"""Hash-aggregate exec (port of ``spark_rapids_tpu/exec/aggregate.py``).

Per batch the fused pre-stages (filters and projections folded in by the
planner, as the reference's ``_fold_stages`` does) run over the batch
with a running keep-mask, then every aggregate's update reduces the kept
rows to partials; the partials of all batches merge in one more
reduction, and finalize yields the result.

Keyless, the update is one masked reduction per aggregate
(``global_groupby``). Keyed, a batch takes one of two paths, as in the
reference:

  * dense: every key is a dictionary string column and the product of
    (cardinality + 1) over the keys fits ``DIRECT_MAX_GROUPS``. The keys'
    codes go through the exec-local dictionary (batch code -> global
    code) and one ``dense_groupby`` kernel launch reduces all of the
    batch's aggregates (exec/dense_groupby.py). Its partials are one row
    per group slot, with a live mask for the occupied ones;
  * sort: anything else (numeric keys, larger products):
    ``segmented_groupby`` (exec/groupby_core.py), string keys as their
    global codes.

Both give global codes, so batches on either path merge together
(keyless or keyed) through ``segmented_groupby`` in merge mode.

Memory (the reference's runtime, mem/): each batch's update runs under
the device semaphore inside ``with_retry_no_split``, and its partials
become a ``SpillableBatch``, which the memory manager may move to the
host or the disk while later batches arrive. The merge is the
reference's bounded fan-in tree (``_merge``): chunks of partials whose
rows fit ``batchSizeRows`` merge level by level, each merge taking its
inputs back to the device inside the retried closure; every path closes
the partials it was handed. Finalize turns the codes back into a
dictionary column whose dictionary is sorted, so that ORDER BY over a
string key orders as the strings do.
"""
from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..columnar import ColumnarBatch, DeviceColumn, DictColumn
from ..columnar.batch import concat_batches
from ..columnar.segmented import bucket_segments
from ..exprs.aggregates import AggregateExpression
from ..exprs.base import Alias, ColumnRef, DVal, EvalContext
from ..exprs.compiler import batch_device, batch_dvals
from ..mem.retry import with_retry_no_split
from ..mem.spillable import SpillableBatch
from ..types import BOOL, INT32, STRING, Schema, StructField, torch_dtype
from .base import ExecContext, TpuExec
from .dense_groupby import BUCKETS, dense_groupby, group_slots
from .groupby_core import segmented_groupby

__all__ = ["TpuHashAggregateExec", "DIRECT_MAX_GROUPS"]

#: the largest product of (cardinality + 1) over the keys that the dense
#: kernel takes; a larger one takes the sort path
DIRECT_MAX_GROUPS = BUCKETS[-1]
#: the partial batch's last column: which rows are groups
_LIVE = "__live"
#: small operands made on the host (dictionary remaps, group slots), kept
#: on their device across batches and queries, so that a warm query
#: copies none of them and never waits on the stream for one
_DEVICE_OPERANDS: "OrderedDict[tuple, object]" = OrderedDict()
_DEVICE_OPERANDS_MAX = 256
_DEVICE_OPERANDS_LOCK = threading.Lock()
#: remaps longer than this are copied every time rather than kept
_CACHED_REMAP_MAX = 4096


def _to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device``; to a card through pinned memory,
    without waiting on the stream."""
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _device_operand(key: tuple, make: Callable[[], object]):
    with _DEVICE_OPERANDS_LOCK:
        got = _DEVICE_OPERANDS.get(key)
        if got is None:
            got = _DEVICE_OPERANDS[key] = make()
            if len(_DEVICE_OPERANDS) > _DEVICE_OPERANDS_MAX:
                _DEVICE_OPERANDS.popitem(last=False)
        return got


def _apply_pre_stages(stages, in_schema: Schema, base_dvals, num_rows: int,
                      padded_len: int, device):
    """Run the fused ("filter", cond) / ("project", exprs, schema)
    pre-stages; returns (EvalContext over the last stage's schema, keep
    mask)."""
    ctx = EvalContext(in_schema, base_dvals, num_rows, padded_len, device)
    keep = ctx.row_mask()
    for st in stages:
        if st[0] == "filter":
            pv = st[1].eval_device(ctx)
            keep = torch.logical_and(keep,
                                     torch.logical_and(pv.data, pv.validity))
        else:
            _, exprs, out_schema = st
            ctx = EvalContext(out_schema, [e.eval_device(ctx) for e in exprs],
                              num_rows, padded_len, device)
    return ctx, keep


def _column_ref(e) -> Optional[str]:
    """The column name an expression passes through, else None."""
    if isinstance(e, Alias):
        e = e.children[0]
    return e.name if isinstance(e, ColumnRef) else None


class TpuHashAggregateExec(TpuExec):
    """Device aggregate with fused pre-stages, keyless or keyed."""

    def __init__(self, groupings: Sequence,
                 aggs: Sequence[AggregateExpression], child: TpuExec,
                 pre_stages: Optional[list] = None,
                 eval_schema: Optional[Schema] = None):
        super().__init__([child])
        self.groupings = list(groupings)
        self.aggs = list(aggs)
        self.pre_stages = pre_stages or []
        self._eval_schema = eval_schema if eval_schema is not None \
            else child.output_schema()
        cs = self._eval_schema
        #: grouping ordinals that go through the string dictionary
        self._dict_keys = [i for i, g in enumerate(self.groupings)
                           if g.data_type(cs) == STRING]
        fields = [StructField(g.name_hint, g.data_type(cs), True)
                  for g in self.groupings]
        fields += [StructField(a.name_hint, a.data_type(cs), True)
                   for a in self.aggs]
        self._schema = Schema(fields)
        self._partial_types = [a.partial_types(cs) for a in self.aggs]
        # partials: keys (string keys as int32 global codes), each
        # aggregate's partial columns, the live mask
        key_types = [INT32 if i in self._dict_keys else g.data_type(cs)
                     for i, g in enumerate(self.groupings)]
        pfields = [StructField(f"_k{i}", t, True)
                   for i, t in enumerate(key_types)]
        pfields += [StructField(f"_a{ai}_{pi}", t, True)
                    for ai, types in enumerate(self._partial_types)
                    for pi, t in enumerate(types)]
        self._partial_schema = Schema(pfields
                                      + [StructField(_LIVE, BOOL, True)])
        #: string -> global code, per dictionary key (one execution's)
        self._dicts: List[Dict[str, int]] = []

    def output_schema(self) -> Schema:
        return self._schema

    def _pre_stages(self, batch: ColumnarBatch):
        return _apply_pre_stages(self.pre_stages,
                                 self.children[0].output_schema(),
                                 batch_dvals(batch), batch.num_rows,
                                 batch.padded_len, batch_device(batch))

    def _finalize_aggs(self, merged) -> List[DeviceColumn]:
        out, pos = [], 0
        nkeys = len(self.groupings)
        for a, types, f in zip(self.aggs, self._partial_types,
                               self._schema.fields[nkeys:]):
            parts = [DVal(d, v, t) for (d, v), t
                     in zip(merged[pos:pos + len(types)], types)]
            pos += len(types)
            final = a.finalize(parts)
            out.append(DeviceColumn(final.data, final.validity, f.dtype))
        return out

    # -- string keys through the exec-local dictionary ---------------------
    def _encode_key(self, j: int, i: int, batch: ColumnarBatch):
        """(codes, validity, remap of the batch dictionary's codes to
        global codes) of dictionary key ordinal j (grouping i). Only a key
        that passes a dictionary column of the input batch through is
        taken (the reference's DictColumn branch)."""
        g = self.groupings[i]
        name = _column_ref(g)
        src = None
        if name is not None and name in batch.schema.names() \
                and self._passes_through(name):
            src = batch.column_by_name(name)
        if not isinstance(src, DictColumn):
            raise NotImplementedError(
                f"group key <{g.name_hint}> over {src!r}: string keys other "
                "than dictionary columns (byte rectangles, computed strings) "
                "arrive with the strings slice")
        d = self._dicts[j]
        gmap = np.asarray([d.setdefault(s, len(d)) for s in src.dictionary],
                          dtype=np.int32)
        dev = src.data.device
        if len(gmap) > _CACHED_REMAP_MAX:
            return src.data, src.validity, _to_device(torch.from_numpy(gmap),
                                                      dev)
        remap = _device_operand(
            ("remap", str(dev), gmap.tobytes()),
            lambda: _to_device(torch.from_numpy(gmap), dev))
        return src.data, src.validity, remap

    def _passes_through(self, name: str) -> bool:
        """True when every fused projection passes column ``name`` on
        unchanged, so the input batch's column is the key."""
        for st in self.pre_stages:
            if st[0] == "project" and not any(
                    e.name_hint == name and _column_ref(e) == name
                    for e in st[1]):
                return False
        return True

    def _direct_operands(self, batch: ColumnarBatch):
        """(key pairs, remaps, cardinalities, group bucket) when every key
        is a dictionary key and their product fits the dense kernel, else
        None."""
        if not self.groupings or len(self._dict_keys) != len(self.groupings):
            return None
        pairs, remaps = [], []
        for j, i in enumerate(self._dict_keys):
            codes, valid, remap = self._encode_key(j, i, batch)
            pairs.append((codes, valid))
            remaps.append(remap)
        cards = [max(len(d), 1) for d in self._dicts]
        prod = math.prod(c + 1 for c in cards)
        if prod > DIRECT_MAX_GROUPS:
            return None
        return pairs, remaps, cards, bucket_segments(prod)

    def _dense_update(self, ops, keep, vals):
        """One dense_groupby launch for every aggregate of the batch:
        (key columns, partials, live) over the group slots."""
        pairs, remaps, cards, G = ops
        wants = [a.sum_inputs(vs) for a, vs in zip(self.aggs, vals)]
        columns, index = [], {}
        for want in wants:
            for d, v in want:
                k = (None if d is None else id(d), None if v is None
                     else id(v))
                if v is not None and k not in index:
                    index[k] = len(columns)
                    columns.append((d, v))
        res = dense_groupby(pairs, remaps, cards, keep, columns, G)
        partials = []
        for a, want in zip(self.aggs, wants):
            sums = []
            for d, v in want:
                if v is None:                    # every live row
                    sums.append((None, res.occupancy))
                else:
                    k = index[(None if d is None else id(d), id(v))]
                    sums.append((res.sums[k], res.counts[k]))
            partials.extend(a.from_sums(sums))
        slots = _device_operand(
            ("slots", tuple(cards), G, str(keep.device)),
            lambda: [(_to_device(c, keep.device), _to_device(v, keep.device))
                     for c, v in group_slots(cards, G)])
        return slots, partials, res.occupancy > 0

    def _sort_keys(self, batch: ColumnarBatch, ectx) -> List[DVal]:
        """Key values for the sort path: string keys as global codes."""
        by_dict = {i: j for j, i in enumerate(self._dict_keys)}
        keys = []
        for i, g in enumerate(self.groupings):
            if i not in by_dict:
                keys.append(g.eval_device(ectx))
                continue
            codes, valid, remap = self._encode_key(by_dict[i], i, batch)
            if len(remap):
                c = remap[codes.clamp(0, len(remap) - 1).long()]
                c = torch.where(valid, c, torch.zeros_like(c))
            else:
                c = torch.zeros_like(codes)
            keys.append(DVal(c, valid, INT32))
        return keys

    def _update(self, batch: ColumnarBatch) -> ColumnarBatch:
        """One batch's partials (the partial schema, live column last)."""
        ectx, keep = self._pre_stages(batch)
        vals = [[e.eval_device(ectx) for e in a.input_exprs()]
                for a in self.aggs]
        ops = self._direct_operands(batch)
        if ops is not None:
            keys, partials, live = self._dense_update(ops, keep, vals)
        else:
            keys, partials, n = segmented_groupby(
                self._sort_keys(batch, ectx), vals, self.aggs, "update",
                keep)
            live = torch.ones(n, dtype=torch.bool, device=keep.device)
        return self._partial_batch(keys, partials, live)

    def _partial_batch(self, keys, partials, live) -> ColumnarBatch:
        cols = [DeviceColumn(d, v, f.dtype) for (d, v), f in
                zip(keys + partials + [(live, live)],
                    self._partial_schema.fields)]
        return ColumnarBatch(cols, int(live.shape[0]), self._partial_schema)

    def _empty_partials(self, device) -> ColumnarBatch:
        cols = [DeviceColumn(torch.zeros(0, dtype=torch_dtype(f.dtype),
                                         device=device),
                             torch.zeros(0, dtype=torch.bool, device=device),
                             f.dtype)
                for f in self._partial_schema.fields]
        return ColumnarBatch(cols, 0, self._partial_schema)

    def _merge_batch(self, big: ColumnarBatch):
        """One ``segmented_groupby`` merge of partial rows: (keys, merged
        partials, groups)."""
        cols = big.columns
        nkeys = len(self.groupings)
        keys = [DVal(c.data, c.validity, f.dtype) for c, f in
                zip(cols[:nkeys], self._partial_schema.fields)]
        vals, pos = [], nkeys
        for types in self._partial_types:
            vals.append([DVal(cols[o].data, cols[o].validity, t)
                         for o, t in zip(range(pos, pos + len(types)),
                                         types)])
            pos += len(types)
        return segmented_groupby(keys, vals, self.aggs, "merge",
                                 cols[-1].data)

    def _merge(self, ctx: ExecContext,
               partials: List[SpillableBatch]) -> ColumnarBatch:
        """Merge the partials into the final batch, closing every one
        (ref ``_merge``, aggregate.py:1445-1565). While their rows add up
        to more than the cap (``batchSizeRows``, never below the largest
        partial), chunks of partials whose rows fit it merge into one
        spillable partial each, level by level; then one merge and the
        finalize. Every merge takes its inputs back to the device inside
        its retried closure, so a spill made for a retry really frees
        the memory the retry needs."""
        op = "HashAggregate.merge"
        level: List[SpillableBatch] = list(partials)
        merged_level: List[SpillableBatch] = []
        try:
            cap = max([ctx.conf.batch_size_rows]
                      + [sb.padded_len for sb in level])
            while len(level) > 1 and \
                    sum(sb.padded_len for sb in level) > cap:
                chunks, cur, acc = [], [], 0
                for sb in level:
                    if cur and acc + sb.padded_len > cap:
                        chunks.append(cur)
                        cur, acc = [], 0
                    cur.append(sb)
                    acc += sb.padded_len
                chunks.append(cur)
                merged_level = []
                for chunk in chunks:
                    if len(chunk) == 1:
                        merged_level.append(chunk[0])
                        continue

                    def level_merge(c=chunk):
                        with ctx.semaphore.held():
                            keys, merged, n = self._merge_batch(
                                concat_batches([s.get() for s in c]))
                            live = torch.ones(n, dtype=torch.bool,
                                              device=ctx.device)
                            return SpillableBatch(
                                self._partial_batch(keys, merged, live),
                                ctx.memory)
                    merged_level.append(with_retry_no_split(
                        level_merge, ctx=ctx, op=op))
                # the chunks' inputs live on in the level's outputs
                for sb in level:
                    if sb not in merged_level:
                        sb.close()
                stalled = len(merged_level) >= len(level)
                level = merged_level
                if stalled:
                    # every chunk a single partial at the cap: one merge
                    # over all of them rather than a loop without end
                    break

            def do_merge():
                with ctx.semaphore.held():
                    big = concat_batches([s.get() for s in level]) \
                        if level else self._empty_partials(ctx.device)
                    keys, merged, n = self._merge_batch(big)
                    return ColumnarBatch(self._decode_keys(keys)
                                         + self._finalize_aggs(merged), n,
                                         self._schema)
            return with_retry_no_split(do_merge, ctx=ctx, op=op)
        finally:
            # close() is idempotent: partials that moved between the
            # lists close once
            for sb in level + merged_level:
                sb.close()

    def _decode_keys(self, keys) -> list:
        """Dictionary keys back to DictColumns over their dictionary
        sorted, codes replaced by their ranks; other keys as they are."""
        out = []
        by_dict = {i: j for j, i in enumerate(self._dict_keys)}
        for i, ((d, v), f) in enumerate(zip(keys, self._schema.fields)):
            if i not in by_dict:
                out.append(DeviceColumn(d, v, f.dtype))
                continue
            inv = np.empty(len(self._dicts[by_dict[i]]), dtype=object)
            for s, c in self._dicts[by_dict[i]].items():
                inv[c] = s
            if not len(inv):
                out.append(DictColumn(torch.zeros_like(d), v, STRING, inv))
                continue
            order = np.argsort(inv, kind="stable")
            rank = np.empty(len(inv), np.int32)
            rank[order] = np.arange(len(inv), dtype=np.int32)
            rank_t = torch.from_numpy(rank).to(d.device)
            codes = rank_t[d.clamp(0, len(inv) - 1).long()]
            out.append(DictColumn(torch.where(v, codes, 0), v, STRING,
                                  inv[order]))
        return out

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        self._dicts = [dict() for _ in self._dict_keys]
        partials: List[SpillableBatch] = []
        try:
            for b in self.children[0].execute(ctx):
                # a batch of no rows adds no group (and its string
                # columns may not have a dictionary form)
                if not b.num_rows:
                    continue

                def update(b=b):
                    with ctx.semaphore.held():
                        return SpillableBatch(self._update(b), ctx.memory)
                partials.append(with_retry_no_split(
                    update, ctx=ctx, op="HashAggregate.update"))
        except BaseException:
            # a fatal error or QueryTimeout mid-update: the partials must
            # not outlive the query (the zero-leak audit)
            for sb in partials:
                sb.close()
            raise
        yield self._merge(ctx, partials)

    def describe(self):
        g = ", ".join(e.name_hint for e in self.groupings)
        a = ", ".join(x.name_hint for x in self.aggs)
        fused = ""
        if self.pre_stages:
            parts = [("filter" if s[0] == "filter" else "project")
                     for s in self.pre_stages]
            fused = f" fused=[{'+'.join(parts)}]"
        return f"HashAggregate[keys=[{g}], aggs=[{a}]]{fused}"
