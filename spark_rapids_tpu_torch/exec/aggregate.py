"""Hash-aggregate exec (port of ``spark_rapids_tpu/exec/aggregate.py``).

Per batch the fused pre-stages (filters and projections folded in by the
planner, as the reference's ``_fold_stages`` does) run over the batch
with a running keep-mask, then every aggregate's update reduces the kept
rows to partials; the partials of all batches merge in one more
reduction, and finalize yields the result.

Keyless, the update is one masked reduction per aggregate
(``global_groupby``). Keyed, a batch takes one of two paths, as in the
reference:

  * dense: every key is a dictionary string column or an integer key of
    planner-proven cardinality (``int_key_cards``: values in [0, card),
    the union-of-aggregates branch id), and the product of (cardinality
    + 1) over the keys fits ``DIRECT_MAX_GROUPS``. A dictionary key's
    codes go through the exec-local dictionary (batch code -> global
    code), an integer key's values are its codes (an identity remap),
    and one ``dense_groupby`` kernel launch reduces all of the batch's
    aggregates (exec/dense_groupby.py), a second the values of the
    moment aggregates less each group's mean (exprs/aggregates.py).
    Its partials are one row per group slot, with a live mask for the
    occupied ones;
  * sort: anything else (other numeric keys, larger products):
    ``segmented_groupby`` (exec/groupby_core.py), string keys as their
    global codes.

Both give global codes (an integer key its own values), so batches on
either path merge together
(keyless or keyed) through ``segmented_groupby`` in merge mode.

A string key groups on its bytes instead (rect key mode, the
reference's ``_rect_key_mode``) when its first batch brings it as a byte
rectangle (a high-cardinality column, or a computed string:
``upper(trim(s))`` over one), or a later batch brings a rectangle whose
values the exec's dictionary cannot take within the dictionary
threshold. The mode holds for the rest of the execution: the partials
made before are rebuilt with the key's values as a rectangle (their
codes decoded through the dictionary), and a later batch that brings the
key as a dictionary column is gathered into a rectangle
(``dict_to_rect``). Such a key takes the sort path as its
words and length (exec/encoding.py), its partial column is a byte
rectangle, and partials of different widths merge padded with zeros.

Memory (the reference's runtime, mem/): each batch's update, its string
keys' conversions and rebuilds included, runs under the device semaphore
inside ``with_retry_no_split``, and its partials
become a ``SpillableBatch``, which the memory manager may move to the
host or the disk while later batches arrive. The merge is the
reference's bounded fan-in tree (``_merge``): chunks of partials whose
rows fit ``batchSizeRows`` merge level by level, each merge taking its
inputs back to the device inside the retried closure; every path closes
the partials it was handed. When a keyed aggregate's partials hold more
than ``batchSizeBytes``, they are hash-split on the keys into 2-64
partitions instead, and each partition merges and finalizes alone
(``_repartitioned_merge``): a group's rows all land in one partition.
Finalize turns the codes back into a dictionary column whose dictionary
is sorted, so that ORDER BY over a string key orders as the strings do.

``collect_list``/``collect_set`` partials are list rectangles, one list a
group (exprs/aggregates.py): partial columns of ``ListColumn``s, which
concatenate, spill and split as any list column does. ``min_by``/
``max_by`` partials are the value, the ordering and the row's position.
An order statistic (``percentile``) keeps the count of a group's values
as its partial and, beside the partials, a value stream: each batch's
(keys, value) rows that hold a value, spillable. After the merge the
stream is sorted by the keys, then the value, by the port's sort (in
core, or out of core past ``batchSizeBytes``: exec/sort.py), so that a
group's values lie in order however many batches it spanned; the merged
groups come out in the same key order, so group g's values start where
the counts of the groups before it end, and the two values at its ranks
are picked from the sorted batches as they stream past (``_pick``); the
stream's key at each group's first position is picked too and held to
the group's key, so that a change to either order raises rather than
giving a group another's values. The merged partials stay spillable
while the streams sort. Past ``batchSizeBytes`` of partials, the
partials and the value streams are hash-split on the keys alike, and
each partition merges, sorts and picks alone.
"""
from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..columnar import (ByteRectColumn, ColumnarBatch, DeviceColumn,
                        DictColumn)
from ..columnar.nested import list_column, null_rows, to_device_list
from ..columnar.batch import (concat_batches, dict_limit, dict_to_rect,
                              rect_to_dict)
from ..columnar.segmented import bucket_segments
from ..config import BATCH_SIZE_BYTES
from ..exprs.aggregates import (AggregateExpression, group_shift,
                                less_shift)
from ..exprs.base import (Alias, ColumnRef, DVal, EvalContext, ListVal,
                          StrVal)
from ..exprs.compiler import batch_device, batch_dvals
from ..mem.retry import with_retry_no_split
from ..mem.spillable import SpillableBatch
from ..types import (BOOL, INT8, INT16, INT32, INT64, NESTED_REST, STRING,
                     ArrayType, Schema, StructField, torch_dtype)
from .base import ExecContext, TpuExec
from .dense_groupby import (BUCKETS, MAX_COLS, dense_groupby, group_slots,
                            packed_ids)
from .groupby_core import segmented_groupby

__all__ = ["TpuHashAggregateExec", "DIRECT_MAX_GROUPS"]

#: the largest product of (cardinality + 1) over the keys that the dense
#: kernel takes; a larger one takes the sort path
DIRECT_MAX_GROUPS = BUCKETS[-1]
#: the integer key types a proven cardinality may address directly
_INT_TYPES = (INT8, INT16, INT32, INT64)
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
                      padded_len: int, device, partition_id: int = 0,
                      task_state: Optional[dict] = None,
                      use_kernel: bool = False):
    """Run the fused ("filter", cond) / ("project", exprs, schema)
    pre-stages; returns (EvalContext over the last stage's schema, keep
    mask). ``partition_id``, ``task_state`` and ``use_kernel`` are the
    batch's partition, the exec's task state and whether string
    predicates take the match kernel (exprs/base.py EvalContext)."""
    ctx = EvalContext(in_schema, base_dvals, num_rows, padded_len, device,
                      partition_id=partition_id, task_state=task_state,
                      use_kernel=use_kernel)
    keep = ctx.row_mask()
    for st in stages:
        if st[0] == "filter":
            pv = st[1].eval_device(ctx)
            keep = torch.logical_and(keep,
                                     torch.logical_and(pv.data, pv.validity))
        else:
            _, exprs, out_schema = st
            ctx = EvalContext(out_schema, [e.eval_device(ctx) for e in exprs],
                              num_rows, padded_len, device,
                              partition_id=partition_id,
                              task_state=task_state, use_kernel=use_kernel)
    return ctx, keep


def _value(v: DVal, agg) -> DVal:
    """An aggregate's input; a string's data is dropped, and its column
    too unless the aggregate reads the strings (``reads_strings``:
    collect_list, min_by; count reads only the validity). A host string
    column (None: wider than rect.maxBytes, not dictionary-shaped) is
    refused at the batch, naming where it arrives."""
    if v is None:
        if agg.reads_strings:
            raise NotImplementedError(
                f"{agg.name_hint}: host strings (past the byte rectangle, "
                f"not dictionary-shaped) inside nested values arrive with "
                f"{NESTED_REST}")
        raise NotImplementedError(
            f"{agg.name_hint}: an aggregate over a host string column "
            "(non-ASCII or over-wide) arrives with slice 7 (strings, "
            "ROADMAP.md Queue A)")
    if v.dtype != STRING:
        return v
    return DVal(None, v.validity, v.dtype,
                v.column if agg.reads_strings else None)


def _agg_column(d, v, dtype) -> DeviceColumn:
    """A partial or result column: a list rectangle for a ``ListVal``, a
    string's column (collect's, min_by's) with validity ``v``."""
    if isinstance(d, ListVal):
        return list_column(*d, v, dtype)
    if isinstance(d, DeviceColumn):
        return null_rows(d, v)
    return DeviceColumn(d, v, dtype)


def _pick(got: torch.Tensor, want: torch.Tensor, values: torch.Tensor,
          base: int, m: int) -> torch.Tensor:
    """``got`` with the entries whose position ``want`` falls in a sorted
    batch of ``m`` rows starting at ``base`` taken from its ``values``."""
    inb = (want >= base) & (want < base + m)
    return torch.where(inb, values[(want - base).clamp(0, m - 1)], got)


class _StreamSource(TpuExec):
    """The spillable batches of an order statistic's value stream as an
    exec, each taken back to the device and closed as it is read (the
    sort over it wraps it again)."""

    def __init__(self, spillables: List[SpillableBatch], schema: Schema):
        super().__init__([])
        self.spillables = spillables
        self._schema = schema

    def output_schema(self) -> Schema:
        return self._schema

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        for sb in self.spillables:
            try:
                b = sb.get()
            finally:
                sb.close()
            yield b


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
                 eval_schema: Optional[Schema] = None,
                 int_key_cards: Optional[Sequence] = None):
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
        #: grouping ordinal -> proven cardinality of an integer key
        self._int_cards = {
            i: int(c) for i, c in enumerate(int_key_cards or [])
            if c and self.groupings[i].data_type(cs) in _INT_TYPES}
        fields = [StructField(g.name_hint, g.data_type(cs), True)
                  for g in self.groupings]
        fields += [StructField(a.name_hint, a.data_type(cs), True)
                   for a in self.aggs]
        self._schema = Schema(fields)
        self._partial_types = [a.partial_types(cs) for a in self.aggs]
        #: string keys (ordinals into _dict_keys) grouping on their bytes
        #: in this execution, and whether all their bytes are ASCII
        self._rect_keys: set = set()
        self._use_kernel = False
        self._rect_ascii: Dict[int, bool] = {}
        self._set_partial_schema()
        #: string -> global code, per dictionary key (one execution's)
        self._dicts: List[Dict[str, int]] = []
        #: rows of the input batches so far (one execution's)
        self._rows_in = 0
        #: every aggregate is sums and counts: the dense kernel may run
        self._dense_ok = all(a.dense_ok for a in self.aggs)
        #: partitions of the latest execution's repartitioned merge (0:
        #: it merged in one tree)
        self.last_repartitions = 0
        self._task_state: dict = {}
        #: the order statistics (their ordinals) and, per distinct input
        #: of theirs, its value stream's spillable batches
        self._order_aggs = [i for i, a in enumerate(self.aggs)
                            if getattr(a, "order_statistic", False)]
        self._stream_keys = list(dict.fromkeys(
            self.aggs[i].child.key() for i in self._order_aggs))
        self._streams: Dict[str, List[SpillableBatch]] = {}
        #: buckets of the latest execution's value-stream sorts (0: in
        #: memory)
        self.last_stream_buckets: List[int] = []

    def output_schema(self) -> Schema:
        return self._schema

    def _set_partial_schema(self) -> None:
        """Partials: keys (a string key as int32 global codes, or as a
        STRING byte rectangle in rect key mode), each aggregate's partial
        columns, the live mask."""
        cs = self._eval_schema
        by_dict = {i: j for j, i in enumerate(self._dict_keys)}
        pfields = [StructField(f"_k{i}", (
            g.data_type(cs) if i not in by_dict else
            STRING if by_dict[i] in self._rect_keys else INT32), True)
            for i, g in enumerate(self.groupings)]
        pfields += [StructField(f"_a{ai}_{pi}", t, True)
                    for ai, types in enumerate(self._partial_types)
                    for pi, t in enumerate(types)]
        self._partial_schema = Schema(pfields
                                      + [StructField(_LIVE, BOOL, True)])

    def _pre_stages(self, batch: ColumnarBatch):
        return _apply_pre_stages(self.pre_stages,
                                 self.children[0].output_schema(),
                                 batch_dvals(batch), batch.num_rows,
                                 batch.padded_len, batch_device(batch),
                                 batch.partition_id, self._task_state,
                                 self._use_kernel)

    def _finalize_aggs(self, merged, picks=None) -> List[DeviceColumn]:
        """The output columns from the merged partials; an order
        statistic's from its count and the values ``picks`` holds for it
        (``_order_stats``)."""
        out, pos = [], 0
        nkeys = len(self.groupings)
        for ai, (a, types, f) in enumerate(zip(
                self.aggs, self._partial_types, self._schema.fields[nkeys:])):
            parts = [DVal(d, v, t) for (d, v), t
                     in zip(merged[pos:pos + len(types)], types)]
            pos += len(types)
            if ai in self._order_aggs:
                final = a.finalize_picked(parts[0].data, *picks[ai])
            else:
                final = a.finalize(parts)
            out.append(_agg_column(final.data, final.validity, f.dtype))
        return out

    # -- string keys through the exec-local dictionary, or on bytes -------
    def _key_column(self, i: int, batch: ColumnarBatch):
        """The input batch's column that string grouping ``i`` passes
        through (renamed or not), else None."""
        name = _column_ref(self.groupings[i])
        name = self._source_column(name) if name is not None else None
        if name is not None and name in batch.schema.names():
            return batch.column_by_name(name)
        return None

    def _key_sources(self, ctx: ExecContext, batch: ColumnarBatch,
                     partials: List[SpillableBatch]) -> list:
        """Per string key, the column it groups on in this batch: a
        dictionary column, or in rect key mode a byte rectangle. A key
        that arrives as a byte rectangle the exec's dictionary cannot
        take (``_rect_key``) switches to rect key mode here (module
        doc). Runs inside the update's retried closure, under the
        semaphore: an OOM part way through leaves what is done (the mode,
        the partials rebuilt so far) and the retry goes on from there."""
        self._rebuild_partials(ctx, partials)
        out = []
        for j, i in enumerate(self._dict_keys):
            src = self._key_column(i, batch)
            if j not in self._rect_keys and isinstance(src, ByteRectColumn):
                # the first batch decides as the reference's does; a later
                # one (a short batch of a dictionary column, fault C1)
                # joins the dictionary when it fits
                conv = self._rect_key(src, batch.num_rows,
                                      self._dicts[j]) if partials else src
                if conv is src:
                    self._to_rect_mode(j, partials)
                    self._rebuild_partials(ctx, partials)
                else:
                    src = conv
            if j in self._rect_keys:
                if isinstance(src, DictColumn):
                    src = dict_to_rect(src, src.padded_len)
                if isinstance(src, ByteRectColumn):
                    self._rect_ascii[j] = self._rect_ascii.get(j, True) \
                        and src.ascii_only
            if not isinstance(src, (DictColumn, ByteRectColumn)):
                g = self.groupings[i]
                raise NotImplementedError(
                    f"group key <{g.name_hint}> over {src!r}: string keys "
                    "other than a column or a transform chain over one "
                    "(host strings wider than rect.maxBytes, other string "
                    "expressions) arrive with slice 7 (strings, ROADMAP.md "
                    "Queue A)")
            out.append(src)
        return out

    def _to_rect_mode(self, j: int, partials: List[SpillableBatch]) -> None:
        """String key ``j`` groups on its bytes from now on; the partials
        made so far are left to ``_rebuild_partials``."""
        inv = np.empty(len(self._dicts[j]), dtype=object)
        for v, c in self._dicts[j].items():
            inv[c] = v
        self._rect_keys.add(j)
        self._rect_ascii[j] = all(v.isascii() for v in inv)
        self._set_partial_schema()
        self._stale[j] = [inv, 0, len(partials)]

    def _rebuild_partials(self, ctx: ExecContext,
                          partials: List[SpillableBatch]) -> None:
        """The partials made before a key switched to rect key mode get
        its column as a byte rectangle, its global codes decoded through
        the exec's dictionary on the device, one partial at a time; each
        rebuilt one is recorded, so that after an OOM the retry goes on
        with the next."""
        for j in sorted(self._stale):
            inv, first, end = self._stale[j]
            at = self._dict_keys[j]
            for n in range(first, end):
                sb = partials[n]
                b = sb.get()
                codes = b.columns[at]
                cols = list(b.columns)
                cols[at] = dict_to_rect(DictColumn(
                    codes.data, codes.validity, STRING, inv), b.padded_len)
                partials[n] = SpillableBatch(
                    ColumnarBatch(cols, b.num_rows, self._partial_schema),
                    ctx.memory)
                sb.close()
                self._stale[j][1] = n + 1
            del self._stale[j]

    def _encode_key(self, j: int, src: DictColumn):
        """(codes, validity, remap of the batch dictionary's codes to
        global codes) of dictionary key ordinal j, over its dictionary
        column ``src`` (``_key_sources``)."""
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

    def _rect_key(self, src: ByteRectColumn, n: int, d: Dict[str, int]):
        """A key batch that arrived as a byte rectangle (a short batch of a
        low-cardinality column does) as a dictionary column, when the
        exec's dictionary with its values added stays within the
        dictionary threshold for every row seen so far; else ``src``."""
        limit = dict_limit(self._rows_in)
        conv = rect_to_dict(src, n, limit)
        if conv is None or len(d) + sum(
                s not in d for s in conv.dictionary) > limit:
            return src
        return conv

    def _source_column(self, name: str) -> Optional[str]:
        """The input batch's column that the fused projections pass on
        as column ``name`` (renamed or not), else None: that column is
        the key."""
        for st in reversed(self.pre_stages):
            if st[0] == "project":
                name = next((_column_ref(e) for e in st[1]
                             if e.name_hint == name), None)
                if name is None:
                    return None
        return name

    def _dense_keys(self) -> bool:
        """Every key is a dictionary key (none grouping on bytes) or a
        proven-cardinality integer key, and the integer keys alone fit
        the dense kernel."""
        return bool(self.groupings) and not self._rect_keys \
            and len(self._dict_keys) + len(
            self._int_cards) == len(self.groupings) and math.prod(
            c + 1 for c in self._int_cards.values()) <= DIRECT_MAX_GROUPS

    def _direct_operands(self, srcs: list, ectx):
        """(key pairs, remaps, cardinalities, group bucket) when every key
        is a dictionary key or a proven-cardinality integer key and their
        product fits the dense kernel, else None. An integer key's values
        are its codes, through an identity remap."""
        if not self._dense_keys():
            return None
        by_dict = {i: j for j, i in enumerate(self._dict_keys)}
        pairs, remaps, cards = [], [], []
        for i, g in enumerate(self.groupings):
            if i in by_dict:
                codes, valid, remap = self._encode_key(by_dict[i],
                                                       srcs[by_dict[i]])
                card = max(len(self._dicts[by_dict[i]]), 1)
            else:
                card = self._int_cards[i]
                v = g.eval_device(ectx)
                codes, valid = v.data.to(torch.int32), v.validity
                dev = codes.device
                remap = _device_operand(
                    ("identity", card, str(dev)),
                    lambda: torch.arange(card, dtype=torch.int32,
                                         device=dev))
            pairs.append((codes, valid))
            remaps.append(remap)
            cards.append(card)
        prod = math.prod(c + 1 for c in cards)
        if prod > DIRECT_MAX_GROUPS:
            return None
        return pairs, remaps, cards, bucket_segments(prod)

    def _dense_update(self, ops, keep, vals):
        """One dense_groupby launch for every aggregate of the batch, and
        for the moment aggregates a second, of their values less each
        group's mean from the first (exprs/aggregates.py): (key columns,
        partials, live) over the group slots; None when the aggregates
        need more value columns than the kernel takes (the sort path
        takes the batch)."""
        pairs, remaps, cards, G = ops
        wants = [a.sum_inputs(vs) for a, vs in zip(self.aggs, vals)]
        shifts = [a.shifted_inputs(vs) for a, vs in zip(self.aggs, vals)]
        columns, index = [], {}

        def key(d, v):
            return (None if d is None else id(d), None if v is None
                    else id(v))
        for want in wants + shifts:
            for d, v in want:
                if v is not None and key(d, v) not in index:
                    index[key(d, v)] = len(columns)
                    columns.append((d, v))
        # the columns the second launch takes shifted: two columns each
        second = list(dict.fromkeys(index[key(d, v)] for want in shifts
                                    for d, v in want))
        if max(len(columns), 2 * len(second)) > MAX_COLS:
            return None
        res = dense_groupby(pairs, remaps, cards, keep, columns, G)
        shifted = {}
        if second:
            ids = packed_ids(pairs, remaps, cards, keep, G)
            cs = [group_shift(res.sums[k], res.counts[k]) for k in second]
            cols2 = []
            for k, c in zip(second, cs):
                cols2 += [(x, columns[k][1])
                          for x in less_shift(columns[k][0], c, ids)]
            res2 = dense_groupby(pairs, remaps, cards, keep, cols2, G)
            shifted = {k: (c, res2.sums[2 * j], res2.sums[2 * j + 1])
                       for j, (k, c) in enumerate(zip(second, cs))}
        partials = []
        for a, want, shift in zip(self.aggs, wants, shifts):
            sums = []
            for d, v in want:
                if v is None:                    # every live row
                    sums.append((None, res.occupancy))
                else:
                    k = index[key(d, v)]
                    sums.append((res.sums[k], res.counts[k]))
            partials.extend(a.from_sums(sums, [shifted[index[key(d, v)]]
                                               for d, v in shift]))
        # a key's slots as the partials carry it: global codes, an
        # integer key's values in its own type
        types = tuple(torch_dtype(f.dtype) if i in self._int_cards
                      else torch.int32 for i, f in enumerate(
                          self._partial_schema.fields[:len(cards)]))
        slots = _device_operand(
            ("slots", tuple(cards), G, types, str(keep.device)),
            lambda: [(_to_device(c.to(t), keep.device),
                      _to_device(v, keep.device))
                     for (c, v), t in zip(group_slots(cards, G), types)])
        return slots, partials, res.occupancy > 0

    def _sort_keys(self, srcs: list, ectx) -> List[DVal]:
        """Key values for the sort path: string keys as global codes, or
        in rect key mode as their byte rectangles."""
        by_dict = {i: j for j, i in enumerate(self._dict_keys)}
        keys = []
        for i, g in enumerate(self.groupings):
            if i not in by_dict:
                keys.append(g.eval_device(ectx))
                continue
            src = srcs[by_dict[i]]
            if by_dict[i] in self._rect_keys:
                keys.append(DVal(StrVal(src.data, src.lengths), src.validity,
                                 STRING))
                continue
            codes, valid, remap = self._encode_key(by_dict[i], src)
            if len(remap):
                c = remap[codes.clamp(0, len(remap) - 1).long()]
                c = torch.where(valid, c, torch.zeros_like(c))
            else:
                c = torch.zeros_like(codes)
            keys.append(DVal(c, valid, INT32))
        return keys

    def _update(self, batch: ColumnarBatch, row_offset: int = 0,
                srcs: Optional[list] = None) -> ColumnarBatch:
        """One batch's partials (the partial schema, live column last);
        ``row_offset`` is the batch's first row's position in the input,
        ``srcs`` the string keys' columns (``_key_sources``)."""
        return self._update_streams(batch, row_offset, srcs)[0]

    def _update_streams(self, batch: ColumnarBatch, row_offset: int = 0,
                        srcs: Optional[list] = None):
        """``_update``'s partials and the batch's value streams' batches
        (``_stream_batches``)."""
        if srcs is None:
            srcs = [self._key_column(i, batch) for i in self._dict_keys]
        ectx, keep = self._pre_stages(batch)
        vals = [[_value(e.eval_device(ectx), a) for e in a.input_exprs()]
                for a in self.aggs]
        streams = self._stream_batches(srcs, ectx, keep, vals)
        ops = self._direct_operands(srcs, ectx) if self._dense_ok \
            else None
        dense = self._dense_update(ops, keep, vals) if ops is not None \
            else None
        if dense is not None:
            keys, partials, live = dense
        else:
            keys, partials, n = segmented_groupby(
                self._sort_keys(srcs, ectx), vals, self.aggs, "update",
                keep, row_offset)
            live = torch.ones(n, dtype=torch.bool, device=keep.device)
        return self._partial_batch(keys, partials, live), streams

    def _stream_batches(self, srcs, ectx, keep, vals) -> list:
        """Per value stream, the batch's rows that hold a value: their
        keys as the sort path takes them (global codes) and the value."""
        if not self._order_aggs:
            return []
        if self._rect_keys:
            from ..types import NESTED_REST
            raise NotImplementedError(
                "an order statistic grouped by a string key of many "
                "distinct values (grouped on its bytes) arrives with "
                f"{NESTED_REST}")
        keys = self._sort_keys(srcs, ectx) if self.groupings else []
        out = []
        for k in self._stream_keys:
            ai = next(i for i in self._order_aggs
                      if self.aggs[i].child.key() == k)
            v = vals[ai][0]
            idx = torch.nonzero(keep & v.validity, as_tuple=True)[0]
            schema = Schema(
                list(self._partial_schema.fields[:len(self.groupings)])
                + [StructField("_v", v.dtype, False)])
            cols = [DeviceColumn(d.data[idx], d.validity[idx], f.dtype)
                    for d, f in zip(keys, schema.fields)]
            cols.append(DeviceColumn(v.data[idx], v.validity[idx], v.dtype))
            out.append(ColumnarBatch(cols, int(idx.shape[0]), schema))
        return out

    def _order_stats(self, ctx: ExecContext, merged_sb: SpillableBatch,
                     streams: Dict[str, List[SpillableBatch]]):
        """Per order statistic, its values at its two ranks in each group
        of the merged partials (``merged_sb``, groups in key order): each
        value stream sorted by the keys and then the value, and the wanted
        positions picked from its batches as they pass. The merged
        partials stay spillable while the streams sort; what is held on
        the device meanwhile is a few values a group. Returns (picks, per
        stream (counts, the stream's keys at each group's first position,
        the stream's rows)) for ``_check_group_order``."""
        from ..plan.logical import SortOrder
        from .sort import TpuSortExec
        nkeys = len(self.groupings)
        pos, at = 0, {}
        for ai, types in enumerate(self._partial_types):
            at[ai] = nkeys + pos
            pos += len(types)
        mine = {k: [i for i in self._order_aggs
                    if self.aggs[i].child.key() == k]
                for k in self._stream_keys}

        def plan():
            with ctx.semaphore.held():
                merged = merged_sb.get()
                out = {}
                for k, ais in mine.items():
                    # a copy: the merged batch may spill meanwhile
                    counts = merged.columns[at[ais[0]]].data.to(
                        torch.int64, copy=True)
                    start = torch.cumsum(counts, 0) - counts
                    wanted = []
                    for i in ais:
                        lo, hi, _ = self.aggs[i].ranks(counts)
                        wanted += [start + lo, start + hi]
                    out[k] = (counts, start, torch.cat(wanted))
                return out
        plans = with_retry_no_split(plan, ctx=ctx, op="HashAggregate.merge")
        picks, checks = {}, {}
        for k, ais in mine.items():
            counts, start, want = plans[k]
            vt = self.aggs[ais[0]].child.data_type(self._eval_schema)
            got = torch.zeros(want.shape, dtype=torch_dtype(vt),
                              device=want.device)
            keys_at = None
            base = 0
            if streams[k]:
                schema = streams[k][0].schema
                orders = [SortOrder(ColumnRef(f.name), True, False)
                          for f in schema.fields]
                sorter = TpuSortExec(orders,
                                     _StreamSource(streams[k], schema))
                for b in sorter.execute(ctx):
                    m = b.num_rows
                    if m:
                        with ctx.semaphore.held():
                            got = _pick(got, want, b.columns[-1].data, base,
                                        m)
                            if keys_at is None:
                                keys_at = [(torch.zeros_like(
                                    start, dtype=c.data.dtype),
                                    torch.zeros_like(start, dtype=torch.bool))
                                    for c in b.columns[:nkeys]]
                            keys_at = [
                                (_pick(d, start, c.data, base, m),
                                 _pick(v, start, c.validity, base, m))
                                for (d, v), c in zip(keys_at,
                                                     b.columns[:nkeys])]
                    base += m
                self.last_stream_buckets.append(sorter.last_buckets)
            checks[k] = (counts, keys_at, base)
            G = counts.shape[0]
            for j, i in enumerate(ais):
                picks[i] = (got[2 * j * G:(2 * j + 1) * G],
                            got[(2 * j + 1) * G:(2 * j + 2) * G])
        return picks, checks

    def _check_group_order(self, merged: ColumnarBatch, checks) -> None:
        """Raise unless each value stream's sorted rows fall into the
        merged groups as ``_order_stats`` assumed: the stream holds as many
        rows as the counts add up to, and the key at each group's first
        position is the group's key. Both orders are the keys ascending,
        NULLs last (segmented_groupby's merge and the sort's SortOrder);
        this holds them to it, one read of one flag."""
        nkeys = len(self.groupings)
        bad = None
        for counts, keys_at, rows in checks.values():
            flag = counts.sum() != rows
            if keys_at is not None:
                for c, (d, v) in zip(merged.columns[:nkeys], keys_at):
                    same = (c.validity == v) & (~v | (c.data == d) | (
                        torch.isnan(c.data) & torch.isnan(d)
                        if d.is_floating_point() else False))
                    flag = flag | ((counts > 0) & ~same).any()
            bad = flag if bad is None else bad | flag
        if bad is not None and bool(bad):
            raise RuntimeError(
                "an order statistic's sorted value stream and the merged "
                "groups disagree on the groups' order: each group would "
                "take another's values")

    def _merge_order_stats(self, ctx: ExecContext,
                           partials: List[SpillableBatch],
                           streams: Dict[str, List[SpillableBatch]]
                           ) -> ColumnarBatch:
        """The merge of an aggregation holding an order statistic: the
        partials into one spillable merged batch, the statistics' values
        picked from the sorted streams, the groups' order checked, then
        the finalize."""
        merged_sb = self._merge(ctx, partials, finalize=False)
        try:
            picks, checks = self._order_stats(ctx, merged_sb, streams)

            def finish():
                with ctx.semaphore.held():
                    merged = merged_sb.get()
                    self._check_group_order(merged, checks)
                    nkeys = len(self.groupings)
                    keys = [(c.data, c.validity)
                            for c in merged.columns[:nkeys]]
                    parts = [(d.data, c.validity) for d, c in zip(
                        batch_dvals(merged)[nkeys:-1],
                        merged.columns[nkeys:-1])]
                    return ColumnarBatch(
                        self._decode_keys(keys)
                        + self._finalize_aggs(parts, picks),
                        merged.num_rows, self._schema)
            return with_retry_no_split(finish, ctx=ctx,
                                       op="HashAggregate.merge")
        finally:
            merged_sb.close()

    def _order_stats_merge(self, ctx: ExecContext,
                           partials: List[SpillableBatch],
                           total: int) -> Iterator[ColumnarBatch]:
        """``_merge_order_stats`` over all the partials and streams, or,
        when the partials hold more than ``batchSizeBytes``, over each
        partition of a hash split on the keys: the partials and the value
        streams split alike, so a group's partials and values land in one
        partition, which merges, sorts and picks alone. One output batch
        a partition."""
        if not self._split_merge(ctx, partials, total):
            yield self._merge_order_stats(ctx, partials, self._streams)
            return
        n_parts = self._n_parts(ctx, total)
        slots = self._hash_split(ctx, partials, n_parts)
        held = [slots]
        try:
            split = {}
            for k in self._stream_keys:
                split[k] = self._hash_split(ctx, self._streams[k], n_parts)
                held.append(split[k])
            for p in range(n_parts):
                if slots[p]:
                    yield self._merge_order_stats(
                        ctx, slots[p], {k: s[p] for k, s in split.items()})
        finally:
            # an error or an abandoned consumer: later partitions' slices
            # must not outlive the query (close() is idempotent)
            for got in held:
                for slot in got:
                    for sb in slot:
                        sb.close()

    def _key_column_out(self, i: int, d, v) -> DeviceColumn:
        """A string key of rect key mode as a byte-rectangle column."""
        j = self._dict_keys.index(i)
        return ByteRectColumn(d.bytes_, v, d.lengths,
                              self._rect_ascii.get(j, True))

    def _partial_batch(self, keys, partials, live) -> ColumnarBatch:
        cols = [self._key_column_out(i, d, v) if isinstance(d, StrVal)
                else _agg_column(d, v, f.dtype) for i, ((d, v), f) in
                enumerate(zip(keys + partials + [(live, live)],
                              self._partial_schema.fields))]
        return ColumnarBatch(cols, int(live.shape[0]), self._partial_schema)

    def _empty_partials(self, device) -> ColumnarBatch:
        def empty(f):
            v = torch.zeros(0, dtype=torch.bool, device=device)
            if isinstance(f.dtype, ArrayType):
                from .base import _empty_nested
                return to_device_list(*_empty_nested(f.dtype), f.dtype,
                                      device)
            if f.dtype == STRING:
                return ByteRectColumn(
                    torch.zeros((0, 8), dtype=torch.uint8, device=device), v,
                    torch.zeros(0, dtype=torch.int32, device=device))
            return DeviceColumn(torch.zeros(0, dtype=torch_dtype(f.dtype),
                                            device=device), v, f.dtype)
        return ColumnarBatch([empty(f) for f in self._partial_schema.fields],
                             0, self._partial_schema)

    def _merge_batch(self, big: ColumnarBatch):
        """One ``segmented_groupby`` merge of partial rows: (keys, merged
        partials, groups)."""
        cols = big.columns
        nkeys = len(self.groupings)
        keys = batch_dvals(big)[:nkeys]
        dvals = batch_dvals(big)
        vals, pos = [], nkeys
        for types in self._partial_types:
            vals.append([DVal(dvals[o].data, cols[o].validity, t,
                              dvals[o].column)
                         for o, t in zip(range(pos, pos + len(types)),
                                         types)])
            pos += len(types)
        return segmented_groupby(keys, vals, self.aggs, "merge",
                                 cols[-1].data)

    def _merge(self, ctx: ExecContext, partials: List[SpillableBatch],
               finalize: bool = True):
        """Merge the partials into the final batch (without ``finalize``:
        into one spillable batch of merged partials), closing every one
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
                    if not finalize:
                        return SpillableBatch(self._partial_batch(
                            keys, merged, torch.ones(
                                n, dtype=torch.bool, device=ctx.device)),
                            ctx.memory)
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
            if isinstance(d, StrVal):
                out.append(self._key_column_out(i, d, v))
                continue
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
        #: the row counts of rand/monotonically_increasing_id in the
        #: fused stages and inputs (exprs/nondeterministic.py)
        self._task_state = {}
        from ..exprs.rect_match import PALLAS_ENABLED
        self._use_kernel = bool(ctx.conf.get(PALLAS_ENABLED))
        self._dicts = [dict() for _ in self._dict_keys]
        self._rows_in = 0
        self._rect_keys = set()
        self._rect_ascii = {}
        #: key ordinal -> [its decode table, the next partial to rebuild,
        #: the partials made before it switched] (``_rebuild_partials``)
        self._stale = {}
        self._set_partial_schema()
        self._streams = {k: [] for k in self._stream_keys}
        self.last_stream_buckets = []
        partials: List[SpillableBatch] = []
        try:
            for b in self.children[0].execute(ctx):
                # a batch of no rows adds no group (and its string
                # columns may not have a dictionary form)
                if not b.num_rows:
                    continue
                offset = self._rows_in
                self._rows_in += b.num_rows
                counts = {e: dict(c) for e, c in self._task_state.items()}

                def update(b=b, offset=offset, counts=counts):
                    # a retry counts the batch's rows once
                    self._task_state.clear()
                    self._task_state.update(
                        {e: dict(c) for e, c in counts.items()})
                    with ctx.semaphore.held():
                        srcs = self._key_sources(ctx, b, partials)
                        part, streams = self._update_streams(b, offset,
                                                             srcs)
                        made = [SpillableBatch(part, ctx.memory)]
                        try:
                            for sbatch in streams:
                                made.append(SpillableBatch(sbatch,
                                                           ctx.memory))
                        except BaseException:
                            for sb in made:
                                sb.close()
                            raise
                        return made
                made = with_retry_no_split(update, ctx=ctx,
                                           op="HashAggregate.update")
                partials.append(made[0])
                for k, sb in zip(self._stream_keys, made[1:]):
                    self._streams[k].append(sb)
        except BaseException:
            # a fatal error or QueryTimeout mid-update: the partials must
            # not outlive the query (the zero-leak audit)
            for sb in partials + [x for v in self._streams.values()
                                  for x in v]:
                sb.close()
            raise
        total = sum(sb.device_bytes() for sb in partials)
        self.last_repartitions = 0
        if self._order_aggs:
            try:
                yield from self._order_stats_merge(ctx, partials, total)
            finally:
                for sb in [x for v in self._streams.values() for x in v]:
                    sb.close()
            return
        if self._split_merge(ctx, partials, total):
            yield from self._repartitioned_merge(ctx, partials, total)
            return
        yield self._merge(ctx, partials)

    #: the repartition hash seed: not the shuffle seed (42), so that input
    #: already partitioned on the keys does not fall into one partition
    REPARTITION_SEED = 1879048201

    def _split_merge(self, ctx: ExecContext, partials: List[SpillableBatch],
                     total: int) -> bool:
        """The keyed partials hold more than ``batchSizeBytes`` and their
        keys hash on the device: the merge goes partition by partition."""
        from ..exprs.hash_fns import device_hashable
        return bool(self.groupings and partials) \
            and total > int(ctx.conf.get(BATCH_SIZE_BYTES)) and not any(
                device_hashable.reason_not_supported(f.dtype)
                for f in self._partial_schema.fields[:len(self.groupings)])

    def _n_parts(self, ctx: ExecContext, total: int) -> int:
        """2-64 partitions, about ``batchSizeBytes`` of partials each."""
        n = min(1 << max(1, (int(total) // int(ctx.conf.get(
            BATCH_SIZE_BYTES))).bit_length()), 64)
        self.last_repartitions = n
        return n

    def _hash_split(self, ctx: ExecContext, spillables: List[SpillableBatch],
                    n_parts: int) -> List[List[SpillableBatch]]:
        """Spillable batches whose first columns are the partial keys (the
        partials, a value stream) hash-split on them into ``n_parts``
        slots; the inputs close as they are split."""
        from ..shuffle.partitioning import (partition_batch,
                                            scatter_spillables)
        keys = [ColumnRef(f.name) for f in
                self._partial_schema.fields[:len(self.groupings)]]
        return scatter_spillables(ctx, spillables, lambda b: partition_batch(
            b, keys, n_parts, self.REPARTITION_SEED), n_parts)

    def _repartitioned_merge(self, ctx: ExecContext,
                             partials: List[SpillableBatch],
                             total: int) -> Iterator[ColumnarBatch]:
        """Hash-split the partials on their keys into 2-64 partitions
        (ref ``_repartitioned_merge``) and merge and finalize each alone;
        one output batch a partition."""
        slots = self._hash_split(ctx, partials, self._n_parts(ctx, total))
        try:
            for parts in slots:
                if not parts:
                    continue

                def merge_part(parts=parts):
                    with ctx.semaphore.held():
                        keys_, merged, n = self._merge_batch(
                            concat_batches([s.get() for s in parts]))
                        return ColumnarBatch(
                            self._decode_keys(keys_)
                            + self._finalize_aggs(merged), n, self._schema)
                try:
                    out = with_retry_no_split(merge_part, ctx=ctx,
                                              op="HashAggregate.merge")
                finally:
                    for s in parts:
                        s.close()
                yield out
        finally:
            # an error or an abandoned consumer: later partitions' slices
            # must not outlive the query (close() is idempotent)
            for slot in slots:
                for s in slot:
                    s.close()

    def describe(self):
        g = ", ".join(e.name_hint for e in self.groupings)
        a = ", ".join(x.name_hint for x in self.aggs)
        fused = ""
        if self.pre_stages:
            parts = [("filter" if s[0] == "filter" else "project")
                     for s in self.pre_stages]
            fused = f" fused=[{'+'.join(parts)}]"
        route = ""
        if self._dense_keys() and not self._dense_ok:
            need = [x.name_hint for x in self.aggs if not x.dense_ok]
            route = f" route=sort ({', '.join(need)}: not sums)"
        elif self._int_cards and self._dense_keys():
            route = " route=dense"
        return f"HashAggregate[keys=[{g}], aggs=[{a}]]{fused}{route}"
