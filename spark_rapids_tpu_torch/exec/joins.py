"""Join execs (port of ``spark_rapids_tpu/exec/joins.py``:
``TpuHashJoinExec``, ``TpuNestedLoopJoinExec``,
``TpuBroadcastHashJoinExec``).

Every equi-join matches through ``exec/join_match.py``: the stream side's
and the build side's keys become int64 words (one a key column, both
sides promoted to one type first; floats as the integers of their total
order, so NaN matches NaN and -0.0 matches 0.0; a dictionary string key
as its code in the union of both sides' dictionaries, with its NULLs
first set to the literal of a ``coalesce(column, 'literal')`` key, the
null-safe key of INTERSECT and EXCEPT), a null key never
matches, and the hash build and probe give the gather maps. The gathers
keep a dictionary column a dictionary column (codes gathered, the
dictionary kept), so a string key of the build side stays one for the
aggregate above.

Join types: inner, left, right, full, leftsemi, leftanti, existence and
cross. A residual condition post-filters an inner or cross join; for the
other types it decides which pairs match (``_finish_pair_join``), over
the inner join's candidate pairs on the keys or, with no keys, over the
cross product (``TpuNestedLoopJoinExec``).

``TpuHashJoinExec`` coalesces both sides, held as ``SpillableBatch``es,
and joins them in one step; past
``spark.rapids.tpu.sql.join.subPartitionSizeBytes`` it hash-splits both
sides on the keys and joins each pair of partitions alone.
``TpuBroadcastHashJoinExec`` joins every stream batch against the
broadcast build side as it arrives, where the join type allows it.
Every device step runs under the semaphore inside ``with_retry_no_split``.
The output of one join is at most ``join_match.MAX_OUTPUT_ROWS`` rows;
the row order of an unordered join differs from the reference's.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..columnar import (ByteRectColumn, ColumnarBatch, DeviceColumn,
                        DictColumn)
from ..columnar.batch import concat_batches
from ..config import JOIN_SUBPARTITION_SIZE
from ..exprs.base import Alias, ColumnRef, EvalContext, Expression, Literal
from ..exprs.conditional import Coalesce
from ..exprs.compiler import (DeviceProjector, batch_device, batch_dvals,
                              filter_batch_by_mask, gather_batch)
from ..mem.retry import with_retry_no_split, wrap_spillable_sides
from ..mem.spillable import SpillableBatch
from ..exprs.cast import as_double
from ..exprs.decimal_arith import scale_up
from ..types import (BOOL, FLOAT32, FLOAT64, STRING, DecimalType, Schema,
                     StructField, torch_dtype)
from .base import ExecContext, TpuExec
from .encoding import _float_order_key
from .join_match import (MAX_OUTPUT_ROWS, BuildTable, build_table,
                         join_match)

__all__ = ["TpuHashJoinExec", "TpuNestedLoopJoinExec",
           "TpuBroadcastHashJoinExec", "empty_batch", "join_schema",
           "encode_keys", "encode_one_side", "string_key_column_name"]

#: the join type seen from the other side (a left build side streams the
#: right side)
_SWAP = {"inner": "inner", "right": "left", "left": "right", "full": "full"}


def join_schema(ls: Schema, rs: Schema, join_type: str,
                exists_name: str = "exists") -> Schema:
    """The output schema (ref ``_join_schema``)."""
    if join_type in ("leftsemi", "leftanti"):
        return Schema(list(ls.fields))
    if join_type == "existence":
        return Schema(list(ls.fields) + [StructField(exists_name, BOOL,
                                                     nullable=False)])
    return Schema(list(ls.fields) + list(rs.fields))


def empty_batch(schema: Schema, device) -> ColumnarBatch:
    """A batch of no rows with ``schema``'s columns (a string column as a
    dictionary column with no entries)."""
    cols = []
    for f in schema.fields:
        valid = torch.zeros(0, dtype=torch.bool, device=device)
        if f.dtype == STRING:
            cols.append(DictColumn(torch.zeros(0, dtype=torch.int32,
                                               device=device), valid, STRING,
                                   np.zeros(0, object)))
        else:
            cols.append(DeviceColumn(torch.zeros(
                0, dtype=torch_dtype(f.dtype), device=device), valid,
                f.dtype))
    return ColumnarBatch(cols, 0, schema)


def _column_ref(e) -> Optional[str]:
    if isinstance(e, Alias):
        e = e.children[0]
    return e.name if isinstance(e, ColumnRef) else None


def _string_fill(e) -> Optional[tuple]:
    """(column name, fill) of a string key ``coalesce(column, 'literal')``
    (the null-safe key of INTERSECT and EXCEPT), else None."""
    if isinstance(e, Alias):
        e = e.children[0]
    if isinstance(e, Coalesce) and len(e.children) == 2:
        c, lit = e.children
        if isinstance(c, ColumnRef) and isinstance(lit, Literal) \
                and isinstance(lit.value, str):
            return c.name, lit.value
    return None


def string_key_column_name(e) -> Optional[str]:
    """The column a string join key reads: a column reference's, or the
    column of ``coalesce(column, 'literal')``; None for other forms."""
    fill = _string_fill(e)
    return fill[0] if fill is not None else _column_ref(e)


def _filled_dictionary(col: DictColumn, fill: str) -> DictColumn:
    """``col`` with its NULLs set to ``fill``, which joins the (sorted)
    dictionary if it is not there."""
    words = np.asarray(col.dictionary, dtype=object)   # NULs kept
    at = int(np.searchsorted(words, fill))
    codes, dictionary = col.data, col.dictionary
    if at == len(words) or words[at] != fill:
        codes = codes + (codes >= at).to(codes.dtype)
        dictionary = np.insert(dictionary, at, fill)
    codes = torch.where(col.validity, codes, torch.full_like(codes, at))
    return DictColumn(codes, torch.ones_like(col.validity), STRING,
                      dictionary)


def _key_values(batch: ColumnarBatch, exprs: Sequence[Expression]):
    """Per key, (DVal, the batch's column when the key passes one
    through); a string key gives no DVal and its column (for
    ``coalesce(column, 'literal')`` with the NULLs filled)."""
    ctx = EvalContext(batch.schema, batch_dvals(batch), batch.num_rows,
                      batch.padded_len, batch_device(batch))
    names = batch.schema.names()
    out = []
    for e in exprs:
        name = string_key_column_name(e) \
            if e.data_type(batch.schema) == STRING else _column_ref(e)
        col = batch.column_by_name(name) if name in names else None
        fill = _string_fill(e)
        if fill is not None and isinstance(col, DictColumn):
            col = _filled_dictionary(col, fill[1])
        out.append((e.eval_device(ctx) if col is None or not (
            isinstance(col, ByteRectColumn) or col.dtype == STRING)
            else None, col))
    return out


def _string_words(lcol, rcol, what: str):
    """Two dictionary columns' codes as codes into the sorted union of
    their dictionaries."""
    for c in (lcol, rcol):
        if not isinstance(c, DictColumn):
            raise NotImplementedError(
                f"join key <{what}> over {c!r}: string join keys other than "
                "dictionary columns (byte rectangles, computed strings) "
                "arrive with the strings slice")
    # object arrays of str: a numpy U array would drop trailing NULs
    union = np.union1d(np.asarray(lcol.dictionary, dtype=object),
                       np.asarray(rcol.dictionary, dtype=object))
    out = []
    for c in (lcol, rcol):
        remap = np.searchsorted(union, np.asarray(c.dictionary, dtype=object)
                                ).astype(np.int64)
        if len(remap):
            t = torch.from_numpy(remap).to(c.data.device)
            out.append(t[c.data.clamp(0, len(remap) - 1).long()])
        else:
            out.append(torch.zeros_like(c.data, dtype=torch.int64))
    return out


def encode_keys(lb: ColumnarBatch, lkeys, rb: ColumnarBatch, rkeys):
    """(left words, left null, right words, right null): int64 [rows, W]
    and bool [rows] per side, W the number of keys (module doc)."""
    lv, rv = _key_values(lb, lkeys), _key_values(rb, rkeys)
    ls, rs = lb.schema, rb.schema
    sides = [([], torch.zeros(lb.num_rows, dtype=torch.bool,
                              device=batch_device(lb))),
             ([], torch.zeros(rb.num_rows, dtype=torch.bool,
                              device=batch_device(rb)))]
    for (la, lcol), (ra, rcol), lk, rk in zip(lv, rv, lkeys, rkeys):
        ldt, rdt = lk.data_type(ls), rk.data_type(rs)
        if (ldt == STRING) != (rdt == STRING):
            raise TypeError(f"join keys <{lk.name_hint}> and "
                            f"<{rk.name_hint}> are a string and a "
                            f"{'number' if ldt == STRING else 'string'}")
        if ldt == STRING:
            lw, rw = _string_words(lcol, rcol, lk.name_hint)
            pairs = [(lw, lcol.validity), (rw, rcol.validity)]
        else:
            pairs = [_key_word(la, ldt, rdt), _key_word(ra, rdt, ldt)]
        for (words, null), (w, valid), b in zip(sides, pairs, (lb, rb)):
            _add_word(words, null, w, valid, b.num_rows)
    return _stack(*sides[0]) + _stack(*sides[1])


def encode_one_side(batch: ColumnarBatch, keys, other_schema: Schema,
                    other_keys):
    """One side's (words, null) of ``encode_keys``, without the other
    side's batch: each key promoted to the type it shares with the other
    side's key, as ``encode_keys`` does. Non-string keys only (a string key
    encodes against both sides' dictionaries): a broadcast join encodes
    its build side once for the table and each stream batch alone."""
    types = [(k.data_type(batch.schema), ok.data_type(other_schema))
             for k, ok in zip(keys, other_keys)]
    for k, (dt, odt) in zip(keys, types):
        if dt == STRING or odt == STRING:
            raise TypeError(f"join key <{k.name_hint}>: a string key "
                            "encodes against both sides")
    null = torch.zeros(batch.num_rows, dtype=torch.bool,
                       device=batch_device(batch))
    words: list = []
    for (v, _), (dt, odt) in zip(_key_values(batch, keys), types):
        _add_word(words, null, *_key_word(v, dt, odt), batch.num_rows)
    return _stack(words, null)


def _key_word(v, dt, odt):
    """(int64 word, validity) of a non-string key beside the other side's
    key type ``odt``: both promoted to their common type. Decimals (or a
    decimal beside an integral key) compare at the larger scale, each
    side's unscaled value rescaled exactly; a value whose rescale passes
    int64 equals nothing on the other side, so it joins as a NULL key
    does. A decimal beside a float is its nearest double (Spark's
    cast)."""
    if isinstance(dt, DecimalType) or isinstance(odt, DecimalType):
        if dt in (FLOAT32, FLOAT64) or odt in (FLOAT32, FLOAT64):
            return _float_order_key(as_double(v)), v.validity
        top = max(t.scale for t in (dt, odt) if isinstance(t, DecimalType))
        k = top - (dt.scale if isinstance(dt, DecimalType) else 0)
        d, fits = scale_up(v.data.to(torch.int64), k)
        return d, v.validity & fits
    common = torch.promote_types(torch_dtype(dt), torch_dtype(odt))
    return _number_words(v, common), v.validity


def _number_words(v, common: torch.dtype) -> torch.Tensor:
    """A number, date or boolean key as int64 words of ``common``: floats
    as the integers of their total order."""
    d = v.data.to(common)
    return (_float_order_key(d) if d.is_floating_point() else d).to(
        torch.int64)


def _add_word(words: list, null: torch.Tensor, w: torch.Tensor,
              valid: torch.Tensor, rows: int) -> None:
    w, valid = w[:rows], valid[:rows]
    words.append(torch.where(valid, w, torch.zeros_like(w)))
    null |= ~valid


def _stack(words: list, null: torch.Tensor):
    n = null.shape[0]
    return (torch.stack(words, dim=1) if words else
            torch.zeros((n, 0), dtype=torch.int64, device=null.device),
            null)


def _cat_columns(lo: ColumnarBatch, ro: ColumnarBatch,
                 schema: Schema) -> ColumnarBatch:
    return ColumnarBatch(lo.columns + ro.columns, lo.num_rows, schema)


def _condition_mask(cond: Expression, batch: ColumnarBatch) -> torch.Tensor:
    col = DeviceProjector([cond], batch.schema).run(batch)[0]
    return torch.logical_and(col.data, col.validity)


def _check_pairs(n: int, what: str) -> None:
    if n > MAX_OUTPUT_ROWS:
        raise OverflowError(f"{what}: {n} candidate pairs exceed "
                            f"{MAX_OUTPUT_ROWS} rows")


def _cross_maps(n_l: int, n_r: int, device):
    _check_pairs(n_l * n_r, "cross product")
    k = torch.arange(n_l * n_r, dtype=torch.int64, device=device)
    nr = max(n_r, 1)
    return k // nr, k % nr


def _finish_pair_join(join_type: str, lb: ColumnarBatch, rb: ColumnarBatch,
                      l_row: torch.Tensor, r_row: torch.Tensor,
                      condition: Optional[Expression],
                      out_schema: Schema) -> ColumnarBatch:
    """Any join from a candidate pair set (ref ``_finish_pair_join``): the
    condition decides which pairs match, then each type emits; outer
    joins give the matched pairs, then the unmatched left rows, then the
    unmatched right rows."""
    dev = l_row.device
    if condition is not None and l_row.shape[0]:
        pair_schema = Schema(list(lb.schema.fields) + list(rb.schema.fields))
        pairs = _cat_columns(gather_batch(lb, l_row),
                             gather_batch(rb, r_row), pair_schema)
        match = _condition_mask(condition, pairs)
    else:
        match = torch.ones(l_row.shape[0], dtype=torch.bool, device=dev)
    ml = torch.bincount(l_row[match], minlength=lb.num_rows)[:lb.num_rows]
    if join_type in ("leftsemi", "leftanti"):
        return filter_batch_by_mask(lb, ml > 0 if join_type == "leftsemi"
                                    else ml == 0)
    if join_type == "existence":
        return ColumnarBatch(lb.columns + [DeviceColumn(
            ml > 0, torch.ones(lb.num_rows, dtype=torch.bool, device=dev),
            BOOL)], lb.num_rows, out_schema)
    gl, gr = [l_row[match]], [r_row[match]]
    if join_type in ("left", "full"):
        u = torch.nonzero(ml == 0, as_tuple=True)[0]
        gl.append(u)
        gr.append(torch.full_like(u, -1))
    if join_type in ("right", "full"):
        mr = torch.bincount(r_row[match], minlength=rb.num_rows)[
            :rb.num_rows]
        u = torch.nonzero(mr == 0, as_tuple=True)[0]
        gl.append(torch.full_like(u, -1))
        gr.append(u)
    gl, gr = torch.cat(gl), torch.cat(gr)
    _check_pairs(int(gl.shape[0]), f"{join_type} join")
    return _cat_columns(gather_batch(lb, gl), gather_batch(rb, gr),
                        out_schema)


class TpuHashJoinExec(TpuExec):
    """Equi-join of two coalesced sides (ref ``TpuHashJoinExec``): the
    left side streams through the right side's table."""

    #: sub-partition hash seed, deliberately not the shuffle seed (42):
    #: after a repartition on the join keys every row of a task has the
    #: same murmur3_42(key) % P, so the same seed would put every row in
    #: one sub-partition (ref GpuSubPartitionHashJoin)
    SUBPARTITION_SEED = 1610612741

    def __init__(self, left: TpuExec, right: TpuExec, join_type: str,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 condition: Optional[Expression] = None):
        super().__init__([left, right])
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.condition = condition
        self._schema = join_schema(left.output_schema(),
                                   right.output_schema(), join_type)
        #: the sub-partition count of the latest execution (0: none)
        self.last_subpartitions = 0

    def output_schema(self) -> Schema:
        return self._schema

    def _sides(self, ctx: ExecContext):
        """Both sides' batches, held spillable (right first, as the
        reference builds)."""
        right, left = wrap_spillable_sides(
            ctx.memory, self.children[1].execute(ctx),
            self.children[0].execute(ctx))
        return left, right

    def _coalesce(self, ctx, side: List[SpillableBatch], i: int):
        if not side:
            return empty_batch(self.children[i].output_schema(), ctx.device)
        return concat_batches([s.get() for s in side])

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        left, right = self._sides(ctx)
        ls, rs = (self.children[0].output_schema(),
                  self.children[1].output_schema())
        total_bytes = sum(s.device_bytes() for s in left + right)
        threshold = int(ctx.conf.get(JOIN_SUBPARTITION_SIZE))
        self.last_subpartitions = 0
        if (threshold > 0 and total_bytes > threshold and self.left_keys
                and self.join_type != "cross" and self.condition is None
                and self._subpartitionable(ls, rs)):
            yield from self._subpartitioned(ctx, left, right, total_bytes,
                                            threshold)
            return

        def run():
            with ctx.semaphore.held():
                return self._join(self._coalesce(ctx, left, 0),
                                  self._coalesce(ctx, right, 1))
        try:
            out = with_retry_no_split(run, ctx=ctx, op="HashJoin")
        finally:
            for s in left + right:
                s.close()
        yield out

    def _subpartitionable(self, ls: Schema, rs: Schema) -> bool:
        """Both sides hash every key identically: a device-hashable type
        and the same type on both sides (the partitioner hashes raw
        values; int32 5 and int64 5 hash apart)."""
        from ..exprs.hash_fns import device_hashable
        for lk, rk in zip(self.left_keys, self.right_keys):
            ldt, rdt = lk.data_type(ls), rk.data_type(rs)
            if device_hashable.reason_not_supported(ldt) \
                    or ldt.np_dtype != rdt.np_dtype \
                    or (ldt != rdt and (isinstance(ldt, DecimalType)
                                        or isinstance(rdt, DecimalType))):
                return False
        return True

    def _subpartitioned(self, ctx, left, right, total_bytes: int,
                        threshold: int) -> Iterator[ColumnarBatch]:
        """Hash both sides into N sub-partitions on the same key hash and
        join each pair alone: equal keys share a partition, so every
        equi-join type distributes over the split. Outputs are held
        spillable and yielded after the semaphore is released."""
        from ..shuffle.partitioning import partition_batch
        n_parts = min(1 << max(1, (int(total_bytes) // threshold)
                               .bit_length()), 64)
        self.last_subpartitions = n_parts

        def run():
            outs = []
            try:
                with ctx.semaphore.held():
                    lp = partition_batch(self._coalesce(ctx, left, 0),
                                         self.left_keys, n_parts,
                                         self.SUBPARTITION_SEED)
                    rp = partition_batch(self._coalesce(ctx, right, 1),
                                         self.right_keys, n_parts,
                                         self.SUBPARTITION_SEED)
                    for p in range(n_parts):
                        lbp, rbp = lp.partition_device(p), \
                            rp.partition_device(p)
                        if not lbp.num_rows and not rbp.num_rows:
                            continue
                        out = self._join(lbp, rbp)
                        if out.num_rows:
                            outs.append(SpillableBatch(out, ctx.memory))
            except BaseException:
                for s in outs:
                    s.close()
                raise
            return outs
        try:
            outs = with_retry_no_split(run, ctx=ctx, op="HashJoin.sub")
        finally:
            for s in left + right:
                s.close()
        try:
            for s in outs:
                b = s.get()
                s.close()
                yield b
        except BaseException:
            for s in outs:
                s.close()
            raise

    # ------------------------------------------------------------------
    def _encode(self, stream: ColumnarBatch, build: ColumnarBatch,
                build_side: str):
        """(stream words, stream null, build words, build null)."""
        if build_side == "right":
            return encode_keys(stream, self.left_keys, build,
                               self.right_keys)
        bw, bn, sw, sn = encode_keys(build, self.left_keys, stream,
                                     self.right_keys)
        return sw, sn, bw, bn

    def _side_keys(self, build_side: str):
        """(stream keys, build keys)."""
        return (self.left_keys, self.right_keys) if build_side == "right" \
            else (self.right_keys, self.left_keys)

    def _join(self, lb: ColumnarBatch, rb: ColumnarBatch,
              build_side: str = "right",
              table: Optional[BuildTable] = None) -> ColumnarBatch:
        """Join two batches; the build side is ``build_side``'s (a
        prepared ``table`` of it may be given)."""
        jt = self.join_type
        if jt == "cross" or not self.left_keys:
            li, ri = _cross_maps(lb.num_rows, rb.num_rows, batch_device(lb))
            return self._finish_cross(lb, rb, li, ri)
        stream, build = (lb, rb) if build_side == "right" else (rb, lb)
        if table is None:
            sw, sn, bw, bn = self._encode(stream, build, build_side)
            table = build_table(bw, bn)
        else:                     # the build side's words are in the table
            skeys, bkeys = self._side_keys(build_side)
            sw, sn = encode_one_side(stream, skeys, build.schema, bkeys)
        if self.condition is not None and jt != "inner":
            maps = join_match(sw, sn, table, "inner")
            li, ri = (maps.stream, maps.build) if build_side == "right" \
                else (maps.build, maps.stream)
            return _finish_pair_join(jt, lb, rb, li, ri, self.condition,
                                     self._schema)
        maps = join_match(sw, sn, table, jt if build_side == "right"
                          else _SWAP[jt])
        if jt in ("leftsemi", "leftanti"):
            return gather_batch(lb, maps.stream, self._schema)
        if jt == "existence":
            return ColumnarBatch(lb.columns + [DeviceColumn(
                maps.flags, torch.ones_like(maps.flags), BOOL)],
                lb.num_rows, self._schema)
        li, ri = (maps.stream, maps.build) if build_side == "right" \
            else (maps.build, maps.stream)
        out = _cat_columns(gather_batch(lb, li), gather_batch(rb, ri),
                           self._schema)
        if self.condition is not None:
            out = filter_batch_by_mask(out, _condition_mask(self.condition,
                                                            out))
        return out

    def _finish_cross(self, lb, rb, li, ri) -> ColumnarBatch:
        if self.join_type in ("cross", "inner"):
            out = _cat_columns(gather_batch(lb, li), gather_batch(rb, ri),
                               self._schema)
            if self.condition is not None:
                out = filter_batch_by_mask(
                    out, _condition_mask(self.condition, out))
            return out
        return _finish_pair_join(self.join_type, lb, rb, li, ri,
                                 self.condition, self._schema)

    def describe(self):
        k = ", ".join(f"{a.name_hint}={b.name_hint}"
                      for a, b in zip(self.left_keys, self.right_keys))
        c = f", cond={self.condition.name_hint}" if self.condition else ""
        return f"HashJoin[{self.join_type}, keys=({k}){c}]"


class TpuNestedLoopJoinExec(TpuHashJoinExec):
    """Join with no equi keys (ref ``TpuNestedLoopJoinExec``): the
    candidate pairs are the whole cross product of the coalesced sides;
    the condition post-filters a cross or inner join and decides the
    matches of the other types."""

    def __init__(self, left: TpuExec, right: TpuExec, join_type: str,
                 condition: Optional[Expression] = None):
        super().__init__(left, right, join_type, [], [], condition)

    def describe(self):
        c = f", cond={self.condition.name_hint}" if self.condition else ""
        return f"NestedLoopJoin[{self.join_type}{c}]"


class TpuBroadcastHashJoinExec(TpuHashJoinExec):
    """Equi-join against a broadcast build side (ref
    ``TpuBroadcastHashJoinExec``): the build child is a
    ``BroadcastExchangeExec`` whose one batch is built once a query and
    joined with every stream batch as it arrives, through one prepared
    table when the keys hold no string. Join types that need the build
    side's unmatched rows across all stream batches (or a stream side's
    whole set) take the coalesced path."""

    #: join types that stream, per build side
    STREAMABLE = {
        "right": ("inner", "left", "leftsemi", "leftanti", "existence",
                  "cross"),
        "left": ("inner", "right", "cross"),
    }

    def __init__(self, left, right, join_type, left_keys, right_keys,
                 condition=None, build_side: str = "right"):
        super().__init__(left, right, join_type, left_keys, right_keys,
                         condition)
        if build_side not in ("left", "right"):
            raise ValueError(f"build_side is left or right, not "
                             f"{build_side}")
        self.build_side = build_side

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        from ..shuffle.broadcast import BroadcastExchangeExec
        bi = 1 if self.build_side == "right" else 0
        build = self.children[bi]
        if (self.join_type not in self.STREAMABLE[self.build_side]
                or not isinstance(build, BroadcastExchangeExec)):
            yield from super().do_execute(ctx)
            return
        held = build.broadcast(ctx)
        try:
            # the table depends on the build side's keys alone (string
            # keys: on both sides' dictionaries), so one serves every
            # stream batch, and survives a spill of the batch
            strings = any(k.data_type(build.output_schema()) == STRING
                          for k in (self.right_keys if bi else
                                    self.left_keys))
            reuse = bool(self.left_keys) and self.join_type != "cross" \
                and not strings
            table: List[BuildTable] = []
            produced = False
            for sb in self.children[1 - bi].execute(ctx):
                def run(sb=sb):
                    with ctx.semaphore.held():
                        bb = held.get()
                        if reuse and not table:
                            skeys, bkeys = self._side_keys(self.build_side)
                            table.append(build_table(*encode_one_side(
                                bb, bkeys, sb.schema, skeys)))
                        lb, rb = (sb, bb) if bi else (bb, sb)
                        return self._join(lb, rb, self.build_side,
                                          table[0] if table else None)
                out = with_retry_no_split(run, ctx=ctx,
                                          op="BroadcastHashJoin")
                produced = True
                yield out
            if not produced:
                empty = empty_batch(self.children[1 - bi].output_schema(),
                                    ctx.device)

                def run_empty():
                    with ctx.semaphore.held():
                        bb = held.get()
                        lb, rb = (empty, bb) if bi else (bb, empty)
                        return self._join(lb, rb, self.build_side)
                yield with_retry_no_split(run_empty, ctx=ctx,
                                          op="BroadcastHashJoin")
        finally:
            build.release(ctx)

    def describe(self):
        return "Broadcast" + super().describe()[:-1] + \
            f", build={self.build_side}]"
