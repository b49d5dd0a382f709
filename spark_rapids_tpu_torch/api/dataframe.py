"""DataFrame and session API (port of ``spark_rapids_tpu/api/dataframe.py``,
the part the slice reaches).

``TorchSession`` runs queries on one torch device, ``cuda`` unless the
caller names another. Inputs are a dict of numpy arrays, an Arrow
table or pandas DataFrame when those packages are installed, or Parquet
files (``read_parquet``, read by the port's own reader); results
come back as rows (``collect``), numpy arrays (``collect_numpy``), an
Arrow table (``collect_arrow``) or a pandas DataFrame (``to_pandas``); a
list column as Python lists, its (offsets, values, element validity, row
validity) and an Arrow ListArray. A ``select`` holding a generator
(``explode``, ``posexplode``, ``stack``) plans a ``Generate``.
``session.sql(text)`` runs SQL over the session's temp views
(``create_temp_view`` / ``df.create_or_replace_temp_view``; sql/).

A session's queries share its memory manager (mem/manager.py, one per
budget in the process) and one device semaphore
(``spark.rapids.tpu.sql.concurrentTpuTasks`` permits), whatever the
threads they run on; each query runs under
``spark.rapids.tpu.query.timeout``. ``close()`` runs the leak audit when
``spark.rapids.tpu.memory.leakDetection`` is on.
"""
from __future__ import annotations

import datetime
import decimal
import time
from typing import List, Optional

import numpy as np
import torch

from ..columnar.batch import HostTable
from ..columnar.strrect import HostStrings
from ..config import LEAK_DETECTION, QUERY_TIMEOUT, TpuConf
from ..exec.base import ExecContext
from ..exprs.aggregates import AggregateExpression
from ..exprs.base import Alias, ColumnRef, Expression
from ..mem.manager import MemoryManager
from ..plan import logical as L
from ..plan.overrides import plan_query
from ..types import (DATE, NULLTYPE, TIMESTAMP, ArrayType, DecimalType,
                     Schema, StructType, map_parts, to_arrow)
from .functions import Col, _to_expr

__all__ = ["TorchSession", "DataFrame", "GroupedData"]


def _as_expr(c) -> Expression:
    if isinstance(c, str):
        return ColumnRef(c)
    return _to_expr(c)


def _host_table(data) -> HostTable:
    if isinstance(data, HostTable):
        return data
    if isinstance(data, dict):
        return HostTable.from_dict(data)
    mod = type(data).__module__.split(".")[0]
    if mod == "pyarrow":
        return HostTable.from_arrow(data)
    if mod == "pandas":
        import pyarrow as pa
        return HostTable.from_arrow(pa.Table.from_pandas(
            data, preserve_index=False))
    raise TypeError(f"cannot make a table of {type(data).__name__}: give a "
                    "dict of numpy arrays, a pyarrow Table or a pandas "
                    "DataFrame")


class TorchSession:
    """Entry point: ``TorchSession(conf=None, device=None)``. ``conf`` is a
    TpuConf or a dict with the reference's keys; ``device`` defaults to
    ``cuda`` and must be given as ``"cpu"`` to run on the CPU."""

    def __init__(self, conf=None, device=None):
        if isinstance(conf, dict):
            conf = TpuConf(conf)
        self.conf = conf or TpuConf()
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchSession runs on a CUDA device and none is "
                    "available; pass device=\"cpu\" to run on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device=\"cpu\" to run on the CPU")
        # the services every query of the session shares
        services = ExecContext(self.conf, self.device)
        self.memory = services.memory
        self.semaphore = services.semaphore
        #: the OOM ladders' counts of the session's latest query
        self.last_retry_stats = None
        #: the physical plan of the session's latest query
        self.last_plan = None
        #: temp views by lower-case name (``create_temp_view``)
        self._views = {}

    def exec_context(self) -> ExecContext:
        """A query's context over the session's memory and semaphore."""
        return ExecContext(self.conf, self.device, memory=self.memory,
                           semaphore=self.semaphore)

    def close(self) -> None:
        """With spark.rapids.tpu.memory.leakDetection on, raise if a
        device buffer registration outlived its query (the MemoryCleaner
        shutdown check, ref Plugin.scala:573-588). The audit is process
        wide, as the reference's: run it when no other session has a
        query in flight."""
        if self.conf.get(LEAK_DETECTION):
            leaks = MemoryManager.audit_all_leaks()
            if leaks:
                raise AssertionError(
                    f"{len(leaks)} leaked device buffer registration(s) "
                    f"at session close: {leaks[:5]} (set "
                    "SRTPU_LEAK_DEBUG=1 for creation sites)")

    def __enter__(self) -> "TorchSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # never mask the exception in flight with a leak assertion
        if exc_type is None:
            self.close()

    def sql(self, text: str) -> "DataFrame":
        """A SQL query over the session's temp views (the analytics
        subset of sql/; ref ``TpuSession.sql``)."""
        from ..sql import lower_statement
        return lower_statement(self, text, self._views)

    def create_temp_view(self, name: str, df: "DataFrame") -> None:
        self._views[name.lower()] = df

    def drop_temp_view(self, name: str) -> None:
        self._views.pop(name.lower(), None)

    def table(self, name: str) -> "DataFrame":
        """A temp view by name. The warehouse catalog arrives with slice
        10, so any other name is not found."""
        v = self._views.get(name.lower())
        if v is None:
            from ..sql.parser import SqlError
            raise SqlError(f"table or view not found: {name}")
        return v

    def read_parquet(self, *paths: str,
                     columns: Optional[List[str]] = None) -> "DataFrame":
        """A DataFrame over Parquet files: files, directories (every
        ``*.parquet`` below) or globs, after the path replacement rules;
        the schema is the first file's. Read by the port's own reader
        (io/), no pyarrow."""
        from ..io.parquet import parquet_files
        from ..io.parquet_meta import parquet_schema
        files = parquet_files(self.conf, paths)
        schema = parquet_schema(files[0])
        if columns is not None:
            missing = [c for c in columns if c not in schema.names()]
            if missing:
                raise KeyError(f"columns {missing} are not in {files[0]}")
        return DataFrame(self, L.ParquetScan(files, schema, columns))

    def range(self, start: int, end: Optional[int] = None,
              step: int = 1) -> "DataFrame":
        """One bigint column ``id``: ``start``, ``start + step``, ... up to
        ``end`` exclusive (``range(n)`` is 0 .. n-1), made on the device.
        A negative step counts down, as Spark's does."""
        if end is None:
            start, end = 0, start
        if int(step) == 0:
            raise ValueError("the step of a range cannot be 0")
        return DataFrame(self, L.RangeRel(int(start), int(end), int(step)))

    def create_dataframe(self, data, num_partitions: int = 1) -> "DataFrame":
        table = _host_table(data)
        if num_partitions <= 1:
            parts = [table]
        else:
            step = -(-table.num_rows // num_partitions)
            parts = [table.slice(i * step, step)
                     for i in range(num_partitions)]
        return DataFrame(self, L.LogicalScan(parts, table.schema))


def _py_values(vals: np.ndarray, valid: np.ndarray, dtype) -> list:
    """Python values of a collected column: a struct row as a dict, a map
    row as a list of (key, value) tuples, a map's entries as a list of
    ``{"key": k, "value": v}`` dicts (the reference's ``to_pylist``)."""
    if map_parts(dtype) is not None:
        return vals.to_pylist(valid)
    if isinstance(dtype, StructType):
        return vals.to_pylist(valid)
    if isinstance(dtype, ArrayType):
        return vals.to_pylist(valid, dtype.element)
    if isinstance(vals, HostStrings):
        vals = vals.to_objects()
    if dtype == DATE:
        epoch = datetime.date(1970, 1, 1)
        out = [epoch + datetime.timedelta(days=int(x)) for x in vals]
    elif dtype == TIMESTAMP:
        epoch = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
        out = [epoch + datetime.timedelta(microseconds=int(x)) for x in vals]
    elif isinstance(dtype, DecimalType):
        out = _decimals(vals, dtype)
    else:
        out = vals.tolist()
    return [x if ok else None for x, ok in zip(out, valid.tolist())]


def _decimals(vals: np.ndarray, dtype: DecimalType) -> list:
    """Unscaled int64 values as Python ``Decimal``s at the type's scale
    (the reference's ``to_pylist``)."""
    return [decimal.Decimal(x).scaleb(-dtype.scale) for x in vals.tolist()]


def _numpy_values(vals, valid: np.ndarray, dtype):
    """A collected column in ``collect_numpy``'s forms."""
    def elems(c, element):
        if element == DATE:
            return c.astype("datetime64[D]")
        if element == TIMESTAMP:
            return c.astype("datetime64[us]")
        return c
    if map_parts(dtype) is not None:
        k, v = vals.keys.compact(), vals.values.compact()
        return (k.offsets, elems(k.values, k.element),
                elems(v.values, v.element), v.elem_valid, valid)
    if isinstance(dtype, StructType):
        return ({f.name: _numpy_values(*vals.table.columns[f.name], f.dtype)
                 for f in dtype.fields}, valid)
    if isinstance(dtype, ArrayType):
        c = vals.compact()
        return (c.offsets, elems(c.values, dtype.element), c.elem_valid,
                valid)
    return np.ma.MaskedArray(elems(vals, dtype), mask=~valid)


def _arrow_values(vals, valid: np.ndarray, dtype):
    """A collected column as an Arrow array."""
    import pyarrow as pa
    if map_parts(dtype) is not None:
        return vals.to_arrow(valid, dtype)
    if isinstance(dtype, StructType):
        return vals.to_arrow(valid, dtype)
    if isinstance(dtype, ArrayType):
        return vals.to_arrow(valid, dtype.element)
    if isinstance(vals, HostStrings):
        vals = vals.to_objects()
    if dtype == NULLTYPE:
        return pa.nulls(len(valid))
    if isinstance(dtype, DecimalType):
        return pa.array([d if ok else None for d, ok in
                         zip(_decimals(vals, dtype), valid.tolist())],
                        type=to_arrow(dtype))
    if dtype == DATE:
        return pa.array(vals.astype(np.int32), mask=~valid,
                        type=pa.int32()).cast(pa.date32())
    if dtype == TIMESTAMP:
        return pa.array(vals.astype(np.int64), mask=~valid,
                        type=pa.int64()).cast(to_arrow(dtype))
    return pa.array(vals, mask=~valid, type=to_arrow(dtype))


class DataFrame:
    def __init__(self, session: TorchSession, plan: L.LogicalPlan):
        self.session = session
        self.plan = plan
        #: set by ``hint("broadcast")`` / ``functions.broadcast``
        self._broadcast_hint = False

    def hint(self, name: str) -> "DataFrame":
        """Spark's plan hint; only "broadcast" means anything here."""
        df = DataFrame(self.session, self.plan)
        df._broadcast_hint = name.lower() == "broadcast"
        return df

    def join(self, other: "DataFrame", on=None, how: str = "inner",
             condition=None) -> "DataFrame":
        """Join with ``other`` (ref ``DataFrame.join``). ``on``: a column
        name or a list of names (USING: one output column a key, keys
        first), or (left, right) pairs of names or Cols; none for a cross
        or condition-only join. ``condition``: a residual predicate over
        both sides' columns."""
        on_list = [on] if isinstance(on, str) else list(on or [])
        bc = "right" if other._broadcast_hint else (
            "left" if self._broadcast_hint else None)
        cond = _as_expr(condition) if condition is not None else None
        if not (on_list and all(isinstance(k, str) for k in on_list)):
            lk, rk = [], []
            for k in on_list:
                if isinstance(k, str):
                    lk.append(ColumnRef(k))
                    rk.append(ColumnRef(k))
                else:
                    lk.append(_as_expr(k[0]))
                    rk.append(_as_expr(k[1]))
            return DataFrame(self.session, L.Join(
                self.plan, other.plan, how, lk, rk, cond, broadcast=bc))
        # USING-style join (PySpark): one column a key, left's values (the
        # right side's for a right join, both coalesced for a full join).
        # The right side's columns are renamed first so the two sides'
        # names stay apart: keys to __ju_<i>, other clashes to <name>_r.
        keyset = set(on_list)
        lnames = self.plan.schema().names()
        rcols = other.plan.schema().names()
        taken = set(lnames) | set(rcols)
        rmap = {k: f"__ju_{i}" for i, k in enumerate(on_list)}
        for c in rcols:
            if c in keyset or c not in lnames:
                continue
            alt = f"{c}_r"
            while alt in taken:
                alt += "_"
            taken.add(alt)
            rmap[c] = alt
        right = other.select(*[Col(Alias(ColumnRef(c), rmap[c]))
                               if c in rmap else c for c in rcols])
        joined = L.Join(self.plan, right.plan, how,
                        [ColumnRef(k) for k in on_list],
                        [ColumnRef(rmap[k]) for k in on_list], cond,
                        broadcast=bc)
        if joined.join_type in ("leftsemi", "leftanti", "existence"):
            return DataFrame(self.session, joined)
        from ..exprs import Coalesce
        exprs: List[Expression] = []
        for k in on_list:
            if joined.join_type == "right":
                exprs.append(Alias(ColumnRef(rmap[k]), k))
            elif joined.join_type == "full":
                exprs.append(Alias(Coalesce(ColumnRef(k),
                                            ColumnRef(rmap[k])), k))
            else:
                exprs.append(ColumnRef(k))
        exprs += [ColumnRef(c) for c in lnames if c not in keyset]
        exprs += [ColumnRef(rmap.get(c, c)) for c in rcols
                  if c not in keyset]
        return DataFrame(self.session, L.Project(exprs, joined))

    def select(self, *cols) -> "DataFrame":
        exprs = [_as_expr(c) for c in cols]
        gen = self._extract_generator(exprs)
        if gen is not None:
            return gen
        return DataFrame(self.session, L.Project(exprs, self.plan))

    def _extract_generator(self, exprs) -> Optional["DataFrame"]:
        """Spark's ExtractGenerator (ref ``_extract_generator``): a select
        list holding explode/posexplode/stack plans a Generate node, with
        the other expressions evaluated over its pass-through columns."""
        from ..exprs.generators import Generator

        def gen_of(e):
            inner = e.children[0] if isinstance(e, Alias) else e
            return inner if isinstance(inner, Generator) else None
        gen_idx = [i for i, e in enumerate(exprs) if gen_of(e) is not None]
        if not gen_idx:
            return None
        if len(gen_idx) > 1:
            raise ValueError("only one generator allowed per select clause")
        i = gen_idx[0]
        generator = gen_of(exprs[i])
        alias = exprs[i].name if isinstance(exprs[i], Alias) else None
        others = [x for j, x in enumerate(exprs) if j != i]
        needed: List[str] = []
        for o in others:
            for r in o.references():
                if r not in needed:
                    needed.append(r)
        out_names = None
        if alias is not None:
            if len(generator.generator_output(self.plan.schema())) != 1:
                raise ValueError(
                    "single alias on a multi-column generator; use the "
                    "default names instead")
            out_names = [alias]
        plan = L.Generate(generator, needed, self.plan, out_names)
        gen_names = plan.schema().names()[len(needed):]
        top = others[:i] + [ColumnRef(n) for n in gen_names] + others[i:]
        return DataFrame(self.session, L.Project(top, plan))

    def with_column(self, name: str, c) -> "DataFrame":
        exprs: List[Expression] = []
        replaced = False
        for f in self.plan.schema().fields:
            if f.name == name:
                exprs.append(Alias(_as_expr(c), name))
                replaced = True
            else:
                exprs.append(ColumnRef(f.name))
        if not replaced:
            exprs.append(Alias(_as_expr(c), name))
        return DataFrame(self.session, L.Project(exprs, self.plan))

    withColumn = with_column

    def filter(self, cond) -> "DataFrame":
        return DataFrame(self.session, L.Filter(_as_expr(cond), self.plan))

    where = filter

    def group_by(self, *cols) -> "GroupedData":
        return GroupedData(self, [_as_expr(c) for c in cols])

    groupBy = group_by

    def agg(self, *aggs) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs)

    def union(self, other: "DataFrame") -> "DataFrame":
        """Every row of both (SQL UNION ALL): the columns pair by position
        and must have the same types; the names are this side's."""
        mine, theirs = self.plan.schema(), other.plan.schema()
        if [f.dtype for f in mine.fields] != \
                [f.dtype for f in theirs.fields]:
            raise ValueError(f"union of two schemas that differ: {mine} "
                             f"and {theirs}")
        return DataFrame(self.session, L.Union([self.plan, other.plan]))

    unionAll = union

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self.session, L.GlobalLimit(n, self.plan))

    def drop(self, *names: str) -> "DataFrame":
        return self.select(*[c for c in self.columns if c not in names])

    def distinct(self) -> "DataFrame":
        """The distinct rows: a group-by over every column with no
        aggregate."""
        return GroupedData(self, [ColumnRef(n) for n in self.columns]).agg()

    def _nullsafe_key_pairs(self, other: "DataFrame") -> list:
        """Join key pairs giving SQL set-operation equality (ref
        ``_nullsafe_key_pairs``): per column an is-null flag and the value
        with NULL filled by a default, so NULL matches NULL and never a
        real default; NaN matches NaN and -0.0 matches 0.0 through the
        join's key encoding. The columns pair by position."""
        from ..exprs import Coalesce, IsNull, Literal
        mine, theirs = self.plan.schema(), other.plan.schema()
        if len(mine.fields) != len(theirs.fields):
            raise ValueError(
                "set operations require the same number of columns "
                f"({len(mine.fields)} vs {len(theirs.fields)})")
        defaults = {"string": "", "boolean": False, "float": 0.0,
                    "double": 0.0}
        pairs = []
        for lf, rf in zip(mine.fields, theirs.fields):
            d = defaults.get(lf.dtype.name, 0)
            l, r = ColumnRef(lf.name), ColumnRef(rf.name)
            pairs.append((IsNull(l), IsNull(r)))
            pairs.append((Coalesce(l, Literal(d, lf.dtype)),
                          Coalesce(r, Literal(d, rf.dtype))))
        return pairs

    def intersect(self, other: "DataFrame") -> "DataFrame":
        """The distinct rows present in both (SQL INTERSECT): a leftsemi
        join of the distinct rows on the null-safe keys."""
        return self.distinct().join(other, how="leftsemi",
                                    on=self._nullsafe_key_pairs(other))

    def subtract(self, other: "DataFrame") -> "DataFrame":
        """The distinct rows absent from ``other`` (SQL EXCEPT): a leftanti
        join of the distinct rows on the null-safe keys."""
        return self.distinct().join(other, how="leftanti",
                                    on=self._nullsafe_key_pairs(other))

    def _counted_setop(self, other: "DataFrame",
                       all_kind: str) -> "DataFrame":
        """INTERSECT ALL / EXCEPT ALL (ref ``_counted_setop``): each side's
        rows counted by a group-by, the counts joined on the null-safe
        keys, each row's multiplicity (the least of the two counts, or
        the left's less the right's) and the row replicated that many
        times by ``explode(sequence(1, m))``, which the Generate exec runs
        from the counts alone (no list rectangle)."""
        from . import functions as F
        from ..exprs import Coalesce, Least, Literal, Subtract
        from ..exprs.aggregates import CountStar
        names = self.plan.schema().names()
        rnames = other.plan.schema().names()
        lc = GroupedData(self, [ColumnRef(n) for n in names]).agg(
            CountStar().with_name("__so_l"))
        rc = GroupedData(other, [ColumnRef(n) for n in rnames]).agg(
            CountStar().with_name("__so_r"))
        # the right side renamed wholesale: its columns pair by position,
        # and the join's output must not repeat a name
        rmap = {rn: f"__so_r_{i}" for i, rn in enumerate(rnames)}
        rc = rc.select(*([Col(Alias(ColumnRef(rn), rmap[rn]))
                          for rn in rnames] + ["__so_r"]))
        pairs = [(le, _renamed(re, rmap))
                 for le, re in self._nullsafe_key_pairs(other)]
        if all_kind == "intersect":
            j = lc.join(rc, on=pairs, how="inner")
            m = Least(ColumnRef("__so_l"), ColumnRef("__so_r"))
        else:
            j = lc.join(rc, on=pairs, how="left")
            m = Subtract(ColumnRef("__so_l"),
                         Coalesce(ColumnRef("__so_r"), Literal(0)))
        j = j.with_column("__so_m", Col(m)) \
             .filter(F.col("__so_m") > F.lit(0))
        j = j.select(*(names + [F.explode(F.sequence(
            F.lit(1), F.col("__so_m"))).alias("__so_i")]))
        return j.select(*names)

    def intersect_all(self, other: "DataFrame") -> "DataFrame":
        """The rows of both as multisets (SQL INTERSECT ALL): each row as
        often as the fewer of its two counts."""
        return self._counted_setop(other, "intersect")

    def except_all(self, other: "DataFrame") -> "DataFrame":
        """This frame's rows less ``other``'s as multisets (SQL EXCEPT
        ALL): each row as often as its count here exceeds its count
        there."""
        return self._counted_setop(other, "except")

    def sample(self, fraction: float, seed: int = 42) -> "DataFrame":
        """A Bernoulli sample without replacement: each row kept with
        probability ``fraction``, by the reference's draw (one numpy
        RandomState(seed) stream over the rows in order)."""
        if not 0.0 <= float(fraction) <= 1.0:
            raise ValueError(f"a sample's fraction must lie in [0, 1], not "
                             f"{fraction}")
        return DataFrame(self.session,
                         L.Sample(float(fraction), int(seed), self.plan))

    def repartition(self, n: Optional[int] = None, *cols) -> "DataFrame":
        raise NotImplementedError(
            "repartition is an exchange, which arrives with slice 12 "
            "(multi-device and multi-process, ROADMAP.md Queue A)")

    intersectAll = intersect_all
    exceptAll = except_all

    def create_or_replace_temp_view(self, name: str) -> None:
        self.session.create_temp_view(name, self)

    createOrReplaceTempView = create_or_replace_temp_view

    def order_by(self, *orders) -> "DataFrame":
        """Global sort: each order a SortOrder (``Col.asc``/``desc``), a
        column name or a Col (ascending, nulls first)."""
        os = []
        for o in orders:
            if isinstance(o, L.SortOrder):
                os.append(o)
            elif isinstance(o, str):
                os.append(L.SortOrder(ColumnRef(o), True))
            elif isinstance(o, Col):
                os.append(L.SortOrder(o.expr, True))
            else:
                os.append(L.SortOrder(_to_expr(o), True))
        return DataFrame(self.session, L.Sort(os, self.plan))

    orderBy = sort = order_by

    def sort_within_partitions(self, *orders) -> "DataFrame":
        """Each batch sorted alone (Spark's sortWithinPartitions)."""
        df = self.order_by(*orders)
        df.plan.global_sort = False
        return df

    def with_window_column(self, name: str, fn, partition_by=(),
                           order_by=(), frame=None) -> "DataFrame":
        """Add a window-function column (ref ``with_window_column``).
        ``fn`` is a window function (``functions.row_number()`` ...) or
        an aggregate; ``partition_by`` names or Cols; ``order_by``
        SortOrders, names or Cols (ascending); ``frame`` None (Spark's
        default) or ("rows", lo, hi) with None for unbounded."""
        pks = [_as_expr(c) for c in partition_by]
        obs = []
        for o in order_by:
            if isinstance(o, L.SortOrder):
                obs.append(o)
            elif isinstance(o, str):
                obs.append(L.SortOrder(ColumnRef(o), True))
            else:
                obs.append(L.SortOrder(_to_expr(o), True))
        spec = L.WindowSpec(pks, obs, frame)
        return DataFrame(self.session,
                         L.Window([(fn, spec, name)], self.plan))

    def schema(self) -> Schema:
        return self.plan.schema()

    @property
    def columns(self) -> List[str]:
        return self.plan.schema().names()

    def _physical(self):
        return plan_query(self.plan, self.session.conf,
                          self.session.memory.budget)

    def explain(self) -> str:
        """Print and return the physical plan: ``*`` marks a device
        operator."""
        s = self._physical().tree_string()
        print(s)
        return s

    def _collect_columns(self):
        physical = self._physical()
        self.session.last_plan = physical
        ctx = self.session.exec_context()
        self.session.last_retry_stats = ctx.retry_stats
        qt = float(self.session.conf.get(QUERY_TIMEOUT))
        ctx.set_query_deadline(time.monotonic() + qt if qt > 0 else None)
        try:
            return physical.output_schema(), physical.collect(ctx)
        finally:
            ctx.set_query_deadline(None)

    def collect_numpy(self) -> dict:
        """name -> numpy masked array (masked where null); DATE columns as
        datetime64[D], TIMESTAMP as datetime64[us]; a list column as
        (int64 offsets from 0, element values, element validity, row
        validity); a map column as (offsets, keys, values, value
        validity, row validity); a struct column as (name -> its field in
        these forms, row validity)."""
        schema, cols = self._collect_columns()
        return {f.name: _numpy_values(vals, valid, f.dtype)
                for f, (vals, valid) in zip(schema.fields, cols)}

    def collect(self) -> list:
        """Rows as dicts, nulls as None (the reference's collect)."""
        schema, cols = self._collect_columns()
        names = schema.names()
        py = [_py_values(v, m, f.dtype)
              for f, (v, m) in zip(schema.fields, cols)]
        return [dict(zip(names, row)) for row in zip(*py)] if py else []

    def collect_arrow(self):
        import pyarrow as pa
        schema, cols = self._collect_columns()
        arrays = [_arrow_values(vals, valid, f.dtype)
                  for f, (vals, valid) in zip(schema.fields, cols)]
        return pa.Table.from_arrays(arrays, names=schema.names())

    def to_pandas(self):
        """The result as a pandas DataFrame (pandas and pyarrow are
        imported here, and needed only here)."""
        return self.collect_arrow().to_pandas()


def _renamed(e: Expression, names: dict) -> Expression:
    """``e`` with its column references renamed by ``names``."""
    import copy
    if isinstance(e, ColumnRef):
        return ColumnRef(names.get(e.name, e.name))
    if not e.children:
        return e
    out = copy.copy(e)
    out.children = [_renamed(c, names) for c in e.children]
    return out


class GroupedData:
    def __init__(self, df: DataFrame, keys: List[Expression]):
        self.df = df
        self.keys = keys

    def agg(self, *aggs) -> DataFrame:
        for a in aggs:
            assert isinstance(a, AggregateExpression), \
                f"expected aggregate function, got {a!r}"
        return DataFrame(self.df.session,
                         L.Aggregate(self.keys, list(aggs), self.df.plan))
