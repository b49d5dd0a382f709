"""DataFrame and session API (port of ``spark_rapids_tpu/api/dataframe.py``,
the part the slice reaches).

``TorchSession`` runs queries on one torch device, ``cuda`` unless the
caller names another. Inputs are a dict of numpy arrays, or an Arrow
table or pandas DataFrame when those packages are installed; results
come back as rows (``collect``), numpy arrays (``collect_numpy``) or an
Arrow table (``collect_arrow``).

A session's queries share its memory manager (mem/manager.py, one per
budget in the process) and one device semaphore
(``spark.rapids.tpu.sql.concurrentTpuTasks`` permits), whatever the
threads they run on; each query runs under
``spark.rapids.tpu.query.timeout``. ``close()`` runs the leak audit when
``spark.rapids.tpu.memory.leakDetection`` is on.
"""
from __future__ import annotations

import datetime
import time
from typing import List

import numpy as np
import torch

from ..columnar.batch import HostTable
from ..config import LEAK_DETECTION, QUERY_TIMEOUT, TpuConf
from ..exec.base import ExecContext
from ..exprs.aggregates import AggregateExpression
from ..exprs.base import Alias, ColumnRef, Expression
from ..mem.manager import MemoryManager
from ..plan import logical as L
from ..plan.overrides import plan_query
from ..types import DATE, TIMESTAMP, Schema
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
    if dtype == DATE:
        epoch = datetime.date(1970, 1, 1)
        out = [epoch + datetime.timedelta(days=int(x)) for x in vals]
    elif dtype == TIMESTAMP:
        epoch = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
        out = [epoch + datetime.timedelta(microseconds=int(x)) for x in vals]
    else:
        out = vals.tolist()
    return [x if ok else None for x, ok in zip(out, valid.tolist())]


class DataFrame:
    def __init__(self, session: TorchSession, plan: L.LogicalPlan):
        self.session = session
        self.plan = plan

    def select(self, *cols) -> "DataFrame":
        return DataFrame(self.session,
                         L.Project([_as_expr(c) for c in cols], self.plan))

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

    def schema(self) -> Schema:
        return self.plan.schema()

    @property
    def columns(self) -> List[str]:
        return self.plan.schema().names()

    def _physical(self):
        return plan_query(self.plan, self.session.conf)

    def explain(self) -> str:
        """Print and return the physical plan: ``*`` marks a device
        operator."""
        s = self._physical().tree_string()
        print(s)
        return s

    def _collect_columns(self):
        physical = self._physical()
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
        datetime64[D], TIMESTAMP as datetime64[us]."""
        schema, cols = self._collect_columns()
        out = {}
        for f, (vals, valid) in zip(schema.fields, cols):
            if f.dtype == DATE:
                vals = vals.astype("datetime64[D]")
            elif f.dtype == TIMESTAMP:
                vals = vals.astype("datetime64[us]")
            out[f.name] = np.ma.MaskedArray(vals, mask=~valid)
        return out

    def collect(self) -> list:
        """Rows as dicts, nulls as None (the reference's collect)."""
        schema, cols = self._collect_columns()
        names = schema.names()
        py = [_py_values(v, m, f.dtype)
              for f, (v, m) in zip(schema.fields, cols)]
        return [dict(zip(names, row)) for row in zip(*py)] if py else []

    def collect_arrow(self):
        import pyarrow as pa
        from ..types import to_arrow
        schema, cols = self._collect_columns()
        arrays = []
        for f, (vals, valid) in zip(schema.fields, cols):
            if f.dtype == DATE:
                arr = pa.array(vals.astype(np.int32), mask=~valid,
                               type=pa.int32()).cast(pa.date32())
            elif f.dtype == TIMESTAMP:
                arr = pa.array(vals.astype(np.int64), mask=~valid,
                               type=pa.int64()).cast(to_arrow(f.dtype))
            else:
                arr = pa.array(vals, mask=~valid, type=to_arrow(f.dtype))
            arrays.append(arr)
        return pa.Table.from_arrays(arrays, names=schema.names())


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
