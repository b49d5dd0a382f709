"""Physical operator base (port of ``spark_rapids_tpu/exec/base.py``).

A TpuExec produces an iterator of ColumnarBatch on the context's device.
The context carries the conf, the device, the memory manager and the
device semaphore (ref GpuSemaphore.scala:51), and the query's
cooperative deadline; the reference's metrics and tracing wait for a
later slice.
"""
from __future__ import annotations

import time
from typing import Iterator, List, Optional

import torch

from ..columnar import ColumnarBatch
from ..config import SEMAPHORE_WEDGE_TIMEOUT_MS, TASK_TIMEOUT, TpuConf
from ..mem.manager import MemoryManager
from ..mem.retry import RetryStats
from ..mem.semaphore import DeviceSemaphore, QueryTimeout
from ..types import Schema

__all__ = ["ExecContext", "TpuExec", "QueryTimeout"]


class ExecContext:
    """Per-query execution context: conf, device and the shared runtime
    services (memory manager, semaphore), made here when not given."""

    def __init__(self, conf: Optional[TpuConf] = None, device=None,
                 memory: Optional[MemoryManager] = None,
                 semaphore: Optional[DeviceSemaphore] = None):
        self.conf = conf or TpuConf()
        self.device = torch.device(device if device is not None else "cuda")
        self.memory = memory or MemoryManager.get(self.conf, self.device)
        self.semaphore = semaphore or DeviceSemaphore(
            self.conf.concurrent_tpu_tasks,
            timeout_s=float(self.conf.get(TASK_TIMEOUT)),
            wedge_timeout_ms=int(self.conf.get(SEMAPHORE_WEDGE_TIMEOUT_MS)),
            memory=self.memory)
        #: what the OOM ladders of this query did (mem/retry.py)
        self.retry_stats = RetryStats()
        #: the query's cooperative deadline (time.monotonic instant, None
        #: = no timeout); checked per produced batch and polled by the
        #: semaphore's waits (api/dataframe.py sets it per query)
        self.deadline: Optional[float] = None

    def set_query_deadline(self, deadline: Optional[float]) -> None:
        """Install (or with None clear) this query's deadline; the
        semaphore polls the same instant, per thread (a shared semaphore
        must not leak one query's deadline into another's wait)."""
        self.deadline = deadline
        self.semaphore.set_thread_deadline(deadline)

    def check_cancelled(self) -> None:
        """Cooperative cancellation point: raises QueryTimeout past the
        deadline. Called at every produced batch (TpuExec.execute) and
        from the retry ladder."""
        dl = self.deadline
        if dl is not None and time.monotonic() > dl:
            raise QueryTimeout(
                "query exceeded spark.rapids.tpu.query.timeout "
                f"(deadline passed by {time.monotonic() - dl:.3f}s)")


class TpuExec:
    """Base physical operator."""

    #: True if the operator runs its compute on the device
    is_tpu: bool = True

    def __init__(self, children: List["TpuExec"]):
        self.children = children

    def output_schema(self) -> Schema:
        raise NotImplementedError

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        """The operator's batches, with the query's deadline checked at
        each one."""
        for b in self.do_execute(ctx):
            ctx.check_cancelled()
            yield b

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__

    def tree_string(self, indent: int = 0) -> str:
        marker = "*" if self.is_tpu else "!"
        s = "  " * indent + marker + " " + self.describe() + "\n"
        for c in self.children:
            s += c.tree_string(indent + 1)
        return s

    def collect(self, ctx: Optional[ExecContext] = None):
        """Drive the pipeline; per output column the (values, validity)
        numpy arrays of all batches concatenated (device representation:
        DATE as int32 days; a list, map or struct column's values a
        ``HostList``, ``HostMap`` or ``HostStruct``)."""
        import numpy as np
        from ..columnar.batch import _concat_values
        ctx = ctx or ExecContext()
        parts = [b.to_numpy() for b in self.execute(ctx)]
        schema = self.output_schema()
        out = []
        for i, f in enumerate(schema.fields):
            if parts:
                out.append((_concat_values([p[i][0] for p in parts]),
                            np.concatenate([p[i][1] for p in parts])))
            elif f.dtype.np_dtype is None and f.dtype.name != "string":
                out.append(_empty_nested(f.dtype))
            else:
                dt = f.dtype.np_dtype if f.dtype.np_dtype is not None \
                    else object
                out.append((np.zeros(0, dt), np.zeros(0, bool)))
        return out


def _empty_nested(dtype):
    """(no rows of a list, map or struct column, no validity)."""
    import numpy as np
    from ..columnar.batch import HostTable
    from ..columnar.nested import HostList, HostMap, HostStruct
    from ..types import ArrayType, Schema, StructType, map_parts

    def empty_list(t):
        if t.np_dtype is None and t.name not in ("string", "void"):
            vals = _empty_nested(t)[0]
        else:
            vals = np.zeros(0, t.np_dtype or object)
        return HostList(np.zeros(1, np.int64), vals, None, t)
    kv = map_parts(dtype)
    if kv is not None:
        out = HostMap.of(*(empty_list(t) for t in kv))
    elif isinstance(dtype, ArrayType):
        out = empty_list(dtype.element)
    elif isinstance(dtype, StructType):
        out = HostStruct(HostTable(
            {f.name: _empty_nested(f.dtype) if f.dtype.np_dtype is None
             and f.dtype.name != "string" else
             (np.zeros(0, f.dtype.np_dtype or object), np.zeros(0, bool))
             for f in dtype.fields}, Schema(dtype.fields)))
    else:
        raise TypeError(f"{dtype.name} has no empty host form")
    return out, np.zeros(0, bool)
