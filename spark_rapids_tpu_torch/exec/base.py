"""Physical operator base (port of ``spark_rapids_tpu/exec/base.py``).

A TpuExec produces an iterator of ColumnarBatch on the context's device.
The port's context carries the conf and the device; the reference's
memory manager, semaphore, metrics and tracing wait for later slices.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import torch

from ..columnar import ColumnarBatch
from ..config import TpuConf
from ..types import Schema

__all__ = ["ExecContext", "TpuExec"]


class ExecContext:
    """Per-query execution context: conf + device."""

    def __init__(self, conf: Optional[TpuConf] = None, device=None):
        self.conf = conf or TpuConf()
        self.device = torch.device(device if device is not None else "cuda")


class TpuExec:
    """Base physical operator."""

    #: True if the operator runs its compute on the device
    is_tpu: bool = True

    def __init__(self, children: List["TpuExec"]):
        self.children = children

    def output_schema(self) -> Schema:
        raise NotImplementedError

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        return self.do_execute(ctx)

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
        DATE as int32 days)."""
        import numpy as np
        ctx = ctx or ExecContext()
        parts = [b.to_numpy() for b in self.execute(ctx)]
        schema = self.output_schema()
        out = []
        for i, f in enumerate(schema.fields):
            if parts:
                out.append((np.concatenate([p[i][0] for p in parts]),
                            np.concatenate([p[i][1] for p in parts])))
            else:
                dt = f.dtype.np_dtype if f.dtype.np_dtype is not None \
                    else object
                out.append((np.zeros(0, dt), np.zeros(0, bool)))
        return out
