"""Task-context expressions (port of
``spark_rapids_tpu/exprs/nondeterministic.py``): ``rand``,
``monotonically_increasing_id`` and ``spark_partition_id``.

The reference evaluates them on its host; the port computes the same
values on the device. Each numbers the rows its hosting operator sees in
a partition during one execution, as Spark numbers a task's rows:

  * ``rand(seed)``: ``(splitmix64(i ^ splitmix64(seed + (p << 32))) >>> 11)
    / 2**53`` for row index ``i`` in partition ``p``, bit for bit the
    reference's counter-based draw;
  * ``monotonically_increasing_id()``: ``(p << 33) + i``;
  * ``spark_partition_id()``: ``p``.

The running row counts live in the hosting operator's task state
(``EvalContext.task_state``), which the operator makes anew at the start
of every execution, so a second collect of a DataFrame restarts them as
Spark restarts a task's state (the reference's ``_reset_task_state``).
torch's int64 arithmetic wraps as uint64 arithmetic would; its ``>>`` is
arithmetic, so every logical shift is masked.

``input_file_name`` and its block siblings wait for slice 10's readers
and are refused at planning.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..types import FLOAT64, INT32, INT64, STRING, DataType, Schema
from .base import DVal, Expression

__all__ = ["Rand", "MonotonicallyIncreasingID", "SparkPartitionID",
           "InputFileName", "InputFileBlockStart", "InputFileBlockLength",
           "TaskContextExpression", "splitmix64", "splitmix64_int"]

_M64 = (1 << 64) - 1


def _signed(c: int) -> int:
    """A 64-bit word as the int64 that holds its bits."""
    c &= _M64
    return c - (1 << 64) if c >= 1 << 63 else c


def _lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 lanes holding 64-bit words."""
    return torch.bitwise_and(torch.bitwise_right_shift(x, k),
                             (1 << (64 - k)) - 1)


_G = _signed(0x9E3779B97F4A7C15)
_C1 = _signed(0xBF58476D1CE4E5B9)
_C2 = _signed(0x94D049BB133111EB)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer over int64 lanes (wrapping as uint64)."""
    x = x + _G
    x = (x ^ _lsr(x, 30)) * _C1
    x = (x ^ _lsr(x, 27)) * _C2
    return x ^ _lsr(x, 31)


def splitmix64_int(x: int) -> int:
    """The same over one Python integer: a 64-bit word."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


class TaskContextExpression(Expression):
    """A leaf whose value depends on the row's place in its partition:
    it runs where an operator hosts its task state (a projection, a
    filter or an aggregate's inputs)."""

    children = []

    def references(self):
        return []

    def _rows(self, ctx):
        """(the index of the batch's first row among the rows seen in its
        partition, the partition id); counts the batch's rows."""
        if ctx.task_state is None:
            raise RuntimeError(
                f"{self.name_hint} evaluated where no operator keeps its "
                "task state (it runs in a projection, a filter or an "
                "aggregate's inputs)")
        counts = ctx.task_state.setdefault(self, {})
        pid = ctx.partition_id
        off = counts.get(pid, 0)
        counts[pid] = off + ctx.num_rows
        return off, pid

    def _positions(self, ctx, off: int) -> torch.Tensor:
        return torch.arange(off, off + ctx.padded_len, dtype=torch.int64,
                            device=ctx.device)

    def _valid(self, ctx) -> torch.Tensor:
        return torch.ones(ctx.padded_len, dtype=torch.bool,
                          device=ctx.device)


class MonotonicallyIncreasingID(TaskContextExpression):
    """``(partition_id << 33) + row index``: Spark's formula."""

    def data_type(self, schema: Schema) -> DataType:
        return INT64

    def eval_device(self, ctx) -> DVal:
        off, pid = self._rows(ctx)
        ids = self._positions(ctx, off) + _signed(pid << 33)
        return DVal(ids, self._valid(ctx), INT64)

    def key(self):
        return "MonotonicallyIncreasingID()"

    @property
    def name_hint(self):
        return "monotonically_increasing_id()"


class SparkPartitionID(TaskContextExpression):
    def data_type(self, schema: Schema) -> DataType:
        return INT32

    def eval_device(self, ctx) -> DVal:
        return DVal(torch.full((ctx.padded_len,), ctx.partition_id,
                               dtype=torch.int32, device=ctx.device),
                    self._valid(ctx), INT32)

    def key(self):
        return "SparkPartitionID()"

    @property
    def name_hint(self):
        return "SPARK_PARTITION_ID()"


class Rand(TaskContextExpression):
    """Uniform [0, 1) a row from a counter-based hash of (seed, partition,
    row index): the same values for the same plan run, new ones as a
    re-execution of the same rows in Spark."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def data_type(self, schema: Schema) -> DataType:
        return FLOAT64

    def stream_key(self, pid: int) -> int:
        """``splitmix64(seed + (pid << 32))`` as an int64."""
        return _signed(splitmix64_int((self.seed & _M64) + (pid << 32)))

    def eval_device(self, ctx) -> DVal:
        off, pid = self._rows(ctx)
        mixed = splitmix64(self._positions(ctx, off) ^ self.stream_key(pid))
        u = _lsr(mixed, 11).to(torch.float64) / float(1 << 53)
        return DVal(u, self._valid(ctx), FLOAT64)

    def key(self):
        return f"Rand({self.seed})"

    @property
    def name_hint(self):
        return f"rand({self.seed})"


class _FileBlock(TaskContextExpression):
    name = "?"

    def device_unsupported_reason(self, schema: Schema) -> Optional[str]:
        return (f"{self.name}() arrives with slice 10's readers (ROADMAP.md "
                "Queue A, slice 10)")

    def key(self):
        return f"{type(self).__name__}()"

    @property
    def name_hint(self):
        return f"{self.name}()"


class InputFileName(_FileBlock):
    name = "input_file_name"

    def data_type(self, schema):
        return STRING


class InputFileBlockStart(_FileBlock):
    name = "input_file_block_start"

    def data_type(self, schema):
        return INT64


class InputFileBlockLength(_FileBlock):
    name = "input_file_block_length"

    def data_type(self, schema):
        return INT64
