"""Broadcast exchange (port of ``spark_rapids_tpu/shuffle/broadcast.py``,
ref GpuBroadcastExchangeExec.scala).

One process runs the query, so a broadcast is the child's result built
once a query into one coalesced batch, held as a ``SpillableBatch`` of
the lowest spill priority (it is cheap to rebuild), and handed to every
stream batch of the join that consumes it. The join releases it when its
stream ends.
"""
from __future__ import annotations

from typing import Iterator

from ..columnar import ColumnarBatch
from ..columnar.batch import concat_batches
from ..exec.base import ExecContext, TpuExec
from ..mem.retry import with_retry_no_split, wrap_spillables
from ..mem.spillable import SpillableBatch, SpillPriorities
from ..types import Schema

__all__ = ["BroadcastExchangeExec"]


class BroadcastExchangeExec(TpuExec):
    """Build-once, consume-many exchange: ``broadcast(ctx)`` gives the
    held batch, made at the first call of a query (per context)."""

    def __init__(self, child: TpuExec):
        super().__init__([child])
        self._schema = child.output_schema()

    def output_schema(self) -> Schema:
        return self._schema

    def _cache(self, ctx: ExecContext) -> dict:
        cache = getattr(ctx, "_broadcast_cache", None)
        if cache is None:
            cache = ctx._broadcast_cache = {}
        return cache

    def broadcast(self, ctx: ExecContext) -> SpillableBatch:
        cache = self._cache(ctx)
        sb = cache.get(id(self))
        if sb is None:
            from ..exec.joins import empty_batch
            parts = wrap_spillables(self.children[0].execute(ctx),
                                    ctx.memory)

            def build():
                with ctx.semaphore.held():
                    return concat_batches([s.get() for s in parts]) \
                        if parts else empty_batch(self._schema, ctx.device)
            try:
                out = with_retry_no_split(build, ctx=ctx,
                                          op="BroadcastExchange")
            finally:
                for s in parts:
                    s.close()
            sb = cache[id(self)] = SpillableBatch(
                out, ctx.memory,
                spill_priority=SpillPriorities.OUTPUT_FOR_SHUFFLE)
        return sb

    def release(self, ctx: ExecContext) -> None:
        """Close the query's held batch (its consumer is done)."""
        sb = self._cache(ctx).pop(id(self), None)
        if sb is not None:
            sb.close()

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        try:
            b = self.broadcast(ctx).get()
        finally:
            self.release(ctx)
        yield b

    def describe(self):
        return "BroadcastExchange"
