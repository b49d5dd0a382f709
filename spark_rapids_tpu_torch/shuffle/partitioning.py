"""Device-side batch partitioning (port of
``spark_rapids_tpu/shuffle/partitioning.py``: hash partition ids, the
stable split, ``PartitionedBatches``, ``scatter_spillables`` and
``partition_batch``).

Partition ids are Spark's: the murmur3 fold of the keys from the seed
(42 for a shuffle), then pmod by the partition count, so a row lands
where Spark's HashPartitioning would put it; padding rows go to a
virtual partition past the last. The split is one stable sort of the
ids carrying a row permutation, one gather per column, and one host
read of the per-partition counts; a partition is then a slice of the
sorted columns. A stable sort keeps each partition's rows in input
order.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..columnar import ColumnarBatch
from ..exprs.base import EvalContext, Expression
from ..exprs.compiler import batch_device, batch_dvals, gather_batch
from ..exprs.hash_fns import murmur3_fold_device

__all__ = ["hash_partition_ids", "partition_batch", "PartitionedBatches",
           "scatter_spillables"]


def hash_partition_ids(batch: ColumnarBatch, keys: Sequence[Expression],
                       num_parts: int, seed: int = 42) -> torch.Tensor:
    """int32 partition id per padded row: pmod(murmur3(keys, seed),
    num_parts), ``num_parts`` for padding rows."""
    ctx = EvalContext(batch.schema, batch_dvals(batch), batch.num_rows,
                      batch.padded_len, batch_device(batch))
    h = murmur3_fold_device([e.eval_device(ctx) for e in keys], seed)
    pid = torch.remainder(h.to(torch.int64), num_parts).to(torch.int32)
    return torch.where(ctx.row_mask(), pid,
                       torch.full_like(pid, num_parts))


def _split(batch: ColumnarBatch, pid: torch.Tensor, num_parts: int):
    """The rows stably sorted by partition id, and the rows of each
    partition (the virtual padding partition dropped)."""
    order = torch.sort(pid, stable=True).indices
    counts = torch.bincount(pid.to(torch.int64), minlength=num_parts + 1)
    return gather_batch(batch, order), counts[:num_parts].cpu().numpy()


class PartitionedBatches:
    """One batch split by partition: each partition a slice of the sorted
    batch (views, no copy)."""

    def __init__(self, sorted_batch: ColumnarBatch, counts: np.ndarray):
        self.sorted = sorted_batch
        self.counts = counts
        self.offsets = np.concatenate([[0], np.cumsum(counts)])

    def partition_device(self, p: int) -> ColumnarBatch:
        return self.sorted.slice(int(self.offsets[p]), int(self.counts[p]))


def partition_batch(batch: ColumnarBatch, keys: Sequence[Expression],
                    num_parts: int, seed: int = 42) -> PartitionedBatches:
    pid = hash_partition_ids(batch, keys, num_parts, seed)
    return PartitionedBatches(*_split(batch, pid, num_parts))


def scatter_spillables(ctx, spillables, make_parts, n_parts: int):
    """Partition every spillable batch with ``make_parts(batch) ->
    PartitionedBatches`` and scatter the non-empty slices into
    ``n_parts`` slots, each held spillable. Device work runs under the
    semaphore inside a retried closure that closes its partial output;
    inputs close as they are consumed, and on a failure every slice and
    every input not yet consumed closes."""
    from ..mem.retry import with_retry_no_split
    from ..mem.spillable import SpillableBatch
    slots: List[List[SpillableBatch]] = [[] for _ in range(n_parts)]
    try:
        for sb in spillables:
            def split_one(sb=sb):
                out = []
                try:
                    with ctx.semaphore.held():
                        pb = make_parts(sb.get())
                        for p in range(n_parts):
                            if pb.counts[p]:
                                out.append((p, SpillableBatch(
                                    pb.partition_device(p), ctx.memory)))
                except Exception:
                    for _, s in out:
                        s.close()
                    raise
                return out
            for p, s in with_retry_no_split(split_one, ctx=ctx,
                                            op="scatter"):
                slots[p].append(s)
            sb.close()
    except BaseException:
        for slot in slots:
            for s in slot:
                s.close()
        for sb in spillables:
            sb.close()
        raise
    return slots
