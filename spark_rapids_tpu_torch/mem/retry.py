"""The OOM retry / split-and-retry escalation ladder (port of
``spark_rapids_tpu/mem/retry.py``).

Reference analog: RmmRapidsRetryIterator.scala:33-200 (withRetry /
withRetryNoSplit / splitAndRetry), driven by GpuRetryOOM /
GpuSplitAndRetryOOM thrown from the allocator, plus the Retryable.scala
CheckpointRestore contract that keeps retried operator state
side-effect-free. Three rungs:

1. **retry**    -- ``RetryOOM``: restore checkpoints, spill this
   manager's device tier, run the attempt again (bounded).
2. **split**    -- ``SplitAndRetryOOM``: halve the input and process the
   pieces recursively, bounded by ``spark.rapids.tpu.oom.maxSplitDepth``
   (ref splitSpillableInHalfByRows).
3. **pressure** -- cross-session spill: every live MemoryManager's
   spillables move off the device so the one starving operator gets the
   whole budget.

The reference's fourth rung runs the starving attempt on the host
backend (``_Ladder.degrade``, ``spark.rapids.tpu.oom.hostFallback``).
The port has no host engine and never moves device work to the CPU: its
ladder ends in ``OutOfDeviceMemory`` naming the operator and the rungs
tried, the reference's behaviour with ``hostFallback.enabled=false``.

Invariants the ladder keeps:

  * the attempted function must be idempotent over its (spillable)
    input; mutable operator state passes a :class:`CheckpointRestore`
    via ``retryable=`` and is restored before every re-attempt;
  * ``close()`` is idempotent, so every rung releases exactly what it
    was handed: no path leaks a registered spillable.
"""
from __future__ import annotations

import time
from typing import Callable, Iterable, Iterator, List, Optional, TypeVar

from ..config import OOM_MAX_SPLIT_DEPTH, TpuConf
from .manager import (MemoryManager, OutOfDeviceMemory, RetryOOM,
                      SplitAndRetryOOM)
from .spillable import SpillableBatch

__all__ = ["with_retry_no_split", "with_retry", "split_batch_in_half",
           "RetryStats", "CheckpointRestore", "wrap_spillables",
           "wrap_spillable_sides"]

T = TypeVar("T")
MAX_RETRIES = 100
#: extra attempts granted after the cross-session pressure rung fires
PRESSURE_ATTEMPTS = 2


class RetryStats:
    def __init__(self):
        self.retries = 0
        self.splits = 0
        self.pressure_spills = 0

    def as_dict(self) -> dict:
        return {"retries": self.retries, "splits": self.splits,
                "pressure_spills": self.pressure_spills}


class CheckpointRestore:
    """Mutable operator state that must survive OOM retries (ref
    Retryable.scala CheckpointRestore): ``checkpoint()`` is called once
    before the first attempt, ``restore()`` before every re-attempt."""

    def checkpoint(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError


def wrap_spillable_sides(mm: MemoryManager, *batch_iters: Iterable
                         ) -> List[List[SpillableBatch]]:
    """``wrap_spillables`` over several input streams with cross-stream
    cleanup: if wrapping a later stream fails, every batch already
    wrapped from the earlier streams closes too before the exception
    re-raises."""
    sides: List[List[SpillableBatch]] = []
    try:
        for it in batch_iters:
            sides.append(wrap_spillables(it, mm))
        return sides
    except BaseException:
        for side in sides:
            for sb in side:
                sb.close()
        raise


def wrap_spillables(batches: Iterable, mm: MemoryManager
                    ) -> List[SpillableBatch]:
    """Exception-safe bulk wrap: closes the batches already wrapped when
    a later wrap (or the producing iterator, e.g. a QueryTimeout) raises,
    so cancellation and OOM paths hold the zero-leak audit."""
    out: List[SpillableBatch] = []
    try:
        for b in batches:
            out.append(SpillableBatch(b, mm))
        return out
    except BaseException:
        for sb in out:
            sb.close()
        raise


class _Ladder:
    """Shared escalation state for one with_retry / with_retry_no_split
    call: checkpointed retryables, the one-shot pressure rung, and what
    the ladder tried (for the final error)."""

    def __init__(self, mm: MemoryManager, stats: Optional[RetryStats],
                 retryable, ctx, op: Optional[str]):
        self.mm = mm
        self.stats = stats if stats is not None else \
            getattr(ctx, "retry_stats", None)
        self.retryables = ([] if retryable is None else
                           list(retryable) if isinstance(retryable,
                                                         (list, tuple))
                           else [retryable])
        self.ctx = ctx
        self.op = op
        self.pressured = False
        self.tried = {"retries": 0, "splits": 0}
        for r in self.retryables:
            r.checkpoint()

    def check_cancelled(self) -> None:
        if self.ctx is not None:
            self.ctx.check_cancelled()

    def restore(self) -> None:
        for r in self.retryables:
            r.restore()

    def note_retry(self) -> None:
        self.tried["retries"] += 1
        if self.stats is not None:
            self.stats.retries += 1
        self.restore()

    def note_split(self) -> None:
        self.tried["splits"] += 1
        if self.stats is not None:
            self.stats.splits += 1
        self.restore()

    def max_split_depth(self, override: Optional[int]) -> int:
        if override is not None:
            return int(override)
        conf = self.ctx.conf if self.ctx is not None else TpuConf()
        return int(conf.get(OOM_MAX_SPLIT_DEPTH))

    def pressure_spill(self) -> None:
        """Rung 3, fired at most once per ladder: spill every live
        session's spillables (this manager first: a directly made
        manager may not be in the singleton table)."""
        self.pressured = True
        if self.stats is not None:
            self.stats.pressure_spills += 1
        self.mm.spill_everything()
        MemoryManager.spill_all_sessions()

    def fail(self, detail: str) -> OutOfDeviceMemory:
        """The end of the ladder: no host rung in the port (module doc)."""
        self.restore()
        return OutOfDeviceMemory(
            f"op={self.op or '?'}: {detail} (rungs tried: "
            f"{self.tried['retries']} retries, {self.tried['splits']} "
            f"splits, pressure spill {'yes' if self.pressured else 'no'}; "
            "the port has no host fallback)")


def with_retry_no_split(fn: Callable[[], T], mm: Optional[MemoryManager]
                        = None, stats: Optional[RetryStats] = None, *,
                        retryable=None, ctx=None, op: Optional[str] = None
                        ) -> T:
    """Run fn through the escalation ladder without splitting (ref
    withRetryNoSplit): RetryOOM -> spill + retry; SplitAndRetryOOM cannot
    be honoured here, so it escalates straight to the pressure spill and
    then to OutOfDeviceMemory."""
    mm = mm or (ctx.memory if ctx is not None else MemoryManager.get())
    lad = _Ladder(mm, stats, retryable, ctx, op)
    attempts = 0
    budget = MAX_RETRIES
    while True:
        lad.check_cancelled()
        try:
            return fn()
        except RetryOOM as e:
            attempts += 1
            lad.note_retry()
            if attempts > budget:
                if not lad.pressured:
                    lad.pressure_spill()
                    budget = attempts + PRESSURE_ATTEMPTS
                    continue
                raise lad.fail(f"exceeded {attempts} OOM retries even after "
                               f"a cross-session pressure spill: {e}") from e
            mm.spill_device(0)
            time.sleep(0)  # yield so other tasks can release
        except SplitAndRetryOOM as e:
            lad.restore()
            if not lad.pressured:
                # a pressure spill can turn an unsatisfiable reserve into
                # a satisfiable one when other sessions held the budget
                lad.pressure_spill()
                budget = attempts + PRESSURE_ATTEMPTS
                continue
            raise lad.fail(f"the operation cannot split its input and the "
                           f"pressure spill did not free enough: {e}") from e


def split_batch_in_half(sb: SpillableBatch) -> List[SpillableBatch]:
    """Default splitter (ref RmmRapidsRetryIterator
    splitSpillableInHalfByRows).

    On success the input is consumed (closed): the pieces replace it. On
    failure the pieces are closed but the input stays open: the ladder
    still owns it and may escalate with the data intact. A batch of
    fewer than 2 rows raises OutOfDeviceMemory (unsplittable)."""
    pieces: List[SpillableBatch] = []
    try:
        batch = sb.get()
        n = batch.num_rows
        if n < 2:
            raise OutOfDeviceMemory("cannot split a batch with < 2 rows")
        mid = n // 2
        mm = sb.memory_manager
        pieces.append(SpillableBatch(batch.slice(0, mid), mm))
        pieces.append(SpillableBatch(batch.slice(mid, n - mid), mm))
    except BaseException:
        for p in pieces:
            p.close()
        raise
    sb.close()
    return pieces


def with_retry(inputs: List[SpillableBatch],
               fn: Callable[[SpillableBatch], T],
               mm: Optional[MemoryManager] = None,
               splitter: Callable = split_batch_in_half,
               stats: Optional[RetryStats] = None, *,
               retryable=None, ctx=None, op: Optional[str] = None,
               max_split_depth: Optional[int] = None) -> Iterator[T]:
    """Process each spillable input through fn with the escalation
    ladder (ref withRetry + RetryIterator). Yields one result per
    (possibly split) input piece, in order. Splitting is bounded by
    ``spark.rapids.tpu.oom.maxSplitDepth`` (or ``max_split_depth``); a
    piece that still cannot fit at the depth cap, or cannot split at
    all, escalates to the pressure spill and then to OutOfDeviceMemory."""
    mm = mm or (ctx.memory if ctx is not None else MemoryManager.get())
    lad = _Ladder(mm, stats, retryable, ctx, op)
    depth_cap = lad.max_split_depth(max_split_depth)
    queue: List[tuple] = [(sb, 0) for sb in inputs]
    item: Optional[SpillableBatch] = None
    try:
        while queue:
            item, depth = queue.pop(0)
            attempts = 0
            budget = MAX_RETRIES
            while True:
                lad.check_cancelled()
                try:
                    out = fn(item)
                    item = None
                    yield out
                    break
                except RetryOOM as e:
                    attempts += 1
                    lad.note_retry()
                    if attempts > budget:
                        if not lad.pressured:
                            lad.pressure_spill()
                            budget = attempts + PRESSURE_ATTEMPTS
                            continue
                        raise lad.fail(f"retry limit exceeded after the "
                                       f"pressure spill: {e}") from e
                    mm.spill_device(0)
                except SplitAndRetryOOM as e:
                    lad.note_split()
                    if depth >= depth_cap:
                        if not lad.pressured:
                            lad.pressure_spill()
                            continue
                        raise lad.fail(
                            f"split depth {depth} reached "
                            f"oom.maxSplitDepth={depth_cap}: {e}") from e
                    try:
                        pieces = splitter(item)
                    except (OutOfDeviceMemory, RetryOOM) as se:
                        # unsplittable (< 2 rows), or the split could not
                        # reserve its pieces: the input is still open, so
                        # escalate with the data intact
                        if not lad.pressured:
                            lad.pressure_spill()
                            continue
                        raise lad.fail(f"split failed: {se}") from se
                    # process the pieces in order before the rest
                    queue = [(p, depth + 1) for p in pieces] + queue
                    item = None
                    break
    except BaseException:
        # fatal error or abandoned consumer: the iterator owns every input
        # still queued; release them (close() is idempotent)
        if item is not None:
            item.close()
        for sb, _ in queue:
            sb.close()
        raise
