"""Segmented reductions (port of ``spark_rapids_tpu/columnar/segmented.py``).

Three contexts an aggregate's ``_seg_sum`` reduces over:

  * ``GlobalSegments`` -- one segment, the rows where ``live`` holds: one
    masked vector reduction per call (keyless aggregation);
  * ``SortedSegments`` -- rows sorted by group, each group a contiguous
    run (the sort path of ``exec/groupby_core.py``): results come back
    one per segment, in segment order;
  * an int group id per row with ``seg_sum``/``seg_count``: a one-hot
    reduction over at most ``DENSE_MAX`` segments, the plain form of the
    dense groupby kernel (``exec/dense_groupby.py``).

Every form is deterministic on the card: no atomics. Float sums over
sorted segments are the reference's Hillis-Steele segmented scan
(elementwise passes, read at each segment's last row); integer sums and
counts are a prefix sum read at the segment ends, exact in any order.
"""
from __future__ import annotations

from typing import List, Optional

import torch

__all__ = ["DENSE_MAX", "GlobalSegments", "SortedSegments",
           "bucket_segments", "prefix_sum", "seg_sum", "seg_count"]

#: largest segment count the one-hot ``seg_sum`` takes
DENSE_MAX = 4096

#: static bucket sizes of a dense group-id space (the reference's)
_BUCKETS = (16, 64, 256, 1024, 4096)


def bucket_segments(n: int) -> int:
    """Smallest bucket >= n (n itself above the largest)."""
    for b in _BUCKETS:
        if n <= b:
            return b
    return n


def prefix_sum(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """Inclusive prefix sum of an integer or bool vector (exact: integer
    adds give the same result in any order, so the card's scan may take
    any)."""
    if x.is_floating_point():
        raise TypeError("prefix_sum takes integers: a float prefix sum on "
                        "the card is not deterministic")
    return torch.cumsum(x, 0, dtype=dtype if dtype is not None
                        else torch.int64)


class GlobalSegments:
    """One segment over the rows where ``live`` holds; results are
    shape-(1,) tensors."""

    def __init__(self, live: torch.Tensor):
        self.live = live

    def sum(self, data: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        ok = torch.logical_and(valid, self.live)
        zero = torch.zeros((), dtype=data.dtype, device=data.device)
        return torch.where(ok, data, zero).sum(dtype=data.dtype).reshape(1)

    def count(self, pred: torch.Tensor, dtype=torch.int64) -> torch.Tensor:
        return torch.logical_and(pred, self.live).sum(dtype=dtype).reshape(1)


class SortedSegments:
    """Segments over rows sorted by group key. ``flags`` marks each
    segment's first row; ``live`` (a prefix of the rows: live rows sort
    first) marks real rows, and flags lie on live rows only. Every
    reduction returns one value per segment."""

    def __init__(self, flags: torch.Tensor, live: torch.Tensor):
        self.flags = flags
        self.live = live
        self.starts = torch.nonzero(flags, as_tuple=True)[0]
        n_live = live.sum().reshape(1)
        self.ends = torch.cat([self.starts[1:], n_live])[
            :self.starts.shape[0]] - 1
        self._steps: Optional[List[tuple]] = None

    @property
    def num_segments(self) -> int:
        return int(self.starts.shape[0])

    def _flag_steps(self) -> List[tuple]:
        """(distance, flags before the pass) of each scan pass; the same
        for every column, so built once."""
        if self._steps is None:
            f, n, d = self.flags, self.flags.shape[0], 1
            steps = []
            while d < n:
                steps.append((d, f))
                f = torch.logical_or(f, _shift(f, d, True))
                d <<= 1
            self._steps = steps
        return self._steps

    def _scan_sum(self, v: torch.Tensor) -> torch.Tensor:
        """Per row, the sum of its segment's rows up to itself: log2(n)
        passes of one shifted add each (the reference's scan)."""
        for d, f in self._flag_steps():
            v = torch.where(f, v, _shift(v, d, 0) + v)
        return v

    def sum(self, data: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        ok = torch.logical_and(valid, self.live)
        masked = torch.where(ok, data, torch.zeros((), dtype=data.dtype,
                                                   device=data.device))
        if not self.num_segments:
            return masked[:0]
        if masked.is_floating_point():
            return self._scan_sum(masked)[self.ends]
        c = prefix_sum(masked, masked.dtype)
        return c[self.ends] - c[self.starts] + masked[self.starts]

    def count(self, pred: torch.Tensor, dtype=torch.int64) -> torch.Tensor:
        ones = torch.ones_like(pred, dtype=torch.bool)
        return self.sum(pred.to(dtype), ones)


def _shift(a: torch.Tensor, d: int, fill) -> torch.Tensor:
    """``a`` moved ``d`` rows towards the end, the first ``d`` rows
    ``fill`` (one op)."""
    k = min(d, a.shape[0])
    return torch.nn.functional.pad(a[:a.shape[0] - k], (k, 0), value=fill)


def seg_sum(data: torch.Tensor, gid, num_segments: int) -> torch.Tensor:
    """Sum of ``data`` per segment; rows whose ``gid`` lies outside
    [0, num_segments) drop out. Callers mask invalid rows to 0 first.
    With a SortedSegments context, its per-segment sum."""
    if isinstance(gid, SortedSegments):
        return gid.sum(data, torch.ones_like(data, dtype=torch.bool))
    if num_segments > DENSE_MAX:
        raise ValueError(f"seg_sum takes at most {DENSE_MAX} segments, "
                         f"not {num_segments}")
    slots = torch.arange(num_segments, device=data.device)
    m = gid.to(torch.int64)[None, :] == slots[:, None]
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    return torch.where(m, data[None, :], zero).sum(dim=1, dtype=data.dtype)


def seg_count(pred: torch.Tensor, gid, num_segments: int,
              dtype=torch.int64) -> torch.Tensor:
    """Count of True rows per segment."""
    if isinstance(gid, SortedSegments):
        return gid.count(pred, dtype)
    return seg_sum(pred.to(dtype), gid, num_segments)
