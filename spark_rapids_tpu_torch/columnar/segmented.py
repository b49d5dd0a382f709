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

``SegmentScan`` is the windows' form (exec/window.py): per row, the sum,
minimum or maximum of its run's rows up to itself, forward or in
reverse, restarting at each run's first row (the counterparts of the
reference's ``last_valid_scan``, ``reverse_last_valid_scan`` and
``exec/window.py:_seg_combine_scan``). It is the same Hillis-Steele scan:
each pass one shifted combine, so a float sum is deterministic and no
frame result is a difference of two prefixes.

``first`` finds each segment's first row where a mask holds: an argmax
over one segment, a search of the mask's rows for each sorted
segment's start.

Every form is deterministic on the card. Float sums over sorted
segments are the reference's Hillis-Steele segmented scan (elementwise
passes, read at each segment's last row), with no atomics; integer sums
and counts are a prefix sum read at the segment ends, exact in any
order. Minimum and maximum (``seg_min``/``seg_max``) and the
first/last-row selection (``select_by_rank``) are one ``scatter_reduce``
over segment ids: a minimum is the same in any order, and floats reduce
as the integers of their total order (NaN greatest, -0.0 equal to 0.0).
"""
from __future__ import annotations

from typing import List, Optional

import torch

__all__ = ["DENSE_MAX", "GlobalSegments", "SortedSegments", "SegmentScan",
           "bucket_segments", "prefix_sum", "seg_sum", "seg_count",
           "seg_min", "seg_max", "select_by_rank"]

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
    shape-(1,) tensors. ``orig_index`` (int64 per row) is the rank that
    first/last select by."""

    num_segments = 1

    def __init__(self, live: torch.Tensor,
                 orig_index: Optional[torch.Tensor] = None):
        self.live = live
        self.orig_index = orig_index

    @property
    def seg_ids(self) -> torch.Tensor:
        return torch.zeros(self.live.shape, dtype=torch.int64,
                           device=self.live.device)

    def sum(self, data: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        ok = torch.logical_and(valid, self.live)
        zero = torch.zeros((), dtype=data.dtype, device=data.device)
        return torch.where(ok, data, zero).sum(dtype=data.dtype).reshape(1)

    def count(self, pred: torch.Tensor, dtype=torch.int64) -> torch.Tensor:
        return torch.logical_and(pred, self.live).sum(dtype=dtype).reshape(1)

    def first(self, ok: torch.Tensor):
        """(the first live row where ``ok`` holds, 0 if none; whether
        there is one), each of shape (1,)."""
        ok = torch.logical_and(ok, self.live)
        if not ok.shape[0]:
            return (torch.zeros(1, dtype=torch.int64, device=ok.device),
                    torch.zeros(1, dtype=torch.bool, device=ok.device))
        return (torch.argmax(ok.to(torch.int32)).reshape(1),
                ok.any().reshape(1))


class SortedSegments:
    """Segments over rows sorted by group key. ``flags`` marks each
    segment's first row; ``live`` (a prefix of the rows: live rows sort
    first) marks real rows, and flags lie on live rows only. Every
    reduction returns one value per segment."""

    def __init__(self, flags: torch.Tensor, live: torch.Tensor,
                 orig_index: Optional[torch.Tensor] = None):
        self.flags = flags
        self.live = live
        #: each sorted row's rank for first/last (its row in the input)
        self.orig_index = orig_index
        self.starts = torch.nonzero(flags, as_tuple=True)[0]
        n_live = live.sum().reshape(1)
        self.ends = torch.cat([self.starts[1:], n_live])[
            :self.starts.shape[0]] - 1
        self._steps: Optional[List[tuple]] = None

    @property
    def num_segments(self) -> int:
        return int(self.starts.shape[0])

    @property
    def seg_ids(self) -> torch.Tensor:
        """int64 segment of every row (live rows only are read)."""
        return prefix_sum(self.flags) - 1

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

    def first(self, ok: torch.Tensor):
        """Per segment, (its first live row where ``ok`` holds, 0 if
        none; whether it has one): the rows where ``ok`` holds, in order,
        searched for each segment's start."""
        pos = torch.nonzero(torch.logical_and(ok, self.live),
                            as_tuple=True)[0]
        G = self.num_segments
        if not pos.shape[0] or not G:
            return (torch.zeros(G, dtype=torch.int64, device=ok.device),
                    torch.zeros(G, dtype=torch.bool, device=ok.device))
        i = torch.searchsorted(pos, self.starts)
        row = pos[i.clamp(max=pos.shape[0] - 1)]
        has = torch.logical_and(i < pos.shape[0], row <= self.ends)
        return torch.where(has, row, 0), has


class SegmentScan:
    """Inclusive scans over runs of rows: ``starts`` marks each run's
    first row (row 0 must be one). With ``reverse`` the scans run from
    the end and ``starts`` marks each run's LAST row: a row's result
    covers itself to its run's end. The flags' passes are built once and
    shared by every scan."""

    _COMBINE = {"sum": torch.add, "min": torch.minimum,
                "max": torch.maximum}

    def __init__(self, starts: torch.Tensor, reverse: bool = False):
        self.reverse = reverse
        f = torch.flip(starts, (0,)) if reverse else starts
        n, d, steps = f.shape[0], 1, []
        while d < n:
            steps.append((d, f))
            f = torch.logical_or(f, _shift(f, d, True))
            d <<= 1
        self._steps = steps

    def scan(self, v: torch.Tensor, how: str, neutral=0) -> torch.Tensor:
        """The scan of ``v`` by ``how`` ("sum", "min" or "max"); rows to
        leave out carry ``neutral`` (0 for a sum, the type's greatest for
        a minimum, its least for a maximum). A sum adds the earlier rows'
        partial before the later's, pass by pass."""
        combine = self._COMBINE[how]
        if self.reverse:
            v = torch.flip(v, (0,))
        for d, f in self._steps:
            v = torch.where(f, v, combine(_shift(v, d, neutral), v))
        return torch.flip(v, (0,)) if self.reverse else v


def _shift(a: torch.Tensor, d: int, fill) -> torch.Tensor:
    """``a`` moved ``d`` rows towards the end, the first ``d`` rows
    ``fill`` (exact for an int64 extreme, which ``pad``'s float value
    does not hold)."""
    k = min(d, a.shape[0])
    head = torch.full((k,), fill, dtype=a.dtype, device=a.device)
    return torch.cat([head, a[:a.shape[0] - k]])


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


def _extreme(data: torch.Tensor, ok: torch.Tensor, seg, how: str):
    """Per segment, the ``how`` ("amin"/"amax") of ``data`` over its rows
    where ``ok`` (and live) holds, 0 where there is none."""
    G = seg.num_segments
    idx = torch.where(torch.logical_and(ok, seg.live), seg.seg_ids, G)
    out = torch.zeros(G + 1, dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(0, idx, data, how, include_self=False)[:G]


def _float_key(d: torch.Tensor) -> torch.Tensor:
    from ..exec.encoding import _float_order_key
    return _float_order_key(d)


def _float_from_key(k: torch.Tensor, dtype) -> torch.Tensor:
    """The inverse of the total-order key (the same xor undoes it)."""
    low = torch.iinfo(k.dtype).max
    return torch.where(k < 0, torch.bitwise_xor(k, low), k).view(dtype)


def _seg_extreme(data: torch.Tensor, valid: torch.Tensor, seg, how: str):
    if data.is_floating_point():
        k = _extreme(_float_key(data), valid, seg, how)
        return _float_from_key(k, data.dtype)
    if data.dtype == torch.bool:
        return _extreme(data.to(torch.int8), valid, seg, how).bool()
    return _extreme(data, valid, seg, how)


def seg_min(data: torch.Tensor, valid: torch.Tensor, seg) -> torch.Tensor:
    """Per segment of ``seg`` (SortedSegments or GlobalSegments), the
    least of ``data`` over its valid live rows in Spark's order (NaN
    greatest, -0.0 as 0.0); 0 where a segment has no such row."""
    return _seg_extreme(data, valid, seg, "amin")


def seg_max(data: torch.Tensor, valid: torch.Tensor, seg) -> torch.Tensor:
    """Per segment, the greatest of ``data`` (as ``seg_min``)."""
    return _seg_extreme(data, valid, seg, "amax")


def select_by_rank(rank: torch.Tensor, ok: torch.Tensor, seg, mode: str):
    """Per segment, the row whose ``rank`` is least (mode "min") or
    greatest ("max") among its live rows where ``ok`` holds; ranks are
    distinct. Returns (row index per segment, 0 where none; whether the
    segment has such a row)."""
    how = "amin" if mode == "min" else "amax"
    G = seg.num_segments
    if not G:
        return (torch.zeros(0, dtype=torch.int64, device=rank.device),
                torch.zeros(0, dtype=torch.bool, device=rank.device))
    best = _extreme(rank, ok, seg, how)
    ids = seg.seg_ids
    hit = torch.logical_and(torch.logical_and(ok, seg.live),
                            rank == best[ids.clamp(0, G - 1)])
    rows = torch.zeros(G + 1, dtype=torch.int64, device=rank.device)
    rows[torch.where(hit, ids, G)] = torch.arange(
        rank.shape[0], device=rank.device)
    has = torch.zeros(G + 1, dtype=torch.bool, device=rank.device)
    has[torch.where(hit, ids, G)] = True
    return rows[:G], has[:G]
