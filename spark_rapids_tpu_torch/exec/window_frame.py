"""Bounded window frames: the hand-written CUDA kernel ``window_frame``,
its plain PyTorch version, and the wrapper that picks between them.

``window_frame(values, valid, flags, lo, hi, op)`` computes, for every
row of rows sorted by partition, ``op`` (sum, count, avg, min or max)
over the row's ``ROWS BETWEEN lo AND hi`` frame with both ends finite:
the rows ``max(start, i + lo)`` to ``min(end, i + hi)``, where
``start``/``end`` are the first and last row of the row's partition and
``flags`` (bool) marks each partition's first row.

Replaces the bounded branch of the reference's window kernel,
``spark_rapids_tpu/exec/window.py`` ``_windowed_agg`` (:268-332) and
``_bounded_minmax`` (:559-631). The reference takes a frame sum as the
difference of two prefix sums over the whole table, so after one +inf
every later frame reads NaN, in every later partition. Here a frame's
sum is the frame's own: its valid values added in ascending row order
from 0, as Spark's sliding frame adds them, so NaN and +-inf stay in the
frames that hold them and a small frame keeps its low bits. Minimum and
maximum follow Spark's float order (NaN greatest, -0.0 as 0.0, results
canonical); a frame with no valid value is NULL, a count never is.

* On CUDA tensors: one launch of ``csrc/window_frame.cu``, its instance
  picked by the frame's offsets (``search`` "frame"; the others force
  one). Within the halo, -lo and hi at most ``HALO_MAX`` = 1,024 rows
  (``tiled``), the tiled instance (``csrc/window_frame_tile.cuh``):
  persistent blocks walk tiles of 1,280 sorted rows, each staged with its
  halo into shared memory by 16-byte asynchronous copies, the next tile
  while this one is computed; bitmasks of the partition starts and valid
  rows, and scans over their words, give every row's partition clamps
  and count (a tile with neither a start nor a NULL needs none); a
  float64 sum adds the frame in row order with a thread's 5 rows walking
  the union of their frames once; an int64 sum is a prefix difference;
  min and max wider than 16 rows come from van Herk / Gil-Werman
  segments, O(1) a row. Past the
  halo, a documented dispatch by shape and not a fallback, the chunked
  instance ("chunks", ``csrc/window_frame_row.cuh``), a thread a row: the
  partition's ends searched by the warp in chunks of 32 flags, the frame
  summed in a loop.
  Bound: 19 bytes a row (value, validity and flag read once, value and
  validity written; ``frame_bytes``), or for a wide float64 sum its W
  adds a row.
* On CPU tensors: ``window_frame_reference``, W shifted, masked passes in
  the same row order, so both give the same bits.

``window_frame.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

__all__ = ["OPS", "SEARCHES", "HALO_MAX", "tiled", "window_frame",
           "window_frame_reference", "frame_bytes"]

#: op name -> csrc/window_frame_row.cuh WfOp
OPS = {"sum": 0, "count": 1, "avg": 2, "min": 3, "max": 4}
#: the kernel instance a launch takes -> WfSearchKind: "frame" picks by
#: the offsets (the port's path: "tile" within the halo, else "chunks");
#: the others force one, for chip_smoke.py to time each
SEARCHES = {"frame": 0, "chunks": 1, "tile": 2}
#: the farthest the tiled instance's frame reaches back (-lo) or forward
#: (hi) (csrc/window_frame_tile.cuh WF_HALO_MAX)
HALO_MAX = 1024
_VALUE_TYPES = (torch.int64, torch.float64)


def tiled(lo: int, hi: int) -> bool:
    """Whether the tiled instance takes the frame ``[lo, hi]`` (within its
    halo)."""
    return -lo <= HALO_MAX and hi <= HALO_MAX


def frame_bytes(n: int, op: str) -> int:
    """Bytes the kernel must move for ``n`` rows of ``op``: each row's
    value (not for a count), validity and partition flag read once, its
    8-byte result and validity written once."""
    return n * ((0 if op == "count" else 8) + 1 + 1 + 8 + 1)


def _check(values, valid, flags, op: str) -> None:
    if op not in OPS:
        raise ValueError(f"window_frame op is one of {sorted(OPS)}, not "
                         f"{op!r}")
    if values.dtype not in _VALUE_TYPES or values.dim() != 1:
        raise TypeError(f"window_frame takes a vector of int64 or float64, "
                        f"not {values.dtype} of {values.dim()} dimensions")
    if op == "avg" and values.dtype != torch.float64:
        raise TypeError("window_frame's avg takes float64 values")
    n = values.shape[0]
    for name, t, dt in (("valid", valid, torch.bool),
                        ("flags", flags, torch.bool)):
        if t.dtype != dt or t.shape != (n,):
            raise TypeError(f"window_frame's {name} must be {dt} of the "
                            f"values' length {n}")
        if t.device != values.device:
            raise ValueError("every input must lie on the values' device")


def _clamp(k: int, n: int) -> int:
    """A frame offset held to [-n - 1, n + 1]: the same frames, and an
    int32 for the kernel."""
    return max(-n - 1, min(n + 1, int(k)))


def _out_dtype(values: torch.Tensor, op: str):
    return {"count": torch.int64, "avg": torch.float64}.get(op,
                                                            values.dtype)


def _partition_bounds(flags: torch.Tensor):
    """(first row, last row) of each row's partition, from the flags: the
    partitions' first rows read through each row's partition number (a
    prefix count of the flags)."""
    n = flags.shape[0]
    if not n:
        idx = torch.zeros(0, dtype=torch.int64, device=flags.device)
        return idx, idx
    part = torch.cumsum(flags, 0) - 1
    first = torch.nonzero(flags, as_tuple=True)[0]
    last = torch.cat([first[1:] - 1, first.new_full((1,), n - 1)])
    return first[part], last[part]


def window_frame_reference(values: torch.Tensor, valid: torch.Tensor,
                           flags: torch.Tensor, lo: int, hi: int, op: str
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``window_frame`` (module doc): the
    partitions' ends from the flags, then one masked pass per frame offset
    k from lo to hi, row i reading row i + k, so each frame is added in
    ascending row order, as the kernel adds it."""
    _check(values, valid, flags, op)
    n = values.shape[0]
    dev = values.device
    idx = torch.arange(n, device=dev)
    start, end = _partition_bounds(flags)
    count = torch.zeros(n, dtype=torch.int64, device=dev)
    if op in ("min", "max"):
        from ..columnar.segmented import _float_from_key, _float_key
        is_f = values.is_floating_point()
        keys = _float_key(values) if is_f else values
        info = torch.iinfo(torch.int64)
        acc = torch.full((n,), info.max if op == "min" else info.min,
                         dtype=torch.int64, device=dev)
        combine = torch.minimum if op == "min" else torch.maximum
    else:
        acc = torch.zeros(n, dtype=values.dtype, device=dev)
    lo, hi = _clamp(lo, n), _clamp(hi, n)
    for k in range(lo, hi + 1):
        j = idx + k
        take = (j >= start) & (j <= end)
        jj = j.clamp(0, max(n - 1, 0))
        take = take & valid[jj]
        count = count + take.to(torch.int64)
        if op in ("min", "max"):
            acc = torch.where(take, combine(acc, keys[jj]), acc)
        elif op != "count":
            acc = acc + torch.where(take, values[jj],
                                    torch.zeros((), dtype=values.dtype,
                                                device=dev))
    ok = count > 0
    if op == "count":
        return count, torch.ones(n, dtype=torch.bool, device=dev)
    if op == "avg":
        out = acc / torch.where(ok, count, torch.ones_like(count)) \
            .to(torch.float64)
        return torch.where(ok, out, torch.zeros_like(out)), ok
    if op in ("min", "max"):
        acc = torch.where(ok, acc, torch.zeros_like(acc))
        out = _float_from_key(acc, values.dtype) if is_f else acc
        return torch.where(ok, out, torch.zeros_like(out)), ok
    return acc, ok


_LIB: dict = {}
_LOCK = threading.Lock()


#: csrc/window_frame.cu window_frame_launch's arguments
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int32,
                                     ctypes.c_int32, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def _launcher():
    with _LOCK:
        if not _LIB:
            from .. import native
            lib = native.load("window_frame")
            fn = lib.window_frame_launch
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
            lib.window_frame_describe.argtypes = [ctypes.c_void_p]
            lib.window_frame_describe.restype = ctypes.c_int
            _LIB.update(launch=fn, describe=lib.window_frame_describe)
        return _LIB


def describe() -> dict:
    """From the built library: the tiled sum instance's registers a thread
    and threads a block, the chunked instance's registers, and the tiled
    instance's halo."""
    out = (ctypes.c_int * 4)()
    rc = _launcher()["describe"](ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"window_frame_describe failed: CUDA error {rc}")
    if out[3] != HALO_MAX:
        raise RuntimeError(f"csrc/window_frame_tile.cuh's halo is {out[3]} "
                           f"rows, the wrapper's {HALO_MAX}")
    return {"registers": out[0], "threads": out[1],
            "chunk_registers": out[2], "halo_max": out[3]}


def window_frame(values: torch.Tensor, valid: torch.Tensor,
                 flags: torch.Tensor, lo: int, hi: int, op: str,
                 search: str = "frame"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(value, validity) of ``op`` over each row's frame (module doc). On
    a CUDA tensor one kernel launch (or an error), its search of the
    partition ends as ``search`` (``SEARCHES``); on a CPU tensor
    ``window_frame_reference``."""
    _check(values, valid, flags, op)
    if search not in SEARCHES:
        raise ValueError(f"window_frame search is one of "
                         f"{sorted(SEARCHES)}, not {search!r}")
    if search == "tile" and not tiled(lo, hi):
        raise ValueError(f"window_frame's tiled instance reaches at most "
                         f"{HALO_MAX} rows back and forward (its halo), "
                         f"not ROWS {lo}..{hi}")
    if values.device.type == "cpu":
        return window_frame_reference(values, valid, flags, lo, hi, op)
    if values.device.type != "cuda":
        raise ValueError(f"window_frame has no kernel for {values.device}")
    n = values.shape[0]
    dev = values.device
    out = torch.empty(n, dtype=_out_dtype(values, op), device=dev)
    out_valid = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out, out_valid
    values, valid = values.contiguous(), valid.contiguous()
    flags = flags.contiguous()
    rc = _launcher()["launch"](
        values.data_ptr(), valid.data_ptr(), flags.data_ptr(),
        out.data_ptr(), out_valid.data_ptr(), n,
        _clamp(lo, n), _clamp(hi, n), OPS[op],
        int(values.is_floating_point()), SEARCHES[search],
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"window_frame kernel launch failed: CUDA error "
                           f"{rc}")
    with _COUNT_LOCK:           # queries on several threads launch it
        window_frame.launches += 1
    return out, out_valid


#: kernel launches since the count was last set to 0
window_frame.launches = 0
_COUNT_LOCK = threading.Lock()
