"""Literal pattern match over byte rectangles: the hand-written CUDA
kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``spark_rapids_tpu/exprs/pallas_rect.py``
(``_match_kernel``, reached through ``pallas_match``); the kernel is
``csrc/rect_match.cu``, its per-row and per-chunk arithmetic
``csrc/rect_match_row.cuh``. Its bound on the H100 is memory: each row
only over its window (up to the length for contains and locate, the
pattern's bytes at 0 or at len - L for the other modes), 4P bytes of
lengths, P bytes out (4P for locate). A block copies a tile of rows into
shared memory with coalesced 16-byte ``cp.async`` chunks that skip
whatever no window needs, in a ring of stages, and scans each row there
with SWAR arithmetic (the source's note gives the design). Measured with
the L2 cold, as ``q_comment`` finds each batch, it runs at about 45% of
that bound on ``l_comment``, 1.7x the first version's speed; it runs
almost as fast cold as from L2, so the SM's instructions, not DRAM, hold
it there (PERF.md).

``rect_match`` launches the kernel for a CUDA tensor and runs
``rect_match_reference`` for a CPU tensor. The reference is also the
route taken when ``spark.rapids.tpu.sql.pallas.enabled`` is off, in
place of the reference's XLA ops (exprs/string_rect.py).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..config import register

__all__ = ["PALLAS_ENABLED", "MODES", "rect_match", "rect_match_reference"]

PALLAS_ENABLED = register(
    "spark.rapids.tpu.sql.pallas.enabled", False,
    "Route byte-rectangle string predicates (contains/startswith/"
    "endswith/equals/locate and the literal LIKE and RLIKE forms) through "
    "the hand-written CUDA kernel (exprs/rect_match.py) instead of plain "
    "torch ops. Off by default until measured faster on the deployment "
    "card.")

#: mode -> the kernel's mode code (csrc/rect_match_row.cuh RectMatchMode)
MODES = {"contains": 0, "startswith": 1, "endswith": 2, "equals": 3,
         "locate": 4}


def _check(bytes_: torch.Tensor, lengths: torch.Tensor, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown match mode {mode!r}")
    if bytes_.dtype != torch.uint8 or bytes_.dim() != 2:
        raise TypeError("bytes_ must be a uint8[P, W] tensor")
    if lengths.dtype != torch.int32 or lengths.shape != bytes_.shape[:1]:
        raise TypeError("lengths must be an int32[P] tensor")
    if lengths.device != bytes_.device:
        raise ValueError("bytes_ and lengths lie on different devices")


def _out(p: int, mode: str, device) -> torch.Tensor:
    dt = torch.int32 if mode == "locate" else torch.bool
    return torch.empty(p, dtype=dt, device=device)


def rect_match_reference(bytes_: torch.Tensor, lengths: torch.Tensor,
                         pattern: bytes, mode: str) -> torch.Tensor:
    """Plain PyTorch version: one slice compare per pattern byte over all
    W-L+1 offsets at once. bool[P], or int32[P] for locate."""
    _check(bytes_, lengths, mode)
    p, w = bytes_.shape
    dev = bytes_.device
    L = len(pattern)
    if L == 0:
        if mode == "equals":
            return lengths == 0
        return torch.ones(p, dtype=torch.int32 if mode == "locate"
                          else torch.bool, device=dev)
    if L > w:
        return torch.zeros(p, dtype=torch.int32 if mode == "locate"
                           else torch.bool, device=dev)
    n_off = w - L + 1
    m = bytes_[:, 0:n_off] == pattern[0]     # [P, offsets]: match at s
    for j in range(1, L):
        m &= bytes_[:, j:j + n_off] == pattern[j]
    if mode == "startswith":
        return (lengths >= L) & m[:, 0]
    if mode == "equals":
        return (lengths == L) & m[:, 0]
    if mode == "endswith":
        s = lengths.to(torch.int64) - L
        ok = (s >= 0) & (s < n_off)
        at = m.gather(1, s.clamp(0, n_off - 1)[:, None])[:, 0]
        return ok & at
    offs = torch.arange(n_off, device=dev)
    hit = m & (offs[None, :] <= (lengths.to(torch.int64) - L)[:, None])
    if mode == "contains":
        return hit.any(dim=1)
    first = hit.to(torch.int8).argmax(dim=1).to(torch.int32) + 1
    return torch.where(hit.any(dim=1), first, torch.zeros_like(first))


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
             ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p]

#: the widest pattern the kernel takes by value (csrc/rect_match.cu
#: kMaxPattern); a wider one matters only in rows at least as wide
MAX_PATTERN = 1024
#: the widest row the kernel takes (csrc/rect_match_row.cuh
#: kRectMaxWidth): three stages of one row fill a block's shared memory
MAX_WIDTH = 65536


def _launcher():
    from .. import native
    lib = native.load("rect_match")
    fn = lib.rect_match_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def rect_match(bytes_: torch.Tensor, lengths: torch.Tensor,
               pattern: bytes, mode: str) -> torch.Tensor:
    """Sliding literal match of ``pattern`` over each row (module doc).
    On a CUDA tensor it launches the kernel (or raises); on a CPU tensor
    it runs ``rect_match_reference``."""
    _check(bytes_, lengths, mode)
    if bytes_.device.type == "cpu":
        return rect_match_reference(bytes_, lengths, pattern, mode)
    if bytes_.device.type != "cuda":
        raise ValueError(f"rect_match has no kernel for {bytes_.device}")
    if not (bytes_.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("rect_match needs contiguous tensors")
    p, w = bytes_.shape
    if w > MAX_WIDTH:
        raise ValueError(f"rect_match takes rows of at most {MAX_WIDTH} "
                         f"bytes, not {w}")
    if MAX_PATTERN < len(pattern) <= w:
        raise ValueError(f"rect_match takes patterns of at most "
                         f"{MAX_PATTERN} bytes, not {len(pattern)}")
    out = _out(p, mode, bytes_.device)
    if p == 0:
        return out
    fn = _launcher()
    rc = fn(bytes_.data_ptr(), lengths.data_ptr(), p, w, pattern,
            len(pattern), MODES[mode], out.data_ptr(),
            torch.cuda.current_stream(bytes_.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rect_match kernel launch failed: CUDA error {rc}")
    with _COUNT_LOCK:           # queries on several threads launch it
        rect_match.launches += 1
    return out


#: kernel launches since the count was last set to 0
rect_match.launches = 0
_COUNT_LOCK = threading.Lock()
