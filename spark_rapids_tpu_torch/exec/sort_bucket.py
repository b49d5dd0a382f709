"""The out-of-core sort's bucketing: the hand-written CUDA kernel
``sort_bucket``, its plain PyTorch version, and the wrapper that picks
between them.

``sort_bucket(operands, splitters, num_rows)`` gives each row the number
of splitters lexicographically <= its key: ``operands`` are the rows'
encoded sort operands (exec/encoding.py ``order_key_operands``: each
order's null rank, then its key), vectors of one length, each of its own
integer type (uint8, int8, int16, int32 or int64); ``splitters`` int64
[K, S] holds the S splitter keys in the same operands widened to int64
(``key_words``), ascending. Rows at or past ``num_rows`` (padding) go to
bucket S + 1. Splitters are picked from the same operands, so a bucket
boundary never splits rows that sort equal.

Replaces the reference's jitted ``_bucket_id_kernel``
(``spark_rapids_tpu/exec/sort.py:164-187``), which compares every row
with every splitter in a ``fori_loop``.

* On CUDA tensors: one launch of ``csrc/sort_bucket.cu`` (row logic
  ``csrc/sort_bucket_row.cuh``): a thread a row, each operand read from
  its own vector at its own width, a binary search over the splitters
  read through the read-only cache. Bound: a row's operands read and its
  bucket written once, the sum of the operands' widths plus 4 bytes
  (``bucket_bytes``).
* On CPU tensors: ``sort_bucket_reference``, the reference's loop over
  the splitters as eager torch.

With one operand ``torch.searchsorted(splitters[0], operand, right=True)``
computes the same function; chip_smoke.py times it beside the kernel and
the port never calls it. ``sort_bucket.launches`` counts the kernel's
launches.
"""
from __future__ import annotations

import ctypes
import threading
from typing import List

import torch

__all__ = ["key_words", "sort_bucket", "sort_bucket_reference",
           "bucket_bytes", "MAX_SPLITTER_WORDS", "MAX_OPERANDS"]

#: splitter words a launch takes (csrc/sort_bucket.cu kMaxSplitterWords)
MAX_SPLITTER_WORDS = 6144
#: operands a launch takes (csrc/sort_bucket_row.cuh SB_MAX_OPERANDS)
MAX_OPERANDS = 32
#: operand element type -> csrc/sort_bucket_row.cuh SbType
_TYPES = {torch.uint8: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
          torch.int64: 4}


_PTRS = ctypes.c_void_p * MAX_OPERANDS
_KINDS = ctypes.c_int32 * MAX_OPERANDS


class _Operands(ctypes.Structure):
    """csrc/sort_bucket_row.cuh SbOperands."""
    _fields_ = [("ptr", _PTRS), ("type", _KINDS)]


#: csrc/sort_bucket.cu sort_bucket_launch's arguments
_ARGTYPES = [ctypes.POINTER(_Operands), ctypes.c_int64, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p]


def _pack(operands: List[torch.Tensor]) -> _Operands:
    """The operands' pointers and element types as the launch takes them
    (contiguous vectors)."""
    return _Operands(_PTRS(*[op.data_ptr() for op in operands]),
                     _KINDS(*[_TYPES[op.dtype] for op in operands]))


def key_words(operands: List[torch.Tensor]) -> torch.Tensor:
    """The sort operands as int64 words [K, n]: widening keeps each
    operand's order (uint8 ranks are non-negative, keys signed). For
    splitter samples, which are few; the kernel reads the operands
    themselves."""
    return torch.stack([op.to(torch.int64) for op in operands])


def bucket_bytes(n: int, itemsizes: List[int], s: int) -> int:
    """Bytes the kernel must move: each row's operands read once at their
    widths (``itemsizes``), its bucket written once, the splitters read
    once."""
    k = len(itemsizes)
    return n * (sum(itemsizes) + 4) + 8 * k * s


def _check(operands: List[torch.Tensor], splitters: torch.Tensor,
           num_rows: int) -> None:
    if not operands:
        raise ValueError("sort_bucket needs at least one operand")
    n, dev = operands[0].shape[0], operands[0].device
    for op in operands:
        if op.dtype not in _TYPES or op.dim() != 1 or op.shape[0] != n:
            raise TypeError(f"sort_bucket takes integer vectors of one "
                            f"length {n}, not {op.dtype} of shape "
                            f"{tuple(op.shape)}")
        if op.device != dev:
            raise ValueError("every operand must lie on one device")
    if splitters.dtype != torch.int64 or splitters.dim() != 2 \
            or splitters.shape[0] != len(operands):
        raise TypeError("sort_bucket's splitters must be int64 [K, S] with "
                        "the operands' K")
    if splitters.device != dev:
        raise ValueError("the splitters must lie on the operands' device")
    if not 0 <= num_rows <= n:
        raise ValueError(f"num_rows {num_rows} outside [0, {n}]")


def sort_bucket_reference(operands: List[torch.Tensor],
                          splitters: torch.Tensor,
                          num_rows: int) -> torch.Tensor:
    """Plain PyTorch version of ``sort_bucket`` (module doc): per
    splitter, a lexicographic compare of every row, counted."""
    _check(operands, splitters, num_rows)
    words = [op.to(torch.int64) for op in operands]
    n, dev = words[0].shape[0], words[0].device
    S = splitters.shape[1]
    bucket = torch.zeros(n, dtype=torch.int32, device=dev)
    for s in range(S):
        gt = torch.zeros(n, dtype=torch.bool, device=dev)
        eq = torch.ones(n, dtype=torch.bool, device=dev)
        for k, w in enumerate(words):
            sv = splitters[k, s]
            gt = gt | (eq & (w > sv))
            eq = eq & (w == sv)
        bucket += (gt | eq).to(torch.int32)
    bucket[num_rows:] = S + 1
    return bucket


_LIB: dict = {}
_LOCK = threading.Lock()


def _launcher():
    with _LOCK:
        if not _LIB:
            from .. import native
            lib = native.load("sort_bucket")
            fn = lib.sort_bucket_launch
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
            for name, want in (("max_words", MAX_SPLITTER_WORDS),
                               ("max_operands", MAX_OPERANDS)):
                f = getattr(lib, f"sort_bucket_{name}")
                f.restype = ctypes.c_int
                if f() != want:
                    raise RuntimeError(f"csrc/sort_bucket.cu takes {f()} "
                                       f"{name[4:]}, the wrapper {want}")
            lib.sort_bucket_describe.argtypes = [ctypes.c_void_p]
            lib.sort_bucket_describe.restype = ctypes.c_int
            _LIB.update(launch=fn, describe=lib.sort_bucket_describe)
        return _LIB


def describe() -> dict:
    """The kernel's registers a thread and threads a block."""
    out = (ctypes.c_int * 2)()
    rc = _launcher()["describe"](ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"sort_bucket_describe failed: CUDA error {rc}")
    return {"registers": out[0], "threads": out[1]}


def sort_bucket(operands: List[torch.Tensor], splitters: torch.Tensor,
                num_rows: int) -> torch.Tensor:
    """int32 bucket of every row (module doc). On CUDA tensors one kernel
    launch (or an error); on CPU tensors ``sort_bucket_reference``."""
    _check(operands, splitters, num_rows)
    dev = operands[0].device
    if dev.type == "cpu":
        return sort_bucket_reference(operands, splitters, num_rows)
    if dev.type != "cuda":
        raise ValueError(f"sort_bucket has no kernel for {dev}")
    K, n = len(operands), operands[0].shape[0]
    S = splitters.shape[1]
    if K > MAX_OPERANDS or S * K > MAX_SPLITTER_WORDS:
        raise NotImplementedError(
            f"{S} splitters of {K} operands: the kernel takes at most "
            f"{MAX_OPERANDS} operands and holds at most "
            f"{MAX_SPLITTER_WORDS} splitter words in shared memory")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    operands = [op.contiguous() for op in operands]
    splitters = splitters.contiguous()
    rc = _launcher()["launch"](
        ctypes.byref(_pack(operands)), n, num_rows, splitters.data_ptr(), S,
        K, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sort_bucket kernel launch failed: CUDA error "
                           f"{rc}")
    with _COUNT_LOCK:           # queries on several threads launch it
        sort_bucket.launches += 1
    return out


#: kernel launches since the count was last set to 0
sort_bucket.launches = 0
_COUNT_LOCK = threading.Lock()
