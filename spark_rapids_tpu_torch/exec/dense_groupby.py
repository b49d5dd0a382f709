"""Dense groupby over dictionary keys: the hand-written CUDA kernel and its
plain PyTorch version.

Replaces the reduction of the reference's direct-addressing groupby
(``spark_rapids_tpu/exec/aggregate.py:_build_direct_core``, a jitted jnp
core over ``columnar/segmented.py`` ``seg_sum`` and ``onehot_gather``).
Up to four dictionary keys pack into one group id per row,
``sum_i (valid_i ? remap_i[code_i] : card_i) * stride_i``, with a null
slot per key; rows outside the keep mask drop out. Per group, the result
is the sum and the count of the valid live rows of every value column,
and the count of live rows (occupancy): all of a batch's aggregates in
one call (``exec/aggregate.py`` hands each aggregate its pairs).

The kernel is ``csrc/dense_groupby.cu``, its arithmetic
``csrc/dense_groupby_row.cuh``. It adds floats in a fixed order, with no
float atomics, so two launches give the same bits; its bound is memory,
each input read once. ``dense_groupby`` launches it for CUDA tensors and
runs ``dense_groupby_reference`` for CPU tensors. Its host side checks
only what the C side cannot, and packs the launch's arguments into one
vector for one ``ctypes`` call.
"""
from __future__ import annotations

import array
import ctypes
import math
import threading
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..columnar.segmented import seg_count, seg_sum

__all__ = ["BUCKETS", "MAX_KEYS", "MAX_COLS", "DenseGroups",
           "dense_groupby", "dense_groupby_reference", "group_slots"]

#: the group counts the kernel is built for (csrc/dense_groupby.cu)
BUCKETS = (16, 64)
#: csrc/dense_groupby_row.cuh kDgMaxKeys, kDgMaxCols
MAX_KEYS = 4
MAX_COLS = 16

#: a value column: (float64 or int64 data, or None for a count only;
#: bool validity)
Column = Tuple[Optional[torch.Tensor], torch.Tensor]


class DenseGroups(NamedTuple):
    #: per column, its sum per group (None for a count-only column)
    sums: List[Optional[torch.Tensor]]
    #: int64 [columns, groups]: valid live rows per group
    counts: torch.Tensor
    #: int64 [groups]: live rows per group
    occupancy: torch.Tensor


def _strides(cards: Sequence[int]) -> List[int]:
    out, s = [], 1
    for c in reversed(cards):
        out.append(s)
        s *= c + 1
    return out[::-1]


def group_slots(cards: Sequence[int], num_groups: int):
    """Per key, the (global code int32, validity) of every group slot:
    the inverse of the packed id; a slot past prod(card + 1) is unused."""
    slot = torch.arange(num_groups, dtype=torch.int64)
    out = []
    for c, s in zip(cards, _strides(cards)):
        code = (slot // s) % (c + 1)
        valid = code < c
        out.append((torch.where(valid, code, 0).to(torch.int32), valid))
    return out


def _check(keys, remaps, cards, keep, values, num_groups) -> None:
    if num_groups not in BUCKETS:
        raise ValueError(f"dense_groupby takes {BUCKETS} groups, not "
                         f"{num_groups}")
    if not 1 <= len(keys) <= MAX_KEYS or len(remaps) != len(keys) \
            or len(cards) != len(keys):
        raise ValueError(f"dense_groupby takes 1..{MAX_KEYS} keys, each "
                         "with a remap and a cardinality")
    if len(values) > MAX_COLS:
        raise ValueError(f"dense_groupby takes at most {MAX_COLS} columns")
    if math.prod(c + 1 for c in cards) > num_groups or min(cards) < 0:
        raise ValueError(f"cardinalities {list(cards)} do not fit "
                         f"{num_groups} groups")
    if keep.dtype != torch.bool or keep.dim() != 1:
        raise TypeError("keep must be a bool vector")
    rows = [keep]
    for (codes, valid), remap in zip(keys, remaps):
        if codes.dtype != torch.int32 or valid.dtype != torch.bool \
                or remap.dtype != torch.int32:
            raise TypeError("keys are int32 codes with bool validity and "
                            "an int32 remap")
        if remap.device != keep.device:
            raise ValueError("a remap lies on another device than keep")
        rows += [codes, valid]
    for data, valid in values:
        if data is not None:
            if data.dtype not in (torch.float64, torch.int64):
                raise TypeError("value columns are float64 or int64")
            rows.append(data)
        if valid.dtype != torch.bool:
            raise TypeError("value validity must be bool")
        rows.append(valid)
    for t in rows:
        if t.device != keep.device or t.shape != keep.shape:
            raise ValueError("every row column must lie on keep's device "
                             "with keep's length")


def dense_groupby_reference(keys: Sequence[Tuple[torch.Tensor,
                                                 torch.Tensor]],
                            remaps: Sequence[torch.Tensor],
                            cards: Sequence[int], keep: torch.Tensor,
                            values: Sequence[Column],
                            num_groups: int) -> DenseGroups:
    """Plain PyTorch version: the packed id per row, then the one-hot
    ``seg_sum``/``seg_count`` of each column (the reference's form)."""
    _check(keys, remaps, cards, keep, values, num_groups)
    G = num_groups
    gid = torch.zeros(keep.shape[0], dtype=torch.int64, device=keep.device)
    for (codes, valid), remap, card, stride in zip(keys, remaps, cards,
                                                   _strides(cards)):
        if len(remap):
            g = remap[codes.clamp(0, len(remap) - 1).long()].to(torch.int64)
            g = torch.where(valid, g, card)
        else:
            g = torch.full_like(gid, card)
        gid += g * stride
    gid = torch.where(keep & (gid >= 0) & (gid < G), gid, G)
    sums, counts = [], []
    for data, valid in values:
        if data is None:
            sums.append(None)
        else:
            sums.append(seg_sum(torch.where(valid, data, torch.zeros_like(
                data)), gid, G))
        counts.append(seg_count(valid, gid, G))
    counts_t = torch.stack(counts) if counts else torch.zeros(
        (0, G), dtype=torch.int64, device=keep.device)
    return DenseGroups(sums, counts_t, seg_count(keep, gid, G))


_KERNEL: dict = {}
#: (device index, stream) -> the kernel's scratch: ticket counters, which
#: every launch leaves at zero, then block partials (never zeroed)
_SCRATCH: dict = {}
#: guards _KERNEL, _SCRATCH and the launch count: queries on several
#: threads launch on one stream
_LOCK = threading.Lock()


def _kernel() -> dict:
    """The library's functions, typed once."""
    with _LOCK:
        if _KERNEL:
            return _KERNEL
        from .. import native
        lib = native.load("dense_groupby")
        lib.dense_groupby_launch.argtypes = [ctypes.c_void_p]
        lib.dense_groupby_launch.restype = ctypes.c_int
        lib.dense_groupby_scratch_bytes.argtypes = [ctypes.c_int,
                                                    ctypes.c_int]
        lib.dense_groupby_scratch_bytes.restype = ctypes.c_int64
        lib.dense_groupby_describe.argtypes = [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        lib.dense_groupby_describe.restype = ctypes.c_int
        _KERNEL.update(launch=lib.dense_groupby_launch,
                       scratch_bytes=lib.dense_groupby_scratch_bytes,
                       describe=lib.dense_groupby_describe, sizes={})
        return _KERNEL


def _scratch(k: dict, dev: int, stream: int, G: int, K: int):
    need = k["sizes"].get((G, K))
    if need is None:
        need = k["sizes"][(G, K)] = int(k["scratch_bytes"](G, K))
    buf = _SCRATCH.get((dev, stream))
    if buf is None or buf.numel() * 8 < need:
        buf = _SCRATCH[(dev, stream)] = torch.zeros(
            -(-need // 8), dtype=torch.int64, device=torch.device("cuda",
                                                                  dev))
    return buf


def _refuse(keys, remaps, cards, keep, values, num_groups):
    """The plain version's message for arguments the kernel refuses."""
    _check(keys, remaps, cards, keep, values, num_groups)
    return ValueError("dense_groupby needs contiguous 1-D tensors on one "
                      "device")


#: torch's raw current-stream getter (a Python int), where it has one
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _launch(keys, remaps, cards, keep, values, num_groups) -> DenseGroups:
    """One kernel launch on CUDA tensors; raises on an error. It checks what the C side cannot see (counts, dtypes, devices, lengths,
    contiguity; any contiguous tensor of the rows' count is read as a
    vector) in the same pass that packs the launch's arguments."""
    G, K = num_groups, len(values)
    if G not in BUCKETS or not 1 <= len(keys) <= MAX_KEYS \
            or not len(remaps) == len(keys) == len(cards) or K > MAX_COLS \
            or min(cards) < 0 or math.prod(c + 1 for c in cards) > G \
            or keep.dtype is not torch.bool or not keep.is_contiguous():
        raise _refuse(keys, remaps, cards, keep, values, num_groups)
    k = _KERNEL or _kernel()
    dev, p = keep.get_device(), keep.numel()
    stream = _RAW_STREAM(dev) if _RAW_STREAM is not None else \
        torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty(2 * K * G + G, dtype=torch.int64, device=keep.device)
    v = [len(keys), K, G, p, keep.data_ptr(), out.data_ptr(), 0, 0,
         stream, 0]
    b8, i32, i64 = torch.bool, torch.int32, torch.int64
    for (codes, valid), remap, card in zip(keys, remaps, cards):
        if codes.dtype is not i32 or valid.dtype is not b8 \
                or remap.dtype is not i32 or not codes.is_contiguous() \
                or not valid.is_contiguous() or codes.numel() != p \
                or valid.numel() != p or not remap.is_contiguous() \
                or codes.get_device() != dev or valid.get_device() != dev \
                or remap.get_device() != dev:
            raise _refuse(keys, remaps, cards, keep, values, num_groups)
        v += (codes.data_ptr(), valid.data_ptr(), remap.data_ptr(),
              remap.shape[0], card)
    int_mask = 0
    for c, (data, valid) in enumerate(values):
        if valid.dtype is not b8 or not valid.is_contiguous() \
                or valid.numel() != p or valid.get_device() != dev:
            raise _refuse(keys, remaps, cards, keep, values, num_groups)
        if data is None:
            v += (0, valid.data_ptr())
            continue
        if (data.dtype is not torch.float64 and data.dtype is not i64) \
                or not data.is_contiguous() or data.numel() != p \
                or data.get_device() != dev:
            raise _refuse(keys, remaps, cards, keep, values, num_groups)
        v += (data.data_ptr(), valid.data_ptr())
        if data.dtype is i64:
            int_mask |= 1 << c
    v[9] = int_mask
    with _LOCK:
        scratch = _scratch(k, dev, stream, G, K)
        v[6], v[7] = scratch.data_ptr(), scratch.numel() * 8
        packed = array.array("q", v)
        rc = k["launch"](packed.buffer_info()[0])
        if rc != 0:
            raise RuntimeError(f"dense_groupby kernel launch failed: CUDA "
                               f"error {rc}")
        dense_groupby.launches += 1
    sums: List[Optional[torch.Tensor]] = [None] * K
    if K:
        block = out[:K * G]
        floats = int_mask != (1 << K) - 1 and block.view(
            torch.float64).view(K, G).unbind(0)
        ints = int_mask and block.view(K, G).unbind(0)
        for c, (data, _) in enumerate(values):
            if data is not None:
                sums[c] = ints[c] if (int_mask >> c) & 1 else floats[c]
    return DenseGroups(sums, out[K * G:2 * K * G].view(K, G),
                       out[2 * K * G:])


def kernel_shape(num_groups: int, ncols: int) -> dict:
    """The launch shape the kernel picks on the current card (threads a
    block, shared memory, blocks an SM, SMs, registers), for reports."""
    k = _kernel()
    out = (ctypes.c_int64 * 6)()
    rc = k["describe"](num_groups, ncols, out)
    if rc != 0:
        raise RuntimeError(f"dense_groupby_describe failed: CUDA error {rc}")
    return dict(zip(("threads", "smem_bytes", "blocks_per_sm", "sms",
                     "registers", "local_bytes"), out))


def dense_groupby(keys: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                  remaps: Sequence[torch.Tensor], cards: Sequence[int],
                  keep: torch.Tensor, values: Sequence[Column],
                  num_groups: int) -> DenseGroups:
    """Per group (module doc): ``keys`` are (int32 codes, bool validity)
    per key, ``remaps`` each key's int32 remap of its codes to global codes
    below ``cards``; ``values`` are (float64 or int64 data or None, bool
    validity). On a CUDA tensor it launches the kernel (or raises); on a
    CPU tensor it runs ``dense_groupby_reference``."""
    if keep.is_cuda:
        return _launch(keys, remaps, cards, keep, values, num_groups)
    if keep.device.type != "cpu":
        raise ValueError(f"dense_groupby has no kernel for {keep.device}")
    return dense_groupby_reference(keys, remaps, cards, keep, values,
                                   num_groups)


#: kernel launches since the count was last set to 0
dense_groupby.launches = 0
