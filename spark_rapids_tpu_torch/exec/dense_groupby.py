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
``csrc/dense_groupby_row.cuh``. It adds in a fixed order, with no atomics,
so two launches give the same bits; its bound is memory, each input read
once. ``dense_groupby`` launches it for CUDA tensors and runs
``dense_groupby_reference`` for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math
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


_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int] + [ctypes.c_void_p] * 3
             + [ctypes.c_int] + [ctypes.c_void_p] * 6)


def _library():
    from .. import native
    lib = native.load("dense_groupby")
    fn = lib.dense_groupby_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.dense_groupby_rows_per_block.restype = ctypes.c_int
    return lib


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * max(len(tensors), 1))(
        *[None if t is None else t.data_ptr() for t in tensors])


def dense_groupby(keys: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                  remaps: Sequence[torch.Tensor], cards: Sequence[int],
                  keep: torch.Tensor, values: Sequence[Column],
                  num_groups: int) -> DenseGroups:
    """Per group (module doc): ``keys`` are (int32 codes, bool validity)
    per key, ``remaps`` each key's int32 remap of its codes to global codes
    below ``cards``; ``values`` are (float64 or int64 data or None, bool
    validity). On a CUDA tensor it launches the kernel (or raises); on a
    CPU tensor it runs ``dense_groupby_reference``."""
    _check(keys, remaps, cards, keep, values, num_groups)
    dev = keep.device
    if dev.type == "cpu":
        return dense_groupby_reference(keys, remaps, cards, keep, values,
                                       num_groups)
    if dev.type != "cuda":
        raise ValueError(f"dense_groupby has no kernel for {dev}")
    tensors = [t for k in keys for t in k] + list(remaps) + [keep] + [
        t for col in values for t in col if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dense_groupby needs contiguous tensors")
    lib = _library()
    G, K, p = num_groups, len(values), keep.shape[0]
    # one allocation: block partials (sums, counts), then the outputs
    part = max(-(-p // lib.dense_groupby_rows_per_block()), 1) * (K + 1) * G
    buf = torch.empty(2 * part + 2 * K * G + G, dtype=torch.int64,
                      device=dev)
    sums = buf[2 * part:2 * part + K * G].view(K, G)
    counts = buf[2 * part + K * G:2 * part + 2 * K * G].view(K, G)
    occupancy = buf[2 * part + 2 * K * G:]
    int32s = ctypes.c_int32 * len(keys)
    rc = lib.dense_groupby_launch(
        len(keys), _ptrs([c for c, _ in keys]), _ptrs([v for _, v in keys]),
        _ptrs(remaps), int32s(*[len(r) for r in remaps]),
        int32s(*[int(c) for c in cards]), keep.data_ptr(), p, K,
        _ptrs([d for d, _ in values]), _ptrs([v for _, v in values]),
        (ctypes.c_uint8 * max(K, 1))(*[
            int(d is not None and d.dtype == torch.int64)
            for d, _ in values]),
        G, buf.data_ptr(), buf.data_ptr() + 8 * part, sums.data_ptr(),
        counts.data_ptr(), occupancy.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dense_groupby kernel launch failed: CUDA error "
                           f"{rc}")
    dense_groupby.launches += 1
    out_sums = []
    for k, (data, _) in enumerate(values):
        if data is None:
            out_sums.append(None)
        else:
            out_sums.append(sums[k] if data.dtype == torch.int64
                            else sums[k].view(torch.float64))
    return DenseGroups(out_sums, counts, occupancy)


#: kernel launches (calls of the kernel pair) since the count was last set
#: to 0
dense_groupby.launches = 0
