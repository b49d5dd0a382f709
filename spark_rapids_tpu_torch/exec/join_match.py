"""The match step of an equi-join: the hand-written CUDA kernel and its
plain PyTorch version.

Replaces the reference's sort-based group match
(``spark_rapids_tpu/exec/joins.py`` ``_build_count_kernel`` ``:55`` and
``_gather_index_kernel`` ``:156``): for a stream side and a build side of
encoded key words (int64 ``[rows, W]``, one word a key column, with a
null flag per row), the gather maps of the join, as
``JoinMaps(stream, build)`` of int64 row indices, -1 for a null-extended
row; semi, anti and existence joins give one flag per stream row.

``build_table`` prepares the build side once (plain torch: a stable sort
of the valid rows by key, the unique keys with each one's start and
count) and, on a card, inserts the unique keys into an open-addressing
table with the kernel ``csrc/join_match.cu``. ``join_match`` probes it:
pass 1 gives each stream row its key's id and match count, one host read
gives the total, pass 2 writes the pairs. Null keys never match; keys
compare by their words, so NaN matches NaN and -0.0 matches 0.0 when the
caller encodes floats canonically (exec/joins.py does).

The order of the maps is defined, and the same in the kernel and the
plain version: stream rows ascending, build rows ascending within one;
then, for right and full joins, the build rows never matched, ascending.
So the card holds the kernel to its plain version exactly.

``join_match`` launches the kernels for CUDA tensors (or raises) and runs
``join_match_reference`` for CPU tensors: the reference's algorithm (one
stable sort of both sides' keys, the build side first within a key) in
eager torch. ``join_match.launches`` counts the calls that launched.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

import torch

from ..columnar.segmented import prefix_sum
from .encoding import lexsort_permutation

__all__ = ["JOIN_TYPES", "BuildTable", "JoinMaps", "build_table",
           "join_match", "join_match_reference", "output_size",
           "MAX_OUTPUT_ROWS"]

JOIN_TYPES = ("inner", "left", "right", "full", "leftsemi", "leftanti",
              "existence")
#: the most output rows one join emits (row counts stay int32 downstream)
MAX_OUTPUT_ROWS = (1 << 31) - 1


class BuildTable(NamedTuple):
    #: int64 [U, W]: the distinct keys of the valid build rows, sorted
    ukeys: torch.Tensor
    #: int64 [U]: each key's first position in ``sorted_rows`` and count
    ustart: torch.Tensor
    ucount: torch.Tensor
    #: int64: the valid build rows sorted by key (stable)
    sorted_rows: torch.Tensor
    #: int64 [build rows]: each row's key id, -1 for a null key
    row_uid: torch.Tensor
    #: int32 [capacity]: the hash table (on a card; None on the CPU)
    table: Optional[torch.Tensor]


class JoinMaps(NamedTuple):
    #: int64 stream row per output row (-1: null-extended)
    stream: torch.Tensor
    #: int64 build row per output row (-1: null-extended); None for the
    #: semi, anti and existence joins
    build: Optional[torch.Tensor]
    #: existence: bool per stream row (a match exists); else None
    flags: Optional[torch.Tensor] = None


def _check_keys(words: torch.Tensor, null: torch.Tensor) -> None:
    if words.dtype != torch.int64 or words.dim() != 2:
        raise TypeError("key words are an int64 [rows, W] tensor")
    if null.dtype != torch.bool or null.shape != words.shape[:1]:
        raise TypeError("the null flags are one bool per row")
    if null.device != words.device:
        raise ValueError("key words and null flags lie on two devices")


def build_table(words: torch.Tensor, null: torch.Tensor) -> BuildTable:
    """The build side's keys prepared for ``join_match`` (module doc)."""
    _check_keys(words, null)
    dev, n, W = words.device, words.shape[0], words.shape[1]
    valid_rows = torch.nonzero(~null, as_tuple=True)[0]
    vw = words[valid_rows]
    if W and vw.shape[0]:
        perm = lexsort_permutation([vw[:, w] for w in range(W)])
        sorted_rows, sw = valid_rows[perm], vw[perm]
    else:
        sorted_rows, sw = valid_rows, vw
    m = sw.shape[0]
    first = torch.ones(m, dtype=torch.bool, device=dev)
    if m > 1:
        first[1:] = (sw[1:] != sw[:-1]).any(dim=1)
    ustart = torch.nonzero(first, as_tuple=True)[0]
    ucount = torch.diff(ustart, append=torch.tensor([m], device=dev))
    row_uid = torch.full((n,), -1, dtype=torch.int64, device=dev)
    row_uid[sorted_rows] = prefix_sum(first) - 1
    ukeys = sw[ustart].contiguous()
    table = None
    if words.is_cuda:
        table = _build_on_card(ukeys)
    return BuildTable(ukeys, ustart, ucount, sorted_rows, row_uid, table)


def output_size(per_row: torch.Tensor, extra: int = 0) -> int:
    """The join's output rows (one host read), raising past
    ``MAX_OUTPUT_ROWS``."""
    total = int(per_row.sum()) + extra if per_row.numel() else extra
    if total > MAX_OUTPUT_ROWS:
        raise OverflowError(
            f"equi-join output of {total} rows exceeds {MAX_OUTPUT_ROWS} "
            "rows: split the join (a smaller "
            "spark.rapids.tpu.sql.join.subPartitionSizeBytes) or filter "
            "its inputs")
    return total


def _finish(join_type: str, count: torch.Tensor, uid: torch.Tensor,
            matched: Optional[torch.Tensor], build: BuildTable, emit):
    """The maps from pass 1's counts and key ids; ``emit(offsets, outer,
    total)`` writes the pairs (the kernel or its plain version)."""
    dev = count.device
    hit = count > 0
    if join_type == "existence":
        return JoinMaps(torch.arange(count.shape[0], device=dev), None, hit)
    if join_type in ("leftsemi", "leftanti"):
        keep = hit if join_type == "leftsemi" else ~hit
        return JoinMaps(torch.nonzero(keep, as_tuple=True)[0], None)
    outer = join_type in ("left", "full")
    per = torch.clamp(count, min=1) if outer else count
    unmatched = None
    if join_type in ("right", "full"):
        seen = torch.zeros(build.ukeys.shape[0] + 1, dtype=torch.bool,
                           device=dev)
        if matched is None:                  # plain version: from uid
            seen[torch.where(uid >= 0, uid, build.ukeys.shape[0])] = True
        else:
            seen[:-1] = matched.bool()
        rid = build.row_uid
        got = seen[torch.where(rid >= 0, rid, build.ukeys.shape[0])] \
            & (rid >= 0)
        unmatched = torch.nonzero(~got, as_tuple=True)[0]
    n_un = 0 if unmatched is None else int(unmatched.shape[0])
    total = output_size(per, n_un)
    offsets = prefix_sum(per) - per
    s_map, b_map = emit(offsets, outer, total - n_un)
    if unmatched is not None and n_un:
        s_map = torch.cat([s_map, torch.full((n_un,), -1, dtype=torch.int64,
                                             device=dev)])
        b_map = torch.cat([b_map, unmatched])
    return JoinMaps(s_map, b_map)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _probe_reference(words: torch.Tensor, null: torch.Tensor,
                     build: BuildTable):
    """Each stream row's key id (-1: none) and match count, by one stable
    sort of the unique build keys and the stream keys together (the
    reference's group match): within equal words the build key sorts
    first, and a stream row takes its group's key if the group has one."""
    dev = words.device
    n, U, W = words.shape[0], build.ukeys.shape[0], words.shape[1]
    uid = torch.full((n,), -1, dtype=torch.int64, device=dev)
    rows = torch.nonzero(~null, as_tuple=True)[0]
    if U and rows.shape[0]:
        allw = torch.cat([build.ukeys, words[rows]])
        side = torch.cat([torch.zeros(U, dtype=torch.uint8, device=dev),
                          torch.ones(rows.shape[0], dtype=torch.uint8,
                                     device=dev)])
        orig = torch.cat([torch.arange(U, device=dev), rows])
        perm = lexsort_permutation([allw[:, w] for w in range(W)] + [side])
        sw, ss, so = allw[perm], side[perm], orig[perm]
        first = torch.ones(sw.shape[0], dtype=torch.bool, device=dev)
        first[1:] = (sw[1:] != sw[:-1]).any(dim=1)
        gid = prefix_sum(first) - 1
        head = torch.nonzero(first, as_tuple=True)[0]
        g_uid = torch.where(ss[head] == 0, so[head], -1)
        is_s = ss == 1
        uid[so[is_s]] = g_uid[gid[is_s]]
    count = torch.where(uid >= 0, build.ucount[uid.clamp(min=0)],
                        0) if U else torch.zeros(n, dtype=torch.int64,
                                                 device=dev)
    return uid, count


def join_match_reference(words: torch.Tensor, null: torch.Tensor,
                         build: BuildTable, join_type: str) -> JoinMaps:
    """Plain PyTorch version of ``join_match`` (module doc)."""
    _check_keys(words, null)
    if join_type not in JOIN_TYPES:
        raise ValueError(f"join_match takes {JOIN_TYPES}, not {join_type}")
    uid, count = _probe_reference(words, null, build)

    def emit(offsets, outer, total):
        per = torch.clamp(count, min=1) if outer else count
        s_map = torch.repeat_interleave(
            torch.arange(count.shape[0], device=count.device), per)
        j = torch.arange(total, device=count.device) - offsets[s_map]
        has = count[s_map] > 0
        start = build.ustart[uid[s_map].clamp(min=0)] if \
            build.ustart.shape[0] else torch.zeros_like(s_map)
        b_map = torch.where(has, build.sorted_rows[
            (start + j).clamp(0, max(build.sorted_rows.shape[0] - 1, 0))]
            if build.sorted_rows.shape[0] else torch.zeros_like(s_map),
            torch.full_like(s_map, -1))
        return s_map, b_map
    return _finish(join_type, count, uid, None, build, emit)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_KERNEL: dict = {}
#: guards _KERNEL and the launch count
_LOCK = threading.Lock()
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _kernel() -> dict:
    """The library's functions, typed once."""
    with _LOCK:
        if _KERNEL:
            return _KERNEL
        from .. import native
        lib = native.load("join_match")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.join_match_build.argtypes = [p, i64, i32, p, i64, p]
        lib.join_match_probe.argtypes = [p, p, i64, i32, p, i64, p, p, p, p,
                                         p, p]
        lib.join_match_emit.argtypes = [p, p, p, p, p, i64, i32, p, p, p]
        for f in (lib.join_match_build, lib.join_match_probe,
                  lib.join_match_emit):
            f.restype = ctypes.c_int
        _KERNEL.update(build=lib.join_match_build,
                       probe=lib.join_match_probe, emit=lib.join_match_emit)
        return _KERNEL


def _stream(t: torch.Tensor) -> int:
    dev = t.get_device()
    return _RAW_STREAM(dev) if _RAW_STREAM is not None else \
        torch.cuda.current_stream(dev).cuda_stream


def _rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"join_match {what} launch failed: CUDA error "
                           f"{rc}")


def _capacity(U: int) -> int:
    c = 2
    while c < 2 * U:
        c <<= 1
    return c


def _build_on_card(ukeys: torch.Tensor) -> torch.Tensor:
    U, W = ukeys.shape
    table = torch.full((_capacity(U),), -1, dtype=torch.int32,
                       device=ukeys.device)
    _rc(_kernel()["build"](ukeys.data_ptr(), U, W, table.data_ptr(),
                           table.shape[0], _stream(ukeys)), "build")
    return table


def _launch(words, null, build: BuildTable, join_type: str) -> JoinMaps:
    _check_keys(words, null)
    if join_type not in JOIN_TYPES:
        raise ValueError(f"join_match takes {JOIN_TYPES}, not {join_type}")
    if build.table is None or build.ukeys.device != words.device \
            or build.ukeys.shape[1] != words.shape[1]:
        raise ValueError("the build table was made on another device or "
                         "for keys of another width")
    k = _KERNEL or _kernel()
    words = words.contiguous()
    null = null.contiguous()
    n, W = words.shape
    dev = words.device
    stream = _stream(words)
    uid = torch.empty(n, dtype=torch.int32, device=dev)
    count = torch.empty(n, dtype=torch.int64, device=dev)
    matched = torch.zeros(build.ukeys.shape[0], dtype=torch.uint8,
                          device=dev) \
        if join_type in ("right", "full") else None
    with _LOCK:
        join_match.launches += 1
    _rc(k["probe"](words.data_ptr(), null.data_ptr(), n, W,
                   build.table.data_ptr(), build.table.shape[0],
                   build.ukeys.data_ptr(), build.ucount.data_ptr(),
                   uid.data_ptr(), count.data_ptr(),
                   None if matched is None else matched.data_ptr(),
                   stream), "probe")

    def emit(offsets, outer, total):
        s_map = torch.empty(total, dtype=torch.int64, device=dev)
        b_map = torch.empty(total, dtype=torch.int64, device=dev)
        _rc(k["emit"](offsets.data_ptr(), count.data_ptr(), uid.data_ptr(),
                      build.ustart.data_ptr(), build.sorted_rows.data_ptr(),
                      n, int(outer), s_map.data_ptr(), b_map.data_ptr(),
                      stream), "emit")
        return s_map, b_map
    return _finish(join_type, count, uid, matched, build, emit)


def join_match(words: torch.Tensor, null: torch.Tensor, build: BuildTable,
               join_type: str) -> JoinMaps:
    """The join's gather maps (module doc): on CUDA tensors the kernels
    (or an error), on CPU tensors ``join_match_reference``."""
    if words.is_cuda:
        return _launch(words, null, build, join_type)
    if words.device.type != "cpu":
        raise ValueError(f"join_match has no kernel for {words.device}")
    return join_match_reference(words, null, build, join_type)


#: calls that launched the kernels since the count was last set to 0
join_match.launches = 0
