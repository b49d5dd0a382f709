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
count, and the largest count, one host read) and, on a card, inserts the
unique keys into an open-addressing table with the kernel
``csrc/join_match.cu``. ``join_match`` probes it with one kernel that
probes, scans across tiles and writes the pairs (the source's doc): where
``n * max(largest count, 1)`` rows are at most ``SINGLE_LAUNCH_FACTOR``
times the ``n`` stream rows (semi and anti joins: always), one launch
into a buffer of that size, whose first ``total`` rows are returned;
else a count launch, one host read of the total, and an emit launch into
exactly the total (``launch_route``). A build side of at most
``SHARED_TABLE_BYTES`` is staged in shared memory (``BuildTable.shared``).
Null keys never match; keys compare by their words, so NaN matches NaN
and -0.0 matches 0.0 when the caller encodes floats canonically
(exec/joins.py does).

The order of the maps is defined, and the same in the kernel and the
plain version: stream rows ascending, build rows ascending within one;
then, for right and full joins, the build rows never matched, ascending.
So the card holds the kernel to its plain version exactly.

``join_match`` launches the kernel for CUDA tensors (or raises) and runs
``join_match_reference`` for CPU tensors: the reference's algorithm (one
stable sort of both sides' keys, the build side first within a key) in
eager torch. ``join_match.launches`` counts the calls that launched.
"""
from __future__ import annotations

import array
import ctypes
import threading
from typing import Callable, NamedTuple, Optional

import torch

from ..columnar.segmented import prefix_sum
from .encoding import lexsort_permutation

__all__ = ["JOIN_TYPES", "BuildTable", "JoinMaps", "build_table",
           "join_match", "join_match_reference", "output_size",
           "launch_route", "MAX_OUTPUT_ROWS"]

JOIN_TYPES = ("inner", "left", "right", "full", "leftsemi", "leftanti",
              "existence")
#: the most output rows one join emits (row counts stay int32 downstream)
MAX_OUTPUT_ROWS = (1 << 31) - 1
#: the kernel's stream rows a tile and shared-memory budget for a staged
#: build side (csrc/join_match.cu kTile, kSharedTableBytes; checked
#: against the library when it loads)
TILE_ROWS = 2048
SHARED_TABLE_BYTES = 48 * 1024
#: one launch when a batch's output rows are bounded by this many times
#: its stream rows; else a count launch first
SINGLE_LAUNCH_FACTOR = 2
#: csrc/join_match_row.cuh JmKind of each join type
_KIND = {"inner": 0, "right": 0, "left": 1, "full": 1, "leftsemi": 2,
         "leftanti": 3, "existence": 4}
_COUNT, _EMIT = 0, 1


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
    #: int64 [capacity * (W + 1)]: the hash table, a slot a key's words and
    #: its start and count in one word (csrc/join_match_row.cuh jm_meta;
    #: on a card, None on the CPU)
    table: Optional[torch.Tensor]
    #: the largest count of one key (0 with no keys)
    max_ucount: int = 0
    #: the hash table's slots and whether the kernel stages it in shared
    #: memory (``_fits_shared``)
    capacity: int = 2
    shared: bool = False


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


def _check_type(join_type: str) -> None:
    if join_type not in JOIN_TYPES:
        raise ValueError(f"join_match takes {JOIN_TYPES}, not {join_type}")


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
    if m > MAX_OUTPUT_ROWS:      # the kernel keeps build positions in int32
        raise OverflowError(f"a build side of {m} rows exceeds "
                            f"{MAX_OUTPUT_ROWS} rows")
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
        table = _build_on_card(ukeys, ustart, ucount)
    U = ukeys.shape[0]
    return BuildTable(ukeys, ustart, ucount, sorted_rows, row_uid, table,
                      int(ucount.max()) if m else 0, _capacity(U),
                      _fits_shared(U, W))


def _fits_shared(U: int, W: int) -> bool:
    """Whether the kernel stages the table of U keys of W words in shared
    memory: keys of 1, 2 or 4 words (16-byte aligned, as a fresh tensor
    is) whose table (W + 1 words a slot) fits SHARED_TABLE_BYTES."""
    return W in (1, 2, 4) and _capacity(U) * (W + 1) * 8 <= \
        SHARED_TABLE_BYTES


def _single_rows(build: BuildTable, n: int, join_type: str) -> int:
    """The most output rows ``n`` stream rows can give (before the
    unmatched build rows of right and full joins)."""
    if join_type in ("leftsemi", "leftanti", "existence"):
        return n
    return n * max(build.max_ucount, 1)


def launch_route(build: BuildTable, n: int, join_type: str) -> str:
    """How ``join_match`` launches for ``n`` stream rows: "flags"
    (existence, no scan), "single" (one launch into a buffer of the most
    rows the batch can give) or "count_emit" (a count launch, the total
    read on the host, an emit launch into exactly the total)."""
    if join_type == "existence":
        return "flags"
    most = _single_rows(build, n, join_type)
    return "single" if most <= min(SINGLE_LAUNCH_FACTOR * n,
                                   MAX_OUTPUT_ROWS) else "count_emit"


def _check_total(total: int) -> int:
    if total > MAX_OUTPUT_ROWS:
        raise OverflowError(
            f"equi-join output of {total} rows exceeds {MAX_OUTPUT_ROWS} "
            "rows: split the join (a smaller "
            "spark.rapids.tpu.sql.join.subPartitionSizeBytes) or filter "
            "its inputs")
    return total


def output_size(per_row: torch.Tensor, extra: int = 0) -> int:
    """The join's output rows (one host read), raising past
    ``MAX_OUTPUT_ROWS``."""
    return _check_total(int(per_row.sum()) + extra if per_row.numel()
                        else extra)


def _unmatched(join_type: str, build: BuildTable,
               seen: torch.Tensor) -> Optional[torch.Tensor]:
    """The build rows of right and full joins that no stream row matched
    (null keys included), ascending; ``seen`` is a bool per key id."""
    if join_type not in ("right", "full"):
        return None
    U = build.ukeys.shape[0]
    flags = torch.zeros(U + 1, dtype=torch.bool, device=seen.device)
    flags[:U] = seen
    rid = build.row_uid
    got = flags[torch.where(rid >= 0, rid, U)] & (rid >= 0)
    return torch.nonzero(~got, as_tuple=True)[0]


def _append(s_map: torch.Tensor, b_map: torch.Tensor,
            unmatched: Optional[torch.Tensor]) -> JoinMaps:
    if unmatched is not None and unmatched.shape[0]:
        s_map = torch.cat([s_map, torch.full(
            (unmatched.shape[0],), -1, dtype=torch.int64,
            device=s_map.device)])
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
    _check_type(join_type)
    uid, count = _probe_reference(words, null, build)
    dev, n = count.device, count.shape[0]
    hit = count > 0
    if join_type == "existence":
        return JoinMaps(torch.arange(n, device=dev), None, hit)
    if join_type in ("leftsemi", "leftanti"):
        keep = hit if join_type == "leftsemi" else ~hit
        return JoinMaps(torch.nonzero(keep, as_tuple=True)[0], None)
    U = build.ukeys.shape[0]
    seen = torch.zeros(U + 1, dtype=torch.bool, device=dev)
    seen[torch.where(uid >= 0, uid, U)] = True
    unmatched = _unmatched(join_type, build, seen[:U])
    per = torch.clamp(count, min=1) if join_type in ("left", "full") \
        else count
    n_un = 0 if unmatched is None else int(unmatched.shape[0])
    total = output_size(per, n_un) - n_un
    offsets = prefix_sum(per) - per
    s_map = torch.repeat_interleave(torch.arange(n, device=dev), per)
    j = torch.arange(total, device=dev) - offsets[s_map]
    has = count[s_map] > 0
    start = build.ustart[uid[s_map].clamp(min=0)] if U else \
        torch.zeros_like(s_map)
    b_map = torch.where(has, build.sorted_rows[
        (start + j).clamp(0, max(build.sorted_rows.shape[0] - 1, 0))]
        if build.sorted_rows.shape[0] else torch.zeros_like(s_map),
        torch.full_like(s_map, -1))
    return _append(s_map, b_map, unmatched)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _pack(words, null, build: BuildTable, join_type: str, phase: int,
          total: int, matched: int = 0, out_s: int = 0, out_b: int = 0,
          flags: int = 0, out_cap: int = 0) -> list:
    """One launch's arguments in csrc/join_match.cu ``JoinMatchArgs``
    order (the outputs as device addresses, 0 for none); the scratch, its
    tiles and the epoch (15-17) are set at the launch."""
    n, W = words.shape
    return [words.data_ptr(), null.data_ptr(), n, W, _KIND[join_type],
            phase, build.table.data_ptr(), build.capacity,
            build.sorted_rows.data_ptr(), matched, out_s, out_b, flags,
            out_cap, total, 0, 0, 0, int(build.shared)]


def _match(words: torch.Tensor, null: torch.Tensor, build: BuildTable,
           join_type: str, launch: Callable[[list], None]) -> JoinMaps:
    """The maps by the kernel's launches: ``launch(v)`` runs one launch of
    packed arguments (the kernel on the card; the tests' host build of
    its tile loop). ``launch_route`` picks one or two launches, into one
    buffer that holds both maps and the total; the unmatched build rows of
    right and full joins are appended in torch."""
    dev, n = words.device, words.shape[0]
    if join_type == "existence":
        flags = torch.empty(n, dtype=torch.bool, device=dev)
        if n:
            launch(_pack(words, null, build, join_type, _EMIT, 0,
                         flags=flags.data_ptr()))
        return JoinMaps(torch.arange(n, device=dev), None, flags)
    pairs = join_type not in ("leftsemi", "leftanti")
    # right and full joins: a flag a sorted build row, set at each matched
    # key's first
    matched = torch.zeros(max(build.sorted_rows.shape[0], 1),
                          dtype=torch.uint8, device=dev) \
        if join_type in ("right", "full") else None
    single = n and launch_route(build, n, join_type) == "single"
    if n and not single:
        count = torch.empty(1, dtype=torch.int64, device=dev)
        launch(_pack(words, null, build, join_type, _COUNT,
                     count.data_ptr()))
        rows = _check_total(count.item())
    else:
        rows = _single_rows(build, n, join_type)
    # [stream map | build map | total]
    buf = torch.empty((2 if pairs else 1) * rows + 1, dtype=torch.int64,
                      device=dev)
    base = buf.data_ptr()
    if n:
        launch(_pack(words, null, build, join_type, _EMIT,
                     base + (buf.shape[0] - 1) * 8,
                     0 if matched is None else matched.data_ptr(), base,
                     base + rows * 8 if pairs else 0, 0, rows))
    total = buf[-1].item() if n else 0
    if total > rows:
        raise RuntimeError(f"join_match wrote {total} rows into a buffer "
                           f"of {rows}: the build table's largest key "
                           "count is wrong")
    if not pairs:
        return JoinMaps(buf[:total], None)
    unmatched = None if matched is None else \
        _unmatched(join_type, build, matched[build.ustart].bool())
    _check_total(total + (0 if unmatched is None
                          else int(unmatched.shape[0])))
    return _append(buf[:total], buf[rows:rows + total], unmatched)


_KERNEL: dict = {}
#: (device index, stream) -> [scratch, epoch]: the kernel's ticket
#: counter (every launch leaves it 0) and per-tile status words (never
#: cleared by the kernel: each holds the epoch of its launch), and the
#: epoch of the latest launch
_SCRATCH: dict = {}
#: guards _KERNEL, _SCRATCH, the epochs and the launch count: queries on
#: several threads launch on one stream
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
        lib.join_match_build.argtypes = [p, p, p, i64, i32, p, i64, p]
        lib.join_match_launch.argtypes = [p, p]
        lib.join_match_describe.argtypes = [i32, i32, p]
        for f in (lib.join_match_build, lib.join_match_launch,
                  lib.join_match_describe):
            f.restype = ctypes.c_int
        for f in (lib.join_match_tile_rows,
                  lib.join_match_shared_table_budget):
            f.argtypes, f.restype = [], i64
        got = (lib.join_match_tile_rows(),
               lib.join_match_shared_table_budget())
        if got != (TILE_ROWS, SHARED_TABLE_BYTES):
            raise RuntimeError(f"csrc/join_match.cu's tile rows and shared "
                               f"budget {got} differ from the wrapper's "
                               f"{(TILE_ROWS, SHARED_TABLE_BYTES)}")
        _KERNEL.update(build=lib.join_match_build,
                       launch=lib.join_match_launch,
                       describe=lib.join_match_describe)
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
    """The table's slots for U distinct keys: a power of two, at least 4U
    (a miss ends at an empty slot after few steps)."""
    c = 2
    while c < 4 * U:
        c <<= 1
    return c


def _build_on_card(ukeys: torch.Tensor, ustart: torch.Tensor,
                   ucount: torch.Tensor) -> torch.Tensor:
    U, W = ukeys.shape
    cap = _capacity(U)
    table = torch.zeros(cap * (W + 1), dtype=torch.int64,
                        device=ukeys.device)
    _rc(_kernel()["build"](ukeys.data_ptr(), ustart.data_ptr(),
                           ucount.data_ptr(), U, W, table.data_ptr(), cap,
                           _stream(ukeys)), "build")
    return table


def _card_launch(dev: int, stream: int) -> Callable[[list], None]:
    """Launch packed arguments on ``stream`` of card ``dev``, with the
    stream's scratch and the next epoch (the status words are zeroed
    once when the 16-bit epoch wraps)."""
    k = _KERNEL or _kernel()

    def launch(v: list) -> None:
        tiles = -(-v[2] // TILE_ROWS)
        with _LOCK:
            slot = _SCRATCH.get((dev, stream))
            if slot is None or slot[0].numel() < 1 + tiles:
                size = 1024
                while size < tiles:
                    size <<= 1
                slot = _SCRATCH[(dev, stream)] = [torch.zeros(
                    1 + size, dtype=torch.int64,
                    device=torch.device("cuda", dev)), 0]
            slot[1] += 1
            if slot[1] >= 1 << 16:
                slot[0][1:].zero_()
                slot[1] = 1
            v[15], v[16], v[17] = (slot[0].data_ptr(),
                                   slot[0].numel() - 1, slot[1])
            packed = array.array("q", v)
            _rc(k["launch"](packed.buffer_info()[0], stream),
                "probe-scan-emit")
    return launch


def _launch(words, null, build: BuildTable, join_type: str) -> JoinMaps:
    _check_keys(words, null)
    _check_type(join_type)
    if build.table is None or build.ukeys.device != words.device \
            or build.ukeys.shape[1] != words.shape[1]:
        raise ValueError("the build table was made on another device or "
                         "for keys of another width")
    words, null = words.contiguous(), null.contiguous()
    launch = _card_launch(words.get_device(), _stream(words))
    launched = []

    def counted(v: list) -> None:
        launch(v)
        if not launched:
            launched.append(True)
            with _LOCK:
                join_match.launches += 1
    return _match(words, null, build, join_type, counted)


def kernel_shape(width: int, shared: bool) -> dict:
    """The kernel instance's registers a thread and resident blocks an SM
    on the current card (for reports)."""
    out = (ctypes.c_int * 2)()
    _rc(_kernel()["describe"](width, int(shared), out), "describe")
    return {"registers": out[0], "blocks_per_sm": out[1],
            "tile_rows": TILE_ROWS}


def join_match(words: torch.Tensor, null: torch.Tensor, build: BuildTable,
               join_type: str) -> JoinMaps:
    """The join's gather maps (module doc): on CUDA tensors the kernel
    (or an error), on CPU tensors ``join_match_reference``."""
    if words.is_cuda:
        return _launch(words, null, build, join_type)
    if words.device.type != "cpu":
        raise ValueError(f"join_match has no kernel for {words.device}")
    return join_match_reference(words, null, build, join_type)


#: calls that launched the kernel since the count was last set to 0
join_match.launches = 0
