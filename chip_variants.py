#!/usr/bin/env python3
"""Where the dense_groupby kernel's time goes, join_match against the
two-kernel design of commit 843e714, and distinct_flag against the
two-launch design of commit 04f2565, on one NVIDIA card.

    python3 chip_variants.py [dense_groupby] [join_match] [distinct_flag]
                             [decimal_arith] [rect_dfa[=DIR]]

(every section when none is named)

Builds variants of spark_rapids_tpu_torch/csrc/dense_groupby.cu, each the
kernel with one part changed by a text substitution, into build/variants/,
one nvcc each, started together, and times each with the L2 cold beside
the kernel itself on q1's batch shape (1,048,576 rows, 2 keys of 3 and 2
values, 5 float64 columns, G = 16) and on the G = 64 shape of
chip_smoke.py:

  loads_only    -- each piece's loads, then a sink in place of the warp
                   loop (what the loads alone cost);
  compute_only  -- the warp loop over made-up ids and values, no column
                   loads (what the loop alone costs);
  no_combine    -- the block partials written, the combine left out;
  blocks_3, blocks_2 -- registers bounded for 3 or 2 blocks an SM in
                   place of 4.

The variants' results are wrong by design; only the kernel's own is
checked against the plain version. Prints one line a shape, with the
card's name and power limit first. Exits non-zero when no card is there.

join_match: the two-kernel design of commit 843e714 (a probe kernel, the
offsets made in torch with a host read of the total, an emit kernel: that
commit's csrc/join_match.cu and join_match_row.cuh, copied below and
built into build/variants/join_match_843e714/) beside the port's one
probe-scan-emit kernel, on q3's first join and on 100,000 build keys
(chip_smoke.py's shapes), in turns (843e714, this, this, 843e714): the
launches of an inner join with their outputs made beforehand, cold
(chip_smoke.py's timing), and the whole call with its host reads, by
events around a synchronised call. Both designs' maps are checked equal
first. Then variants of the port's kernel made by text substitution
(JOIN_VARIANTS: no look-back, no emit, tickets only; their maps are
wrong by design), timed cold beside it, and its timeline: the global
timer at each phase of every tile, each phase's median and largest.

distinct_flag (~70 s): commit 04f2565's kernel (an insert launch and a
mark launch a batch, fences around each published slot; its source and
header copied below and built into build/variants/distinct_flag_04f2565/)
beside the port's one cooperative launch, on q28's shapes at SF10 (the
batch before the last against a table of the earlier batches' keys, the
first against fresh tables) at 04f2565's 1 GiB table and a 16 MiB one,
in turns (04f2565, this, this, 04f2565), after both designs' flags are
checked against the plain version on every batch. Then 04f2565's two
launches apart, with an 8-byte count copy and event after them, and
without its fences (DF_VARIANTS); and the port's kernel beside its
variants (DF_NEW_VARIANTS: 04f2565's fences, no grid barrier), and the
host microseconds a call of the port's wrapper and of its parts.

decimal_arith (~60 s): variants of csrc/decimal_arith.cu made by text
substitution (DA_VARIANTS: one or four rows a thread in place of two,
grids of one, four or 32 waves of resident blocks in place of two (a
thread loads its next group while it computes one), registers bounded
for 4 blocks an SM (a variant that then spills is reported and not
timed), the loads and stores alone, no reciprocal a row), each built into build/variants/ and timed cold beside the kernel
on chip_smoke.py's phase 19 (d) shapes, in turns; the variants that keep
the kernel's results are checked against it bit for bit first.

rect_dfa (~1 min): variants of csrc/rect_dfa.cu and rect_dfa_row.cuh
made by text substitution (RD_VARIANTS: the class-indexed instance for
every DFA, the length and sink tests on every byte of commit 3444cf9's
kernel, no loads ahead, a block's rows staged in shared memory by
cp.async, two rows a thread in step, a nibble table for at most 16
states, registers bounded for 5 blocks an SM, the next row's first 32
bytes ahead in place of 64, each warp's tiles staged in shared memory by
cp.async in two stages, the rows' loads cached as by default or in L2
only in place of streaming, L2 prefetch hints of 128 or 256 bytes, the
loads alone), and with ``rect_dfa=DIR`` that directory's rect_dfa.cu and
header (commit 3444cf9's kernel: the class-indexed table), each built
into build/variants/, checked bit for bit against the kernel and timed
cold beside it in turns on an SF1 l_comment batch for RD_TIMED's
patterns (loads_only unchecked: its answers are not the kernel's).
"""
from __future__ import annotations

import array
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs

_PIECE = "  const int gid = in ? dg_group_id(a.keys, a.keep, row, G) : G;\n"
_LOADS = ("    v[u] = on ? s_valid[u][row] : 0;\n"
          "    x[u] = on && ((a.data_mask >> u) & 1u) ? s_data[u][row] : 0;")
VARIANTS = {
    "loads_only": [(_PIECE, _PIECE + (
        "  {\n    int64_t sink = gid;\n"
        "    for (int u = 0; u < kDgColsAPass; ++u) sink += x[u] + v[u];\n"
        "    if (sink == 0x5a5a5a5a5a5aLL) w_cnt[0] = 1;\n    return;\n  }\n"))],
    "compute_only": [
        (_PIECE, "  const int gid = in ? static_cast<int>((row * 7 / 3) % 6)"
                 " : G;\n"),
        (_LOADS, "    v[u] = on ? ((row + u) % 5 != 0) : 0;\n"
                 "    x[u] = on ? row * 3 + u : 0;")],
    "no_combine": [("  // the last block of each kDgCombine adds theirs in "
                    "block order\n", "  return;\n")],
    "blocks_3": [("H:constexpr int kDgMinBlocks = 4;",
                  "constexpr int kDgMinBlocks = 3;")],
    "blocks_2": [("H:constexpr int kDgMinBlocks = 4;",
                  "constexpr int kDgMinBlocks = 2;")],
}


def _build_variants():
    """Start one nvcc a variant; returns {name: (process, library)}."""
    from spark_rapids_tpu_torch import native
    src = (native.CSRC / "dense_groupby.cu").read_text()
    hdr = (native.CSRC / "dense_groupby_row.cuh").read_text()
    started = {}
    for name, subs in VARIANTS.items():
        s, h = src, hdr
        for old, new in subs:
            if old.startswith("H:"):
                cs._check(old[2:] in h, f"{name}: no {old[2:]!r} in header")
                h = h.replace(old[2:], new)
            else:
                cs._check(old in s, f"{name}: no {old!r} in the kernel")
                s = s.replace(old, new)
        d = native.BUILD_DIR / "variants" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "dense_groupby.cu").write_text(s)
        (d / "dense_groupby_row.cuh").write_text(h)
        lib = d / "libdense_groupby.so"
        started[name] = (subprocess.Popen(
            [native._nvcc(), *native.NVCC_FLAGS, "-I", str(d), "-o",
             str(lib), str(d / "dense_groupby.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    return started


def _use(lib_path):
    """Point the wrapper at another build of the library (None: the
    port's own)."""
    from spark_rapids_tpu_torch.exec import dense_groupby as dg
    dg._KERNEL.clear()
    if lib_path is None:
        dg._kernel()
        return
    lib = ctypes.CDLL(str(lib_path))
    lib.dense_groupby_launch.argtypes = [ctypes.c_void_p]
    lib.dense_groupby_launch.restype = ctypes.c_int
    lib.dense_groupby_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.dense_groupby_scratch_bytes.restype = ctypes.c_int64
    dg._KERNEL.update(launch=lib.dense_groupby_launch,
                      scratch_bytes=lib.dense_groupby_scratch_bytes,
                      describe=None, sizes={})


#: join_match of commit 843e714, its header inlined: kept here only to be
#: timed beside the port's kernel
JOIN_MATCH_843E714 = r"""// join_match: the match step of an equi-join as a hash build and probe on
// the card. It replaces the sort-based group match of the reference's
// jitted jnp join kernels (spark_rapids_tpu/exec/joins.py
// _build_count_kernel and _gather_index_kernel): for a stream side and a
// build side of encoded key words, the (stream row, build row) gather
// maps of the join.
//
// The wrapper (exec/join_match.py) sorts the build rows by key with torch
// and hands over the unique keys with each one's start and count in the
// sorted order. Then:
//   join_match_build  inserts the unique keys into an open-addressing
//                     table (linear probing, slots claimed by atomicCAS);
//   join_match_probe  per stream row, its unique-key id and match count,
//                     and for right and full joins a matched flag per
//                     key (a store of 1, the same in any order);
//   join_match_emit   per stream row, its pairs at its offset (an
//                     exclusive scan of the counts, made by the wrapper
//                     with one host read of the total).
// The output order is defined (stream row ascending, build rows ascending
// within it), so the kernels and the plain version agree exactly.
//
// Bound: memory. Each stream key is read once and each pair written
// once; a lookup touches one table sector and one key sector (more on a
// collision), which stay in L2 for a small build side. Grid-stride
// loops, 256 threads a block, one thread a stream row; a skewed key's many pairs fall to one thread (a later PR's
// warp-cooperative emit).
#include <cuda_runtime.h>
#include <stdint.h>

// The per-row logic of the join_match kernels (csrc/join_match.cu): the
// key hash, the key compare, the open-addressing insert and lookup, and
// one stream row's probe and emit. Everything here is __host__
// __device__, so g++ builds it on a machine without CUDA and the tests
// run the kernels' loops on the host (tests/test_torch_joins.py).
//
// A key is W int64 words, row-major ([rows, W]); the wrapper encodes each
// key column as one word in a form where equal keys have equal words
// (floats as the integers of their total order, NaN canonical, -0.0 as
// 0.0). The table holds int32 unique-key ids, -1 for an empty slot; its
// capacity is a power of two at least twice the number of unique keys,
// so linear probing always ends.
#include <stdint.h>

#ifdef __CUDACC__
#define JM_HD __host__ __device__ __forceinline__
#else
#define JM_HD inline
#endif

// splitmix64's finalizer: every input bit reaches every output bit
JM_HD uint64_t jm_mix(uint64_t x) {
  x ^= x >> 30;
  x *= 0xbf58476d1ce4e5b9ULL;
  x ^= x >> 27;
  x *= 0x94d049bb133111ebULL;
  x ^= x >> 31;
  return x;
}

JM_HD uint64_t jm_hash(const int64_t* key, int W) {
  uint64_t h = 0x9e3779b97f4a7c15ULL;
  for (int w = 0; w < W; ++w) h = jm_mix(h ^ (uint64_t)key[w]);
  return h;
}

JM_HD bool jm_equal(const int64_t* a, const int64_t* b, int W) {
  for (int w = 0; w < W; ++w)
    if (a[w] != b[w]) return false;
  return true;
}

// Insert unique key id u at the first free slot from its hash. ``cas``
// is compare-and-swap of a slot from -1 to u, returning the slot's value
// before (atomicCAS on the card). The keys are distinct, so which thread
// wins a slot changes where a key sits, never what a lookup finds.
template <class Cas>
JM_HD void jm_insert(int32_t* table, int64_t mask, const int64_t* key, int W,
                     int32_t u, Cas cas) {
  int64_t s = (int64_t)(jm_hash(key, W) & (uint64_t)mask);
  while (cas(table + s, u) != -1) s = (s + 1) & mask;
}

// The unique-key id whose words equal ``key``, or -1.
JM_HD int32_t jm_find(const int32_t* table, int64_t mask,
                      const int64_t* ukeys, int W, const int64_t* key) {
  int64_t s = (int64_t)(jm_hash(key, W) & (uint64_t)mask);
  while (true) {
    int32_t u = table[s];
    if (u < 0) return -1;
    if (jm_equal(ukeys + (int64_t)u * W, key, W)) return u;
    s = (s + 1) & mask;
  }
}

// Probe pass 1 for one stream row: its unique-key id (-1 for a null key
// or no match) and its match count.
JM_HD int64_t jm_probe_row(const int64_t* key, bool null, int W,
                           const int32_t* table, int64_t mask,
                           const int64_t* ukeys, const int64_t* ucount,
                           int32_t* uid) {
  int32_t u = null ? -1 : jm_find(table, mask, ukeys, W, key);
  *uid = u;
  return u < 0 ? 0 : ucount[u];
}

// Probe pass 2 for stream row i: its pairs (i, build row) at ``off``, the
// build rows of its key in ascending order; with ``outer`` a row without
// a match writes (i, -1).
JM_HD void jm_emit_row(int64_t i, int64_t off, int64_t count, int32_t uid,
                       const int64_t* ustart, const int64_t* sorted_rows,
                       bool outer, int64_t* out_s, int64_t* out_b) {
  if (count == 0) {
    if (outer) {
      out_s[off] = i;
      out_b[off] = -1;
    }
    return;
  }
  const int64_t* rows = sorted_rows + ustart[uid];
  for (int64_t j = 0; j < count; ++j) {
    out_s[off + j] = i;
    out_b[off + j] = rows[j];
  }
}

namespace {

constexpr int kThreads = 256;

struct DeviceCas {
  __host__ __device__ int32_t operator()(int32_t* slot, int32_t u) const {
#ifdef __CUDA_ARCH__
    return atomicCAS(slot, -1, u);
#else
    return *slot;  // the host pass never runs a kernel body
#endif
  }
};

int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < (1 << 20) ? (blocks > 0 ? blocks : 1) : (1 << 20));
}

__global__ void join_match_build_kernel(const int64_t* __restrict__ ukeys,
                                        int64_t U, int W, int32_t* table,
                                        int64_t mask) {
  for (int64_t u = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; u < U;
       u += (int64_t)gridDim.x * blockDim.x)
    jm_insert(table, mask, ukeys + u * W, W, (int32_t)u, DeviceCas());
}

__global__ void join_match_probe_kernel(
    const int64_t* __restrict__ skeys, const uint8_t* __restrict__ snull,
    int64_t n, int W, const int32_t* __restrict__ table, int64_t mask,
    const int64_t* __restrict__ ukeys, const int64_t* __restrict__ ucount,
    int32_t* __restrict__ uid, int64_t* __restrict__ count,
    uint8_t* __restrict__ matched) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    int32_t u;
    count[i] = jm_probe_row(skeys + i * W, snull[i] != 0, W, table, mask,
                            ukeys, ucount, &u);
    uid[i] = u;
    if (matched != nullptr && u >= 0) matched[u] = 1;
  }
}

__global__ void join_match_emit_kernel(
    const int64_t* __restrict__ offsets, const int64_t* __restrict__ count,
    const int32_t* __restrict__ uid, const int64_t* __restrict__ ustart,
    const int64_t* __restrict__ sorted_rows, int64_t n, int outer,
    int64_t* __restrict__ out_s, int64_t* __restrict__ out_b) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    jm_emit_row(i, offsets[i], count[i], uid[i], ustart, sorted_rows,
                outer != 0, out_s, out_b);
}

}  // namespace

extern "C" int join_match_build(const int64_t* ukeys, int64_t U, int W,
                                int32_t* table, int64_t capacity,
                                void* stream) {
  if (U > 0)
    join_match_build_kernel<<<grid_for(U), kThreads, 0,
                              (cudaStream_t)stream>>>(ukeys, U, W, table,
                                                      capacity - 1);
  return (int)cudaGetLastError();
}

extern "C" int join_match_probe(const int64_t* skeys, const uint8_t* snull,
                                int64_t n, int W, const int32_t* table,
                                int64_t capacity, const int64_t* ukeys,
                                const int64_t* ucount, int32_t* uid,
                                int64_t* count, uint8_t* matched,
                                void* stream) {
  if (n > 0)
    join_match_probe_kernel<<<grid_for(n), kThreads, 0,
                              (cudaStream_t)stream>>>(
        skeys, snull, n, W, table, capacity - 1, ukeys, ucount, uid, count,
        matched);
  return (int)cudaGetLastError();
}

extern "C" int join_match_emit(const int64_t* offsets, const int64_t* count,
                               const int32_t* uid, const int64_t* ustart,
                               const int64_t* sorted_rows, int64_t n,
                               int outer, int64_t* out_s, int64_t* out_b,
                               void* stream) {
  if (n > 0)
    join_match_emit_kernel<<<grid_for(n), kThreads, 0,
                             (cudaStream_t)stream>>>(
        offsets, count, uid, ustart, sorted_rows, n, outer, out_s, out_b);
  return (int)cudaGetLastError();
}
"""


def _build_join_843e714():
    """Start nvcc on commit 843e714's join_match; returns (process,
    library)."""
    from spark_rapids_tpu_torch import native
    d = native.BUILD_DIR / "variants" / "join_match_843e714"
    d.mkdir(parents=True, exist_ok=True)
    (d / "join_match.cu").write_text(JOIN_MATCH_843E714)
    lib = d / "libjoin_match_843e714.so"
    return subprocess.Popen(
        [native._nvcc(), *native.NVCC_FLAGS, "-o", str(lib),
         str(d / "join_match.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True), lib


class _Join843e714:
    """Commit 843e714's kernels over one build side: its int32 table (at
    least 2U slots), and its launches and whole wrapper call for an inner
    join."""

    def __init__(self, lib_path, table):
        import torch
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib = self.lib = ctypes.CDLL(str(lib_path))
        lib.join_match_build.argtypes = [p, i64, i32, p, i64, p]
        lib.join_match_probe.argtypes = [p, p, i64, i32, p, i64, p, p, p, p,
                                         p, p]
        lib.join_match_emit.argtypes = [p, p, p, p, p, i64, i32, p, p, p]
        for f in (lib.join_match_build, lib.join_match_probe,
                  lib.join_match_emit):
            f.restype = ctypes.c_int
        U, W = table.ukeys.shape
        cap = 2
        while cap < 2 * U:
            cap <<= 1
        self.t = table
        self.slots = torch.full((cap,), -1, dtype=torch.int32,
                                device="cuda")
        self.stream = torch.cuda.current_stream().cuda_stream
        cs._check(lib.join_match_build(
            table.ukeys.data_ptr(), U, W, self.slots.data_ptr(), cap,
            self.stream) == 0, "843e714's build failed")

    def probe(self, w, nl, uid, count):
        t = self.t
        cs._check(self.lib.join_match_probe(
            w.data_ptr(), nl.data_ptr(), w.shape[0], w.shape[1],
            self.slots.data_ptr(), self.slots.shape[0], t.ukeys.data_ptr(),
            t.ucount.data_ptr(), uid.data_ptr(), count.data_ptr(), None,
            self.stream) == 0, "843e714's probe failed")

    def emit(self, offsets, count, uid, s_map, b_map):
        t = self.t
        cs._check(self.lib.join_match_emit(
            offsets.data_ptr(), count.data_ptr(), uid.data_ptr(),
            t.ustart.data_ptr(), t.sorted_rows.data_ptr(), count.shape[0], 0,
            s_map.data_ptr(), b_map.data_ptr(), self.stream) == 0,
            "843e714's emit failed")

    def call(self, w, nl):
        """Commit 843e714's wrapper for an inner join: probe, the total
        read on the host, the offsets in torch, emit."""
        import torch
        from spark_rapids_tpu_torch.columnar.segmented import prefix_sum
        n = w.shape[0]
        uid = torch.empty(n, dtype=torch.int32, device="cuda")
        count = torch.empty(n, dtype=torch.int64, device="cuda")
        self.probe(w, nl, uid, count)
        total = int(count.sum())
        offsets = prefix_sum(count) - count
        s_map = torch.empty(total, dtype=torch.int64, device="cuda")
        b_map = torch.empty(total, dtype=torch.int64, device="cuda")
        self.emit(offsets, count, uid, s_map, b_map)
        return s_map, b_map

    def launches(self, sw, sn):
        """The probe and emit launches as one function of (words, null),
        their outputs made beforehand (that commit's chip_smoke timing)."""
        import torch
        n = sw.shape[0]
        uid = torch.empty(n, dtype=torch.int32, device="cuda")
        count = torch.empty(n, dtype=torch.int64, device="cuda")
        self.probe(sw, sn, uid, count)
        offsets = torch.cumsum(count, 0) - count
        total = int(count.sum())
        s_map = torch.empty(total, dtype=torch.int64, device="cuda")
        b_map = torch.empty(total, dtype=torch.int64, device="cuda")

        def both(w, nl):
            self.probe(w, nl, uid, count)
            self.emit(offsets, count, uid, s_map, b_map)
        return both


def _stamp(k: int) -> str:
    """Thread 0 writes the global timer (ns) into word k of its tile's 8
    in the buffer handed over as the existence flags."""
    return ("    if (tid == 0) {\n      unsigned long long t_;\n"
            "      asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_));\n"
            "      reinterpret_cast<unsigned long long*>(a.flags)[tile * 8 + "
            f"{k}] = t_;\n    }}\n")


_ROWS = "    const int rows = (int)min64(kTile, a.n - base);\n"
_PROBED = ("    if (kind == JM_EXIST) {\n      __syncthreads();  // every "
           "thread has read s_tile")
_LOOK = "    // 3. the tile's offset"
_EMIT = "    // 4. the tile's outputs"
_END = ("    __syncthreads();  // before the next tile overwrites shared "
        "memory\n")
#: join_match variants by text substitution of csrc/join_match.cu (their
#: maps are wrong by design and not checked): where its time goes
JOIN_VARIANTS = {
    "no_lookback": [("for (int64_t pos = tile - 1; pos >= 0; pos -= kLook) {",
                     "for (int64_t pos = tile - 1; pos < 0; pos -= kLook) {")],
    "no_emit": [("    if (phase == 1) {\n      int lo = 0;",
                 "    if (false) {\n      int lo = 0;")],
    "tickets_only": [(_ROWS, _ROWS + "    if (rows > 0) {\n      "
                      "__syncthreads();\n      continue;\n    }\n")],
    # the timeline: a tile's start, probe, scan, look-back and end
    "timeline": [(_ROWS, _ROWS + _stamp(0)), (_PROBED, _stamp(1) + _PROBED),
                 (_LOOK, _stamp(2) + _LOOK), (_EMIT, _stamp(3) + _EMIT),
                 (_END, _END + _stamp(4))],
}


def _build_join_variants():
    """Start one nvcc a join_match variant; {name: (process, library)}."""
    from spark_rapids_tpu_torch import native
    src = (native.CSRC / "join_match.cu").read_text()
    sources = {}
    for name, subs in JOIN_VARIANTS.items():      # all checked, then built
        s = src
        for old, new in subs:
            cs._check(old in s, f"{name}: no {old!r} in the kernel")
            s = s.replace(old, new)
        sources[name] = s
    started = {}
    for name, s in sources.items():
        d = native.BUILD_DIR / "variants" / f"join_match_{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "join_match.cu").write_text(s)
        lib = d / "libjoin_match.so"
        started[name] = (subprocess.Popen(
            [native._nvcc(), *native.NVCC_FLAGS, "-I", str(native.CSRC),
             "-o", str(lib), str(d / "join_match.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return started


def _join_launch_fn(lib_path):
    lib = ctypes.CDLL(str(lib_path))
    lib.join_match_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.join_match_launch.restype = ctypes.c_int
    return lib.join_match_launch


def _timeline(sw, sn, table, launch_fn, phase: int) -> str:
    """One launch of the timeline variant in ``phase`` (after one
    untimed): each phase's median and largest time over the tiles, in
    microseconds."""
    import torch
    from spark_rapids_tpu_torch.exec import join_match as jm
    n = int(sw.shape[0])
    tiles = -(-n // jm.TILE_ROWS)
    rows = jm._single_rows(table, n, "inner") if jm.launch_route(
        table, n, "inner") == "single" else 4 * n
    out = torch.empty(2 * rows + 1, dtype=torch.int64, device="cuda")
    stamps = torch.zeros(tiles * 8, dtype=torch.int64, device="cuda")
    own = jm._KERNEL["launch"]
    jm._KERNEL["launch"] = launch_fn
    try:
        launch = jm._card_launch(sw.get_device(), jm._stream(sw))
        for _ in range(2):
            v = jm._pack(sw, sn, table, "inner", phase,
                         out.data_ptr() + 2 * rows * 8, 0,
                         out.data_ptr() if phase else 0,
                         out.data_ptr() + rows * 8 if phase else 0, 0,
                         rows if phase else 0)
            v[12] = stamps.data_ptr()
            launch(v)
            torch.cuda.synchronize()
    finally:
        jm._KERNEL["launch"] = own
    t = stamps.view(tiles, 8)[:, :5].cpu().numpy().astype(np.float64)
    d = np.diff(t, axis=1) / 1e3
    end = (t[:, 4] - t[:, 0].min()) / 1e3
    return "; ".join(
        f"{name} {np.median(d[:, i]):.2f} (largest {d[:, i].max():.2f})"
        for i, name in enumerate(("probe", "scan", "look-back", "emit"))) + \
        f"; last tile ends {end.max():.2f} after the first starts"


def join_section(old_build, variants) -> None:
    """Commit 843e714's design against the port's kernel in turns on both
    shapes; then the kernel's variants and its timeline."""
    import torch
    from spark_rapids_tpu_torch.exec import join_match as jm
    proc, lib = old_build
    log, _ = proc.communicate(timeout=600)
    cs._check(proc.returncode == 0, f"nvcc failed for 843e714's join_match:\n"
                                    f"{log}")
    fns = {}
    for name, (vproc, vlib) in variants.items():
        vlog, _ = vproc.communicate(timeout=600)
        cs._check(vproc.returncode == 0, f"nvcc failed for {name}:\n{vlog}")
        fns[name] = _join_launch_fn(vlib)
    shapes = {"q3's first join": cs.q3_join_shape(),
              "100,000 build keys of 1-8 rows": cs._join_case(
                  np.random.RandomState(100), 100_000, ("i64",))}
    for label, (sw, sn, bw, bn) in shapes.items():
        table = jm.build_table(bw, bn)
        old = _Join843e714(lib, table)
        got, want = jm.join_match(sw, sn, table, "inner"), old.call(sw, sn)
        torch.cuda.synchronize()
        cs._check(torch.equal(got.stream, want[0])
                  and torch.equal(got.build, want[1]),
                  f"{label}: 843e714's maps and the port's differ")
        new_both, total, route = cs._raw_join_calls(sw, sn, table)
        old_both = old.launches(sw, sn)
        per = sw.nbytes + sn.nbytes
        copies = [(sw, sn)] + [(sw.clone(), sn.clone()) for _ in range(
            max(1, -(-cs.COLD_BYTES // per) - 1))]
        kern = {"843e714": [], "this": []}
        call = {"843e714": [], "this": []}
        for name in ("843e714", "this", "this", "843e714"):
            fn = old_both if name == "843e714" else new_both
            kern[name].append(cs._cold_ms(fn, copies,
                                          f"join_match {name} {label}")[0])
            whole = (lambda: old.call(sw, sn)) if name == "843e714" else \
                (lambda: jm.join_match(sw, sn, table, "inner"))
            call[name].append(cs._call_ms(whole)[0])
        b = cs.join_bound(sw, sn, table, total)
        print(f"join_match on {label} ({sw.shape[0]} stream rows, "
              f"{int(table.ukeys.shape[0])} build keys, {total} pairs; this "
              f"design's route {route}), cold device ms a call in turns "
              f"843e714, this, this, 843e714: kernels "
              f"{kern['843e714'][0]:.4f}, {kern['this'][0]:.4f}, "
              f"{kern['this'][1]:.4f}, {kern['843e714'][1]:.4f}; whole call "
              f"{call['843e714'][0]:.4f}, {call['this'][0]:.4f}, "
              f"{call['this'][1]:.4f}, {call['843e714'][1]:.4f}; bound "
              f"{b['ms']:.4f} ({b['bytes']} B)", flush=True)
        own = jm._KERNEL["launch"]
        ms = {}
        for name in ("kernel", "no_lookback", "no_emit", "tickets_only",
                     "kernel again"):
            jm._KERNEL["launch"] = own if name.startswith("kernel") \
                else fns[name]
            try:
                ms[name] = cs._cold_ms(new_both, copies,
                                       f"join_match {name} {label}")[0]
            finally:
                jm._KERNEL["launch"] = own
        print(f"join_match variants on {label}, cold device ms a call: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
        for phase in ((1,) if route == "single" else (0, 1)):
            print(f"join_match timeline on {label}, "
                  f"{'emit' if phase else 'count'} launch, us a tile: "
                  + _timeline(sw, sn, table, fns["timeline"], phase),
                  flush=True)


#: distinct_flag of commit 04f2565 (two launches a batch: insert, then
#: mark), its header inlined: kept here only to be timed beside the
#: port's kernel
DISTINCT_FLAG_04F2565 = r"""// distinct_flag: the first stream occurrence of each (group, value) key,
// through a persistent open-addressing hash table on the card.
//
// Replaces the reference's jitted jnp kernels of
// spark_rapids_tpu/exec/distinct_flag.py: ``_probe_insert`` (:83, the
// scatter-min claim rounds in a while_loop), ``_flag_kernel`` (:133) and
// ``_rebuild_kernel`` (:166). The flags must be exactly the reference's:
// true on the LOWEST row of the first batch that holds a key, false on
// every other row and on every row whose value is NULL.
//
// Design (csrc/distinct_flag_row.cuh holds the per-row logic):
//  * two launches a batch. Pass 1 (distinct_flag_insert_kernel): a
//    thread a row inserts or finds its key by linear probing, claiming
//    an EMPTY slot with atomicCAS (EMPTY -> BUSY), writing the key's
//    words and its row, then publishing READY with the batch's epoch
//    after a fence; a prober that meets BUSY reads the word again (the
//    owner is one step from publishing; independent thread scheduling
//    lets a spinning lane and its owner share a warp). A row whose key
//    is new in this batch atomicMins its row into the slot's first-row
//    word and keeps the slot's index in scratch; a key from an earlier
//    batch gives -1. Pass 2 (distinct_flag_mark_kernel) flags a row
//    whose slot's first row is the row. atomicCAS picks any winner
//    among a batch's rows of one key; the min makes the flagged row
//    the lowest, so the flags are the same bits every run.
//  * no memset between batches: the host advances the epoch.
//  * the table's size comes from a host-known bound on the rows
//    inserted (load at most 1/2); growth is a rehash launch
//    (distinct_flag_rehash_kernel) into a larger zeroed table. An insert
//    that passes every slot sets the error word, which the host reads
//    once at the end of the stream.
//
// Bound: memory. Each row's key words and validity are read once, its
// flag written once, and one 32-byte slot (one sector) read, plus one
// written for each new key; the row's 4-byte scratch slot index is
// written and read as well.
#include <cuda_runtime.h>
#include <stdint.h>

// The per-row logic of the distinct_flag kernel (csrc/distinct_flag.cu):
// the normalisation of a key word, the hash, the slot compare and the
// insert-or-find step of the open-addressing table.
// Everything here is __host__ __device__, so g++ builds it on a machine
// without CUDA and the tests run the kernel's two passes on the host,
// each row's steps interleaved in shuffled thread orders
// (tests/test_torch_distinct.py).
//
// A key is (group word, group null bit, value word). A word is the
// column's value normalised so that equal SQL values have equal words:
// narrow integers sign-extend to 64 bits, floats are their bit patterns
// with -0.0 as +0.0 and every NaN as one pattern (a float32's 32-bit
// pattern, sign-extended). A NULL group is a real group: its word is 0
// and its null bit 1. Full keys are stored and compared; no result
// relies on the hash being unique.
//
// A slot is 32 bytes, one sector of device memory: the two key words, a
// state word and the first row. The state word is EMPTY (0), BUSY (a
// thread has claimed the slot and is writing its key) or READY:
// (epoch << 1) | group null bit, where the epoch is the batch that
// inserted the key (1, 2, ...; the host advances it every batch, so no
// table is ever cleared between batches). ``first`` holds the lowest row
// of that batch with the key (atomicMin).
#pragma once
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define DF_HD __host__ __device__ __forceinline__
#else
#define DF_HD inline
#endif

// the element type of a key column, read raw (the wrapper's
// exec/distinct_flag.py _KIND); a bool column is read as int8
enum DfKind { DF_I8 = 0, DF_I16 = 1, DF_I32 = 2, DF_I64 = 3, DF_F32 = 4,
              DF_F64 = 5 };

struct alignas(32) DfSlot {
  int64_t val;
  int64_t grp;
  uint32_t state;
  int32_t first;
  int64_t pad;
};
static_assert(sizeof(DfSlot) == 32, "a slot is one 32-byte sector");

constexpr uint32_t kDfEmpty = 0u;
constexpr uint32_t kDfBusy = 0xFFFFFFFFu;
// the largest epoch: READY words stay below BUSY
constexpr int64_t kDfMaxEpoch = (int64_t)1 << 30;

DF_HD uint32_t df_ready(int64_t epoch, bool gnull) {
  return ((uint32_t)epoch << 1) | (gnull ? 1u : 0u);
}
DF_HD int64_t df_epoch(uint32_t state) { return (int64_t)(state >> 1); }
DF_HD bool df_gnull(uint32_t state) { return (state & 1u) != 0; }

DF_HD int64_t df_norm_f64(double d) {
  if (d != d) return 0x7FF8000000000000LL;  // every NaN as numpy's nan
  d = d == 0.0 ? 0.0 : d;                   // -0.0 as +0.0
  int64_t bits;
  memcpy(&bits, &d, sizeof bits);
  return bits;
}

DF_HD int64_t df_norm_f32(float f) {
  if (f != f) return 0x7FC00000LL;
  f = f == 0.0f ? 0.0f : f;
  int32_t bits;
  memcpy(&bits, &f, sizeof bits);
  return bits;  // sign-extended
}

// row i of a column of ``kind``, normalised
DF_HD int64_t df_norm(const void* col, int kind, int64_t i) {
  switch (kind) {
    case DF_I8: return ((const int8_t*)col)[i];
    case DF_I16: return ((const int16_t*)col)[i];
    case DF_I32: return ((const int32_t*)col)[i];
    case DF_I64: return ((const int64_t*)col)[i];
    case DF_F32: return df_norm_f32(((const float*)col)[i]);
    default: return df_norm_f64(((const double*)col)[i]);
  }
}

// splitmix64's finaliser over the key's words
DF_HD uint64_t df_hash(int64_t val, int64_t grp, bool gnull) {
  uint64_t x = (uint64_t)val ^ ((uint64_t)grp * 0x9E3779B97F4A7C15ULL) ^
               ((uint64_t)gnull << 1);
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// One thread's probe: the slot it looks at, the slots it has passed, and
// whether it has claimed the slot (then its next step writes the key).
struct DfProbe {
  int64_t pos;
  int64_t steps;
  int owned;
};

DF_HD DfProbe df_probe(int64_t val, int64_t grp, bool gnull, int64_t mask) {
  DfProbe p;
  p.pos = (int64_t)(df_hash(val, grp, gnull) & (uint64_t)mask);
  p.steps = 0;
  p.owned = 0;
  return p;
}

enum DfStep { DF_AGAIN = 0, DF_DONE = 1, DF_FAIL = 2 };

// One step of inserting or finding the key (val, grp, gnull) in a table
// of mask + 1 slots. ``ready`` is the state word to publish for a new
// key and ``first`` its row; ``copy`` (a rehash: every key is new)
// fails on a key found. On DF_DONE, ``*slot`` is the key's slot when
// the key is new in the epoch of ``ready`` (inserted now, or by another
// row of this batch, whose ``first`` then takes the lower row), else -1.
// DF_FAIL: every slot has been passed (the table is full) or a rehash
// found its key.
//
// ``ops`` are the memory operations: on the card, volatile loads,
// atomicCAS, a fence then atomicExch to publish, a fence after seeing
// READY, and atomicMin; on the host, plain ones.
template <class Ops>
DF_HD int df_step(DfSlot* table, int64_t mask, int64_t val, int64_t grp,
                  bool gnull, uint32_t ready, int32_t first, bool copy,
                  DfProbe& p, int64_t* slot, const Ops& ops) {
  DfSlot* s = table + p.pos;
  if (p.owned) {
    s->val = val;
    s->grp = grp;
    s->first = first;
    ops.publish(&s->state, ready);
    *slot = p.pos;
    return DF_DONE;
  }
  uint32_t st = ops.load(&s->state);
  if (st == kDfEmpty) {
    st = ops.cas(&s->state, kDfEmpty, kDfBusy);
    if (st == kDfEmpty) {
      p.owned = 1;
      return DF_AGAIN;
    }
  }
  if (st == kDfBusy) return DF_AGAIN;  // the owner is writing: look again
  ops.acquire();
  if (df_gnull(st) == gnull && ops.load64(&s->val) == val &&
      ops.load64(&s->grp) == grp) {
    if (copy) return DF_FAIL;
    if (df_epoch(st) == df_epoch(ready)) {
      ops.min(&s->first, first);
      *slot = p.pos;
    } else {
      *slot = -1;
    }
    return DF_DONE;
  }
  if (++p.steps > mask) return DF_FAIL;
  p.pos = (p.pos + 1) & mask;
  return DF_AGAIN;
}

// Pass 2's flag of row ``i`` whose pass 1 gave ``slot``: the row is the
// first of its key in the stream.
DF_HD bool df_flag(const DfSlot* table, int32_t slot, int64_t i) {
  return slot >= 0 && (int64_t)table[slot].first == i;
}

namespace {

constexpr int kThreads = 256;

struct DeviceOps {
  __device__ uint32_t load(uint32_t* w) const {
    return *(volatile uint32_t*)w;
  }
  __device__ uint32_t cas(uint32_t* w, uint32_t expect,
                          uint32_t value) const {
    return atomicCAS(w, expect, value);
  }
  __device__ void publish(uint32_t* w, uint32_t value) const {
    __threadfence();
    atomicExch(w, value);
  }
  __device__ void acquire() const { __threadfence(); }
  __device__ int64_t load64(int64_t* w) const {
    return *(volatile int64_t*)w;
  }
  __device__ void min(int32_t* w, int32_t value) const { atomicMin(w, value); }
};

}  // namespace

// One batch's launch arguments, 8 bytes a field (the wrapper's
// exec/distinct_flag.py _pack order).
struct DistinctFlagArgs {
  const void* val;        // the value column, of kind vkind
  int64_t vkind;
  const uint8_t* vvalid;  // the value's validity (a NULL value never flags)
  const void* grp;        // the group column, of kind gkind; null: none
  int64_t gkind;
  const uint8_t* gvalid;
  int64_t n;              // rows
  DfSlot* table;
  int64_t capacity;       // slots, a power of two
  int32_t* slot_of_row;   // scratch, n words: pass 1 -> pass 2
  uint8_t* flags;         // n bools
  int32_t* error;         // set when an insert passed every slot
  int64_t epoch;          // this batch's, 1 .. kDfMaxEpoch
};

__global__ void __launch_bounds__(kThreads)
    distinct_flag_insert_kernel(const DistinctFlagArgs a) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  int64_t slot = -1;
  if (a.vvalid[i]) {
    const int64_t val = df_norm(a.val, (int)a.vkind, i);
    bool gnull = false;
    int64_t grp = 0;
    if (a.grp != nullptr) {
      gnull = a.gvalid[i] == 0;
      grp = gnull ? 0 : df_norm(a.grp, (int)a.gkind, i);
    }
    const int64_t mask = a.capacity - 1;
    const uint32_t ready = df_ready(a.epoch, gnull);
    DfProbe p = df_probe(val, grp, gnull, mask);
    int r;
    do {
      r = df_step(a.table, mask, val, grp, gnull, ready, (int32_t)i, false,
                  p, &slot, DeviceOps());
    } while (r == DF_AGAIN);
    if (r == DF_FAIL) {
      atomicOr(a.error, 1);
      slot = -1;
    }
  }
  a.slot_of_row[i] = (int32_t)slot;
}

__global__ void __launch_bounds__(kThreads)
    distinct_flag_mark_kernel(const DistinctFlagArgs a) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  a.flags[i] = df_flag(a.table, a.slot_of_row[i], i) ? 1 : 0;
}

// Every READY slot of ``old`` into ``table`` with its state and first row
// (the stored keys are distinct: each insert finds an EMPTY slot).
__global__ void __launch_bounds__(kThreads)
    distinct_flag_rehash_kernel(const DfSlot* old, int64_t old_capacity,
                                DfSlot* table, int64_t capacity,
                                int32_t* error) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= old_capacity) return;
  const DfSlot s = old[j];
  if (s.state == kDfEmpty) return;
  const int64_t mask = capacity - 1;
  const bool gnull = df_gnull(s.state);
  DfProbe p = df_probe(s.val, s.grp, gnull, mask);
  int64_t slot;
  int r;
  do {
    r = df_step(table, mask, s.val, s.grp, gnull, s.state, s.first, true, p,
                &slot, DeviceOps());
  } while (r == DF_AGAIN);
  if (r == DF_FAIL) atomicOr(error, 1);
}

static int64_t blocks_for(int64_t n) { return (n + kThreads - 1) / kThreads; }

static bool valid_args(const DistinctFlagArgs* a) {
  const uint64_t t = reinterpret_cast<uintptr_t>(a->table);
  return a->capacity >= 2 && (a->capacity & (a->capacity - 1)) == 0 &&
         a->capacity <= ((int64_t)1 << 31) && (t & 31) == 0 &&
         a->epoch >= 1 && a->epoch <= kDfMaxEpoch &&
         a->n < ((int64_t)1 << 31) &&
         a->vkind >= DF_I8 && a->vkind <= DF_F64 &&
         (a->grp == nullptr || (a->gkind >= DF_I8 && a->gkind <= DF_F64));
}

// Pass 1 over one batch (module doc); a batch of no rows launches nothing.
extern "C" int distinct_flag_insert(const DistinctFlagArgs* a, void* stream) {
  if (!valid_args(a)) return (int)cudaErrorInvalidValue;
  if (a->n <= 0) return 0;
  distinct_flag_insert_kernel<<<(unsigned)blocks_for(a->n), kThreads, 0,
                                (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// Pass 2 over the same batch.
extern "C" int distinct_flag_mark(const DistinctFlagArgs* a, void* stream) {
  if (!valid_args(a)) return (int)cudaErrorInvalidValue;
  if (a->n <= 0) return 0;
  distinct_flag_mark_kernel<<<(unsigned)blocks_for(a->n), kThreads, 0,
                              (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// Growth: ``old``'s keys into ``table``, which the caller has zeroed.
extern "C" int distinct_flag_rehash(const DfSlot* old, int64_t old_capacity,
                                    DfSlot* table, int64_t capacity,
                                    int32_t* error, void* stream) {
  if (capacity <= old_capacity || (capacity & (capacity - 1)) != 0 ||
      capacity > ((int64_t)1 << 31) ||
      (reinterpret_cast<uintptr_t>(table) & 31) != 0)
    return (int)cudaErrorInvalidValue;
  if (old_capacity <= 0) return 0;
  distinct_flag_rehash_kernel<<<(unsigned)blocks_for(old_capacity), kThreads,
                                0, (cudaStream_t)stream>>>(
      old, old_capacity, table, capacity, error);
  return (int)cudaGetLastError();
}

extern "C" int64_t distinct_flag_slot_bytes() { return sizeof(DfSlot); }

// Registers a thread of the insert kernel (for reports).
extern "C" int distinct_flag_describe(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, distinct_flag_insert_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], distinct_flag_insert_kernel, kThreads, 0);
  return (int)err;
}
"""

_PUBLISH = "    __threadfence();\n    atomicExch(w, value);\n"
_ACQUIRE = "  __device__ void acquire() const { __threadfence(); }\n"
#: commit 04f2565's kernel and its variants by text substitution:
#: no_fence publishes READY by a plain store and meets it without a fence
#: (wrong by design: only its time counts)
DF_VARIANTS = {
    "04f2565": [],
    "04f2565_no_fence": [(_PUBLISH, "    *(volatile uint32_t*)w = value;\n"),
                         (_ACQUIRE, "  __device__ void acquire() const {}\n")],
}


def _build_df_04f2565():
    """Start one nvcc for commit 04f2565's distinct_flag and each of its
    variants; {name: (process, library)}."""
    from spark_rapids_tpu_torch import native
    sources = {}
    for name, subs in DF_VARIANTS.items():        # all checked, then built
        s = DISTINCT_FLAG_04F2565
        for old, new in subs:
            cs._check(old in s, f"{name}: no {old!r} in the kernel")
            s = s.replace(old, new)
        sources[name] = s
    started = {}
    for name, s in sources.items():
        d = native.BUILD_DIR / "variants" / f"distinct_flag_{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "distinct_flag.cu").write_text(s)
        lib = d / "libdistinct_flag.so"
        started[name] = (subprocess.Popen(
            [native._nvcc(), *native.NVCC_FLAGS, "-o", str(lib),
             str(d / "distinct_flag.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    return started


def _df_scratch(x):
    """A batch's slot-of-row scratch and flags for commit 04f2565."""
    import torch
    n = int(x[0].shape[0])
    return (torch.empty(n, dtype=torch.int32, device="cuda"),
            torch.empty(n, dtype=torch.bool, device="cuda"))


class _Flag04f2565:
    """Commit 04f2565's launches over one zeroed table of ``capacity``
    slots, with that commit's DistinctFlagArgs order (the host advances
    the epoch a batch)."""

    def __init__(self, lib, capacity: int):
        import torch
        self.lib, self.capacity, self.epoch = lib, capacity, 0
        self.slots = torch.zeros(capacity * 4, dtype=torch.int64,
                                 device="cuda")
        self.error = torch.zeros(1, dtype=torch.int32, device="cuda")
        self.stream = torch.cuda.current_stream().cuda_stream

    def run(self, x, scratch, passes=("insert", "mark"), advance=True):
        from spark_rapids_tpu_torch.exec.distinct_flag import _KIND
        v, vv, g, gv = x
        sor, flags = scratch
        self.epoch += bool(advance)
        packed = array.array("q", [
            v.data_ptr(), _KIND[v.dtype], vv.data_ptr(),
            0 if g is None else g.data_ptr(),
            0 if g is None else _KIND[g.dtype],
            0 if g is None else gv.data_ptr(), v.shape[0],
            self.slots.data_ptr(), self.capacity, sor.data_ptr(),
            flags.data_ptr(), self.error.data_ptr(), self.epoch])
        for p in passes:
            rc = getattr(self.lib, f"distinct_flag_{p}")(
                packed.buffer_info()[0], self.stream)
            cs._check(rc == 0, f"04f2565's {p} failed: CUDA error {rc}")
        return flags


def _df_old_times(lib, cap: int, batches, at: int, count_copy: bool):
    """Commit 04f2565's launches (both, insert alone, mark alone) timed
    cold on q28's batch ``at`` against a table of ``cap`` slots holding
    the earlier batches' keys, and on the first batch against fresh
    tables; with ``count_copy``, also both launches followed by an 8-byte
    copy into pinned host memory and an event (a key count's read-back)."""
    import torch
    first, last = batches[0], batches[at]
    n0, n = int(first[0].shape[0]), int(last[0].shape[0])
    t = _Flag04f2565(lib, cap)
    for x in batches[:at]:
        t.run(x, _df_scratch(x))
    copies = [last] + [tuple(None if c is None else c.clone() for c in last)
                       for _ in range(max(1, -(-cs.COLD_BYTES // (18 * n))
                                          - 1))]
    inputs = [(x, _df_scratch(x)) for x in copies]
    ms = {}
    for label, passes in (("both", ("insert", "mark")),
                          ("insert", ("insert",)), ("mark", ("mark",))):
        ms[label] = cs._cold_ms(
            lambda x, s, p=passes: t.run(x, s, p, advance=p[0] == "insert"),
            inputs, f"04f2565 {label} {cap}")[0]
    if count_copy:
        word = torch.zeros(1, dtype=torch.int64, device="cuda")
        host = torch.zeros(1, dtype=torch.int64, pin_memory=True)

        def with_copy(x, s):
            t.run(x, s)
            host.copy_(word, non_blocking=True)
            torch.cuda.Event().record()
        ms["both + count copy"] = cs._cold_ms(with_copy, inputs,
                                              f"04f2565 copy {cap}")[0]
    cs._check(not bool(t.error.item()), "04f2565 set its error word")
    del t, inputs, copies
    k = max(2, -(-cs.COLD_BYTES // (cap * 32 + 18 * n0)))
    scratch = [_df_scratch(first) for _ in range(k)]
    xs = [tuple(None if c is None else c.clone() for c in first)
          for _ in range(k)]
    for label, passes in (("both", ("insert", "mark")),
                          ("insert", ("insert",))):
        tables = [_Flag04f2565(lib, cap) for _ in range(k)]
        torch.cuda.synchronize()
        ms[f"first {label}"] = cs._queued_ms(
            [lambda t=t, x=x, s=s, p=passes: t.run(x, s, p)
             for t, x, s in zip(tables, xs, scratch)],
            f"04f2565 first {label} {cap}")[0]
        if label == "insert":
            ms["first mark"] = cs._queued_ms(
                [lambda t=t, x=x, s=s: t.run(x, s, ("mark",), advance=False)
                 for t, x, s in zip(tables, xs, scratch)],
                f"04f2565 first mark {cap}")[0]
        del tables
    return ms, n, n0, k


#: the port's distinct_flag with one part changed by text substitution:
#: fences (04f2565's fences in place of the release store and acquire
#: loads; flags still right), no_barrier (no grid barrier: wrong by
#: design, only its time counts)
DF_NEW_VARIANTS = {
    "fences": [
        ("    return StateRef(*w).load(cuda::memory_order_acquire);\n",
         "    const uint32_t v = *(volatile uint32_t*)w;\n"
         "    __threadfence();\n    return v;\n"),
        ("    StateRef(*w).store(value, cuda::memory_order_release);\n",
         "    __threadfence();\n    atomicExch(w, value);\n")],
    "no_barrier": [("  cg::this_grid().sync();\n", "")],
}


def _build_df_variants():
    """Start one nvcc a variant of the port's distinct_flag; {name:
    (process, library)}."""
    from spark_rapids_tpu_torch import native
    src = (native.CSRC / "distinct_flag.cu").read_text()
    sources = {}
    for name, subs in DF_NEW_VARIANTS.items():    # all checked, then built
        s = src
        for old, new in subs:
            cs._check(old in s, f"{name}: no {old!r} in the kernel")
            s = s.replace(old, new)
        sources[name] = s
    started = {}
    for name, s in sources.items():
        d = native.BUILD_DIR / "variants" / f"distinct_flag_{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "distinct_flag.cu").write_text(s)
        lib = d / "libdistinct_flag.so"
        started[name] = (subprocess.Popen(
            [native._nvcc(), *native.NVCC_FLAGS, "-I", str(native.CSRC),
             "-o", str(lib), str(d / "distinct_flag.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return started


def _finish(builds):
    """Wait for nvcc; {name: library}, each reported and free of stack
    frames and spills."""
    libs = {}
    for name, (proc, path) in builds.items():
        log, _ = proc.communicate(timeout=600)
        cs._check(proc.returncode == 0, f"nvcc failed for {name}:\n{log}")
        frames = cs._ptxas_frames(log)
        print(f"ptxas distinct_flag {name}: " + "; ".join(
            ln.strip() for ln in log.splitlines() if "registers" in ln),
            flush=True)
        cs._check(all(f[1:] == (0, 0, 0) for f in frames),
                  f"{name}: a stack frame or spills {frames}")
        libs[name] = ctypes.CDLL(str(path))
    return libs


def _use_df(lib):
    """Point the port's wrapper at another build of its kernel (None: its
    own), with that build's grid."""
    from spark_rapids_tpu_torch.exec import distinct_flag as dfl
    dfl._KERNEL.clear()
    k = dfl._kernel()
    if lib is not None:
        lib.distinct_flag_launch.argtypes = [ctypes.c_void_p] * 2
        lib.distinct_flag_launch.restype = ctypes.c_int
        lib.distinct_flag_describe.argtypes = [ctypes.c_void_p]
        lib.distinct_flag_describe.restype = ctypes.c_int
        k.update(launch=lib.distinct_flag_launch,
                 describe=lib.distinct_flag_describe)


def _clones(x, k: int):
    return [x] + [tuple(None if c is None else c.clone() for c in x)
                  for _ in range(k - 1)]


def _turns(libs, batches, at: int, cap: int) -> dict:
    """Cold device ms a call of 04f2565's two launches and the port's one,
    in turns (04f2565, this, this, 04f2565), against tables of ``cap``
    slots: on batch ``at`` with the earlier batches' keys in the table,
    and on the first batch against fresh tables."""
    import torch
    from spark_rapids_tpu_torch.exec import distinct_flag as dfl
    last, first = batches[at], batches[0]
    n, n0 = int(last[0].shape[0]), int(first[0].shape[0])
    old = _Flag04f2565(libs["04f2565"], cap)
    new = dfl.DistinctTable("cuda", cap)
    for x in batches[:at]:
        old.run(x, _df_scratch(x))
        dfl.distinct_flag(new, *x)
    copies = _clones(last, max(2, -(-cs.COLD_BYTES // (18 * n))))
    olds = [(x, _df_scratch(x)) for x in copies]
    k = max(2, -(-cs.COLD_BYTES // (cap * 32 + 18 * n0)))
    fresh = _clones(first, k)
    scratch = [_df_scratch(first) for _ in range(k)]
    out = {"late": {"04f2565": [], "this": []},
           "first": {"04f2565": [], "this": []}}
    for name in ("04f2565", "this", "this", "04f2565"):
        if name == "04f2565":
            ms = cs._cold_ms(lambda x, s: old.run(x, s), olds,
                             f"04f2565 late {cap}")[0]
            tables = [_Flag04f2565(libs["04f2565"], cap) for _ in range(k)]
            calls = [lambda t=t, x=x, s=s: t.run(x, s)
                     for t, x, s in zip(tables, fresh, scratch)]
        else:
            ms = cs._cold_ms(lambda *x: dfl.distinct_flag(new, *x), copies,
                             f"this late {cap}")[0]
            tables = [dfl.DistinctTable("cuda", cap) for _ in range(k)]
            calls = [lambda t=t, x=x: dfl.distinct_flag(t, *x)
                     for t, x in zip(tables, fresh)]
        torch.cuda.synchronize()
        out["late"][name].append(ms)
        out["first"][name].append(cs._queued_ms(calls, f"{name} first")[0])
        del tables, calls
    cs._check(not bool(old.error.item()) and not new.failed(),
              "an error word was set")
    out.update(n=n, n0=n0, k=k)
    return out


def _host_us(fn, calls: int = 50, reps: int = 21) -> float:
    """Median host microseconds a call of ``fn`` over ``reps`` loops of
    ``calls`` calls, the card synchronised between loops (outside the
    timing) so no queue backs up."""
    import time
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) * 1e6 / calls)
    torch.cuda.synchronize()
    return float(np.median(out))


def _host_split(x) -> dict:
    """Host microseconds a call of the port's wrapper on batch ``x`` and
    of its parts: without its event record, the bare ctypes launch over
    packed arguments, the two per-batch allocations, an event record."""
    import torch
    from spark_rapids_tpu_torch.exec import distinct_flag as dfl
    table = dfl.DistinctTable("cuda", 1 << 20)
    n = int(x[0].shape[0])
    out = {"wrapper": _host_us(lambda: dfl.distinct_flag(table, *x))}
    ev, table.count._last = table.count._last, None
    out["wrapper, no event"] = _host_us(lambda: dfl.distinct_flag(table, *x))
    table.count._last = ev
    sor = torch.empty(n, dtype=torch.int32, device="cuda")
    flags = torch.empty(n, dtype=torch.bool, device="cuda")
    packed = array.array("q", dfl._pack(table, *x, sor, flags))
    fn, stream = dfl._kernel()["launch"], dfl._stream(x[0])
    out["ctypes launch"] = _host_us(
        lambda: fn(packed.buffer_info()[0], stream))
    out["two allocations"] = _host_us(lambda: (
        torch.empty(n, dtype=torch.int32, device="cuda"),
        torch.empty(n, dtype=torch.bool, device="cuda")))
    e = torch.cuda.Event()
    out["event record"] = _host_us(e.record)
    cs._check(not table.failed(), "the host split's table set its error")
    return out


def distinct_section(builds, new_builds) -> None:
    """distinct_flag on q28's shapes at SF10 (its last full batch against a
    table of the earlier batches' keys, its first against fresh tables):
    commit 04f2565's two launches and the port's one in turns, at 04f2565's
    1 GiB table and at a 16 MiB one; 04f2565's launches apart, with a key
    count's copy after them, and its no_fence variant; the port's
    variants."""
    import torch
    from spark_rapids_tpu_torch.exec import distinct_flag as dfl
    libs = _finish(builds)
    for lib in libs.values():
        for f in (lib.distinct_flag_insert, lib.distinct_flag_mark):
            f.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            f.restype = ctypes.c_int
    new_libs = _finish(new_builds)
    ss = cs.gen_store_sales(cs.SF10_STORE_SALES)
    batches = cs.q28_flag_batches(ss, 1 << 20)
    del ss
    at = len(batches) - 2
    # both designs' flags equal the plain version on every batch, each
    # table sized as its own commit sizes it
    old = _Flag04f2565(libs["04f2565"], 1 << 25)
    seen, table, growths, new0 = dfl.SeenKeys(), None, 0, 0
    for j, x in enumerate(batches):
        table, grew = dfl.sized_table(table, x[0].device, int(x[0].shape[0]),
                                      dfl.HashDistinctFlagExec._MIN_SLOTS)
        growths += grew
        got_old = old.run(x, _df_scratch(x))
        got_new = dfl.distinct_flag(table, *x)
        want = dfl.distinct_flag_reference(seen, *x)
        cs._check(torch.equal(got_old, want) and torch.equal(got_new, want),
                  f"the flags differ on batch {j + 1}")
        new0 = new0 or int(want.sum())
    cs._check(not bool(old.error.item()) and not table.failed(),
              "an error word was set")
    keys = int(seen.keys.shape[0])
    del old, seen
    b = cs.distinct_bound(int(batches[at][0].shape[0]), 0)
    b0 = cs.distinct_bound(int(batches[0][0].shape[0]), new0)
    print(f"distinct_flag: q28 at SF10 in {len(batches)} batches, {keys} "
          f"keys; 04f2565's and this design's flags equal the plain version "
          f"on every batch (this design's table: {table.capacity} slots "
          f"after {growths} growths, {int(table.keys)} keys counted); bound "
          f"on batch {at + 1} {b['ms']:.4f} ms ({b['bytes']} B), on the "
          f"first ({new0} new keys) {b0['ms']:.4f} ms; "
          f"{dfl.kernel_shape()}", flush=True)
    del table
    for cap in (1 << 25, 1 << 19):
        t = _turns(libs, batches, at, cap)
        print(f"distinct_flag in turns 04f2565, this, this, 04f2565, a "
              f"table of {cap} slots ({cap * 32} B), cold device ms a call: "
              f"batch {at + 1} ({t['n']} rows) "
              f"{t['late']['04f2565'][0]:.4f}, {t['late']['this'][0]:.4f}, "
              f"{t['late']['this'][1]:.4f}, {t['late']['04f2565'][1]:.4f}; "
              f"first batch ({t['n0']} rows, {t['k']} fresh tables) "
              f"{t['first']['04f2565'][0]:.4f}, {t['first']['this'][0]:.4f}, "
              f"{t['first']['this'][1]:.4f}, "
              f"{t['first']['04f2565'][1]:.4f}", flush=True)
    for cap in (1 << 25, 1 << 19):
        for name, lib in libs.items():
            ms, n, n0, k = _df_old_times(lib, cap, batches, at,
                                         name == "04f2565")
            print(f"distinct_flag {name}, a table of {cap} slots "
                  f"({cap * 32} B), cold device ms a call: batch {at + 1} "
                  f"({n} rows) " + ", ".join(
                      f"{lb} {v:.4f}" for lb, v in ms.items()
                      if not lb.startswith("first"))
                  + f"; first batch ({n0} rows, {k} fresh tables) "
                  + ", ".join(f"{lb[6:]} {v:.4f}" for lb, v in ms.items()
                              if lb.startswith("first")), flush=True)
    cap = 1 << 19
    ms = {}
    for name in ["this", *DF_NEW_VARIANTS, "this again"]:
        _use_df(None if name.startswith("this") else new_libs[name])
        try:
            t = dfl.DistinctTable("cuda", cap)
            for x in batches[:at]:
                dfl.distinct_flag(t, *x)
            copies = _clones(batches[at], max(2, -(-cs.COLD_BYTES // (
                18 * int(batches[at][0].shape[0])))))
            got = [cs._cold_ms(lambda *x: dfl.distinct_flag(t, *x), copies,
                               f"{name} late")[0]]
            x = batches[0]
            k = max(2, -(-cs.COLD_BYTES // (cap * 32 + 18 * int(
                x[0].shape[0]))))
            tables = [dfl.DistinctTable("cuda", cap) for _ in range(k)]
            torch.cuda.synchronize()
            got.append(cs._queued_ms(
                [lambda t=t, x=x: dfl.distinct_flag(t, *x)
                 for t, x in zip(tables, _clones(x, k))],
                f"{name} fresh")[0])
            del tables
            ms[name] = got
            del t
        finally:
            _use_df(None)
    print(f"distinct_flag variants of this design, tables of {cap} slots, "
          f"cold device ms a call (batch {at + 1}; first batch): " + ", ".join(
              f"{k} " + "; ".join(f"{v:.4f}" for v in t)
              for k, t in ms.items()), flush=True)
    split = _host_split(batches[at])
    print(f"distinct_flag host microseconds a call on batch {at + 1} "
          "(median of 21 loops of 50 calls): " + ", ".join(
              f"{k} {v:.2f}" for k, v in split.items()), flush=True)

#: decimal_arith variants, each the kernel with one part changed by a text
#: substitution in csrc/decimal_arith.cu: (substitutions, whether its
#: results are the kernel's own)
DA_VARIANTS = {
    "rows_1": ([("constexpr int kRows = 2;", "constexpr int kRows = 1;")],
               True),
    "rows_4": ([("constexpr int kRows = 2;", "constexpr int kRows = 4;")],
               True),
    "waves_1": ([("constexpr int kWaves = 2;", "constexpr int kWaves = 1;")],
                True),
    "waves_4": ([("constexpr int kWaves = 2;", "constexpr int kWaves = 4;")],
                True),
    "waves_32": ([("constexpr int kWaves = 2;",
                   "constexpr int kWaves = 32;")], True),
    "blocks_4": ([("__global__ void __launch_bounds__(kThreads) "
                   "decimal_arith_kernel(",
                   "__global__ void __launch_bounds__(kThreads, 4) "
                   "decimal_arith_kernel(")], True),
    "rows_1_blocks_4": ([("constexpr int kRows = 2;",
                          "constexpr int kRows = 1;"),
                         ("__global__ void __launch_bounds__(kThreads) "
                          "decimal_arith_kernel(",
                          "__global__ void __launch_bounds__(kThreads, 4) "
                          "decimal_arith_kernel(")], True),
    "loads_only": ([("          da_row_c(OP, k, cur.x[0][j], cur.x[1][j], "
                     "cur.x[2][j],\n                   cur.x[3][j], &v) &&",
                     "          ((v = cur.x[0][j] ^ cur.x[1][j] ^ "
                     "cur.x[2][j] ^ cur.x[3][j]), true) &&")], False),
    # what a row's reciprocal costs (div, avg, rem): none built
    "no_reciprocal": ([("H:DA_HD uint64_t da_recip(uint64_t d) {\n",
                        "DA_HD uint64_t da_recip(uint64_t d) {\n"
                        "  if (d != 1) return ~d;\n")], False),
}


def _build_da_variants():
    """Start one nvcc a variant of the port's decimal_arith; {name:
    (process, library)}."""
    from spark_rapids_tpu_torch import native
    src = (native.CSRC / "decimal_arith.cu").read_text()
    hdr = (native.CSRC / "decimal_arith_row.cuh").read_text()
    started = {}
    for name, (subs, _) in DA_VARIANTS.items():
        s, h = src, hdr
        for old, new in subs:
            if old.startswith("H:"):
                cs._check(old[2:] in h, f"{name}: no {old[2:]!r} in header")
                h = h.replace(old[2:], new)
            else:
                cs._check(old in s, f"{name}: no {old!r} in the kernel")
                s = s.replace(old, new)
        d = native.BUILD_DIR / "variants" / f"decimal_arith_{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "decimal_arith.cu").write_text(s)
        (d / "decimal_arith_row.cuh").write_text(h)
        lib = d / "libdecimal_arith.so"
        started[name] = (subprocess.Popen(
            [native._nvcc(), *native.NVCC_FLAGS, "-I", str(d),
             "-o", str(lib), str(d / "decimal_arith.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return started


def decimal_section(builds) -> None:
    """decimal_arith beside its variants (DA_VARIANTS) on chip_smoke.py's
    phase 19 (d) shapes, cold, in turns (kernel, variants, variants in
    reverse, kernel); the variants that keep the kernel's results are
    checked bit for bit against it first."""
    import torch
    from spark_rapids_tpu_torch.exprs import decimal_arith as DA
    fns = {}
    for name, (proc, path) in builds.items():
        log, _ = proc.communicate(timeout=600)
        cs._check(proc.returncode == 0, f"nvcc failed for {name}:\n{log}")
        frames = cs._ptxas_frames(log)
        regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers",
                                                   log)})
        if any(f[1:] != (0, 0, 0) for f in frames):
            print(f"ptxas decimal_arith {name}: a stack frame or spills "
                  f"{sorted({f[1:] for f in frames})}, registers {regs}: "
                  "not timed", flush=True)
            continue
        print(f"ptxas decimal_arith {name}: registers {regs}", flush=True)
        fns[name] = cs._decimal_arith_compare(name, ctypes.CDLL(str(path)))
    rng = np.random.RandomState(19)
    for which in cs.DA_TIMED:
        op = "to_double" if which == "to_double_q1" else which
        ops, valid, valid2, k, t, m, p, row_bytes = cs._da_inputs(
            rng, cs.DA_ROWS, which)
        n_ops = len(ops)
        ops = ops + [valid] + ([valid2] if valid2 is not None else [])

        def call(f, op=op, n_ops=n_ops, k=k, t=t, m=m, p=p):
            return lambda *x: f(op, x[:n_ops], x[n_ops],
                                x[n_ops + 1] if len(x) > n_ops + 1
                                else None, k, t, m, p)
        kern = call(DA.decimal_arith)
        want, wok = kern(*ops)
        for name, f in fns.items():
            if DA_VARIANTS[name][1]:
                got, ok = call(f)(*ops)
                cs._check(torch.equal(got, want) and torch.equal(ok, wok),
                          f"decimal_arith {which}: variant {name} differs")
        n = max(2, -(-cs.COLD_BYTES // (row_bytes * cs.DA_ROWS)))
        inputs = [tuple(ops)] + [tuple(o.clone() for o in ops)
                                 for _ in range(n - 1)]
        order = [("kernel", kern)] + [(name, call(f))
                                      for name, f in fns.items()]
        turns = {name: [] for name, _ in order}
        for name, f in order + order[::-1]:
            turns[name].append(cs._cold_ms(f, inputs,
                                           f"{which} {name}")[0])
        bound = row_bytes * cs.DA_ROWS / cs.HBM_BYTES_PER_S * 1e3
        print(f"decimal_arith variants, {which} ({cs.DA_ROWS} rows, bound "
              f"{bound:.4f} ms), device ms a call, cold: " + ", ".join(
                  f"{name} {np.mean(v):.4f} ({v[0]:.4f}/{v[1]:.4f})"
                  for name, v in turns.items()), flush=True)
        del ops, inputs


#: rect_dfa variants, each the kernel with one part changed by a text
#: substitution in csrc/rect_dfa.cu ("K:" or no prefix; a triple replaces
#: the kernel's text from its first string to its second) or
#: csrc/rect_dfa_row.cuh ("H:"): (substitutions, the tables it is handed:
#: None as the wrapper hands them, "class" the class-indexed table).
#: Every variant but RD_INEXACT's keeps the kernel's answers.
_RD_GROUP_BODY = """  const int whole = n >= 16 * kRdGroup ? kRdGroup : n >> 4;
  RD_UNROLL
  for (int c = 0; c < kRdGroup; ++c)
    if (c < whole && s < first_sink) s = rd_full(step, s, g[c]);
  const int rest = n - 16 * whole;
  if (whole < kRdGroup && rest > 0 && s < first_sink) {
    uint32_t w[4] = {g[0][0], g[0][1], g[0][2], g[0][3]};
    RD_UNROLL
    for (int c = 1; c < kRdGroup; ++c)
      if (c == whole) {
        RD_UNROLL
        for (int k = 0; k < 4; ++k) w[k] = g[c][k];
      }
    s = rd_part(step, s, w, rest);
  }
  return s;
"""
_RD_KERNEL_WALK = """  if (kByte)
    rd_thread(RdByteStep{s_table}, s_accept, start, first_sink, width, first,
              stride, (uint32_t)rows, span, valid, load, store);
  else
    rd_thread(RdClassStep{s_classes, s_table, n_classes}, s_accept, start,
              first_sink, width, first, stride, (uint32_t)rows, span, valid,
              load, store);
}
"""
_RD_SMEM = "static int rd_smem(int n_states, int n_classes) {\n  return 512 + "
# commit 3444cf9's tests: the length and the sink on every byte
_RD_BYTE_TESTS = """  RD_UNROLL
  for (int c = 0; c < kRdGroup; ++c) {
    RD_UNROLL
    for (int j = 0; j < 16; ++j)
      if (16 * c + j < n && s < first_sink)
        s = step(s, rd_byte(g[c][j >> 2], j & 3));
  }
  return s;
"""
# a block's rows staged in shared memory by cp.async (only the chunks
# below each length, 16 bytes a copy, rows 80 bytes apart so that a
# quarter-warp's 16-byte reads hit distinct banks), then walked from there;
# 64-byte rectangles only
_RD_STAGED = """  uint8_t* s_rows = smem + ((512 + (kByte ? n_states * kRdNextStride
                                          : n_states * n_classes) + 15) & ~15);
  const auto walk = [&](int n, uint32_t(&g)[kRdGroup][4]) {
    const auto from = [&](int i, uint32_t(&h)[kRdGroup][4]) {
      for (int c = 0; c < kRdGroup; ++c)
        if (16 * (kRdGroup * i + c) < n) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              s_rows + t * 80 + 16 * (kRdGroup * i + c));
          h[c][0] = v.x;
          h[c][1] = v.y;
          h[c][2] = v.z;
          h[c][3] = v.w;
        }
    };
    from(0, g);
    return kByte ? rd_walk(RdByteStep{s_table}, start, first_sink, n, width,
                           g, from)
                 : rd_walk(RdClassStep{s_classes, s_table, n_classes}, start,
                           first_sink, n, width, g, from);
  };
  for (uint32_t base = blockIdx.x * kRdBlock; base < (uint32_t)rows;
       base += gridDim.x * kRdBlock) {
    for (int k = 0; k < 4; ++k) {
      const uint32_t lr = (t >> 2) + 64 * k, r = base + lr;
      const int c = t & 3;
      if (r < (uint32_t)rows &&
          16 * c < rd_span(lengths[r], validity[r], width)) {
        const uint32_t dst = (uint32_t)__cvta_generic_to_shared(
            s_rows + lr * 80 + 16 * c);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                     "l"(bytes + (size_t)r * 64 + 16 * c));
      }
    }
    asm volatile("cp.async.commit_group;" ::);
    asm volatile("cp.async.wait_group 0;" ::);
    __syncthreads();
    const uint32_t r = base + t;
    if (r < (uint32_t)rows) {
      const int n = rd_span(lengths[r], validity[r], width);
      bool hit = false;
      if (n >= 0) {
        uint32_t g[kRdGroup][4] = {};
        hit = s_accept[walk(n, g)] != 0;
      }
      out[r] = hit;
    }
    __syncthreads();
  }
}
"""
# each warp's 32-row tiles staged in shared memory by cp.async, two
# stages (the next tile's copies in flight while a tile is walked), only
# the chunks below each length, rows 80 bytes apart; the lengths two
# tiles ahead; 64-byte rectangles only
_RD_STAGED_WARP = """  const int lane = t & 31;
  uint8_t* s_rows = smem + ((512 + (kByte ? n_states * kRdNextStride
                                          : n_states * n_classes) + 15) & ~15)
                    + (t >> 5) * 2 * 2560;
  const uint32_t warps = gridDim.x * (kRdBlock / 32);
  const uint32_t tiles = ((uint32_t)rows + 31) / 32;
  uint32_t tile = blockIdx.x * (kRdBlock / 32) + (t >> 5);
  const auto len_of = [&](uint32_t tl) {
    const uint32_t r = tl * 32 + lane;
    return r < (uint32_t)rows ? rd_span(lengths[r], validity[r], width) : -1;
  };
  const auto issue = [&](uint32_t tl, int n_lane, uint8_t* buf) {
    RD_UNROLL
    for (int j = 0; j < 4; ++j) {
      const int row = 8 * j + (lane >> 2), c = lane & 3;
      const int n = __shfl_sync(0xffffffffu, n_lane, row);
      if (16 * c < n) {
        const uint32_t dst =
            (uint32_t)__cvta_generic_to_shared(buf + row * 80 + 16 * c);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                     "l"(bytes + (size_t)(tl * 32 + row) * 64 + 16 * c));
      }
    }
    asm volatile("cp.async.commit_group;" ::);
  };
  const auto none = [](int, uint32_t(&)[kRdGroup][4]) {};
  int n0 = len_of(tile), n1 = len_of(tile + warps);
  issue(tile, n0, s_rows);
  for (int p = 0; tile < tiles; tile += warps, p ^= 1) {
    const int n2 = len_of(tile + 2 * warps);
    issue(tile + warps, n1, s_rows + (p ^ 1) * 2560);
    asm volatile("cp.async.wait_group 1;" ::);
    __syncwarp();
    const uint8_t* mine = s_rows + p * 2560 + lane * 80;
    bool hit = false;
    if (n0 >= 0) {
      uint32_t g[kRdGroup][4] = {};
      RD_UNROLL
      for (int c = 0; c < kRdGroup; ++c)
        if (16 * c < n0) {
          const uint4 v = *reinterpret_cast<const uint4*>(mine + 16 * c);
          g[c][0] = v.x;
          g[c][1] = v.y;
          g[c][2] = v.z;
          g[c][3] = v.w;
        }
      const int s = kByte ? rd_walk(RdByteStep{s_table}, start, first_sink,
                                    n0, width, g, none)
                          : rd_walk(RdClassStep{s_classes, s_table,
                                                n_classes},
                                    start, first_sink, n0, width, g, none);
      hit = s_accept[s] != 0;
    }
    const uint32_t r = tile * 32 + lane;
    if (r < (uint32_t)rows) out[r] = hit;
    __syncwarp();
    n0 = n1;
    n1 = n2;
  }
  asm volatile("cp.async.wait_group 0;" ::);
}
"""
# two rows a thread, walked in step (two independent chains), loaded
# together at the top of each pair; 64-byte rectangles only
_RD_TWO_ROWS = """  for (uint32_t r0 = first; r0 < (uint32_t)rows; r0 += 2 * stride) {
    const uint32_t r1 = r0 + stride;
    const int n0 = span(r0), n1 = span(r1);
    uint32_t g0[4][4] = {}, g1[4][4] = {};
    const uint4* q0 = reinterpret_cast<const uint4*>(bytes + (size_t)r0 * 64);
    const uint4* q1 = reinterpret_cast<const uint4*>(bytes + (size_t)r1 * 64);
    RD_UNROLL
    for (int c = 0; c < 4; ++c) {
      if (16 * c < n0) {
        const uint4 v = __ldcs(q0 + c);
        g0[c][0] = v.x, g0[c][1] = v.y, g0[c][2] = v.z, g0[c][3] = v.w;
      }
      if (16 * c < n1) {
        const uint4 v = __ldcs(q1 + c);
        g1[c][0] = v.x, g1[c][1] = v.y, g1[c][2] = v.z, g1[c][3] = v.w;
      }
    }
    const int w0 = n0 >= 64 ? 4 : n0 >> 4, w1 = n1 >= 64 ? 4 : n1 >> 4;
    int s0 = start, s1 = start;
    const auto step = [&](int s, uint32_t b) {
      return kByte ? RdByteStep{s_table}(s, b)
                   : RdClassStep{s_classes, s_table, n_classes}(s, b);
    };
    RD_UNROLL
    for (int c = 0; c < 4; ++c) {
      const bool a0 = c < w0 && s0 < first_sink;
      const bool a1 = c < w1 && s1 < first_sink;
      RD_UNROLL
      for (int j = 0; j < 16; ++j) {
        if (a0) s0 = step(s0, rd_byte(g0[c][j >> 2], j & 3));
        if (a1) s1 = step(s1, rd_byte(g1[c][j >> 2], j & 3));
      }
    }
    uint32_t p0[4], p1[4];
    RD_UNROLL
    for (int k = 0; k < 4; ++k) {
      p0[k] = g0[0][k];
      p1[k] = g1[0][k];
    }
    RD_UNROLL
    for (int c = 1; c < 4; ++c)
      RD_UNROLL
      for (int k = 0; k < 4; ++k) {
        if (c == w0) p0[k] = g0[c][k];
        if (c == w1) p1[k] = g1[c][k];
      }
    const int e0 = w0 < 4 && s0 < first_sink ? n0 - 16 * w0 : 0;
    const int e1 = w1 < 4 && s1 < first_sink ? n1 - 16 * w1 : 0;
    RD_UNROLL
    for (int j = 0; j < 15; ++j) {
      if (j < e0) s0 = step(s0, rd_byte(p0[j >> 2], j & 3));
      if (j < e1) s1 = step(s1, rd_byte(p1[j >> 2], j & 3));
    }
    store(r0, n0 >= 0 && s_accept[s0] != 0);
    if (r1 < (uint32_t)rows) store(r1, n1 >= 0 && s_accept[s1] != 0);
  }
}
"""
# at most 16 states: a 64-bit word a byte of its 16 next states as
# nibbles, so a byte's load does not wait on the state
_RD_NIBBLE = """  if (kByte) {
    uint64_t* s_nib = reinterpret_cast<uint64_t*>(
        smem + ((512 + n_states * kRdNextStride + 15) & ~15));
    uint64_t word = 0;
    for (int s = 0; s < n_states; ++s)
      word |= (uint64_t)s_table[s * kRdNextStride + t] << (4 * s);
    s_nib[t] = word;
    __syncthreads();
    const auto nib = [&](int s, uint32_t b) {
      return (int)((s_nib[b] >> (4 * s)) & 15u);
    };
    rd_thread(nib, s_accept, start, first_sink, width, first, stride,
              (uint32_t)rows, span, valid, load, store);
  } else
    rd_thread(RdClassStep{s_classes, s_table, n_classes}, s_accept, start,
              first_sink, width, first, stride, (uint32_t)rows, span, valid,
              load, store);
}
"""
RD_VARIANTS = {
    "class_table": ([("H:constexpr int kRdByteStates = ",
                      "constexpr int kRdByteStates = 0 * ")], "class"),
    "byte_tests": ([("H:" + _RD_GROUP_BODY, _RD_BYTE_TESTS)], None),
    "no_ahead": ([("H:    load(next, len_next, 0, ahead);\n", ""),
                  ("H:      const int n = len;\n",
                   "      const int n = len;\n      load(r, n, 0, g);\n")],
                 None),
    "staged": ([(_RD_SMEM, _RD_SMEM + "20480 + 16 + "),
                ("  const auto span = [&](uint32_t r) {",
                 "              load, store);\n}\n", _RD_STAGED)], None),
    "rows_2": ([("K:" + _RD_KERNEL_WALK, _RD_TWO_ROWS)], None),
    "nibble": ([(_RD_SMEM, _RD_SMEM + "2048 + 16 + "),
                ("K:" + _RD_KERNEL_WALK, _RD_NIBBLE)], None),
    "bounds_5": ([("__global__ void __launch_bounds__(kRdBlock)\n",
                   "__global__ void __launch_bounds__(kRdBlock, 5)\n")],
                 None),
    # a group of two chunks: the next row's first 32 bytes ahead, its
    # second sector read when its walk gets there
    "group_2": ([("H:constexpr int kRdGroup = 4;",
                  "constexpr int kRdGroup = 2;")], None),
    # three chunks (48 bytes: an l_comment row whole) ahead, fewer
    # registers; and with registers bounded for 5 blocks an SM
    "group_3": ([("H:constexpr int kRdGroup = 4;",
                  "constexpr int kRdGroup = 3;")], None),
    "group_3_bounds_5": ([("H:constexpr int kRdGroup = 4;",
                           "constexpr int kRdGroup = 3;"),
                          ("__global__ void __launch_bounds__(kRdBlock)\n",
                           "__global__ void __launch_bounds__(kRdBlock, 5)\n")],
                         None),
    "staged_warp": ([(_RD_SMEM, _RD_SMEM + "40960 + 16 + "),
                     ("  const auto span = [&](uint32_t r) {",
                      "              load, store);\n}\n", _RD_STAGED_WARP)],
                    None),
    # the rows' loads cached in L1 and L2 as by default, or in L2 only
    "cached": ([("      const uint4 v = __ldcs(q + c);",
                 "      const uint4 v = q[c];")], None),
    "l2_only": ([("      const uint4 v = __ldcs(q + c);",
                  "      const uint4 v = __ldcg(q + c);")], None),
    # the rows' loads with L2 prefetch hints of 128 or 256 bytes
    "l2_128": ([("      const uint4 v = __ldcs(q + c);",
                 "      uint4 v;\n      asm(\"ld.global.cs.L2::128B.v4.u32 "
                 "{%0, %1, %2, %3}, [%4];\" : \"=r\"(v.x), \"=r\"(v.y), "
                 "\"=r\"(v.z), \"=r\"(v.w) : \"l\"(q + c));")], None),
    "l2_256": ([("      const uint4 v = __ldcs(q + c);",
                 "      uint4 v;\n      asm(\"ld.global.cs.L2::256B.v4.u32 "
                 "{%0, %1, %2, %3}, [%4];\" : \"=r\"(v.x), \"=r\"(v.y), "
                 "\"=r\"(v.z), \"=r\"(v.w) : \"l\"(q + c));")], None),
    # the loads alone: each group folded into a 0/1 state, no walk
    "loads_only": ([("H:" + _RD_GROUP_BODY,
                     "  return (s + (int)(g[0][0] ^ g[kRdGroup - 1][3])) & "
                     "1;\n")], None),
}
#: variants whose answers are not the kernel's (timed unchecked)
RD_INEXACT = {"loads_only"}
#: the patterns the variants are timed on: TPC-H Q13's and an anchored
#: RLIKE whose rows mostly reach the dead sink at their first space
RD_TIMED = (("like", "%special%requests%"),
            ("rlike", "^[a-z]+ (pending|final) "))


def _build_rd_variants(old_dir=None):
    """Start one nvcc a variant of the port's rect_dfa (and, with
    ``old_dir``, that directory's rect_dfa.cu and header, such as commit
    3444cf9's kernel); {name: (process, library, form)}."""
    from spark_rapids_tpu_torch import native
    src = (native.CSRC / "rect_dfa.cu").read_text()
    hdr = (native.CSRC / "rect_dfa_row.cuh").read_text()
    started = {}
    builds = dict(RD_VARIANTS)
    if old_dir:
        builds["old"] = ("dir", "class")
    for name, (subs, form) in builds.items():
        if subs == "dir":
            d = Path(old_dir)
        else:
            s, h = src, hdr
            for old, *new in subs:
                if len(new) == 2:       # the kernel's text from old to end
                    end, new = new
                    i = s.find(old)
                    j = s.find(end, i)
                    cs._check(i >= 0 and j >= 0, f"{name}: no {old!r} .. "
                                                 f"{end!r} in the kernel")
                    s = s[:i] + new + s[j + len(end):]
                    continue
                new = new[0]
                if old.startswith("H:"):
                    cs._check(old[2:] in h, f"{name}: no {old[2:]!r} in the "
                                            "header")
                    h = h.replace(old[2:], new)
                else:
                    old = old[2:] if old.startswith("K:") else old
                    cs._check(old in s, f"{name}: no {old!r} in the kernel")
                    s = s.replace(old, new)
            d = native.BUILD_DIR / "variants" / f"rect_dfa_{name}"
            d.mkdir(parents=True, exist_ok=True)
            (d / "rect_dfa.cu").write_text(s)
            (d / "rect_dfa_row.cuh").write_text(h)
        lib = native.BUILD_DIR / "variants" / f"librect_dfa_{name}.so"
        lib.parent.mkdir(parents=True, exist_ok=True)
        started[name] = (subprocess.Popen(
            [native._nvcc(), *native.NVCC_FLAGS, "-I", str(d),
             "-o", str(lib), str(d / "rect_dfa.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib,
            form)
    return started


def rect_dfa_section(builds) -> None:
    """rect_dfa beside its variants (RD_VARIANTS) on an SF1 l_comment
    batch (1,048,576 x 64), cold, in turns (kernel, variants, variants in
    reverse, kernel), on RD_TIMED; each variant is checked bit for bit
    against the kernel first."""
    import torch
    from spark_rapids_tpu_torch.exec import rect_dfa as RDK
    fns = {}
    for name, (proc, path, form) in builds.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            print(f"nvcc failed for rect_dfa {name}: not timed\n{log}",
                  flush=True)
            continue
        frames = cs._ptxas_frames(log)
        regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers",
                                                   log)})
        if any(f[1:] != (0, 0, 0) for f in frames):
            print(f"ptxas rect_dfa {name}: a stack frame or spills "
                  f"{sorted({f[1:] for f in frames})}, registers {regs}: "
                  "not timed", flush=True)
            continue
        print(f"ptxas rect_dfa {name}: registers {regs}", flush=True)
        fns[name] = cs._rect_dfa_compare(name, ctypes.CDLL(str(path)), form)
    rows = 1 << 20
    text = cs.gen_comment(rows)
    rect = torch.from_numpy(text.view(np.uint8).reshape(rows, -1).copy())
    lens = torch.from_numpy(np.char.str_len(text).astype(np.int32))
    b, ln, v = rect.cuda(), lens.cuda(), torch.ones(rows, dtype=torch.bool,
                                                    device="cuda")
    n = max(2, -(-cs.COLD_BYTES // (b.nbytes + ln.nbytes + v.nbytes)))
    inputs = [(b, ln, v)] + [(b.clone(), ln.clone(), v.clone())
                             for _ in range(n - 1)]
    for kind, pat in RD_TIMED:
        dfa = cs._dfa_compile(kind, pat)
        want = RDK.rect_dfa(b, ln, v, dfa)
        ok = {}
        for name, f in fns.items():
            got = f(b, ln, v, dfa)
            torch.cuda.synchronize()
            ok[name] = name in RD_INEXACT or torch.equal(got, want)
            if not ok[name]:
                print(f"rect_dfa {pat!r}: variant {name} differs from the "
                      f"kernel in {int((got != want).sum())} rows: not "
                      "timed", flush=True)
        order = [("kernel", lambda b, ln, v: RDK.rect_dfa(b, ln, v, dfa))] + [
            (name, lambda b, ln, v, f=f: f(b, ln, v, dfa))
            for name, f in fns.items() if ok[name]]
        turns = {name: [] for name, _ in order}
        for name, f in order + order[::-1]:
            turns[name].append(cs._cold_ms(f, inputs, f"{pat} {name}")[0])
        bd = cs.dfa_bound(cs.dfa_walked(b, ln, v, dfa))
        print(f"rect_dfa variants, {kind} {pat!r} ({rows} x 64 l_comment, "
              f"{dfa.n_states} states, bound {bd['ms']:.4f} ms), device ms "
              "a call, cold: " + ", ".join(
                  f"{name} {np.mean(t):.4f} ({t[0]:.4f}/{t[1]:.4f}, "
                  f"{bd['ms'] / np.mean(t):.0%} of bound)"
                  for name, t in turns.items()), flush=True)
    del inputs


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_variants.py runs on the card",
              file=sys.stderr)
        return 2
    args = sys.argv[1:] or ["dense_groupby", "join_match",
                            "distinct_flag", "decimal_arith", "rect_dfa"]
    sections = [a.split("=", 1)[0] for a in args]
    rd_old = next((a.split("=", 1)[1] for a in args
                   if a.startswith("rect_dfa=")), None)
    cs._check(set(sections) <= {"dense_groupby", "join_match",
                                "distinct_flag", "decimal_arith",
                                "rect_dfa"},
              f"unknown sections {sections}")
    from spark_rapids_tpu_torch.exec import dense_groupby as dg
    cs.phase_device()
    started = _build_variants() if "dense_groupby" in sections else {}
    old_join = _build_join_843e714() if "join_match" in sections else None
    join_variants = _build_join_variants() if old_join else {}
    df_builds = _build_df_04f2565() if "distinct_flag" in sections else {}
    df_new = _build_df_variants() if df_builds else {}
    da_builds = _build_da_variants() if "decimal_arith" in sections else {}
    rd_builds = (_build_rd_variants(rd_old) if "rect_dfa" in sections
                 else {})
    cs.phase_build()
    if "dense_groupby" in sections:
        for name, (proc, _) in started.items():
            log, _ = proc.communicate(timeout=600)
            cs._check(proc.returncode == 0, f"nvcc failed for {name}:\n{log}")
        rng = np.random.RandomState(1)
        shapes = {"q1's batch shape": cs._dense_case(rng, 1 << 20, (3, 2), 5,
                                                     16, floats=True),
                  "the G = 64 shape": cs._g64_args(np.random.RandomState(64),
                                                   1 << 20)}
        for label, args in shapes.items():
            cs._dense_check(args, label)
            n = max(2, -(-cs.COLD_BYTES // cs.dense_bound(args)["bytes"]))
            inputs = [args] + [cs._clone_args(args) for _ in range(n - 1)]
            ms = {}
            for name in ["kernel", *VARIANTS, "kernel again"]:
                _use(None if name.startswith("kernel") else started[name][1])
                ms[name] = cs._cold_ms(dg.dense_groupby, inputs,
                                       f"{label} {name}")[0]
            _use(None)
            print(f"dense_groupby variants on {label}, device ms a call, "
                  "cold: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()),
                  flush=True)
    if old_join is not None:
        join_section(old_join, join_variants)
    if df_builds:
        distinct_section(df_builds, df_new)
    if da_builds:
        decimal_section(da_builds)
    if rd_builds:
        rect_dfa_section(rd_builds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
