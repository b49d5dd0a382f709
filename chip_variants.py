#!/usr/bin/env python3
"""Where the dense_groupby kernel's time goes, and join_match against
the two-kernel design of commit 843e714, on one NVIDIA card.

    python3 chip_variants.py [dense_groupby] [join_match]

(both sections when none is named)

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
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

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
    sections = sys.argv[1:] or ["dense_groupby", "join_match"]
    cs._check(set(sections) <= {"dense_groupby", "join_match"},
              f"unknown sections {sections}")
    from spark_rapids_tpu_torch.exec import dense_groupby as dg
    cs.phase_device()
    started = _build_variants() if "dense_groupby" in sections else {}
    old_join = _build_join_843e714() if "join_match" in sections else None
    join_variants = _build_join_variants() if old_join else {}
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
