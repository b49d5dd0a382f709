// Literal pattern match over a byte-rectangle string column, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel spark_rapids_tpu/exprs/pallas_rect.py
// _match_kernel (pl.pallas_call at :120), which compiles one program per
// (pattern, mode, width, rows) and unrolls every pattern offset. Here the
// pattern and its length are runtime arguments; the width and the mode
// pick one of the instances built once.
//
// Bound: memory, counted from the data. A row is needed only over its
// window (rect_row_window in rect_match_row.cuh): up to its length for
// contains and locate (up to the first match), the pattern's L bytes at 0
// or at len - L for the one-offset modes, nothing where the lengths alone
// decide; plus 4P bytes of lengths and P bytes of output (4P for locate).
// chip_smoke.py computes that bound per call, in 32-byte sectors, and
// times the kernel with the L2 cold, as q_comment finds each batch.
//
// Design:
// - A block of 256 threads owns a tile of consecutive rows at a time
//   (16 KiB of bytes: 256 rows up to W = 64, 16 at W = 1024) and walks the
//   tiles in a persistent grid of a few blocks per SM.
// - Lengths come first, coalesced: each thread holds its own row's length
//   for the next few tiles in registers (kLenRing), so that no wait for
//   data waits for lengths too. Then the lanes of each warp copy
//   consecutive 16-byte chunks of the tile into shared memory with
//   cp.async (8-byte at W = 8); a chunk outside its row's window is never
//   requested (rect_row_chunks).
// - A ring of stages_of(W) stages keeps one or two tiles in flight while
//   the block scans the oldest from shared memory. A row is scanned by one
//   thread up to W = 64 and by W / 64 threads above (rect_row_threads),
//   16 bytes a step, the next step's bytes read while this one is tested:
//   SWAR arithmetic tests the pattern's first two bytes at all sixteen
//   offsets at once, and the whole pattern is compared only at those
//   candidates (rect_find). Nothing lives in local memory.
// - Rows are padded by 16 bytes from W = 32 (rect_row_stride), so that a
//   warp's 16-byte reads of its rows are free of bank conflicts.
// - Every power-of-two width from 8 to 1024 at a 16-byte aligned base is
//   an instance per mode. Any other width, or a base that is not 16-byte
//   aligned, takes the raw layout: the same loop over the aligned 16-byte
//   chunks of device memory that hold the tile, rows read through a
//   funnel shift.
//
// Measured on an H100 (PERF.md, chip_smoke.py): on an l_comment batch the
// kernel runs at about 45% of that bound (the card fetches 64 bytes for a
// 32-byte sector, and against whole rows it is at about two thirds), and
// nearly as fast cold as with its input in L2, so the SM's instructions,
// not DRAM, set its pace.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "rect_match_row.cuh"

namespace {

// Stages of the ring: two at W = 64 (five blocks an SM fit, against three
// with three stages), three elsewhere: each the faster of the two on the
// H100 at that width (chip_smoke.py --compare; PERF.md).
__host__ __device__ constexpr int stages_of(int W) {
  return W == 64 ? 2 : 3;
}
// Each thread holds its row's length for the next kLenRing tiles in
// registers, loaded that far ahead (more than the stages), so that no wait
// for data waits for lengths as well.
constexpr int kLenRing = 4;
// The raw layout's chunks span rows, so it also keeps the lengths of the
// tiles being issued in shared memory: slots from the one issued now to
// the one stored now.
__host__ __device__ constexpr int len_slots_of(int W) {
  return W == 0 ? stages_of(W) + 1 : 0;
}

// The pattern, passed by value; a pattern wider than the row is never read,
// so kMaxPattern only has to cover the widest rectangle used.
constexpr int kMaxPattern = 1024;
struct alignas(16) Pattern {
  uint8_t b[kMaxPattern];
};
// its words in shared memory, with a zero word after the last
constexpr int kPatternBytes = kMaxPattern + 16;

constexpr int kThreads = 256;

template <int W>
__host__ __device__ int stage_bytes(int width) {
  const int rows = W == 0 ? rect_raw_rows(width) : rect_tile_rows(W);
  const int image = W == 0 ? (15 + rows * width + 15) / 16 * 16
                           : rows * rect_row_stride(W);
  return image + kRectStageSlack;
}

template <int W>
size_t smem_bytes(int width) {
  return kPatternBytes + len_slots_of(W) * kThreads * 4 +
         static_cast<size_t>(stages_of(W)) * stage_bytes<W>(width);
}

template <int CB>
__device__ inline void cp_async_chunk(uint8_t* dst, const uint8_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (CB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(d), "l"(src) : "memory");
  }
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// W in {8, 16, ..., 1024}: the padded layout at a 16-byte aligned base;
// W == 0: the raw layout, `width` any value up to kRectMaxWidth. M is the
// mode (RectMatchMode), so that each instance tests only its own window:
// with the mode a runtime argument (9 instances in place of 45) the H100
// took 3% longer on the main path, up to 25% at W = 8 and 35% for equals
// (PERF.md).
template <int W, int M>
__global__ void __launch_bounds__(kThreads)
rect_match_tiles(const uint8_t* __restrict__ bytes,
                 const int32_t* __restrict__ lengths, int64_t rows, int width,
                 const __grid_constant__ Pattern pat, int L,
                 uint8_t* __restrict__ out_bool,
                 int32_t* __restrict__ out_pos) {
  constexpr int mode = M;
  constexpr int kStages = stages_of(W);
  constexpr int kLenSlots = len_slots_of(W);
  constexpr int Q = W == 0 ? 1 : rect_row_threads(W);  // threads a row
  constexpr int kAlign = W == 0 ? 1 : (W == 8 ? 8 : 16);
  constexpr int kWords = W == 8 ? 2 : 4;  // words a scan step
  const int w = W == 0 ? width : W;
  const int T = W == 0 ? rect_raw_rows(width) : kThreads / Q;
  const int sbytes = stage_bytes<W>(width);
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* pw = reinterpret_cast<uint32_t*>(smem);
  int32_t* lens = reinterpret_cast<int32_t*>(smem + kPatternBytes);
  uint8_t* stages = smem + kPatternBytes + kLenSlots * kThreads * 4;

  const uint32_t* pat_w = reinterpret_cast<const uint32_t*>(pat.b);
  const int n_words = L <= width ? (L + 3) / 4 + 1 : 1;
  for (int i = tid; i < n_words; i += kThreads) {
    pw[i] = i < kMaxPattern / 4 ? pat_w[i] : 0u;
  }

  const int64_t tiles = (rows + T - 1) / T;
  uint32_t head = 0;  // the pattern's first four bytes, read after the sync
  auto tile_of = [&](int k) -> int64_t {
    return blockIdx.x + static_cast<int64_t>(k) * gridDim.x;
  };
  // the length of this thread's row in a tile (row tid / Q); 0 past the
  // rows, which needs no byte and is never stored
  auto row_len = [&](int64_t tile) -> int32_t {
    const int64_t g = tile * T + tid / Q;
    return tid / Q < T && tile < tiles && g < rows ? __ldg(lengths + g) : 0;
  };
  auto tile_rows = [&](int64_t tile) -> int {
    const int64_t left = rows - tile * T;
    return left < T ? static_cast<int>(left) : T;
  };
  // tile's data into stage; len is this thread's row length in the tile,
  // tl the tile's lengths in shared memory (raw layout only)
  auto issue = [&](int64_t tile, uint8_t* stage, int32_t len,
                   const int32_t* tl) {
    if (tile >= tiles) return;
    const uint8_t* src0 = bytes + tile * T * w;
    const int n = tile_rows(tile);
    if constexpr (W != 0) {
      // The first of a row's Q threads finds the row's chunks; then G lanes
      // a row, on consecutive chunks, take the warp's 32 / Q rows RP at a
      // time.
      constexpr int CB = rect_chunk_bytes(W);
      constexpr int G = W / CB < 32 ? W / CB : 32;
      constexpr int RP = 32 / G;
      int c0 = 0, c1 = 0;
      if (tid / Q < n) rect_row_chunks(len, W, L, mode, CB, &c0, &c1);
      const int lane = tid & 31;
#pragma unroll
      for (int p = 0; p < G / Q; ++p) {
        const int rl = p * RP + lane / G;
        const int a = __shfl_sync(0xFFFFFFFFu, c0, rl * Q);
        const int b = __shfl_sync(0xFFFFFFFFu, c1, rl * Q);
        const int r = (tid & ~31) / Q + rl;
        // one pass of G lanes covers a row of up to G chunks
        for (int c = a + lane % G; c < b; c += G) {
          cp_async_chunk<CB>(stage + r * rect_row_stride(W) + c * CB,
                             src0 + r * W + c * CB);
          if constexpr (W / CB <= G) break;
        }
      }
    } else {
      const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src0) & 15);
      const int n_chunks = (mis + n * w + 15) / 16;
      int src, dst;
      for (int i = tid; i < n_chunks; i += kThreads) {
        if (rect_raw_chunk(i, w, n, mis, tl, L, mode, &src, &dst)) {
          cp_async_chunk<16>(stage + dst, src0 + src);
        }
      }
    }
  };
  auto scan = [&](int64_t tile, const uint8_t* stage, int32_t len) {
    const int r = tid / Q;
    const int64_t g = tile * T + r;
    const bool live = r < T && g < rows;
    int32_t v = 0;
    if (live) {
      int off = r * rect_row_stride(w);
      if constexpr (W == 0) {
        off = static_cast<int>(
                  reinterpret_cast<uintptr_t>(bytes + tile * T * w) & 15) +
              r * w;
      }
      v = rect_match_loaded<kAlign, kWords>(
          reinterpret_cast<const uint32_t*>(stage), off, w, len, pw, head, L,
          mode, tid % Q, Q);
    }
#pragma unroll
    for (int d = Q / 2; d > 0; d /= 2) {
      v = rect_merge_rows(v, __shfl_xor_sync(0xFFFFFFFFu, v, d));
    }
    if (!live || tid % Q != 0) return;
    if constexpr (M == RECT_LOCATE) {
      out_pos[g] = v;
    } else {
      out_bool[g] = static_cast<uint8_t>(v);
    }
  };

  // the lengths of the first kLenRing tiles in flight; the first
  // kStages - 1 tiles of data in flight
  int32_t ring[kLenRing];
#pragma unroll
  for (int u = 0; u < kLenRing; ++u) ring[u] = row_len(tile_of(u));
  if constexpr (W == 0) {
#pragma unroll
    for (int j = 0; j < kStages; ++j) lens[j * kThreads + tid] = ring[j];
  }
  __syncthreads();
  head = pw[0];
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    issue(tile_of(j), stages + j * sbytes, ring[j], lens + j * kThreads);
    cp_async_commit();
  }
  for (int k0 = 0; tile_of(k0) < tiles; k0 += kLenRing) {
#pragma unroll
    for (int u = 0; u < kLenRing; ++u) {
      const int k = k0 + u;
      if (tile_of(k) >= tiles) break;
      cp_async_wait<kStages - 2>();  // tile k has landed (this thread's
      __syncthreads();               // part, then every thread's)
      const int ahead = (u + kStages - 1) % kLenRing;  // folded: unrolled
      const int32_t* tl = nullptr;
      if constexpr (W == 0) {
        // tile k + kStages into the slot of tile k - 1, read by the issue
        // of the next iteration, after its barrier
        lens[((k + kStages) % kLenSlots) * kThreads + tid] =
            ring[(u + kStages) % kLenRing];
        tl = lens + ((k + kStages - 1) % kLenSlots) * kThreads;
      }
      issue(tile_of(k + kStages - 1),
            stages + ((k + kStages - 1) % kStages) * sbytes, ring[ahead],
            tl);
      cp_async_commit();
      scan(tile_of(k), stages + (k % kStages) * sbytes, ring[u]);
      ring[u] = row_len(tile_of(k + kLenRing));
    }
  }
  cp_async_wait<0>();
}

int device_sms() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0) {
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return sms[dev];
}

template <int W, int M>
int launch(const uint8_t* b, const int32_t* len, int64_t rows, int width,
           const Pattern& pat, int L, void* out, cudaStream_t s) {
  auto kernel = rect_match_tiles<W, M>;
  const size_t smem = smem_bytes<W>(width);
  // blocks per SM, set up once per instance (per launch for the raw
  // layout, whose shared memory follows the width)
  static int occupancy = 0;
  int occ = occupancy;
  if (W == 0 || occ == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                      kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (occ <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (W != 0) occupancy = occ;
  }
  const int64_t T = W == 0 ? rect_raw_rows(width) : rect_tile_rows(W);
  const int64_t tiles = (rows + T - 1) / T;
  const int64_t slots = static_cast<int64_t>(occ) * device_sms();
  const int blocks = static_cast<int>(tiles < slots ? tiles : slots);
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<blocks, kThreads, smem, s>>>(
      b, len, rows, width, pat, L,
      M == RECT_LOCATE ? nullptr : static_cast<uint8_t*>(out),
      M == RECT_LOCATE ? static_cast<int32_t*>(out) : nullptr);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_mode(const uint8_t* b, const int32_t* len, int64_t rows,
                int width, const Pattern& pat, int L, int mode, void* out,
                cudaStream_t s) {
  switch (mode) {
    case RECT_CONTAINS:
      return launch<W, RECT_CONTAINS>(b, len, rows, width, pat, L, out, s);
    case RECT_STARTSWITH:
      return launch<W, RECT_STARTSWITH>(b, len, rows, width, pat, L, out, s);
    case RECT_ENDSWITH:
      return launch<W, RECT_ENDSWITH>(b, len, rows, width, pat, L, out, s);
    case RECT_EQUALS:
      return launch<W, RECT_EQUALS>(b, len, rows, width, pat, L, out, s);
    case RECT_LOCATE:
      return launch<W, RECT_LOCATE>(b, len, rows, width, pat, L, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// bytes uint8[rows, width] and lengths int32[rows] on the device; pattern
// holds pattern_len bytes in host memory (may be null when pattern_len is
// 0), copied into the launch's parameters; out is bool[rows], or
// int32[rows] for locate. Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a pattern that fits the
// row but not kMaxPattern, or a width past kRectMaxWidth.
extern "C" int rect_match_launch(const void* bytes, const void* lengths,
                                 int64_t rows, int width, const void* pattern,
                                 int pattern_len, int mode, void* out,
                                 void* stream) {
  if (rows <= 0) return 0;
  if (width <= 0 || width > kRectMaxWidth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the pattern is read only when it fits the row
  const int n_pat = pattern_len <= width ? pattern_len : 0;
  if (n_pat > kMaxPattern) return static_cast<int>(cudaErrorInvalidValue);
  Pattern pat;
  memset(&pat, 0, sizeof(pat));
  if (n_pat > 0) memcpy(pat.b, pattern, n_pat);
  auto b = static_cast<const uint8_t*>(bytes);
  auto len = static_cast<const int32_t*>(lengths);
  auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(b) % 16) == 0;
  switch (aligned ? width : 0) {
#define RECT_CASE(WIDTH)                                                  \
  case WIDTH:                                                             \
    return launch_mode<WIDTH>(b, len, rows, width, pat, pattern_len, mode, \
                              out, s);
    RECT_CASE(8)
    RECT_CASE(16)
    RECT_CASE(32)
    RECT_CASE(64)
    RECT_CASE(128)
    RECT_CASE(256)
    RECT_CASE(512)
    RECT_CASE(1024)
#undef RECT_CASE
    default:
      return launch_mode<0>(b, len, rows, width, pat, pattern_len, mode, out,
                            s);
  }
}
