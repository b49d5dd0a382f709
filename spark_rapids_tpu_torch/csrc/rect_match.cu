// Literal pattern match over a byte-rectangle string column, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel spark_rapids_tpu/exprs/pallas_rect.py
// _match_kernel (pl.pallas_call at :120), which compiles one program per
// (pattern, mode, width, rows) and unrolls every pattern offset. Here the
// pattern, its length, the width and the mode are runtime arguments, so
// one build serves every query.
//
// Bound: the kernel reads each row's bytes only as far as its scan goes
// (its length, or the end of the first match), in 32-byte sectors, plus
// 4P bytes of lengths, and writes P bytes (4P for locate). P*W + 4P is an
// upper count: the bytes past a row's length are zero and decide nothing.
// It does at most (W-L+1)*L byte compares a row, usually about one a
// scanned offset, so it is memory bound. chip_smoke.py computes the bound
// from the data it runs on and PERF.md records it beside the kernel's time.
// Design: one thread per row over a grid-stride loop; the row comes in with
// 16-byte vector loads (8-byte for W = 8) into a per-thread buffer, the
// pattern is a kernel parameter, and the scan stops at the row's length
// and at the first match. The ragged tail needs no padding: the loop bound
// masks it. Other widths, or a misaligned base, read the row in place.
// ptxas gives the buffer a W-byte stack frame: it lives in local memory
// (L1), not registers, because the scan indexes it at runtime. Keeping it
// in registers, and coalescing the loads across a warp, is the next step
// toward the bound.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "rect_match_row.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;

// The pattern, passed by value; a pattern wider than the row is never read,
// so kMaxPattern only has to cover the widest rectangle used.
constexpr int kMaxPattern = 1024;
struct Pattern {
  uint8_t b[kMaxPattern];
};

template <int W>
__device__ inline void load_row(const uint8_t* __restrict__ src,
                                uint8_t* dst) {
  if constexpr (W == 8) {
    *reinterpret_cast<uint2*>(dst) = __ldg(reinterpret_cast<const uint2*>(src));
  } else {
#pragma unroll
    for (int k = 0; k < W / 16; ++k) {
      reinterpret_cast<uint4*>(dst)[k] =
          __ldg(reinterpret_cast<const uint4*>(src) + k);
    }
  }
}

__device__ inline void store(int64_t r, int32_t v, uint8_t* out_bool,
                             int32_t* out_pos) {
  if (out_pos != nullptr) {
    out_pos[r] = v;
  } else {
    out_bool[r] = static_cast<uint8_t>(v);
  }
}

// Rows of a compile-time width W in {8, 16, 32, 64}, 16-byte aligned.
template <int W>
__global__ void rect_match_fixed(const uint8_t* __restrict__ bytes,
                                 const int32_t* __restrict__ lengths,
                                 int64_t rows,
                                 const __grid_constant__ Pattern pat, int L,
                                 int mode, uint8_t* __restrict__ out_bool,
                                 int32_t* __restrict__ out_pos) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < rows; r += stride) {
    alignas(16) uint8_t row[W];
    load_row<W>(bytes + r * W, row);
    store(r, rect_match_row(row, W, lengths[r], pat.b, L, mode), out_bool,
          out_pos);
  }
}

// Any width: the row is read in place.
__global__ void rect_match_any(const uint8_t* __restrict__ bytes,
                               const int32_t* __restrict__ lengths,
                               int64_t rows, int width,
                               const __grid_constant__ Pattern pat, int L,
                               int mode, uint8_t* __restrict__ out_bool,
                               int32_t* __restrict__ out_pos) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < rows; r += stride) {
    store(r,
          rect_match_row(bytes + r * width, width, lengths[r], pat.b, L,
                         mode),
          out_bool, out_pos);
  }
}

}  // namespace

// bytes uint8[rows, width] and lengths int32[rows] on the device; pattern
// holds pattern_len bytes in host memory (may be null when pattern_len is
// 0), copied into the launch's parameters; out is bool[rows], or
// int32[rows] for locate. Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a pattern that fits the
// row but not kMaxPattern.
extern "C" int rect_match_launch(const void* bytes, const void* lengths,
                                 int64_t rows, int width, const void* pattern,
                                 int pattern_len, int mode, void* out,
                                 void* stream) {
  if (rows <= 0) return 0;
  // the pattern is read only when it fits the row
  const int n_pat = pattern_len <= width ? pattern_len : 0;
  if (n_pat > kMaxPattern) return static_cast<int>(cudaErrorInvalidValue);
  Pattern pat;
  memset(&pat, 0, sizeof(pat));
  if (n_pat > 0) memcpy(pat.b, pattern, n_pat);
  const int64_t want = (rows + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  auto b = static_cast<const uint8_t*>(bytes);
  auto len = static_cast<const int32_t*>(lengths);
  uint8_t* out_bool = mode == RECT_LOCATE ? nullptr : static_cast<uint8_t*>(out);
  int32_t* out_pos = mode == RECT_LOCATE ? static_cast<int32_t*>(out) : nullptr;
  auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(b) % 16) == 0;
  switch (aligned ? width : 0) {
    case 8:
      rect_match_fixed<8><<<blocks, kThreads, 0, s>>>(
          b, len, rows, pat, pattern_len, mode, out_bool, out_pos);
      break;
    case 16:
      rect_match_fixed<16><<<blocks, kThreads, 0, s>>>(
          b, len, rows, pat, pattern_len, mode, out_bool, out_pos);
      break;
    case 32:
      rect_match_fixed<32><<<blocks, kThreads, 0, s>>>(
          b, len, rows, pat, pattern_len, mode, out_bool, out_pos);
      break;
    case 64:
      rect_match_fixed<64><<<blocks, kThreads, 0, s>>>(
          b, len, rows, pat, pattern_len, mode, out_bool, out_pos);
      break;
    default:
      rect_match_any<<<blocks, kThreads, 0, s>>>(
          b, len, rows, width, pat, pattern_len, mode, out_bool, out_pos);
  }
  return static_cast<int>(cudaGetLastError());
}
