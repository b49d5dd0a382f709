// The arithmetic of the dense groupby kernel (dense_groupby.cu), as
// __host__ __device__ functions, so that g++ compiles and tests it on a
// machine with no CUDA toolkit (tests/test_torch_groupby.py runs the
// kernel's block loop on the host through these functions).
//
// A row's group id packs up to kDgMaxKeys dictionary keys:
//   gid = sum_i (valid_i ? remap_i[code_i] : card_i) * stride_i
// where remap_i maps the batch dictionary's codes to the exec's global
// codes in [0, card_i), card_i is the null slot, and stride_i is the
// product of (card_j + 1) over the keys after i. A dead row (outside the
// keep mask) gets the id G and drops out.
//
// Sums are deterministic: every thread adds its own rows, in row order,
// into its own slots, and slots are combined in one fixed order: a lane
// of a warp folds every 32nd slot in turn (dg_fold), then the warp adds
// halves, lane l taking lane l + 16, 8, 4, 2, 1 (dg_warp_tree on the card,
// dg_tree_host here). Only additions: no multiply to fuse, no atomics.
#pragma once

#include <stdint.h>
#include <string.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define DG_INLINE inline
#else
#define DG_INLINE __forceinline__
#endif

constexpr int kDgMaxKeys = 4;
constexpr int kDgMaxCols = 16;
// rows a block owns: 8 a thread at G = 16 (256 threads), 16 at G = 64
// (128 threads)
constexpr int kDgRowsPerBlock = 2048;
constexpr int kDgLanes = 32;

// The dictionary keys of one launch (pointers into device memory).
struct DgKeys {
  const int32_t* codes[kDgMaxKeys];   // batch-dictionary codes [rows]
  const uint8_t* valid[kDgMaxKeys];   // key validity [rows]
  const int32_t* remap[kDgMaxKeys];   // batch code -> global code
  int32_t remap_len[kDgMaxKeys];
  int32_t card[kDgMaxKeys];           // global cardinality = null slot
  int32_t stride[kDgMaxKeys];
  int32_t nkeys;
};

// Strides of the packed id from the cardinalities (the last key's is 1);
// returns the number of ids, prod(card_i + 1).
__host__ __device__ inline int64_t dg_strides(DgKeys* k) {
  int64_t s = 1;
  for (int i = k->nkeys - 1; i >= 0; --i) {
    k->stride[i] = static_cast<int32_t>(s);
    s *= static_cast<int64_t>(k->card[i]) + 1;
  }
  return s;
}

// Group id of row r, G when the row is dead. A code outside the remap is
// clamped into it; an id outside [0, G) (a remap value past its card)
// drops the row rather than write past the slots.
// The loop over keys unrolls fully, so that on the card every field of
// the keys (a kernel parameter) is read at a constant offset.
__host__ __device__ DG_INLINE int dg_group_id(const DgKeys& k,
                                              const uint8_t* keep, int64_t r,
                                              int G) {
  if (!keep[r]) return G;
  int64_t gid = 0;
#pragma unroll
  for (int i = 0; i < kDgMaxKeys; ++i) {
    if (i < k.nkeys) {
      int32_t c = k.card[i];
      if (k.valid[i][r] && k.remap_len[i] > 0) {
        int32_t code = k.codes[i][r];
        code = code < 0 ? 0 : (code >= k.remap_len[i] ? k.remap_len[i] - 1
                                                       : code);
        c = k.remap[i][code];
      }
      gid += static_cast<int64_t>(c) * k.stride[i];
    }
  }
  return (gid >= 0 && gid < G) ? static_cast<int>(gid) : G;
}

// Slot of group g of thread t among a block's tpb threads: slots of one
// group lie side by side, so the 32 lanes of a warp touch 32 banks
// whatever groups their rows fall in.
__host__ __device__ DG_INLINE int dg_slot(int g, int t, int tpb) {
  return g * tpb + t;
}

// The rows a thread owns in a block of tpb threads: r0 + t + j * tpb for
// j < R = kDgRowsPerBlock / tpb, those below r1. Its rows' group ids and
// one column's values live in per-thread arrays of R (registers on the
// card); every step below is unrolled over them, so that a thread's R
// loads are in flight together.

// The group ids of a thread's rows (G for a dead row or one past r1),
// counted into its occupancy slots.
template <int R>
__host__ __device__ DG_INLINE void dg_stage_ids(const DgKeys& k,
                                               const uint8_t* keep,
                                               int64_t r0, int64_t r1, int t,
                                               int tpb, int G, int* g,
                                               int32_t* cnts) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int64_t r = r0 + t + static_cast<int64_t>(j) * tpb;
    g[j] = r < r1 ? dg_group_id(k, keep, r, G) : G;
  }
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (g[j] < G) cnts[dg_slot(g[j], t, tpb)] += 1;
}

// Load one column over a thread's rows: the 8 bytes of each value (float64
// or int64, as bits; 0 when data is null) and its validity byte.
template <int R>
__host__ __device__ DG_INLINE void dg_load_column(const int64_t* data,
                                                 const uint8_t* valid,
                                                 int64_t r0, int64_t r1,
                                                 int t, int tpb, int64_t* x,
                                                 uint8_t* v) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int64_t r = r0 + t + static_cast<int64_t>(j) * tpb;
    const bool in = r < r1;
    v[j] = in ? valid[r] : 0;
    x[j] = in && data != nullptr ? data[r] : 0;
  }
}

// The 8 bytes of a value as type T.
template <typename T>
__host__ __device__ DG_INLINE T dg_as(int64_t bits);

template <>
__host__ __device__ DG_INLINE int64_t dg_as<int64_t>(int64_t bits) {
  return bits;
}

template <>
__host__ __device__ DG_INLINE double dg_as<double>(int64_t bits) {
#ifdef __CUDA_ARCH__
  return __longlong_as_double(bits);
#else
  double out;
  memcpy(&out, &bits, sizeof(out));
  return out;
#endif
}

// The accumulation step: a thread's loaded valid live rows of one column
// into its slots, in row order, sum (unless count_only) and count.
template <typename T, int R>
__host__ __device__ DG_INLINE void dg_accumulate(const int* g,
                                                const int64_t* x,
                                                const uint8_t* v, int t,
                                                int tpb, int G,
                                                bool count_only, T* sums,
                                                int32_t* cnts) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (g[j] < G && v[j]) {
      if (!count_only) sums[dg_slot(g[j], t, tpb)] += dg_as<T>(x[j]);
      cnts[dg_slot(g[j], t, tpb)] += 1;
    }
  }
}

// Lane `lane`'s fold of n values base[j * stride], j = lane, lane + 32,
// ..., in that order, as accumulator type A.
template <typename A, typename S>
__host__ __device__ DG_INLINE A dg_fold(const S* base, int64_t stride,
                                        int lane, int64_t n) {
  A acc = 0;
#pragma unroll 8
  for (int64_t j = lane; j < n; j += kDgLanes) acc += static_cast<A>(
      base[j * stride]);
  return acc;
}

#ifdef __CUDACC__
// The warp's tree over the lanes' folds: lane 0 ends with the total.
template <typename T>
__device__ DG_INLINE T dg_warp_tree(T v) {
  for (int off = kDgLanes / 2; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}
#else
// The same tree over 32 lane values on the host: lanes below each
// distance take the lane that far above, as the shuffles do.
template <typename T>
inline T dg_tree_host(T* v) {
  for (int off = kDgLanes / 2; off > 0; off >>= 1)
    for (int l = 0; l < off; ++l) v[l] += v[l + off];
  return v[0];
}
#endif
