// The arithmetic of the dense groupby kernel (dense_groupby.cu), as
// __host__ __device__ functions, so that g++ compiles and tests it on a
// machine with no CUDA toolkit (tests/test_torch_groupby.py runs the
// kernel's warp loop, fold and combine on the host through these
// functions, each ballot and shuffle emulated lane by lane).
//
// A row's group id packs up to kDgMaxKeys dictionary keys:
//   gid = sum_i (valid_i ? remap_i[code_i] : card_i) * stride_i
// where remap_i maps the batch dictionary's codes to the exec's global
// codes in [0, card_i), card_i is the null slot, and stride_i is the
// product of (card_j + 1) over the keys after i. A dead row (outside the
// keep mask, or past the last row) gets the id G and drops out.
//
// Sums are deterministic. A warp takes 32 rows at a time and orders them
// by group id, stably (dg_rank: one ballot per bit of the id), so that
// each group's rows sit in consecutive lanes in row order. A segmented
// inclusive scan over the lanes (dg_scan_takes: a shuffle step for each
// doubling up to the longest group, five at most, a lane adding the lane
// d below it only inside its own group) leaves each group's sum in its
// last lane, which adds it into the warp's own slot. The block adds its
// warps' slots in warp order (dg_fold_warps) and the block partials are
// added in block order (dg_combine). Counts are integers. Only
// additions: no multiply to fuse, no atomics.
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
constexpr int kDgLanes = 32;
// warps a block; each walks its own range of 32-row pieces
constexpr int kDgWarps = 8;
constexpr int kDgThreads = kDgWarps * kDgLanes;
// blocks an SM the registers are bounded for (__launch_bounds__)
constexpr int kDgMinBlocks = 4;
// value columns whose loads a warp issues together
constexpr int kDgColsAPass = 8;
// blocks whose partials the last of them adds (the first level of the
// combine); the last group to finish adds the group partials
constexpr int kDgCombine = 16;
// ticket counters at the start of the scratch; the last is the second
// level's
constexpr int kDgTickets = 64;

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
// drops the row rather than write past the slots. Every load of the row
// comes before any decision, so that a thread's rows load together; the
// loop over keys unrolls fully, so that on the card every field of the
// keys (a kernel parameter) is read at a constant offset.
__host__ __device__ DG_INLINE int dg_group_id(const DgKeys& k,
                                              const uint8_t* keep, int64_t r,
                                              int G) {
  const bool live = keep[r];
  int64_t gid = 0;
#pragma unroll
  for (int i = 0; i < kDgMaxKeys; ++i) {
    if (i < k.nkeys) {
      const bool v = k.valid[i][r];
      int32_t x = k.codes[i][r];
      int32_t c = k.card[i];
      if (v && k.remap_len[i] > 0) {
        x = x < 0 ? 0 : (x >= k.remap_len[i] ? k.remap_len[i] - 1 : x);
        c = k.remap[i][x];
      }
      gid += static_cast<int64_t>(c) * k.stride[i];
    }
  }
  return (live && gid >= 0 && gid < G) ? static_cast<int>(gid) : G;
}

// ---------------------------------------------------------------------------
// the row schedule
// ---------------------------------------------------------------------------

// Pieces [*p0, *p1) of warp w among `warps` (a piece is 32 consecutive
// rows): contiguous, counts differing by at most one, fixed by the row
// count and the grid alone.
__host__ __device__ DG_INLINE void dg_piece_range(int64_t pieces,
                                                  int64_t warps, int64_t w,
                                                  int64_t* p0, int64_t* p1) {
  *p0 = pieces * w / warps;
  *p1 = pieces * (w + 1) / warps;
}

// Bytes of a block's shared memory: each warp's sums (ncols x G, 8
// bytes), counts ((ncols + 1) x G, 4 bytes, occupancy last) and reorder
// scratch (row and id a lane).
__host__ __device__ DG_INLINE int64_t dg_warp_bytes(int G, int ncols) {
  return static_cast<int64_t>(ncols) * G * 8
         + static_cast<int64_t>(ncols + 1) * G * 4 + kDgLanes * 8;
}

// ---------------------------------------------------------------------------
// the warp loop: stable order by group id, then a segmented scan
// ---------------------------------------------------------------------------

__host__ __device__ DG_INLINE unsigned dg_popc(unsigned x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return static_cast<unsigned>(__builtin_popcount(x));
#endif
}

// Bits of a group id, dead rows' G included.
__host__ __device__ constexpr int dg_id_bits(int G) {
  return G <= 16 ? 5 : 7;
}

// One bit of the ordering, most significant first: `ballot` has lane j's
// bit b of its id. `lt` collects the lanes whose ids are smaller than
// this lane's, `eq` keeps those equal so far (after the last bit: the
// lanes with this lane's id).
__host__ __device__ DG_INLINE void dg_rank_bit(int gid, int b, unsigned ballot,
                                               unsigned* lt, unsigned* eq) {
  if ((gid >> b) & 1) {
    *lt |= *eq & ~ballot;
    *eq &= ballot;
  } else {
    *eq &= ~ballot;
  }
}

// The lane's place in the stable order by id: the lanes with smaller ids,
// then those with the same id below it.
__host__ __device__ DG_INLINE int dg_rank(unsigned lt, unsigned eq,
                                          int lane) {
  return static_cast<int>(dg_popc(lt) + dg_popc(eq & ((1u << lane) - 1u)));
}

// In the ordered lanes: the first lane of this lane's group, from the
// ballot of group heads (a lane whose id differs from the lane below).
__host__ __device__ DG_INLINE int dg_seg_start(unsigned heads, int lane) {
  const unsigned upto = lane == 31 ? 0xffffffffu : ((2u << lane) - 1u);
  const unsigned h = heads & upto;     // lane 0 is always a head
#ifdef __CUDA_ARCH__
  return 31 - __clz(h);
#else
  return 31 - __builtin_clz(h);
#endif
}

// The lanes of this lane's group up to this lane (all of the group at
// its last lane).
__host__ __device__ DG_INLINE unsigned dg_seg_mask(int start, int lane) {
  const unsigned upto = lane == 31 ? 0xffffffffu : ((2u << lane) - 1u);
  return upto & ~((1u << start) - 1u);
}

// Step d of the scan: whether the lane adds the value of lane - d. The
// steps run while d is below the longest group's length in lanes (the
// steps after would add nothing).
__host__ __device__ DG_INLINE bool dg_scan_takes(int lane, int d, int start) {
  return lane - d >= start;
}

// ---------------------------------------------------------------------------
// values, the fold and the combine
// ---------------------------------------------------------------------------

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

__host__ __device__ DG_INLINE int64_t dg_bits(int64_t v) { return v; }
__host__ __device__ DG_INLINE int64_t dg_bits(double v) {
#ifdef __CUDA_ARCH__
  return __double_as_longlong(v);
#else
  int64_t out;
  memcpy(&out, &v, sizeof(out));
  return out;
#endif
}

// Output o of a block: its warps' slots added in warp order (warp w's at
// w * stride + o), as type T.
template <typename T, typename S>
__host__ __device__ DG_INLINE int64_t dg_fold_warps(const S* slot,
                                                    int64_t stride, int warps,
                                                    int64_t o) {
  T s = 0;
  for (int w = 0; w < warps; ++w)
    s += dg_as<T>(static_cast<int64_t>(slot[w * stride + o]));
  return dg_bits(s);
}

// A partial another block wrote: on the card read at L2, past this SM's
// L1, which is not kept coherent with other SMs' writes.
__host__ __device__ DG_INLINE int64_t dg_load_partial(const int64_t* p) {
#ifdef __CUDA_ARCH__
  return __ldcg(reinterpret_cast<const long long*>(p));
#else
  return *p;
#endif
}

// Output o of n partials (partial j's at j * stride + o) added in order,
// loaded kDgCombine at a time so that the loads are in flight together.
template <typename T>
__host__ __device__ DG_INLINE int64_t dg_combine(const int64_t* part,
                                                 int64_t stride, int64_t n,
                                                 int64_t o) {
  T s = 0;
  for (int64_t j0 = 0; j0 < n; j0 += kDgCombine) {
    int64_t x[kDgCombine];
#pragma unroll
    for (int u = 0; u < kDgCombine; ++u)
      x[u] = j0 + u < n ? dg_load_partial(part + (j0 + u) * stride + o) : 0;
#pragma unroll
    for (int u = 0; u < kDgCombine; ++u)
      if (j0 + u < n) s += dg_as<T>(x[u]);
  }
  return dg_bits(s);
}
