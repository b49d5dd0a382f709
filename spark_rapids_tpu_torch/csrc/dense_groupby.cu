// Dense groupby over dictionary keys, for Hopper (sm_90a): per group, the
// sum and the count of valid live rows of every value column of a batch,
// and the group's count of live rows, in one call.
//
// Replaces the reduction of the reference's direct-addressing groupby,
// spark_rapids_tpu/exec/aggregate.py _build_direct_core (:797): a jitted
// jnp core that packs dictionary codes into a group id (remapped through
// columnar/segmented.py onehot_gather, :345) and reduces each aggregate
// with segmented.py seg_sum (:270), a one-hot over G <= 4096 segments. On
// the card a one-hot reduction materialises a G x rows mask per column,
// and index_add_ adds floats with atomics, whose sums change from run to
// run; this kernel reads each input once and adds in a fixed order.
//
// Bound: memory. Each row's key codes and validity, the keep mask, and
// each value column's 8 bytes and validity byte are read once; the
// outputs are K x G sums and counts. chip_smoke.py computes that bound.
//
// Design (arithmetic in dense_groupby_row.cuh):
// - A block owns kDgRowsPerBlock consecutive rows, a thread every
//   threads-th of them (8 or 16). Each thread computes its rows' group
//   ids (remap, null slot, stride) once and keeps them in registers,
//   counting occupancy on the way.
// - Then for each value column in turn, each thread adds its own rows, in
//   row order, into its own G slots in shared memory (sum and count; slot
//   g of thread t at g * threads + t, so a warp's 32 lanes hit 32 banks),
//   and the block folds the slots of each group in a fixed order: lanes
//   of a warp fold every 32nd thread's slot, then a shuffle tree. One
//   partial per block, column and group goes to device memory. A
//   thread's rows of a column are loaded together, into registers, while
//   the column before folds.
// - A second, small launch adds the block partials, in block order, the
//   same way: one warp per (column, group).
// Nothing depends on the order in which blocks run, so two launches on
// the same inputs give the same bits. One instance per group bucket:
// G = 16 with 256 threads a block (48 KiB of shared memory), G = 64 with
// 128 (96 KiB).
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_groupby_row.cuh"

namespace {

// The value columns of one launch. The kernel reads the pointer arrays
// only at constant indices, copying them to shared memory (a kernel
// parameter indexed at run time would be copied to local memory).
struct DgCols {
  const void* data[kDgMaxCols];     // float64 or int64 [rows], or null
  const uint8_t* valid[kDgMaxCols];
  uint32_t int_mask;                // bit c: column c is int64
  uint32_t data_mask;               // bit c: column c has data
  int32_t ncols;
};

__host__ __device__ constexpr int threads_of(int G) {
  return G <= 16 ? 256 : 128;
}

// Blocks an SM must hold, for __launch_bounds__: without it ptxas held the
// G = 16 instance to 64 registers and spilled one; 3 allows 85.
__host__ __device__ constexpr int min_blocks_of(int G) {
  return G <= 16 ? 3 : 1;
}

template <int G>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(G) * threads_of(G) * (8 + 4);
}

__device__ __forceinline__ int64_t dg_bits(int64_t v) { return v; }
__device__ __forceinline__ int64_t dg_bits(double v) {
  return __double_as_longlong(v);
}

// Fold the slots of every group of this block (sums as type T, unless
// sums is null) into the block's partial for column c.
template <int G, typename T>
__device__ inline void block_fold(const T* sums, const int32_t* cnts,
                                  int64_t* psum, int64_t* pcnt) {
  constexpr int TPB = threads_of(G);
  const int lane = threadIdx.x % kDgLanes;
  for (int g = threadIdx.x / kDgLanes; g < G; g += TPB / kDgLanes) {
    const int64_t n = dg_warp_tree(
        dg_fold<int64_t>(cnts + dg_slot(g, 0, TPB), 1, lane, TPB));
    T s = 0;
    if (sums != nullptr)
      s = dg_warp_tree(dg_fold<T>(sums + dg_slot(g, 0, TPB), 1, lane, TPB));
    if (lane == 0) {
      pcnt[g] = n;
      psum[g] = dg_bits(s);
    }
  }
}

template <int G>
__global__ void __launch_bounds__(threads_of(G), min_blocks_of(G))
dense_groupby_blocks(DgKeys keys, const uint8_t* __restrict__ keep,
                     int64_t rows, DgCols cols, int64_t* psum,
                     int64_t* pcnt) {
  constexpr int TPB = threads_of(G);
  constexpr int R = kDgRowsPerBlock / TPB;
  extern __shared__ __align__(16) uint8_t smem[];
  int64_t* s_sum = reinterpret_cast<int64_t*>(smem);
  int32_t* s_cnt = reinterpret_cast<int32_t*>(smem + G * TPB * 8);
  __shared__ const int64_t* s_data[kDgMaxCols];
  __shared__ const uint8_t* s_valid[kDgMaxCols];
  const int t = threadIdx.x;
  if (t == 0) {
#pragma unroll
    for (int c = 0; c < kDgMaxCols; ++c) {
      s_data[c] = static_cast<const int64_t*>(cols.data[c]);
      s_valid[c] = cols.valid[c];
    }
  }
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kDgRowsPerBlock;
  const int64_t r1 = rows - r0 < kDgRowsPerBlock ? rows
                                                 : r0 + kDgRowsPerBlock;
  // partials of this block: [column (ncols + 1, occupancy last)][G]
  const int64_t part = static_cast<int64_t>(blockIdx.x) * (cols.ncols + 1)
                       * G;

  int g[R];                     // the thread's rows' group ids
  int64_t x[R];                 // one column over them, loaded ahead
  uint8_t v[R];
  for (int i = 0; i < G; ++i) s_cnt[dg_slot(i, t, TPB)] = 0;
  dg_stage_ids<R>(keys, keep, r0, r1, t, TPB, G, g, s_cnt);
  __syncthreads();              // and the pointers in shared memory
  if (cols.ncols > 0)
    dg_load_column<R>(s_data[0], s_valid[0], r0, r1, t, TPB, x, v);
  block_fold<G, int64_t>(nullptr, s_cnt, psum + part + cols.ncols * G,
                         pcnt + part + cols.ncols * G);

  for (int c = 0; c < cols.ncols; ++c) {
    __syncthreads();            // the fold before has read every slot
    for (int i = 0; i < G; ++i) {
      s_sum[dg_slot(i, t, TPB)] = 0;
      s_cnt[dg_slot(i, t, TPB)] = 0;
    }
    const bool count_only = !((cols.data_mask >> c) & 1u);
    const bool is_int = (cols.int_mask >> c) & 1u;
    if (is_int) {
      dg_accumulate<int64_t, R>(g, x, v, t, TPB, G, count_only, s_sum,
                                s_cnt);
    } else {
      dg_accumulate<double, R>(g, x, v, t, TPB, G, count_only,
                               reinterpret_cast<double*>(s_sum), s_cnt);
    }
    // the next column's loads fly while this one folds
    if (c + 1 < cols.ncols)
      dg_load_column<R>(s_data[c + 1], s_valid[c + 1], r0, r1, t, TPB, x,
                        v);
    __syncthreads();
    if (is_int) {
      block_fold<G, int64_t>(count_only ? nullptr : s_sum, s_cnt,
                             psum + part + c * G, pcnt + part + c * G);
    } else {
      block_fold<G, double>(count_only ? nullptr
                                       : reinterpret_cast<double*>(s_sum),
                            s_cnt, psum + part + c * G, pcnt + part + c * G);
    }
  }
}

// One warp per (column, group): the block partials added in block order.
__global__ void dense_groupby_combine(const int64_t* psum,
                                      const int64_t* pcnt, int64_t blocks,
                                      int G, int ncols, uint32_t int_mask,
                                      uint32_t data_mask, int64_t* sums,
                                      int64_t* counts, int64_t* occupancy) {
  const int64_t w = (static_cast<int64_t>(blockIdx.x) * blockDim.x
                     + threadIdx.x) / kDgLanes;
  const int lane = threadIdx.x % kDgLanes;
  const int n_out = (ncols + 1) * G;
  if (w >= n_out) return;          // whole warps leave together
  const int c = static_cast<int>(w / G);
  const int64_t stride = n_out;    // one block's partials
  const int64_t n = dg_warp_tree(dg_fold<int64_t>(pcnt + w, stride, lane,
                                                  blocks));
  if (c == ncols) {
    if (lane == 0) occupancy[w - c * G] = n;
    return;
  }
  int64_t bits;
  if ((int_mask >> c) & 1u) {
    bits = dg_warp_tree(dg_fold<int64_t>(psum + w, stride, lane, blocks));
  } else {
    bits = dg_bits(dg_warp_tree(dg_fold<double>(
        reinterpret_cast<const double*>(psum + w), stride, lane, blocks)));
  }
  if (lane == 0) {
    sums[w] = ((data_mask >> c) & 1u) ? bits : 0;
    counts[w] = n;
  }
}

template <int G>
int launch_blocks(const DgKeys& keys, const uint8_t* keep, int64_t rows,
                  const DgCols& cols, int64_t blocks, int64_t* psum,
                  int64_t* pcnt, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    // the shared memory the block needs, and all of the SM's unified
    // L1/shared memory as shared, so that as many blocks fit as can
    cudaError_t e = cudaFuncSetAttribute(
        dense_groupby_blocks<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<G>()));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dense_groupby_blocks<G>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dense_groupby_blocks<G><<<static_cast<unsigned>(blocks), threads_of(G),
                            smem_bytes<G>(), s>>>(keys, keep, rows, cols,
                                                  psum, pcnt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows per block of the first launch: the wrapper sizes the partials,
// blocks x (ncols + 1) x groups int64 each, from it.
extern "C" int dense_groupby_rows_per_block() { return kDgRowsPerBlock; }

// All pointers but the host arrays (codes ... is_int) are device memory.
// Keys: nkeys (1..4) of int32 codes, bool validity, int32 remap of
// remap_len[i] entries and cardinality cards[i]; prod(cards[i] + 1) must
// not exceed groups (16 or 64). Values: ncols (0..16) of float64 or int64
// data (is_int[c]; null for a count-only column) with bool validity.
// Outputs: sums and counts [ncols][groups] (sums as the column's type),
// occupancy [groups]; psum and pcnt are scratch of
// ceil(rows / rows_per_block) x (ncols + 1) x groups int64 each. Launches
// on `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments out of range.
extern "C" int dense_groupby_launch(
    int nkeys, const void* const* codes, const void* const* key_valid,
    const void* const* remaps, const int32_t* remap_len,
    const int32_t* cards, const void* keep, int64_t rows, int ncols,
    const void* const* data, const void* const* valid,
    const uint8_t* is_int, int groups, void* psum, void* pcnt, void* sums,
    void* counts, void* occupancy, void* stream) {
  if (nkeys < 1 || nkeys > kDgMaxKeys || ncols < 0 || ncols > kDgMaxCols
      || rows < 0 || (groups != 16 && groups != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DgKeys k = {};
  k.nkeys = nkeys;
  for (int i = 0; i < nkeys; ++i) {
    if (cards[i] < 0 || remap_len[i] < 0)
      return static_cast<int>(cudaErrorInvalidValue);
    k.codes[i] = static_cast<const int32_t*>(codes[i]);
    k.valid[i] = static_cast<const uint8_t*>(key_valid[i]);
    k.remap[i] = static_cast<const int32_t*>(remaps[i]);
    k.remap_len[i] = remap_len[i];
    k.card[i] = cards[i];
  }
  if (dg_strides(&k) > groups) return static_cast<int>(cudaErrorInvalidValue);
  DgCols c = {};
  c.ncols = ncols;
  for (int j = 0; j < ncols; ++j) {
    c.data[j] = data[j];
    c.valid[j] = static_cast<const uint8_t*>(valid[j]);
    c.int_mask |= (is_int[j] ? 1u : 0u) << j;
    c.data_mask |= (data[j] != nullptr ? 1u : 0u) << j;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto ps = static_cast<int64_t*>(psum);
  auto pc = static_cast<int64_t*>(pcnt);
  const int64_t blocks = (rows + kDgRowsPerBlock - 1) / kDgRowsPerBlock;
  if (blocks > 0) {
    const auto kp = static_cast<const uint8_t*>(keep);
    const int rc = groups == 16
        ? launch_blocks<16>(k, kp, rows, c, blocks, ps, pc, s)
        : launch_blocks<64>(k, kp, rows, c, blocks, ps, pc, s);
    if (rc != 0) return rc;
  }
  const int64_t warps = static_cast<int64_t>(ncols + 1) * groups;
  const int threads = 256;
  const unsigned grid = static_cast<unsigned>(
      (warps * kDgLanes + threads - 1) / threads);
  dense_groupby_combine<<<grid, threads, 0, s>>>(
      ps, pc, blocks, groups, ncols, c.int_mask, c.data_mask,
      static_cast<int64_t*>(sums),
      static_cast<int64_t*>(counts), static_cast<int64_t*>(occupancy));
  return static_cast<int>(cudaGetLastError());
}
