// Dense groupby over dictionary keys, for Hopper (sm_90a): per group, the
// sum and the count of valid live rows of every value column of a batch,
// and the group's count of live rows, in one launch.
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
// Design (arithmetic in dense_groupby_row.cuh, where the order of every
// addition is written down):
// - Warps over 32-row pieces: each warp of a persistent grid (as many
//   blocks as the SMs hold) walks its own contiguous range of pieces,
//   fixed by the row count and the grid (dg_piece_range). A lane loads
//   its row's keys, keep, and the validity and data of up to
//   kDgColsAPass columns at once, straight from device memory into
//   registers: every load is coalesced (a warp reads 32 consecutive
//   values), and nothing waits on another warp until the block's end, so
//   the many warps an SM holds keep the loads in flight.
// - Fixed-order warp sums: the warp orders its 32 rows stably by group id
//   (a ballot per id bit), moves each column's values into that order
//   (a shuffle; validity by a ballot), and a segmented scan (a shuffle
//   step for each doubling up to the longest group, five at most) leaves
//   each group's sum in the group's last lane, which adds it into the
//   warp's own slots. Counts are popcounts of a ballot, kept in the
//   warp's slots too. A block adds its warps' slots once, in warp order,
//   at its end.
// - The cross-block combine in the same launch: each block writes its
//   partial and takes a ticket; the last block of each 16 adds their
//   partials in block order, and the last of those adds the group
//   partials in group order, then resets the tickets. The order is the
//   same whichever block comes last, so two launches give the same bits.
//   (A second launch for the same additions measured slower: PERF.md.)
// Measured on the H100 against other designs in the same calls
// (PERF.md): staging tiles in shared memory through a ring of asynchronous
// copies (cp.async.bulk from a producer warp, 16-byte cp.async from every
// warp, or a ring per warp), then reducing them with this warp loop, a
// per-tile counting sort or per-thread slots, all ran slower on q1's
// batch: the staging's shared-memory traffic, and a barrier a tile, cost
// more than the latency they hid. Reducing float64 columns on the tensor
// cores (one-hot x values, mma m8n8k4) needed so many registers that
// half the warps fit, and ran slower too. What holds this design back is
// in PERF.md: neither its loads nor its warp loop alone comes near the
// memory bound.
// One instance per group bucket, G = 16 and G = 64, registers bounded for
// kDgMinBlocks blocks an SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "dense_groupby_row.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct DgArgs {
  DgKeys keys;
  const uint8_t* keep;                // bool [rows]
  const int64_t* data[kDgMaxCols];    // float64 or int64 [rows], or null
  const uint8_t* valid[kDgMaxCols];   // bool [rows]
  int64_t rows;
  int32_t ncols;
  uint32_t int_mask;                  // bit c: column c is int64
  uint32_t data_mask;                 // bit c: column c has data
  int64_t* psum;                      // [grid][ncols][G] block partials
  int64_t* pcnt;                      // [grid][ncols + 1][G]
  int64_t* gsum;                      // [groups of 16 blocks][ncols][G]
  int64_t* gcnt;
  int32_t* tickets;                   // kDgTickets, zero between launches
  int64_t* sums;                      // [ncols][G], then counts
  int64_t* counts;                    // [ncols + 1][G]: occupancy last
};

// Inclusive scan of a column's values (the 8 bytes of type T) over the
// lanes of each group (lanes ordered by group, this lane's group starting
// at `start`, no group longer than `span`).
template <typename T>
__device__ __forceinline__ int64_t seg_scan(int64_t bits, int lane,
                                            int start, int span) {
  T x = dg_as<T>(bits);
  for (int d = 1; d < span; d <<= 1) {
    const T y = __shfl_up_sync(kFull, x, d);
    if (dg_scan_takes(lane, d, start)) x += y;
  }
  return dg_bits(x);
}

// The warp's piece p (rows 32p .. 32p + 31) into its slots.
template <int G>
__device__ __forceinline__ void reduce_piece(
    const DgArgs& a, const int64_t* const* s_data,
    const uint8_t* const* s_valid, int64_t p, int32_t* scratch,
    int64_t* w_sum, uint32_t* w_cnt) {
  const int lane = threadIdx.x % kDgLanes;
  const int64_t row = p * kDgLanes + lane;
  const bool in = row < a.rows;
  // the first columns' loads go out with the keys'
  int64_t x[kDgColsAPass];
  uint8_t v[kDgColsAPass];
#pragma unroll
  for (int u = 0; u < kDgColsAPass; ++u) {
    const bool on = in && u < a.ncols;
    v[u] = on ? s_valid[u][row] : 0;
    x[u] = on && ((a.data_mask >> u) & 1u) ? s_data[u][row] : 0;
  }
  const int gid = in ? dg_group_id(a.keys, a.keep, row, G) : G;

  unsigned lt = 0, eq = kFull;
#pragma unroll
  for (int b = dg_id_bits(G) - 1; b >= 0; --b)
    dg_rank_bit(gid, b, __ballot_sync(kFull, (gid >> b) & 1), &lt, &eq);
  scratch[dg_rank(lt, eq, lane)] = lane;
  scratch[kDgLanes + dg_rank(lt, eq, lane)] = gid;
  __syncwarp();
  const int src = scratch[lane];
  const int gs = scratch[kDgLanes + lane];
  const int prev = lane > 0 ? scratch[kDgLanes + lane - 1] : -1;
  const int next = lane < kDgLanes - 1 ? scratch[kDgLanes + lane + 1] : -1;
  __syncwarp();
  const int start = dg_seg_start(__ballot_sync(kFull, gs != prev), lane);
  const unsigned seg = dg_seg_mask(start, lane);
  const bool last = gs != next && gs < G;
  if (last) w_cnt[a.ncols * G + gs] += lane - start + 1;
  // every group's rows within `span` lanes: the scan's steps past that
  // would add nothing
  const int span = static_cast<int>(
      __reduce_max_sync(kFull, static_cast<unsigned>(lane - start + 1)));

  for (int c0 = 0; c0 < a.ncols; c0 += kDgColsAPass) {
    if (c0 > 0) {
#pragma unroll
      for (int u = 0; u < kDgColsAPass; ++u) {
        const int c = c0 + u;
        const bool on = in && c < a.ncols;
        v[u] = on ? s_valid[c][row] : 0;
        x[u] = on && ((a.data_mask >> c) & 1u) ? s_data[c][row] : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kDgColsAPass; ++u) {
      const int c = c0 + u;
      if (c >= a.ncols) break;
      // this lane's row in group order: its validity and value
      const unsigned vb = __ballot_sync(kFull, v[u]);
      const bool vs = gs < G && ((vb >> src) & 1u);
      const unsigned nv = dg_popc(__ballot_sync(kFull, vs) & seg);
      if ((a.data_mask >> c) & 1u) {
        int64_t xs = __shfl_sync(kFull, x[u], src);
        xs = vs ? xs : 0;
        const bool is_int = (a.int_mask >> c) & 1u;
        const int64_t y = is_int ? seg_scan<int64_t>(xs, lane, start, span)
                                 : seg_scan<double>(xs, lane, start, span);
        if (last && nv) {
          int64_t* slot = w_sum + c * G + gs;
          *slot = is_int ? *slot + y
                         : dg_bits(dg_as<double>(*slot) + dg_as<double>(y));
        }
      }
      if (last && nv) w_cnt[c * G + gs] += nv;
    }
  }
}

// Outputs (sums [ncols][G], counts [ncols + 1][G]) of n partials at ps
// and pc, added in order.
template <int G>
__device__ __forceinline__ void combine_into(const DgArgs& a,
                                             const int64_t* ps,
                                             const int64_t* pc, int64_t n,
                                             int64_t* dsum, int64_t* dcnt) {
  const int kg = a.ncols * G;
  for (int o = threadIdx.x; o < kg + G; o += blockDim.x) {
    dcnt[o] = dg_combine<int64_t>(pc, kg + G, n, o);
    if (o >= kg) continue;
    const int c = o / G;
    int64_t s = 0;
    if ((a.data_mask >> c) & 1u)
      s = ((a.int_mask >> c) & 1u) ? dg_combine<int64_t>(ps, kg, n, o)
                                   : dg_combine<double>(ps, kg, n, o);
    dsum[o] = s;
  }
}

template <int G>
__global__ void __launch_bounds__(kDgThreads, kDgMinBlocks)
dense_groupby_warps(const __grid_constant__ DgArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_flag;
  __shared__ const int64_t* s_data[kDgMaxCols];
  __shared__ const uint8_t* s_valid[kDgMaxCols];
  const int tid = threadIdx.x;
  const int warp = tid / kDgLanes;
  const int kg = a.ncols * G;
  // each warp's sums, then each warp's counts, then each warp's scratch
  int64_t* s_sum = reinterpret_cast<int64_t*>(smem);
  uint32_t* s_cnt = reinterpret_cast<uint32_t*>(s_sum + kDgWarps * kg);
  int32_t* s_scratch = reinterpret_cast<int32_t*>(s_cnt + kDgWarps
                                                  * (kg + G));
  if (tid < kDgMaxCols) {
    s_data[tid] = a.data[tid];
    s_valid[tid] = a.valid[tid];
  }
  for (int o = tid; o < kDgWarps * kg; o += kDgThreads) s_sum[o] = 0;
  for (int o = tid; o < kDgWarps * (kg + G); o += kDgThreads) s_cnt[o] = 0;
  __syncthreads();

  int64_t p0, p1;
  dg_piece_range((a.rows + kDgLanes - 1) / kDgLanes,
                 static_cast<int64_t>(gridDim.x) * kDgWarps,
                 static_cast<int64_t>(blockIdx.x) * kDgWarps + warp, &p0,
                 &p1);
  for (int64_t p = p0; p < p1; ++p)
    reduce_piece<G>(a, s_data, s_valid, p, s_scratch + warp * 2 * kDgLanes,
                    s_sum + warp * kg, s_cnt + warp * (kg + G));
  __syncthreads();

  // the block's partial: its warps' counts and sums in warp order
  int64_t* ps = a.psum + static_cast<int64_t>(blockIdx.x) * kg;
  int64_t* pc = a.pcnt + static_cast<int64_t>(blockIdx.x) * (kg + G);
  for (int o = tid; o < kg + G; o += kDgThreads) {
    pc[o] = dg_fold_warps<int64_t>(s_cnt, kg + G, kDgWarps, o);
    if (o >= kg) continue;
    const int c = o / G;
    int64_t s = 0;
    if ((a.data_mask >> c) & 1u)
      s = ((a.int_mask >> c) & 1u)
              ? dg_fold_warps<int64_t>(s_sum, kg, kDgWarps, o)
              : dg_fold_warps<double>(s_sum, kg, kDgWarps, o);
    ps[o] = s;
  }
  __threadfence();
  __syncthreads();

  // the last block of each kDgCombine adds theirs in block order
  const int64_t grid = gridDim.x;
  const int64_t q = blockIdx.x / kDgCombine;
  const int64_t first = q * kDgCombine;
  const int64_t nq = grid - first < kDgCombine ? grid - first : kDgCombine;
  const int64_t groups = (grid + kDgCombine - 1) / kDgCombine;
  if (tid == 0) s_flag = atomicAdd(&a.tickets[q], 1) == nq - 1;
  __syncthreads();
  if (!s_flag) return;
  __threadfence();
  if (groups == 1) {
    combine_into<G>(a, a.psum, a.pcnt, nq, a.sums, a.counts);
  } else {
    combine_into<G>(a, a.psum + first * kg, a.pcnt + first * (kg + G), nq,
                    a.gsum + q * kg, a.gcnt + q * (kg + G));
  }
  if (tid == 0) a.tickets[q] = 0;
  if (groups == 1) return;
  __threadfence();
  __syncthreads();
  // the last group to finish adds the group partials in group order
  if (tid == 0)
    s_flag = atomicAdd(&a.tickets[kDgTickets - 1], 1) == groups - 1;
  __syncthreads();
  if (!s_flag) return;
  __threadfence();
  combine_into<G>(a, a.gsum, a.gcnt, groups, a.sums, a.counts);
  if (tid == 0) a.tickets[kDgTickets - 1] = 0;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

std::mutex g_mu;
// (device, G, threads, shared memory) -> blocks an SM holds
std::map<std::tuple<int, int, int, int64_t>, int> g_resident;
// (device, G) -> the instance's shared-memory attributes are set
std::map<std::pair<int, int>, bool> g_configured;
std::map<int, int> g_sms;

template <int G>
cudaError_t configure(int dev) {
  if (g_configured[{dev, G}]) return cudaSuccess;
  // all of the SM's unified L1/shared memory as shared, and up to a
  // block's maximum dynamic shared memory
  int optin = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, dense_groupby_warps<G>);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        dense_groupby_warps<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        optin - static_cast<int>(fa.sharedSizeBytes));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dense_groupby_warps<G>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  int sms = 0;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  g_sms[dev] = sms;
  g_configured[{dev, G}] = true;
  return cudaSuccess;
}

// The blocks an SM holds with `smem` bytes of dynamic shared memory.
template <int G>
cudaError_t resident(int64_t smem, int* blocks_per_sm, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(g_mu);
  e = configure<G>(dev);
  if (e != cudaSuccess) return e;
  *sms = g_sms[dev];
  auto key = std::make_tuple(dev, G, kDgThreads, smem);
  auto it = g_resident.find(key);
  if (it == g_resident.end()) {
    int nb = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &nb, dense_groupby_warps<G>, kDgThreads, static_cast<size_t>(smem));
    if (e != cudaSuccess) return e;
    it = g_resident.emplace(key, nb).first;
  }
  *blocks_per_sm = it->second;
  return cudaSuccess;
}

// The largest grid: kDgTickets - 1 groups of kDgCombine blocks.
constexpr int64_t kMaxGrid = (kDgTickets - 1) * kDgCombine;

int64_t scratch_bytes(int groups, int ncols) {
  const int64_t kg = static_cast<int64_t>(ncols) * groups;
  const int64_t per = kg + kg + groups;           // a partial's int64s
  return kDgTickets * 4
         + (kMaxGrid + kMaxGrid / kDgCombine) * per * 8;
}

template <int G>
int launch(DgArgs& a, cudaStream_t s) {
  const int64_t smem = kDgWarps * dg_warp_bytes(G, a.ncols);
  int nb = 0, sms = 0;
  cudaError_t e = resident<G>(smem, &nb, &sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (nb < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t pieces = (a.rows + kDgLanes - 1) / kDgLanes;
  int64_t grid = static_cast<int64_t>(nb) * sms;
  if (grid > (pieces + kDgWarps - 1) / kDgWarps)
    grid = (pieces + kDgWarps - 1) / kDgWarps;
  if (grid < 1) grid = 1;
  if (grid > kMaxGrid) grid = kMaxGrid;
  dense_groupby_warps<G><<<static_cast<unsigned>(grid), kDgThreads,
                           static_cast<size_t>(smem), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of scratch a launch with `groups` and `ncols` needs: ticket
// counters (zero before the first launch; every launch leaves them zero),
// then block and group partials. Not a function of the row count.
extern "C" int64_t dense_groupby_scratch_bytes(int groups, int ncols) {
  return scratch_bytes(groups, ncols);
}

// The launch's shape for chip_smoke.py to print: out = {threads a block,
// dynamic shared memory bytes, blocks an SM, SMs, registers a thread,
// local bytes a thread}.
extern "C" int dense_groupby_describe(int groups, int ncols, int64_t* out) {
  if ((groups != 16 && groups != 64) || ncols < 0 || ncols > kDgMaxCols)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem = kDgWarps * dg_warp_bytes(groups, ncols);
  int nb = 0, sms = 0;
  cudaFuncAttributes fa;
  cudaError_t e;
  if (groups == 16) {
    e = resident<16>(smem, &nb, &sms);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa,
                                                    dense_groupby_warps<16>);
  } else {
    e = resident<64>(smem, &nb, &sms);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa,
                                                    dense_groupby_warps<64>);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t v[6] = {kDgThreads, smem, nb, sms, fa.numRegs,
                        static_cast<int64_t>(fa.localSizeBytes)};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// One launch from a packed argument vector of int64 (pointers as
// integers; all pointers are device memory):
//   [0] nkeys (1..4)  [1] ncols (0..16)  [2] groups (16 or 64)  [3] rows
//   (below 2^31: a warp counts its rows in 32 bits)  [4] keep (bool [rows])  [5] out: sums [ncols][groups]
//   (as each column's type), counts [ncols][groups], occupancy [groups],
//   in one buffer  [6] scratch  [7] its bytes  [8] stream  [9] bit c:
//   column c is int64
//   then per key 5: codes (int32 [rows]), validity (bool), remap (int32),
//   remap length, cardinality; prod(card + 1) must not exceed groups
//   then per column 2: data (float64 or int64 [rows], 0 for a count
//   only), validity (bool).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for arguments out of range (nothing launched).
extern "C" int dense_groupby_launch(const int64_t* v) {
  const int nkeys = static_cast<int>(v[0]);
  const int ncols = static_cast<int>(v[1]);
  const int groups = static_cast<int>(v[2]);
  const int64_t rows = v[3];
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (nkeys < 1 || nkeys > kDgMaxKeys || ncols < 0 || ncols > kDgMaxCols
      || rows < 0 || rows > INT32_MAX || (groups != 16 && groups != 64)
      || v[7] < scratch_bytes(groups, ncols) || v[6] == 0 || v[5] == 0
      || (rows > 0 && v[4] == 0))
    return bad;
  DgArgs a = {};
  a.keys.nkeys = nkeys;
  const int64_t* kv = v + 10;
  const int64_t* cv = kv + 5 * nkeys;
  for (int i = 0; i < nkeys; ++i) {
    const int64_t len = kv[5 * i + 3], card = kv[5 * i + 4];
    if (len < 0 || len > INT32_MAX || card < 0 || card > INT32_MAX
        || (rows > 0 && (kv[5 * i] == 0 || kv[5 * i + 1] == 0))
        || (len > 0 && kv[5 * i + 2] == 0))
      return bad;
    a.keys.codes[i] = reinterpret_cast<const int32_t*>(kv[5 * i]);
    a.keys.valid[i] = reinterpret_cast<const uint8_t*>(kv[5 * i + 1]);
    a.keys.remap[i] = reinterpret_cast<const int32_t*>(kv[5 * i + 2]);
    a.keys.remap_len[i] = static_cast<int32_t>(len);
    a.keys.card[i] = static_cast<int32_t>(card);
  }
  if (dg_strides(&a.keys) > groups) return bad;
  a.keep = reinterpret_cast<const uint8_t*>(v[4]);
  for (int c = 0; c < ncols; ++c) {
    if (rows > 0 && cv[2 * c + 1] == 0) return bad;
    a.data[c] = reinterpret_cast<const int64_t*>(cv[2 * c]);
    a.valid[c] = reinterpret_cast<const uint8_t*>(cv[2 * c + 1]);
    a.data_mask |= (cv[2 * c] != 0 ? 1u : 0u) << c;
  }
  a.rows = rows;
  a.ncols = ncols;
  a.int_mask = static_cast<uint32_t>(v[9]);
  const int64_t kg = static_cast<int64_t>(ncols) * groups;
  auto scratch = reinterpret_cast<uint8_t*>(v[6]);
  a.tickets = reinterpret_cast<int32_t*>(scratch);
  a.psum = reinterpret_cast<int64_t*>(scratch + kDgTickets * 4);
  a.pcnt = a.psum + kMaxGrid * kg;
  a.gsum = a.pcnt + kMaxGrid * (kg + groups);
  a.gcnt = a.gsum + (kMaxGrid / kDgCombine) * kg;
  a.sums = reinterpret_cast<int64_t*>(v[5]);
  a.counts = a.sums + kg;
  auto s = reinterpret_cast<cudaStream_t>(v[8]);
  return groups == 16 ? launch<16>(a, s) : launch<64>(a, s);
}
