// window_frame: sum, count, average, minimum or maximum over each row's
// bounded ROWS BETWEEN lo AND hi frame (both ends finite), over rows
// sorted by partition.
//
// Replaces the bounded branch of the reference's jitted window kernel:
// spark_rapids_tpu/exec/window.py ``_windowed_agg`` (:268-332: a frame
// sum as the difference of two prefix sums over the whole table) and
// ``_bounded_minmax`` (:559-631: a sparse table of log2(W) passes, the
// clamped-scan candidates and three more prefix sums for the counts). A
// difference of prefixes is not the frame's sum: after one +inf every
// later frame reads inf - inf = NaN, in every later partition, and a
// large prefix loses a small frame's low bits. Here a float64 frame is
// summed in ascending row order, as Spark's sliding frame sums it.
//
// What bounds it on an H100: bytes, 19 a row (value, validity and
// partition flag read once, value and validity written once), 114 MB
// for bench.py's window rung at 6,001,215 rows, 0.034 ms at 3.35 TB/s;
// for a wide float64 sum, the W adds a row that row order forces (W =
// 101: 606 M adds, 0.036 ms at 64 adds a clock an SM).
//
// Design (the tiled instance, csrc/window_frame_tile.cuh): persistent
// blocks of 256 threads (as many as the card holds at once), each walking
// tiles of 1,280 rows. A tile and its halo (-lo rows before, hi after,
// each rounded up to 16) are copied into shared memory by 16-byte
// asynchronous copies into one of two buffers, the next tile's while this
// one is computed, so each byte is read from device memory about once. A
// tile whose staged rows hold no partition start and no NULL (the
// barrier's OR after the copies) computes every frame whole; else it
// builds bitmasks of the starts and valid rows (ballots) and scans their
// words, which give every row's partition clamps and count in O(1). A
// thread's 5 consecutive rows walk the union of their frames once (a
// float64 sum in row order: a value loaded once for 5 rows); an int64
// sum is a prefix difference, an extreme wider than 16 rows van Herk /
// Gil-Werman segments, O(1) a row whatever W; the tile's results go out
// in 16-byte stores.
//
// Dispatch by the frame's offsets (``search`` "frame", the port's path):
// the tiled instance takes a frame reaching at most WF_HALO_MAX = 1,024
// rows back and forward. Past that, the chunked instance
// (csrc/window_frame_row.cuh), a thread a row: the partition's ends
// searched by the warp in chunks of 32 flags, the row's frame summed in
// a loop. ``search`` can force an instance, for chip_smoke.py to time
// each. An instance per (value type, op) keeps the op's branches out of
// the loops.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "window_frame_row.cuh"
#include "window_frame_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kAll = 0xffffffffu;
// Blocks of the tiled instance an SM holds at least (ptxas keeps its
// registers to 65536 / (256 * WF_MIN_BLOCKS) a thread)
#define WF_MIN_BLOCKS 4

template <typename T, int OP>
__global__ void window_frame_kernel(const T* __restrict__ values,
                                    const uint8_t* __restrict__ valid,
                                    const uint8_t* __restrict__ flags,
                                    void* __restrict__ out,
                                    uint8_t* __restrict__ out_valid,
                                    int64_t n, int32_t lo, int32_t hi) {
  typedef typename std::conditional<
      OP == WF_COUNT, int64_t,
      typename std::conditional<OP == WF_AVG, double, T>::type>::type Out;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  // a warp's 32 rows from base (a multiple of 32: so are blockDim and the
  // stride); every lane runs the search, the rows past n as well
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + threadIdx.x - lane;
       base < n; base += stride) {
    const int64_t i = base + lane;
    WfSearch s = wf_search(i, n, lo, hi);
    for (int64_t cb = base; __any_sync(kAll, wf_back_needs(s, cb));
         cb -= 32)
      wf_back_chunk(&s, __ballot_sync(kAll, wf_flag(flags, n, cb + lane,
                                                    false)),
                    cb, i);
    for (int64_t cb = base; __any_sync(kAll, wf_fwd_needs(s, cb)); cb += 32)
      wf_fwd_chunk(&s, __ballot_sync(kAll, wf_flag(flags, n, cb + lane,
                                                   true)),
                   cb, i);
    if (i >= n) continue;
    Out r;
    uint8_t ok;
    wf_row<T, OP>(values, valid, s.x, s.y, &r, &ok);
    ((Out*)out)[i] = r;
    out_valid[i] = ok;
  }
}

// Persistent blocks, each walking tiles of WF_TILE_R * blockDim.x rows
// (window_frame_tile.cuh: a tile's copies staged a tile ahead, then its
// steps, a barrier between each two).
template <typename T, int OP, bool SEG>
__global__ void __launch_bounds__(WF_TILE_THREADS, WF_MIN_BLOCKS)
    window_frame_tile_kernel(const T* __restrict__ values,
                             const uint8_t* __restrict__ valid,
                             const uint8_t* __restrict__ flags,
                             void* __restrict__ out,
                             uint8_t* __restrict__ out_valid, int64_t n,
                             int32_t lo, int32_t hi, int64_t tiles) {
  typedef WfKind<T, OP, SEG> K;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const WfGeo geo = wf_geo(n, lo, hi, blockDim.x);
  const WfSmem s = wf_carve<T, OP, SEG>(smem, geo, values, valid, flags);
  int64_t tile = blockIdx.x;
  wf_stage<OP>(wf_at(geo, tile), wf_buf(s, 0), values, valid, flags, tid);
  tc_commit();
  for (int b = 0; tile < tiles; tile += gridDim.x, b ^= 1) {
    const WfGeo g = wf_at(geo, tile);
    const int64_t next = tile + gridDim.x;
    if (next < tiles)
      wf_stage<OP>(wf_at(geo, next), wf_buf(s, b ^ 1), values, valid, flags,
                   tid);
    tc_commit();
    tc_wait_prior();  // this tile's copies have landed, the next in flight
    const WfBuf bf = wf_buf(s, b);
    const bool masks =
        __syncthreads_or(wf_clamps(g, bf, valid, flags, tid));
    if (masks) wf_masks(g, s, bf, tid);
    if (K::kRowScans) wf_reduce<T, OP, SEG>(g, s, bf, tid);
    if (masks || K::kRowScans) __syncthreads();
    if (masks) wf_words(g, s, tid);
    if (K::kRowScans) wf_carries<T, OP, SEG>(g, s, tid);
    if (masks || K::kRowScans) __syncthreads();
    if (K::kRowScans) {
      wf_rescan<T, OP, SEG>(g, s, bf, tid);
      __syncthreads();
    }
    wf_rows<T, OP, SEG>(g, s, bf, tid, masks);
    __syncthreads();
    wf_store(g, s, out, out_valid, tid);
  }
}

// The multiprocessors of the current device.
int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

template <typename T, int OP, bool SEG>
int launch_tile(const void* values, const uint8_t* valid,
                const uint8_t* flags, void* out, uint8_t* out_valid,
                int64_t n, int32_t lo, int32_t hi, cudaStream_t stream) {
  const WfGeo g = wf_geo(n, lo, hi, WF_TILE_THREADS);
  const int64_t smem = wf_smem_bytes<T, OP, SEG>(g);
  // The instance may take as much shared memory as its widest frame
  // needs (about 111 KB), set on every launch: one size, so launches on
  // other threads and devices never see it lowered.
  const int64_t most = wf_smem_bytes<T, OP, SEG>(
      wf_geo(n, -WF_HALO_MAX, WF_HALO_MAX, WF_TILE_THREADS));
  int sms = 0, per_sm = 0;
  int rc = sm_count(&sms);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      window_frame_tile_kernel<T, OP, SEG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, window_frame_tile_kernel<T, OP, SEG>, WF_TILE_THREADS,
        (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (n + g.rows - 1) / g.rows;
  int64_t blocks = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > tiles) blocks = tiles;
  window_frame_tile_kernel<T, OP, SEG><<<(unsigned)blocks, WF_TILE_THREADS,
                                         (size_t)smem, stream>>>(
      (const T*)values, valid, flags, out, out_valid, n, lo, hi, tiles);
  return (int)cudaGetLastError();
}

template <typename T, int OP>
int launch(const void* values, const uint8_t* valid, const uint8_t* flags,
           void* out, uint8_t* out_valid, int64_t n,
           int32_t lo, int32_t hi, int search, cudaStream_t stream) {
  if (search == WF_SEARCH_TILE ||
      (search == WF_SEARCH_FRAME && wf_tiled(lo, hi)))
    return wf_segmented(OP, lo, hi)
               ? launch_tile<T, OP, true>(values, valid, flags, out,
                                          out_valid, n, lo, hi, stream)
               : launch_tile<T, OP, false>(values, valid, flags, out,
                                           out_valid, n, lo, hi, stream);
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc) return rc;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * (2048 / kThreads) * 4;
  if (blocks > cap) blocks = cap;
  window_frame_kernel<T, OP><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)values, valid, flags, out, out_valid, n, lo, hi);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_op(int op, const void* values, const uint8_t* valid,
              const uint8_t* flags, void* out, uint8_t* out_valid,
              int64_t n, int32_t lo, int32_t hi, int search,
              cudaStream_t s) {
  switch (op) {
    case WF_SUM:
      return launch<T, WF_SUM>(values, valid, flags, out, out_valid, n,
                               lo, hi, search, s);
    case WF_COUNT:
      return launch<T, WF_COUNT>(values, valid, flags, out, out_valid,
                                 n, lo, hi, search, s);
    case WF_MIN:
      return launch<T, WF_MIN>(values, valid, flags, out, out_valid, n,
                               lo, hi, search, s);
    case WF_MAX:
      return launch<T, WF_MAX>(values, valid, flags, out, out_valid, n,
                               lo, hi, search, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch on ``stream``: out[i] and out_valid[i] for rows 0..n-1.
// ``flags`` marks each partition's first row. ``is_float``: values are
// doubles (else int64). An average takes doubles. ``search``: a
// WfSearchKind (the tiled instance only within its halo). ``out`` and
// ``out_valid`` are 16-byte aligned. Returns the launch's CUDA error (0
// on success).
extern "C" int window_frame_launch(const void* values, const uint8_t* valid,
                                   const uint8_t* flags, void* out,
                                   uint8_t* out_valid, int64_t n,
                                   int32_t lo, int32_t hi, int op,
                                   int is_float, int search, void* stream) {
  if (n <= 0) return 0;
  if (search < WF_SEARCH_FRAME || search > WF_SEARCH_TILE ||
      (search == WF_SEARCH_TILE && !wf_tiled(lo, hi)) ||
      ((uintptr_t)out & 15) || ((uintptr_t)out_valid & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (op == WF_AVG) {
    if (!is_float) return (int)cudaErrorInvalidValue;
    return launch<double, WF_AVG>(values, valid, flags, out, out_valid,
                                  n, lo, hi, search, s);
  }
  return is_float ? launch_op<double>(op, values, valid, flags, out,
                                      out_valid, n, lo, hi, search, s)
                  : launch_op<int64_t>(op, values, valid, flags, out,
                                       out_valid, n, lo, hi, search, s);
}

// Registers a thread of the tiled sum instance over doubles, its threads
// a block, registers a thread of the chunked one, and the halo limit.
extern "C" int window_frame_describe(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(
      &attr, window_frame_tile_kernel<double, WF_SUM, false>);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = WF_TILE_THREADS;
  err = cudaFuncGetAttributes(&attr, window_frame_kernel<double, WF_SUM>);
  if (err != cudaSuccess) return (int)err;
  out[2] = attr.numRegs;
  out[3] = WF_HALO_MAX;
  return 0;
}
