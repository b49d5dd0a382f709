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
// large prefix loses a small frame's low bits. Here each row sums its
// own frame in ascending row order, as Spark's sliding frame does.
//
// What bounds it on an H100: bytes, for a narrow frame. A row reads its
// value, validity and partition-start flag once (its neighbours' values
// and flags come from L1 and L2) and writes a value and a validity: 19
// bytes, 114 MB for bench.py's window rung at 6,001,215 rows, 0.034 ms
// at 3.35 TB/s. A wide frame costs W loads and adds a row, so the time
// grows with W past the byte bound.
//
// Design: the simple form. One thread a row over a grid-stride loop,
// 256 threads a block, the row's frame summed in a loop
// (csrc/window_frame_row.cuh, which the CPU tests build with g++). The
// frame's bounds come from the partition flags. A frame that reaches at
// most 32 rows back and forward has each row walk them, a load a flag;
// a wider one has the warp search them in chunks of its 32 rows, a
// chunk one byte load a lane and a ballot, about W / 32 of them for W
// rows. On an H100 the walk is the faster at W = 3 and the chunks at
// W = 101 (chip_smoke.py times both in turns; PERF.md section 6), so
// the launch picks by the frame's offsets (``wf_chunked``); ``search``
// can force either, for that timing. An instance per (value type, op,
// search) keeps the op's branches out of the loop.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "window_frame_row.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kAll = 0xffffffffu;

template <typename T, int OP, bool CHUNKED>
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
  if (!CHUNKED) {
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
      int64_t a, b;
      wf_walk_bounds(flags, n, i, lo, hi, &a, &b);
      Out r;
      uint8_t ok;
      wf_row<T, OP>(values, valid, a, b, &r, &ok);
      ((Out*)out)[i] = r;
      out_valid[i] = ok;
    }
    return;
  }
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

template <typename T, int OP>
int launch(const void* values, const uint8_t* valid, const uint8_t* flags,
           void* out, uint8_t* out_valid, int64_t n,
           int32_t lo, int32_t hi, int search, cudaStream_t stream) {
  int sms = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * (2048 / kThreads) * 4;
  if (blocks > cap) blocks = cap;
  if (search == WF_SEARCH_FRAME ? wf_chunked(lo, hi)
                               : search == WF_SEARCH_CHUNKS)
    window_frame_kernel<T, OP, true><<<(unsigned)blocks, kThreads, 0,
                                       stream>>>(
        (const T*)values, valid, flags, out, out_valid, n, lo, hi);
  else
    window_frame_kernel<T, OP, false><<<(unsigned)blocks, kThreads, 0,
                                        stream>>>(
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
// WfSearchKind. Returns the launch's CUDA error (0 on success).
extern "C" int window_frame_launch(const void* values, const uint8_t* valid,
                                   const uint8_t* flags, void* out,
                                   uint8_t* out_valid, int64_t n,
                                   int32_t lo, int32_t hi, int op,
                                   int is_float, int search, void* stream) {
  if (n <= 0) return 0;
  if (search < WF_SEARCH_FRAME || search > WF_SEARCH_CHUNKS)
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

// Registers a thread of the sum instance over doubles that walks the
// flags, and its threads a block.
extern "C" int window_frame_describe(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(
      &attr, window_frame_kernel<double, WF_SUM, false>);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = kThreads;
  return 0;
}
