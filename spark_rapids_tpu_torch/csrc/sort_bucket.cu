// sort_bucket: each row's bucket in the out-of-core sample sort, the
// number of splitters lexicographically <= its encoded sort key.
//
// Replaces the reference's jitted ``_bucket_id_kernel``
// (spark_rapids_tpu/exec/sort.py:164-187), which scans all S splitters
// in a fori_loop, comparing every row with each: S passes over the rows'
// K words.
//
// What bounds it on an H100: bytes. A row's K operands are read once at
// their own widths (a 1-byte null rank, a key of 1 to 8 bytes) and its
// 4-byte bucket written once; the splitters (at most 255 of K words) are
// read once a block. The search is log2(S + 1) steps of one compare,
// almost always decided by the first operand or two.
//
// Design: one thread a row over a grid-stride loop, 256 threads a block.
// Each block first copies the splitters into shared memory, splitter by
// splitter (a splitter's K words side by side). The operands are the
// sort's own vectors, passed as pointers with their element types, so
// nothing widens or stacks them first. A thread reads its row's first
// four operands (a sort by two orders: null rank, key, null rank, key)
// into registers (column by column, so a warp's loads are coalesced),
// then binary searches the splitters (csrc/sort_bucket_row.cuh, which
// the CPU tests build with g++). Reading the operands again at each
// compare, or four rows a thread before any search, was slower on the
// card (PERF.md section 6).
#include <cuda_runtime.h>
#include <stdint.h>

#include "sort_bucket_row.cuh"

namespace {

constexpr int kThreads = 256;
// Splitter words a block holds in shared memory (48 KB, the static limit)
constexpr int kMaxSplitterWords = 6144;

__global__ void sort_bucket_kernel(const SbOperands ops, int64_t n,
                                   int64_t num_rows,
                                   const int64_t* __restrict__ splitters,
                                   int S, int K, int32_t* __restrict__ out) {
  extern __shared__ int64_t sp[];
  for (int t = threadIdx.x; t < S * K; t += blockDim.x) {
    const int s = t / K, k = t - s * K;
    sp[t] = splitters[(int64_t)k * S + s];
  }
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = sb_bucket(sp, S, K, ops, i, num_rows);
}

}  // namespace

// One launch on ``stream``: out[i] for rows 0..n-1. ``ops`` holds the K
// operands' vectors of n rows each and their element types,
// ``splitters`` is int64 [K][S] (ascending). Returns the launch's CUDA
// error (0 on success).
extern "C" int sort_bucket_launch(const SbOperands* ops, int64_t n,
                                  int64_t num_rows, const int64_t* splitters,
                                  int S, int K, int32_t* out, void* stream) {
  if (n <= 0) return 0;
  if (K <= 0 || K > SB_MAX_OPERANDS || S < 0 ||
      (int64_t)S * K > kMaxSplitterWords)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < K; ++k)
    if (ops->type[k] < SB_U8 || ops->type[k] > SB_I64)
      return (int)cudaErrorInvalidValue;
  int sms = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * (2048 / kThreads) * 2;
  if (blocks > cap) blocks = cap;
  const size_t shared = (size_t)S * K * sizeof(int64_t);
  sort_bucket_kernel<<<(unsigned)blocks, kThreads, shared,
                       (cudaStream_t)stream>>>(*ops, n, num_rows,
                                               splitters, S, K, out);
  return (int)cudaGetLastError();
}

// The splitter words a launch takes.
extern "C" int sort_bucket_max_words() { return kMaxSplitterWords; }

// The operands a launch takes.
extern "C" int sort_bucket_max_operands() { return SB_MAX_OPERANDS; }

// Registers a thread of the kernel, and its threads a block.
extern "C" int sort_bucket_describe(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, sort_bucket_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = kThreads;
  return 0;
}
