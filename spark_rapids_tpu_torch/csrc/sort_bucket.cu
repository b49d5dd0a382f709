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
// 4-byte bucket written once; the splitters (at most 6,144 words) are
// read from L1. The search is log2(S + 1) steps of one compare, almost
// always decided by the first operand or two.
//
// Design: one thread a row, 256 threads a block, a block for every 256
// rows. The operands are the sort's own vectors, passed as pointers with
// their element types, so nothing widens or stacks them first. A thread
// reads its row's first four operands (a sort by two orders: null rank,
// key, null rank, key) into registers, column by column, so a warp's
// loads are coalesced, then binary searches the splitters
// (csrc/sort_bucket_row.cuh, which the CPU tests build with g++),
// reading them where the sort keeps them, through the read-only cache.
// No block stages them in shared memory: that puts a read of device
// memory and a barrier ahead of every block's first row load, which at
// ten microseconds a launch costs more than the search's L1 reads
// (PERF.md section 6 has the designs timed against this one).
#include <cuda_runtime.h>
#include <stdint.h>

#include "sort_bucket_row.cuh"

namespace {

constexpr int kThreads = 256;
// Splitter words a launch takes (48 KB, within L1)
constexpr int kMaxSplitterWords = 6144;

__global__ void sort_bucket_kernel(const SbOperands ops, int64_t n,
                                   int64_t num_rows,
                                   const int64_t* __restrict__ splitters,
                                   int S, int K, int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = sb_bucket(splitters, S, K, ops, i, num_rows);
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
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  sort_bucket_kernel<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(*ops, n, num_rows, splitters,
                                               S, K, out);
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
