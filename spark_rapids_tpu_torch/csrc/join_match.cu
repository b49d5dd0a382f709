// join_match: the match step of an equi-join as a hash build and probe on
// the card. It replaces the sort-based group match of the reference's
// jitted jnp join kernels (spark_rapids_tpu/exec/joins.py
// _build_count_kernel and _gather_index_kernel): for a stream side and a
// build side of encoded key words, the (stream row, build row) gather
// maps of the join.
//
// The wrapper (exec/join_match.py) sorts the build rows by key with torch
// and hands over the unique keys with each one's start and count in the
// sorted order. Then:
//   join_match_build  inserts the unique keys into an open-addressing
//                     table (linear probing, slots claimed by atomicCAS);
//   join_match_probe  per stream row, its unique-key id and match count,
//                     and for right and full joins a matched flag per
//                     key (a store of 1, the same in any order);
//   join_match_emit   per stream row, its pairs at its offset (an
//                     exclusive scan of the counts, made by the wrapper
//                     with one host read of the total).
// The output order is defined (stream row ascending, build rows ascending
// within it), so the kernels and the plain version agree exactly.
//
// Bound: memory. Each stream key is read once and each pair written
// once; a lookup touches one table sector and one key sector (more on a
// collision), which stay in L2 for a small build side. Grid-stride
// loops, 256 threads a block, one thread a stream row; a skewed key's many pairs fall to one thread (a later PR's
// warp-cooperative emit).
#include <cuda_runtime.h>
#include <stdint.h>

#include "join_match_row.cuh"

namespace {

constexpr int kThreads = 256;

struct DeviceCas {
  __host__ __device__ int32_t operator()(int32_t* slot, int32_t u) const {
#ifdef __CUDA_ARCH__
    return atomicCAS(slot, -1, u);
#else
    return *slot;  // the host pass never runs a kernel body
#endif
  }
};

int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < (1 << 20) ? (blocks > 0 ? blocks : 1) : (1 << 20));
}

__global__ void join_match_build_kernel(const int64_t* __restrict__ ukeys,
                                        int64_t U, int W, int32_t* table,
                                        int64_t mask) {
  for (int64_t u = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; u < U;
       u += (int64_t)gridDim.x * blockDim.x)
    jm_insert(table, mask, ukeys + u * W, W, (int32_t)u, DeviceCas());
}

__global__ void join_match_probe_kernel(
    const int64_t* __restrict__ skeys, const uint8_t* __restrict__ snull,
    int64_t n, int W, const int32_t* __restrict__ table, int64_t mask,
    const int64_t* __restrict__ ukeys, const int64_t* __restrict__ ucount,
    int32_t* __restrict__ uid, int64_t* __restrict__ count,
    uint8_t* __restrict__ matched) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    int32_t u;
    count[i] = jm_probe_row(skeys + i * W, snull[i] != 0, W, table, mask,
                            ukeys, ucount, &u);
    uid[i] = u;
    if (matched != nullptr && u >= 0) matched[u] = 1;
  }
}

__global__ void join_match_emit_kernel(
    const int64_t* __restrict__ offsets, const int64_t* __restrict__ count,
    const int32_t* __restrict__ uid, const int64_t* __restrict__ ustart,
    const int64_t* __restrict__ sorted_rows, int64_t n, int outer,
    int64_t* __restrict__ out_s, int64_t* __restrict__ out_b) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    jm_emit_row(i, offsets[i], count[i], uid[i], ustart, sorted_rows,
                outer != 0, out_s, out_b);
}

}  // namespace

extern "C" int join_match_build(const int64_t* ukeys, int64_t U, int W,
                                int32_t* table, int64_t capacity,
                                void* stream) {
  if (U > 0)
    join_match_build_kernel<<<grid_for(U), kThreads, 0,
                              (cudaStream_t)stream>>>(ukeys, U, W, table,
                                                      capacity - 1);
  return (int)cudaGetLastError();
}

extern "C" int join_match_probe(const int64_t* skeys, const uint8_t* snull,
                                int64_t n, int W, const int32_t* table,
                                int64_t capacity, const int64_t* ukeys,
                                const int64_t* ucount, int32_t* uid,
                                int64_t* count, uint8_t* matched,
                                void* stream) {
  if (n > 0)
    join_match_probe_kernel<<<grid_for(n), kThreads, 0,
                              (cudaStream_t)stream>>>(
        skeys, snull, n, W, table, capacity - 1, ukeys, ucount, uid, count,
        matched);
  return (int)cudaGetLastError();
}

extern "C" int join_match_emit(const int64_t* offsets, const int64_t* count,
                               const int32_t* uid, const int64_t* ustart,
                               const int64_t* sorted_rows, int64_t n,
                               int outer, int64_t* out_s, int64_t* out_b,
                               void* stream) {
  if (n > 0)
    join_match_emit_kernel<<<grid_for(n), kThreads, 0,
                             (cudaStream_t)stream>>>(
        offsets, count, uid, ustart, sorted_rows, n, outer, out_s, out_b);
  return (int)cudaGetLastError();
}
