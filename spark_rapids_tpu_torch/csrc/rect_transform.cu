// rect_transform: a chain of string transforms (upper, lower, initcap,
// trim, substring, replace, lpad/rpad, substring_index, reverse) over
// every row of an ASCII byte rectangle, for an NVIDIA H100 (sm_90a).
//
// Replaces the jitted jax.numpy transforms of the JAX package's
// spark_rapids_tpu/exprs/string_rect.py (_upper :74, _lower :80, _trim
// :86, _substring :111, _replace :222, _pad :263, _substring_index :363,
// _reverse :389), which it fuses into one XLA kernel a chain
// (exprs/compiler.py:compile_rect_chain :478). They are not Pallas
// kernels; in eager PyTorch one upper(trim(s)) is dozens of launches a
// batch (the realign alone is W masked shifts), so this kernel takes the
// whole chain in one launch a batch.
//
// Bound: bytes. Each input byte is read once (P * W, 4P of lengths, P of
// validity) and each output byte written once (P * Wo, 4P of lengths);
// the ops themselves are a few integer operations a byte. The strings
// rung's batch (1,048,576 rows, W = 32, upper(trim(s)) keeping Wo = 32)
// moves 76,546,048 bytes: 0.0228 ms at 3.35 TB/s.
//
// Design: a block of 256 threads owns a tile of 256 rows, one row a
// thread. The block copies the tile (contiguous in device memory) into
// shared memory with coalesced 8-byte loads, rows 68 bytes apart so
// that a warp reading byte j of its 32 rows hits 32 banks. Each thread
// then runs the chain over its row between two shared-memory buffers
// (rect_transform_row.cuh: each op reads one and writes the other), and
// the block writes the final buffer back with coalesced 8-byte stores;
// each thread writes its row's length. A row's bytes are indexed at run
// time, which in registers or a per-thread array would put them in local
// memory; in shared memory they cost no stack frame and no spill. The
// chain (at most 8 ops with their literals) is a __grid_constant__
// parameter copied into shared memory once a block. The per-row loops
// are sequential over the row's bytes: simple first, a warp a row with
// ballots and shuffles would be the faster design.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "rect_transform_row.cuh"

__global__ void __launch_bounds__(kRtTileRows)
    rect_transform_kernel(const uint8_t* __restrict__ bytes,
                          const int32_t* __restrict__ lengths,
                          const bool* __restrict__ validity, int64_t rows,
                          int w_in, int w_out, uint8_t* __restrict__ out,
                          int32_t* __restrict__ out_len,
                          const __grid_constant__ RtChain chain) {
  __shared__ RtOp ops[kRtMaxOps];
  __shared__ __align__(16) uint8_t buf[2][kRtTileRows * kRtRowStride];
  const int n_ops = chain.n_ops;
  {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(chain.ops);
    uint32_t* dst = reinterpret_cast<uint32_t*>(ops);
    const int words = n_ops * (int)(sizeof(RtOp) / 4);
    for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = src[i];
  }
  const int64_t row0 = (int64_t)blockIdx.x * kRtTileRows;
  const int64_t left = rows - row0;
  const int tile = left < kRtTileRows ? (int)left : kRtTileRows;

  // the tile in: tile * w_in contiguous bytes as 8-byte words
  const int in_words = w_in / 8;
  const uint2* src = reinterpret_cast<const uint2*>(bytes + row0 * w_in);
  for (int c = threadIdx.x; c < tile * in_words; c += blockDim.x) {
    const uint2 v = src[c];
    const int r = c / in_words;
    const int k = c - r * in_words;
    uint32_t* d =
        reinterpret_cast<uint32_t*>(&buf[0][r * kRtRowStride + k * 8]);
    d[0] = v.x;
    d[1] = v.y;
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t < tile) {
    const int64_t row = row0 + t;
    const int n = rt_row_chain(ops, n_ops, &buf[0][t * kRtRowStride],
                               &buf[1][t * kRtRowStride], lengths[row],
                               validity[row]);
    out_len[row] = n;
  }
  __syncthreads();

  // the tile out, from the buffer the last op wrote
  const uint8_t* fin = buf[n_ops & 1];
  const int out_words = w_out / 8;
  uint2* dst = reinterpret_cast<uint2*>(out + row0 * w_out);
  for (int c = threadIdx.x; c < tile * out_words; c += blockDim.x) {
    const int r = c / out_words;
    const int k = c - r * out_words;
    const uint32_t* s =
        reinterpret_cast<const uint32_t*>(&fin[r * kRtRowStride + k * 8]);
    dst[c] = make_uint2(s[0], s[1]);
  }
}

// sizeof(RtChain): the wrapper checks that its packing agrees.
extern "C" int rect_transform_chain_bytes() { return (int)sizeof(RtChain); }

// One launch on `stream` (PyTorch's current stream); returns
// cudaGetLastError(). `chain` points to an RtChain in host memory, passed
// to the kernel by value. bytes must be 8-byte aligned; w_in and w_out
// multiples of 8 up to kRtMaxWidth; out is rows * w_out bytes.
extern "C" int rect_transform_launch(const void* bytes, const void* lengths,
                                     const void* validity, int64_t rows,
                                     int w_in, int w_out, const void* chain,
                                     void* out, void* out_len,
                                     void* stream) {
  RtChain c;
  memcpy(&c, chain, sizeof(RtChain));
  if (rows <= 0) return 0;
  if (c.n_ops < 1 || c.n_ops > kRtMaxOps || w_in % 8 || w_out % 8 ||
      w_in < 8 || w_out < 8 || w_in > kRtMaxWidth || w_out > kRtMaxWidth)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((rows + kRtTileRows - 1) / kRtTileRows);
  rect_transform_kernel<<<grid, kRtTileRows, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(bytes),
      static_cast<const int32_t*>(lengths),
      static_cast<const bool*>(validity), rows, w_in, w_out,
      static_cast<uint8_t*>(out), static_cast<int32_t*>(out_len), c);
  return (int)cudaGetLastError();
}
