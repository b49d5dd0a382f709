// decimal_arith: Spark's decimal add, subtract, remainder, multiply,
// divide, rescale and average, and the cast of a decimal to double, over
// decimals held as their unscaled values in int64 lanes, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the reference computes decimals in int64 lanes
// with jnp (spark_rapids_tpu/exprs/arithmetic.py Add/Multiply/Divide over
// the promoted int64 operands, exprs/aggregates.py Sum/Average), which
// wraps where a product, a scaled dividend or an operand rescaled to the
// larger scale passes 2^63. Torch has no int128; a decimal(15,2) by
// decimal(16,2) product, a dividend scaled up by Spark's result scale, or
// a decimal(38,0) plus a decimal(38,10), needs 128-bit intermediates even
// where the result fits int64. This is the work of spark-rapids' DecimalUtils JNI kernels
// (SURVEY.md 2.12).
//
// Bound: on q1's shapes, memory. A row reads its two int64 operands and
// their validity bytes (18 bytes; 34 with the average's four operands)
// and writes its int64 result and validity (9 bytes). A division over
// 128 bits takes up to 128 steps of a few 64-bit instructions: where the
// operands need it, integer operations bound it; chip_smoke.py counts
// them beside the bytes.
//
// Design: a thread a row, 256 threads a block, a block for every 256
// rows; each operand vector is read coalesced, once. The function is a
// template parameter, so a launch runs one straight-line body. A 128-bit
// division by a value that fits 64 bits, of a value that fits 64 bits, is
// one hardware division; the rest is restoring division over the
// dividend's bits (csrc/decimal_arith_row.cuh, which the CPU tests build
// with g++).
#include <cuda_runtime.h>
#include <stdint.h>

#include "decimal_arith_row.cuh"

namespace {

constexpr int kThreads = 256;

template <int OP>
__global__ void decimal_arith_kernel(const int64_t* __restrict__ a,
                                     const int64_t* __restrict__ b,
                                     const int64_t* __restrict__ c,
                                     const int64_t* __restrict__ d,
                                     const uint8_t* __restrict__ av,
                                     const uint8_t* __restrict__ bv,
                                     int64_t n, int k, int t, int m, int p,
                                     int64_t* __restrict__ out,
                                     uint8_t* __restrict__ out_valid) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool ok = av[i] != 0 && (bv == nullptr || bv[i] != 0);
  int64_t r = 0;
  if (ok) {
    const int64_t x = a[i];
    const int64_t y = b != nullptr ? b[i] : 0;
    const int64_t z = c != nullptr ? c[i] : 0;
    const int64_t w = d != nullptr ? d[i] : 0;
    ok = da_row(OP, x, y, z, w, k, t, m, p, &r);
    if (!ok) r = 0;
  }
  out[i] = r;
  out_valid[i] = ok ? 1 : 0;
}

template <int OP>
cudaError_t launch(const int64_t* a, const int64_t* b, const int64_t* c,
                   const int64_t* d, const uint8_t* av, const uint8_t* bv,
                   int64_t n, int k, int t, int m, int p, int64_t* out,
                   uint8_t* out_valid, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  decimal_arith_kernel<OP><<<(unsigned)blocks, kThreads, 0, stream>>>(
      a, b, c, d, av, bv, n, k, t, m, p, out, out_valid);
  return cudaGetLastError();
}

}  // namespace

// One launch on ``stream`` of function ``op`` (DaOp) over rows 0..n-1:
// operands a (and b, c, d where the function takes them, else null),
// validity av (and bv, or null), constants k, t, m, p; out[i] the int64
// result (the double's bits for DA_TO_DOUBLE), out_valid[i] its
// validity. Returns the launch's CUDA error (0 on success).
extern "C" int decimal_arith_launch(int op, const int64_t* a,
                                    const int64_t* b, const int64_t* c,
                                    const int64_t* d, const uint8_t* av,
                                    const uint8_t* bv, int64_t n, int k,
                                    int t, int m, int p, int64_t* out,
                                    uint8_t* out_valid, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case DA_MUL:
      return (int)launch<DA_MUL>(a, b, c, d, av, bv, n, k, t, m, p, out,
                                 out_valid, s);
    case DA_DIV:
      return (int)launch<DA_DIV>(a, b, c, d, av, bv, n, k, t, m, p, out,
                                 out_valid, s);
    case DA_RESCALE:
      return (int)launch<DA_RESCALE>(a, b, c, d, av, bv, n, k, t, m, p, out,
                                     out_valid, s);
    case DA_AVG:
      return (int)launch<DA_AVG>(a, b, c, d, av, bv, n, k, t, m, p, out,
                                 out_valid, s);
    case DA_TO_DOUBLE:
      return (int)launch<DA_TO_DOUBLE>(a, b, c, d, av, bv, n, k, t, m, p, out,
                                       out_valid, s);
    case DA_ADD:
      return (int)launch<DA_ADD>(a, b, c, d, av, bv, n, k, t, m, p, out,
                                 out_valid, s);
    case DA_SUB:
      return (int)launch<DA_SUB>(a, b, c, d, av, bv, n, k, t, m, p, out,
                                 out_valid, s);
    case DA_REM:
      return (int)launch<DA_REM>(a, b, c, d, av, bv, n, k, t, m, p, out,
                                 out_valid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Registers a thread of the multiply's and the division's instances, and
// threads a block.
extern "C" int decimal_arith_describe(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr,
                                          decimal_arith_kernel<DA_MUL>);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  err = cudaFuncGetAttributes(&attr, decimal_arith_kernel<DA_DIV>);
  if (err != cudaSuccess) return (int)err;
  out[1] = attr.numRegs;
  out[2] = kThreads;
  return 0;
}
