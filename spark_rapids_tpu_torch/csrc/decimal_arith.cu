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
// What bounds it on an H100: a row reads its int64 operands and their
// validity bytes once (18 bytes for two operands, 9 for one, 34 for the
// average's four) and writes its int64 result and validity once (9
// bytes); nothing is read twice, so there is no reuse for shared memory
// or TMA to stage, and no matrix product for wgmma. mul, rescale, add
// and to_double are bound by those HBM bytes. The divisions (div, rem,
// avg) are bound by the integer pipe (64 lanes an SM a clock: every
// IMAD, IADD3, ISETP and SEL of the 128-bit arithmetic): a reciprocal of
// the row's divisor and a 2-by-1 step or two a row; avg, with three
// steps, stays above the bytes (PERF.md section 6 has the times and the
// variants of chip_variants.py that split them).
//
// Design: the host computes a launch's powers of ten and the reciprocals
// of those it divides by once (da_consts) and passes them by value, a
// __grid_constant__ struct read from the constant bank; no thread loops
// over digits, and no thread runs a software division: every quotient is
// a multiply-high by a reciprocal with at most two corrections
// (csrc/decimal_arith_row.cuh, which the CPU tests build with g++). A
// thread takes kRows = 2 consecutive rows: each int64 operand as one
// 16-byte load (a warp's 512 contiguous bytes), each validity vector as
// one 2-byte word, the results as one 16-byte and one 2-byte store; the
// row past the last pair goes to a thread alone. Four rows a thread (two
// 16-byte loads 32 bytes apart) and one were slower at 1,048,576 rows.
// The grid is two waves of the blocks the 132 SMs hold at once; a thread
// loops over its pairs with the next pair's loads in flight while it
// computes one. Views whose pointers are not 16-byte (the int64 vectors)
// or 2-byte (validity) aligned take the scalar instance, a row a thread.
// The function is a template parameter, so a launch runs one
// straight-line body.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decimal_arith_row.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 2;
// Waves of resident blocks a launch's grid may take before its threads
// loop over more rows
constexpr int kWaves = 2;

// Operands of each function
template <int OP>
struct Arity {
  static constexpr int n = OP == DA_AVG ? 4
                           : (OP == DA_RESCALE || OP == DA_TO_DOUBLE) ? 1
                                                                      : 2;
};

// Row i alone: its validity and result
template <int OP>
__device__ __forceinline__ void one_row(
    const int64_t* __restrict__ a, const int64_t* __restrict__ b,
    const int64_t* __restrict__ c, const int64_t* __restrict__ d,
    const uint8_t* __restrict__ av, const uint8_t* __restrict__ bv,
    int64_t i, const DaConsts& k, int64_t* __restrict__ out,
    uint8_t* __restrict__ out_valid) {
  constexpr int kOps = Arity<OP>::n;
  int64_t r = 0;
  bool ok = av[i] != 0 && (bv == nullptr || bv[i] != 0);
  ok = da_row_c(OP, k, a[i], kOps > 1 ? b[i] : 0, kOps > 2 ? c[i] : 0,
                kOps > 3 ? d[i] : 0, &r) && ok;
  out[i] = ok ? r : 0;
  out_valid[i] = ok ? 1 : 0;
}

// A validity word: kRows bytes, one a row
template <int R>
struct Word;
template <>
struct Word<1> { typedef uint8_t T; };
template <>
struct Word<2> { typedef uint16_t T; };
template <>
struct Word<4> { typedef uint32_t T; };
typedef Word<kRows>::T ValidWord;

// Rows kRows g .. kRows g + kRows - 1 of one operand: 16-byte loads
__device__ __forceinline__ void load_rows(const int64_t* __restrict__ p,
                                          int64_t g, int64_t* x) {
  if (kRows == 1) {
    x[0] = __ldg(p + g);
    return;
  }
  const longlong2* q = reinterpret_cast<const longlong2*>(p) + kRows / 2 * g;
#pragma unroll
  for (int h = 0; h < kRows / 2; ++h) {
    const longlong2 v = __ldg(q + h);
    x[2 * h] = v.x;
    x[2 * h + 1] = v.y;
  }
}

// One group of kRows rows: the operands a function takes and both
// validity words (a missing second validity reads as all valid)
template <int OPS>
struct Group {
  int64_t x[4][kRows];
  ValidWord va, vb;

  __device__ __forceinline__ void load(
      const int64_t* __restrict__ a, const int64_t* __restrict__ b,
      const int64_t* __restrict__ c, const int64_t* __restrict__ d,
      const uint8_t* __restrict__ av, const uint8_t* __restrict__ bv,
      int64_t g) {
    load_rows(a, g, x[0]);
#pragma unroll
    for (int j = 0; j < kRows; ++j) x[1][j] = x[2][j] = x[3][j] = 0;
    if (OPS > 1) load_rows(b, g, x[1]);
    if (OPS > 2) load_rows(c, g, x[2]);
    if (OPS > 3) load_rows(d, g, x[3]);
    va = __ldg(reinterpret_cast<const ValidWord*>(av) + g);
    vb = bv != nullptr ? __ldg(reinterpret_cast<const ValidWord*>(bv) + g)
                       : (ValidWord)0x0101010101010101ull;
  }
};

template <int OP, bool VEC>
__global__ void __launch_bounds__(kThreads) decimal_arith_kernel(
    const int64_t* __restrict__ a, const int64_t* __restrict__ b,
    const int64_t* __restrict__ c, const int64_t* __restrict__ d,
    const uint8_t* __restrict__ av, const uint8_t* __restrict__ bv,
    int64_t n, const __grid_constant__ DaConsts k,
    int64_t* __restrict__ out, uint8_t* __restrict__ out_valid) {
  constexpr int kOps = Arity<OP>::n;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  if (!VEC) {
    for (int64_t i = tid; i < n; i += stride)
      one_row<OP>(a, b, c, d, av, bv, i, k, out, out_valid);
    return;
  }
  const int64_t groups = n / kRows;
  Group<kOps> cur;
  if (tid < groups) cur.load(a, b, c, d, av, bv, tid);
  for (int64_t g = tid; g < groups; g += stride) {
    // the next group's loads are in flight while this one computes
    Group<kOps> next;
    if (g + stride < groups) next.load(a, b, c, d, av, bv, g + stride);
    int64_t r[kRows];
    ValidWord ok = 0;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      int64_t v = 0;
      const bool row_ok =
          da_row_c(OP, k, cur.x[0][j], cur.x[1][j], cur.x[2][j],
                   cur.x[3][j], &v) &&
          ((cur.va >> (8 * j)) & 0xff) != 0 &&
          ((cur.vb >> (8 * j)) & 0xff) != 0;
      r[j] = row_ok ? v : 0;
      ok |= (ValidWord)row_ok << (8 * j);
    }
    if (kRows == 1) {
      out[g] = r[0];
    } else {
      longlong2* o = reinterpret_cast<longlong2*>(out) + kRows / 2 * g;
#pragma unroll
      for (int h = 0; h < kRows / 2; ++h)
        o[h] = make_longlong2(r[2 * h], r[2 * h + 1]);
    }
    reinterpret_cast<ValidWord*>(out_valid)[g] = ok;
    cur = next;
  }
  const int64_t tail = n - groups * kRows;
  if (tid < tail)
    one_row<OP>(a, b, c, d, av, bv, groups * kRows + tid, k, out, out_valid);
}

template <int OP, bool VEC>
cudaError_t launch(const int64_t* a, const int64_t* b, const int64_t* c,
                   const int64_t* d, const uint8_t* av, const uint8_t* bv,
                   int64_t n, const DaConsts& k, int64_t* out,
                   uint8_t* out_valid, cudaStream_t stream) {
  // blocks an SM holds of this instance, found once
  static const int per_sm = [] {
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, decimal_arith_kernel<OP, VEC>, kThreads, 0) !=
        cudaSuccess)
      blocks = 1;
    return blocks > 0 ? blocks : 1;
  }();
  int dev = 0, sms = 132;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t units = VEC ? (n + kRows - 1) / kRows : n;
  int64_t blocks = (units + kThreads - 1) / kThreads;
  if (blocks > (int64_t)sms * per_sm * kWaves)
    blocks = (int64_t)sms * per_sm * kWaves;
  decimal_arith_kernel<OP, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      a, b, c, d, av, bv, n, k, out, out_valid);
  return cudaGetLastError();
}

template <int OP>
cudaError_t launch_op(const int64_t* a, const int64_t* b, const int64_t* c,
                      const int64_t* d, const uint8_t* av, const uint8_t* bv,
                      int64_t n, int k, int t, int m, int p, int64_t* out,
                      uint8_t* out_valid, cudaStream_t stream) {
  const DaConsts consts = da_consts(OP, k, t, m, p);
  auto at = [](const void* ptr, uintptr_t align) {
    return ((uintptr_t)ptr & (align - 1)) == 0;
  };
  const uintptr_t wide = kRows > 1 ? 16 : 8;
  const bool vec = at(a, wide) && at(b, wide) && at(c, wide) &&
                   at(d, wide) && at(out, wide) && at(av, kRows) &&
                   at(bv, kRows) && at(out_valid, kRows);
  return vec ? launch<OP, true>(a, b, c, d, av, bv, n, consts, out,
                                out_valid, stream)
             : launch<OP, false>(a, b, c, d, av, bv, n, consts, out,
                                 out_valid, stream);
}

template <int OP>
cudaError_t registers(int* vec, int* scalar) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr,
                                          decimal_arith_kernel<OP, true>);
  if (err != cudaSuccess) return err;
  *vec = attr.numRegs;
  err = cudaFuncGetAttributes(&attr, decimal_arith_kernel<OP, false>);
  if (err != cudaSuccess) return err;
  *scalar = attr.numRegs;
  return cudaSuccess;
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
      return (int)launch_op<DA_MUL>(a, b, c, d, av, bv, n, k, t, m, p, out,
                                    out_valid, s);
    case DA_DIV:
      return (int)launch_op<DA_DIV>(a, b, c, d, av, bv, n, k, t, m, p, out,
                                    out_valid, s);
    case DA_RESCALE:
      return (int)launch_op<DA_RESCALE>(a, b, c, d, av, bv, n, k, t, m, p,
                                        out, out_valid, s);
    case DA_AVG:
      return (int)launch_op<DA_AVG>(a, b, c, d, av, bv, n, k, t, m, p, out,
                                    out_valid, s);
    case DA_TO_DOUBLE:
      return (int)launch_op<DA_TO_DOUBLE>(a, b, c, d, av, bv, n, k, t, m, p,
                                          out, out_valid, s);
    case DA_ADD:
      return (int)launch_op<DA_ADD>(a, b, c, d, av, bv, n, k, t, m, p, out,
                                    out_valid, s);
    case DA_SUB:
      return (int)launch_op<DA_SUB>(a, b, c, d, av, bv, n, k, t, m, p, out,
                                    out_valid, s);
    case DA_REM:
      return (int)launch_op<DA_REM>(a, b, c, d, av, bv, n, k, t, m, p, out,
                                    out_valid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Registers a thread of every function's instances: out[op] the vector
// instance's (kRows rows a thread), out[8 + op] the scalar instance's (op
// a DaOp); out[16] threads a block, out[17] rows a thread.
extern "C" int decimal_arith_describe(int* out) {
  cudaError_t err = registers<DA_MUL>(out + DA_MUL, out + 8 + DA_MUL);
  if (err == cudaSuccess)
    err = registers<DA_DIV>(out + DA_DIV, out + 8 + DA_DIV);
  if (err == cudaSuccess)
    err = registers<DA_RESCALE>(out + DA_RESCALE, out + 8 + DA_RESCALE);
  if (err == cudaSuccess)
    err = registers<DA_AVG>(out + DA_AVG, out + 8 + DA_AVG);
  if (err == cudaSuccess)
    err = registers<DA_TO_DOUBLE>(out + DA_TO_DOUBLE, out + 8 + DA_TO_DOUBLE);
  if (err == cudaSuccess)
    err = registers<DA_ADD>(out + DA_ADD, out + 8 + DA_ADD);
  if (err == cudaSuccess)
    err = registers<DA_SUB>(out + DA_SUB, out + 8 + DA_SUB);
  if (err == cudaSuccess)
    err = registers<DA_REM>(out + DA_REM, out + 8 + DA_REM);
  if (err != cudaSuccess) return (int)err;
  out[16] = kThreads;
  out[17] = kRows;
  return 0;
}
