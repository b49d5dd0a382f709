// The per-row logic of the sort_bucket kernel (csrc/sort_bucket.cu): a
// row's bucket in the out-of-core sample sort, found by a binary search
// over the splitters.
// Everything here is __host__ __device__, so g++ builds it on a machine
// without CUDA and the tests hold it to the plain version
// (tests/test_torch_sort_ooc.py).
//
// A row's sort key is its K encoded sort operands in order
// (exec/encoding.py ``order_key_operands``: each order's null rank, then
// its key), each a column of its own width: operand k is the vector at
// ops.ptr[k] of the element type ops.type[k], read at row i and widened
// to int64 (uint8 zero-extended, the signed types sign-extended, so the
// widened values keep the operands' order); a row's first SB_CACHED
// operands are read once, into registers, the rest only at the compares
// that reach them. The S splitters are keys of the same operands
// widened to int64, sorted ascending, operand by operand in ``sp``:
// word k of splitter s at sp[k * S + s]. A row's
// bucket is the number of splitters lexicographically <= its key (the
// reference's ``_bucket_id_kernel``, spark_rapids_tpu/exec/sort.py:164);
// a padding row (i >= num_rows) goes to bucket S + 1.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define SB_HD __host__ __device__ __forceinline__
#else
#define SB_HD inline
#endif

// Operand element types (exec/sort_bucket.py _TYPES)
enum SbType { SB_U8 = 0, SB_I8 = 1, SB_I16 = 2, SB_I32 = 3, SB_I64 = 4 };

// Operands a launch takes (exec/sort_bucket.py MAX_OPERANDS)
#define SB_MAX_OPERANDS 32

// The operands' vectors and element types, passed to the kernel by value.
struct SbOperands {
  const void* ptr[SB_MAX_OPERANDS];
  int32_t type[SB_MAX_OPERANDS];
};

// Operand k of row i, widened to int64.
SB_HD int64_t sb_load(const SbOperands& ops, int k, int64_t i) {
  const void* p = ops.ptr[k];
  switch (ops.type[k]) {
    case SB_U8:
      return ((const uint8_t*)p)[i];
    case SB_I8:
      return ((const int8_t*)p)[i];
    case SB_I16:
      return ((const int16_t*)p)[i];
    case SB_I32:
      return ((const int32_t*)p)[i];
    default:
      return ((const int64_t*)p)[i];
  }
}

// Operands of a row read once, into registers, before the search (the
// search's first steps are decided by the first operands; the rest are
// read at the compares that reach them)
#define SB_CACHED 4

// A row's first SB_CACHED operands, widened (0 past K).
struct SbRow {
  int64_t v[SB_CACHED];
};

SB_HD SbRow sb_row(const SbOperands& ops, int K, int64_t i) {
  SbRow r;
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int k = 0; k < SB_CACHED; ++k)
    r.v[k] = k < K ? sb_load(ops, k, i) : 0;
  return r;
}

// Word k of splitter s (``sp`` int64 [K][S]), through the card's
// read-only cache.
SB_HD int64_t sb_word(const int64_t* sp, int S, int k, int s) {
#ifdef __CUDA_ARCH__
  return __ldg(sp + (int64_t)k * S + s);
#else
  return sp[(int64_t)k * S + s];
#endif
}

// Whether splitter s is lexicographically <= row i (its first operands
// in ``r``).
SB_HD bool sb_splitter_le_row(const int64_t* sp, int S, int K, int s,
                              const SbOperands& ops, const SbRow& r,
                              int64_t i) {
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int k = 0; k < SB_CACHED; ++k) {
    if (k >= K) return true;
    const int64_t a = sb_word(sp, S, k, s);
    if (a != r.v[k]) return a < r.v[k];
  }
  for (int k = SB_CACHED; k < K; ++k) {
    const int64_t a = sb_word(sp, S, k, s), b = sb_load(ops, k, i);
    if (a != b) return a < b;
  }
  return true;
}

// Row i's bucket (its first operands in ``r``): the first splitter
// greater than the row (an upper bound over the sorted splitters), S + 1
// for a padding row.
SB_HD int32_t sb_search(const int64_t* sp, int S, int K,
                        const SbOperands& ops, const SbRow& r, int64_t i,
                        int64_t num_rows) {
  if (i >= num_rows) return S + 1;
  int lo = 0, hi = S;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sb_splitter_le_row(sp, S, K, mid, ops, r, i))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Row i's bucket, its operands read here.
SB_HD int32_t sb_bucket(const int64_t* sp, int S, int K,
                        const SbOperands& ops, int64_t i,
                        int64_t num_rows) {
  SbRow r = {};
  if (i < num_rows) r = sb_row(ops, K, i);
  return sb_search(sp, S, K, ops, r, i, num_rows);
}
