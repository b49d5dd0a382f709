// Per-row logic of the string transform chain over a byte rectangle,
// shared by the CUDA kernel (rect_transform.cu) and a host build: outside
// nvcc the two function qualifiers are defined empty, so g++ compiles and
// tests the same code (tests/test_torch_strings.py).
//
// A row is `w_in` bytes of which the first `len` are the string; every op
// reads only bytes below the row's length, so what lies past it (in the
// kernel, stale shared memory) is never read. Each op writes all `w_out`
// bytes of its output row, zero past the new length. The ops and their
// arguments (RtOp) are those of exec/rect_transform.py's chain:
//   UPPER, LOWER, INITCAP, REVERSE    no arguments
//   TRIM              a = left, b = right (space 0x20 only)
//   SUBSTRING         a = pos (Spark's: 1-based, 0 as 1, negative from
//                     the end), b = length when c != 0
//   REPLACE           lit1 = search (n1 >= 1), lit2 = replacement (n2)
//   PAD               a = length (>= 1), b = left, lit1 = pad (n1 >= 1)
//   SUBSTRING_INDEX   lit1 = delimiter (n1 >= 1), a = count; every match
//                     counts, overlapping ones too (Spark's search starts
//                     one byte past the last match)
// The host computes each op's output width before the launch (w_out);
// the width rules guarantee that every output fits it.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define RT_INLINE inline
#else
// inlined into the kernel, so that no pointer or loop needs a stack frame
#define RT_INLINE __forceinline__
#endif

enum RtOpCode {
  RT_UPPER = 1,
  RT_LOWER = 2,
  RT_TRIM = 3,
  RT_SUBSTRING = 4,
  RT_REPLACE = 5,
  RT_PAD = 6,
  RT_SUBSTRING_INDEX = 7,
  RT_REVERSE = 8,
  RT_INITCAP = 9,
};

constexpr int kRtMaxOps = 8;       // ops a launch takes
constexpr int kRtMaxLiteral = 32;  // bytes of one literal
constexpr int kRtMaxWidth = 64;    // widest row, in or out
constexpr int kRtTileRows = 256;   // rows of a block's tile, one a thread
// Bytes between two rows of a tile in shared memory: 17 words, odd, so
// that the 32 threads of a warp reading byte j of their rows hit 32
// distinct banks.
constexpr int kRtRowStride = kRtMaxWidth + 4;

struct RtOp {
  int32_t code;
  int32_t a, b, c;
  int32_t w_in, w_out;
  int32_t n1, n2;
  uint8_t lit1[kRtMaxLiteral];
  uint8_t lit2[kRtMaxLiteral];
};

struct RtChain {
  int32_t n_ops;
  int32_t reserved[3];
  RtOp ops[kRtMaxOps];
};

RT_INLINE __host__ __device__ uint8_t rt_upper(uint8_t c) {
  return (c >= 'a' && c <= 'z') ? (uint8_t)(c - 32) : c;
}

RT_INLINE __host__ __device__ uint8_t rt_lower(uint8_t c) {
  return (c >= 'A' && c <= 'Z') ? (uint8_t)(c + 32) : c;
}

// The n-byte literal `lit` starts at byte i of the row and ends within its
// length.
RT_INLINE __host__ __device__ bool rt_match_at(const uint8_t* in, int len,
                                               int i, const uint8_t* lit,
                                               int n) {
  if (i + n > len) return false;
  for (int k = 0; k < n; ++k)
    if (in[i + k] != lit[k]) return false;
  return true;
}

// out[j] = in[start + j] for j < n, zero up to w_out.
RT_INLINE __host__ __device__ void rt_copy_from(const uint8_t* in, int start,
                                                int n, uint8_t* out,
                                                int w_out) {
  for (int j = 0; j < w_out; ++j) out[j] = j < n ? in[start + j] : 0;
}

// One op over one row: writes out[0, op.w_out), returns the new length.
RT_INLINE __host__ __device__ int rt_apply(const RtOp& op, const uint8_t* in,
                                           int len, uint8_t* out) {
  const int w_out = op.w_out;
  switch (op.code) {
    case RT_UPPER:
    case RT_LOWER:
    case RT_INITCAP: {
      uint8_t prev = ' ';
      for (int j = 0; j < w_out; ++j) {
        uint8_t c = j < len ? in[j] : 0;
        uint8_t o = c;
        if (op.code == RT_UPPER) {
          o = rt_upper(c);
        } else if (op.code == RT_LOWER) {
          o = rt_lower(c);
        } else {
          o = prev == ' ' ? rt_upper(c) : rt_lower(c);
        }
        out[j] = o;
        prev = c;
      }
      return len;
    }
    case RT_REVERSE:
      for (int j = 0; j < w_out; ++j) out[j] = j < len ? in[len - 1 - j] : 0;
      return len;
    case RT_TRIM: {
      int lead = 0, trail = 0;
      if (op.a)
        while (lead < len && in[lead] == ' ') ++lead;
      if (op.b)
        while (trail < len - lead && in[len - 1 - trail] == ' ') ++trail;
      const int n = len - lead - trail;
      rt_copy_from(in, lead, n, out, w_out);
      return n;
    }
    case RT_SUBSTRING: {
      int64_t start = op.a > 0 ? op.a - 1 : (op.a < 0 ? (int64_t)len + op.a
                                                       : 0);
      int64_t end = op.c ? start + op.b : (int64_t)len;
      if (start < 0) start = 0;
      if (end > len) end = len;
      const int n = end > start ? (int)(end - start) : 0;
      rt_copy_from(in, (int)start, n, out, w_out);
      return n;
    }
    case RT_REPLACE: {
      int o = 0;
      for (int i = 0; i < len;) {
        if (rt_match_at(in, len, i, op.lit1, op.n1)) {
          for (int k = 0; k < op.n2; ++k)
            if (o + k < w_out) out[o + k] = op.lit2[k];
          o += op.n2;
          i += op.n1;
        } else {
          if (o < w_out) out[o] = in[i];
          ++o;
          ++i;
        }
      }
      if (o > w_out) o = w_out;
      for (int j = o; j < w_out; ++j) out[j] = 0;
      return o;
    }
    case RT_PAD: {
      const int length = op.a;
      if (len >= length) {
        rt_copy_from(in, 0, length, out, w_out);
      } else if (op.b) {
        const int shift = length - len;
        for (int j = 0; j < w_out; ++j)
          out[j] = j < shift ? op.lit1[j % op.n1]
                             : (j < length ? in[j - shift] : 0);
      } else {
        for (int j = 0; j < w_out; ++j)
          out[j] = j < len ? in[j]
                           : (j < length ? op.lit1[(j - len) % op.n1] : 0);
      }
      return length;
    }
    case RT_SUBSTRING_INDEX: {
      const int count = op.a;
      int start = 0, n = 0;
      if (count > 0) {
        int seen = 0;
        n = len;
        for (int i = 0; i < len; ++i) {
          if (rt_match_at(in, len, i, op.lit1, op.n1) && ++seen == count) {
            n = i;
            break;
          }
        }
      } else if (count < 0) {
        int seen = 0;
        for (int i = len - op.n1; i >= 0; --i) {
          if (rt_match_at(in, len, i, op.lit1, op.n1) && --seen == count) {
            start = i + op.n1;
            break;
          }
        }
        n = len - start;
      }
      rt_copy_from(in, start, n, out, w_out);
      return n;
    }
    default:
      break;
  }
  for (int j = 0; j < w_out; ++j) out[j] = 0;
  return 0;
}

// The whole chain over one row held in `a` (its first `len` bytes), with
// `b` as the other buffer: each op reads one and writes the other, so the
// result lies in `a` for an even number of ops and in `b` for an odd one.
// An invalid row gives all zeros and length 0.
RT_INLINE __host__ __device__ int rt_row_chain(const RtOp* ops, int n_ops,
                                               uint8_t* a, uint8_t* b,
                                               int len, bool valid) {
  if (!valid) {
    uint8_t* fin = (n_ops & 1) ? b : a;
    for (int j = 0; j < ops[n_ops - 1].w_out; ++j) fin[j] = 0;
    return 0;
  }
  if (len > ops[0].w_in) len = ops[0].w_in;
  if (len < 0) len = 0;
  uint8_t* in = a;
  uint8_t* out = b;
  for (int k = 0; k < n_ops; ++k) {
    len = rt_apply(ops[k], in, len, out);
    uint8_t* t = in;
    in = out;
    out = t;
  }
  return len;
}
