// Per-word logic of the string transform chain over a byte rectangle,
// shared by the CUDA kernel (rect_transform.cu) and a host build: outside
// nvcc the two function qualifiers are defined empty, so g++ compiles and
// tests the same code (tests/test_torch_strings.py).
//
// A row is held by a group of G lanes (G = the chain's widest width / 16,
// at least 1), lane k holding bytes [16k, 16k + 16) of the row as four
// little-endian 32-bit words (row words 4k .. 4k + 3), zero past the
// row's length. Every op works on those words: the byte-parallel ones
// (case maps, masks) within each word, the rest through a few exchanges
// between the group's lanes. The exchanges go through an `Ex` object: on
// the card RtWarpEx (one lane a thread, __shfl_sync and __ballot_sync),
// on the host RtHostEx (every lane of the group in one thread, the words
// in an array). So each op is written once over `L` lanes a thread: L = 1
// in the kernel, L = G on the host.
//
// The ops and their arguments (RtOp) are those of exec/rect_transform.py's
// chain:
//   UPPER, LOWER, INITCAP, REVERSE    no arguments
//   TRIM              a = left, b = right (space 0x20 only)
//   SUBSTRING         a = pos (Spark's: 1-based, 0 as 1, negative from
//                     the end), b = length when c != 0
//   REPLACE           lit1 = search (n1 >= 1), lit2 = replacement (n2)
//   PAD               a = length (>= 1), b = left, lit1 = pad (n1 >= 1)
//   SUBSTRING_INDEX   lit1 = delimiter (n1 >= 1), a = count; every match
//                     counts, overlapping ones too (Spark's search starts
//                     one byte past the last match)
//   REPEAT            a = times (>= 0)
//   TRANSLATE         lit1 = from (n1), lit2 = to (n2): each byte of from
//                     maps to the byte of to at its position, the first
//                     occurrence winning; one past the end of to, or
//                     mapped to 0x00, is deleted (Spark's translate)
// The host computes each op's output width before the launch (w_out);
// the width rules guarantee that every output fits it. Any byte value,
// 0x00 included, is a byte of the string when it lies below the length.
#pragma once

#include <stdint.h>
#include <string.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define RT_INLINE inline
#define RT_UNROLL
#else
// inlined into the kernel, and the loops over a lane's words unrolled, so
// that every array is indexed at compile time and needs no stack frame
#define RT_INLINE __forceinline__
#define RT_UNROLL _Pragma("unroll")
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
  RT_REPEAT = 10,
  RT_TRANSLATE = 11,
};

constexpr int kRtMaxOps = 8;       // ops a launch takes
constexpr int kRtMaxLiteral = 32;  // bytes of one literal
constexpr int kRtMaxWidth = 64;    // widest row, in or out
// A PAD op's pad repeated: byte b is pad[(b - 4) mod n1], for the offsets
// -4 to 67 of a row that its words read (rt_rep_word).
constexpr int kRtRepBytes = 80;

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

// ---------------------------------------------------------------------------
// words
// ---------------------------------------------------------------------------

constexpr uint32_t kRtOnes = 0x01010101u;
constexpr uint32_t kRtHigh = 0x80808080u;
constexpr uint32_t kRtLow7 = 0x7f7f7f7fu;

// 0x80 in each byte of x equal to c, 0 elsewhere (exact for every byte).
RT_INLINE __host__ __device__ uint32_t rt_eq_bytes(uint32_t x, uint32_t c) {
  const uint32_t t = x ^ (c * kRtOnes);
  return ~(((t & kRtLow7) + kRtLow7) | t) & kRtHigh;
}

// 0x80 in each byte of x in [lo, hi] (1 <= lo <= hi < 0x80), 0 elsewhere:
// the low seven bits of a byte plus 0x80 - lo carry into its top bit when
// they are >= lo, plus 0x7f - hi when they are > hi, and neither sum
// leaves the byte; a byte >= 0x80 is in no such range.
RT_INLINE __host__ __device__ uint32_t rt_in_range(uint32_t x, uint32_t lo,
                                                   uint32_t hi) {
  const uint32_t h = x & kRtLow7;
  const uint32_t ge = h + (0x80u - lo) * kRtOnes;
  const uint32_t gt = h + (0x7fu - hi) * kRtOnes;
  return ge & ~gt & ~x & kRtHigh;
}

// The case maps flip bit 0x20 of the bytes in their range.
RT_INLINE __host__ __device__ uint32_t rt_upper_word(uint32_t x) {
  return x ^ (rt_in_range(x, 'a', 'z') >> 2);
}

RT_INLINE __host__ __device__ uint32_t rt_lower_word(uint32_t x) {
  return x ^ (rt_in_range(x, 'A', 'Z') >> 2);
}

// initcap of one word: a byte after a space (0x20) upper case, any other
// lower case. `carry` is 0x80 when the byte before the word is a space
// (or the word starts the row), else 0.
RT_INLINE __host__ __device__ uint32_t rt_initcap_word(uint32_t x,
                                                       uint32_t carry) {
  const uint32_t first = (rt_eq_bytes(x, ' ') << 8) | carry;
  const uint32_t flip = (rt_in_range(x, 'a', 'z') & first) |
                        (rt_in_range(x, 'A', 'Z') & ~first);
  return x ^ (flip >> 2);
}

// The bytes of row word q that lie below n: 0xff in each, 0 elsewhere.
RT_INLINE __host__ __device__ uint32_t rt_keep(int q, int n) {
  const int d = n - 4 * q;
  return d >= 4 ? 0xffffffffu : (d <= 0 ? 0u : (1u << (8 * d)) - 1u);
}

// Bytes [r, r + 4) of the eight bytes hi:lo (r in 0..3).
RT_INLINE __host__ __device__ uint32_t rt_funnel(uint32_t lo, uint32_t hi,
                                                 int r) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, 8 * r);
#else
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> (8 * r));
#endif
}

// Byte i of the result is byte (sel >> 4i) & 7 of hi:lo (the selector
// nibbles are 0..7).
RT_INLINE __host__ __device__ uint32_t rt_perm(uint32_t lo, uint32_t hi,
                                               uint32_t sel) {
#ifdef __CUDA_ARCH__
  return __byte_perm(lo, hi, sel);
#else
  const uint64_t v = ((uint64_t)hi << 32) | lo;
  uint32_t out = 0;
  for (int i = 0; i < 4; ++i)
    out |= (uint32_t)((v >> (8 * ((sel >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return out;
#endif
}

RT_INLINE __host__ __device__ int rt_ctz32(uint32_t x) {  // x != 0
#ifdef __CUDA_ARCH__
  return __ffs(x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

RT_INLINE __host__ __device__ int rt_clz32(uint32_t x) {  // x != 0
#ifdef __CUDA_ARCH__
  return __clz(x);
#else
  return __builtin_clz(x);
#endif
}

RT_INLINE __host__ __device__ int rt_ctz64(uint64_t x) {  // x != 0
#ifdef __CUDA_ARCH__
  return __ffsll((long long)x) - 1;
#else
  return __builtin_ctzll(x);
#endif
}

RT_INLINE __host__ __device__ int rt_clz64(uint64_t x) {  // x != 0
#ifdef __CUDA_ARCH__
  return __clzll((long long)x);
#else
  return __builtin_clzll(x);
#endif
}

RT_INLINE __host__ __device__ int rt_popc64(uint64_t x) {
#ifdef __CUDA_ARCH__
  return __popcll(x);
#else
  return __builtin_popcountll(x);
#endif
}

// Positions below p (p in 0..64) as a mask.
RT_INLINE __host__ __device__ uint64_t rt_below(int p) {
  return p >= 64 ? ~0ull : (p <= 0 ? 0ull : (1ull << p) - 1ull);
}

// ---------------------------------------------------------------------------
// literal matches (REPLACE, SUBSTRING_INDEX) over a 64-position mask
// ---------------------------------------------------------------------------

// The greedy left-to-right non-overlapping choice among the match starts
// `m` of an n-byte literal (REPLACE): each chosen match hides the starts
// of its next n - 1 bytes.
RT_INLINE __host__ __device__ uint64_t rt_select_nonoverlap(uint64_t m,
                                                            int n) {
  if (n <= 1) return m;
  uint64_t sel = 0;
  while (m) {
    const int p = rt_ctz64(m);
    sel |= 1ull << p;
    m &= ~rt_below(p + n);
  }
  return sel;
}

// The position of the count-th match start of `m` from the left (count
// > 0) or the -count-th from the right (count < 0), or -1 when `m` holds
// fewer (SUBSTRING_INDEX: every start counts, overlapping ones too).
RT_INLINE __host__ __device__ int rt_nth_match(uint64_t m, int32_t count) {
  const int64_t c = count > 0 ? (int64_t)count : -(int64_t)count;
  if (count == 0 || c > rt_popc64(m)) return -1;
  for (int64_t i = 1; i < c; ++i) {
    if (count > 0)
      m &= m - 1;
    else
      m &= ~(1ull << (63 - rt_clz64(m)));
  }
  return count > 0 ? rt_ctz64(m) : 63 - rt_clz64(m);
}

// Word t of a 4-byte aligned byte array (a literal, a repeated pad, the
// scratch), and its store.
RT_INLINE __host__ __device__ uint32_t rt_ld32(const uint8_t* p, int t) {
#ifdef __CUDA_ARCH__
  return reinterpret_cast<const uint32_t*>(p)[t];
#else
  uint32_t v;
  memcpy(&v, p + 4 * t, 4);
  return v;
#endif
}

RT_INLINE __host__ __device__ void rt_st32(uint8_t* p, int t, uint32_t v) {
#ifdef __CUDA_ARCH__
  reinterpret_cast<uint32_t*>(p)[t] = v;
#else
  memcpy(p + 4 * t, &v, 4);
#endif
}

// One step of a literal match over a lane's 16 start positions: diff[j]
// collects, for the starts 4q + b (b = 0..3 in its bytes) of the lane's
// word q = 4k + j, row bytes [4(q + t) + b, + 4) against literal word t;
// win holds row words 4k + t .. 4k + t + 4.
RT_INLINE __host__ __device__ void rt_match_step(uint32_t (&diff)[4],
                                                 const uint32_t (&win)[5],
                                                 uint32_t lit, uint32_t mask) {
  RT_UNROLL
  for (int j = 0; j < 4; ++j) {
    RT_UNROLL
    for (int b = 0; b < 4; ++b)
      diff[j] |= (uint32_t)(((rt_funnel(win[j], win[j + 1], b) ^ lit) &
                             mask) != 0)
                 << b;
  }
}

// The lane's 16 match starts (bit 4j + b for row byte 16k + 4j + b) at
// which the n-byte literal ends within the length.
RT_INLINE __host__ __device__ uint32_t rt_match_bits(const uint32_t (&diff)[4],
                                                    int k, int n, int len) {
  uint32_t bits = 0;
  for (int j = 0; j < 4; ++j) bits |= (~diff[j] & 0xfu) << (4 * j);
  const int room = len - n + 1 - 16 * k;  // starts below this end in time
  return room >= 16 ? bits : (room <= 0 ? 0u : bits & ((1u << room) - 1u));
}

// REPLACE: the bytes that lie inside a chosen match past its first byte,
// given the chosen starts `sel` of an n1-byte search. The matches do not
// overlap, so the ranges p + 1 .. p + n1 - 1 are disjoint and their sum,
// (sel << n1) - (sel << 1), is their union (a match that ends at byte 64
// loses its top bit to the shift, which leaves bits p + 1 .. 63).
RT_INLINE __host__ __device__ uint64_t rt_covered(uint64_t sel, int n1) {
  return n1 >= 64 ? 0ull : (sel << n1) - (sel << 1);
}

// Byte b of a PAD op's repeated pad (kRtRepBytes).
RT_INLINE __host__ __device__ uint8_t rt_rep_byte(const RtOp& op, int b) {
  const int n = op.n1 > 0 ? op.n1 : 1;
  return op.lit1[((b - 4) % n + n) % n];
}

// Bytes [o, o + 4) of the repeated pad, for o in -4..64 (aligned reads).
RT_INLINE __host__ __device__ uint32_t rt_rep_word(const uint8_t* rep, int o) {
  const int b = o + 4 < 0 ? 0 : o + 4;
  return rt_funnel(rt_ld32(rep, b >> 2), rt_ld32(rep, (b >> 2) + 1), b & 3);
}

// A lane's first and last byte (0..15) among the 0x80 marks of `m`, each
// word's marks in its top bits; -1 when there is none.
RT_INLINE __host__ __device__ int rt_first_mark(const uint32_t (&m)[4]) {
  int f = -1;
  RT_UNROLL
  for (int j = 3; j >= 0; --j)
    if (m[j]) f = 4 * j + (rt_ctz32(m[j]) >> 3);
  return f;
}

RT_INLINE __host__ __device__ int rt_last_mark(const uint32_t (&m)[4]) {
  int f = -1;
  RT_UNROLL
  for (int j = 0; j < 4; ++j)
    if (m[j]) f = 4 * j + ((31 - rt_clz32(m[j])) >> 3);
  return f;
}

// ---------------------------------------------------------------------------
// the exchanges between the lanes of a group
// ---------------------------------------------------------------------------

// On the host: every lane of the group in one thread (L = G). `calls`
// counts the exchanges: on the card every group of a warp must make the
// same ones, whatever its row holds, so the host test requires every row
// of a chain to make the same number.
template <int G>
struct RtHostEx {
  mutable long calls = 0;
  // out[l] = v[src[l]], 0 where src[l] is outside the group
  void shfl(const uint32_t (&v)[G], const int (&src)[G],
            uint32_t (&out)[G]) const {
    ++calls;
    uint32_t tmp[G];
    for (int l = 0; l < G; ++l)
      tmp[l] = (unsigned)src[l] < (unsigned)G ? v[src[l]] : 0u;
    for (int l = 0; l < G; ++l) out[l] = tmp[l];
  }
  // bit l: p[l]
  uint32_t ballot(const bool (&p)[G]) const {
    ++calls;
    uint32_t b = 0;
    for (int l = 0; l < G; ++l) b |= (uint32_t)p[l] << l;
    return b;
  }
  // the OR of every lane's v
  uint64_t or64(const uint64_t (&v)[G]) const {
    ++calls;
    uint64_t r = 0;
    for (int l = 0; l < G; ++l) r |= v[l];
    return r;
  }
  void sync() const { ++calls; }
};

#ifdef __CUDACC__
// On the card: one lane a thread (L = 1); the group is G aligned lanes of
// a warp, every lane of the warp taking part in every exchange. A group
// of one lane exchanges nothing.
template <int G>
struct RtWarpEx {
  int base;  // the group's first lane
  __device__ void shfl(const uint32_t (&v)[1], const int (&src)[1],
                       uint32_t (&out)[1]) const {
    if (G == 1) {
      out[0] = src[0] == 0 ? v[0] : 0u;
    } else {
      const uint32_t r =
          __shfl_sync(0xffffffffu, v[0], base + (src[0] & (G - 1)));
      out[0] = (unsigned)src[0] < (unsigned)G ? r : 0u;
    }
  }
  __device__ uint32_t ballot(const bool (&p)[1]) const {
    if (G == 1) return p[0] ? 1u : 0u;
    return (__ballot_sync(0xffffffffu, p[0]) >> base) & ((1u << G) - 1u);
  }
  __device__ uint64_t or64(const uint64_t (&v)[1]) const {
    uint32_t lo = (uint32_t)v[0], hi = (uint32_t)(v[0] >> 32);
#pragma unroll
    for (int off = 1; off < G; off <<= 1) {
      lo |= __shfl_xor_sync(0xffffffffu, lo, off);
      hi |= __shfl_xor_sync(0xffffffffu, hi, off);
    }
    return ((uint64_t)hi << 32) | lo;
  }
  __device__ void sync() const {
    if (G > 1) __syncwarp();
  }
};
#endif

// ---------------------------------------------------------------------------
// the ops over a row group
// ---------------------------------------------------------------------------

// win = row words [A, A + 5) for each lane's A (any sign), 0 outside the
// group's words: the four words of lanes A / 4 and A / 4 + 1 (eight
// shuffles), then shifted down by A mod 4 words in two steps of selects.
template <int L, class Ex>
RT_INLINE __host__ __device__ void rt_window(const Ex& ex,
                                             const uint32_t (&w)[L][4],
                                             const int (&A)[L],
                                             uint32_t (&win)[L][5]) {
  int src[L];
  uint32_t t[L][8];
  for (int l = 0; l < L; ++l) src[l] = A[l] >> 2;  // floor
  RT_UNROLL
  for (int h = 0; h < 2; ++h) {
    RT_UNROLL
    for (int j = 0; j < 4; ++j) {
      uint32_t col[L], got[L];
      for (int l = 0; l < L; ++l) col[l] = w[l][j];
      ex.shfl(col, src, got);
      for (int l = 0; l < L; ++l) t[l][4 * h + j] = got[l];
    }
    for (int l = 0; l < L; ++l) ++src[l];
  }
  for (int l = 0; l < L; ++l) {
    const int o = A[l] & 3;
    uint32_t u[6];
    RT_UNROLL
    for (int i = 0; i < 6; ++i) u[i] = (o & 2) ? t[l][i + 2] : t[l][i];
    RT_UNROLL
    for (int i = 0; i < 5; ++i) win[l][i] = (o & 1) ? u[i + 1] : u[i];
  }
}

// Word q becomes bytes [4q + s, 4q + s + 4) of the row (s may be
// negative); bytes outside the group's words read 0.
template <int L, class Ex>
RT_INLINE __host__ __device__ void rt_shift(const Ex& ex, uint32_t (&w)[L][4],
                                            const int (&k)[L], int s) {
  int A[L];
  uint32_t win[L][5];
  for (int l = 0; l < L; ++l) A[l] = 4 * k[l] + (s >> 2);  // floor
  rt_window(ex, w, A, win);
  for (int l = 0; l < L; ++l)
    for (int j = 0; j < 4; ++j)
      w[l][j] = rt_funnel(win[l][j], win[l][j + 1], s & 3);
}

// Every word of the lane masked to the first n bytes of the row.
template <int L>
RT_INLINE __host__ __device__ void rt_mask(uint32_t (&w)[L][4],
                                           const int (&k)[L], int n) {
  for (int l = 0; l < L; ++l)
    for (int j = 0; j < 4; ++j) w[l][j] &= rt_keep(4 * k[l] + j, n);
}

// The 64-position mask of the starts of op.lit1 within the length.
template <int L, class Ex>
RT_INLINE __host__ __device__ uint64_t rt_match_mask(const Ex& ex,
                                                     const RtOp& op,
                                                     const uint32_t (&w)[L][4],
                                                     const int (&k)[L],
                                                     int len) {
  const int n = op.n1;
  const int words = (n + 3) >> 2;
  uint32_t diff[L][4];
  for (int l = 0; l < L; ++l)
    for (int j = 0; j < 4; ++j) diff[l][j] = 0;
  for (int t = 0; t < words; ++t) {
    int A[L];
    uint32_t win[L][5];
    for (int l = 0; l < L; ++l) A[l] = 4 * k[l] + t;
    rt_window(ex, w, A, win);
    const uint32_t lit = rt_ld32(op.lit1, t);
    const uint32_t mask = rt_keep(t, n);
    for (int l = 0; l < L; ++l) rt_match_step(diff[l], win[l], lit, mask);
  }
  uint64_t part[L];
  for (int l = 0; l < L; ++l)
    part[l] = (uint64_t)rt_match_bits(diff[l], k[l], n, len) << (16 * k[l]);
  return ex.or64(part);
}

// One op over the group's row: w holds the row (zero past len) and then
// the op's output (zero past the returned length). `scr` is the group's
// 16G bytes of scratch, `rep` the op's repeated pad (PAD). Every group
// makes the same exchanges whatever its row holds: the lanes of a warp
// exchange together.
template <int L, bool kMatch, class Ex>
RT_INLINE __host__ __device__ int rt_apply(const RtOp& op, const Ex& ex,
                                           uint32_t (&w)[L][4],
                                           const int (&k)[L], int len,
                                           uint8_t* scr, const uint8_t* rep) {
  switch (op.code) {
    case RT_UPPER:
      for (int l = 0; l < L; ++l)
        for (int j = 0; j < 4; ++j) w[l][j] = rt_upper_word(w[l][j]);
      return len;
    case RT_LOWER:
      for (int l = 0; l < L; ++l)
        for (int j = 0; j < 4; ++j) w[l][j] = rt_lower_word(w[l][j]);
      return len;
    case RT_INITCAP: {
      // the byte before each word: the previous word's top byte, from the
      // previous lane for the lane's first word
      int src[L];
      uint32_t col[L], prev[L];
      for (int l = 0; l < L; ++l) {
        src[l] = k[l] - 1;
        col[l] = w[l][3];
      }
      ex.shfl(col, src, prev);
      for (int l = 0; l < L; ++l) {
        uint32_t before = prev[l];
        RT_UNROLL
        for (int j = 0; j < 4; ++j) {
          const uint32_t carry =
              k[l] == 0 && j == 0 ? 0x80u : rt_eq_bytes(before, ' ') >> 24;
          before = w[l][j];
          w[l][j] = rt_initcap_word(w[l][j], carry);
        }
      }
      return len;
    }
    case RT_REVERSE: {
      // out word q = row bytes len - 4 - 4q .. len - 1 - 4q, reversed: the
      // lane's four come from the five row words from (len - 16 - 16k) / 4
      int A[L];
      uint32_t win[L][5];
      for (int l = 0; l < L; ++l) A[l] = (len - 16 - 16 * k[l]) >> 2;
      rt_window(ex, w, A, win);
      const int r = len & 3;
      for (int l = 0; l < L; ++l)
        for (int j = 0; j < 4; ++j)
          w[l][j] = rt_perm(rt_funnel(win[l][3 - j], win[l][4 - j], r), 0,
                            0x0123);
      rt_mask(w, k, len);
      return len;
    }
    case RT_TRIM: {
      // non-space bytes below the length: the first and last lanes that
      // hold one, by a ballot, then their first and last such byte
      uint32_t first[L], last[L];
      bool any[L];
      for (int l = 0; l < L; ++l) {
        uint32_t ns[4];
        for (int j = 0; j < 4; ++j)
          ns[j] = ~rt_eq_bytes(w[l][j], ' ') & rt_keep(4 * k[l] + j, len) &
                  kRtHigh;
        first[l] = (uint32_t)rt_first_mark(ns);
        last[l] = (uint32_t)rt_last_mark(ns);
        any[l] = (ns[0] | ns[1] | ns[2] | ns[3]) != 0;
      }
      const uint32_t lanes = ex.ballot(any);
      const int kf = lanes ? rt_ctz32(lanes) : 0;
      const int kl = lanes ? 31 - rt_clz32(lanes) : 0;
      int src[L];
      uint32_t f[L], e[L];
      for (int l = 0; l < L; ++l) src[l] = kf;
      ex.shfl(first, src, f);
      for (int l = 0; l < L; ++l) src[l] = kl;
      ex.shfl(last, src, e);
      int n = op.a || op.b ? 0 : len, lead = 0;
      if (lanes) {
        lead = op.a ? 16 * kf + (int)f[0] : 0;
        n = (op.b ? 16 * kl + (int)e[0] + 1 : len) - lead;
      }
      rt_shift(ex, w, k, lead);
      rt_mask(w, k, n);
      return n;
    }
    case RT_SUBSTRING: {
      int64_t start = op.a > 0 ? op.a - 1
                               : (op.a < 0 ? (int64_t)len + op.a : 0);
      int64_t end = op.c ? start + op.b : (int64_t)len;
      if (start < 0) start = 0;
      if (end > len) end = len;
      const int n = end > start ? (int)(end - start) : 0;
      rt_shift(ex, w, k, n ? (int)start : 0);
      rt_mask(w, k, n);
      return n;
    }
    case RT_SUBSTRING_INDEX: {
      if (!kMatch) break;
      const uint64_t m = rt_match_mask(ex, op, w, k, len);
      const int p = rt_nth_match(m, op.a);
      int start = 0, n = len;
      if (op.a == 0) {
        n = 0;
      } else if (op.a > 0) {
        if (p >= 0) n = p;
      } else if (p >= 0) {
        start = p + op.n1;
        n = len - start;
      }
      rt_shift(ex, w, k, start);
      rt_mask(w, k, n);
      return n;
    }
    case RT_REPLACE: {
      if (!kMatch) break;
      // the chosen matches, then every kept byte and every replacement
      // scattered to its output position in the group's scratch
      const uint64_t sel = rt_select_nonoverlap(
          rt_match_mask(ex, op, w, k, len), op.n1);
      const int d = op.n2 - op.n1;
      int n = len + d * rt_popc64(sel);
      if (n > op.w_out) n = op.w_out;
      for (int l = 0; l < L; ++l)
        for (int j = 0; j < 4; ++j) rt_st32(scr, 4 * k[l] + j, 0);
      ex.sync();
      // the lane's 16 bytes: chosen starts, bytes inside a match, and
      // the chosen starts before each (a running count)
      const uint64_t cov = rt_covered(sel, op.n1);
      RT_UNROLL
      for (int l = 0; l < L; ++l) {
        const uint32_t s16 = (uint32_t)(sel >> (16 * k[l])) & 0xffffu;
        uint32_t skip = (uint32_t)(cov >> (16 * k[l])) & 0xffffu;
        const int room = len - 16 * k[l];
        if (room < 16) skip |= room <= 0 ? 0xffffu : 0xffffu << room;
        int before = rt_popc64(sel & rt_below(16 * k[l]));
        RT_UNROLL
        for (int j = 0; j < 4; ++j) {
          const uint32_t word = w[l][j];
          RT_UNROLL
          for (int b = 0; b < 4; ++b) {
            const int c = 4 * j + b;
            const int o = 16 * k[l] + c + d * before;
            if ((s16 >> c) & 1) {
              for (int t = 0; t < op.n2 && o + t < op.w_out; ++t)
                scr[o + t] = op.lit2[t];
              ++before;
            } else if (!((skip >> c) & 1) && o < op.w_out) {
              scr[o] = (uint8_t)(word >> (8 * b));
            }
          }
        }
      }
      ex.sync();
      for (int l = 0; l < L; ++l)
        for (int j = 0; j < 4; ++j) w[l][j] = rt_ld32(scr, 4 * k[l] + j);
      rt_mask(w, k, n);
      return n;
    }
    case RT_REPEAT: {
      if (!kMatch) break;
      // every copy of each byte to the scratch, t * len bytes on
      const int64_t total = (int64_t)len * (op.a > 0 ? op.a : 0);
      const int n = total > op.w_out ? op.w_out : (int)total;
      for (int l = 0; l < L; ++l)
        for (int j = 0; j < 4; ++j) rt_st32(scr, 4 * k[l] + j, 0);
      ex.sync();
      RT_UNROLL
      for (int l = 0; l < L; ++l) {
        RT_UNROLL
        for (int j = 0; j < 4; ++j) {
          RT_UNROLL
          for (int b = 0; b < 4; ++b) {
            const int q = 16 * k[l] + 4 * j + b;
            if (q < len)
              for (int o = q; o < n; o += len)
                scr[o] = (uint8_t)(w[l][j] >> (8 * b));
          }
        }
      }
      ex.sync();
      for (int l = 0; l < L; ++l)
        for (int j = 0; j < 4; ++j) w[l][j] = rt_ld32(scr, 4 * k[l] + j);
      rt_mask(w, k, n);
      return n;
    }
    case RT_TRANSLATE: {
      if (!kMatch) break;
      // each byte mapped within its word; the kept bytes' positions from
      // the group's 64-bit mask of them, then scattered to the scratch
      uint64_t part[L];
      for (int l = 0; l < L; ++l) {
        uint32_t keep16 = 0;
        RT_UNROLL
        for (int j = 0; j < 4; ++j) {
          uint32_t done = 0, to = 0, del = 0;
          for (int i = 0; i < op.n1; ++i) {
            const uint32_t m = rt_eq_bytes(w[l][j], op.lit1[i]) & ~done;
            done |= m;
            if (i < op.n2 && op.lit2[i] != 0)
              to |= ((m >> 7) * 0xffu) & (op.lit2[i] * kRtOnes);
            else
              del |= m;
          }
          w[l][j] = (w[l][j] & ~((done >> 7) * 0xffu)) | to;
          const uint32_t live = rt_keep(4 * k[l] + j, len);
          RT_UNROLL
          for (int b = 0; b < 4; ++b)
            keep16 |= (uint32_t)(((live >> (8 * b)) & 1u) &&
                                 !((del >> (8 * b + 7)) & 1u))
                      << (4 * j + b);
        }
        part[l] = (uint64_t)keep16 << (16 * k[l]);
      }
      const uint64_t keep = ex.or64(part);
      const int n = rt_popc64(keep);
      for (int l = 0; l < L; ++l)
        for (int j = 0; j < 4; ++j) rt_st32(scr, 4 * k[l] + j, 0);
      ex.sync();
      RT_UNROLL
      for (int l = 0; l < L; ++l) {
        RT_UNROLL
        for (int j = 0; j < 4; ++j) {
          RT_UNROLL
          for (int b = 0; b < 4; ++b) {
            const int q = 16 * k[l] + 4 * j + b;
            if ((keep >> q) & 1)
              scr[rt_popc64(keep & rt_below(q))] =
                  (uint8_t)(w[l][j] >> (8 * b));
          }
        }
      }
      ex.sync();
      for (int l = 0; l < L; ++l)
        for (int j = 0; j < 4; ++j) w[l][j] = rt_ld32(scr, 4 * k[l] + j);
      rt_mask(w, k, n);
      return n;
    }
    case RT_PAD: {
      const int length = op.a;
      // lpad moves the row right by `shift` (0 where it is long enough)
      const int shift = op.b && len < length ? length - len : 0;
      if (op.b) rt_shift(ex, w, k, -shift);
      if (len >= length) {
        rt_mask(w, k, length);
      } else {
        // lpad: the pad fills the front; rpad: the pad follows the row,
        // its byte j - len at byte j
        for (int l = 0; l < L; ++l) {
          RT_UNROLL
          for (int j = 0; j < 4; ++j) {
            const int q = 4 * k[l] + j;
            const uint32_t row = rt_keep(q, op.b ? length : len) &
                                 ~(op.b ? rt_keep(q, shift) : 0u);
            const uint32_t pad = rt_rep_word(rep, op.b ? 4 * q : 4 * q - len);
            w[l][j] = (w[l][j] & row) | (pad & rt_keep(q, length) & ~row);
          }
        }
      }
      return length;
    }
    default:
      break;
  }
  rt_mask(w, k, 0);
  return 0;
}

// The whole chain over one row group: w holds the lane's words of the row
// as read from the rectangle (any bytes past `len`); returns the final
// length and leaves the final words in w. An invalid row gives all zeros
// and length 0 (its lanes still take part in every exchange). `reps`
// holds each op's repeated pad, kRtRepBytes apart. Without kMatch the
// literal-match ops (REPLACE, SUBSTRING_INDEX) are compiled out, and a
// chain must not hold one (rt_chain_matches; REPEAT and TRANSLATE too):
// the kernel for the other chains needs fewer registers.
template <int L, bool kMatch, class Ex>
RT_INLINE __host__ __device__ int rt_group_chain(const RtOp* ops, int n_ops,
                                                 const Ex& ex,
                                                 uint32_t (&w)[L][4],
                                                 const int (&k)[L], int len,
                                                 bool valid, uint8_t* scr,
                                                 const uint8_t* reps) {
  if (len > ops[0].w_in) len = ops[0].w_in;
  if (len < 0 || !valid) len = 0;
  rt_mask(w, k, len);
  for (int i = 0; i < n_ops; ++i)
    len = rt_apply<L, kMatch>(ops[i], ex, w, k, len, scr,
                              reps + i * kRtRepBytes);
  if (!valid) {
    rt_mask(w, k, 0);
    len = 0;
  }
  return len;
}

// Whether a chain holds an op of the heavier instance: a literal match
// (REPLACE, SUBSTRING_INDEX), or a scatter through the scratch (REPEAT,
// TRANSLATE).
RT_INLINE __host__ __device__ bool rt_chain_matches(const RtChain& c) {
  for (int i = 0; i < c.n_ops; ++i)
    if (c.ops[i].code == RT_REPLACE || c.ops[i].code == RT_SUBSTRING_INDEX ||
        c.ops[i].code == RT_REPEAT || c.ops[i].code == RT_TRANSLATE)
      return true;
  return false;
}
