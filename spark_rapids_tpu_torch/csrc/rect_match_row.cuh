// Per-row and per-chunk logic of the byte-rectangle literal match, shared
// by the CUDA kernel (rect_match.cu) and a host build: outside nvcc the two
// function qualifiers are defined empty, so g++ compiles and tests the same
// code (tests/test_torch_rect_match.py).
//
// A row is `width` bytes, zero past its `len` bytes; the pattern is `L`
// bytes. Modes (the same codes as exprs/rect_match.py's MODES):
//   contains   a match at some offset s <= len - L
//   startswith len >= L and a match at 0
//   endswith   a match at len - L
//   equals     len == L and a match at 0
//   locate     1-based first such s, else 0
// The empty pattern: equals holds for len == 0, locate is 1, the rest
// hold. A pattern wider than the row matches nothing.
//
// The kernel copies a tile of rows into shared memory in chunks, and only
// the chunks that overlap a row's window (rect_row_window) are copied; the
// other bytes of the tile's image hold whatever was there before. So every
// read below that may reach past the window is masked.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define RECT_INLINE inline
#else
// inlined into the kernel, so that no output pointer or small array
// needs a stack frame
#define RECT_INLINE __forceinline__
#endif

enum RectMatchMode {
  RECT_CONTAINS = 0,
  RECT_STARTSWITH = 1,
  RECT_ENDSWITH = 2,
  RECT_EQUALS = 3,
  RECT_LOCATE = 4,
};

// ---------------------------------------------------------------------------
// tile geometry
// ---------------------------------------------------------------------------

// Threads that scan one row: one up to W = 64, then one per 64 bytes, so
// that a block's 256 threads hold a tile of 256 / Q rows (16 KiB of bytes)
// and every thread has about as much to scan.
__host__ __device__ constexpr int rect_row_threads(int W) {
  return W >= 128 ? W / 64 : 1;
}

// Rows of a tile for a power-of-two width W in [8, 1024] at a 16-byte
// aligned base (a block is always 256 threads).
__host__ __device__ constexpr int rect_tile_rows(int W) {
  return 256 / rect_row_threads(W);
}

// Bytes one copy moves: 16, or 8 for W = 8 (one row per chunk).
__host__ __device__ constexpr int rect_chunk_bytes(int W) {
  return W < 16 ? W : 16;
}

// Bytes between two rows of a tile in shared memory. From W = 32 up a row
// is padded by 16 bytes, so the 16-byte reads of eight rows that a quarter
// warp makes at once fall in distinct banks ((W / 16 + 1) is odd); up to
// W = 16 consecutive rows are consecutive words already.
__host__ __device__ constexpr int rect_row_stride(int W) {
  return W >= 32 ? W + 16 : W;
}

// Unaligned base or any other width (the raw layout): the tile's bytes are
// copied as the 16-byte aligned chunks of device memory that hold them, to
// the same places in shared memory, so row r starts at byte mis + r * width
// of the image, mis being the tile's first address mod 16.
__host__ __device__ constexpr int rect_raw_rows(int width) {
  return 16384 / width < 1 ? 1 : (16384 / width > 256 ? 256 : 16384 / width);
}

// The widest row the raw layout takes (three stages of one row fit a
// block's shared memory).
constexpr int kRectMaxWidth = 65536;

// Slack after a stage: a scan reads up to 16 bytes past a row's window and
// masks them (rect_find), so the last row's reads stay inside the image.
constexpr int kRectStageSlack = 32;

// ---------------------------------------------------------------------------
// which bytes a row needs
// ---------------------------------------------------------------------------

// The bytes [*lo, *hi) of a row that decide its result. Empty (*lo == *hi)
// where the lengths alone decide it: the empty pattern, a pattern wider
// than the row, a length test that fails.
__host__ __device__ RECT_INLINE void rect_row_window(int32_t len, int width,
                                                     int L, int mode,
                                                     int* lo, int* hi) {
  *lo = 0;
  *hi = 0;
  if (L == 0 || L > width) return;
  switch (mode) {
    case RECT_STARTSWITH:
      if (len >= L) *hi = L;
      return;
    case RECT_EQUALS:
      if (len == L) *hi = L;
      return;
    case RECT_ENDSWITH:
      if (len >= L && len <= width) {
        *lo = len - L;
        *hi = len;
      }
      return;
    default: {  // contains, locate: offsets 0 .. min(len, width) - L
      const int n = len < width ? len : width;
      if (n >= L) *hi = n;
      return;
    }
  }
}

// Does the chunk of `size` bytes at `start` (relative to the row's first
// byte, may be negative) overlap the window [lo, hi)?
__host__ __device__ RECT_INLINE bool rect_chunk_needed(int start, int size,
                                                       int lo, int hi) {
  return lo < hi && start < hi && start + size > lo;
}

// The chunks [*c0, *c1) of `cb` bytes that a row's window overlaps: the
// ones rect_chunk_needed accepts.
__host__ __device__ RECT_INLINE void rect_row_chunks(int32_t len, int width,
                                                     int L, int mode, int cb,
                                                     int* c0, int* c1) {
  int lo, hi;
  rect_row_window(len, width, L, mode, &lo, &hi);
  *c0 = lo < hi ? lo / cb : 0;
  *c1 = lo < hi ? (hi + cb - 1) / cb : 0;
}

// Chunk i of a tile of `rows` rows in the raw layout: the 16 bytes at
// 16 * i - mis past the tile's first byte, to byte 16 * i of the stage.
// A chunk may span several rows; it is needed when any of them needs it.
__host__ __device__ RECT_INLINE bool rect_raw_chunk(int i, int width,
                                                    int rows, int mis,
                                                    const int32_t* lens,
                                                    int L, int mode,
                                                    int* src, int* dst) {
  const int a = 16 * i - mis;  // the chunk's first byte in the tile
  *src = a;
  *dst = 16 * i;
  int r = a < 0 ? 0 : a / width;
  int r1 = (a + 15) / width;
  if (r1 > rows - 1) r1 = rows - 1;
  for (; r <= r1; ++r) {
    int lo, hi;
    rect_row_window(lens[r], width, L, mode, &lo, &hi);
    if (rect_chunk_needed(a - r * width, 16, lo, hi)) return true;
  }
  return false;
}

// ---------------------------------------------------------------------------
// the scan, over the tile's image as 32-bit little-endian words
// ---------------------------------------------------------------------------

// (hi:lo) >> sh, low word: bytes sh/8 .. sh/8 + 3 of the pair.
__host__ __device__ RECT_INLINE uint32_t rect_funnel(uint32_t lo,
                                                     uint32_t hi, int sh) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, sh);
#else
  return sh == 0 ? lo : (lo >> sh) | (hi << (32 - sh));
#endif
}

// The four bytes at byte b of the image, for any b.
__host__ __device__ RECT_INLINE uint32_t rect_word_at(const uint32_t* w,
                                                      int b) {
  return rect_funnel(w[b >> 2], w[(b >> 2) + 1], (b & 3) * 8);
}

// The high bit of each byte of x that equals the byte b4 repeats, in
// three operations. It never misses such a byte; it may also mark a byte
// above one (equal to b4's byte ^ 1, reached by the subtraction's borrow),
// so a caller checks every mark in full.
__host__ __device__ RECT_INLINE uint32_t rect_eq_hi4(uint32_t x,
                                                     uint32_t b4) {
  const uint32_t y = x ^ b4;
  return (y - 0x01010101u) & ~y & 0x80808080u;
}

// The kWords (2 or 4) words at byte b of the image. kAlign is what b is
// known to be a multiple of: 16 and 8 read whole vectors on the card, any
// other value goes word by word through the funnel.
template <int kAlign, int kWords>
__host__ __device__ RECT_INLINE void rect_load(const uint32_t* w, int b,
                                               uint32_t* v) {
#ifdef __CUDA_ARCH__
  if constexpr (kAlign == 16 && kWords == 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(w + (b >> 2));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (kAlign >= 8 && kWords == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(w + (b >> 2));
    v[0] = x.x; v[1] = x.y;
  } else  // NOLINT: the loop below is the else branch on the card
#endif
  {
#pragma unroll
    for (int k = 0; k < kWords; ++k) v[k] = rect_word_at(w, b + 4 * k);
  }
}

// Does the pattern (pw: its bytes as words, zero past L) match at offset s
// of the row that starts at byte `off` of the image? Reads only the bytes
// [off + s, off + s + L) into the result.
__host__ __device__ RECT_INLINE bool rect_match_at(const uint32_t* w,
                                                   int off, int s,
                                                   const uint32_t* pw,
                                                   int L) {
  const int b = off + s;
  const uint32_t* p = w + (b >> 2);
  const int sh = (b & 3) * 8;
  uint32_t lo = p[0];
  for (int j = 0, k = 1; j < L; j += 4, ++k) {
    const uint32_t hi = p[k];
    uint32_t x = rect_funnel(lo, hi, sh) ^ pw[j >> 2];
    if (L - j < 4) x &= (1u << (8 * (L - j))) - 1u;
    if (x != 0) return false;
    lo = hi;
  }
  return true;
}

__host__ __device__ RECT_INLINE int rect_ctz(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// The first offset s in [0, last] where the pattern matches, or -1,
// among the steps of 4 * kWords bytes at base0, base0 + stride, ... of the
// row (all of them for base0 = 0 and stride = 4 * kWords). Tests the
// pattern's first two bytes at every offset of a step at once
// (rect_eq_hi4, the second byte through a funnel shift across words); a
// step without a candidate costs no branch per offset, and the whole
// pattern is compared at each candidate, in order, up to `last`. The
// next step's words are read while this one is tested. The bytes read past
// the row's window (up to 4 * kWords + 4) decide nothing.
template <int kAlign, int kWords>
__host__ __device__ RECT_INLINE int rect_find(const uint32_t* w, int off,
                                              int last, const uint32_t* pw,
                                              uint32_t head, int L,
                                              int base0, int stride) {
  constexpr int kStep = 4 * kWords;
  const uint32_t first4 = (head & 0xFFu) * 0x01010101u;
  const uint32_t second4 = ((head >> 8) & 0xFFu) * 0x01010101u;
  uint32_t v[kWords + 1];
  if (base0 <= last) rect_load<kAlign, kWords>(w, off + base0, v);
  for (int base = base0; base <= last; base += stride) {
    uint32_t nx[kWords];
    const bool more = base + stride <= last;
    if (more) rect_load<kAlign, kWords>(w, off + base + stride, nx);
    v[kWords] = more && stride == kStep ? nx[0]
                                        : rect_word_at(w, off + base + kStep);
    uint32_t z[kWords];
    uint32_t any = 0;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      z[k] = rect_eq_hi4(v[k], first4);
      if (L >= 2) {
        z[k] &= rect_eq_hi4(rect_funnel(v[k], v[k + 1], 8), second4);
      }
      any |= z[k];
    }
    if (any != 0) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        for (uint32_t m = z[k]; m != 0; m &= m - 1u) {
          const int s = base + 4 * k + (rect_ctz(m) >> 3);
          if (s > last) return -1;
          if (rect_match_at(w, off, s, pw, L)) return s;
        }
      }
    }
    if (more) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) v[k] = nx[k];
    }
  }
  return -1;
}

// 0/1 for the bool modes, the 1-based position for locate, for the row
// whose first byte is byte `off` of the image, as thread q of the Q that
// scan the row sees it: thread q takes the steps q, q + Q, ... of a
// contains or locate scan, and only thread 0 tests the one offset of the
// other modes. rect_merge_rows combines the Q answers. Only the row's
// window (rect_row_window) has to hold the row's bytes. Steps are of
// 4 * kWords bytes (8 for W = 8, else 16); head is pw[0], the pattern's
// first four bytes, read once by the caller.
template <int kAlign, int kWords>
__host__ __device__ RECT_INLINE int32_t rect_match_loaded(
    const uint32_t* w, int off, int width, int32_t len, const uint32_t* pw,
    uint32_t head, int L, int mode, int q, int Q) {
  if (L == 0) return mode == RECT_EQUALS ? (len == 0) : 1;
  int lo, hi;
  rect_row_window(len, width, L, mode, &lo, &hi);
  if (lo >= hi) return 0;
  if (mode == RECT_CONTAINS || mode == RECT_LOCATE) {
    const int s = rect_find<kAlign, kWords>(w, off, hi - L, pw, head, L,
                                            4 * kWords * q, 4 * kWords * Q);
    if (s < 0) return 0;
    return mode == RECT_LOCATE ? s + 1 : 1;
  }
  return q == 0 && rect_match_at(w, off, lo, pw, L);
}

// Two threads' answers for one row as one: the smaller nonzero one (the
// first match for locate; any match for the bool modes), else 0.
__host__ __device__ RECT_INLINE int32_t rect_merge_rows(int32_t a,
                                                        int32_t b) {
  if (a == 0) return b;
  if (b == 0) return a;
  return a < b ? a : b;
}
