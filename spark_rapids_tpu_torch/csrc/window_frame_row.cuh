// The per-row logic of the window_frame kernel's chunked instance
// (csrc/window_frame.cu), which takes frames past the tiled instance's
// halo (csrc/window_frame_tile.cuh): one row's aggregate over its bounded
// ROWS frame.
// Everything here is __host__ __device__, so g++ builds it on a machine
// without CUDA and the tests hold it to the plain version
// (tests/test_torch_window.py).
//
// The n rows are sorted by partition; flags[j] is 1 where row j starts a
// partition (flags[0] is 1). Row i's partition runs from start to end
// (inclusive) and its frame is [max(start, i + lo), min(end, i + hi)].
// The partition's ends are searched among the flags at most -lo rows
// back and hi forward, in chunks of 32 rows (``wf_chunk_bounds``), a
// chunk's flags as a 32-bit mask, which on the card is one load a lane
// and a ballot for the warp's 32 rows at once.
// Values are int64 or double (the wrapper widens narrower types; an
// average takes doubles). NULL rows (valid 0) are
// skipped. The sum adds the frame's valid values in ascending row order
// from 0, as Spark's sliding frame does, so NaN and +-inf come out per
// frame. Minimum and maximum compare doubles as the integers of their
// total order (-0.0 as 0.0, every NaN one canonical NaN, NaN greatest):
// a maximum is NaN when the frame holds a NaN, a minimum only when it
// holds nothing else. A frame with no valid value gives NULL (0 in the
// value slot); a count is never NULL.
#pragma once
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define WF_HD __host__ __device__ __forceinline__
#else
#define WF_HD inline
#endif

// The wrapper's exec/window_frame.py _OPS
enum WfOp { WF_SUM = 0, WF_COUNT = 1, WF_AVG = 2, WF_MIN = 3, WF_MAX = 4 };

static const int64_t kWfLow = 0x7FFFFFFFFFFFFFFFLL;  // every bit but the sign
static const int64_t kWfNan = 0x7FF8000000000000LL;  // the canonical NaN

// A double as the int64 whose order is the doubles' total order.
WF_HD int64_t wf_key(double x) {
  if (x == 0.0) x = 0.0;
  int64_t b;
  memcpy(&b, &x, sizeof b);
  if (x != x) b = kWfNan;
  return b < 0 ? (b ^ kWfLow) : b;
}

WF_HD double wf_unkey(int64_t k) {
  const int64_t b = k < 0 ? (k ^ kWfLow) : k;
  double x;
  memcpy(&x, &b, sizeof x);
  return x;
}

// Order keys of T: the value itself for int64, the total-order key for
// double.
WF_HD int64_t wf_order(int64_t v) { return v; }
WF_HD int64_t wf_order(double v) { return wf_key(v); }
WF_HD void wf_unorder(int64_t k, int64_t* out) { *out = k; }
WF_HD void wf_unorder(int64_t k, double* out) { *out = wf_unkey(k); }

// Addition that wraps for int64, as torch's does (signed overflow is
// undefined in C++).
WF_HD int64_t wf_add(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}
WF_HD double wf_add(double a, double b) { return a + b; }

// The kernel instance a launch takes (exec/window_frame.py SEARCHES):
// picked by the frame (the tiled one within its halo, csrc/
// window_frame_tile.cuh ``wf_tiled``, else the chunked one), or forced
enum WfSearchKind { WF_SEARCH_FRAME = 0, WF_SEARCH_CHUNKS = 1,
                    WF_SEARCH_TILE = 2 };

// The partition ends' search, in chunks of 32 rows. The 32 rows from
// ``base`` (a multiple of 32) are a warp's on the card. Chunk c of the
// backward search holds rows [base - 32c, base - 32c + 31], of the
// forward search rows [base + 32c, base + 32c + 31]; its mask has bit k
// set where row (chunk start + k) starts a partition, and going forward
// where the rows have ended (k past n - 1).
struct WfSearch {
  int64_t x, y;    // the frame's first and last row so far
  bool back, fwd;  // still searching back, forward
};

WF_HD WfSearch wf_search(int64_t i, int64_t n, int32_t lo, int32_t hi) {
  WfSearch s;
  s.x = i + lo;
  s.y = i + hi;
  s.back = i < n && lo < 0;  // a partition start in (i + lo, i]
  s.fwd = i < n && hi > 0;   // the next one (or n) in (i, i + hi]
  return s;
}

// Whether row r's bit is set in a backward (fwd false) or forward mask.
WF_HD bool wf_flag(const uint8_t* flags, int64_t n, int64_t r, bool fwd) {
  return r >= n ? fwd : (r >= 0 && flags[r] != 0);
}

WF_HD int wf_high_bit(uint32_t m) {  // m != 0
#ifdef __CUDA_ARCH__
  return 31 - __clz((int)m);
#else
  return 31 - __builtin_clz(m);
#endif
}

WF_HD int wf_low_bit(uint32_t m) {  // m != 0
#ifdef __CUDA_ARCH__
  return __ffs((int)m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// Bits k of m with lo < k <= hi (either may lie outside [0, 31]).
WF_HD uint32_t wf_bits(uint32_t m, int64_t lo, int64_t hi) {
  if (hi < 0 || lo >= 31) return 0;
  if (hi < 31) m &= (2u << hi) - 1;
  if (lo >= 0) m &= ~((2u << lo) - 1);
  return m;
}

WF_HD bool wf_back_needs(const WfSearch& s, int64_t cb) {
  return s.back && cb + 31 > s.x;
}

WF_HD bool wf_fwd_needs(const WfSearch& s, int64_t cb) {
  return s.fwd && cb <= s.y;
}

// Row i's backward search over the chunk from cb with mask m: the last
// partition start in (x, i] ends it.
WF_HD void wf_back_chunk(WfSearch* s, uint32_t m, int64_t cb, int64_t i) {
  if (!wf_back_needs(*s, cb)) return;
  m = wf_bits(m, s->x - cb, i - cb);
  if (m) {
    s->x = cb + wf_high_bit(m);
    s->back = false;
  }
}

// Row i's forward search over the chunk from cb with mask m: the first
// partition start (or n) in (i, y] ends it, the frame's last row before
// it.
WF_HD void wf_fwd_chunk(WfSearch* s, uint32_t m, int64_t cb, int64_t i) {
  if (!wf_fwd_needs(*s, cb)) return;
  m = wf_bits(m, i - cb, s->y - cb);
  if (m) {
    s->y = cb + wf_low_bit(m) - 1;
    s->fwd = false;
  }
}

// The chunk's mask, read flag by flag (the card's lanes read one each).
WF_HD uint32_t wf_mask(const uint8_t* flags, int64_t n, int64_t cb,
                       bool fwd) {
  uint32_t m = 0;
  for (int k = 0; k < 32; ++k)
    if (wf_flag(flags, n, cb + k, fwd)) m |= 1u << k;
  return m;
}

// Row i's frame bounds [*a, *b] by chunks; empty when *a > *b. One
// row's search, chunk by chunk, as a lane of the kernel searches it (the
// kernel goes on while any lane of its warp searches; further chunks
// leave a row that has stopped as it is).
WF_HD void wf_chunk_bounds(const uint8_t* flags, int64_t n, int64_t i,
                           int32_t lo, int32_t hi, int64_t* a, int64_t* b) {
  const int64_t base = i - (i & 31);
  WfSearch s = wf_search(i, n, lo, hi);
  for (int64_t cb = base; wf_back_needs(s, cb); cb -= 32)
    wf_back_chunk(&s, wf_mask(flags, n, cb, false), cb, i);
  for (int64_t cb = base; wf_fwd_needs(s, cb); cb += 32)
    wf_fwd_chunk(&s, wf_mask(flags, n, cb, true), cb, i);
  *a = s.x;
  *b = s.y;
}

// One row: its frame's OP over values[a..b], into *out (a T, or for a
// count an int64, for an average a double) and *ok.
template <typename T, int OP>
WF_HD void wf_row(const T* values, const uint8_t* valid, int64_t a,
                  int64_t b, void* out, uint8_t* ok) {
  int64_t count = 0;
  if (OP == WF_MIN || OP == WF_MAX) {
    int64_t m = OP == WF_MIN ? (int64_t)kWfLow : (int64_t)(-kWfLow - 1);
    for (int64_t j = a; j <= b; ++j) {
      if (!valid[j]) continue;
      const int64_t k = wf_order(values[j]);
      if (OP == WF_MIN ? k < m : k > m) m = k;
      ++count;
    }
    T r = 0;
    if (count) wf_unorder(m, &r);
    *(T*)out = r;
    *ok = count > 0;
    return;
  }
  T acc = 0;
  for (int64_t j = a; j <= b; ++j) {
    if (!valid[j]) continue;
    if (OP != WF_COUNT) acc = wf_add(acc, values[j]);
    ++count;
  }
  if (OP == WF_COUNT) {
    *(int64_t*)out = count;
    *ok = 1;
  } else if (OP == WF_AVG) {
    *(double*)out = count ? (double)acc / (double)count : 0.0;
    *ok = count > 0;
  } else {
    *(T*)out = acc;
    *ok = count > 0;
  }
}
