// The tile logic of the window_frame kernel's tiled instance
// (csrc/window_frame.cu): tiles of sorted rows staged with their halo in
// shared memory, and every row's frame aggregate computed from there.
// Everything is __host__ __device__; where the card uses a warp's ballot
// or shuffles (the bitmasks, the scans over words and over the threads'
// partials) the host runs the same arithmetic lane by lane. So g++ builds
// it and the CPU tests run a block's steps thread by thread between its
// barriers (tests/test_torch_window.py).
//
// A block of ``nt`` threads walks tiles of T = nt * WF_TILE_R consecutive
// rows (tile, tile + blocks, ...). For a tile from t0 it stages rows
// [t0 - hb, t0 + T + hf): hb >= -lo rows before, hf >= hi rows after,
// each rounded up to 16 rows (so that every interior tile's copies are
// whole 16-byte pieces), WF_HALO_MAX at most (``wf_tiled``), into one of
// two buffers: the next tile's copies are in flight while this one is
// computed. Staged rows before row 0 read as NULL, not a
// partition start; rows past n as NULL partition starts. Then (staged row
// p = row - (t0 - hb)):
//
// * Two bitmasks, of partition starts and of valid rows (a ballot a
//   32-row word), and three scans over their words (a warp each): the
//   valid rows before each word, the last start before it, the first
//   after it. Row i's frame is [max(i + lo, ls(i)), min(i + hi,
//   ns(i + 1) - 1)] (ls: the last start at or before, ns: the first at
//   or after; a start outside the halo never clamps), and a frame's count
//   a difference of two prefix counts: each O(1) a row.
// * A thread takes R = WF_TILE_R consecutive rows. Where no start lies in
//   (first row + min(lo, 0), last row + max(hi, 0)], its frames are
//   whole; where also no NULL lies in their union, every count is W. A
//   tile whose staged rows hold neither (the block's OR, at a barrier)
//   builds no bitmask and scans no word.
// * A float64 sum or average adds the frame's values in ascending row
//   order from 0 (departure 1 of ROADMAP Queue C). The R rows walk the
//   union of their frames once, each value read from shared memory once
//   and added to every accumulator whose frame holds it: (W + R - 1) / R
//   loads a row, not W. A NULL adds +0.0, which leaves an accumulator that
//   starts at +0.0 as it was. Whole frames need no test but at the ends
//   of the walk.
// * Minimum and maximum up to WF_DIRECT_W rows wide: the same walk over
//   order keys (W compares a row). Wider, van Herk / Gil-Werman: the
//   staged rows are cut into segments at every multiple of W and at every
//   partition start; P[p] is the extreme from p's segment start to p, S[p]
//   from p to its segment end, each a segmented scan over the staged rows
//   (every value's order key made once). A frame holds no partition start
//   but its first row, and at most one multiple of W, so it spans one
//   segment or two: across two, op(S[x], P[y]); in one, P[y] where x
//   starts the segment, else S[x] (y then ends it). Three compares a row.
// * An int64 sum: a difference of the inclusive prefix sum over the staged
//   rows, which wraps as the sum does (addition modulo 2^64 is
//   associative).
// * A count: the prefix counts.
//
// A scan over the staged rows (the int64 prefix, P, S) runs in three
// steps: each thread reduces a chunk of consecutive staged rows into a
// partial, a warp a scan turns the nt partials into each chunk's carry,
// each thread rescans its chunk from its carry. Results go to shared
// memory, and out in 16-byte stores.
#pragma once
#include <stdint.h>

#include <type_traits>

#include "tile_copy.cuh"
#include "window_frame_row.cuh"

// Rows a thread (odd: R consecutive doubles a thread are 2R banks apart,
// so a half-warp's 16 loads never share a bank)
#define WF_TILE_R 5
// The farthest a tiled frame reaches back (-lo) or forward (hi); past it
// the launch takes the chunked instance (exec/window_frame.py)
#define WF_HALO_MAX 1024
// Threads a block on the card
#define WF_TILE_THREADS 256
// The widest minimum or maximum walked directly; wider ones take the
// segments (a template parameter of the instance, SEG)
#define WF_DIRECT_W 16

// A scan's combine
enum WfComb { WF_C_ADD = 0, WF_C_MAX = 1, WF_C_MIN = 2 };

// Whether the tiled instance takes frame [lo, hi].
WF_HD bool wf_tiled(int32_t lo, int32_t hi) {
  return -(int64_t)lo <= WF_HALO_MAX && (int64_t)hi <= WF_HALO_MAX;
}

// Whether a frame [lo, hi] of op takes the segments (SEG).
WF_HD bool wf_segmented(int op, int32_t lo, int32_t hi) {
  return (op == WF_MIN || op == WF_MAX) &&
         (int64_t)hi - lo + 1 > WF_DIRECT_W;
}

WF_HD int64_t wf_comb(int c, int64_t a, int64_t b) {
  if (c == WF_C_ADD) return (int64_t)((uint64_t)a + (uint64_t)b);
  if (c == WF_C_MAX) return a > b ? a : b;
  return a < b ? a : b;
}

WF_HD int64_t wf_d2i(double x) {
#ifdef __CUDA_ARCH__
  return __double_as_longlong(x);
#else
  int64_t b;
  memcpy(&b, &x, sizeof b);
  return b;
#endif
}

WF_HD double wf_i2d(int64_t b) {
#ifdef __CUDA_ARCH__
  return __longlong_as_double(b);
#else
  double x;
  memcpy(&x, &b, sizeof x);
  return x;
#endif
}

WF_HD int wf_popc(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

// What an instance of (value type, op, segments) computes.
template <typename T, int OP, bool SEG>
struct WfKind {
  static const bool kFloat = std::is_same<T, double>::value;
  static const bool kExt = OP == WF_MIN || OP == WF_MAX;
  static const bool kFloatSum = kFloat && (OP == WF_SUM || OP == WF_AVG);
  static const bool kIntSum = !kFloat && OP == WF_SUM;
  // scans over the staged rows: the int64 prefix, or P and S
  static const int kRowScans = kIntSum ? 1 : (kExt && SEG ? 2 : 0);
  static const int kExtComb = OP == WF_MIN ? WF_C_MIN : WF_C_MAX;
  static const int64_t kExtIdent =
      OP == WF_MIN ? (int64_t)kWfLow : (int64_t)(-kWfLow - 1);
};

// A launch's geometry, and the tile at hand (``wf_at``).
struct WfGeo {
  int64_t n, t0, g0;  // rows, the tile's first row, staged row 0's row
  int32_t lo, hi, w;  // the frame, its width (0 when lo > hi)
  int32_t seg;        // the extremes' segment length: w, at least 1
  int32_t hb, hf;     // halo rows back and forward (multiples of 16)
  int32_t m, mw;      // staged rows, their 32-row words
  int32_t nt, rows;   // threads, tile rows (nt * WF_TILE_R)
  int32_t chunk;      // staged rows a thread scans (odd)
};

WF_HD WfGeo wf_geo(int64_t n, int32_t lo, int32_t hi, int nt) {
  WfGeo g;
  g.n = n;
  g.lo = lo;
  g.hi = hi;
  g.w = lo <= hi ? hi - lo + 1 : 0;  // wf_tiled: |lo|, |hi| small then
  g.seg = g.w > 0 ? g.w : 1;
  // whole 16-row pieces either side: with 16-byte aligned columns, an
  // interior tile's copies are all whole 16-byte pieces
  g.hb = ((lo < 0 ? -lo : 0) + 15) & ~15;
  g.hf = ((hi > 0 ? hi : 0) + 15) & ~15;
  g.nt = nt;
  g.rows = nt * WF_TILE_R;
  g.m = g.rows + g.hb + g.hf;
  g.mw = (g.m + 31) >> 5;
  g.chunk = ((g.m + nt - 1) / nt) | 1;
  g.t0 = g.g0 = 0;
  return g;
}

WF_HD WfGeo wf_at(WfGeo g, int64_t tile) {
  g.t0 = tile * g.rows;
  g.g0 = g.t0 - g.hb;
  return g;
}

WF_HD int64_t wf_up16(int64_t b) { return (b + 15) & ~(int64_t)15; }

// One buffer of staged rows: values (their bits; order keys, then P, for
// segmented extremes; the prefix sum for an int64 sum), validity,
// partition starts, each at its source's phase modulo 16.
struct WfBuf {
  int64_t* v;
  uint8_t* ok;
  uint8_t* fl;
};

// A block's shared memory, each array from a 16-byte boundary.
struct WfSmem {
  uint8_t* v_out;   // the tile's results
  uint8_t* ok_out;
  WfBuf buf0;       // buffer 0; buffer 1 ``stride`` bytes on (``wf_buf``)
  int64_t stride;
  uint32_t* fmask;  // partition starts, a bit a staged row (mw + 1 words:
  uint32_t* vmask;  // the last is 0), and valid rows
  int32_t* cntw;    // valid rows in the words before each word
  int32_t* lsw;     // the last start before each word (-1: none)
  int32_t* nsw;     // the first start after each word (m: none)
  int64_t* sx;      // S (segmented extremes)
  int64_t* pv;      // the row scans' partials [scans][nt]: a value, and
  uint8_t* pf;      // whether the chunk holds a segment's reset
};

template <typename T, int OP, bool SEG>
WF_HD int64_t wf_smem_bytes(const WfGeo& g) {
  typedef WfKind<T, OP, SEG> K;
  const int64_t m = g.m, words = g.mw + 1;
  return wf_up16(8 * (int64_t)g.rows) + wf_up16(g.rows) +
         2 * (wf_up16(8 * m + 16) + 2 * wf_up16(m + 16)) +
         5 * wf_up16(4 * words) + (K::kExt && SEG ? wf_up16(8 * m) : 0) +
         wf_up16(8 * (int64_t)K::kRowScans * g.nt) +
         wf_up16((int64_t)K::kRowScans * g.nt);
}

template <typename T, int OP, bool SEG>
WF_HD WfSmem wf_carve(uint8_t* p, const WfGeo& g, const void* values,
                      const uint8_t* valid, const uint8_t* flags) {
  typedef WfKind<T, OP, SEG> K;
  // tile 0's first staged row: every tile's, modulo 16 bytes
  const int64_t m = g.m, words = g.mw + 1, g0 = -g.hb;
  WfSmem s;
  s.v_out = p;
  p += wf_up16(8 * (int64_t)g.rows);
  s.ok_out = p;
  p += wf_up16(g.rows);
  s.stride = wf_up16(8 * m + 16) + 2 * wf_up16(m + 16);
  s.buf0.v = (int64_t*)(p + tc_phase(values, 8 * g0));
  p += wf_up16(8 * m + 16);
  s.buf0.ok = p + tc_phase(valid, g0);
  p += wf_up16(m + 16);
  s.buf0.fl = p + tc_phase(flags, g0);
  p += wf_up16(m + 16) + s.stride;
  s.fmask = (uint32_t*)p;
  p += wf_up16(4 * words);
  s.vmask = (uint32_t*)p;
  p += wf_up16(4 * words);
  s.cntw = (int32_t*)p;
  p += wf_up16(4 * words);
  s.lsw = (int32_t*)p;
  p += wf_up16(4 * words);
  s.nsw = (int32_t*)p;
  p += wf_up16(4 * words);
  s.sx = (int64_t*)p;
  if (K::kExt && SEG) p += wf_up16(8 * m);
  s.pv = (int64_t*)p;
  p += wf_up16(8 * (int64_t)K::kRowScans * g.nt);
  s.pf = p;
  return s;
}

// Buffer b (0 or 1) of staged rows.
WF_HD WfBuf wf_buf(const WfSmem& s, int b) {
  WfBuf f = s.buf0;
  f.v = (int64_t*)((uint8_t*)f.v + b * s.stride);
  f.ok += b * s.stride;
  f.fl += b * s.stride;
  return f;
}

// Stage the tile's rows into ``bf`` (a count reads no values). Copies in
// flight until the thread waits for its group.
template <int OP>
WF_HD void wf_stage(const WfGeo& g, const WfBuf& bf, const void* values,
                    const uint8_t* valid, const uint8_t* flags, int tid) {
  const int64_t a = g.g0 < 0 ? 0 : g.g0;
  const int64_t e = g.g0 + g.m;
  const int64_t b = e < g.n ? e : g.n;
  const int pa = (int)(a - g.g0), pb = (int)(b - g.g0);
  if (OP != WF_COUNT)
    tc_stage((uint8_t*)(bf.v + pa), (const uint8_t*)values + 8 * a,
             8 * (pb - pa), tid, g.nt);
  tc_stage(bf.ok + pa, valid + a, pb - pa, tid, g.nt);
  tc_stage(bf.fl + pa, flags + a, pb - pa, tid, g.nt);
  for (int p = tid; p < pa; p += g.nt) {  // before row 0
    bf.v[p] = 0;
    bf.ok[p] = 0;
    bf.fl[p] = 0;
  }
  for (int p = pb + tid; p < g.m; p += g.nt) {  // past row n - 1
    bf.v[p] = 0;
    bf.ok[p] = 0;
    bf.fl[p] = 1;
  }
}

// ---------------------------------------------------------------------
// Bitmasks and the scans over their words
// ---------------------------------------------------------------------

// Step 1, before the barrier after the copies: whether the staged rows
// that this thread copied hold a partition start past the first staged
// row or a NULL; the block's OR of it (the barrier's, on the card) says
// whether the tile needs the bitmasks. Without, every frame is whole and
// every count W. Only an interior tile of 16-byte aligned columns is
// checked so (every row there comes in the 16-row pieces that
// tc_stage gives thread c % nt); any other answers yes.
WF_HD bool wf_clamps(const WfGeo& g, const WfBuf& bf, const uint8_t* valid,
                     const uint8_t* flags, int tid) {
  if (g.g0 < 0 || g.g0 + g.m > g.n || tc_phase(valid, g.g0) ||
      tc_phase(flags, g.g0))
    return true;
  for (int c = tid; c < g.m / 16; c += g.nt) {
    uint32_t f[4], v[4];
    memcpy(f, bf.fl + 16 * c, 16);
    memcpy(v, bf.ok + 16 * c, 16);
    if (c == 0) f[0] &= ~0xffu;  // staged row 0 clamps nothing
    for (int k = 0; k < 4; ++k)
      if (f[k] || v[k] != 0x01010101u) return true;
  }
  return false;
}

// Step 2 (where the tile needs them): the bitmasks of partition starts
// and valid rows, a word a 32 staged rows (a ballot on the card), and the
// 0 word after them.
WF_HD void wf_masks(const WfGeo& g, const WfSmem& s, const WfBuf& bf,
                    int tid) {
  const int lane = tid & 31, nw = (g.nt + 31) >> 5;
#ifdef __CUDA_ARCH__
  for (int q = tid >> 5; q <= g.mw; q += nw) {
    const int p = q * 32 + lane;
    const bool in = p < g.m;
    const uint32_t f = __ballot_sync(0xffffffffu, in && bf.fl[p]);
    const uint32_t v = __ballot_sync(0xffffffffu, in && bf.ok[p]);
    if (lane == 0) {
      s.fmask[q] = f;
      s.vmask[q] = v;
    }
  }
#else
  if (lane) return;
  for (int q = tid >> 5; q <= g.mw; q += nw) {
    uint32_t f = 0, v = 0;
    for (int k = 0; k < 32; ++k) {
      const int p = q * 32 + k;
      if (p < g.m && bf.fl[p]) f |= 1u << k;
      if (p < g.m && bf.ok[p]) v |= 1u << k;
    }
    s.fmask[q] = f;
    s.vmask[q] = v;
  }
#endif
}

// Word scan ``sc``'s element at word q: 0, the valid rows; 1, the word's
// last start (-1: none); 2, its first (m: none).
WF_HD int32_t wf_word(const WfGeo& g, const WfSmem& s, int sc, int q) {
  if (sc == 0) return wf_popc(s.vmask[q]);
  const uint32_t f = s.fmask[q];
  if (sc == 1) return f ? q * 32 + wf_high_bit(f) : -1;
  return f ? q * 32 + wf_low_bit(f) : g.m;
}

// Word scan ``sc``'s combine, direction, identity and result array.
WF_HD void wf_word_scan_of(const WfGeo& g, const WfSmem& s, int sc,
                           int* comb, bool* rev, int32_t* ident,
                           int32_t** out) {
  *rev = sc == 2;
  *comb = sc == 0 ? WF_C_ADD : sc == 1 ? WF_C_MAX : WF_C_MIN;
  *ident = sc == 0 ? 0 : sc == 1 ? -1 : g.m;
  *out = sc == 0 ? s.cntw : sc == 1 ? s.lsw : s.nsw;
}

// Step 3 (where the tile needs them; warps 0-2): each word scan,
// exclusive in its order (the first start after a word: from the last
// word back).
WF_HD void wf_words(const WfGeo& g, const WfSmem& s, int tid) {
  const int nq = g.mw + 1;
#ifdef __CUDA_ARCH__
  const int sc = tid >> 5, lane = tid & 31, per = (nq + 31) / 32;
  if (sc > 2) return;
  int comb;
  bool rev;
  int32_t ident, *out;
  wf_word_scan_of(g, s, sc, &comb, &rev, &ident, &out);
  int32_t agg = ident;
  for (int k = lane * per; k < lane * per + per && k < nq; ++k)
    agg = (int32_t)wf_comb(comb, agg,
                           wf_word(g, s, sc, rev ? nq - 1 - k : k));
  for (int d = 1; d < 32; d <<= 1) {  // inclusive, over the lanes
    const int32_t o = __shfl_up_sync(0xffffffffu, agg, d);
    if (lane >= d) agg = (int32_t)wf_comb(comb, o, agg);
  }
  int32_t run = __shfl_up_sync(0xffffffffu, agg, 1);
  if (lane == 0) run = ident;
  for (int k = lane * per; k < lane * per + per && k < nq; ++k) {
    const int q = rev ? nq - 1 - k : k;
    out[q] = run;
    run = (int32_t)wf_comb(comb, run, wf_word(g, s, sc, q));
  }
#else
  if (tid != 0) return;
  for (int sc = 0; sc < 3; ++sc) {
    int comb;
    bool rev;
    int32_t ident, *out;
    wf_word_scan_of(g, s, sc, &comb, &rev, &ident, &out);
    int32_t run = ident;
    for (int k = 0; k < nq; ++k) {
      const int q = rev ? nq - 1 - k : k;
      out[q] = run;
      run = (int32_t)wf_comb(comb, run, wf_word(g, s, sc, q));
    }
  }
#endif
}

// The last partition start at or before staged row p (-1: none).
WF_HD int wf_ls(const WfSmem& s, int p) {
  const int q = p >> 5;
  const uint32_t f = s.fmask[q] & (0xffffffffu >> (31 - (p & 31)));
  return f ? q * 32 + wf_high_bit(f) : s.lsw[q];
}

// The first partition start at or after staged row p <= m (m: none).
WF_HD int wf_ns(const WfSmem& s, int p) {
  const int q = p >> 5;
  const uint32_t f = s.fmask[q] & (0xffffffffu << (p & 31));
  return f ? q * 32 + wf_low_bit(f) : s.nsw[q];
}

// Valid staged rows before row p <= m.
WF_HD int wf_pc(const WfSmem& s, int p) {
  const int q = p >> 5;
  return s.cntw[q] + wf_popc(s.vmask[q] & ((1u << (p & 31)) - 1));
}

// Whether any bit of ``w`` is set in rows [a, b] (a <= b); with ``all``,
// whether any is clear.
WF_HD bool wf_bits_any(const uint32_t* w, int a, int b, bool all) {
  const int qa = a >> 5, qb = b >> 5;
  const uint32_t flip = all ? 0xffffffffu : 0u;
  const uint32_t ma = 0xffffffffu << (a & 31);
  const uint32_t mb = 0xffffffffu >> (31 - (b & 31));
  if (qa == qb) return ((w[qa] ^ flip) & ma & mb) != 0;
  if ((w[qa] ^ flip) & ma) return true;
  for (int q = qa + 1; q < qb; ++q)
    if (w[q] ^ flip) return true;
  return ((w[qb] ^ flip) & mb) != 0;
}

// ---------------------------------------------------------------------
// Scans over the staged rows (the int64 prefix, P and S)
// ---------------------------------------------------------------------

// Whether staged row p starts a segment of the extremes (``r`` is
// p % seg).
WF_HD bool wf_cut(const WfBuf& bf, int p, int r) {
  return r == 0 || bf.fl[p];
}

// One thread's chunk [a, b) of row scan ``sc`` (0: the int64 prefix or P;
// 1: S), from carry ``c`` (and no reset): the running value over the
// chunk in scan order, written back where ``write``. Returns the last
// running value; *f is set where the chunk resets a segment. ``ra`` is
// a % seg.
template <typename T, int OP, bool SEG>
WF_HD int64_t wf_chunk_scan(const WfGeo& g, const WfSmem& s,
                            const WfBuf& bf, int sc, int64_t c, int a,
                            int b, int ra, bool write, uint8_t* f) {
  typedef WfKind<T, OP, SEG> K;
  *f = 0;
  if (K::kIntSum) {
    for (int p = a; p < b; ++p) {
      c = wf_comb(WF_C_ADD, c, bf.v[p]);
      if (write) bf.v[p] = c;
    }
    return c;
  }
  if (sc == 0) {  // P: forward, reset at each segment start
    for (int p = a, r = ra; p < b; ++p, r = r + 1 == g.seg ? 0 : r + 1) {
      if (wf_cut(bf, p, r)) {
        c = bf.v[p];
        *f = 1;
      } else {
        c = wf_comb(K::kExtComb, c, bf.v[p]);
      }
      if (write) bf.v[p] = c;
    }
    return c;
  }
  // S: backward, reset at each segment end (the row before a start, and
  // the last staged row)
  int r = (ra + (b - a)) % g.seg;  // (p + 1) % seg for p = b - 1
  for (int p = b - 1; p >= a; --p) {
    if (p + 1 == g.m || wf_cut(bf, p + 1, r)) {
      c = bf.v[p];
      *f = 1;
    } else {
      c = wf_comb(K::kExtComb, bf.v[p], c);
    }
    if (write) s.sx[p] = c;
    r = r == 0 ? g.seg - 1 : r - 1;
  }
  return c;
}

WF_HD void wf_chunk_of(const WfGeo& g, int tid, int* a, int* b) {
  *a = tid * g.chunk;
  *b = *a + g.chunk;
  if (*a > g.m) *a = g.m;
  if (*b > g.m) *b = g.m;
}

// A row scan's combine, direction and identity.
template <typename T, int OP, bool SEG>
WF_HD void wf_row_scan_of(int sc, int* comb, bool* rev, int64_t* ident) {
  typedef WfKind<T, OP, SEG> K;
  *rev = sc == 1;
  *comb = K::kIntSum ? WF_C_ADD : K::kExtComb;
  *ident = K::kIntSum ? 0 : K::kExtIdent;
}

// Step 2, for the row scans: the thread's chunk made ready (a NULL's
// value 0 for an int64 sum, the identity for extremes; order keys made
// once), then its partial of each row scan.
template <typename T, int OP, bool SEG>
WF_HD void wf_reduce(const WfGeo& g, const WfSmem& s, const WfBuf& bf,
                     int tid) {
  typedef WfKind<T, OP, SEG> K;
  int a, b;
  wf_chunk_of(g, tid, &a, &b);
  for (int p = a; p < b; ++p) {
    if (!bf.ok[p])
      bf.v[p] = K::kExt ? K::kExtIdent : 0;
    else if (K::kExt && K::kFloat)
      bf.v[p] = wf_key(wf_i2d(bf.v[p]));
  }
  const int ra = a % g.seg;
  for (int sc = 0; sc < K::kRowScans; ++sc) {
    int comb;
    bool rev;
    int64_t ident;
    wf_row_scan_of<T, OP, SEG>(sc, &comb, &rev, &ident);
    uint8_t f;
    s.pv[sc * g.nt + tid] =
        wf_chunk_scan<T, OP, SEG>(g, s, bf, sc, ident, a, b, ra, false, &f);
    s.pf[sc * g.nt + tid] = f;
  }
}

// Partial q of a scan in its order (a backward scan from the right).
WF_HD int wf_part(int q, int nt, bool rev) { return rev ? nt - 1 - q : q; }

// The partials [lane * per, lane * per + per) of a scan, in its order,
// combined: (*f, *v).
WF_HD void wf_lane_reduce(const int64_t* pv, const uint8_t* pf, int nt,
                          int per, bool rev, int comb, int64_t ident,
                          int lane, uint8_t* f, int64_t* v) {
  uint8_t af = 0;
  int64_t av = ident;
  for (int q = lane * per; q < lane * per + per && q < nt; ++q) {
    const int t = wf_part(q, nt, rev);
    av = pf[t] ? pv[t] : wf_comb(comb, av, pv[t]);
    af |= pf[t];
  }
  *f = af;
  *v = av;
}

// The same partials replaced by their chunks' carries, from the lane's
// carry ``cv``.
WF_HD void wf_lane_carry(int64_t* pv, const uint8_t* pf, int nt, int per,
                         bool rev, int comb, int lane, int64_t cv) {
  for (int q = lane * per; q < lane * per + per && q < nt; ++q) {
    const int t = wf_part(q, nt, rev);
    const int64_t v = pv[t];
    pv[t] = cv;
    cv = pf[t] ? v : wf_comb(comb, cv, v);
  }
}

// Step 3, for the row scans (row scan sc on warp (3 + sc) % warps, after
// the word scan of warp sc < 3): each chunk's carry.
template <typename T, int OP, bool SEG>
WF_HD void wf_carries(const WfGeo& g, const WfSmem& s, int tid) {
  typedef WfKind<T, OP, SEG> K;
  const int per = (g.nt + 31) / 32;
#ifdef __CUDA_ARCH__
  const int warps = (g.nt + 31) >> 5, lane = tid & 31;
  const int sc = ((tid >> 5) - 3 + warps) % warps;
  if (sc >= K::kRowScans) return;
  int comb;
  bool rev;
  int64_t ident;
  wf_row_scan_of<T, OP, SEG>(sc, &comb, &rev, &ident);
  int64_t* pv = s.pv + sc * g.nt;
  const uint8_t* pf = s.pf + sc * g.nt;
  uint8_t f;
  int64_t v;
  wf_lane_reduce(pv, pf, g.nt, per, rev, comb, ident, lane, &f, &v);
  int fi = f;
  for (int d = 1; d < 32; d <<= 1) {  // inclusive, over the lanes
    const int64_t ov = __shfl_up_sync(0xffffffffu, v, d);
    const int of = __shfl_up_sync(0xffffffffu, fi, d);
    if (lane >= d) {
      v = fi ? v : wf_comb(comb, ov, v);
      fi |= of;
    }
  }
  int64_t cv = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 0) cv = ident;
  wf_lane_carry(pv, pf, g.nt, per, rev, comb, lane, cv);
#else
  if (tid != 0) return;
  for (int sc = 0; sc < K::kRowScans; ++sc) {
    int comb;
    bool rev;
    int64_t ident;
    wf_row_scan_of<T, OP, SEG>(sc, &comb, &rev, &ident);
    int64_t* pv = s.pv + sc * g.nt;
    const uint8_t* pf = s.pf + sc * g.nt;
    uint8_t lf[32];
    int64_t lv[32];
    for (int lane = 0; lane < 32; ++lane)
      wf_lane_reduce(pv, pf, g.nt, per, rev, comb, ident, lane, &lf[lane],
                     &lv[lane]);
    int64_t cv = ident;
    for (int lane = 0; lane < 32; ++lane) {
      wf_lane_carry(pv, pf, g.nt, per, rev, comb, lane, cv);
      cv = lf[lane] ? lv[lane] : wf_comb(comb, cv, lv[lane]);
    }
  }
#endif
}

// Step 4, for the row scans: each thread rescans its chunk from its
// carries (S first: P overwrites the keys it reads).
template <typename T, int OP, bool SEG>
WF_HD void wf_rescan(const WfGeo& g, const WfSmem& s, const WfBuf& bf,
                     int tid) {
  typedef WfKind<T, OP, SEG> K;
  int a, b;
  wf_chunk_of(g, tid, &a, &b);
  const int ra = a % g.seg;
  for (int sc = K::kRowScans - 1; sc >= 0; --sc) {
    uint8_t f;
    wf_chunk_scan<T, OP, SEG>(g, s, bf, sc, s.pv[sc * g.nt + tid], a, b,
                              ra, true, &f);
  }
}

// ---------------------------------------------------------------------
// The rows
// ---------------------------------------------------------------------

// A float64 sum's walk: a value, or +0.0 for a NULL.
struct WfAdd {
  const int64_t* v;
  const uint8_t* ok;
  bool full;  // no NULL in the walk
  WF_HD double load(int j) const {
    return full || ok[j] ? wf_i2d(v[j]) : 0.0;
  }
  WF_HD void add(double& acc, double u) const { acc += u; }
};

// A narrow extreme's walk: a value's order key, or the identity for a
// NULL.
template <typename T, int OP>
struct WfExt {
  const int64_t* v;
  const uint8_t* ok;
  bool full;
  WF_HD int64_t load(int j) const {
    typedef WfKind<T, OP, false> K;
    if (!full && !ok[j]) return K::kExtIdent;
    return K::kFloat ? wf_key(wf_i2d(v[j])) : v[j];
  }
  WF_HD void add(int64_t& acc, int64_t u) const {
    acc = wf_comb(WfKind<T, OP, false>::kExtComb, acc, u);
  }
};

// The R rows' walk over the union of their frames, from staged row
// ``base`` (the first row's first): row r takes the walk's k in
// [r, r + W) (``whole``), or where its row base + k lies in [x[r], y[r]].
// Each row's values come in ascending row order.
template <typename A, class F>
WF_HD void wf_walk(A* acc, int base, int W, bool whole, const int* x,
                   const int* y, const F& f) {
  const int R = WF_TILE_R;
  if (W <= 0) return;
  if (whole) {
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int k = 0; k < R - 1; ++k) {  // the first rows' frames begin
      const A u = f.load(base + k);
#ifdef __CUDACC__
#pragma unroll
#endif
      for (int r = 0; r <= k; ++r)
        if (k - r < W) f.add(acc[r], u);
    }
    for (int k = R - 1; k < W; ++k) {  // every row's frame
      const A u = f.load(base + k);
#ifdef __CUDACC__
#pragma unroll
#endif
      for (int r = 0; r < R; ++r) f.add(acc[r], u);
    }
    for (int k = W > R - 1 ? W : R - 1; k < W + R - 1; ++k) {
      const A u = f.load(base + k);  // the last rows' frames end
#ifdef __CUDACC__
#pragma unroll
#endif
      for (int r = 0; r < R; ++r)
        if (k - r < W) f.add(acc[r], u);
    }
    return;
  }
  for (int k = 0; k < W + R - 1; ++k) {  // a start clamps: test each add
    const int j = base + k;
    const A u = f.load(j);
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int r = 0; r < R; ++r)
      if (j >= x[r] && j <= y[r]) f.add(acc[r], u);
  }
}

// Step 5: the thread's R rows' results, into shared memory (``masks``:
// whether the tile built its bitmasks).
template <typename T, int OP, bool SEG>
WF_HD void wf_rows(const WfGeo& g, const WfSmem& s, const WfBuf& bf,
                   int tid, bool masks) {
  typedef WfKind<T, OP, SEG> K;
  const int R = WF_TILE_R, W = g.w;
  const int li0 = g.hb + tid * R;  // the thread's first row, staged
  const int base = li0 + g.lo;     // its first row's frame's first row
  int x[R], y[R];
  // whole: no partition start clamps a frame (none in (i + lo, i] or
  // (i, i + hi] of any row i); full: no NULL in the frames' union
  bool whole = true, full = true;
  if (W > 0 && masks) {
    whole = !wf_bits_any(s.fmask, li0 + (g.lo < 0 ? g.lo : 0) + 1,
                         li0 + R - 1 + (g.hi > 0 ? g.hi : 0), false);
    full = !wf_bits_any(s.vmask, base, li0 + R - 1 + g.hi, true);
  }
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int r = 0; r < R; ++r) {
    x[r] = base + r;
    y[r] = base + r + W - 1;
    if (W > 0 && !whole) {
      const int a = wf_ls(s, li0 + r), e = wf_ns(s, li0 + r + 1) - 1;
      if (a > x[r]) x[r] = a;
      if (e < y[r]) y[r] = e;
    }
  }
  int64_t* vo = (int64_t*)s.v_out + tid * R;
  uint8_t* oo = s.ok_out + tid * R;
  // row r's count of valid rows, after the walk (fewer registers live
  // through it)
#define WF_COUNT_OF(r)                        \
  (x[r] > y[r]     ? 0                        \
   : whole && full ? W                        \
                   : wf_pc(s, y[r] + 1) - wf_pc(s, x[r]))
  if (K::kFloatSum) {
    double acc[R];
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int r = 0; r < R; ++r) acc[r] = 0.0;
    const WfAdd f = {bf.v, bf.ok, full};
    wf_walk(acc, base, W, whole, x, y, f);
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int r = 0; r < R; ++r) {
      const int c = WF_COUNT_OF(r);
      vo[r] = wf_d2i(OP == WF_AVG ? (c ? acc[r] / (double)c : 0.0) : acc[r]);
      oo[r] = c > 0;
    }
    return;
  }
  if (K::kExt && !SEG) {
    int64_t acc[R];
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int r = 0; r < R; ++r) acc[r] = K::kExtIdent;
    const WfExt<T, OP> f = {bf.v, bf.ok, full};
    wf_walk(acc, base, W, whole, x, y, f);
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int r = 0; r < R; ++r) {
      const int c = WF_COUNT_OF(r);
      vo[r] = !c ? 0 : K::kFloat ? wf_d2i(wf_unkey(acc[r])) : acc[r];
      oo[r] = c > 0;
    }
    return;
  }
  int xm = base % g.seg;  // x[r] % seg of a whole frame
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int r = 0; r < R; ++r, xm = xm + 1 == g.seg ? 0 : xm + 1) {
    const int c = WF_COUNT_OF(r);
    int64_t v = c;
    if (K::kIntSum) {
      v = x[r] > y[r] ? 0
                      : (int64_t)((uint64_t)bf.v[y[r]] -
                                  (uint64_t)(x[r] > 0 ? bf.v[x[r] - 1] : 0));
    } else if (K::kExt) {  // the segments
      v = 0;
      if (c) {
        const int xr = whole ? xm : x[r] % g.seg;
        if (xr + (y[r] - x[r]) >= g.seg)
          v = wf_comb(K::kExtComb, s.sx[x[r]], bf.v[y[r]]);
        else if (xr == 0 || bf.fl[x[r]])
          v = bf.v[y[r]];
        else
          v = s.sx[x[r]];
        if (K::kFloat) v = wf_d2i(wf_unkey(v));
      }
    }
    vo[r] = v;
    oo[r] = OP == WF_COUNT || c > 0;
  }
#undef WF_COUNT_OF
}

// Step 6: the tile's results to device memory (``out`` and ``out_valid``
// 16-byte aligned, as are the tile's rows: 8 * rows and rows are
// multiples of 16).
WF_HD void wf_store(const WfGeo& g, const WfSmem& s, void* out,
                    uint8_t* out_valid, int tid) {
  const int rows = g.n - g.t0 < g.rows ? (int)(g.n - g.t0) : g.rows;
  tc_store((uint8_t*)out + 8 * g.t0, s.v_out, 8 * rows, tid, g.nt);
  tc_store(out_valid + g.t0, s.ok_out, rows, tid, g.nt);
}
