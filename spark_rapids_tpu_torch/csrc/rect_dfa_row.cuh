// Per-row logic of the DFA walk over a byte rectangle, shared by the CUDA
// kernel (rect_dfa.cu) and a host build: outside nvcc the two function
// qualifiers are defined empty, so g++ compiles and tests the same code
// (tests/test_torch_regex.py, tests/test_torch_rect_dfa.py).
//
// A DFA (exprs/regex_dfa.py) is a class for each byte value (`classes`,
// 256 bytes), the next state for each state and class (`table`, states x
// n_classes bytes, row-major), a flag for each state that is 1 where a
// string ending there matches (`accept`), the start state, and
// `first_sink`: the states from it on lead back to themselves on every
// byte, so the answer is known once the walk reaches one and it stops.
//
// Two instances walk it. The byte-indexed one looks up
// next[s * kRdNextStride + b] = table[s, classes[b]]: one lookup a byte.
// The class-indexed one looks up the class, then the state: two. Both
// take a row as 16-byte chunks of four little-endian 32-bit words, held
// a group of kRdGroup chunks (64 bytes) at a time. A chunk
// wholly inside the row is walked with no test; only the row's last,
// partial chunk tests the length on each byte, so bytes at or past the
// length never reach the state; the sink is tested once a chunk (a sink
// absorbs every byte, so walking on inside it changes nothing).
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define RD_INLINE inline
#define RD_UNROLL
#define RD_ROLLED
#else
#define RD_INLINE __forceinline__
#define RD_UNROLL _Pragma("unroll")
#define RD_ROLLED _Pragma("unroll 1")
#endif

constexpr int kRdMaxStates = 256;        // a state fits a byte
constexpr int kRdMaxTableBytes = 32768;  // states x classes
// Bytes between two states' rows of the byte-indexed table in shared
// memory: 256 and 24 more, so that the same byte in two states falls in
// banks 6 apart (ASCII text keeps its bytes in a few banks).
constexpr int kRdNextStride = 280;
// The most states the byte-indexed instance takes: its table then fits
// the 48 KB a block has without opting in to more (exec/rect_dfa.py
// BYTE_STATES; rect_dfa.cu's note gives the times behind it).
constexpr int kRdByteStates = 168;
// Chunks a thread holds of a row (64 bytes: an l_comment row whole); a
// wider row's later groups are read when its walk gets there.
constexpr int kRdGroup = 4;

struct RdTables {
  const uint8_t* classes;  // [256]
  const uint8_t* table;    // [n_states * n_classes]
  const uint8_t* accept;   // [n_states]
  int n_classes;
  int start;
  int first_sink;
};

// Byte j (0-3) of a word.
RD_INLINE __host__ __device__ uint32_t rd_byte(uint32_t w, int j) {
#ifdef __CUDA_ARCH__
  return __byte_perm(w, 0u, 0x4440u + (uint32_t)j);
#else
  return (w >> (8 * j)) & 0xffu;
#endif
}

// The class-indexed instance's step: the byte's class, then the state.
struct RdClassStep {
  const uint8_t* classes;
  const uint8_t* table;
  int n_classes;
  RD_INLINE __host__ __device__ int operator()(int s, uint32_t b) const {
    return table[s * n_classes + classes[b]];
  }
};

// The byte-indexed instance's step: one lookup in rows kRdNextStride
// apart.
struct RdByteStep {
  const uint8_t* next;
  RD_INLINE __host__ __device__ int operator()(int s, uint32_t b) const {
    return next[s * kRdNextStride + (int)b];
  }
};

// A chunk wholly inside the row: 16 steps, no test.
template <class Step>
RD_INLINE __host__ __device__ int rd_full(const Step& step, int s,
                                          const uint32_t (&w)[4]) {
  RD_UNROLL
  for (int j = 0; j < 16; ++j) s = step(s, rd_byte(w[j >> 2], j & 3));
  return s;
}

// The first n (< 16) bytes of a chunk, the length tested on each.
template <class Step>
RD_INLINE __host__ __device__ int rd_part(const Step& step, int s,
                                          const uint32_t (&w)[4], int n) {
  RD_UNROLL
  for (int j = 0; j < 15; ++j)
    if (j < n) s = step(s, rd_byte(w[j >> 2], j & 3));
  return s;
}

// The state after one group of chunks of which the first n bytes are the
// row's (n >= 16 kRdGroup: all of them), from state s: the whole chunks
// first, then the partial one, so a warp's lanes meet again before it.
template <class Step>
RD_INLINE __host__ __device__ int rd_group(const Step& step, int first_sink,
                                           int s,
                                           const uint32_t (&g)[kRdGroup][4],
                                           int n) {
  const int whole = n >= 16 * kRdGroup ? kRdGroup : n >> 4;
  RD_UNROLL
  for (int c = 0; c < kRdGroup; ++c)
    if (c < whole && s < first_sink) s = rd_full(step, s, g[c]);
  const int rest = n - 16 * whole;
  if (whole < kRdGroup && rest > 0 && s < first_sink) {
    uint32_t w[4] = {g[0][0], g[0][1], g[0][2], g[0][3]};
    RD_UNROLL
    for (int c = 1; c < kRdGroup; ++c)
      if (c == whole) {
        RD_UNROLL
        for (int k = 0; k < 4; ++k) w[k] = g[c][k];
      }
    s = rd_part(step, s, w, rest);
  }
  return s;
}

// The state at the end of a row of `len` bytes (clamped to [0, width]):
// `g` holds the row's first group; `load(i, g)` fills it with group i
// (its chunks c with 16 (kRdGroup i + c) < len) when the walk gets there
// (and not past a sink).
template <class Step, class Load>
RD_INLINE __host__ __device__ int rd_walk(const Step& step, int start,
                                          int first_sink, int len, int width,
                                          uint32_t (&g)[kRdGroup][4],
                                          Load load) {
  len = len < 0 ? 0 : len > width ? width : len;
  int s = start;
  RD_ROLLED
  for (int i = 0; 16 * kRdGroup * i < len && s < first_sink; ++i) {
    if (i > 0) load(i, g);
    s = rd_group(step, first_sink, s, g, len - 16 * kRdGroup * i);
  }
  return s;
}

// A row's bytes to walk: its length clamped to [0, width], or -1 for a
// NULL row (not walked: false).
RD_INLINE __host__ __device__ int rd_span(int len, bool valid, int width) {
  return !valid ? -1 : len < 0 ? 0 : len > width ? width : len;
}

// One thread's rows of the kernel, `first` and then `stride` apart below
// `rows`, through `step`. `span(r)` gives row r's bytes to walk (rd_span;
// -1 past the end too), `valid(r)` whether row r is not NULL (r below
// `rows`), `load(r, n, i, g)` fills g with group i of row r
// of n bytes (chunks c with 16 (kRdGroup i + c) < n; the rest of g
// kept), `store(r, hit)` takes the answer. Before a row's walk the next
// row's first group is loaded, and the span of the row after it (a
// chunk's load waits on its row's length), so their loads are in flight
// during it. Where the start state is a sink every answer is known: no
// byte and no length is read, only the validity, four rows at once.
template <class Step, class Span, class Valid, class Load, class Store>
RD_INLINE __host__ __device__ void rd_thread(
    const Step& step, const uint8_t* accept, int start, int first_sink,
    int width, uint32_t first, uint32_t stride, uint32_t rows, Span span,
    Valid valid, Load load, Store store) {
  if (start >= first_sink) {
    const bool yes = accept[start] != 0;
    RD_ROLLED
    for (uint32_t row = first; row < rows; row += 4 * stride) {
      bool v[4];
      RD_UNROLL
      for (int k = 0; k < 4; ++k) v[k] = valid(row + k * stride);
      RD_UNROLL
      for (int k = 0; k < 4; ++k)
        if (row + k * stride < rows) store(row + k * stride, yes && v[k]);
    }
    return;
  }
  uint32_t g[kRdGroup][4] = {}, ahead[kRdGroup][4] = {};
  uint32_t row = first;
  int len = span(row);
  load(row, len, 0, g);
  int len_next = span(row + stride);
  RD_ROLLED
  for (; row < rows; row += stride) {
    const uint32_t next = row + stride;
    load(next, len_next, 0, ahead);
    const int len_after = span(next + stride);
    bool hit = false;
    if (len >= 0) {
      const uint32_t r = row;
      const int n = len;
      const int s = rd_walk(step, start, first_sink, n, width, g,
                            [&](int i, uint32_t(&h)[kRdGroup][4]) {
                              load(r, n, i, h);
                            });
      hit = accept[s] != 0;
    }
    store(row, hit);
    RD_UNROLL
    for (int c = 0; c < kRdGroup; ++c) {
      RD_UNROLL
      for (int k = 0; k < 4; ++k) g[c][k] = ahead[c][k];
    }
    len = len_next;
    len_next = len_after;
  }
}

// Whether a row of `len` bytes matches through the class-indexed step:
// `load(c, w)` fills w with the row's chunk c (bytes 16c .. 16c + 15).
template <class Load>
RD_INLINE __host__ __device__ bool rd_row(const RdTables& t, int len,
                                          int width, Load load) {
  const int n = len < 0 ? 0 : len > width ? width : len;
  auto group = [&](int i, uint32_t(&g)[kRdGroup][4]) {
    for (int c = 0; c < kRdGroup; ++c)
      if (16 * (kRdGroup * i + c) < n) load(kRdGroup * i + c, g[c]);
  };
  uint32_t g[kRdGroup][4] = {};
  group(0, g);
  const RdClassStep step{t.classes, t.table, t.n_classes};
  return t.accept[rd_walk(step, t.start, t.first_sink, n, width, g,
                          group)] != 0;
}
