// Per-row logic of the DFA walk over a byte rectangle, shared by the CUDA
// kernel (rect_dfa.cu) and a host build: outside nvcc the two function
// qualifiers are defined empty, so g++ compiles and tests the same code
// (tests/test_torch_regex.py).
//
// A DFA (exprs/regex_dfa.py) is a class for each byte value (`classes`,
// 256 bytes), the next state for each state and class (`table`, states x
// n_classes bytes, row-major), a flag for each state that is 1 where a
// string ending there matches (`accept`), the start state, and
// `first_sink`: the states from it on lead back to themselves on every
// byte, so the answer is known once the walk reaches one and it stops.
// A row's bytes arrive in 16-byte chunks of four little-endian 32-bit
// words; bytes at or past the row's length are never looked at.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define RD_INLINE inline
#define RD_UNROLL
#else
#define RD_INLINE __forceinline__
#define RD_UNROLL _Pragma("unroll")
#endif

constexpr int kRdMaxStates = 256;        // a state fits a byte
constexpr int kRdMaxTableBytes = 32768;  // states x classes

struct RdTables {
  const uint8_t* classes;  // [256]
  const uint8_t* table;    // [n_states * n_classes]
  const uint8_t* accept;   // [n_states]
  int n_classes;
  int start;
  int first_sink;
};

// The state after the first n bytes (n may pass 16: the chunk's 16 are
// taken) of one chunk, from state s; a sink stops the walk.
RD_INLINE __host__ __device__ int rd_chunk(const RdTables& t, int s,
                                           const uint32_t (&w)[4], int n) {
  RD_UNROLL
  for (int j = 0; j < 16; ++j) {
    if (j < n && s < t.first_sink) {
      const int b = (int)((w[j >> 2] >> (8 * (j & 3))) & 0xffu);
      s = t.table[s * t.n_classes + t.classes[b]];
    }
  }
  return s;
}

// Whether a row of `len` bytes (clamped to the rectangle's width) matches:
// `load(c, w)` fills w with the row's chunk c (bytes 16c .. 16c + 15).
template <class Load>
RD_INLINE __host__ __device__ bool rd_row(const RdTables& t, int len,
                                          int width, Load load) {
  if (len > width) len = width;
  int s = t.start;
  for (int c = 0; 16 * c < len && s < t.first_sink; ++c) {
    uint32_t w[4];
    load(c, w);
    s = rd_chunk(t, s, w, len - 16 * c);
  }
  return t.accept[s] != 0;
}
