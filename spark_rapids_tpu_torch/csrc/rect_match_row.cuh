// Per-row logic of the byte-rectangle literal match, shared by the CUDA
// kernel (rect_match.cu) and a host build: outside nvcc the two function
// qualifiers are defined empty, so g++ compiles and tests the same code.
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
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

enum RectMatchMode {
  RECT_CONTAINS = 0,
  RECT_STARTSWITH = 1,
  RECT_ENDSWITH = 2,
  RECT_EQUALS = 3,
  RECT_LOCATE = 4,
};

__host__ __device__ inline bool rect_match_at(const uint8_t* row, int s,
                                              const uint8_t* pat, int L) {
  for (int j = 0; j < L; ++j) {
    if (row[s + j] != pat[j]) return false;
  }
  return true;
}

// 0/1 for the bool modes, the 1-based position for locate.
__host__ __device__ inline int32_t rect_match_row(const uint8_t* row,
                                                  int width, int32_t len,
                                                  const uint8_t* pat, int L,
                                                  int mode) {
  if (L == 0) return mode == RECT_EQUALS ? (len == 0) : 1;
  if (L > width) return 0;
  switch (mode) {
    case RECT_STARTSWITH:
      return len >= L && rect_match_at(row, 0, pat, L);
    case RECT_EQUALS:
      return len == L && rect_match_at(row, 0, pat, L);
    case RECT_ENDSWITH: {
      int32_t s = len - L;
      return s >= 0 && s <= width - L && rect_match_at(row, s, pat, L);
    }
    default: {  // contains, locate: scan only the offsets inside the row
      int32_t last = (len < width ? len : width) - L;
      for (int32_t s = 0; s <= last; ++s) {
        if (row[s] == pat[0] && rect_match_at(row, s, pat, L)) {
          return mode == RECT_LOCATE ? s + 1 : 1;
        }
      }
      return 0;
    }
  }
}
