// The per-row and per-tile logic of the join_match kernel
// (csrc/join_match.cu): the key hash, the key compare, the
// open-addressing insert and lookup, a stream row's output count, and
// the search from a tile's output index to its stream row and build
// row.
// Everything here is __host__ __device__, so g++ builds it on a machine
// without CUDA and the tests run the kernel's tile loop on the host
// (tests/test_torch_join_match.py).
//
// A key is W int64 words, row-major ([rows, W]); the wrapper encodes each
// key column as one word in a form where equal keys have equal words
// (floats as the integers of their total order, NaN canonical, -0.0 as
// 0.0). The table is int64 slots of W + 1 words (jm_meta), its capacity
// a power of two at least four times the number of distinct keys (a miss
// ends at an empty slot after few steps); a lookup reads one slot a
// step.
//
// The width is a template argument K where the kernel knows it (K = 1, 2
// or 4: the keys lie in registers and the loops unroll) and the runtime
// W otherwise (K = 0).
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define JM_HD __host__ __device__ __forceinline__
#else
#define JM_HD inline
#endif

// The output rows of one stream row, by join kind (the wrapper's
// exec/join_match.py _KIND): the pairs of inner and right joins; at least
// one row for left and full joins (an unmatched row pairs with -1); one
// row for a hit (leftsemi) or a miss (leftanti); none for existence,
// which writes a flag per row and takes no scan.
enum JmKind { JM_PAIRS = 0, JM_OUTER = 1, JM_SEMI = 2, JM_ANTI = 3,
              JM_EXIST = 4 };

// One multiply between two xor-shifts: every input bit reaches the low
// bits a slot index takes (the high half folds into the low before the
// multiply, the product's high bits back after it)
JM_HD uint64_t jm_mix(uint64_t x) {
  x ^= x >> 32;
  x *= 0x9e3779b97f4a7c15ULL;
  return x ^ (x >> 29);
}

template <int K = 0>
JM_HD uint64_t jm_hash(const int64_t* key, int W) {
  const int n = K > 0 ? K : W;
  uint64_t h = 0x9e3779b97f4a7c15ULL;
#pragma unroll
  for (int w = 0; w < n; ++w) h = jm_mix(h ^ (uint64_t)key[w]);
  return h;
}

template <int K = 0>
JM_HD bool jm_equal(const int64_t* a, const int64_t* b, int W) {
  const int n = K > 0 ? K : W;
  bool eq = true;
#pragma unroll
  for (int w = 0; w < n; ++w) eq = eq && a[w] == b[w];
  return eq;
}

// A table slot is W key words and a meta word: the key's first position
// in the sorted build rows (low 32 bits) and its row count (high 32
// bits). A meta word of 0 marks an empty slot: every key has a row.
JM_HD int64_t jm_meta(int64_t start, int64_t count) {
  return (int64_t)((uint64_t)start | ((uint64_t)count << 32));
}
JM_HD int64_t jm_meta_start(int64_t meta) {
  return meta == 0 ? -1 : (int64_t)(uint32_t)meta;
}
JM_HD int64_t jm_meta_count(int64_t meta) {
  return (int64_t)((uint64_t)meta >> 32);
}

// Insert a distinct key with its meta word at the first free slot from
// its hash. ``cas`` is compare-and-swap of a meta word from 0 to ``meta``,
// returning the word before (atomicCAS on the card); the winner writes
// the key words. The keys are distinct, so which thread wins a slot
// changes where a key sits, never what a lookup finds; lookups run in a
// later launch.
template <class Cas>
JM_HD void jm_insert(int64_t* table, int64_t mask, const int64_t* key, int W,
                     int64_t meta, Cas cas) {
  int64_t s = (int64_t)(jm_hash(key, W) & (uint64_t)mask);
  while (cas(table + s * (W + 1) + W, meta) != 0) s = (s + 1) & mask;
  for (int w = 0; w < W; ++w) table[s * (W + 1) + w] = key[w];
}

// A slot's K key words and meta word (K + 1 words): for K = 1 one
// 16-byte load on the card.
template <int K>
JM_HD void jm_load_slot(const int64_t* e, int64_t* out) {
#ifdef __CUDA_ARCH__
  if constexpr (K == 1) {
    const longlong2 v = *reinterpret_cast<const longlong2*>(e);
    out[0] = v.x;
    out[1] = v.y;
    return;
  }
#endif
#pragma unroll
  for (int w = 0; w <= K; ++w) out[w] = e[w];
}

// The meta word of the slot whose key words equal ``key``, or 0: K words
// when K > 0 (the key in registers, a slot one load for K = 1), else W.
template <int K = 0>
JM_HD int64_t jm_find(const int64_t* table, int64_t mask, int W,
                      const int64_t* key) {
  if constexpr (K > 0) {
    int64_t s = (int64_t)(jm_hash<K>(key, K) & (uint64_t)mask);
    while (true) {
      int64_t e[K + 1];
      jm_load_slot<K>(table + s * (K + 1), e);
      if (e[K] == 0 || jm_equal<K>(e, key, K)) return e[K];
      s = (s + 1) & mask;
    }
  } else {
    int64_t s = (int64_t)(jm_hash(key, W) & (uint64_t)mask);
    while (true) {
      const int64_t* e = table + s * (W + 1);
      const int64_t meta = e[W];
      if (meta == 0 || jm_equal(e, key, W)) return meta;
      s = (s + 1) & mask;
    }
  }
}

// The output rows of a tile's row slot whose lookup gave ``meta``
// (jm_meta; 0: no match), by join kind (JmKind); a slot past the end of
// the stream rows (the last tile's) gives none.
JM_HD int64_t jm_row_out(int kind, int64_t meta, bool in_rows) {
  if (!in_rows) return 0;
  const int64_t count = jm_meta_count(meta);
  switch (kind) {
    case JM_PAIRS: return count;
    case JM_OUTER: return count > 0 ? count : 1;
    case JM_SEMI: return count > 0 ? 1 : 0;
    case JM_ANTI: return count > 0 ? 0 : 1;
    default: return 0;
  }
}

// Output index ``o`` of a tile whose rows' output counts have the
// inclusive scan ``incl[0 .. rows)`` (0 <= o < incl[rows - 1]): its row in
// the tile, the first r with incl[r] > o, searched in [lo, rows). A
// thread whose indices grow passes its last row as ``lo``. int64
// offsets throughout: a tile's outputs may pass 2^31.
JM_HD int jm_output_row(const int64_t* incl, int lo, int rows, int64_t o) {
  int hi = rows - 1;
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (incl[mid] > o)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// Output ``o`` of the tile falls on tile row r (jm_output_row), whose
// key's build rows start at ``start`` in the sorted build rows (-1: a
// row without a match, which an outer join pairs with -1; jm_meta_start):
// the position of its build row there, start + o's rank among the row's
// outputs, or -1. Leftsemi and leftanti write the stream row alone.
JM_HD int64_t jm_build_pos(int64_t o, const int64_t* incl, int r,
                           int64_t start) {
  return start < 0 ? -1 : start + o - (r > 0 ? incl[r - 1] : 0);
}
