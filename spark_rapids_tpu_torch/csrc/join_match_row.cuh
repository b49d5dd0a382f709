// The per-row logic of the join_match kernels (csrc/join_match.cu): the
// key hash, the key compare, the open-addressing insert and lookup, and
// one stream row's probe and emit. Everything here is __host__
// __device__, so g++ builds it on a machine without CUDA and the tests
// run the kernels' loops on the host (tests/test_torch_joins.py).
//
// A key is W int64 words, row-major ([rows, W]); the wrapper encodes each
// key column as one word in a form where equal keys have equal words
// (floats as the integers of their total order, NaN canonical, -0.0 as
// 0.0). The table holds int32 unique-key ids, -1 for an empty slot; its
// capacity is a power of two at least twice the number of unique keys,
// so linear probing always ends.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define JM_HD __host__ __device__ __forceinline__
#else
#define JM_HD inline
#endif

// splitmix64's finalizer: every input bit reaches every output bit
JM_HD uint64_t jm_mix(uint64_t x) {
  x ^= x >> 30;
  x *= 0xbf58476d1ce4e5b9ULL;
  x ^= x >> 27;
  x *= 0x94d049bb133111ebULL;
  x ^= x >> 31;
  return x;
}

JM_HD uint64_t jm_hash(const int64_t* key, int W) {
  uint64_t h = 0x9e3779b97f4a7c15ULL;
  for (int w = 0; w < W; ++w) h = jm_mix(h ^ (uint64_t)key[w]);
  return h;
}

JM_HD bool jm_equal(const int64_t* a, const int64_t* b, int W) {
  for (int w = 0; w < W; ++w)
    if (a[w] != b[w]) return false;
  return true;
}

// Insert unique key id u at the first free slot from its hash. ``cas``
// is compare-and-swap of a slot from -1 to u, returning the slot's value
// before (atomicCAS on the card). The keys are distinct, so which thread
// wins a slot changes where a key sits, never what a lookup finds.
template <class Cas>
JM_HD void jm_insert(int32_t* table, int64_t mask, const int64_t* key, int W,
                     int32_t u, Cas cas) {
  int64_t s = (int64_t)(jm_hash(key, W) & (uint64_t)mask);
  while (cas(table + s, u) != -1) s = (s + 1) & mask;
}

// The unique-key id whose words equal ``key``, or -1.
JM_HD int32_t jm_find(const int32_t* table, int64_t mask,
                      const int64_t* ukeys, int W, const int64_t* key) {
  int64_t s = (int64_t)(jm_hash(key, W) & (uint64_t)mask);
  while (true) {
    int32_t u = table[s];
    if (u < 0) return -1;
    if (jm_equal(ukeys + (int64_t)u * W, key, W)) return u;
    s = (s + 1) & mask;
  }
}

// Probe pass 1 for one stream row: its unique-key id (-1 for a null key
// or no match) and its match count.
JM_HD int64_t jm_probe_row(const int64_t* key, bool null, int W,
                           const int32_t* table, int64_t mask,
                           const int64_t* ukeys, const int64_t* ucount,
                           int32_t* uid) {
  int32_t u = null ? -1 : jm_find(table, mask, ukeys, W, key);
  *uid = u;
  return u < 0 ? 0 : ucount[u];
}

// Probe pass 2 for stream row i: its pairs (i, build row) at ``off``, the
// build rows of its key in ascending order; with ``outer`` a row without
// a match writes (i, -1).
JM_HD void jm_emit_row(int64_t i, int64_t off, int64_t count, int32_t uid,
                       const int64_t* ustart, const int64_t* sorted_rows,
                       bool outer, int64_t* out_s, int64_t* out_b) {
  if (count == 0) {
    if (outer) {
      out_s[off] = i;
      out_b[off] = -1;
    }
    return;
  }
  const int64_t* rows = sorted_rows + ustart[uid];
  for (int64_t j = 0; j < count; ++j) {
    out_s[off + j] = i;
    out_b[off + j] = rows[j];
  }
}
