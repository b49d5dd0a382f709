// The per-row logic of the distinct_flag kernel (csrc/distinct_flag.cu):
// the normalisation of a key word, the hash, the slot compare and the
// insert-or-find step of the open-addressing table.
// Everything here is __host__ __device__, so g++ builds it on a machine
// without CUDA and the tests run the kernel's two phases on the host,
// the probing rows' steps interleaved in shuffled orders, the phases
// split where the kernel's grid barrier splits them
// (tests/test_torch_distinct.py).
//
// A key is (group word, group null bit, value word). A word is the
// column's value normalised so that equal SQL values have equal words:
// narrow integers sign-extend to 64 bits, floats are their bit patterns
// with -0.0 as +0.0 and every NaN as one pattern (a float32's 32-bit
// pattern, sign-extended). A NULL group is a real group: its word is 0
// and its null bit 1. Full keys are stored and compared; no result
// relies on the hash being unique.
//
// A slot is 32 bytes, one sector of device memory: the two key words, a
// state word and the first row. The state word is EMPTY (0), BUSY (a
// thread has claimed the slot and is writing its key) or READY:
// (epoch << 1) | group null bit, where the epoch is the batch that
// inserted the key (1, 2, ...; the host advances it every batch, so no
// table is ever cleared between batches). ``first`` holds the lowest row
// of that batch with the key (atomicMin).
//
// The slot protocol: a thread claims an EMPTY slot by compare-and-swap
// to BUSY, writes the key words and its row with plain stores, and
// publishes READY with a release store. A prober reads the state with an
// acquire load: BUSY sends it back to read again (the owner is one step
// from publishing), READY makes the owner's words visible to its next
// loads. A compare-and-swap that loses sends the prober back to the
// acquire load, so no key word is read after a relaxed operation alone.
// On the host the three are plain operations: the test's one-step moves
// stand in for the threads.
#pragma once
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define DF_HD __host__ __device__ __forceinline__
#else
#define DF_HD inline
#endif

// the element type of a key column, read raw (the wrapper's
// exec/distinct_flag.py _KIND); a bool column is read as int8
enum DfKind { DF_I8 = 0, DF_I16 = 1, DF_I32 = 2, DF_I64 = 3, DF_F32 = 4,
              DF_F64 = 5 };

struct alignas(32) DfSlot {
  int64_t val;
  int64_t grp;
  uint32_t state;
  int32_t first;
  int64_t pad;
};
static_assert(sizeof(DfSlot) == 32, "a slot is one 32-byte sector");

constexpr uint32_t kDfEmpty = 0u;
constexpr uint32_t kDfBusy = 0xFFFFFFFFu;
// the largest epoch: READY words stay below BUSY
constexpr int64_t kDfMaxEpoch = (int64_t)1 << 30;

DF_HD uint32_t df_ready(int64_t epoch, bool gnull) {
  return ((uint32_t)epoch << 1) | (gnull ? 1u : 0u);
}
DF_HD int64_t df_epoch(uint32_t state) { return (int64_t)(state >> 1); }
DF_HD bool df_gnull(uint32_t state) { return (state & 1u) != 0; }

DF_HD int64_t df_norm_f64(double d) {
  if (d != d) return 0x7FF8000000000000LL;  // every NaN as numpy's nan
  d = d == 0.0 ? 0.0 : d;                   // -0.0 as +0.0
  int64_t bits;
  memcpy(&bits, &d, sizeof bits);
  return bits;
}

DF_HD int64_t df_norm_f32(float f) {
  if (f != f) return 0x7FC00000LL;
  f = f == 0.0f ? 0.0f : f;
  int32_t bits;
  memcpy(&bits, &f, sizeof bits);
  return bits;  // sign-extended
}

// row i of a column of ``kind``, normalised
DF_HD int64_t df_norm(const void* col, int kind, int64_t i) {
  switch (kind) {
    case DF_I8: return ((const int8_t*)col)[i];
    case DF_I16: return ((const int16_t*)col)[i];
    case DF_I32: return ((const int32_t*)col)[i];
    case DF_I64: return ((const int64_t*)col)[i];
    case DF_F32: return df_norm_f32(((const float*)col)[i]);
    default: return df_norm_f64(((const double*)col)[i]);
  }
}

// splitmix64's finaliser over the key's words
DF_HD uint64_t df_hash(int64_t val, int64_t grp, bool gnull) {
  uint64_t x = (uint64_t)val ^ ((uint64_t)grp * 0x9E3779B97F4A7C15ULL) ^
               ((uint64_t)gnull << 1);
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// One thread's probe: the slot it looks at, the slots it has passed, and
// whether it has claimed the slot (then its next step writes the key).
struct DfProbe {
  int64_t pos;
  int64_t steps;
  int owned;
};

DF_HD DfProbe df_probe(int64_t val, int64_t grp, bool gnull, int64_t mask) {
  DfProbe p;
  p.pos = (int64_t)(df_hash(val, grp, gnull) & (uint64_t)mask);
  p.steps = 0;
  p.owned = 0;
  return p;
}

enum DfStep { DF_AGAIN = 0, DF_DONE = 1, DF_FAIL = 2 };

// One step of inserting or finding the key (val, grp, gnull) in a table
// of mask + 1 slots. ``ready`` is the state word to publish for a new
// key and ``first`` its row; ``copy`` (a rehash: every key is new)
// fails on a key found. On DF_DONE, ``*slot`` is the key's slot when
// the key is new in the epoch of ``ready`` (inserted now, or by another
// row of this batch, whose ``first`` then takes the lower row), else -1;
// ``p.owned`` is then 1 when this thread inserted the key. DF_FAIL:
// every slot has been passed (the table is full) or a rehash found its
// key.
//
// ``ops`` are the memory operations (the protocol above): on the card an
// acquire load, atomicCAS, a release store, volatile loads of the key
// words and atomicMin; on the host, plain ones.
template <class Ops>
DF_HD int df_step(DfSlot* table, int64_t mask, int64_t val, int64_t grp,
                  bool gnull, uint32_t ready, int32_t first, bool copy,
                  DfProbe& p, int64_t* slot, const Ops& ops) {
  DfSlot* s = table + p.pos;
  if (p.owned) {
    s->val = val;
    s->grp = grp;
    s->first = first;
    ops.publish(&s->state, ready);
    *slot = p.pos;
    return DF_DONE;
  }
  const uint32_t st = ops.load(&s->state);
  if (st == kDfEmpty) {
    // claimed: write the key next; lost: read the state again
    p.owned = ops.cas(&s->state, kDfEmpty, kDfBusy) == kDfEmpty;
    return DF_AGAIN;
  }
  if (st == kDfBusy) return DF_AGAIN;  // the owner is writing: look again
  if (df_gnull(st) == gnull && ops.load64(&s->val) == val &&
      ops.load64(&s->grp) == grp) {
    if (copy) return DF_FAIL;
    if (df_epoch(st) == df_epoch(ready)) {
      ops.min(&s->first, first);
      *slot = p.pos;
    } else {
      *slot = -1;
    }
    return DF_DONE;
  }
  if (++p.steps > mask) return DF_FAIL;
  p.pos = (p.pos + 1) & mask;
  return DF_AGAIN;
}

// Phase 2's flag of row ``i`` whose phase 1 gave ``slot``: the row is
// the first of its key in the stream. ``first`` is read past the L1
// (volatile): other SMs' atomicMin wrote it before the grid barrier.
DF_HD bool df_flag(const DfSlot* table, int32_t slot, int64_t i) {
  return slot >= 0 &&
         (int64_t)(*(const volatile int32_t*)&table[slot].first) == i;
}

// Blocks of ``threads`` the kernel's grid takes for ``n`` rows when at
// most ``max_blocks`` are resident together: one row a thread when they
// fit; else every resident block, each thread then walking rows a grid
// apart (a thread holds its first row's slot in a register across the
// barrier, the rows after it keep theirs in scratch).
DF_HD int64_t df_grid_blocks(int64_t n, int64_t threads, int64_t max_blocks) {
  const int64_t need = (n + threads - 1) / threads;
  return need < max_blocks ? need : max_blocks;
}
