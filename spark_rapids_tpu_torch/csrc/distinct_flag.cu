// distinct_flag: the first stream occurrence of each (group, value) key,
// through a persistent open-addressing hash table on the card.
//
// Replaces the reference's jitted jnp kernels of
// spark_rapids_tpu/exec/distinct_flag.py: ``_probe_insert`` (:83, the
// scatter-min claim rounds in a while_loop), ``_flag_kernel`` (:133) and
// ``_rebuild_kernel`` (:166). The flags must be exactly the reference's:
// true on the LOWEST row of the first batch that holds a key, false on
// every other row and on every row whose value is NULL.
//
// Design (csrc/distinct_flag_row.cuh holds the per-row logic):
//  * two launches a batch. Pass 1 (distinct_flag_insert_kernel): a
//    thread a row inserts or finds its key by linear probing, claiming
//    an EMPTY slot with atomicCAS (EMPTY -> BUSY), writing the key's
//    words and its row, then publishing READY with the batch's epoch
//    after a fence; a prober that meets BUSY reads the word again (the
//    owner is one step from publishing; independent thread scheduling
//    lets a spinning lane and its owner share a warp). A row whose key
//    is new in this batch atomicMins its row into the slot's first-row
//    word and keeps the slot's index in scratch; a key from an earlier
//    batch gives -1. Pass 2 (distinct_flag_mark_kernel) flags a row
//    whose slot's first row is the row. atomicCAS picks any winner
//    among a batch's rows of one key; the min makes the flagged row
//    the lowest, so the flags are the same bits every run.
//  * no memset between batches: the host advances the epoch.
//  * the table's size comes from a host-known bound on the rows
//    inserted (load at most 1/2); growth is a rehash launch
//    (distinct_flag_rehash_kernel) into a larger zeroed table. An insert
//    that passes every slot sets the error word, which the host reads
//    once at the end of the stream.
//
// Bound: memory. Each row's key words and validity are read once, its
// flag written once, and one 32-byte slot (one sector) read, plus one
// written for each new key; the row's 4-byte scratch slot index is
// written and read as well.
#include <cuda_runtime.h>
#include <stdint.h>

#include "distinct_flag_row.cuh"

namespace {

constexpr int kThreads = 256;

struct DeviceOps {
  __device__ uint32_t load(uint32_t* w) const {
    return *(volatile uint32_t*)w;
  }
  __device__ uint32_t cas(uint32_t* w, uint32_t expect,
                          uint32_t value) const {
    return atomicCAS(w, expect, value);
  }
  __device__ void publish(uint32_t* w, uint32_t value) const {
    __threadfence();
    atomicExch(w, value);
  }
  __device__ void acquire() const { __threadfence(); }
  __device__ int64_t load64(int64_t* w) const {
    return *(volatile int64_t*)w;
  }
  __device__ void min(int32_t* w, int32_t value) const { atomicMin(w, value); }
};

}  // namespace

// One batch's launch arguments, 8 bytes a field (the wrapper's
// exec/distinct_flag.py _pack order).
struct DistinctFlagArgs {
  const void* val;        // the value column, of kind vkind
  int64_t vkind;
  const uint8_t* vvalid;  // the value's validity (a NULL value never flags)
  const void* grp;        // the group column, of kind gkind; null: none
  int64_t gkind;
  const uint8_t* gvalid;
  int64_t n;              // rows
  DfSlot* table;
  int64_t capacity;       // slots, a power of two
  int32_t* slot_of_row;   // scratch, n words: pass 1 -> pass 2
  uint8_t* flags;         // n bools
  int32_t* error;         // set when an insert passed every slot
  int64_t epoch;          // this batch's, 1 .. kDfMaxEpoch
};

__global__ void __launch_bounds__(kThreads)
    distinct_flag_insert_kernel(const DistinctFlagArgs a) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  int64_t slot = -1;
  if (a.vvalid[i]) {
    const int64_t val = df_norm(a.val, (int)a.vkind, i);
    bool gnull = false;
    int64_t grp = 0;
    if (a.grp != nullptr) {
      gnull = a.gvalid[i] == 0;
      grp = gnull ? 0 : df_norm(a.grp, (int)a.gkind, i);
    }
    const int64_t mask = a.capacity - 1;
    const uint32_t ready = df_ready(a.epoch, gnull);
    DfProbe p = df_probe(val, grp, gnull, mask);
    int r;
    do {
      r = df_step(a.table, mask, val, grp, gnull, ready, (int32_t)i, false,
                  p, &slot, DeviceOps());
    } while (r == DF_AGAIN);
    if (r == DF_FAIL) {
      atomicOr(a.error, 1);
      slot = -1;
    }
  }
  a.slot_of_row[i] = (int32_t)slot;
}

__global__ void __launch_bounds__(kThreads)
    distinct_flag_mark_kernel(const DistinctFlagArgs a) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  a.flags[i] = df_flag(a.table, a.slot_of_row[i], i) ? 1 : 0;
}

// Every READY slot of ``old`` into ``table`` with its state and first row
// (the stored keys are distinct: each insert finds an EMPTY slot).
__global__ void __launch_bounds__(kThreads)
    distinct_flag_rehash_kernel(const DfSlot* old, int64_t old_capacity,
                                DfSlot* table, int64_t capacity,
                                int32_t* error) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= old_capacity) return;
  const DfSlot s = old[j];
  if (s.state == kDfEmpty) return;
  const int64_t mask = capacity - 1;
  const bool gnull = df_gnull(s.state);
  DfProbe p = df_probe(s.val, s.grp, gnull, mask);
  int64_t slot;
  int r;
  do {
    r = df_step(table, mask, s.val, s.grp, gnull, s.state, s.first, true, p,
                &slot, DeviceOps());
  } while (r == DF_AGAIN);
  if (r == DF_FAIL) atomicOr(error, 1);
}

static int64_t blocks_for(int64_t n) { return (n + kThreads - 1) / kThreads; }

static bool valid_args(const DistinctFlagArgs* a) {
  const uint64_t t = reinterpret_cast<uintptr_t>(a->table);
  return a->capacity >= 2 && (a->capacity & (a->capacity - 1)) == 0 &&
         a->capacity <= ((int64_t)1 << 31) && (t & 31) == 0 &&
         a->epoch >= 1 && a->epoch <= kDfMaxEpoch &&
         a->n < ((int64_t)1 << 31) &&
         a->vkind >= DF_I8 && a->vkind <= DF_F64 &&
         (a->grp == nullptr || (a->gkind >= DF_I8 && a->gkind <= DF_F64));
}

// Pass 1 over one batch (module doc); a batch of no rows launches nothing.
extern "C" int distinct_flag_insert(const DistinctFlagArgs* a, void* stream) {
  if (!valid_args(a)) return (int)cudaErrorInvalidValue;
  if (a->n <= 0) return 0;
  distinct_flag_insert_kernel<<<(unsigned)blocks_for(a->n), kThreads, 0,
                                (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// Pass 2 over the same batch.
extern "C" int distinct_flag_mark(const DistinctFlagArgs* a, void* stream) {
  if (!valid_args(a)) return (int)cudaErrorInvalidValue;
  if (a->n <= 0) return 0;
  distinct_flag_mark_kernel<<<(unsigned)blocks_for(a->n), kThreads, 0,
                              (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// Growth: ``old``'s keys into ``table``, which the caller has zeroed.
extern "C" int distinct_flag_rehash(const DfSlot* old, int64_t old_capacity,
                                    DfSlot* table, int64_t capacity,
                                    int32_t* error, void* stream) {
  if (capacity <= old_capacity || (capacity & (capacity - 1)) != 0 ||
      capacity > ((int64_t)1 << 31) ||
      (reinterpret_cast<uintptr_t>(table) & 31) != 0)
    return (int)cudaErrorInvalidValue;
  if (old_capacity <= 0) return 0;
  distinct_flag_rehash_kernel<<<(unsigned)blocks_for(old_capacity), kThreads,
                                0, (cudaStream_t)stream>>>(
      old, old_capacity, table, capacity, error);
  return (int)cudaGetLastError();
}

extern "C" int64_t distinct_flag_slot_bytes() { return sizeof(DfSlot); }

// Registers a thread of the insert kernel (for reports).
extern "C" int distinct_flag_describe(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, distinct_flag_insert_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], distinct_flag_insert_kernel, kThreads, 0);
  return (int)err;
}
