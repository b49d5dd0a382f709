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
// What bounds it on an H100: not bytes. A batch of q28 at SF10 (about
// 192,000 rows) needs 9.8 MB moved, 0.0029 ms at 3.35 TB/s, and fits in
// one wave of the card (132 SMs x 2,048 threads). Each row's work is a
// short chain of dependent memory round trips (its key words, then its
// slot's state, then the slot's key words, then the first-row atomic),
// so the time is the chain's latency, the launch's ramp and tail, and
// whatever orders memory between the steps.
//
// Design (csrc/distinct_flag_row.cuh holds the per-row logic):
//  * one cooperative launch a batch (distinct_flag_kernel): a grid of
//    at most the blocks that are resident together walks the rows, a
//    row a thread, a grid apart. Phase 1 inserts or finds each key; a
//    grid barrier (cooperative_groups' grid sync; the cooperative launch
//    guarantees co-residency) follows; phase 2 flags a row whose slot's
//    first row is the row. A thread keeps its first row's slot in a
//    register across the barrier; its later rows (only when the batch
//    has more rows than the grid threads) keep theirs in the scratch
//    array. One launch saves the second launch's ramp and the scratch
//    round trip of every row.
//  * every valid row probes for itself. Grouping a warp's equal keys
//    first (one probe a key) cost more on q28's batches than it saved:
//    0.0161 against 0.0150 ms a batch on an NVIDIA H100 80GB HBM3 at
//    700 W (PERF.md).
//  * the slot protocol with a release store of READY and acquire loads
//    of the state (cuda::atomic_ref), in place of a full fence before
//    publishing and after every READY slot met.
//  * the key count: every warp adds the keys its lanes inserted to a
//    device word with one atomicAdd; after the barrier the first thread
//    stores (epoch << 32) | count into the table's pinned host word in
//    one 8-byte store. The host reads the word without waiting; the
//    epoch says which launch wrote it, so which rows the count covers
//    (exec/distinct_flag.py ``KeyCount``, ``sized_table``: at most half
//    of the slots for the keys after the batch): q28's table stays in
//    the L2 instead of growing with the rows. The kernel's own store
//    replaces a copy queued after it, which cost 0.010 ms of stream
//    time a batch on an H100.
//  * no memset between batches: the host advances the epoch.
//  * growth is a rehash launch (distinct_flag_rehash_kernel) into a
//    larger zeroed table; the count word is the table's and stays. An
//    insert that passes every slot sets the error word, which the host
//    reads once at the end of the stream.
#include <cooperative_groups.h>
#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include "distinct_flag_row.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

using StateRef = cuda::atomic_ref<uint32_t, cuda::thread_scope_device>;

struct DeviceOps {
  __device__ uint32_t load(uint32_t* w) const {
    return StateRef(*w).load(cuda::memory_order_acquire);
  }
  __device__ uint32_t cas(uint32_t* w, uint32_t expect,
                          uint32_t value) const {
    return atomicCAS(w, expect, value);
  }
  __device__ void publish(uint32_t* w, uint32_t value) const {
    StateRef(*w).store(value, cuda::memory_order_release);
  }
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
  int32_t* slot_of_row;   // n words: the slots of rows past a thread's first
  uint8_t* flags;         // n bools
  int32_t* error;         // set when an insert passed every slot
  unsigned long long* keys;       // the table's key count
  unsigned long long* host_keys;  // pinned: (epoch << 32) | keys
  int64_t epoch;          // this batch's, 1 .. kDfMaxEpoch
};

__global__ void __launch_bounds__(kThreads)
    distinct_flag_kernel(const DistinctFlagArgs a) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t mask = a.capacity - 1;
  int32_t held = -1;   // the slot of this thread's first row
  uint32_t added = 0;  // keys this thread inserted
  // phase 1
  for (int64_t i = t; i < a.n; i += stride) {
    int32_t slot = -1;
    if (a.vvalid[i] != 0) {
      const int64_t val = df_norm(a.val, (int)a.vkind, i);
      bool gnull = false;
      int64_t grp = 0;
      if (a.grp != nullptr) {
        gnull = a.gvalid[i] == 0;
        grp = gnull ? 0 : df_norm(a.grp, (int)a.gkind, i);
      }
      const uint32_t ready = df_ready(a.epoch, gnull);
      DfProbe p = df_probe(val, grp, gnull, mask);
      int64_t s = -1;
      int r;
      do {
        r = df_step(a.table, mask, val, grp, gnull, ready, (int32_t)i, false,
                    p, &s, DeviceOps());
      } while (r == DF_AGAIN);
      if (r == DF_FAIL) {
        atomicOr(a.error, 1);
        s = -1;
      } else {
        added += (uint32_t)p.owned;
      }
      slot = (int32_t)s;
    }
    if (i == t)
      held = slot;
    else
      a.slot_of_row[i] = slot;
  }
  // every lane of the warp gets here
  const uint32_t warp_added = __reduce_add_sync(0xFFFFFFFFu, added);
  if ((threadIdx.x & 31) == 0 && warp_added != 0)
    atomicAdd(a.keys, (unsigned long long)warp_added);
  cg::this_grid().sync();
  if (blockIdx.x == 0 && threadIdx.x == 0)
    *(volatile unsigned long long*)a.host_keys =
        ((unsigned long long)a.epoch << 32) |
        *(volatile unsigned long long*)a.keys;
  // phase 2
  for (int64_t i = t; i < a.n; i += stride)
    a.flags[i] = df_flag(a.table, i == t ? held : a.slot_of_row[i], i) ? 1 : 0;
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

// Blocks of the kernel resident together on the current device (cached
// per device: the occupancy does not change between launches).
static int resident_blocks(int* out) {
  static int cached[64] = {0};
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && cached[dev] > 0) {
    *out = cached[dev];
    return 0;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, distinct_flag_kernel, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (dev < 64) cached[dev] = per_sm * sms;
  *out = per_sm * sms;
  return 0;
}

static bool valid_args(const DistinctFlagArgs* a) {
  const uint64_t t = reinterpret_cast<uintptr_t>(a->table);
  return a->capacity >= 2 && (a->capacity & (a->capacity - 1)) == 0 &&
         a->capacity <= ((int64_t)1 << 31) && (t & 31) == 0 &&
         a->epoch >= 1 && a->epoch <= kDfMaxEpoch &&
         a->n < ((int64_t)1 << 31) && a->keys != nullptr &&
         a->host_keys != nullptr && (a->n == 0 || a->slot_of_row != nullptr) &&
         a->vkind >= DF_I8 && a->vkind <= DF_F64 &&
         (a->grp == nullptr || (a->gkind >= DF_I8 && a->gkind <= DF_F64));
}

// One batch (module doc); a batch of no rows launches nothing. A refused
// cooperative launch returns its error code.
extern "C" int distinct_flag_launch(const DistinctFlagArgs* a,
                                    void* stream) {
  if (!valid_args(a)) return (int)cudaErrorInvalidValue;
  if (a->n <= 0) return 0;
  int resident;
  int rc = resident_blocks(&resident);
  if (rc != 0) return rc;
  const int64_t grid = df_grid_blocks(a->n, kThreads, resident);
  void* params[] = {(void*)a};
  return (int)cudaLaunchCooperativeKernel((const void*)distinct_flag_kernel,
                                          dim3((unsigned)grid),
                                          dim3(kThreads), params, 0,
                                          (cudaStream_t)stream);
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

// Whether the kernel may store to host pointer ``p`` (pinned, mapped into
// the device's address space at the same address): 1 or 0.
extern "C" int distinct_flag_host_ok(const void* p) {
  cudaPointerAttributes attr;
  if (cudaPointerGetAttributes(&attr, p) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return attr.type == cudaMemoryTypeHost && attr.devicePointer == p;
}

// Registers a thread of the kernel, its resident blocks an SM and its
// threads a block.
extern "C" int distinct_flag_describe(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, distinct_flag_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[2] = kThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], distinct_flag_kernel, kThreads, 0);
}
