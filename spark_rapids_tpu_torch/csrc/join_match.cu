// join_match: the match step of an equi-join as a hash build and one
// probe-scan-emit launch on the card. It replaces the sort-based group
// match of the reference's jitted jnp join kernels
// (spark_rapids_tpu/exec/joins.py _build_count_kernel and
// _gather_index_kernel): for a stream side and a build side of encoded
// key words, the (stream row, build row) gather maps of the join.
//
// The wrapper (exec/join_match.py) sorts the build rows by key with torch
// and hands over the distinct keys with each one's start and count in
// the sorted order. Then:
//   join_match_build_kernel  inserts the distinct keys into an
//                     open-addressing table (linear probing, at least 4
//                     slots a key), a slot the key's words and one meta
//                     word of its start and count (jm_meta), claimed by
//                     atomicCAS; once a build side;
//   join_match_tile_kernel   one launch a stream batch. Blocks take tiles
//                     of kTile stream rows in order from a ticket counter
//                     and, per tile: probe each row (a thread's 8
//                     consecutive rows, keys read as 16-byte loads where
//                     the width allows; a one-word slot is one 16-byte
//                     load), an exclusive block scan of the rows' output
//                     counts (JmKind), the tile's global offset by a
//                     decoupled look-back over per-tile status words, then
//                     the tile's outputs as one contiguous range that the
//                     threads stride over: output index -> stream row by
//                     a binary search over the tile's inclusive scan in
//                     shared memory, build row as sorted_rows[start + j]
//                     (4 outputs' loads in flight a thread). Consecutive
//                     threads write consecutive words, and a key with
//                     thousands of build rows spreads over the whole
//                     block. The last tile writes the grand total to one
//                     device word.
// In the count phase the kernel writes only the status words and the
// total; the emit phase probes the same rows the same way and writes.
// The wrapper launches the emit phase alone into a buffer of n *
// max(largest key count, 1) rows when that is at most twice n, else the
// count phase, one host read of the total, and the emit phase into exactly
// the total. Existence writes a flag per row from the same kernel (no
// scan); right and full joins flag the first sorted build row of every
// key they match (a store of 1, the same in any order).
//
// The output order is defined (stream row ascending, build rows ascending
// within it), so the kernel and the plain version agree exactly.
//
// Forward progress: tiles are numbered by an atomic ticket, not by
// blockIdx, so a tile's predecessors belong to blocks that are already
// running; the grid is persistent (at most the blocks the card holds at
// once with the launch's shared memory), each block drawing tickets until
// they run out; the block that draws the last ticket of all sets the
// counter back to 0. The status words are never cleared by the kernel:
// each carries the epoch of its launch (16 bits), which the wrapper
// advances every launch, zeroing the words once when the epoch wraps (an
// epoch counter, not a memset a launch); a word of an older launch reads
// as not ready. The whole block looks back, kLook tiles a step.
//
// Shared memory: a tile's inclusive scan (int64) and its rows' first
// build positions (int32: the sorted build rows are fewer than 2^31),
// 24 KiB; with keys of 1, 2 or 4 words and a
// table of at most kSharedTableBytes (512 keys of one word, 256 of four)
// the whole table is staged into shared memory once a block, else
// lookups go through L1/L2 (a 100,000-key table of one word is 8 MB and
// stays in the 50 MB L2). The largest staged table leaves 3 blocks an SM.
// A warp's lookups read shared memory at the slots their keys fall on,
// so they conflict in banks as the keys fall; a lookup reads one or two
// slots, so that is accepted.
//
// Bound: memory. Each stream key is read once and each output written
// once; the build side is small beside the stream side on the main path.
// What holds the kernel above its bound on the H100 is latency: a tile's
// loads, lookups, scan, look-back and writes run in sequence, and every
// tile waits at its look-back for its slowest predecessor (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "join_match_row.cuh"

// One launch's arguments, 8 bytes a field (exec/join_match.py packs
// them in this order).
struct JoinMatchArgs {
  const int64_t* skeys;
  const uint8_t* snull;
  int64_t n;
  int64_t W;
  int64_t kind;   // JmKind
  int64_t phase;  // 0: count, 1: emit
  const int64_t* table;  // capacity slots of W + 1 words (jm_meta)
  int64_t capacity;
  const int64_t* sorted_rows;
  uint8_t* matched;  // right and full joins: a flag a sorted build row
  int64_t* out_s;
  int64_t* out_b;    // null for leftsemi and leftanti
  uint8_t* flags;    // existence
  int64_t out_cap;
  int64_t* total;
  unsigned long long* scratch;  // the ticket counter, then status words
  int64_t scratch_tiles;
  int64_t epoch;  // 1 .. 65535
  int64_t shared;
};

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;
constexpr int kTile = kThreads * kRowsPerThread;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = kTile * (8 + 4);
constexpr int64_t kSharedTableBytes = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
// status words a thread reads in a look-back step: kLook tiles a step
constexpr int kLookWords = 4;
constexpr int kLook = kThreads * kLookWords;

// A tile's status word: epoch (16 bits), flag (2), value (46, saturated).
constexpr int kEpochShift = 48;
constexpr int kFlagShift = 46;
constexpr uint64_t kValueMask = (1ull << kFlagShift) - 1;
constexpr uint64_t kAggregate = 1;  // the tile's own output count
constexpr uint64_t kPrefix = 2;     // the outputs of tiles 0 .. this one

struct DeviceCas {
  __host__ __device__ int64_t operator()(int64_t* word, int64_t meta) const {
#ifdef __CUDA_ARCH__
    return (int64_t)atomicCAS(reinterpret_cast<unsigned long long*>(word),
                              0ull, (unsigned long long)meta);
#else
    return *word;  // the host pass never runs a kernel body
#endif
  }
};

__device__ __forceinline__ uint64_t status_word(int64_t epoch, uint64_t flag,
                                                int64_t v) {
  const uint64_t val = v > (int64_t)kValueMask ? kValueMask : (uint64_t)v;
  return ((uint64_t)epoch << kEpochShift) | (flag << kFlagShift) | val;
}

// A status word as it stands in L2 (a relaxed load at GPU scope: never an
// L1 copy; the loads of a look-back step go out together).
__device__ __forceinline__ uint64_t load_status(
    const unsigned long long* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) {
  return x < y ? x : y;
}

__device__ __forceinline__ int64_t warp_incl_scan(int64_t v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

__device__ __forceinline__ int64_t warp_sum(int64_t v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// Tile row r's probe result (stream row base + r), its slot's meta word
// (0: no match): the flag of an existence join, or the row's output
// count, with its key's first build position (-1: none) into shared
// memory. Right and full joins mark the key's first sorted build row
// matched. Rows past the stream's end count 0 (jm_row_out).
__device__ __forceinline__ int64_t take_row(int r, int rows, int64_t base,
                                            int64_t meta, int kind,
                                            int phase, uint8_t* matched,
                                            uint8_t* flags,
                                            int32_t* s_start) {
  if (r < rows) {
    if (kind == JM_EXIST) {
      flags[base + r] = meta != 0;
      return 0;
    }
    if (matched != nullptr && meta != 0 && phase == 1)
      matched[jm_meta_start(meta)] = 1;
  }
  s_start[r] = (int32_t)jm_meta_start(meta);  // below 2^31 or -1
  return jm_row_out(kind, meta, r < rows);
}

// Block-wide reductions through one slot a warp; every thread gets the
// result. Callers alternate slot arrays, so no slot is rewritten while a
// thread still reads it.
__device__ __forceinline__ int block_min(int v, int* slots, int lane,
                                         int warp) {
  v = __reduce_min_sync(kFull, v);
  if (lane == 0) slots[warp] = v;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) v = min(v, slots[w]);
  return v;
}

__global__ void join_match_build_kernel(const int64_t* __restrict__ ukeys,
                                        const int64_t* __restrict__ ustart,
                                        const int64_t* __restrict__ ucount,
                                        int64_t U, int W, int64_t* table,
                                        int64_t mask) {
  for (int64_t u = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; u < U;
       u += (int64_t)gridDim.x * blockDim.x)
    jm_insert(table, mask, ukeys + u * W, W, jm_meta(ustart[u], ucount[u]),
              DeviceCas());
}

// K: the key width when it is 1, 2 or 4 words and the keys are 16-byte
// aligned and the null flags 8-byte aligned (registers, 16-byte loads),
// else 0; kShared: the build side
// staged in shared memory (K > 0 only: the generic width reads the table
// through L1/L2).
template <int K, bool kShared>
__global__ void __launch_bounds__(kThreads)
    join_match_tile_kernel(const JoinMatchArgs a, const int64_t tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* s_incl = reinterpret_cast<int64_t*>(smem);
  int32_t* s_start = reinterpret_cast<int32_t*>(s_incl + kTile);
  __shared__ int64_t s_warp[kWarps];
  __shared__ int64_t s_red_sum[kWarps];
  __shared__ int s_red_min[kWarps];
  __shared__ int s_red_ok[kWarps];
  __shared__ int64_t s_tile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = K > 0 ? K : (int)a.W;
  const int kind = (int)a.kind, phase = (int)a.phase;
  const int64_t mask = a.capacity - 1;
  const int64_t* table = a.table;
  if constexpr (kShared) {
    int64_t* t_table = reinterpret_cast<int64_t*>(s_start + kTile);
    const int64_t words = a.capacity * (K + 1);
    for (int64_t i = tid; 2 * i < words; i += kThreads) {
      if (2 * i + 1 < words)
        reinterpret_cast<longlong2*>(t_table)[i] =
            __ldg(reinterpret_cast<const longlong2*>(a.table) + i);
      else
        t_table[2 * i] = a.table[2 * i];
    }
    // the tile loop's first barrier orders these stores before a lookup
    table = t_table;
  }
  unsigned long long* ticket = a.scratch;
  unsigned long long* status = a.scratch + 1;

  for (;;) {
    if (tid == 0) s_tile = (int64_t)atomicAdd(ticket, 1ull);
    __syncthreads();
    const int64_t tile = s_tile;
    if (tile >= tiles) break;
    const int64_t base = tile * kTile;
    const int rows = (int)min64(kTile, a.n - base);

    // 1. probe: a thread's kRowsPerThread consecutive rows, their keys
    // read as 16-byte loads (8 words at a time, before any of their
    // lookups) and their null flags as one 8-byte load
    const int r0 = tid * kRowsPerThread;
    int64_t part[kRowsPerThread];
    if constexpr (K == 0) {
      // a row at a time, rolled (the counts wait in shared memory)
#pragma unroll 1
      for (int k = 0; k < kRowsPerThread; ++k) {
        const int r = r0 + k;
        const int64_t meta =
            r < rows && a.snull[base + r] == 0
                ? jm_find(table, mask, W, a.skeys + (base + r) * W)
                : 0;
        s_incl[r] = take_row(r, rows, base, meta, kind, phase, a.matched,
                             a.flags, s_start);
      }
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) part[k] = s_incl[r0 + k];
    } else {
      constexpr int kLoadRows = 8 / K;
      uint64_t nulls = 0;
      if (r0 + kRowsPerThread <= rows) {
        nulls = __ldg(reinterpret_cast<const unsigned long long*>(
            a.snull + base + r0));
      } else {
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k)
          if (r0 + k < rows) nulls |= (uint64_t)a.snull[base + r0 + k] << (8 * k);
      }
#pragma unroll
      for (int q = 0; q < kRowsPerThread; q += kLoadRows) {
        int64_t key[8];
        const int64_t* src = a.skeys + (base + r0 + q) * K;
        if (r0 + q + kLoadRows <= rows) {
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(src) + h);
            key[2 * h] = v.x;
            key[2 * h + 1] = v.y;
          }
        } else {
#pragma unroll
          for (int w = 0; w < 8; ++w)
            key[w] = r0 + q + w / K < rows ? src[w] : 0;
        }
#pragma unroll
        for (int g = 0; g < kLoadRows; ++g) {
          const int k = q + g, r = r0 + k;
          const int64_t meta =
              r < rows && ((nulls >> (8 * k)) & 0xff) == 0
                  ? jm_find<K>(table, mask, K, key + g * K)
                  : 0;
          part[k] = take_row(r, rows, base, meta, kind, phase, a.matched,
                             a.flags, s_start);
        }
      }
    }
    if (kind == JM_EXIST) {
      __syncthreads();  // every thread has read s_tile
      continue;
    }

    // 2. the block's scan: each thread's rows in order, the warps by
    // shuffles, the warps' totals in shared memory
    int64_t sum = 0;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      sum += part[k];
      part[k] = sum;
    }
    const int64_t incl = warp_incl_scan(sum, lane);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int64_t before = 0, agg = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int64_t t = s_warp[w];
      before += w < warp ? t : 0;
      agg += t;
    }
    const int64_t tbase = before + incl - sum;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k)
      s_incl[r0 + k] = tbase + part[k];

    // 3. the tile's offset: a decoupled look-back by the whole block,
    // kLook predecessors a step, back to the nearest inclusive prefix (a
    // word of another epoch, or flag 0, is not ready: read again)
    if (tid == 0)
      store_status(status + tile, status_word(
          a.epoch, tile == 0 ? kPrefix : kAggregate, agg));
    int64_t excl = 0;
    for (int64_t pos = tile - 1; pos >= 0; pos -= kLook) {
      uint64_t w[kLookWords];
      int nearest = kLook;
#pragma unroll
      for (int k = kLookWords - 1; k >= 0; --k) {
        const int d = k * kThreads + tid;
        const int64_t j = pos - d;
        w[k] = j >= 0 ? load_status(status + j)
                      : status_word(a.epoch, kPrefix, 0);
        if (w[k] >> kEpochShift != (uint64_t)a.epoch) w[k] = 0;
        if ((w[k] >> kFlagShift & 3u) == kPrefix) nearest = d;
      }
      nearest = block_min(nearest, s_red_min, lane, warp);
      bool ok = true;
      int64_t got = 0;
#pragma unroll
      for (int k = 0; k < kLookWords; ++k) {
        if (k * kThreads + tid > nearest) continue;
        ok = ok && (w[k] >> kFlagShift & 3u) != 0;
        got += (int64_t)(w[k] & kValueMask);
      }
      ok = __all_sync(kFull, ok);
      got = warp_sum(got);
      if (lane == 0) {
        s_red_ok[warp] = ok;
        s_red_sum[warp] = got;
      }
      __syncthreads();
      got = 0;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        ok = ok && s_red_ok[v];
        got += s_red_sum[v];
      }
      if (!ok) {  // a predecessor has not published yet: this step again
        pos += kLook;
        continue;
      }
      excl = min64(excl + got, (int64_t)kValueMask);
      if (nearest < kLook) break;
    }
    if (tid == 0) {
      if (tile > 0)
        store_status(status + tile, status_word(a.epoch, kPrefix, excl + agg));
      if (tile == tiles - 1) *a.total = min64(excl + agg, (int64_t)kValueMask);
    }
    __syncthreads();

    // 4. the tile's outputs, one contiguous range, threads striding; a
    // thread finds 4 outputs' rows, then loads their 4 build rows at once
    if (phase == 1) {
      int lo = 0;
      for (int64_t o0 = tid; o0 < agg; o0 += 4 * kThreads) {
        int rr[4];
        int64_t pos[4];
        // 4 searches from one lower bound: none waits on another
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int64_t o = o0 + q * kThreads;
          rr[q] = o < agg ? jm_output_row(s_incl, lo, rows, o) : lo;
          pos[q] = o < agg ? jm_build_pos(o, s_incl, rr[q], s_start[rr[q]])
                           : -1;
        }
        lo = rr[3];
        int64_t b[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          b[q] = a.out_b != nullptr && pos[q] >= 0
                     ? __ldg(reinterpret_cast<const long long*>(
                           a.sorted_rows + pos[q]))
                     : -1;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int64_t o = o0 + q * kThreads, g = excl + o;
          if (o < agg && g < a.out_cap) {
            a.out_s[g] = base + rr[q];
            if (a.out_b != nullptr) a.out_b[g] = b[q];
          }
        }
      }
    }
    __syncthreads();  // before the next tile overwrites shared memory
  }
  // every block draws one ticket past the tiles; the block that draws
  // the last of them draws the last ticket of the launch and leaves the
  // counter at 0 for the next
  if (tid == 0 && s_tile == tiles + gridDim.x - 1) atomicExch(ticket, 0ull);
}

int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < (1 << 20) ? (blocks > 0 ? blocks : 1) : (1 << 20));
}

int64_t shared_table_bytes(const JoinMatchArgs& a) {
  return a.capacity * (a.W + 1) * 8;
}

// Launch one instance: a persistent grid of at most the blocks the card
// holds at once with this launch's shared memory (found once a device
// and KiB of shared memory).
template <int K, bool kShared>
int launch(const JoinMatchArgs& a, int64_t tiles, cudaStream_t stream) {
  constexpr int kBuckets = (kTileBytes + kSharedTableBytes) / 1024 + 1;
  static int resident[kMaxDevices][kBuckets];
  static bool sized[kMaxDevices];
  auto* kernel = join_match_tile_kernel<K, kShared>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (kShared && !sized[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kTileBytes + (int)kSharedTableBytes);
    if (err != cudaSuccess) return (int)err;
    sized[dev] = true;
  }
  const int smem =
      kTileBytes + (kShared ? (int)shared_table_bytes(a) : 0);
  int& blocks = resident[dev][smem / 1024];
  if (blocks == 0) {
    const int most = kTileBytes + (kShared ? (int)kSharedTableBytes : 0);
    const int bucket = (smem / 1024 + 1) * 1024;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, bucket < most ? bucket : most);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    blocks = (per_sm > 0 ? per_sm : 1) * sms;
  }
  const int64_t grid = tiles < blocks ? tiles : blocks;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(a, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int join_match_build(const int64_t* ukeys, const int64_t* ustart,
                                const int64_t* ucount, int64_t U, int W,
                                int64_t* table, int64_t capacity,
                                void* stream) {
  if (U > 0)
    join_match_build_kernel<<<grid_for(U), kThreads, 0,
                              (cudaStream_t)stream>>>(
        ukeys, ustart, ucount, U, W, table, capacity - 1);
  return (int)cudaGetLastError();
}

// One probe-scan-emit launch over ``a`` (module doc); a batch of no rows
// launches nothing.
extern "C" int join_match_launch(const JoinMatchArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  const int64_t tiles = (a->n + kTile - 1) / kTile;
  if (tiles > a->scratch_tiles || a->epoch <= 0 || a->epoch >= (1 << 16) ||
      a->capacity < 2 || a->W < 1 ||
      (a->shared && shared_table_bytes(*a) > kSharedTableBytes))
    return (int)cudaErrorInvalidValue;
  const bool aligned = (reinterpret_cast<uintptr_t>(a->skeys) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(a->snull) & 7) == 0;
  const int K = aligned && (a->W == 1 || a->W == 2 || a->W == 4) ? (int)a->W
                                                                  : 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (a->shared) {
    switch (K) {
      case 1: return launch<1, true>(*a, tiles, s);
      case 2: return launch<2, true>(*a, tiles, s);
      case 4: return launch<4, true>(*a, tiles, s);
    }
  }
  switch (K) {
    case 1: return launch<1, false>(*a, tiles, s);
    case 2: return launch<2, false>(*a, tiles, s);
    case 4: return launch<4, false>(*a, tiles, s);
    default: return launch<0, false>(*a, tiles, s);
  }
}

// The kernel's constants, for the wrapper to check its own against.
extern "C" int64_t join_match_tile_rows() { return kTile; }
extern "C" int64_t join_match_shared_table_budget() {
  return kSharedTableBytes;
}

// Registers a thread and resident blocks an SM of the instance for
// ``width`` (1, 2, 4; anything else: the generic one, which never stages
// the table) and ``shared``: out[0], out[1]; for reports.
extern "C" int join_match_describe(int width, int shared, int* out) {
  bool s = shared != 0;
  const void* k =
      width == 1   ? (s ? (const void*)join_match_tile_kernel<1, true>
                        : (const void*)join_match_tile_kernel<1, false>)
      : width == 2 ? (s ? (const void*)join_match_tile_kernel<2, true>
                        : (const void*)join_match_tile_kernel<2, false>)
      : width == 4 ? (s ? (const void*)join_match_tile_kernel<4, true>
                        : (const void*)join_match_tile_kernel<4, false>)
                   : (const void*)join_match_tile_kernel<0, false>;
  s = s && (width == 1 || width == 2 || width == 4);
  const int most = kTileBytes + (s ? (int)kSharedTableBytes : 0);
  cudaFuncAttributes attr;
  cudaError_t err;
  if (s) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], k, kThreads,
                                                      most);
  out[0] = attr.numRegs;
  return (int)err;
}
