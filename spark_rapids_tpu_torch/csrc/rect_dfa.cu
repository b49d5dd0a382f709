// rect_dfa: LIKE of any pattern and RLIKE over every row of an ASCII byte
// rectangle, as a DFA walk, for an NVIDIA H100 (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs LIKE patterns with an
// inner %, _ or an escape, and every RLIKE that is not a literal, on its
// host engine (spark_rapids_tpu/exprs/string_fns.py, Like.eval_host and
// RLike.eval_host through pyarrow's RE2 and Python's re). The port has no
// host engine, and no PyTorch call matches a regular expression, so the
// pattern is compiled on the host to a DFA over bytes
// (exprs/regex_dfa.py) and this kernel walks every row through it.
//
// Bound: bytes. A row is read only up to its length (in 32-byte sectors),
// with its 4-byte length and its validity, and one bool is written. On
// TPC-H l_comment (1,048,576 rows of 10-43 bytes in a 64-byte rectangle)
// that is about 51 MB: 0.0151 ms at 3.35 TB/s. A row that reaches a sink
// early needs fewer of its bytes.
//
// What bounds it on this card is the rows' loads: 16 bytes a lane, rows
// 64 bytes apart, so a warp's load touches 16 lines and half of each
// sector it asks for. The loads alone (chip_variants.py rect_dfa
// loads_only) take 0.0255 ms of the kernel's 0.0278 on Q13's pattern
// (NVIDIA H100 80GB HBM3, 700 W; commit 3444cf9's kernel 0.0367 in the
// same call).
// The walk is a chain of shared-memory lookups, one a byte, under them:
//
// * Two instances. The byte-indexed one (at most kRdByteStates states)
//   holds next[s][b] = table[s][classes[b]] in shared memory, states
//   kRdNextStride bytes apart, and walks a byte with one PRMT (the byte),
//   one IMAD (its address) and one shared load; the wrapper builds that
//   table once a DFA on the host (exec/rect_dfa.py next_table) and a block
//   copies it 16 bytes a thread. The stride (256 + 24) puts the same byte
//   of two states in banks 6 apart: ASCII text keeps its bytes in a few
//   banks. The class-indexed instance keeps the states x classes table (at
//   most 32 KB) and two dependent lookups a byte. The rule: the byte table
//   while it fits the 48 KB a block has without opting in (168 states).
//   Measured, in turns: 0.0280 against 0.0286 ms at 16 states, 0.0286
//   against 0.0288 at 66, 0.0296 against 0.0294 at 130 (the walk is under
//   the loads; a longer walk gains more from one lookup a byte); past 168
//   states the class-indexed one runs (0.0292 at 192).
// * Whole chunks without tests: a row's 16-byte chunks that lie wholly
//   inside it are walked with no test at all; the sink is tested once a
//   chunk (sinks absorb every byte); only the last, partial chunk tests
//   the length on each byte. The whole chunks come first and the partial
//   one after, so a warp's lanes meet again before it (the two tests on
//   every byte of commit 3444cf9's kernel: 0.0318 ms).
// * Loads ahead: a thread walks one row at a time, rows a grid apart (the
//   grid is what the card holds at once). Before a row's walk it issues
//   the next row's first 64 bytes (the chunks below its length) and the
//   length and validity of the row after it (a chunk's load waits on its
//   row's length), with streaming loads (a row is read once; cached loads:
//   0.0318 ms). Wider rows load their later groups when the walk gets
//   there. Only 32 bytes ahead, the second sector read when the walk gets
//   there, took 0.0347; no loads ahead 0.0295.
// * A start state that is a sink (RLIKE '') reads only the validity.
//
// No wgmma or tensor core applies: the walk is a chain of table lookups,
// no matrix product. Staging the rows in shared memory by cp.async
// (coalesced, rows 80 bytes apart) did not pay: 0.0393 ms a block's tile
// at a time, 0.0324 with each warp's next tile in flight; nor did two
// rows a thread walked in step (0.0311) or a nibble table of 16 states
// (0.0326). A NULL row is not walked and gives false (its validity is the
// caller's). No stack frame, no spill.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rect_dfa_row.cuh"

// Threads a block: the prologue gives each thread one byte value.
constexpr int kRdBlock = 256;
static_assert(kRdBlock == 256, "the prologue gives each thread a byte");

// Group i of a row of n bytes at p: its chunks c with
// 16 (kRdGroup i + c) < n, 16-byte streaming loads (one 8-byte load for
// an 8-byte rectangle; a row is read once); the other chunks of g keep
// what they held.
__device__ __forceinline__ void rd_load(const uint8_t* p, int width, int n,
                                        int i,
                                        uint32_t (&g)[kRdGroup][4]) {
  if (width == 8) {
    if (i == 0 && n > 0) {
      const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
      g[0][0] = v.x;
      g[0][1] = v.y;
    }
    return;
  }
  const uint4* q = reinterpret_cast<const uint4*>(p) + kRdGroup * i;
  RD_UNROLL
  for (int c = 0; c < kRdGroup; ++c)
    if (16 * (kRdGroup * i + c) < n) {
      const uint4 v = __ldcs(q + c);
      g[c][0] = v.x;
      g[c][1] = v.y;
      g[c][2] = v.z;
      g[c][3] = v.w;
    }
}

template <bool kByte>
__global__ void __launch_bounds__(kRdBlock)
    rect_dfa_kernel(const uint8_t* __restrict__ bytes,
                    const int32_t* __restrict__ lengths,
                    const bool* __restrict__ validity, int rows, int width,
                    const uint8_t* __restrict__ classes,
                    const uint8_t* __restrict__ table,
                    const uint8_t* __restrict__ accept, int n_states,
                    int n_classes, int start, int first_sink,
                    bool* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_accept = smem;
  uint8_t* s_classes = smem + 256;
  uint8_t* s_table = smem + 512;
  const int t = threadIdx.x;
  s_accept[t] = t < n_states ? accept[t] : 0;
  if (kByte) {
    const bool by_byte = n_classes == 256 &&
                         ((uintptr_t)table & 15) == 0;
    if (__syncthreads_and(!by_byte || classes[t] == t) && by_byte) {
      // the table comes indexed by byte: 16 bytes a thread, two 8-byte
      // stores (the stride is a multiple of 8, not of 16)
      for (int i = t; i < n_states * 16; i += kRdBlock) {
        const uint4 v = reinterpret_cast<const uint4*>(table)[i];
        uint2* d = reinterpret_cast<uint2*>(s_table +
                                            (i >> 4) * kRdNextStride +
                                            16 * (i & 15));
        d[0] = make_uint2(v.x, v.y);
        d[1] = make_uint2(v.z, v.w);
      }
    } else {
      // any other classes: thread t makes byte t's column
      const int c = classes[t];
      for (int s = 0; s < n_states; ++s)
        s_table[s * kRdNextStride + t] = table[s * n_classes + c];
    }
  } else {
    s_classes[t] = classes[t];
    for (int i = t; i < n_states * n_classes; i += kRdBlock)
      s_table[i] = table[i];
  }
  __syncthreads();

  const auto span = [&](uint32_t r) {
    return r < (uint32_t)rows ? rd_span(lengths[r], validity[r], width)
                              : -1;
  };
  const auto valid = [&](uint32_t r) {
    return r < (uint32_t)rows && validity[r];
  };
  const auto load = [&](uint32_t r, int n, int i,
                        uint32_t(&g)[kRdGroup][4]) {
    rd_load(bytes + (size_t)r * (uint32_t)width, width, n, i, g);
  };
  const auto store = [&](uint32_t r, bool hit) { out[r] = hit; };
  const uint32_t first = blockIdx.x * kRdBlock + t;
  const uint32_t stride = gridDim.x * kRdBlock;
  if (kByte)
    rd_thread(RdByteStep{s_table}, s_accept, start, first_sink, width, first,
              stride, (uint32_t)rows, span, valid, load, store);
  else
    rd_thread(RdClassStep{s_classes, s_table, n_classes}, s_accept, start,
              first_sink, width, first, stride, (uint32_t)rows, span, valid,
              load, store);
}

// Whether a DFA of n_states states runs on the byte-indexed instance.
static bool rd_by_byte(int n_states) { return n_states <= kRdByteStates; }

// Shared memory of a launch: the accept flags, the classes, the table.
static int rd_smem(int n_states, int n_classes) {
  return 512 + (rd_by_byte(n_states) ? n_states * kRdNextStride
                                     : n_states * n_classes);
}

// The grid of a launch over `rows` rows: a block for each 256 rows, at
// most what the card holds at once with this table.
extern "C" int64_t rect_dfa_grid(int64_t rows, int n_states, int n_classes) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  int per = 0;
  if (rd_by_byte(n_states))
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, rect_dfa_kernel<true>, kRdBlock, rd_smem(n_states, n_classes));
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, rect_dfa_kernel<false>, kRdBlock,
        rd_smem(n_states, n_classes));
  const int64_t resident = (int64_t)sms * (per > 0 ? per : 1);
  const int64_t needed = (rows + kRdBlock - 1) / kRdBlock;
  return needed < resident ? needed : resident;
}

// Registers a thread, threads a block and stack bytes of the byte-indexed
// instance (out[0..2]) and of the class-indexed one (out[3..5]).
extern "C" int rect_dfa_describe(int* out) {
  cudaFuncAttributes a[2];
  cudaError_t err = cudaFuncGetAttributes(&a[0], rect_dfa_kernel<true>);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&a[1], rect_dfa_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  for (int k = 0; k < 2; ++k) {
    out[3 * k] = a[k].numRegs;
    out[3 * k + 1] = kRdBlock;
    out[3 * k + 2] = (int)a[k].localSizeBytes;
  }
  return 0;
}

// One launch on `stream` (PyTorch's current stream); returns
// cudaGetLastError(). bytes is rows x width (width 8 or a multiple of 16,
// 16-byte aligned), the DFA's three tables lie on the card; out is
// bool[rows]. A DFA of at most kRdByteStates states runs on the
// byte-indexed instance, whose table is copied as it is where the classes
// are the identity (n_classes 256: the table already indexed by byte) and
// made from the classes otherwise; a larger one on the class-indexed
// instance, its table at most kRdMaxTableBytes.
extern "C" int rect_dfa_launch(const void* bytes, const void* lengths,
                               const void* validity, int64_t rows, int width,
                               const void* classes, const void* table,
                               const void* accept, int n_states,
                               int n_classes, int start, int first_sink,
                               void* out, void* stream) {
  if (rows <= 0) return 0;
  if (rows > INT32_MAX - kRdBlock || n_states < 1 ||
      n_states > kRdMaxStates || n_classes < 1 || n_classes > 256 ||
      (!rd_by_byte(n_states) && n_states * n_classes > kRdMaxTableBytes) ||
      start < 0 || start >= n_states || first_sink < 0 ||
      first_sink > n_states ||
      !(width == 8 || (width >= 16 && width % 16 == 0)) ||
      (uintptr_t)bytes % 16)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)rect_dfa_grid(rows, n_states, n_classes);
  const int smem = rd_smem(n_states, n_classes);
  auto kernel = rd_by_byte(n_states) ? rect_dfa_kernel<true>
                                     : rect_dfa_kernel<false>;
  kernel<<<grid, kRdBlock, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(bytes),
      static_cast<const int32_t*>(lengths),
      static_cast<const bool*>(validity), (int)rows, width,
      static_cast<const uint8_t*>(classes),
      static_cast<const uint8_t*>(table),
      static_cast<const uint8_t*>(accept), n_states, n_classes, start,
      first_sink, static_cast<bool*>(out));
  return (int)cudaGetLastError();
}
