// rect_transform: a chain of string transforms (upper, lower, initcap,
// trim, substring, replace, lpad/rpad, substring_index, reverse, repeat,
// translate) over every row of an ASCII byte rectangle, for an NVIDIA
// H100 (sm_90a).
//
// Replaces the jitted jax.numpy transforms of the JAX package's
// spark_rapids_tpu/exprs/string_rect.py (_upper :74, _lower :80, _trim
// :86, _substring :111, _replace :222, _pad :263, _substring_index :363,
// _reverse :389), which it fuses into one XLA kernel a chain
// (exprs/compiler.py:compile_rect_chain :478). They are not Pallas
// kernels; in eager PyTorch one upper(trim(s)) is dozens of launches a
// batch (the realign alone is W masked shifts), so this kernel takes the
// whole chain in one launch a batch.
//
// Bound: bytes. Each input byte is read once (P * W, 4P of lengths, P of
// validity) and each output byte written once (P * Wo, 4P of lengths);
// the ops themselves are a few integer operations a byte. The strings
// rung's batch (1,048,576 rows, W = 32, upper(trim(s)) keeping Wo = 32)
// moves 76,546,048 bytes: 0.0228 ms at 3.35 TB/s.
//
// Design (the kernel before this one walked each row byte by byte in one
// thread through shared memory and was bound by instruction issue): a row
// is spread over a group of G lanes of one warp, 16 bytes a lane, G = the
// chain's widest width / 16 (1 lane for rows of 8-16 bytes, 2 for 32, 4
// for 64). Each lane holds its 16 bytes as four 32-bit words in
// registers, loaded straight from device memory with one 16-byte load:
// rows are contiguous, so a warp's load is 512 contiguous bytes. The ops
// work on words (rect_transform_row.cuh): the case maps by byte-wise range
// masks within a word; initcap with the byte before each word (the
// previous lane's last word by one shuffle); trim's first and last
// non-space byte from per-byte space masks, one ballot for the lanes that
// hold any and two shuffles for their positions; every realign (trim,
// substring, lpad, substring_index) and reverse as a window of five words
// (the two source lanes' words by eight shuffles, two steps of selects)
// and a funnel shift or byte permute a word; literal matches as each lane
// testing its own 16 start positions against the literal's words, the
// group's 64 starts gathered by an OR across the lanes, then selected
// (replace: greedy, leftmost, non-overlapping) or counted
// (substring_index) on that mask; replace scatters the kept bytes and the
// replacements through the group's 16G bytes of shared scratch, each
// byte's output position from a running count of the chosen starts
// before it. Every group of a warp makes the same exchanges whatever its
// row holds. The grid is what the card holds at once; its warps walk the
// row sets (32 / G rows each), and each issues the next set's loads before
// it computes the current one. Chains without a literal match run an
// instance without that code (fewer registers); repeat (each byte's
// copies) and translate (each byte mapped within its word, the kept
// ones scattered to their running count) go through the scratch in the
// instance with it. Measured on the way
// (PERF.md): 4 bytes a lane lost to the byte-loop kernel (the per-op
// work of a lane, decode, lengths, masks, addresses, paid for 4 bytes);
// occupancy then set the pace, so two sets in flight, or a window of five
// shuffles with the word picked by its sender, were slower than this. The
// chain (at most 8 ops with their literals) is copied into shared memory
// once a block, with each pad op's pad repeated. No stack frame, no spill.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "rect_transform_row.cuh"

constexpr int kRtBlock = 256;  // threads a block
// Blocks an SM the registers must leave room for: the chains without a
// literal match, and those with one (more registers, fewer blocks).
constexpr int kRtBlocksLight = 3;
constexpr int kRtBlocksMatch = 1;

// A lane's 16 bytes of row `row` (zero past w bytes), and their store.
__device__ __forceinline__ uint4 rt_load_lane(const uint8_t* base,
                                              uint32_t row, int w, int k) {
  const uint8_t* p = base + (size_t)row * (uint32_t)w;
  if (16 * (k + 1) <= w) return reinterpret_cast<const uint4*>(p)[k];
  if (k == 0 && w == 8) {
    const uint2 v = reinterpret_cast<const uint2*>(p)[0];
    return make_uint4(v.x, v.y, 0u, 0u);
  }
  return make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void rt_store_lane(uint8_t* base, uint32_t row,
                                              int w, int k,
                                              const uint32_t (&v)[4]) {
  uint8_t* p = base + (size_t)row * (uint32_t)w;
  if (16 * (k + 1) <= w)
    reinterpret_cast<uint4*>(p)[k] = make_uint4(v[0], v[1], v[2], v[3]);
  else if (k == 0 && w == 8)
    reinterpret_cast<uint2*>(p)[0] = make_uint2(v[0], v[1]);
}

template <int G, bool kMatch>
__global__ void __launch_bounds__(kRtBlock,
                                  kMatch ? kRtBlocksMatch : kRtBlocksLight)
    rect_transform_kernel(const uint8_t* __restrict__ bytes,
                          const int32_t* __restrict__ lengths,
                          const bool* __restrict__ validity, int rows,
                          int w_in, int w_out, uint8_t* __restrict__ out,
                          int32_t* __restrict__ out_len,
                          const __grid_constant__ RtChain chain) {
  __shared__ RtOp ops[kRtMaxOps];
  __shared__ __align__(16) uint8_t reps[kRtMaxOps * kRtRepBytes];
  __shared__ __align__(16) uint8_t scratch[kRtBlock * 16];
  const int n_ops = chain.n_ops;
  {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(chain.ops);
    uint32_t* dst = reinterpret_cast<uint32_t*>(ops);
    const int words = n_ops * (int)(sizeof(RtOp) / 4);
    for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = src[i];
    for (int i = threadIdx.x; i < n_ops * kRtRepBytes; i += blockDim.x) {
      const RtOp& op = chain.ops[i / kRtRepBytes];
      reps[i] = op.code == RT_PAD ? rt_rep_byte(op, i % kRtRepBytes) : 0;
    }
  }
  __syncthreads();

  constexpr int kRowsPerSet = 32 / G;
  const int lane = threadIdx.x & 31;
  const int k[1] = {lane & (G - 1)};
  const int g = lane / G;
  const RtWarpEx<G> ex{lane & ~(G - 1)};
  uint8_t* scr = scratch + 16 * (threadIdx.x & ~(G - 1));
  // the warps walk the row sets, a grid's worth of warps apart (the grid
  // is what the card holds at once); the next set's loads are issued
  // before a set is computed (rows < 2^31: 32-bit indices)
  const uint32_t sets = ((uint32_t)rows + kRowsPerSet - 1) / kRowsPerSet;
  const uint32_t stride = gridDim.x * (kRtBlock / 32);
  const uint32_t first = blockIdx.x * (kRtBlock / 32) + threadIdx.x / 32;
  uint4 a;
  int l;
  bool v;
  auto load = [&](uint32_t set, uint4& x, int& n, bool& ok) {
    const uint32_t row = set * kRowsPerSet + g;
    x = make_uint4(0u, 0u, 0u, 0u);
    n = 0;
    ok = false;
    if (row < (uint32_t)rows) {
      n = lengths[row];
      ok = validity[row];
      x = rt_load_lane(bytes, row, w_in, k[0]);
    }
  };
  load(first, a, l, v);

#pragma unroll 1
  for (uint32_t set = first; set < sets; set += stride) {
    uint32_t w[1][4] = {{a.x, a.y, a.z, a.w}};
    const int len = l;
    const bool valid = v;
    load(set + stride, a, l, v);
    const int n =
        rt_group_chain<1, kMatch>(ops, n_ops, ex, w, k, len, valid, scr, reps);
    const uint32_t row = set * kRowsPerSet + g;
    if (row < (uint32_t)rows) {
      rt_store_lane(out, row, w_out, k[0], w[0]);
      if (k[0] == 0) out_len[row] = n;
    }
  }
}

// sizeof(RtChain): the wrapper checks that its packing agrees.
extern "C" int rect_transform_chain_bytes() { return (int)sizeof(RtChain); }

// Lanes a row for a chain whose widest width is `widest`.
static int rt_lanes(int widest) {
  return widest > 16 ? widest / 16 : 1;
}

// The blocks of one instance the card holds at once (its SMs times the
// blocks an SM takes at its registers and shared memory), asked once.
template <int G, bool M>
static int64_t rt_resident() {
  static int64_t resident = 0;
  if (!resident) {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, rect_transform_kernel<G, M>, kRtBlock, 0);
    resident = (int64_t)(sms > 0 ? sms : 1) * (per > 0 ? per : 1);
  }
  return resident;
}

static int64_t rt_resident_blocks(int lanes, bool match) {
  if (lanes == 1)
    return match ? rt_resident<1, true>() : rt_resident<1, false>();
  if (lanes == 2)
    return match ? rt_resident<2, true>() : rt_resident<2, false>();
  return match ? rt_resident<4, true>() : rt_resident<4, false>();
}

// The grid of a launch over `rows` rows (the wrapper's launch_shape asks):
// a block for each 8 warps' sets, at most what the card holds at once.
extern "C" int64_t rect_transform_grid(int64_t rows, int widest, int match) {
  const int lanes = rt_lanes(widest);
  const int64_t sets = (rows + 32 / lanes - 1) / (32 / lanes);
  const int64_t needed = (sets + kRtBlock / 32 - 1) / (kRtBlock / 32);
  const int64_t resident = rt_resident_blocks(lanes, match != 0);
  return needed < resident ? needed : resident;
}

// One launch on `stream` (PyTorch's current stream); returns
// cudaGetLastError(). `chain` points to an RtChain in host memory, passed
// to the kernel by value. rows below 2^31 - 2^6; bytes and out 16-byte
// aligned; w_in and w_out powers of two from 8 to kRtMaxWidth, as every
// op's widths; out is rows * w_out bytes.
extern "C" int rect_transform_launch(const void* bytes, const void* lengths,
                                     const void* validity, int64_t rows,
                                     int w_in, int w_out, const void* chain,
                                     void* out, void* out_len,
                                     void* stream) {
  RtChain c;
  memcpy(&c, chain, sizeof(RtChain));
  if (rows <= 0) return 0;
  auto width_ok = [](int w) {
    return w >= 8 && w <= kRtMaxWidth && (w & (w - 1)) == 0;
  };
  if (rows > INT32_MAX - 64 || c.n_ops < 1 || c.n_ops > kRtMaxOps ||
      !width_ok(w_in) ||
      !width_ok(w_out) || (uintptr_t)bytes % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  int widest = 8;
  for (int i = 0; i < c.n_ops; ++i) {
    const RtOp& op = c.ops[i];
    if (!width_ok(op.w_in) || !width_ok(op.w_out))
      return (int)cudaErrorInvalidValue;
    widest = op.w_in > widest ? op.w_in : widest;
    widest = op.w_out > widest ? op.w_out : widest;
  }
  // 1, 2 or 4 lanes a row (widest 8-16, 32, 64 bytes)
  const int lanes = rt_lanes(widest);
  const bool match = rt_chain_matches(c);
  const unsigned grid = (unsigned)rect_transform_grid(rows, widest, match);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* b = static_cast<const uint8_t*>(bytes);
  const int32_t* ln = static_cast<const int32_t*>(lengths);
  const bool* v = static_cast<const bool*>(validity);
  uint8_t* o = static_cast<uint8_t*>(out);
  int32_t* ol = static_cast<int32_t*>(out_len);
#define RT_LAUNCH(G, M)                                                    \
  rect_transform_kernel<G, M><<<grid, kRtBlock, 0, s>>>(b, ln, v, (int)rows, \
                                                       w_in, w_out, o, ol, c)
  if (lanes == 1)
    match ? RT_LAUNCH(1, true) : RT_LAUNCH(1, false);
  else if (lanes == 2)
    match ? RT_LAUNCH(2, true) : RT_LAUNCH(2, false);
  else
    match ? RT_LAUNCH(4, true) : RT_LAUNCH(4, false);
#undef RT_LAUNCH
  return (int)cudaGetLastError();
}
