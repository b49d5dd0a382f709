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
// with its 4-byte length and its validity, and one bool is written; the
// walk is one table lookup a byte. On TPC-H l_comment (1,048,576 rows of
// 10-43 bytes in a 64-byte rectangle) that is about 51 MB: 0.015 ms at
// 3.35 TB/s. A row that reaches a sink early needs fewer of its bytes.
//
// Design (a simple one): the DFA's tables (the byte classes, 256 bytes;
// the transitions, states x classes bytes, at most 32 KB; the accept
// flags) are copied into shared memory once a block. Each thread walks
// one row at a time, 16 bytes a load straight from device memory (8 for
// an 8-byte rectangle), two dependent shared-memory lookups a byte (class,
// then next state), and stops at the row's length or as soon as it
// reaches a sink state, where the answer is known (a LIKE '%x%' that has
// found x, an anchored pattern that has failed). The sinks are numbered
// last, so that test is one compare. A NULL row is not walked and gives
// false (its validity is the caller's). The grid is what the card holds
// at once; the threads walk the rows a grid apart. No stack frame, no
// spill.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rect_dfa_row.cuh"

constexpr int kRdBlock = 256;  // threads a block

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
  uint8_t* s_classes = smem;
  uint8_t* s_accept = smem + 256;
  uint8_t* s_table = smem + 512;
  const int cells = n_states * n_classes;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    s_classes[i] = classes[i];
    s_accept[i] = i < n_states ? accept[i] : 0;
  }
  for (int i = threadIdx.x; i < cells; i += blockDim.x) s_table[i] = table[i];
  __syncthreads();
  const RdTables t{s_classes, s_table, s_accept, n_classes, start,
                   first_sink};
  const uint32_t stride = gridDim.x * blockDim.x;
#pragma unroll 1
  for (uint32_t row = blockIdx.x * blockDim.x + threadIdx.x;
       row < (uint32_t)rows; row += stride) {
    bool hit = false;
    if (validity[row]) {
      const uint8_t* p = bytes + (size_t)row * (uint32_t)width;
      hit = rd_row(t, lengths[row], width, [&](int c, uint32_t(&w)[4]) {
        if (width >= 16) {
          const uint4 v = reinterpret_cast<const uint4*>(p)[c];
          w[0] = v.x;
          w[1] = v.y;
          w[2] = v.z;
          w[3] = v.w;
        } else {
          const uint2 v = reinterpret_cast<const uint2*>(p)[0];
          w[0] = v.x;
          w[1] = v.y;
          w[2] = 0u;
          w[3] = 0u;
        }
      });
    }
    out[row] = hit;
  }
}

// Shared memory of a launch: the classes, the accept flags, the table.
static int rd_smem(int n_states, int n_classes) {
  return 512 + n_states * n_classes;
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
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per, rect_dfa_kernel, kRdBlock, rd_smem(n_states, n_classes));
  const int64_t resident = (int64_t)sms * (per > 0 ? per : 1);
  const int64_t needed = (rows + kRdBlock - 1) / kRdBlock;
  return needed < resident ? needed : resident;
}

// Registers a thread, threads a block (for the report).
extern "C" int rect_dfa_describe(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, rect_dfa_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = kRdBlock;
  out[2] = (int)a.localSizeBytes;
  return 0;
}

// One launch on `stream` (PyTorch's current stream); returns
// cudaGetLastError(). bytes is rows x width (width 8 or a multiple of 16,
// 16-byte aligned), the DFA's three tables lie on the card; out is
// bool[rows].
extern "C" int rect_dfa_launch(const void* bytes, const void* lengths,
                               const void* validity, int64_t rows, int width,
                               const void* classes, const void* table,
                               const void* accept, int n_states,
                               int n_classes, int start, int first_sink,
                               void* out, void* stream) {
  if (rows <= 0) return 0;
  if (rows > INT32_MAX - kRdBlock || n_states < 1 ||
      n_states > kRdMaxStates || n_classes < 1 || n_classes > 256 ||
      n_states * n_classes > kRdMaxTableBytes || start < 0 ||
      start >= n_states || first_sink < 0 || first_sink > n_states ||
      !(width == 8 || (width >= 16 && width % 16 == 0)) ||
      (uintptr_t)bytes % 16)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)rect_dfa_grid(rows, n_states, n_classes);
  rect_dfa_kernel<<<grid, kRdBlock, rd_smem(n_states, n_classes),
                    (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(bytes),
      static_cast<const int32_t*>(lengths),
      static_cast<const bool*>(validity), (int)rows, width,
      static_cast<const uint8_t*>(classes),
      static_cast<const uint8_t*>(table),
      static_cast<const uint8_t*>(accept), n_states, n_classes, start,
      first_sink, static_cast<bool*>(out));
  return (int)cudaGetLastError();
}
