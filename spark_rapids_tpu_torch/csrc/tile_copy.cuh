// Staging a range of rows of a column into shared memory, and a tile of
// results back to device memory, for window_frame's tiled instance
// (csrc/window_frame_tile.cuh). Everything is __host__ __device__: on the card a 16-byte
// piece goes by an asynchronous copy (cp.async.cg, through L2 only), and
// the ragged ends by ordinary loads; g++ builds the same code for the
// CPU tests, where a piece is a memcpy and the waits do nothing.
//
// A column's rows land in shared memory at the same offset modulo 16 as
// in device memory (``tc_phase``), so whatever the column's alignment the
// 16-byte pieces of the range are aligned on both sides; only the bytes
// before the first and after the last such piece are copied one by one.
#pragma once
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define TC_HD __host__ __device__ __forceinline__
#else
#define TC_HD inline
#endif

// The offset modulo 16 of byte address ``a`` (plus ``off`` bytes, which
// may reach before ``a``).
TC_HD int tc_phase(const void* a, int64_t off = 0) {
  return (int)(((uintptr_t)a + (uintptr_t)off) & 15u);
}

// One 16-byte piece, both addresses 16-byte aligned: asynchronous on the
// card (complete after tc_wait_prior, once a later group is committed).
TC_HD void tc_copy16(void* smem, const void* global) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(global)
               : "memory");
#else
  memcpy(smem, global, 16);
#endif
}

// Close the thread's current group of copies.
TC_HD void tc_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait for every group the thread committed but the last.
TC_HD void tc_wait_prior() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#endif
}

// Copy the ``nbytes`` bytes at ``src`` (device memory) to ``dst`` (shared
// memory at the same phase modulo 16) with the block's ``nt`` threads,
// this one ``tid``. (32-bit counts: a 64-bit one makes the compiler call
// a division routine for each loop's trip count.)
TC_HD void tc_stage(uint8_t* dst, const uint8_t* src, int nbytes, int tid,
                    int nt) {
  if (nbytes <= 0) return;
  const int head = (16 - tc_phase(src)) & 15;
  const int body = nbytes > head ? (nbytes - head) & ~15 : 0;
  const int tail = head + body;
  // the ragged ends, byte by byte (kept rolled: they are short, and
  // unrolled they hold many registers through the caller's loop)
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int k = tid; k < (body ? head : nbytes); k += nt) dst[k] = src[k];
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int k = tail + tid; body && k < nbytes; k += nt) dst[k] = src[k];
  for (int c = tid; c < body / 16; c += nt)
    tc_copy16(dst + head + 16 * c, src + head + 16 * c);
}

// Copy ``nbytes`` from shared memory to device memory, both 16-byte
// aligned at ``src`` and ``dst``: 16-byte stores, the last bytes one by
// one.
TC_HD void tc_store(uint8_t* dst, const uint8_t* src, int nbytes, int tid,
                    int nt) {
  const int body = nbytes & ~15;
  for (int c = tid; c < body / 16; c += nt) {
#ifdef __CUDA_ARCH__
    *(uint4*)(dst + 16 * c) = *(const uint4*)(src + 16 * c);
#else
    memcpy(dst + 16 * c, src + 16 * c, 16);
#endif
  }
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int k = body + tid; k < nbytes; k += nt) dst[k] = src[k];
}
