// Asynchronous copies from device memory into a block's shared-memory ring,
// shared by K15 (reach_assembly.cu) and K16 (grasp_rows.cu): each block
// copies its next tile of contiguous ranges with cp.async while it works on
// the current one.
//
// A range lands at its slot plus the phase (offset mod 4 floats) it has in
// its tensor, so that any offset copies 16 bytes at a time between a 4-byte
// head (up to the first 16-byte boundary) and a 4-byte tail; the tensor's
// base and the slot must be 16-byte aligned.  A reader finds the range at
// slot + (off & 3).
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void ring_cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}

__device__ __forceinline__ void ring_cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}

__device__ __forceinline__ void ring_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// every copy of this thread but its newest N groups has landed
template <int N>
__device__ __forceinline__ void ring_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying len floats from base + off to slot + (off & 3), by the
// `threads` threads of the block (at least 8): 16-byte chunks, the head by
// threads 0-2, the tail by threads 4-6.
__device__ __forceinline__ void ring_copy(float* slot, const float* base, long long off, int len,
                                          int threads) {
  const int tid = threadIdx.x, ph = (int)(off & 3);
  const float* src = base + off;
  float* dst = slot + ph;
  const int head = min((4 - ph) & 3, len), chunks = (len - head) >> 2;
  const int tail = len - head - 4 * chunks;
  for (int c = tid; c < chunks; c += threads) ring_cp16(dst + head + 4 * c, src + head + 4 * c);
  if (tid < head) ring_cp4(dst + tid, src + tid);
  if (tid >= 4 && tid < 4 + tail) {
    const int i = len - tail + tid - 4;
    ring_cp4(dst + i, src + i);
  }
}
