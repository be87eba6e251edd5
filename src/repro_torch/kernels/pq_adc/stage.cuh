// Staging of a span of device memory into shared memory by 16-byte
// cp.async, shared by the dense (adc.cu) and slot-tiled (adc_slots.cu) ADC
// kernels.  _build.library_path hashes this header with each source.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t{15}; }

// Shared-memory layout of a CTA that stages one (M, K) LUT and a tile of
// `rows` code rows; ops.py::adc_smem repeats these formulas.  The spans
// staged with stage_span keep their source's offset modulo 16, so each
// region has 16 bytes of slack.
__host__ __device__ inline size_t lut_region(int M, int K) {
  return align16(static_cast<size_t>(M) * K * sizeof(float) + 16);
}
__host__ __device__ inline size_t code_region(int rows, int M) {
  return align16(static_cast<size_t>(rows) * M + 16);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// Copy `nbytes` from `src` to shared memory at dst16 + (src mod 16), so that
// 16-byte-aligned chunks of the source land on 16-byte-aligned addresses:
// the aligned body goes by cp.async, the (at most 15-byte) head and tail by
// plain byte copies.  Returns the offset src mod 16.  The caller commits
// and waits (cp_async_wait_all) and then synchronises the block.
__device__ __forceinline__ int stage_span(unsigned char* dst16,
                                          const unsigned char* src,
                                          int nbytes) {
  const int pad = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  unsigned char* dst = dst16 + pad;
  const int head = min(nbytes, (16 - pad) & 15);
  const int chunks = (nbytes - head) >> 4;
  const int tail = head + (chunks << 4);
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  for (int c = threadIdx.x; c < chunks; c += blockDim.x)
    cp_async16(dst + head + (c << 4), src + head + (c << 4));
  for (int i = tail + threadIdx.x; i < nbytes; i += blockDim.x) dst[i] = src[i];
  return pad;
}

// Wait for every cp.async this thread issued (then __syncthreads()).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
