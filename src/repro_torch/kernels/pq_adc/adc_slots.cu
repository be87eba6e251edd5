// Slot-tiled PQ asymmetric distance computation for Hopper (sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/pq_adc/kernel.py::pq_adc_slots_pallas (and the m-sum its
// wrapper ops.py::pq_adc_slots_tiled runs after it):
//     out[s, c] = sum_m luts[s, m, codes[s, c, m]]
// Every resident query slot s scores its own C candidates against its own
// (M, K) lookup table.  The TPU kernel expresses the lookup as a one-hot
// matmul because the TPU has no fast per-lane gather; Hopper does, so this is
// a gather.
//
// Bound: bytes.  The LUTs, the codes and the output each cross device memory
// once (about 8 MB at S = C = 256, M = 24, K = 256: 2.4 us).
//
// Design: one CTA per (slot, tile of `tile` candidates), a thread a
// candidate; the slot is grid x (up to 2^31 - 1 slots: a scatter-gather call
// of 8192 queries over 10 partitions is 81,920), the candidate tile grid y;
// the tile and the route come from ops.py::adc_slots_plan.
//   staged (calls that cannot fill the card, where latency counts): the
//     slot's LUT (24 KB at M = 24, K = 256) and the CTA's code tile (one
//     contiguous span) go into shared memory by 16-byte cp.async, both in
//     flight before the one wait, so their round trips overlap; the lookups
//     are shared-memory loads.
//   direct (calls that fill the card, where throughput counts, and LUTs
//     past shared memory): no shared memory and no barrier; each thread
//     reads its codes from device memory and looks its entries up in the
//     LUT through L1 (ld.global.nc), so a CTA reads only the entries it
//     uses.
// Either way a thread reads its codes as 32-bit words (four codes a load;
// bytewise where M is not a multiple of 4 or the codes start off a 4-byte
// boundary) up to 32 codes at a time, then issues those lookups together
// before it adds them.  Each sum starts from the m = 0 entry and adds in m
// order with __fadd_rn (nothing contracts into an FMA), so the result is
// bitwise equal to the plain version (a gather, then a left-to-right sum
// over m) and to the reference.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage.cuh"

namespace {

constexpr int kMaxTile = 256;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;         // a block's share on Hopper

// Codes m .. m+3 of a row (those below M), packed little-endian.
__device__ __forceinline__ uint32_t code_word(const uint8_t* row, int m,
                                              int M, bool words) {
  if (words) return *reinterpret_cast<const uint32_t*>(row + m);
  uint32_t x = 0;
  for (int j = 0; j < 4 && m + j < M; ++j) x |= uint32_t{row[m + j]} << (8 * j);
  return x;
}

template <bool kDirect>
__device__ __forceinline__ float lut_entry(const float* p) {
  if constexpr (kDirect) return __ldg(p);
  return *p;
}

// sum_m lut[m * K + row[m]] in m order, 32 codes a round: their words
// first, then their lookups, then the adds.
template <bool kDirect>
__device__ __forceinline__ float score_row(const float* lut, const uint8_t* row,
                                           int M, int K, bool words) {
  float acc = 0.0f;
  for (int m0 = 0; m0 < M; m0 += 32) {
    uint32_t word[8];
#pragma unroll
    for (int w = 0; w < 8; ++w)
      word[w] = m0 + 4 * w < M ? code_word(row, m0 + 4 * w, M, words) : 0u;
    float v[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int code = static_cast<int>((word[j >> 2] >> (8 * (j & 3))) & 0xff);
      v[j] = m0 + j < M ? lut_entry<kDirect>(lut + (m0 + j) * K + code) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (m0 + j < M) acc = (m0 + j == 0) ? v[j] : __fadd_rn(acc, v[j]);
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kMaxTile)
adc_slots_staged(const float* __restrict__ luts,
                 const uint8_t* __restrict__ codes, float* __restrict__ out,
                 int C, int M, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x;
  const int c0 = blockIdx.y * blockDim.x;
  const int nc = min(static_cast<int>(blockDim.x), C - c0);

  // --- stage the LUT and the code tile, all copies in flight at once
  const float* lut_g = luts + static_cast<size_t>(s) * M * K;
  const int lpad = stage_span(smem, reinterpret_cast<const unsigned char*>(lut_g),
                              M * K * static_cast<int>(sizeof(float)));
  const float* lut_s = reinterpret_cast<const float*>(smem + lpad);
  unsigned char* code_base = smem + lut_region(M, K);
  const int cpad = stage_span(
      code_base, codes + (static_cast<size_t>(s) * C + c0) * M, nc * M);
  const uint8_t* code_s = code_base + cpad;
  cp_async_wait_all();
  __syncthreads();

  const int i = threadIdx.x;
  if (i >= nc) return;
  const bool words = (M & 3) == 0 && (cpad & 3) == 0;
  out[static_cast<size_t>(s) * C + c0 + i] =
      score_row<false>(lut_s, code_s + i * M, M, K, words);
}

__global__ void __launch_bounds__(kMaxTile)
adc_slots_direct(const float* __restrict__ luts,
                 const uint8_t* __restrict__ codes, float* __restrict__ out,
                 int C, int M, int K) {
  const int s = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const bool words =
      (M & 3) == 0 && (reinterpret_cast<uintptr_t>(codes) & 3) == 0;
  const size_t sc = static_cast<size_t>(s) * C + c;
  out[sc] = score_row<true>(luts + static_cast<size_t>(s) * M * K,
                            codes + sc * M, M, K, words);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// luts (S, M, K) float32, codes (S, C, M) uint8 with every code < K,
// out (S, C) float32, all contiguous (checked by the wrapper).  The tile of
// `tile` candidates (and threads) a CTA and the route (staged != 0: the
// staged route) come from ops.py::adc_slots_plan.  A tile the kernel does
// not take (not a multiple of 32 in 32..256), or whose shared memory or
// candidate tiles (grid y) exceed the card's limits, returns
// cudaErrorInvalidValue without launching.
int adc_slots_launch(const float* luts, const uint8_t* codes, float* out,
                     int S, int C, int M, int K, int tile, int staged,
                     void* stream) {
  if (S == 0 || C == 0) return 0;
  if (tile < 32 || tile > kMaxTile || tile % 32 != 0 || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (C + tile - 1) / tile;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(S, tiles);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (staged) {
    const size_t smem = lut_region(M, K) + code_region(tile, M);
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > kDefaultSmem) {
      cudaError_t err = cudaFuncSetAttribute(
          adc_slots_staged, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    adc_slots_staged<<<grid, tile, smem, st>>>(luts, codes, out, C, M, K);
  } else {
    adc_slots_direct<<<grid, tile, 0, st>>>(luts, codes, out, C, M, K);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* adc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
