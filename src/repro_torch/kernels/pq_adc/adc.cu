// Dense PQ asymmetric distance computation for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/pq_adc/kernel.py::pq_adc_pallas, as
// the reference's engine runs it: vmapped over a leading batch axis (one
// block per partition), wrapped by ops.py::pq_adc and ops.py::pq_adc_slots:
//     out[b, q, n] = sum_m lut[b, q, m, codes[b, n, m]]
// The TPU kernel scores every (query, code row) pair of a block with one-hot
// matmuls on the matrix unit and accumulates over m in grid order
// (out = 0 + p0 + p1 + ..., each one-hot product exact).  Hopper has a fast
// gather from shared memory, so here every lookup is a shared-memory load.
// The tensor cores are no help: a one-hot product on wgmma rounds the LUT to
// TF32 or bf16 (not exact in f32) and does K = 256 times the work.
//
// Bound: shared-memory lookups.  The bytes (LUTs, codes and output once
// each, 16.3 MB at the engine's B = 8, Q = 32, N = 8192, M = 24, K = 256)
// take 4.9 us; its 50.3 M lookups at 32 a clock on each of 132 SMs take
// about 7 us, raised by bank conflicts (random codes).
//
// Design: one CTA per (tile of `rows` code rows, query, batch entry); the
// row tile is sized from the shape by ops.py::adc_plan so that small calls
// (the tier's (1, g, 256 g)) still spread over the SMs and large ones keep
// the re-reads of each LUT from L2 few.  The CTA brings its query's LUT and
// its code tile (each one contiguous span of device memory) into shared
// memory with 16-byte cp.async copies issued together.  Each thread scores
// RPT code rows, reading each row's codes from shared memory as 32-bit
// words (four codes a load) and holding RPT sums in registers.  Tiles of 2
// or 4 queries a CTA, their LUTs interleaved so one 8- or 16-byte load
// fetched every query's entry, measured no faster on the H100 (PERF.md),
// so a CTA serves one query.  Each sum starts from the m = 0 entry and adds in m
// order with __fadd_rn (no contraction into an FMA), so the result is
// bitwise equal to the plain version (a gather, then a left-to-right sum
// over m), to the slot-tiled kernel and to the reference's interpret-mode
// accumulation.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;         // a block's share on Hopper

template <int RPT>
__global__ void __launch_bounds__(kMaxThreads)
adc_dense_kernel(const float* __restrict__ luts,
                 const uint8_t* __restrict__ codes, float* __restrict__ out,
                 int Q, int N, int M, int K, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.z;
  const int q = blockIdx.y;
  const int n0 = blockIdx.x * rows;
  const int nrows = min(rows, N - n0);

  // --- stage the LUT and the code tile, all copies in flight at once
  const float* lut_g = luts + (static_cast<size_t>(b) * Q + q) * M * K;
  const int lpad = stage_span(smem, reinterpret_cast<const unsigned char*>(lut_g),
                              M * K * static_cast<int>(sizeof(float)));
  const float* lut_s = reinterpret_cast<const float*>(smem + lpad);
  unsigned char* code_base = smem + lut_region(M, K);
  const int cpad = stage_span(
      code_base, codes + (static_cast<size_t>(b) * N + n0) * M, nrows * M);
  const unsigned char* code_s = code_base + cpad;
  cp_async_wait_all();
  __syncthreads();

  // --- score RPT rows a thread
  const bool words = (M & 3) == 0 && (cpad & 3) == 0;
  const int nwords = (M + 3) >> 2;
  float acc[RPT];
  int rr[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) rr[i] = threadIdx.x + i * blockDim.x;
  for (int w = 0; w < nwords; ++w) {
    uint32_t word[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      // rows past the tile read code 0 (a valid entry) and are not stored
      const unsigned char* row = code_s + rr[i] * M + 4 * w;
      if (rr[i] >= nrows) {
        word[i] = 0;
      } else if (words) {
        word[i] = *reinterpret_cast<const uint32_t*>(row);
      } else {
        uint32_t x = 0;
        for (int j = 0; j < 4 && 4 * w + j < M; ++j) x |= uint32_t{row[j]} << (8 * j);
        word[i] = x;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = 4 * w + j;
      if (m >= M) break;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float v = lut_s[m * K + static_cast<int>((word[i] >> (8 * j)) & 0xff)];
        acc[i] = (m == 0) ? v : __fadd_rn(acc[i], v);
      }
    }
  }

  float* out_q = out + (static_cast<size_t>(b) * Q + q) * N + n0;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (rr[i] < nrows) out_q[rr[i]] = acc[i];
  }
}

using AdcKernel = void (*)(const float*, const uint8_t*, float*, int, int, int,
                           int, int);

AdcKernel pick(int rpt) {
  switch (rpt) {
    case 1: return adc_dense_kernel<1>;
    case 2: return adc_dense_kernel<2>;
    case 4: return adc_dense_kernel<4>;
    case 8: return adc_dense_kernel<8>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// luts (B, Q, M, K) float32, codes (B, N, M) uint8 with every code < K,
// out (B, Q, N) float32, all contiguous (checked by the wrapper).  The row
// tile of `rows` code rows comes from ops.py::adc_plan; a CTA runs
// min(rows, 256) threads, each scoring rows / threads rows.  A tile the
// kernel does not take (rows not a multiple of 32, or more than 8 rows a
// thread), or whose shared memory or grid exceeds the card's limits,
// returns cudaErrorInvalidValue without launching.
int adc_dense_launch(const float* luts, const uint8_t* codes, float* out,
                     int B, int Q, int N, int M, int K, int rows,
                     void* stream) {
  if (B == 0 || Q == 0 || N == 0) return 0;
  const int threads = rows < kMaxThreads ? rows : kMaxThreads;
  if (rows <= 0 || rows % 32 != 0 || rows % threads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const AdcKernel kernel = pick(rows / threads);
  const size_t smem = lut_region(M, K) + code_region(rows, M);
  if (kernel == nullptr || smem > kMaxSmem || Q > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((N + rows - 1) / rows, Q, B);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      luts, codes, out, Q, N, M, K, rows);
  return static_cast<int>(cudaGetLastError());
}

const char* adc_dense_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
