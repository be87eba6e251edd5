// Dense PQ asymmetric distance computation for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/pq_adc/kernel.py::pq_adc_pallas, as
// the reference's engine runs it: vmapped over a leading batch axis (one
// block per partition), wrapped by ops.py::pq_adc and ops.py::pq_adc_slots:
//     out[b, q, n] = sum_m lut[b, q, m, codes[b, n, m]]
// The TPU kernel scores every (query, code row) pair of a block with one-hot
// matmuls on the matrix unit and accumulates over m in grid order
// (out = 0 + p0 + p1 + ..., each one-hot product exact).  Hopper has a fast
// gather from shared memory, so here every lookup is one shared-memory load.
//
// Design: one CTA per (tile of 2048 code rows, tile of up to 4 queries,
// batch entry).  The CTA stages the whole (tq, M, K) LUT block of its
// queries in shared memory once (96 KB at M = 24, K = 256, so two CTAs fit
// on an SM), then each of its 256 threads scores 8 code rows against every
// query of the tile, holding the 32 partial sums in registers and reading
// each row's codes through L1.  The sum starts from the m = 0 entry and adds
// in m order with __fadd_rn (no contraction into an FMA), so the result is
// bitwise equal to the plain version (a gather, then a left-to-right sum
// over m), to the slot-tiled kernel and to the reference's interpret-mode
// accumulation.  Staging the whole block once, not one subspace slice per m
// behind a barrier, keeps M round trips to L2 off each CTA's critical path.
//
// Bound: bytes.  The LUTs, the codes and the output each cross device
// memory once (16.3 MB at the engine's B = 8, Q = 32, N = 8192, M = 24,
// K = 256); each LUT block is read again from L2 by every 2048-row tile of
// its batch entry (4 times there).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;                    // code rows per thread
constexpr int kTileN = kThreads * kRows;    // code rows per CTA
constexpr int kMaxTQ = 4;                   // queries per CTA
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;     // a block's share on Hopper

__global__ void adc_dense_kernel(const float* __restrict__ luts,
                                 const uint8_t* __restrict__ codes,
                                 float* __restrict__ out, int Q, int N, int M,
                                 int K, int tq) {
  extern __shared__ float lut_s[];            // (nq, M, K)
  const int b = blockIdx.z;
  const int q0 = blockIdx.y * tq;
  const int n0 = blockIdx.x * kTileN;
  const int nq = min(tq, Q - q0);

  const float* lut_g = luts + (static_cast<size_t>(b) * Q + q0) * M * K;
  for (int t = threadIdx.x; t < nq * M * K; t += blockDim.x) lut_s[t] = lut_g[t];
  __syncthreads();

  const uint8_t* code_b = codes + static_cast<size_t>(b) * N * M;
  float acc[kMaxTQ][kRows];
#pragma unroll
  for (int q = 0; q < kMaxTQ; ++q) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[q][r] = 0.0f;
  }
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int n = n0 + r * kThreads + threadIdx.x;
      if (n < N) {
        const int code = code_b[static_cast<size_t>(n) * M + m];
#pragma unroll
        for (int q = 0; q < kMaxTQ; ++q) {
          if (q < nq) {
            const float v = lut_s[(q * M + m) * K + code];
            acc[q][r] = (m == 0) ? v : __fadd_rn(acc[q][r], v);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int n = n0 + r * kThreads + threadIdx.x;
    if (n < N) {
#pragma unroll
      for (int q = 0; q < kMaxTQ; ++q) {
        if (q < nq) out[(static_cast<size_t>(b) * Q + q0 + q) * N + n] = acc[q][r];
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// luts (B, Q, M, K) float32, codes (B, N, M) uint8 with every code < K,
// out (B, Q, N) float32, all contiguous (checked by the wrapper).  A query's
// (M, K) LUT must fit in a block's shared memory.
int adc_dense_launch(const float* luts, const uint8_t* codes, float* out,
                     int B, int Q, int N, int M, int K, void* stream) {
  if (B == 0 || Q == 0 || N == 0) return 0;
  const size_t per_query = static_cast<size_t>(M) * K * sizeof(float);
  const int fit = static_cast<int>(kMaxSmem / per_query);
  if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tq = min(min(kMaxTQ, fit), Q);
  const size_t smem = per_query * tq;
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        adc_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((N + kTileN - 1) / kTileN, (Q + tq - 1) / tq, B);
  adc_dense_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      luts, codes, out, Q, N, M, K, tq);
  return static_cast<int>(cudaGetLastError());
}

const char* adc_dense_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
