// PQ lookup-table build for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/pq_lut/kernel.py::pq_lut_pallas
// (wrapped by ops.py::pq_lut):
//     lut[q, m, c] = |q_m|^2 - 2 * <q_m, cent[m, c]> + |cent[m, c]|^2
// for queries (Q, d) and centroids (M, K, dsub), d = M * dsub.  The TPU
// kernel writes the cross term as a (TQ, dsub) @ (dsub, K) matmul; at the
// port's dsub = 4 that is four multiply-adds per entry, far too short for
// tensor cores, so this is float32 arithmetic on the CUDA cores.
//
// Design: one CTA per (tile of 32 queries, subspace m); threads run over the
// tile's (q, c) entries, one entry each per pass.  The subspace's centroids
// (K * dsub * 4 bytes, 4 KB at K = 256, dsub = 4), their squared norms and
// the tile's query slices sit in shared memory.  Every dot product runs over
// dsub in order, each product and sum rounded on its own (__fmul_rn,
// __fadd_rn: nothing contracts into an FMA), and the entry is
// (|q|^2 - 2 * cross) + |c|^2 in that order: the plain version
// (ref.py::pq_lut_ref) computes in the same order, so the two are bitwise
// equal, and each entry is independent of how many queries share the call.
//
// Bound: bytes.  The output (Q * M * K * 4 bytes, 25 MB at Q = 1024,
// M = 24, K = 256) dominates; the inputs are read once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileQ = 32;
constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float dot_in_order(const float* x, const float* y,
                                              int n) {
  float acc = __fmul_rn(x[0], y[0]);
  for (int j = 1; j < n; ++j) acc = __fadd_rn(acc, __fmul_rn(x[j], y[j]));
  return acc;
}

__global__ void pq_lut_kernel(const float* __restrict__ queries,
                              const float* __restrict__ cent,
                              float* __restrict__ out, int Q, int M, int K,
                              int dsub) {
  extern __shared__ float smem[];
  float* cent_s = smem;                    // (K, dsub)
  float* c2_s = cent_s + K * dsub;         // (K,)
  float* q_s = c2_s + K;                   // (kTileQ, dsub)
  float* q2_s = q_s + kTileQ * dsub;       // (kTileQ,)
  const int m = blockIdx.y;
  const int q0 = blockIdx.x * kTileQ;
  const int nq = min(kTileQ, Q - q0);
  const int d = M * dsub;

  const float* cent_m = cent + static_cast<size_t>(m) * K * dsub;
  for (int t = threadIdx.x; t < K * dsub; t += blockDim.x) cent_s[t] = cent_m[t];
  for (int t = threadIdx.x; t < nq * dsub; t += blockDim.x) {
    const int q = t / dsub;
    const int j = t - q * dsub;
    q_s[t] = queries[static_cast<size_t>(q0 + q) * d + m * dsub + j];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < K; c += blockDim.x)
    c2_s[c] = dot_in_order(cent_s + c * dsub, cent_s + c * dsub, dsub);
  for (int q = threadIdx.x; q < nq; q += blockDim.x)
    q2_s[q] = dot_in_order(q_s + q * dsub, q_s + q * dsub, dsub);
  __syncthreads();

  for (int t = threadIdx.x; t < nq * K; t += blockDim.x) {
    const int q = t / K;
    const int c = t - q * K;
    const float cross = dot_in_order(q_s + q * dsub, cent_s + c * dsub, dsub);
    const float v =
        __fadd_rn(__fsub_rn(q2_s[q], __fmul_rn(2.0f, cross)), c2_s[c]);
    out[(static_cast<size_t>(q0 + q) * M + m) * K + c] = v;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// queries (Q, M * dsub) float32, centroids (M, K, dsub) float32,
// out (Q, M, K) float32, all contiguous (checked by the wrapper).
int pq_lut_launch(const float* queries, const float* cent, float* out, int Q,
                  int M, int K, int dsub, void* stream) {
  if (Q == 0 || M == 0 || K == 0) return 0;
  const size_t smem = (static_cast<size_t>(K) * (dsub + 1) +
                       static_cast<size_t>(kTileQ) * (dsub + 1)) *
                      sizeof(float);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        pq_lut_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((Q + kTileQ - 1) / kTileQ, M);
  pq_lut_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      queries, cent, out, Q, M, K, dsub);
  return static_cast<int>(cudaGetLastError());
}

const char* pq_lut_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
