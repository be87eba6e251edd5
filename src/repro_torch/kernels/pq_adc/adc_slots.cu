// Slot-tiled PQ asymmetric distance computation for Hopper (sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/pq_adc/kernel.py::pq_adc_slots_pallas (and the m-sum its
// wrapper ops.py::pq_adc_slots_tiled runs after it):
//     out[s, c] = sum_m luts[s, m, codes[s, c, m]]
// Every resident query slot s scores its own C candidates against its own
// (M, K) lookup table.  The TPU kernel expresses the lookup as a one-hot
// matmul because the TPU has no fast per-lane gather; Hopper does, so this is
// a gather from shared memory.
//
// Design: one CTA per (candidate tile of 256, slot).  The slot's LUT
// (M*K*4 bytes, 24 KB at M=24, K=256) is staged in shared memory once per
// CTA; each thread owns one candidate, reads its M uint8 codes and sums the
// M looked-up entries.  The sum runs left to right over m starting from the
// m = 0 entry -- the order of the reference's jnp.sum over that axis -- and
// uses only adds (nothing to contract into an FMA), so the result is
// bitwise equal to the plain PyTorch version and to the reference.  The
// kernel is bound by bytes: the LUTs, the codes and the output each cross
// device memory once (about 8 MB at S = C = 256, M = 24, K = 256).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileC = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

__global__ void adc_slots_kernel(const float* __restrict__ luts,
                                 const uint8_t* __restrict__ codes,
                                 float* __restrict__ out, int C, int M, int K) {
  extern __shared__ float lut_s[];
  const int s = blockIdx.y;
  const float* lut = luts + static_cast<size_t>(s) * M * K;
  for (int t = threadIdx.x; t < M * K; t += blockDim.x) lut_s[t] = lut[t];
  __syncthreads();

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const uint8_t* code = codes + (static_cast<size_t>(s) * C + c) * M;
  float acc = lut_s[code[0]];
  for (int m = 1; m < M; ++m) acc += lut_s[m * K + code[m]];
  out[static_cast<size_t>(s) * C + c] = acc;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// luts (S, M, K) float32, codes (S, C, M) uint8 with every code < K,
// out (S, C) float32, all contiguous (checked by the wrapper).
int adc_slots_launch(const float* luts, const uint8_t* codes, float* out,
                     int S, int C, int M, int K, void* stream) {
  if (S == 0 || C == 0) return 0;
  const size_t smem = static_cast<size_t>(M) * K * sizeof(float);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        adc_slots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((C + kTileC - 1) / kTileC, S);
  adc_slots_kernel<<<grid, kTileC, smem, static_cast<cudaStream_t>(stream)>>>(
      luts, codes, out, C, M, K);
  return static_cast<int>(cudaGetLastError());
}

const char* adc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
