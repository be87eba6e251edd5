// Batched bitonic top-k for Hopper (sm_90a): the beam and pool merges.
//
// Replaces the TPU kernel repro/kernels/topk/kernel.py::bitonic_topk_pallas.
// Per row it returns the k smallest (value, index) pairs in ascending order,
// ties broken by the smaller index, exactly as the Pallas network and
// jnp.lexsort((idx, val)) order them.  A row may arrive as two lists (a
// then b, the merge of beam and candidates); the kernel reads both straight
// into shared memory and pads the row to a power of two with
// (+inf, INT32_MAX), so no concatenated or padded copy is ever written to
// device memory.
//
// Design: one CTA per row.  The row (<= 4096 pairs, 8 bytes each) lives in
// shared memory; each thread owns cpad/2/blockDim compare-exchange pairs per
// stage, with a barrier between stages.  At the slice's shapes (B = 256 rows
// of 320 or 264 pairs -> 512) the kernel moves well under 1 MB, so it is
// bound by launch latency and the log2(cpad)*(log2(cpad)+1)/2 = 45 barrier
// stages, not by bytes; a warp-shuffle network for the short strides is the
// obvious next step and is left for a later change.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;

__device__ __forceinline__ bool pair_less(float v, int i, float pv, int pi) {
  return (v < pv) || (v == pv && i < pi);
}

__global__ void bitonic_topk_kernel(const float* __restrict__ va,
                                    const int* __restrict__ ia, int ca,
                                    const float* __restrict__ vb,
                                    const int* __restrict__ ib, int cb,
                                    int cpad, int k,
                                    float* __restrict__ out_v,
                                    int* __restrict__ out_i) {
  extern __shared__ unsigned char smem_raw[];
  float* sv = reinterpret_cast<float*>(smem_raw);
  int* si = reinterpret_cast<int*>(sv + cpad);
  const int row = blockIdx.x;
  const float* rva = va + static_cast<size_t>(row) * ca;
  const int* ria = ia + static_cast<size_t>(row) * ca;
  const float* rvb = vb + static_cast<size_t>(row) * cb;
  const int* rib = ib + static_cast<size_t>(row) * cb;

  for (int t = threadIdx.x; t < cpad; t += blockDim.x) {
    if (t < ca) {
      sv[t] = rva[t];
      si[t] = ria[t];
    } else if (t < ca + cb) {
      sv[t] = rvb[t - ca];
      si[t] = rib[t - ca];
    } else {
      sv[t] = INFINITY;
      si[t] = INT32_MAX;
    }
  }
  __syncthreads();

  const int half = cpad >> 1;
  for (int kk = 2; kk <= cpad; kk <<= 1) {
    for (int jj = kk >> 1; jj > 0; jj >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        // t-th pair: a has bit jj clear, b = a ^ jj
        const int a = ((t & ~(jj - 1)) << 1) | (t & (jj - 1));
        const int b = a + jj;
        const float fa = sv[a], fb = sv[b];
        const int xa = si[a], xb = si[b];
        const bool ascending = (a & kk) == 0;
        const bool swap = ascending ? pair_less(fb, xb, fa, xa)
                                    : pair_less(fa, xa, fb, xb);
        if (swap) {
          sv[a] = fb;
          sv[b] = fa;
          si[a] = xb;
          si[b] = xa;
        }
      }
      __syncthreads();
    }
  }

  float* ov = out_v + static_cast<size_t>(row) * k;
  int* oi = out_i + static_cast<size_t>(row) * k;
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    ov[t] = sv[t];
    oi[t] = si[t];
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// vb/ib may be null when cb == 0.  Requires cpad a power of two with
// ca + cb <= cpad <= 4096 and 1 <= k <= ca + cb (checked by the wrapper).
int bitonic_topk_launch(const float* va, const int* ia, int ca,
                        const float* vb, const int* ib, int cb, int rows,
                        int cpad, int k, float* out_v, int* out_i,
                        void* stream) {
  if (rows == 0) return 0;
  int threads = cpad / 2 < kMaxThreads ? cpad / 2 : kMaxThreads;
  threads = threads < 32 ? 32 : threads;
  const size_t smem = static_cast<size_t>(cpad) * (sizeof(float) + sizeof(int));
  bitonic_topk_kernel<<<rows, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      va, ia, ca, vb, ib, cb, cpad, k, out_v, out_i);
  return static_cast<int>(cudaGetLastError());
}

const char* topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
