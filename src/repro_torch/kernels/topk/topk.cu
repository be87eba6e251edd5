// Batched bitonic top-k for Hopper (sm_90a): the beam and pool merges.
//
// Replaces the TPU kernel repro/kernels/topk/kernel.py::bitonic_topk_pallas.
// Per row it returns the k smallest (value, index) pairs in ascending order,
// ties broken by the smaller index, exactly as the Pallas network and
// jnp.lexsort((idx, val)) order them.  A row may arrive as two lists (a
// then b, the merge of beam and candidates); the kernel reads both in place
// and pads the row to a power of two with (+inf, INT32_MAX), so no
// concatenated or padded copy is ever written to device memory.  Any sort by
// this strict total order gives the same pairs bitwise: equal pairs (the
// padding, a merge's repeated fill) are interchangeable.
//
// Bound: latency.  At the slice's shapes (B = 256 rows of 320 or 264 pairs,
// padded to 512) the kernel moves under 1 MB (0.3 us of bytes).  What its
// time follows, measured on the H100 (PERF.md), is the
// number of dependent network stages, about 0.1 us each, on top of about
// 2 us of launch, loads and stores; neither the pairs a thread nor the
// number of warps doing work moves it much.  So the kernel keeps every
// stage short and does no stage it can skip: one CTA a row, E pairs a
// thread in registers; strides inside a thread are register exchanges,
// inside a warp __shfl_xor_sync, across warps one shared-memory exchange
// between two barriers.  It sorts only chunks of k (rounded up to a power
// of two), then halves them, keeping the best k of each pair (bitonic
// top-k: 42 stages for k = 64 of 512, against 45), and a warp holding only
// padding or dropped chunks does no compare-exchange.  ops.py::topk_plan
// picks E from the padded length; when n / E = 32 the row is one warp and
// no stage touches shared memory.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Bitwise & and |, not && and ||: no short-circuit branch, so a lane's
// compare-exchanges stay independent instructions the scheduler overlaps.
__device__ __forceinline__ bool pair_less(float v, int i, float pv, int pi) {
  return (v < pv) | ((v == pv) & (i < pi));
}

// Pairs e0 .. e0 + E - 1 of the row (lists a then b, then padding).
template <int E>
__device__ __forceinline__ void load_row(float (&v)[E], int (&x)[E], int e0,
                                         const float* va, const int* ia, int ca,
                                         const float* vb, const int* ib, int cb) {
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e = e0 + j;
    if (e < ca) {
      v[j] = va[e];
      x[j] = ia[e];
    } else if (e < ca + cb) {
      v[j] = vb[e - ca];
      x[j] = ib[e - ca];
    } else {
      v[j] = INFINITY;
      x[j] = INT32_MAX;
    }
  }
}

// Set (v, x) to the smaller (keep_min) or larger of itself and (ov, ox):
// one compare, since two pairs neither smaller than the other are the same
// pair and taking it changes nothing (-0.0 and +0.0 under one index would
// be the exception; a row's indices are distinct apart from the padding).
__device__ __forceinline__ void keep(float& v, int& x, float ov, int ox,
                                     bool keep_min) {
  const bool take = pair_less(ov, ox, v, x) == keep_min;
  v = take ? ov : v;
  x = take ? ox : x;
}

// One compare-exchange stage: the pair at e meets the pair at e ^ mask, and
// the one with bit `lobit` clear keeps the smaller.  RM = mask & (E - 1) is
// the register part of the mask (a template argument, so registers are
// indexed statically); lane_mask = mask / E the thread part.  Thread parts
// of 32 and above cross warps and go through shared memory (sv, si, laid
// out (E, threads) so each exchange is conflict-free) between barriers
// that every thread reaches; `active` (uniform over a warp) skips the
// compare-exchanges of a warp whose pairs cannot change or are not needed.
template <int E, int RM>
__device__ __forceinline__ void stage(float (&v)[E], int (&x)[E], int e0,
                                      int lane_mask, int lobit, bool active,
                                      float* sv, int* si) {
  const int t = threadIdx.x;
  const int cols = blockDim.x;
  if (lane_mask >= 32) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      sv[j * cols + t] = v[j];
      si[j * cols + t] = x[j];
    }
    __syncthreads();
    if (active) {
      const int pt = t ^ lane_mask;
      const bool lo = (e0 & lobit) == 0;
#pragma unroll
      for (int j = 0; j < E; ++j)
        keep(v[j], x[j], sv[(j ^ RM) * cols + pt], si[(j ^ RM) * cols + pt], lo);
    }
    __syncthreads();
  } else if (!active) {
    return;
  } else if (lane_mask > 0) {              // across lanes of the warp
    const bool lo = (e0 & lobit) == 0;
    float ov[E];                           // all received before any update:
    int ox[E];                             // register j ^ RM may be sent later
#pragma unroll
    for (int j = 0; j < E; ++j) {
      ov[j] = __shfl_xor_sync(0xffffffffu, v[j ^ RM], lane_mask);
      ox[j] = __shfl_xor_sync(0xffffffffu, x[j ^ RM], lane_mask);
    }
#pragma unroll
    for (int j = 0; j < E; ++j) keep(v[j], x[j], ov[j], ox[j], lo);
  } else {                                 // inside the thread's registers
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int p = j ^ RM;
      if (p <= j || (j & lobit)) continue;   // each pair once, from its lower end
      const bool swap = pair_less(v[p], x[p], v[j], x[j]);
      const float tv = v[j];
      const int tx = x[j];
      v[j] = swap ? v[p] : tv;
      x[j] = swap ? x[p] : tx;
      v[p] = swap ? tv : v[p];
      x[p] = swap ? tx : x[p];
    }
  }
}

// stage<E, mask & (E - 1)>, the register part picked at run time.
template <int E, int RM = 0>
__device__ __forceinline__ void stage_at(float (&v)[E], int (&x)[E], int e0,
                                         int mask, int lobit, bool active,
                                         float* sv, int* si) {
  if constexpr (RM < E) {
    if ((mask & (E - 1)) == RM)
      stage<E, RM>(v, x, e0, mask / E, lobit, active, sv, si);
    else
      stage_at<E, RM + 1>(v, x, e0, mask, lobit, active, sv, si);
  }
}

// One row a CTA of n / E threads, E consecutive pairs a thread.
//  1. Sort each chunk of kp pairs (kp = k rounded up to a power of two)
//     with the all-ascending bitonic network: merge size kk first meets e
//     with e ^ (kk - 1) (its mirror), then half-cleans with strides kk/4 ..
//     1; the lower index keeps the smaller pair every time.  The padding,
//     the largest pair, never moves, so a warp holding only padding skips.
//  2. Halve the chunks: chunk p (p a multiple of 2d) meets chunk p + d
//     mirrored, keeps the kp smaller pairs (every pair of the other chunk
//     has kp smaller ones, so none of them is in the top k) and half-cleans
//     them back into order; the other chunk is dropped.
// The first k pairs of chunk 0 are the answer.
template <int E>
__global__ void __launch_bounds__(1024)
topk_kernel(const float* __restrict__ va, const int* __restrict__ ia, int ca,
            const float* __restrict__ vb, const int* __restrict__ ib, int cb,
            int n, int kp, int k, float* __restrict__ out_v,
            int* __restrict__ out_i) {
  extern __shared__ unsigned char smem_raw[];
  float* sv = reinterpret_cast<float*>(smem_raw);
  int* si = reinterpret_cast<int*>(sv + n);
  constexpr int W = 32 * E;                // pairs a warp holds
  const int row = blockIdx.x;
  const int e0 = threadIdx.x * E;
  const int w0 = e0 & ~(W - 1);            // the warp's first pair
  float v[E];
  int x[E];
  load_row<E>(v, x, e0, va + static_cast<size_t>(row) * ca,
              ia + static_cast<size_t>(row) * ca, ca,
              vb + static_cast<size_t>(row) * cb,
              ib + static_cast<size_t>(row) * cb, cb);
  const bool real = w0 < ca + cb;          // not all padding
  for (int kk = 2; kk <= kp; kk <<= 1) {
    stage_at<E>(v, x, e0, kk - 1, kk >> 1, real, sv, si);
    for (int jj = kk >> 2; jj >= 1; jj >>= 1)
      stage_at<E>(v, x, e0, jj, jj, real, sv, si);
  }
  for (int d = kp; d < n; d <<= 1) {
    // the warp holds part of a chunk that survives this level
    const bool alive = real && (w0 & (2 * d - 1)) < kp;
    stage_at<E>(v, x, e0, d + kp - 1, d, alive, sv, si);
    for (int jj = kp >> 1; jj >= 1; jj >>= 1)
      stage_at<E>(v, x, e0, jj, jj, alive, sv, si);
  }
  float* ov = out_v + static_cast<size_t>(row) * k;
  int* oi = out_i + static_cast<size_t>(row) * k;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if (e0 + j < k) {
      ov[e0 + j] = v[j];
      oi[e0 + j] = x[j];
    }
  }
}

using TopkKernel = void (*)(const float*, const int*, int, const float*,
                            const int*, int, int, int, int, float*, int*);

TopkKernel pick(int e) {
  switch (e) {
    case 1: return topk_kernel<1>;
    case 2: return topk_kernel<2>;
    case 4: return topk_kernel<4>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// vb/ib may be null when cb == 0.  n is the padded row length, a power of
// two with ca + cb <= n <= 4096; 1 <= k <= ca + cb.  per_lane (E, from
// ops.py::topk_plan) is 1, 2 or 4 with 32 <= n / E <= 1024 threads a row.
// Anything else returns cudaErrorInvalidValue without launching.
int bitonic_topk_launch(const float* va, const int* ia, int ca,
                        const float* vb, const int* ib, int cb, int rows,
                        int n, int k, int per_lane, float* out_v, int* out_i,
                        void* stream) {
  if (rows == 0) return 0;
  const TopkKernel kernel = pick(per_lane);
  if (kernel == nullptr || n > 4096 || (n & (n - 1)) != 0 ||
      n / per_lane < 32 || n / per_lane > 1024 || k < 1 || k > ca + cb ||
      ca + cb > n)
    return static_cast<int>(cudaErrorInvalidValue);
  int kp = 1;
  while (kp < k) kp <<= 1;
  const size_t smem = static_cast<size_t>(n) * (sizeof(float) + sizeof(int));
  kernel<<<rows, n / per_lane, smem, static_cast<cudaStream_t>(stream)>>>(
      va, ia, ca, vb, ib, cb, n, kp, k, out_v, out_i);
  return static_cast<int>(cudaGetLastError());
}

const char* topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
