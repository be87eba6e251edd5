// Batched top-k for Hopper (sm_90a): the beam and pool merges.  Two routes,
// both the function `topk_kernel`.
//
// Per row it returns the k smallest (value, index) pairs in ascending order,
// ties broken by the smaller index, exactly as jnp.lexsort((idx, val)) and
// topk_ref order them.  A row may arrive as two lists (a then b, the merge
// of beam and candidates); the kernel reads both in place, so no
// concatenated or padded copy is ever written to device memory.  Any sort
// by this strict total order gives the same pairs bitwise: equal pairs (the
// padding, a merge's repeated fill) are interchangeable.
//
// The network route replaces the TPU kernel
// repro/kernels/topk/kernel.py::bitonic_topk_pallas: it pads the row to a
// power of two with (+inf, INT32_MAX) and sorts it.  Bound: latency, the
// number of dependent network stages, about 0.1 us each, on top of about
// 2 us of launch, loads and stores (PERF.md).  So it keeps every stage
// short and does no stage it can skip: one CTA a row, E pairs a thread in
// registers; strides inside a thread are register exchanges, inside a warp
// __shfl_xor_sync, across warps one shared-memory exchange between two
// barriers.  It sorts only chunks of k (rounded up to a power of two), then
// halves them, keeping the best k of each pair (bitonic top-k), and a warp
// holding only padding or dropped chunks does no compare-exchange.
//
// The rank route replaces no TPU kernel.  It was added because every
// merge_topk caller passes as list a the previous merge's output, already
// in order, and only b (the scored candidates, or a hop's exact reads) is
// unordered: sorting whole rows repeated that work, 55 dependent stages for
// the scatter-gather beam of 768 + 256 pairs, half of them shared-memory
// exchanges between barriers.  It drops the pairs of b that cannot be
// kept, sorts the rest over the CTA (a few pairs a thread, the network's
// stages), then places each pair at its rank in the merged row (merge
// path, binary searches in shared memory).  Bound: bytes, each pair read
// once from device memory and each kept pair written once; few threads a
// row (n / 16), so that many rows are in flight on each SM.  A vote checks
// that a is in order; a row whose a is not is sorted whole by the network
// in shared memory inside the same launch and is counted, so the answer
// never depends on the caller.
//
// ops.py::topk_plan picks the route from the shapes: the rank route where
// 1 <= cb <= 256 and cb <= ca; the network everywhere else: plain top-k of
// one list (cb = 0), b past 256, and rows whose b outnumbers a (the baton
// engine's beam, 64 | 256, and the examples' beams), where sorting b
// costs about what the network does and the rank route wins only on many
// rows.
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

// The network's stages over a row of c real pairs held E a thread (pair
// e0 + j in v[j], x[j]; past c the padding, the largest pair), a CTA of
// n / E threads.
//  1. Sort each chunk of kp pairs (kp = k rounded up to a power of two)
//     with the all-ascending bitonic network: merge size kk first meets e
//     with e ^ (kk - 1) (its mirror), then half-cleans with strides kk/4 ..
//     1; the lower index keeps the smaller pair every time.  The padding
//     never moves, so a warp holding only padding skips.
//  2. Halve the chunks: chunk p (p a multiple of 2d) meets chunk p + d
//     mirrored, keeps the kp smaller pairs (every pair of the other chunk
//     has kp smaller ones, so none of them is in the top k) and half-cleans
//     them back into order; the other chunk is dropped.
// The first k pairs of chunk 0 are the answer.
template <int E>
__device__ __forceinline__ void sort_regs(float (&v)[E], int (&x)[E], int e0,
                                          int c, int n, int kp, float* sv,
                                          int* si) {
  constexpr int W = 32 * E;                // pairs a warp holds
  const int w0 = e0 & ~(W - 1);            // the warp's first pair
  const bool real = w0 < c;                // not all padding
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
}

// The network route on one row: a CTA of n / E threads, E pairs a thread.
template <int E>
__device__ __forceinline__ void network_row(
    const float* va, const int* ia, int ca, const float* vb, const int* ib,
    int cb, int n, int kp, int k, float* ov, int* oi, float* sv, int* si) {
  const int e0 = threadIdx.x * E;
  float v[E];
  int x[E];
  load_row<E>(v, x, e0, va, ia, ca, vb, ib, cb);
  sort_regs<E>(v, x, e0, ca + cb, n, kp, sv, si);
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if (e0 + j < k) {
      ov[e0 + j] = v[j];
      oi[e0 + j] = x[j];
    }
  }
}

// A pair in shared memory: the value, and the index's bits in .y.
__device__ __forceinline__ float2 pack(float v, int x) {
  return make_float2(v, __int_as_float(x));
}

__device__ __forceinline__ bool less2(float2 p, float2 q) {
  return pair_less(p.x, __float_as_int(p.y), q.x, __float_as_int(q.y));
}

// The rank route's fallback: the whole row (a, b, then padding to n) sorted
// in shared memory by the same all-ascending network, one compare-exchange
// a thread at a time between barriers, so it takes any CTA size and few
// registers.  Slow, and run only on a row whose a is out of order.
__device__ __noinline__ void smem_network_row(
    const float* va, const int* ia, int ca, const float* vb, const int* ib,
    int cb, int n, int k, float* ov, int* oi, float2* s) {
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  for (int e = t; e < n; e += nt)
    s[e] = e < ca ? pack(va[e], ia[e])
         : e < ca + cb ? pack(vb[e - ca], ib[e - ca])
         : pack(INFINITY, INT32_MAX);
  __syncthreads();
  for (int kk = 2; kk <= n; kk <<= 1) {
    for (int jj = kk >> 1; jj >= 1; jj >>= 1) {
      for (int p = t; p < n / 2; p += nt) {
        const int lo = ((p & ~(jj - 1)) << 1) | (p & (jj - 1));
        const int hi = jj == kk >> 1 ? lo ^ (kk - 1) : lo + jj;
        const float2 l = s[lo], h = s[hi];
        if (less2(h, l)) {
          s[lo] = h;
          s[hi] = l;
        }
      }
      __syncthreads();
    }
  }
  for (int d = t; d < k; d += nt) {
    ov[d] = s[d].x;
    oi[d] = __float_as_int(s[d].y);
  }
}

// The rank route on one row (list a in order), a CTA of nt threads; b is
// held E pairs a thread (nt * E >= cb).  Returns false, with nothing
// written, when a is out of order.
//  1. The CTA copies a and b into shared memory, coalesced, each pair read
//     once.
//  2. A vote over adjacent pairs of a: any pair smaller than the one
//     before it sends the whole row to the fallback.
//  3. Where k <= ca, a pair of b not below a[k - 1] has k pairs of a at
//     or before it and is never kept: b's other pairs (all of them where
//     k > ca) are moved to its front in order by a scan over the CTA, and
//     only those are sorted, with the network's stages over as many
//     slots, rounded up to a power of two (strides inside a warp by
//     shuffles, beyond it through shared memory).  On a finished branch's
//     rows (b all padding) none is left and nothing is sorted.
//  4. Merge path: thread t owns outputs d0 .. d0 + per - 1.  The first d0
//     hold a[0 .. i - 1] and b[0 .. d0 - i - 1], i the first index with
//     b[d0 - 1 - i] < a[i] (on equal pairs a comes first), found by a
//     binary search in shared memory; from there the thread merges per
//     pairs into an output row in shared memory, which the CTA then
//     writes out coalesced.  So a[i] lands at i + #{b < a[i]} and b[j] at
//     j + #{a <= b[j]}, and the k kept are written once.
// Equal pairs are interchangeable, so the k pairs are the network's
// bitwise, whichever of two equal pairs is taken first.
template <int E>
__device__ __forceinline__ bool rank_row(
    const float* va, const int* ia, int ca, const float* vb, const int* ib,
    int cb, int k, float* ov, int* oi, float2* sa) {
  __shared__ int warp_kept[32];
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = t & 31;
  const int c = ca + cb;
  float2* sb = sa + ca;
  float2* so = sb + cb;                    // the k kept, in order; before
                                           // that the sort's exchanges
#pragma unroll 8
  for (int e = t; e < c; e += nt)
    sa[e] = e < ca ? pack(va[e], ia[e]) : pack(vb[e - ca], ib[e - ca]);
  __syncthreads();
  bool bad = false;
  for (int e = t + 1; e < ca; e += nt) bad |= less2(sa[e], sa[e - 1]);
  // b's pairs this thread holds, and which of them can be kept
  const int e0 = t * E;
  const float2 last = sa[min(k, ca) - 1];
  float2 p[E];
  int kept = 0;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    p[j] = e0 + j < cb ? sb[e0 + j] : pack(INFINITY, INT32_MAX);
    const bool keep = e0 + j < cb && (k > ca || less2(p[j], last));
    kept |= keep << j;
  }
  int before = __popc(kept);               // inclusive scan over the warp
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, before, s);
    if (lane >= s) before += o;
  }
  if (lane == 31) warp_kept[t >> 5] = before;
  if (__syncthreads_or(bad)) return false;
  before -= __popc(kept);
  int cbk = 0;                             // b's pairs left
  for (int w = 0; w < nt >> 5; ++w) {
    const int n_w = warp_kept[w];
    before += w < (t >> 5) ? n_w : 0;
    cbk += n_w;
  }
#pragma unroll
  for (int j = 0; j < E; ++j)              // every read is done: in place
    if ((kept >> j) & 1) sb[before++] = p[j];
  __syncthreads();
  if (cbk > 1) {
    int cbp = 1;                           // the sorted length
    while (cbp < cbk) cbp <<= 1;
    float v[E];
    int x[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float2 q = e0 + j < cbk ? sb[e0 + j] : pack(INFINITY, INT32_MAX);
      v[j] = q.x;
      x[j] = __float_as_int(q.y);
    }
    float* sv = reinterpret_cast<float*>(so);
    sort_regs<E>(v, x, e0, cbk, cbp, cbp, sv,
                 reinterpret_cast<int*>(sv + E * nt));
#pragma unroll
    for (int j = 0; j < E; ++j)            // the slots this thread read
      if (e0 + j < cbk) sb[e0 + j] = pack(v[j], x[j]);
    __syncthreads();
  }
  const int per = (k + nt - 1) / nt;
  const int d0 = min(t * per, k);
  const int d1 = min(d0 + per, k);
  int lo = max(0, d0 - cbk), hi = min(d0, ca);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (less2(sb[d0 - 1 - mid], sa[mid]))
      hi = mid;
    else
      lo = mid + 1;
  }
  int i = lo, j = d0 - lo;
  float2 pa = sa[min(i, ca - 1)];
  float2 pb = sb[max(min(j, cbk - 1), 0)];
  for (int d = d0; d < d1; ++d) {
    const bool take_b = i >= ca || (j < cbk && less2(pb, pa));
    so[d] = take_b ? pb : pa;
    if (take_b) {
      ++j;
      pb = sb[max(min(j, cbk - 1), 0)];
    } else {
      ++i;
      pa = sa[min(i, ca - 1)];
    }
  }
  __syncthreads();
  for (int d = t; d < k; d += nt) {
    const float2 q = so[d];
    ov[d] = q.x;
    oi[d] = __float_as_int(q.y);
  }
  return true;
}

// One row a CTA.  RANK false: the network, E pairs a thread.  RANK true:
// the rank route, E of b's pairs a thread; a row whose a is out
// of order takes the shared-memory network and is counted in *fallback.
// One function name for both routes, so a trace sums their seconds under
// `topk_kernel`.
template <int E, bool RANK>
__global__ void __launch_bounds__(1024)
topk_kernel(const float* __restrict__ va, const int* __restrict__ ia, int ca,
            const float* __restrict__ vb, const int* __restrict__ ib, int cb,
            int n, int kp, int k, int* __restrict__ fallback,
            float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ float2 smem[];
  const size_t row = blockIdx.x;
  va += row * ca;
  ia += row * ca;
  if (cb > 0) {
    vb += row * cb;
    ib += row * cb;
  }
  float* ov = out_v + row * k;
  int* oi = out_i + row * k;
  if constexpr (RANK) {
    if (rank_row<E>(va, ia, ca, vb, ib, cb, k, ov, oi, smem)) return;
    if (threadIdx.x == 0) atomicAdd(fallback, 1);
    smem_network_row(va, ia, ca, vb, ib, cb, n, k, ov, oi, smem);
  } else {
    float* sv = reinterpret_cast<float*>(smem);
    network_row<E>(va, ia, ca, vb, ib, cb, n, kp, k, ov, oi, sv,
                   reinterpret_cast<int*>(sv + n));
  }
}

using TopkKernel = void (*)(const float*, const int*, int, const float*,
                            const int*, int, int, int, int, int*, float*,
                            int*);

template <bool RANK>
TopkKernel pick(int e) {
  switch (e) {
    case 1: return topk_kernel<1, RANK>;
    case 2: return topk_kernel<2, RANK>;
    case 4: return topk_kernel<4, RANK>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// vb/ib may be null when cb == 0.  n is the padded row length, a power of
// two with ca + cb <= n <= 4096; 1 <= k <= ca + cb; threads a row
// (one CTA a row) a power of two in 32 .. 1024.  sort_lane 0 runs the
// network with n / threads (1, 2 or 4) pairs a thread; 1, 2 or 4 the
// rank route (ca >= 1, 1 <= cb <= threads * sort_lane once rounded up to
// a power of two), which counts the rows it sends to its fallback into
// *fallback (device memory, not null).  Anything else returns
// cudaErrorInvalidValue without launching.
int bitonic_topk_launch(const float* va, const int* ia, int ca,
                        const float* vb, const int* ib, int cb, int rows,
                        int n, int k, int threads, int sort_lane,
                        int* fallback, float* out_v, int* out_i,
                        void* stream) {
  if (rows == 0) return 0;
  const bool rank = sort_lane > 0;
  const TopkKernel kernel =
      rank ? pick<true>(sort_lane) : pick<false>(threads > 0 ? n / threads : 0);
  int cbp = 1;
  while (cbp < cb) cbp <<= 1;
  if (kernel == nullptr || n > 4096 || (n & (n - 1)) != 0 ||
      threads < 32 || threads > 1024 || (threads & (threads - 1)) != 0 ||
      k < 1 || k > ca + cb || ca + cb > n ||
      (!rank && threads * (n / threads) != n) ||
      (rank && (ca < 1 || cb < 1 || cbp > threads * sort_lane ||
                fallback == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  int kp = 1;
  while (kp < k) kp <<= 1;
  size_t smem = static_cast<size_t>(n) * (sizeof(float) + sizeof(int));
  if (rank) {
    // a, b, then the output row or the sort's exchanges, whichever is longer
    const int tail = k > threads * sort_lane ? k : threads * sort_lane;
    const size_t pairs = static_cast<size_t>(ca) + cb + tail;
    if (pairs * sizeof(float2) > smem) smem = pairs * sizeof(float2);
  }
  kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      va, ia, ca, vb, ib, cb, n, kp, k, fallback, out_v, out_i);
  return static_cast<int>(cudaGetLastError());
}

const char* topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
