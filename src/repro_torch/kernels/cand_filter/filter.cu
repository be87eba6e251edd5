// Candidate filter for Hopper (sm_90a): drop the neighbours a search knows.
//
// Replaces no TPU kernel: the JAX package tests membership in jnp
// (repro/core/beam_search.py::_contains_rows, an (rows, C, H) broadcast
// compare and an any-reduce).  Its PyTorch transcription held two thirds of
// the card's busy time in the baton engine's step (an int32 == over
// (10,240, 256, 64 + 256) and a bool reduce, ~839 MB of temporaries a step),
// so this kernel does the same membership test in one pass: each row's C
// candidates against its two haystacks (the beam and the pool, or the beam
// and the visited list), a candidate found in either becoming NO_ID.  A
// NO_ID candidate stays NO_ID; every other id passes unchanged, so the
// output is bitwise the plain version's (kernels/cand_filter/ref.py).
//
// Bound: bytes.  A row's ids are read once and the filtered ids written
// once: at the engine's shape 10,240 x (256 + 64 + 256) x 4 B read and
// 10,240 x 256 x 4 B written, ~34.1 MB a step, ~10 us at 3.35 TB/s.  The
// 8.4e8 integer compares that an exact test without a hash takes run at
// the card's integer rate in a few tens of us, so the design keeps the
// compare loop tight and touches device memory once:
//  - a CTA takes `rows_per_cta` rows (ops.py::filter_plan: one row at
//    C = 256, several at the head search's C = 32); it stages both
//    haystacks of its rows into shared memory with 16-byte loads where the
//    rows allow them, padded with NO_ID (which only a NO_ID candidate
//    equals, and that one is NO_ID either way);
//  - each thread holds kPerThread consecutive candidates in registers and
//    sweeps its row's staged haystack with int4 shared-memory reads: every
//    lane of the row reads the same address, a broadcast with no bank
//    conflict; the compares and ORs are branch-free, with no early exit.
//    The sweep runs in chunks of kChunk int4 (the haystacks padded to a
//    whole chunk), so that a chunk's hits collect in predicates (one
//    compare-and-OR instruction each) and only a chunk's end folds them
//    into a register (flags carried in registers across every int4 take
//    three instructions a compare: ISETP, SEL, LOP3);
//  - rows that do not run (the engine's non-runnable slots and frozen
//    rows) arrive all NO_ID: a CTA whose rows hold no live candidate writes
//    them back and exits before staging (__syncthreads_or), so the work
//    follows the occupied slots without a host sync.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPerThread = 4;     // candidates a thread holds in registers
constexpr int kChunk = 8;         // int4 of the haystack swept a chunk
constexpr int kNoId = -1;         // core/state.py::NO_ID
constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 48 * 1024;   // a CTA's shared memory without opt-in

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Four ids of a haystack row from id e on, NO_ID past its end h.
__device__ __forceinline__ int4 load4(const int* row, int e, int h, bool vec) {
  if (vec) return *reinterpret_cast<const int4*>(row + e);
  int4 v;
  v.x = e < h ? row[e] : kNoId;
  v.y = e + 1 < h ? row[e + 1] : kNoId;
  v.z = e + 2 < h ? row[e + 2] : kNoId;
  v.w = e + 3 < h ? row[e + 3] : kNoId;
  return v;
}

// blockDim.x = rows_per_cta * tpr threads, tpr = ceil(c / kPerThread) a
// row; dynamic shared memory rows_per_cta * q int4, q = qa + qb rounded up
// to a whole chunk, qa = ceil(ha / 4), qb = ceil(hb / 4): row r's haystack
// a, then its b, then NO_ID.
__global__ void __launch_bounds__(kMaxThreads)
cand_filter_kernel(const int* __restrict__ cand, int c,
                   const int* __restrict__ hay_a, int ha,
                   const int* __restrict__ hay_b, int hb, int rows,
                   int rows_per_cta, int tpr, int* __restrict__ out) {
  extern __shared__ int4 hay[];
  const int qa = (ha + 3) >> 2;
  const int qab = qa + ((hb + 3) >> 2);
  const int q = (qab + kChunk - 1) / kChunk * kChunk;
  const int local = threadIdx.x / tpr;
  const int e0 = (threadIdx.x - local * tpr) * kPerThread;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const long long row = row0 + local;
  const bool row_ok = row < rows;
  const int* crow = cand + row * c;
  int* orow = out + row * c;
  const bool vec_c = (c % kPerThread) == 0 && aligned16(cand) &&
                     aligned16(out);

  int x[kPerThread];
  if (row_ok && vec_c) {
    const int4 v = *reinterpret_cast<const int4*>(crow + e0);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      x[j] = row_ok && e0 + j < c ? crow[e0 + j] : kNoId;
  }
  bool live = false;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) live |= x[j] != kNoId;

  if (__syncthreads_or(live)) {
    const bool vec_a = (ha & 3) == 0 && aligned16(hay_a);
    const bool vec_b = (hb & 3) == 0 && aligned16(hay_b);
    const int n_rows = static_cast<int>(
        rows - row0 < rows_per_cta ? rows - row0 : rows_per_cta);
    for (int i = threadIdx.x; i < n_rows * q; i += blockDim.x) {
      const int r = i / q;
      const int k = i - r * q;
      const long long g = row0 + r;
      hay[i] = k < qa    ? load4(hay_a + g * ha, 4 * k, ha, vec_a)
               : k < qab ? load4(hay_b + g * hb, 4 * (k - qa), hb, vec_b)
                         : make_int4(kNoId, kNoId, kNoId, kNoId);
    }
    __syncthreads();
    if (row_ok) {
      const int4* h = hay + local * q;
      unsigned found = 0;                  // bit j: candidate j was seen
      for (int k = 0; k < q; k += kChunk) {
        bool hit[kPerThread];
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) hit[j] = false;
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const int4 v = h[k + u];
#pragma unroll
          for (int j = 0; j < kPerThread; ++j)
            hit[j] = hit[j] | (x[j] == v.x) | (x[j] == v.y) | (x[j] == v.z) |
                     (x[j] == v.w);
        }
#pragma unroll
        for (int j = 0; j < kPerThread; ++j)
          found |= static_cast<unsigned>(hit[j]) << j;
      }
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        x[j] = (found >> j) & 1 ? kNoId : x[j];
    }
  }
  if (!row_ok) return;
  if (vec_c) {
    *reinterpret_cast<int4*>(orow + e0) = make_int4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if (e0 + j < c) orow[e0 + j] = x[j];
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// cand/out (rows, c), hay_a (rows, ha), hay_b (rows, hb), all int32 and
// contiguous; a haystack of width 0 may be null.  rows_per_cta (from
// ops.py::filter_plan) rows a CTA of rows_per_cta * ceil(c / 4) <= 1024
// threads, whose haystacks take rows_per_cta * 16 * (ceil(ha / 4) +
// ceil(hb / 4), rounded up to a multiple of 8) <= 48 KB of shared memory.
// Anything else returns cudaErrorInvalidValue without launching.
int cand_filter_launch(const int* cand, int c, const int* hay_a, int ha,
                       const int* hay_b, int hb, int rows, int rows_per_cta,
                       int* out, void* stream) {
  if (rows == 0 || c == 0) return 0;
  const int tpr = (c + kPerThread - 1) / kPerThread;
  const long long threads = static_cast<long long>(tpr) * rows_per_cta;
  const long long smem = 16LL * rows_per_cta *
      (((ha + 3) / 4 + (hb + 3) / 4 + kChunk - 1) / kChunk * kChunk);
  if (rows < 0 || c < 0 || ha < 0 || hb < 0 || rows_per_cta < 1 ||
      threads > kMaxThreads || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (rows + rows_per_cta - 1) / rows_per_cta;
  cand_filter_kernel<<<grid, static_cast<int>(threads),
                       static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      cand, c, hay_a, ha, hay_b, hb, rows, rows_per_cta, tpr, out);
  return static_cast<int>(cudaGetLastError());
}

const char* cand_filter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
