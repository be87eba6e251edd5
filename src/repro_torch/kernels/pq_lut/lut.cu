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
// Bound: bytes.  The output (Q * M * K * 4 bytes, 25 MB at Q = 1024,
// M = 24, K = 256) dominates; the inputs are read once.
//
// Design: one CTA per (tile of tile_q queries, subspace m, tile of tile_c
// centroids), the tiles chosen from the shape by ops.py::lut_plan so that
// small calls still put a CTA on every SM and large ones take long query
// tiles.  A thread owns one centroid c: at dsub = 4 it holds the centroid in
// registers (any other dsub: in shared memory, transposed so that a warp's
// 32 centroids lie in 32 banks) and computes its norm once.  The CTA stages
// its queries' slices and their norms in shared memory (one barrier), then
// each thread runs over the tile's queries, reading each slice as a
// broadcast, and a warp stores 32 consecutive entries of one (q, m) row.
// Every dot product runs over dsub in order, each product and sum rounded
// on its own (__fmul_rn, __fadd_rn: nothing contracts into an FMA), and the
// entry is (|q|^2 - 2 * cross) + |c|^2 in that order: the plain version
// (ref.py::pq_lut_ref) computes in the same order, so the two are bitwise
// equal, and each entry is independent of how the call is tiled and of how
// many queries share it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;         // a block's share on Hopper

// Shared memory of a CTA; ops.py::lut_smem repeats this formula.  The
// query slices and norms always; the centroids only on the generic route.
__host__ __device__ inline size_t lut_smem(int tile_q, int tile_c, int dsub,
                                           bool generic) {
  return (static_cast<size_t>(tile_q) * (dsub + 1) +
          (generic ? static_cast<size_t>(tile_c) * dsub : 0)) *
         sizeof(float);
}

// x . y over n in order, each product and sum rounded on its own; x and y
// step by sx and sy floats.
__device__ __forceinline__ float dot_in_order(const float* x, int sx,
                                              const float* y, int sy, int n) {
  float acc = __fmul_rn(x[0], y[0]);
  for (int j = 1; j < n; ++j)
    acc = __fadd_rn(acc, __fmul_rn(x[j * sx], y[j * sy]));
  return acc;
}

// kRegisters (dsub == 4): the centroid in registers, the query slices read
// as float4 broadcasts; otherwise any dsub, the CTA's centroids in shared
// memory as (dsub, tile_c).
template <bool kRegisters>
__global__ void pq_lut_kernel(const float* __restrict__ queries,
                              const float* __restrict__ cent,
                              float* __restrict__ out, int Q, int M, int K,
                              int dsub, int tile_q) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                       // (tile_q, dsub)
  float* q2_s = q_s + tile_q * dsub;       // (tile_q,)
  float* cent_s = q2_s + tile_q;           // (dsub, tile_c), generic only
  const int tile_c = blockDim.x;
  const int m = blockIdx.y;
  const int q0 = blockIdx.x * tile_q;
  const int nq = min(tile_q, Q - q0);
  const int c = blockIdx.z * tile_c + threadIdx.x;
  const bool live = c < K;
  const int d = M * dsub;

  // the tile's query slices and their norms: a thread a query
  for (int q = threadIdx.x; q < nq; q += tile_c) {
    const float* src = queries + static_cast<size_t>(q0 + q) * d + m * dsub;
    for (int j = 0; j < dsub; ++j) q_s[q * dsub + j] = src[j];
    q2_s[q] = dot_in_order(src, 1, src, 1, dsub);
  }
  // this thread's centroid and its norm
  const float* cent_c = cent + (static_cast<size_t>(m) * K + (live ? c : 0)) * dsub;
  float4 cv;
  if constexpr (kRegisters) {
    cv = make_float4(cent_c[0], cent_c[1], cent_c[2], cent_c[3]);
  } else {
    for (int j = 0; j < dsub; ++j) cent_s[j * tile_c + threadIdx.x] = cent_c[j];
  }
  const float c2 = dot_in_order(cent_c, 1, cent_c, 1, dsub);
  __syncthreads();
  if (!live) return;

  float* out_c = out + (static_cast<size_t>(q0) * M + m) * K + c;
  const size_t row = static_cast<size_t>(M) * K;
  for (int q = 0; q < nq; ++q) {
    float cross;
    if constexpr (kRegisters) {
      const float4 x = reinterpret_cast<const float4*>(q_s)[q];  // a broadcast
      cross = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x.x, cv.x),
                                            __fmul_rn(x.y, cv.y)),
                                  __fmul_rn(x.z, cv.z)),
                        __fmul_rn(x.w, cv.w));
    } else {
      cross = dot_in_order(q_s + q * dsub, 1, cent_s + threadIdx.x, tile_c, dsub);
    }
    out_c[q * row] =
        __fadd_rn(__fsub_rn(q2_s[q], __fmul_rn(2.0f, cross)), c2);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// queries (Q, M * dsub) float32, centroids (M, K, dsub) float32,
// out (Q, M, K) float32, all contiguous (checked by the wrapper).  The
// tiles (tile_q queries, tile_c centroids a CTA, tile_c threads) come from
// ops.py::lut_plan; dsub == 4 takes the registers route, any other dsub the
// generic one.  A tiling the kernel does not take (tile_c not a multiple of
// 32 or above 1024, tile_q < 1), or whose shared memory or grid exceeds the
// card's limits, returns cudaErrorInvalidValue without launching.
int pq_lut_launch(const float* queries, const float* cent, float* out, int Q,
                  int M, int K, int dsub, int tile_q, int tile_c,
                  void* stream) {
  if (Q == 0 || M == 0 || K == 0) return 0;
  const bool generic = dsub != 4;
  const size_t smem = lut_smem(tile_q, tile_c, dsub, generic);
  const long long gx = (static_cast<long long>(Q) + tile_q - 1) / tile_q;
  const int gz = (K + tile_c - 1) / tile_c;
  if (tile_q < 1 || tile_c < 32 || tile_c > 1024 || tile_c % 32 != 0 ||
      dsub < 1 || smem > kMaxSmem || gx > 0x7fffffffLL || M > 65535 ||
      gz > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = generic ? pq_lut_kernel<false> : pq_lut_kernel<true>;
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(static_cast<unsigned>(gx), M, gz);
  kernel<<<grid, tile_c, smem, static_cast<cudaStream_t>(stream)>>>(
      queries, cent, out, Q, M, K, dsub, tile_q);
  return static_cast<int>(cudaGetLastError());
}

const char* pq_lut_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
