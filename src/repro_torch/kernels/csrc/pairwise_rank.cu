// Brute-force RankSVM frequency counts on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_pairwise_kernel` of
// src/repro/kernels/pairwise_rank/kernel.py (launched there by
// `pairwise_counts_kernel`). For every query i it computes the paper's
// frequency vectors (eqs. 5 and 6):
//
//   c_i = #{j : y_j > y_i  and  p_j < p_i + 1}
//   d_i = #{j : y_j < y_i  and  p_j > p_i - 1}
//
// Design. One thread per query i keeps both counts in int32 registers.
// The block walks ALL candidates j in tiles staged through shared
// memory; this loop takes the place of the TPU's sequential j grid axis,
// along which the Pallas kernel accumulated into its output block, so
// no block ever writes another block's outputs: no atomics and no race.
// The ragged end of the candidate range is bound-checked instead of
// padded. The reference pads p and y with +inf, which satisfies neither
// count, so skipping those slots gives the same result.
//
// The comparisons are the reference's, in float32: p_i + 1 and p_i - 1
// are rounded once to float32 and compared strictly, and y is compared
// as float32 (the wrapper casts both), so ties break bit for bit as in
// the O(m^2) reference.
//
// Bound on the H100: 4 comparisons per (i, j) pair, m^2 pairs, against
// 16 m bytes of input and output, so the kernel is bound by operations
// (about 1 microsecond at m = 4096 at the float32 peak of 67 TFLOP/s).
// At m <= 4096, the range the wrapper's tiering sends here, the grid is
// only m / 256 <= 16 blocks for the 132 SMs: the card is mostly idle and
// the launch costs more than the work. Splitting j across blocks (with a
// second reduction pass) would fill it; that is left to a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void pairwise_counts_kernel(const float* __restrict__ p,
                                       const float* __restrict__ y, int m,
                                       int* __restrict__ c,
                                       int* __restrict__ d) {
  __shared__ float sp[kTile];
  __shared__ float sy[kTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < m;
  const float pi = live ? p[i] : 0.0f;
  const float yi = live ? y[i] : 0.0f;
  const float hi = pi + 1.0f;  // p_j < p_i + 1  (c margin)
  const float lo = pi - 1.0f;  // p_j > p_i - 1  (d margin)
  int cc = 0;
  int dd = 0;
  for (int j0 = 0; j0 < m; j0 += kTile) {
    const int n = min(kTile, m - j0);
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      sp[k] = p[j0 + k];
      sy[k] = y[j0 + k];
    }
    __syncthreads();
    if (live) {
      for (int k = 0; k < n; ++k) {
        const float pj = sp[k];
        const float yj = sy[k];
        cc += (yj > yi) & (pj < hi);
        dd += (yj < yi) & (pj > lo);
      }
    }
    __syncthreads();
  }
  if (live) {
    c[i] = cc;
    d[i] = dd;
  }
}

}  // namespace

extern "C" int pairwise_counts_launch(const float* p, const float* y, int m,
                                      int* c, int* d, cudaStream_t stream) {
  if (m <= 0) return 0;
  const int blocks = (m + kThreads - 1) / kThreads;
  pairwise_counts_kernel<<<blocks, kThreads, 0, stream>>>(p, y, m, c, d);
  return static_cast<int>(cudaGetLastError());
}
