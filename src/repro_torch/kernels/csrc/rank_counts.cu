// Fused sub-quadratic RankSVM frequency counts on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rank_counts_kernel` of
// src/repro/kernels/rank_counts/kernel.py (launched there by
// `rank_counts_kernel`). Both of the paper's frequency vectors come out
// of one pass over the scores sorted once:
//
//   c_i = #{j : y_j > y_i  and  p_j < p_i + 1}
//   d_i = #{j : y_j < y_i  and  p_j > p_i - 1}
//
// Inputs, prepared by the wrapper (kernels/rank_counts/ops.py), all in
// ascending-score order:
//   ps    (m,)  float32  sorted scores
//   yr    (m,)  int32    compact ranks of y (order-isomorphic to y)
//   band  (nI, 4) int32  per query tile [c_lo, c_hi, d_lo, d_hi] in
//                        candidate tiles of `tj` elements
//   gt, lt (nJ + 1, levels) int32: gt[t][r] counts the candidates of
//                        tiles [0, t) whose rank is > r, lt[t][r] those
//                        whose rank is < r (suffix and prefix sums over
//                        levels of the per-tile rank histogram).
//
// Exactness. Because the data is sorted by p, the c margin of query i is
// the prefix [0, L_i) with L_i = #{k : p_k < p_i + 1}, and the d margin
// the suffix [R_i, m) with R_i = #{k : p_k <= p_i - 1}. Float rounding
// is monotone (a <= b implies fl(a + 1) <= fl(b + 1)), so the L_i of a
// query tile lie between those of its first and last query, which the
// wrapper finds with searchsorted against the same rounded float32
// thresholds. Candidate tiles below c_lo lie inside every c margin of
// the tile and are counted from the histogram (one read of gt at row
// c_lo); tiles from c_hi on lie outside every one. Likewise tiles from
// d_hi on lie inside every d margin (lt[nJ] - lt[d_hi]) and tiles below
// d_lo outside. Only the partial bands [c_lo, c_hi) and [d_lo, d_hi) are
// compared densely, with the reference's float32 predicates, so the
// counts equal the O(m^2) reference bit for bit. The argument is the one
// of the TPU kernel's docstring.
//
// Design. One thread per sorted query, one block per query tile of
// blockDim.x queries. The block reads its own four band ints (the TPU
// kernel had them prefetched as scalars). The histogram term is one
// lookup each for c and d: the wrapper's sums over levels turn the TPU
// kernel's 256-wide masked reduction into a single read. The partial
// bands are staged through shared memory one candidate tile at a time.
// The sorted arrays and the tables stay in device memory and L2: at
// m = 2^20 they are 8 MB plus two (4097, 256) int32 tables of 4 MB, far
// more than a block's shared memory (the TPU kept them whole in VMEM).
//
// Bound on the H100: each input byte read once and each output written
// once is 16 m bytes plus the tables (about 25 MB at m = 2^20, 7.5
// microseconds at 3.35 TB/s); the band work is 2 comparisons per
// (query, band candidate) pair and depends on how the scores spread.
// Which of the two bounds the kernel is measured by chip_smoke.py.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

__global__ void rank_counts_kernel(const int* __restrict__ band,
                                   const float* __restrict__ ps,
                                   const int* __restrict__ yr,
                                   const int* __restrict__ gt,
                                   const int* __restrict__ lt, int m, int tj,
                                   int n_tiles_j, int levels,
                                   int* __restrict__ c, int* __restrict__ d) {
  extern __shared__ unsigned char smem[];
  float* sp = reinterpret_cast<float*>(smem);
  int* sy = reinterpret_cast<int*>(smem + static_cast<size_t>(tj) * 4);

  const int tile = blockIdx.x;
  const int i = tile * blockDim.x + threadIdx.x;
  const bool live = i < m;
  const int c_lo = band[4 * tile + 0];
  const int c_hi = band[4 * tile + 1];
  const int d_lo = band[4 * tile + 2];
  const int d_hi = band[4 * tile + 3];

  const float pi = live ? ps[i] : 0.0f;
  const int ri = live ? yr[i] : 0;
  const float hi = pi + 1.0f;  // p_j < p_i + 1  (c margin)
  const float lo = pi - 1.0f;  // p_j > p_i - 1  (d margin)

  // Whole tiles, from the histogram tables.
  int cc = live ? gt[static_cast<size_t>(c_lo) * levels + ri] : 0;
  int dd = live ? lt[static_cast<size_t>(n_tiles_j) * levels + ri] -
                      lt[static_cast<size_t>(d_hi) * levels + ri]
                : 0;

  // Partial c band, compared densely.
  for (int t = c_lo; t < c_hi; ++t) {
    const int j0 = t * tj;
    const int n = min(tj, m - j0);
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      sp[k] = ps[j0 + k];
      sy[k] = yr[j0 + k];
    }
    __syncthreads();
    if (live) {
      for (int k = 0; k < n; ++k) cc += (sy[k] > ri) & (sp[k] < hi);
    }
    __syncthreads();
  }
  // Partial d band, compared densely.
  for (int t = d_lo; t < d_hi; ++t) {
    const int j0 = t * tj;
    const int n = min(tj, m - j0);
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      sp[k] = ps[j0 + k];
      sy[k] = yr[j0 + k];
    }
    __syncthreads();
    if (live) {
      for (int k = 0; k < n; ++k) dd += (sy[k] < ri) & (sp[k] > lo);
    }
    __syncthreads();
  }
  if (live) {
    c[i] = cc;
    d[i] = dd;
  }
}

}  // namespace

extern "C" int rank_counts_launch(const int* band, const float* ps,
                                  const int* yr, const int* gt, const int* lt,
                                  int m, int ti, int tj, int levels, int* c,
                                  int* d, cudaStream_t stream) {
  if (m <= 0) return 0;
  const int n_tiles_i = (m + ti - 1) / ti;
  const int n_tiles_j = (m + tj - 1) / tj;
  const size_t smem = static_cast<size_t>(tj) * 8;
  rank_counts_kernel<<<n_tiles_i, ti, smem, stream>>>(
      band, ps, yr, gt, lt, m, tj, n_tiles_j, levels, c, d);
  return static_cast<int>(cudaGetLastError());
}
