// Brute-force RankSVM frequency counts on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_pairwise_kernel` of
// src/repro/kernels/pairwise_rank/kernel.py:30 (launched there by
// `pairwise_counts_kernel`). For every query i it computes the paper's
// frequency vectors (eqs. 5 and 6) by comparing every pair:
//
//   c_i = #{j : y_j > y_i  and  p_j < p_i + 1}
//   d_i = #{j : y_j < y_i  and  p_j > p_i - 1}
//
// The comparisons are the reference's, in float32: p_i + 1 and p_i - 1
// are rounded once to float32 and compared strictly, and y is compared
// as float32 (the wrapper casts both), so ties break bit for bit as in
// the O(m^2) reference.
//
// Design. A block owns a tile of kTile = 128 queries, four a thread in
// registers, and one of S splits of the candidates. Its 8 warps share
// the same queries and take turns over the split's candidates, staged
// through shared memory as (p, y) float2: each candidate read (one
// broadcast load) serves four queries. The grid is (query tiles) x S,
// S = ceil(2 x SMs / query tiles) capped at 8, so that m = 4096 (32
// tiles) runs 256 blocks on the 132 SMs instead of 16; the TPU's
// sequential candidate axis, along which the Pallas kernel accumulated
// into its output block, becomes the split plus the loop inside it.
// The ragged ends of both axes are bound-checked instead of padded (the
// reference pads with +inf, which satisfies neither count).
//
// The partial counts are summed without atomics: the warps' partials
// through shared memory, then the S blocks of a query tile, which form
// one thread-block cluster (1, S, 1), through distributed shared memory:
// after a cluster barrier block s sums its slice of the tile's queries
// over the S blocks' partials and writes c and d. Kept over integer
// atomicAdd into zeroed outputs because it is one launch (no memset),
// writes each output once, and is deterministic; the sums are integers,
// so any order gives the same bits anyway.
//
// Bound on the H100: 4 comparisons per (i, j) pair, m^2 pairs, against
// 16 m bytes of input and output, so the kernel is bound by operations:
// 1.0 microsecond at m = 4096 at the float32 peak of 67 TFLOP/s, under a
// launch's own cost. What the design does about the idle SMs of the
// one-thread-per-query version (16 blocks at m = 4096) is the split.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kQ = 4;               // queries a thread holds
constexpr int kTile = 32 * kQ;      // queries a block holds
constexpr int kChunk = 2048;        // candidates staged at a time
constexpr int kMaxSplit = 8;        // portable cluster size
static_assert(kThreads == 2 * kTile, "one thread per (count, query) sum");

__global__ void __launch_bounds__(kThreads)
    pairwise_counts_kernel(const float* __restrict__ p,
                           const float* __restrict__ y, int m, int split,
                           int* __restrict__ c, int* __restrict__ d) {
  __shared__ float2 cand[kChunk];
  __shared__ int warp_part[2][kWarps][kTile];
  __shared__ int part[2][kTile];
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kTile;

  float hi[kQ], lo[kQ], yi[kQ];
  int cc[kQ], dd[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int i = q0 + lane + 32 * q;
    const float pi = i < m ? p[i] : 0.0f;
    hi[q] = pi + 1.0f;  // p_j < p_i + 1  (c margin)
    lo[q] = pi - 1.0f;  // p_j > p_i - 1  (d margin)
    yi[q] = i < m ? y[i] : 0.0f;
    cc[q] = 0;
    dd[q] = 0;
  }

  const int j0 = blockIdx.y * split;
  const int j1 = min(m, j0 + split);
  for (int c0 = j0; c0 < j1; c0 += kChunk) {
    const int n = min(kChunk, j1 - c0);
    for (int k = threadIdx.x; k < n; k += kThreads)
      cand[k] = make_float2(p[c0 + k], y[c0 + k]);
    __syncthreads();
#pragma unroll 4
    for (int k = warp; k < n; k += kWarps) {
      const float2 v = cand[k];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        cc[q] += (v.y > yi[q]) & (v.x < hi[q]);
        dd[q] += (v.y < yi[q]) & (v.x > lo[q]);
      }
    }
    __syncthreads();
  }

  // The block's partial: the sum over its warps.
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    warp_part[0][warp][lane + 32 * q] = cc[q];
    warp_part[1][warp][lane + 32 * q] = dd[q];
  }
  __syncthreads();
  {
    const int which = threadIdx.x / kTile;
    const int qq = threadIdx.x % kTile;
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_part[which][w][qq];
    part[which][qq] = s;
  }
  cluster.sync();  // every block's partial is in its shared memory

  // Block `rank` sums its slice of the tile's queries over the cluster.
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int per = (kTile + splits - 1) / splits;
  for (int t = threadIdx.x; t < 2 * per; t += kThreads) {
    const int which = t / per;
    const int qq = rank * per + t % per;
    if (qq < kTile && q0 + qq < m) {
      int s = 0;
      for (int b = 0; b < splits; ++b)
        s += *cluster.map_shared_rank(&part[which][qq], b);
      (which ? d : c)[q0 + qq] = s;
    }
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// Candidate splits for m: enough blocks for two a SM, at most kMaxSplit.
cudaError_t pick_splits(int m, int* splits) {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (m + kTile - 1) / kTile;
  *splits = max(1, min(kMaxSplit, (2 * sms + tiles - 1) / tiles));
  return err;
}

}  // namespace

extern "C" int pairwise_counts_launch(const float* p, const float* y, int m,
                                      int* c, int* d, cudaStream_t stream) {
  if (m <= 0) return 0;
  int splits = 1;
  cudaError_t err = pick_splits(m, &splits);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((m + kTile - 1) / kTile),
                     static_cast<unsigned>(splits));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = static_cast<unsigned>(splits);
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pairwise_counts_kernel, p, y, m,
                           (m + splits - 1) / splits, c, d);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry for m: out[0] candidate splits (the cluster size),
// out[1] queries a block holds, out[2] queries a thread holds.
extern "C" int pairwise_counts_geometry(int m, int* out) {
  out[1] = kTile;
  out[2] = kQ;
  return static_cast<int>(pick_splits(m, out));
}
