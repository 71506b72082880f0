// Fused sub-quadratic RankSVM frequency counts on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rank_counts_kernel` of
// src/repro/kernels/rank_counts/kernel.py:59 (launched there by
// `rank_counts_kernel`, prepared by ops.py's `_kernel_counts`). Both of
// the paper's frequency vectors come out of one pass over the scores
// sorted once:
//
//   c_i = #{j : y_j > y_i  and  p_j < fl32(p_i + 1)}
//   d_i = #{j : y_j < y_i  and  p_j > fl32(p_i - 1)}
//
// Inputs: ps (m,) float32 and order (m,) int64, the stable sort of the
// scores (torch.sort: the reference sorts in XLA outside its kernel),
// and ranks (m,) int32, the compact ranks of y in example order
// (order-isomorphic to y, 0 .. n_ranks - 1). Output cd (m, 2) int32 in
// example order, c and d its columns. The wrapper
// (kernels/rank_counts/ops.py) allocates every output and the scratch
// below; one call of `rank_counts_launch` runs three kernels on the
// caller's stream:
//
// 1. gather  (one warp per candidate tile of tj = 32 s sorted positions)
//            yr[k] = ranks[order[k]]; the bit planes of the ranks,
//            planes[w][b] bit l = bit b of yr[32 w + l]; and row t + 1 of
//            the table: the tile's count of ranks <= r, for each r (a
//            warp histogram in shared memory, then a scan over ranks);
//            and, spread over its warps, the frontiers of the count
//            blocks' boundary queries (edges), which bound each block's.
// 2. scan    (a cluster of up to 8 blocks per rank; the table is
//            column-major, one contiguous column of nT + 1 rows per rank)
//            the rows become prefixes over tiles: table[r][t] =
//            #{k < t tj : yr_k <= r}, row 0 is 0.
// 3. count   (one thread per sorted query, blocks of ti) the two
//            frontiers and the counts, written straight to example order
//            through order, (c, d) as one int2 of the (m, 2) output.
//
// Exactness. In sorted order the c margin of query i is the prefix
// [0, L_i), L_i = #{k : ps_k < fl32(ps_i + 1)}, and the d margin the
// suffix [R_i, m), R_i = #{k : ps_k <= fl32(ps_i - 1)}: each frontier is
// the count of the reference's own float32 predicate over the sorted
// scores (the predicate holds on a prefix; for d its complement does),
// found by binary search with the threshold rounded once, as in the
// reference. Then no float compare is left:
//   c_i = (whole tiles below L_i with rank > r_i: t tj - table[r_i][t],
//          t = L_i / tj) + (positions [t tj, L_i) with rank > r_i)
//   d_i = (all with rank < r_i: table[r_i - 1][nT])
//         - (the same count below R_i, by the same split)
// The table counts whole tiles exactly; the partial tile is at most s
// words of 32 positions, each answered by a bit-sliced compare of r_i
// against the word's `bits` rank planes and one __popc. Integer sums
// throughout, so the counts equal the O(m^2) reference bit for bit.
//
// What the design does about the TPU kernel's dense bands. The first
// port kept the TPU design: per query tile of 256, dense compares over
// every candidate tile between its first and last query's frontier,
// 2.14e9 compares at m = 2^20 (about 2000 a query), and tables sized to
// the level capacity (2 x 4097 x 256 int32, 8.4 MB), prepared by some
// 40 eager launches. Here each query pays two binary searches inside its
// block's band (the gather kernel searches the blocks' boundary queries
// over the whole array, spread over its warps, so no count block waits
// on a search of its own), four table reads and at most 2 s plane words
// (s = 1 up to 64 ranks); the tables follow the alphabet (at m = 2^20
// with five grades 0.66 MB of table and 0.39 MB of planes); and the call
// after the sort is these three launches. Measured on the H100 (PERF.md):
// staging the band in shared memory, or four queries a thread, did not
// shorten the count kernel; storing c and d as one int2 did.
//
// Bound on the H100: the function reads p and ranks once and writes c
// and d once, 16 m bytes (16.8 MB at m = 2^20, 5.0 microseconds at
// 3.35 TB/s); it does O(m log m) compares in the searches, far under
// the operation bound. Its time against that bound is measured by
// chip_smoke.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kGatherWarps = 4;   // candidate tiles per gather block
constexpr int kScanThreads = 1024;
constexpr int kScanPer = 8;       // rows a scan thread holds per round
constexpr int kScanRows = kScanThreads * kScanPer;
constexpr int kMaxScanSplit = 8;  // blocks of a column's scan (cluster)
constexpr unsigned kFull = 0xffffffffu;

// First k in [0, n) with !(a[k] < x), or with !(a[k] <= x) when kLe,
// else n (a sorted).
template <bool kLe>
__device__ __forceinline__ int search(const float* __restrict__ a, int n,
                                      float x) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    const float v = a[lo + half];
    if (kLe ? v <= x : v < x) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kGatherWarps * 32)
    rc_gather_kernel(const float* __restrict__ ps,
                     const int* __restrict__ ranks,
                     const long long* __restrict__ order, int m, int n_ranks,
                     int bits, int words_per_tile, int n_tiles, int ti,
                     int n_blocks, int* __restrict__ yr,
                     unsigned* __restrict__ planes, int* __restrict__ table,
                     int* __restrict__ edges) {
  extern __shared__ int hist_all[];
  // The frontiers of the count blocks' boundary queries, q_b = b ti for
  // b < nB and q_nB = m - 1, spread over the grid's warps (a lane or two
  // of some) so that their searches overlap the gather: edges[b] =
  // (L(q_b), R(q_b)). Rounding is monotone, so block b's frontiers lie
  // between those of q_b and q_{b+1}.
  {
    const long long warps = static_cast<long long>(gridDim.x) * kGatherWarps;
    const long long gw = static_cast<long long>(blockIdx.x) * kGatherWarps +
                         (threadIdx.x >> 5);
    const int tasks = 2 * (n_blocks + 1);
    const int end = static_cast<int>((gw + 1) * tasks / warps);
    for (int task = static_cast<int>(gw * tasks / warps) + (threadIdx.x & 31);
         task < end; task += 32) {
      const int b = task >> 1;
      const float x = ps[b < n_blocks ? b * ti : m - 1];
      edges[task] = (task & 1) ? search<true>(ps, m, x - 1.0f)
                               : search<false>(ps, m, x + 1.0f);
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x * kGatherWarps + warp;
  if (tile >= n_tiles) return;  // whole warps; no block barrier below
  int* hist = hist_all + static_cast<size_t>(warp) * n_ranks;
  for (int r = lane; r < n_ranks; r += 32) hist[r] = 0;
  __syncwarp();
  for (int wi = 0; wi < words_per_tile; ++wi) {
    const int w = tile * words_per_tile + wi;
    if (w * 32 >= m) break;  // the last tile's empty words have no planes
    const int k = w * 32 + lane;
    const bool valid = k < m;
    int r = 0;
    if (valid) {
      r = ranks[order[k]];
      yr[k] = r;
    }
    for (int b = 0; b < bits; ++b) {
      const unsigned plane = __ballot_sync(kFull, (r >> b) & 1);
      if (lane == b) planes[static_cast<size_t>(w) * bits + b] = plane;
    }
    const unsigned same = __match_any_sync(kFull, valid ? r : -1);
    if (valid && lane == __ffs(same) - 1) hist[r] += __popc(same);
    __syncwarp();
  }
  // Row tile + 1 of each rank column: the tile's count of ranks <= r.
  const size_t rows = static_cast<size_t>(n_tiles) + 1;
  int carry = 0;
  for (int r0 = 0; r0 < n_ranks; r0 += 32) {
    const int r = r0 + lane;
    int v = r < n_ranks ? hist[r] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, v, off);
      if (lane >= off) v += t;
    }
    v += carry;
    if (r < n_ranks) table[r * rows + tile + 1] = v;
    carry = __shfl_sync(kFull, v, 31);
  }
}

// Shared-memory slot of row k of a scan round: one word of padding per
// 32, so a thread's kScanPer consecutive rows fall in distinct banks.
__device__ __forceinline__ int scan_slot(int k) { return k + (k >> 5); }

// Inclusive prefix over rows 1 .. n_tiles of one column (each column
// contiguous); row 0 becomes 0. A column is a cluster of S blocks, each
// scanning a contiguous part of its rows: the parts' sums are exchanged
// through distributed shared memory, then each part scans from its
// offset. Rounds of kScanRows rows go through shared memory, so that
// loads and stores are coalesced while each thread scans kScanPer
// consecutive rows.
__global__ void __launch_bounds__(kScanThreads)
    rc_scan_kernel(int* __restrict__ table, int n_tiles) {
  __shared__ int buf[kScanRows + kScanRows / 32];
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int part_sum;
  cg::cluster_group cluster = cg::this_cluster();
  const int parts = static_cast<int>(cluster.num_blocks());
  const int part = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* column =
      table + static_cast<size_t>(blockIdx.x / parts) * (n_tiles + 1);
  const int per_part = (n_tiles + parts - 1) / parts;
  const int lo = 1 + part * per_part;                 // rows [lo, hi)
  const int hi = min(n_tiles + 1, lo + per_part);

  // This part's sum, for the parts above it.
  int sum = 0;
  for (int row = lo + threadIdx.x; row < hi; row += kScanThreads)
    sum += column[row];
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(kFull, sum, off);
  if (lane == 0) warp_sums[warp] = sum;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sums[lane];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(kFull, s, off);
    if (lane == 0) part_sum = s;
  }
  cluster.sync();  // every part's sum is in its shared memory
  int carry = 0;
  for (int b = 0; b < part; ++b)
    carry += *cluster.map_shared_rank(&part_sum, b);
  cluster.sync();  // no block leaves or rewrites while another reads

  for (int base = lo; base < hi; base += kScanRows) {
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      const int row = k * kScanThreads + threadIdx.x;
      buf[scan_slot(row)] = base + row < hi ? column[base + row] : 0;
    }
    __syncthreads();
    int v[kScanPer];
    int tsum = 0;
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      v[k] = buf[scan_slot(threadIdx.x * kScanPer + k)];
      tsum += v[k];
    }
    int incl = tsum;  // inclusive scan of the threads' sums
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int s = warp_sums[lane];
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kFull, s, off);
        if (lane >= off) s += t;
      }
      warp_sums[lane] = s;
    }
    __syncthreads();
    int run = carry + incl - tsum + (warp ? warp_sums[warp - 1] : 0);
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      run += v[k];
      buf[scan_slot(threadIdx.x * kScanPer + k)] = run;
    }
    carry += warp_sums[31];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      const int row = k * kScanThreads + threadIdx.x;
      if (base + row < hi) column[base + row] = buf[scan_slot(row)];
    }
    __syncthreads();  // buf and warp_sums are written again next round
  }
  if (part == 0 && threadIdx.x == 0) column[0] = 0;
}

// Bits of one word whose rank is > r (greater) or < r, from its planes
// (most significant first): a bit-sliced compare.
__device__ __forceinline__ unsigned rank_mask(const unsigned* __restrict__ pl,
                                              int bits, int r, bool greater) {
  unsigned out = 0u;
  unsigned eq = kFull;
  for (int b = bits - 1; b >= 0; --b) {
    const unsigned plane = pl[b];
    const unsigned rb = ((r >> b) & 1) ? kFull : 0u;
    out |= eq & (greater ? (plane & ~rb) : (~plane & rb));
    eq &= ~(plane ^ rb);
  }
  return out;
}

// Positions in [32 w0, end) whose rank is > r (greater) or < r.
__device__ __forceinline__ int count_words(const unsigned* __restrict__ planes,
                                           int bits, int w0, int end, int r,
                                           bool greater) {
  int n = 0;
  const int w_end = end >> 5;
  for (int w = w0; w < w_end; ++w)
    n += __popc(rank_mask(planes + static_cast<size_t>(w) * bits, bits, r,
                          greater));
  if (end & 31)
    n += __popc(rank_mask(planes + static_cast<size_t>(w_end) * bits, bits, r,
                          greater) &
                ((1u << (end & 31)) - 1u));
  return n;
}

// One sorted query a thread; the gather kernel found the block's band.
// c and d of a query are written together, (c, d) as one int2 at its
// example index: half the scattered stores of two separate arrays.
__global__ void __launch_bounds__(1024)
    rc_count_kernel(const float* __restrict__ ps, const int* __restrict__ yr,
                    const unsigned* __restrict__ planes,
                    const int* __restrict__ table,
                    const long long* __restrict__ order,
                    const int* __restrict__ edges, int m, int bits, int tj,
                    int n_tiles, int2* __restrict__ cd) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const float pi = ps[i];
  const int ri = yr[i];
  // The block's frontiers lie between those of its boundary queries.
  const int la = edges[2 * blockIdx.x];
  const int ra = edges[2 * blockIdx.x + 1];
  const int L = la + search<false>(ps + la, edges[2 * blockIdx.x + 2] - la,
                                   pi + 1.0f);
  const int R = ra + search<true>(ps + ra, edges[2 * blockIdx.x + 3] - ra,
                                  pi - 1.0f);
  const int words = tj >> 5;
  const size_t rows = static_cast<size_t>(n_tiles) + 1;

  const int tl = L / tj;
  int cc = tl * tj - table[ri * rows + tl];
  cc += count_words(planes, bits, tl * words, L, ri, true);
  int dd = 0;
  if (ri > 0) {
    const int tr = R / tj;
    const int* lower = table + (ri - 1) * rows;  // ranks <= r_i - 1
    dd = lower[n_tiles] - lower[tr] -
         count_words(planes, bits, tr * words, R, ri, false);
  }
  cd[order[i]] = make_int2(cc, dd);  // one 8-byte store in example order
}

// Planes per 32 positions: enough bits for ranks 0 .. n_ranks - 1 (the
// wrapper's `ref.rank_bits`, which sizes the planes).
int rank_counts_bits(int n_ranks) {
  int bits = 1;
  while (bits < 31 && (1 << bits) < n_ranks) ++bits;
  return bits;
}

}  // namespace

extern "C" int rank_counts_launch(const float* ps, const long long* order,
                                  const int* ranks, int m, int n_ranks,
                                  int ti, int tj, int* yr, unsigned* planes,
                                  int* table, int* edges, int* cd,
                                  cudaStream_t stream) {
  if (m <= 0) return 0;
  const int bits = rank_counts_bits(n_ranks);
  const int n_tiles = (m + tj - 1) / tj;
  const int n_blocks = (m + ti - 1) / ti;
  // the wrapper keeps n_ranks <= 3072: 48 KB of warp histograms
  const size_t hist_bytes =
      static_cast<size_t>(kGatherWarps) * n_ranks * sizeof(int);
  rc_gather_kernel<<<(n_tiles + kGatherWarps - 1) / kGatherWarps,
                     kGatherWarps * 32, hist_bytes, stream>>>(
      ps, ranks, order, m, n_ranks, bits, tj / 32, n_tiles, ti, n_blocks, yr,
      planes, table, edges);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // A column's scan: one block for each 4096 rows, at most kMaxScanSplit.
  const int parts = max(1, min(kMaxScanSplit, (n_tiles + 4095) / 4096));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_ranks) * parts);
  cfg.blockDim = dim3(kScanThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(parts);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rc_scan_kernel, table, n_tiles);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rc_count_kernel<<<n_blocks, ti, 0, stream>>>(
      ps, yr, planes, table, order, edges, m, bits, tj, n_tiles,
      reinterpret_cast<int2*>(cd));
  return static_cast<int>(cudaGetLastError());
}
