// Backward RWKV-6 WKV recurrence on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_wkv_bwd_kernel` of
// src/repro/kernels/wkv/kernel.py (launched there by `wkv_backward`). The
// forward, over N independent sequences of T steps with a K x K state
// S[k, v] per sequence, is
//
//   o_t[v] = sum_k r_t[k] * (S_{t-1}[k, v] + u[k] * k_t[k] * v_t[v])
//   S_t[k, v] = w_t[k] * S_{t-1}[k, v] + k_t[k] * v_t[v]
//
// and, walking t from T down to 1 with dS_T = dsT, its gradients are
//
//   dr_t[k] = sum_v S_{t-1}[k, v] do_t[v] + u[k] k_t[k] <v_t, do_t>
//   dk_t[k] = u[k] r_t[k] <v_t, do_t> + sum_v dS_t[k, v] v_t[v]
//   dv_t[v] = (sum_k u[k] r_t[k] k_t[k]) do_t[v] + sum_k dS_t[k, v] k_t[k]
//   dw_t[k] = sum_v dS_t[k, v] S_{t-1}[k, v]
//   du[k]  += k_t[k] <v_t, do_t> r_t[k]
//   dS_{t-1}[k, v] = w_t[k] dS_t[k, v] + r_t[k] do_t[v],   ds0 = dS_0.
//
// It writes dr, dk, dv in the dtype of r (bf16 rounded to nearest even,
// or f32) and dw, du, ds0 in f32, from the chunk-boundary states that the
// forward kernel wrote (the state before each chunk of `chunk` steps).
//
// Design. The rows of S and dS are independent, and only dv sums over
// them. So each sequence is a thread-block cluster of C blocks, block c
// owning K / C rows, and each row is split over R threads that own K / R
// columns of it (the 4-column quads g, g + R, ..., so that a warp's
// 16-byte shared-memory reads fall on distinct banks). The R threads of a
// row sit in one warp: dr, dk and dw are K / R-long partial sums met by a
// halving butterfly of __shfl_xor_sync (each level a lane keeps half of
// the sums it carries). dv is summed over the warp's rows by the same
// kind of butterfly (a thread holds its quads in an order that spares the
// first level its selects: see kSwap), over the block's warps through
// shared memory after each stage, and over the cluster's blocks once per
// chunk: each
// block stores its partials for the columns that block c owns into c's
// shared memory (distributed shared memory), and after a cluster barrier
// block c adds them in block order and writes its columns. No atomics:
// two launches give the same bits.
//
// The walk needs S_{t-1} in reverse order. Each chunk is cut into
// stages of kSub steps, and each stage into segments of kSeg. A first
// pass recomputes the chunk forward from its boundary, stage by stage, and
// keeps the state at each segment's start in a global scratch (each
// thread its own K / R values of one row); then, for each stage from the
// last, each segment (from the last) is recomputed from its checkpoint
// into registers (kSeg states) and walked back. The chunk's last stage
// is not checkpointed: its segments start from the state the first pass
// ends with. So a step is recomputed about 1.75 times (0.75 in the first
// pass, 7/8 in the walk, and the last stage's first segment once more),
// where the Pallas kernel, which kept a chunk's history in VMEM (1 MB per
// sequence at chunk = K = 64), recomputed it once.
//
// Each stage (k, v, w, and in the walk r and do) is copied with 16-byte
// cp.async into shared memory while the previous stage is worked on, and
// converted once to f32; <v_t, do_t> and sum_k u r k are summed there
// once per step and block, and the u terms of dr, dk and du join when the
// stage's outputs are written. A whole stage is walked without per-step
// guards, so that the compiler can overlap neighbouring steps.
//
// Geometry, chosen by timing variants on an H100 (PERF.md): K =
// 64 runs C = 4 (640 blocks of 128 threads at N = 160), R = 8, kSub =
// 16, kSeg = 8 and at most 168 registers (3 blocks per SM). Shorter
// stages cost more in barriers and staging than they save, checkpoints
// every 4 steps more in scratch traffic than in recompute, and a register
// cap for 4 blocks per SM spills; 2 blocks per SM leave too few warps.
//
// Each product and sum of the state and dS updates is rounded once, in
// the order of the plain version (`kernels/wkv/ref.py`), without fused
// multiply-adds, so the recomputed states, dS and ds0 equal it bit for
// bit; dr, dk, dv, dw and du differ only in the order of their K-term
// (and, for du, T-term) sums. Offsets into the (N, T, K), boundary and
// scratch arrays are size_t, so N * T * K may exceed 2^31.
//
// Bound on the H100, at the training shape N = 160, T = 4096, K = 64 with
// bf16 r/k/v/do/dr/dk/dv and f32 w/dw: 14 K^2 float operations per (n,
// t): 3 for one recompute of the state (decay, product, sum), 2 each for
// the products and sums of dr, dk, dv and dw, and 3 for the dS update
// (the u terms are O(K)); 3.8e10 in all (0.56 ms at the float32 peak of
// 67 TFLOP/s), against about 1.1 GB of inputs and outputs (0.33 ms at
// 3.35 TB/s): bound by operations. What holds it back is the instruction
// stream, not memory: about 12 K^2 float instructions per (n, t) (1.75
// recomputes of 3, the walk's four products and the dS update's 3; the
// updates cannot fuse without breaking bit-equality), and beside them
// the butterflies' shuffles and selects, the shared-memory reads and
// each stage's staging and sums. The next step is fewer instructions per
// element (a tensor-core chunked form; ROADMAP).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kSub = 16;       // time steps per stage (one staged copy)
constexpr int kSeg = 8;        // steps between checkpoints: a walk segment
constexpr int kSegs = kSub / kSeg;
constexpr int kMaxChunk = 64;  // longest chunk (the reference's rule)
constexpr int kMinBlocks = 3;  // blocks per SM the register cap leaves room for
static_assert(kSub % kSeg == 0, "segments cut the stage evenly");

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16 bytes of T at src as f32 into dst (16 / sizeof(T) values); both
// 16-byte aligned.
__device__ __forceinline__ void widen16(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void widen16(float* dst,
                                        const __nv_bfloat16* src) {
  const uint4 b = *reinterpret_cast<const uint4*>(src);
  const unsigned x[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int h = 0; h < 2; ++h)
    *reinterpret_cast<float4*>(dst + 4 * h) =
        make_float4(__uint_as_float(x[2 * h] << 16),
                    __uint_as_float(x[2 * h] & 0xffff0000u),
                    __uint_as_float(x[2 * h + 1] << 16),
                    __uint_as_float(x[2 * h + 1] & 0xffff0000u));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// C blocks per sequence (a cluster), R threads per row of S.
template <int K, int C, int R>
struct Geom {
  static constexpr int kRows = K / C;           // rows a block owns
  static constexpr int kThreads = kRows * R;
  static constexpr int kWarp = kThreads < 32 ? kThreads : 32;
  static constexpr int kWarps = kThreads / kWarp;
  static constexpr int kRowsPerWarp = kWarp / R;
  static constexpr int kCols = K / R;           // columns a thread owns
  static constexpr int kQuads = kCols / 4;
  static constexpr unsigned kMask =
      kWarp == 32 ? 0xffffffffu : (1u << kWarp) - 1u;
  // halving levels of the row sums (over the R threads of a row) and of
  // the dv butterfly over the warp's rows
  static constexpr int kRLevels = R >= 16 ? 4 : R >= 8 ? 3 : R >= 4 ? 2 : 1;
  static constexpr int kLevels =
      kRowsPerWarp >= 32 ? 5 : kRowsPerWarp >= 16 ? 4 : kRowsPerWarp >= 8
      ? 3 : kRowsPerWarp >= 4 ? 2 : kRowsPerWarp >= 2 ? 1 : 0;
  // the dv butterfly's first level swaps whole halves of a thread's quads:
  // a thread whose partner keeps the low half holds its quads in swapped
  // order, so that every thread keeps its first half and sends its second
  static constexpr bool kSwap = kQuads >= 2 && kLevels >= 1;
  // threads that share one step's <v, do> and sum u r k
  static constexpr int kParts =
      kThreads / kSub < 1 ? 1
      : (kThreads / kSub > kWarp ? kWarp : kThreads / kSub);
  static_assert(kQuads >= 1 && K % (4 * R) == 0, "R must divide K / 4");
  static_assert(kWarp % R == 0 && kThreads % kWarp == 0, "warp layout");
  static_assert(kSub * kParts <= kThreads, "one step sum per thread");
  static_assert(kRows % 8 == 0, "16-byte rows of r, k and w");
};

// Bytes of the raw stage: r, k, v, do of every column (T) and w of the
// block's rows (f32).
template <int K, int C, typename T>
__host__ __device__ constexpr int raw_stage_bytes() {
  return 4 * kSub * K * static_cast<int>(sizeof(T)) + kSub * (K / C) * 4;
}

template <int K, int C, int R, typename T>
__global__ void __launch_bounds__(Geom<K, C, R>::kThreads, kMinBlocks)
    wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u,
                   const float* __restrict__ bnd,
                   const T* __restrict__ dout,
                   const float* __restrict__ dsT, T* __restrict__ dr,
                   T* __restrict__ dk, T* __restrict__ dv,
                   float* __restrict__ dw, float* __restrict__ du,
                   float* __restrict__ ds0, float* __restrict__ ckpt,
                   int t_len, int chunk) {
  using G = Geom<K, C, R>;
  constexpr int kStage = kSub * K;
  constexpr int kStageRows = kSub * G::kRows;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // T per 16 bytes
  // the raw stage (dynamic shared memory)
  extern __shared__ __align__(16) unsigned char raw[];
  T* const raw_r = reinterpret_cast<T*>(raw);
  T* const raw_k = raw_r + kStage;
  T* const raw_v = raw_r + 2 * kStage;
  T* const raw_do = raw_r + 3 * kStage;
  float* const raw_w = reinterpret_cast<float*>(raw_r + 4 * kStage);
  __shared__ __align__(16) float fr[kStageRows];  // the block's rows
  __shared__ __align__(16) float fk[kStageRows];
  __shared__ __align__(16) float fw[kStageRows];
  __shared__ __align__(16) float fv[kStage];      // every column
  __shared__ __align__(16) float fdo[kStage];
  __shared__ float fa[kSub];                      // sum_k u r k
  __shared__ float fvdo[kSub];                    // <v, do>
  __shared__ float fu[K];
  __shared__ __align__(16) float dvw[kSub * G::kWarps * K];  // per warp
  // dv over each block's rows for the columns this block owns:
  // [step of the chunk][source block][owned column]
  __shared__ __align__(16) float recv[kMaxChunk * K];
  __shared__ float orow[3 * kStageRows];          // dr, dk, dw of the rows

  cg::cluster_group cluster = cg::this_cluster();
  const int n = blockIdx.x / C;
  const int cb = blockIdx.x % C;                 // rank in the cluster
  const int tid = threadIdx.x;
  const int warp = tid / G::kWarp;
  const int lane = tid % G::kWarp;
  const int g = lane % R;                        // place among the row's R
  const int il = warp * G::kRowsPerWarp + lane / R;  // row in the block
  const int i = cb * G::kRows + il;                  // row of S
  const size_t seq = static_cast<size_t>(n) * t_len * K;
  const size_t mat = static_cast<size_t>(n) * K * K;
  const int n_chunks = t_len / chunk;
  const int n_sub = (chunk + kSub - 1) / kSub;
  const int len = min(kSub, chunk);              // steps per stage
  const int per_chunk = 2 * n_sub - 1;           // stages per chunk
  const int n_stages = n_chunks * per_chunk;
  const int n_ckpt = (chunk + kSeg - 1) / kSeg;  // checkpoints per chunk
  // this thread's K / R values of row i in each checkpoint
  float* const my_ckpt = ckpt + static_cast<size_t>(n) * n_ckpt * K * K +
                         static_cast<size_t>(i) * K;

  for (int e = tid; e < K; e += G::kThreads)
    fu[e] = u[static_cast<size_t>(n) * K + e];
  // the lane's bits that steer the butterflies, computed once: the row
  // sums halve over g's bits (from the highest), dv over the row's bits
  int ybit[G::kRLevels > 2 ? G::kRLevels : 2] = {};
#pragma unroll
  for (int lv = 0; lv < G::kRLevels; ++lv)
    ybit[lv] = (g >> (G::kRLevels - 1 - lv)) & 1;
  // the row sums' first level splits g's upper half from its lower, the
  // second (R >= 4) the lower half's dr from its dk; orow[yout] is where
  // the lane writes the sum it ends with (-1: none)
  const bool yhi = ybit[0] != 0;
  const bool ysend1 = G::kRLevels >= 2 && (yhi || ybit[1] != 0);
  const bool ykeep1 = G::kRLevels >= 2 && (yhi || ybit[1] == 0);
  int yout = G::kRLevels >= 2 ? (yhi ? (ybit[1] ? -1 : 2) : ybit[1]) :
             (yhi ? 2 : 0);
#pragma unroll
  for (int lv = 2; lv < G::kRLevels; ++lv)
    if (ybit[lv]) yout = -1;
  int vbit[G::kLevels > 0 ? G::kLevels : 1];
#pragma unroll
  for (int lv = 0; lv < G::kLevels; ++lv) vbit[lv] = ((lane / R) >> lv) & 1;
  // the 16-byte column quad held in slot m (see kSwap)
  const int swap = G::kSwap ? vbit[0] * (G::kQuads / 2) : 0;
  int quad[G::kQuads];
#pragma unroll
  for (int m = 0; m < G::kQuads; ++m) quad[m] = (m ^ swap) * R + g;

  float ds[G::kQuads][4];
  float s[G::kQuads][4];
#pragma unroll
  for (int m = 0; m < G::kQuads; ++m) {
    const float4 d4 =
        dsT ? *reinterpret_cast<const float4*>(
                  dsT + mat + static_cast<size_t>(i) * K + 4 * quad[m])
            : make_float4(0.f, 0.f, 0.f, 0.f);
    ds[m][0] = d4.x; ds[m][1] = d4.y; ds[m][2] = d4.z; ds[m][3] = d4.w;
  }
  float du_i = 0.0f;  // du of row i (every thread of the row holds it)

  auto load_ckpt = [&](float4 (&dst)[G::kQuads], int idx) {
#pragma unroll
    for (int m = 0; m < G::kQuads; ++m)
      dst[m] = *reinterpret_cast<const float4*>(
          my_ckpt + static_cast<size_t>(idx) * K * K + 4 * (m * R + g));
  };
  auto save_ckpt = [&](int idx) {
#pragma unroll
    for (int m = 0; m < G::kQuads; ++m)
      *reinterpret_cast<float4*>(my_ckpt + static_cast<size_t>(idx) * K * K +
                                 4 * (m * R + g)) =
          make_float4(s[m][0], s[m][1], s[m][2], s[m][3]);
  };
  // one step of the state update, t <- w_q t + k_q v_q, in the plain
  // version's rounding and order
  auto advance = [&](float (&t)[G::kQuads][4], int q) {
    const float kq = fk[q * G::kRows + il];
    const float wq = fw[q * G::kRows + il];
    const float4* vq = reinterpret_cast<const float4*>(fv + q * K);
#pragma unroll
    for (int m = 0; m < G::kQuads; ++m) {
      const float4 v4 = vq[quad[m]];
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        t[m][e] = __fadd_rn(__fmul_rn(wq, t[m][e]), __fmul_rn(kq, vv[e]));
    }
  };

  // Stage st of the walk: chunk c (from the last), stage j of the chunk,
  // and whether it is the reverse walk (pass 2) or the forward recompute.
  auto stage_c = [&](int st) { return n_chunks - 1 - st / per_chunk; };
  auto stage_j = [&](int st) {
    const int q = st % per_chunk;
    return q < n_sub - 1 ? q : 2 * n_sub - 2 - q;
  };
  auto stage_walk = [&](int st) { return st % per_chunk >= n_sub - 1; };
  // copies of stage st into the raw buffer, as one group
  auto issue = [&](int st) {
    if (st >= n_stages) return;
    const bool walk = stage_walk(st);
    const size_t g0 = seq + static_cast<size_t>(stage_c(st) * chunk +
                                                stage_j(st) * kSub) * K;
    for (int e = tid * kVec; e < len * K; e += G::kThreads * kVec) {
      cp_async16(raw_k + e, k + g0 + e);
      cp_async16(raw_v + e, v + g0 + e);
      if (walk) {
        cp_async16(raw_r + e, r + g0 + e);
        cp_async16(raw_do + e, dout + g0 + e);
      }
    }
    for (int e = tid * 4; e < len * G::kRows; e += G::kThreads * 4)
      cp_async16(raw_w + e, w + g0 + static_cast<size_t>(e / G::kRows) * K +
                                cb * G::kRows + e % G::kRows);
    cp_async_commit();
  };

  issue(0);
  for (int st = 0; st < n_stages; ++st) {
    const int c = stage_c(st);
    const int j = stage_j(st);
    const bool walk = stage_walk(st);
    const bool last = j == n_sub - 1;  // the chunk's last stage
    const int t0 = c * chunk + j * kSub;
    if (st % per_chunk == 0) {  // a new chunk: its boundary state
      const float* b = bnd + (static_cast<size_t>(n) * n_chunks + c) * K * K +
                       static_cast<size_t>(i) * K;
#pragma unroll
      for (int m = 0; m < G::kQuads; ++m) {
        const float4 b4 = *reinterpret_cast<const float4*>(b + 4 * quad[m]);
        s[m][0] = b4.x; s[m][1] = b4.y; s[m][2] = b4.z; s[m][3] = b4.w;
      }
    }
    // the walk's first checkpoint, read ahead of the barrier
    float4 pre[G::kQuads];
    if (walk && !last) load_ckpt(pre, j * kSegs + kSegs - 1);
    cp_async_wait_all();
    __syncthreads();  // the stage has landed; the previous one is done
    for (int e = tid * kVec; e < len * G::kRows; e += G::kThreads * kVec) {
      const int q = e / G::kRows, row = cb * G::kRows + e % G::kRows;
      widen16(fk + e, raw_k + q * K + row);
      if (walk) widen16(fr + e, raw_r + q * K + row);
    }
    for (int e = tid * 4; e < len * G::kRows; e += G::kThreads * 4)
      widen16(fw + e, raw_w + e);
    for (int e = tid * kVec; e < len * K; e += G::kThreads * kVec) {
      widen16(fv + e, raw_v + e);
      if (walk) widen16(fdo + e, raw_do + e);
    }
    if (walk && tid < kSub * G::kParts) {  // one step's sums per kParts
      // part p of step q sums the kPer columns from p * kPer
      constexpr int kPer = K / G::kParts;
      static_assert(kPer % kVec == 0 && kPer % 4 == 0, "16-byte parts");
      const int q = tid / G::kParts, part = tid % G::kParts;
      float a = 0.0f, vdo = 0.0f;
      if (q < len) {
        const int e0 = q * K + part * kPer;
        float fr_[kPer], fk_[kPer], fv_[kPer], fd_[kPer];
#pragma unroll
        for (int h = 0; h < kPer; h += kVec) {
          widen16(fr_ + h, raw_r + e0 + h);
          widen16(fk_ + h, raw_k + e0 + h);
          widen16(fv_ + h, raw_v + e0 + h);
          widen16(fd_ + h, raw_do + e0 + h);
        }
#pragma unroll
        for (int h = 0; h < kPer; ++h) {
          a = fmaf(fr_[h] * fu[part * kPer + h], fk_[h], a);
          vdo = fmaf(fv_[h], fd_[h], vdo);
        }
      }
#pragma unroll
      for (int off = 1; off < G::kParts; off <<= 1) {
        a += __shfl_xor_sync(G::kMask, a, off);
        vdo += __shfl_xor_sync(G::kMask, vdo, off);
      }
      if (part == 0) {
        fa[q] = a;
        fvdo[q] = vdo;
      }
    }
    __syncthreads();  // f32 stage ready; the raw buffer is free
    issue(st + 1);    // its copies overlap this stage's work

    if (!walk) {  // pass 1: checkpoint each segment, then step over it
#pragma unroll
      for (int sg = 0; sg < kSegs; ++sg) {
        save_ckpt(j * kSegs + sg);
#pragma unroll
        for (int q = sg * kSeg; q < (sg + 1) * kSeg; ++q) advance(s, q);
      }
      continue;  // len == kSub in pass 1
    }

    // pass 2: each segment's states S_{t-1} into registers, then back,
    // from the last segment. A segment starts from its checkpoint, or in
    // the chunk's last stage (not checkpointed) from s, the stage's start.
    // A whole stage (len == kSub) runs without per-step guards, so that
    // the compiler may overlap one step's sums with the next step's work.
    auto walk_stage = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
#pragma unroll
      for (int sg = kSegs - 1; sg >= 0; --sg) {
        if (!kFull && sg * kSeg >= len) continue;
        float t[G::kQuads][4];
        if (last) {
#pragma unroll
          for (int m = 0; m < G::kQuads; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) t[m][e] = s[m][e];
#pragma unroll
          for (int q = 0; q < sg * kSeg; ++q) advance(t, q);
        } else {
#pragma unroll
          for (int m = 0; m < G::kQuads; ++m) {
            t[m][0] = pre[m].x; t[m][1] = pre[m].y;
            t[m][2] = pre[m].z; t[m][3] = pre[m].w;
          }
          if (sg > 0) load_ckpt(pre, j * kSegs + sg - 1);  // the next one
        }
        float h[kSeg][G::kQuads][4];
#pragma unroll
        for (int qq = 0; qq < kSeg; ++qq) {
#pragma unroll
          for (int m = 0; m < G::kQuads; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) h[qq][m][e] = t[m][e];
          if (qq + 1 < kSeg && (kFull || sg * kSeg + qq + 1 < len))
            advance(t, sg * kSeg + qq);
        }
#pragma unroll
        for (int qq = kSeg - 1; qq >= 0; --qq) {
          const int q = sg * kSeg + qq;
          if (!kFull && q >= len) continue;
          const float rq = fr[q * G::kRows + il];
          const float kq = fk[q * G::kRows + il];
          const float wq = fw[q * G::kRows + il];
          const float4* vq = reinterpret_cast<const float4*>(fv + q * K);
          const float4* dq = reinterpret_cast<const float4*>(fdo + q * K);
          float pr = 0.0f, pk = 0.0f, pw = 0.0f;
          float x[G::kCols];  // this row's dv terms dS_t[i, v] k_t[i]
#pragma unroll
          for (int m = 0; m < G::kQuads; ++m) {
            const float4 v4 = vq[quad[m]];
            const float4 d4 = dq[quad[m]];
            const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
            const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float sp = h[qq][m][e];  // S_{t-1}[i, col]
              pr = fmaf(sp, dd[e], pr);
              pk = fmaf(ds[m][e], vv[e], pk);
              pw = fmaf(ds[m][e], sp, pw);
              x[4 * m + e] = ds[m][e] * kq;
              ds[m][e] = __fadd_rn(__fmul_rn(wq, ds[m][e]),
                                   __fmul_rn(rq, dd[e]));
            }
          }
          // row sums of (dr, dk, dw) over the row's R threads: the first
          // level sends dw one way and dr and dk the other, the second
          // (R >= 4) parts dr from dk, the rest add whole sums; the u
          // terms join when the stage's outputs are written
          {
            const float a0 = __shfl_xor_sync(G::kMask, yhi ? pr : pw, R / 2);
            const float a1 = __shfl_xor_sync(G::kMask, pk, R / 2);
            float y0 = (yhi ? pw : pr) + a0;  // dw above, dr below
            const float y1 = pk + a1;         // dk, below
            if constexpr (G::kRLevels >= 2) {
              const float send = ysend1 ? y0 : y1;
              const float keep = ykeep1 ? y0 : y1;
              y0 = keep + __shfl_xor_sync(G::kMask, send, R / 4);
            }
#pragma unroll
            for (int lv = 2; lv < G::kRLevels; ++lv)
              y0 += __shfl_xor_sync(G::kMask, y0, (R / 2) >> lv);
            if (yout >= 0) orow[yout * kStageRows + q * G::kRows + il] = y0;
            if constexpr (G::kRLevels == 1) {
              if (!yhi) orow[kStageRows + q * G::kRows + il] = y1;
            }
          }
          // dv over the warp's rows: each level halves the columns a lane
          // keeps and adds its partner's share of them (the first level
          // without selects: see kSwap)
          int base = 0;
          bool canonical = true;
#pragma unroll
          for (int lv = 0; lv < (G::kLevels > 0 ? G::kLevels : 0); ++lv) {
            const int mask = R << lv;
            const bool bit = vbit[lv] != 0;
            constexpr int kStart = G::kCols;
            const int cnt = kStart >> lv;
            if (cnt > 1) {
              const int half = cnt / 2;
#pragma unroll
              for (int a = 0; a < G::kCols / 2; ++a) {
                if (a < half) {
                  if (G::kSwap && lv == 0) {
                    x[a] += __shfl_xor_sync(G::kMask, x[half + a], mask);
                  } else {
                    const float send = bit ? x[a] : x[half + a];
                    const float keep = bit ? x[half + a] : x[a];
                    x[a] = keep + __shfl_xor_sync(G::kMask, send, mask);
                  }
                }
              }
              base += bit ? half : 0;
            } else {
              x[0] += __shfl_xor_sync(G::kMask, x[0], mask);
              canonical = canonical && !bit;
            }
          }
          constexpr int kKept =
              (G::kCols >> G::kLevels) > 0 ? (G::kCols >> G::kLevels) : 1;
          if (canonical) {
            float* dst = dvw + (q * G::kWarps + warp) * K;
#pragma unroll
            for (int a = 0; a < kKept; ++a) {
              const int idx = base + a;
              dst[4 * ((idx / 4) * R + g) + idx % 4] = x[a];
            }
          }
        }
      }
    };
    if (len == kSub)
      walk_stage(std::true_type());
    else
      walk_stage(std::false_type());
    __syncthreads();  // every warp's dv terms and row outputs are in place
    if (last && c < n_chunks - 1)
      cluster_wait();  // the owners have read the last chunk's partials
    for (int e = tid * 4; e < len * K; e += G::kThreads * 4) {
      const int q = e / K, col = e % K;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int wp = 0; wp < G::kWarps; ++wp) {
        const float4 p = *reinterpret_cast<const float4*>(
            dvw + (q * G::kWarps + wp) * K + col);
        acc.x += p.x; acc.y += p.y; acc.z += p.z; acc.w += p.w;
      }
      const int owner = col / G::kRows;
      if (owner == cb) {
        const float a = fa[q];
        acc.x = fmaf(a, fdo[e], acc.x);
        acc.y = fmaf(a, fdo[e + 1], acc.y);
        acc.z = fmaf(a, fdo[e + 2], acc.z);
        acc.w = fmaf(a, fdo[e + 3], acc.w);
      }
      *reinterpret_cast<float4*>(cluster.map_shared_rank(recv, owner) +
                                 ((j * kSub + q) * C + cb) * G::kRows +
                                 col % G::kRows) = acc;
    }
    for (int e = tid; e < len * G::kRows; e += G::kThreads) {
      const int q = e / G::kRows, row = cb * G::kRows + e % G::kRows;
      const size_t gi = seq + static_cast<size_t>(t0 + q) * K + row;
      const float uv = fu[row] * fvdo[q];
      store(dr + gi, fmaf(uv, fk[e], orow[e]));
      store(dk + gi, fmaf(uv, fr[e], orow[kStageRows + e]));
      dw[gi] = orow[2 * kStageRows + e];
    }
    {  // du: thread (il, g) adds steps g, g + R, ... of row il, and the
       // row's R threads meet by a butterfly
      float part = 0.0f;
      for (int q = g; q < len; q += R) {
        const int e = q * G::kRows + il;
        part += (fk[e] * fvdo[q]) * fr[e];
      }
#pragma unroll
      for (int off = R / 2; off >= 1; off /= 2)
        part += __shfl_xor_sync(G::kMask, part, off);
      du_i += part;
    }
    if (j == 0) {  // the chunk is walked: combine dv over the cluster
      cluster_arrive();
      cluster_wait();  // every block's partials have landed
      for (int e = tid; e < chunk * G::kRows; e += G::kThreads) {
        const int q = e / G::kRows, cl = e % G::kRows;
        float acc = 0.0f;
#pragma unroll
        for (int b = 0; b < C; ++b) acc += recv[(q * C + b) * G::kRows + cl];
        store(dv + seq + static_cast<size_t>(c * chunk + q) * K +
                  cb * G::kRows + cl,
              acc);
      }
      cluster_arrive();  // waited for before recv is written again
    }
  }
  if (n_stages > 0) cluster_wait();  // no block leaves while written to
#pragma unroll
  for (int m = 0; m < G::kQuads; ++m)
    *reinterpret_cast<float4*>(ds0 + mat + static_cast<size_t>(i) * K +
                               4 * quad[m]) =
        make_float4(ds[m][0], ds[m][1], ds[m][2], ds[m][3]);
  if (g == 0) du[static_cast<size_t>(n) * K + i] = du_i;
}

template <int K, int C, int R, typename T>
int launch_g(const T* r, const T* k, const T* v, const float* w,
             const float* u, const float* bnd, const T* dout,
             const float* dsT, T* dr, T* dk, T* dv, float* dw, float* du,
             float* ds0, float* ckpt, int n, int t, int chunk,
             cudaStream_t stream) {
  auto kernel = wkv_bwd_kernel<K, C, R, T>;
  const int raw_bytes = raw_stage_bytes<K, C, T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, raw_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n) * C);
  cfg.blockDim = dim3(Geom<K, C, R>::kThreads);
  cfg.dynamicSmemBytes = raw_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, r, k, v, w, u, bnd, dout, dsT, dr,
                           dk, dv, dw, du, ds0, ckpt, t, chunk);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// (C, R) of each K.
bool geometry(int kk, int* cr) {
  switch (kk) {
    case 8: cr[0] = 1; cr[1] = 2; return true;
    case 16: cr[0] = 2; cr[1] = 4; return true;
    case 32: cr[0] = 2; cr[1] = 4; return true;
    case 64: cr[0] = 4; cr[1] = 8; return true;
    default: return false;
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* bnd, const void* dout,
           const float* dsT, void* dr, void* dk, void* dv, float* dw,
           float* du, float* ds0, float* ckpt, int n, int t, int kk,
           int chunk, cudaStream_t stream) {
  const T* rp = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dp = static_cast<const T*>(dout);
  T* drp = static_cast<T*>(dr);
  T* dkp = static_cast<T*>(dk);
  T* dvp = static_cast<T*>(dv);
  switch (kk) {
    case 8:
      return launch_g<8, 1, 2, T>(rp, kp, vp, w, u, bnd, dp, dsT, drp, dkp,
                                  dvp, dw, du, ds0, ckpt, n, t, chunk,
                                  stream);
    case 16:
      return launch_g<16, 2, 4, T>(rp, kp, vp, w, u, bnd, dp, dsT, drp, dkp,
                                   dvp, dw, du, ds0, ckpt, n, t, chunk,
                                   stream);
    case 32:
      return launch_g<32, 2, 4, T>(rp, kp, vp, w, u, bnd, dp, dsT, drp, dkp,
                                   dvp, dw, du, ds0, ckpt, n, t, chunk,
                                   stream);
    case 64:
      return launch_g<64, 4, 8, T>(rp, kp, vp, w, u, bnd, dp, dsT, drp, dkp,
                                   dvp, dw, du, ds0, ckpt, n, t, chunk,
                                   stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, v, dout, dr, dk, dv: (n, t, kk) bf16 when is_bf16, else f32;
// w, dw: (n, t, kk) f32; u, du: (n, kk) f32; bnd: (n, t / chunk, kk, kk)
// f32, the state before each chunk; dsT: (n, kk, kk) f32 or null (zero);
// ds0: (n, kk, kk) f32; ckpt: scratch of (n, ceil(chunk / kSeg), kk, kk)
// f32. Every pointer is 16-byte aligned. kk is 8, 16, 32 or 64; chunk
// divides t and is at most 64. Returns cudaGetLastError() after the
// launch.
extern "C" int wkv_bwd_launch(const void* r, const void* k, const void* v,
                              const float* w, const float* u,
                              const float* bnd, const void* dout,
                              const float* dsT, void* dr, void* dk, void* dv,
                              float* dw, float* du, float* ds0, float* ckpt,
                              int n, int t, int kk, int chunk, int is_bf16,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  if (chunk <= 0 || chunk > kMaxChunk || t < 0 || t % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16
             ? launch<__nv_bfloat16>(r, k, v, w, u, bnd, dout, dsT, dr, dk,
                                     dv, dw, du, ds0, ckpt, n, t, kk, chunk,
                                     stream)
             : launch<float>(r, k, v, w, u, bnd, dout, dsT, dr, dk, dv, dw,
                             du, ds0, ckpt, n, t, kk, chunk, stream);
}

// The launch geometry for head size kk: out[0] = C (blocks per sequence,
// one cluster), out[1] = R (threads per row), out[2] = kSub (steps per
// stage), out[3] = kSeg (steps between checkpoints, which sizes the ckpt
// scratch). Returns 0, or cudaErrorInvalidValue for a kk the kernel does
// not take.
extern "C" int wkv_bwd_geometry(int kk, int* out) {
  if (!geometry(kk, out)) return static_cast<int>(cudaErrorInvalidValue);
  out[2] = kSub;
  out[3] = kSeg;
  return 0;
}
