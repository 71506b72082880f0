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
//   dr_t[k] = sum_v (S_{t-1}[k, v] + u[k] k_t[k] v_t[v]) do_t[v]
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
// Design. One block owns one sequence and walks its chunks from the last
// to the first; the block has K threads and thread i owns row i of both S
// and dS in registers. With rows owned, the state update, the dS update,
// dr_t[i], dk_t[i], dw_t[i] and du[i] stay inside the thread; only dv_t
// sums over the rows, through shared memory.
//
// The walk needs S_{t-1} in reverse order. The Pallas kernel kept a
// chunk's whole history in VMEM, (chunk, K, K) f32 = 1 MB per sequence at
// chunk = 64, K = 64: far more than the 227 KB of shared memory an H100
// block can hold. So each chunk is cut into sub-chunks of kSub = 4 steps:
// a first pass recomputes the chunk forward from its boundary and keeps
// the state at each sub-chunk's start in a global scratch (thread i its
// own row; n_sub K x K per block, in L2 at the training shape); then, for
// each sub-chunk from the last, the block recomputes its kSub states into
// shared memory from that checkpoint and walks them back. That is one more
// forward recompute per chunk than the Pallas kernel makes, and the
// history takes kSub * K * (K + 1) floats (66.5 KB at K = 64, so three
// blocks fit an SM). The history slots of a step, once read, receive that
// step's dv terms dS_t[i, v] * k_t[i], which the K threads then sum by
// columns after one barrier: three barriers per sub-chunk.
//
// Each product and sum of the state and dS updates is rounded once, in
// the order of the plain version (`kernels/wkv/ref.py`), without fused
// multiply-adds, so the recomputed states, dS and ds0 equal it bit for
// bit; dr, dk, dv, dw and du differ only in the order of their K-term
// (and, for du, T-term) sums.
//
// Bound on the H100, at the training shape N = 160, T = 4096, K = 64 with
// bf16 r/k/v/do/dr/dk/dv and f32 w/dw: about 16 K^2 operations per (n, t)
// including the forward recompute, 4.3e10 in all (0.64 ms at the float32
// peak of 67 TFLOP/s), against about 0.9 GB of inputs and outputs (0.28
// ms at 3.35 TB/s): bound by operations. With K threads a block is two
// warps, and at most three blocks share an SM; the per-step chains of
// dependent adds leave it bound by latency. Splitting a sequence's rows
// over more blocks and batching the dv reduction are left to a later
// change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kSub = 4;  // time steps per sub-chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int K>
constexpr size_t smem_floats() {
  // history/dv terms, r k v w do stages, u, <v_t, do_t>, sum_k u r k
  return static_cast<size_t>(kSub) * K * (K + 1) + 5 * kSub * K + K +
         2 * kSub;
}

template <int K, typename T>
__global__ void __launch_bounds__(K)
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
  extern __shared__ float smem[];
  constexpr int kRow = K + 1;                  // padded row of the history
  float* hist = smem;                          // [kSub][K (v)][kRow (i)]
  float* sr = hist + kSub * K * kRow;          // [kSub][K] each
  float* sk = sr + kSub * K;
  float* sv = sk + kSub * K;
  float* sw = sv + kSub * K;
  float* sdo = sw + kSub * K;
  float* su = sdo + kSub * K;                  // [K]
  float* svdo = su + K;                        // [kSub]
  float* sa = svdo + kSub;                     // [kSub]

  const int n = blockIdx.x;
  const int i = threadIdx.x;  // the row of S and dS this thread owns
  const size_t seq = static_cast<size_t>(n) * t_len * K;
  const size_t mat = static_cast<size_t>(n) * K * K;
  const int n_chunks = t_len / chunk;
  const int n_sub = (chunk + kSub - 1) / kSub;
  float* my_ckpt = ckpt + static_cast<size_t>(n) * n_sub * K * K;

  const float ui = u[static_cast<size_t>(n) * K + i];
  su[i] = ui;
  float ds[K];
  float s[K];
#pragma unroll
  for (int c = 0; c < K; ++c) ds[c] = dsT ? dsT[mat + i * K + c] : 0.0f;
  float du_i = 0.0f;

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int c0 = c * chunk;
    // Pass 1: the chunk forward from its boundary; keep each sub-chunk's
    // starting state (layout [j][v][i], coalesced over i).
    const float* b = bnd + (static_cast<size_t>(n) * n_chunks + c) * K * K;
#pragma unroll
    for (int c2 = 0; c2 < K; ++c2) s[c2] = b[i * K + c2];
    for (int j = 0; j < n_sub; ++j) {
#pragma unroll
      for (int c2 = 0; c2 < K; ++c2) my_ckpt[(j * K + c2) * K + i] = s[c2];
      if (j == n_sub - 1) break;
      const size_t g0 = seq + static_cast<size_t>(c0 + j * kSub) * K;
      __syncthreads();  // the stage is free
      for (int e = i; e < kSub * K; e += K) {
        sk[e] = to_f32(k[g0 + e]);
        sv[e] = to_f32(v[g0 + e]);
        sw[e] = w[g0 + e];
      }
      __syncthreads();
      for (int q = 0; q < kSub; ++q) {
        const float kq = sk[q * K + i];
        const float wq = sw[q * K + i];
        const float* vq = sv + q * K;
#pragma unroll
        for (int c2 = 0; c2 < K; ++c2)
          s[c2] = __fadd_rn(__fmul_rn(wq, s[c2]), __fmul_rn(kq, vq[c2]));
      }
    }

    // Pass 2: each sub-chunk from the last, its states into shared memory,
    // then the reverse walk.
    for (int j = n_sub - 1; j >= 0; --j) {
      const int t0 = c0 + j * kSub;
      const int len = min(kSub, chunk - j * kSub);
      const size_t g0 = seq + static_cast<size_t>(t0) * K;
#pragma unroll
      for (int c2 = 0; c2 < K; ++c2) s[c2] = my_ckpt[(j * K + c2) * K + i];
      __syncthreads();  // the previous sub-chunk's dv sums are done
      for (int e = i; e < len * K; e += K) {
        sr[e] = to_f32(r[g0 + e]);
        sk[e] = to_f32(k[g0 + e]);
        sv[e] = to_f32(v[g0 + e]);
        sw[e] = w[g0 + e];
        sdo[e] = to_f32(dout[g0 + e]);
      }
      __syncthreads();
      if (i < len) {  // one step's shared scalars per thread
        float vdo = 0.0f, a = 0.0f;
        for (int c2 = 0; c2 < K; ++c2) {
          vdo += sv[i * K + c2] * sdo[i * K + c2];
          a += su[c2] * sr[i * K + c2] * sk[i * K + c2];
        }
        svdo[i] = vdo;
        sa[i] = a;
      }
      for (int q = 0; q < len; ++q) {
        float* hq = hist + q * K * kRow + i;
        const float kq = sk[q * K + i];
        const float wq = sw[q * K + i];
        const float* vq = sv + q * K;
#pragma unroll
        for (int c2 = 0; c2 < K; ++c2) {
          hq[c2 * kRow] = s[c2];
          s[c2] = __fadd_rn(__fmul_rn(wq, s[c2]), __fmul_rn(kq, vq[c2]));
        }
      }
      __syncthreads();  // svdo and sa are written
      for (int q = len - 1; q >= 0; --q) {
        float* hq = hist + q * K * kRow + i;
        const float rq = sr[q * K + i];
        const float kq = sk[q * K + i];
        const float wq = sw[q * K + i];
        const float* vq = sv + q * K;
        const float* dq = sdo + q * K;
        const float vdo = svdo[q];
        float acc_r = 0.0f, acc_k = 0.0f, acc_w = 0.0f;
#pragma unroll
        for (int c2 = 0; c2 < K; ++c2) {
          const float sp = hq[c2 * kRow];  // S_{t-1}[i, c2]
          acc_r += (sp + ui * (kq * vq[c2])) * dq[c2];
          acc_k += ds[c2] * vq[c2];
          acc_w += ds[c2] * sp;
          hq[c2 * kRow] = ds[c2] * kq;     // dv term of row i, column c2
          ds[c2] = __fadd_rn(__fmul_rn(wq, ds[c2]), __fmul_rn(rq, dq[c2]));
        }
        const size_t g = g0 + static_cast<size_t>(q) * K + i;
        store(dr + g, acc_r);
        store(dk + g, (ui * rq) * vdo + acc_k);
        dw[g] = acc_w;
        du_i += (kq * vdo) * rq;
      }
      __syncthreads();  // every row's dv terms are in place
      for (int q = 0; q < len; ++q) {  // thread i sums value column i
        const float* pq = hist + (q * K + i) * kRow;
        float acc = 0.0f;
#pragma unroll
        for (int c2 = 0; c2 < K; ++c2) acc += pq[c2];
        store(dv + g0 + static_cast<size_t>(q) * K + i,
              sa[q] * sdo[q * K + i] + acc);
      }
    }
  }
#pragma unroll
  for (int c2 = 0; c2 < K; ++c2) ds0[mat + i * K + c2] = ds[c2];
  du[static_cast<size_t>(n) * K + i] = du_i;
}

template <int K, typename T>
int launch_k(const T* r, const T* k, const T* v, const float* w,
             const float* u, const float* bnd, const T* dout,
             const float* dsT, T* dr, T* dk, T* dv, float* dw, float* du,
             float* ds0, float* ckpt, int n, int t, int chunk,
             cudaStream_t stream) {
  const size_t bytes = smem_floats<K>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_kernel<K, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_bwd_kernel<K, T><<<n, K, bytes, stream>>>(
      r, k, v, w, u, bnd, dout, dsT, dr, dk, dv, dw, du, ds0, ckpt, t, chunk);
  return static_cast<int>(cudaGetLastError());
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
      return launch_k<8, T>(rp, kp, vp, w, u, bnd, dp, dsT, drp, dkp, dvp, dw,
                            du, ds0, ckpt, n, t, chunk, stream);
    case 16:
      return launch_k<16, T>(rp, kp, vp, w, u, bnd, dp, dsT, drp, dkp, dvp,
                             dw, du, ds0, ckpt, n, t, chunk, stream);
    case 32:
      return launch_k<32, T>(rp, kp, vp, w, u, bnd, dp, dsT, drp, dkp, dvp,
                             dw, du, ds0, ckpt, n, t, chunk, stream);
    case 64:
      return launch_k<64, T>(rp, kp, vp, w, u, bnd, dp, dsT, drp, dkp, dvp,
                             dw, du, ds0, ckpt, n, t, chunk, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, v, dout, dr, dk, dv: (n, t, kk) bf16 when is_bf16, else f32;
// w, dw: (n, t, kk) f32; u, du: (n, kk) f32; bnd: (n, t / chunk, kk, kk)
// f32, the state before each chunk; dsT: (n, kk, kk) f32 or null (zero);
// ds0: (n, kk, kk) f32; ckpt: scratch of (n, ceil(chunk / 4), kk, kk) f32.
// kk is 8, 16, 32 or 64 and chunk divides t. Returns cudaGetLastError()
// after the launch.
extern "C" int wkv_bwd_launch(const void* r, const void* k, const void* v,
                              const float* w, const float* u,
                              const float* bnd, const void* dout,
                              const float* dsT, void* dr, void* dk, void* dv,
                              float* dw, float* du, float* ds0, float* ckpt,
                              int n, int t, int kk, int chunk, int is_bf16,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  if (chunk <= 0 || t % chunk) return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16
             ? launch<__nv_bfloat16>(r, k, v, w, u, bnd, dout, dsT, dr, dk,
                                     dv, dw, du, ds0, ckpt, n, t, kk, chunk,
                                     stream)
             : launch<float>(r, k, v, w, u, bnd, dout, dsT, dr, dk, dv, dw,
                             du, ds0, ckpt, n, t, kk, chunk, stream);
}
