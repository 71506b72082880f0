// Forward RWKV-6 WKV recurrence on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_wkv_fwd_kernel` of
// src/repro/kernels/wkv/kernel.py (launched there by `wkv_forward`). Over
// N = batch * heads independent sequences of T steps, with a K x K state
// S[k, v] per sequence:
//
//   o_t[v] = sum_k r_t[k] * (S_{t-1}[k, v] + u[k] * k_t[k] * v_t[v])
//   S_t[k, v] = w_t[k] * S_{t-1}[k, v] + k_t[k] * v_t[v]
//
// It writes o (N, T, K) in the dtype of r (bf16 rounded to nearest even,
// as JAX's astype, or f32), the final state sT (N, K, K) f32 and, when a
// buffer is given, the state at the start of each chunk of `chunk` steps
// (N, T / chunk, K, K) f32, which the backward pass recomputes from.
//
// Design. The recurrence is sequential in T, so one block owns one
// sequence n and walks all of T; this loop takes the place of the TPU's
// sequential chunk grid axis, along which the Pallas kernel carried the
// state in a VMEM scratch. The block has K threads, and thread j owns the
// state column S[:, j] in K registers for the whole sequence: the state
// never leaves the SM. u is held in registers too. The block stages
// kSteps time steps of r, k, v and w at a time through shared memory,
// with coalesced loads, so there are two barriers per kSteps steps
// rather than per step; within a step every thread reads r_t, k_t, w_t
// as shared-memory broadcasts. Each product and sum of the state update
// is rounded once, in the order of the plain version
// (`kernels/wkv/ref.py`), without fused multiply-adds, so states and
// boundaries equal it bit for bit; o differs only in the order of its
// K-term sum.
//
// Bound on the H100, at the prefill shape N = 320, T = 4096, K = 64 with
// bf16 r/k/v/o and f32 w: about 6 K^2 operations per (n, t), 3.2e10 in
// all (0.48 ms at the float32 peak of 67 TFLOP/s), against 1.0 GB of
// inputs and outputs (0.30 ms at 3.35 TB/s): bound by operations. With
// K = 64 threads a block is two warps and N = 320 blocks leave most of
// each SM's issue slots to latency; splitting the value columns of a
// sequence over more blocks, or several sequences per block, would fill
// it. That is left to a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kSteps = 32;  // time steps staged through shared memory

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int K, typename T>
__global__ void __launch_bounds__(K)
    wkv_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u, const float* __restrict__ s0,
                   T* __restrict__ o, float* __restrict__ sT,
                   float* __restrict__ bnd, int t_len, int chunk) {
  __shared__ float sr[kSteps * K];
  __shared__ float sk[kSteps * K];
  __shared__ float sv[kSteps * K];
  __shared__ float sw[kSteps * K];
  const int n = blockIdx.x;
  const int j = threadIdx.x;  // the value column this thread owns
  const size_t seq = static_cast<size_t>(n) * t_len * K;
  const size_t mat = static_cast<size_t>(n) * K * K;
  const int n_chunks = t_len / chunk;

  float s[K];
  float uu[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    s[i] = s0[mat + i * K + j];
    uu[i] = u[static_cast<size_t>(n) * K + i];
  }

  for (int t0 = 0; t0 < t_len; t0 += kSteps) {
    const int steps = min(kSteps, t_len - t0);
    __syncthreads();  // the previous pass has read the stage
    for (int e = j; e < steps * K; e += K) {
      const size_t g = seq + static_cast<size_t>(t0) * K + e;
      sr[e] = to_f32(r[g]);
      sk[e] = to_f32(k[g]);
      sv[e] = to_f32(v[g]);
      sw[e] = w[g];
    }
    __syncthreads();
    for (int q = 0; q < steps; ++q) {
      const int t = t0 + q;
      if (bnd != nullptr && t % chunk == 0) {
        float* b = bnd + (static_cast<size_t>(n) * n_chunks + t / chunk)
                             * K * K;
#pragma unroll
        for (int i = 0; i < K; ++i) b[i * K + j] = s[i];
      }
      const float* rq = sr + q * K;
      const float* kq = sk + q * K;
      const float* wq = sw + q * K;
      const float vj = sv[q * K + j];
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float kv = __fmul_rn(kq[i], vj);
        acc = __fadd_rn(acc,
                        __fmul_rn(__fadd_rn(s[i], __fmul_rn(uu[i], kv)),
                                  rq[i]));
        s[i] = __fadd_rn(__fmul_rn(wq[i], s[i]), kv);
      }
      store(o + seq + static_cast<size_t>(t) * K + j, acc);
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) sT[mat + i * K + j] = s[i];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* o, float* sT, float* bnd,
           int n, int t, int kk, int chunk, cudaStream_t stream) {
  const T* rr = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  switch (kk) {
    case 8:
      wkv_fwd_kernel<8, T><<<n, 8, 0, stream>>>(rr, kp, vp, w, u, s0, op, sT,
                                                 bnd, t, chunk);
      break;
    case 16:
      wkv_fwd_kernel<16, T><<<n, 16, 0, stream>>>(rr, kp, vp, w, u, s0, op,
                                                   sT, bnd, t, chunk);
      break;
    case 32:
      wkv_fwd_kernel<32, T><<<n, 32, 0, stream>>>(rr, kp, vp, w, u, s0, op,
                                                   sT, bnd, t, chunk);
      break;
    case 64:
      wkv_fwd_kernel<64, T><<<n, 64, 0, stream>>>(rr, kp, vp, w, u, s0, op,
                                                   sT, bnd, t, chunk);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, o: (n, t, kk) bf16 when is_bf16, else f32; w: (n, t, kk) f32;
// u: (n, kk) f32; s0, sT: (n, kk, kk) f32; bnd: (n, t / chunk, kk, kk)
// f32 or null. kk is 8, 16, 32 or 64 and chunk divides t. Returns
// cudaGetLastError() after the launch.
extern "C" int wkv_fwd_launch(const void* r, const void* k, const void* v,
                              const float* w, const float* u,
                              const float* s0, void* o, float* sT,
                              float* bnd, int n, int t, int kk, int chunk,
                              int is_bf16, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? launch<__nv_bfloat16>(r, k, v, w, u, s0, o, sT, bnd, n, t,
                                         kk, chunk, stream)
                 : launch<float>(r, k, v, w, u, s0, o, sT, bnd, n, t, kk,
                                 chunk, stream);
}
