// Forward RWKV-6 WKV recurrence on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_wkv_fwd_kernel` of
// src/repro/kernels/wkv/kernel.py (launched there by `wkv_forward`). Over
// N = batch * heads independent sequences of T steps, with a K x K state
// S[k, v] per sequence:
//
//   o_t[v] = sum_k r_t[k] * (S_{t-1}[k, v] + u[k] * k_t[k] * v_t[v])
//          = sum_k r_t[k] * S_{t-1}[k, v] + v_t[v] * a_t,
//   a_t    = sum_k r_t[k] * u[k] * k_t[k]
//   S_t[k, v] = w_t[k] * S_{t-1}[k, v] + k_t[k] * v_t[v]
//
// It writes o (N, T, K) in the dtype of r (bf16 rounded to nearest even,
// as JAX's astype, or f32), the final state sT (N, K, K) f32 and, when a
// buffer is given, the state at the start of each chunk of `chunk` steps
// (N, T / chunk, K, K) f32, which the backward pass recomputes from.
//
// Design. The recurrence is sequential in T, so a block walks all of T;
// this loop takes the place of the TPU's sequential chunk grid axis. The
// value columns are independent (S[:, v] depends on v_t[v] alone), so a
// sequence's K columns are split over C blocks, and each column over R
// threads that own K / R rows each: a thread keeps K / R state values in
// registers for the whole sequence, and sums its part of o_t[v] in four
// independent chains (one per element of a quad, so that a step's sum is
// not one long chain of dependent adds); the R partial sums meet by
// __shfl_xor_sync (the R threads of a column sit in one warp). A
// thread's rows are the 4-row quads g, g + R, g + 2R, ... (g its place
// among the column's threads), so the R distinct 16-byte shared-memory
// reads of a warp fall on distinct banks. The bonus term is a_t * v_t[v]:
// a_t is summed once per step and block while the stage is converted.
//
// Staging: kSteps steps of r, k, v, w are copied into a ring of kRing
// slots of shared memory with 16-byte cp.async ahead of use, and
// converted once to f32, 16 bytes at a time; a whole stage is unrolled so
// that its steps overlap. o is gathered per stage and written 16 bytes at
// a time by rows of the block's columns, and boundary stores put
// neighbouring columns in neighbouring lanes.
//
// Geometry, chosen by timing variants on an H100 (PERF.md): every
// K = 64 launch runs C = 2 blocks per sequence and R = 4 threads per
// column (16 rows a thread, 128 threads a block), with kSteps = 16, a
// ring of 2 and at most 102 registers (5 blocks per SM, so the prefill
// shape's 640 blocks are resident at once). Four blocks per sequence
// were no faster at N = 160 and slower at N = 320; eight rows a thread
// and a deeper ring were no faster either. Smaller K (the tests' shapes)
// use one geometry each (`geometry` below).
//
// Exactness. Each product and sum of the state update is rounded once,
// in the order of the plain version (`kernels/wkv/ref.py`), without fused
// multiply-adds, so the states and boundaries equal it bit for bit; o
// differs only in the order of its sums (fused multiply-adds allowed).
// Offsets into the (N, T, K) and (N, T / chunk, K, K) arrays are size_t,
// so N * T * K may exceed 2^31.
//
// Bound on the H100, at the prefill shape N = 320, T = 4096, K = 64 with
// bf16 r/k/v/o and f32 w: 5 K^2 float operations per (n, t) (2 for the
// products and sums of o, 3 for the state's decay, product and sum; the
// bonus is O(K) through a_t), 2.7e10 in all (0.40 ms at the float32 peak
// of 67 TFLOP/s), against 1.0 GB of inputs and outputs (0.30 ms at 3.35
// TB/s): bound by operations. At the training shape (N = 160, with
// boundaries) the two are even: 0.20 ms each. The kernel issues about
// 4 K^2 float instructions per (n, t) (one FMA for o, two products and a
// sum for the state, which bit-equality keeps from fusing), plus one
// 16-byte shared-memory read per four state values per input and the
// shuffles of o; what holds it back is that instruction stream, not
// memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kSteps = 16;     // time steps per stage
constexpr int kRing = 2;       // stages in flight (copies run ahead)
constexpr int kMinBlocks = 5;  // blocks per SM the register cap leaves room for


// 16 bytes of T at src as f32 into dst (16 / sizeof(T) values), and back
// (bf16 rounded to nearest even); every pointer 16-byte aligned.
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
__device__ __forceinline__ void narrow16(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void narrow16(__nv_bfloat16* dst,
                                         const float* src) {
  unsigned x[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const __nv_bfloat162 p =
        __halves2bfloat162(__float2bfloat16_rn(src[2 * h]),
                           __float2bfloat16_rn(src[2 * h + 1]));
    x[h] = *reinterpret_cast<const unsigned*>(&p);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most kRing - 2 groups of copies are in flight: the
// oldest one (the stage about to be converted) has landed
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 2) : "memory");
}

// Bytes of one raw stage in the ring: r, k, v (T) and w (f32).
template <int K, typename T>
__host__ __device__ constexpr int raw_stage_bytes() {
  return kSteps * K * (3 * static_cast<int>(sizeof(T)) + 4);
}

// C blocks per sequence, R threads per value column.
template <int K, int C, int R>
struct Geom {
  static constexpr int kCols = K / C;            // value columns a block owns
  static constexpr int kThreads = kCols * R;
  static constexpr int kWarp = kThreads < 32 ? kThreads : 32;
  static constexpr int kColsPerWarp = kWarp / R;
  static constexpr int kQuads = K / R / 4;       // 4-row quads a thread owns
  static constexpr unsigned kMask =
      kWarp == 32 ? 0xffffffffu : (1u << kWarp) - 1u;
  // threads that share one step's a_t sum
  static constexpr int kParts =
      kThreads / kSteps < 1 ? 1
      : (kThreads / kSteps > kWarp ? kWarp : kThreads / kSteps);
  static_assert(kQuads >= 1 && K % (4 * R) == 0, "R must divide K / 4");
  static_assert(kWarp % R == 0 && kThreads % kWarp == 0, "warp layout");
  static_assert(K % kParts == 0, "a_t split");
};

template <int K, int C, int R, typename T>
__global__ void __launch_bounds__(Geom<K, C, R>::kThreads, kMinBlocks)
    wkv_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u, const float* __restrict__ s0,
                   T* __restrict__ o, float* __restrict__ sT,
                   float* __restrict__ bnd, int t_len, int chunk) {
  using G = Geom<K, C, R>;
  constexpr int kStage = kSteps * K;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // T per 16 bytes
  // the ring of raw stages (dynamic shared memory, kRing slots)
  extern __shared__ __align__(16) unsigned char ring[];
  constexpr int kSlot = raw_stage_bytes<K, T>();
  auto raw_r = [&](int t0) {
    return reinterpret_cast<T*>(ring + ((t0 / kSteps) % kRing) * kSlot);
  };
  __shared__ __align__(16) float fr[kStage];
  __shared__ __align__(16) float fk[kStage];
  __shared__ __align__(16) float fw[kStage];
  __shared__ __align__(16) float fv[kSteps * G::kCols];
  __shared__ __align__(16) float fo[kSteps * G::kCols];
  __shared__ float fa[kSteps];
  __shared__ float fu[K];

  const int n = blockIdx.x / C;
  const int c = blockIdx.x % C;
  const int tid = threadIdx.x;
  const int lane = tid % G::kWarp;
  const int g = lane / G::kColsPerWarp;        // place among the R threads
  const int jl = (tid / G::kWarp) * G::kColsPerWarp + lane % G::kColsPerWarp;
  const int j = c * G::kCols + jl;             // the value column
  const size_t seq = static_cast<size_t>(n) * t_len * K;
  const size_t mat = static_cast<size_t>(n) * K * K;
  const int n_chunks = t_len / chunk;

  for (int i = tid; i < K; i += G::kThreads)
    fu[i] = u[static_cast<size_t>(n) * K + i];
  float s[G::kQuads][4];
#pragma unroll
  for (int m = 0; m < G::kQuads; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[m][e] = s0[mat + static_cast<size_t>(4 * (m * R + g) + e) * K + j];

  // 16-byte copies of the stage that starts at t0 into its ring slot; a
  // group is committed even past the end, so that the count of groups in
  // flight is kept
  auto issue = [&](int t0) {
    if (t0 < t_len) {
      constexpr int kPerT = 16 / sizeof(T);
      const int steps = min(kSteps, t_len - t0);
      const size_t g0 = seq + static_cast<size_t>(t0) * K;
      T* rr = raw_r(t0);
      float* rw = reinterpret_cast<float*>(rr + 3 * kStage);
      for (int e = tid * kPerT; e < steps * K; e += G::kThreads * kPerT) {
        cp_async16(rr + e, r + g0 + e);
        cp_async16(rr + kStage + e, k + g0 + e);
        cp_async16(rr + 2 * kStage + e, v + g0 + e);
      }
      for (int e = tid * 4; e < steps * K; e += G::kThreads * 4)
        cp_async16(rw + e, w + g0 + e);
    }
    cp_async_commit();
  };
  // o of the stage that starts at t0, by rows of the block's columns
  auto flush_o = [&](int t0, int steps) {
    for (int e = tid * kVec; e < steps * G::kCols; e += G::kThreads * kVec)
      narrow16(o + seq + static_cast<size_t>(t0 + e / G::kCols) * K +
                   c * G::kCols + e % G::kCols,
               fo + e);
  };

  int next_bnd = 0;  // the next step whose starting state is a boundary
  for (int p = 0; p < kRing - 1; ++p) issue(p * kSteps);
  for (int t0 = 0; t0 < t_len; t0 += kSteps) {
    const int steps = min(kSteps, t_len - t0);
    cp_async_wait_stage();
    __syncthreads();  // the stage has landed; the previous one is walked
    if (t0 > 0) flush_o(t0 - kSteps, kSteps);
    const T* raw_rr = raw_r(t0);
    const T* raw_k = raw_rr + kStage;
    const T* raw_v = raw_rr + 2 * kStage;
    const float* raw_w = reinterpret_cast<const float*>(raw_rr + 3 * kStage);
    for (int e = tid * kVec; e < steps * K; e += G::kThreads * kVec) {
      widen16(fr + e, raw_rr + e);
      widen16(fk + e, raw_k + e);
    }
    for (int e = tid * 4; e < steps * K; e += G::kThreads * 4)
      widen16(fw + e, raw_w + e);
    for (int e = tid * kVec; e < steps * G::kCols; e += G::kThreads * kVec)
      widen16(fv + e,
              raw_v + (e / G::kCols) * K + c * G::kCols + e % G::kCols);
    // a_t: part p of step q sums the kPer rows from p * kPer
    for (int e = tid; e < kSteps * G::kParts; e += G::kThreads) {
      constexpr int kPer = K / G::kParts;
      static_assert(kPer % kVec == 0 && kPer % 4 == 0, "16-byte parts");
      const int q = e / G::kParts, part = e % G::kParts;
      float a = 0.0f;
      if (q < steps) {
        const int e0 = q * K + part * kPer;
        float r_[kPer], k_[kPer];
#pragma unroll
        for (int h = 0; h < kPer; h += kVec) {
          widen16(r_ + h, raw_rr + e0 + h);
          widen16(k_ + h, raw_k + e0 + h);
        }
#pragma unroll
        for (int h = 0; h < kPer; ++h)
          a = fmaf(r_[h] * fu[part * kPer + h], k_[h], a);
      }
#pragma unroll
      for (int off = 1; off < G::kParts; off <<= 1)
        a += __shfl_xor_sync(G::kMask, a, off);
      if (part == 0) fa[q] = a;
    }
    __syncthreads();  // f32 stage ready; the raw buffers are free
    issue(t0 + (kRing - 1) * kSteps);  // into the slot t0 - kSteps freed

    // one step: o_t into the stage's buffer, the state advanced
    auto step = [&](int q) {
      const int t = t0 + q;
      if (bnd != nullptr && t == next_bnd) {
        float* b = bnd + (static_cast<size_t>(n) * n_chunks + t / chunk) *
                             K * K + j;
#pragma unroll
        for (int m = 0; m < G::kQuads; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            b[static_cast<size_t>(4 * (m * R + g) + e) * K] = s[m][e];
        next_bnd += chunk;
      }
      const float4* rq = reinterpret_cast<const float4*>(fr + q * K);
      const float4* kq = reinterpret_cast<const float4*>(fk + q * K);
      const float4* wq = reinterpret_cast<const float4*>(fw + q * K);
      const float vj = fv[q * G::kCols + jl];
      float acc4[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // four chains, not one
#pragma unroll
      for (int m = 0; m < G::kQuads; ++m) {
        const float4 r4 = rq[m * R + g];
        const float4 k4 = kq[m * R + g];
        const float4 w4 = wq[m * R + g];
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc4[e] = fmaf(rr[e], s[m][e], acc4[e]);
          s[m][e] = __fadd_rn(__fmul_rn(ww[e], s[m][e]),
                              __fmul_rn(kk[e], vj));
        }
      }
      float acc = (acc4[0] + acc4[1]) + (acc4[2] + acc4[3]);
#pragma unroll
      for (int off = G::kColsPerWarp; off < G::kWarp; off <<= 1)
        acc += __shfl_xor_sync(G::kMask, acc, off);
      if (g == 0) fo[q * G::kCols + jl] = fmaf(vj, fa[q], acc);
    };
    if (steps == kSteps) {  // a whole stage: unrolled, steps overlap
#pragma unroll
      for (int q = 0; q < kSteps; ++q) step(q);
    } else {
      for (int q = 0; q < steps; ++q) step(q);
    }
  }
  __syncthreads();
  if (t_len > 0) flush_o(((t_len - 1) / kSteps) * kSteps,
                         t_len - ((t_len - 1) / kSteps) * kSteps);
#pragma unroll
  for (int m = 0; m < G::kQuads; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sT[mat + static_cast<size_t>(4 * (m * R + g) + e) * K + j] = s[m][e];
}

template <int K, int C, int R, typename T>
int launch_g(const T* r, const T* k, const T* v, const float* w,
             const float* u, const float* s0, T* o, float* sT, float* bnd,
             int n, int t, int chunk, cudaStream_t stream) {
  auto kernel = wkv_fwd_kernel<K, C, R, T>;
  const int ring_bytes = kRing * raw_stage_bytes<K, T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ring_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(n) * C, Geom<K, C, R>::kThreads, ring_bytes,
           stream>>>(r, k, v, w, u, s0, o, sT, bnd, t, chunk);
  return static_cast<int>(cudaGetLastError());
}

// (C, R) of each K.
bool geometry(int kk, int* cr) {
  switch (kk) {
    case 8: cr[0] = 1; cr[1] = 2; return true;
    case 16: cr[0] = 2; cr[1] = 4; return true;
    case 32: cr[0] = 2; cr[1] = 4; return true;
    case 64: cr[0] = 2; cr[1] = 4; return true;
    default: return false;
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* o, float* sT, float* bnd,
           int n, int t, int kk, int chunk, cudaStream_t stream) {
  const T* rp = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  switch (kk) {
    case 8:
      return launch_g<8, 1, 2, T>(rp, kp, vp, w, u, s0, op, sT, bnd, n, t,
                                  chunk, stream);
    case 16:
      return launch_g<16, 2, 4, T>(rp, kp, vp, w, u, s0, op, sT, bnd, n, t,
                                   chunk, stream);
    case 32:
      return launch_g<32, 2, 4, T>(rp, kp, vp, w, u, s0, op, sT, bnd, n, t,
                                   chunk, stream);
    case 64:
      return launch_g<64, 2, 4, T>(rp, kp, vp, w, u, s0, op, sT, bnd, n, t,
                                   chunk, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, v, o: (n, t, kk) bf16 when is_bf16, else f32; w: (n, t, kk) f32;
// u: (n, kk) f32; s0, sT: (n, kk, kk) f32; bnd: (n, t / chunk, kk, kk)
// f32 or null. Every pointer is 16-byte aligned. kk is 8, 16, 32 or 64
// and chunk divides t. Returns cudaGetLastError() after the launch.
extern "C" int wkv_fwd_launch(const void* r, const void* k, const void* v,
                              const float* w, const float* u,
                              const float* s0, void* o, float* sT,
                              float* bnd, int n, int t, int kk, int chunk,
                              int is_bf16, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (chunk <= 0 || t < 0 || t % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? launch<__nv_bfloat16>(r, k, v, w, u, s0, o, sT, bnd, n, t,
                                         kk, chunk, stream)
                 : launch<float>(r, k, v, w, u, s0, o, sT, bnd, n, t, kk,
                                 chunk, stream);
}

// The launch geometry for head size kk: out[0] = C (blocks per
// sequence), out[1] = R (threads per value column), out[2] = time steps
// per stage. Returns 0, or cudaErrorInvalidValue for a kk the kernel
// does not take.
extern "C" int wkv_fwd_geometry(int kk, int* out) {
  if (!geometry(kk, out)) return static_cast<int>(cudaErrorInvalidValue);
  out[2] = kSteps;
  return 0;
}
