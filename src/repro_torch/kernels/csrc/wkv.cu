// K5: the RWKV6 (Finch) WKV recurrence over a whole sequence, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv.py::wkv_chunk (body
// _wkv_kernel) together with the chunk scan that drives it,
// src/repro/kernels/ops.py::rwkv6_wkv.  Per batch-head, with state
// S in R^{D x D} (float32):
//
//     y_t = sum_i r_t[i] * (S[i, :] + u[i] * k_t[i] * v_t)
//     S  <- diag(w_t) S + k_t (x) v_t
//
// r, k, v (BH, C, D) in the model's type (float32 or bfloat16), w (BH, C, D)
// float32, u (BH, D) float32, s0 (BH, D, D) float32 -> y (BH, C, D) in r's
// type and the final state s1 (BH, D, D) float32.  Decode is C = 1.
//
// What bounds it on this card: per token and head it reads 3 D values of the
// model's type and D float32 decays, writes D outputs, and does about 7 D^2
// float32 operations, so a long sequence is bound by float32 operations; but
// the recurrence is serial in t, so with one block per batch-head the run is
// closer to the latency of the per-token chain than to either bound.  Design:
// one block of D threads per batch-head; thread j keeps its state column
// S[:, j] (D floats) in registers for the whole sequence, so the state never
// leaves the chip between tokens or chunks: one launch replaces the TPU's
// lax.scan over chunk launches.  Tokens are staged 16 at a time: r_t, k_t,
// w_t and v_t are read once, coalesced, into shared memory, then every thread
// walks the 16 tokens reading r, k, w as broadcasts and its own v_t[j]; the
// output sum runs in four partial sums to shorten the dependent chain.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTC = 16;          // tokens staged per step

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ s0,
           T* __restrict__ y, float* __restrict__ s1, int C) {
  __shared__ float rs[kTC][D], ks[kTC][D], ws[kTC][D], vs[kTC][D], us[D];
  const int bh = blockIdx.x, j = threadIdx.x;
  const size_t sbase = static_cast<size_t>(bh) * D * D;
  const size_t base = static_cast<size_t>(bh) * C * D;

  float st[D];                   // st[i] = S[i, j]
#pragma unroll
  for (int i = 0; i < D; ++i) st[i] = s0[sbase + static_cast<size_t>(i) * D + j];
  us[j] = u[static_cast<size_t>(bh) * D + j];

  for (int t0 = 0; t0 < C; t0 += kTC) {
    const int n = min(kTC, C - t0);
    __syncthreads();             // the previous tokens' reads are done
    for (int tt = 0; tt < n; ++tt) {
      const size_t g = base + static_cast<size_t>(t0 + tt) * D + j;
      rs[tt][j] = to_f<T>(r[g]);
      ks[tt][j] = to_f<T>(k[g]);
      vs[tt][j] = to_f<T>(v[g]);
      ws[tt][j] = w[g];
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float kv = ks[tt][i] * vj;
        acc[i & 3] = fmaf(rs[tt][i], fmaf(us[i], kv, st[i]), acc[i & 3]);
        st[i] = fmaf(ws[tt][i], st[i], kv);
      }
      y[base + static_cast<size_t>(t0 + tt) * D + j] =
          from_f<T>((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) s1[sbase + static_cast<size_t>(i) * D + j] = st[i];
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s1, int BH, int C,
           cudaStream_t stream) {
  wkv_kernel<T, D><<<BH, D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s1), C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* y, void* s1, int BH, int C,
             int D, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, y, s1, BH, C, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, y, s1, BH, C, stream);
    case 128:
      return launch<T, 128>(r, k, v, w, u, s0, y, s1, BH, C, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches K5 on `stream` (a cudaStream_t).  dtype 0 = float32, 1 = bfloat16
// for r, k, v and y; D in {32, 64, 128}.  Returns cudaGetLastError().
int repro_wkv(const void* r, const void* k, const void* v, const void* w,
              const void* u, const void* s0, void* y, void* s1, int dtype,
              int BH, int C, int D, void* stream) {
  if (BH <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(r, k, v, w, u, s0, y, s1, BH, C, D, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(r, k, v, w, u, s0, y, s1, BH, C, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_wkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
