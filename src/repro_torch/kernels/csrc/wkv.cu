// K5: the RWKV6 (Finch) WKV recurrence over a whole sequence, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv.py::wkv_chunk (body
// _wkv_kernel) together with the chunk scan that drives it,
// src/repro/kernels/ops.py::rwkv6_wkv.  Per batch-head, with state
// S in R^{D x D} (float32):
//
//     y_t[j] = sum_i r_t[i] * (S[i, j] + u[i] * k_t[i] * v_t[j])
//     S[i, j] <- w_t[i] * S[i, j] + k_t[i] * v_t[j]
//
// r, k, v (BH, C, D) in the model's type (float32 or bfloat16), w (BH, C, D)
// float32, u (BH, D) float32, s0 (BH, D, D) float32 -> y (BH, C, D) in r's
// type and the final state s1 (BH, D, D) float32.  Decode is C = 1.
//
// What bounds it on this card: 5 float32 operations per (token, head, i, j)
// (an fma for y, a multiply and an fma for the update), against 16 bytes
// per (token, head, channel) read or written once, so a sequence is bound by
// the float32 rate of the CUDA cores; each of the D / JC column blocks of a
// head also reads the head's r, k and w whole, D / JC times the bytes above,
// from L2.  The recurrence is serial in t, so the bound is reached only if
// every SM has enough independent work per token.  In practice the limit
// is shared memory: a lane reads r, k and w for each of its rows every
// token, and shared memory delivers 32 floats a cycle to an SM's 128
// float32 lanes, so with one column a lane the reads take three times as
// long as the arithmetic.
//
// Design.  Columns j of S are independent, so a head is split into D / JC
// column blocks, launched next to each other so that their common reads of
// r, k and w meet in L2 (at batch 1, BH 32, D 64, JC 16: 128 blocks for the
// 132 SMs, where one block per head filled 32).  Inside a block each column
// belongs to G adjacent lanes of one warp; lane g keeps the D / G rows
// 4 (q G + g) + e (e < 4) of JL neighbouring columns in registers for the
// whole sequence, so one float4 read of shared memory serves 4 JL entries
// and the G lanes read G consecutive float4s, free of bank conflicts.
// Tokens are staged TC at a time into shared memory as float32,
// double-buffered: the loads of chunk n + 1 are issued into registers
// before chunk n is computed and stored behind it, so a chunk costs one
// barrier.  Each lane sums its rows of y for the TC JL (token, column)
// pairs of a chunk; the G lanes then fold those partial sums together with
// log2(G) exchanges that each hand over half of the values, so lane g
// stores the pairs g TC JL / G onwards.  The last chunk is padded with
// r = k = v = 0, w = 1, which leaves the state bit for bit as it was, so no
// token loop branches.  Per entry it keeps the plain version's float32
// operations (kv = k v; y += r (u kv + S); S = w S + kv) in an order that
// does not depend on TC, so a sequence gives the same bits however it is
// cut into launches, and with no atomics a run is bit for bit repeatable.
// (G, JC, JL, TC) come from `wkv_launch_params` in kernels/rwkv.py (at
// D = 64: 4 columns a lane when the blocks fill every SM twice, else 2);
// the combinations built are listed in WKV_CONFIGS.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The 16 / sizeof(T) values of one 16-byte vector, as float32, to dst.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& q, float* dst);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& q, float* dst) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(q.x), __uint_as_float(q.y),
                  __uint_as_float(q.z), __uint_as_float(q.w));
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& q,
                                                      float* dst) {
  // a bfloat16 is the upper half of a float32; the lower one comes first
  const uint32_t p[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int h = 0; h < 2; ++h)
    reinterpret_cast<float4*>(dst)[h] = make_float4(
        __uint_as_float(p[2 * h] << 16), __uint_as_float(p[2 * h] & 0xffff0000u),
        __uint_as_float(p[2 * h + 1] << 16),
        __uint_as_float(p[2 * h + 1] & 0xffff0000u));
}

// Sums acc[] over the G lanes of a column (lane bits below G).  While more
// than one value is left, lane g exchanges half of its H values with lane
// g ^ M and keeps the sums of the other half (the upper half where bit M is
// set); once one is left, the step is a plain butterfly.  Afterwards acc[x]
// holds the sum of value g H / G + x (H >= G), or of value g / (G / H) on
// every lane of its group (H < G).  Either way each sum is taken in the
// same order, ((a_g + a_g^8) + (a_g^4 + a_g^12)) + ..., whatever H is.
template <int M, int H>
__device__ __forceinline__ void fold(float* acc, int g) {
  if constexpr (M > 0) {
    if constexpr (H >= 2) {
      const bool hi = (g & M) != 0;
#pragma unroll
      for (int x = 0; x < H / 2; ++x) {
        const float send = hi ? acc[x] : acc[x + H / 2];
        const float keep = hi ? acc[x + H / 2] : acc[x];
        acc[x] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
      fold<M / 2, H / 2>(acc, g);
    } else {
      acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], M);
      fold<M / 2, 1>(acc, g);
    }
  }
}

template <typename T, int D, int G, int JC, int JL, int TC>
__global__ void __launch_bounds__(G * JC / JL, 512 / (G * JC / JL))
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ s0,
           T* __restrict__ y, float* __restrict__ s1, int C) {
  constexpr int NT = G * JC / JL;            // threads of the block
  constexpr int NQ = D / G / 4;              // float4 row groups per lane
  constexpr int VE = 16 / sizeof(T);         // values of T in 16 bytes
  constexpr int NRK = TC * D / VE, NW = TC * D / 4, NV = TC * JC / VE;
  constexpr int PRK = (NRK + NT - 1) / NT, PW = (NW + NT - 1) / NT,
                PV = (NV + NT - 1) / NT;     // 16-byte loads per thread
  constexpr int N = TC * JL;                 // y sums per lane and chunk
  constexpr int HF = N >= G ? N / G : 1;     // of them, stored by a lane
  static_assert(32 % G == 0 && D % (4 * G) == 0 && D % JC == 0, "G, JC");
  static_assert(JC % VE == 0 && JC % JL == 0 && (JL & (JL - 1)) == 0 &&
                    (TC & (TC - 1)) == 0, "JC, JL, TC");

  __shared__ __align__(16) float rs[2][TC][D], ks[2][TC][D], ws[2][TC][D];
  __shared__ __align__(16) float vs[2][TC][JC];

  const int cb = blockIdx.x % (D / JC), bh = blockIdx.x / (D / JC);
  const int tid = threadIdx.x, g = tid % G, jl = tid / G * JL;
  const int j = cb * JC + jl;                // the lane's first column
  const size_t base = static_cast<size_t>(bh) * C * D;
  const size_t sbase = static_cast<size_t>(bh) * D * D;

  // S[i, j + c] and u[i], i = 4 (q G + g) + e
  float st[NQ][4][JL], uu[NQ][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * (q * G + g) + e;
#pragma unroll
      for (int c = 0; c < JL; ++c)
        st[q][e][c] = s0[sbase + static_cast<size_t>(i) * D + j + c];
      uu[q][e] = u[static_cast<size_t>(bh) * D + i];
    }

  // The chunk of TC tokens from t0 in registers, while the chunk before is
  // computed: 16-byte loads, past C r = k = v = 0 and w = 1.
  uint4 pr[PRK], pk[PRK], pw[PW], pv[PV];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const uint32_t one_bits = __float_as_uint(1.0f);
  const uint4 one = make_uint4(one_bits, one_bits, one_bits, one_bits);
  auto fetch = [&](int t0) {
    const int n = min(TC, C - t0);
    const size_t at = base + static_cast<size_t>(t0) * D;
#pragma unroll
    for (int p = 0; p < PRK; ++p) {
      const int e = tid + p * NT;
      const bool live = e < NRK && e * VE / D < n;
      pr[p] = live ? *reinterpret_cast<const uint4*>(r + at + e * VE) : zero;
      pk[p] = live ? *reinterpret_cast<const uint4*>(k + at + e * VE) : zero;
    }
#pragma unroll
    for (int p = 0; p < PW; ++p) {
      const int e = tid + p * NT;
      pw[p] = e < NW && e * 4 / D < n
                  ? *reinterpret_cast<const uint4*>(w + at + e * 4) : one;
    }
#pragma unroll
    for (int p = 0; p < PV; ++p) {
      const int e = tid + p * NT, tt = e / (JC / VE);
      pv[p] = e < NV && tt < n
                  ? *reinterpret_cast<const uint4*>(
                        v + at + static_cast<size_t>(tt) * D + cb * JC +
                        (e % (JC / VE)) * VE)
                  : zero;
    }
  };
  // ... and then as float32 into buffer b
  auto put = [&](int b) {
#pragma unroll
    for (int p = 0; p < PRK; ++p) {
      const int e = tid + p * NT;
      if (e < NRK) {
        unpack<T>(pr[p], &rs[b][0][0] + e * VE);
        unpack<T>(pk[p], &ks[b][0][0] + e * VE);
      }
    }
#pragma unroll
    for (int p = 0; p < PW; ++p) {
      const int e = tid + p * NT;
      if (e < NW) unpack<float>(pw[p], &ws[b][0][0] + e * 4);
    }
#pragma unroll
    for (int p = 0; p < PV; ++p) {
      const int e = tid + p * NT;
      if (e < NV) unpack<T>(pv[p], &vs[b][0][0] + e * VE);
    }
  };

  const int chunks = (C + TC - 1) / TC;
  fetch(0);
  put(0);
  __syncthreads();
  for (int n = 0; n < chunks; ++n) {
    const int t0 = n * TC, b = n & 1;
    if (n + 1 < chunks) fetch(t0 + TC);
    float acc[N];                  // acc[tt JL + c]: token tt, column j + c
#pragma unroll
    for (int tt = 0; tt < TC; ++tt) {
      float vj[JL], a[JL];
#pragma unroll
      for (int c = 0; c < JL; ++c) {
        vj[c] = vs[b][tt][jl + c];
        a[c] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int i0 = 4 * (q * G + g);
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[b][tt][i0]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[b][tt][i0]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[b][tt][i0]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < JL; ++c) {
            const float kv = kk[e] * vj[c];
            a[c] = fmaf(rr[e], fmaf(uu[q][e], kv, st[q][e][c]), a[c]);
            st[q][e][c] = fmaf(ww[e], st[q][e][c], kv);
          }
      }
#pragma unroll
      for (int c = 0; c < JL; ++c) acc[tt * JL + c] = a[c];
    }
    fold<G / 2, N>(acc, g);
    bool store = true;
    if constexpr (N < G) store = g % (G / N) == 0;
    if (store) {
#pragma unroll
      for (int x = 0; x < HF; ++x) {
        const int at = g * N / G + x, t = t0 + at / JL;
        if (t < C)
          y[base + static_cast<size_t>(t) * D + j + at % JL] =
              from_f<T>(acc[x]);
      }
    }
    if (n + 1 < chunks) put(b ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < JL; ++c)
        s1[sbase + static_cast<size_t>(4 * (q * G + g) + e) * D + j + c] =
            st[q][e][c];
}

template <typename T, int D, int G, int JC, int JL, int TC>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s1, int BH, int C,
           cudaStream_t stream) {
  wkv_kernel<T, D, G, JC, JL, TC><<<BH * (D / JC), G * JC / JL, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s1), C);
  return static_cast<int>(cudaGetLastError());
}

// (D, G, JC, JL, TC) built: what `wkv_launch_params` chooses, for a
// prefill (TC > 1) and for decode (TC = 1).
#define WKV_CONFIGS(X)                                                   \
  X(32, 8, 16, 1, 16) X(32, 8, 16, 1, 1) X(64, 16, 16, 4, 8)            \
  X(64, 16, 16, 4, 1) X(64, 16, 16, 2, 16) X(64, 16, 16, 2, 1)          \
  X(128, 8, 16, 1, 8) X(128, 8, 16, 1, 1)
#ifdef REPRO_WKV_VARIANTS
// the others tried at the prefill shapes, for tools/wkv_variants.py
#define WKV_VARIANTS(X)                                                  \
  X(64, 8, 16, 1, 16) X(64, 16, 16, 1, 16) X(64, 4, 16, 1, 16)           \
  X(64, 16, 16, 2, 8) X(64, 8, 16, 2, 8) X(64, 8, 16, 4, 8)              \
  X(64, 8, 8, 1, 16) X(64, 16, 8, 2, 8) X(64, 16, 8, 2, 16)              \
  X(64, 16, 8, 4, 8) X(64, 16, 16, 4, 16) X(64, 8, 16, 2, 16)
#else
#define WKV_VARIANTS(X)
#endif

template <typename T>
int launch_t(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* y, void* s1, int BH, int C,
             int D, int G, int JC, int JL, int TC, cudaStream_t stream) {
#define WKV_CASE(d, g, jc, jl, tc)                                          \
  if (D == d && G == g && JC == jc && JL == jl && TC == tc)               \
    return launch<T, d, g, jc, jl, tc>(r, k, v, w, u, s0, y, s1, BH, C,   \
                                       stream);
  WKV_CONFIGS(WKV_CASE)
  WKV_VARIANTS(WKV_CASE)
#undef WKV_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launches K5 on `stream` (a cudaStream_t).  dtype 0 = float32, 1 = bfloat16
// for r, k, v and y; D in {32, 64, 128}; (G, JC, JL, TC) one of WKV_CONFIGS, as
// `wkv_launch_params` chooses.  r, k, v and w must be 16-byte aligned.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a combination
// that was not built.
int repro_wkv(const void* r, const void* k, const void* v, const void* w,
              const void* u, const void* s0, void* y, void* s1, int dtype,
              int BH, int C, int D, int G, int JC, int JL, int TC,
              void* stream) {
  if (BH <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(r, k, v, w, u, s0, y, s1, BH, C, D, G, JC, JL, TC,
                           st);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(r, k, v, w, u, s0, y, s1, BH, C, D, G, JC,
                                   JL, TC, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_wkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
