// K4: blocked online-softmax (flash) attention, causal, GQA, optional sliding
// window, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention.py::
// flash_attention (body _attn_kernel).  q (B, H, S, D), k and v (B, Hkv, S, D),
// all contiguous, float32 or bfloat16; output (B, H, S, D) in the input type.
// Query head h reads kv head h / (H / Hkv).  Keys k >= S are masked (ragged
// S), and so are k > q (causal) and k <= q - window (sliding window).
//
// The Pallas kernel's roundings are kept: q * scale is rounded to the input
// type (scale itself rounded to it first, as JAX rounds a Python scalar to an
// array's type), scores and the running max / sum are float32, p is rounded
// to v's type before the PV product, the accumulator is float32, and the
// output is acc / max(l, 1e-30).  A masked score is -1e30, not -inf: a row
// whose first visited tile is fully masked gets exp(0) = 1 terms there, which
// the first tile with a live key scales by exp(-1e30 - m) = 0, so no NaN.
//
// What bounds it on this card: at the model's shapes (S in the thousands,
// D = 128) the work is S^2 D / 2 multiply-adds per head against S D bytes, so
// it is bound by operations: in bf16 by the tensor cores.  This first version
// computes with float32 FMAs on the CUDA cores instead, staged through shared
// memory, so it runs far above that bound; wgmma with TMA loads is the later
// step.  Design: one block of 256 threads per (query tile of 64 rows, head,
// batch); a loop inside the block over the 64-key tiles that the causal and
// window bounds admit replaces the TPU's fori_loop, so fully masked tiles are
// never visited.  Q, K, V and P tiles live in shared memory as float32 (113 KB
// at D = 128, set through cudaFuncAttributeMaxDynamicSharedMemorySize).  A
// thread owns a 4 x 4 block of the score tile (rows ty + 16 i, keys tx + 16 j)
// and the same 4 rows of the output (columns tx + 16 c), so the row max and
// row sum reduce over the 16 lanes of a half-warp with shuffles and the
// running max, sum and rescale of the accumulator stay in registers.  Rows of
// Q and K are padded by one float, so the 16 keys a half-warp reads at one d
// fall in 16 different banks.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16: ty = row group, tx = key / column
constexpr int kPS = kBK + 1;     // padded row stride of the P tile
constexpr float kNegInf = -1e30f;

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

// x rounded to T and back
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBQ * (D + 1) + kBK * D + kBQ * kPS);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int Hkv, int S, float scale, int causal, int window) {
  constexpr int QS = D + 1;      // padded row stride of the Q and K tiles
  constexpr int NC = D / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [kBQ][QS], q * scale rounded to T
  float* Ks = Qs + kBQ * QS;     // [kBK][QS]
  float* Vs = Ks + kBK * QS;     // [kBK][D]
  float* Ps = Vs + kBK * D;      // [kBQ][kPS], p rounded to T

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = qb * kBQ;
  const T* qp = q + static_cast<size_t>(b * H + h) * S * D;
  const T* kp = k + static_cast<size_t>(b * Hkv + hk) * S * D;
  const T* vp = v + static_cast<size_t>(b * Hkv + hk) * S * D;
  T* op = o + static_cast<size_t>(b * H + h) * S * D;

  const float sc = round_to<T>(scale);
  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    Qs[r * QS + c] = (q0 + r < S)
        ? round_to<T>(to_f<T>(qp[static_cast<size_t>(q0 + r) * D + c]) * sc)
        : 0.f;
  }

  // the key tiles that hold at least one unmasked key for some row
  const int n_kv = (S + kBK - 1) / kBK;
  const int hi = causal ? min(n_kv, (q0 + kBQ - 1) / kBK + 1) : n_kv;
  const int lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();             // the previous tile's K, V, P reads are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const bool in = k0 + r < S;
      const size_t g = static_cast<size_t>(k0 + r) * D + c;
      Ks[r * QS + c] = in ? to_f<T>(kp[g]) : 0.f;
      Vs[r * D + c] = in ? to_f<T>(vp[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < S && (!causal || kj <= qi) &&
                        (window <= 0 || kj > qi - window);
        if (!ok) s[i][j] = kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mn = fmaxf(m[i], mt);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        ls += p;
        Ps[(ty + 16 * i) * kPS + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ls += __shfl_xor_sync(0xffffffffu, ls, off);
      const float alpha = expf(m[i] - mn);
      l[i] = alpha * l[i] + ls;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * kPS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      op[static_cast<size_t>(qi) * D + tx + 16 * c] = from_f<T>(acc[i][c] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int S, float scale, int causal, int window,
           cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, S, scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hkv, int S, int D, float scale, int causal, int window,
             cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, Hkv, S, scale, causal, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, Hkv, S, scale, causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, Hkv, S, scale, causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches K4 on `stream` (a cudaStream_t).  dtype 0 = float32, 1 = bfloat16;
// D in {32, 64, 128}; window <= 0 means no window.  Returns a cudaError_t:
// the attribute call's or cudaGetLastError() after the launch.
int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                          int dtype, int B, int H, int Hkv, int S, int D,
                          float scale, int causal, int window, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, B, H, Hkv, S, D, scale, causal, window, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, H, Hkv, S, D, scale, causal,
                                   window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
