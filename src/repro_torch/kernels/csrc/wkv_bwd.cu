// K5's backward: the gradient of the RWKV6 (Finch) WKV recurrence, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel.  The reference's Pallas kernel
// (src/repro/kernels/rwkv.py::wkv_chunk) has no backward: the reference
// trains through XLA's autodiff of its chunkwise form,
// src/repro/models/rwkv6.py::wkv_chunked.  In the port this kernel is the
// backward of K5's autograd Function (kernels/rwkv.py::_WKV) and computes
// what its plain version kernels/rwkv.py::wkv_bwd computes, in float32.
// Per batch-head, with S_{t-1} the state before token t and G_t = dL/dS_t
// (G_{C-1} = dstate, zero when none is given):
//
//     dr_t[i] = sum_j dy_t[j] S_{t-1}[i, j] + u[i] k_t[i] (dy_t . v_t)
//     dk_t[i] = sum_j G_t[i, j] v_t[j] + r_t[i] u[i] (dy_t . v_t)
//     dv_t[j] = sum_i G_t[i, j] k_t[i] + (sum_i r_t[i] u[i] k_t[i]) dy_t[j]
//     dw_t[i] = sum_j G_t[i, j] S_{t-1}[i, j]
//     du[i]   = sum_t r_t[i] k_t[i] (dy_t . v_t)
//     G_{t-1} = diag(w_t) G_t + r_t dy_t^T,       dstate0 = G_{-1}
//
// r, k, v, dy (BH, C, D) in the model's type (float32 or bfloat16), w
// (BH, C, D), u (BH, D), s0 and dstate (BH, D, D) float32 -> dr, dk, dv in
// r's type, dw, du and dstate0 float32.
//
// What bounds it on this card: 14 float32 operations per (token, head, i,
// j) (the states again, the adjoint update, the four products above)
// against 22 bytes per (token, head, channel) in bfloat16, so it is bound
// by the float32 rate of the CUDA cores, and the recurrence is serial in t:
// the parallel work has to come from heads, rows and columns.
//
// Design.  Given a token's vectors the rows of S and of G are independent
// (S[i, :] <- w[i] S[i, :] + k[i] v, G[i, :] <- w[i] G[i, :] + r[i] dy), so
// a head is split into D / RB row blocks, one thread block each, and dr,
// dk, dw (sums over j) stay inside a block.  Within a block a row's D
// columns lie on LG = D / 4 adjacent lanes, 4 columns a lane, and a lane
// holds A rows of them in registers; the LG lanes fold their row sums
// together with log2(LG) exchanges that each hand over half of the values
// (the forward's `fold`), TB tokens at a time.  dv sums over rows, so each
// block writes its rows' share to a float32 scratch, summed over the row
// groups of the block in a fixed order; a last kernel adds the D / RB
// shares in order and the bonus term.  No atomics: a run is bit for bit
// repeatable.
//
// The states are never stored per token and never divided by w (the model
// clamps w to [1e-5, 1], so products over a chunk underflow).  Pass 1 runs
// the recurrence forward with the forward kernel's operation order (kv = k
// v; S = w S + kv), takes dr and du on the way, and writes S at every
// TB-token boundary into a float32 scratch: (C / TB) D^2 floats a head,
// where the plain version keeps 2 C D^2.  Pass 2 walks the TB-token blocks
// from last to first: it rebuilds a block's TB states from its checkpoint
// in registers, in the same order (so they equal pass 1's bit for bit),
// and walks them backwards with G in registers.  The states are built
// twice, 17 operations per (token, head, i, j) in all.  A first small
// kernel takes dy_t . v_t and sum_i r_t[i] u[i] k_t[i] a token.  Tokens
// past C are staged as r = k = v = dy = 0, w = 1, which leaves S and G bit
// for bit as they were.  (A, NW, TB) come from `wkv_bwd_launch_params` in
// kernels/rwkv.py; the combinations built are listed in WKV_BWD_CONFIGS.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

// Sums acc[] over the G lanes that share a row (lane bits below G), as in
// csrc/wkv.cu: while more than one value is left, lane g exchanges half of
// its H values with lane g ^ M and keeps the sums of the other half (the
// upper half where bit M is set); once one is left, the step is a plain
// butterfly.  Afterwards acc[x] holds the sum of value g H / G + x (H >=
// G), or of value g / (G / H) on every lane of its group (H < G).
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

// dyv[n] = dy_n . v_n and ruk[n] = sum_i r_n[i] u[i] k_n[i] for the BH C
// rows n = (bh, t): a warp a row, 8 rows a block.
template <typename T, int D>
__global__ void __launch_bounds__(256)
wkv_bwd_prep(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dy,
             const float* __restrict__ u, float* __restrict__ dyv,
             float* __restrict__ ruk, int BH, int C) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= BH * C) return;                   // the whole warp
  const size_t at = static_cast<size_t>(row) * D;
  const float* uh = u + static_cast<size_t>(row / C) * D;
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int q = 0; q < D / 32; ++q) {
    const int j = lane + 32 * q;
    a = fmaf(to_f(dy[at + j]), to_f(v[at + j]), a);
    b = fmaf(to_f(r[at + j]) * uh[j], to_f(k[at + j]), b);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, m);
    b += __shfl_xor_sync(0xffffffffu, b, m);
  }
  if (lane == 0) {
    dyv[row] = a;
    ruk[row] = b;
  }
}

// Both passes for one row block of one head (see the note above).  ck is
// (BH, NB, D, D) with NB = ceil(C / TB), part (D / RB, BH, C, D).
template <typename T, int D, int A, int NW, int TB>
__global__ void __launch_bounds__(NW * 32)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ s0,
               const T* __restrict__ dy, const float* __restrict__ ds,
               const float* __restrict__ dyv, float* __restrict__ ck,
               float* __restrict__ part, T* __restrict__ dr,
               T* __restrict__ dk, float* __restrict__ dw,
               float* __restrict__ du, float* __restrict__ ds0, int BH,
               int C) {
  constexpr int LG = D / 4;              // lanes over a row's D columns
  constexpr int RG = 32 / LG;            // row groups in a warp
  constexpr int NG = NW * RG;            // row groups in the block
  constexpr int RB = NG * A;             // rows of the block
  constexpr int NRB = D / RB;            // row blocks of a head
  constexpr int NT = NW * 32;            // threads of the block
  constexpr int N = TB * A;              // row sums a lane folds a block
  constexpr int HF = N >= LG ? N / LG : 1;   // of them, stored by a lane
  static_assert(LG <= 32 && 32 % LG == 0 && D % RB == 0, "D, A, NW");
  static_assert((N & (N - 1)) == 0 && (TB & (TB - 1)) == 0, "A, TB");

  __shared__ __align__(16) float rs[TB][RB], ks[TB][RB], ws[TB][RB];
  __shared__ __align__(16) float vs[TB][D], dys[TB][D];
  __shared__ __align__(16) float red[NG][TB][D];
  __shared__ float dyvs[TB], us[RB];

  const int rb = blockIdx.x % NRB, bh = blockIdx.x / NRB;
  const int tid = threadIdx.x, lane = tid % 32;
  const int cg = lane % LG;              // the lane's columns 4 cg + c
  const int grp = tid / 32 * RG + lane / LG;  // its row group
  const int lr0 = grp * A;               // its first row in the block
  const int row0 = rb * RB;              // the block's first row
  const size_t base = static_cast<size_t>(bh) * C * D;
  const size_t sbase = static_cast<size_t>(bh) * D * D;
  const int NB = (C + TB - 1) / TB;
  // the lane's A rows x 4 columns of a (D, D) matrix at m
  auto at4 = [&](size_t m, int e) {
    return m + static_cast<size_t>(row0 + lr0 + e) * D + 4 * cg;
  };

  if (tid < RB) us[tid] = u[static_cast<size_t>(bh) * D + row0 + tid];

  // The TB tokens from t0 as float32 (past C: r = k = v = dy = 0, w = 1).
  auto stage = [&](int t0) {
    for (int e = tid; e < TB * RB; e += NT) {
      const int tt = e / RB, i = e % RB, t = t0 + tt;
      const size_t at = base + static_cast<size_t>(t) * D + row0 + i;
      const bool live = t < C;
      rs[tt][i] = live ? to_f(r[at]) : 0.f;
      ks[tt][i] = live ? to_f(k[at]) : 0.f;
      ws[tt][i] = live ? w[at] : 1.f;
    }
    for (int e = tid; e < TB * D; e += NT) {
      const int tt = e / D, j = e % D, t = t0 + tt;
      const size_t at = base + static_cast<size_t>(t) * D + j;
      const bool live = t < C;
      vs[tt][j] = live ? to_f(v[at]) : 0.f;
      dys[tt][j] = live ? to_f(dy[at]) : 0.f;
    }
    if (tid < TB)
      dyvs[tid] = t0 + tid < C ? dyv[static_cast<size_t>(bh) * C + t0 + tid]
                               : 0.f;
  };
  // Whether the lane stores its folded sums, and which (token, row) its
  // x-th one belongs to.
  const bool store = N >= LG || cg % (LG / (N < LG ? N : LG)) == 0;
  auto which = [&](int x, int& tt, int& li) {
    const int at = cg * N / LG + x;
    tt = at / A;
    li = lr0 + at % A;
  };

  // ---- pass 1: the states forward; checkpoints, dr and du -------------
  float S[A][4], dua[A];
#pragma unroll
  for (int e = 0; e < A; ++e) {
    const float4 q = *reinterpret_cast<const float4*>(s0 + at4(sbase, e));
    S[e][0] = q.x, S[e][1] = q.y, S[e][2] = q.z, S[e][3] = q.w;
    dua[e] = 0.f;
  }
  for (int n = 0; n < NB; ++n) {
    const int t0 = n * TB;
    const size_t ckn = (static_cast<size_t>(bh) * NB + n) * D * D;
#pragma unroll
    for (int e = 0; e < A; ++e)
      *reinterpret_cast<float4*>(ck + at4(ckn, e)) =
          make_float4(S[e][0], S[e][1], S[e][2], S[e][3]);
    __syncthreads();                 // the block before has read the stage
    stage(t0);
    __syncthreads();
    float acc[N];                    // acc[tt A + e]: token tt, row e
#pragma unroll
    for (int tt = 0; tt < TB; ++tt) {
      const float4 v4 = *reinterpret_cast<const float4*>(&vs[tt][4 * cg]);
      const float4 d4 = *reinterpret_cast<const float4*>(&dys[tt][4 * cg]);
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
      const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int e = 0; e < A; ++e) {
        const float kk = ks[tt][lr0 + e], ww = ws[tt][lr0 + e];
        float a = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float kv = kk * vv[c];
          a = fmaf(dd[c], S[e][c], a);
          S[e][c] = fmaf(ww, S[e][c], kv);
        }
        acc[tt * A + e] = a;
        dua[e] = fmaf(rs[tt][lr0 + e] * kk, dyvs[tt], dua[e]);
      }
    }
    fold<LG / 2, N>(acc, cg);
    if (store) {
#pragma unroll
      for (int x = 0; x < HF; ++x) {
        int tt, li;
        which(x, tt, li);
        if (t0 + tt < C)
          dr[base + static_cast<size_t>(t0 + tt) * D + row0 + li] =
              from_f<T>(acc[x] + us[li] * ks[tt][li] * dyvs[tt]);
      }
    }
  }
  if (cg == 0) {
#pragma unroll
    for (int e = 0; e < A; ++e)
      du[static_cast<size_t>(bh) * D + row0 + lr0 + e] = dua[e];
  }

  // ---- pass 2: the blocks from last to first; dk, dw, dv, dstate0 -------
  float G[A][4];
#pragma unroll
  for (int e = 0; e < A; ++e) {
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ds != nullptr)
      q = *reinterpret_cast<const float4*>(ds + at4(sbase, e));
    G[e][0] = q.x, G[e][1] = q.y, G[e][2] = q.z, G[e][3] = q.w;
  }
  for (int n = NB - 1; n >= 0; --n) {
    const int t0 = n * TB;
    const size_t ckn = (static_cast<size_t>(bh) * NB + n) * D * D;
    float st[TB][A][4];              // st[tt] = S_{t0 + tt - 1}
#pragma unroll
    for (int e = 0; e < A; ++e) {
      const float4 q = *reinterpret_cast<const float4*>(ck + at4(ckn, e));
      st[0][e][0] = q.x, st[0][e][1] = q.y, st[0][e][2] = q.z,
      st[0][e][3] = q.w;
    }
    __syncthreads();         // the block after has read the stage and red
    stage(t0);
    __syncthreads();
#pragma unroll
    for (int tt = 1; tt < TB; ++tt) {
      const float4 v4 = *reinterpret_cast<const float4*>(&vs[tt - 1][4 * cg]);
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int e = 0; e < A; ++e) {
        const float kk = ks[tt - 1][lr0 + e], ww = ws[tt - 1][lr0 + e];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float kv = kk * vv[c];
          st[tt][e][c] = fmaf(ww, st[tt - 1][e][c], kv);
        }
      }
    }
    float dka[N], dwa[N];            // [tt A + e]: token tt, row e
#pragma unroll
    for (int tt = TB - 1; tt >= 0; --tt) {
      const float4 v4 = *reinterpret_cast<const float4*>(&vs[tt][4 * cg]);
      const float4 d4 = *reinterpret_cast<const float4*>(&dys[tt][4 * cg]);
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
      const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
      float dv4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int e = 0; e < A; ++e) {
        const float kk = ks[tt][lr0 + e], ww = ws[tt][lr0 + e],
                    rr = rs[tt][lr0 + e];
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float g = G[e][c];
          a = fmaf(g, vv[c], a);
          b = fmaf(g, st[tt][e][c], b);
          dv4[c] = fmaf(g, kk, dv4[c]);
          G[e][c] = fmaf(ww, g, rr * dd[c]);
        }
        dka[tt * A + e] = a;
        dwa[tt * A + e] = b;
      }
      *reinterpret_cast<float4*>(&red[grp][tt][4 * cg]) =
          make_float4(dv4[0], dv4[1], dv4[2], dv4[3]);
    }
    fold<LG / 2, N>(dka, cg);
    fold<LG / 2, N>(dwa, cg);
    if (store) {
#pragma unroll
      for (int x = 0; x < HF; ++x) {
        int tt, li;
        which(x, tt, li);
        if (t0 + tt < C) {
          const size_t at =
              base + static_cast<size_t>(t0 + tt) * D + row0 + li;
          dk[at] = from_f<T>(dka[x] + rs[tt][li] * us[li] * dyvs[tt]);
          dw[at] = dwa[x];
        }
      }
    }
    __syncthreads();
    // the block's share of dv: its row groups summed in order
    for (int e = tid; e < TB * D; e += NT) {
      const int tt = e / D, j = e % D;
      if (t0 + tt >= C) continue;
      float s = red[0][tt][j];
#pragma unroll
      for (int g = 1; g < NG; ++g) s += red[g][tt][j];
      part[(static_cast<size_t>(rb) * BH + bh) * C * D +
           static_cast<size_t>(t0 + tt) * D + j] = s;
    }
  }
#pragma unroll
  for (int e = 0; e < A; ++e)
    *reinterpret_cast<float4*>(ds0 + at4(sbase, e)) =
        make_float4(G[e][0], G[e][1], G[e][2], G[e][3]);
}

// dv = the nrb row blocks' shares added in order, plus ruk dy.
template <typename T, int D>
__global__ void __launch_bounds__(256)
wkv_bwd_dv(const float* __restrict__ part, const float* __restrict__ ruk,
           const T* __restrict__ dy, T* __restrict__ dv, int nrb,
           size_t count) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t n = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       n < count; n += stride) {
    float s = part[n];
    for (int p = 1; p < nrb; ++p) s += part[p * count + n];
    dv[n] = from_f<T>(fmaf(ruk[n / D], to_f(dy[n]), s));
  }
}

template <typename T, int D, int A, int NW, int TB>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, const void* dy, const void* ds,
           void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
           void* ck, void* part, void* dyv, void* ruk, int BH, int C,
           cudaStream_t stream) {
  constexpr int NRB = D / (NW * (32 / (D / 4)) * A);
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dyt = static_cast<const T*>(dy);
  float* dyvf = static_cast<float*>(dyv);
  float* rukf = static_cast<float*>(ruk);
  float* partf = static_cast<float*>(part);
  const int rows = BH * C;
  wkv_bwd_prep<T, D><<<(rows + 7) / 8, 256, 0, stream>>>(
      rt, kt, vt, dyt, static_cast<const float*>(u), dyvf, rukf, BH, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_bwd_kernel<T, D, A, NW, TB><<<BH * NRB, NW * 32, 0, stream>>>(
      rt, kt, vt, static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(s0), dyt, static_cast<const float*>(ds),
      dyvf, static_cast<float*>(ck), partf, static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<float*>(dw), static_cast<float*>(du),
      static_cast<float*>(ds0), BH, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t count = static_cast<size_t>(rows) * D;
  const size_t blocks = (count + 255) / 256;
  wkv_bwd_dv<T, D><<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                     256, 0, stream>>>(partf, rukf, dyt, static_cast<T*>(dv),
                                       NRB, count);
  return static_cast<int>(cudaGetLastError());
}

// (D, A, NW, TB) built: what `wkv_bwd_launch_params` chooses (at D = 64 two
// rows a lane from BH 33, else one).
#define WKV_BWD_CONFIGS(X) \
  X(32, 1, 2, 16) X(64, 2, 4, 8) X(64, 1, 4, 16) X(128, 2, 8, 8)
#ifdef REPRO_WKV_BWD_VARIANTS
// the others tried at D = 64, for tools/wkv_bwd_variants.py
#define WKV_BWD_VARIANTS(X) \
  X(64, 1, 4, 8) X(64, 2, 8, 8) X(64, 2, 2, 8) X(64, 1, 2, 16)
#else
#define WKV_BWD_VARIANTS(X)
#endif

template <typename T>
int launch_t(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, const void* dy, const void* ds,
             void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
             void* ck, void* part, void* dyv, void* ruk, int BH, int C,
             int D, int A, int NW, int TB, cudaStream_t stream) {
#define WKV_BWD_CASE(d, a, nw, tb)                                       \
  if (D == d && A == a && NW == nw && TB == tb)                          \
    return launch<T, d, a, nw, tb>(r, k, v, w, u, s0, dy, ds, dr, dk, dv, \
                                   dw, du, ds0, ck, part, dyv, ruk, BH, C, \
                                   stream);
  WKV_BWD_CONFIGS(WKV_BWD_CASE)
  WKV_BWD_VARIANTS(WKV_BWD_CASE)
#undef WKV_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launches K5's backward on `stream` (a cudaStream_t): three kernels, in
// order.  dtype 0 = float32, 1 = bfloat16 for r, k, v, dy, dr, dk and dv;
// ds may be null (a zero final-state gradient); ck, part, dyv and ruk are
// float32 scratch of (BH, ceil(C / TB), D, D), (D / RB, BH, C, D), (BH, C)
// and (BH, C) floats.  s0, ds, ds0 and ck must be 16-byte aligned.
// Returns the first launch error, or cudaErrorInvalidValue for a
// combination that was not built.
int repro_wkv_bwd(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* s0, const void* dy,
                  const void* ds, void* dr, void* dk, void* dv, void* dw,
                  void* du, void* ds0, void* ck, void* part, void* dyv,
                  void* ruk, int dtype, int BH, int C, int D, int A, int NW,
                  int TB, void* stream) {
  if (BH <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(r, k, v, w, u, s0, dy, ds, dr, dk, dv, dw, du, ds0,
                           ck, part, dyv, ruk, BH, C, D, A, NW, TB, st);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(r, k, v, w, u, s0, dy, ds, dr, dk, dv, dw,
                                   du, ds0, ck, part, dyv, ruk, BH, C, D, A,
                                   NW, TB, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_wkv_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
