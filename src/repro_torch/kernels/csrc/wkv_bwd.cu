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
// by the float32 rate of the CUDA cores (0.0561 ms at rwkv6-1.6b's (128,
// 512, 64)).  The recurrence is serial in t: the parallel work has to come
// from heads, rows and columns, and each block's token stages wait on one
// another, so in practice latency (loads, barriers, folds) and the warps an
// SM decide its time.
//
// Design.  Given a token's vectors the rows of S and of G are independent
// (S[i, :] <- w[i] S[i, :] + k[i] v, G[i, :] <- w[i] G[i, :] + r[i] dy), so
// a head is split into NRB = D / RB row blocks, one thread block each, and
// dr, dk, dw (sums over j) stay inside a block.  A row's D columns lie on
// LG = D / JL adjacent lanes, JL columns a lane, and a lane holds A rows of
// them in registers; the LG lanes fold their row sums together with
// log2(LG) exchanges that each hand over half of the values (the forward's
// `fold`), TB tokens (a stage) at a time.  `wkv_bwd_launch_params` picks
// (JL, A, NW, TB) by BH: at D = 64, 4 rows a lane where 2 would take two
// waves, so BH 128's 256 blocks are resident at once; fewer rows and
// longer stages as BH falls, and 2 columns a lane where the grid gives few
// warps an SM.
//
// Staging.  A block walks 2 NB jobs, one a stage: pass 1's stages first to
// last, then pass 2's last to first.  Every job's inputs come through a
// ring of 3 stages in dynamic shared memory, filled by 16-byte `cp.async`
// copies and kept in the inputs' own type until a lane reads them.  Job j
// first issues job j + 2's copies, into the ring stage job j - 1 read
// before the barrier that ended it, then computes, then waits for job j +
// 1's copies and meets the block at one barrier: two jobs' copies are in
// flight while one computes.  Tokens past C are staged as r = k = v = dy =
// 0, w = 1, which leaves S and G bit for bit as they were.  dy . v and
// sum_i r u k a token come from a first small kernel (`wkv_bwd_prep`),
// padded with zeros to whole stages.  dr, dk and dw go out through shared
// memory, one 16-byte store a thread.
//
// The states are never stored per token and never divided by w (the model
// clamps w to [1e-5, 1], so products over a chunk underflow).  Pass 1 runs
// the recurrence forward with the forward kernel's operation order (kv = k
// v; S = w S + kv), takes dr and du on the way, and writes S to device
// memory at the start of every stage; pass 2's jobs copy their stage's
// checkpoint into the ring beside its inputs (a lane its own entries).
// Pass 2 rebuilds each stage's TB states in registers from it in the same
// order (so they equal pass 1's bit for bit) and walks them backwards with
// G in registers: the states are built twice, 17 operations per (token,
// head, i, j) in all.
//
// dv sums over rows, that is over the NRB blocks of a head: each warp folds
// its row groups' share of a stage with shuffles into shared memory, the
// block adds its warps' shares in order after the stage's barrier and
// writes its share to a float32 scratch `part`, and a last kernel
// (`wkv_bwd_dv`) adds the NRB shares in order and the bonus term.  No
// atomics: a run is bit for bit repeatable.
//
// Tried and dropped (tools/wkv_bwd_variants.py, PERF.md §6; the code is in
// the repository's history): the NRB blocks of a head as one thread-block
// cluster adding the shares in distributed shared memory (1.2-2.0x slower:
// a cluster barrier a stage, and at 2 blocks an SM only 62 clusters of 4
// resident, so BH 64 takes two waves); checkpoints every segment of K > 1
// stages with the inner states rebuilt into shared memory (a third build
// of the states and a barrier a rebuilt stage cost more than the
// checkpoints' bytes save); converting bfloat16 once a stage into float32
// stages (more registers and wider reads of shared memory, 13-28% slower).
// The launch shapes tried are WKV_BWD_VARIANTS; those built for the main
// path, WKV_BWD_CONFIGS.

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

// The JL values at p (JL * sizeof(value) bytes, aligned to that) as
// float32 (a bfloat16 is the upper half of a float32; the lower one first)
template <int JL>
__device__ __forceinline__ void load_cols(const float* p, float* out) {
  if constexpr (JL == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    out[0] = q.x, out[1] = q.y, out[2] = q.z, out[3] = q.w;
  } else if constexpr (JL == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    out[0] = q.x, out[1] = q.y;
  } else {
#pragma unroll
    for (int c = 0; c < JL; ++c) out[c] = p[c];
  }
}
template <int JL>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float* out) {
  if constexpr (JL == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    out[0] = __uint_as_float(q.x << 16);
    out[1] = __uint_as_float(q.x & 0xffff0000u);
    out[2] = __uint_as_float(q.y << 16);
    out[3] = __uint_as_float(q.y & 0xffff0000u);
  } else if constexpr (JL == 2) {
    const uint32_t q = *reinterpret_cast<const uint32_t*>(p);
    out[0] = __uint_as_float(q << 16);
    out[1] = __uint_as_float(q & 0xffff0000u);
  } else {
#pragma unroll
    for (int c = 0; c < JL; ++c) out[c] = __bfloat162float(p[c]);
  }
}

template <int JL>
__device__ __forceinline__ void store_cols(float* p, const float* in) {
  if constexpr (JL == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else if constexpr (JL == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  } else {
#pragma unroll
    for (int c = 0; c < JL; ++c) p[c] = in[c];
  }
}

// Sums acc[] over the lanes that differ in the lane bits M, M / 2, .., LO,
// as in csrc/wkv.cu: while more than one value is left, a lane exchanges
// half of its H values with lane ^ M and keeps the sums of the other half
// (the upper half where bit M is set); once one is left, the step is a
// plain butterfly.  With g the lane's bits in the range and G = 2 M / LO
// lanes summed, acc[x] then holds the sum of value g H / G + x (H >= G), or
// of value g / (G / H) on every lane of its group (H < G).
template <int M, int LO, int H>
__device__ __forceinline__ void fold(float* acc, int lane) {
  if constexpr (M >= LO && M > 0) {
    if constexpr (H >= 2) {
      const bool hi = (lane & M) != 0;
#pragma unroll
      for (int x = 0; x < H / 2; ++x) {
        const float send = hi ? acc[x] : acc[x + H / 2];
        const float keep = hi ? acc[x + H / 2] : acc[x];
        acc[x] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
      fold<M / 2, LO, H / 2>(acc, lane);
    } else {
      acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], M);
      fold<M / 2, LO, 1>(acc, lane);
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// B bytes (4, 8 or 16) from global memory into shared memory, in flight
// until the group it is committed with is waited for
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(B)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dyv[bh, t] = dy_t . v_t and ruk[bh, t] = sum_i r_t[i] u[i] k_t[i] (ruk
// BH Cp floats after dyv) for t < Cp, zero from C: a warp a row, 8 rows a
// block.
template <typename T, int D>
__global__ void __launch_bounds__(256)
wkv_bwd_prep(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dy,
             const float* __restrict__ u, float* __restrict__ dyv, int BH,
             int C, int Cp) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= BH * Cp) return;                  // the whole warp
  const int bh = row / Cp, t = row % Cp;
  float a = 0.f, b = 0.f;
  if (t < C) {
    const size_t at = (static_cast<size_t>(bh) * C + t) * D;
    const float* uh = u + static_cast<size_t>(bh) * D;
#pragma unroll
    for (int q = 0; q < D / 32; ++q) {
      const int j = lane + 32 * q;
      a = fmaf(to_f(dy[at + j]), to_f(v[at + j]), a);
      b = fmaf(to_f(r[at + j]) * uh[j], to_f(k[at + j]), b);
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, m);
    b += __shfl_xor_sync(0xffffffffu, b, m);
  }
  if (lane == 0) {
    dyv[row] = a;
    dyv[static_cast<size_t>(BH) * Cp + row] = b;
  }
}

// The TB x RB floats at src (a stage's rows of a block, from row0) into
// out (BH, C, D) at base, one 16-byte store a thread, tokens past C left
// out.
template <int TB, int RB, int D, int NT, typename O>
__device__ __forceinline__ void put_rows(O* out, const float* src,
                                         size_t base, int t0, int C,
                                         int row0, int tid) {
  constexpr int VO = 16 / sizeof(O), CR = RB / VO;
  for (int e = tid; e < TB * CR; e += NT) {
    const int tt = e / CR, c = e % CR;
    if (t0 + tt >= C) continue;
    const float* s = src + tt * RB + c * VO;
    O* const o = out + base + static_cast<size_t>(t0 + tt) * D + row0 + c * VO;
    if constexpr (VO == 4) {
      *reinterpret_cast<float4*>(o) = *reinterpret_cast<const float4*>(s);
    } else {
      uint4 q;
      uint32_t* p = reinterpret_cast<uint32_t*>(&q);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const __nv_bfloat162 b2 = __floats2bfloat162_rn(s[2 * h], s[2 * h + 1]);
        p[h] = *reinterpret_cast<const uint32_t*>(&b2);
      }
      *reinterpret_cast<uint4*>(o) = q;
    }
  }
}

// The block's shape and its dynamic shared memory, in bytes from the start
// (kernels/rwkv.py::_bwd_smem repeats kBytes for the CPU tests).
template <typename T, int D, int JL, int A, int NW, int TB>
struct Shape {
  static constexpr int LG = D / JL;        // lanes over a row's D columns
  static constexpr int RG = 32 / LG;       // row groups in a warp
  static constexpr int NG = NW * RG;       // row groups in the block
  static constexpr int RB = NG * A;        // rows of the block
  static constexpr int NRB = D / RB;       // row blocks of a head
  static constexpr int NT = NW * 32;       // threads of the block
  static constexpr int NS = 3;             // ring stages
  static constexpr int E = A * JL;         // state entries a lane
  // one ring stage: r, k (TB, RB) in T, w (TB, RB) float, v, dy (TB, D) in
  // T, dyv (TB) float
  static constexpr int oR = 0, oK = oR + TB * RB * (int)sizeof(T),
                       oW = oK + TB * RB * (int)sizeof(T),
                       oV = oW + TB * RB * 4,
                       oDY = oV + TB * D * (int)sizeof(T),
                       oDYV = oDY + TB * D * (int)sizeof(T),
                       kStage = oDYV + TB * 4;
  // then a stage's checkpoint for each ring stage ([NS][A][NT][JL] float, a
  // lane's own entries), the warps' dv shares ([2][NW][TB][D]), dr or dk
  // and dw on their way out ([2][2][TB][RB]) and u's rows
  static constexpr int kCk = NS * kStage;
  static constexpr int kRed = kCk + NS * E * NT * 4;
  static constexpr int kOut = kRed + 2 * NW * TB * D * 4;
  static constexpr int kU = kOut + 2 * 2 * TB * RB * 4;
  static constexpr int kBytes = kU + RB * 4;
  // at most 128 registers a thread (512 threads an SM) where a lane's TB
  // states fit in 32 of them
  static constexpr int kMinBlocks = TB * E <= 32 ? 512 / NT : 1;
};

// Both passes for one row block of one head (see the note above).  ck is
// (BH, NB, D, D) with NB = ceil(C / TB) stages, Cp = NB TB; dyv (2, BH,
// Cp); part (NRB, BH, C, D), the row blocks' shares of dv.
template <typename T, int D, int JL, int A, int NW, int TB>
__global__ void __launch_bounds__(Shape<T, D, JL, A, NW, TB>::NT,
                                  Shape<T, D, JL, A, NW, TB>::kMinBlocks)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ s0,
               const T* __restrict__ dy, const float* __restrict__ ds,
               const float* __restrict__ dyv, float* __restrict__ ck,
               float* __restrict__ part, T* __restrict__ dr,
               T* __restrict__ dk, float* __restrict__ dw,
               float* __restrict__ du, float* __restrict__ ds0, int BH,
               int C) {
  using L = Shape<T, D, JL, A, NW, TB>;
  constexpr int LG = L::LG, RG = L::RG, RB = L::RB, NRB = L::NRB,
                NT = L::NT, NS = L::NS;
  constexpr int N = TB * A;                 // row sums a lane folds a stage
  constexpr int HF = N >= LG ? N / LG : 1;  // of them, stored by a lane
  constexpr int VT = 16 / sizeof(T);        // values of T in 16 bytes
  static_assert(LG <= 32 && 32 % LG == 0 && D % RB == 0, "D, JL, A, NW");
  static_assert((N & (N - 1)) == 0 && (TB & (TB - 1)) == 0 && TB >= 4 &&
                    JL % RG == 0,
                "A, TB");
  static_assert((RB * sizeof(T)) % 16 == 0, "rows of 16 bytes");

  extern __shared__ __align__(16) unsigned char smem[];
  float* const ckb = reinterpret_cast<float*>(smem + L::kCk);
  float* const red = reinterpret_cast<float*>(smem + L::kRed);
  float* const ob = reinterpret_cast<float*>(smem + L::kOut);
  float* const us = reinterpret_cast<float*>(smem + L::kU);

  const int rb = blockIdx.x % NRB;          // the block's rank in its head
  const int bh = blockIdx.x / NRB;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cg = lane % LG;                 // the lane's columns JL cg + c
  const int lr0 = (warp * RG + lane / LG) * A;  // its first row in the block
  const int row0 = rb * RB;                 // the block's first row
  const size_t base = static_cast<size_t>(bh) * C * D;
  const size_t sbase = static_cast<size_t>(bh) * D * D;
  const int NB = (C + TB - 1) / TB, Cp = NB * TB;
  const float* const dyvg = dyv + static_cast<size_t>(bh) * Cp;
  // the lane's row e, columns JL cg .. of a (D, D) matrix at m
  auto at = [&](size_t m, int e) {
    return m + static_cast<size_t>(row0 + lr0 + e) * D + JL * cg;
  };
  // the lane's own JL entries of row e in ring stage s's checkpoint
  auto own = [&](int s, int e) {
    return ckb + (static_cast<size_t>(s * A + e) * NT + tid) * JL;
  };
  // the state before stage n (a global offset)
  auto ckpt = [&](int n) {
    return (static_cast<size_t>(bh) * NB + n) * D * D;
  };
  // Job j < 2 NB walks stage j (pass 1), then stage 2 NB - 1 - j (pass 2).
  auto stage_of = [&](int j) { return j < NB ? j : 2 * NB - 1 - j; };

  // Job j's inputs into ring stage j % NS, one committed group a call
  // (empty past the last job): r, k, w rows and v, dy whole, dyv, and in
  // pass 2 the stage's checkpoint (pass 2's first job finds it in place,
  // put there by pass 1).  The ring stage was last read by job j - NS
  // before the barrier that ended it.
  auto issue = [&](int j) {
    if (j < 2 * NB) {
      unsigned char* const st = smem + (j % NS) * L::kStage;
      const int t0 = stage_of(j) * TB;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      const uint32_t one_bits = __float_as_uint(1.0f);
      const uint4 one = make_uint4(one_bits, one_bits, one_bits, one_bits);
      constexpr int CRK = RB / VT, CW = RB / 4, CV = D / VT;
#pragma unroll
      for (int e = tid; e < TB * CRK; e += NT) {
        const int tt = e / CRK, c = e % CRK, t = t0 + tt;
        T* const rd = reinterpret_cast<T*>(st + L::oR) + tt * RB + c * VT;
        T* const kd = reinterpret_cast<T*>(st + L::oK) + tt * RB + c * VT;
        if (t < C) {
          const size_t g = base + static_cast<size_t>(t) * D + row0 + c * VT;
          cp_async<16>(rd, r + g);
          cp_async<16>(kd, k + g);
        } else {
          *reinterpret_cast<uint4*>(rd) = zero;
          *reinterpret_cast<uint4*>(kd) = zero;
        }
      }
#pragma unroll
      for (int e = tid; e < TB * CW; e += NT) {
        const int tt = e / CW, c = e % CW, t = t0 + tt;
        float* const wd = reinterpret_cast<float*>(st + L::oW) + tt * RB + c * 4;
        if (t < C)
          cp_async<16>(wd, w + base + static_cast<size_t>(t) * D + row0 + c * 4);
        else
          *reinterpret_cast<uint4*>(wd) = one;
      }
#pragma unroll
      for (int e = tid; e < TB * CV; e += NT) {
        const int tt = e / CV, c = e % CV, t = t0 + tt;
        T* const vd = reinterpret_cast<T*>(st + L::oV) + tt * D + c * VT;
        T* const yd = reinterpret_cast<T*>(st + L::oDY) + tt * D + c * VT;
        if (t < C) {
          const size_t g = base + static_cast<size_t>(t) * D + c * VT;
          cp_async<16>(vd, v + g);
          cp_async<16>(yd, dy + g);
        } else {
          *reinterpret_cast<uint4*>(vd) = zero;
          *reinterpret_cast<uint4*>(yd) = zero;
        }
      }
      if (tid < TB / 4)                      // dyv, 4 tokens a copy
        cp_async<16>(st + L::oDYV + tid * 16, dyvg + t0 + 4 * tid);
      if (j > NB) {
#pragma unroll
        for (int e = 0; e < A; ++e)
          cp_async<JL * 4>(own(j % NS, e), ck + at(ckpt(t0 / TB), e));
      }
    }
    cp_commit();
  };
  // Whether the lane stores its folded row sums, and which (token, row)
  // its x-th one belongs to.
  const bool store = N >= LG || cg % (LG / (N < LG ? N : LG)) == 0;
  auto which = [&](int x, int& tt, int& li) {
    const int q = cg * N / LG + x;
    tt = q / A;
    li = lr0 + q % A;
  };
  if (tid < RB) us[tid] = u[static_cast<size_t>(bh) * D + row0 + tid];
  issue(0);
  issue(1);
  cp_wait<1>();
  __syncthreads();

  // Job j issues job j + 2's copies first and ends by waiting for job j +
  // 1's: two jobs' copies are in flight while one computes.
  // ---- pass 1: the states forward; checkpoints, dr and du -------------
  float S[A][JL], dua[A];
#pragma unroll
  for (int e = 0; e < A; ++e) {
    load_cols<JL>(s0 + at(sbase, e), S[e]);
    dua[e] = 0.f;
  }
  for (int j = 0; j < NB; ++j) {
    issue(j + NS - 1);
    const unsigned char* const st = smem + (j % NS) * L::kStage;
    const T* const rs = reinterpret_cast<const T*>(st + L::oR);
    const T* const ks = reinterpret_cast<const T*>(st + L::oK);
    const float* const ws = reinterpret_cast<const float*>(st + L::oW);
    const T* const vs = reinterpret_cast<const T*>(st + L::oV);
    const T* const dys = reinterpret_cast<const T*>(st + L::oDY);
    const float* const dyvs = reinterpret_cast<const float*>(st + L::oDYV);
    float* const obj = ob + (j & 1) * 2 * TB * RB;
    const int t0 = j * TB;
#pragma unroll
    for (int e = 0; e < A; ++e) {     // the stage's checkpoint
      store_cols<JL>(ck + at(ckpt(j), e), S[e]);
      if (j == NB - 1)                // where pass 2's first job reads it
        store_cols<JL>(own(NB % NS, e), S[e]);
    }
    float acc[N];                     // acc[tt A + e]: token tt, row e
#pragma unroll
    for (int tt = 0; tt < TB; ++tt) {
      float vv[JL], dd[JL];
      load_cols<JL>(vs + tt * D + JL * cg, vv);
      load_cols<JL>(dys + tt * D + JL * cg, dd);
      const float dyvt = dyvs[tt];
#pragma unroll
      for (int e = 0; e < A; ++e) {
        const float kk = to_f(ks[tt * RB + lr0 + e]),
                    ww = ws[tt * RB + lr0 + e];
        float a = 0.f;
#pragma unroll
        for (int c = 0; c < JL; ++c) {
          const float kv = kk * vv[c];
          a = fmaf(dd[c], S[e][c], a);
          S[e][c] = fmaf(ww, S[e][c], kv);
        }
        acc[tt * A + e] = a;
        dua[e] = fmaf(to_f(rs[tt * RB + lr0 + e]) * kk, dyvt, dua[e]);
      }
    }
    fold<LG / 2, 1, N>(acc, lane);
    if (store) {
#pragma unroll
      for (int x = 0; x < HF; ++x) {
        int tt, li;
        which(x, tt, li);
        obj[tt * RB + li] =
            acc[x] + us[li] * to_f(ks[tt * RB + li]) * dyvs[tt];
      }
    }
    cp_wait<NS - 2>();
    __syncthreads();
    put_rows<TB, RB, D, NT>(dr, obj, base, t0, C, row0, tid);
  }
  if (cg == 0) {
#pragma unroll
    for (int e = 0; e < A; ++e)
      du[static_cast<size_t>(bh) * D + row0 + lr0 + e] = dua[e];
  }

  // ---- pass 2: stages from last to first; dk, dw, dv, dstate0 ----------
  float G[A][JL];
#pragma unroll
  for (int e = 0; e < A; ++e) {
    if (ds != nullptr) {
      load_cols<JL>(ds + at(sbase, e), G[e]);
    } else {
#pragma unroll
      for (int c = 0; c < JL; ++c) G[e][c] = 0.f;
    }
  }
  for (int j = NB; j < 2 * NB; ++j) {
    issue(j + NS - 1);
    const unsigned char* const st = smem + (j % NS) * L::kStage;
    const T* const rs = reinterpret_cast<const T*>(st + L::oR);
    const T* const ks = reinterpret_cast<const T*>(st + L::oK);
    const float* const ws = reinterpret_cast<const float*>(st + L::oW);
    const T* const vs = reinterpret_cast<const T*>(st + L::oV);
    const T* const dys = reinterpret_cast<const T*>(st + L::oDY);
    const float* const dyvs = reinterpret_cast<const float*>(st + L::oDYV);
    float* const obj = ob + (j & 1) * 2 * TB * RB;
    float* const redj = red + (j & 1) * NW * TB * D;
    const int t0 = stage_of(j) * TB;
    float sts[TB][A][JL];             // sts[tt] = S_{t0 + tt - 1}
#pragma unroll
    for (int e = 0; e < A; ++e) load_cols<JL>(own(j % NS, e), sts[0][e]);
#pragma unroll
    for (int tt = 1; tt < TB; ++tt) {
      float vv[JL];
      load_cols<JL>(vs + (tt - 1) * D + JL * cg, vv);
#pragma unroll
      for (int e = 0; e < A; ++e) {
        const float kk = to_f(ks[(tt - 1) * RB + lr0 + e]),
                    ww = ws[(tt - 1) * RB + lr0 + e];
#pragma unroll
        for (int c = 0; c < JL; ++c) {
          const float kv = kk * vv[c];
          sts[tt][e][c] = fmaf(ww, sts[tt - 1][e][c], kv);
        }
      }
    }
    float dka[N], dwa[N];             // [tt A + e]: token tt, row e
#pragma unroll
    for (int tt = TB - 1; tt >= 0; --tt) {
      float vv[JL], dd[JL], dvs[JL];
      load_cols<JL>(vs + tt * D + JL * cg, vv);
      load_cols<JL>(dys + tt * D + JL * cg, dd);
#pragma unroll
      for (int c = 0; c < JL; ++c) dvs[c] = 0.f;
#pragma unroll
      for (int e = 0; e < A; ++e) {
        const float kk = to_f(ks[tt * RB + lr0 + e]),
                    ww = ws[tt * RB + lr0 + e],
                    rr = to_f(rs[tt * RB + lr0 + e]);
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int c = 0; c < JL; ++c) {
          const float g = G[e][c];
          a = fmaf(g, vv[c], a);
          b = fmaf(g, sts[tt][e][c], b);
          dvs[c] = fmaf(g, kk, dvs[c]);
          G[e][c] = fmaf(ww, g, rr * dd[c]);
        }
        dka[tt * A + e] = a;
        dwa[tt * A + e] = b;
      }
      // the warp's share of dv: its row groups folded, JL / RG columns a
      // lane
      fold<16, LG, JL>(dvs, lane);
      store_cols<JL / RG>(
          redj + (warp * TB + tt) * D + JL * cg + lane / LG * (JL / RG), dvs);
    }
    fold<LG / 2, 1, N>(dka, lane);
    fold<LG / 2, 1, N>(dwa, lane);
    if (store) {
#pragma unroll
      for (int x = 0; x < HF; ++x) {
        int tt, li;
        which(x, tt, li);
        obj[tt * RB + li] = dka[x] + to_f(rs[tt * RB + li]) * us[li] * dyvs[tt];
        obj[TB * RB + tt * RB + li] = dwa[x];
      }
    }
    cp_wait<NS - 2>();
    __syncthreads();
    // the block's share of dv: its warps in order
    for (int o = tid; o < TB * D; o += NT) {
      const int tt = o / D, jc = o % D;
      float x = redj[tt * D + jc];
#pragma unroll
      for (int q = 1; q < NW; ++q) x += redj[(q * TB + tt) * D + jc];
      if (t0 + tt < C)
        part[(static_cast<size_t>(rb) * BH + bh) * C * D +
             static_cast<size_t>(t0 + tt) * D + jc] = x;
    }
    put_rows<TB, RB, D, NT>(dk, obj, base, t0, C, row0, tid);
    put_rows<TB, RB, D, NT>(dw, obj + TB * RB, base, t0, C, row0, tid);
  }
#pragma unroll
  for (int e = 0; e < A; ++e) store_cols<JL>(ds0 + at(sbase, e), G[e]);
}

// dv = the nrb row blocks' shares added in order, plus ruk dy.
template <typename T, int D>
__global__ void __launch_bounds__(256)
wkv_bwd_dv(const float* __restrict__ part, const float* __restrict__ ruk,
           const T* __restrict__ dy, T* __restrict__ dv, int nrb, int C,
           int Cp, size_t count) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t n = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       n < count; n += stride) {
    float s = part[n];
    for (int p = 1; p < nrb; ++p) s += part[p * count + n];
    const size_t row = n / D;
    dv[n] = from_f<T>(
        fmaf(ruk[row / C * Cp + row % C], to_f(dy[n]), s));
  }
}

template <typename T, int D, int JL, int A, int NW, int TB>
cudaError_t prepare() {
  using L = Shape<T, D, JL, A, NW, TB>;
  static cudaError_t done = cudaErrorNotReady;
  if (done == cudaErrorNotReady)
    done = cudaFuncSetAttribute(wkv_bwd_kernel<T, D, JL, A, NW, TB>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                L::kBytes);
  return done;
}

template <typename T, int D, int JL, int A, int NW, int TB>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, const void* dy, const void* ds,
           void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
           void* ck, void* part, void* dyv, int BH, int C,
           cudaStream_t stream) {
  using L = Shape<T, D, JL, A, NW, TB>;
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dyt = static_cast<const T*>(dy);
  float* dyvf = static_cast<float*>(dyv);
  const int Cp = (C + TB - 1) / TB * TB;
  wkv_bwd_prep<T, D><<<(BH * Cp + 7) / 8, 256, 0, stream>>>(
      rt, kt, vt, dyt, static_cast<const float*>(u), dyvf, BH, C, Cp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = prepare<T, D, JL, A, NW, TB>();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_bwd_kernel<T, D, JL, A, NW, TB><<<BH * L::NRB, L::NT, L::kBytes,
                                        stream>>>(
      rt, kt, vt, static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(s0), dyt, static_cast<const float*>(ds),
      dyvf, static_cast<float*>(ck), static_cast<float*>(part),
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<float*>(dw),
      static_cast<float*>(du), static_cast<float*>(ds0), BH, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t count = static_cast<size_t>(BH) * C * D;
  const size_t blocks = (count + 255) / 256;
  wkv_bwd_dv<T, D><<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                     256, 0, stream>>>(
      static_cast<const float*>(part), dyvf + static_cast<size_t>(BH) * Cp,
      dyt, static_cast<T*>(dv), L::NRB, C, Cp, count);
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of a launch: out = {resident blocks an SM, registers
// a thread, local (spilled) bytes a thread, dynamic shared memory bytes a
// block}.
template <typename T, int D, int JL, int A, int NW, int TB>
int fit(int* out) {
  using L = Shape<T, D, JL, A, NW, TB>;
  auto kern = wkv_bwd_kernel<T, D, JL, A, NW, TB>;
  cudaError_t err = prepare<T, D, JL, A, NW, TB>();
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, L::NT,
                                                      L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks, out[1] = fa.numRegs;
  out[2] = static_cast<int>(fa.localSizeBytes), out[3] = L::kBytes;
  return 0;
}

// (D, JL, A, NW, TB) built: what `wkv_bwd_launch_params` chooses (at D =
// 64: 4 rows a lane in 4-token stages where 2 would take two waves, 2 rows
// in 8-token stages from BH 33, 1 row in 16-token stages from BH 17, 2
// columns a lane below).
#define WKV_BWD_CONFIGS(X)                                          \
  X(32, 4, 1, 2, 4) X(64, 4, 4, 4, 4) X(64, 4, 2, 4, 8)             \
  X(64, 4, 1, 4, 16) X(64, 2, 1, 8, 16) X(128, 4, 2, 8, 4)
#ifdef REPRO_WKV_BWD_VARIANTS
// the other launch shapes tried at D = 64, for tools/wkv_bwd_variants.py:
// 4-token stages at 2 rows a lane (4 blocks an SM), and other splits of a
// row's columns and rows and of a block's warps
#define WKV_BWD_VARIANTS(X)                                         \
  X(64, 4, 2, 4, 4) X(64, 4, 1, 4, 8) X(64, 2, 2, 8, 8)             \
  X(64, 4, 2, 2, 8)
#else
#define WKV_BWD_VARIANTS(X)
#endif

template <typename T>
int launch_t(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, const void* dy, const void* ds,
             void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
             void* ck, void* part, void* dyv, int BH, int C, int D, int JL,
             int A, int NW, int TB, cudaStream_t stream) {
#define WKV_BWD_CASE(d, jl, a, nw, tb)                                      \
  if (D == d && JL == jl && A == a && NW == nw && TB == tb)                 \
    return launch<T, d, jl, a, nw, tb>(r, k, v, w, u, s0, dy, ds, dr, dk,   \
                                       dv, dw, du, ds0, ck, part, dyv, BH,  \
                                       C, stream);
  WKV_BWD_CONFIGS(WKV_BWD_CASE)
  WKV_BWD_VARIANTS(WKV_BWD_CASE)
#undef WKV_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int fit_t(int D, int JL, int A, int NW, int TB, int* out) {
#define WKV_BWD_FIT(d, jl, a, nw, tb)                        \
  if (D == d && JL == jl && A == a && NW == nw && TB == tb)  \
    return fit<T, d, jl, a, nw, tb>(out);
  WKV_BWD_CONFIGS(WKV_BWD_FIT)
  WKV_BWD_VARIANTS(WKV_BWD_FIT)
#undef WKV_BWD_FIT
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launches K5's backward on `stream` (a cudaStream_t): the prep kernel,
// the backward (D / RB blocks a head) and the dv sum.  dtype 0 = float32,
// 1 = bfloat16 for r, k, v, dy, dr, dk and dv; ds may be null (a zero
// final-state gradient); ck, part and dyv are float32 scratch of (BH, NB,
// D, D), (D / RB, BH, C, D) and (2, BH, Cp) floats (NB = ceil(C / TB)
// stages, Cp = NB TB).  r, k, v, w, dy, s0, ds, ds0, ck and dyv must be
// 16-byte aligned.  Returns the first launch error, or
// cudaErrorInvalidValue for a combination that was not built.
int repro_wkv_bwd(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* s0, const void* dy,
                  const void* ds, void* dr, void* dk, void* dv, void* dw,
                  void* du, void* ds0, void* ck, void* part, void* dyv,
                  int dtype, int BH, int C, int D, int JL, int A, int NW,
                  int TB, void* stream) {
  if (BH <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(r, k, v, w, u, s0, dy, ds, dr, dk, dv, dw, du, ds0,
                           ck, part, dyv, BH, C, D, JL, A, NW, TB, st);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(r, k, v, w, u, s0, dy, ds, dr, dk, dv, dw,
                                   du, ds0, ck, part, dyv, BH, C, D, JL, A,
                                   NW, TB, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[4] = {blocks an SM, registers, spilled bytes, shared memory bytes}
// of one built combination (see `fit`).
int repro_wkv_bwd_fit(int dtype, int D, int JL, int A, int NW, int TB,
                      int* out) {
  if (dtype == 0) return fit_t<float>(D, JL, A, NW, TB, out);
  if (dtype == 1) return fit_t<__nv_bfloat16>(D, JL, A, NW, TB, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_wkv_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
