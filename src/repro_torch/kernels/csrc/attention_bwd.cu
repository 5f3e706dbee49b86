// K4's backward: the gradient of blocked flash attention (GQA, causal,
// sliding window, or unmasked over keys of their own length), for Hopper
// (sm_90a).
//
// Replaces no TPU kernel.  The reference's Pallas kernel
// (src/repro/kernels/attention.py::flash_attention) has no backward: the
// reference trains through XLA's autodiff of its plain attention,
// src/repro/models/layers.py::attention_full.  In the port this kernel is the
// backward of K4's autograd Function (kernels/attention.py::_FlashAttention)
// and computes what its plain version kernels/attention.py::
// flash_attention_bwd computes.  q, o, dO (B, H, Sq, D), k, v (B, Hkv, Sk, D),
// contiguous, float32 or bfloat16; query head h reads kv head h / (H / Hkv).
// The forward (csrc/attention.cu) leaves each query row's softmax statistics,
// its final max m and its sum l (float32, (2, B, H, Sq)), so P is recomputed
// with K4's roundings and the rows are never reduced again:
//
//     qs = q * scale            rounded to the input type (scale first)
//     s  = qs k^T               float32, masked keys get p = 0
//     p  = exp(s - m),  P = p / max(l, 1e-30)
//     dV = sum_q (bf16(p) / l) dO        p rounded to v's type, as the PV
//                                        product of the forward took it
//     dP = dO V^T,  delta = rowsum(dO o),  dS = P (dP - delta)
//     dK = dS^T qs,  dQ = scale dS K
//
// dK and dV sum over the query heads of a GQA group.  Three kernels a
// launch, no atomics, so a run is bit for bit repeatable:
//
//   prep   a warp a row: delta in float32, and qs into a scratch of q's
//          shape, so that neither of the next two rounds q again;
//   dq     a block a (query tile, head, batch) walks the key tiles its rows
//          see: S, dP, then dQ += dS K, in registers;
//   dkdv   a block a (key tile, kv head, batch) walks the group's query heads
//          and the query tiles that see a key of the tile (the forward's tile
//          bounds turned around: causal from the tile's diagonal on, a window
//          up to the last query that still sees the tile, unmasked every one
//          of the Sq rows): S^T, dP^T, then dV += P^T dO and dK += dS^T qs,
//          summed in registers across the whole group.
//
// The two main kernels take QK^T and dO V^T each: 7 products of 2 D
// operations an admitted (query, key) pair where the least work is 5 (the
// gradients bit for bit the same on every run, instead of dQ summed over key
// tiles with atomics).  At head size 256 the dkdv kernel keeps dK and dV in
// two halves of 128 columns and walks its query tiles once a half, so S^T and
// dP^T are taken twice there: 9 products.
//
// What bounds it on this card: at the models' training shapes (S 512 to
// 4,096, D 64 to 256) the work is 7 S^2 D multiply-adds a head against 8
// tensors of S D bytes read or written once, so it is bound by operations,
// in bfloat16 by the tensor cores.
//
// bfloat16 (namespace tc): every product runs on the tensor cores as
// mma.sync m16n8k16 bf16 -> float32.  Blocks of 4 warps; a warp owns 16 rows
// of the output (16 keys of dK and dV, 16 queries of dQ).  Tiles are staged
// in shared memory by cp.async, rows padded by 16 bytes so that the 8 rows
// an ldmatrix reads fall in 8 different bank groups, and rows past Sq or Sk
// are zero-filled (the mask gives them p = 0).  The streamed tiles (Q and dO
// in dkdv, K and V in dq) are double-buffered: the next tile's copies are in
// flight while the warps compute on this one.  A score tile stays in
// registers: its accumulator fragment is the A fragment of the next product
// (P^T or dS^T, packed to bf16 pairs), so P never goes through shared memory.
// dS, a float32 value, is rounded to bfloat16 to enter the tensor cores (the
// plain version keeps it in float32), and the dV operand bf16(p) / l is
// rounded once more, to bfloat16.  Query tiles of 64 rows at D <= 64 and 32
// from D = 128 keep the score tiles and the two 16 x D accumulators within a
// thread's registers (dkdv); key tiles of 64 (32 at D = 256) do the same for
// dq (Tiles<D>).
//
// float32 (namespace simt), for the smoke models and the tests: float32 FMAs
// on the CUDA cores (tensor cores in TF32 would round the inputs).  32-key by
// 32-query tiles in shared memory; in dkdv a thread owns 2 keys x D / 16
// columns of dK and dV, in dq 2 rows x D / 16 columns of dQ.
//
// The shared-memory limit of each kernel is raised once per device, not per
// launch.

#include <atomic>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// whether query qi sees key kj
__device__ __forceinline__ bool live(int qi, int kj, int Sq, int Sk,
                                     int causal, int window) {
  return qi < Sq && kj < Sk && (!causal || kj <= qi) &&
         (window <= 0 || kj > qi - window);
}

// [lo, hi): the query tiles of BQ rows that see a key of [k0, k0 + BK)
__device__ __forceinline__ void query_tiles(int k0, int BK, int BQ, int Sq,
                                            int causal, int window, int& lo,
                                            int& hi) {
  lo = causal ? k0 / BQ : 0;
  int last = Sq - 1;
  if (window > 0) last = min(last, k0 + BK - 1 + window - 1);
  hi = last / BQ + 1;
}

// [lo, hi): the key tiles of BK keys that a query of [q0, q0 + BQ) sees
__device__ __forceinline__ void key_tiles(int q0, int BQ, int BK, int Sk,
                                          int causal, int window, int& lo,
                                          int& hi) {
  lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  int last = Sk - 1;
  if (causal) last = min(last, q0 + BQ - 1);
  hi = last / BK + 1;
}

// delta[row] = sum_d dO o (float32) and qs[row] = q * scale rounded to T, for
// the rows B H Sq rows: a warp a row, 8 rows a block
template <typename T, int D>
__global__ void __launch_bounds__(256)
attn_bwd_prep(const T* __restrict__ q, const T* __restrict__ o,
              const T* __restrict__ dout, T* __restrict__ qs,
              float* __restrict__ delta, float scale, int rows) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;                     // the whole warp
  const float sc = round_to<T>(scale);
  const size_t at = static_cast<size_t>(row) * D;
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    const size_t j = at + lane + 32 * i;
    a = fmaf(to_f(dout[j]), to_f(o[j]), a);
    qs[j] = from_f<T>(to_f(q[j]) * sc);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) a += __shfl_xor_sync(0xffffffffu, a, m);
  if (lane == 0) delta[row] = a;
}

template <typename T, int D>
int launch_prep(const void* q, const void* o, const void* dout, void* qs,
                float* delta, float scale, int rows, cudaStream_t stream) {
  attn_bwd_prep<T, D><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<T*>(qs), delta, scale, rows);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ float32: CUDA cores -----
namespace simt {

constexpr int kB = 32;           // keys and queries a tile
constexpr int kThreads = 256;    // 16 x 16: ty = 2 rows, tx = 2 columns
constexpr int kPS = kB + 1;      // padded row stride of the P and dS tiles

template <int D>
constexpr size_t smem_dkdv() {
  return sizeof(float) * (4 * kB * (D + 1) + 2 * kB * kPS + 3 * kB);
}
template <int D>
constexpr size_t smem_dq() {
  return sizeof(float) * (4 * kB * (D + 1) + kB * kPS);
}

// rows r0 .. r0 + kB - 1 of a (S, D) matrix at src into dst (rows of D + 1),
// rows past S as zeros
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int S, int tid) {
  for (int i = tid; i < kB * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] =
        r0 + r < S ? src[static_cast<size_t>(r0 + r) * D + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv(const float* __restrict__ qs, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ stats,
              const float* __restrict__ delta, float* __restrict__ dk,
              float* __restrict__ dv, int H, int Hkv, int Sq, int Sk,
              int causal, int window) {
  constexpr int QS = D + 1, NC = D / 16;
  extern __shared__ float smem_f[];
  float* Ks = smem_f;                // [kB][QS]
  float* Vs = Ks + kB * QS;
  float* Qs = Vs + kB * QS;        // q * scale
  float* Os = Qs + kB * QS;        // dO
  float* Ps = Os + kB * QS;        // [kB keys][kPS]: p / l
  float* Ds = Ps + kB * kPS;       // dS
  float* St = Ds + kB * kPS;       // m, l, delta of the tile's rows

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int kt = gridDim.x - 1 - blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv, k0 = kt * kB;
  const size_t kv0 = static_cast<size_t>(b * Hkv + hk) * Sk;
  const size_t n_rows = static_cast<size_t>(gridDim.z) * H * Sq;
  load_rows<D>(Ks, k + kv0 * D, k0, Sk, tid);
  load_rows<D>(Vs, v + kv0 * D, k0, Sk, tid);
  int qlo, qhi;
  query_tiles(k0, kB, kB, Sq, causal, window, qlo, qhi);

  float dka[2][NC], dva[2][NC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const size_t row0 = static_cast<size_t>(b * H + hk * G + g) * Sq;
    for (int qt = qlo; qt < qhi; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();           // the previous tile's reads are done
      load_rows<D>(Qs, qs + row0 * D, q0, Sq, tid);
      load_rows<D>(Os, dout + row0 * D, q0, Sq, tid);
      for (int i = tid; i < 3 * kB; i += kThreads) {
        const int a = i / kB, r = q0 + i % kB;
        const float* src = a == 0 ? stats : a == 1 ? stats + n_rows : delta;
        St[i] = r < Sq ? src[row0 + r] : 0.f;
      }
      __syncthreads();

      float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      float dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float ka[2], va[2], qb[2], ob[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          ka[i] = Ks[(2 * ty + i) * QS + d];
          va[i] = Vs[(2 * ty + i) * QS + d];
          qb[i] = Qs[(2 * tx + i) * QS + d];
          ob[i] = Os[(2 * tx + i) * QS + d];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            s[i][j] = fmaf(ka[i], qb[j], s[i][j]);
            dp[i][j] = fmaf(va[i], ob[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kr = 2 * ty + i, qr = 2 * tx + j;
          const bool ok = live(q0 + qr, k0 + kr, Sq, Sk, causal, window);
          const float p = ok ? expf(s[i][j] - St[qr]) : 0.f;
          const float il = 1.f / fmaxf(St[kB + qr], 1e-30f);
          const float P = p * il;
          Ps[kr * kPS + qr] = P;
          Ds[kr * kPS + qr] = P * (dp[i][j] - St[2 * kB + qr]);
        }
      __syncthreads();
#pragma unroll 4
      for (int qq = 0; qq < kB; ++qq) {
        float p[2], ds[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          p[i] = Ps[(2 * ty + i) * kPS + qq];
          ds[i] = Ds[(2 * ty + i) * kPS + qq];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float o = Os[qq * QS + tx + 16 * c];
          const float x = Qs[qq * QS + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            dva[i][c] = fmaf(p[i], o, dva[i][c]);
            dka[i][c] = fmaf(ds[i], x, dka[i][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = k0 + 2 * ty + i;
    if (kj >= Sk) continue;
    const size_t at = (kv0 + kj) * D + tx;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[at + 16 * c] = dka[i][c];
      dv[at + 16 * c] = dva[i][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq(const float* __restrict__ qs, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ stats, const float* __restrict__ delta,
            float* __restrict__ dq, int H, int Hkv, int Sq, int Sk,
            float scale, int causal, int window) {
  constexpr int QS = D + 1, NC = D / 16;
  extern __shared__ float smem_f[];
  float* Qs = smem_f;                // [kB][QS], q * scale
  float* Os = Qs + kB * QS;        // dO
  float* Ks = Os + kB * QS;
  float* Vs = Ks + kB * QS;
  float* Ds = Vs + kB * QS;        // [kB rows][kPS]: dS

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv), q0 = qt * kB;
  const size_t row0 = static_cast<size_t>(b * H + h) * Sq;
  const size_t kv0 = static_cast<size_t>(b * Hkv + hk) * Sk;
  const size_t n_rows = static_cast<size_t>(gridDim.z) * H * Sq;
  load_rows<D>(Qs, qs + row0 * D, q0, Sq, tid);
  load_rows<D>(Os, dout + row0 * D, q0, Sq, tid);
  float m[2], il[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + 2 * ty + i;
    m[i] = r < Sq ? stats[row0 + r] : 0.f;
    il[i] = r < Sq ? 1.f / fmaxf(stats[n_rows + row0 + r], 1e-30f) : 0.f;
    dl[i] = r < Sq ? delta[row0 + r] : 0.f;
  }
  int klo, khi;
  key_tiles(q0, kB, kB, Sk, causal, window, klo, khi);

  float acc[2][NC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int kt = klo; kt < khi; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();             // the previous tile's reads are done
    load_rows<D>(Ks, k + kv0 * D, k0, Sk, tid);
    load_rows<D>(Vs, v + kv0 * D, k0, Sk, tid);
    __syncthreads();
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[2], oa[2], kb[2], vb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        qa[i] = Qs[(2 * ty + i) * QS + d];
        oa[i] = Os[(2 * ty + i) * QS + d];
        kb[i] = Ks[(2 * tx + i) * QS + d];
        vb[i] = Vs[(2 * tx + i) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qr = 2 * ty + i, kr = 2 * tx + j;
        const bool ok = live(q0 + qr, k0 + kr, Sq, Sk, causal, window);
        const float p = ok ? expf(s[i][j] - m[i]) : 0.f;
        const float P = p * il[i];
        Ds[qr * kPS + kr] = P * (dp[i][j] - dl[i]);
      }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kB; ++kk) {
      float ds[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) ds[i] = Ds[(2 * ty + i) * kPS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float x = Ks[kk * QS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 2; ++i) acc[i][c] = fmaf(ds[i], x, acc[i][c]);
      }
    }
  }
  const float sc = round_to<float>(scale);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + 2 * ty + i;
    if (qi >= Sq) continue;
    const size_t at = (row0 + qi) * D + tx;
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[at + 16 * c] = acc[i][c] * sc;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* stats, void* dq, void* dk, void* dv,
           float* delta, void* qs, int B, int H, int Hkv, int Sq, int Sk,
           float scale, int causal, int window, cudaStream_t stream) {
  int err = launch_prep<float, D>(q, o, dout, qs, delta, scale, B * H * Sq,
                                  stream);
  if (err != 0) return err;
  const float* qsf = static_cast<const float*>(qs);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(dout);
  {
    auto kern = attn_bwd_dq<D>;
    constexpr size_t bytes = smem_dq<D>();
    static std::atomic<uint32_t> ready{0};
    cudaError_t e = allow_smem(kern, static_cast<int>(bytes), ready);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<dim3((Sq + kB - 1) / kB, H, B), kThreads, bytes, stream>>>(
        qsf, kf, vf, of, stats, delta, static_cast<float*>(dq), H, Hkv, Sq,
        Sk, scale, causal, window);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  auto kern = attn_bwd_dkdv<D>;
  constexpr size_t bytes = smem_dkdv<D>();
  static std::atomic<uint32_t> ready{0};
  cudaError_t e = allow_smem(kern, static_cast<int>(bytes), ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3((Sk + kB - 1) / kB, Hkv, B), kThreads, bytes, stream>>>(
      qsf, kf, vf, of, stats, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), H, Hkv, Sq, Sk, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ------------------------------------------------ bfloat16: tensor cores --
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;    // four warps, 16 output rows each
constexpr int kBK = 64;          // dkdv: keys a block
constexpr int kBQd = 64;         // dq: query rows a block

// Tile sizes by head size D (see the note at the top of the file)
template <int D>
struct Tiles {
  static constexpr int kBQ = D <= 64 ? 64 : 32;     // dkdv: queries a step
  static constexpr int kDC = D <= 128 ? D : 128;    // dkdv: columns a pass
  static constexpr int kBKd = D <= 128 ? 64 : 32;   // dq: keys a step
  static constexpr int kRS = D + 8;                 // padded row, elements
  static constexpr int kDkdvSmem =
      2 * (2 * kBK * kRS + 4 * kBQ * kRS) + 4 * 2 * 3 * kBQ;
  static constexpr int kDqSmem = 2 * (2 * kBQd * kRS + 4 * kBKd * kRS);
};

// 16 bytes from global to shared memory, asynchronously; bytes = 0 writes
// 16 zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; .trans delivers each transposed
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, "
               "%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += A B, A 16 x 16 (row), B 16 x 8 (col), bf16 in, float32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows r0 .. r0 + R - 1 of a (S, D) matrix at src into shared memory at dst
// (rows of kRS elements), by cp.async; rows past S are zero-filled
template <int D, int R>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src,
                                          int r0, int S, int tid) {
  constexpr int CH = D / 8, RS = Tiles<D>::kRS;
  for (int i = tid; i < R * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < S;
    cp_async16(dst + (r * RS + c * 8) * 2,
               src + static_cast<size_t>(ok ? r0 + r : r0) * D + c * 8,
               ok ? 16 : 0);
  }
}

// The 16 x 16 A fragment (rows of 16 from a, columns from k0) of a
// shared-memory matrix of kRS-element rows at a: lane l reads row l % 16,
// columns k0 + 8 (l / 16)
template <int D>
__device__ __forceinline__ uint32_t a_addr(uint32_t a, int lane) {
  return a + ((lane % 16) * Tiles<D>::kRS + 8 * (lane / 16)) * 2;
}
// the B fragments of two n-tiles (n, n + 8) at one k-step from a matrix
// stored [n][k] (ldsm): lane l reads row n0 + l % 8 + 8 (l / 16), column
// k0 + 8 ((l / 8) % 2)
template <int D>
__device__ __forceinline__ uint32_t b_addr(uint32_t b, int lane) {
  return b + (((lane % 8) + 8 * (lane / 16)) * Tiles<D>::kRS +
              8 * ((lane / 8) % 2)) * 2;
}
// ... and from a matrix stored [k][n] (ldsm_t): lane l reads row k0 + l %
// 16, column n0 + 8 (l / 16), the same addresses as a_addr
template <int D>
__device__ __forceinline__ uint32_t bt_addr(uint32_t b, int lane) {
  return a_addr<D>(b, lane);
}

// Q (as qs) and dO rows q0 .. q0 + BQ - 1 of one head, and their m, l and
// delta, into one stage of the dkdv kernel's ring
template <int D>
__device__ __forceinline__ void load_query_tile(
    uint32_t qdst, uint32_t odst, uint32_t sdst, const bf16* qs,
    const bf16* dout, const float* stats, const float* delta, size_t row0,
    size_t n_rows, int q0, int Sq, int tid) {
  constexpr int BQ = Tiles<D>::kBQ;
  load_rows<D, BQ>(qdst, qs + row0 * D, q0, Sq, tid);
  load_rows<D, BQ>(odst, dout + row0 * D, q0, Sq, tid);
  for (int i = tid; i < 3 * BQ; i += kThreads) {
    const int a = i / BQ, r = q0 + i % BQ;
    const float* src = a == 0 ? stats : a == 1 ? stats + n_rows : delta;
    cp_async4(sdst + 4 * i, src + row0 + (r < Sq ? r : q0), r < Sq ? 4 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv(const bf16* __restrict__ qs, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ stats,
              const float* __restrict__ delta, bf16* __restrict__ dk,
              bf16* __restrict__ dv, int H, int Hkv, int Sq, int Sk,
              int causal, int window) {
  using T = Tiles<D>;
  constexpr int BQ = T::kBQ, DC = T::kDC, RS = T::kRS;
  constexpr int NQ = BQ / 8, NC = DC / 8;
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_b);       // [kBK][RS]
  bf16* Vs = Ks + kBK * RS;
  bf16* Qr = Vs + kBK * RS;                        // [2][BQ][RS], qs
  bf16* Or = Qr + 2 * BQ * RS;                     // [2][BQ][RS], dO
  float* Sr = reinterpret_cast<float*>(Or + 2 * BQ * RS);  // [2][3][BQ]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kt = gridDim.x - 1 - blockIdx.x;      // heaviest first (causal)
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv, k0 = kt * kBK;
  const size_t kv0 = static_cast<size_t>(b * Hkv + hk) * Sk;
  const size_t n_rows = static_cast<size_t>(gridDim.z) * H * Sq;
  int qlo, qhi;
  query_tiles(k0, kBK, BQ, Sq, causal, window, qlo, qhi);
  const int nq = max(0, qhi - qlo), n_it = G * nq;

  load_rows<D, kBK>(smem_u32(Ks), k + kv0 * D, k0, Sk, tid);
  load_rows<D, kBK>(smem_u32(Vs), v + kv0 * D, k0, Sk, tid);

  // this warp's 16 keys: rows 16 warp + lane / 4 (+ 8) of the accumulators
  const uint32_t ka = a_addr<D>(smem_u32(Ks + 16 * warp * RS), lane);
  const uint32_t va = a_addr<D>(smem_u32(Vs + 16 * warp * RS), lane);
  const int kw = k0 + 16 * warp + lane / 4;

  float dka[NC][4], dva[NC][4];
#pragma unroll 1
  for (int dc0 = 0; dc0 < D; dc0 += DC) {
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
    auto stage_load = [&](int it, int st) {
      const int g = it / nq, q0 = (qlo + it % nq) * BQ;
      load_query_tile<D>(smem_u32(Qr + st * BQ * RS),
                         smem_u32(Or + st * BQ * RS),
                         smem_u32(Sr + st * 3 * BQ), qs, dout, stats, delta,
                         static_cast<size_t>(b * H + hk * G + g) * Sq,
                         n_rows, q0, Sq, tid);
    };
    if (n_it > 0) stage_load(0, 0);
    cp_commit();
    for (int it = 0; it < n_it; ++it) {
      const int st = it & 1;
      if (it + 1 < n_it) stage_load(it + 1, st ^ 1);
      cp_commit();
      cp_wait<1>();              // this step's tile (and K, V) are in
      __syncthreads();
      const int q0 = (qlo + it % nq) * BQ;
      const uint32_t qsm = smem_u32(Qr + st * BQ * RS);
      const uint32_t osm = smem_u32(Or + st * BQ * RS);
      const float* srow = Sr + st * 3 * BQ;

      // S^T = K qs^T and dP^T = V dO^T: this warp's 16 keys x BQ queries
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        ldsm(ak, ka + kk * 32);
        ldsm(av, va + kk * 32);
#pragma unroll
        for (int j2 = 0; j2 < BQ / 16; ++j2) {
          uint32_t bq[4], bo[4];
          const uint32_t off = (16 * j2 * RS + 16 * kk) * 2;
          ldsm(bq, b_addr<D>(qsm, lane) + off);
          ldsm(bo, b_addr<D>(osm, lane) + off);
          mma(s[2 * j2], ak, bq[0], bq[1]);
          mma(s[2 * j2 + 1], ak, bq[2], bq[3]);
          mma(dp[2 * j2], av, bo[0], bo[1]);
          mma(dp[2 * j2 + 1], av, bo[2], bo[3]);
        }
      }
      // s <- bf16(p) / l (dV's operand), dp <- dS; entry e of n-tile j is
      // key kw + 8 (e / 2), query q0 + 8 j + 2 (lane % 4) + e % 2
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qr = 8 * j + 2 * (lane % 4) + c;
          const float ml = srow[qr] * kLog2e;
          const float il = 1.f / fmaxf(srow[BQ + qr], 1e-30f);
          const float dl = srow[2 * BQ + qr];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + c;
            const float p =
                live(q0 + qr, kw + 8 * r, Sq, Sk, causal, window)
                    ? exp2_approx(fmaf(s[j][e], kLog2e, -ml))
                    : 0.f;
            const float P = p * il;
            s[j][e] = round_to<bf16>(p) * il;
            dp[j][e] = P * (dp[j][e] - dl);
          }
        }
      // the accumulator fragments of n-tiles 2 kk, 2 kk + 1 are the A
      // fragment of k-step kk (16 queries)
      uint32_t ap[BQ / 16][4], as[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        ap[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        ap[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        ap[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        ap[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        as[kk][0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
        as[kk][1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
        as[kk][2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        as[kk][3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
      }
      // dV += P^T dO, dK += dS^T qs over columns dc0 .. dc0 + DC - 1
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int n2 = 0; n2 < DC / 16; ++n2) {
          uint32_t bt[4];
          const uint32_t off = (16 * kk * RS + dc0 + 16 * n2) * 2;
          ldsm_t(bt, bt_addr<D>(osm, lane) + off);
          mma(dva[2 * n2], ap[kk], bt[0], bt[1]);
          mma(dva[2 * n2 + 1], ap[kk], bt[2], bt[3]);
          ldsm_t(bt, bt_addr<D>(qsm, lane) + off);
          mma(dka[2 * n2], as[kk], bt[0], bt[1]);
          mma(dka[2 * n2 + 1], as[kk], bt[2], bt[3]);
        }
      __syncthreads();           // this stage is read before it is refilled
    }
    cp_wait<0>();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kj = kw + 8 * r;
      if (kj >= Sk) continue;
      const size_t at = (kv0 + kj) * D + dc0 + 2 * (lane % 4);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * n) =
            __floats2bfloat162_rn(dka[n][2 * r], dka[n][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * n) =
            __floats2bfloat162_rn(dva[n][2 * r], dva[n][2 * r + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq(const bf16* __restrict__ qs, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ stats, const float* __restrict__ delta,
            bf16* __restrict__ dq, int H, int Hkv, int Sq, int Sk,
            float scale, int causal, int window) {
  using T = Tiles<D>;
  constexpr int BK = T::kBKd, RS = T::kRS;
  constexpr int NK = BK / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_b);       // [kBQd][RS], qs
  bf16* Os = Qs + kBQd * RS;                       // dO
  bf16* Kr = Os + kBQd * RS;                       // [2][BK][RS]
  bf16* Vr = Kr + 2 * BK * RS;                     // [2][BK][RS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qt = gridDim.x - 1 - blockIdx.x;      // heaviest first (causal)
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv), q0 = qt * kBQd;
  const size_t row0 = static_cast<size_t>(b * H + h) * Sq;
  const size_t kv0 = static_cast<size_t>(b * Hkv + hk) * Sk;
  const size_t n_rows = static_cast<size_t>(gridDim.z) * H * Sq;
  int klo, khi;
  key_tiles(q0, kBQd, BK, Sk, causal, window, klo, khi);
  const int n = max(0, khi - klo);

  load_rows<D, kBQd>(smem_u32(Qs), qs + row0 * D, q0, Sq, tid);
  load_rows<D, kBQd>(smem_u32(Os), dout + row0 * D, q0, Sq, tid);
  auto stage_load = [&](int t, int st) {
    const int k0 = (klo + t) * BK;
    load_rows<D, BK>(smem_u32(Kr + st * BK * RS), k + kv0 * D, k0, Sk, tid);
    load_rows<D, BK>(smem_u32(Vr + st * BK * RS), v + kv0 * D, k0, Sk, tid);
  };
  if (n > 0) stage_load(0, 0);
  cp_commit();

  // this thread's rows: qw and qw + 8
  const int qw = q0 + 16 * warp + lane / 4;
  float ml[2], il[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = qw + 8 * r < Sq;
    const size_t at = row0 + (ok ? qw + 8 * r : 0);
    ml[r] = ok ? stats[at] * kLog2e : 0.f;
    il[r] = ok ? 1.f / fmaxf(stats[n_rows + at], 1e-30f) : 0.f;
    dl[r] = ok ? delta[at] : 0.f;
  }
  const uint32_t qa = a_addr<D>(smem_u32(Qs + 16 * warp * RS), lane);
  const uint32_t oa = a_addr<D>(smem_u32(Os + 16 * warp * RS), lane);

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < n; ++t) {
    const int st = t & 1;
    if (t + 1 < n) stage_load(t + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();                // this step's K and V (and Q, dO) are in
    __syncthreads();
    const int k0 = (klo + t) * BK;
    const uint32_t ksm = smem_u32(Kr + st * BK * RS);
    const uint32_t vsm = smem_u32(Vr + st * BK * RS);

    // S = qs K^T and dP = dO V^T: this warp's 16 rows x BK keys
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      ldsm(aq, qa + kk * 32);
      ldsm(ao, oa + kk * 32);
#pragma unroll
      for (int j2 = 0; j2 < BK / 16; ++j2) {
        uint32_t bk[4], bv[4];
        const uint32_t off = (16 * j2 * RS + 16 * kk) * 2;
        ldsm(bk, b_addr<D>(ksm, lane) + off);
        ldsm(bv, b_addr<D>(vsm, lane) + off);
        mma(s[2 * j2], aq, bk[0], bk[1]);
        mma(s[2 * j2 + 1], aq, bk[2], bk[3]);
        mma(dp[2 * j2], ao, bv[0], bv[1]);
        mma(dp[2 * j2 + 1], ao, bv[2], bv[3]);
      }
    }
    // dS; entry e of n-tile j is row qw + 8 (e / 2), key k0 + 8 j + 2
    // (lane % 4) + e % 2
    uint32_t as[BK / 16][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const int kj = k0 + 8 * j + 2 * (lane % 4) + e % 2;
        const float p = live(qw + 8 * r, kj, Sq, Sk, causal, window)
                            ? exp2_approx(fmaf(s[j][e], kLog2e, -ml[r]))
                            : 0.f;
        const float P = p * il[r];
        dp[j][e] = P * (dp[j][e] - dl[r]);
      }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      as[kk][0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      as[kk][1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      as[kk][2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      as[kk][3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
    }
    // dQ += dS K (K as B, stored [key][d])
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t bt[4];
        ldsm_t(bt, bt_addr<D>(ksm, lane) + (16 * kk * RS + 16 * n2) * 2);
        mma(acc[2 * n2], as[kk], bt[0], bt[1]);
        mma(acc[2 * n2 + 1], as[kk], bt[2], bt[3]);
      }
    __syncthreads();             // this stage is read before it is refilled
  }
  cp_wait<0>();
  const float sc = round_to<bf16>(scale);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qw + 8 * r;
    if (qi >= Sq) continue;
    bf16* row = dq + (row0 + qi) * D + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = __floats2bfloat162_rn(
          acc[j][2 * r] * sc, acc[j][2 * r + 1] * sc);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* stats, void* dq, void* dk, void* dv,
           float* delta, void* qs, int B, int H, int Hkv, int Sq, int Sk,
           float scale, int causal, int window, cudaStream_t stream) {
  using T = Tiles<D>;
  int err = launch_prep<bf16, D>(q, o, dout, qs, delta, scale, B * H * Sq,
                                 stream);
  if (err != 0) return err;
  const bf16* qsb = static_cast<const bf16*>(qs);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(dout);
  {
    auto kern = attn_bwd_dq<D>;
    static std::atomic<uint32_t> ready{0};
    cudaError_t e = allow_smem(kern, T::kDqSmem, ready);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<dim3((Sq + kBQd - 1) / kBQd, H, B), kThreads, T::kDqSmem,
           stream>>>(qsb, kb, vb, ob, stats, delta, static_cast<bf16*>(dq), H,
                     Hkv, Sq, Sk, scale, causal, window);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  auto kern = attn_bwd_dkdv<D>;
  static std::atomic<uint32_t> ready{0};
  cudaError_t e = allow_smem(kern, T::kDkdvSmem, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3((Sk + kBK - 1) / kBK, Hkv, B), kThreads, T::kDkdvSmem,
         stream>>>(qsb, kb, vb, ob, stats, delta, static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), H, Hkv, Sq, Sk, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <int D>
int launch_d(int dtype, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const float* stats, void* dq,
             void* dk, void* dv, float* delta, void* qs, int B, int H,
             int Hkv, int Sq, int Sk, float scale, int causal, int window,
             cudaStream_t stream) {
  if (dtype == 0)
    return simt::launch<D>(q, k, v, o, dout, stats, dq, dk, dv, delta, qs, B,
                           H, Hkv, Sq, Sk, scale, causal, window, stream);
  if (dtype == 1)
    return tc::launch<D>(q, k, v, o, dout, stats, dq, dk, dv, delta, qs, B, H,
                         Hkv, Sq, Sk, scale, causal, window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launches K4's backward on `stream` (a cudaStream_t): q, o, dO (B, H, Sq, D),
// k, v (B, Hkv, Sk, D), stats the forward's (2, B, H, Sq) m and l ->
// dq, dk, dv in the inputs' type; delta (B, H, Sq) float32 and qs (q's shape
// and type) are scratch the caller allocates.  dtype 0 = float32 (CUDA
// cores), 1 = bfloat16 (tensor cores; every tensor 16-byte aligned); D in
// {32, 64, 128, 256}; window <= 0 means no window; Sq != Sk only with neither
// the causal mask nor a window.  Returns a cudaError_t: the attribute
// call's, cudaErrorInvalidValue for arguments it does not take, or
// cudaGetLastError() after each launch.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const float* stats, void* dq, void* dk,
                              void* dv, float* delta, void* qs, int dtype,
                              int B, int H, int Hkv, int Sq, int Sk, int D,
                              float scale, int causal, int window,
                              void* stream) {
  if (B <= 0 || Sq <= 0) return static_cast<int>(cudaSuccess);
  if (Hkv <= 0 || H % Hkv != 0 || Sk <= 0 ||
      (Sq != Sk && (causal || window > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_d<32>(dtype, q, k, v, o, dout, stats, dq, dk, dv, delta,
                          qs, B, H, Hkv, Sq, Sk, scale, causal, window, st);
    case 64:
      return launch_d<64>(dtype, q, k, v, o, dout, stats, dq, dk, dv, delta,
                          qs, B, H, Hkv, Sq, Sk, scale, causal, window, st);
    case 128:
      return launch_d<128>(dtype, q, k, v, o, dout, stats, dq, dk, dv, delta,
                           qs, B, H, Hkv, Sq, Sk, scale, causal, window, st);
    case 256:
      return launch_d<256>(dtype, q, k, v, o, dout, stats, dq, dk, dv, delta,
                           qs, B, H, Hkv, Sq, Sk, scale, causal, window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
