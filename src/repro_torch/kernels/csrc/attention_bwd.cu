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
// dK and dV sum over the query heads of a GQA group.  No atomics, so a run
// is bit for bit repeatable:
//
//   prep   a warp a row: delta in float32, qs into a scratch of q's shape
//          (so that neither main kernel rounds q again) and, in bfloat16,
//          each row's (m log2 e, 1 / max(l, 1e-30), delta) for both;
//   dq     a block a (query tile, head, batch) walks the key tiles its rows
//          see: S, dP, then dQ += dS K, in registers;
//   dkdv   a block a (key tile, kv head, batch) walks query heads and the
//          query tiles that see a key of the tile (the forward's tile bounds
//          turned around: causal from the tile's diagonal on, a window up to
//          the last query that still sees the tile, unmasked every one of
//          the Sq rows): S^T, dP^T, then dV += P^T dO and dK += dS^T qs.
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
// bfloat16 (namespace tc): every product is a wgmma bf16 -> float32, issued by
// a block of one warpgroup (128 threads).  TMA brings the tiles into shared
// memory, 128-byte swizzled (64-byte at D = 32), through 3-D tensor maps (D,
// S, batch x head), so rows past Sq or Sk are zero-filled (the mask gives them
// p = 0); a plain bulk copy brings a query tile's row scratch. Thread 0 issues
// every load, kStages steps ahead, each stage completing on its mbarrier; a
// stage is refilled once the whole warpgroup is past the step that read it.
// The score tiles stay in registers: S^T = K qs^T and dP^T = V dO^T (dkdv; S =
// qs K^T and dP = dO V^T in dq) are wgmma's with both operands in shared
// memory (K-major), and their accumulator fragments, turned into the bf16
// pairs of bf16(p) / l and dS, are the A operands of dV += P^T dO and dK +=
// dS^T qs (dQ += dS K), wgmma's from registers with dO and qs (K) as B through
// a transposed, MN-major descriptor, as K4's forward takes P V.  A warpgroup
// owns 64 keys of dK and dV or 64 rows of dQ; a step is 64 queries (dkdv) or
// 64 keys (dq; 128 up to D = 64 at long sequences), Tiles<D>.  A step issues S
// and dP, waits for S (and with it the last step's products, which queue
// behind them on the tensor cores), turns S into P while dP runs, and dS while
// dV runs (dkdv); dkdv from D = 128 also waits for its dV and dK at the end of
// a step, its 255 registers leaving no room for the next score tiles beside
// them.  No register that feeds a wgmma in flight is written (ptxas's C7513),
// and the softmax of one block also overlaps the products of the others on its
// SM (two dkdv blocks an SM up to D = 128).  dS, a float32 value, is rounded
// to bfloat16 to enter the tensor cores (the plain version keeps it in
// float32), and the dV operand bf16(p) / l once more.
//
// A GQA group's query heads are cut into `parts` runs of consecutive heads, a
// dkdv block each, as far as the grid needs to fill the card (kernels/
// attention.py::attention_bwd_launch_params; a whole group in one block leaves
// too few blocks at the training shapes, and one heavy causal block): at
// chip_smoke.py's training shapes 2 parts at smollm-360m's, 1 at qwen3-0.6b's,
// gemma3-12b's and the vlm cross's, 3 at the smollm train_4k rank's; at the
// card tests' (two kv heads, Sq 200) a part a head.  With parts > 1 each block
// writes its float32 dK and dV to a scratch, parts x 2 x B Hkv Sk D, and
// attn_bwd_reduce adds the parts in head order and rounds once to bfloat16: a
// fixed order, so still bit for bit repeatable.  Key tile 0, the heaviest
// under the causal mask, is issued first (the key tile is the slowest grid
// index); dq issues its last, heaviest query tile first.
//
// float32 (namespace simt), for the smoke models and the tests: float32 FMAs
// on the CUDA cores (tensor cores in TF32 would round the inputs).  32-key by
// 32-query tiles in shared memory; in dkdv a thread owns 2 keys x D / 16
// columns of dK and dV, in dq 2 rows x D / 16 columns of dQ.
//
// The shared-memory limit of each kernel is raised once per device, not per
// launch.  The helpers shared with K4's forward (TMA, mbarriers, wgmma,
// tensor maps) live in attention_common.cuh.

#include <atomic>
#include <cstdint>

#include <cuda.h>
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
constexpr int kThreads = 128;    // one warpgroup
constexpr int kBK = 64;          // dkdv: keys a block (accumulator rows)
constexpr int kBQd = 64;         // dq: query rows a block
constexpr int kRowPad = 64;      // the row scratch pads Sq to a multiple

// The tiles by head size D, which the wrapper's launch parameters
// (kernels/attention.py::attention_bwd_launch_params) must name: kBQ query
// rows a dkdv step; kBKd keys a dq step, or kBKdLong where the wrapper
// chooses it for long sequences (128 at D <= 64: twice the work a step,
// where a block walks enough key tiles that the half-masked diagonal one
// costs little); dkdv keeps dK and dV kDC columns at a time (two passes at
// D = 256); kStages steps in flight, 3 up to D = 64 and 2 from D = 128 (and
// for 128-key dq steps), so that two dkdv blocks fit an SM's shared memory
// at D = 128 (99 KB each) and one at D = 256 (195 KB).
template <int D>
struct Tiles {
  static constexpr int kBQ = 64;
  static constexpr int kBKd = 64;
  static constexpr int kBKdLong = D <= 64 ? 128 : 64;
  static constexpr int kDC = D <= 128 ? D : 128;
  static constexpr int kStages = D <= 64 ? 3 : 2;
};

// Shared memory of the dkdv kernel: the block's K and V tiles, a ring of
// kStages steps of qs and dO tiles and their rows' float4 (m log2 e, 1 / l,
// delta, 0), then the barriers (K and V, then one a stage)
template <int D>
struct DkdvSmem {
  using T = Tiles<D>;
  static constexpr int kKV = kBK * D * 2;            // one K or V tile
  static constexpr int kQ = T::kBQ * D * 2;          // one qs or dO tile
  static constexpr int kRows = T::kBQ * 16;
  static constexpr int kK = 0, kV = kKV, kRing = 2 * kKV;
  static constexpr int kRowRing = kRing + T::kStages * 2 * kQ;
  static constexpr int kBar = kRowRing + T::kStages * kRows;
  static constexpr int kBytes = kBar + 8 * (1 + T::kStages) + 1024;   // + align
};

// ... of the dq kernel with BK keys a step: the block's qs and dO rows, a
// ring of kStages steps of K and V tiles, then the barriers (qs and dO,
// then one a stage)
template <int D, int BK>
struct DqSmem {
  static constexpr int kStages = BK > 64 ? 2 : Tiles<D>::kStages;
  static constexpr int kQ = kBQd * D * 2;            // qs or dO
  static constexpr int kKV = BK * D * 2;             // one K or V tile
  static constexpr int kO = kQ, kRing = 2 * kQ;
  static constexpr int kBar = kRing + kStages * 2 * kKV;
  static constexpr int kBytes = kBar + 8 * (1 + kStages) + 1024;
};

// A plain bulk copy of `bytes` (a multiple of 16) from global memory into
// shared memory at dst, completing on the barrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The R-row box at row r0 of plane n of `map` (all its atom columns) into the
// tile at dst, completing on the barrier
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int r0, int n) {
  using A = Atoms<D>;
#pragma unroll
  for (int a = 0; a < A::kNA; ++a)
    tma_load(dst + a * R * A::kSwz, map, bar, a * A::kAW, r0, n);
}

// d = A B^T over D columns, A the 64-row tile at a and B the N-row tile at b
// (both K-major): D / 16 k-steps, issued and committed; a k-step inside a
// swizzle atom advances the start address by 32 bytes
template <int D, int N>
__device__ __forceinline__ void issue_ss(float (&d)[N / 2], uint32_t a,
                                         uint32_t b) {
  using A = Atoms<D>;
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int at = kk * 16 / A::kAW, in = (kk * 16 % A::kAW) * 2;
    wgmma_ss(d,
             make_desc(a + at * 64 * A::kSwz + in, 16, 8 * A::kSwz,
                       A::kDescLayout),
             make_desc(b + at * N * A::kSwz + in, 16, 8 * A::kSwz,
                       A::kDescLayout),
             kk > 0);
  }
  wgmma_commit();
}

// d += A B, A (64 x K) from registers (a[4 kk .. 4 kk + 3] the bf16 pairs of
// k-step kk) and B (K x N) the K-row tile at b, N columns of it from b's
// atom column, through an MN-major descriptor (LBO: the next atom column,
// SBO: the next 8 rows); issued and committed
template <int D, int K, int N>
__device__ __forceinline__ void issue_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[K / 4],
                                         uint32_t b) {
  using A = Atoms<D>;
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t f[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                           a[4 * kk + 3]};
    wgmma_rs(d, f,
             make_desc(b + kk * 16 * A::kSwz, K * A::kSwz, 8 * A::kSwz,
                       A::kDescLayout),
             1);
  }
  wgmma_commit();
  fence_regs(d);
}

// delta = sum_d dO o (float32) and qs = q * scale rounded to bf16 for each of
// the B H Sq rows, and the row scratch (B H, Sqp) of float4 (m log2 e, 1 /
// max(l, 1e-30), delta, 0) that both main kernels read, zeros for the rows
// Sq .. Sqp - 1: D / 8 adjacent threads a row, 16 bytes each
template <int D>
__global__ void __launch_bounds__(256)
attn_bwd_prep(const bf16* __restrict__ q, const bf16* __restrict__ o,
              const bf16* __restrict__ dout, const float* __restrict__ stats,
              bf16* __restrict__ qs, float4* __restrict__ rows, float scale,
              int Sq, int Sqp, int nbh) {
  constexpr int TR = D / 8;                    // threads a row
  const int row = blockIdx.x * (256 / TR) + threadIdx.x / TR;
  const int part = threadIdx.x % TR;
  if (row >= nbh * Sqp) return;                // the row's lanes alike
  const int bh = row / Sqp, r = row % Sqp;
  if (r >= Sq) {
    if (part == 0) rows[row] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const float sc = round_to<bf16>(scale);
  const size_t sr = static_cast<size_t>(bh) * Sq + r, at = sr * D + 8 * part;
  const uint4 xo = *reinterpret_cast<const uint4*>(o + at);
  const uint4 xd = *reinterpret_cast<const uint4*>(dout + at);
  uint4 xq = *reinterpret_cast<const uint4*>(q + at);
  const __nv_bfloat162* ho = reinterpret_cast<const __nv_bfloat162*>(&xo);
  const __nv_bfloat162* hd = reinterpret_cast<const __nv_bfloat162*>(&xd);
  __nv_bfloat162* hq = reinterpret_cast<__nv_bfloat162*>(&xq);
  float a = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 fo = __bfloat1622float2(ho[j]), fd = __bfloat1622float2(hd[j]);
    const float2 fq = __bfloat1622float2(hq[j]);
    a = fmaf(fd.x, fo.x, a);
    a = fmaf(fd.y, fo.y, a);
    hq[j] = __floats2bfloat162_rn(fq.x * sc, fq.y * sc);
  }
  *reinterpret_cast<uint4*>(qs + at) = xq;
  // the row's TR lanes alone: the other rows of the warp may have returned
  const unsigned lanes =
      TR == 32 ? 0xffffffffu
               : ((1u << TR) - 1) << (threadIdx.x % 32 / TR * TR);
#pragma unroll
  for (int m = TR / 2; m > 0; m >>= 1) a += __shfl_xor_sync(lanes, a, m);
  if (part == 0) {
    const float l = stats[static_cast<size_t>(nbh) * Sq + sr];
    rows[row] = make_float4(stats[sr] * kLog2e, 1.f / fmaxf(l, 1e-30f), a, 0.f);
  }
}

// One dkdv step's P from this thread's entries of the 64 x BQ tile s = S^T
// (entry e = 4 j + 2 r + c is key kw + 8 r, query q0 + 8 j + cq + c): P = p
// / l in place of s, and ap, the dV operand bf16(p) / l packed to bf16
// pairs (pair 2 j + r is k-step j / 2's A fragment); rows holds the tile's
// queries' (m log2 e, 1 / l, delta).  kMask masks keys past Sk, queries
// past Sq and the causal and window bounds.
template <int BQ, bool kMask>
__device__ __forceinline__ void dkdv_p(float (&s)[BQ / 2],
                                       uint32_t (&ap)[BQ / 4],
                                       const float4* rows, int kw, int q0,
                                       int cq, int Sq, int Sk, int causal,
                                       int window) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const float4 st[2] = {rows[8 * j + cq], rows[8 * j + cq + 1]};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float pv[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * r + c;
        const float p =
            !kMask || live(q0 + 8 * j + cq + c, kw + 8 * r, Sq, Sk, causal,
                           window)
                ? exp2_approx(fmaf(s[e], kLog2e, -st[c].x))
                : 0.f;
        s[e] = p * st[c].y;
        pv[c] = round_to<bf16>(p) * st[c].y;
      }
      ap[2 * j + r] = pack_bf16(pv[0], pv[1]);
    }
  }
}

// ... and its dS = P (dP - delta) from s = P and dp = dP^T, packed to bf16
// pairs as ap is
template <int BQ>
__device__ __forceinline__ void dkdv_ds(const float (&s)[BQ / 2],
                                        const float (&dp)[BQ / 2],
                                        uint32_t (&as)[BQ / 4],
                                        const float4* rows, int cq) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const float dl[2] = {rows[8 * j + cq].z, rows[8 * j + cq + 1].z};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = 4 * j + 2 * r;
      as[2 * j + r] = pack_bf16(s[e] * (dp[e] - dl[0]),
                                s[e + 1] * (dp[e + 1] - dl[1]));
    }
  }
}

// One dq step's P = p / l in place of this thread's entries of the 64 x BK
// tile s = S (rows qw, qw + 8; keys k0 + 8 j + cq + {0, 1}); ml, il: its
// rows' m log2 e and 1 / l; kMask as dkdv_p's
template <int BK, bool kMask>
__device__ __forceinline__ void dq_p(float (&s)[BK / 2], const float (&ml)[2],
                                     const float (&il)[2], int qw, int k0,
                                     int cq, int Sq, int Sk, int causal,
                                     int window) {
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const int r = (e >> 1) & 1;
    const float p =
        !kMask || live(qw + 8 * r, k0 + 8 * (e >> 2) + cq + (e & 1), Sq, Sk,
                       causal, window)
            ? exp2_approx(fmaf(s[e], kLog2e, -ml[r]))
            : 0.f;
    s[e] = p * il[r];
  }
}

// ... and its dS = P (dP - delta) from s = P and dp = dP, packed to bf16
// pairs as dkdv_p packs them; dl: its rows' delta
template <int BK>
__device__ __forceinline__ void dq_ds(const float (&s)[BK / 2],
                                      const float (&dp)[BK / 2],
                                      uint32_t (&as)[BK / 4],
                                      const float (&dl)[2]) {
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) {
    const float d = dl[i & 1];
    as[i] = pack_bf16(s[2 * i] * (dp[2 * i] - d),
                      s[2 * i + 1] * (dp[2 * i + 1] - d));
  }
}

// dK and dV of one 64-key tile: a block a (part of a GQA group, kv head,
// batch) x key tile, the parts' blocks of one (kv head, batch) adjacent.
// It walks the part's query heads and, for each, the query tiles that see a
// key of the tile: S^T and dP^T (shared x shared), then dV += P^T dO and dK
// += dS^T qs (registers x shared); D / DC passes over the same steps.  With
// one part it rounds dK and dV to bf16; with more it writes its float32
// sums to part (parts, 2, B Hkv Sk D) for attn_bwd_reduce.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkdv(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const float4* __restrict__ rows, bf16* __restrict__ dk,
              bf16* __restrict__ dv, float* __restrict__ part, int H,
              int Hkv, int Sq, int Sqp, int Sk, int parts, int causal,
              int window) {
  using T = Tiles<D>;
  using L = DkdvSmem<D>;
  using A = Atoms<D>;
  constexpr int BQ = T::kBQ, DC = T::kDC, NS = T::kStages;
  // whether a step waits for its dV and dK before the next step's S^T and
  // dP^T are issued: their accumulators beside the pairs that feed them and
  // the next score tiles would pass a thread's 255 registers
  constexpr bool kDrain = DC > 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms: 1024 B
  const float4* srows =
      reinterpret_cast<const float4*>(smem_raw + (base - raw) + L::kRowRing);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = H / Hkv;
  const int pi = blockIdx.x % parts, bkv = blockIdx.x / parts;  // b Hkv + hk
  const int k0 = blockIdx.y * kBK;     // tile 0 first: heaviest (causal)
  const int g0 = pi * G / parts, g1 = (pi + 1) * G / parts;
  const int bh0 = (bkv / Hkv) * H + (bkv % Hkv) * G + g0;
  int qlo, qhi;
  query_tiles(k0, kBK, BQ, Sq, causal, window, qlo, qhi);
  const int nq = max(0, qhi - qlo), n = (g1 - g0) * nq;
  const int n_all = (D / DC) * n;            // steps over every pass
  const uint32_t bar_kv = base + L::kBar;    // then one "full" a stage
  // step u: head bh0 + (u % n) / nq, query tile qlo + u % nq, in stage u % NS
  auto load_step = [&](int u) {
    const int t = u % n, st = u % NS;
    const int bh = bh0 + t / nq, q0 = (qlo + t % nq) * BQ;
    const uint32_t bar = bar_kv + 8 * (1 + st);
    const uint32_t q = base + L::kRing + st * 2 * L::kQ;
    mbar_expect_tx(bar, 2 * L::kQ + L::kRows);
    load_tile<D, BQ>(q, &tq, bar, q0, bh);
    load_tile<D, BQ>(q + L::kQ, &tdo, bar, q0, bh);
    bulk_load(base + L::kRowRing + st * L::kRows,
              rows + static_cast<size_t>(bh) * Sqp + q0, L::kRows, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + NS; ++i) mbar_init(bar_kv + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * L::kKV);
    load_tile<D, kBK>(base + L::kK, &tk, bar_kv, k0, bkv);
    load_tile<D, kBK>(base + L::kV, &tv, bar_kv, k0, bkv);
    for (int u = 0; u < NS && u < n_all; ++u) load_step(u);
  }

  // this thread's keys kw, kw + 8 (accumulator rows) and queries cq, cq + 1
  // of every 8 (columns)
  const int kw = k0 + 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const size_t n_el = static_cast<size_t>(gridDim.x / parts) * Sk * D;
  float dka[DC / 2], dva[DC / 2];
  mbar_wait(bar_kv, 0);
#pragma unroll 1
  for (int dc0 = 0, u = 0; dc0 < D; dc0 += DC) {
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) dka[i] = dva[i] = 0.f;
    for (int t = 0; t < n; ++t, ++u) {
      const int st = u % NS, q0 = (qlo + t % nq) * BQ;
      const uint32_t qsm = base + L::kRing + st * 2 * L::kQ, osm = qsm + L::kQ;
      float s[BQ / 2], dp[BQ / 2];
      uint32_t ap[BQ / 4], as[BQ / 4];
      mbar_wait(bar_kv + 8 * (1 + st), (u / NS) & 1);
      issue_ss<D, BQ>(s, base + L::kK, qsm);
      issue_ss<D, BQ>(dp, base + L::kV, osm);
      wgmma_wait<1>();           // S^T, and the last step's dV, dK
      fence_regs(s);
      if (u > 0) {               // the last step's stage is read: refill it
        __syncthreads();
        if (tid == 0 && u - 1 + NS < n_all) load_step(u - 1 + NS);
      }
      // P while dP^T runs, dS while dV runs
      const float4* r = srows + st * BQ;
      if (k0 + kBK > Sk || q0 + BQ > Sq || (causal && k0 + kBK - 1 > q0) ||
          (window > 0 && k0 <= q0 + BQ - 1 - window))
        dkdv_p<BQ, true>(s, ap, r, kw, q0, cq, Sq, Sk, causal, window);
      else
        dkdv_p<BQ, false>(s, ap, r, kw, q0, cq, Sq, Sk, causal, window);
      const uint32_t col = (dc0 / A::kAW) * BQ * A::kSwz;
      issue_rs<D, BQ, DC>(dva, ap, osm + col);
      wgmma_wait<1>();           // dP^T
      fence_regs(dp);
      dkdv_ds<BQ>(s, dp, as, r, cq);
      issue_rs<D, BQ, DC>(dka, as, qsm + col);
      if (kDrain) {
        wgmma_wait<0>();
        fence_regs(dva);
        fence_regs(dka);
      }
    }
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kj = kw + 8 * r;
      if (kj >= Sk) continue;
      const size_t at = (static_cast<size_t>(bkv) * Sk + kj) * D + dc0 + cq;
      if (parts == 1) {
#pragma unroll
        for (int j = 0; j < DC / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
              __floats2bfloat162_rn(dka[4 * j + 2 * r], dka[4 * j + 2 * r + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
              __floats2bfloat162_rn(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
        }
      } else {
        float* pk = part + 2 * pi * n_el + at;
#pragma unroll
        for (int j = 0; j < DC / 8; ++j) {
          *reinterpret_cast<float2*>(pk + 8 * j) =
              make_float2(dka[4 * j + 2 * r], dka[4 * j + 2 * r + 1]);
          *reinterpret_cast<float2*>(pk + n_el + 8 * j) =
              make_float2(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// dQ of 64 query rows of one (batch, head): it walks the key tiles its rows
// see, S and dP (shared x shared), then dQ += dS K (registers x shared, K
// through an MN-major descriptor); dQ = bf16(scale) dQ at the end
template <int D, int BK>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tdo,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const float4* __restrict__ rows, bf16* __restrict__ dq, int H,
            int Hkv, int Sq, int Sqp, int Sk, float scale, int causal,
            int window) {
  using L = DqSmem<D, BK>;
  constexpr int NS = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;                                // b H + h
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQd;      // heaviest first
  int klo, khi;
  key_tiles(q0, kBQd, BK, Sk, causal, window, klo, khi);
  const int n = max(0, khi - klo);
  const uint32_t bar_q = base + L::kBar;    // then one "full" a stage
  auto load_step = [&](int t) {
    const int st = t % NS;
    const uint32_t bar = bar_q + 8 * (1 + st);
    const uint32_t kd = base + L::kRing + st * 2 * L::kKV;
    mbar_expect_tx(bar, 2 * L::kKV);
    load_tile<D, BK>(kd, &tk, bar, (klo + t) * BK, kvh);
    load_tile<D, BK>(kd + L::kKV, &tv, bar, (klo + t) * BK, kvh);
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + NS; ++i) mbar_init(bar_q + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * L::kQ);
    load_tile<D, kBQd>(base, &tq, bar_q, q0, bh);
    load_tile<D, kBQd>(base + L::kO, &tdo, bar_q, q0, bh);
    for (int t = 0; t < NS && t < n; ++t) load_step(t);
  }

  // this thread's rows qw, qw + 8 and keys cq, cq + 1 of every 8
  const int qw = q0 + 16 * warp + lane / 4, cq = 2 * (lane % 4);
  float ml[2], il[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float4 x = rows[static_cast<size_t>(bh) * Sqp + qw + 8 * r];
    ml[r] = x.x;
    il[r] = x.y;
    dl[r] = x.z;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(bar_q, 0);
  for (int t = 0; t < n; ++t) {
    const int st = t % NS, k0 = (klo + t) * BK;
    const uint32_t ksm = base + L::kRing + st * 2 * L::kKV, vsm = ksm + L::kKV;
    float s[BK / 2], dp[BK / 2];
    uint32_t as[BK / 4];
    mbar_wait(bar_q + 8 * (1 + st), (t / NS) & 1);
    issue_ss<D, BK>(s, base, ksm);
    issue_ss<D, BK>(dp, base + L::kO, vsm);
    wgmma_wait<1>();             // S, and the last step's dQ
    fence_regs(s);
    if (t > 0) {                 // the last step's stage is read: refill it
      __syncthreads();
      if (tid == 0 && t - 1 + NS < n) load_step(t - 1 + NS);
    }
    // P while dP runs
    if (k0 + BK > Sk || q0 + kBQd > Sq || (causal && k0 + BK - 1 > q0) ||
        (window > 0 && k0 <= q0 + kBQd - 1 - window))
      dq_p<BK, true>(s, ml, il, qw, k0, cq, Sq, Sk, causal, window);
    else
      dq_p<BK, false>(s, ml, il, qw, k0, cq, Sq, Sk, causal, window);
    wgmma_wait<0>();             // dP
    fence_regs(dp);
    dq_ds<BK>(s, dp, as, dl);
    issue_rs<D, BK, D>(acc, as, ksm);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  const float sc = round_to<bf16>(scale);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qw + 8 * r;
    if (qi >= Sq) continue;
    bf16* row = dq + (static_cast<size_t>(bh) * Sq + qi) * D + cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * sc, acc[4 * j + 2 * r + 1] * sc);
  }
}

// dK and dV from the parts' float32 sums, part (parts, 2, n4 float4s): the
// parts added in order, each sum rounded once to bf16; 4 values a thread
__global__ void __launch_bounds__(256)
attn_bwd_reduce(const float4* __restrict__ part, bf16* __restrict__ dk,
                bf16* __restrict__ dv, size_t n4, int parts) {
  for (size_t i = blockIdx.x * 256ull + threadIdx.x; i < 2 * n4;
       i += static_cast<size_t>(gridDim.x) * 256) {
    float4 a = part[i];
    for (int p = 1; p < parts; ++p) {
      const float4 b = part[2 * p * n4 + i];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(
        (i < n4 ? dk + 4 * i : dv + 4 * (i - n4)));
    out[0] = __floats2bfloat162_rn(a.x, a.y);
    out[1] = __floats2bfloat162_rn(a.z, a.w);
  }
}

template <int D, int BK>
cudaError_t launch_dq(const CUtensorMap& tq, const CUtensorMap& tdo,
                      const CUtensorMap& tk, const CUtensorMap& tv,
                      const float4* rows, void* dq, int B, int H, int Hkv,
                      int Sq, int Sqp, int Sk, float scale, int causal,
                      int window, cudaStream_t stream) {
  auto kern = attn_bwd_dq<D, BK>;
  using L = DqSmem<D, BK>;
  static std::atomic<uint32_t> ready{0};
  const cudaError_t e = allow_smem(kern, L::kBytes, ready);
  if (e != cudaSuccess) return e;
  kern<<<dim3(B * H, (Sq + kBQd - 1) / kBQd), kThreads, L::kBytes, stream>>>(
      tq, tdo, tk, tv, rows, static_cast<bf16*>(dq), H, Hkv, Sq, Sqp, Sk,
      scale, causal, window);
  return cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* stats, void* dq, void* dk, void* dv,
           float* rows, void* qs, float* part, int parts, int bq, int bkd,
           int B, int H, int Hkv, int Sq, int Sk, float scale, int causal,
           int window, cudaStream_t stream) {
  using T = Tiles<D>;
  if (bq != T::kBQ || (bkd != T::kBKd && bkd != T::kBKdLong) || parts < 1 ||
      parts > H / Hkv || (parts > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Sqp = (Sq + kRowPad - 1) / kRowPad * kRowPad, nbh = B * H;
  float4* rows4 = reinterpret_cast<float4*>(rows);
  attn_bwd_prep<D><<<(nbh * Sqp + 2048 / D - 1) / (2048 / D), 256, 0,
                     stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), stats, static_cast<bf16*>(qs), rows4,
      scale, Sq, Sqp, nbh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // the maps of each kernel: its own rows' box of qs and dO, its steps' of
  // K and V (rows past Sq or Sk read as zeros)
  CUtensorMap q_dq, o_dq, k_dq, v_dq, q_kv, o_kv, k_kv, v_kv;
  if (!encode<D>(&q_dq, qs, Sq, nbh, kBQd) ||
      !encode<D>(&o_dq, dout, Sq, nbh, kBQd) ||
      !encode<D>(&k_dq, k, Sk, B * Hkv, bkd) ||
      !encode<D>(&v_dq, v, Sk, B * Hkv, bkd) ||
      !encode<D>(&q_kv, qs, Sq, nbh, T::kBQ) ||
      !encode<D>(&o_kv, dout, Sq, nbh, T::kBQ) ||
      !encode<D>(&k_kv, k, Sk, B * Hkv, kBK) ||
      !encode<D>(&v_kv, v, Sk, B * Hkv, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  e = bkd == T::kBKd
          ? launch_dq<D, T::kBKd>(q_dq, o_dq, k_dq, v_dq, rows4, dq, B, H, Hkv,
                                  Sq, Sqp, Sk, scale, causal, window, stream)
          : launch_dq<D, T::kBKdLong>(q_dq, o_dq, k_dq, v_dq, rows4, dq, B, H,
                                      Hkv, Sq, Sqp, Sk, scale, causal, window,
                                      stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  {
    auto kern = attn_bwd_dkdv<D>;
    static std::atomic<uint32_t> ready{0};
    e = allow_smem(kern, DkdvSmem<D>::kBytes, ready);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<dim3(B * Hkv * parts, (Sk + kBK - 1) / kBK), kThreads,
           DkdvSmem<D>::kBytes, stream>>>(
        q_kv, o_kv, k_kv, v_kv, rows4, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), part, H, Hkv, Sq, Sqp, Sk, parts, causal,
        window);
    e = cudaGetLastError();
    if (e != cudaSuccess || parts == 1) return static_cast<int>(e);
  }
  const size_t n4 = static_cast<size_t>(B) * Hkv * Sk * D / 4;
  const size_t blocks = (2 * n4 + 255) / 256;
  attn_bwd_reduce<<<static_cast<unsigned>(blocks < 2048 ? blocks : 2048), 256,
                    0, stream>>>(reinterpret_cast<const float4*>(part),
                                 static_cast<bf16*>(dk),
                                 static_cast<bf16*>(dv), n4, parts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <int D>
int launch_d(int dtype, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const float* stats, void* dq,
             void* dk, void* dv, float* delta, void* qs, float* part,
             int parts, int bq, int bkd, int B, int H, int Hkv, int Sq,
             int Sk, float scale, int causal, int window,
             cudaStream_t stream) {
  if (dtype == 0)
    return simt::launch<D>(q, k, v, o, dout, stats, dq, dk, dv, delta, qs, B,
                           H, Hkv, Sq, Sk, scale, causal, window, stream);
  if (dtype == 1)
    return tc::launch<D>(q, k, v, o, dout, stats, dq, dk, dv, delta, qs, part,
                         parts, bq, bkd, B, H, Hkv, Sq, Sk, scale, causal,
                         window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launches K4's backward on `stream` (a cudaStream_t): q, o, dO (B, H, Sq, D),
// k, v (B, Hkv, Sk, D), stats the forward's (2, B, H, Sq) m and l ->
// dq, dk, dv in the inputs' type; qs (q's shape and type) and delta are
// scratch the caller allocates.  dtype 0 = float32 (CUDA cores; delta (B, H,
// Sq) float32; part, parts, bq and bkd unread), 1 = bfloat16 (tensor cores;
// every tensor 16-byte aligned; delta is the row scratch, B H Sqp float4s,
// Sqp = Sq rounded up to a multiple of 64; bq and bkd the tiles it is built
// for at D; each GQA group's query heads in `parts` runs, 1 <= parts <= H /
// Hkv, and for parts > 1 part is float32 scratch of parts x 2 x B Hkv Sk D);
// D in {32, 64, 128, 256}; window <= 0 means no window; Sq != Sk only with
// neither the causal mask nor a window.  Returns a cudaError_t: the
// attribute call's, cudaErrorInvalidValue for arguments it does not take (or
// a tensor map it cannot encode), or cudaGetLastError() after each launch.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const float* stats, void* dq, void* dk,
                              void* dv, float* delta, void* qs, int dtype,
                              int B, int H, int Hkv, int Sq, int Sk, int D,
                              float scale, int causal, int window,
                              float* part, int parts, int bq, int bkd,
                              void* stream) {
  if (B <= 0 || Sq <= 0) return static_cast<int>(cudaSuccess);
  if (Hkv <= 0 || H % Hkv != 0 || Sk <= 0 ||
      (Sq != Sk && (causal || window > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_d<32>(dtype, q, k, v, o, dout, stats, dq, dk, dv, delta,
                          qs, part, parts, bq, bkd, B, H, Hkv, Sq, Sk, scale,
                          causal, window, st);
    case 64:
      return launch_d<64>(dtype, q, k, v, o, dout, stats, dq, dk, dv, delta,
                          qs, part, parts, bq, bkd, B, H, Hkv, Sq, Sk, scale,
                          causal, window, st);
    case 128:
      return launch_d<128>(dtype, q, k, v, o, dout, stats, dq, dk, dv, delta,
                           qs, part, parts, bq, bkd, B, H, Hkv, Sq, Sk, scale,
                           causal, window, st);
    case 256:
      return launch_d<256>(dtype, q, k, v, o, dout, stats, dq, dk, dv, delta,
                           qs, part, parts, bq, bkd, B, H, Hkv, Sq, Sk, scale,
                           causal, window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
