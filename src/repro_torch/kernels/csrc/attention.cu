// K4: blocked online-softmax (flash) attention, causal, GQA, optional sliding
// window, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention.py::
// flash_attention (body _attn_kernel).  q (B, H, Sq, D), k and v (B, Hkv, Sk,
// D), all contiguous, float32 or bfloat16; output (B, H, Sq, D) in the input
// type.  Query head h reads kv head h / (H / Hkv).  Keys k >= Sk are masked
// (ragged Sk), and so are k > q (causal) and k <= q - window (sliding window).
// Sk may differ from Sq only without the causal mask and the window (the
// models' cross-attention over a memory, unmasked as in the reference); Sq ==
// Sk without them is the encoder's bidirectional self-attention.
//
// The Pallas kernel's roundings are kept: q * scale is rounded to the input
// type (scale itself rounded to it first, as JAX rounds a Python scalar to an
// array's type), scores and the running max / sum are float32, p is rounded
// to v's type before the PV product, the accumulator is float32, and the
// output is acc / max(l, 1e-30).  A masked score is -1e30, not -inf: a row
// whose first visited tile is fully masked gets exp(0) = 1 terms there (0 in
// the bfloat16 kernel), which the first tile with a live key scales by
// exp(-1e30 - m) = 0, so no NaN and the same result.
//
// What bounds it on this card: at the models' shapes (S in the thousands,
// D = 64 to 256) the work is S^2 D / 2 multiply-adds per head against S D
// bytes, so it is bound by operations, in bfloat16 by the tensor cores
// (989 TFLOP/s).
//
// bfloat16 (namespace tc), the models' type: both products run on the tensor
// cores as wgmma bf16 -> float32.  One block of 256 threads, two warpgroups,
// owns 128 query rows (64 per warpgroup) of one (batch, head); a loop inside
// the block walks the key tiles that the causal and window bounds admit (the
// TPU's sequential grid axis).  TMA brings Q once and K and V tiles into a ring
// of stages in shared memory, 128-byte swizzled (64-byte at D = 32), completing
// on mbarriers: up to D = 128, 128-key tiles in three stages (32 KB of Q and 3
// x 64 KB of K and V at D = 128); at D = 256 (gemma3), 64-key tiles in two (64
// KB of Q and 2 x 64 KB of K and V), since the larger ring exceeds the 227 KB a
// block may use and a 128-key score tile beside a thread's 128 accumulators
// exceeds its 255 registers (Layout).  The tensor maps are 3-D, (D, S, batch x
// head), so rows >= Sk of a ragged K or V tile (>= Sq of Q) are zero-filled,
// not the next head's; the mask then gives those keys exactly 0 weight.
// Each warpgroup rounds its Q rows to q * scale in place once, then fences the
// generic proxy's writes for wgmma.  S = Q K^T is a wgmma with both operands in
// shared memory (K-major); the scores stay in registers, where the row max and
// sum reduce over the four lanes that share a row, and only tiles that cross S,
// the diagonal or the window edge are masked.  p, packed to bf16 pairs, is
// exactly the A fragment of the PV wgmma (A from registers, V as B through a
// transposed, MN-major descriptor): P never goes through shared memory.  Within
// a warpgroup the tensor cores overlap the softmax: at tile j it issues S_j and
// the PV product of tile j - 1, waits for S_j alone and runs the softmax of
// tile j while PV_{j-1} runs; p is packed only once PV_{j-1} is done, because
// ptxas serialises the wgmma's when registers that feed one in flight are
// written (its warning C7513).  Thread 0 issues the first loads; the load of
// tile j + kStages is issued by whichever warpgroup is second to be done with
// tile j (a count per stage in shared memory), so no block-wide barrier couples
// the two warpgroups: they drift apart, and one's softmax also overlaps the
// other's products.  Query tiles are issued heaviest first (the query tile is
// the slowest grid index, reversed), so the short causal tiles fill in at the
// end.  204 registers at D = 128, none spilled; ptxas's line for D = 256 is
// printed by chip_smoke.py.
//
// Not done, measured slower on the card (PERF.md): a producer warp or
// warpgroup (the 288- or 384-thread block caps ptxas at 168 registers, and
// setmaxnreg did not lift the cap, so the loop spills at D = 128), and the
// two warpgroups taking turns on the tensor cores through named barriers.
//
// float32 (namespace simt), for the smoke models and tests: float32 FMAs on the
// CUDA cores; tensor cores in TF32 would round the inputs to 10 bits. One block
// of 256 threads per (query tile of 64 rows, head, batch) walks the admitted
// 64-key tiles; Q, K, V and P tiles live in shared memory as float32 (113 KB at
// D = 128, 209 KB at D = 256).  A thread owns a 4 x 4 block of the score tile
// (rows ty + 16 i, keys tx + 16 j) and the same 4 rows of the output (columns
// tx + 16 c), so the row max and sum reduce over the 16 lanes of a half-warp
// with shuffles.  Rows of Q and K are padded by one float, so the 16 keys a
// half-warp reads at one d fall in 16 different banks.
//
// For the gradient (csrc/attention_bwd.cu) both kernels can also write each
// query row's float32 softmax statistics where they finish the row: the
// final max m and the sum l of its p = exp(s - m) (the l the output is
// divided by), stats[0] and stats[1] of a (2, B, H, Sq) buffer.  Serving
// passes no buffer and writes nothing more.
//
// The shared-memory limit of each kernel is raised once per device, not per
// launch.  The TMA encoder, cuTensorMapEncodeTiled, lives in libcuda and is
// looked up at run time through cudart, so the library links nothing else.

#include <atomic>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

// ------------------------------------------------ float32: CUDA cores -----
namespace simt {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16: ty = row group, tx = key / column
constexpr int kPS = kBK + 1;     // padded row stride of the P tile
constexpr float kNegInf = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBQ * (D + 1) + kBK * D + kBQ * kPS);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ stats, int H, int Hkv, int Sq,
                       int Sk, float scale, int causal, int window) {
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
  const T* qp = q + static_cast<size_t>(b * H + h) * Sq * D;
  const T* kp = k + static_cast<size_t>(b * Hkv + hk) * Sk * D;
  const T* vp = v + static_cast<size_t>(b * Hkv + hk) * Sk * D;
  T* op = o + static_cast<size_t>(b * H + h) * Sq * D;

  const float sc = round_to<T>(scale);
  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    Qs[r * QS + c] = (q0 + r < Sq)
        ? round_to<T>(to_f<T>(qp[static_cast<size_t>(q0 + r) * D + c]) * sc)
        : 0.f;
  }

  // the key tiles that hold at least one unmasked key for some row
  const int n_kv = (Sk + kBK - 1) / kBK;
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
      const bool in = k0 + r < Sk;
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
        const bool ok = kj < Sk && (!causal || kj <= qi) &&
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
    if (qi >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      op[static_cast<size_t>(qi) * D + tx + 16 * c] = from_f<T>(acc[i][c] / den);
    if (stats != nullptr && tx == 0) {
      const size_t at = static_cast<size_t>(b * H + h) * Sq + qi;
      stats[at] = m[i];
      stats[static_cast<size_t>(gridDim.z) * H * Sq + at] = l[i];
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* stats,
           int B, int H, int Hkv, int Sq, int Sk, float scale, int causal,
           int window, cudaStream_t stream) {
  auto kern = flash_attention_kernel<float, D>;
  constexpr size_t smem = smem_bytes<D>();
  static std::atomic<uint32_t> ready{0};
  cudaError_t err = allow_smem(kern, static_cast<int>(smem), ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), stats, H, Hkv, Sq,
      Sk, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

int launch_d(const void* q, const void* k, const void* v, void* o,
             float* stats, int B, int H, int Hkv, int Sq, int Sk, int D,
             float scale, int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<32>(q, k, v, o, stats, B, H, Hkv, Sq, Sk, scale, causal,
                        window, stream);
    case 64:
      return launch<64>(q, k, v, o, stats, B, H, Hkv, Sq, Sk, scale, causal,
                        window, stream);
    case 128:
      return launch<128>(q, k, v, o, stats, B, H, Hkv, Sq, Sk, scale, causal,
                         window, stream);
    case 256:
      return launch<256>(q, k, v, o, stats, B, H, Hkv, Sq, Sk, scale, causal,
                         window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
}  // namespace simt

// ------------------------------------------------ bfloat16: tensor cores --
namespace tc {

constexpr int kBQ = 128;         // query rows per block, 64 per warpgroup
constexpr int kThreads = 256;    // two warpgroups
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Tile shape and shared-memory layout for head size D.  Up to D = 128, kBK =
// 128 keys a tile in kStages = 3 stages; at D = 256, 64 keys in 2 stages:
// 128-key tiles would hold 64 KB of Q and 3 x 2 x 64 KB of K and V, past the
// 227 KB a block may use, and a 128-column score tile beside the 128
// accumulators a thread holds at D = 256 would not fit 255 registers.  Each
// tile is kNA atom columns (Atoms<D>).
template <int D>
struct Layout : Atoms<D> {
  static constexpr int kBK = D <= 128 ? 128 : 64;           // keys per tile
  static constexpr int kStages = D <= 128 ? 3 : 2;          // K/V tiles in flight
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;           // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;   // 1 + kStages
  static constexpr int kCnt = kBar + 8 * (1 + kStages);    // release counts
  static constexpr int kSmem = kCnt + 4 * kStages + 1024;  // + align
};

// S = (q * scale) K^T for one warpgroup, 64 x kBK from the Q rows at q and
// the K tile at k (both K-major), D / 16 k-steps, issued and committed; a
// k-step inside a swizzle atom advances the start address by 32 bytes
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[Layout<D>::kBK / 2],
                                        uint32_t q, uint32_t k) {
  using L = Layout<D>;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int a = kk * 16 / L::kAW, in = (kk * 16 % L::kAW) * 2;
    wgmma_ss(s,
             make_desc(q + a * kBQ * L::kSwz + in, 16, 8 * L::kSwz,
                       L::kDescLayout),
             make_desc(k + a * L::kBK * L::kSwz + in, 16, 8 * L::kSwz,
                       L::kDescLayout),
             kk > 0);
  }
  wgmma_commit();
}

// acc += P V for one warpgroup: P's bf16 pairs from registers, the V tile at
// v through an MN-major descriptor (LBO: the next atom column of D, SBO: the
// next 8 keys), kBK / 16 k-steps, issued and committed
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&p)[Layout<D>::kBK / 4],
                                         uint32_t v) {
  using L = Layout<D>;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::kBK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3]};
    wgmma_rs(acc, a,
             make_desc(v + kk * 16 * L::kSwz, L::kBK * L::kSwz, 8 * L::kSwz,
                       L::kDescLayout),
             1);
  }
  wgmma_commit();
  fence_regs(acc);
}

// whether accumulator entry e of this thread (rows row0, row0 + 8; columns
// cq, cq + 1 of every 8) holds a key that its query may see
__device__ __forceinline__ bool live(int e, int row0, int k0, int cq, int Sk,
                                     int causal, int window) {
  const int qi = row0 + 8 * ((e >> 1) & 1);
  const int kj = k0 + 8 * (e >> 2) + cq + (e & 1);
  return kj < Sk && (!causal || kj <= qi) && (window <= 0 || kj > qi - window);
}

// The online softmax of one BK-key tile (first key k0) for this thread's
// two rows, masking keys past Sk, past the diagonal or the window (kMask):
// updates the running max m and gives alpha = exp(m_old - m_new), the row
// sums ls of p = exp(s - m_new) (over the four lanes that share a row), and
// p itself in place of s.  exp(s - m) is 2^(s log2 e - m log2 e), one fma;
// while a row has seen only masked keys (m = -1e30) that fma's residue
// would not be 0, so m log2 e is taken as 0 and those terms are 0 instead
// of 1: the first live tile scales them by alpha = 0 either way.
template <int BK, bool kMask>
__device__ __forceinline__ void softmax_pass(float (&s)[BK / 2],
                                             float (&m)[2], float (&alpha)[2],
                                             float (&ls)[2],
                                             int row0, int k0, int cq, int Sk,
                                             int causal, int window) {
  float mn[2] = {m[0], m[1]}, ml[2];
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const float x = !kMask || live(e, row0, k0, cq, Sk, causal, window)
                        ? s[e] : kNegInf;
    mn[(e >> 1) & 1] = fmaxf(mn[(e >> 1) & 1], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mn[r] = fmaxf(mn[r], __shfl_xor_sync(0xffffffffu, mn[r], 1));
    mn[r] = fmaxf(mn[r], __shfl_xor_sync(0xffffffffu, mn[r], 2));
    alpha[r] = exp2_approx((m[r] - mn[r]) * kLog2e);
    m[r] = mn[r];
    ml[r] = mn[r] == kNegInf ? 0.f : mn[r] * kLog2e;
    ls[r] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < BK / 4; ++j) {
    const int r = j & 1;
    const float x0 = !kMask || live(2 * j, row0, k0, cq, Sk, causal, window)
                         ? s[2 * j] : kNegInf;
    const float x1 = !kMask || live(2 * j + 1, row0, k0, cq, Sk, causal, window)
                         ? s[2 * j + 1] : kNegInf;
    const float p0 = exp2_approx(fmaf(x0, kLog2e, -ml[r]));
    const float p1 = exp2_approx(fmaf(x1, kLog2e, -ml[r]));
    ls[r] += p0 + p1;
    s[2 * j] = p0;
    s[2 * j + 1] = p1;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 1);
    ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 2);
  }
}

// softmax_pass, masked only where the tile crosses Sk, the diagonal or the
// window edge for some row of the warpgroup (rows from r_lo)
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2],
                                             float (&m)[2], float (&alpha)[2],
                                             float (&ls)[2],
                                             int row0, int k0, int r_lo,
                                             int cq, int Sk, int causal,
                                             int window) {
  if (k0 + BK > Sk || (causal && k0 + BK - 1 > r_lo) ||
      (window > 0 && k0 <= r_lo + 63 - window))
    softmax_pass<BK, true>(s, m, alpha, ls, row0, k0, cq, Sk, causal, window);
  else
    softmax_pass<BK, false>(s, m, alpha, ls, row0, k0, cq, Sk, causal, window);
}

// TMA of key tile kt's K and V into stage st, completing on its barrier
template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint32_t base,
                                        int st, int kt, int kvh) {
  using L = Layout<D>;
  const uint32_t bar = base + L::kBar + 8 * (1 + st);
  mbar_expect_tx(bar, 2 * L::kTileBytes);
#pragma unroll
  for (int a = 0; a < L::kNA; ++a) {
    const uint32_t off = st * L::kTileBytes + a * L::kBK * L::kSwz;
    tma_load(base + L::kK + off, tk, bar, a * L::kAW, kt * L::kBK, kvh);
    tma_load(base + L::kV + off, tv, bar, a * L::kAW, kt * L::kBK, kvh);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ stats,
                   int H, int Hkv, int Sq, int Sk, float scale, int causal,
                   int window) {
  using L = Layout<D>;
  constexpr int NO = D / 2;                // output accumulators per thread
  constexpr int kBK = L::kBK, kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms: 1024 B
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x;                      // b * H + h
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int qb = gridDim.y - 1 - blockIdx.y;      // heaviest first
  const int q0 = qb * kBQ;
  // the key tiles that hold at least one unmasked key for some row
  const int n_kv = (Sk + kBK - 1) / kBK;
  const int hi = causal ? min(n_kv, (q0 + kBQ - 1) / kBK + 1) : n_kv;
  const int lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  const int n = hi - lo;
  const uint32_t bar_q = base + L::kBar;   // then one "full" per stage
  uint32_t* released = reinterpret_cast<uint32_t*>(smem + L::kCnt);
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) released[i] = 0;
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(bar_q + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
    for (int a = 0; a < L::kNA; ++a)
      tma_load(base + L::kQ + a * kBQ * L::kSwz, &tq, bar_q, a * L::kAW, q0,
               bh);
    for (int st = 0; st < kStages && st < n; ++st)
      load_kv<D>(&tk, &tv, base, st, lo + st, kvh);
  }

  // this warpgroup's Q rows to q * scale rounded to bf16, in place (the
  // swizzle permutes whole 16-byte chunks, so any order of them will do)
  mbar_wait(bar_q, 0);
  {
    const __nv_bfloat162 sc2 = __float2bfloat162_rn(scale);
    const float2 sf = __bfloat1622float2(sc2);
#pragma unroll
    for (int a = 0; a < L::kNA; ++a) {
      uint4* rows = reinterpret_cast<uint4*>(
          smem + L::kQ + a * kBQ * L::kSwz + wg * 64 * L::kSwz);
      for (int i = tid % 128; i < 64 * L::kSwz / 16; i += 128) {
        uint4 x = rows[i];
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          h[j] = __floats2bfloat162_rn(f.x * sf.x, f.y * sf.y);
        }
        rows[i] = x;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }

  // this thread's rows of the accumulators: r_lo + 16 warp + lane / 4 and
  // + 8, and columns 8 j + 2 (lane % 4) + {0, 1} of every 8-column group j
  const int r_lo = q0 + 64 * wg;
  const int row0 = r_lo + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const uint32_t q_base = base + L::kQ + wg * 64 * L::kSwz;
  const uint32_t k_ring = base + L::kK, v_ring = base + L::kV;
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2], alpha[2];
  uint32_t p[kBK / 4];   // bf16 pairs of p: p[4 kk .. 4 kk + 3] is k-step kk

  // tile 0: scores and softmax (acc is 0, so its alpha does not matter)
  {
    float s[kBK / 2];
    mbar_wait(bar_q + 8, 0);
    issue_s<D>(s, q_base, k_ring);
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile<kBK>(s, m, alpha, l, row0, lo * kBK, r_lo, cq, Sk, causal,
                      window);
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) p[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
  }
  // tile i: acc rescaled by the alpha of tile i - 1, then S of tile i and
  // the PV product of tile i - 1 on the tensor cores while this warpgroup
  // runs the softmax of tile i.  p is packed from s only after PV is done:
  // writing registers that feed a wgmma still in flight makes ptxas
  // serialise the wgmma's.
  for (int i = 1; i < n; ++i) {
    const int st = i % kStages, sp = (i - 1) % kStages;
    float s[kBK / 2], ls[2];
#pragma unroll
    for (int e = 0; e < NO; ++e) acc[e] *= alpha[(e >> 1) & 1];
    mbar_wait(bar_q + 8 * (1 + st), (i / kStages) & 1);
    issue_s<D>(s, q_base, k_ring + st * L::kTileBytes);
    issue_pv<D>(acc, p, v_ring + sp * L::kTileBytes);
    wgmma_wait<1>();               // the scores are in
    fence_regs(s);
    softmax_tile<kBK>(s, m, alpha, ls, row0, (lo + i) * kBK, r_lo, cq, Sk,
                      causal, window);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + ls[r];
    wgmma_wait<0>();               // acc += P V of tile i - 1 is done
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) p[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
    // the second warpgroup to be done with tile i - 1's stage refills it,
    // so the warpgroups never wait for each other and drift apart
    if (tid % 128 == 0) {
      __threadfence_block();
      if ((atomicAdd(released + sp, 1u) & 1u) && i - 1 + kStages < n)
        load_kv<D>(&tk, &tv, base, sp, lo + i - 1 + kStages, kvh);
    }
  }
#pragma unroll
  for (int e = 0; e < NO; ++e) acc[e] *= alpha[(e >> 1) & 1];
  issue_pv<D>(acc, p, v_ring + ((n - 1) % kStages) * L::kTileBytes);
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = o + (static_cast<size_t>(bh) * Sq + qi) * D + cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] / den, acc[4 * j + 2 * r + 1] / den);
    // the four lanes of a row hold the same m and l
    if (stats != nullptr && lane % 4 == 0) {
      const size_t at = static_cast<size_t>(bh) * Sq + qi;
      stats[at] = m[r];
      stats[static_cast<size_t>(gridDim.x) * Sq + at] = l[r];
    }
  }
}


template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* stats,
           int B, int H, int Hkv, int Sq, int Sk, float scale, int causal,
           int window, cudaStream_t stream) {
  using L = Layout<D>;
  auto kern = flash_attention_tc<D>;
  static std::atomic<uint32_t> ready{0};
  cudaError_t err = allow_smem(kern, L::kSmem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tq, tk, tv;
  if (!encode<D>(&tq, q, Sq, B * H, kBQ) ||
      !encode<D>(&tk, k, Sk, B * Hkv, L::kBK) ||
      !encode<D>(&tv, v, Sk, B * Hkv, L::kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, L::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), stats, H, Hkv, Sq, Sk,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

int launch_d(const void* q, const void* k, const void* v, void* o,
             float* stats, int B, int H, int Hkv, int Sq, int Sk, int D,
             float scale, int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<32>(q, k, v, o, stats, B, H, Hkv, Sq, Sk, scale, causal,
                        window, stream);
    case 64:
      return launch<64>(q, k, v, o, stats, B, H, Hkv, Sq, Sk, scale, causal,
                        window, stream);
    case 128:
      return launch<128>(q, k, v, o, stats, B, H, Hkv, Sq, Sk, scale, causal,
                         window, stream);
    case 256:
      return launch<256>(q, k, v, o, stats, B, H, Hkv, Sq, Sk, scale, causal,
                         window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// Launches K4 on `stream` (a cudaStream_t).  dtype 0 = float32 (the CUDA-core
// kernel), 1 = bfloat16 (the tensor-core kernel; q, k, v 16-byte aligned);
// D in {32, 64, 128, 256}; window <= 0 means no window; Sq != Sk only with
// neither the causal mask nor a window.  stats, when not null, is a float32
// (2, B, H, Sq) buffer for each row's m and l.  Returns a cudaError_t: the
// attribute call's, cudaErrorInvalidValue for arguments it does not take or
// when a tensor map cannot be encoded, or cudaGetLastError() after the launch.
int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                          float* stats, int dtype, int B, int H, int Hkv,
                          int Sq, int Sk, int D, float scale, int causal,
                          int window, void* stream) {
  if (B <= 0 || Sq <= 0) return static_cast<int>(cudaSuccess);
  if (Hkv <= 0 || H % Hkv != 0 || Sk <= 0 ||
      (Sq != Sk && (causal || window > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return simt::launch_d(q, k, v, o, stats, B, H, Hkv, Sq, Sk, D, scale,
                          causal, window, st);
  if (dtype == 1)
    return tc::launch_d(q, k, v, o, stats, B, H, Hkv, Sq, Sk, D, scale,
                        causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
