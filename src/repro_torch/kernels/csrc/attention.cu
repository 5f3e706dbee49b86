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
// accumulators a thread holds at D = 256 would not fit 255 registers.  A
// TMA box is an "atom column": kAW elements of each row (one swizzle span,
// kSwz bytes) for all its rows, so a tile of D columns is kNA atom columns
// one after another.
template <int D>
struct Layout {
  static constexpr int kBK = D <= 128 ? 128 : 64;           // keys per tile
  static constexpr int kStages = D <= 128 ? 3 : 2;          // K/V tiles in flight
  static constexpr int kSwz = D * 2 < 128 ? D * 2 : 128;   // bytes
  static constexpr int kAW = kSwz / 2;                      // elements
  static constexpr int kNA = D / kAW;
  static constexpr uint64_t kDescLayout = kSwz == 128 ? 1 : 2;   // B128, B64
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;           // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;   // 1 + kStages
  static constexpr int kCnt = kBar + 8 * (1 + kStages);    // release counts
  static constexpr int kSmem = kCnt + 4 * kStages + 1024;  // + align
};

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// Waits until the phase of parity `parity` of the barrier has completed.  A
// completion that never comes (a TMA that failed) traps after ~10 s of
// cycles, so the launch reports an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// TMA: the box at (c0, c1, c2) of `map` into shared memory at dst, completing
// on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving register reads or writes of d across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A B (scale_d 0) or d += A B (1); A (64 x 16) and B (16 x 128) from
// shared memory through descriptors, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d = A B or d += A B as above, B 16 x 64 (a 64-key tile at D = 256)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += A B with A (64 x 16) from registers (the bf16 pairs of a k16 slice,
// as mma.sync's A fragment) and B (16 x N) from shared memory, MN-major
// (transposed: N contiguous)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, or null
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over a contiguous (n, S, D) bf16 tensor, innermost first: boxes
// of (kAW, rows, 1), swizzled; rows past S read as zeros (S is Sq for q, Sk
// for k and v).
template <int D>
bool encode(CUtensorMap* map, const void* ptr, int S, int n, int rows) {
  using L = Layout<D>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(L::kAW),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             L::kSwz == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
