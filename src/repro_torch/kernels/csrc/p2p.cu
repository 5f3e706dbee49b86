// K1: gathered P2P Laplace direct sum for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/p2p.py::p2p_pallas (body
// _p2p_kernel, tile _tile_phi).  For a batch of P interaction rows, each with
// S gathered sources and T gathered targets:
//
//     phi[p, t] = sum_s q[p, s] * rsqrt(|x_tgt[p, t] - x_src[p, s]|^2)
//
// with r^2 == 0 contributing 0.  Inputs: q (P, S), x_src (P, S, 3),
// x_tgt (P, T, 3), all float32 and contiguous; output (P, T) float32.
//
// What bounds it on this card: at the engine's shapes (T = 64, S = 8..64)
// a row reads 12 bytes per target and writes 4, and a (target, source) pair
// costs 11 float32 operations, so the launch is bound by device-memory
// bytes, but only if it does no needless work: the buckets are padded, both
// with rows whose charges are all 0 and with zero charges past each row's
// live sources (mean live sources 5-48 of S = 8-64).  So one warp takes a
// row (kRows consecutive rows a warp, the next row's last charges read
// while it sums a row; warps a block chosen by
// kernels/p2p.py::p2p_launch_params), finds the row's last nonzero charge
// with a ballot over 32-wide chunks of q read from the end, and runs the
// source loop only that far: a padding row reads its q and writes zeros.  The sum is bit for bit the full loop's
// (see p2p_common.cuh).  The row's targets and sources are copied into the
// warp's slice of shared memory with 16-byte loads where the row is 16-byte
// aligned (coalesced scalar loads otherwise), so the stride-3 coordinates
// never become strided global loads, and a pass's targets and its first
// chunk of sources are read together; each lane then holds two targets in
// registers (64 a pass, passes looping for any T), the sources are staged
// 32 at a time as float4 {x, y, z, q}, and each staged source feeds both of
// a lane's pairs through the pair body shared with K2.

#include <cstdint>

// Shipped settings (tools/p2p_variants.py times others): rows a warp, and
// the source loop unrolled twice (unrolled four times it spills).
#ifndef REPRO_P2P_ROWS
#define REPRO_P2P_ROWS 8
#endif
#ifndef REPRO_P2P_UNROLL
#define REPRO_P2P_UNROLL 2
#endif

#include "p2p_common.cuh"

namespace {

using repro_p2p::accumulate_chunk;
using repro_p2p::kFull;
using repro_p2p::kMaxWarps;
using repro_p2p::kPassTargets;
using repro_p2p::kSrcChunk;
using repro_p2p::kWarp;
using repro_p2p::warp_zero;

constexpr int kRows = REPRO_P2P_ROWS;       // consecutive rows a warp
constexpr int kTgtRaw = 3 * kPassTargets;   // floats of a pass's targets
constexpr int kSrcRaw = 3 * kSrcChunk;      // floats of a chunk's sources

// A warp's shared memory: kSrcChunk staged float4 sources, raw floats for
// one pass of targets' coordinates and raw floats for one chunk of sources'
// coordinates, so that a pass's targets and its first chunk of sources are
// in flight together.
constexpr int kWarpSmem = kSrcChunk + (kTgtRaw + kSrcRaw) / 4;   // float4s

// Up to kMax floats of a row, copied from device memory to shared memory by
// one warp in two steps, so that several copies can be in flight at once:
// load() issues the row's 16-byte reads into registers where the row is
// 16-byte aligned, and store() writes them to a 16-byte aligned shared
// array, reading the rest (the tail, or the whole of an unaligned row) as
// coalesced 4-byte reads on the way.
template <int kMax>
struct WarpRow {
  static constexpr int kVec = (kMax / 4 + kWarp - 1) / kWarp;
  float4 v[kVec];
  const float* src;
  int n, n4;      // floats in all, and float4s of them read as vectors

  __device__ __forceinline__ void load(const float* __restrict__ src_, int n_,
                                       int lane) {
    src = src_;
    n = n_;
    n4 = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? n >> 2 : 0;
    const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int i = lane + k * kWarp;
      if (i < n4) v[k] = __ldg(s4 + i);
    }
  }

  __device__ __forceinline__ void store(float* dst, int lane) const {
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int i = lane + k * kWarp;
      if (i < n4) d4[i] = v[k];
    }
    for (int i = 4 * n4 + lane; i < n; i += kWarp) dst[i] = __ldg(src + i);
  }
};

// This lane's charge in the last 32-wide chunk of a row of S (0 past S).
__device__ __forceinline__ float last_charge(const float* __restrict__ qrow,
                                             int S, int lane) {
  const int j = (S - 1) / kSrcChunk * kSrcChunk + lane;
  return j < S ? __ldg(qrow + j) : 0.0f;
}

// 1 + the index of the row's last nonzero charge (0 for none), by ballots
// over 32-wide chunks from the end; qlast is last_charge(qrow, S, lane).
__device__ __forceinline__ int trim(const float* __restrict__ qrow, int S,
                                    float qlast, int lane) {
  int c0 = (S - 1) / kSrcChunk * kSrcChunk;
  unsigned nz = __ballot_sync(kFull, qlast != 0.0f);
  while (!nz && c0 > 0) {
    c0 -= kSrcChunk;
    nz = __ballot_sync(kFull, __ldg(qrow + c0 + lane) != 0.0f);
  }
  return nz ? c0 + kWarp - __clz(nz) : 0;
}

// One row's n sources into its T targets, by one warp.
__device__ __forceinline__ void sum_row(const float* __restrict__ qrow,
                                        const float* __restrict__ srow,
                                        const float* __restrict__ trow,
                                        float* __restrict__ orow, int T,
                                        int n, float4* src, float* traw,
                                        float* sraw, int lane) {
  for (int t0 = 0; t0 < T; t0 += kPassTargets) {
    const int nt = min(kPassTargets, T - t0);
    float a0 = 0.0f, a1 = 0.0f;
    float3 tg[2] = {};
    WarpRow<kTgtRaw> trows;
    WarpRow<kSrcRaw> srows;
    for (int c0 = 0; c0 < n; c0 += kSrcChunk) {
      const int m = min(kSrcChunk, n - c0);
      // a pass's targets and its first chunk of sources load together
      if (c0 == 0) trows.load(trow + 3 * t0, 3 * nt, lane);
      srows.load(srow + 3 * c0, 3 * m, lane);
      const float qs = lane < m ? __ldg(qrow + c0 + lane) : 0.0f;
      __syncwarp(kFull);                 // the shared slices are free again
      if (c0 == 0) trows.store(traw, lane);
      srows.store(sraw, lane);
      __syncwarp(kFull);
      if (c0 == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = h * kWarp + lane;
          if (t < nt)
            tg[h] = make_float3(traw[3 * t], traw[3 * t + 1], traw[3 * t + 2]);
        }
      }
      if (lane < m)
        src[lane] = make_float4(sraw[3 * lane], sraw[3 * lane + 1],
                                sraw[3 * lane + 2], qs);
      __syncwarp(kFull);
      accumulate_chunk(a0, a1, tg[0], tg[1], src, m, nt > kWarp);
    }
    if (lane < nt) orow[t0 + lane] = a0;
    if (lane + kWarp < nt) orow[t0 + kWarp + lane] = a1;
  }
}

// A warp takes kRows consecutive rows, from row (blockIdx.x * warps + warp)
// * kRows; the next row's last charges are read while it sums a row.
__global__ void REPRO_P2P_BOUNDS p2p_gathered_kernel(
    const float* __restrict__ q, const float* __restrict__ xs,
    const float* __restrict__ xt, float* __restrict__ out, int64_t P, int S,
    int T) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) + warp) *
      kRows;
  if (first >= P) return;                // uniform across the warp
  float4* src = smem + warp * kWarpSmem;
  float* traw = reinterpret_cast<float*>(src + kSrcChunk);
  float* sraw = traw + kTgtRaw;
  const int64_t left = P - first;
  const int last = left < kRows ? static_cast<int>(left) : kRows;
  float qlast = last_charge(q + first * S, S, lane);
#pragma unroll 1
  for (int k = 0; k < last; ++k) {
    const int64_t r = first + k;
    const float* qrow = q + r * S;
    const int n = trim(qrow, S, qlast, lane);
    if (k + 1 < last) qlast = last_charge(qrow + S, S, lane);
    if (n == 0)                          // every term adds +0
      warp_zero(out + r * T, T, lane);
    else
      sum_row(qrow, xs + r * S * 3, xt + r * T * 3, out + r * T, T, n, src,
              traw, sraw, lane);
  }
}

}  // namespace

extern "C" {

// Launches K1 on `stream` (a cudaStream_t) with `warps` warps per block;
// returns cudaGetLastError(), or cudaErrorInvalidValue for a launch shape
// outside 1..16 warps (32 warps of 66 registers a thread would need more
// registers than an SM has).
int repro_p2p_gathered(const void* q, const void* x_src, const void* x_tgt,
                       void* out, long long P, int S, int T, int warps,
                       void* stream) {
  if (warps < 1 || warps > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P <= 0 || T <= 0) return static_cast<int>(cudaSuccess);
  const long long per_block = static_cast<long long>(warps) * kRows;
  const long long blocks = (P + per_block - 1) / per_block;
  const size_t smem = static_cast<size_t>(warps) * kWarpSmem * sizeof(float4);
  p2p_gathered_kernel<<<static_cast<unsigned>(blocks), warps * kWarp, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(x_src),
      static_cast<const float*>(x_tgt), static_cast<float*>(out),
      static_cast<int64_t>(P), S, T);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_p2p_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
