// K2: streaming P2P Laplace direct sum for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/p2p_stream.py::p2p_stream
// (body _stream_kernel, tile stream_tile_phi).  It computes the same sum as
// K1 (p2p.cu), but over one unified tile table for every width class, and
// does the gather itself:
//
//   meta     (Ti, 4) int32: [src_start, src_len, tgt_start, tgt_len] per tile
//   payload  (4, F) float32: structure of arrays [x; y; z; q] over the flat
//            body axis, zero-padded so fixed-size slab reads stay in bounds
//   out      (Ti, block_t) float32
//
// Lane t < tgt_len of tile i gets sum_{s < src_len} q_s * rsqrt(r^2)
// (r^2 == 0 adds 0) over the sources payload[:, src_start + s] and the
// target payload[:, tgt_start + t].  Lanes in [tgt_len, block_t) and whole
// dead tiles (tgt_len == 0) are written as exactly 0.0f.  The reference
// computes those lanes too; its caller drops them through the table's
// out_valid, so they carry no information and this kernel does not
// evaluate them.
//
// What bounds it on this card: the contract still writes the whole
// (Ti, block_t) output, which is most of the bytes, and the live pairs are a
// sixteenth of the tile's block_t x smax lanes at the engine's shapes (mean
// src_len and tgt_len ~23 of smax 64 and block_t 128).  So the design
// evaluates live pairs only: one warp takes a tile (kTiles consecutive
// tiles a warp, their meta rows in one read; warps a block chosen by
// kernels/p2p_stream.py::stream_launch_params), loads the tile's sources 32
// at a time (four coalesced reads of the SoA payload) into its own slice of
// shared memory as float4 {x, y, z, q}, and runs the source loop to
// src_len, which is uniform across the warp, so no block barrier is needed.
// A lane holds two targets in registers (64 a pass, passes looping up to
// tgt_len for any block_t), so each staged source feeds two pairs.  The
// pair body and the ascending order are shared with K1 (p2p_common.cuh): on
// identical slabs the two kernels agree bit for bit on every lane below
// tgt_len.  Zeros go out as 16-byte stores where the row is aligned.  What
// is left bounds it by instruction issue as much as by bytes: 11
// instructions a pair on 32-lane warps over tiles of ~23 targets.  No
// TPU-style double buffering: reading the next tile ahead, in registers or
// with cp.async, measured slower (PERF.md section 6).

#include <climits>
#include <cstdint>

// Shipped settings (tools/p2p_variants.py times others): tiles a warp, and
// the source loop unrolled four times.
#ifndef REPRO_P2P_TILES
#define REPRO_P2P_TILES 8
#endif
#ifndef REPRO_P2P_UNROLL
#define REPRO_P2P_UNROLL 4
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

constexpr int kTiles = REPRO_P2P_TILES;     // consecutive tiles a warp
static_assert(kTiles >= 1 && kTiles <= kWarp, "a lane reads one meta row");

// The payload as four rows [x; y; z; q] of F floats.  Indices are 32-bit:
// the table builder keeps every slab below 2^31 bodies, and the launch
// clips F there.
struct Payload {
  const float* x;
  const float* y;
  const float* z;
  const float* q;
  int F;

  // body g's position, or 0 outside [0, F) or where !live
  __device__ __forceinline__ float3 target(int g, bool live) const {
    return live && g >= 0 && g < F
               ? make_float3(__ldg(x + g), __ldg(y + g), __ldg(z + g))
               : make_float3(0.0f, 0.0f, 0.0f);
  }
  // body j as a source {x, y, z, q}, or 0 outside [0, F) or where !live
  __device__ __forceinline__ float4 source(int j, bool live) const {
    return live && j >= 0 && j < F
               ? make_float4(__ldg(x + j), __ldg(y + j), __ldg(z + j),
                             __ldg(q + j))
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
};

// One tile, by one warp, from its meta row m: sums below tgt_len, zeros in
// the rest of the row.
__device__ __forceinline__ void stream_tile(const Payload& p,
                                            float* __restrict__ o,
                                            int block_t, int smax, int4 m,
                                            float4* src, int lane) {
  const int ns = min(m.y, smax);
  const int nt_all = min(m.w, block_t);
  int done = 0;                          // lanes written so far
  for (int t0 = 0; t0 < nt_all; t0 += kPassTargets) {
    const int nt = min(kPassTargets, nt_all - t0);
    const int g = m.z + t0 + lane;
    const float3 tg0 = p.target(g, lane < nt);
    const float3 tg1 = p.target(g + kWarp, lane + kWarp < nt);
    float a0 = 0.0f, a1 = 0.0f;
    for (int c0 = 0; c0 < ns; c0 += kSrcChunk) {
      const int n = min(kSrcChunk, ns - c0);
      const float4 b = p.source(m.x + c0 + lane, lane < n);
      __syncwarp(kFull);                 // the last chunk is read
      src[lane] = b;
      __syncwarp(kFull);
      accumulate_chunk(a0, a1, tg0, tg1, src, n, nt > kWarp);
    }
    // the pass's lanes: sums below tgt_len, zeros from it to the pass end
    const int t = t0 + lane;
    if (t < block_t) o[t] = lane < nt ? a0 : 0.0f;
    if (t + kWarp < block_t) o[t + kWarp] = lane + kWarp < nt ? a1 : 0.0f;
    done = min(block_t, t0 + kPassTargets);
  }
  warp_zero(o + done, block_t - done, lane);   // the rest, dead tiles whole
}

// A warp takes kTiles consecutive tiles, from tile (blockIdx.x * warps +
// warp) * kTiles; lane k < kTiles reads tile k's meta row, all in one read,
// and hands it to the warp with shuffles.  Shared memory holds kSrcChunk
// float4 sources for each warp of the block.
__global__ void REPRO_P2P_BOUNDS p2p_stream_kernel(
    const int4* __restrict__ meta, const float* __restrict__ pay,
    float* __restrict__ out, int64_t n_tiles, int F, int64_t pitch,
    int block_t, int smax) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) + warp) *
      kTiles;
  if (first >= n_tiles) return;          // uniform across the warp
  float4* src = smem + warp * kSrcChunk;
  const Payload p{pay, pay + pitch, pay + 2 * pitch, pay + 3 * pitch, F};
  int4 mine = make_int4(0, 0, 0, 0);
  if (lane < kTiles && first + lane < n_tiles) mine = __ldg(meta + first + lane);
  const int64_t left = n_tiles - first;
  const int last = left < kTiles ? static_cast<int>(left) : kTiles;
#pragma unroll 1
  for (int k = 0; k < last; ++k) {
    const int4 m = make_int4(__shfl_sync(kFull, mine.x, k),
                             __shfl_sync(kFull, mine.y, k),
                             __shfl_sync(kFull, mine.z, k),
                             __shfl_sync(kFull, mine.w, k));
    stream_tile(p, out + (first + k) * block_t, block_t, smax, m, src, lane);
  }
}

}  // namespace

extern "C" {

// Launches K2 on `stream` (a cudaStream_t) with `warps` warps per block;
// returns cudaGetLastError(), or cudaErrorInvalidValue for a launch shape
// outside 1..16 warps (K1's limit).
int repro_p2p_stream(const void* meta, const void* payload, void* out,
                     long long n_tiles, long long F, int block_t, int smax,
                     int warps, void* stream) {
  if (warps < 1 || warps > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles <= 0 || block_t <= 0) return static_cast<int>(cudaSuccess);
  const long long per_block = static_cast<long long>(warps) * kTiles;
  const long long blocks = (n_tiles + per_block - 1) / per_block;
  const size_t smem = static_cast<size_t>(warps) * kSrcChunk * sizeof(float4);
  p2p_stream_kernel<<<static_cast<unsigned>(blocks), warps * kWarp, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(meta), static_cast<const float*>(payload),
      static_cast<float*>(out), static_cast<int64_t>(n_tiles),
      static_cast<int>(F < INT_MAX ? F : INT_MAX), static_cast<int64_t>(F),
      block_t, smax);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_p2p_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
