// Shared pair body and warp helpers of the two P2P kernels (p2p.cu and
// p2p_stream.cu).
//
// Both kernels give one warp a row (K1) or a tile (K2).  Each lane holds up
// to kPassTargets / 32 = 2 targets of the current pass in registers; the
// warp stages its sources 32 at a time in its own slice of shared memory as
// float4 {x, y, z, q}, and every lane reads each staged source once (a
// broadcast) for both of its targets.  pair_step is the one per-pair
// expression, with explicit round-to-nearest intrinsics, so the compiler can
// neither contract nor reorder it; accumulate_chunk adds a chunk's sources
// in ascending order.  Every target's sum therefore runs over its sources
// in the same order in both kernels, and on identical staged values the
// gathered and the streaming kernel produce the same bits.
//
// A source with q == 0 leaves a sum unchanged bit for bit: inv is finite
// (r^2 is clamped at 1e-30, and r^2 == 0 or NaN gives 0), so the fma adds
// +-0, and a sum that starts at +0 never becomes -0 under round-to-nearest.
// That is why both kernels may stop a source loop at the last nonzero
// charge and still give the bits of the full loop.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

// Compile-time settings.  Each kernel's source sets its shipped values
// before including this header (unless given with -D); tools/p2p_variants.py
// builds the other values it times.  REPRO_P2P_UNROLL unrolls the source
// loop; REPRO_P2P_MIN_BLOCKS, where set, asks ptxas for that many blocks of
// kMaxThreads an SM (a register cap).
#ifndef REPRO_P2P_UNROLL
#error "a kernel's source sets REPRO_P2P_UNROLL before including this header"
#endif
#define REPRO_P2P_PRAGMA(x) _Pragma(#x)
#define REPRO_P2P_UNROLLED(n) REPRO_P2P_PRAGMA(unroll n)
#ifdef REPRO_P2P_MIN_BLOCKS
#define REPRO_P2P_BOUNDS \
  __launch_bounds__(repro_p2p::kMaxThreads, REPRO_P2P_MIN_BLOCKS)
#else
#define REPRO_P2P_BOUNDS __launch_bounds__(repro_p2p::kMaxThreads)
#endif

namespace repro_p2p {

constexpr int kWarp = 32;
constexpr int kSrcChunk = 32;       // sources staged per warp per step
constexpr int kPassTargets = 64;    // targets a warp holds per pass (2 a lane)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 16;       // warps a block, at most
constexpr int kMaxThreads = kMaxWarps * kWarp;

// rsqrtf(x) for x >= 1e-30.  rsqrtf compiles to the approximate MUFU.RSQ
// behind a test that scales a denormal x up and the result back; x here is
// never denormal, so the flush-to-zero form of the same instruction gives
// the same bits without that test (REPRO_P2P_RSQRT_PLAIN keeps rsqrtf, for
// tools/p2p_variants.py to show that the bits agree).
__device__ __forceinline__ float rsqrt_normal(float x) {
#ifdef REPRO_P2P_RSQRT_PLAIN
  return rsqrtf(x);
#else
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#endif
}

// acc + q * rsqrt(|x_t - x_s|^2), with r^2 == 0 adding 0 and r^2 clamped at
// 1e-30 before the rsqrt (the reference's guard).
__device__ __forceinline__ float pair_step(float acc, float xt, float yt,
                                           float zt, float4 b) {
#ifdef REPRO_P2P_PROBE
  // a timing probe for tools/p2p_variants.py, not a kernel: one fma a pair
  // in place of the arithmetic, to time everything else
  return __fmaf_rn(b.w, xt, acc);
#else
  const float dx = __fsub_rn(xt, b.x);
  const float dy = __fsub_rn(yt, b.y);
  const float dz = __fsub_rn(zt, b.z);
  const float r2 = __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
  const float inv = r2 > 0.0f ? rsqrt_normal(fmaxf(r2, 1e-30f)) : 0.0f;
  return __fmaf_rn(b.w, inv, acc);
#endif
}

// The n staged sources src[0..n) in ascending order into a lane's first
// target (a0) and, where `two` (uniform across the warp), its second (a1).
__device__ __forceinline__ void accumulate_chunk(float& a0, float& a1,
                                                 const float3& t0,
                                                 const float3& t1,
                                                 const float4* src, int n,
                                                 bool two) {
  if (two) {
    REPRO_P2P_UNROLLED(REPRO_P2P_UNROLL)
    for (int s = 0; s < n; ++s) {
      const float4 b = src[s];
      a0 = pair_step(a0, t0.x, t0.y, t0.z, b);
      a1 = pair_step(a1, t1.x, t1.y, t1.z, b);
    }
  } else {
    REPRO_P2P_UNROLLED(REPRO_P2P_UNROLL)
    for (int s = 0; s < n; ++s) a0 = pair_step(a0, t0.x, t0.y, t0.z, src[s]);
  }
}

// n zeros to o[0..n) by one warp: 16-byte stores where o is 16-byte aligned.
__device__ __forceinline__ void warp_zero(float* o, int n, int lane) {
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(o) & 15) == 0) {
    const int n4 = n >> 2;
    float4* o4 = reinterpret_cast<float4*>(o);
    for (int i = lane; i < n4; i += kWarp)
      o4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    head = n4 << 2;
  }
  for (int i = head + lane; i < n; i += kWarp) o[i] = 0.0f;
}

}  // namespace repro_p2p
