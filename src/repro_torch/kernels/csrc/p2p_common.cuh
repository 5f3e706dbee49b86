// Shared tile body of the two P2P kernels (p2p.cu and p2p_stream.cu).
//
// Both kernels stage sources in shared memory as float4 {x, y, z, q} and call
// tile_accumulate for each staged chunk.  The sum runs over the sources in
// ascending order with explicit round-to-nearest intrinsics, so the compiler
// can neither contract nor reorder it: on identical staged values the
// gathered and the streaming kernel produce the same bits.
#pragma once

#include <cuda_runtime.h>

namespace repro_p2p {

// Sources staged per chunk (16 bytes each).  A kernel's dynamic shared memory
// holds at most this many sources per row, so wide source rows loop over
// chunks instead of growing shared memory.
constexpr int kSrcChunk = 256;

// acc + sum_{s < n} q_s * rsqrt(|x_t - x_s|^2), with r^2 == 0 adding 0 and
// r^2 clamped at 1e-30 before the rsqrt (the reference's guard).
__device__ __forceinline__ float tile_accumulate(float acc, float xt, float yt,
                                                 float zt,
                                                 const float4* __restrict__ src,
                                                 int n) {
#pragma unroll 4
  for (int s = 0; s < n; ++s) {
    const float4 b = src[s];
    const float dx = __fsub_rn(xt, b.x);
    const float dy = __fsub_rn(yt, b.y);
    const float dz = __fsub_rn(zt, b.z);
    const float r2 = __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
    const float inv = r2 > 0.0f ? rsqrtf(fmaxf(r2, 1e-30f)) : 0.0f;
    acc = __fmaf_rn(b.w, inv, acc);
  }
  return acc;
}

}  // namespace repro_p2p
