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
// What bounds it on this card: at the engine's shapes (T = 64, S = 8..64) a
// (target, source) pair costs 11 float32 operations (an fma counted as 2),
// and each row reads 12 bytes per target and 16 per source and writes 4 per
// target, so the whole launch moves more bytes than its arithmetic can hide:
// it is bound by device-memory bytes, not by the float32 rate.  The design therefore reads
// every input exactly once: a block takes a few rows, stages each row's
// sources once in shared memory (16-byte {x, y, z, q} records), and gives
// every target its own thread, which keeps its position and its sum in
// registers and writes one float.  The TPU kernel's 128-lane target tiles
// and VMEM budget do not carry over: a block is 256 threads, as many rows as
// fit (4 rows of 64 targets at T = 64).

#include <cstdint>

#include "p2p_common.cuh"

namespace {

using repro_p2p::kSrcChunk;
using repro_p2p::tile_accumulate;

// Block: (bx, by) threads; row = blockIdx.x * by + threadIdx.y; a thread
// takes targets threadIdx.x, threadIdx.x + bx, ...  Shared memory holds
// `chunk` sources for each of the block's rows.
__global__ void p2p_gathered_kernel(const float* __restrict__ q,
                                    const float* __restrict__ xs,
                                    const float* __restrict__ xt,
                                    float* __restrict__ out, int64_t P, int S,
                                    int T, int chunk) {
  extern __shared__ float4 smem[];
  const int ty = threadIdx.y;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.y + ty;
  const bool live = row < P;
  float4* src = smem + ty * chunk;
  const float* qrow = q + row * S;
  const float* srow = xs + row * S * 3;
  const float* trow = xt + row * T * 3;

  // Every loop bound below is uniform across the block, so all threads
  // reach each __syncthreads().
  for (int t0 = 0; t0 < T; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    const bool tl = live && t < T;
    float x = 0.0f, y = 0.0f, z = 0.0f;
    if (tl) {
      x = trow[3 * t + 0];
      y = trow[3 * t + 1];
      z = trow[3 * t + 2];
    }
    float acc = 0.0f;
    for (int c0 = 0; c0 < S; c0 += chunk) {
      const int n = min(chunk, S - c0);
      __syncthreads();
      if (live) {
        for (int s = threadIdx.x; s < n; s += blockDim.x) {
          const int j = c0 + s;
          src[s] = make_float4(srow[3 * j + 0], srow[3 * j + 1],
                               srow[3 * j + 2], qrow[j]);
        }
      }
      __syncthreads();
      if (tl) acc = tile_accumulate(acc, x, y, z, src, n);
    }
    if (tl) out[row * T + t] = acc;
  }
}

}  // namespace

extern "C" {

// Launches K1 on `stream` (a cudaStream_t); returns cudaGetLastError().
int repro_p2p_gathered(const void* q, const void* x_src, const void* x_tgt,
                       void* out, long long P, int S, int T, void* stream) {
  if (P <= 0 || T <= 0) return static_cast<int>(cudaSuccess);
  int bx = 32;
  while (bx < T && bx < 256) bx <<= 1;
  const int by = 256 / bx;
  int chunk = S < kSrcChunk ? S : kSrcChunk;
  if (chunk < 1) chunk = 1;
  const long long blocks = (P + by - 1) / by;
  const size_t smem = static_cast<size_t>(by) * chunk * sizeof(float4);
  p2p_gathered_kernel<<<static_cast<unsigned>(blocks), dim3(bx, by), smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(x_src),
      static_cast<const float*>(x_tgt), static_cast<float*>(out),
      static_cast<int64_t>(P), S, T, chunk);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_p2p_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
