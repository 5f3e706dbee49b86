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
// Tile i reads the source slab payload[:, src_start : src_start + smax] with
// q masked to 0 past src_len, and the target slab
// payload[:, tgt_start : tgt_start + block_t]; every target lane gets
// sum_s q_s * rsqrt(r^2) (r^2 == 0 adds 0), lanes past tgt_len included, as
// in the reference (the caller's out_valid drops them).  Dead tiles
// (tgt_len == 0) load nothing and write zeros.
//
// What bounds it on this card: the same few float32 operations per pair as
// K1 against 16 bytes per source and target read from the payload, so it is
// bound by device-memory bytes; unlike K1 it reads the payload in place and
// never materialises gathered operands.  There is no scalar prefetch on this
// card: each block reads its own meta row.  One block per tile, one thread
// per target lane; the source slab is staged once in shared memory and every
// lane runs the tile body shared with K1 (p2p_common.cuh), so on identical
// slabs the two kernels agree bit for bit.  The TPU kernel's DMA double
// buffering has no counterpart yet: the card overlaps one block's loads with
// other blocks' arithmetic.

#include <cstdint>

#include "p2p_common.cuh"

namespace {

using repro_p2p::kSrcChunk;
using repro_p2p::tile_accumulate;

__global__ void p2p_stream_kernel(const int* __restrict__ meta,
                                  const float* __restrict__ pay,
                                  float* __restrict__ out, int64_t F,
                                  int block_t, int smax, int chunk) {
  extern __shared__ float4 src[];
  const int64_t tile = blockIdx.x;
  const int src_start = meta[4 * tile + 0];
  const int src_len = meta[4 * tile + 1];
  const int tgt_start = meta[4 * tile + 2];
  const int tgt_len = meta[4 * tile + 3];
  float* o = out + tile * block_t;
  if (tgt_len <= 0) {  // dead tile: uniform across the block
    for (int t = threadIdx.x; t < block_t; t += blockDim.x) o[t] = 0.0f;
    return;
  }
  const float* px = pay;
  const float* py = pay + F;
  const float* pz = pay + 2 * F;
  const float* pq = pay + 3 * F;

  for (int t0 = 0; t0 < block_t; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    const bool tl = t < block_t;
    const int64_t g = static_cast<int64_t>(tgt_start) + t;
    const bool gin = tl && g >= 0 && g < F;
    const float x = gin ? px[g] : 0.0f;
    const float y = gin ? py[g] : 0.0f;
    const float z = gin ? pz[g] : 0.0f;
    float acc = 0.0f;
    for (int c0 = 0; c0 < smax; c0 += chunk) {
      const int n = min(chunk, smax - c0);
      __syncthreads();
      for (int s = threadIdx.x; s < n; s += blockDim.x) {
        const int64_t j = static_cast<int64_t>(src_start) + c0 + s;
        const bool in = j >= 0 && j < F;
        const float qv = (in && c0 + s < src_len) ? pq[j] : 0.0f;
        src[s] = make_float4(in ? px[j] : 0.0f, in ? py[j] : 0.0f,
                             in ? pz[j] : 0.0f, qv);
      }
      __syncthreads();
      if (tl) acc = tile_accumulate(acc, x, y, z, src, n);
    }
    if (tl) o[t] = acc;
  }
}

}  // namespace

extern "C" {

// Launches K2 on `stream` (a cudaStream_t); returns cudaGetLastError().
int repro_p2p_stream(const void* meta, const void* payload, void* out,
                     long long n_tiles, long long F, int block_t, int smax,
                     void* stream) {
  if (n_tiles <= 0 || block_t <= 0) return static_cast<int>(cudaSuccess);
  const int threads = block_t < 256 ? ((block_t + 31) / 32) * 32 : 256;
  int chunk = smax < kSrcChunk ? smax : kSrcChunk;
  if (chunk < 1) chunk = 1;
  const size_t smem = static_cast<size_t>(chunk) * sizeof(float4);
  p2p_stream_kernel<<<static_cast<unsigned>(n_tiles), threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(meta), static_cast<const float*>(payload),
      static_cast<float*>(out), static_cast<int64_t>(F), block_t, smax,
      chunk);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_p2p_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
