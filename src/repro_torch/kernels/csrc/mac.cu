// K3: the MAC (multipole acceptance criterion) margin of a pair frontier, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mac.py::mac_margins (body
// _mac_kernel).  For every (target, source) cell pair k of one frontier
// generation of the device dual traversal:
//
//     margin[k] = theta * |c_a[k] - c_b[k]| - (r_a[k] + r_b[k])
//
// accepted for M2L iff margin > 0.  Inputs: ca, cb (K, 3), ra, rb (K,), all
// float32 and contiguous; output (K,) float32.
//
// What bounds it on this card: each pair reads 3 + 1 + 3 + 1 floats and
// writes one (36 bytes) for about a dozen float32 operations, so it is bound
// by device-memory bytes; at the traversal's frontier sizes (10^4 to 10^6
// pairs) a launch is closer to launch latency than to either bound.  The
// design is one thread per pair in 128-thread blocks, each thread reading
// its own 8 floats once and writing one: nothing is staged or reused, so
// shared memory would only add a copy.
//
// Every step is an explicit round-to-nearest intrinsic in the plain
// version's order, d = sqrt((dx*dx + dy*dy) + dz*dz): nvcc may neither
// contract a multiply and an add into an fma nor reorder the sum.  The
// margin's bits decide which pairs are accepted, so the kernel must equal
// its plain PyTorch version (kernels/mac.py::mac_margins_ref) bit for bit,
// and a traversal through it must emit the same pair lists as one through
// the plain version.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;

__global__ void mac_margins_kernel(const float* __restrict__ ca,
                                   const float* __restrict__ ra,
                                   const float* __restrict__ cb,
                                   const float* __restrict__ rb, float theta,
                                   float* __restrict__ out, int64_t K) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const float dx = __fsub_rn(ca[3 * k + 0], cb[3 * k + 0]);
  const float dy = __fsub_rn(ca[3 * k + 1], cb[3 * k + 1]);
  const float dz = __fsub_rn(ca[3 * k + 2], cb[3 * k + 2]);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  const float d = __fsqrt_rn(d2);
  out[k] = __fsub_rn(__fmul_rn(theta, d), __fadd_rn(ra[k], rb[k]));
}

}  // namespace

extern "C" {

// Launches K3 on `stream` (a cudaStream_t); returns cudaGetLastError().
int repro_mac_margins(const void* ca, const void* ra, const void* cb,
                      const void* rb, float theta, void* out, long long K,
                      void* stream) {
  if (K <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (K + kBlock - 1) / kBlock;
  mac_margins_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ca), static_cast<const float*>(ra),
      static_cast<const float*>(cb), static_cast<const float*>(rb), theta,
      static_cast<float*>(out), static_cast<int64_t>(K));
  return static_cast<int>(cudaGetLastError());
}

const char* repro_mac_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
