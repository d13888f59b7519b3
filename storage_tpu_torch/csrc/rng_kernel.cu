// Kernel A: threefry-2x32 counter normals in block halves.
//
// Replaces the TPU kernel storage_tpu/ops/rng_kernel.py:normal_halves_pallas
// (_normal_halves_kernel / _normal_halves_signed_kernel, threefry2x32,
// _bits_to_normal_f32).  For every (row, path) pair it hashes the counter
// (ids[s], b0 + row) under the fixed key and sends both words to standard
// normals (threefry.cuh, shared with the simulation sweep), so the draws are
// those of the JAX package to a few ULP.
//
// This is the draw-only entry: the valuation's paths come from the
// simulation sweep (sim_sweep.cu), which draws the same words in registers
// and writes no normals.  Bound on the H100: instruction issue.  Each pair
// costs ~80 integer operations of hashing (at half the f32 lanes) and two
// log1p + 9-term polynomials of unfused f32 operations, against 8 bytes of
// output; nothing is read but ids/sign.  Design: one thread per (row, path),
// neighbouring threads on neighbouring paths so the two output rows are
// written coalesced; the counters are built in registers, so the only
// device-memory traffic is the output.
#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

using stt::bits_to_normal;
using stt::threefry2x32;

__global__ void normal_halves_kernel(uint32_t k0, uint32_t k1, uint32_t b0,
                                     int nb, int num_paths,
                                     const uint32_t* __restrict__ ids,
                                     const float* __restrict__ sign,
                                     float* __restrict__ z1,
                                     float* __restrict__ z2) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= num_paths) return;
  const uint32_t hi = ids[s];
  const float sg = sign != nullptr ? sign[s] : 1.0f;
  for (int row = blockIdx.y; row < nb; row += gridDim.y) {
    uint32_t x0 = hi;
    uint32_t x1 = b0 + static_cast<uint32_t>(row);
    threefry2x32(k0, k1, x0, x1);
    float a = bits_to_normal(x0);
    float b = bits_to_normal(x1);
    if (sign != nullptr) {
      a = __fmul_rn(a, sg);
      b = __fmul_rn(b, sg);
    }
    const size_t o = static_cast<size_t>(row) * num_paths + s;
    z1[o] = a;
    z2[o] = b;
  }
}

// The raw words alone, so a check can hold the hash bit for bit.
__global__ void threefry_words_kernel(uint32_t k0, uint32_t k1, uint32_t b0,
                                      int nb, int num_paths,
                                      const uint32_t* __restrict__ ids,
                                      uint32_t* __restrict__ w1,
                                      uint32_t* __restrict__ w2) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= num_paths) return;
  for (int row = blockIdx.y; row < nb; row += gridDim.y) {
    uint32_t x0 = ids[s];
    uint32_t x1 = b0 + static_cast<uint32_t>(row);
    threefry2x32(k0, k1, x0, x1);
    const size_t o = static_cast<size_t>(row) * num_paths + s;
    w1[o] = x0;
    w2[o] = x1;
  }
}

}  // namespace

extern "C" int stt_threefry_words(uint32_t k0, uint32_t k1, uint32_t b0, int nb,
                                  int num_paths, const void* ids, void* w1,
                                  void* w2, void* stream) {
  if (nb <= 0 || num_paths <= 0) return 0;
  const int threads = 256;
  dim3 grid((num_paths + threads - 1) / threads, nb < 65535 ? nb : 65535);
  threefry_words_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      k0, k1, b0, nb, num_paths, static_cast<const uint32_t*>(ids),
      static_cast<uint32_t*>(w1), static_cast<uint32_t*>(w2));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stt_normal_halves(uint32_t k0, uint32_t k1, uint32_t b0, int nb,
                                 int num_paths, const void* ids,
                                 const void* sign, void* z1, void* z2,
                                 void* stream) {
  if (nb <= 0 || num_paths <= 0) return 0;
  const int threads = 256;
  dim3 grid((num_paths + threads - 1) / threads, nb < 65535 ? nb : 65535);
  normal_halves_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      k0, k1, b0, nb, num_paths, static_cast<const uint32_t*>(ids),
      static_cast<const float*>(sign), static_cast<float*>(z1),
      static_cast<float*>(z2));
  return static_cast<int>(cudaGetLastError());
}
