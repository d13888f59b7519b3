// Kernel A: threefry-2x32 counter normals in block halves.
//
// Replaces the TPU kernel storage_tpu/ops/rng_kernel.py:normal_halves_pallas
// (_normal_halves_kernel / _normal_halves_signed_kernel, threefry2x32,
// _bits_to_normal_f32).  For every (row, path) pair it hashes the counter
// (ids[s], b0 + row) under the fixed key with the 20 threefry rounds JAX uses
// (rotations 13,15,26,6 / 17,29,16,24, five key injections) and sends both
// words through the mantissa trick to u in (-1, 1) and on to sqrt(2)*erfinv(u),
// with erfinv transcribed from XLA's f32 erf_inv (Giles' polynomial), so the
// draws are those of the JAX package to a few ULP.
//
// Bound on the H100: compute.  Each pair costs ~100 integer ops of hashing and
// two log1p + 9-term polynomials, against 8 bytes of output; nothing is read
// but ids/sign.  Design: one thread per (row, path), neighbouring threads on
// neighbouring paths so the two output rows are written coalesced; the
// counters are built in registers, so the only device-memory traffic is the
// output.  The polynomial uses explicitly rounded multiply and add (no FMA
// contraction, no fast math) to stay op-for-op with XLA's lowering.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

#define STT_ROUND(r)   \
  x0 += x1;            \
  x1 = rotl(x1, (r));  \
  x1 ^= x0;

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  STT_ROUND(13) STT_ROUND(15) STT_ROUND(26) STT_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  STT_ROUND(17) STT_ROUND(29) STT_ROUND(16) STT_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  STT_ROUND(13) STT_ROUND(15) STT_ROUND(26) STT_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  STT_ROUND(17) STT_ROUND(29) STT_ROUND(16) STT_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  STT_ROUND(13) STT_ROUND(15) STT_ROUND(26) STT_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}

#undef STT_ROUND

// XLA's f32 erf_inv (xla/hlo/builder/lib/math.cc, ErfInv32).
__device__ __forceinline__ float erfinv_xla(float x) {
  const float w0 = -log1pf(-__fmul_rn(x, x));
  float w, p;
  if (w0 < 5.0f) {
    w = __fsub_rn(w0, 2.5f);
    p = 2.81022636e-08f;
    p = __fadd_rn(3.43273939e-07f, __fmul_rn(p, w));
    p = __fadd_rn(-3.5233877e-06f, __fmul_rn(p, w));
    p = __fadd_rn(-4.39150654e-06f, __fmul_rn(p, w));
    p = __fadd_rn(0.00021858087f, __fmul_rn(p, w));
    p = __fadd_rn(-0.00125372503f, __fmul_rn(p, w));
    p = __fadd_rn(-0.00417768164f, __fmul_rn(p, w));
    p = __fadd_rn(0.246640727f, __fmul_rn(p, w));
    p = __fadd_rn(1.50140941f, __fmul_rn(p, w));
  } else {
    w = __fsub_rn(sqrtf(w0), 3.0f);
    p = -0.000200214257f;
    p = __fadd_rn(0.000100950558f, __fmul_rn(p, w));
    p = __fadd_rn(0.00134934322f, __fmul_rn(p, w));
    p = __fadd_rn(-0.00367342844f, __fmul_rn(p, w));
    p = __fadd_rn(0.00573950773f, __fmul_rn(p, w));
    p = __fadd_rn(-0.0076224613f, __fmul_rn(p, w));
    p = __fadd_rn(0.00943887047f, __fmul_rn(p, w));
    p = __fadd_rn(1.00167406f, __fmul_rn(p, w));
    p = __fadd_rn(2.83297682f, __fmul_rn(p, w));
  }
  const float r = __fmul_rn(p, x);
  return fabsf(x) == 1.0f ? x * __int_as_float(0x7f800000) : r;
}

// Mantissa-packed uniform on [0, 1) -> (-1, 1) -> sqrt(2) * erfinv.
__device__ __forceinline__ float bits_to_normal(uint32_t bits) {
  const float x = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float lo = __int_as_float(0xBF7FFFFF);  // nextafter(-1, 0)
  const float u = fmaxf(__fsub_rn(__fmul_rn(x, 2.0f), 1.0f), lo);
  return __fmul_rn(1.41421354f, erfinv_xla(u));
}

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
