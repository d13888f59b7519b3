// The counter draw shared by kernel A (rng_kernel.cu) and the simulation
// sweep (sim_sweep.cu): the threefry-2x32 hash with the 20 rounds JAX uses
// (rotations 13,15,26,6 / 17,29,16,24, five key injections), and one 32-bit
// word to a standard normal by the mantissa trick and sqrt(2)*erfinv(u), with
// erfinv transcribed from XLA's f32 erf_inv (Giles' polynomial).  The
// polynomial uses explicitly rounded multiply and add (no FMA contraction, no
// fast math) to stay op-for-op with XLA's lowering and with the plain
// versions in ops/rng_kernel.py.  One copy, so both kernels draw the same bits.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace stt {

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

}  // namespace stt
