// Kernel A as a simulation sweep: every path through all P steps of the exact
// OU model in one launch, its normals drawn in registers.
//
// Replaces the TPU kernel storage_tpu/ops/rng_kernel.py:normal_halves_pallas
// together with what the JAX package does with its output
// (storage_tpu/models/spot_sim.py:simulate_ou_paths: a lax.scan of
// x_k = decay_k * x_{k-1} + L_k z_k, then one fused spot pass).  For path s
// and step k the F draws are the words W = k*F + i of path ids[s]: word W is
// half W%2 of the threefry block of counter (ids[s], W/2), sent to a normal as
// kernel A does (threefry.cuh) and multiplied by the antithetic sign.  Then
//   x_k,i = decay_k,i * x_{k-1},i + sum_j L_k,ij z_k,j     (j left to right)
//   ln S_k = sum_i vols_k,i x_k,i (i left to right) + c_k,  S_k = expf(ln S_k)
// with c_k = ln F_k - half_var_k from the wrapper.  Every product and sum is
// explicitly rounded (__fmul_rn / __fadd_rn, no FMA contraction) in the order
// of the plain version, ops/rng_kernel.py:simulate_sweep_plain, so that both
// give the same bits.
//
// A sweep may resume: it starts at step `start` from the entry state x_in
// (x_{start-1}, zeros where NULL), its step tables sliced from `start`, its
// draws the words W = (start + k)*F + i.  Where start*F is odd its first word
// is the second half of block (start*F)/2: that block is hashed first and its
// second word kept as the spare.  The state leaving the sweep is its last
// factor row.  A resumed sweep's rows are those of one long sweep, to the bit
// (the streamed engine, engines/lsmc.py, regenerates its segments so).
//
// Bound on the H100: instruction issue.  Per path and step: F normals and F/2
// hashes (~190 unfused f32 and ~120 integer operations at F=3) against
// (F+1)*4 bytes written; the normals never reach device memory.  Design: one
// thread per path, 256 a block, neighbouring threads on neighbouring paths so
// that every row of factors and spot is written coalesced; x and the step's z
// in registers (F is a template parameter, 1..kMaxF); the step tables are
// warp-uniform reads through L1; a thread hashes a block when it needs its
// first word and keeps the second word for the next draw.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

template <int F>
__global__ void __launch_bounds__(kThreads) sim_sweep_kernel(
    uint32_t k0, uint32_t k1, uint32_t start, int P, int S, const uint32_t* __restrict__ ids,
    const float* __restrict__ sign, const float* __restrict__ x_in, const float* __restrict__ decay,
    const float* __restrict__ chol, const float* __restrict__ vols,
    const float* __restrict__ c, float* __restrict__ factors, float* __restrict__ spot) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  const uint32_t hi = ids[s];
  const float sg = sign != nullptr ? sign[s] : 1.0f;
  float x[F];
#pragma unroll
  for (int i = 0; i < F; ++i) x[i] = x_in != nullptr ? x_in[static_cast<size_t>(i) * S + s] : 0.0f;
  const uint32_t w0 = start * static_cast<uint32_t>(F);
  uint32_t block = w0 / 2;  // the counter block of the next word
  uint32_t spare = 0;       // the second word of `block`, once hashed
  bool have_spare = (w0 & 1u) != 0;
  if (have_spare) {  // the first word is the second half of its block
    uint32_t x0 = hi;
    uint32_t x1 = block;
    stt::threefry2x32(k0, k1, x0, x1);
    spare = x1;
  }
  for (int k = 0; k < P; ++k) {
    float z[F];
#pragma unroll
    for (int i = 0; i < F; ++i) {
      uint32_t bits;
      if (have_spare) {
        bits = spare;
        ++block;
      } else {
        uint32_t x0 = hi;
        uint32_t x1 = block;
        stt::threefry2x32(k0, k1, x0, x1);
        bits = x0;
        spare = x1;
      }
      have_spare = !have_spare;
      z[i] = stt::bits_to_normal(bits);
      if (sign != nullptr) z[i] = __fmul_rn(z[i], sg);
    }
    const float* dk = decay + static_cast<size_t>(k) * F;
    const float* lk = chol + static_cast<size_t>(k) * F * F;
    const float* vk = vols + static_cast<size_t>(k) * F;
    float ln_s = 0.0f;
#pragma unroll
    for (int i = 0; i < F; ++i) {
      float lz = __fmul_rn(__ldg(lk + i * F), z[0]);
#pragma unroll
      for (int j = 1; j < F; ++j) lz = __fadd_rn(lz, __fmul_rn(__ldg(lk + i * F + j), z[j]));
      x[i] = __fadd_rn(__fmul_rn(x[i], __ldg(dk + i)), lz);
      factors[(static_cast<size_t>(k) * F + i) * S + s] = x[i];
      const float term = __fmul_rn(__ldg(vk + i), x[i]);
      ln_s = i == 0 ? term : __fadd_rn(ln_s, term);
    }
    spot[static_cast<size_t>(k) * S + s] = expf(__fadd_rn(ln_s, __ldg(c + k)));
  }
}

using SweepKernel = decltype(&sim_sweep_kernel<1>);

static_assert(stt::kMaxF == 8, "sweep_kernel instantiates F = 1..8");

SweepKernel sweep_kernel(int F) {
  switch (F) {
    case 1: return sim_sweep_kernel<1>;
    case 2: return sim_sweep_kernel<2>;
    case 3: return sim_sweep_kernel<3>;
    case 4: return sim_sweep_kernel<4>;
    case 5: return sim_sweep_kernel<5>;
    case 6: return sim_sweep_kernel<6>;
    case 7: return sim_sweep_kernel<7>;
    case 8: return sim_sweep_kernel<8>;
    default: return nullptr;
  }
}

}  // namespace

// factors [P, F, S] and spot [P, S] of steps start..start+P-1 of the paths
// ids [S] (uint32 identities; sign [S] f32 or NULL) from the entry state x_in
// [F, S] (NULL: zeros) and the step tables of those steps, decay [P, F], chol
// [P, F, F], vols [P, F] and c [P].
extern "C" int stt_simulate_sweep(uint32_t k0, uint32_t k1, uint32_t start, int P, int F, int S,
                                  const void* ids, const void* sign, const void* x_in,
                                  const void* decay, const void* chol, const void* vols,
                                  const void* c, void* factors, void* spot, void* stream) {
  const SweepKernel kernel = sweep_kernel(F);
  if (kernel == nullptr || P < 0 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0 || S == 0) return 0;
  kernel<<<(S + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      k0, k1, start, P, S, static_cast<const uint32_t*>(ids), static_cast<const float*>(sign),
      static_cast<const float*>(x_in), static_cast<const float*>(decay), static_cast<const float*>(chol),
      static_cast<const float*>(vols), static_cast<const float*>(c),
      static_cast<float*>(factors), static_cast<float*>(spot));
  return static_cast<int>(cudaGetLastError());
}

// Launch report of the sweep at F factors into out[6] (stt::kernel_info; it
// takes no shared memory, so the grid field out[3] means nothing here).
extern "C" int stt_simulate_sweep_info(int F, int* out) {
  const SweepKernel kernel = sweep_kernel(F);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(stt::kernel_info(kernel, kThreads, 0, 1, 0, out));
}
