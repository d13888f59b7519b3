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
// in registers (F is a template parameter, 1..kMaxRegisterF); the step tables
// are warp-uniform reads through L1; a thread hashes a block when it needs
// its first word and keeps the second word for the next draw.  Beyond
// kMaxRegisterF factors the wide route (F = 0 below, the count known at run
// time) keeps x and z in shared memory, one column a thread ([F][256] each,
// no bank conflict), and does the same arithmetic in the same order, so it
// gives the plain version's bits too; its shared memory, 2 KB a factor,
// bounds F (sweep_info: max_factors).
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
// The largest factor count whose state and draws stay in registers; beyond
// it the wide route (sim_sweep_kernel<0>).
constexpr int kMaxRegisterF = 12;

// Dynamic shared memory of the wide route at F factors, in bytes: x and z.
inline size_t wide_smem_bytes(int F) { return sizeof(float) * 2 * static_cast<size_t>(F) * kThreads; }

// kF > 0: F = kF, x and z in registers; kF == 0: F = num_factors, x and z in
// shared memory.
template <int kF>
__global__ void __launch_bounds__(kThreads) sim_sweep_kernel(
    int num_factors, uint32_t k0, uint32_t k1, uint32_t start, int P, int S,
    const uint32_t* __restrict__ ids, const float* __restrict__ sign,
    const float* __restrict__ x_in, const float* __restrict__ decay,
    const float* __restrict__ chol, const float* __restrict__ vols,
    const float* __restrict__ c, float* __restrict__ factors, float* __restrict__ spot) {
  extern __shared__ float wide[];  // the wide route's x [F][kThreads], then z [F][kThreads]
  const int F = kF > 0 ? kF : num_factors;
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  float x_reg[kF > 0 ? kF : 1], z_reg[kF > 0 ? kF : 1];
  float* x_wide = wide + threadIdx.x;
  float* z_wide = x_wide + static_cast<size_t>(F) * kThreads;
  auto x = [&](int i) -> float& {
    if constexpr (kF > 0) return x_reg[i]; else return x_wide[i * kThreads];
  };
  auto z = [&](int i) -> float& {
    if constexpr (kF > 0) return z_reg[i]; else return z_wide[i * kThreads];
  };
  const uint32_t hi = ids[s];
  const float sg = sign != nullptr ? sign[s] : 1.0f;
#pragma unroll
  for (int i = 0; i < F; ++i) x(i) = x_in != nullptr ? x_in[static_cast<size_t>(i) * S + s] : 0.0f;
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
  // Draw i of the step (word k·F + i), into z(i).
  auto draw = [&](int i) {
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
    float zi = stt::bits_to_normal(bits);
    if (sign != nullptr) zi = __fmul_rn(zi, sg);
    z(i) = zi;
  };
  for (int k = 0; k < P; ++k) {
    const float* dk = decay + static_cast<size_t>(k) * F;
    const float* lk = chol + static_cast<size_t>(k) * F * F;
    const float* vk = vols + static_cast<size_t>(k) * F;
    float ln_s = 0.0f;
    // Factor i's step, its row and its term of ln S (i in order).
    auto ou_step = [&](int i) {
      float lz = __fmul_rn(__ldg(lk + i * F), z(0));
#pragma unroll
      for (int j = 1; j < F; ++j) lz = __fadd_rn(lz, __fmul_rn(__ldg(lk + i * F + j), z(j)));
      const float xi = __fadd_rn(__fmul_rn(x(i), __ldg(dk + i)), lz);
      x(i) = xi;
      factors[(static_cast<size_t>(k) * F + i) * S + s] = xi;
      const float term = __fmul_rn(__ldg(vk + i), xi);
      ln_s = i == 0 ? term : __fadd_rn(ln_s, term);
    };
    if constexpr (kF > 0) {
#pragma unroll
      for (int i = 0; i < F; ++i) draw(i);
#pragma unroll
      for (int i = 0; i < F; ++i) ou_step(i);
    } else {  // four draws and four factors' chains in flight
#pragma unroll 4
      for (int i = 0; i < F; ++i) draw(i);
#pragma unroll 4
      for (int i = 0; i < F; ++i) ou_step(i);
    }
    spot[static_cast<size_t>(k) * S + s] = expf(__fadd_rn(ln_s, __ldg(c + k)));
  }
}

using SweepKernel = decltype(&sim_sweep_kernel<1>);

static_assert(kMaxRegisterF == 12, "sweep_kernel instantiates F = 1..12");

// The sweep at F factors: compiled for F up to kMaxRegisterF, the wide route
// beyond; NULL for F < 1.
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
    case 9: return sim_sweep_kernel<9>;
    case 10: return sim_sweep_kernel<10>;
    case 11: return sim_sweep_kernel<11>;
    case 12: return sim_sweep_kernel<12>;
    default: return F > kMaxRegisterF ? sim_sweep_kernel<0> : nullptr;
  }
}

// The dynamic shared memory of the sweep at F factors, in bytes.
size_t sweep_smem(int F) { return F > kMaxRegisterF ? wide_smem_bytes(F) : 0; }

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
  const size_t smem = sweep_smem(F);
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(S + kThreads - 1) / kThreads, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      F, k0, k1, start, P, S, static_cast<const uint32_t*>(ids), static_cast<const float*>(sign),
      static_cast<const float*>(x_in), static_cast<const float*>(decay), static_cast<const float*>(chol),
      static_cast<const float*>(vols), static_cast<const float*>(c),
      static_cast<float*>(factors), static_cast<float*>(spot));
  return static_cast<int>(cudaGetLastError());
}

// Launch report of the sweep at F factors into out[6] (stt::kernel_info with
// the wide route's 2 KB of shared memory a factor as the "grid" term, so
// out[3] is the largest F that route takes; the compiled sizes take no
// shared memory).
extern "C" int stt_simulate_sweep_info(int F, int* out) {
  const SweepKernel kernel = sweep_kernel(F);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int per_factor = F > kMaxRegisterF ? 2 * kThreads : 0;
  const cudaError_t err = stt::kernel_info(kernel, kThreads, 0, per_factor > 0 ? per_factor : 1,
                                           per_factor > 0 ? F : 0, out);
  out[3] = per_factor > 0 ? out[3] : kMaxRegisterF;
  return static_cast<int>(err);
}
