// Kernel B: one backward LSMC step — the decision update plus the regression
// moments of the next step.
//
// Replaces the TPU kernel storage_tpu/ops/decision_kernel.py:
// decision_update_moments_pallas (_kernel_moments).  For every inventory grid
// point g and sim s it takes the decision whose REGRESSED value is largest
// (strict >, decision 0 first, so ties keep the earlier decision) and realises
// its ACTUAL value:
//   actual continuation   v[lo, s]·(1 − w) + v[lo + 1, s]·w   (lo, w per (g, d))
//   regressed gap         Σ_b dci[d, g, b]·dm[b, s]            (dci = ci − ci[0])
//   immediate value       a[d, g]·spot[s] + b[d, g]
// and accumulates step t−1's XᵀX [B, B] and (Xᵀ·best_act)ᵀ [G, B] in the
// coordinates standardised by (mean_prev, std_prev) — the TPU kernel's
// u-coordinates when those are this step's (mean, std).
//
// Bound on the H100: device memory.  Per step it must read the value panel v
// [G, S] (105 MB at G=100, S=262,144) and write best_act [G, S]; the arithmetic
// (~G·(2D + (D−1)·B + B) flops per sim) is far below the card's rate.  Design:
//   * one thread per sim column, 128 sims per block; every (g, d) reads the two
//     v rows it interpolates, so neighbouring threads read neighbouring words
//     (coalesced) and no [G, D, S] intermediate touches device memory;
//   * the per-step tables (dci, a, b, idx_lo, w_hi, mean, std) go to shared
//     memory once per block; the design rows live in registers;
//   * the interpolation is the two-row gather — the TPU's dense one-hot matmul
//     W[d] @ v and its bf16 hi/lo split are not carried over: plain f32;
//   * best_act goes to a separate buffer (the caller ping-pongs two), never
//     over v: a later g of the same column still reads rows an in-place write
//     would already have replaced;
//   * the moments: best_act and the previous step's design rows are staged in
//     shared memory, each block writes its partial sums, and a second small
//     kernel reduces them in a fixed order — no float atomics, the same bits on
//     every run (CUDA blocks, unlike the TPU grid, run in no order).
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "decision_step.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPitch = kThreads + 1;  // padded smem rows: no bank conflicts

__global__ void decision_moments_kernel(
    int G, int S, int D, stt::Basis basis,
    const float* __restrict__ v, const float* __restrict__ spot,
    const float* __restrict__ factors, const float* __restrict__ spot_prev,
    const float* __restrict__ factors_prev, const float* __restrict__ mean_g,
    const float* __restrict__ std_g, const float* __restrict__ mean_prev_g,
    const float* __restrict__ std_prev_g, const int* __restrict__ idx_lo_g,
    const float* __restrict__ w_hi_g, const float* __restrict__ dci_g,
    const float* __restrict__ a_g, const float* __restrict__ b_g,
    float* __restrict__ best_out, float* __restrict__ partials) {
  const int B = basis.nb;
  const int F = basis.nf;
  extern __shared__ float smem[];
  const stt::DecisionTables tab =
      stt::load_decision_tables(smem, G, D, B, dci_g, a_g, b_g, w_hi_g, idx_lo_g);
  float* mean = smem + stt::decision_tables_words(G, D, B);  // [B]
  float* stdv = mean + B;             // [B]
  float* mean_prev = stdv + B;        // [B]
  float* std_prev = mean_prev + B;    // [B]
  float* best_tile = std_prev + B;    // [G, kPitch]
  float* dmp_tile = best_tile + G * kPitch;  // [B, kPitch]

  const int tid = threadIdx.x;
  for (int i = tid; i < B; i += kThreads) {
    mean[i] = mean_g[i];
    stdv[i] = std_g[i];
    mean_prev[i] = mean_prev_g[i];
    std_prev[i] = std_prev_g[i];
  }
  __syncthreads();

  const int s = blockIdx.x * kThreads + tid;
  const bool valid = s < S;
  float fac[stt::kMaxF];
  float dm[stt::kMaxB];
  float sp = 0.0f;
  if (valid) {
    sp = spot[s];
#pragma unroll
    for (int f = 0; f < stt::kMaxF; ++f)
      fac[f] = f < F ? factors[static_cast<size_t>(f) * S + s] : 0.0f;
    stt::design_row(basis, sp, fac, mean, stdv, dm);
  }

  for (int g = 0; g < G; ++g) {
    float best_act = 0.0f;
    if (valid) {
      best_act = stt::decide(tab, G, D, B, g, v, S, s, sp, dm);
      best_out[static_cast<size_t>(g) * S + s] = best_act;
    }
    best_tile[g * kPitch + tid] = best_act;
  }

  // Step t-1's design rows, standardised by (mean_prev, std_prev).
  if (valid) {
    const float spp = spot_prev[s];
#pragma unroll
    for (int f = 0; f < stt::kMaxF; ++f)
      fac[f] = f < F ? factors_prev[static_cast<size_t>(f) * S + s] : 0.0f;
    stt::design_row(basis, spp, fac, mean_prev, std_prev, dm);
  }
#pragma unroll
  for (int k = 0; k < stt::kMaxB; ++k)
    if (k < B) dmp_tile[k * kPitch + tid] = valid ? dm[k] : 0.0f;
  __syncthreads();

  // Block partials: XᵀX pairs first, then (Xᵀ·best_act)ᵀ as [G, B].
  const int nblk = gridDim.x;
  const int npairs = B * B + G * B;
  for (int p = tid; p < npairs; p += kThreads) {
    const float* x;
    const float* y;
    if (p < B * B) {
      x = dmp_tile + (p / B) * kPitch;
      y = dmp_tile + (p % B) * kPitch;
    } else {
      const int q = p - B * B;
      x = best_tile + (q / B) * kPitch;
      y = dmp_tile + (q % B) * kPitch;
    }
    float acc = 0.0f;
    for (int t = 0; t < kThreads; ++t) acc = fmaf(x[t], y[t], acc);
    partials[static_cast<size_t>(p) * nblk + blockIdx.x] = acc;
  }
}

}  // namespace

namespace stt {

cudaError_t launch_decision_moments(
    int G, int S, int D, const Basis& basis, const float* v, const float* spot,
    const float* factors, const float* spot_prev, const float* factors_prev,
    const float* mean, const float* stdv, const float* mean_prev,
    const float* std_prev, const int* idx_lo, const float* w_hi,
    const float* dci, const float* a, const float* b, float* best_out,
    float* partials, float* moments, cudaStream_t stream) {
  const int B = basis.nb;
  const int nblk = (S + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) *
      (decision_tables_words(G, D, B) + 4 * B + static_cast<size_t>(G + B) * kPitch);
  cudaError_t err = cudaFuncSetAttribute(
      decision_moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  decision_moments_kernel<<<nblk, kThreads, smem, stream>>>(
      G, S, D, basis, v, spot, factors, spot_prev, factors_prev, mean, stdv,
      mean_prev, std_prev, idx_lo, w_hi, dci, a, b, best_out, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  launch_reduce(partials, nblk, B * B + G * B, moments, stream);
  return cudaGetLastError();
}

}  // namespace stt

extern "C" int stt_decision_update_moments(
    int G, int S, int F, int D, const int* basis_table, const void* v,
    const void* spot, const void* factors, const void* spot_prev,
    const void* factors_prev, const void* mean, const void* stdv,
    const void* mean_prev, const void* std_prev, const void* idx_lo,
    const void* w_hi, const void* dci, const void* a, const void* b,
    void* best_out, void* partials, void* moments, void* stream) {
  stt::Basis basis;
  if (!stt::make_basis(basis_table, F, &basis) || G < 2 || D < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(stt::launch_decision_moments(
      G, S, D, basis, static_cast<const float*>(v),
      static_cast<const float*>(spot), static_cast<const float*>(factors),
      static_cast<const float*>(spot_prev),
      static_cast<const float*>(factors_prev), static_cast<const float*>(mean),
      static_cast<const float*>(stdv), static_cast<const float*>(mean_prev),
      static_cast<const float*>(std_prev), static_cast<const int*>(idx_lo),
      static_cast<const float*>(w_hi), static_cast<const float*>(dci),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(best_out), static_cast<float*>(partials),
      static_cast<float*>(moments), static_cast<cudaStream_t>(stream)));
}
