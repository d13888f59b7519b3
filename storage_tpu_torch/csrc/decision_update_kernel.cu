// Kernel D: the backward LSMC decision update on a precomputed standardised
// design, without moments.
//
// Replaces the TPU kernel storage_tpu/ops/decision_kernel.py:
// decision_update_pallas (_kernel).  The JAX engine runs it in its plain
// backward body, the branch taken when the panels carry no factor
// (value_from_sims on spot-only panels): there the design rows come from the
// caller's standardised design dm_std_t [B, S] instead of being built from
// spot and factors, and the regression is fitted outside the kernel, so no
// moments are accumulated.  The decision arithmetic is kernel B's
// (decision_step.cuh: strict >, decision 0 first, centred gaps, two-row
// gather of v).
//
// Bound on the H100: device memory.  Per step it must read v [G, S] (105 MB at
// G=100, S=262,144), dm_std_t [B, S] and spot, and write best_act [G, S]:
// about 215 MB, ~64 us at 3.35 TB/s; the arithmetic (~G·(D·6 + (D−1)·2B)
// flops per sim) is far below the card's rate.  Design, as simple as B's:
//   * one thread per sim column, 128 sims per block; the B design entries of
//     the column are read coalesced from dm_std_t into registers;
//   * the per-step tables (dci, a, b, idx_lo, w_hi) go to shared memory once
//     per block;
//   * best_act goes to a separate buffer (the engine's spare [G, S] panel),
//     never over v: a later g of the same column still reads v rows that an
//     in-place write (the TPU's input_output_aliases) would have replaced.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "decision_step.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void decision_update_kernel(
    int G, int S, int D, int B, const float* __restrict__ v,
    const float* __restrict__ dm_std_t, const float* __restrict__ spot,
    const int* __restrict__ idx_lo_g, const float* __restrict__ w_hi_g,
    const float* __restrict__ dci_g, const float* __restrict__ a_g,
    const float* __restrict__ b_g, float* __restrict__ best_out) {
  extern __shared__ float smem[];
  const stt::DecisionTables tab =
      stt::load_decision_tables(smem, G, D, B, dci_g, a_g, b_g, w_hi_g, idx_lo_g);
  __syncthreads();

  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  const float sp = spot[s];
  float dm[stt::kMaxB];
#pragma unroll
  for (int k = 0; k < stt::kMaxB; ++k)
    dm[k] = k < B ? dm_std_t[static_cast<size_t>(k) * S + s] : 0.0f;
  for (int g = 0; g < G; ++g)
    best_out[static_cast<size_t>(g) * S + s] = stt::decide(tab, G, D, B, g, v, S, s, sp, dm);
}

}  // namespace

extern "C" int stt_decision_update(
    int G, int S, int D, int B, const void* v, const void* dm_std_t,
    const void* spot, const void* idx_lo, const void* w_hi, const void* dci,
    const void* a, const void* b, void* best_out, void* stream) {
  if (G < 2 || D < 1 || S < 1 || B < 1 || B > stt::kMaxB)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nblk = (S + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * stt::decision_tables_words(G, D, B);
  cudaError_t err = cudaFuncSetAttribute(
      decision_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  decision_update_kernel<<<nblk, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      G, S, D, B, static_cast<const float*>(v), static_cast<const float*>(dm_std_t),
      static_cast<const float*>(spot), static_cast<const int*>(idx_lo),
      static_cast<const float*>(w_hi), static_cast<const float*>(dci),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(best_out));
  return static_cast<int>(cudaGetLastError());
}

// Kernel D's launch report at (G, D, B) on the current device (common.cuh:
// kernel_info).
extern "C" int stt_decision_update_info(int G, int D, int B, int* out) {
  if (G < 0 || D < 1 || B < 1 || B > stt::kMaxB) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(stt::kernel_info(decision_update_kernel, kThreads, 0,
                                           stt::decision_tables_words(1, D, B), G, out));
}
