// The backward step's decision update for one sim column, run by kernel B
// (decision_kernel.cu) and, through B's kernel, kernel E (fullstep_kernel.cu);
// kernel D (decision_update_kernel.cu) does the same arithmetic in its own
// loop.
//
// For inventory grid point g of sim s it takes the decision whose REGRESSED
// value is largest (strict >, decision 0 first, so ties keep the earlier
// decision) and returns its ACTUAL value:
//   actual continuation   v[lo, s]·(1 − w) + v[lo + 1, s]·w   (lo, w per (g, d))
//   regressed gap         Σ_b dci[d, g, b]·dm[b]               (dci = ci − ci[0])
//   immediate value       a[d, g]·spot + b[d, g]
// in the plain versions' order, every product and sum rounded on its own (no
// fused multiply-adds), so a kernel matches its plain version to the bit.
#pragma once

#include <cstddef>
#include <cuda_runtime.h>

#include "common.cuh"

namespace stt {

// The per-step tables, staged in shared memory by every block.  On kernel
// B's large route, a tile of nt grid points at a time: grid point g0 + i of
// the step is entry i of the tile, and nt stands in for G below.
struct DecisionTables {
  float* dci;   // [D, G, B]
  float* a;     // [D, G]
  float* b;     // [D, G]
  float* w_hi;  // [G, D]
  int* idx_lo;  // [G, D]
};

// Floats of shared memory the tables take (idx_lo counted as 4-byte words).
__host__ __device__ inline size_t decision_tables_words(int G, int D, int B) {
  return static_cast<size_t>(D) * G * B + 4 * static_cast<size_t>(D) * G;
}

// Carves the tables out of `smem` and copies them in (block-strided); the
// caller synchronises before reading them.
__device__ __forceinline__ DecisionTables load_decision_tables(
    float* smem, int G, int D, int B, const float* __restrict__ dci_g,
    const float* __restrict__ a_g, const float* __restrict__ b_g,
    const float* __restrict__ w_hi_g, const int* __restrict__ idx_lo_g) {
  DecisionTables t;
  t.dci = smem;
  t.a = t.dci + D * G * B;
  t.b = t.a + D * G;
  t.w_hi = t.b + D * G;
  t.idx_lo = reinterpret_cast<int*>(t.w_hi + G * D);
  for (int i = threadIdx.x; i < D * G * B; i += blockDim.x) t.dci[i] = dci_g[i];
  for (int i = threadIdx.x; i < D * G; i += blockDim.x) {
    t.a[i] = a_g[i];
    t.b[i] = b_g[i];
    t.w_hi[i] = w_hi_g[i];
    t.idx_lo[i] = idx_lo_g[i];
  }
  return t;
}

// The same for grid points [g0, g0 + nt) of a step of G (the large route's
// tile): the tables of a step of nt grid points.
__device__ __forceinline__ DecisionTables load_decision_tile(
    float* smem, int G, int g0, int nt, int D, int B, const float* __restrict__ dci_g,
    const float* __restrict__ a_g, const float* __restrict__ b_g,
    const float* __restrict__ w_hi_g, const int* __restrict__ idx_lo_g) {
  DecisionTables t;
  t.dci = smem;
  t.a = t.dci + D * nt * B;
  t.b = t.a + D * nt;
  t.w_hi = t.b + D * nt;
  t.idx_lo = reinterpret_cast<int*>(t.w_hi + nt * D);
  for (int i = threadIdx.x; i < D * nt * B; i += blockDim.x) {
    const int d = i / (nt * B);
    t.dci[i] = dci_g[(static_cast<size_t>(d) * G + g0) * B + (i - d * nt * B)];
  }
  for (int i = threadIdx.x; i < D * nt; i += blockDim.x) {
    const int d = i / nt;
    const int g = g0 + i - d * nt;
    t.a[i] = a_g[d * G + g];
    t.b[i] = b_g[d * G + g];
    t.w_hi[i] = w_hi_g[g0 * D + i];
    t.idx_lo[i] = idx_lo_g[g0 * D + i];
  }
  return t;
}

// best_act of sim s at grid point g (entry g of a tile of G); `dm` is the
// sim's standardised design row (kMaxB entries, zero beyond B), `sp` its
// spot.
__device__ __forceinline__ float decide(const DecisionTables& t, int G, int D,
                                        int B, int g, const float* __restrict__ v,
                                        int S, int s, float sp, const float* dm) {
  const int lo0 = t.idx_lo[g * D];
  const float w0 = t.w_hi[g * D];
  const float imm0 = __fadd_rn(__fmul_rn(t.a[g], sp), t.b[g]);
  const float c0 = __fadd_rn(
      __fmul_rn(v[static_cast<size_t>(lo0) * S + s], __fsub_rn(1.0f, w0)),
      __fmul_rn(v[static_cast<size_t>(lo0 + 1) * S + s], w0));
  float best_reg = imm0;
  float best_act = __fadd_rn(c0, imm0);
  for (int d = 1; d < D; ++d) {
    const float* c = t.dci + (d * G + g) * B;
    float q = __fmul_rn(c[0], dm[0]);
#pragma unroll
    for (int k = 1; k < kMaxB; ++k)
      if (k < B) q = __fadd_rn(q, __fmul_rn(c[k], dm[k]));
    const float imm = __fadd_rn(__fmul_rn(t.a[d * G + g], sp), t.b[d * G + g]);
    const int lo = t.idx_lo[g * D + d];
    const float w = t.w_hi[g * D + d];
    const float cont = __fadd_rn(
        __fmul_rn(v[static_cast<size_t>(lo) * S + s], __fsub_rn(1.0f, w)),
        __fmul_rn(v[static_cast<size_t>(lo + 1) * S + s], w));
    const float vr = __fadd_rn(q, imm);
    if (vr > best_reg) {
      best_reg = vr;
      best_act = __fadd_rn(cont, imm);
    }
  }
  return best_act;
}

// Kernel B's launch (decision_kernel.cu): the decision update of every sim
// column plus the per-block partial moments of the step-(t−1) design, then
// the fixed-order reduce into `moments` ([B·B] XᵀX, then [G, B] (Xᵀ·best)ᵀ).
// The step tables go to shared memory all at once (tile >= G: the shared
// route) or `tile` grid points at a time (the large route).  Every pointer
// is a device pointer; kernel E launches it on the buffers its solve
// kernels filled.
cudaError_t launch_decision_moments(
    int G, int tile, int S, int D, const Basis& basis, const float* v, const float* spot,
    const float* factors, const float* spot_prev, const float* factors_prev,
    const float* mean, const float* stdv, const float* mean_prev,
    const float* std_prev, const int* idx_lo, const float* w_hi,
    const float* dci, const float* a, const float* b, float* best_out,
    float* partials, float* moments, cudaStream_t stream);

}  // namespace stt
