// The backward step's decision loop of kernel B (decision_kernel.cu) and so
// of kernel E (fullstep_kernel.cu), which launches B's kernel after its
// solve.  It is kernel D's loop (decision_update_kernel.cu keeps its own
// copy: on this one D compiled 8% slower at B = 9, PERF.md).
//
// For inventory grid point g of sim s it takes the decision whose REGRESSED
// value is largest (strict >, decision 0 first, so ties keep the earlier
// decision) and returns its ACTUAL value:
//   regressed gap         Σ_b dci[d, g, b]·dm[b]               (dci = ci − ci[0])
//   immediate value       a[d, g]·spot + b[d, g]
//   actual continuation   v[lo, s]·(1 − w) + v[lo + 1, s]·w   (lo, w of the winner)
// in the plain versions' order, every product and sum rounded on its own (no
// fused multiply-adds), so a kernel matches its plain version to the bit.
//
// The argmax runs first, on the regressed values, which need no v; only the
// winner's two rows of v are then read, through L1 (2 reads per sim and grid
// point, not 2D).  The grid points go in groups, decided together: a group's
// independent chains keep several reads of v in flight.  The step tables are
// repacked per grid point in shared memory: per decision one 16-byte entry
// {a, b, w_hi, idx_lo}, then for d > 0 its centred coefficients zero-padded
// to whole float4s, all read at warp-uniform addresses.  The padded terms add
// 0·0 to a regressed value, which moves no argmax.
#pragma once

#include <cstddef>
#include <cuda_runtime.h>

#include "common.cuh"

namespace stt {

__host__ __device__ inline int padded_basis(int B) { return (B + 3) & ~3; }
// Floats of one grid point's record: {a, b, w_hi, idx_lo} per decision, and
// after each of decisions 1..D−1 its Bp padded centred coefficients.
__host__ __device__ inline int record_words(int D, int Bp) { return 4 + (D - 1) * (4 + Bp); }
__host__ __device__ inline int record_offset(int d, int Bp) {
  return d == 0 ? 0 : 4 + (d - 1) * (4 + Bp);
}

// A sim's standardised design row, Bp entries (zero beyond B), in registers.
template <int Bp>
struct RegisterRow {
  float dm[Bp];
  // The regressed gap cf·dm of padded coefficients cf (16-byte aligned):
  // each product and sum rounded on its own, term 0 first.
  __device__ __forceinline__ float gap(const float* p) const {
    float cf[Bp];
#pragma unroll
    for (int k = 0; k < Bp; k += 4) {
      const float4 q4 = *reinterpret_cast<const float4*>(p + k);
      cf[k] = q4.x;
      cf[k + 1] = q4.y;
      cf[k + 2] = q4.z;
      cf[k + 3] = q4.w;
    }
    float q = __fmul_rn(cf[0], dm[0]);
#pragma unroll
    for (int k = 1; k < Bp; ++k) q = __fadd_rn(q, __fmul_rn(cf[k], dm[k]));
    return q;
  }
};

// The same row in shared memory, of a padded size bp known at run time
// (kernel E's wide route past its register row's kMaxWideRegB terms): entry
// k at row[k·kStride], this thread's column of a [bp, kStride] tile, zero
// beyond B.  The same products and sums in the same order, 4 terms at a
// time, so the same gap to the bit.
template <int kStride>
struct SharedRow {
  const float* row;
  int bp;
  __device__ __forceinline__ float gap(const float* p) const {
    float q = 0.0f;
#pragma unroll 1
    for (int k = 0; k < bp; k += 4) {
      const float4 c = *reinterpret_cast<const float4*>(p + k);
      const float* x = row + k * kStride;
      q = k == 0 ? __fmul_rn(c.x, x[0]) : __fadd_rn(q, __fmul_rn(c.x, x[0]));
      q = __fadd_rn(q, __fmul_rn(c.y, x[kStride]));
      q = __fadd_rn(q, __fmul_rn(c.z, x[2 * kStride]));
      q = __fadd_rn(q, __fmul_rn(c.w, x[3 * kStride]));
    }
    return q;
  }
};

// Repacks the records of grid points [g0, g0 + nt) of a step of G into tab
// (block-strided); the caller synchronises before reading them.  The tables
// are the wrappers' dci [D, G, B], a and b [D, G], w_hi and idx_lo [G, D].
__device__ __forceinline__ void load_records(float* tab, int G, int g0, int nt, int D, int B,
                                             int bp, const int* __restrict__ idx_lo_g,
                                             const float* __restrict__ w_hi_g,
                                             const float* __restrict__ dci_g,
                                             const float* __restrict__ a_g,
                                             const float* __restrict__ b_g) {
  const int rec = record_words(D, bp);
  for (int i = threadIdx.x; i < nt * D; i += blockDim.x) {
    const int d = i / nt;
    const int gl = i - d * nt;
    const int g = g0 + gl;
    float* out = tab + gl * rec + record_offset(d, bp);
    out[0] = a_g[d * G + g];
    out[1] = b_g[d * G + g];
    out[2] = w_hi_g[g * D + d];
    out[3] = __int_as_float(idx_lo_g[g * D + d]);
    if (d > 0)
      for (int k = 0; k < bp; ++k)
        out[4 + k] = k < B ? dci_g[(static_cast<size_t>(d) * G + g) * B + k] : 0.0f;
  }
}

// best_act of sim s at the kGroup grid points whose records are entries
// first .. first + kGroup − 1 of tab, into best[i] for entry first + i
// (those past entry `last` repeat it: the caller stores nothing for them);
// `sp` is the sim's spot, `dm` its design row (bp entries, zero beyond B: a
// RegisterRow, or a SharedRow on the wide route).  All kGroup results are
// formed before any is stored: handing each to a store as it is formed
// compiled kernel B 5–8% slower (PERF.md).
template <int kGroup, typename Row>
__device__ __forceinline__ void decide_group(const float* tab, int first, int last, int D,
                                             int bp, const float* __restrict__ v, int S, int s,
                                             float sp, const Row& dm, float (&best)[kGroup]) {
  const int rec = record_words(D, bp);
  const float* r[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) r[i] = tab + min(first + i, last) * rec;
  float best_reg[kGroup], best_imm[kGroup], best_w[kGroup];
  int best_lo[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    const float4 e = *reinterpret_cast<const float4*>(r[i]);
    best_reg[i] = best_imm[i] = __fadd_rn(__fmul_rn(e.x, sp), e.y);
    best_w[i] = e.z;
    best_lo[i] = __float_as_int(e.w);
  }
#pragma unroll 1
  for (int d = 1; d < D; ++d) {
    const int off = record_offset(d, bp);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const float* p = r[i] + off;
      const float4 e = *reinterpret_cast<const float4*>(p);
      const float q = dm.gap(p + 4);
      const float imm = __fadd_rn(__fmul_rn(e.x, sp), e.y);
      const float vr = __fadd_rn(q, imm);
      if (vr > best_reg[i]) {
        best_reg[i] = vr;
        best_imm[i] = imm;
        best_w[i] = e.z;
        best_lo[i] = __float_as_int(e.w);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    const float* x = v + static_cast<size_t>(best_lo[i]) * S + s;
    const float w = best_w[i];
    const float cont =
        __fadd_rn(__fmul_rn(__ldg(x), __fsub_rn(1.0f, w)), __fmul_rn(__ldg(x + S), w));
    best[i] = __fadd_rn(cont, best_imm[i]);
  }
}

// Kernel B's launch (decision_kernel.cu): the decision update of every sim
// column plus the per-block partial moments of the step-(t−1) design, then
// the fixed-order reduce into `moments` ([B·B] XᵀX, then [G, B] (Xᵀ·best)ᵀ).
// The step's records go to shared memory all at once (tile >= G: the shared
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

// The same for any basis size and factor count (kernel E's wide route): the
// powers `pows` [B, F + 1] int8 in device memory, staged in each block's
// shared memory; step t's design row in registers (the register row, up to
// kMaxWideRegB terms) or, with `smem_row`, in shared memory beside step
// t−1's design tile (any B).
cudaError_t launch_decision_moments_wide(
    int G, int tile, int S, int D, int B, int F, bool smem_row, const int8_t* pows,
    const float* v, const float* spot, const float* factors, const float* spot_prev,
    const float* factors_prev, const float* mean, const float* stdv, const float* mean_prev,
    const float* std_prev, const int* idx_lo, const float* w_hi, const float* dci,
    const float* a, const float* b, float* best_out, float* partials, float* moments,
    cudaStream_t stream);

}  // namespace stt
