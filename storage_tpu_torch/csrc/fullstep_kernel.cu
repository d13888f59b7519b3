// Kernel E: the whole backward LSMC step with no tensor glue between steps.
//
// Replaces the TPU kernel storage_tpu/ops/decision_kernel.py:
// decision_update_fullstep_pallas (_kernel_fullstep, _prologue_solve).  The
// TPU ran the inter-step glue as a prologue on grid tile 0 and kept its
// results in VMEM scratch for the later tiles: its grid runs in order on one
// core.  CUDA blocks run in no order and cannot wait for one block's
// prologue, so the step is three launches on the caller's stream, all CUDA:
//   1. fullstep_solve_kernel, one block: standardise the carried moments
//      (ops/regression.standardise_moments), compose the stats
//      mean = cmean + cstd·μ_u and std = cstd·σ_u, add the trace-scaled ridge,
//      factor the [B, B] system (Cholesky) and solve it for the G
//      right-hand sides, fall back to the constant-column projection when a
//      pivot is not positive or a coefficient is not finite (the plain
//      version's cholesky_ex info ≠ 0 or non-finite test), and interpolate the
//      coefficients to every (grid point, decision) target as the centred gaps
//      dci = ci − ci[0] — into device buffers;
//   2. kernel B's decision-update-and-moments kernel on those buffers
//      (decision_kernel.cu, launch_decision_moments);
//   3. B's fixed-order reduce of the moment partials.
//
// The one block holds the standardised right-hand sides and the
// coefficients [B, G] in shared memory (72 B a grid point at B=9: up to
// G = 3,213 on an H100).  Past that, the large route spreads the G
// right-hand sides over blocks of kSolveThreads columns: every block
// standardises the moments and factors the [B, B] system itself, with the
// same code in the same order, so every block holds the same factor; each
// solves its own columns into a scratch [B, G] and flags a non-finite
// coefficient; then fullstep_interp_kernel applies the fallback where any
// block flagged one (or the factor failed), writes the coefficients and
// interpolates dci.  Every column's arithmetic is the one block's, so the
// two routes give the same bits; kernel B runs on its large route beside it
// (ops/decision_kernel.py fullstep_route).
//
// Past kernel B's register caps (16 terms, 8 factors: stt::kMaxB, kMaxF) the
// wide route (stt_decision_update_fullstep_wide) runs the same solve, its
// substitution vector sized to the basis (16, 32 or 64 doubles), on either
// grid route, then one of kernel B's wide bodies (decision_kernel.cu): the
// register row (the tiled kernel on the powers staged from a device table,
// compiled per padded size up to stt::kMaxWideRegB = 32 terms) or, past it,
// the shared row (decision_moments_wide_kernel, step t's design rows in
// shared memory); the wrapper chooses from B and F alone
// (ops/decision_kernel.py fullstep_route).  Inside the caps the register
// route runs B's own kernels.
//
// The factor is formed a column at a time: thread 0 the pivot, then one
// thread a row below it, each entry's sum over k in the serial order, two
// barriers a column.  Up to 32 terms the substitutions are unrolled to the
// compiled size, so that the vector stays in registers.  At 20 terms the
// solve took 0.071 ms a step with one thread factoring and the vector in
// local memory, 0.044 after (PERF.md).
//
// The factorisation and the substitutions run in double on the f32 system
// and round the coefficients to f32 once: the [B, B] work is a few hundred
// operations.  The plain version factors in double too (torch.linalg), so
// the two differ only where double rounding moves a coefficient's f32.  The
// standardisation, the ridge and the coefficient interpolation keep the plain
// version's f32 operations in its order.
//
// Bound on the H100: device memory, as kernel B — v [G, S] read and best_act
// written (210 MB at G=100, S=262,144) plus two steps' spot and factors, ~63 us
// at 3.35 TB/s; the solve kernel adds one block's latency (0.016–0.044 ms
// at 13–20 terms) and replaces the ~25 small tensor launches of the glue.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "decision_step.cuh"

namespace {

constexpr int kSolveThreads = 256;

// Forward then back substitution of one right-hand side x (entry i at
// x[i·stride]) on the lower factor chol [B, B], the coefficients rounded to
// f32 into c (entry i at c[i·stride]); returns whether one is not finite.
// Up to 32 terms the loops are unrolled to kMaxY, so that the vector y stays
// in registers; beyond, it is kMaxY doubles of local memory.  The same sums
// in the same order either way.
template <int kMaxY>
__device__ __forceinline__ int substitute(int B, const double* chol, const float* x, int stride,
                                          float* c) {
  double y[kMaxY];
  int nonfinite = 0;
  if constexpr (kMaxY <= 32) {
#pragma unroll
    for (int i = 0; i < kMaxY; ++i) {
      if (i < B) {
        double acc = x[i * stride];
#pragma unroll
        for (int k = 0; k < i; ++k) acc -= chol[i * B + k] * y[k];
        y[i] = acc / chol[i * B + i];
      }
    }
#pragma unroll
    for (int i = kMaxY - 1; i >= 0; --i) {
      if (i < B) {
        double acc = y[i];
#pragma unroll
        for (int k = i + 1; k < kMaxY; ++k)
          if (k < B) acc -= chol[k * B + i] * y[k];
        y[i] = acc / chol[i * B + i];
        const float ci = static_cast<float>(y[i]);
        c[i * stride] = ci;
        nonfinite |= !isfinite(ci);
      }
    }
  } else {
    for (int i = 0; i < B; ++i) {
      double acc = x[i * stride];
      for (int k = 0; k < i; ++k) acc -= chol[i * B + k] * y[k];
      y[i] = acc / chol[i * B + i];
    }
    for (int i = B - 1; i >= 0; --i) {
      double acc = y[i];
      for (int k = i + 1; k < B; ++k) acc -= chol[k * B + i] * y[k];
      y[i] = acc / chol[i * B + i];
      const float ci = static_cast<float>(y[i]);
      c[i * stride] = ci;
      nonfinite |= !isfinite(ci);
    }
  }
  return nonfinite;
}

// The solve of right-hand sides [c0, c0 + nc) of the G: one block, c0 = 0
// and nc = G (kSpread false: then also the fallback and dci), or block
// blockIdx.x's columns of the large route (kSpread: the coefficients before
// the fallback and the block's flag into `scratch`).  Each thread's
// substitution vector holds kMaxY doubles (substitute): stt::kMaxB on the
// register route, on the wide route stt::kMaxB, stt::kMaxWideRegB or
// stt::kMaxWideB, the least that holds B.
template <bool kSpread, int kMaxY>
__global__ void fullstep_solve_kernel(
    int G, int D, int B, float ridge, const float* __restrict__ xtx_g,
    const float* __restrict__ xty_t_g, const float* __restrict__ cmean_g,
    const float* __restrict__ cstd_g, const int* __restrict__ idx_lo_g,
    const float* __restrict__ w_hi_g, float* __restrict__ mean_out,
    float* __restrict__ std_out, float* __restrict__ coeffs_out,
    float* __restrict__ dci_out, float* __restrict__ scratch) {
  const int c0 = kSpread ? static_cast<int>(blockIdx.x) * kSolveThreads : 0;
  const int nc = kSpread ? min(kSolveThreads, G - c0) : G;
  extern __shared__ double dsmem[];
  double* chol = dsmem;                                  // [B, B] lower factor
  float* m = reinterpret_cast<float*>(chol + B * B);     // [B, B]
  float* mean_u = m + B * B;                             // [B]
  float* std_u = mean_u + B;                             // [B]
  float* xs = std_u + B;                                 // [B, nc] standardised Xᵀy
  float* coef = xs + B * nc;                             // [B, nc]
  int* failed = reinterpret_cast<int*>(coef + B * nc);   // [1]

  const int tid = threadIdx.x;
  const float n = xtx_g[0];
  // standardise_moments: μ = XᵀX[0, :]/n, var = diag/n − μ², column 0 kept.
  for (int j = tid; j < B; j += blockDim.x) {
    const float mu = __fdiv_rn(xtx_g[j], n);
    const float ex2 = __fdiv_rn(xtx_g[j * B + j], n);
    const float mj = j == 0 ? 0.0f : mu;
    const float var = __fsub_rn(ex2, __fmul_rn(mj, mj));
    float sd = sqrtf(fmaxf(var, 0.0f));
    sd = sd > 0.0f ? sd : 1.0f;
    if (j == 0) sd = 1.0f;
    mean_u[j] = mj;
    std_u[j] = sd;
  }
  if (tid == 0) *failed = 0;
  __syncthreads();
  for (int p = tid; p < B * B; p += blockDim.x) {
    const int i = p / B, j = p % B;
    const float mu_i = __fdiv_rn(xtx_g[i], n);
    const float mu_j = __fdiv_rn(xtx_g[j], n);
    m[p] = p == 0 ? n
                  : __fdiv_rn(__fsub_rn(xtx_g[p], __fmul_rn(__fmul_rn(n, mu_i), mu_j)),
                              __fmul_rn(std_u[i], std_u[j]));
  }
  for (int p = tid; p < B * nc; p += blockDim.x) {
    const int b = p / nc, g = c0 + p % nc;
    xs[p] = __fdiv_rn(__fsub_rn(xty_t_g[g * B + b], __fmul_rn(mean_u[b], xty_t_g[g * B])),
                      std_u[b]);
  }
  __syncthreads();

  // Trace-scaled ridge (f32, as fit_from_moments).
  if (tid == 0) {
    float trace = m[0];
    for (int i = 1; i < B; ++i) trace = __fadd_rn(trace, m[i * B + i]);
    const float jitter = __fdiv_rn(__fmul_rn(trace, ridge), static_cast<float>(B));
    for (int i = 0; i < B; ++i) m[i * B + i] = __fadd_rn(m[i * B + i], jitter);
  }
  __syncthreads();
  // The Cholesky factor a column j at a time: its pivot by thread 0, then
  // row j + 1 + tid of the column by thread tid, each entry's sum over k in
  // order, as one thread forms it column by column.  A pivot that is not
  // positive (or NaN) stops the factor: the fallback follows.
  for (int j = 0; j < B; ++j) {
    if (tid == 0) {
      double ajj = m[j * B + j];
      for (int k = 0; k < j; ++k) ajj -= chol[j * B + k] * chol[j * B + k];
      if (ajj > 0.0)
        chol[j * B + j] = sqrt(ajj);
      else
        *failed = 1;
    }
    __syncthreads();
    if (*failed) break;
    const int i = j + 1 + tid;
    if (i < B) {
      double aij = m[i * B + j];
      for (int k = 0; k < j; ++k) aij -= chol[i * B + k] * chol[j * B + k];
      chol[i * B + j] = aij / chol[j * B + j];
    }
    __syncthreads();
  }

  // Forward then back substitution, one thread per right-hand side.
  int nonfinite = 0;
  if (!*failed) {
    for (int g = tid; g < nc; g += blockDim.x)
      nonfinite |= substitute<kMaxY>(B, chol, xs + g, nc, coef + g);
  }
  const bool fallback = __syncthreads_or(nonfinite) || *failed;
  if constexpr (kSpread) {
    for (int p = tid; p < B * nc; p += blockDim.x)
      scratch[static_cast<size_t>(p / nc) * G + c0 + p % nc] = coef[p];
    float* flags = scratch + static_cast<size_t>(B) * G + 1;
    if (tid == 0) flags[blockIdx.x] = fallback ? 1.0f : 0.0f;
    if (blockIdx.x == 0) {
      if (tid == 0) scratch[static_cast<size_t>(B) * G] = m[0];
      for (int j = tid; j < B; j += blockDim.x) {
        mean_out[j] = __fadd_rn(cmean_g[j], __fmul_rn(cstd_g[j], mean_u[j]));
        std_out[j] = __fmul_rn(cstd_g[j], std_u[j]);
      }
    }
    return;
  }

  // The constant-column projection (the cross-sim mean) on a failed solve.
  for (int p = tid; p < B * G; p += blockDim.x) {
    float c = coef[p];
    if (fallback) c = p < G ? __fdiv_rn(xs[p], m[0]) : 0.0f;
    coef[p] = c;
    coeffs_out[p] = c;
  }
  for (int j = tid; j < B; j += blockDim.x) {
    mean_out[j] = __fadd_rn(cmean_g[j], __fmul_rn(cstd_g[j], mean_u[j]));
    std_out[j] = __fmul_rn(cstd_g[j], std_u[j]);
  }
  __syncthreads();

  // ci[d, g, :] = coeffs[:, lo]·(1 − w) + coeffs[:, lo + 1]·w; dci = ci − ci[0].
  for (int p = tid; p < D * G * B; p += blockDim.x) {
    const int d = p / (G * B);
    const int g = (p / B) % G;
    const int b = p % B;
    const float* row = coef + b * G;
    const int lo0 = idx_lo_g[g * D];
    const float w0 = w_hi_g[g * D];
    const float ci0 = __fadd_rn(__fmul_rn(row[lo0], __fsub_rn(1.0f, w0)),
                                __fmul_rn(row[lo0 + 1], w0));
    const int lo = idx_lo_g[g * D + d];
    const float w = w_hi_g[g * D + d];
    const float ci = __fadd_rn(__fmul_rn(row[lo], __fsub_rn(1.0f, w)),
                               __fmul_rn(row[lo + 1], w));
    dci_out[p] = __fsub_rn(ci, ci0);
  }
}

// The large route's second launch: the fallback where any block flagged
// one (the one block's `fallback`), the coefficients, and dci as the one
// block interpolates them, from the scratch of the spread solve.
__global__ void fullstep_interp_kernel(int G, int D, int B, const float* __restrict__ xty_t_g,
                                       const int* __restrict__ idx_lo_g,
                                       const float* __restrict__ w_hi_g,
                                       const float* __restrict__ scratch,
                                       float* __restrict__ coeffs_out,
                                       float* __restrict__ dci_out) {
  const float* flags = scratch + static_cast<size_t>(B) * G + 1;
  bool fallback = false;
  for (int k = 0; k < (G + kSolveThreads - 1) / kSolveThreads; ++k) fallback |= flags[k] != 0.0f;
  const float m0 = scratch[static_cast<size_t>(B) * G];
  // Coefficient (b, g) after the fallback: the constant-column projection
  // xs[0, g] / m[0, 0], with xs[0, g] standardised as the solve does it (by
  // mean_u[0] = 0 and std_u[0] = 1).
  auto coef = [&](int b, int g) {
    if (!fallback) return scratch[static_cast<size_t>(b) * G + g];
    if (b > 0) return 0.0f;
    const float x = xty_t_g[g * B];
    return __fdiv_rn(__fdiv_rn(__fsub_rn(x, __fmul_rn(0.0f, x)), 1.0f), m0);
  };
  const size_t n = static_cast<size_t>(D) * G * B;
  for (size_t p = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; p < n;
       p += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int d = static_cast<int>(p / (static_cast<size_t>(G) * B));
    const int g = static_cast<int>((p / B) % G);
    const int b = static_cast<int>(p % B);
    if (d == 0) coeffs_out[static_cast<size_t>(b) * G + g] = coef(b, g);
    const int lo0 = idx_lo_g[g * D];
    const float w0 = w_hi_g[g * D];
    const float ci0 = __fadd_rn(__fmul_rn(coef(b, lo0), __fsub_rn(1.0f, w0)),
                                __fmul_rn(coef(b, lo0 + 1), w0));
    const int lo = idx_lo_g[g * D + d];
    const float w = w_hi_g[g * D + d];
    const float ci = __fadd_rn(__fmul_rn(coef(b, lo), __fsub_rn(1.0f, w)),
                               __fmul_rn(coef(b, lo + 1), w));
    dci_out[p] = __fsub_rn(ci, ci0);
  }
}

// The regression of kernel E on the caller's stream: the one-block solve,
// or the solve spread over blocks of kSolveThreads columns and the
// interpolation launch (`spread`, whose scratch holds B·G + 1 + ⌈G/256⌉
// floats: the coefficients before the fallback, the ridged m[0, 0], a flag
// a block of 256 columns).  mean_out, std_out, coeffs_out and dci are filled
// for the decision kernel that follows.
template <int kMaxY>
cudaError_t launch_solve(int G, int D, int B, bool spread, float ridge, const float* xtx,
                         const float* xty_t, const float* cmean, const float* cstd,
                         const int* idx_lo, const float* w_hi, float* mean_out, float* std_out,
                         float* coeffs_out, float* dci, float* scratch, cudaStream_t st) {
  const int nc = spread ? kSolveThreads : G;  // right-hand sides a block
  const size_t smem = sizeof(double) * B * B +
      sizeof(float) * (static_cast<size_t>(B) * B + 2 * B + 2 * static_cast<size_t>(B) * nc) +
      sizeof(int);
  const decltype(&fullstep_solve_kernel<false, kMaxY>) solve =
      spread ? &fullstep_solve_kernel<true, kMaxY> : &fullstep_solve_kernel<false, kMaxY>;
  cudaError_t err = cudaFuncSetAttribute(
      solve, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  solve<<<(G + nc - 1) / nc, kSolveThreads, smem, st>>>(
      G, D, B, ridge, xtx, xty_t, cmean, cstd, idx_lo, w_hi, mean_out, std_out, coeffs_out, dci,
      scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess || !spread) return err;
  const int threads = 256;
  const size_t blocks = (static_cast<size_t>(D) * G * B + threads - 1) / threads;
  fullstep_interp_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), threads, 0, st>>>(
      G, D, B, xty_t, idx_lo, w_hi, scratch, coeffs_out, dci);
  return cudaGetLastError();
}

}  // namespace

// Kernel E.  `tile` is kernel B's (decision_kernel.cu); with `spread` the
// solve takes the large route (launch_solve).
extern "C" int stt_decision_update_fullstep(
    int G, int tile, int spread, int S, int F, int D, const int* basis_table, float ridge,
    const void* v, const void* spot, const void* factors, const void* spot_prev,
    const void* factors_prev, const void* xtx, const void* xty_t,
    const void* cmean, const void* cstd, const void* mean_prev,
    const void* std_prev, const void* idx_lo, const void* w_hi, const void* a,
    const void* b, void* best_out, void* mean_out, void* std_out,
    void* coeffs_out, void* dci, void* scratch, void* partials, void* moments, void* stream) {
  stt::Basis basis;
  if (!stt::make_basis(basis_table, F, &basis) || G < 2 || D < 1 || S < 1 ||
      (spread && !scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_solve<stt::kMaxB>(
      G, D, basis.nb, spread, ridge, static_cast<const float*>(xtx),
      static_cast<const float*>(xty_t), static_cast<const float*>(cmean),
      static_cast<const float*>(cstd), static_cast<const int*>(idx_lo),
      static_cast<const float*>(w_hi), static_cast<float*>(mean_out),
      static_cast<float*>(std_out), static_cast<float*>(coeffs_out), static_cast<float*>(dci),
      static_cast<float*>(scratch), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Without mean_prev/std_prev the step-(t−1) moments are standardised by
  // the composed stats: the TPU kernel's u-coordinates.
  const float* mp = mean_prev ? static_cast<const float*>(mean_prev)
                              : static_cast<const float*>(mean_out);
  const float* sp = std_prev ? static_cast<const float*>(std_prev)
                             : static_cast<const float*>(std_out);
  return static_cast<int>(stt::launch_decision_moments(
      G, tile, S, D, basis, static_cast<const float*>(v),
      static_cast<const float*>(spot), static_cast<const float*>(factors),
      static_cast<const float*>(spot_prev),
      static_cast<const float*>(factors_prev),
      static_cast<const float*>(mean_out), static_cast<const float*>(std_out),
      mp, sp, static_cast<const int*>(idx_lo), static_cast<const float*>(w_hi),
      static_cast<const float*>(dci), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<float*>(best_out),
      static_cast<float*>(partials), static_cast<float*>(moments), st));
}

// Kernel E's wide route: any B up to stt::kMaxWideB and any F, the powers
// `pows` [B, F + 1] int8 in device memory; the same regression (its solve
// with a substitution vector of the least of kMaxB, kMaxWideRegB and
// kMaxWideB doubles that holds B), then kernel B's wide body
// (launch_decision_moments_wide) at `tile`: the register row up to
// stt::kMaxWideRegB terms, or with `smem_row` the shared row.
extern "C" int stt_decision_update_fullstep_wide(
    int G, int tile, int spread, int S, int F, int D, int B, int smem_row, const void* pows,
    float ridge, const void* v, const void* spot, const void* factors, const void* spot_prev,
    const void* factors_prev, const void* xtx, const void* xty_t,
    const void* cmean, const void* cstd, const void* mean_prev,
    const void* std_prev, const void* idx_lo, const void* w_hi, const void* a,
    const void* b, void* best_out, void* mean_out, void* std_out,
    void* coeffs_out, void* dci, void* scratch, void* partials, void* moments, void* stream) {
  if (B < 1 || B > stt::kMaxWideB || F < 0 || !pows || G < 2 || D < 1 || S < 1 ||
      (spread && !scratch) || (!smem_row && stt::padded_basis(B) > stt::kMaxWideRegB))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto solve = B <= stt::kMaxB         ? launch_solve<stt::kMaxB>
                     : B <= stt::kMaxWideRegB ? launch_solve<stt::kMaxWideRegB>
                                              : launch_solve<stt::kMaxWideB>;
  cudaError_t err = solve(
      G, D, B, spread, ridge, static_cast<const float*>(xtx),
      static_cast<const float*>(xty_t), static_cast<const float*>(cmean),
      static_cast<const float*>(cstd), static_cast<const int*>(idx_lo),
      static_cast<const float*>(w_hi), static_cast<float*>(mean_out),
      static_cast<float*>(std_out), static_cast<float*>(coeffs_out), static_cast<float*>(dci),
      static_cast<float*>(scratch), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* mp = mean_prev ? static_cast<const float*>(mean_prev)
                              : static_cast<const float*>(mean_out);
  const float* sp = std_prev ? static_cast<const float*>(std_prev)
                             : static_cast<const float*>(std_out);
  return static_cast<int>(stt::launch_decision_moments_wide(
      G, tile, S, D, B, F, smem_row != 0, static_cast<const int8_t*>(pows),
      static_cast<const float*>(v), static_cast<const float*>(spot),
      static_cast<const float*>(factors), static_cast<const float*>(spot_prev),
      static_cast<const float*>(factors_prev), static_cast<const float*>(mean_out),
      static_cast<const float*>(std_out), mp, sp, static_cast<const int*>(idx_lo),
      static_cast<const float*>(w_hi), static_cast<const float*>(dci),
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(best_out),
      static_cast<float*>(partials), static_cast<float*>(moments), st));
}
