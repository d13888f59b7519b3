// Kernel C: one forward LSMC step per sim.
//
// Replaces the TPU kernel storage_tpu/ops/forward_kernel.py:forward_step_pallas
// (_forward_kernel, _ratchet_rates_smem, _bang_bang).  Per sim: the
// standardised design row; ratchet rates at the sim's inventory from the
// R-node table (linear or step); the bang-bang decision set (D = 2e + 3); per
// decision the fitted continuation at the target inventory, the immediate
// value with costs, fuel and inventory cost, and a first-max argmax; then the
// new inventory and PV and the chosen volume and fuel.  The step's cross-sim
// sums (inventory, volume, fuel, loss, immediate value, delta numerator) and
// the summed design row go out as per-block partials, reduced in a fixed order
// by a second small kernel (no float atomics).  Where the caller asks for the
// per-sim panels it also passes imm_out, and each sim's chosen immediate PV
// is written there (NULL: not written).
//
// Bound on the H100: launch latency.  Per step a sim reads 6 floats and writes
// 4 (about 10 MB at 262,144 sims, ~3 us of bandwidth), and the arithmetic is
// a few hundred flops.  Design: one thread per sim, the regression
// coefficients [B, G] and the ratchet tables staged in shared memory, and the
// fitted continuation evaluated only at the two grid rows each decision
// touches — pred = coeffs[:, row]·dm at lo and lo + 1 — where the TPU, lacking
// a per-lane gather, evaluated all G rows and contracted a hat.  The edges
// reproduce that hat sum: a degenerate grid (inv_delta = 0) puts weight 1 on
// row 0; a position at the top edge takes lo = G − 2 with weight 1.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxR = 64;
// Parameter slots (ops/forward_kernel.py pack_params).
enum {
  P_DF_SETTLE, P_DF_FLOW, P_INJ_COST, P_WDR_COST, P_INJ_PCNT, P_WDR_PCNT,
  P_LOSS_PCNT, P_INV_COST, P_NEXT_MIN, P_NEXT_MAX, P_GRID_LO, P_GRID_HI,
  P_GRID_INVDELTA, NUM_PARAMS
};
constexpr int kNumSums = 8;  // 6 used, 2 kept zero (the JAX layout)

__device__ __forceinline__ float lerp(float x0, float x1, float w) {
  return __fadd_rn(__fmul_rn(x0, __fsub_rn(1.0f, w)), __fmul_rn(x1, w));
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__global__ void forward_step_kernel(
    int S, int G, int R, int E, int is_step, stt::Basis basis,
    const float* __restrict__ params_g, const float* __restrict__ mean_g,
    const float* __restrict__ std_g, const float* __restrict__ rinv_g,
    const float* __restrict__ rmin_g, const float* __restrict__ rmax_g,
    const float* __restrict__ spot, const float* __restrict__ factors,
    const float* __restrict__ inv_in, const float* __restrict__ pv_in,
    const float* __restrict__ coeffs_g, float* __restrict__ inv_out,
    float* __restrict__ pv_out, float* __restrict__ dec_out,
    float* __restrict__ cons_out, float* __restrict__ imm_out,
    float* __restrict__ partials) {
  const int B = basis.nb;
  const int F = basis.nf;
  extern __shared__ float smem[];
  float* coeffs = smem;            // [B, G]
  float* par = coeffs + B * G;     // [NUM_PARAMS]
  float* mean = par + NUM_PARAMS;  // [B]
  float* stdv = mean + B;          // [B]
  float* rinv = stdv + B;          // [R]
  float* rmin = rinv + R;          // [R]
  float* rmax = rmin + R;          // [R]
  float* red = rmax + R;           // [kThreads / 32, kNumSums + B]

  const int tid = threadIdx.x;
  for (int i = tid; i < B * G; i += kThreads) coeffs[i] = coeffs_g[i];
  for (int i = tid; i < NUM_PARAMS; i += kThreads) par[i] = params_g[i];
  for (int i = tid; i < B; i += kThreads) {
    mean[i] = mean_g[i];
    stdv[i] = std_g[i];
  }
  for (int i = tid; i < R; i += kThreads) {
    rinv[i] = rinv_g[i];
    rmin[i] = rmin_g[i];
    rmax[i] = rmax_g[i];
  }
  __syncthreads();

  const int s = blockIdx.x * kThreads + tid;
  const bool valid = s < S;
  float acc[kNumSums + stt::kMaxB];
#pragma unroll
  for (int k = 0; k < kNumSums + stt::kMaxB; ++k) acc[k] = 0.0f;

  if (valid) {
    const float sp = spot[s];
    const float inv = inv_in[s];
    float fac[stt::kMaxF];
#pragma unroll
    for (int f = 0; f < stt::kMaxF; ++f)
      fac[f] = f < F ? factors[static_cast<size_t>(f) * S + s] : 0.0f;
    float dm[stt::kMaxB];
    stt::design_row(basis, sp, fac, mean, stdv, dm);

    // Ratchet rates at the inventory (_ratchet_rates_smem).
    const float inv_c = clampf(inv, rinv[0], rinv[R - 1]);
    float min_rate = rmin[0];
    float max_rate = rmax[0];
    if (is_step) {
      for (int r = 1; r < R; ++r) {
        if (inv_c >= rinv[r]) {
          min_rate = rmin[r];
          max_rate = rmax[r];
        }
      }
    } else {
      for (int r = 0; r + 1 < R; ++r) {
        const float x0 = rinv[r];
        const float span = __fsub_rn(rinv[r + 1], x0);
        const float safe = span > 0.0f ? span : 1.0f;
        const float w = clampf(__fdiv_rn(__fsub_rn(inv_c, x0), safe), 0.0f, 1.0f);
        if (r == 0 || inv_c >= x0) {
          min_rate = lerp(rmin[r], rmin[r + 1], w);
          max_rate = lerp(rmax[r], rmax[r + 1], w);
        }
      }
    }

    // Bang-bang decision set (_bang_bang).
    const float loss_pcnt = par[P_LOSS_PCNT];
    const float next_min = par[P_NEXT_MIN];
    const float next_max = par[P_NEXT_MAX];
    const float inv_after_loss = __fsub_rn(inv, __fmul_rn(loss_pcnt, inv));
    const float w_target = __fadd_rn(min_rate, inv_after_loss);
    const float yw = w_target > next_max ? __fsub_rn(next_max, inv_after_loss)
                   : (w_target > next_min ? min_rate : __fsub_rn(next_min, inv_after_loss));
    const float i_target = __fadd_rn(max_rate, inv_after_loss);
    const float yi = i_target < next_min ? __fsub_rn(next_min, inv_after_loss)
                   : (i_target < next_max ? max_rate : __fsub_rn(next_max, inv_after_loss));
    const bool has_zero = (yw < 0.0f) && (yi > 0.0f);
    const int D = 2 * E + 3;
    const int mid = E + 1;

    const float loss = __fmul_rn(loss_pcnt, inv);
    const float grid_lo = par[P_GRID_LO];
    const float grid_hi = par[P_GRID_HI];
    const float inv_delta = par[P_GRID_INVDELTA];
    const float df_settle = par[P_DF_SETTLE];
    const float df_flow = par[P_DF_FLOW];
    const float inv_cost_npv = __fmul_rn(__fmul_rn(par[P_INV_COST], inv), df_flow);

    float best_total = 0.0f, opt_dec = 0.0f, opt_cons = 0.0f, opt_imm = 0.0f,
          opt_inv = 0.0f;
    for (int k = 0; k < D; ++k) {
      float dec;
      if (has_zero) {
        dec = k <= mid
            ? __fmul_rn(yw, static_cast<float>(1.0 - static_cast<double>(k) / mid))
            : __fmul_rn(yi, static_cast<float>(static_cast<double>(k - mid) / mid));
      } else {
        const float frac = static_cast<float>((k > 1 ? k - 1.0 : 0.0) / (D - 2));
        dec = __fadd_rn(yw, __fmul_rn(__fsub_rn(yi, yw), frac));
      }
      const float inv_after = __fsub_rn(__fadd_rn(inv, dec), loss);
      const float pos = __fmul_rn(
          __fsub_rn(clampf(inv_after, grid_lo, grid_hi), grid_lo), inv_delta);
      const int lo = min(max(static_cast<int>(floorf(pos)), 0), G - 2);
      const float w = clampf(__fsub_rn(pos, static_cast<float>(lo)), 0.0f, 1.0f);
      float p_lo = __fmul_rn(coeffs[lo], dm[0]);
      float p_hi = __fmul_rn(coeffs[lo + 1], dm[0]);
#pragma unroll
      for (int b = 1; b < stt::kMaxB; ++b) {
        if (b < B) {
          p_lo = __fadd_rn(p_lo, __fmul_rn(coeffs[b * G + lo], dm[b]));
          p_hi = __fadd_rn(p_hi, __fmul_rn(coeffs[b * G + lo + 1], dm[b]));
        }
      }
      const float cont = lerp(p_lo, p_hi, w);
      const bool is_inject = dec > 0.0f;
      const float abs_d = fabsf(dec);
      const float consumed = __fmul_rn(is_inject ? par[P_INJ_PCNT] : par[P_WDR_PCNT], abs_d);
      const float cost_npv = __fmul_rn(
          __fmul_rn(is_inject ? par[P_INJ_COST] : par[P_WDR_COST], abs_d), df_flow);
      const float imm = __fsub_rn(
          __fsub_rn(__fmul_rn(__fmul_rn(-__fadd_rn(dec, consumed), df_settle), sp),
                    cost_npv),
          inv_cost_npv);
      const float total = __fadd_rn(imm, cont);
      if (k == 0 || total > best_total) {
        best_total = total;
        opt_dec = dec;
        opt_cons = consumed;
        opt_imm = imm;
        opt_inv = inv_after;
      }
    }
    inv_out[s] = opt_inv;
    pv_out[s] = __fadd_rn(pv_in[s], opt_imm);
    dec_out[s] = opt_dec;
    cons_out[s] = opt_cons;
    if (imm_out) imm_out[s] = opt_imm;

    acc[0] = inv;
    acc[1] = opt_dec;
    acc[2] = opt_cons;
    acc[3] = loss;
    acc[4] = opt_imm;
    acc[5] = __fmul_rn(-__fadd_rn(opt_dec, opt_cons), sp);
#pragma unroll
    for (int b = 0; b < stt::kMaxB; ++b)
      if (b < B) acc[kNumSums + b] = dm[b];
  }

  // Block partials: warp butterflies, then the warps in order.
  const int nout = kNumSums + B;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < kNumSums + stt::kMaxB; ++k) {
    if (k < nout) {
      float x = acc[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane == 0) red[warp * nout + k] = x;
    }
  }
  __syncthreads();
  if (tid < nout) {
    float x = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) x += red[w * nout + tid];
    partials[static_cast<size_t>(tid) * gridDim.x + blockIdx.x] = x;
  }
}

}  // namespace

extern "C" int stt_forward_step(
    int S, int F, int G, int R, int E, int is_step, const int* basis_table,
    const void* params, const void* mean, const void* stdv,
    const void* ratchet_inv, const void* ratchet_min, const void* ratchet_max,
    const void* spot, const void* factors, const void* inv, const void* pv,
    const void* coeffs, void* new_inv, void* new_pv, void* dec, void* cons,
    void* imm, void* partials, void* sums, void* stream) {
  stt::Basis basis;
  if (!stt::make_basis(basis_table, F, &basis) || G < 2 || R < 1 || R > kMaxR ||
      E < 0 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int B = basis.nb;
  const int nblk = (S + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(B) * G + NUM_PARAMS + 2 * B + 3 * R +
       (kThreads / 32) * (kNumSums + B));
  cudaError_t err = cudaFuncSetAttribute(
      forward_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  forward_step_kernel<<<nblk, kThreads, smem, st>>>(
      S, G, R, E, is_step, basis, static_cast<const float*>(params),
      static_cast<const float*>(mean), static_cast<const float*>(stdv),
      static_cast<const float*>(ratchet_inv),
      static_cast<const float*>(ratchet_min),
      static_cast<const float*>(ratchet_max), static_cast<const float*>(spot),
      static_cast<const float*>(factors), static_cast<const float*>(inv),
      static_cast<const float*>(pv), static_cast<const float*>(coeffs),
      static_cast<float*>(new_inv), static_cast<float*>(new_pv),
      static_cast<float*>(dec), static_cast<float*>(cons),
      static_cast<float*>(imm), static_cast<float*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stt::launch_reduce(static_cast<const float*>(partials), nblk,
                     kNumSums + B, static_cast<float*>(sums), st);
  return static_cast<int>(cudaGetLastError());
}
