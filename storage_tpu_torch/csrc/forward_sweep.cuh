// Kernel C's sweep (csrc/forward_kernel.cu describes it), shared by its two
// translation units: forward_kernel.cu compiles the shared route, whose
// ring stages each step's whole packed row, coefficients [B, G] (and in
// general-grid mode the next grid row and its bucket index) included;
// forward_kernel_large.cu the large route, for grids whose two rows do not
// fit a block's shared memory: the ring stages only each row's fixed part,
// and each decision reads its two coefficient rows of [G, Bp] in 16-byte
// loads (and its grid nodes and buckets) in device memory, through L1.  The
// two compile in parallel.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "dp_common.cuh"

namespace {

constexpr int kThreads = 256;  // threads per block: one partials group
constexpr int kSims = 1;       // sims per thread (kSims groups per block)
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;     // ring stages: the tables of two steps
// Parameter slots (ops/forward_kernel.py pack_params).
enum {
  P_DF_SETTLE, P_DF_FLOW, P_INJ_COST, P_WDR_COST, P_INJ_PCNT, P_WDR_PCNT,
  P_LOSS_PCNT, P_INV_COST, P_NEXT_MIN, P_NEXT_MAX, P_GRID_LO, P_GRID_HI,
  P_GRID_INVDELTA, NUM_PARAMS
};
constexpr int kNumSums = 8;   // 6 used, 2 kept zero (the JAX layout)
constexpr int kUsedSums = 6;

// Floats of the general-grid mode's tail of a step (ops/forward_kernel.py
// general_tail): the next step's grid row [G], its bucket scale, and the
// bucket index [G] (K = G - 1 buckets, K + 1 counts).
__host__ __device__ inline int general_words(int G) { return 2 * G + 1; }
// Floats of one step's packed table (ops/forward_kernel.py table_layout):
// parameters, mean [B], std [B], ratchet inventories, min and max rates [R]
// each, coefficients [B, G], in general-grid mode the general tail; padded
// to whole 16-byte words for the bulk copy.
__host__ __device__ inline int table_words(int B, int R, int G, bool general) {
  return (NUM_PARAMS + 2 * B + 3 * R + B * G + (general ? general_words(G) : 0) + 3) / 4 * 4;
}
// The large route's coefficients [N, G, Bp]: each grid row's B terms padded
// to a whole number of 16-byte words.
__host__ __device__ inline int padded_basis(int B) { return (B + 3) / 4 * 4; }
// The large route's row: the same parts without the coefficients and the
// grid row, which stay in device memory.
__host__ __device__ inline int fixed_table_words(int B, int R) {
  return table_words(B, R, 0, false);
}
// Floats of one stage's per-sim slots: spot and V staged values (the F
// factors, or the B design values in design mode) of the block's sims, as
// [1 + V][kSims][kThreads].
__host__ __device__ inline int slot_words(int V) { return (1 + V) * kSims * kThreads; }
// Whether the sweep takes its wide route (B = 0 below, the basis size known
// at run time): past stt::kMaxB terms in either mode, and in the monomial
// mode also past stt::kMaxF factors.
__host__ __device__ inline bool is_wide(int B, int F, bool design) {
  return B > stt::kMaxB || (!design && F > stt::kMaxF);
}
// Floats of the wide route's own dynamic shared memory (none on the compiled
// sizes, which keep their sums in static shared memory): the warps' sums of
// two steps, [2][kSims][kWarps][6 + B]; in the monomial mode also each sim's
// standardised design row [B][kSims][kThreads] and the powers [B, F + 1]
// int8 in whole words.
__host__ __device__ inline int wide_words(int B, int F, bool design) {
  return 2 * kSims * kWarps * (kUsedSums + B) +
         (design ? 0 : B * kSims * kThreads + (B * (F + 1) + 3) / 4);
}
// Dynamic shared memory, in floats: kStages tables (their padding counted at
// its most; on the shared route in general-grid mode also the tail's scale)
// and slots of V staged values a sim (the F factors, or B in design mode),
// then the decision fractions [2, D] (D = 2E + 3), then the wide route's own.
__host__ __device__ inline size_t smem_fixed_words(int B, int R, int F, int E, bool design,
                                                   bool staged_tail = false) {
  const int V = design ? B : F;
  return static_cast<size_t>(kStages) *
             (NUM_PARAMS + 2 * B + 3 * R + 3 + (staged_tail ? 1 : 0) + slot_words(V)) +
         2 * (2 * static_cast<size_t>(E) + 3) +
         (is_wide(B, F, design) ? wide_words(B, F, design) : 0);
}
// The shared route's words a grid point: coefficients, and in general-grid
// mode the grid row's node and bucket count.
__host__ __device__ inline size_t smem_words_per_grid_point(int B, bool general) {
  return static_cast<size_t>(kStages) * (B + (general ? 2 : 0));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// TMA: `bytes` (a multiple of 16) from global to shared memory, completing
// on `bar`, which is told first how many bytes to expect.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// 4 bytes from global to shared memory, in this thread's open cp.async group.
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ float lerp(float x0, float x1, float w) {
  return __fadd_rn(__fmul_rn(x0, __fsub_rn(1.0f, w)), __fmul_rn(x1, w));
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// A load from shared memory, or on the large route (kGlobal) from device
// memory through the read-only path.
template <bool kGlobal, typename T>
__device__ __forceinline__ T read_at(const T* p) {
  if constexpr (kGlobal) return __ldg(p); else return *p;
}

// The general-grid mode's next grid row with its bucket index
// (ops/forward_kernel.py general_tail): K = G - 1 uniform buckets over
// [a, b] = [grid[0], grid[G - 1]], the bucket of x floor((x - a) * scale)
// (within [0, K - 1]: bucket_of), and cnt[i] the count of interior nodes
// whose bucket is below i.  The row is non-decreasing (a custom grid's rows
// are sorted, interp.interp_weights_general's contract) and the bucket is
// non-decreasing in x, so every interior node of a lower bucket lies below
// x and every one of a higher bucket above it: the count of interior nodes
// <= x, general_weights' lower node, lies in [cnt[i], cnt[i + 1]], found
// from the nodes of bucket i alone.  The index kernel computes the nodes'
// buckets with the same function, so the bracket holds by the same
// comparisons the search makes.
struct GeneralRow {
  const float* grid;  // [G]
  const int* cnt;     // [G]
  float a, b, scale;
  int G;
};

// The bucket of x on a row of G nodes: floor((x - a) * scale) within
// [0, K - 1], each operation rounded on its own; the index kernel
// (forward_kernel.cu general_tail_kernel) and the search share it, so a
// node and a target meet the same comparisons.
__device__ __forceinline__ int bucket_of(float x, float a, float scale, int G) {
  return static_cast<int>(fminf(fmaxf(floorf(__fmul_rn(__fsub_rn(x, a), scale)), 0.0f),
                                static_cast<float>(G - 2)));
}

template <bool kGlobal>
__device__ __forceinline__ GeneralRow general_row(const float* tail, int G) {
  return GeneralRow{tail, reinterpret_cast<const int*>(tail + G + 1), read_at<kGlobal>(tail),
                    read_at<kGlobal>(tail + G - 1), read_at<kGlobal>(tail + G), G};
}

// The lower node and weight of x on the row: general_weights' answer, from
// the bucket's nodes alone.  A bucket of at most two nodes is decided from
// the four nodes from cnt[i] on, read together; a wider one (the padding's
// repeats of the last node) by binary search within it, at most
// log2(width) probes.
template <bool kGlobal>
__device__ __forceinline__ void indexed_weights(const GeneralRow& row, float x, int* idx,
                                                float* w) {
  const float* grid = row.grid;
  const int G = row.G;
  const float xc = stt_dp::clamp_to(x, row.a, row.b);
  const int i = bucket_of(xc, row.a, row.scale, G);
  int c = read_at<kGlobal>(row.cnt + i);
  const int c1 = read_at<kGlobal>(row.cnt + i + 1);
  float x0, x1;
  if (c1 - c <= 2) {
    const float g0 = read_at<kGlobal>(grid + c);
    const float g1 = read_at<kGlobal>(grid + c + 1);
    const float g2 = read_at<kGlobal>(grid + min(c + 2, G - 1));
    const float g3 = read_at<kGlobal>(grid + min(c + 3, G - 1));
    const bool n1 = c1 > c && g1 <= xc;
    const bool n2 = c1 > c + 1 && g2 <= xc;  // implies n1: the row is sorted
    x0 = n2 ? g2 : (n1 ? g1 : g0);
    x1 = n2 ? g3 : (n1 ? g2 : g1);
    c += static_cast<int>(n1) + static_cast<int>(n2);
  } else {
    int lo = c + 1, hi = c1 + 1;  // first r in [c + 1, c1 + 1) with grid[r] > xc
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (read_at<kGlobal>(grid + mid) <= xc) lo = mid + 1; else hi = mid;
    }
    c = lo - 1;
    x0 = read_at<kGlobal>(grid + c);
    x1 = read_at<kGlobal>(grid + c + 1);
  }
  *idx = c;
  const float span = __fsub_rn(x1, x0);
  *w = span > 0.0f ? __fdiv_rn(__fsub_rn(xc, x0), span) : 0.0f;
}

// A row of the large route's coefficients [G, Bp] (16-byte aligned) into
// registers: B / 4 16-byte loads, then the rest in one load.
template <int B>
__device__ __forceinline__ void load_coef_row(const float* __restrict__ p, float (&r)[B]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < B / 4; ++i) {
    const float4 v = __ldg(q + i);
    r[4 * i] = v.x;
    r[4 * i + 1] = v.y;
    r[4 * i + 2] = v.z;
    r[4 * i + 3] = v.w;
  }
  constexpr int t = B / 4 * 4;
  if constexpr (B % 4 == 1) {
    r[t] = __ldg(p + t);
  } else if constexpr (B % 4 == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p + t));
    r[t] = v.x;
    r[t + 1] = v.y;
  } else if constexpr (B % 4 == 3) {
    const float4 v = __ldg(q + B / 4);
    r[t] = v.x;
    r[t + 1] = v.y;
    r[t + 2] = v.z;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// A basis term as the design row reads it: its count of nonzero powers, then
// each as (source << 8) | power, the spot (source 0) first and then the
// factors by index (source 1 + f).
constexpr int kTermWords = stt::kMaxF + 2;

__device__ __forceinline__ void make_term(const stt::Basis& basis, int b, int* term) {
  int n = 0;
  for (int src = 0; src <= basis.nf; ++src)
    if (basis.pows[b][src]) term[1 + n++] = (src << 8) | basis.pows[b][src];
  term[0] = n;
}

// Entry b of a sim's standardised design row, stt::design_row's arithmetic
// (each power's product rounded on its own, the spot first, then the
// factors by index) over the term's nonzero powers only; source i's value
// at vals[i * stride].
__device__ __forceinline__ float design_entry(const int* term, const float* vals, int stride,
                                              float mean, float stdv) {
  float x = 1.0f;
#pragma unroll 1
  for (int i = 0; i < term[0]; ++i) {
    const int e = term[1 + i];
    x = __fmul_rn(x, stt::ipow(vals[(e >> 8) * stride], e & 0xff));
  }
  return __fdiv_rn(__fsub_rn(x, mean), stdv);
}

// The same entry on the monomial mode's wide route, from the term's row of
// the staged powers [B, F + 1] (the spot's power, then the factors' by
// index; read at warp-uniform addresses): the same products in the same
// order, so the same bits.
__device__ __forceinline__ float design_entry(const int8_t* pows, int nf, const float* vals,
                                              int stride, float mean, float stdv) {
  float x = 1.0f;
#pragma unroll 1
  for (int i = 0; i <= nf; ++i) {
    const int p = pows[i];
    if (p) x = __fmul_rn(x, stt::ipow(vals[i * stride], p));
  }
  return __fdiv_rn(__fsub_rn(x, mean), stdv);
}

// A sim's standardised design row of B entries in registers (B > 0), or of
// nb entries in shared memory at `stride` floats apart (the wide route).
template <int B>
struct RegisterRow {
  static constexpr int kSize = B;
  float v[B];
  __device__ __forceinline__ float at(int b) const { return v[b]; }
  __device__ __forceinline__ int size() const { return B; }
};
struct SharedRow {
  static constexpr int kSize = 0;
  const float* p;
  int nb, stride;
  __device__ __forceinline__ float at(int b) const { return p[b * stride]; }
  __device__ __forceinline__ int size() const { return nb; }
};

// One step of one sim from inventory `inv` and spot `sp`, with its design row
// `dm` (nb entries), the step's table at `par` and the
// decision fractions `frac` [2, D]: those the one-step kernel computed in
// double for every decision of every sim, computed once per block and rounded
// to f32 the same way.
struct StepResult {
  float inv, dec, cons, imm, loss;
};

// Rows lo and lo + 1 of the large route's coefficients [G, Bp] at c, each
// dotted with the design row: each term's product rounded on its own and
// summed from b = 0 up, the shared route's order.
template <typename Row>
__device__ __forceinline__ void dot_rows_large(const float* __restrict__ c, const Row& dm,
                                               float* p_lo, float* p_hi) {
  constexpr int B = Row::kSize;
  if constexpr (B > 0) {
    float lo[B], hi[B];
    load_coef_row<B>(c, lo);
    load_coef_row<B>(c + padded_basis(B), hi);
    float a = __fmul_rn(lo[0], dm.at(0));
    float b = __fmul_rn(hi[0], dm.at(0));
#pragma unroll
    for (int k = 1; k < B; ++k) {
      a = __fadd_rn(a, __fmul_rn(lo[k], dm.at(k)));
      b = __fadd_rn(b, __fmul_rn(hi[k], dm.at(k)));
    }
    *p_lo = a;
    *p_hi = b;
  } else {
    // The wide route: the basis size known at run time.
    const int nb = dm.size();
    const int bp = padded_basis(nb);
    float a = 0.0f, b = 0.0f;
    for (int q = 0; q < nb; q += 4) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(c + q));
      const float4 v = __ldg(reinterpret_cast<const float4*>(c + bp + q));
      const float us[4] = {u.x, u.y, u.z, u.w};
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = q + j;
        if (k < nb) {
          const float x = dm.at(k);
          a = k == 0 ? __fmul_rn(us[j], x) : __fadd_rn(a, __fmul_rn(us[j], x));
          b = k == 0 ? __fmul_rn(vs[j], x) : __fadd_rn(b, __fmul_rn(vs[j], x));
        }
      }
    }
    *p_lo = a;
    *p_hi = b;
  }
}

// On the large route (kLarge) the step's coefficients [G, Bp] and, in
// general-grid mode, its general tail (the next grid row and its bucket
// index) are read from device memory (coef_t, tail_t) through L1; else from
// the staged row.
template <bool kGeneral, bool kLarge, typename Row>
__device__ __forceinline__ StepResult step_sim(const float* par, int R, int G, int E,
                                               int is_step, float sp, float inv,
                                               const Row& dm, const float* frac,
                                               const float* __restrict__ coef_t,
                                               const float* __restrict__ tail_t) {
  const int B = dm.size();
  const float* rinv = par + NUM_PARAMS + 2 * B;
  const float* rmin = rinv + R;
  const float* rmax = rmin + R;
  const float* coeffs = rmax + R;        // [B, G]
  GeneralRow row{};
  if constexpr (kGeneral) row = general_row<kLarge>(kLarge ? tail_t : coeffs + B * G, G);

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

  float best_total = 0.0f;
  StepResult best{0.0f, 0.0f, 0.0f, 0.0f, loss};
  for (int k = 0; k < D; ++k) {
    const float dec = has_zero ? __fmul_rn(k <= mid ? yw : yi, frac[k])
                               : __fadd_rn(yw, __fmul_rn(__fsub_rn(yi, yw), frac[D + k]));
    const float inv_after = __fsub_rn(__fadd_rn(inv, dec), loss);
    int lo;
    float w;
    if constexpr (kGeneral) {
      indexed_weights<kLarge>(row, inv_after, &lo, &w);
    } else {
      const float pos = __fmul_rn(
          __fsub_rn(clampf(inv_after, grid_lo, grid_hi), grid_lo), inv_delta);
      lo = min(max(static_cast<int>(floorf(pos)), 0), G - 2);
      w = clampf(__fsub_rn(pos, static_cast<float>(lo)), 0.0f, 1.0f);
    }
    float p_lo, p_hi;
    if constexpr (kLarge) {
      dot_rows_large(coef_t + static_cast<size_t>(lo) * padded_basis(B), dm, &p_lo, &p_hi);
    } else {
      p_lo = __fmul_rn(coeffs[lo], dm.at(0));
      p_hi = __fmul_rn(coeffs[lo + 1], dm.at(0));
#pragma unroll
      for (int b = 1; b < B; ++b) {
        p_lo = __fadd_rn(p_lo, __fmul_rn(coeffs[b * G + lo], dm.at(b)));
        p_hi = __fadd_rn(p_hi, __fmul_rn(coeffs[b * G + lo + 1], dm.at(b)));
      }
    }
    const float cont = lerp(p_lo, p_hi, w);
    const bool is_inject = dec > 0.0f;
    const float abs_d = fabsf(dec);
    const float consumed = __fmul_rn(is_inject ? par[P_INJ_PCNT] : par[P_WDR_PCNT], abs_d);
    const float cost_npv = __fmul_rn(
        __fmul_rn(is_inject ? par[P_INJ_COST] : par[P_WDR_COST], abs_d), df_flow);
    const float imm = __fsub_rn(
        __fsub_rn(__fmul_rn(__fmul_rn(-__fadd_rn(dec, consumed), df_settle), sp), cost_npv),
        inv_cost_npv);
    const float total = __fadd_rn(imm, cont);
    if (k == 0 || total > best_total) {
      best_total = total;
      best.dec = dec;
      best.cons = consumed;
      best.imm = imm;
      best.inv = inv_after;
    }
  }
  return best;
}

// `values` is [N, V, S]: the factors (V = F) or, in design mode, the raw
// design values (V = B).  B = 0 is the wide route, its basis size basis.nb
// (and factor count basis.nf) known at run time; in the monomial mode its
// powers are pows_g [B, F + 1] int8 in device memory (NULL elsewhere), which
// each block stages in shared memory.  kLarge: the large route, whose
// `table` rows hold the fixed parts alone, the coefficients [N, G, Bp] and
// the general tails [N, 2G + 1] at coef_g and grid_g (NULL on the shared
// route).
template <int B, bool kDesign, bool kGeneral, bool kLarge>
__global__ void __launch_bounds__(kThreads) forward_sweep_kernel(
    int N, int S, int G, int R, int E, int is_step, stt::Basis basis,
    const int8_t* __restrict__ pows_g,
    const float* __restrict__ table, const float* __restrict__ coef_g,
    const float* __restrict__ grid_g, const float* __restrict__ spot,
    const float* __restrict__ values, const float* __restrict__ inv0,
    const float* __restrict__ pv0, float* __restrict__ inv_out, float* __restrict__ pv_out,
    float* __restrict__ inv_rows, float* __restrict__ dec_rows, float* __restrict__ cons_rows,
    float* __restrict__ imm_rows, float* __restrict__ partials) {
  constexpr bool kWide = B == 0;
  const int nb = kWide ? basis.nb : B;
  const int nf = basis.nf;
  const int V = kDesign ? nb : nf;
  const int W = kLarge ? fixed_table_words(nb, R) : table_words(nb, R, G, kGeneral);
  const int nslot = slot_words(V);
  const int nout = kNumSums + nb;
  const int ngroups = (S + kThreads - 1) / kThreads;
  const int pitch = kUsedSums + nb;  // of the warps' sums of a step
  __shared__ uint64_t bars[kStages];
  // The warps' sums by parity of the step, [2][kSims][kWarps][pitch]; the
  // wide route's in dynamic shared memory.
  __shared__ float red_fixed[kWide ? 1 : 2 * kSims * kWarps * (kUsedSums + B)];
  __shared__ int terms[kWide ? 1 : B][kTermWords];
  extern __shared__ __align__(128) float smem[];
  float* ring = smem;                                  // [kStages][W]
  float* slots = ring + kStages * W;                   // [kStages][nslot]
  float* frac = slots + kStages * nslot;               // [2, D]
  float* red = kWide ? frac + 2 * (2 * E + 3) : red_fixed;
  // The monomial mode's wide route: each sim's design row [nb][kSims]
  // [kThreads] after the sums, then the staged powers [nb, nf + 1].
  float* dm_rows = kWide ? red + 2 * kSims * kWarps * (kUsedSums + nb) : nullptr;
  int8_t* pows = kWide ? reinterpret_cast<int8_t*>(dm_rows + nb * kSims * kThreads) : nullptr;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int sim[kSims];
  bool valid[kSims];
#pragma unroll
  for (int j = 0; j < kSims; ++j) {
    const int col = (blockIdx.x * kSims + j) * kThreads + tid;
    valid[j] = col < S;
    sim[j] = min(col, S - 1);  // the sims past S compute on sim S − 1 and count as zeros
  }

  // Starts the copies of step t's table and this thread's values into stage
  // t % kStages, and closes the thread's cp.async group (empty past N).
  auto stage = [&](int t) {
    if (t < N) {
      const int k = t % kStages;
      if (tid == 0)
        bulk_copy(ring + k * W, table + static_cast<size_t>(t) * W,
                  static_cast<uint32_t>(W * sizeof(float)), &bars[k]);
      float* slot = slots + k * nslot + tid;
#pragma unroll
      for (int j = 0; j < kSims; ++j) {
        copy4(slot + j * kThreads, spot + static_cast<size_t>(t) * S + sim[j]);
        for (int f = 0; f < V; ++f)
          copy4(slot + ((1 + f) * kSims + j) * kThreads,
                values + (static_cast<size_t>(t) * V + f) * S + sim[j]);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  if (tid == 0) {
    for (int k = 0; k < kStages; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&bars[k])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (!kDesign && tid < B) make_term(basis, tid, terms[tid]);
  if constexpr (kWide && !kDesign) {
    for (int i = tid; i < nb * (nf + 1); i += kThreads) pows[i] = pows_g[i];
  }
  // The decision fractions of _bang_bang: with a zero decision, decision k of
  // D = 2E + 3 scales the withdrawal (k <= E + 1) or the injection by frac[k];
  // without, it lies frac[D + k] of the way from one to the other.
  const int D = 2 * E + 3;
  const int mid = E + 1;
  for (int k = tid; k < D; k += kThreads) {
    frac[k] = k <= mid ? static_cast<float>(1.0 - static_cast<double>(k) / mid)
                       : static_cast<float>(static_cast<double>(k - mid) / mid);
    frac[D + k] = static_cast<float>((k > 1 ? k - 1.0 : 0.0) / (D - 2));
  }
  __syncthreads();
  for (int t = 0; t < kStages; ++t) stage(t);

  float inv[kSims], pv[kSims];
#pragma unroll
  for (int j = 0; j < kSims; ++j) {
    inv[j] = inv0[sim[j]];
    pv[j] = pv0 ? pv0[sim[j]] : 0.0f;
  }

  for (int t = 0; t < N; ++t) {
    const int k = t % kStages;
    const float* par = ring + k * W;
    const float* mean = par + NUM_PARAMS;
    const float* stdv = mean + nb;
    // This thread's values of step t have landed (step t + 1's may be in
    // flight), and so has the table.
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    wait_parity(&bars[k], (t / kStages) & 1);
    const size_t row = static_cast<size_t>(t) * S;
#pragma unroll
    for (int j = 0; j < kSims; ++j) {
      float* vals = slots + k * nslot + j * kThreads + tid;
      const float sp = vals[0];
      // The step of sim j on its standardised design row dm, and its sums.
      auto step = [&](const auto& dm) {
        const StepResult r = step_sim<kGeneral, kLarge>(
            par, R, G, E, is_step, sp, inv[j], dm, frac,
            kLarge ? coef_g + static_cast<size_t>(t) * G * padded_basis(nb) : nullptr,
            kLarge && kGeneral ? grid_g + static_cast<size_t>(t) * general_words(G) : nullptr);
        float acc[kUsedSums] = {inv[j], r.dec, r.cons, r.loss, r.imm,
                                __fmul_rn(-__fadd_rn(r.dec, r.cons), sp)};
        inv[j] = r.inv;
        pv[j] = __fadd_rn(pv[j], r.imm);
        if (valid[j]) {
          const size_t at = row + sim[j];
          if (inv_rows) inv_rows[at] = r.inv;
          if (dec_rows) dec_rows[at] = r.dec;
          if (cons_rows) cons_rows[at] = r.cons;
          if (imm_rows) imm_rows[at] = r.imm;
        }
        float* red_w = red + (((t & 1) * kSims + j) * kWarps + warp) * pitch;
#pragma unroll
        for (int c = 0; c < kUsedSums; ++c) {
          const float x = warp_sum(valid[j] ? acc[c] : 0.0f);
          if (lane == 0) red_w[c] = x;
        }
#pragma unroll
        for (int b = 0; b < dm.size(); ++b) {
          const float x = warp_sum(valid[j] ? dm.at(b) : 0.0f);
          if (lane == 0) red_w[kUsedSums + b] = x;
        }
      };
      if constexpr (kWide && kDesign) {
        // Standardised in place: only this thread reads its slots until the
        // stage is refilled, after the step's barrier.
        for (int b = 0; b < nb; ++b) {
          float* x = vals + (1 + b) * kSims * kThreads;
          *x = __fdiv_rn(__fsub_rn(*x, mean[b]), stdv[b]);
        }
        step(SharedRow{vals + kSims * kThreads, nb, kSims * kThreads});
      } else if constexpr (kWide) {
        // Built into this thread's own column of the design rows, which
        // only it reads, from the spot and the F factors in its slots.
        float* row = dm_rows + j * kThreads + tid;
        for (int b = 0; b < nb; ++b)
          row[b * kSims * kThreads] = design_entry(pows + b * (nf + 1), nf, vals,
                                                   kSims * kThreads, mean[b], stdv[b]);
        step(SharedRow{row, nb, kSims * kThreads});
      } else {
        RegisterRow<B> dm;
#pragma unroll
        for (int b = 0; b < B; ++b)
          dm.v[b] = kDesign
              ? __fdiv_rn(__fsub_rn(vals[(1 + b) * kSims * kThreads], mean[b]), stdv[b])
              : design_entry(terms[b], vals, kSims * kThreads, mean[b], stdv[b]);
        step(dm);
      }
    }
    __syncthreads();
    // Every thread is past step t: its stage takes step t + kStages.
    stage(t + kStages);
    // The step's partials row of each group: the warps in order.
    for (int i = tid; i < kSims * nout; i += kThreads) {
      const int j = i / nout;
      const int c = i % nout;
      float x = 0.0f;
      if (c < kUsedSums || c >= kNumSums) {
        const int col = c < kUsedSums ? c : c - (kNumSums - kUsedSums);
        for (int w = 0; w < kWarps; ++w)
          x += red[(((t & 1) * kSims + j) * kWarps + w) * pitch + col];
      }
      const int group = blockIdx.x * kSims + j;
      if (group < ngroups)
        partials[(static_cast<size_t>(t) * nout + c) * ngroups + group] = x;
    }
  }
#pragma unroll
  for (int j = 0; j < kSims; ++j) {
    if (valid[j]) {
      inv_out[sim[j]] = inv[j];
      pv_out[sim[j]] = pv[j];
    }
  }
}

using SweepKernel = decltype(&forward_sweep_kernel<1, false, false, false>);

// The sweep compiled for basis size B in either mode, on uniform or general
// grid rows, on the shared or the large route; past stt::kMaxB terms (in the
// monomial mode also past stt::kMaxF factors, F) the wide route.
template <bool kDesign, bool kGeneral, bool kLarge>
SweepKernel sweep_kernel(int B, int F) {
  static_assert(stt::kMaxB == 16, "one case per basis size");
  if (is_wide(B, F, kDesign)) return forward_sweep_kernel<0, kDesign, kGeneral, kLarge>;
  switch (B) {
    case 1: return forward_sweep_kernel<1, kDesign, kGeneral, kLarge>;
    case 2: return forward_sweep_kernel<2, kDesign, kGeneral, kLarge>;
    case 3: return forward_sweep_kernel<3, kDesign, kGeneral, kLarge>;
    case 4: return forward_sweep_kernel<4, kDesign, kGeneral, kLarge>;
    case 5: return forward_sweep_kernel<5, kDesign, kGeneral, kLarge>;
    case 6: return forward_sweep_kernel<6, kDesign, kGeneral, kLarge>;
    case 7: return forward_sweep_kernel<7, kDesign, kGeneral, kLarge>;
    case 8: return forward_sweep_kernel<8, kDesign, kGeneral, kLarge>;
    case 9: return forward_sweep_kernel<9, kDesign, kGeneral, kLarge>;
    case 10: return forward_sweep_kernel<10, kDesign, kGeneral, kLarge>;
    case 11: return forward_sweep_kernel<11, kDesign, kGeneral, kLarge>;
    case 12: return forward_sweep_kernel<12, kDesign, kGeneral, kLarge>;
    case 13: return forward_sweep_kernel<13, kDesign, kGeneral, kLarge>;
    case 14: return forward_sweep_kernel<14, kDesign, kGeneral, kLarge>;
    case 15: return forward_sweep_kernel<15, kDesign, kGeneral, kLarge>;
    case 16: return forward_sweep_kernel<16, kDesign, kGeneral, kLarge>;
    default: return nullptr;
  }
}

// The sweep of either grid mode, chosen at run time.
template <bool kDesign, bool kLarge>
SweepKernel pick_sweep(int B, int F, bool general) {
  return general ? sweep_kernel<kDesign, true, kLarge>(B, F)
                 : sweep_kernel<kDesign, false, kLarge>(B, F);
}

// Launches the sweep of either mode (basis.nb terms; the monomial mode's
// basis.nf factors, or in design mode B raw design values, staged a sim and
// step), then the reduce of its partials.  `pows` [B, F + 1] int8 in device
// memory are the monomial mode's powers on its wide route (else NULL).  With
// `large` (the large route) the ring stages only the fixed part of each row:
// coef [N, G, Bp] (16-byte aligned) and the general tails stay in device
// memory.
cudaError_t launch_sweep(SweepKernel kernel, bool design, int N, int S, int G, int R, int E,
                         int is_step, bool general, bool large, const stt::Basis& basis,
                         const int8_t* pows, const void* table, const void* coef,
                         const void* grid,
                         const void* spot, const void* values, const void* inv0,
                         const void* pv0, void* inv_out, void* pv_out, void* inv_rows,
                         void* dec_rows, void* cons_rows, void* imm_rows, void* partials,
                         void* totals, void* stream) {
  if (reinterpret_cast<uintptr_t>(table) % 16 != 0) return cudaErrorMisalignedAddress;
  if (!kernel || (large && (!coef || (general && !grid)))) return cudaErrorInvalidValue;
  if (large && reinterpret_cast<uintptr_t>(coef) % 16 != 0) return cudaErrorMisalignedAddress;
  const int B = basis.nb;
  if (!design && is_wide(B, basis.nf, false) != (pows != nullptr)) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) *
      (smem_fixed_words(B, R, basis.nf, E, design, general && !large) +
       (large ? 0 : smem_words_per_grid_point(B, general) * G));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = (S + kSims * kThreads - 1) / (kSims * kThreads);
  kernel<<<nblk, kThreads, smem, st>>>(
      N, S, G, R, E, is_step, basis, pows, static_cast<const float*>(table),
      static_cast<const float*>(coef), static_cast<const float*>(grid),
      static_cast<const float*>(spot), static_cast<const float*>(values),
      static_cast<const float*>(inv0), static_cast<const float*>(pv0),
      static_cast<float*>(inv_out), static_cast<float*>(pv_out),
      static_cast<float*>(inv_rows), static_cast<float*>(dec_rows),
      static_cast<float*>(cons_rows), static_cast<float*>(imm_rows),
      static_cast<float*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stt::launch_reduce(static_cast<const float*>(partials), (S + kThreads - 1) / kThreads,
                     N * (kNumSums + B), static_cast<float*>(totals), st);
  return cudaGetLastError();
}

}  // namespace
