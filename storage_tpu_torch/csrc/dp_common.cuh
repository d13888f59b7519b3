// Device functions shared by the DP kernels on the inventory grid: the
// intrinsic DP (intrinsic_kernel.cu) and the trinomial tree's backward
// induction (tree_kernel.cu); kernel C (forward_kernel.cu) takes
// general_weights for its general-grid mode.
//
// One function, decide(), values every decision of one step at one
// inventory and keeps the first best, as decision_totals / decision_values of
// engines/intrinsic.py do: the ratchet rates at the inventory (the interior
// nodes 1..R-2 counted, as grid.ratchet_rates), the bang-bang set of
// D = 2E + 3 volumes, each one's immediate PV and fuel at the given price,
// the loss, the inventory after the decision, the continuation interpolated
// on the next step's grid, and the first maximum over d (strict > in
// ascending d, as jnp.argmax takes it).  Every product and sum is rounded on
// its own (no contraction to FMA), so the arithmetic is the plain version's
// operation by operation.  decide_lanes() spreads the D decisions over a
// group of lanes and keeps the same first best (FirstBest).  A step's
// decision table (table_column_fill, entry_total) splits the same
// operations where the price and the next row's values enter, so that the
// backward passes, whose inventories are the grid points, do the part
// before that off their chain.
//
// The continuation comes in three modes:
//   0 uniform linear: the arithmetic position on a linspace row;
//   1 general linear: the lower node is the count of interior nodes <= x (a
//     binary search), so a zero-span segment of a fixed-spacing or custom
//     row's padding takes its left node's value;
//   2 natural cubic: the row's moments M = solver @ rhs (block_moments, a
//     block matvec over the dense [G-2, G-2] inverse, as the JAX package
//     does).  A degenerate row (h = 0) has zero moments and zero curvature.
#pragma once

#include <cuda_runtime.h>

namespace stt_dp {

// Step scalar slots (ops/intrinsic_kernel.py pack_steps).
enum {
  S_FWD, S_DF_SETTLE, S_DF_FLOW, S_INJ_COST, S_WDR_COST, S_INJ_PCNT, S_WDR_PCNT,
  S_LOSS_PCNT, S_INV_COST, S_NEXT_MIN, S_NEXT_MAX, NUM_STEP_SCALARS
};
enum { MODE_UNIFORM = 0, MODE_GENERAL = 1, MODE_CUBIC = 2 };

// Rounded arithmetic: one rounding per operation, never an FMA.
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }

template <typename T>
__device__ __forceinline__ T clamp_to(T x, T lo, T hi) {
  // torch.minimum(torch.maximum(x, lo), hi)
  const T m = x > lo ? x : lo;
  return m < hi ? m : hi;
}

// Uniform-row lower node and weight (ops/interp.py interp_weights).
template <typename T>
__device__ __forceinline__ void uniform_weights(const T* grid, int G, T x, int* idx, T* w) {
  const T lo = grid[0], hi = grid[G - 1];
  const T delta = dvd(sub(hi, lo), static_cast<T>(G - 1));
  const T safe = delta > T(0) ? delta : T(1);
  T pos = dvd(sub(clamp_to(x, lo, hi), lo), safe);
  if (!(delta > T(0))) pos = T(0);
  int i = static_cast<int>(floor(pos));
  i = i < 0 ? 0 : (i > G - 2 ? G - 2 : i);
  *idx = i;
  *w = clamp_to(sub(pos, static_cast<T>(i)), T(0), T(1));
}

// General-row lower node and weight (ops/interp.py interp_weights_general):
// idx = #{r in 1..G-2 : grid[r] <= x} by binary search on the clamped x, and
// weight 0 on a zero-span segment.  Also kernel C's general-grid mode
// (forward_kernel.cu).
template <typename T>
__device__ __forceinline__ void general_weights(const T* grid, int G, T x, int* idx, T* w) {
  const T xc = clamp_to(x, grid[0], grid[G - 1]);
  int lo = 1, hi = G - 1;  // first r in [1, G-1) with grid[r] > xc
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (grid[mid] <= xc) lo = mid + 1; else hi = mid;
  }
  *idx = lo - 1;
  const T x0 = grid[lo - 1], x1 = grid[lo];
  const T span = sub(x1, x0);
  *w = span > T(0) ? dvd(sub(xc, x0), span) : T(0);
}

// The continuation at inventory x on the next step's row: values v and (cubic)
// moments m on grid, in device or shared memory.
template <typename T>
__device__ __forceinline__ T continuation(const T* grid, const T* v, const T* m, int G,
                                          int mode, T x) {
  if (mode == MODE_GENERAL) {
    // ops/interp.py interp_vector_general.
    int idx;
    T w;
    general_weights(grid, G, x, &idx, &w);
    return add(mul(v[idx], sub(T(1), w)), mul(v[idx + 1], w));
  }
  int idx;
  T w;
  uniform_weights(grid, G, x, &idx, &w);
  const T v_lo = v[idx], v_hi = v[idx + 1];
  if (mode == MODE_UNIFORM) return add(v_lo, mul(sub(v_hi, v_lo), w));
  // ops/interp.py interp_vector_cubic.
  const T h = dvd(sub(grid[G - 1], grid[0]), static_cast<T>(G - 1));
  const T u = sub(T(1), w);
  const T linear = add(mul(v_lo, u), mul(v_hi, w));
  if (!(h > T(0))) return linear;
  const T cu = sub(mul(mul(u, u), u), u);
  const T cw = sub(mul(mul(w, w), w), w);
  const T curvature = mul(dvd(mul(h, h), T(6)), add(mul(cu, m[idx]), mul(cw, m[idx + 1])));
  return add(linear, curvature);
}

// Ratchet rates at inventory inv (grid.ratchet_rates: the interior nodes
// 1..R-2 counted; step tables take the left node, linear ones lerp).
template <typename T>
__device__ __forceinline__ void ratchet_rates(const T* r_inv, const T* r_min, const T* r_max,
                                              int R, int is_step, T inv, T* min_rate,
                                              T* max_rate) {
  const T inv_c = clamp_to(inv, r_inv[0], r_inv[R - 1]);
  int idx = 0;
  for (int r = 1; r < R - 1; ++r) idx += inv_c >= r_inv[r];
  if (is_step) {
    *min_rate = r_min[idx];
    *max_rate = r_max[idx];
  } else {
    const int hi = idx + 1 < R ? idx + 1 : R - 1;
    const T x0 = r_inv[idx], x1 = r_inv[hi];
    const T w = x1 > x0 ? dvd(sub(inv_c, x0), sub(x1, x0)) : T(0);
    const T omw = sub(T(1), w);
    *min_rate = add(mul(r_min[idx], omw), mul(r_min[hi], w));
    *max_rate = add(mul(r_max[idx], omw), mul(r_max[hi], w));
  }
}

// The bang-bang decision set (grid.bang_bang_decisions): its two constrained
// ends, and whether holding (0) is feasible between them.
template <typename T>
struct BangBang {
  T yw, yi;
  bool has_zero;
  int nd, mid;

  __device__ __forceinline__ BangBang(T min_rate, T max_rate, T after_loss, T next_min,
                                      T next_max, int E) {
    const T w_target = add(min_rate, after_loss);
    yw = w_target > next_max ? sub(next_max, after_loss)
                             : (w_target > next_min ? min_rate : sub(next_min, after_loss));
    const T i_target = add(max_rate, after_loss);
    yi = i_target < next_min ? sub(next_min, after_loss)
                             : (i_target < next_max ? max_rate : sub(next_max, after_loss));
    has_zero = yw < T(0) && yi > T(0);
    nd = 2 * E + 3;
    mid = E + 1;
  }

  // Volume k of the D = 2E + 3.
  __device__ __forceinline__ T volume(int k) const {
    if (has_zero)
      return k <= mid ? mul(yw, sub(T(1), dvd(static_cast<T>(k), static_cast<T>(mid))))
                      : mul(yi, dvd(static_cast<T>(k - mid), static_cast<T>(mid)));
    const T frac = dvd(static_cast<T>(k > 1 ? k - 1 : 0), static_cast<T>(nd - 2));
    return add(yw, mul(sub(yi, yw), frac));
  }
};

// One step's tables as decide() reads them.
template <typename T>
struct StepView {
  const T* s;          // the step's scalars [NUM_STEP_SCALARS]
  const T* r_inv;      // the step's ratchet inventories [R]
  const T* r_min;      // its min rates [R]
  const T* r_max;      // its max rates [R]
  int R, is_step, E, G, mode;
  const T* grid_next;  // the next step's grid [G]
  const T* v_next;     // the continuation values on it [G]
  const T* m_next;     // their moments [G] (cubic) or null
};

template <typename T>
struct Choice {
  T total, decision, consumed, pv;
};

// The decision set at inventory inv: the loss, the bang-bang ends from the
// ratchet rates there, and the step's discounted inventory cost.
template <typename T>
struct Candidates {
  T loss, inv_cost_npv;
  BangBang<T> bb;
};

template <typename T>
__device__ __forceinline__ Candidates<T> candidates(const StepView<T>& st, T inv) {
  const T* s = st.s;
  T min_rate, max_rate;
  ratchet_rates(st.r_inv, st.r_min, st.r_max, st.R, st.is_step, inv, &min_rate, &max_rate);
  const T loss = mul(s[S_LOSS_PCNT], inv);
  const BangBang<T> bb(min_rate, max_rate, sub(inv, loss), s[S_NEXT_MIN], s[S_NEXT_MAX], st.E);
  return Candidates<T>{loss, mul(mul(s[S_INV_COST], inv), s[S_DF_FLOW]), bb};
}

// Decision k of the set against the price: its total, volume, fuel and
// immediate PV.
template <typename T>
__device__ __forceinline__ Choice<T> candidate(const StepView<T>& st, const Candidates<T>& c,
                                               T price, T inv, int k) {
  const T* s = st.s;
  const T df_settle = s[S_DF_SETTLE], df_flow = s[S_DF_FLOW];
  const T dec = c.bb.volume(k);
  // immediate_pv: ((iw - cost) + fuel) - inventory cost.
  const bool inject = dec > T(0);
  const T abs_dec = fabs(dec);
  const T consumed = mul(inject ? s[S_INJ_PCNT] : s[S_WDR_PCNT], abs_dec);
  const T iw = mul(mul(-dec, price), df_settle);
  const T cost = mul(mul(inject ? s[S_INJ_COST] : s[S_WDR_COST], abs_dec), df_flow);
  const T fuel = mul(mul(-consumed, price), df_settle);
  const T pv = sub(add(sub(iw, cost), fuel), c.inv_cost_npv);
  const T inv_after = sub(add(inv, dec), c.loss);
  const T total =
      add(pv, continuation(st.grid_next, st.v_next, st.m_next, st.G, st.mode, inv_after));
  return Choice<T>{total, dec, consumed, pv};
}

// The best decision at inventory inv against the price (the forward in the
// intrinsic DP, a node's spot in the tree).
template <typename T>
__device__ __forceinline__ Choice<T> decide(const StepView<T>& st, T price, T inv) {
  const Candidates<T> c = candidates(st, inv);
  Choice<T> best{T(0), T(0), T(0), T(0)};
  for (int k = 0; k < c.bb.nd; ++k) {
    const Choice<T> x = candidate(st, c, price, inv, k);
    if (k == 0 || x.total > best.total) best = x;
  }
  return best;
}

// What decide()'s scan keeps, the first maximum in ascending k, kept by a
// group of P adjacent lanes of a warp (P a power of two, 1 to 32; every lane
// of the warp takes part): each lane offers the totals of its decisions
// k = lane, lane + P, ... in ascending k, then a butterfly merges the group.
// A NaN total of decision 0 wins, any other NaN never does, as in the scan.
template <typename T>
struct FirstBest {
  T total;
  int k;      // -1: none yet
  bool nan0;  // decision 0's total is NaN

  // True where decision k becomes the lane's best.
  __device__ __forceinline__ bool offer(T x, int kx) {
    if (kx == 0) {
      total = x;
      k = 0;
      nan0 = isnan(x);
      return true;
    }
    if (nan0 || isnan(x) || (k >= 0 && !(x > total))) return false;
    total = x;
    k = kx;
    return true;
  }

  // The group's best on every lane of it.
  __device__ __forceinline__ void merge(int P) {
    for (int lane_mask = 1; lane_mask < P; lane_mask <<= 1) {
      const T o_total = __shfl_xor_sync(0xffffffffu, total, lane_mask);
      const int o_k = __shfl_xor_sync(0xffffffffu, k, lane_mask);
      const bool o_nan0 = __shfl_xor_sync(0xffffffffu, static_cast<int>(nan0), lane_mask) != 0;
      bool take;
      if (nan0 || o_nan0) take = o_nan0;
      else if (k < 0 || o_k < 0) take = k < 0;
      else take = o_total > total || (!(total > o_total) && o_k < k);
      if (take) {
        total = o_total;
        k = o_k;
        nan0 = o_nan0;
      }
    }
  }
};

// decide() by a group of P lanes (FirstBest): every lane returns the group's
// choice, its volume, fuel and PV from the lane that valued it.
template <typename T>
__device__ __forceinline__ Choice<T> decide_lanes(const StepView<T>& st, T price, T inv,
                                                int P) {
  const Candidates<T> c = candidates(st, inv);
  FirstBest<T> best{T(0), -1, false};
  Choice<T> mine{T(0), T(0), T(0), T(0)};
  for (int k = threadIdx.x & (P - 1); k < c.bb.nd; k += P) {
    const Choice<T> x = candidate(st, c, price, inv, k);
    if (best.offer(x.total, k)) mine = x;
  }
  best.merge(P);
  const int owner = (threadIdx.x & 31 & ~(P - 1)) | (best.k & (P - 1));
  return Choice<T>{best.total, __shfl_sync(0xffffffffu, mine.decision, owner),
                   __shfl_sync(0xffffffffu, mine.consumed, owner),
                   __shfl_sync(0xffffffffu, mine.pv, owner)};
}

// A step's decision table: at every grid point g and decision k, what
// decide() computes before the price and the continuation's values enter,
// so that one table serves every node row of the tree.  The entries are the
// operations of candidate() and continuation(), in their order, split where
// the price or a value of the next row first enters.  A grid point's column
// holds the inventory cost's PV, then for each decision its volume, fuel,
// cost's PV and the continuation's node (as a value of T) and weight.  The
// table is [table_row(D), G], value-major, so that neighbouring grid points
// sit in neighbouring words (coalesced, and free of shared-memory bank
// conflicts); `col` points at grid point g's first value and `stride` is G.
enum { E_DEC, E_FUEL, E_COST, E_IDX, E_W, NUM_ENTRY_FIELDS };

__host__ __device__ __forceinline__ int table_row(int D) { return 1 + NUM_ENTRY_FIELDS * D; }

// Grid point inv's column of a step's table (st.grid_next is the next
// step's grid; no value row is read).
template <typename T>
__device__ __forceinline__ void table_column_fill(const StepView<T>& st, T inv, T* col,
                                                  int stride) {
  const T* s = st.s;
  const Candidates<T> c = candidates(st, inv);
  col[0] = c.inv_cost_npv;
  for (int k = 0; k < c.bb.nd; ++k) {
    T* e = col + static_cast<size_t>(1 + NUM_ENTRY_FIELDS * k) * stride;
    const T dec = c.bb.volume(k);
    const bool inject = dec > T(0);
    const T abs_dec = fabs(dec);
    e[E_DEC * stride] = dec;
    e[E_FUEL * stride] = mul(inject ? s[S_INJ_PCNT] : s[S_WDR_PCNT], abs_dec);
    e[E_COST * stride] = mul(mul(inject ? s[S_INJ_COST] : s[S_WDR_COST], abs_dec), s[S_DF_FLOW]);
    const T x = sub(add(inv, dec), c.loss);
    int idx;
    T w;
    if (st.mode == MODE_GENERAL)
      general_weights(st.grid_next, st.G, x, &idx, &w);
    else
      uniform_weights(st.grid_next, st.G, x, &idx, &w);
    e[E_IDX * stride] = static_cast<T>(idx);
    e[E_W * stride] = w;
  }
}

// The step's cubic curvature factor h^2 / 6 on the next grid, and whether
// the row is degenerate (h = 0: the continuation is linear).
template <typename T>
__device__ __forceinline__ T cubic_factor(const T* grid_next, int G, bool* degenerate) {
  const T h = dvd(sub(grid_next[G - 1], grid_next[0]), static_cast<T>(G - 1));
  *degenerate = !(h > T(0));
  return dvd(mul(h, h), T(6));
}

// Decision k's immediate PV from its grid point's table column against the
// price (candidate()'s pv, bit for bit).
template <typename T>
__device__ __forceinline__ T entry_pv(const T* col, int stride, int k, const T* s, T price) {
  const T* e = col + static_cast<size_t>(1 + NUM_ENTRY_FIELDS * k) * stride;
  const T iw = mul(mul(-e[E_DEC * stride], price), s[S_DF_SETTLE]);
  const T fuel = mul(mul(-e[E_FUEL * stride], price), s[S_DF_SETTLE]);
  return sub(add(sub(iw, e[E_COST * stride]), fuel), col[0]);
}

// Decision k's continuation node (lower index) and weight on the next row.
template <typename T>
__device__ __forceinline__ void entry_node(const T* col, int stride, int k, int* idx, T* w) {
  const T* e = col + static_cast<size_t>(1 + NUM_ENTRY_FIELDS * k) * stride;
  *idx = static_cast<int>(e[E_IDX * stride]);
  *w = e[E_W * stride];
}

// The continuation at weight w between the next row's values v_lo, v_hi at
// a decision's two nodes (and, cubic, their moments m_lo, m_hi):
// continuation()'s arithmetic on them.
template <typename T>
__device__ __forceinline__ T node_continuation(int mode, T w, T v_lo, T v_hi, T m_lo, T m_hi,
                                               T curvature, bool degenerate) {
  if (mode == MODE_GENERAL) return add(mul(v_lo, sub(T(1), w)), mul(v_hi, w));
  if (mode == MODE_UNIFORM) return add(v_lo, mul(sub(v_hi, v_lo), w));
  const T u = sub(T(1), w);
  const T linear = add(mul(v_lo, u), mul(v_hi, w));
  if (degenerate) return linear;
  const T cu = sub(mul(mul(u, u), u), u);
  const T cw = sub(mul(mul(w, w), w), w);
  return add(linear, mul(curvature, add(mul(cu, m_lo), mul(cw, m_hi))));
}

// Decision k's total from its grid point's table column against the price
// on the continuation values v (and cubic moments m) of the next row:
// decide()'s candidate total, bit for bit.
template <typename T>
__device__ __forceinline__ T entry_total(const T* col, int stride, int k, const T* s, int mode,
                                         T price, const T* v, const T* m, T curvature,
                                         bool degenerate) {
  int idx;
  T w;
  entry_node(col, stride, k, &idx, &w);
  const bool moments = mode == MODE_CUBIC && !degenerate;
  return add(entry_pv(col, stride, k, s, price),
             node_continuation(mode, w, v[idx], v[idx + 1], moments ? m[idx] : T(0),
                               moments ? m[idx + 1] : T(0), curvature, degenerate));
}

// One element (4 or 8 bytes) from device to shared memory by cp.async, in
// the calling thread's open group; cp_async_wait_all() then waits for all of
// the thread's copies, and a barrier after it publishes them to the block.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "cp.async copies 4 or 8 bytes here");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// n elements from src to dst in shared memory, strided over the block.
template <typename T>
__device__ __forceinline__ void stage_copy(T* dst, const T* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async(dst + i, src + i);
}

// The natural-cubic spline's spacing h on a uniform row (0 where degenerate).
template <typename T>
__device__ __forceinline__ T spline_h(const T* grid, int G) {
  return dvd(sub(grid[G - 1], grid[0]), static_cast<T>(G - 1));
}

// An entry of the moments' right-hand side from a row's values v0, v1, v2 at
// three neighbouring grid points, at spacing h.
template <typename T>
__device__ __forceinline__ T moments_rhs(T v0, T v1, T v2, T h) {
  const T safe_h = h > T(0) ? h : T(1);
  return dvd(mul(T(6), add(sub(v2, mul(T(2), v1)), v0)), mul(safe_h, safe_h));
}

// Interior moment i + 1 (i < n = G-2): row i of the dense inverse times the
// rhs, summed in ascending j; 0 on a degenerate row.
template <typename T>
__device__ __forceinline__ T moment_at(const T* solver, const T* rhs, int i, int n, T h) {
  T acc = T(0);
  if (h > T(0)) {
    const T* row = solver + static_cast<size_t>(i) * n;
    for (int j = 0; j < n; ++j) acc = add(acc, mul(row[j], rhs[j]));
  }
  return acc;
}

// Natural-cubic moments m [G] of the row v [G] on a uniform grid: rhs [G-2]
// into scratch, then the matvec with the dense inverse, rows strided over the
// block, summed in ascending j.  Ends with a barrier.
template <typename T>
__device__ void block_moments(const T* grid, const T* v, const T* solver, T* rhs, T* m, int G) {
  const int n = G - 2;
  const T h = spline_h(grid, G);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    rhs[i] = moments_rhs(v[i], v[i + 1], v[i + 2], h);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) m[i + 1] = moment_at(solver, rhs, i, n, h);
  if (threadIdx.x == 0) {
    m[0] = T(0);
    m[G - 1] = T(0);
  }
  __syncthreads();
}

}  // namespace stt_dp
