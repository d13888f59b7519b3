// The intrinsic DP (the deterministic storage valuation on the forward curve)
// as one launch of one block.
//
// No TPU kernel stands behind it: it replaces the lax.scan pair of
// storage_tpu/engines/intrinsic.py:_intrinsic_core (backward over t = N-1..1,
// then the forward walk of the inventory), which the port would otherwise
// run as tensor code at ~7 launches a backward step and ~60 a forward step.
// Here the whole DP is one launch: threads stride over the G grid points of
// a backward step, a block barrier between steps, and then one thread walks
// the forward from the starting inventory.
//
// Per grid point (backward) or for the path's inventory (forward), one
// device function, decide(), mirrors decision_values of the JAX package and
// of engines/intrinsic.py: ratchet rates at the inventory (the interior nodes
// 1..R-2 counted, as grid.ratchet_rates: not kernel C's loop over 1..R-1),
// the bang-bang set of D = 2E + 3 volumes, each one's immediate PV and fuel,
// the loss, the inventory after the decision, the continuation interpolated
// on the next step's grid, and the first maximum over d (strict > in
// ascending d, as jnp.argmax takes it).  Every product and sum is rounded on
// its own (no contraction to FMA), so the arithmetic is the plain version's
// (engines/intrinsic.py intrinsic_plain) operation by operation.
//
// The continuation comes in three modes, all here:
//   0 uniform linear: the arithmetic position on a linspace row;
//   1 general linear: the lower node is the count of interior nodes <= x (a
//     binary search), so a zero-span segment of a fixed-spacing or custom
//     row's padding takes its left node's value;
//   2 natural cubic: each step's moments M = solver @ rhs, a block matvec
//     over the dense [G-2, G-2] inverse (as the JAX package does), kept in
//     a [N+1, G] buffer beside the values, so that the forward reads them.
//     A degenerate row (h = 0) has zero moments and zero curvature.
//
// The values vs [N+1, G] live in device memory and are read through L1:
// any G works, with no shared memory at all.
//
// Bound on the H100: neither bytes (the tables, ~150 KB at N = 365, G = 100)
// nor operations (~4·10^6 at the headline) but latency: the DP is a chain of
// N - 1 dependent backward steps, each ended by a barrier, and N dependent
// forward steps on one thread.  The design keeps that chain in one launch,
// so no launch gap lies between its steps.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T>
struct Problem {
  int N, G, R, E, is_step, mode;
  const T* steps;    // [N, NUM_STEP_SCALARS]
  const T* r_inv;    // [N, R]
  const T* r_min;    // [N, R]
  const T* r_max;    // [N, R]
  const T* grids;    // [N + 1, G]
  const T* v_end;    // [G] terminal values on grids[N]
  const T* solver;   // [G - 2, G - 2] (cubic) or null
  T inv0;            // starting inventory
  T* vs;             // [N + 1, G] values
  T* moments;        // [N + 1, G] (cubic) or null
  T* rhs;            // [G] scratch (cubic) or null
  T* out;            // [5 * N + 1]: inventory, volume, fuel, loss, PV rows; final inventory
};

template <typename T>
struct Choice {
  T total, decision, consumed, pv;
};

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

// The continuation at inventory x on the next step's row.
template <typename T>
__device__ __forceinline__ T continuation(const T* grid, const T* v, const T* m, int G,
                                          int mode, T x) {
  if (mode == MODE_GENERAL) {
    // ops/interp.py interp_vector_general: idx = #{r in 1..G-2 : grid[r] <= x}.
    const T xc = clamp_to(x, grid[0], grid[G - 1]);
    int lo = 1, hi = G - 1;  // first r in [1, G-1) with grid[r] > xc
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (grid[mid] <= xc) lo = mid + 1; else hi = mid;
    }
    const int idx = lo - 1;
    const T x0 = grid[idx], x1 = grid[idx + 1];
    const T span = sub(x1, x0);
    const T w = span > T(0) ? dvd(sub(xc, x0), span) : T(0);
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

// decision_values of engines/intrinsic.py at one inventory of step t.
template <typename T>
__device__ Choice<T> decide(const Problem<T>& p, int t, T inv) {
  const T* s = p.steps + static_cast<size_t>(t) * NUM_STEP_SCALARS;
  const T* r_inv = p.r_inv + static_cast<size_t>(t) * p.R;
  const T* r_min = p.r_min + static_cast<size_t>(t) * p.R;
  const T* r_max = p.r_max + static_cast<size_t>(t) * p.R;
  const size_t next = static_cast<size_t>(t + 1) * p.G;

  // Ratchet rates (grid.ratchet_rates: the interior nodes 1..R-2 counted).
  const T inv_c = clamp_to(inv, r_inv[0], r_inv[p.R - 1]);
  int idx = 0;
  for (int r = 1; r < p.R - 1; ++r) idx += inv_c >= r_inv[r];
  T min_rate, max_rate;
  if (p.is_step) {
    min_rate = r_min[idx];
    max_rate = r_max[idx];
  } else {
    const int hi = idx + 1 < p.R ? idx + 1 : p.R - 1;
    const T x0 = r_inv[idx], x1 = r_inv[hi];
    const T w = x1 > x0 ? dvd(sub(inv_c, x0), sub(x1, x0)) : T(0);
    const T omw = sub(T(1), w);
    min_rate = add(mul(r_min[idx], omw), mul(r_min[hi], w));
    max_rate = add(mul(r_max[idx], omw), mul(r_max[hi], w));
  }

  // Bang-bang decision set (grid.bang_bang_decisions).
  const T loss = mul(s[S_LOSS_PCNT], inv);
  const T after_loss = sub(inv, loss);
  const T next_min = s[S_NEXT_MIN], next_max = s[S_NEXT_MAX];
  const T w_target = add(min_rate, after_loss);
  const T yw = w_target > next_max ? sub(next_max, after_loss)
                                   : (w_target > next_min ? min_rate : sub(next_min, after_loss));
  const T i_target = add(max_rate, after_loss);
  const T yi = i_target < next_min ? sub(next_min, after_loss)
                                   : (i_target < next_max ? max_rate : sub(next_max, after_loss));
  const bool has_zero = yw < T(0) && yi > T(0);
  const int nd = 2 * p.E + 3;
  const int mid = p.E + 1;

  const T price = s[S_FWD], df_settle = s[S_DF_SETTLE], df_flow = s[S_DF_FLOW];
  const T inv_cost_npv = mul(mul(s[S_INV_COST], inv), df_flow);
  const T* grid_next = p.grids + next;
  const T* v_next = p.vs + next;
  const T* m_next = p.moments ? p.moments + next : nullptr;

  Choice<T> best{T(0), T(0), T(0), T(0)};
  for (int k = 0; k < nd; ++k) {
    T dec;
    if (has_zero) {
      dec = k <= mid ? mul(yw, sub(T(1), dvd(static_cast<T>(k), static_cast<T>(mid))))
                     : mul(yi, dvd(static_cast<T>(k - mid), static_cast<T>(mid)));
    } else {
      const T frac = dvd(static_cast<T>(k > 1 ? k - 1 : 0), static_cast<T>(nd - 2));
      dec = add(yw, mul(sub(yi, yw), frac));
    }
    // immediate_pv: ((iw - cost) + fuel) - inventory cost.
    const bool inject = dec > T(0);
    const T abs_dec = fabs(dec);
    const T consumed = mul(inject ? s[S_INJ_PCNT] : s[S_WDR_PCNT], abs_dec);
    const T iw = mul(mul(-dec, price), df_settle);
    const T cost = mul(mul(inject ? s[S_INJ_COST] : s[S_WDR_COST], abs_dec), df_flow);
    const T fuel = mul(mul(-consumed, price), df_settle);
    const T pv = sub(add(sub(iw, cost), fuel), inv_cost_npv);
    const T inv_after = sub(add(inv, dec), loss);
    const T total = add(pv, continuation(grid_next, v_next, m_next, p.G, p.mode, inv_after));
    if (k == 0 || total > best.total) best = Choice<T>{total, dec, consumed, pv};
  }
  return best;
}

// Moments of row t (values vs[t] on grids[t]): rhs into scratch, then the
// matvec with the dense inverse, rows strided over the block.  Ends with a
// barrier.
template <typename T>
__device__ void moments_row(const Problem<T>& p, int t) {
  const int G = p.G, n = G - 2;
  const T* grid = p.grids + static_cast<size_t>(t) * G;
  const T* v = p.vs + static_cast<size_t>(t) * G;
  T* m = p.moments + static_cast<size_t>(t) * G;
  const T h = dvd(sub(grid[G - 1], grid[0]), static_cast<T>(G - 1));
  const T safe_h = h > T(0) ? h : T(1);
  const T hh = mul(safe_h, safe_h);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    p.rhs[i] = dvd(mul(T(6), add(sub(v[i + 2], mul(T(2), v[i + 1])), v[i])), hh);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    T acc = T(0);
    if (h > T(0)) {
      const T* row = p.solver + static_cast<size_t>(i) * n;
      for (int j = 0; j < n; ++j) acc = add(acc, mul(row[j], p.rhs[j]));
    }
    m[i + 1] = acc;
  }
  if (threadIdx.x == 0) {
    m[0] = T(0);
    m[G - 1] = T(0);
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) intrinsic_dp_kernel(Problem<T> p) {
  const int N = p.N, G = p.G;
  const bool cubic = p.mode == MODE_CUBIC;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    p.vs[static_cast<size_t>(N) * G + g] = p.v_end[g];
    p.vs[g] = T(0);  // grid[0] is the known inventory: valued by the forward walk
  }
  __syncthreads();
  if (cubic) moments_row(p, N);
  // Backward over t = N-1 .. 1.
  for (int t = N - 1; t >= 1; --t) {
    const T* grid = p.grids + static_cast<size_t>(t) * G;
    T* v = p.vs + static_cast<size_t>(t) * G;
    for (int g = threadIdx.x; g < G; g += blockDim.x) v[g] = decide(p, t, grid[g]).total;
    __syncthreads();
    if (cubic) moments_row(p, t);
  }
  // Forward walk of the inventory.
  if (threadIdx.x == 0) {
    T inv = p.inv0;
    for (int t = 0; t < N; ++t) {
      const Choice<T> c = decide(p, t, inv);
      const T loss = mul(p.steps[static_cast<size_t>(t) * NUM_STEP_SCALARS + S_LOSS_PCNT], inv);
      inv = sub(add(inv, c.decision), loss);
      p.out[t] = inv;
      p.out[N + t] = c.decision;
      p.out[2 * N + t] = c.consumed;
      p.out[3 * N + t] = loss;
      p.out[4 * N + t] = c.pv;
    }
    p.out[5 * N] = inv;
  }
}

template <typename T>
int launch(int N, int G, int R, int E, int is_step, int mode, const T* steps, const T* r_inv,
           const T* r_min, const T* r_max, const T* grids, const T* v_end, const T* solver,
           double inv0, T* vs, T* moments, T* rhs, T* out, void* stream) {
  if (N < 1 || G < 2 || R < 1 || E < 0 || mode < MODE_UNIFORM || mode > MODE_CUBIC ||
      (mode == MODE_CUBIC && ((G > 2 && !solver) || !moments || !rhs)))
    return static_cast<int>(cudaErrorInvalidValue);
  Problem<T> p{N, G, R, E, is_step, mode, steps, r_inv, r_min, r_max, grids, v_end,
               mode == MODE_CUBIC ? solver : nullptr, static_cast<T>(inv0), vs,
               mode == MODE_CUBIC ? moments : nullptr, rhs, out};
  intrinsic_dp_kernel<T><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// N steps, G grid points, R ratchet nodes, E extra decisions, is_step, mode
// (0 uniform, 1 general, 2 cubic), steps [N, 11], ratchet inventories, min
// and max rates [N, R], grids [N+1, G], v_end [G], solver [G-2, G-2] (cubic,
// else NULL), the starting inventory, vs [N+1, G], moments [N+1, G] and rhs
// [G] (cubic, else NULL), out [5N+1], stream.
extern "C" int stt_intrinsic_dp_f32(int N, int G, int R, int E, int is_step, int mode,
                                    const float* steps, const float* r_inv, const float* r_min,
                                    const float* r_max, const float* grids, const float* v_end,
                                    const float* solver, double inv0, float* vs, float* moments,
                                    float* rhs, float* out, void* stream) {
  return launch<float>(N, G, R, E, is_step, mode, steps, r_inv, r_min, r_max, grids, v_end,
                       solver, inv0, vs, moments, rhs, out, stream);
}

extern "C" int stt_intrinsic_dp_f64(int N, int G, int R, int E, int is_step, int mode,
                                    const double* steps, const double* r_inv, const double* r_min,
                                    const double* r_max, const double* grids, const double* v_end,
                                    const double* solver, double inv0, double* vs, double* moments,
                                    double* rhs, double* out, void* stream) {
  return launch<double>(N, G, R, E, is_step, mode, steps, r_inv, r_min, r_max, grids, v_end,
                        solver, inv0, vs, moments, rhs, out, stream);
}

// Launch report of the DP kernel in f32 (is_double 0) or f64 (1) into out[5]:
// threads per block, registers per thread, local memory bytes per thread
// (spills), static shared memory bytes, blocks per SM at that block size.
template <typename Kernel>
static int dp_info(Kernel kernel, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = kThreads;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  out[4] = blocks;
  return 0;
}

extern "C" int stt_intrinsic_dp_info(int is_double, int* out) {
  return is_double ? dp_info(intrinsic_dp_kernel<double>, out)
                   : dp_info(intrinsic_dp_kernel<float>, out);
}
