// The trinomial tree's backward induction on the inventory grid: one launch
// a valuation of one thread-block cluster (the cluster route), or, for a
// slab too large for the cluster's shared memory, one launch a step with one
// block a node row (the large-slab route), or, for rows too long for a
// block's shared memory, two launches a step (three in cubic mode) on rows
// in device memory, deciding from step tables (the large route).
//
// No TPU kernel stands behind it: it replaces the lax.scan of
// storage_tpu/engines/tree.py:_tree_core, whose step is a dense
// [M, M] x [M, G] dot (tree.py:125) and then the decisions of every node and
// grid point (tree.py:130-165).  At step t, node row m
//   1. forms its row of the expected continuation,
//      ev[g] = sum_k T_t[m, k] * V_{t+1}[k, g], reading only the row's band:
//      the W <= 2 * num_substeps + 1 rows of V_{t+1} from start[m] that hold
//      its non-zeros (ops/tree_kernel.py band), summed in ascending k (the
//      dense product's other terms are exact zeros, so they change no
//      rounding);
//   2. in cubic mode, forms the row's spline moments (dp_common.cuh
//      block_moments, the dense [G-2, G-2] inverse);
//   3. writes V_t[m, g] = max over the D = 2E + 3 decisions of immediate PV
//      against the node's spot plus the interpolated continuation at every
//      grid point g (dp_common.cuh decide()'s arithmetic, every operation
//      rounded on its own).
// Every route does this arithmetic, so they give the same bits.  The values
// [N+1, M, G] go to device memory for the caller; the transition never
// reaches the card as [N, M, M].  Each kernel is compiled once for each
// continuation mode.
//
// Bound on the H100: at the headline tree (N = 365, M = 99, G = 100, W = 9)
// the work is ~5·10^8 unfused operations and ~15 MB of values (0.015 ms),
// but the N steps are a chain: step t reads V_{t+1}.  Latency, not work: a
// decide() is ~1 us on one thread (tools/torch_dp_probe.py --stamps), and
// what passes V_{t+1} from CTA to CTA is another.
//
// The cluster route (tree_cluster_kernel): one launch of one cluster of C
// CTAs (16 where the card co-schedules them, else the portable 8).
//   - First the cluster fills the decision tables of every step
//     (dp_common.cuh table_column_fill: at each grid point and decision, the
//     ratchet rates, volume, fuel, costs and the continuation's node and
//     weight), which depend on the step and the grid point but not on the
//     node's spot or V_{t+1}: [N, G, D] entries in device memory, work
//     without a chain, spread over the cluster.  What stays on the chain is
//     a few operations a cell and decision (entry_total: the PV at the
//     node's spot, the continuation's lerp on ev), and the first best.
//   - CTA k owns node rows [k·rows, (k+1)·rows) and keeps them in shared
//     memory twice, V_{t+1} and V_t: a step reads the band's rows that other
//     CTAs own through distributed shared memory (map_shared_rank), writes
//     its own rows locally and streams them to the output with plain stores.
//     One cluster barrier (release/acquire) ends each step: with the double
//     buffer no CTA writes a row another may still read.
//   - The next step's scalars, the own rows' spot, band and band start and
//     its decision table come by cp.async into a second stage while the
//     step computes.  No launch gap lies between steps.
//
// The large-slab route (tree_step_kernel), where a CTA's rows, their ev and a
// step's table do not fit its shared memory: one launch a step of M blocks
// of 256 threads, block m forming its row's ev in shared memory and deciding
// its grid points with decide(), the step's hand-over in device memory and
// L2.
//
// The large route, where not even a row's ev (and in cubic mode its moments
// and rhs) fits a block's shared memory: every row in device memory, and the
// step's decisions from a table that all node rows share.
//   - tree_table_kernel fills the decision tables of a chunk of steps (as
//     many as the wrapper's table scratch holds: all 16 of T1 at G = 65,536),
//     a thread a (step, grid point) column, work without a chain: what a
//     whole decide() a cell would do M times over a step (the ratchet rates,
//     the bang-bang set, each decision's fuel, costs and continuation node
//     and weight, a binary search on general rows) is done once a column.
//   - each step then tree_ev_kernel forms ev [M, G] into a scratch, the
//     band's W rows of V_{t+1} summed in ascending w as the other routes
//     sum them (in cubic mode also block_moments' rhs, and
//     tree_moments_kernel the moments: the dense inverse times the rhs, a
//     thread a moment, summed in ascending j as block_moments does), and
//     tree_table_decide_kernel decides, a thread a grid point for 4 node
//     rows (each decision's table entry read once for all four, the rows'
//     ev gathers issued together): for each decision the PV at the node's
//     spot and the continuation on ev at its two nodes, then the first
//     best: two launches a step, three in cubic mode; tree_ev_kernel takes
//     8 node rows a block, whose bands overlap in L1.  (Summing ev at a
//     decision's two nodes inside the decide, with no ev launch, ran 2.1x
//     slower at T1, G = 65,536: 2D·W band terms a cell in place of W, W = 9
//     there; tools/torch_dp_probe.py --large-variants.)
// The same arithmetic in the same order: the same bits as the other routes.
#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <initializer_list>

#include "dp_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace stt_dp;

constexpr int kStepThreads = 256;
constexpr int kDecideRows = 4;  // node rows a large-route decide block takes at its grid points
constexpr int kEvRows = 8;      // node rows a large-route ev block takes at its grid points
constexpr int kClusterThreads = 1024;
constexpr int kMaxCluster = 16;
constexpr int kPortableCluster = 8;
constexpr int kScalarSlots = 12;  // NUM_STEP_SCALARS, padded

template <typename T>
struct TreeDP {
  int N, M, G, W, R, E, is_step, mode;
  int rows;                   // node rows a CTA owns (cluster route)
  const T* steps;             // [N, NUM_STEP_SCALARS]
  const T* r_inv;             // [N, R] ratchet nodes
  const T* r_min;
  const T* r_max;
  const T* grids;             // [N + 1, G]
  const T* spot;              // [N + 1, M]
  const T* band;              // [N, M, W]
  const int64_t* start;       // [N, M]: each band's first column
  const T* solver;            // [G - 2, G - 2] (cubic) or null
  T* values;                  // [N + 1, M, G]; values[N] given
  T* table;                   // [N, table_row(D), G] decision tables (cluster route)
};

// Grid point g's column of step t's decision table (dp_common.cuh
// table_column_fill; no value row enters it) at `table`, a [table_row(D), G]
// table value-major.
template <int kMode, typename T>
__device__ void fill_column(const TreeDP<T>& p, int t, int g, T* table) {
  const size_t row = static_cast<size_t>(t) * p.R;
  const StepView<T> st{p.steps + static_cast<size_t>(t) * NUM_STEP_SCALARS, p.r_inv + row,
                       p.r_min + row, p.r_max + row, p.R, p.is_step, p.E, p.G, kMode,
                       p.grids + static_cast<size_t>(t + 1) * p.G, nullptr, nullptr};
  table_column_fill(st, p.grids[static_cast<size_t>(t) * p.G + g], table + g, p.G);
}

// ---- the large-slab route: one launch a step, one block a node row.

// Shared memory: ev [G], and in cubic mode its moments [G] and the rhs [G-2].
template <typename T>
size_t step_smem_bytes(int G, int mode) {
  return sizeof(T) * static_cast<size_t>(mode == MODE_CUBIC ? 3 * G - 2 : G);
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kStepThreads) tree_step_kernel(TreeDP<T> p, int t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ev = reinterpret_cast<T*>(smem_raw);
  constexpr bool cubic = kMode == MODE_CUBIC;
  T* moments = cubic ? ev + p.G : nullptr;
  const int G = p.G, M = p.M, m = blockIdx.x;
  const size_t mg = static_cast<size_t>(M) * G;
  const T* grid_next = p.grids + static_cast<size_t>(t + 1) * G;

  const T* band = p.band + (static_cast<size_t>(t) * M + m) * p.W;
  const int64_t first = p.start[static_cast<size_t>(t) * M + m];
  const T* rows = p.values + (t + 1) * mg + static_cast<size_t>(first) * G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    T acc = T(0);
    for (int w = 0; w < p.W; ++w)
      acc = add(acc, mul(band[w], rows[static_cast<size_t>(w) * G + g]));
    ev[g] = acc;
  }
  __syncthreads();
  if (cubic) block_moments(grid_next, ev, p.solver, ev + 2 * G, moments, G);

  const size_t row = static_cast<size_t>(t) * p.R;
  const StepView<T> st{p.steps + static_cast<size_t>(t) * NUM_STEP_SCALARS,
                       p.r_inv + row, p.r_min + row, p.r_max + row, p.R, p.is_step, p.E, G, kMode,
                       grid_next, ev, moments};
  const T price = p.spot[static_cast<size_t>(t) * M + m];
  const T* grid = p.grids + static_cast<size_t>(t) * G;
  T* out = p.values + t * mg + static_cast<size_t>(m) * G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) out[g] = decide(st, price, grid[g]).total;
}

// ---- the large route: a step's ev, rhs and moments in device memory.

// ev[m, g] of step t into ev [M, G] for node rows [blockIdx.y·kEvRows,
// +kEvRows), the band summed in ascending w (neighbouring rows' bands
// overlap, so a row's loads mostly hit the lines the row before brought
// into L1); in cubic mode (rhs not null) also block_moments' rhs[m, g] for
// g < G-2, from ev at g, g+1 and g+2, each formed by the same sum.
template <typename T>
__global__ void __launch_bounds__(kStepThreads) tree_ev_kernel(TreeDP<T> p, int t, T* ev, T* rhs) {
  const int G = p.G, M = p.M;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const size_t mg = static_cast<size_t>(M) * G;
  const int m1 = min(M, static_cast<int>(blockIdx.y + 1) * kEvRows);
  for (int m = blockIdx.y * kEvRows; m < m1; ++m) {
    const T* band = p.band + (static_cast<size_t>(t) * M + m) * p.W;
    const int64_t first = p.start[static_cast<size_t>(t) * M + m];
    const T* rows = p.values + (t + 1) * mg + static_cast<size_t>(first) * G;
    const auto ev_at = [&](int x) {
      T acc = T(0);
      for (int w = 0; w < p.W; ++w)
        acc = add(acc, mul(band[w], rows[static_cast<size_t>(w) * G + x]));
      return acc;
    };
    const T e0 = ev_at(g);
    ev[static_cast<size_t>(m) * G + g] = e0;
    if (rhs && g < G - 2)
      rhs[static_cast<size_t>(m) * (G - 2) + g] = moments_rhs(
          e0, ev_at(g + 1), ev_at(g + 2), spline_h(p.grids + static_cast<size_t>(t + 1) * G, G));
  }
}

// The moments [M, G] of step t's ev rows: block_moments' matvec, a thread an
// interior moment i of row m, summed in ascending j; zero ends, and zero
// moments on a degenerate row.
template <typename T>
__global__ void __launch_bounds__(kStepThreads)
    tree_moments_kernel(TreeDP<T> p, int t, const T* rhs, T* mom) {
  const int G = p.G, n = G - 2, m = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  T* out = mom + static_cast<size_t>(m) * G;
  if (i < n)
    out[i + 1] = moment_at(p.solver, rhs + static_cast<size_t>(m) * n, i, n,
                           spline_h(p.grids + static_cast<size_t>(t + 1) * G, G));
  if (i == 0) {
    out[0] = T(0);
    out[G - 1] = T(0);
  }
}

// The decision tables of steps [t0, t1) into table [t1 - t0, table_row(D), G],
// a thread a (step, grid point) column: work without a chain.
template <typename T, int kMode>
__global__ void __launch_bounds__(kStepThreads)
    tree_table_kernel(TreeDP<T> p, int t0, int t1, T* table) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t g_ = static_cast<size_t>(p.G);
  if (i >= static_cast<size_t>(t1 - t0) * g_) return;
  const int dt = static_cast<int>(i / g_), g = static_cast<int>(i - dt * g_);
  fill_column<kMode>(p, t0 + dt, g, table + dt * g_ * table_row(2 * p.E + 3));
}

// values[t][m, g] for node rows [blockIdx.y·kDecideRows, +kDecideRows) at
// grid point g, from step t's table and the step's ev (and cubic moments)
// [M, G]: each decision's PV at each row's spot, its continuation on the
// row's ev at the decision's two nodes, each row's first best in ascending
// k (the cluster route's entry_total arithmetic, so decide()'s bits).  A
// decision's table entry is the same for every row, so it is read once and
// the rows' ev gathers go out together (the rows unrolled), not one row's
// decisions after another's.
template <typename T, int kMode>
__global__ void __launch_bounds__(kStepThreads)
    tree_table_decide_kernel(TreeDP<T> p, int t, const T* table, const T* ev, const T* mom) {
  const int G = p.G, M = p.M, D = 2 * p.E + 3;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const size_t mg = static_cast<size_t>(M) * G;
  const T* s = p.steps + static_cast<size_t>(t) * NUM_STEP_SCALARS;
  const T* col = table + g;
  bool degenerate = false;
  T curvature = T(0);
  if (kMode == MODE_CUBIC)
    curvature = cubic_factor(p.grids + static_cast<size_t>(t + 1) * G, G, &degenerate);
  const bool moments = kMode == MODE_CUBIC && !degenerate;
  const int m0 = blockIdx.y * kDecideRows, rows = min(kDecideRows, M - m0);
  T price[kDecideRows];
  FirstBest<T> best[kDecideRows];
#pragma unroll
  for (int r = 0; r < kDecideRows; ++r) {
    price[r] = r < rows ? p.spot[static_cast<size_t>(t) * M + m0 + r] : T(0);
    best[r] = FirstBest<T>{T(0), -1, false};
  }
  for (int k = 0; k < D; ++k) {
    int idx;
    T w;
    entry_node(col, G, k, &idx, &w);
#pragma unroll
    for (int r = 0; r < kDecideRows; ++r) {
      if (r >= rows) break;
      const size_t at = static_cast<size_t>(m0 + r) * G + idx;
      const T cont = node_continuation(kMode, w, ev[at], ev[at + 1], moments ? mom[at] : T(0),
                                       moments ? mom[at + 1] : T(0), curvature, degenerate);
      best[r].offer(add(entry_pv(col, G, k, s, price[r]), cont), k);
    }
  }
#pragma unroll
  for (int r = 0; r < kDecideRows; ++r)
    if (r < rows) p.values[static_cast<size_t>(t) * mg + static_cast<size_t>(m0 + r) * G + g] =
        best[r].total;
}

// ---- the cluster route: one launch a valuation.

// A CTA's shared memory: the address of every node row of V_{t+1} and V_t
// in the cluster ([2][M] pointers), the staged band starts (int64, two
// stages), then in elements of T V_{t+1} and V_t, ev, the cubic moments and
// rhs, and two stages of a step's scalars, the own rows' spot and band, and
// the step's decision table.
struct ClusterLayout {
  int stage_len;                          // T elements of one stage
  int s_spot, s_band, s_table;            // offsets in a stage
  size_t v, ev, mom, rhs, stage, bytes;   // T offsets after the starts; bytes in all
};

// Threads a CTA: its rows' cells rounded up to a warp, at most 1,024.
inline int cluster_threads(int rows, int G) {
  return std::min(kClusterThreads, (rows * G + 31) / 32 * 32);
}

template <typename T>
__host__ __device__ ClusterLayout cluster_layout(int M, int rows, int G, int W, int E, int mode) {
  ClusterLayout l;
  l.s_spot = kScalarSlots;
  l.s_band = l.s_spot + rows;
  l.s_table = l.s_band + rows * W;
  l.stage_len = l.s_table + G * table_row(2 * E + 3);
  l.stage_len += l.stage_len & 1;  // each stage 8-byte aligned in f32
  const size_t cells = static_cast<size_t>(rows) * G;
  l.v = 0;
  l.ev = 2 * cells;
  l.mom = 3 * cells;
  l.rhs = l.mom + (mode == MODE_CUBIC ? cells : 0);
  l.stage = l.rhs + (mode == MODE_CUBIC ? static_cast<size_t>(G) : 0);
  l.bytes = 2 * sizeof(T*) * static_cast<size_t>(M) +
            2 * sizeof(int64_t) * static_cast<size_t>(rows) +
            sizeof(T) * (l.stage + 2 * static_cast<size_t>(l.stage_len));
  return l;
}

// Step t's scalars, the spot, band and band start of the CTA's rows
// [r0, r0 + my) and the step's decision table into a stage by cp.async (the
// calling threads' open groups).
template <typename T>
__device__ void stage_step(const TreeDP<T>& p, const ClusterLayout& l, int t, int r0, int my,
                           int table_len, T* stage, int64_t* start) {
  stage_copy(stage, p.steps + static_cast<size_t>(t) * NUM_STEP_SCALARS, NUM_STEP_SCALARS);
  stage_copy(stage + l.s_spot, p.spot + static_cast<size_t>(t) * p.M + r0, my);
  stage_copy(stage + l.s_band, p.band + (static_cast<size_t>(t) * p.M + r0) * p.W, my * p.W);
  stage_copy(stage + l.s_table, p.table + static_cast<size_t>(t) * table_len, table_len);
  stage_copy(start, p.start + static_cast<size_t>(t) * p.M + r0, my);
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kClusterThreads, 1) tree_cluster_kernel(TreeDP<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = p.G, M = p.M, W = p.W, rows = p.rows, D = 2 * p.E + 3;
  const int table_len = G * table_row(D);
  const ClusterLayout l = cluster_layout<T>(M, rows, G, W, p.E, kMode);
  const T** row_at = reinterpret_cast<const T**>(smem_raw);      // [2][M]
  int64_t* starts = reinterpret_cast<int64_t*>(row_at + 2 * M);  // [2][rows]
  T* base = reinterpret_cast<T*>(starts + 2 * rows);
  T* vbuf = base + l.v;  // [2][rows * G]: V_{t+1} and V_t by the parity of t
  T* ev = base + l.ev;
  constexpr bool cubic = kMode == MODE_CUBIC;
  T* mom = cubic ? base + l.mom : nullptr;
  T* stages = base + l.stage;

  const int rank = static_cast<int>(cluster.block_rank());
  const int r0 = rank * rows;
  const int my = max(0, min(rows, M - r0));
  const int cells = my * G;
  const size_t mg = static_cast<size_t>(M) * G;

  // The decision tables of every step, each (t, g) by one thread of the
  // cluster: no value row enters them.
  for (int tg = rank * blockDim.x + threadIdx.x; tg < p.N * G;
       tg += static_cast<int>(cluster.num_blocks()) * blockDim.x) {
    const int t = tg / G, g = tg - t * G;
    fill_column<kMode>(p, t, g, p.table + static_cast<size_t>(t) * table_len);
  }
  // Where each node row of either value buffer lies in the cluster: row k is
  // row k - owner·rows of CTA owner.
  for (int k = threadIdx.x; k < M; k += blockDim.x) {
    const int owner = k / rows, local = k - owner * rows;
    for (int b = 0; b < 2; ++b)
      row_at[b * M + k] =
          cluster.map_shared_rank(vbuf + b * static_cast<size_t>(rows) * G, owner) + local * G;
  }
  // V_N of the own rows.
  const T* v_end = p.values + static_cast<size_t>(p.N) * mg + static_cast<size_t>(r0) * G;
  T* v_n = vbuf + (p.N & 1) * static_cast<size_t>(rows) * G;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) v_n[i] = v_end[i];
  // The tables, written across the cluster, are read after this barrier.
  cluster.sync();
  stage_step(p, l, p.N - 1, r0, my, table_len, stages + ((p.N - 1) & 1) * l.stage_len,
             starts + ((p.N - 1) & 1) * rows);
  cp_async_wait_all();
  __syncthreads();

  for (int t = p.N - 1; t >= 0; --t) {
    const int cur = t & 1, nxt = cur ^ 1;
    const T* s = stages + cur * l.stage_len;
    const int64_t* start = starts + cur * rows;
    if (t > 0)
      stage_step(p, l, t - 1, r0, my, table_len, stages + nxt * l.stage_len, starts + nxt * rows);
    // ev of the own rows from the band's rows of V_{t+1}, wherever they lie.
    const T* const* next_rows = row_at + nxt * M;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      const int r = i / G, g = i - r * G;
      const T* const* band_rows = next_rows + start[r];
      const T* band = s + l.s_band + r * W;
      T acc = T(0);
      for (int w0 = 0; w0 < W; w0 += 8) {
        T x[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) x[j] = w0 + j < W ? band_rows[w0 + j][g] : T(0);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (w0 + j < W) acc = add(acc, mul(band[w0 + j], x[j]));
      }
      ev[i] = acc;
    }
    __syncthreads();
    const T* grid_next = p.grids + static_cast<size_t>(t + 1) * G;
    bool degenerate = false;
    T curvature = T(0);
    if (cubic) {
      for (int r = 0; r < my; ++r)
        block_moments(grid_next, ev + r * G, p.solver, base + l.rhs, mom + r * G, G);
      curvature = cubic_factor(grid_next, G, &degenerate);
    }
    // V_t of the own cells: each decision's total from its table entry, the
    // first best; into shared memory and the output.
    T* v_cur = vbuf + cur * static_cast<size_t>(rows) * G;
    T* out = p.values + static_cast<size_t>(t) * mg + static_cast<size_t>(r0) * G;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      const int r = i / G, g = i - r * G;
      const T price = s[l.s_spot + r];
      FirstBest<T> best{T(0), -1, false};
      for (int k = 0; k < D; ++k)
        best.offer(entry_total(s + l.s_table + g, G, k, s, kMode, price, ev + r * G,
                               cubic ? mom + r * G : nullptr, curvature, degenerate),
                   k);
      v_cur[i] = best.total;
      out[i] = best.total;
    }
    cp_async_wait_all();
    // Publishes V_t and the next stage to the cluster; after it no CTA still
    // reads V_{t+1}, which the next step overwrites (and no CTA exits while
    // another may read its rows).
    cluster.sync();
  }
}

// Each route's kernel compiled for a continuation mode: the kernel's code
// then holds that mode's continuation alone.
template <typename T>
auto step_kernel(int mode) {
  return mode == MODE_GENERAL ? tree_step_kernel<T, MODE_GENERAL>
         : mode == MODE_CUBIC ? tree_step_kernel<T, MODE_CUBIC>
                              : tree_step_kernel<T, MODE_UNIFORM>;
}

template <typename T>
auto decide_kernel(int mode) {
  return mode == MODE_GENERAL ? tree_table_decide_kernel<T, MODE_GENERAL>
         : mode == MODE_CUBIC ? tree_table_decide_kernel<T, MODE_CUBIC>
                              : tree_table_decide_kernel<T, MODE_UNIFORM>;
}

template <typename T>
auto table_kernel(int mode) {
  return mode == MODE_GENERAL ? tree_table_kernel<T, MODE_GENERAL>
         : mode == MODE_CUBIC ? tree_table_kernel<T, MODE_CUBIC>
                              : tree_table_kernel<T, MODE_UNIFORM>;
}

template <typename T>
auto cluster_kernel(int mode) {
  return mode == MODE_GENERAL ? tree_cluster_kernel<T, MODE_GENERAL>
         : mode == MODE_CUBIC ? tree_cluster_kernel<T, MODE_CUBIC>
                              : tree_cluster_kernel<T, MODE_UNIFORM>;
}

int smem_optin(int* bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return static_cast<int>(err);
}

template <typename T>
bool valid(const TreeDP<T>& p) {
  return p.N >= 1 && p.M >= 1 && p.G >= 2 && p.W >= 1 && p.W <= p.M && p.R >= 1 && p.E >= 0 &&
         p.mode >= MODE_UNIFORM && p.mode <= MODE_CUBIC &&
         !(p.mode == MODE_CUBIC && p.G > 2 && !p.solver);
}

// A launch of one cluster of c CTAs (attr holds its dimension).
cudaLaunchConfig_t cluster_config(int c, int threads, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(c);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

// The cluster the card co-schedules for CTAs of smem bytes: 16 where
// cudaOccupancyMaxActiveClusters allows it (non-portable), else 8; 0 where
// neither.
template <typename T>
int cluster_size(int mode, size_t smem, cudaError_t* err) {
  const auto kernel = cluster_kernel<T>(mode);
  // The card's largest: the attribute is the kernel's, shared by every host
  // thread that launches it, whatever slab each launch takes.
  int optin = 0;
  *err = static_cast<cudaError_t>(smem_optin(&optin));
  if (*err == cudaSuccess)
    *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (*err == cudaSuccess)
    *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (*err != cudaSuccess) return 0;
  for (int c : {kMaxCluster, kPortableCluster}) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t config = cluster_config(c, kClusterThreads, smem, nullptr, &attr);
    int active = 0;
    *err = cudaOccupancyMaxActiveClusters(&active, kernel, &config);
    if (*err != cudaSuccess) return 0;
    if (active >= 1) return c;
  }
  return 0;
}

// The cluster route's plan for M rows: the cluster size, rows a CTA, its
// shared memory; false where no cluster takes the slab.
template <typename T>
bool cluster_plan(int M, int G, int W, int E, int mode, int* cluster, int* rows, size_t* smem,
                  cudaError_t* err) {
  *err = cudaSuccess;
  int optin = 0;
  if ((*err = static_cast<cudaError_t>(smem_optin(&optin))) != cudaSuccess) return false;
  for (int c : {kMaxCluster, kPortableCluster}) {
    const int r = (M + c - 1) / c;
    const size_t bytes = cluster_layout<T>(M, r, G, W, E, mode).bytes;
    if (bytes > static_cast<size_t>(optin)) return false;  // fewer CTAs only need more
    if (cluster_size<T>(mode, bytes, err) == c) {
      *cluster = c;
      *rows = r;
      *smem = bytes;
      return true;
    }
    if (*err != cudaSuccess) return false;
  }
  return false;
}

template <typename T>
int launch_cluster(TreeDP<T> p, void* stream) {
  if (!valid(p) || !p.table) return static_cast<int>(cudaErrorInvalidValue);
  int cluster = 0;
  size_t smem = 0;
  cudaError_t err;
  if (!cluster_plan<T>(p.M, p.G, p.W, p.E, p.mode, &cluster, &p.rows, &smem, &err))
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config =
      cluster_config(cluster, cluster_threads(p.rows, p.G), smem,
                     static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&config, cluster_kernel<T>(p.mode), p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_steps(TreeDP<T> p, void* stream) {
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0;
  if (int err = smem_optin(&optin)) return err;
  const size_t smem = step_smem_bytes<T>(p.G, p.mode);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = step_kernel<T>(p.mode);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t = p.N - 1; t >= 0; --t) {
    kernel<<<p.M, kStepThreads, smem, s>>>(p, t);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The large route: the steps' decision tables table_steps at a time into
// the table scratch [table_steps, table_row(D), G] (one launch a chunk of
// steps, from the last), and for each step t = N-1 .. 0 of the chunk ev
// (and in cubic mode rhs) into their scratch, in cubic mode the moments,
// then the decisions into values[t]; each launch after the one before on
// the stream, which orders their device-memory writes and reads.
template <typename T>
int launch_large(TreeDP<T> p, T* table, int table_steps, T* ev, T* mom, T* rhs, void* stream) {
  const bool cubic = p.mode == MODE_CUBIC;
  if (!valid(p) || !table || table_steps < 1 || !ev || (cubic && (!mom || (p.G > 2 && !rhs))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto decide_k = decide_kernel<T>(p.mode);
  const auto table_k = table_kernel<T>(p.mode);
  const size_t table_len = static_cast<size_t>(p.G) * table_row(2 * p.E + 3);
  const dim3 cells((p.G + kStepThreads - 1) / kStepThreads,
                   (p.M + kDecideRows - 1) / kDecideRows);
  const dim3 rows((p.G + kStepThreads - 1) / kStepThreads, (p.M + kEvRows - 1) / kEvRows);
  const dim3 moments(std::max(1, (p.G - 2 + kStepThreads - 1) / kStepThreads), p.M);
  for (int hi = p.N; hi > 0; hi -= table_steps) {
    const int lo = std::max(0, hi - table_steps);
    const size_t columns = static_cast<size_t>(hi - lo) * p.G;
    table_k<<<static_cast<unsigned>((columns + kStepThreads - 1) / kStepThreads), kStepThreads, 0,
              s>>>(p, lo, hi, table);
    for (int t = hi - 1; t >= lo; --t) {
      tree_ev_kernel<T><<<rows, kStepThreads, 0, s>>>(p, t, ev, cubic ? rhs : nullptr);
      if (cubic) tree_moments_kernel<T><<<moments, kStepThreads, 0, s>>>(p, t, rhs, mom);
      decide_k<<<cells, kStepThreads, 0, s>>>(p, t, table + (t - lo) * table_len, ev, mom);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

template <typename T>
TreeDP<T> problem(int N, int M, int G, int W, int R, int E, int is_step, int mode, const T* steps,
                  const T* r_inv, const T* r_min, const T* r_max, const T* grids, const T* spot,
                  const T* band, const int64_t* start, const T* solver, T* values, T* table) {
  return TreeDP<T>{N, M, G, W, R, E, is_step, mode, 0, steps, r_inv, r_min, r_max, grids, spot,
                   band, start, mode == MODE_CUBIC ? solver : nullptr, values, table};
}

// The step kernel's report at G into out[6] (see stt_tree_dp_info).
template <typename T>
int step_info(int G, int mode, int* out) {
  const auto kernel = step_kernel<T>(mode);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int optin = 0;
  if (err == cudaSuccess) err = static_cast<cudaError_t>(smem_optin(&optin));
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = step_smem_bytes<T>(G, mode);
  int blocks = 0;
  if (smem <= static_cast<size_t>(optin)) {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kStepThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int per = static_cast<int>(sizeof(T));
  out[0] = kStepThreads;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = static_cast<int>(smem);
  out[4] = blocks;
  out[5] = mode == MODE_CUBIC ? (optin / per + 2) / 3 : optin / per;  // the largest G
  return 0;
}

// The large route's report in a mode into out[8] (see stt_tree_dp_large_info).
template <typename T>
int large_info(int mode, int* out) {
  cudaFuncAttributes ev, moments, decide, table;
  cudaError_t err = cudaFuncGetAttributes(&ev, tree_ev_kernel<T>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&moments, tree_moments_kernel<T>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&decide, decide_kernel<T>(mode));
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&table, table_kernel<T>(mode));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, decide_kernel<T>(mode),
                                                        kStepThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool cubic = mode == MODE_CUBIC;
  out[0] = kStepThreads;
  out[1] = decide.numRegs;
  out[2] = ev.numRegs;
  out[3] = cubic ? moments.numRegs : 0;
  out[4] = static_cast<int>(std::max({table.localSizeBytes, decide.localSizeBytes,
                                      ev.localSizeBytes,
                                      cubic ? moments.localSizeBytes : size_t(0)}));
  out[5] = blocks;
  out[6] = cubic ? 3 : 2;
  out[7] = table.numRegs;
  return 0;
}

// The cluster route's report for an [M, G] slab into out[8] (see
// stt_tree_cluster_info).
template <typename T>
int cluster_info(int M, int G, int W, int E, int mode, int* out) {
  const auto kernel = cluster_kernel<T>(mode);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int optin = 0;
  if (err == cudaSuccess) err = static_cast<cudaError_t>(smem_optin(&optin));
  if (err != cudaSuccess) return static_cast<int>(err);
  int cluster = 0, rows = 0;
  size_t smem = 0;
  const bool fits = cluster_plan<T>(M, G, W, E, mode, &cluster, &rows, &smem, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  if (fits) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kClusterThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // The most rows a CTA holds at G, W and E, times the cluster a CTA of that
  // size gets.
  int max_rows = 0, max_cluster = 0;
  // (M at that size: the row addresses take shared memory too.)
  while (cluster_layout<T>(kMaxCluster * (max_rows + 1), max_rows + 1, G, W, E, mode).bytes <=
         static_cast<size_t>(optin))
    ++max_rows;
  if (max_rows) {
    max_cluster = cluster_size<T>(
        mode, cluster_layout<T>(kMaxCluster * max_rows, max_rows, G, W, E, mode).bytes, &err);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  out[0] = fits ? cluster : 0;
  out[1] = fits ? cluster_threads(rows, G) : 0;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = fits ? static_cast<int>(smem) : 0;
  out[5] = blocks;
  out[6] = fits ? rows : 0;
  out[7] = max_rows * max_cluster;
  return static_cast<int>(err);
}

}  // namespace

// N steps, M node rows, G grid points, W band width, R ratchet nodes, E extra
// decisions, is_step, mode (0 uniform, 1 general, 2 cubic), steps [N, 11],
// ratchet inventories, min and max rates [N, R], grids [N+1, G], spot
// [N+1, M], band [N, M, W], band start [N, M] (int64), solver [G-2, G-2]
// (cubic, else NULL), values [N+1, M, G] (values[N] given: the terminal
// values), the decision tables' scratch [N, 1 + 5(2E+3), G], stream.
// The cluster route: one launch of one cluster for the N steps t = N-1 .. 0;
// cudaErrorInvalidValue where the slab does not fit (stt_tree_cluster_info),
// or the launch's own error.
extern "C" int stt_tree_dp_f32(int N, int M, int G, int W, int R, int E, int is_step, int mode,
                               const float* steps, const float* r_inv, const float* r_min,
                               const float* r_max, const float* grids, const float* spot,
                               const float* band, const int64_t* start, const float* solver,
                               float* values, float* table, void* stream) {
  return launch_cluster(problem<float>(N, M, G, W, R, E, is_step, mode, steps, r_inv, r_min, r_max,
                                       grids, spot, band, start, solver, values, table), stream);
}

extern "C" int stt_tree_dp_f64(int N, int M, int G, int W, int R, int E, int is_step, int mode,
                               const double* steps, const double* r_inv, const double* r_min,
                               const double* r_max, const double* grids, const double* spot,
                               const double* band, const int64_t* start, const double* solver,
                               double* values, double* table, void* stream) {
  return launch_cluster(problem<double>(N, M, G, W, R, E, is_step, mode, steps, r_inv, r_min,
                                        r_max, grids, spot, band, start, solver, values, table),
                        stream);
}

// The large-slab route, the same arguments but the tables' scratch: one
// launch a step, t = N-1 .. 0.
extern "C" int stt_tree_dp_steps_f32(int N, int M, int G, int W, int R, int E, int is_step,
                                     int mode, const float* steps, const float* r_inv,
                                     const float* r_min, const float* r_max, const float* grids,
                                     const float* spot, const float* band, const int64_t* start,
                                     const float* solver, float* values, void* stream) {
  return launch_steps(problem<float>(N, M, G, W, R, E, is_step, mode, steps, r_inv, r_min, r_max,
                                     grids, spot, band, start, solver, values, nullptr), stream);
}

extern "C" int stt_tree_dp_steps_f64(int N, int M, int G, int W, int R, int E, int is_step,
                                     int mode, const double* steps, const double* r_inv,
                                     const double* r_min, const double* r_max,
                                     const double* grids, const double* spot, const double* band,
                                     const int64_t* start, const double* solver, double* values,
                                     void* stream) {
  return launch_steps(problem<double>(N, M, G, W, R, E, is_step, mode, steps, r_inv, r_min, r_max,
                                      grids, spot, band, start, solver, values, nullptr), stream);
}

// The large route, the same arguments as the cluster route, then the steps
// the table scratch holds (table: [table_steps, 1 + 5(2E+3), G]), then the
// scratch of a step's ev [M, G], and in cubic mode of its moments [M, G] and
// rhs [M, G-2] (else NULL): per chunk of table_steps steps one table launch,
// then per step t = N-1 .. 0 two launches (three in cubic mode); any G.
extern "C" int stt_tree_dp_large_f32(int N, int M, int G, int W, int R, int E, int is_step,
                                     int mode, const float* steps, const float* r_inv,
                                     const float* r_min, const float* r_max, const float* grids,
                                     const float* spot, const float* band, const int64_t* start,
                                     const float* solver, float* values, float* table,
                                     int table_steps, float* ev, float* moments, float* rhs,
                                     void* stream) {
  return launch_large(problem<float>(N, M, G, W, R, E, is_step, mode, steps, r_inv, r_min, r_max,
                                     grids, spot, band, start, solver, values, nullptr),
                      table, table_steps, ev, moments, rhs, stream);
}

extern "C" int stt_tree_dp_large_f64(int N, int M, int G, int W, int R, int E, int is_step,
                                     int mode, const double* steps, const double* r_inv,
                                     const double* r_min, const double* r_max,
                                     const double* grids, const double* spot, const double* band,
                                     const int64_t* start, const double* solver, double* values,
                                     double* table, int table_steps, double* ev, double* moments,
                                     double* rhs, void* stream) {
  return launch_large(problem<double>(N, M, G, W, R, E, is_step, mode, steps, r_inv, r_min, r_max,
                                      grids, spot, band, start, solver, values, nullptr),
                      table, table_steps, ev, moments, rhs, stream);
}

// Launch report of the large route in f32 (is_double 0) or f64 (1) in a
// mode into out[8]: threads a block, registers a thread of the decide, ev
// and moments kernels (the last 0 outside cubic mode, which alone launches
// it), local memory bytes a thread (spills, the most of its kernels),
// decide blocks per SM, launches a step (ev and decide, and moments in
// cubic mode), and the table kernel's registers.  Any G.
extern "C" int stt_tree_dp_large_info(int is_double, int mode, int* out) {
  if (mode < MODE_UNIFORM || mode > MODE_CUBIC) return static_cast<int>(cudaErrorInvalidValue);
  return is_double ? large_info<double>(mode, out) : large_info<float>(mode, out);
}

// Launch report of the large-slab route's step kernel in f32 (is_double 0) or
// f64 (1) at G grid points in a mode into out[6]: threads per block,
// registers per thread, local memory bytes per thread (spills), dynamic
// shared memory bytes at G, blocks per SM at G (0 where G does not fit), and
// the largest G that fits the card's shared memory in that mode.
extern "C" int stt_tree_dp_info(int is_double, int G, int mode, int* out) {
  if (G < 2 || mode < MODE_UNIFORM || mode > MODE_CUBIC)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_double ? step_info<double>(G, mode, out) : step_info<float>(G, mode, out);
}

// Launch report of the cluster route for an [M, G] slab of band width W and
// E extra decisions in a mode into out[8]: the cluster size (0 where the
// slab does not fit), threads a CTA, registers and local (spill) bytes a
// thread, dynamic shared memory a CTA, CTAs per SM at it, node rows a CTA,
// and the most node rows the cluster takes at G, W and E.
extern "C" int stt_tree_cluster_info(int is_double, int M, int G, int W, int E, int mode,
                                     int* out) {
  if (M < 1 || G < 2 || W < 1 || E < 0 || mode < MODE_UNIFORM || mode > MODE_CUBIC)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_double ? cluster_info<double>(M, G, W, E, mode, out)
                   : cluster_info<float>(M, G, W, E, mode, out);
}
