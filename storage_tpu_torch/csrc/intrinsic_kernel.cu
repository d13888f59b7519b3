// The intrinsic DP (the deterministic storage valuation on the forward curve)
// as one launch: of one block (the shared route), or of a cooperative grid
// over the card (the large route).
//
// No TPU kernel stands behind it: it replaces the lax.scan pair of
// storage_tpu/engines/intrinsic.py:_intrinsic_core (backward over t = N-1..1,
// then the forward walk of the inventory), which the port would otherwise
// run as tensor code at ~7 launches a backward step and ~60 a forward step.
//
// Per grid point (backward) or for the path's inventory (forward), the
// decision is dp_common.cuh's decide() against the step's forward price, in
// any of its three continuation modes.  Every operation is rounded on its
// own, so the arithmetic is the plain version's (engines/intrinsic.py
// intrinsic_plain) operation by operation.
//
// Bound on the H100: neither bytes (the tables, ~150 KB at N = 365, G = 100)
// nor operations (~4·10^6 at the headline) but latency: the DP is a chain of
// N - 1 dependent backward steps, each ended by a barrier, and N dependent
// forward steps.  A decide() on one thread is ~1 us (tools/torch_dp_probe.py
// --stamps), so the design takes as much of it off the chain as it can and
// keeps the chain in one launch:
//   - backward: the backward's inventories are the grid points, known before
//     any value, so the block first fills every step's decision table
//     (dp_common.cuh table_column_fill: the ratchet rates, the bang-bang
//     volumes, their fuel and costs and the continuation's node and weight
//     at the inventory after each), work without a chain.  A step of the
//     chain is then a few operations a grid point and decision on the table
//     column (entry_total: the PV at the forward, the continuation's lerp on
//     v_{t+1}) and the first best (FirstBest), with the value rows v_{t+1}
//     and v_t (in cubic mode their moments too) alternating in shared
//     memory.  Step t-1's scalars and, where it fits, its table come by
//     cp.async while step t computes.  Every row also goes to vs [N+1, G]
//     (and the moments to [N+1, G]) for the forward walk.
//   - forward: the walked inventory is known only step by step, so each step
//     is a whole decide(), by warp 0, its lanes valuing the decisions side by
//     side (decide_lanes); the block stages the next K steps' scalars,
//     ratchets and vs rows (the moments and grid rows where the mode reads
//     them) into shared memory by cp.async, two chunks in flight, while warp
//     0 walks the chunk before from there.
// Shared memory bounds G on this route: intrinsic_info reports the largest G
// in each mode (max_grid).
//
// The large route (intrinsic_dp_large_kernel), for a G beyond max_grid, or
// whose decision tables' scratch would pass the wrapper's cap: no row in
// shared memory and no table, and each backward step spread over the whole
// card, since a step's G decide()s are independent and a decide() is a
// chain of ~1 us on one thread.
//   - backward: one cooperative launch of blocks of 256 threads, one grid
//     point a thread up to every block the card holds at once
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor; in cubic mode always
//     that many: large_grid_blocks); each grid point of step t a whole
//     decide() against the forward (decide() and the table's entry_total
//     give the same bits), v_{t+1} read from vs in device memory and v_t
//     written there; a grid barrier (cg's grid sync) ends the step.  In
//     cubic mode block_moments' two halves follow, each across the card and
//     ended by a grid barrier: the rhs [G-2] into a device scratch, then the
//     moments [N+1, G], each summed by one thread in ascending j (its
//     bits), the rows spread over every block.  (One launch a step in place
//     of the barriers, or the step tables filled first as on the shared
//     route, ran slower.)
//   - forward: after the last barrier block 0 walks as above, but the chunks
//     stage only the steps' scalars and ratchets: the walk reads a few
//     entries of the vs, moments and grid rows a step, from device memory.
// Memory model: a row written on one SM is read on others only after a
// grid barrier, which fences at GPU scope on both sides; every such read is
// a plain (coherent) load, never ld.global.nc (no pointer here is
// __restrict__, nothing goes through __ldg).  Its bound is the chain: N-1
// grid barriers (three a step in cubic mode, whose moments also read the
// [G-2, G-2] inverse every step) and the N steps of the walk.
#include <algorithm>
#include <cooperative_groups.h>
#include <initializer_list>
#include <cstdint>
#include <cuda_runtime.h>

#include "dp_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace stt_dp;

constexpr int kThreads = 1024;
constexpr int kGridThreads = 256;  // the large route's blocks
constexpr int kScalarSlots = 12;  // NUM_STEP_SCALARS, padded
constexpr int kMaxChunk = 32;     // forward steps staged a chunk
constexpr size_t kForwardBudget = 48 * 1024;  // bytes the forward may stage, at least

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
  T* table;          // [N, G, table_row(D)]: the steps' decision tables (scratch)
  T* out;            // [5 * N + 1]: inventory, volume, fuel, loss, PV rows; final inventory
};

int pow2_at_least(int d) {
  int p = 1;
  while (p < d && p < 32) p <<= 1;
  return p;
}

// The block's plan, in T elements of shared memory.
//   backward: v [2][G], cubic moments [2][G] and rhs [G], two stages of step
//     scalars and ratchets, and where they fit two stages of a step's
//     decision table [G, table_row(D)] (else it is read from device memory);
//   forward (the same memory, after the backward): two chunks of K steps of
//     scalars, ratchets, the vs row, and where staged the grid row (general
//     rows always) and the moments row (cubic).
struct Plan {
  int threads;                      // the block: 1,024, for the tables
  int walk_lanes;                   // forward: lanes of warp 0 a step
  int tab, row_len;                 // scalars + ratchets a stage; a grid point's table row
  int stage_table;                  // the backward stages each step's table
  size_t v, mom, rhs, stage, table; // backward offsets
  int f_step, f_v, f_grid, f_mom;   // forward step length and offsets (f_grid -1: global)
  int chunk;                        // K
  size_t bytes;
};

template <typename T>
Plan plan(int N, int G, int R, int E, int mode, int optin) {
  Plan p;
  const int D = 2 * E + 3;
  const bool general = mode == MODE_GENERAL, cubic = mode == MODE_CUBIC;
  p.threads = kThreads;  // the tables' grid points, all at once
  p.walk_lanes = pow2_at_least(D);
  p.tab = kScalarSlots + 3 * R;
  p.tab += p.tab & 1;
  p.row_len = table_row(D);
  const size_t g = static_cast<size_t>(G);
  p.v = 0;
  p.mom = 2 * g;
  p.rhs = p.mom + (cubic ? 2 * g : 0);
  p.stage = p.rhs + (cubic ? g : 0);
  p.table = p.stage + 2 * static_cast<size_t>(p.tab);
  const size_t with_table = p.table + 2 * g * p.row_len;
  p.stage_table = sizeof(T) * with_table <= static_cast<size_t>(optin);
  const size_t backward = p.stage_table ? with_table : p.table;
  // The forward: the grid row staged where two chunks of one step hold it
  // within the larger of the backward's memory and kForwardBudget.
  const size_t budget = std::max(backward, kForwardBudget / sizeof(T));
  const int rows = 1 + (cubic ? 1 : 0);  // vs, moments
  const int with_grid = p.tab + (rows + 1) * G, without = p.tab + (rows + (general ? 1 : 0)) * G;
  const bool stage_grid = general || 2 * static_cast<size_t>(with_grid) <= budget;
  p.f_step = stage_grid ? with_grid : without;
  p.f_step += p.f_step & 1;
  p.f_v = p.tab;
  p.f_mom = cubic ? p.f_v + G : -1;
  p.f_grid = stage_grid ? p.f_v + rows * G : -1;
  p.chunk = static_cast<int>(std::min<size_t>(
      {static_cast<size_t>(kMaxChunk), static_cast<size_t>(N),
       std::max<size_t>(1, budget / (2 * static_cast<size_t>(p.f_step)))}));
  const size_t forward = 2 * static_cast<size_t>(p.chunk) * p.f_step;
  p.bytes = sizeof(T) * std::max(backward, forward);
  return p;
}

// Step t's scalars and ratchets into a stage (the calling threads' open
// cp.async groups).
template <typename T>
__device__ void stage_tables(const Problem<T>& p, int t, T* dst) {
  const size_t row = static_cast<size_t>(t) * p.R;
  stage_copy(dst, p.steps + static_cast<size_t>(t) * NUM_STEP_SCALARS, NUM_STEP_SCALARS);
  stage_copy(dst + kScalarSlots, p.r_inv + row, p.R);
  stage_copy(dst + kScalarSlots + p.R, p.r_min + row, p.R);
  stage_copy(dst + kScalarSlots + 2 * p.R, p.r_max + row, p.R);
}

// A step's view with the continuation mode a compile-time constant, so that
// the kernel's code holds that mode's continuation alone.
template <int kMode, typename T>
__device__ StepView<T> view(const Problem<T>& p, const T* tab, const T* grid_next, const T* v_next,
                            const T* m_next) {
  return StepView<T>{tab, tab + kScalarSlots, tab + kScalarSlots + p.R,
                     tab + kScalarSlots + 2 * p.R, p.R, p.is_step, p.E, p.G, kMode,
                     grid_next, v_next, m_next};
}

// The backward over t = N-1 .. 1: first every step's decision table, then
// the chain of steps on it; rows of vs (and moments) in device memory.
template <int kMode, typename T>
__device__ void backward(const Problem<T>& p, const Plan& l, T* base) {
  const int N = p.N, G = p.G, D = 2 * p.E + 3;
  constexpr bool cubic = kMode == MODE_CUBIC;
  T* v = base + l.v;
  T* mom = base + l.mom;
  T* stages = base + l.stage;
  T* tables = base + l.table;
  const size_t g_ = static_cast<size_t>(G), table_len = g_ * l.row_len;
  // The decision tables of steps 1 .. N-1, a grid point a thread: the
  // ratchet rates, volumes, costs and continuation nodes, which no value
  // row enters, off the chain.
  for (int tg = threadIdx.x; tg < (N - 1) * G; tg += blockDim.x) {
    const int t = 1 + tg / G, g = tg - (t - 1) * G;
    const size_t row = static_cast<size_t>(t) * p.R;
    const StepView<T> st{p.steps + static_cast<size_t>(t) * NUM_STEP_SCALARS, p.r_inv + row,
                         p.r_min + row, p.r_max + row, p.R, p.is_step, p.E, G, kMode,
                         p.grids + static_cast<size_t>(t + 1) * G, nullptr, nullptr};
    table_column_fill(st, p.grids[static_cast<size_t>(t) * G + g],
                      p.table + static_cast<size_t>(t) * table_len + g, G);
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    v[(N & 1) * g_ + g] = p.v_end[g];
    p.vs[static_cast<size_t>(N) * G + g] = p.v_end[g];
    p.vs[g] = T(0);  // grid[0] is the known inventory: valued by the forward walk
  }
  __syncthreads();  // the tables, written by every thread, are read below
  if (N > 1) {
    stage_tables(p, N - 1, stages + ((N - 1) & 1) * l.tab);
    if (l.stage_table)
      stage_copy(tables + ((N - 1) & 1) * table_len, p.table + (N - 1) * table_len,
                 static_cast<int>(table_len));
  }
  cp_async_wait_all();
  __syncthreads();
  if (cubic) {
    block_moments(p.grids + static_cast<size_t>(N) * G, v + (N & 1) * g_, p.solver,
                  base + l.rhs, mom + (N & 1) * g_, G);
    for (int g = threadIdx.x; g < G; g += blockDim.x)
      p.moments[static_cast<size_t>(N) * G + g] = mom[(N & 1) * g_ + g];
  }
  for (int t = N - 1; t >= 1; --t) {
    const int cur = t & 1, nxt = cur ^ 1;
    const T* tab = stages + cur * l.tab;
    const T* table = l.stage_table ? tables + cur * table_len : p.table + t * table_len;
    if (t > 1) {
      stage_tables(p, t - 1, stages + nxt * l.tab);
      if (l.stage_table)
        stage_copy(tables + nxt * table_len, p.table + (t - 1) * table_len,
                   static_cast<int>(table_len));
    }
    bool degenerate = false;
    T curvature = T(0);
    if (cubic) curvature = cubic_factor(p.grids + (t + 1) * g_, G, &degenerate);
    const T* v_next = v + nxt * g_;
    const T* m_next = cubic ? mom + nxt * g_ : nullptr;
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      FirstBest<T> best{T(0), -1, false};
      for (int k = 0; k < D; ++k)
        best.offer(entry_total(table + g, G, k, tab, kMode, tab[S_FWD], v_next, m_next,
                               curvature, degenerate),
                   k);
      v[cur * g_ + g] = best.total;
      p.vs[static_cast<size_t>(t) * G + g] = best.total;
    }
    cp_async_wait_all();
    __syncthreads();
    if (cubic) {
      block_moments(p.grids + t * g_, v + cur * g_, p.solver, base + l.rhs, mom + cur * g_, G);
      for (int g = threadIdx.x; g < G; g += blockDim.x)
        p.moments[static_cast<size_t>(t) * G + g] = mom[cur * g_ + g];
    }
  }
}

// Steps [c·K, c·K + K) of the forward walk into chunk buffer c & 1: their
// scalars and ratchets, and unless kLarge their next rows.
template <bool kLarge, typename T>
__device__ void stage_chunk(const Problem<T>& p, const Plan& l, int c, T* base) {
  const int t0 = c * l.chunk, t1 = min(p.N, t0 + l.chunk);
  T* buf = base + (c & 1) * static_cast<size_t>(l.chunk) * l.f_step;
  for (int t = t0; t < t1; ++t) {
    T* dst = buf + static_cast<size_t>(t - t0) * l.f_step;
    const size_t next = static_cast<size_t>(t + 1) * p.G;
    stage_tables(p, t, dst);
    if constexpr (!kLarge) {
      stage_copy(dst + l.f_v, p.vs + next, p.G);
      if (l.f_mom >= 0) stage_copy(dst + l.f_mom, p.moments + next, p.G);
      if (l.f_grid >= 0) stage_copy(dst + l.f_grid, p.grids + next, p.G);
    }
  }
}

// The forward walk of the inventory from inv0: warp 0 walks each staged
// chunk while the block stages the next.  kLarge: the next rows are read
// from device memory.
template <int kMode, bool kLarge, typename T>
__device__ void forward_walk(const Problem<T>& p, const Plan& l, T* base) {
  const int N = p.N, chunks = (N + l.chunk - 1) / l.chunk;
  // 16 units in the last place (engines/intrinsic.py snap_to_band).
  const T snap_ulps = ldexp(T(1), sizeof(T) == 4 ? -19 : -48);
  T inv = p.inv0;
  stage_chunk<kLarge>(p, l, 0, base);
  for (int c = 0; c < chunks; ++c) {
    // Chunk c has landed, and warp 0 is done with chunk c - 1's buffer.
    cp_async_wait_all();
    __syncthreads();
    if (c + 1 < chunks) stage_chunk<kLarge>(p, l, c + 1, base);
    if (threadIdx.x >= 32) continue;
    const T* buf = base + (c & 1) * static_cast<size_t>(l.chunk) * l.f_step;
    for (int t = c * l.chunk; t < min(N, (c + 1) * l.chunk); ++t) {
      const T* s = buf + static_cast<size_t>(t - c * l.chunk) * l.f_step;
      const size_t row = static_cast<size_t>(t + 1) * p.G;  // the next step's rows
      const StepView<T> st =
          kLarge ? view<kMode>(p, s, p.grids + row, p.vs + row,
                               kMode == MODE_CUBIC ? p.moments + row : nullptr)
                 : view<kMode>(p, s, l.f_grid >= 0 ? s + l.f_grid : p.grids + row, s + l.f_v,
                               l.f_mom >= 0 ? s + l.f_mom : nullptr);
      const Choice<T> ch = decide_lanes(st, s[S_FWD], inv, l.walk_lanes);
      const T loss = mul(s[S_LOSS_PCNT], inv);
      T next = sub(add(inv, ch.decision), loss);
      // A decision that fills or empties to a bound of the next band lands
      // on it: snap the rounding residual, whose sign would decide whether
      // the next decision set holds zero.
      const T tol = mul(snap_ulps, add(add(fabs(inv), fabs(ch.decision)), fabs(loss)));
      if (fabs(sub(next, s[S_NEXT_MIN])) <= tol) next = s[S_NEXT_MIN];
      if (fabs(sub(next, s[S_NEXT_MAX])) <= tol) next = s[S_NEXT_MAX];
      inv = next;
      if (threadIdx.x == 0) {
        p.out[t] = inv;
        p.out[N + t] = ch.decision;
        p.out[2 * N + t] = ch.consumed;
        p.out[3 * N + t] = loss;
        p.out[4 * N + t] = ch.pv;
      }
    }
  }
  if (threadIdx.x == 0) p.out[5 * N] = inv;
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads, 1) intrinsic_dp_kernel(Problem<T> p, Plan l) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* base = reinterpret_cast<T*>(smem_raw);
  backward<kMode>(p, l, base);
  __syncthreads();
  // Forward walk of the inventory.
  forward_walk<kMode, false>(p, l, base);
}

// ---- the large route: each backward step spread over the card.

// The large route's plan: blocks of kGridThreads, and block 0's forward walk
// in two chunks of K steps' scalars and ratchets in shared memory (at least
// one step, at most kMaxChunk, within kForwardBudget where one step fits it).
template <typename T>
Plan large_plan(int N, int R, int E) {
  Plan p = {};
  p.threads = kGridThreads;
  p.walk_lanes = pow2_at_least(2 * E + 3);
  p.tab = kScalarSlots + 3 * R;
  p.tab += p.tab & 1;
  p.f_step = p.tab;
  p.f_v = p.f_grid = p.f_mom = -1;
  const size_t budget = kForwardBudget / sizeof(T);
  p.chunk = static_cast<int>(std::min<size_t>(
      {static_cast<size_t>(kMaxChunk), static_cast<size_t>(N),
       std::max<size_t>(1, budget / (2 * static_cast<size_t>(p.f_step)))}));
  p.bytes = sizeof(T) * 2 * static_cast<size_t>(p.chunk) * p.f_step;
  return p;
}

// Step t's values: each grid point decided whole against the forward (as the
// tree's step kernels do: decide() and the table's entry_total give the same
// bits), v_{t+1} (and its moments) read from vs, v_t written there; grid
// points g = first, first + stride, ...
template <int kMode, typename T>
__device__ void decide_row(const Problem<T>& p, int t, size_t first, size_t stride) {
  const size_t g_ = static_cast<size_t>(p.G), row = static_cast<size_t>(t) * p.R,
               next = (t + 1) * g_;
  const StepView<T> st{p.steps + static_cast<size_t>(t) * NUM_STEP_SCALARS, p.r_inv + row,
                       p.r_min + row, p.r_max + row, p.R, p.is_step, p.E, p.G, kMode,
                       p.grids + next, p.vs + next,
                       kMode == MODE_CUBIC ? p.moments + next : nullptr};
  const T* grid = p.grids + t * g_;
  T* v = p.vs + t * g_;
  for (size_t g = first; g < g_; g += stride) v[g] = decide(st, st.s[S_FWD], grid[g]).total;
}

// block_moments' two halves on row t across the card: the rhs [G-2] of v_t
// (entries first, first + stride, ...), and, after a barrier, the moments
// (rows `first`, `first + stride`, ..., each summed by one thread in
// ascending j, so the bits are block_moments') with zero ends.
template <typename T>
__device__ void rhs_row(const Problem<T>& p, int t, T* rhs, size_t first, size_t stride) {
  const size_t g_ = static_cast<size_t>(p.G);
  const T h = spline_h(p.grids + t * g_, p.G);
  const T* v = p.vs + t * g_;
  for (size_t i = first; i + 2 < g_; i += stride) rhs[i] = moments_rhs(v[i], v[i + 1], v[i + 2], h);
}

template <typename T>
__device__ void moments_row(const Problem<T>& p, int t, const T* rhs, size_t first,
                            size_t stride) {
  const size_t g_ = static_cast<size_t>(p.G);
  const int n = p.G - 2;
  const T h = spline_h(p.grids + t * g_, p.G);
  T* m = p.moments + t * g_;
  for (size_t i = first; i < static_cast<size_t>(n); i += stride)
    m[i + 1] = moment_at(p.solver, rhs, static_cast<int>(i), n, h);
  if (first == 0) {
    m[0] = T(0);
    m[p.G - 1] = T(0);
  }
}

// The large route: one cooperative launch of blocks co-resident on the card.
// Each backward step decides the row's grid points across the grid and ends
// with a grid barrier (cubic mode: then the rhs, a barrier, the moments, a
// barrier); after the last, block 0 walks the forward as the shared route
// does, its next rows read from device memory.  The barrier is the only
// ordering between SMs: cg's grid sync fences at GPU scope before its arrive
// and after its wait, so the rows one SM wrote before it are what another
// reads after it.  Those reads are plain loads, never ld.global.nc: no
// pointer of Problem is __restrict__ and nothing reads vs, moments or rhs
// through __ldg, since the non-coherent path may hold a line from before the
// barrier.
template <typename T, int kMode>
__global__ void __launch_bounds__(kGridThreads)
    intrinsic_dp_large_kernel(Problem<T> p, Plan l, T* rhs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  constexpr bool cubic = kMode == MODE_CUBIC;
  const int N = p.N;
  const size_t g_ = static_cast<size_t>(p.G);
  const size_t threads = static_cast<size_t>(gridDim.x) * blockDim.x;
  // Grid points block-major (one a thread where the grid holds them), the
  // moment rows spread over every block (row i on block i % blocks).
  const size_t first = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t spread = static_cast<size_t>(threadIdx.x) * gridDim.x + blockIdx.x;
  const auto moments = [&](int t) {
    rhs_row(p, t, rhs, first, threads);
    grid.sync();  // the rhs, written across the grid, before every row reads all of it
    moments_row(p, t, rhs, spread, threads);
    grid.sync();  // the moments before step t-1 reads them (and the rhs is free again)
  };
  for (size_t g = first; g < g_; g += threads) {
    p.vs[N * g_ + g] = p.v_end[g];
    p.vs[g] = T(0);  // grid[0] is the known inventory: valued by the forward walk
  }
  grid.sync();  // v_N before its moments and step N-1 read it
  if (cubic) moments(N);
  for (int t = N - 1; t >= 1; --t) {
    decide_row<kMode>(p, t, first, threads);
    grid.sync();  // v_t before its moments and step t-1 read it
    if (cubic) moments(t);
  }
  if (blockIdx.x == 0) forward_walk<kMode, true>(p, l, reinterpret_cast<T*>(smem_raw));
}

// The kernel compiled for a continuation mode.
template <typename T>
auto kernel_for(int mode) {
  return mode == MODE_GENERAL ? intrinsic_dp_kernel<T, MODE_GENERAL>
         : mode == MODE_CUBIC ? intrinsic_dp_kernel<T, MODE_CUBIC>
                              : intrinsic_dp_kernel<T, MODE_UNIFORM>;
}

template <typename T>
auto large_kernel_for(int mode) {
  return mode == MODE_GENERAL ? intrinsic_dp_large_kernel<T, MODE_GENERAL>
         : mode == MODE_CUBIC ? intrinsic_dp_large_kernel<T, MODE_CUBIC>
                              : intrinsic_dp_large_kernel<T, MODE_UNIFORM>;
}

int smem_optin(int* bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return static_cast<int>(err);
}

// The largest G whose plan fits the card's shared memory.
template <typename T>
int max_grid(int R, int E, int mode, int optin) {
  int lo = 2, hi = 1 << 20;  // plan(lo) fits, plan(hi) does not
  if (plan<T>(kMaxChunk, lo, R, E, mode, optin).bytes > static_cast<size_t>(optin)) return 0;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    (plan<T>(kMaxChunk, mid, R, E, mode, optin).bytes <= static_cast<size_t>(optin) ? lo : hi) =
        mid;
  }
  return lo;
}

template <typename T>
int launch(int N, int G, int R, int E, int is_step, int mode, const T* steps, const T* r_inv,
           const T* r_min, const T* r_max, const T* grids, const T* v_end, const T* solver,
           double inv0, T* vs, T* moments, T* table, T* out, void* stream) {
  if (N < 1 || G < 2 || R < 1 || E < 0 || mode < MODE_UNIFORM || mode > MODE_CUBIC || !table ||
      (mode == MODE_CUBIC && ((G > 2 && !solver) || !moments)))
    return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0;
  if (int err = smem_optin(&optin)) return err;
  const Plan l = plan<T>(N, G, R, E, mode, optin);
  if (l.bytes > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = kernel_for<T>(mode);
  // The card's largest: the attribute is the kernel's, shared by every host
  // thread that launches it, whatever G each launch takes.
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  Problem<T> p{N, G, R, E, is_step, mode, steps, r_inv, r_min, r_max, grids, v_end,
               mode == MODE_CUBIC ? solver : nullptr, static_cast<T>(inv0), vs,
               mode == MODE_CUBIC ? moments : nullptr, table, out};
  kernel<<<1, l.threads, l.bytes, static_cast<cudaStream_t>(stream)>>>(p, l);
  return static_cast<int>(cudaGetLastError());
}

int device_attribute(cudaDeviceAttr attr, int* value) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(value, attr, device);
  return static_cast<int>(err);
}

// The large route's grid on a card of `sms` SMs holding `per_sm` of its
// blocks: in linear and general modes one grid point a thread, up to every
// block the card holds (fewer blocks, a cheaper barrier: 2.15 against 2.34
// ms at G = 32,768 in f32), and every block it holds in cubic mode, whose
// moment rows read the dense inverse across every SM (2.27x faster than
// over the blocks G needs; tools/torch_dp_probe.py --large-variants).  The
// copy in ops/intrinsic_kernel.py large_grid_blocks.
int large_grid_blocks(int G, int mode, int sms, int per_sm) {
  const long long resident = static_cast<long long>(sms) * per_sm;
  if (mode == MODE_CUBIC) return static_cast<int>(resident);
  return static_cast<int>(std::min<long long>(resident, (G + kGridThreads - 1) / kGridThreads));
}

// The large route's launch at N steps, G grid points, R ratchet nodes and E
// extra decisions in a mode: its plan, the kernel's blocks per SM at the
// plan's shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and
// the cooperative grid's blocks (large_grid_blocks).
template <typename T>
int large_launch_plan(int N, int G, int R, int E, int mode, Plan* l, int* per_sm,
                      int* blocks) {
  int optin = 0, sms = 0;
  if (int err = smem_optin(&optin)) return err;
  if (int err = device_attribute(cudaDevAttrMultiProcessorCount, &sms)) return err;
  *l = large_plan<T>(N, R, E);
  *per_sm = *blocks = 0;
  if (l->bytes > static_cast<size_t>(optin)) return 0;
  const auto kernel = large_kernel_for<T>(mode);
  // The card's largest: the attribute is the kernel's, shared by every host
  // thread that launches it, whatever N each launch takes.
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, l->threads, l->bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = large_grid_blocks(G, mode, sms, *per_sm);
  return 0;
}

template <typename T>
int launch_large(int N, int G, int R, int E, int is_step, int mode, const T* steps,
                 const T* r_inv, const T* r_min, const T* r_max, const T* grids, const T* v_end,
                 const T* solver, double inv0, T* vs, T* moments, T* rhs, T* out, void* stream) {
  if (N < 1 || G < 2 || R < 1 || E < 0 || mode < MODE_UNIFORM || mode > MODE_CUBIC ||
      (mode == MODE_CUBIC && ((G > 2 && (!solver || !rhs)) || !moments)))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan l;
  int per_sm = 0, blocks = 0;
  if (int err = large_launch_plan<T>(N, G, R, E, mode, &l, &per_sm, &blocks)) return err;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool cubic = mode == MODE_CUBIC;
  Problem<T> p{N, G, R, E, is_step, mode, steps, r_inv, r_min, r_max, grids, v_end,
               cubic ? solver : nullptr, static_cast<T>(inv0), vs, cubic ? moments : nullptr,
               nullptr, out};
  T* rhs_arg = cubic ? rhs : nullptr;
  void* args[] = {&p, &l, &rhs_arg};
  // Every block co-resident (the grid is sized from the occupancy report),
  // or the launch fails with cudaErrorCooperativeLaunchTooLarge, returned.
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(large_kernel_for<T>(mode)), dim3(blocks), dim3(l.threads),
      args, l.bytes, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The large route's report at G grid points, R ratchet nodes, E extra
// decisions in a mode into out[9] (see stt_intrinsic_dp_large_info).
template <typename T>
int large_info(int G, int R, int E, int mode, int* out) {
  const auto kernel = large_kernel_for<T>(mode);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan l;
  int per_sm = 0, blocks = 0;
  if (int e = large_launch_plan<T>(kMaxChunk, G, R, E, mode, &l, &per_sm, &blocks)) return e;
  out[0] = l.threads;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = static_cast<int>(l.bytes);
  out[4] = per_sm;
  out[5] = l.walk_lanes;
  out[6] = l.chunk;
  out[7] = blocks;
  out[8] = 1;  // a cooperative launch
  return 0;
}

// Launch report at G grid points, R ratchet nodes, E extra decisions in a
// mode into out[9] (see stt_intrinsic_dp_info).
template <typename T>
int info(int G, int R, int E, int mode, int* out) {
  const auto kernel = kernel_for<T>(mode);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int optin = 0;
  if (err == cudaSuccess) err = static_cast<cudaError_t>(smem_optin(&optin));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan l = plan<T>(kMaxChunk, G, R, E, mode, optin);
  int blocks = 0;
  if (l.bytes <= static_cast<size_t>(optin)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, l.threads, l.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  out[0] = l.threads;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = static_cast<int>(l.bytes);
  out[4] = blocks;
  out[5] = l.stage_table;
  out[6] = l.walk_lanes;
  out[7] = l.chunk;
  out[8] = max_grid<T>(R, E, mode, optin);
  return 0;
}

}  // namespace

// N steps, G grid points, R ratchet nodes, E extra decisions, is_step, mode
// (0 uniform, 1 general, 2 cubic), steps [N, 11], ratchet inventories, min
// and max rates [N, R], grids [N+1, G], v_end [G], solver [G-2, G-2] (cubic,
// else NULL), the starting inventory, vs [N+1, G], moments [N+1, G] (cubic,
// else NULL), the decision tables' scratch [N, 1 + 5(2E+3), G], out [5N+1],
// stream.  cudaErrorInvalidValue where G is beyond what the block's shared
// memory holds (stt_intrinsic_dp_info).
extern "C" int stt_intrinsic_dp_f32(int N, int G, int R, int E, int is_step, int mode,
                                    const float* steps, const float* r_inv, const float* r_min,
                                    const float* r_max, const float* grids, const float* v_end,
                                    const float* solver, double inv0, float* vs, float* moments,
                                    float* table, float* out, void* stream) {
  return launch<float>(N, G, R, E, is_step, mode, steps, r_inv, r_min, r_max, grids, v_end,
                       solver, inv0, vs, moments, table, out, stream);
}

extern "C" int stt_intrinsic_dp_f64(int N, int G, int R, int E, int is_step, int mode,
                                    const double* steps, const double* r_inv, const double* r_min,
                                    const double* r_max, const double* grids, const double* v_end,
                                    const double* solver, double inv0, double* vs, double* moments,
                                    double* table, double* out, void* stream) {
  return launch<double>(N, G, R, E, is_step, mode, steps, r_inv, r_min, r_max, grids, v_end,
                        solver, inv0, vs, moments, table, out, stream);
}

// Launch report of the DP kernel in f32 (is_double 0) or f64 (1) at G grid
// points, R ratchet nodes and E extra decisions in a mode into out[9]:
// threads of its one block, registers per thread, local memory bytes per
// thread (spills), dynamic shared memory bytes, blocks per SM at that size
// (0 where G does not fit), whether the backward stages each step's
// decision table in shared memory (1) or reads it from device memory (0),
// lanes a step in the forward walk, forward steps staged a chunk, and the
// largest G that fits the card's shared memory.
extern "C" int stt_intrinsic_dp_info(int is_double, int G, int R, int E, int mode, int* out) {
  if (G < 2 || R < 1 || E < 0 || mode < MODE_UNIFORM || mode > MODE_CUBIC)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_double ? info<double>(G, R, E, mode, out) : info<float>(G, R, E, mode, out);
}

// The large route, the same arguments but, in place of the tables' scratch,
// block_moments' rhs scratch [G-2] (cubic, else NULL): any G.
extern "C" int stt_intrinsic_dp_large_f32(int N, int G, int R, int E, int is_step, int mode,
                                          const float* steps, const float* r_inv,
                                          const float* r_min, const float* r_max,
                                          const float* grids, const float* v_end,
                                          const float* solver, double inv0, float* vs,
                                          float* moments, float* rhs, float* out, void* stream) {
  return launch_large<float>(N, G, R, E, is_step, mode, steps, r_inv, r_min, r_max, grids, v_end,
                             solver, inv0, vs, moments, rhs, out, stream);
}

extern "C" int stt_intrinsic_dp_large_f64(int N, int G, int R, int E, int is_step, int mode,
                                          const double* steps, const double* r_inv,
                                          const double* r_min, const double* r_max,
                                          const double* grids, const double* v_end,
                                          const double* solver, double inv0, double* vs,
                                          double* moments, double* rhs, double* out,
                                          void* stream) {
  return launch_large<double>(N, G, R, E, is_step, mode, steps, r_inv, r_min, r_max, grids, v_end,
                              solver, inv0, vs, moments, rhs, out, stream);
}

// Launch report of the large route in f32 (is_double 0) or f64 (1) at G grid
// points, R ratchet nodes and E extra decisions in a mode into out[9]:
// threads a block, registers per thread, local memory bytes per thread
// (spills), dynamic shared memory bytes a block (at N >= 32), blocks per SM
// at that size, lanes a step in the forward walk, forward steps staged a
// chunk, the cooperative grid's blocks at G, and 1 (the launch is
// cooperative).
extern "C" int stt_intrinsic_dp_large_info(int is_double, int G, int R, int E, int mode,
                                           int* out) {
  if (G < 2 || R < 1 || E < 0 || mode < MODE_UNIFORM || mode > MODE_CUBIC)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_double ? large_info<double>(G, R, E, mode, out)
                   : large_info<float>(G, R, E, mode, out);
}
