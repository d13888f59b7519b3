// Kernel B: one backward LSMC step — the decision update plus the regression
// moments of the next step.
//
// Replaces the TPU kernel storage_tpu/ops/decision_kernel.py:
// decision_update_moments_pallas (_kernel_moments).  For every inventory grid
// point g and sim s it takes the decision whose REGRESSED value is largest
// (strict >, decision 0 first, so ties keep the earlier decision) and realises
// its ACTUAL value:
//   actual continuation   v[lo, s]·(1 − w) + v[lo + 1, s]·w   (lo, w per (g, d))
//   regressed gap         Σ_b dci[d, g, b]·dm[b, s]            (dci = ci − ci[0])
//   immediate value       a[d, g]·spot[s] + b[d, g]
// and accumulates step t−1's XᵀX [B, B] and (Xᵀ·best_act)ᵀ [G, B] in the
// coordinates standardised by (mean_prev, std_prev) — the TPU kernel's
// u-coordinates when those are this step's (mean, std).
//
// Bound on the H100: device memory.  Per step it must read the value panel v
// [G, S] and write best_act [G, S] (210 MB at G=100, S=262,144, D=3, B=9,
// F=3, with two steps' spot and factors: 0.0651 ms at 3.35 TB/s); the
// decision loop is unfused, and its issue slots (the argmax's products,
// sums, compares and selects, the winner's interpolation, the addresses)
// with the moments' FMAs come to 0.0585 ms (chip_smoke.decision_work).
//
// What held the first design back (tools/torch_decision_probe.py at those
// shapes on an NVIDIA H100 80GB HBM3, 700.00 W): not its moments epilogue —
// with the 981 serial 128-term dot products per block compiled out it took
// 0.929 ms against 0.935 — but
//   * occupancy: the [G, 129] best_act tile took a block to 72 KB of shared
//     memory, 3 blocks (12 warps) per SM; kernel D, the same decision loop at
//     7 blocks, slows from 0.317 to 0.583 ms when padded to that size;
//   * code size: the two design rows, unrolled over every (term, factor)
//     pair of a runtime basis, were ~20,000 of the kernel's ~21,000
//     instructions, fetched anew by every block (kernel D reads its design
//     from memory in ~700);
//   * a best_act store into shared memory at every g, which the compiler
//     cannot move past the next g's table reads (both shared memory).
//
// The moments' redesign kept that design's decision loop: 2D = 6 dependent
// gathers of v per sim and grid point, one grid point at a time — 0.379 of
// its 0.438 ms a step, the rest the moment products
// (tools/torch_decision_probe.py, PERF.md).
//
// Design:
//   * one thread per sim column, 128 sims per block; the decision loop is
//     decision_step.cuh's, kernel D's (which keeps its own copy): per group
//     of kGroup grid points the argmax first, on the regressed values from
//     the step's records alone, then only the winner's two rows of v,
//     through L1 — 2 reads per sim and grid point, not 2D, and kGroup
//     chains in flight.  Neighbouring threads read neighbouring words
//     (coalesced) and no [G, D, S] intermediate touches device memory;
//   * the step's records ({a, b, w_hi, idx_lo} per decision, the centred
//     coefficients padded to whole float4s) go to shared memory once per
//     block; they are the only part of shared memory that grows with G.
//     Past the grid whose records fit (1,553 points at D=3, B=9 on an H100)
//     the large route repacks them a tile of grid points at a time into the
//     same buffer, a barrier before and after each tile, and runs the same
//     chunk loop over each tile: the same arithmetic in the same order, so
//     the same bits, and any G.  The wrapper picks the route and the tile
//     from the shape (ops/decision_kernel.py moments_route);
//   * each kernel is compiled per basis size padded to a multiple of 4 (4,
//     8, 12, 16), so that the design row and the coefficients are unrolled
//     over registers; the padded terms add 0·0 to a regressed value, which
//     moves no argmax;
//   * the design rows are built entry by entry with rolled loops, in
//     stt::design_row's arithmetic: step t's through the thread's column of
//     the design tile into registers, then step t−1's into that column;
//   * the grid loop runs in chunks of kChunk grid points; each decision goes
//     to best_out and to a static [kChunk, 128] tile, which the compiler
//     knows is not the records.  After a chunk the block reduces the tile
//     against step t−1's design tile [B, 128]: thread (row r, slice q) sums
//     8 of the block's sims of row r against all B columns from float4
//     reads, and the 16 slices of a row combine by a fixed butterfly.  XᵀX
//     comes from the design tile the same way;
//   * registers are capped for kMinBlocks = 9 blocks (36 warps) per SM: more
//     warps keep more reads of v in flight than the few spilled registers
//     cost (7 blocks was slower, and so were groups of 2 or 8 grid points
//     and one 16-term kernel for every B: tools/torch_decision_probe.py);
//   * each block writes its partial moments as one contiguous row of
//     partials [nblk, B·B + G·B]; a second kernel sums the rows in a fixed
//     order — no float atomics, the same bits on every run;
//   * best_act goes to a separate buffer (the caller ping-pongs two), never
//     over v: a later g of the same column still reads rows an in-place write
//     would already have replaced;
//   * the wide route, which kernel B (stt_decision_update_moments_wide) and
//     kernel E launch past the caps (16 terms, 8 factors), as the JAX
//     package's kernel takes any monomial basis, takes any F, one kernel
//     for both grid routes: the tiled
//     kernel on a stt::WideBasis (the powers staged from a device table
//     into shared memory after the records), so the sim's design row is a
//     RegisterRow and the moments run at compile-time width, compiled per
//     padded basis size up to stt::kMaxWideRegB = 32 terms; past that its
//     shared row (decision_moments_wide_kernel: step t's design rows [Bp,
//     128] in shared memory, the gaps read from them 4 terms at a time, the
//     moments at run-time width), up to 64.  The same arithmetic in the same
//     order, so the register route's bits wherever two run (B = 9 forced
//     onto either).  The register row's registers are capped by padded size
//     (kWideRegMinBlocks: 8 blocks per SM up to 16 terms, 64 registers; 6
//     past them, 80), the shared row's for kWideMinBlocks = 8; of caps for
//     5 to 9 blocks, 8 was fastest at 13 terms on 10 factors and 6 at 20
//     and 32 terms on 3 (G = 100 and 1,000: tools/torch_decision_probe.py
//     --wide --variants regcap5 ..., PERF.md).
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "common.cuh"
#include "decision_step.cuh"

namespace {

constexpr int kThreads = 128;                 // sims per block, one thread each
constexpr int kChunk = 8;                     // grid points per staged chunk
constexpr int kGroup = 4;                     // grid points decided together
constexpr int kSlices = kThreads / kChunk;    // threads that share one tile row
constexpr int kMinBlocks = 9;                 // blocks per SM the registers must allow
constexpr int kWideMinBlocks = 8;             // the same, on the wide route's shared row
// The same on the wide route's register row, by padded basis size: up to
// 16 terms, and past 16 (to stt::kMaxWideRegB).
constexpr int kWideRegMinBlocks[2] = {8, 6};
constexpr int kReduceRows = 32;               // partial rows summed per column thread
static_assert(kChunk % kGroup == 0, "a chunk holds whole groups");

// Blocks per SM a register-row kernel's registers are capped for: the
// register route's kMinBlocks, the wide route's kWideRegMinBlocks.
template <typename BasisT>
constexpr int min_blocks(int Bp) {
  if constexpr (std::is_same_v<BasisT, stt::Basis>)
    return kMinBlocks;
  else
    return kWideRegMinBlocks[Bp <= 16 ? 0 : 1];
}

// The powers of a wide basis staged from device memory into `smem`, at
// warp-uniform addresses for every design entry (the caller synchronises
// before reading them).
__device__ __forceinline__ stt::WideBasis staged(const stt::WideBasis& basis, void* smem) {
  int8_t* pows = static_cast<int8_t*>(smem);
  for (int i = threadIdx.x; i < basis.nb * (basis.nf + 1); i += blockDim.x)
    pows[i] = basis.pows[i];
  return {pows, basis.nb, basis.nf};
}

// Dynamic shared memory of the kernel in floats: the design tile, then the
// step's records, record_words(D, Bp) a grid point (the best_act tile is
// static).
__host__ __device__ inline size_t smem_fixed_words(int B) {
  return static_cast<size_t>(B) * kThreads;
}

// Entry b of sim s's standardised design row: stt::design_row's arithmetic
// (common.cuh) — the spot power, then the factor powers by index, each
// product rounded on its own — with its loops rolled, so that the kernel's
// code stays small.  On the register routes' stt::Basis or the wide route's
// stt::WideBasis: the same arithmetic, so the same entries.
template <typename BasisT>
__device__ __forceinline__ float design_entry(const BasisT& basis, int b, float spot,
                                              const float* __restrict__ factors, int S, int s,
                                              const float* mean, const float* stdv) {
  float x = 1.0f;
  const int sp = stt::power_of(basis, b, 0);
  if (sp) x = __fmul_rn(x, stt::ipow(spot, sp));
#pragma unroll 1
  for (int f = 0; f < basis.nf; ++f) {
    const int fp = stt::power_of(basis, b, 1 + f);
    if (fp) x = __fmul_rn(x, stt::ipow(factors[static_cast<size_t>(f) * S + s], fp));
  }
  return __fdiv_rn(__fsub_rn(x, mean[b]), stdv[b]);
}

// out[r·B + b] = Σ over the block's sims of x[r, sim]·dmp[b, sim], for the
// rows r < nrows of a [kChunk, kThreads] tile x.  Thread (r, q) sums sims
// 4q..4q+3 and 64 + 4q..64 + 4q+3 in that order, the kSlices threads of row r
// combine by a fixed butterfly, and thread q < B of the row writes column q.
__device__ __forceinline__ void tile_product(const float* x, int nrows, const float* dmp,
                                             int B, float* __restrict__ out) {
  const int r = threadIdx.x / kSlices;
  const int q = threadIdx.x % kSlices;
  float acc[stt::kMaxB];
#pragma unroll
  for (int b = 0; b < stt::kMaxB; ++b) acc[b] = 0.0f;
#pragma unroll
  for (int j = 0; j < kThreads / (4 * kSlices); ++j) {
    const int k = 4 * q + 4 * kSlices * j;
    // (Rows past nrows repeat the last one: their sums are not written.)
    const float4 xv = *reinterpret_cast<const float4*>(x + min(r, nrows - 1) * kThreads + k);
#pragma unroll
    for (int b = 0; b < stt::kMaxB; ++b) {
      if (b < B) {
        const float4 dv = *reinterpret_cast<const float4*>(dmp + b * kThreads + k);
        acc[b] = fmaf(xv.x, dv.x, acc[b]);
        acc[b] = fmaf(xv.y, dv.y, acc[b]);
        acc[b] = fmaf(xv.z, dv.z, acc[b]);
        acc[b] = fmaf(xv.w, dv.w, acc[b]);
      }
    }
  }
  float mine = 0.0f;
#pragma unroll
  for (int b = 0; b < stt::kMaxB; ++b) {
    if (b < B) {
#pragma unroll
      for (int off = kSlices / 2; off > 0; off >>= 1)
        acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
      if (b == q) mine = acc[b];
    }
  }
  if (r < nrows && q < B) out[r * B + q] = mine;
}

// tile_product past kMaxB columns (the wide route): the columns in groups of
// kSlices, each column's sum formed as tile_product forms it (the same
// products in the same order and the same butterfly, so the same bits), and
// thread q of a row writes the group's column q.  kCols is the most columns
// compiled for (the groups unrolled, the last cut to the columns left), 0
// for B at run time.  (tile_product folded in as its one-group case gave
// kernel B's shared kernel 4% more SASS instructions and 3% more time,
// PERF.md.)
template <int kCols>
__device__ __forceinline__ void tile_product_wide(const float* x, int nrows, const float* dmp,
                                                  int B, float* __restrict__ out) {
  const int r = threadIdx.x / kSlices;
  const int q = threadIdx.x % kSlices;
  // (Rows past nrows repeat the last one: their sums are not written.)
  const float* xr = x + min(r, nrows - 1) * kThreads;
#pragma unroll
  for (int b0 = 0; b0 < (kCols ? kCols : B); b0 += kSlices) {
    const int nb = min(kCols ? min(kSlices, kCols - b0) : kSlices, B - b0);
    float acc[kSlices];
#pragma unroll
    for (int b = 0; b < kSlices; ++b) acc[b] = 0.0f;
#pragma unroll
    for (int j = 0; j < kThreads / (4 * kSlices); ++j) {
      const int k = 4 * q + 4 * kSlices * j;
      const float4 xv = *reinterpret_cast<const float4*>(xr + k);
#pragma unroll
      for (int b = 0; b < kSlices; ++b) {
        if (b < nb) {
          const float4 dv = *reinterpret_cast<const float4*>(dmp + (b0 + b) * kThreads + k);
          acc[b] = fmaf(xv.x, dv.x, acc[b]);
          acc[b] = fmaf(xv.y, dv.y, acc[b]);
          acc[b] = fmaf(xv.z, dv.z, acc[b]);
          acc[b] = fmaf(xv.w, dv.w, acc[b]);
        }
      }
    }
    float mine = 0.0f;
#pragma unroll
    for (int b = 0; b < kSlices; ++b) {
      if (b < nb) {
#pragma unroll
        for (int off = kSlices / 2; off > 0; off >>= 1)
          acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
        if (b == q) mine = acc[b];
      }
    }
    if (r < nrows && q < nb) out[r * B + b0 + q] = mine;
  }
}

// The moments of a register-row kernel compiled for Bp terms: tile_product
// within kMaxB, tile_product_wide<Bp> past it.
template <int Bp>
__device__ __forceinline__ void tile_moments(const float* x, int nrows, const float* dmp, int B,
                                             float* __restrict__ out) {
  if constexpr (Bp <= stt::kMaxB)
    tile_product(x, nrows, dmp, B, out);
  else
    tile_product_wide<Bp>(x, nrows, dmp, B, out);
}

// Step t's design row, in registers, for the decisions, and step t−1's,
// standardised by (mean_prev, std_prev), in this thread's column of the
// design tile (each thread touches its own column only, so no barrier
// between).  The columns past S compute on column S − 1 and count as zeros.
// On the register route's stt::Basis or a staged stt::WideBasis.
template <int Bp, typename BasisT>
__device__ __forceinline__ stt::RegisterRow<Bp> design_rows(
    const BasisT& basis, float* dmp_tile, int s, bool valid, int S,
    const float* __restrict__ spot, const float* __restrict__ factors,
    const float* __restrict__ spot_prev, const float* __restrict__ factors_prev,
    const float* __restrict__ mean, const float* __restrict__ stdv,
    const float* __restrict__ mean_prev, const float* __restrict__ std_prev) {
  const int B = basis.nb;
  const int tid = threadIdx.x;
#pragma unroll 1
  for (int k = 0; k < B; ++k)
    dmp_tile[k * kThreads + tid] = design_entry(basis, k, spot[s], factors, S, s, mean, stdv);
  stt::RegisterRow<Bp> dm;
#pragma unroll
  for (int k = 0; k < Bp; ++k) dm.dm[k] = k < B ? dmp_tile[k * kThreads + tid] : 0.0f;
#pragma unroll 1
  for (int k = 0; k < B; ++k) {
    const float x = design_entry(basis, k, spot_prev[s], factors_prev, S, s, mean_prev, std_prev);
    dmp_tile[k * kThreads + tid] = valid ? x : 0.0f;
  }
  return dm;
}

// The rows grid points of a chunk whose records are entries first.. of tab
// (of a tile whose last entry is `last`): each decision to best_out, from
// grid point g0 of the step, and to the best_act tile.
// `dm` is the sim's design row of padded size bp (decision_step.cuh: a
// RegisterRow, or the wide route's SharedRow).
template <typename Row>
__device__ __forceinline__ void decide_chunk(const float* tab, int first, int rows, int last,
                                             size_t g0, int D, int bp, const float* __restrict__ v,
                                             int S, int s, bool valid, float sp, const Row& dm,
                                             float* __restrict__ best_out, float* best_tile) {
#pragma unroll
  for (int c = 0; c < kChunk; c += kGroup) {
    if (c < rows) {
      float best[kGroup];
      stt::decide_group<kGroup>(tab, first + c, last, D, bp, v, S, s, sp, dm, best);
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (c + i < rows) {
          if (valid) best_out[(g0 + c + i) * S + s] = best[i];
          best_tile[(c + i) * kThreads + threadIdx.x] = valid ? best[i] : 0.0f;
        }
      }
    }
  }
}

template <int Bp>
__global__ void __launch_bounds__(kThreads, kMinBlocks) decision_moments_kernel(
    int G, int S, int D, stt::Basis basis,
    const float* __restrict__ v, const float* __restrict__ spot,
    const float* __restrict__ factors, const float* __restrict__ spot_prev,
    const float* __restrict__ factors_prev, const float* __restrict__ mean,
    const float* __restrict__ stdv, const float* __restrict__ mean_prev,
    const float* __restrict__ std_prev, const int* __restrict__ idx_lo_g,
    const float* __restrict__ w_hi_g, const float* __restrict__ dci_g,
    const float* __restrict__ a_g, const float* __restrict__ b_g,
    float* __restrict__ best_out, float* __restrict__ partials) {
  const int B = basis.nb;
  // The best_act tile is an array of its own, so that the compiler knows
  // its stores do not touch the records and can keep the next decisions'
  // loads in flight across them.
  __shared__ __align__(16) float best_tile[kChunk * kThreads];
  extern __shared__ __align__(16) float smem[];
  float* dmp_tile = smem;                       // [B, kThreads]
  float* tab = smem + smem_fixed_words(B);      // [G] records
  stt::load_records(tab, G, 0, G, D, B, Bp, idx_lo_g, w_hi_g, dci_g, a_g, b_g);

  const int col = static_cast<int>(blockIdx.x) * kThreads + threadIdx.x;
  const bool valid = col < S;
  const int s = min(col, S - 1);
  const stt::RegisterRow<Bp> dm = design_rows<Bp>(basis, dmp_tile, s, valid, S, spot, factors,
                                                  spot_prev, factors_prev, mean, stdv,
                                                  mean_prev, std_prev);
  const float sp = spot[s];
  __syncthreads();

  // This block's row of partials: XᵀX, then (Xᵀ·best_act)ᵀ as [G, B].
  float* row = partials + static_cast<size_t>(blockIdx.x) * (B * B + G * B);
  for (int r0 = 0; r0 < B; r0 += kChunk)
    tile_moments<Bp>(dmp_tile + r0 * kThreads, min(kChunk, B - r0), dmp_tile, B, row + r0 * B);
  row += B * B;

  for (int g0 = 0; g0 < G; g0 += kChunk) {
    const int rows = min(kChunk, G - g0);
    decide_chunk(tab, g0, rows, G - 1, g0, D, Bp, v, S, s, valid, sp, dm, best_out, best_tile);
    __syncthreads();
    tile_moments<Bp>(best_tile, rows, dmp_tile, B, row + g0 * B);
    __syncthreads();  // the tile is rewritten by the next chunk
  }
}

// The register row's kernel at `tile` grid points a tile: kernel B's large
// route (tile < G: decision_moments_kernel with the records `tile` grid
// points at a time in the same buffer, the same chunk loop over each tile's
// grid points, its arithmetic, so its bits) on the register route's
// stt::Basis, and kernel E's wide body (any tile) on a stt::WideBasis, its
// powers staged in shared memory after the records.  A kernel of its own,
// so that the shared route's launch keeps its compiled code: one body for
// both (a template, or `tile` read at run time) compiled the shared route
// to other spills and slowed it at the headline (PERF.md).
template <int Bp, typename BasisT>
__global__ void __launch_bounds__(kThreads, min_blocks<BasisT>(Bp)) decision_moments_tiled_kernel(
    int G, int tile, int S, int D, BasisT basis,
    const float* __restrict__ v, const float* __restrict__ spot,
    const float* __restrict__ factors, const float* __restrict__ spot_prev,
    const float* __restrict__ factors_prev, const float* __restrict__ mean,
    const float* __restrict__ stdv, const float* __restrict__ mean_prev,
    const float* __restrict__ std_prev, const int* __restrict__ idx_lo_g,
    const float* __restrict__ w_hi_g, const float* __restrict__ dci_g,
    const float* __restrict__ a_g, const float* __restrict__ b_g,
    float* __restrict__ best_out, float* __restrict__ partials) {
  const int B = basis.nb;
  __shared__ __align__(16) float best_tile[kChunk * kThreads];
  extern __shared__ __align__(16) float smem[];
  float* dmp_tile = smem;                       // [B, kThreads]
  float* tab = smem + smem_fixed_words(B);      // [tile] records
  stt::load_records(tab, G, 0, min(tile, G), D, B, Bp, idx_lo_g, w_hi_g, dci_g, a_g, b_g);
  if constexpr (std::is_same_v<BasisT, stt::WideBasis>) {
    basis = staged(basis, tab + static_cast<size_t>(tile) * stt::record_words(D, Bp));
    __syncthreads();  // the powers, before any design entry
  }

  const int col = static_cast<int>(blockIdx.x) * kThreads + threadIdx.x;
  const bool valid = col < S;
  const int s = min(col, S - 1);
  const stt::RegisterRow<Bp> dm = design_rows<Bp>(basis, dmp_tile, s, valid, S, spot, factors,
                                                  spot_prev, factors_prev, mean, stdv,
                                                  mean_prev, std_prev);
  const float sp = spot[s];
  __syncthreads();

  // This block's row of partials: XᵀX, then (Xᵀ·best_act)ᵀ as [G, B].
  float* row = partials + static_cast<size_t>(blockIdx.x) * (B * B + G * B);
  for (int r0 = 0; r0 < B; r0 += kChunk)
    tile_moments<Bp>(dmp_tile + r0 * kThreads, min(kChunk, B - r0), dmp_tile, B, row + r0 * B);
  row += B * B;

  for (int t0 = 0; t0 < G; t0 += tile) {
    const int nt = min(tile, G - t0);
    if (t0 > 0) {
      // Every thread is past the last tile's records (the chunk loop ends
      // on a barrier): the next tile takes their place.
      stt::load_records(tab, G, t0, nt, D, B, Bp, idx_lo_g, w_hi_g, dci_g, a_g, b_g);
      __syncthreads();
    }
    for (int c0 = 0; c0 < nt; c0 += kChunk) {
      const int rows = min(kChunk, nt - c0);
      const size_t g0 = static_cast<size_t>(t0) + c0;
      decide_chunk(tab, c0, rows, nt - 1, g0, D, Bp, v, S, s, valid, sp, dm, best_out,
                   best_tile);
      __syncthreads();
      tile_moments<Bp>(best_tile, rows, dmp_tile, B, row + g0 * B);
      __syncthreads();  // the tile is rewritten by the next chunk
    }
  }
}

// Dynamic shared memory of kernel E's wide bodies besides their records, in
// floats: step t−1's design tile [B, kThreads], on the shared row
// (`smem_row`) step t's design rows [Bp, kThreads] too, and, after the
// records, the basis powers [B, F + 1] int8 in whole words.
__host__ __device__ inline size_t wide_fixed_words(int B, int F, bool smem_row) {
  return static_cast<size_t>(B + (smem_row ? stt::padded_basis(B) : 0)) * kThreads +
         (static_cast<size_t>(B) * (F + 1) + 3) / 4;
}

// The wide route's shared row: kernel B's body for any basis size B and
// factor count F (past the register row's stt::kMaxWideRegB terms), one
// kernel for both grid routes (tile >= G: all of a step's records at
// once; else `tile` grid points at a time, as the tiled kernel).  The powers
// come from device memory and are staged in shared memory; step t's design
// rows go to shared memory beside step t−1's tile, one column a thread, in
// place of RegisterRow; the gaps are read from them 4 terms at a time
// (SharedRow), and the moments are summed a group of kSlices columns at a
// time (tile_product_wide at run-time width).  Every entry, gap, decision and
// sum is the register route's arithmetic in its order: the same bits at any
// shape both take.
__global__ void __launch_bounds__(kThreads, kWideMinBlocks) decision_moments_wide_kernel(
    int G, int tile, int S, int D, int B, int F, const int8_t* __restrict__ pows_g,
    const float* __restrict__ v, const float* __restrict__ spot,
    const float* __restrict__ factors, const float* __restrict__ spot_prev,
    const float* __restrict__ factors_prev, const float* __restrict__ mean,
    const float* __restrict__ stdv, const float* __restrict__ mean_prev,
    const float* __restrict__ std_prev, const int* __restrict__ idx_lo_g,
    const float* __restrict__ w_hi_g, const float* __restrict__ dci_g,
    const float* __restrict__ a_g, const float* __restrict__ b_g,
    float* __restrict__ best_out, float* __restrict__ partials) {
  const int Bp = stt::padded_basis(B);
  const int rec = stt::record_words(D, Bp);
  const int tid = threadIdx.x;
  __shared__ __align__(16) float best_tile[kChunk * kThreads];
  extern __shared__ __align__(16) float smem[];
  float* dmp_tile = smem;                         // [B, kThreads]: step t−1
  float* dm_tile = dmp_tile + B * kThreads;       // [Bp, kThreads]: step t
  float* tab = dm_tile + Bp * kThreads;           // [tile] records
  const stt::WideBasis basis = staged({pows_g, B, F}, tab + static_cast<size_t>(tile) * rec);
  stt::load_records(tab, G, 0, min(tile, G), D, B, Bp, idx_lo_g, w_hi_g, dci_g, a_g, b_g);
  __syncthreads();  // the powers, before any design entry

  // The two steps' design rows, as design_rows builds them, into this
  // thread's column of the two tiles (no barrier between: its own column);
  // the columns past S compute on column S − 1 and count as zeros.
  const int col = static_cast<int>(blockIdx.x) * kThreads + tid;
  const bool valid = col < S;
  const int s = min(col, S - 1);
#pragma unroll 1
  for (int k = 0; k < Bp; ++k)
    dm_tile[k * kThreads + tid] =
        k < B ? design_entry(basis, k, spot[s], factors, S, s, mean, stdv) : 0.0f;
#pragma unroll 1
  for (int k = 0; k < B; ++k) {
    const float x = design_entry(basis, k, spot_prev[s], factors_prev, S, s, mean_prev, std_prev);
    dmp_tile[k * kThreads + tid] = valid ? x : 0.0f;
  }
  const stt::SharedRow<kThreads> dm{dm_tile + tid, Bp};
  const float sp = spot[s];
  __syncthreads();

  // This block's row of partials: XᵀX, then (Xᵀ·best_act)ᵀ as [G, B].
  float* row = partials + static_cast<size_t>(blockIdx.x) * (B * B + G * B);
  for (int r0 = 0; r0 < B; r0 += kChunk)
    tile_product_wide<0>(dmp_tile + r0 * kThreads, min(kChunk, B - r0), dmp_tile, B,
                         row + r0 * B);
  row += B * B;

  for (int t0 = 0; t0 < G; t0 += tile) {
    const int nt = min(tile, G - t0);
    if (t0 > 0) {
      // Every thread is past the last tile's records (the chunk loop ends
      // on a barrier): the next tile takes their place.
      stt::load_records(tab, G, t0, nt, D, B, Bp, idx_lo_g, w_hi_g, dci_g, a_g, b_g);
      __syncthreads();
    }
    for (int c0 = 0; c0 < nt; c0 += kChunk) {
      const int rows = min(kChunk, nt - c0);
      const size_t g0 = static_cast<size_t>(t0) + c0;
      decide_chunk(tab, c0, rows, nt - 1, g0, D, Bp, v, S, s, valid, sp, dm, best_out,
                   best_tile);
      __syncthreads();
      tile_product_wide<0>(best_tile, rows, dmp_tile, B, row + g0 * B);
      __syncthreads();  // the tile is rewritten by the next chunk
    }
  }
}

// moments[k] = Σ over blocks of partials[blk, k]: thread (x, y) of a
// 32 × kReduceRows block sums rows y, y + kReduceRows, … of column
// 32·blockIdx.x + x in order, and the column's kReduceRows sums are added in
// order of y — a fixed order, so the same bits on every run.
__global__ void reduce_rows_kernel(const float* __restrict__ partials, int nrows, int ncols,
                                   float* __restrict__ moments) {
  __shared__ float sums[kReduceRows][33];
  const int k = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.0f;
  if (k < ncols) {
#pragma unroll 4
    for (int r = threadIdx.y; r < nrows; r += kReduceRows)
      acc += partials[static_cast<size_t>(r) * ncols + k];
  }
  sums[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && k < ncols) {
    float total = sums[0][threadIdx.x];
    for (int y = 1; y < kReduceRows; ++y) total += sums[y][threadIdx.x];
    moments[k] = total;
  }
}

// The two routes' kernels for basis size B (at most kMaxB = 16), compiled for
// its padded size Bp, whose records they read.
struct MomentsKernels {
  decltype(&decision_moments_kernel<4>) shared;
  decltype(&decision_moments_tiled_kernel<4, stt::Basis>) tiled;
  int bp;
};

MomentsKernels moments_kernels(int B) {
  static_assert(stt::kMaxB == 16, "one case per padded basis size");
  switch (stt::padded_basis(B)) {
    case 4: return {decision_moments_kernel<4>, decision_moments_tiled_kernel<4, stt::Basis>, 4};
    case 8: return {decision_moments_kernel<8>, decision_moments_tiled_kernel<8, stt::Basis>, 8};
    case 12: return {decision_moments_kernel<12>, decision_moments_tiled_kernel<12, stt::Basis>, 12};
    default: return {decision_moments_kernel<16>, decision_moments_tiled_kernel<16, stt::Basis>, 16};
  }
}

// Kernel E's wide route on the register row, compiled per padded basis size
// up to stt::kMaxWideRegB (none beyond: the shared row's).
using WideRegisterKernel = decltype(&decision_moments_tiled_kernel<4, stt::WideBasis>);

WideRegisterKernel wide_register_kernel(int B) {
  static_assert(stt::kMaxWideRegB == 32, "one case per padded basis size");
  switch (stt::padded_basis(B)) {
    case 4: return decision_moments_tiled_kernel<4, stt::WideBasis>;
    case 8: return decision_moments_tiled_kernel<8, stt::WideBasis>;
    case 12: return decision_moments_tiled_kernel<12, stt::WideBasis>;
    case 16: return decision_moments_tiled_kernel<16, stt::WideBasis>;
    case 20: return decision_moments_tiled_kernel<20, stt::WideBasis>;
    case 24: return decision_moments_tiled_kernel<24, stt::WideBasis>;
    case 28: return decision_moments_tiled_kernel<28, stt::WideBasis>;
    case 32: return decision_moments_tiled_kernel<32, stt::WideBasis>;
    default: return nullptr;
  }
}

}  // namespace

namespace stt {

cudaError_t launch_decision_moments(
    int G, int tile, int S, int D, const Basis& basis, const float* v, const float* spot,
    const float* factors, const float* spot_prev, const float* factors_prev,
    const float* mean, const float* stdv, const float* mean_prev,
    const float* std_prev, const int* idx_lo, const float* w_hi,
    const float* dci, const float* a, const float* b, float* best_out,
    float* partials, float* moments, cudaStream_t stream) {
  const int B = basis.nb;
  if (tile < 1) return cudaErrorInvalidValue;
  tile = min(tile, G);
  const int nblk = (S + kThreads - 1) / kThreads;
  const MomentsKernels k = moments_kernels(B);
  const size_t smem = sizeof(float) * (smem_fixed_words(B) +
                                       static_cast<size_t>(stt::record_words(D, k.bp)) * tile);
  cudaError_t err;
  if (tile < G) {
    err = cudaFuncSetAttribute(k.tiled, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    k.tiled<<<nblk, kThreads, smem, stream>>>(
        G, tile, S, D, basis, v, spot, factors, spot_prev, factors_prev, mean, stdv,
        mean_prev, std_prev, idx_lo, w_hi, dci, a, b, best_out, partials);
  } else {
    err = cudaFuncSetAttribute(k.shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    k.shared<<<nblk, kThreads, smem, stream>>>(
        G, S, D, basis, v, spot, factors, spot_prev, factors_prev, mean, stdv, mean_prev,
        std_prev, idx_lo, w_hi, dci, a, b, best_out, partials);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int ncols = B * B + G * B;
  reduce_rows_kernel<<<(ncols + 31) / 32, dim3(32, kReduceRows), 0, stream>>>(
      partials, nblk, ncols, moments);
  return cudaGetLastError();
}

cudaError_t launch_decision_moments_wide(
    int G, int tile, int S, int D, int B, int F, bool smem_row, const int8_t* pows,
    const float* v, const float* spot, const float* factors, const float* spot_prev,
    const float* factors_prev, const float* mean, const float* stdv, const float* mean_prev,
    const float* std_prev, const int* idx_lo, const float* w_hi, const float* dci,
    const float* a, const float* b, float* best_out, float* partials, float* moments,
    cudaStream_t stream) {
  const WideRegisterKernel reg = smem_row ? nullptr : wide_register_kernel(B);
  if (tile < 1 || B < 1 || F < 0 || (!smem_row && !reg)) return cudaErrorInvalidValue;
  tile = min(tile, G);
  const int nblk = (S + kThreads - 1) / kThreads;
  const size_t rec = stt::record_words(D, stt::padded_basis(B));
  const size_t smem = sizeof(float) * (wide_fixed_words(B, F, smem_row) + rec * tile);
  cudaError_t err;
  if (smem_row) {
    err = cudaFuncSetAttribute(decision_moments_wide_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    decision_moments_wide_kernel<<<nblk, kThreads, smem, stream>>>(
        G, tile, S, D, B, F, pows, v, spot, factors, spot_prev, factors_prev, mean, stdv,
        mean_prev, std_prev, idx_lo, w_hi, dci, a, b, best_out, partials);
  } else {
    err = cudaFuncSetAttribute(reg, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    reg<<<nblk, kThreads, smem, stream>>>(
        G, tile, S, D, WideBasis{pows, B, F}, v, spot, factors, spot_prev, factors_prev, mean,
        stdv, mean_prev, std_prev, idx_lo, w_hi, dci, a, b, best_out, partials);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int ncols = B * B + G * B;
  reduce_rows_kernel<<<(ncols + 31) / 32, dim3(32, kReduceRows), 0, stream>>>(
      partials, nblk, ncols, moments);
  return cudaGetLastError();
}

}  // namespace stt

// Kernel B on the tables of `tile` grid points at a time (tile >= G: the
// shared route, all at once).
extern "C" int stt_decision_update_moments(
    int G, int tile, int S, int F, int D, const int* basis_table, const void* v,
    const void* spot, const void* factors, const void* spot_prev,
    const void* factors_prev, const void* mean, const void* stdv,
    const void* mean_prev, const void* std_prev, const void* idx_lo,
    const void* w_hi, const void* dci, const void* a, const void* b,
    void* best_out, void* partials, void* moments, void* stream) {
  stt::Basis basis;
  if (!stt::make_basis(basis_table, F, &basis) || G < 2 || D < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(stt::launch_decision_moments(
      G, tile, S, D, basis, static_cast<const float*>(v),
      static_cast<const float*>(spot), static_cast<const float*>(factors),
      static_cast<const float*>(spot_prev),
      static_cast<const float*>(factors_prev), static_cast<const float*>(mean),
      static_cast<const float*>(stdv), static_cast<const float*>(mean_prev),
      static_cast<const float*>(std_prev), static_cast<const int*>(idx_lo),
      static_cast<const float*>(w_hi), static_cast<const float*>(dci),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(best_out), static_cast<float*>(partials),
      static_cast<float*>(moments), static_cast<cudaStream_t>(stream)));
}

// Kernel B's launch report at (G, D, B) on the current device (common.cuh:
// kernel_info): the shared route's with all G grid points' records (its
// max_grid is the largest G that route takes), or with `large` the large
// route's at a tile of G grid points; the wrappers size the partials by its
// sims per block.
extern "C" int stt_decision_update_moments_info(int G, int D, int B, int large, int* out) {
  if (G < 0 || D < 1 || B < 1 || B > stt::kMaxB) return static_cast<int>(cudaErrorInvalidValue);
  const MomentsKernels k = moments_kernels(B);
  const size_t fixed = smem_fixed_words(B);
  const size_t rec = stt::record_words(D, k.bp);
  return static_cast<int>(large ? stt::kernel_info(k.tiled, kThreads, fixed, rec, G, out)
                                : stt::kernel_info(k.shared, kThreads, fixed, rec, G, out));
}

// The wide route's launch report at (G, D, B, F) on the current device, of
// its register row (smem_row 0, up to stt::kMaxWideRegB terms) or its shared
// row: with all G grid points' records (its max_grid is the largest G, or
// tile, that fits), the shared route at G or the large route at a tile of G
// (one kernel).
extern "C" int stt_decision_update_moments_wide_info(int G, int D, int B, int F, int smem_row,
                                                     int* out) {
  const WideRegisterKernel reg = smem_row ? nullptr : wide_register_kernel(B);
  if (G < 0 || D < 1 || B < 1 || F < 0 || (!smem_row && !reg))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t fixed = wide_fixed_words(B, F, smem_row);
  const size_t rec = stt::record_words(D, stt::padded_basis(B));
  return static_cast<int>(smem_row
                              ? stt::kernel_info(decision_moments_wide_kernel, kThreads, fixed,
                                                 rec, G, out)
                              : stt::kernel_info(reg, kThreads, fixed, rec, G, out));
}

// Kernel B past the register caps (stt::kMaxB terms, stt::kMaxF factors):
// its wide body (launch_decision_moments_wide), the one that kernel E's wide
// route launches after its solve, on the caller's centred coefficients dci
// = ci − ci[0].  Any B up to stt::kMaxWideB and any F, the powers `pows`
// [B, F + 1] int8 in device memory; the register row up to
// stt::kMaxWideRegB padded terms, or with `smem_row` the shared row; `tile`
// as stt_decision_update_moments's.
extern "C" int stt_decision_update_moments_wide(
    int G, int tile, int S, int F, int D, int B, int smem_row, const void* pows, const void* v,
    const void* spot, const void* factors, const void* spot_prev, const void* factors_prev,
    const void* mean, const void* stdv, const void* mean_prev, const void* std_prev,
    const void* idx_lo, const void* w_hi, const void* dci, const void* a, const void* b,
    void* best_out, void* partials, void* moments, void* stream) {
  if (B < 1 || B > stt::kMaxWideB || F < 0 || !pows || G < 2 || D < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(stt::launch_decision_moments_wide(
      G, tile, S, D, B, F, smem_row != 0, static_cast<const int8_t*>(pows),
      static_cast<const float*>(v), static_cast<const float*>(spot),
      static_cast<const float*>(factors), static_cast<const float*>(spot_prev),
      static_cast<const float*>(factors_prev), static_cast<const float*>(mean),
      static_cast<const float*>(stdv), static_cast<const float*>(mean_prev),
      static_cast<const float*>(std_prev), static_cast<const int*>(idx_lo),
      static_cast<const float*>(w_hi), static_cast<const float*>(dci),
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(best_out),
      static_cast<float*>(partials), static_cast<float*>(moments),
      static_cast<cudaStream_t>(stream)));
}
