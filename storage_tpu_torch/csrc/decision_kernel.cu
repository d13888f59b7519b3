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
// arithmetic (~G·(2D + (D−1)·B + B) flops per sim) is far below the card's
// rate.
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
// Design:
//   * one thread per sim column, 128 sims per block; every (g, d) reads the two
//     v rows it interpolates, so neighbouring threads read neighbouring words
//     (coalesced) and no [G, D, S] intermediate touches device memory;
//   * the step tables (dci, a, b, idx_lo, w_hi) go to shared memory once per
//     block (decision_step.cuh, as kernel D); they are the only part of
//     shared memory that grows with G.  Past the grid whose tables fit
//     (1,434 points at D=3, B=9 on an H100) the large route brings them a
//     tile of grid points at a time into the same buffer, a barrier before
//     and after each tile, and runs the same chunk loop over each tile: the
//     same arithmetic in the same order, so the same bits, and any G.  The
//     wrapper picks the route and the tile from the shape
//     (ops/decision_kernel.py moments_route);
//   * the design rows are built entry by entry with rolled loops, in
//     stt::design_row's arithmetic: step t's through the thread's column of
//     the design tile into registers, then step t−1's into that column;
//   * the grid loop is kernel D's, in chunks of kChunk grid points; each
//     decision goes to best_out and to a static [kChunk, 128] tile, which the
//     compiler knows is not the tables.  After a chunk the block reduces the
//     tile against step t−1's design tile [B, 128]: thread (row r, slice q)
//     sums 8 of the block's sims of row r against all B columns from float4
//     reads, and the 16 slices of a row combine by a fixed butterfly.  XᵀX
//     comes from the design tile the same way.  Shared memory is
//     4·(B·128 + kChunk·128 + 39·G) bytes at D=3: 24,304 at G=100, B=9;
//   * registers are capped for 9 blocks (36 warps) per SM, more than kernel
//     D's 7: more warps keep more v gathers in flight than the few spilled
//     registers cost;
//   * each block writes its partial moments as one contiguous row of
//     partials [nblk, B·B + G·B]; a second kernel sums the rows in a fixed
//     order — no float atomics, the same bits on every run;
//   * best_act goes to a separate buffer (the caller ping-pongs two), never
//     over v: a later g of the same column still reads rows an in-place write
//     would already have replaced.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "decision_step.cuh"

namespace {

constexpr int kThreads = 128;                 // sims per block, one thread each
constexpr int kChunk = 8;                     // grid points per staged chunk
constexpr int kSlices = kThreads / kChunk;    // threads that share one tile row
constexpr int kMinBlocks = 9;                 // blocks per SM the registers must allow
constexpr int kReduceRows = 32;               // partial rows summed per column thread

// Dynamic shared memory of the kernel in floats: the design tile, then the
// step tables (the best_act tile is static).
__host__ __device__ inline size_t smem_fixed_words(int B) {
  return static_cast<size_t>(B) * kThreads;
}
__host__ __device__ inline size_t smem_words_per_grid_point(int D, int B) {
  return stt::decision_tables_words(1, D, B);
}

// Entry b of sim s's standardised design row: stt::design_row's arithmetic
// (common.cuh) — the spot power, then the factor powers by index, each
// product rounded on its own — with its loops rolled, so that the kernel's
// code stays small.
__device__ __forceinline__ float design_entry(const stt::Basis& basis, int b, float spot,
                                              const float* __restrict__ factors, int S, int s,
                                              const float* mean, const float* stdv) {
  float x = 1.0f;
  const int sp = basis.pows[b][0];
  if (sp) x = __fmul_rn(x, stt::ipow(spot, sp));
#pragma unroll 1
  for (int f = 0; f < basis.nf; ++f) {
    const int fp = basis.pows[b][1 + f];
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
  // its stores do not touch the step tables and can keep the next decisions'
  // loads in flight across them.
  __shared__ __align__(16) float best_tile[kChunk * kThreads];
  extern __shared__ __align__(16) float smem[];
  float* dmp_tile = smem;                       // [B, kThreads]
  const stt::DecisionTables tab = stt::load_decision_tables(
      smem + smem_fixed_words(B), G, D, B, dci_g, a_g, b_g, w_hi_g, idx_lo_g);

  const int tid = threadIdx.x;
  const int col = static_cast<int>(blockIdx.x) * kThreads + tid;
  const bool valid = col < S;
  // The columns past S compute on column S − 1 and count as zeros: no
  // branch around the decisions.
  const int s = min(col, S - 1);
  // Step t's design row goes through this thread's column of the design tile
  // into registers, for the decisions; then step t−1's, standardised by
  // (mean_prev, std_prev), takes the column (each thread touches its own
  // column only, so no barrier between).
#pragma unroll 1
  for (int k = 0; k < B; ++k)
    dmp_tile[k * kThreads + tid] = design_entry(basis, k, spot[s], factors, S, s, mean, stdv);
  float dm[stt::kMaxB];
#pragma unroll
  for (int k = 0; k < stt::kMaxB; ++k) dm[k] = k < B ? dmp_tile[k * kThreads + tid] : 0.0f;
  const float sp = spot[s];
#pragma unroll 1
  for (int k = 0; k < B; ++k) {
    const float x = design_entry(basis, k, spot_prev[s], factors_prev, S, s, mean_prev, std_prev);
    dmp_tile[k * kThreads + tid] = valid ? x : 0.0f;
  }
  __syncthreads();

  // This block's row of partials: XᵀX, then (Xᵀ·best_act)ᵀ as [G, B].
  float* row = partials + static_cast<size_t>(blockIdx.x) * (B * B + G * B);
  for (int r0 = 0; r0 < B; r0 += kChunk)
    tile_product(dmp_tile + r0 * kThreads, min(kChunk, B - r0), dmp_tile, B, row + r0 * B);
  row += B * B;

  for (int g0 = 0; g0 < G; g0 += kChunk) {
    const int rows = min(kChunk, G - g0);
    for (int i = 0; i < rows; ++i) {
      const float best = stt::decide(tab, G, D, B, g0 + i, v, S, s, sp, dm);
      if (valid) best_out[static_cast<size_t>(g0 + i) * S + s] = best;
      best_tile[i * kThreads + tid] = valid ? best : 0.0f;
    }
    __syncthreads();
    tile_product(best_tile, rows, dmp_tile, B, row + g0 * B);
    __syncthreads();  // the tile is rewritten by the next chunk
  }
}

// The large route: decision_moments_kernel with the step tables `tile`
// (< G) grid points at a time in the same buffer, the same chunk loop over
// each tile's grid points (its arithmetic, so its bits).  A kernel of its
// own, so that the shared route's launch keeps its compiled code: one body
// for both (a template, or `tile` read at run time) compiled the shared
// route to other spills and slowed it at the headline (PERF.md, PR 17).
__global__ void __launch_bounds__(kThreads, kMinBlocks) decision_moments_tiled_kernel(
    int G, int tile, int S, int D, stt::Basis basis,
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
  // its stores do not touch the step tables and can keep the next decisions'
  // loads in flight across them.
  __shared__ __align__(16) float best_tile[kChunk * kThreads];
  extern __shared__ __align__(16) float smem[];
  float* dmp_tile = smem;                       // [B, kThreads]
  // The first tile's tables (min(tile, G) = tile here, but this form
  // compiles with fewer spills: 32 bytes against 80 in ptxas's report).
  stt::DecisionTables tab = stt::load_decision_tile(smem + smem_fixed_words(B), G, 0,
                                                    min(tile, G), D, B, dci_g, a_g, b_g, w_hi_g,
                                                    idx_lo_g);

  const int tid = threadIdx.x;
  const int col = static_cast<int>(blockIdx.x) * kThreads + tid;
  const bool valid = col < S;
  // The columns past S compute on column S − 1 and count as zeros: no
  // branch around the decisions.
  const int s = min(col, S - 1);
  // Step t's design row goes through this thread's column of the design tile
  // into registers, for the decisions; then step t−1's, standardised by
  // (mean_prev, std_prev), takes the column (each thread touches its own
  // column only, so no barrier between).
#pragma unroll 1
  for (int k = 0; k < B; ++k)
    dmp_tile[k * kThreads + tid] = design_entry(basis, k, spot[s], factors, S, s, mean, stdv);
  float dm[stt::kMaxB];
#pragma unroll
  for (int k = 0; k < stt::kMaxB; ++k) dm[k] = k < B ? dmp_tile[k * kThreads + tid] : 0.0f;
  const float sp = spot[s];
#pragma unroll 1
  for (int k = 0; k < B; ++k) {
    const float x = design_entry(basis, k, spot_prev[s], factors_prev, S, s, mean_prev, std_prev);
    dmp_tile[k * kThreads + tid] = valid ? x : 0.0f;
  }
  __syncthreads();

  // This block's row of partials: XᵀX, then (Xᵀ·best_act)ᵀ as [G, B].
  float* row = partials + static_cast<size_t>(blockIdx.x) * (B * B + G * B);
  for (int r0 = 0; r0 < B; r0 += kChunk)
    tile_product(dmp_tile + r0 * kThreads, min(kChunk, B - r0), dmp_tile, B, row + r0 * B);
  row += B * B;

  for (int t0 = 0; t0 < G; t0 += tile) {
    const int nt = min(tile, G - t0);
    if (t0 > 0) {
      // Every thread is past the last tile's tables (the chunk loop ends
      // on a barrier): the next tile takes their place.
      tab = stt::load_decision_tile(smem + smem_fixed_words(B), G, t0, nt, D, B, dci_g, a_g,
                                    b_g, w_hi_g, idx_lo_g);
      __syncthreads();
    }
    for (int c0 = 0; c0 < nt; c0 += kChunk) {
      const int rows = min(kChunk, nt - c0);
      const size_t g0 = static_cast<size_t>(t0) + c0;
      for (int i = 0; i < rows; ++i) {
        const float best = stt::decide(tab, nt, D, B, c0 + i, v, S, s, sp, dm);
        if (valid) best_out[(g0 + i) * S + s] = best;
        best_tile[i * kThreads + tid] = valid ? best : 0.0f;
      }
      __syncthreads();
      tile_product(best_tile, rows, dmp_tile, B, row + g0 * B);
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
  const size_t smem =
      sizeof(float) * (smem_fixed_words(B) + smem_words_per_grid_point(D, B) * tile);
  cudaError_t err;
  if (tile < G) {
    err = cudaFuncSetAttribute(decision_moments_tiled_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    decision_moments_tiled_kernel<<<nblk, kThreads, smem, stream>>>(
        G, tile, S, D, basis, v, spot, factors, spot_prev, factors_prev, mean, stdv,
        mean_prev, std_prev, idx_lo, w_hi, dci, a, b, best_out, partials);
  } else {
    err = cudaFuncSetAttribute(decision_moments_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    decision_moments_kernel<<<nblk, kThreads, smem, stream>>>(
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
// kernel_info), for the shared route (all G grid points' tables at once: its
// max_grid is the largest G that route takes); the wrappers size the
// partials by its sims per block.
extern "C" int stt_decision_update_moments_info(int G, int D, int B, int* out) {
  if (G < 0 || D < 1 || B < 1 || B > stt::kMaxB) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(stt::kernel_info(decision_moments_kernel, kThreads, smem_fixed_words(B),
                                           smem_words_per_grid_point(D, B), G, out));
}
