// Kernel D: the backward LSMC decision update on a precomputed standardised
// design, without moments.
//
// Replaces the TPU kernel storage_tpu/ops/decision_kernel.py:
// decision_update_pallas (_kernel).  The JAX engine runs it in its plain
// backward body, the branch taken when the panels carry no factor
// (value_from_sims on spot-only panels): there the design rows come from the
// caller's standardised design dm_std_t [B, S] instead of being built from
// spot and factors, and the regression is fitted outside the kernel, so no
// moments are accumulated.
//
// Bound on the H100: device memory.  Per step it must read v [G, S] (105 MB at
// G=100, S=262,144), dm_std_t [B, S] and spot, and write best_act [G, S]:
// about 215 MB, ~64 us at 3.35 TB/s; the arithmetic, ~G·(D·6 + (D−1)·2B) flops
// per sim, is below that at the card's f32 rate.  What held the first design
// back (0.315 ms, PERF.md) was latency: six dependent gathers of v per sim
// and grid point from device memory, one grid point at a time.  Design:
//   * The argmax runs first, on the regressed values, which need no v; then
//     only the chosen decision's two rows are read: 2 reads per sim and grid
//     point, not 2D.  They go through L1, where the rows of the few grid
//     points in flight stay: staging the block's slice of v in shared
//     memory costs blocks per SM and was 16% slower
//     (tools/torch_update_probe.py, PERF.md).
//   * The grid points go in groups of kGroup, decided together: kGroup
//     independent chains per thread.
//   * The step tables are repacked per grid point in shared memory: per
//     decision one 16-byte entry {a, b, w_hi, idx_lo}, then for d > 0 its
//     centred coefficients (dci, zero-padded to whole float4s), all read at
//     warp-uniform addresses.  Past the grid whose records fit (2,905
//     points at D=3, B=4 on an H100) the large route repacks them a tile of
//     grid points at a time into the same buffer, a barrier before and
//     after each tile, and decides each tile's grid points as above: the
//     same arithmetic, so the same bits, at any G.  The wrapper picks the
//     route and the tile from the shape (ops/decision_kernel.py
//     update_route).
//   * The kernel is compiled per basis size padded to a multiple of 4, up
//     to kMaxRegisterBasis, so the design entries and the dot products are
//     unrolled over registers (one kernel for every B, at 16 terms or with
//     a loop over B, was 32–41% slower at B=4); the padded terms add 0·0 to
//     a regressed value, which moves no argmax.  A larger basis takes the
//     wide route, one kernel for any B: each thread's design row sits in
//     shared memory after the tables, one column a thread (no bank
//     conflict), and each gap is summed 4 terms at a time over it, the same
//     products and sums in the same order.  The route is the basis size's
//     alone (update_kernel).
//   * The loop is kernel B's (decision_step.cuh decide_group; D keeps this
//     copy, which runs 8% faster at B=9 than D on B's), every product and
//     sum rounded on its own: strict >, decision 0 first, centred gaps, the
//     winner's actual value v[lo]·(1 − w) + v[lo + 1]·w plus its immediate
//     value.  So best_act is the plain version's to the bit.
//   * best_act goes to a separate buffer (the engine's spare [G, S] panel),
//     never over v: a later g of the same column still reads v rows that an
//     in-place write (the TPU's input_output_aliases) would have replaced.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // sims per block, one a thread
constexpr int kGroup = 4;      // grid points decided together
// The largest padded basis whose design row and coefficients are unrolled
// over registers; beyond it the wide route (decision_update_kernel<0>).
constexpr int kMaxRegisterBasis = 32;

__host__ __device__ inline int padded_basis(int B) { return (B + 3) & ~3; }
// Floats of one grid point's table record: {a, b, w_hi, idx_lo} per decision,
// and after each of decisions 1..D−1 its padded centred coefficients.
__host__ __device__ inline int record_words(int D, int Bp) { return 4 + (D - 1) * (4 + Bp); }
__host__ __device__ inline int record_offset(int d, int Bp) {
  return d == 0 ? 0 : 4 + (d - 1) * (4 + Bp);
}
// Floats of a block's dynamic shared memory besides the tables: the wide
// route's design rows [Bp][kThreads].
__host__ __device__ inline int row_words(int Bp) {
  return Bp > kMaxRegisterBasis ? Bp * kThreads : 0;
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

// The same row in shared memory, entry k at row[k * kThreads], of a padded
// size bp known at run time: the same products and sums in the same order,
// 4 terms at a time.
struct SharedRow {
  const float* row;
  int bp;
  __device__ __forceinline__ float gap(const float* p) const {
    float q = 0.0f;
#pragma unroll 1
    for (int k = 0; k < bp; k += 4) {
      const float4 c = *reinterpret_cast<const float4*>(p + k);
      const float* x = row + k * kThreads;
      q = k == 0 ? __fmul_rn(c.x, x[0]) : __fadd_rn(q, __fmul_rn(c.x, x[0]));
      q = __fadd_rn(q, __fmul_rn(c.y, x[kThreads]));
      q = __fadd_rn(q, __fmul_rn(c.z, x[2 * kThreads]));
      q = __fadd_rn(q, __fmul_rn(c.w, x[3 * kThreads]));
    }
    return q;
  }
};

// Repacks the records of grid points [g0, g0 + nt) of a step of G into
// tab (block-strided); the caller synchronises before reading them.
__device__ __forceinline__ void load_records(float* tab, int G, int g0, int nt, int D, int B,
                                             int bp, const int* __restrict__ idx_lo_g,
                                             const float* __restrict__ w_hi_g,
                                             const float* __restrict__ dci_g,
                                             const float* __restrict__ a_g,
                                             const float* __restrict__ b_g) {
  const int rec = record_words(D, bp);
  for (int i = threadIdx.x; i < nt * D; i += kThreads) {
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

// best_act of entries [c·kGroup, c·kGroup + kGroup) of a tile of nt grid
// points from g0 for sim s, whose spot is sp and design row dm (bp entries,
// zero beyond B).
template <typename Row>
__device__ __forceinline__ void decide_group(int c, int g0, int nt, int S, int D, int bp,
                                             const float* tab, const float* __restrict__ v, int s,
                                             bool valid, float sp, const Row& dm,
                                             float* __restrict__ best_out) {
  const int rec = record_words(D, bp);
  const float* r[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) r[i] = tab + min(c * kGroup + i, nt - 1) * rec;
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
    const int gl = c * kGroup + i;
    const float* x = v + static_cast<size_t>(best_lo[i]) * S + s;
    const float w = best_w[i];
    const float cont =
        __fadd_rn(__fmul_rn(__ldg(x), __fsub_rn(1.0f, w)), __fmul_rn(__ldg(x + S), w));
    if (gl < nt && valid)
      best_out[static_cast<size_t>(g0 + gl) * S + s] = __fadd_rn(cont, best_imm[i]);
  }
}

// Bp > 0: the design row in registers, padded to Bp; Bp == 0: the wide
// route, the row in shared memory, padded to a multiple of 4 at run time.
// The records go to shared memory `tile` grid points at a time (tile = G:
// all at once).
template <int Bp>
__global__ void __launch_bounds__(kThreads) decision_update_kernel(
    int G, int tile, int S, int D, int B, const float* __restrict__ v,
    const float* __restrict__ dm_std_t, const float* __restrict__ spot,
    const int* __restrict__ idx_lo_g, const float* __restrict__ w_hi_g,
    const float* __restrict__ dci_g, const float* __restrict__ a_g,
    const float* __restrict__ b_g, float* __restrict__ best_out) {
  extern __shared__ __align__(16) float tab[];
  const int bp = Bp > 0 ? Bp : padded_basis(B);
  const int rec = record_words(D, bp);
  load_records(tab, G, 0, min(tile, G), D, B, bp, idx_lo_g, w_hi_g, dci_g, a_g, b_g);
  // Past the end a thread decides for sim S − 1 and stores nothing.
  const int col = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = col < S;
  const int s = min(col, S - 1);
  const float sp = spot[s];
  // Every tile's grid points, the first tile's records already loading.
  auto sweep = [&](const auto& dm) {
    for (int g0 = 0; g0 < G; g0 += tile) {
      const int nt = min(tile, G - g0);
      if (g0 > 0) {
        __syncthreads();  // every thread is past the last tile's records
        load_records(tab, G, g0, nt, D, B, bp, idx_lo_g, w_hi_g, dci_g, a_g, b_g);
        __syncthreads();
      }
      const int ngroups = (nt + kGroup - 1) / kGroup;
      for (int c = 0; c < ngroups; ++c)
        decide_group(c, g0, nt, S, D, bp, tab, v, s, valid, sp, dm, best_out);
    }
  };
  if constexpr (Bp > 0) {
    RegisterRow<Bp> dm;
#pragma unroll
    for (int k = 0; k < Bp; ++k)
      dm.dm[k] = k < B ? dm_std_t[static_cast<size_t>(k) * S + s] : 0.0f;
    __syncthreads();
    sweep(dm);
  } else {
    // This thread's column of [bp][kThreads], after the tables.
    float* row = tab + min(tile, G) * rec + threadIdx.x;
    for (int k = 0; k < bp; ++k)
      row[k * kThreads] = k < B ? dm_std_t[static_cast<size_t>(k) * S + s] : 0.0f;
    const SharedRow dm{row, bp};
    __syncthreads();
    sweep(dm);
  }
}

using UpdateKernel = decltype(&decision_update_kernel<4>);

// The kernel for basis size B: compiled for its padded size up to
// kMaxRegisterBasis, the wide route beyond.
UpdateKernel update_kernel(int B) {
  static_assert(kMaxRegisterBasis == 32, "one case per padded basis size");
  switch (padded_basis(B)) {
    case 4: return decision_update_kernel<4>;
    case 8: return decision_update_kernel<8>;
    case 12: return decision_update_kernel<12>;
    case 16: return decision_update_kernel<16>;
    case 20: return decision_update_kernel<20>;
    case 24: return decision_update_kernel<24>;
    case 28: return decision_update_kernel<28>;
    case 32: return decision_update_kernel<32>;
    default: return decision_update_kernel<0>;
  }
}

}  // namespace

// Kernel D on the records of `tile` grid points at a time (tile >= G: the
// shared route, all at once).
extern "C" int stt_decision_update(
    int G, int tile, int S, int D, int B, const void* v, const void* dm_std_t,
    const void* spot, const void* idx_lo, const void* w_hi, const void* dci,
    const void* a, const void* b, void* best_out, void* stream) {
  if (G < 2 || tile < 1 || D < 1 || S < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  tile = tile < G ? tile : G;
  const UpdateKernel kernel = update_kernel(B);
  const int bp = padded_basis(B);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(tile) * record_words(D, bp) + row_words(bp));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblk = (S + kThreads - 1) / kThreads;
  kernel<<<nblk, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      G, tile, S, D, B, static_cast<const float*>(v), static_cast<const float*>(dm_std_t),
      static_cast<const float*>(spot), static_cast<const int*>(idx_lo),
      static_cast<const float*>(w_hi), static_cast<const float*>(dci),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(best_out));
  return static_cast<int>(cudaGetLastError());
}

// Kernel D's launch report at (G, D, B) on the current device (common.cuh:
// kernel_info), for the shared route (all G grid points' records at once: its
// max_grid is the largest G that route takes).
extern "C" int stt_decision_update_info(int G, int D, int B, int* out) {
  if (G < 0 || D < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int bp = padded_basis(B);
  return static_cast<int>(stt::kernel_info(update_kernel(B), kThreads, row_words(bp),
                                           record_words(D, bp), G, out));
}
