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
//   * pack_records_kernel writes every grid point's record once a step into
//     device memory ([G, record_words] floats): per decision one 16-byte
//     entry {a, b, w_hi, idx_lo}, then for d > 0 its centred coefficients
//     dci = ci − ci[0] (one f32 subtraction, the plain version's bits),
//     zero-padded to whole float4s.  It takes the place of a subtraction the
//     wrapper would launch, so a step launches two kernels, as before.
//   * A block takes a tile of `tile` grid points for its kThreads sims:
//     grid (⌈G/tile⌉, ⌈S/kThreads⌉), the tiles fastest, so that the blocks
//     of one column of sims run together and share its design rows and the
//     rows of v at their tiles' edges in L2.  It copies its tile's records
//     into shared memory with 16-byte loads, once, behind one barrier, and
//     reads them at warp-uniform addresses.  The wrapper takes one tile of
//     all G grid points while that leaves as many blocks per SM as tiles of
//     256, else tiles of 256 (ops/decision_kernel.py update_route): the
//     same arithmetic either way, so the same bits, at any G.  (Every block
//     repacking all G records itself, a tile of 256 at a time between two
//     barriers, took 3.87 / 5.28 ms at G = 4,096, B = 4 / 9 against a
//     2.57 ms bytes bound; tools/torch_grid_probe.py --ablate-d, PERF.md.)
//   * The kernel is compiled per basis size B up to kMaxRegisterBasis, the
//     design row and dot products unrolled over registers (one kernel for
//     every B, at 16 terms or with a loop over B, was 32–41% slower at B=4;
//     compiled per padded size it took 4.63 against 4.22 ms at G = 4,096,
//     B = 9).  Its registers are capped for min_blocks(padded B) blocks per
//     SM.  A larger basis takes the wide route, one kernel for any B: each
//     thread's design row sits in shared memory after the tables, one
//     column a thread (no bank conflict), and each gap is summed 4 terms at
//     a time over it, the same products and sums in the same order.
//   * The loop is kernel B's (decision_step.cuh decide_group; D keeps this
//     copy, which runs 8% faster at B=9 than D on B's), every product and
//     sum rounded on its own: strict >, decision 0 first, centred gaps, the
//     winner's actual value v[lo]·(1 − w) + v[lo + 1]·w plus its immediate
//     value.  So best_act is the plain version's to the bit.
//   * Tried and left out (no gain in turns): streaming stores for best_act,
//     to keep v's rows in L2; the loop software-pipelined by one group
//     (c's argmax while c − 1's rows are in flight: 32 B spilled and 5%
//     slower at B = 4, within ±3% at B = 9); the tiles of one column
//     launched apart; other register caps, tiles and group sizes.
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

// A sim's standardised design row of its N = B entries in registers.
template <int N>
struct RegisterRow {
  float dm[N];
  // The regressed gap cf·dm of coefficients cf padded to whole float4s
  // (16-byte aligned): each product and sum rounded on its own, term 0
  // first.
  __device__ __forceinline__ float gap(const float* p) const {
    constexpr int kPadded = (N + 3) & ~3;
    float cf[kPadded];
#pragma unroll
    for (int k = 0; k < kPadded; k += 4) {
      const float4 q4 = *reinterpret_cast<const float4*>(p + k);
      cf[k] = q4.x;
      cf[k + 1] = q4.y;
      cf[k + 2] = q4.z;
      cf[k + 3] = q4.w;
    }
    float q = __fmul_rn(cf[0], dm[0]);
#pragma unroll
    for (int k = 1; k < N; ++k) q = __fadd_rn(q, __fmul_rn(cf[k], dm[k]));
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

// best_act of entries [c·kGroup, c·kGroup + kGroup) of a tile of nt grid
// points from g0 for sim s, whose spot is sp and design row dm.
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

// A sim's design row, from the transposed design [B, S]: its N = B entries
// in registers (N > 0), or in this thread's column of [bp][kThreads] in
// shared memory, zero beyond B (N == 0, the wide route).
template <int N>
struct DesignRow {
  using Row = RegisterRow<N>;
  __device__ __forceinline__ static Row load(const float* __restrict__ dm_std_t, int S, int s,
                                             int /*B*/, float* /*row_smem*/) {
    Row dm;
#pragma unroll
    for (int k = 0; k < N; ++k) dm.dm[k] = dm_std_t[static_cast<size_t>(k) * S + s];
    return dm;
  }
};

template <>
struct DesignRow<0> {
  using Row = SharedRow;
  __device__ __forceinline__ static Row load(const float* __restrict__ dm_std_t, int S, int s,
                                             int B, float* row_smem) {
    const int bp = padded_basis(B);
    for (int k = 0; k < bp; ++k)
      row_smem[k * kThreads] = k < B ? dm_std_t[static_cast<size_t>(k) * S + s] : 0.0f;
    return SharedRow{row_smem, bp};
  }
};

// Blocks per SM the kernel's registers must allow, by padded basis size (0:
// the wide route).  ops/decision_kernel.py update_reg_blocks keeps the same
// rule, which chip_smoke.py holds to kernel_info.
__host__ __device__ constexpr int min_blocks(int Bp) {
  return Bp == 0 ? 4 : Bp <= 4 ? 5 : Bp <= 16 ? 4 : Bp <= 28 ? 3 : 2;
}

// NB > 0: the design row of NB = B terms in registers; NB == 0: the wide
// route.
template <int NB>
__global__ void __launch_bounds__(kThreads, min_blocks((NB + 3) & ~3))
decision_update_kernel(
    int G, int tile, int S, int D, int B, const float* __restrict__ v,
    const float* __restrict__ dm_std_t, const float* __restrict__ spot,
    const float* __restrict__ records, float* __restrict__ best_out) {
  extern __shared__ __align__(16) float tab[];
  const int bp = padded_basis(NB > 0 ? NB : B);
  const int rec = record_words(D, bp);
  const int g0 = blockIdx.x * tile;
  const int nt = min(tile, G - g0);
  {
    const float4* src = reinterpret_cast<const float4*>(records + static_cast<size_t>(g0) * rec);
    float4* dst = reinterpret_cast<float4*>(tab);
    for (int i = threadIdx.x; i < nt * rec / 4; i += kThreads) dst[i] = __ldg(src + i);
  }
  const int col = blockIdx.y * kThreads + threadIdx.x;
  const bool valid = col < S;
  const int s = min(col, S - 1);
  const float sp = spot[s];
  const auto dm = DesignRow<NB>::load(dm_std_t, S, s, B, tab + tile * rec + threadIdx.x);
  __syncthreads();
  const int ngroups = (nt + kGroup - 1) / kGroup;
  for (int c = 0; c < ngroups; ++c)
    decide_group(c, g0, nt, S, D, bp, tab, v, s, valid, sp, dm, best_out);
}

// records[g, :] of a step: {a, b, w_hi, idx_lo} of decision 0, then for
// each decision d > 0 its entry and its centred coefficients dci = ci[d] −
// ci[0], zero-padded to bp; one thread a word.
__global__ void pack_records_kernel(int G, int D, int B, int bp, const int* __restrict__ idx_lo_g,
                                    const float* __restrict__ w_hi_g,
                                    const float* __restrict__ ci_g,
                                    const float* __restrict__ a_g, const float* __restrict__ b_g,
                                    float* __restrict__ records) {
  const int rec = record_words(D, bp);
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(G) * rec) return;
  const int g = static_cast<int>(i / rec);
  const int word = static_cast<int>(i - static_cast<size_t>(g) * rec);
  const int d = word < 4 ? 0 : 1 + (word - 4) / (4 + bp);
  const int k = word - record_offset(d, bp);
  float out;
  if (k == 0) {
    out = a_g[d * G + g];
  } else if (k == 1) {
    out = b_g[d * G + g];
  } else if (k == 2) {
    out = w_hi_g[g * D + d];
  } else if (k == 3) {
    out = __int_as_float(idx_lo_g[g * D + d]);
  } else {
    const int j = k - 4;
    out = j < B ? __fsub_rn(ci_g[(static_cast<size_t>(d) * G + g) * B + j],
                            ci_g[static_cast<size_t>(g) * B + j])
                : 0.0f;
  }
  records[i] = out;
}

using UpdateKernel = decltype(&decision_update_kernel<4>);

// The kernel for basis size B: compiled for B itself up to
// kMaxRegisterBasis, the wide route beyond.
UpdateKernel update_kernel(int B) {
  static_assert(kMaxRegisterBasis == 32, "one case per basis size up to 32");
  switch (B) {
#define STT_UPDATE_CASE(NB) case NB: return decision_update_kernel<NB>;
#define STT_UPDATE_CASES(NB) STT_UPDATE_CASE(NB) STT_UPDATE_CASE(NB + 1) \
    STT_UPDATE_CASE(NB + 2) STT_UPDATE_CASE(NB + 3)
    STT_UPDATE_CASES(1)
    STT_UPDATE_CASES(5)
    STT_UPDATE_CASES(9)
    STT_UPDATE_CASES(13)
    STT_UPDATE_CASES(17)
    STT_UPDATE_CASES(21)
    STT_UPDATE_CASES(25)
    STT_UPDATE_CASES(29)
#undef STT_UPDATE_CASES
#undef STT_UPDATE_CASE
    default: return decision_update_kernel<0>;
  }
}

}  // namespace

// A step's records, [G, record_words(D, padded B)] floats.
extern "C" int stt_pack_records(int G, int D, int B, const void* idx_lo, const void* w_hi,
                                const void* ci, const void* a, const void* b, void* records,
                                void* stream) {
  if (G < 1 || D < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int bp = padded_basis(B);
  const size_t words = static_cast<size_t>(G) * record_words(D, bp);
  const int threads = 256;
  pack_records_kernel<<<static_cast<unsigned>((words + threads - 1) / threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      G, D, B, bp, static_cast<const int*>(idx_lo), static_cast<const float*>(w_hi),
      static_cast<const float*>(ci), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(records));
  return static_cast<int>(cudaGetLastError());
}

// Kernel D on a step's packed records (stt_pack_records), `tile` grid
// points a block.
extern "C" int stt_decision_update(int G, int tile, int S, int D, int B, const void* v,
                                   const void* dm_std_t, const void* spot, const void* records,
                                   void* best_out, void* stream) {
  if (G < 2 || tile < 1 || D < 1 || S < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  tile = tile < G ? tile : G;
  const UpdateKernel kernel = update_kernel(B);
  const int bp = padded_basis(B);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(tile) * record_words(D, bp) + row_words(bp));
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((G + tile - 1) / tile, (S + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      G, tile, S, D, B, static_cast<const float*>(v), static_cast<const float*>(dm_std_t),
      static_cast<const float*>(spot), static_cast<const float*>(records),
      static_cast<float*>(best_out));
  return static_cast<int>(cudaGetLastError());
}

// Kernel D's launch report at a tile of G grid points, D decisions and B
// basis functions on the current device (common.cuh: kernel_info; its
// max_grid is the largest tile).
extern "C" int stt_decision_update_info(int G, int D, int B, int* out) {
  if (G < 0 || D < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int bp = padded_basis(B);
  return static_cast<int>(stt::kernel_info(update_kernel(B), kThreads, row_words(bp),
                                           record_words(D, bp), G, out));
}
