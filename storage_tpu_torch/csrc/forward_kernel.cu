// Kernel C: the forward LSMC pass as one sweep over every step.
//
// Replaces the TPU kernel storage_tpu/ops/forward_kernel.py:forward_step_pallas
// (_forward_kernel, _ratchet_rates_smem, _bang_bang), which the JAX engine
// launches once per step of its forward lax.scan
// (storage_tpu/engines/lsmc.py).  Here one launch carries every sim through
// all N steps.  Per sim and step: the standardised design row; ratchet rates
// at the sim's inventory from the R-node table (linear or step); the
// bang-bang decision set (D = 2E + 3); per decision the fitted continuation
// at the target inventory, the immediate value with costs, fuel and
// inventory cost, and a first-max argmax; then the new inventory and PV, and
// the chosen volume, fuel and immediate PV.  The fitted continuation is
// evaluated only at the two grid rows a decision touches — pred =
// coeffs[:, row]·dm at lo and lo + 1 — where the TPU, lacking a per-lane
// gather, evaluated all G rows and contracted a hat.  The edges reproduce
// that hat sum: a degenerate grid (inv_delta = 0) puts weight 1 on row 0; a
// position at the top edge takes lo = G − 2 with weight 1.
//
// Bound on the H100: device memory.  A sim reads its spot and F factor values
// once a step: 1.53 GB at N = 365, S = 262,144, F = 3, about 0.46 ms at
// 3.35 TB/s (twice that with the per-sim panels written); the arithmetic,
// ~230 operations per sim and step, is below that.  What limits the sweep
// in practice is its instructions, not its bytes: each operation rounded on
// its own, eleven IEEE divisions and fifteen warp sums per sim and step.  On
// an NVIDIA H100 80GB HBM3 at 700.00 W it takes about 4.9 ms (PERF.md,
// tools/torch_forward_probe.py).  Design:
//   * A block of kThreads threads carries kSims·kThreads sims through the
//     whole sweep.  A sim's forward path depends only on its own spot and
//     factor values and on tables known before the sweep, so blocks never
//     wait on each other; inventory and PV stay in registers and are written
//     once, at the end.
//   * Design mode (kDesign, for bases with a user callable, which no kernel
//     can evaluate): the wrapper writes each step's raw design values
//     [N, B, S] to device memory, and the ring stages them in place of the
//     factors: spot + B values a sim and step instead of spot + F.  Each
//     entry is standardised as design_entry does, and the rest of the step
//     is the same code, so a design equal to the monomials' gives the
//     monomial mode's bits.
//   * The wrapper packs each step's tables — parameters, design mean and
//     std, ratchets, coefficients [B, G] (and the general tail) — into one
//     row of an [N, W] table.
//     One thread copies row t + 2 into a two-stage ring in shared memory with
//     a TMA bulk copy that completes on the stage's mbarrier, while the block
//     computes steps t and t + 1.
//   * Each thread copies its sims' spot and factor values of step t + 2 into
//     its own slots of the ring with 4-byte cp.async: two steps of loads in
//     flight, no registers held for them.
//   * The kernel is compiled for each basis size B (1 to stt::kMaxB), so the
//     design row and the B-term dot products are unrolled loops over
//     registers with no guards for unused terms.  Both modes also take a
//     larger shape on their wide route (B = 0 below, the size known at run
//     time; forward_sweep.cuh is_wide: past kMaxB terms, and in the
//     monomial mode past kMaxF factors, up to kMaxWideB terms on any F, as
//     the JAX package's kernel takes any monomial basis): in design mode
//     each sim's entries are standardised in place in its slots of the
//     ring; in the monomial mode each sim's B entries are built from the
//     staged factor values and a per-block copy of the powers [B, F + 1]
//     (the wrapper's device table) into the sim's column of a [B, 256]
//     tile of shared memory.  The dot products read them from there, the
//     same products and sums in the same order, and the warps' sums of a
//     step go to dynamic shared memory.  The staged values grow with B (and
//     F), so fewer blocks fit an SM (kernel_info).  Each entry of the design
//     row is stt::design_row's arithmetic (the spot power, then the factor
//     powers by index, each product rounded on its own) over the term's
//     nonzero powers only, from a per-block term table: small code.
//   * The decision arithmetic is the one-step kernel's of the JAX package,
//     every product and sum rounded on its own, so a sim's path is the plain
//     version's (ops/forward_kernel.py forward_step_plain) to the bit.
//   * Large route (forward_kernel_large.cu, the same body with kLarge): past
//     the grid whose two rows leave a block's shared route 4 blocks an SM
//     (ops/forward_kernel.py sweep_route: 658 points at B=9, R=3, F=3 on an
//     H100, 538 in general-grid mode; they fit up to 3,090 and 2,528) the
//     coefficients are packed [G, Bp], each row's B terms padded to whole
//     16-byte words (ops/forward_kernel.py pack_tables), and stay in device
//     memory with the general tails; the ring stages each row's fixed part
//     alone, and each decision reads its rows lo and lo + 1 in ceil(B / 4)
//     loads each (three at B=9, where 2B scalar loads took eighteen; a warp's
//     sims sit at scattered rows, so each load touches its own lines) and,
//     in general-grid mode, its bucket and nodes, through L1.  The same
//     products and sums in the same order, so the same paths, at any G.  The
//     wrapper picks the route from the shape (sweep_route).
//   * General-grid mode (kGeneral, for custom inventory grids whose rows are
//     not evenly spaced; in both modes above): the JAX package takes its XLA
//     forward step with interp_per_sim_general there
//     (storage_tpu/engines/lsmc.py:990-994).  The packed table row carries
//     the next step's general tail after the coefficients — the grid row
//     [G] and a bucket index over it that the wrapper builds before the
//     sweep (forward_sweep.cuh GeneralRow; ops/forward_kernel.py
//     general_tail) — so the ring stages it beside them, and each decision's
//     lower row and weight are dp_common.cuh's general_weights' (the count of
//     interior nodes <= the clamped inventory, weight 0 on a zero-span
//     segment of a padded row), found from the nodes of the inventory's
//     bucket alone (indexed_weights): a bucket's count pair and at most four
//     nodes, where the binary search of the whole row made about log2(G)
//     dependent probes a decision.  The two predicted values and their lerp
//     are unchanged.
//   * The step's cross-sim sums (inventory, volume, fuel, loss, immediate
//     value, delta numerator; the design row) go out as one partials row per
//     step and group of kThreads sims — warp butterflies, then the warps in
//     order — and one stt::launch_reduce after the sweep sums the N·(8 + B)
//     rows over the groups in a fixed order: no float atomics, the same bits
//     on every run and for every kSims.
#include "forward_sweep.cuh"

// The general-grid mode's index (forward_sweep.cuh GeneralRow), one block a
// row: the row copied, its scale K / (row[G-1] - row[0]) over K = G - 1
// buckets (0 on a zero span), and the counts cnt[i] of interior nodes whose
// bucket is below i: interior node j sets cnt over (bucket(j - 1),
// bucket(j)] to j - 1 (bucket(0) taken as -1), and the end sets it up to K
// to G - 2, so the ranges of a non-decreasing row tile [0, K].  The counts
// are zeroed first: on a row that is not non-decreasing (which no valuation
// builds, and whose answer is not defined) every count stays in [0, G - 2],
// so the search reads inside the row.
__global__ void __launch_bounds__(kThreads) general_tail_kernel(
    int G, const float* __restrict__ grid, float* __restrict__ out, int stride) {
  const float* row = grid + static_cast<size_t>(blockIdx.x) * G;
  float* tail = out + static_cast<size_t>(blockIdx.x) * stride;
  int* cnt = reinterpret_cast<int*>(tail + G + 1);
  for (int j = threadIdx.x; j < G; j += kThreads) {
    tail[j] = row[j];
    cnt[j] = 0;
  }
  const float a = row[0];
  const float span = __fsub_rn(row[G - 1], a);
  const float scale = span > 0.0f ? __fdiv_rn(static_cast<float>(G - 1), span) : 0.0f;
  if (threadIdx.x == 0) tail[G] = scale;
  __syncthreads();
  for (int j = threadIdx.x + 1; j < G; j += kThreads) {
    const int lo = j > 1 ? bucket_of(row[j - 1], a, scale, G) : -1;
    const int hi = j < G - 1 ? bucket_of(row[j], a, scale, G) : G - 1;
    for (int i = lo + 1; i <= hi; ++i) cnt[i] = j - 1;
  }
}

// The general tails of N next grid rows [N, G] (f32) into out, one row of
// 2G + 1 floats every `stride` floats: the packed table's tails on the
// shared route, or [N, 2G + 1] on the large route.
extern "C" int stt_general_tail(int N, int G, const void* grid, void* out, int stride,
                                void* stream) {
  if (N < 1 || G < 2 || stride < general_words(G)) return static_cast<int>(cudaErrorInvalidValue);
  general_tail_kernel<<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      G, static_cast<const float*>(grid), static_cast<float*>(out), stride);
  return static_cast<int>(cudaGetLastError());
}

// The sweep: N steps of S sims from inventory inv0 (and PV pv0, or 0 where
// NULL) on the packed tables [N, W] (16-byte aligned; with `general`, each
// row ends with the next step's general tail); spot [N, S], factors [N, F, S].
// Writes the final inventory and PV, and, where given (else NULL), the rows
// [N, S] of inventory after each step, volume, fuel and immediate PV;
// partials [N, 8 + B, ceil(S / 256)] are scratch, and totals [N, 8 + B]
// receive each step's sums, then its summed design row.
extern "C" int stt_forward_sweep(
    int N, int S, int F, int G, int R, int E, int is_step, int general, const int* basis_table,
    const void* table, const void* spot, const void* factors, const void* inv0,
    const void* pv0, void* inv_out, void* pv_out, void* inv_rows, void* dec_rows,
    void* cons_rows, void* imm_rows, void* partials, void* totals, void* stream) {
  stt::Basis basis;
  if (!stt::make_basis(basis_table, F, &basis) || N < 1 || S < 1 || G < 2 || R < 1 || E < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_sweep(
      pick_sweep<false, false>(basis.nb, F, general), false, N, S, G, R, E, is_step, general,
      false, basis, nullptr, table, nullptr, nullptr, spot, factors, inv0, pv0, inv_out, pv_out,
      inv_rows, dec_rows, cons_rows, imm_rows, partials, totals, stream));
}

// The monomial mode past stt::kMaxB terms or stt::kMaxF factors, on its wide
// route: as stt_forward_sweep, with the B terms' powers `pows` [B, F + 1]
// int8 in device memory in place of the host's basis table; B up to
// stt::kMaxWideB, any F.
extern "C" int stt_forward_sweep_wide(
    int N, int S, int F, int B, int G, int R, int E, int is_step, int general, const void* pows,
    const void* table, const void* spot, const void* factors, const void* inv0,
    const void* pv0, void* inv_out, void* pv_out, void* inv_rows, void* dec_rows,
    void* cons_rows, void* imm_rows, void* partials, void* totals, void* stream) {
  if (B < 1 || B > stt::kMaxWideB || F < 0 || !is_wide(B, F, false) || !pows || N < 1 ||
      S < 1 || G < 2 || R < 1 || E < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  stt::Basis basis{};
  basis.nb = B;
  basis.nf = F;
  return static_cast<int>(launch_sweep(
      pick_sweep<false, false>(B, F, general), false, N, S, G, R, E, is_step, general, false,
      basis, static_cast<const int8_t*>(pows), table, nullptr, nullptr, spot, factors, inv0, pv0,
      inv_out, pv_out, inv_rows, dec_rows, cons_rows, imm_rows, partials, totals, stream));
}

// The sweep in design mode: as stt_forward_sweep, with the raw design
// values [N, B, S] of B basis functions in place of the factors; any B.
extern "C" int stt_forward_sweep_design(
    int N, int S, int B, int G, int R, int E, int is_step, int general, const void* table,
    const void* spot, const void* design, const void* inv0, const void* pv0, void* inv_out,
    void* pv_out, void* inv_rows, void* dec_rows, void* cons_rows, void* imm_rows,
    void* partials, void* totals, void* stream) {
  if (B < 1 || N < 1 || S < 1 || G < 2 || R < 1 || E < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  stt::Basis basis{};
  basis.nb = B;
  return static_cast<int>(launch_sweep(
      pick_sweep<true, false>(B, 0, general), true, N, S, G, R, E, is_step, general, false,
      basis, nullptr, table, nullptr, nullptr, spot, design, inv0, pv0, inv_out, pv_out,
      inv_rows, dec_rows, cons_rows, imm_rows, partials, totals, stream));
}

// The sweep's launch report at (G, B, R, F, E) on the current device
// (common.cuh kernel_info), with out[0] the sims of a block; with `design`
// set, the design mode's (F is then not read); with `general`, the
// general-grid mode's; past the caps, the wide route's (in the monomial mode
// up to stt::kMaxWideB terms).  The shared route's: its max_grid is the
// largest G that route takes.
extern "C" int stt_forward_sweep_info(int G, int B, int R, int F, int E, int design, int general,
                                      int* out) {
  if (G < 0 || B < 1 || R < 1 || E < 0 || (!design && (B > stt::kMaxWideB || F < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (design) F = 0;
  const cudaError_t err = stt::kernel_info(
      design ? pick_sweep<true, false>(B, F, general) : pick_sweep<false, false>(B, F, general),
      kThreads, smem_fixed_words(B, R, F, E, design, general),
      smem_words_per_grid_point(B, general), G, out);
  out[0] = kSims * kThreads;
  return static_cast<int>(err);
}
