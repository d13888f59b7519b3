// Kernel C's large route: the sweep of forward_sweep.cuh with kLarge, for
// grids whose two packed rows do not fit a block's shared memory
// (forward_kernel.cu describes the kernel, this route among its modes).
// The ring stages each step's fixed part alone (parameters, design stats,
// ratchets); the coefficients [N, G, Bp] and, in general-grid mode, the
// general tails [N, 2G + 1] (each next grid row and its bucket index) stay
// in device memory and are read through L1.  Its own
// translation unit, so that its 66 kernels compile beside the shared
// route's.
#include "forward_sweep.cuh"

// The sweep as stt_forward_sweep, on packed rows of the fixed parts alone
// (ops/forward_kernel.py table_layout(..., large=True)) and the coefficients
// coef [N, G, Bp] (16-byte aligned; and, with `general`, the general tails
// [N, 2G + 1] at grid).
extern "C" int stt_forward_sweep_large(
    int N, int S, int F, int G, int R, int E, int is_step, int general, const int* basis_table,
    const void* table, const void* coef, const void* grid, const void* spot,
    const void* factors, const void* inv0, const void* pv0, void* inv_out, void* pv_out,
    void* inv_rows, void* dec_rows, void* cons_rows, void* imm_rows, void* partials,
    void* totals, void* stream) {
  stt::Basis basis;
  if (!stt::make_basis(basis_table, F, &basis) || N < 1 || S < 1 || G < 2 || R < 1 || E < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_sweep(
      pick_sweep<false, true>(basis.nb, F, general), false, N, S, G, R, E, is_step, general,
      true, basis, nullptr, table, coef, grid, spot, factors, inv0, pv0, inv_out, pv_out,
      inv_rows, dec_rows, cons_rows, imm_rows, partials, totals, stream));
}

// The monomial mode's wide route on the large route: as
// stt_forward_sweep_wide, with the tables as stt_forward_sweep_large's.
extern "C" int stt_forward_sweep_wide_large(
    int N, int S, int F, int B, int G, int R, int E, int is_step, int general, const void* pows,
    const void* table, const void* coef, const void* grid, const void* spot,
    const void* factors, const void* inv0, const void* pv0, void* inv_out, void* pv_out,
    void* inv_rows, void* dec_rows, void* cons_rows, void* imm_rows, void* partials,
    void* totals, void* stream) {
  if (B < 1 || B > stt::kMaxWideB || F < 0 || !is_wide(B, F, false) || !pows || N < 1 ||
      S < 1 || G < 2 || R < 1 || E < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  stt::Basis basis{};
  basis.nb = B;
  basis.nf = F;
  return static_cast<int>(launch_sweep(
      pick_sweep<false, true>(B, F, general), false, N, S, G, R, E, is_step, general, true,
      basis, static_cast<const int8_t*>(pows), table, coef, grid, spot, factors, inv0, pv0,
      inv_out, pv_out, inv_rows, dec_rows, cons_rows, imm_rows, partials, totals, stream));
}

// The design mode on the large route: as stt_forward_sweep_design, with the
// tables as stt_forward_sweep_large's.
extern "C" int stt_forward_sweep_design_large(
    int N, int S, int B, int G, int R, int E, int is_step, int general, const void* table,
    const void* coef, const void* grid, const void* spot, const void* design, const void* inv0,
    const void* pv0, void* inv_out, void* pv_out, void* inv_rows, void* dec_rows,
    void* cons_rows, void* imm_rows, void* partials, void* totals, void* stream) {
  if (B < 1 || N < 1 || S < 1 || G < 2 || R < 1 || E < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  stt::Basis basis{};
  basis.nb = B;
  return static_cast<int>(launch_sweep(
      pick_sweep<true, true>(B, 0, general), true, N, S, G, R, E, is_step, general, true, basis,
      nullptr, table, coef, grid, spot, design, inv0, pv0, inv_out, pv_out, inv_rows, dec_rows,
      cons_rows, imm_rows, partials, totals, stream));
}

// The large route's launch report (common.cuh kernel_info; no part of its
// shared memory grows with G, so its max_grid is INT_MAX); past the caps,
// the wide route's, as stt_forward_sweep_info.
extern "C" int stt_forward_sweep_large_info(int B, int R, int F, int E, int design, int general,
                                            int* out) {
  if (B < 1 || R < 1 || E < 0 || (!design && (B > stt::kMaxWideB || F < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (design) F = 0;
  const cudaError_t err = stt::kernel_info(
      design ? pick_sweep<true, true>(B, F, general) : pick_sweep<false, true>(B, F, general),
      kThreads, smem_fixed_words(B, R, F, E, design), 0, 0, out);
  out[0] = kSims * kThreads;
  return static_cast<int>(err);
}
