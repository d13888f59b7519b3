"""The backward LSMC step's decision update: with next-step moments
(kernel B), on a precomputed design without moments (kernel D), and with the
inter-step regression folded in (kernel E).

Counterparts of ``storage_tpu.ops.decision_kernel``'s
``decision_update_moments_pallas`` (B), ``decision_update_pallas`` (D) and
``decision_update_fullstep_pallas`` (E).  For every inventory grid point g
and sim s each evaluates, per decision d,

    val_reg[g,d,s] = imm[g,d](spot[s]) + regressed continuation gap (vs d = 0)
    val_act[g,d,s] = imm[g,d](spot[s]) + actual continuation
    best_act[g,s]  = val_act[g, argmax_d val_reg[g,d,s], s]

(the reference's anti-foresight trick, LsmcStorageValuation.cs:310-336; ties
keep the first decision) and returns the raw moments XᵀX [B, B] and
Xᵀ·best_act [B, G] of step t−1's design matrix standardised by
(mean_prev, std_prev) — the input of the next step's regression.  The TPU
kernel standardises step t−1 by step t's own (mean, std); passing those as
(mean_prev, std_prev) reproduces it.  The engine passes step t−1's exact
two-pass stats instead, which keeps near-deterministic columns (the
valuation day's factors, ~1e-9) from cancelling in the moments.

The actual continuation interpolates ``v`` between rows ``idx_lo[g, d]`` and
``idx_lo[g, d] + 1`` with weight ``w_hi[g, d]``: a two-row gather, not the
TPU's dense hat matmul, and plain f32 (the JAX kernel's ``pred_passes=1``).
Kernel D reads the standardised design rows from the caller's ``dm_std_t``
[B, S] (the engine's backward step on spot-only panels, whose regression is
fitted outside the kernel).  Kernel E takes the raw moments the previous
step's B accumulated and solves the regression itself: standardise the
moments, compose the stats, trace-ridge Cholesky solve with the constant-
column fallback, interpolate the coefficients — then B's update.

The kernels are ``csrc/decision_kernel.cu`` (B), ``csrc/decision_update_kernel.cu``
(D) and ``csrc/fullstep_kernel.cu`` (E, which launches B's kernel after its
solve); each ``*_plain`` function is the same function in tensor code, used
for CPU tensors.  All three run the same decision loop (B and E from
``csrc/decision_step.cuh``, D from its own copy): the argmax first, on the
regressed values, then only the winner's two rows of ``v``, a group of grid
points at a time, on the step's tables repacked into per-grid-point records
(``record_words``) in shared memory.  B's kernel keeps
only the records and two fixed tiles in shared memory, D's only the records
(and, past 32 terms, each sim's design row).  Each takes any grid, on one of
two routes decided from the shape before anything is allocated
(``moments_route``, ``update_route``, ``fullstep_route``): the shared route,
all of a step's records in a block's shared memory at once, while they fit
(``kernel_info`` gives the largest grid) and leave at least as many blocks
per SM as the large route (``moments_blocks_per_sm``,
``update_blocks_per_sm``), else the large route, a tile of grid points at a
time (and E's solve spread over blocks).  Both give the same bits.  B
repacks its records in each block; D packs them once a step
(``pack_records``) and runs one kernel on both routes, a tile a block (the
shared route's tile is the whole grid).  B and E build the
monomial design on the card: on their register kernels within the caps
``_build.MAX_BASIS`` and ``_build.MAX_FACTORS`` (16 and 8) and, past either
cap, on the wide body (``fullstep_body``, ``moments_plan``,
``fullstep_route``: B's body with the powers staged from a device table, one
kernel for both grid routes, on any factor count: each sim's design row in
registers up to ``_build.MAX_WIDE_REGISTER_BASIS`` padded terms, the "wide"
body, compiled per padded size; in shared memory beyond, up to
``_build.MAX_WIDE_BASIS`` terms, the "wide-smem" body), chosen from B and F
alone; past ``_build.MAX_WIDE_BASIS`` terms both raise ``ValueError``.  D
reads the design and takes any basis, compiled per basis size up to 32
terms and on its wide route beyond.
"""
from __future__ import annotations

import ctypes
import functools
import typing as tp

import torch

from ..basis import Monomial, design_matrix
from . import _build
from .interp import interp_coeffs
from .regression import fit_from_moments, ridge_for, standardise_moments


def snap_weights(w):
    """Interpolation weights rounded to the 1/256 grid (the quadrature of the
    TPU run; ``snap_interp`` selects it)."""
    return torch.round(w * 256.0) / 256.0


def _standardised_design(monomials, spot, factors, mean, std):
    return (design_matrix(monomials, spot, factors) - mean) / std  # [S, B]


def decision_values(v, spot, factors, mean, std, idx_lo, w_hi, ci, a, b, monomials):
    """Per decision d, its (regressed, actual) values [G, S] in the kernel's
    arithmetic order: the regressed one is the centred gap to decision 0 plus
    the immediate value."""
    dm = _standardised_design(monomials, spot, factors, mean, std)  # [S, B]
    return decision_values_on_design(v, dm, spot, idx_lo, w_hi, ci, a, b)


def decision_values_on_design(v, dm, spot, idx_lo, w_hi, ci, a, b):
    """``decision_values`` on a given standardised design ``dm`` [S, B]."""
    dci = ci - ci[0:1]  # [D, G, B]
    lo = idx_lo.to(torch.int64)
    for d in range(ci.shape[0]):
        w = w_hi[:, d][:, None]
        actual = v[lo[:, d]] * (1 - w) + v[lo[:, d] + 1] * w  # [G, S]
        imm = a[d][:, None] * spot[None, :] + b[d][:, None]
        if d == 0:
            yield imm, actual + imm
            continue
        q = dci[d][:, 0:1] * dm[:, 0][None, :]
        for k in range(1, dm.shape[1]):
            q = q + dci[d][:, k:k + 1] * dm[:, k][None, :]
        yield q + imm, actual + imm


def _best_actual(values):
    """The running argmax over decisions: strict >, decision 0 first."""
    best_reg, best_act = next(values)
    for val_reg, val_act in values:
        better = val_reg > best_reg
        best_reg = torch.where(better, val_reg, best_reg)
        best_act = torch.where(better, val_act, best_act)
    return best_act


def decision_update_moments_plain(v, spot, factors, spot_prev, factors_prev,
                                  mean, std, mean_prev, std_prev, idx_lo, w_hi,
                                  ci, a, b, monomials):
    """Tensor-code version of kernel B; any dtype, any device."""
    best_act = _best_actual(
        decision_values(v, spot, factors, mean, std, idx_lo, w_hi, ci, a, b, monomials))
    dmp = _standardised_design(monomials, spot_prev, factors_prev, mean_prev, std_prev)
    return best_act, dmp.T @ dmp, dmp.T @ best_act.T


class Route(tp.NamedTuple):
    """A launch's route: "shared" (a step's tables in shared memory at
    once) or "large" (a tile of grid points at a time), and the grid points
    a tile takes (G on the shared route)."""
    name: str
    tile: int


class FullstepRoute(tp.NamedTuple):
    """The route of kernel B (``moments_plan``) or kernel E
    (``fullstep_route``): its grid route and tile as ``Route``, and its body:
    kernel B's register kernels ("register", within 16 terms and 8 factors)
    or, past either, the wide route's, its powers from a device table, each
    sim's design row in registers ("wide", compiled per padded size up to
    ``_build.MAX_WIDE_REGISTER_BASIS``) or in shared memory ("wide-smem")."""
    name: str
    tile: int
    body: str

    @property
    def wide(self) -> bool:
        """Whether the body is one of the wide route's."""
        return self.body != "register"


ROUTES = ("shared", "large")
# The grid routes of kernels B and E on a wide body, which ``route=`` may
# force at any shape the body takes.
WIDE_ROUTES = ("wide-shared", "wide-large", "wide-smem-shared", "wide-smem-large")
# Grid points a tile of the large routes of kernels B and D (and E, which
# launches B): tools/torch_grid_probe.py times tiles at G = 4,096.
TILE_B = 32
TILE_D = 256

# The kernels' sizing, copied from csrc/decision_kernel.cu,
# csrc/decision_update_kernel.cu and their records (csrc/decision_step.cuh)
# so that the route is decided from shapes on any device; chip_smoke.py holds
# each copy to ``kernel_info``.  Both kernels keep a record of
# ``record_words(D, B)`` words a grid point in shared memory.  Kernel B: 128
# sims a block, a static [kChunk = 8, 128] best_act tile, a [B, 128] design
# tile, then the records.  Kernel D: 256 sims a block, the records, past 32
# padded terms also each sim's design row [Bp, 256].  Kernel E's one-block
# solve: B·B doubles and B·B + 2·B + 2·B·G floats and an int; its large
# route spreads the right-hand sides over blocks of 256.
_B_SIMS = 128
_B_CHUNK = 8
_D_SIMS = 256
_D_GROUP = 4
_SOLVE_COLUMNS = 256

# The blocks per SM kernel B's registers allow (the rest of a route's
# blocks per SM is ``_build.blocks_per_sm``'s): capped for kMinBlocks = 9
# blocks (csrc/decision_kernel.cu), on both routes, for kWideRegMinBlocks on
# the wide register row (by padded B: up to 16, past 16) and for
# kWideMinBlocks on the shared row; kernel D's are ``update_reg_blocks``.
_B_REG_BLOCKS = 9
_WIDE_REG_BLOCKS = (8, 6)
_WIDE_SMEM_REG_BLOCKS = 8


def padded_basis(bdim: int) -> int:
    """B rounded up to whole float4s, as the records and the kernels pad it."""
    return -(-bdim // 4) * 4


def record_words(d: int, bdim: int) -> int:
    """Words of one grid point's record: {a, b, w_hi, idx_lo} per decision,
    and after each of decisions 1..D−1 its centred coefficients padded to
    whole float4s."""
    return 4 + (d - 1) * (4 + padded_basis(bdim))


def _fit(limit: int, static_bytes: int, fixed_words: int, words_per_point: int) -> int:
    """The most grid points whose words fit a block's shared memory."""
    room = (limit - static_bytes) // 4 - fixed_words
    return room // words_per_point if room >= 0 else 0


def moments_blocks_per_sm(g: int, d: int, bdim: int, smem_limit: int) -> int:
    """Blocks per SM of kernel B holding G grid points' records: its shared
    route at G, its large route at a tile of G."""
    smem = 4 * _B_CHUNK * _B_SIMS + 4 * (bdim * _B_SIMS + g * record_words(d, bdim))
    return _build.blocks_per_sm(smem, _B_SIMS, _B_REG_BLOCKS, smem_limit)


def _row_words(bdim: int) -> int:
    bp = padded_basis(bdim)
    return bp * _D_SIMS if bp > 32 else 0


def update_reg_blocks(bdim: int) -> int:
    """The blocks per SM kernel D's registers are capped for
    (``__launch_bounds__``, ``min_blocks`` in csrc/decision_update_kernel.cu),
    by padded basis size: 5 up to 4 terms, 4 up to 16, 3 up to 28, 2 up to
    32, and 4 on the wide route beyond."""
    bp = padded_basis(bdim)
    return 4 if bp > 32 else 5 if bp <= 4 else 4 if bp <= 16 else 3 if bp <= 28 else 2


def update_blocks_per_sm(g: int, d: int, bdim: int, smem_limit: int) -> int:
    """Blocks per SM of kernel D at a tile of G grid points."""
    smem = 4 * (g * record_words(d, bdim) + _row_words(bdim))
    return _build.blocks_per_sm(smem, _D_SIMS, update_reg_blocks(bdim), smem_limit)


def _choose(name: str, g: int, max_grid: int, want: int, quantum: int,
            route: tp.Optional[str], shared_blocks, large_blocks) -> Route:
    """The shared route while G fits it and its blocks per SM
    (``shared_blocks(G)``) are at least the large route's
    (``large_blocks(tile)``), else the large route with tiles of ``want``
    grid points, fewer (a multiple of ``quantum`` where one fits) where
    those do not fit; ``route`` forces one."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"{name}: route must be one of {ROUTES}, got {route!r}")
    tile = min(want, g, max_grid)
    if tile >= quantum:
        tile -= tile % quantum
    if route is None:
        fits = g <= max_grid and shared_blocks(g) >= large_blocks(max(tile, 1))
        route = "shared" if fits else "large"
    if route == "shared":
        if g > max_grid:
            raise ValueError(f"{name}: the shared route holds at most G={max_grid} grid points "
                             f"at this shape, got G={g}")
        return Route("shared", g)
    if tile < 1:
        raise ValueError(f"{name}: not even one grid point's tables fit a block's shared "
                         f"memory at this shape")
    return Route("large", tile)


def moments_max_grid(d: int, bdim: int, smem_limit: int) -> int:
    """The largest G of kernel B's shared route at D decisions and B basis
    functions, under ``smem_limit`` bytes of shared memory a block."""
    return _fit(smem_limit, 4 * _B_CHUNK * _B_SIMS, bdim * _B_SIMS, record_words(d, bdim))


def moments_route(g: int, d: int, bdim: int, smem_limit: int,
                  route: tp.Optional[str] = None) -> Route:
    """Kernel B's route at (G, D, B), from the shape and the card's shared
    memory a block (``_build.smem_limit``): shared while G fits it
    (``moments_max_grid``) and its blocks per SM are at least the large
    route's, else large, ``TILE_B`` grid points a tile."""
    def blocks(n):
        return moments_blocks_per_sm(n, d, bdim, smem_limit)
    return _choose("decision_update_moments", g, moments_max_grid(d, bdim, smem_limit), TILE_B,
                   _B_CHUNK, route, blocks, blocks)


def update_max_grid(d: int, bdim: int, smem_limit: int) -> int:
    """The largest G of kernel D's shared route (its largest tile)."""
    return _fit(smem_limit, 0, _row_words(bdim), record_words(d, bdim))


def update_route(g: int, d: int, bdim: int, smem_limit: int,
                 route: tp.Optional[str] = None) -> Route:
    """Kernel D's route, as ``moments_route``: one tile of all G grid points
    (shared) or ``TILE_D`` a tile (large), for the same kernel."""
    def blocks(n):
        return update_blocks_per_sm(n, d, bdim, smem_limit)
    return _choose("decision_update", g, update_max_grid(d, bdim, smem_limit), TILE_D, _D_GROUP,
                   route, blocks, blocks)


def solve_max_grid(bdim: int, smem_limit: int) -> int:
    """The largest G of kernel E's one-block solve (the same on both of its
    bodies: the wide route's substitution vector is not in shared memory)."""
    return (smem_limit - 8 * bdim * bdim - 4 * (bdim * bdim + 2 * bdim) - 4) // (8 * bdim)


def wide_body(bdim: int) -> str:
    """The wide route's body for B terms: "wide" (the design row in
    registers) while B padded to whole float4s is at most
    ``_build.MAX_WIDE_REGISTER_BASIS``, else "wide-smem"."""
    return "wide" if padded_basis(bdim) <= _build.MAX_WIDE_REGISTER_BASIS else "wide-smem"


def fullstep_body(bdim: int, num_factors: int) -> str:
    """The body of kernel B and kernel E from the basis size and the factor
    count alone:
    "register" within ``_build.MAX_BASIS`` terms and ``_build.MAX_FACTORS``
    factors, else the wide route's (``wide_body``).  Not a fallback:
    nothing is tried first."""
    if bdim <= _build.MAX_BASIS and num_factors <= _build.MAX_FACTORS:
        return "register"
    return wide_body(bdim)


def wide_reg_blocks(bdim: int, body: str) -> int:
    """The blocks per SM a wide body's registers are capped for
    (``__launch_bounds__``): kWideRegMinBlocks by padded B on the register
    row, kWideMinBlocks on the shared row (csrc/decision_kernel.cu)."""
    if body == "wide-smem":
        return _WIDE_SMEM_REG_BLOCKS
    return _WIDE_REG_BLOCKS[0 if padded_basis(bdim) <= 16 else 1]


def wide_fixed_words(bdim: int, num_factors: int, body: str) -> int:
    """A wide body's shared words besides its records and its static
    best_act tile: step t−1's design tile [B, 128], on the shared row also
    step t's design rows [Bp, 128], and the powers [B, F + 1] int8 in whole
    words (csrc/decision_kernel.cu wide_fixed_words)."""
    rows = bdim + (padded_basis(bdim) if body == "wide-smem" else 0)
    return rows * _B_SIMS + -(-bdim * (num_factors + 1) // 4)


def wide_blocks_per_sm(g: int, d: int, bdim: int, num_factors: int, smem_limit: int,
                       body: tp.Optional[str] = None) -> int:
    """Blocks per SM of a wide body (``wide_body``'s by default) holding G
    grid points' records: its shared route at G, its large route at a tile
    of G (one kernel)."""
    body = body or wide_body(bdim)
    smem = 4 * _B_CHUNK * _B_SIMS + 4 * (wide_fixed_words(bdim, num_factors, body)
                                         + g * record_words(d, bdim))
    return _build.blocks_per_sm(smem, _B_SIMS, wide_reg_blocks(bdim, body), smem_limit)


def wide_max_grid(d: int, bdim: int, num_factors: int, smem_limit: int,
                  body: tp.Optional[str] = None) -> int:
    """The largest G (or tile) of a wide body (``wide_body``'s by default)
    under ``smem_limit`` bytes of shared memory a block."""
    return _fit(smem_limit, 4 * _B_CHUNK * _B_SIMS,
                wide_fixed_words(bdim, num_factors, body or wide_body(bdim)),
                record_words(d, bdim))


def wide_route(g: int, d: int, bdim: int, num_factors: int, smem_limit: int,
               route: tp.Optional[str] = None, body: tp.Optional[str] = None) -> Route:
    """A wide body's grid route, as ``moments_route``: shared while G fits
    (``wide_max_grid``) and its blocks per SM are at least the large
    route's, else large, ``TILE_B`` grid points a tile."""
    def blocks(n):
        return wide_blocks_per_sm(n, d, bdim, num_factors, smem_limit, body)
    return _choose("decision_update_fullstep", g,
                   wide_max_grid(d, bdim, num_factors, smem_limit, body), TILE_B, _B_CHUNK,
                   route, blocks, blocks)


def _forced_body(name: str, bdim: int, num_factors: int, route: tp.Optional[str]):
    """The body from B and F (``fullstep_body``), or the wide one that a
    route of ``WIDE_ROUTES`` forces, and the grid route left to force (or
    None); ``ValueError`` where the body does not take B terms."""
    if route is not None and route not in ROUTES + WIDE_ROUTES:
        raise ValueError(f"{name}: route must be one of {ROUTES + WIDE_ROUTES}, got {route!r}")
    body = fullstep_body(bdim, num_factors)
    if route in WIDE_ROUTES:
        body, route = route.rsplit("-", 1)
    if body != "register":
        _build.require_wide_basis(name, bdim)
    if body == "wide" and padded_basis(bdim) > _build.MAX_WIDE_REGISTER_BASIS:
        raise ValueError(f"{name}: {bdim} basis functions; the wide register row is compiled "
                         f"for at most {_build.MAX_WIDE_REGISTER_BASIS} (csrc/common.cuh "
                         f"kMaxWideRegB)")
    return body, route


def moments_plan(g: int, d: int, bdim: int, num_factors: int, smem_limit: int,
                 route: tp.Optional[str] = None) -> FullstepRoute:
    """Kernel B's route from the shape alone: its body from B and F
    (``fullstep_body``: its register kernels within ``_build.MAX_BASIS``
    terms and ``_build.MAX_FACTORS`` factors, else the wide body that kernel
    E's wide route runs, ``wide_body``; a route of ``WIDE_ROUTES`` forces a
    wide one at any shape it takes), then its grid route (``moments_route``,
    or ``wide_route`` on a wide body: one kernel for both).  A wide body
    takes at most ``_build.MAX_WIDE_BASIS`` terms, its register row
    ``_build.MAX_WIDE_REGISTER_BASIS`` padded (``ValueError`` beyond).  Not a
    fallback: nothing is tried first."""
    body, route = _forced_body("decision_update_moments", bdim, num_factors, route)
    if body == "register":
        return FullstepRoute(*moments_route(g, d, bdim, smem_limit, route), body)
    return FullstepRoute(*wide_route(g, d, bdim, num_factors, smem_limit, route, body), body)


def fullstep_route(g: int, d: int, bdim: int, smem_limit: int, route: tp.Optional[str] = None,
                   num_factors: int = 0) -> FullstepRoute:
    """Kernel E's route: its body from B and F (``fullstep_body``; a route
    of ``WIDE_ROUTES`` forces a wide one at any shape it takes), then its
    grid route: shared where its body's rule (``moments_route`` or
    ``wide_route``) takes its shared route and the one-block solve fits,
    else large (the body's large route and the solve spread over blocks).
    The wide route takes at most ``_build.MAX_WIDE_BASIS`` terms, its
    register row ``_build.MAX_WIDE_REGISTER_BASIS`` padded (``ValueError``
    beyond)."""
    body, route = _forced_body("decision_update_fullstep", bdim, num_factors, route)
    if body == "register":
        grid = functools.partial(moments_route, g, d, bdim, smem_limit)
        max_grid = moments_max_grid(d, bdim, smem_limit)
    else:
        grid = functools.partial(wide_route, g, d, bdim, num_factors, smem_limit, body=body)
        max_grid = wide_max_grid(d, bdim, num_factors, smem_limit, body)
    if route is None:
        shared = g <= solve_max_grid(bdim, smem_limit) and grid().name == "shared"
        route = "shared" if shared else "large"
    if route == "large":
        return FullstepRoute("large", grid(route="large").tile, body)
    fits = min(max_grid, solve_max_grid(bdim, smem_limit))
    return FullstepRoute(*_choose("decision_update_fullstep", g, fits, TILE_B, _B_CHUNK, route,
                                  None, None), body)


def _check_shapes(name: str, shapes) -> None:
    for arg, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} is {tuple(t.shape)}, want {shape}")


_INFO_FIELDS = ("sims_per_block", "smem_bytes", "smem_limit", "max_grid", "blocks_per_sm",
                "registers")


@functools.lru_cache(maxsize=64)
def _kernel_info(entry: str, g: int, d: int, bdim: int, extra: tuple, device_index: int) -> dict:
    out = (ctypes.c_int * len(_INFO_FIELDS))()
    lib = _build.library()
    with torch.cuda.device(device_index):
        _build.check(getattr(lib, entry)(g, d, bdim, *extra, out), entry)
    return dict(zip(_INFO_FIELDS, out))


def kernel_info(kernel: str, g: int, d: int, bdim: int, device: torch.device,
                large: bool = False, num_factors: int = 0, body: tp.Optional[str] = None) -> dict:
    """Launch report of kernel B (``"moments"``, also run by kernel E),
    the wide body (``"wide"``, the wide route of kernels B and E, at
    ``num_factors`` factors: ``body``, ``wide_body``'s by default) or kernel D
    (``"update"``) at D decisions and B basis functions
    on a CUDA device: B's shared route holding G grid points' records, or
    with ``large`` its large route at a tile of G; the wide body's one kernel
    and D's at a tile of G (``large`` is B's alone): sims per block, shared
    memory bytes per block (static and dynamic), the device's limit per
    block, the largest G (or tile) that route takes at this D and B, blocks
    per SM (0 where G does not fit) and registers per thread.  ``"moments"``
    takes B within its basis cap (``_build.MAX_BASIS``), ``"wide"`` up to
    ``_build.MAX_WIDE_BASIS``, ``"update"`` any B."""
    entry, extra = {"moments": ("stt_decision_update_moments_info", (int(bool(large)),)),
                    "wide": ("stt_decision_update_moments_wide_info",
                             (int(num_factors), int((body or wide_body(bdim)) == "wide-smem"))),
                    "update": ("stt_decision_update_info", ())}[kernel]
    return _kernel_info(entry, g, d, bdim, extra, torch.device(device).index or 0)


def moments_scratch(g: int, bdim: int, s: int, device: torch.device):
    """The scratch of kernel B's moments, for B and for E, which launches
    B's kernel: the per-block partials [nblk, B·B + G·B], one contiguous row
    per block of sims, and the reduced moments [B·B + G·B]: XᵀX, then
    (Xᵀ·best_act)ᵀ as [G, B]."""
    nblk = -(-s // _B_SIMS)
    npairs = bdim * bdim + g * bdim
    return (torch.empty((nblk, npairs), dtype=torch.float32, device=device),
            torch.empty((npairs,), dtype=torch.float32, device=device))


def _split_moments(moments, g: int, bdim: int):
    """(xtx [B, B], xty [B, G]) as views of the reduced moments."""
    return moments[: bdim * bdim].view(bdim, bdim), moments[bdim * bdim:].view(g, bdim).T


def decision_update_moments(
    v: torch.Tensor,             # [G, S] next-period actual values
    spot: torch.Tensor,          # [S] step-t spot
    factors: torch.Tensor,       # [F, S] step-t factors
    spot_prev: torch.Tensor,     # [S] step-(t-1) spot
    factors_prev: torch.Tensor,  # [F, S] step-(t-1) factors
    mean: torch.Tensor,          # [B] step-t design column means
    std: torch.Tensor,           # [B] step-t design column stds
    mean_prev: torch.Tensor,     # [B] centre of the step-(t-1) moments
    std_prev: torch.Tensor,      # [B] scale of the step-(t-1) moments
    idx_lo: torch.Tensor,        # [G, D] int32 lower interpolation row
    w_hi: torch.Tensor,          # [G, D] weight of row idx_lo + 1
    ci: torch.Tensor,            # [D, G, B] interpolated regression coeffs
    a: torch.Tensor,             # [D, G] immediate-pv spot coefficient
    b: torch.Tensor,             # [D, G] immediate-pv constant
    monomials: tp.Sequence[Monomial],
    out: tp.Optional[torch.Tensor] = None,
    route: tp.Optional[str] = None,
):
    """Returns (best_act [G, S], xtx [B, B], xty [B, G]).

    CPU tensors take the plain version.  CUDA tensors launch the kernel and
    must be f32 and contiguous; ``out`` is the [G, S] buffer for best_act and
    must not be ``v`` (the kernel reads every v row until the step ends).
    ``idx_lo`` must lie in [0, G-2], as ``ops.interp.interp_weights`` makes
    it: the kernel does not check it, and checking on the host would wait
    for the device every step.  The route is ``moments_plan``'s, from B, F
    and G: the register kernels within 16 terms and 8 factors, past either
    the wide body up to ``_build.MAX_WIDE_BASIS`` terms (``ValueError``
    beyond, before any launch); ``route`` forces a grid route, or with
    ``WIDE_ROUTES`` a wide body.  ``launches`` counts every launch,
    ``large_launches`` those of the large grid route, ``wide_launches``
    those of the wide body and ``wide_smem_launches`` those of its shared
    row (each counted in ``launches`` too)."""
    if v.device.type == "cpu":
        return decision_update_moments_plain(
            v, spot, factors, spot_prev, factors_prev, mean, std, mean_prev,
            std_prev, idx_lo, w_hi, ci, a, b, monomials,
        )
    g, s = v.shape
    f = factors.shape[0]
    d = ci.shape[0]
    bdim = len(monomials)
    plan = moments_plan(g, d, bdim, f, _build.smem_limit(v.device), route)
    dci = (ci - ci[0:1]).contiguous()
    if out is None:
        out = torch.empty_like(v)
    device = _build.require_cuda(
        "decision_update_moments", v, spot, factors, spot_prev, factors_prev,
        mean, std, mean_prev, std_prev, w_hi, dci, a, b, out,
    )
    _build.require_cuda("decision_update_moments", idx_lo, dtype=torch.int32)
    if idx_lo.device != device:
        raise ValueError("decision_update_moments: idx_lo on another device")
    if out.data_ptr() == v.data_ptr():
        raise ValueError("decision_update_moments: out must not alias v")
    _check_shapes("decision_update_moments", {
        "spot": (spot, (s,)), "factors": (factors, (f, s)),
        "spot_prev": (spot_prev, (s,)), "factors_prev": (factors_prev, (f, s)),
        "mean": (mean, (bdim,)), "std": (std, (bdim,)),
        "mean_prev": (mean_prev, (bdim,)), "std_prev": (std_prev, (bdim,)),
        "idx_lo": (idx_lo, (g, d)), "w_hi": (w_hi, (g, d)),
        "ci": (ci, (d, g, bdim)), "a": (a, (d, g)), "b": (b, (d, g)),
        "out": (out, (g, s)),
    })
    partials, moments = moments_scratch(g, bdim, s, device)
    if plan.wide:
        entry = _build.library().stt_decision_update_moments_wide
        head = (g, plan.tile, s, f, d, bdim, int(plan.body == "wide-smem"),
                _build.wide_basis_table(tuple(monomials), f, device).data_ptr())
    else:
        entry = _build.library().stt_decision_update_moments
        head = (g, plan.tile, s, f, d, _build.basis_table(tuple(monomials), f))
    rc = entry(
        *head, v.data_ptr(), spot.data_ptr(), factors.data_ptr(), spot_prev.data_ptr(),
        factors_prev.data_ptr(), mean.data_ptr(), std.data_ptr(),
        mean_prev.data_ptr(), std_prev.data_ptr(), idx_lo.data_ptr(),
        w_hi.data_ptr(), dci.data_ptr(), a.data_ptr(), b.data_ptr(),
        out.data_ptr(), partials.data_ptr(), moments.data_ptr(),
        _build.stream_handle(device),
    )
    decision_update_moments.launches += 1
    decision_update_moments.large_launches += plan.name == "large"
    decision_update_moments.wide_launches += plan.wide
    decision_update_moments.wide_smem_launches += plan.body == "wide-smem"
    _build.check(rc, "decision_update_moments")
    return (out, *_split_moments(moments, g, bdim))


decision_update_moments.launches = 0
decision_update_moments.large_launches = 0  # those of the large route, counted in launches too
decision_update_moments.wide_launches = 0  # those of the wide body, counted in launches too
decision_update_moments.wide_smem_launches = 0  # those of its shared row, also in wide_launches


def decision_update_plain(v, dm_std_t, spot, idx_lo, w_hi, ci, a, b):
    """Tensor-code version of kernel D; any dtype, any device."""
    return _best_actual(
        decision_values_on_design(v, dm_std_t.T, spot, idx_lo, w_hi, ci, a, b))


def pack_records_plain(idx_lo, w_hi, ci, a, b):
    """Tensor-code version of kernel D's record pack: [G,
    record_words(D, B)] f32, per grid point {a, b, w_hi, idx_lo} (its bits)
    of decision 0, then for each later decision d its entry and its centred
    coefficients ci[d] − ci[0] zero-padded to whole float4s."""
    d, g, bdim = ci.shape
    bp = padded_basis(bdim)
    entries = torch.stack([a.T, b.T, w_hi, idx_lo.to(torch.int32).view(torch.float32)],
                          dim=2)  # [G, D, 4]
    parts = [entries[:, 0]]
    dci = torch.zeros((g, bp), dtype=ci.dtype, device=ci.device)
    for k in range(1, d):
        dci[:, :bdim] = ci[k] - ci[0]
        parts += [entries[:, k], dci.clone()]
    return torch.cat(parts, dim=1)


def pack_records(idx_lo: torch.Tensor, w_hi: torch.Tensor, ci: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """The records of a step for kernel D, as ``pack_records_plain``.
    CPU tensors take the plain version; CUDA tensors launch the pack kernel
    (``csrc/decision_update_kernel.cu``), f32 and contiguous, with ``idx_lo``
    int32; ``launches`` counts its launches."""
    if ci.device.type == "cpu":
        return pack_records_plain(idx_lo, w_hi, ci, a, b)
    d, g, bdim = ci.shape
    records = torch.empty((g, record_words(d, bdim)), dtype=torch.float32, device=ci.device)
    device = _build.require_cuda("pack_records", w_hi, ci, a, b, records)
    _build.require_cuda("pack_records", idx_lo, dtype=torch.int32)
    if idx_lo.device != device:
        raise ValueError("pack_records: idx_lo on another device")
    _check_shapes("pack_records", {"idx_lo": (idx_lo, (g, d)), "w_hi": (w_hi, (g, d)),
                                   "a": (a, (d, g)), "b": (b, (d, g))})
    rc = _build.library().stt_pack_records(
        g, d, bdim, idx_lo.data_ptr(), w_hi.data_ptr(), ci.data_ptr(), a.data_ptr(),
        b.data_ptr(), records.data_ptr(), _build.stream_handle(device))
    pack_records.launches += 1
    _build.check(rc, "pack_records")
    return records


pack_records.launches = 0


def decision_update(
    v: torch.Tensor,         # [G, S] next-period actual values
    dm_std_t: torch.Tensor,  # [B, S] standardised design of step t, transposed
    spot: torch.Tensor,      # [S] step-t spot
    idx_lo: torch.Tensor,    # [G, D] int32 lower interpolation row
    w_hi: torch.Tensor,      # [G, D] weight of row idx_lo + 1
    ci: torch.Tensor,        # [D, G, B] interpolated regression coeffs
    a: torch.Tensor,         # [D, G] immediate-pv spot coefficient
    b: torch.Tensor,         # [D, G] immediate-pv constant
    out: tp.Optional[torch.Tensor] = None,
    route: tp.Optional[str] = None,
):
    """Returns best_act [G, S] (kernel D).

    CPU tensors take the plain version.  CUDA tensors launch the kernel, at
    any basis size and grid, and must be f32 and contiguous; ``out`` is the
    [G, S] buffer for best_act and must not be ``v``.  ``idx_lo`` must lie
    in [0, G-2], as for kernel B, in any order.  Each call launches
    ``pack_records``, then the kernel with ``update_route``'s tile (``route``
    forces one); ``large_launches`` counts the large route's launches, as
    kernel B's wrapper does."""
    if v.device.type == "cpu":
        return decision_update_plain(v, dm_std_t, spot, idx_lo, w_hi, ci, a, b)
    g, s = v.shape
    bdim = dm_std_t.shape[0]
    d = ci.shape[0]
    plan = update_route(g, d, bdim, _build.smem_limit(v.device), route)
    if out is None:
        out = torch.empty_like(v)
    device = _build.require_cuda("decision_update", v, dm_std_t, spot, w_hi, ci, a, b, out)
    _build.require_cuda("decision_update", idx_lo, dtype=torch.int32)
    if idx_lo.device != device:
        raise ValueError("decision_update: idx_lo on another device")
    if out.data_ptr() == v.data_ptr():
        raise ValueError("decision_update: out must not alias v")
    _check_shapes("decision_update", {
        "dm_std_t": (dm_std_t, (bdim, s)), "spot": (spot, (s,)),
        "idx_lo": (idx_lo, (g, d)), "w_hi": (w_hi, (g, d)), "ci": (ci, (d, g, bdim)),
        "a": (a, (d, g)), "b": (b, (d, g)), "out": (out, (g, s)),
    })
    records = pack_records(idx_lo, w_hi, ci, a, b)
    rc = _build.library().stt_decision_update(
        g, plan.tile, s, d, bdim, v.data_ptr(), dm_std_t.data_ptr(), spot.data_ptr(),
        records.data_ptr(), out.data_ptr(), _build.stream_handle(device))
    decision_update.launches += 1
    decision_update.large_launches += plan.name == "large"
    _build.check(rc, "decision_update")
    return out


decision_update.launches = 0
decision_update.large_launches = 0


def decision_update_fullstep_plain(v, spot, factors, spot_prev, factors_prev, xtx, xty,
                                   cmean, cstd, idx_lo, w_hi, a, b, monomials,
                                   mean_prev=None, std_prev=None):
    """Tensor-code version of kernel E; any dtype, any device.  As the
    kernel, it factors the standardised system in double and rounds the
    coefficients to the working dtype once."""
    m, rhs, mu_u, sig_u = standardise_moments(xtx, xty)
    mean = cmean + cstd * mu_u
    std = cstd * sig_u
    coeffs = fit_from_moments(m, rhs, solve_dtype=torch.float64)
    ci = interp_coeffs(coeffs, idx_lo, w_hi)
    best_act, xtx_next, xty_next = decision_update_moments_plain(
        v, spot, factors, spot_prev, factors_prev, mean, std,
        mean if mean_prev is None else mean_prev, std if std_prev is None else std_prev,
        idx_lo, w_hi, ci, a, b, monomials,
    )
    return best_act, xtx_next, xty_next, mean, std, coeffs


def decision_update_fullstep(
    v: torch.Tensor,             # [G, S] next-period actual values
    spot: torch.Tensor,          # [S] step-t spot
    factors: torch.Tensor,       # [F, S] step-t factors
    spot_prev: torch.Tensor,     # [S] step-(t-1) spot
    factors_prev: torch.Tensor,  # [F, S] step-(t-1) factors
    xtx: torch.Tensor,           # [B, B] raw moments of step t's design ...
    xty: torch.Tensor,           # [B, G] ... against v, centred by (cmean, cstd)
    cmean: torch.Tensor,         # [B] centre of those moments
    cstd: torch.Tensor,          # [B] scale of those moments
    idx_lo: torch.Tensor,        # [G, D] int32 lower interpolation row
    w_hi: torch.Tensor,          # [G, D] weight of row idx_lo + 1
    a: torch.Tensor,             # [D, G] immediate-pv spot coefficient
    b: torch.Tensor,             # [D, G] immediate-pv constant
    monomials: tp.Sequence[Monomial],
    mean_prev: tp.Optional[torch.Tensor] = None,  # [B] centre of the step-(t-1) moments
    std_prev: tp.Optional[torch.Tensor] = None,   # [B] scale of the step-(t-1) moments
    out: tp.Optional[torch.Tensor] = None,
    regression_out: tp.Optional[tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    route: tp.Optional[str] = None,
):
    """Returns (best_act [G, S], xtx_next [B, B], xty_next [B, G], mean [B],
    std [B], coeffs [B, G]) of one whole backward step (kernel E).

    The step's stats are composed from the carried moments' own
    (``cmean + cstd·μ_u``, ``cstd·σ_u``), and the regression is solved from
    them.  Without ``mean_prev``/``std_prev`` the next moments are centred by
    those composed stats (the TPU kernel's u-coordinates); with them, by the
    stats given.  CPU tensors take the plain version.  CUDA tensors launch the
    kernels and must be f32 and contiguous, except ``xty``, which may also be
    the transposed view of a contiguous [G, B] (as the kernel returns it);
    ``out`` must not be ``v``; ``regression_out`` are optional buffers for
    (mean, std, coeffs).  The route is ``fullstep_route``'s, its body from B
    and F (the register route within 16 terms and 8 factors, the wide route
    past either, up to ``_build.MAX_WIDE_BASIS`` terms) and its grid route
    from G (``route`` forces one, ``WIDE_ROUTES`` a wide body at any shape
    it takes); ``large_launches`` counts the large grid route's launches, as
    kernel B's wrapper does, ``wide_launches`` the wide route's and
    ``wide_smem_launches`` those of its shared row (each counted in
    ``launches`` too)."""
    if v.device.type == "cpu":
        result = decision_update_fullstep_plain(
            v, spot, factors, spot_prev, factors_prev, xtx, xty, cmean, cstd, idx_lo,
            w_hi, a, b, monomials, mean_prev, std_prev,
        )
        if out is not None:
            out.copy_(result[0])
            result = (out, *result[1:])
        if regression_out is not None:
            for buf, val in zip(regression_out, result[3:]):
                buf.copy_(val)
            result = (*result[:3], *regression_out)
        return result
    g, s = v.shape
    f = factors.shape[0]
    d = idx_lo.shape[1]
    bdim = len(monomials)
    if (mean_prev is None) != (std_prev is None):
        raise ValueError("decision_update_fullstep: pass both mean_prev and std_prev, or neither")
    plan = fullstep_route(g, d, bdim, _build.smem_limit(v.device), route, num_factors=f)
    xty_t = xty.T if xty.T.is_contiguous() else xty.T.contiguous()  # [G, B]
    if out is None:
        out = torch.empty_like(v)
    if regression_out is None:
        regression_out = (torch.empty(bdim, dtype=v.dtype, device=v.device),
                          torch.empty(bdim, dtype=v.dtype, device=v.device),
                          torch.empty((bdim, g), dtype=v.dtype, device=v.device))
    mean, std, coeffs = regression_out
    prev = () if mean_prev is None else (mean_prev, std_prev)
    device = _build.require_cuda(
        "decision_update_fullstep", v, spot, factors, spot_prev, factors_prev, xtx, xty_t,
        cmean, cstd, w_hi, a, b, out, mean, std, coeffs, *prev,
    )
    _build.require_cuda("decision_update_fullstep", idx_lo, dtype=torch.int32)
    if idx_lo.device != device:
        raise ValueError("decision_update_fullstep: idx_lo on another device")
    if out.data_ptr() == v.data_ptr():
        raise ValueError("decision_update_fullstep: out must not alias v")
    shapes = {
        "spot": (spot, (s,)), "factors": (factors, (f, s)), "spot_prev": (spot_prev, (s,)),
        "factors_prev": (factors_prev, (f, s)), "xtx": (xtx, (bdim, bdim)),
        "xty": (xty, (bdim, g)), "cmean": (cmean, (bdim,)), "cstd": (cstd, (bdim,)),
        "idx_lo": (idx_lo, (g, d)), "w_hi": (w_hi, (g, d)), "a": (a, (d, g)),
        "b": (b, (d, g)), "out": (out, (g, s)), "mean": (mean, (bdim,)),
        "std": (std, (bdim,)), "coeffs": (coeffs, (bdim, g)),
    }
    if prev:
        shapes.update(mean_prev=(mean_prev, (bdim,)), std_prev=(std_prev, (bdim,)))
    _check_shapes("decision_update_fullstep", shapes)
    partials, moments = moments_scratch(g, bdim, s, device)
    dci = torch.empty((d, g, bdim), dtype=torch.float32, device=device)
    large = plan.name == "large"
    # The large route's solve scratch: coefficients [B, G], the ridged
    # m[0, 0], a flag a block of columns (csrc/fullstep_kernel.cu).
    scratch = torch.empty((bdim * g + 1 + -(-g // _SOLVE_COLUMNS),), dtype=torch.float32,
                          device=device) if large else None
    if plan.wide:
        entry = _build.library().stt_decision_update_fullstep_wide
        basis = (bdim, int(plan.body == "wide-smem"),
                 _build.wide_basis_table(tuple(monomials), f, device).data_ptr())
    else:
        entry = _build.library().stt_decision_update_fullstep
        basis = (_build.basis_table(tuple(monomials), f),)
    rc = entry(
        g, plan.tile, int(large), s, f, d, *basis, ridge_for(torch.float32), v.data_ptr(), spot.data_ptr(), factors.data_ptr(), spot_prev.data_ptr(),
        factors_prev.data_ptr(), xtx.data_ptr(), xty_t.data_ptr(), cmean.data_ptr(),
        cstd.data_ptr(), mean_prev.data_ptr() if prev else None,
        std_prev.data_ptr() if prev else None, idx_lo.data_ptr(), w_hi.data_ptr(),
        a.data_ptr(), b.data_ptr(), out.data_ptr(), mean.data_ptr(), std.data_ptr(),
        coeffs.data_ptr(), dci.data_ptr(), None if scratch is None else scratch.data_ptr(),
        partials.data_ptr(), moments.data_ptr(), _build.stream_handle(device),
    )
    decision_update_fullstep.launches += 1
    decision_update_fullstep.large_launches += large
    decision_update_fullstep.wide_launches += plan.wide
    decision_update_fullstep.wide_smem_launches += plan.body == "wide-smem"
    _build.check(rc, "decision_update_fullstep")
    return (out, *_split_moments(moments, g, bdim), mean, std, coeffs)


decision_update_fullstep.launches = 0
decision_update_fullstep.large_launches = 0
decision_update_fullstep.wide_launches = 0  # those of the wide route, counted in launches too
decision_update_fullstep.wide_smem_launches = 0  # those of its shared row, also in wide_launches
