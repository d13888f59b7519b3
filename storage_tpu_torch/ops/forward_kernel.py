"""The forward LSMC pass per sim (kernel C), as one sweep over every step.

Counterpart of ``storage_tpu.ops.forward_kernel.forward_step_pallas``, which
the JAX engine runs once per step of its forward scan: the design row, the
fitted continuation at each candidate decision's target inventory, ratchet
lookup, the bang-bang decision set, the immediate value and a first-max
argmax, then the new inventory/PV, the chosen volume/fuel and the step's
cross-sim sums.  The fitted continuation is evaluated only at the two grid
rows each decision touches (``coeffs[:, row]·dm`` at lo and lo + 1), in plain
f32 — the JAX kernel's ``pred_passes=1`` arithmetic.

``csrc/forward_kernel.cu`` is the kernel: ``forward_sweep`` launches it once
for all N steps (``forward_step`` is the sweep at N = 1), at any monomial
basis of up to 64 terms on any factor count (compiled per B within 16 terms
and 8 factors, past either on its wide route, ``sweep_wide``).  Its design mode,
``forward_sweep_design``, reads each step's raw design [B, S] from memory
instead of building it from monomials: ``forward_sweep_generic`` runs it for
a basis with user callables, building the design ``DESIGN_CHUNK`` steps at a
time and launching once per chunk.  Either mode places target inventories
on evenly spaced grid rows by arithmetic or, given the rows (``grid``), on
custom rows by search: the general-grid mode.  Every mode takes any grid,
on one of two routes decided from the shape before anything is allocated
(``sweep_route``): the shared route stages each step's whole packed row,
coefficients included, in the kernel's ring while two rows fit a block's
shared memory (``kernel_info`` gives the largest grid) and leave it
``SHARED_MIN_BLOCKS`` blocks an SM; the large route
(``csrc/forward_kernel_large.cu``) stages the row's fixed part alone and
reads the coefficients, packed [G, Bp] in 16-byte words, and the grid rows
from device memory.  Both give the same bits.  The general-grid mode finds
a target's lower node from a bucket index over each next grid row that a
small kernel builds before the sweep (``general_tail``), not by a binary
search of the whole row; ``indexed_weights_plain`` is that search in tensor
code.  ``forward_step_plain`` is one step in tensor code and
``forward_sweep_plain`` its loop over the steps, used for CPU tensors.  The ratchet lookup and the decision fractions follow the
TPU kernel (``_ratchet_rates_smem``, ``_bang_bang``), so the plain version
agrees with it term for term.

Adjoint deltas differentiate the pricing run's own sweep in the forward
curve: ``forward_sweep_vjp`` (``csrc/forward_vjp.cu``), run on the volume and
fuel rows each launch of the sweep wrote (grad[t] reads row t alone, so a
streamed run takes it a segment at a time).
"""
from __future__ import annotations

import ctypes
import functools
import typing as tp

import torch

from ..basis import design_columns, design_matrix
from . import _build, interp

# Parameter slots (the JAX kernel's SMEM vector layout).
_P_DF_SETTLE = 0
_P_DF_FLOW = 1
_P_INJ_COST = 2
_P_WDR_COST = 3
_P_INJ_PCNT = 4
_P_WDR_PCNT = 5
_P_LOSS_PCNT = 6
_P_INV_COST = 7
_P_NEXT_MIN = 8
_P_NEXT_MAX = 9
_P_GRID_LO = 10
_P_GRID_HI = 11
_P_GRID_INVDELTA = 12  # 1/delta, or 0 for a degenerate grid
NUM_PARAMS = 13

# Sum slots: expected inventory, volume, fuel, loss, immediate value and the
# pathwise-delta numerator; slots 6 and 7 stay zero.
_A_INV = 0
_A_DEC = 1
_A_CONS = 2
_A_LOSS = 3
_A_IMM = 4
_A_DELTA = 5
NUM_SUMS = 8


def pack_params(x: tp.Dict[str, torch.Tensor], grid_next,
                dtype=torch.float32) -> torch.Tensor:
    """The step scalars as the kernel's parameter vector [..., 13]; ``x``
    holds [...]-shaped scalars and ``grid_next`` is [..., G].  The kernel
    reads f32; an f64 run of the plain version keeps f64."""
    g = grid_next.shape[-1]
    lo = grid_next[..., 0]
    hi = grid_next[..., g - 1]
    span = hi - lo
    inv_delta = torch.where(
        span / (g - 1) > 0, (g - 1) / torch.where(span > 0, span, torch.ones_like(span)),
        torch.zeros_like(span),
    )
    vals = [
        x["df_settle"], x["df_flow"], x["inj_cost"], x["wdr_cost"],
        x["inj_pcnt"], x["wdr_pcnt"], x["loss_pcnt"], x["inv_cost_rate"],
        x["next_min"], x["next_max"], lo, hi, inv_delta,
    ]
    return torch.stack([torch.as_tensor(v) for v in vals], dim=-1).to(dtype)


def _ratchet_rates(r_inv, r_min, r_max, is_step: bool, inv):
    """The TPU kernel's ratchet lookup (``_ratchet_rates_smem``)."""
    num_nodes = r_inv.shape[0]
    inv_c = torch.minimum(torch.maximum(inv, r_inv[0]), r_inv[num_nodes - 1])
    min_rate = r_min[0].expand(inv_c.shape)
    max_rate = r_max[0].expand(inv_c.shape)
    if is_step:
        for r in range(1, num_nodes):
            sel = inv_c >= r_inv[r]
            min_rate = torch.where(sel, r_min[r], min_rate)
            max_rate = torch.where(sel, r_max[r], max_rate)
        return min_rate, max_rate
    for r in range(num_nodes - 1):
        x0 = r_inv[r]
        span = r_inv[r + 1] - x0
        safe = torch.where(span > 0, span, torch.ones_like(span))
        w = torch.clamp((inv_c - x0) / safe, 0.0, 1.0)
        seg_min = r_min[r] * (1 - w) + r_min[r + 1] * w
        seg_max = r_max[r] * (1 - w) + r_max[r + 1] * w
        sel = inv_c >= x0 if r > 0 else torch.ones_like(inv_c, dtype=torch.bool)
        min_rate = torch.where(sel, seg_min, min_rate)
        max_rate = torch.where(sel, seg_max, max_rate)
    return min_rate, max_rate


def _bang_bang(min_rate, max_rate, inventory, loss_pcnt, next_min, next_max,
               num_extra_decisions: int):
    """The decision volumes as a list of [S] tensors; the slot fractions are
    computed in double and rounded once, as the TPU kernel does."""
    inv_after_loss = inventory - loss_pcnt * inventory
    w_target = min_rate + inv_after_loss
    yielded_w = torch.where(
        w_target > next_max, next_max - inv_after_loss,
        torch.where(w_target > next_min, min_rate, next_min - inv_after_loss),
    )
    i_target = max_rate + inv_after_loss
    yielded_i = torch.where(
        i_target < next_min, next_min - inv_after_loss,
        torch.where(i_target < next_max, max_rate, next_max - inv_after_loss),
    )
    has_zero = (yielded_w < 0.0) & (yielded_i > 0.0)
    e = num_extra_decisions
    d = 2 * e + 3
    mid = e + 1
    out = []
    for k in range(d):
        if k <= mid:
            with_zero = yielded_w * (1.0 - k / mid)
        else:
            with_zero = yielded_i * ((k - mid) / mid)
        frac = max(k - 1.0, 0.0) / (d - 2)
        without_zero = yielded_w + (yielded_i - yielded_w) * frac
        out.append(torch.where(has_zero, with_zero, without_zero))
    return out


def decision_candidates(params, mean, std, ratchet_inv, ratchet_min, ratchet_max,
                        spot, factors, inventory, coeffs, monomials,
                        num_extra_decisions: int, ratchet_is_step: bool, design=None,
                        grid=None):
    """Per decision, its total value [S] (immediate plus fitted continuation)
    and the path quantities it would set, in the kernel's arithmetic order;
    with the standardised design [S, B] and the inventory loss [S].  The raw
    design is ``design`` [B, S] where one is given (design mode), else the
    monomials' on ``spot`` and ``factors``.  With ``grid``, the next step's
    grid row [G] (general-grid mode), a target inventory's rows and weight
    are ``interp.interp_weights_general``'s on it; without, the position
    arithmetic of an evenly spaced row from ``params``."""
    # [S, B] in the monomials' layout, so that the summed row adds alike.
    raw = design.T.contiguous() if design is not None else design_matrix(monomials, spot, factors)
    dm = (raw - mean) / std  # [S, B]
    g = coeffs.shape[1]
    par = params.to(spot.dtype)
    min_rate, max_rate = _ratchet_rates(
        ratchet_inv, ratchet_min, ratchet_max, ratchet_is_step, inventory
    )
    decisions = _bang_bang(
        min_rate, max_rate, inventory, par[_P_LOSS_PCNT], par[_P_NEXT_MIN],
        par[_P_NEXT_MAX], num_extra_decisions,
    )
    loss = par[_P_LOSS_PCNT] * inventory
    inv_cost_npv = par[_P_INV_COST] * inventory * par[_P_DF_FLOW]
    coeffs_t = coeffs.T  # [G, B]

    def pred_at(row):
        c = coeffs_t[row]  # [S, B]
        p = c[:, 0] * dm[:, 0]
        for k in range(1, dm.shape[1]):
            p = p + c[:, k] * dm[:, k]
        return p

    candidates = []
    for dec in decisions:
        inv_after = inventory + dec - loss
        if grid is not None:
            lo, w = interp.interp_weights_general(grid, inv_after)
        else:
            clipped = torch.minimum(torch.maximum(inv_after, par[_P_GRID_LO]), par[_P_GRID_HI])
            pos = (clipped - par[_P_GRID_LO]) * par[_P_GRID_INVDELTA]
            lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, g - 2)
            w = torch.clamp(pos - lo.to(pos.dtype), 0.0, 1.0)
        cont = pred_at(lo) * (1 - w) + pred_at(lo + 1) * w
        is_inject = dec > 0.0
        abs_d = torch.abs(dec)
        consumed = torch.where(is_inject, par[_P_INJ_PCNT], par[_P_WDR_PCNT]) * abs_d
        cost_npv = torch.where(is_inject, par[_P_INJ_COST], par[_P_WDR_COST]) * abs_d * par[_P_DF_FLOW]
        imm = -(dec + consumed) * par[_P_DF_SETTLE] * spot - cost_npv - inv_cost_npv
        candidates.append((imm + cont, {"dec": dec, "cons": consumed, "imm": imm, "inv": inv_after}))
    return candidates, dm, loss


def forward_step_plain(params, mean, std, ratchet_inv, ratchet_min, ratchet_max,
                       spot, factors, inventory, pv, coeffs, monomials,
                       num_extra_decisions: int, ratchet_is_step: bool, imm_out=None,
                       design=None, grid=None):
    """Tensor-code version of the kernel; any dtype, any device.  The chosen
    immediate PV per sim goes to ``imm_out`` where one is given; ``design``
    and ``grid`` as for ``decision_candidates``."""
    candidates, dm, loss = decision_candidates(
        params, mean, std, ratchet_inv, ratchet_min, ratchet_max, spot, factors,
        inventory, coeffs, monomials, num_extra_decisions, ratchet_is_step, design, grid,
    )
    best, opt = candidates[0]
    for total, cand in candidates[1:]:
        better = total > best
        best = torch.where(better, total, best)
        opt = {k: torch.where(better, cand[k], opt[k]) for k in opt}
    zero = torch.zeros((), dtype=spot.dtype, device=spot.device)
    sums = torch.stack([
        inventory.sum(), opt["dec"].sum(), opt["cons"].sum(), loss.sum(),
        opt["imm"].sum(), (-(opt["dec"] + opt["cons"]) * spot).sum(), zero, zero,
    ])
    if imm_out is not None:
        imm_out.copy_(opt["imm"])
    return opt["inv"], pv + opt["imm"], opt["dec"], opt["cons"], sums, dm.sum(dim=0)


def forward_sweep_plain(params, mean, std, ratchet_inv, ratchet_min, ratchet_max, spot,
                        factors, inventory, pv, coeffs, monomials, num_extra_decisions: int,
                        ratchet_is_step: bool, panels=None, out=None, design=None, grid=None):
    """Tensor-code version of the sweep: ``forward_step_plain`` once per step;
    any dtype, any device.  Arguments and results as ``forward_sweep``'s; with
    ``design`` [N, B, S] (design mode, ``forward_sweep_design``) the steps read
    it, and ``factors`` and ``monomials`` are not read; with ``grid`` [N, G],
    each step's next grid row, the general-grid mode."""
    rows = list(panels) if panels is not None else [None] * 4
    pv = torch.zeros_like(inventory) if pv is None else pv
    sums, xbar = [], []
    for t in range(spot.shape[0]):
        inventory, pv, dec, cons, sums_t, xbar_t = forward_step_plain(
            params[t], mean[t], std[t], ratchet_inv[t], ratchet_min[t], ratchet_max[t],
            spot[t], None if factors is None else factors[t], inventory, pv, coeffs[t],
            monomials, num_extra_decisions, ratchet_is_step,
            None if rows[3] is None else rows[3][t], None if design is None else design[t],
            None if grid is None else grid[t],
        )
        for buf, val in zip(rows[:3], (inventory, dec, cons)):
            if buf is not None:
                buf[t].copy_(val)
        sums.append(sums_t)
        xbar.append(xbar_t)
    if out is not None:
        out[0].copy_(inventory)
        out[1].copy_(pv)
        inventory, pv = out
    return inventory, pv, torch.stack(sums), torch.stack(xbar)


# The kernel's sums go out per group of this many sims (csrc/forward_kernel.cu
# kThreads): the partials scratch has one row per step, sum and group.
_GROUP = 256
_TABLE_PARTS = ("params", "mean", "std", "ratchet_inv", "ratchet_min", "ratchet_max", "coeffs",
                "grid")


def general_words(g: int) -> int:
    """Floats of a step's general tail (``general_tail``): the grid row [G],
    its bucket scale, its bucket index [G] (csrc/forward_sweep.cuh
    general_words)."""
    return 2 * g + 1


def _count_dtype(dtype: torch.dtype) -> torch.dtype:
    """The integer type whose bits a general tail of ``dtype`` holds its
    counts in."""
    return torch.int32 if dtype == torch.float32 else torch.int64


def general_tail_plain(grid: torch.Tensor) -> torch.Tensor:
    """Each next grid row [N, G] with its bucket index, as the kernel's
    general-grid mode reads it (f32; f64 rows give the same layout in f64
    for the plain search): [N, 2G + 1], the row, then its scale
    K / (row[G-1] − row[0]) over K = G − 1 uniform buckets, then the counts
    cnt [G] (the bits of int32, int64 in f64): cnt[i] the interior nodes
    whose bucket, floor((node − row[0])·scale) within [0, K − 1] with each
    operation rounded on its own (the kernel's arithmetic), is below i.  The
    rows are non-decreasing, as ``interp.interp_weights_general`` takes them
    (a custom grid's rows are sorted); on others the index is not defined."""
    rows = grid.contiguous()
    ints = _count_dtype(rows.dtype)
    n, g = rows.shape
    a, b = rows[:, :1], rows[:, g - 1:]
    span = b - a
    # A tensor division (a scalar over a tensor multiplies by its reciprocal).
    scale = torch.where(span > 0, torch.full_like(span, g - 1) / torch.where(
        span > 0, span, torch.ones_like(span)), torch.zeros_like(span))
    pos = torch.floor((rows[:, 1:g - 1] - a) * scale).clamp(min=0, max=g - 2)
    buckets = pos.to(ints).contiguous()
    edges = torch.arange(g, dtype=ints, device=rows.device).expand(n, g).contiguous()
    counts = torch.searchsorted(buckets, edges).to(ints).contiguous()
    return torch.cat([rows, scale, counts.view(rows.dtype)], dim=1)


def general_tail(grid: torch.Tensor, out: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """``general_tail_plain``'s tails of the rows ``grid`` [N, G] into ``out``
    ([N, 2G + 1], rows at any stride: the packed table's tail columns), or a
    new [N, 2G + 1].  CPU tensors take the plain version; CUDA tensors (f32,
    ``grid`` contiguous) launch the index kernel (``csrc/forward_kernel.cu``
    general_tail_kernel, one block a row), and ``launches`` counts it."""
    if grid.device.type == "cpu":
        tail = general_tail_plain(grid)
        return tail if out is None else out.copy_(tail)
    n, g = grid.shape
    width = general_words(g)
    if out is None:
        out = torch.empty((n, width), dtype=torch.float32, device=grid.device)
    device = _build.require_cuda("general_tail", grid)
    if (out.device != device or out.dtype != torch.float32
            or tuple(out.shape) != (n, width) or out.stride(1) != 1):
        raise ValueError(f"general_tail: out is {out.dtype} {tuple(out.shape)} at strides "
                         f"{out.stride()} on {out.device}, want float32 ({n}, {width}) "
                         f"with contiguous rows on {device}")
    rc = _build.library().stt_general_tail(n, g, grid.data_ptr(), out.data_ptr(), out.stride(0),
                                           _build.stream_handle(device))
    general_tail.launches += 1
    _build.check(rc, "general_tail")
    return out


general_tail.launches = 0


def general_brackets(tail: torch.Tensor) -> torch.Tensor:
    """The nodes each bucket of ``general_tail``'s rows brackets, [N, K]:
    the widths that the kernel's in-bucket search covers."""
    g = (tail.shape[-1] - 1) // 2
    counts = tail[..., g + 1:].contiguous().view(_count_dtype(tail.dtype))
    return counts[..., 1:] - counts[..., :-1]


def indexed_weights_plain(tail: torch.Tensor, x: torch.Tensor):
    """The kernel's search of the general-grid mode in tensor code: (idx_lo,
    w_hi) for ``x`` [N, *q] on the rows of ``tail`` [N, 2G + 1]
    (``general_tail``; one row [2G + 1] with any ``x`` too): the bucket of
    the clamped x, then a binary search within its bracket [cnt[i],
    cnt[i + 1]], and the weight as ``interp.interp_weights_general`` takes
    it: that function's answer on the non-decreasing rows it takes."""
    if tail.dim() == 1:
        idx, w = indexed_weights_plain(tail[None], x.reshape(1, -1))
        return idx.reshape(x.shape), w.reshape(x.shape)
    n = tail.shape[0]
    g = (tail.shape[-1] - 1) // 2
    grid, scale = tail[:, :g], tail[:, g:g + 1]
    counts = tail[:, g + 1:].contiguous().view(_count_dtype(tail.dtype)).to(torch.int64)
    flat = x.reshape(n, -1)
    xc = torch.minimum(torch.maximum(flat, grid[:, :1]), grid[:, g - 1:])
    bucket = torch.floor((xc - grid[:, :1]) * scale).clamp(min=0, max=g - 2).to(torch.int64)
    lo = torch.gather(counts, 1, bucket) + 1
    hi = torch.gather(counts, 1, bucket + 1) + 1
    for _ in range(max(g, 2).bit_length()):
        active = lo < hi
        mid = (lo + hi) // 2
        below = torch.gather(grid, 1, torch.clamp(mid, max=g - 1)) <= xc
        lo = torch.where(active & below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
    idx = lo - 1
    x0 = torch.gather(grid, 1, idx)
    x1 = torch.gather(grid, 1, idx + 1)
    span = x1 - x0
    w = torch.where(span > 0, (xc - x0) / torch.where(span > 0, span, torch.ones_like(span)),
                    torch.zeros_like(span))
    return idx.reshape(x.shape), w.reshape(x.shape)


def padded_basis(bdim: int) -> int:
    """The large route's coefficient row width: B padded to whole 16-byte
    words (csrc/forward_sweep.cuh padded_basis)."""
    return -(-bdim // 4) * 4


def table_layout(bdim: int, r: int, g: int, general: bool = False, large: bool = False):
    """Offsets (in floats) of each part of one step's packed table, and its
    width W: the parameters, mean [B], std [B], ratchet inventories, min and
    max rates [R] each, coefficients [B, G] row by row, in general-grid mode
    the general tail [2G + 1] (``general_tail``, at "grid"), padded with
    zeros to a multiple of 4 floats (whole 16-byte words for the kernel's
    bulk copy).  On the large route (``large``) the row holds the parts
    before the coefficients alone."""
    g = 0 if large else g
    sizes = (NUM_PARAMS, bdim, bdim, r, r, r, bdim * g, general_words(g) if general and g else 0)
    offsets, pos = {}, 0
    for name, n in zip(_TABLE_PARTS, sizes):
        offsets[name] = pos
        pos += n
    return offsets, -(-pos // 4) * 4


def pack_tables(params, mean, std, ratchet_inv, ratchet_min, ratchet_max, coeffs, grid=None,
                large: bool = False):
    """Every step's tables as the kernel reads them, one row of W floats a
    step: [N, W] f32 (``table_layout``; with ``grid`` [N, G], the
    general-grid mode, each row ends with its ``general_tail``).  On the
    large route (``large``) the rows hold the fixed parts alone, and the
    coefficients go beside them as [N, G, Bp] f32, each grid row's B terms
    adjacent and zero-padded to ``padded_basis`` (16-byte loads of a
    decision's rows lo and lo + 1), with the general tails [N, 2G + 1] (None
    without ``grid``): returns (table, coefficients, tails)."""
    n, bdim, g = coeffs.shape
    offsets, width = table_layout(bdim, ratchet_inv.shape[1], g, grid is not None, large)
    parts = [params, mean, std, ratchet_inv, ratchet_min, ratchet_max]
    if not large:
        parts.append(coeffs.reshape(n, bdim * g))
    table = torch.cat([p.to(torch.float32) for p in parts], dim=1)
    table = torch.nn.functional.pad(table, (0, width - table.shape[1])).contiguous()
    rows = None if grid is None else grid.to(torch.float32).contiguous()
    tail = None
    if rows is not None and large:
        tail = general_tail(rows)
    elif rows is not None:
        general_tail(rows, out=table[:, offsets["grid"]:offsets["grid"] + general_words(g)])
    if large:
        coef = torch.nn.functional.pad(coeffs.transpose(1, 2).to(torch.float32),
                                       (0, padded_basis(bdim) - bdim))
        return table, coef.contiguous(), tail
    return table


ROUTES = ("shared", "large")
# The sweep's sizing, copied from csrc/forward_kernel.cu and
# forward_sweep.cuh so that the route is decided from shapes on any device;
# chip_smoke.py holds it to ``kernel_info``'s max_grid.  A block of 256
# sims; dynamic shared memory of two ring stages of a row (its padding
# counted at its most) and of the sims' spot and V staged values, the
# decision fractions [2, D], on the wide route (``sweep_wide``) the warps'
# sums and, in the monomial mode, each sim's design row [B, 256] and the
# powers [B, F + 1] int8 in whole words; on the shared route also the two
# rows' coefficients (and general tails: a grid node and a bucket count a
# grid point, and the scale), B + 2·general words a grid point a stage.
# Static: two mbarriers, the warps' sums of two steps [2][8 warps][6 + B]
# (one float on the wide route) and, in the monomial mode, the basis terms
# [B][10] ints (none on the wide route), laid out in 128-byte units.
_SWEEP_SIMS = 256
_SWEEP_WARPS = _SWEEP_SIMS // 32
_STAGES = 2
_USED_SUMS = 6


def sweep_wide(bdim: int, v: int, design: bool = False) -> bool:
    """Whether the sweep takes its wide route (the basis size known at run
    time, csrc/forward_sweep.cuh is_wide) at B terms and V staged values a
    sim (the F factors, or B in design mode): past ``_build.MAX_BASIS``
    terms, and in the monomial mode also past ``_build.MAX_FACTORS``
    factors.  Not a fallback: the route is the shape's."""
    return bdim > _build.MAX_BASIS or (not design and v > _build.MAX_FACTORS)


def _sweep_fixed_words(bdim: int, r: int, v: int, e: int, design: bool) -> int:
    wide = 0
    if sweep_wide(bdim, v, design):
        wide = 2 * _SWEEP_WARPS * (_USED_SUMS + bdim) + (
            0 if design else bdim * _SWEEP_SIMS + -(-bdim * (v + 1) // 4))
    return (_STAGES * (NUM_PARAMS + 2 * bdim + 3 * r + 3 + (1 + v) * _SWEEP_SIMS)
            + 2 * (2 * e + 3) + wide)


def _sweep_static_bytes(bdim: int, v: int, design: bool) -> int:
    if sweep_wide(bdim, v, design):
        raw = 16 + 4
    else:
        raw = 16 + 4 * 2 * _SWEEP_WARPS * (_USED_SUMS + bdim) + (
            0 if design else 4 * bdim * (_build.MAX_FACTORS + 2))
    return -(-raw // 128) * 128


def sweep_max_grid(bdim: int, r: int, v: int, e: int, smem_limit: int, design: bool = False,
                   general: bool = False) -> int:
    """The largest G of the sweep's shared route at B basis functions, R
    ratchet nodes, V staged values a sim (the F factors, or B in design
    mode) and E extra decisions, under ``smem_limit`` bytes a block."""
    room = ((smem_limit - _sweep_static_bytes(bdim, v, design)) // 4
            - _sweep_fixed_words(bdim, r, v, e, design) - _STAGES * int(general))
    return room // (_STAGES * (bdim + 2 * int(general))) if room >= 0 else 0


# The sweep keeps its shared route while that route's shared memory leaves
# at least this many blocks of 256 sims an SM: its large route runs at 4–5
# (registers), and in turns at B = 4 and 9, G = 400 to 3,000 on an H100 the
# shared route won at 4 or more and lost at 3 or fewer in every mode but
# the design mode at B = 4, within 3–10% there (PERF.md §6).  The wide
# route (``sweep_wide``) keeps its shared route while it fits: its large
# route reads the coefficients in a loop of run-time length, and in the
# design mode in turns at B = 20 (G = 50 to 400) and 32 (G = 50 to 400) it
# lost at 1 to 4 blocks an SM alike; the monomial mode's wide route runs the
# same loop.
SHARED_MIN_BLOCKS = 4


def sweep_blocks_per_sm(g: int, bdim: int, r: int, v: int, e: int, smem_limit: int,
                        design: bool = False, general: bool = False) -> int:
    """Blocks of the sweep's shared route an SM at G grid points, as its
    shared memory allows them (the copied sizing; its registers, which the
    compiler chooses, not counted)."""
    words = (_sweep_fixed_words(bdim, r, v, e, design) + _STAGES * int(general)
             + _STAGES * (bdim + 2 * int(general)) * g)
    return _build.blocks_per_sm(_sweep_static_bytes(bdim, v, design) + 4 * words, _SWEEP_SIMS,
                                _build.SM_BLOCKS, smem_limit)


def sweep_route(g: int, bdim: int, r: int, v: int, e: int, smem_limit: int,
                design: bool = False, general: bool = False,
                route: tp.Optional[str] = None) -> str:
    """The sweep's route (``route`` forces one), from the shape and the
    card's shared memory a block (``_build.smem_limit``): "shared" while G
    fits it (``sweep_max_grid``) and, off the wide route (``sweep_wide``),
    it leaves ``SHARED_MIN_BLOCKS`` blocks an SM (``sweep_blocks_per_sm``),
    else "large"."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"forward_sweep: route must be one of {ROUTES}, got {route!r}")
    max_grid = sweep_max_grid(bdim, r, v, e, smem_limit, design, general)
    route = route or ("shared" if g <= max_grid and (
        sweep_wide(bdim, v, design)
        or sweep_blocks_per_sm(g, bdim, r, v, e, smem_limit, design, general)
        >= SHARED_MIN_BLOCKS) else "large")
    fixed = (_sweep_static_bytes(bdim, v, design)
             + 4 * _sweep_fixed_words(bdim, r, v, e, design))
    if (route == "shared" and g > max_grid) or fixed > smem_limit:
        raise ValueError(
            f"forward_sweep: the {route} route at B={bdim}, R={r}, V={v} staged values a sim "
            f"and E={e} takes at most G={max_grid if route == 'shared' else 0} grid points in "
            f"{smem_limit} bytes of shared memory a block, got G={g}")
    return route


_INFO_FIELDS = ("sims_per_block", "smem_bytes", "smem_limit", "max_grid", "blocks_per_sm",
                "registers")


@functools.lru_cache(maxsize=64)
def _kernel_info(g: int, bdim: int, r: int, f: int, e: int, design: bool, general: bool,
                 large: bool, device_index: int) -> dict:
    out = (ctypes.c_int * len(_INFO_FIELDS))()
    lib = _build.library()
    with torch.cuda.device(device_index):
        if large:
            rc = lib.stt_forward_sweep_large_info(bdim, r, f, e, int(design), int(general), out)
        else:
            rc = lib.stt_forward_sweep_info(g, bdim, r, f, e, int(design), int(general), out)
        _build.check(rc, "stt_forward_sweep_info")
    return dict(zip(_INFO_FIELDS, out))


def kernel_info(g: int, bdim: int, r: int, f: int, e: int, device, design: bool = False,
                general: bool = False, large: bool = False) -> dict:
    """Launch report of the sweep kernel at G grid points, B basis functions,
    R ratchet nodes, F factors and E extra decisions on a CUDA device: sims
    per block, shared memory bytes per block (static and dynamic: the
    two-stage ring of step tables and per-sim values, and the decision
    fractions), the device's limit per block, the largest G
    within it, blocks per SM (0 where G does not fit) and registers per
    thread.  The monomial mode takes B up to ``_build.MAX_WIDE_BASIS`` and
    any F (past ``_build.MAX_BASIS`` or ``_build.MAX_FACTORS`` on its wide
    route, ``sweep_wide``).  ``design`` reports the design mode, which
    stages B design values a sim in place of the F factors (F is not read)
    and takes any B (beyond ``_build.MAX_BASIS`` on its wide route);
    ``general`` the general-grid mode, whose tables hold one
    more row of G a step.  This is the shared route's report, whose max_grid
    is the largest G that route takes; ``large`` gives the large route's,
    whose shared memory does not grow with G (max_grid 2**31 − 1)."""
    return _kernel_info(0 if large else g, bdim, r, f, e, bool(design), bool(general),
                        bool(large), torch.device(device).index or 0)


def sass_name(bdim: int, design: bool = False, general: bool = False,
              large: bool = False) -> str:
    """What the mangled name of the sweep kernel compiled for B basis
    functions (in design mode with ``design``, general-grid mode with
    ``general``, on the large route with ``large``) holds (for
    ``_build.sass_instructions``)."""
    return f"forward_sweep_kernelILi{bdim}ELb{int(design)}ELb{int(general)}ELb{int(large)}EE"


def _launch_sweep(name, params, mean, std, ratchet_inv, ratchet_min, ratchet_max, spot, values,
                  inventory, pv, coeffs, monomials, num_extra_decisions, ratchet_is_step, panels,
                  out, grid, route):
    """Checks and launches the sweep in either mode: ``values`` [N, V, S] are
    the factors (``monomials`` given) or the raw design (``monomials`` None,
    V = B); ``grid`` [N, G] the next steps' grid rows of the general-grid
    mode, or None; on ``sweep_route``'s route (``route`` forces one).
    Returns (inventory, pv, sums, xbar_sum), the C call's code, the route
    and whether it took the wide route (``sweep_wide``)."""
    design = monomials is None
    general = grid is not None
    n, s = spot.shape
    v = values.shape[1]
    bdim, g = coeffs.shape[1:]
    f = 0 if design else v
    r = ratchet_inv.shape[1]
    if not design:
        _build.require_wide_basis(name, bdim)
    wide = sweep_wide(bdim, v, design)
    route = sweep_route(g, bdim, r, v, num_extra_decisions, _build.smem_limit(spot.device),
                        design, general, route)
    large = route == "large"
    rows = list(panels) if panels is not None else [None] * 4
    outs = list(out) if out is not None else [
        torch.empty(s, dtype=torch.float32, device=spot.device) for _ in range(2)]
    given = [t for t in (pv, *rows, grid) if t is not None]
    device = _build.require_cuda(
        name, params, mean, std, ratchet_inv, ratchet_min, ratchet_max, spot,
        values, inventory, coeffs, *outs, *given,
    )
    shapes = {
        "params": (params, (n, NUM_PARAMS)), "mean": (mean, (n, bdim)), "std": (std, (n, bdim)),
        "ratchet_min": (ratchet_min, (n, r)), "ratchet_max": (ratchet_max, (n, r)),
        ("design" if design else "factors"): (values, (n, bdim if design else f, s)),
        "coeffs": (coeffs, (n, bdim, g)), **({"grid": (grid, (n, g))} if general else {}),
        "inventory": (inventory, (s,)), **({"pv": (pv, (s,))} if pv is not None else {}),
        **{f"out[{i}]": (o, (s,)) for i, o in enumerate(outs)},
        **{f"panels[{i}]": (p, (n, s)) for i, p in enumerate(rows) if p is not None},
    }
    for key, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} is {tuple(t.shape)}, want {shape}")
    if not design and len(monomials) != bdim:
        raise ValueError(f"{name}: coeffs rows must match the basis")
    table = pack_tables(params, mean, std, ratchet_inv, ratchet_min, ratchet_max, coeffs, grid,
                        large)
    if large:
        table, coeffs_gb, tails = table
        tables = (table.data_ptr(), coeffs_gb.data_ptr(), _ptr_or_none(tails))
    else:
        tables = (table.data_ptr(),)
    nout = NUM_SUMS + bdim
    partials = torch.empty((n * nout * -(-s // _GROUP),), dtype=torch.float32, device=device)
    totals = torch.empty((n, nout), dtype=torch.float32, device=device)
    lib = _build.library()
    common = (*tables, spot.data_ptr(), values.data_ptr(), inventory.data_ptr(),
              _ptr_or_none(pv), outs[0].data_ptr(), outs[1].data_ptr(),
              *(_ptr_or_none(p) for p in rows), partials.data_ptr(), totals.data_ptr(),
              _build.stream_handle(device))
    suffix = "_large" if large else ""
    if design:
        rc = getattr(lib, f"stt_forward_sweep_design{suffix}")(
            n, s, bdim, g, r, num_extra_decisions, int(ratchet_is_step), int(general), *common)
    elif wide:
        rc = getattr(lib, f"stt_forward_sweep_wide{suffix}")(
            n, s, f, bdim, g, r, num_extra_decisions, int(ratchet_is_step), int(general),
            _build.wide_basis_table(tuple(monomials), f, device).data_ptr(), *common)
    else:
        rc = getattr(lib, f"stt_forward_sweep{suffix}")(
            n, s, f, g, r, num_extra_decisions, int(ratchet_is_step), int(general),
            _build.basis_table(tuple(monomials), f), *common)
    return (outs[0], outs[1], totals[:, :NUM_SUMS], totals[:, NUM_SUMS:]), rc, route, wide


def _ptr_or_none(t: tp.Optional[torch.Tensor]):
    """A tensor's data pointer, or None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


def forward_sweep(
    params: torch.Tensor,       # [N, 13] step scalars (pack_params)
    mean: torch.Tensor,         # [N, B]
    std: torch.Tensor,          # [N, B]
    ratchet_inv: torch.Tensor,  # [N, R]
    ratchet_min: torch.Tensor,  # [N, R]
    ratchet_max: torch.Tensor,  # [N, R]
    spot: torch.Tensor,         # [N, S]
    factors: torch.Tensor,      # [N, F, S]
    inventory: torch.Tensor,    # [S] before step 0
    pv: tp.Optional[torch.Tensor],  # [S] before step 0, or None for zeros
    coeffs: torch.Tensor,       # [N, B, G]
    monomials: tp.Sequence,
    num_extra_decisions: int,
    ratchet_is_step: bool,
    panels: tp.Optional[tp.Sequence[tp.Optional[torch.Tensor]]] = None,
    out: tp.Optional[tp.Sequence[torch.Tensor]] = None,
    grid: tp.Optional[torch.Tensor] = None,  # [N, G] next grid rows: general-grid mode
    route: tp.Optional[str] = None,
):
    """The forward pass over N steps: returns (inventory [S], pv [S], sums
    [N, 8], xbar_sum [N, B]), the final inventory and PV and each step's
    cross-sim sums and summed design row.

    ``panels`` optionally holds four [N, S] buffers, each of which may be
    None: per step, each sim's inventory after the step, its volume, its fuel
    and its immediate PV.  ``out`` optionally holds two [S] buffers for the
    final inventory and PV.  ``grid``, where given, holds each step's next
    grid row for rows that are not evenly spaced: each target inventory is
    placed on it by search (``decision_candidates``).  CPU tensors take the
    plain version.  CUDA tensors launch the sweep kernel, once for all N
    steps, and must be f32 and contiguous (``factors`` may be [N, 0, S]: the
    kernel reads no factor then), at any G, on ``sweep_route``'s route
    (``route`` forces one), at any basis of up to ``_build.MAX_WIDE_BASIS``
    terms (``ValueError`` beyond, before any launch) on any F: compiled per
    B within 16 terms and 8 factors, past either on the wide route
    (``sweep_wide``: the powers from a device table, each sim's design row
    in shared memory; the same arithmetic).  ``launches`` counts every
    launch, ``general_launches`` those of the general-grid mode,
    ``large_launches`` those of the large route and ``wide_launches`` those
    of the wide route."""
    if spot.device.type == "cpu":
        return forward_sweep_plain(
            params, mean, std, ratchet_inv, ratchet_min, ratchet_max, spot, factors, inventory,
            pv, coeffs, monomials, num_extra_decisions, ratchet_is_step, panels, out, grid=grid,
        )
    result, rc, taken, wide = _launch_sweep(
        "forward_sweep", params, mean, std, ratchet_inv, ratchet_min, ratchet_max, spot,
        factors, inventory, pv, coeffs, monomials, num_extra_decisions, ratchet_is_step,
        panels, out, grid, route)
    forward_sweep.launches += 1
    forward_sweep.general_launches += grid is not None
    forward_sweep.large_launches += taken == "large"
    forward_sweep.wide_launches += wide
    _build.check(rc, "forward_sweep")
    return result


forward_sweep.launches = 0
forward_sweep.general_launches = 0  # those of the general-grid mode, counted in launches too
forward_sweep.large_launches = 0  # those of the large route, counted in launches too
forward_sweep.wide_launches = 0  # those of the wide route, counted in launches too


def forward_sweep_design(
    params: torch.Tensor,       # [N, 13] step scalars (pack_params)
    mean: torch.Tensor,         # [N, B]
    std: torch.Tensor,          # [N, B]
    ratchet_inv: torch.Tensor,  # [N, R]
    ratchet_min: torch.Tensor,  # [N, R]
    ratchet_max: torch.Tensor,  # [N, R]
    spot: torch.Tensor,         # [N, S]
    design: torch.Tensor,       # [N, B, S] raw (unstandardised) design values
    inventory: torch.Tensor,    # [S] before step 0
    pv: tp.Optional[torch.Tensor],  # [S] before step 0, or None for zeros
    coeffs: torch.Tensor,       # [N, B, G]
    num_extra_decisions: int,
    ratchet_is_step: bool,
    panels: tp.Optional[tp.Sequence[tp.Optional[torch.Tensor]]] = None,
    out: tp.Optional[tp.Sequence[torch.Tensor]] = None,
    grid: tp.Optional[torch.Tensor] = None,  # [N, G] next grid rows: general-grid mode
    route: tp.Optional[str] = None,
):
    """Kernel C's design mode: ``forward_sweep`` on each step's raw design
    [B, S], read from memory and standardised by ``mean`` and ``std``, in
    place of the design that monomials build on the card.  Results,
    ``panels``, ``out``, ``grid``, ``route`` and the counters as
    ``forward_sweep``'s.  CPU tensors take
    the plain version; CUDA tensors launch the kernel once for all N steps,
    at any B: compiled per B up to ``_build.MAX_BASIS``, the wide route
    beyond (the same arithmetic; no factor is read, so no factor count
    applies)."""
    if spot.device.type == "cpu":
        return forward_sweep_plain(
            params, mean, std, ratchet_inv, ratchet_min, ratchet_max, spot, None, inventory,
            pv, coeffs, None, num_extra_decisions, ratchet_is_step, panels, out, design=design,
            grid=grid,
        )
    result, rc, taken, _ = _launch_sweep(
        "forward_sweep_design", params, mean, std, ratchet_inv, ratchet_min, ratchet_max, spot,
        design, inventory, pv, coeffs, None, num_extra_decisions, ratchet_is_step, panels, out,
        grid, route)
    forward_sweep_design.launches += 1
    forward_sweep_design.general_launches += grid is not None
    forward_sweep_design.large_launches += taken == "large"
    _build.check(rc, "forward_sweep_design")
    return result


forward_sweep_design.launches = 0
forward_sweep_design.general_launches = 0
forward_sweep_design.large_launches = 0

# Steps of raw design a launch of the design mode reads: at S = 262,144 and
# B = 9 a chunk of 32 steps is 302 MB, where the whole 365-step year would be
# 3.44 GB.
DESIGN_CHUNK = 32


def sweep_in_chunks(num_steps: int, chunk: int, chunk_cb, sweep_chunk, inventory, pv=None):
    """A forward pass ``chunk`` steps a launch: ``sweep_chunk(t0, t1,
    inventory, pv)`` sweeps steps t0..t1−1 from the carried inventory and PV
    (``pv``, None for zeros, before the first) and returns the sweep's four
    results;
    ``chunk_cb(done, total)``, where given, is called after each chunk.
    Returns the sweep's results over all steps.  Each step's arithmetic is
    the sweep's, and a launch hands on the f32 inventory and PV that one
    launch would carry to its next step: the same bits as one launch."""
    sums, xbar = [], []
    total = -(-num_steps // chunk)
    for done, t0 in enumerate(range(0, num_steps, chunk), start=1):
        inventory, pv, sums_c, xbar_c = sweep_chunk(t0, min(t0 + chunk, num_steps), inventory, pv)
        sums.append(sums_c)
        xbar.append(xbar_c)
        if chunk_cb is not None:
            chunk_cb(done, total)
    return inventory, pv, torch.cat(sums), torch.cat(xbar)


def forward_sweep_generic(params, mean, std, ratchet_inv, ratchet_min, ratchet_max, spot,
                          factors, inventory, coeffs, entries, num_extra_decisions: int,
                          ratchet_is_step: bool, panels=None, chunk: tp.Optional[int] = None,
                          chunk_cb=None, grid=None, pv=None):
    """The forward pass for a basis of any entries, generic callables too:
    ``chunk`` steps at a time (``DESIGN_CHUNK`` where None), the raw design
    of the chunk's steps built on the spot's device (``basis.design_columns``,
    a generic entry called once a step) and swept by ``forward_sweep_design``,
    the inventory and PV carried from one chunk to the next, and
    ``chunk_cb(done, total)`` called after each chunk (``sweep_in_chunks``).
    Arguments and results as ``forward_sweep``'s (``pv`` and ``grid`` as
    there)."""
    rows = list(panels) if panels is not None else [None] * 4

    def sweep_chunk(t0, t1, inventory, pv):
        design = torch.stack(design_columns(entries, spot[t0:t1], factors[t0:t1]), dim=1)
        return forward_sweep_design(
            params[t0:t1], mean[t0:t1], std[t0:t1], ratchet_inv[t0:t1], ratchet_min[t0:t1],
            ratchet_max[t0:t1], spot[t0:t1], design, inventory, pv, coeffs[t0:t1],
            num_extra_decisions, ratchet_is_step,
            panels=[None if p is None else p[t0:t1] for p in rows],
            grid=None if grid is None else grid[t0:t1],
        )

    return sweep_in_chunks(spot.shape[0], chunk or DESIGN_CHUNK, chunk_cb, sweep_chunk, inventory,
                           pv)


def forward_step(
    params: torch.Tensor,       # [13] f32 step scalars (pack_params)
    mean: torch.Tensor,         # [B]
    std: torch.Tensor,          # [B]
    ratchet_inv: torch.Tensor,  # [R]
    ratchet_min: torch.Tensor,  # [R]
    ratchet_max: torch.Tensor,  # [R]
    spot: torch.Tensor,         # [S]
    factors: torch.Tensor,      # [F, S]
    inventory: torch.Tensor,    # [S]
    pv: torch.Tensor,           # [S]
    coeffs: torch.Tensor,       # [B, G]
    monomials: tp.Sequence,
    num_extra_decisions: int,
    ratchet_is_step: bool,
    out: tp.Optional[tp.Sequence[torch.Tensor]] = None,
    imm_out: tp.Optional[torch.Tensor] = None,
):
    """One forward step: the sweep at N = 1.  Returns (new_inventory [S],
    new_pv [S], opt_decision [S], opt_consumed [S], sums [8], xbar_sum [B]).

    ``out`` optionally holds four [S] buffers for the first four results (a
    row of a per-sim panel each, say); ``imm_out`` an [S] buffer that
    receives each sim's chosen immediate PV.  CPU tensors take the plain
    version, CUDA tensors launch the sweep kernel (``forward_sweep``)."""
    outs = list(out) if out is not None else [torch.empty_like(spot) for _ in range(4)]
    row = lambda t: None if t is None else t[None]  # noqa: E731
    _, _, sums, xbar = forward_sweep(
        *(x[None] for x in (params, mean, std, ratchet_inv, ratchet_min, ratchet_max, spot,
                            factors)),
        inventory, pv, coeffs[None], monomials, num_extra_decisions, ratchet_is_step,
        panels=(None, outs[2][None], outs[3][None], row(imm_out)), out=outs[:2],
    )
    return (*outs, sums[0], xbar[0])


def forward_sweep_vjp_plain(dec, cons, spot, fwd, df_settle, g):
    """Tensor-code version of ``forward_sweep_vjp``; any dtype, any device."""
    return df_settle / fwd * (g[None, :] * (-(dec + cons)) * spot).sum(dim=1)


@functools.lru_cache(maxsize=1)
def _vjp_chunk() -> int:
    out = (ctypes.c_int * 1)()
    _build.check(_build.library().stt_forward_sweep_vjp_chunk(out), "stt_forward_sweep_vjp_chunk")
    return out[0]


def forward_sweep_vjp(
    dec: torch.Tensor,        # [N, S] each sim's chosen volume (the sweep's panel)
    cons: torch.Tensor,       # [N, S] its fuel
    spot: torch.Tensor,       # [N, S]
    fwd: torch.Tensor,        # [N] the forward curve's rows
    df_settle: torch.Tensor,  # [N]
    g: torch.Tensor,          # [S] the upstream gradient of each sim's PV
) -> torch.Tensor:
    """The forward sweep's vector-Jacobian product in the forward curve with
    the policy held fixed (``csrc/forward_vjp.cu``): grad [N] with
    grad[t] = df_settle[t] / fwd[t] · Σ_s g[s]·(−(dec[t,s] + cons[t,s]))·spot[t,s].
    CPU tensors take the plain version; CUDA tensors launch the kernel (f32
    or f64, contiguous, one dtype)."""
    if spot.device.type == "cpu":
        return forward_sweep_vjp_plain(dec, cons, spot, fwd, df_settle, g)
    if spot.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"forward_sweep_vjp: expected float32 or float64, got {spot.dtype}")
    device = _build.require_cuda("forward_sweep_vjp", dec, cons, spot, fwd, df_settle, g,
                                 dtype=spot.dtype)
    n, s = spot.shape
    for key, t, shape in (("dec", dec, (n, s)), ("cons", cons, (n, s)), ("fwd", fwd, (n,)),
                          ("df_settle", df_settle, (n,)), ("g", g, (s,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"forward_sweep_vjp: {key} is {tuple(t.shape)}, want {shape}")
    partials = torch.empty((n * -(-s // _vjp_chunk()),), dtype=spot.dtype, device=device)
    grad = torch.empty((n,), dtype=spot.dtype, device=device)
    rc = _build.library().stt_forward_sweep_vjp(
        n, s, int(spot.dtype == torch.float64), dec.data_ptr(), cons.data_ptr(), spot.data_ptr(),
        g.data_ptr(), fwd.data_ptr(), df_settle.data_ptr(), partials.data_ptr(), grad.data_ptr(),
        _build.stream_handle(device))
    forward_sweep_vjp.launches += 1
    _build.check(rc, "forward_sweep_vjp")
    return grad


forward_sweep_vjp.launches = 0
