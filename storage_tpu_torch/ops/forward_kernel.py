"""One forward LSMC step per sim (kernel C).

Counterpart of ``storage_tpu.ops.forward_kernel.forward_step_pallas``: the
design row, the fitted continuation at each candidate decision's target
inventory, ratchet lookup, the bang-bang decision set, the immediate value
and a first-max argmax, then the new inventory/PV, the chosen volume/fuel and
the step's cross-sim sums.  The fitted continuation is evaluated only at the
two grid rows each decision touches (``coeffs[:, row]·dm`` at lo and lo + 1),
in plain f32 — the JAX kernel's ``pred_passes=1`` arithmetic.

``csrc/forward_kernel.cu`` is the kernel; ``forward_step_plain`` is the same
function in tensor code, used for CPU tensors.  The ratchet lookup and the
decision fractions follow the TPU kernel (``_ratchet_rates_smem``,
``_bang_bang``), so the plain version agrees with it term for term.
"""
from __future__ import annotations

import typing as tp

import torch

from ..basis import Monomial, design_matrix
from . import _build

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
                        num_extra_decisions: int, ratchet_is_step: bool):
    """Per decision, its total value [S] (immediate plus fitted continuation)
    and the path quantities it would set, in the kernel's arithmetic order;
    with the standardised design [S, B] and the inventory loss [S]."""
    dm = (design_matrix(monomials, spot, factors) - mean) / std  # [S, B]
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
                       num_extra_decisions: int, ratchet_is_step: bool, imm_out=None):
    """Tensor-code version of the kernel; any dtype, any device.  The chosen
    immediate PV per sim goes to ``imm_out`` where one is given."""
    candidates, dm, loss = decision_candidates(
        params, mean, std, ratchet_inv, ratchet_min, ratchet_max, spot, factors,
        inventory, coeffs, monomials, num_extra_decisions, ratchet_is_step,
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
    monomials: tp.Sequence[Monomial],
    num_extra_decisions: int,
    ratchet_is_step: bool,
    out: tp.Optional[tp.Sequence[torch.Tensor]] = None,
    imm_out: tp.Optional[torch.Tensor] = None,
):
    """Returns (new_inventory [S], new_pv [S], opt_decision [S],
    opt_consumed [S], sums [8], xbar_sum [B]).

    ``out`` optionally holds four [S] buffers for the first four results (a
    row of a per-sim panel each, say); ``imm_out`` an [S] buffer that
    receives each sim's chosen immediate PV.  CPU tensors take the plain
    version.  CUDA tensors launch the kernel and must be f32 and contiguous
    (``factors`` may be [0, S]: the kernel reads no factor then)."""
    if spot.device.type == "cpu":
        result = forward_step_plain(
            params, mean, std, ratchet_inv, ratchet_min, ratchet_max, spot,
            factors, inventory, pv, coeffs, monomials, num_extra_decisions,
            ratchet_is_step, imm_out,
        )
        if out is None:
            return result
        for buf, val in zip(out, result[:4]):
            buf.copy_(val)
        return (*out, *result[4:])
    s = spot.shape[0]
    f = factors.shape[0]
    bdim, g = coeffs.shape
    r = ratchet_inv.shape[0]
    outs = list(out) if out is not None else [
        torch.empty(s, dtype=torch.float32, device=spot.device) for _ in range(4)]
    extra = () if imm_out is None else (imm_out,)
    device = _build.require_cuda(
        "forward_step", params, mean, std, ratchet_inv, ratchet_min,
        ratchet_max, spot, factors, inventory, pv, coeffs, *outs, *extra,
    )
    shapes = {
        "params": (params, (NUM_PARAMS,)), "mean": (mean, (bdim,)),
        "std": (std, (bdim,)), "ratchet_min": (ratchet_min, (r,)),
        "ratchet_max": (ratchet_max, (r,)), "factors": (factors, (f, s)),
        "inventory": (inventory, (s,)), "pv": (pv, (s,)),
        **{f"out[{i}]": (o, (s,)) for i, o in enumerate(outs)},
        **({"imm_out": (imm_out, (s,))} if imm_out is not None else {}),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"forward_step: {name} is {tuple(t.shape)}, want {shape}")
    if len(monomials) != bdim:
        raise ValueError("forward_step: coeffs rows must match the basis")
    nblk = -(-s // 256)
    partials = torch.empty((NUM_SUMS + bdim, nblk), dtype=torch.float32, device=device)
    totals = torch.empty((NUM_SUMS + bdim,), dtype=torch.float32, device=device)
    lib = _build.library()
    rc = lib.stt_forward_step(
        s, f, g, r, num_extra_decisions, int(ratchet_is_step),
        _build.basis_table(tuple(monomials), f), params.data_ptr(), mean.data_ptr(),
        std.data_ptr(), ratchet_inv.data_ptr(), ratchet_min.data_ptr(),
        ratchet_max.data_ptr(), spot.data_ptr(), factors.data_ptr(),
        inventory.data_ptr(), pv.data_ptr(), coeffs.data_ptr(),
        *(o.data_ptr() for o in outs), imm_out.data_ptr() if imm_out is not None else None,
        partials.data_ptr(), totals.data_ptr(),
        _build.stream_handle(device),
    )
    forward_step.launches += 1
    _build.check(rc, "forward_step")
    return (*outs, totals[:NUM_SUMS], totals[NUM_SUMS:])


forward_step.launches = 0
