"""The backward LSMC step's decision update with next-step moments (kernel B).

Counterpart of ``storage_tpu.ops.decision_kernel.decision_update_moments_pallas``.
For every inventory grid point g and sim s it evaluates, per decision d,

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
``csrc/decision_kernel.cu`` is the kernel; ``decision_update_moments_plain``
is the same function in tensor code, used for CPU tensors.
"""
from __future__ import annotations

import typing as tp

import torch

from ..basis import Monomial, design_matrix
from . import _build


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


def decision_update_moments_plain(v, spot, factors, spot_prev, factors_prev,
                                  mean, std, mean_prev, std_prev, idx_lo, w_hi,
                                  ci, a, b, monomials):
    """Tensor-code version of the kernel; any dtype, any device."""
    values = decision_values(v, spot, factors, mean, std, idx_lo, w_hi, ci, a, b, monomials)
    best_reg, best_act = next(values)
    for val_reg, val_act in values:
        better = val_reg > best_reg
        best_reg = torch.where(better, val_reg, best_reg)
        best_act = torch.where(better, val_act, best_act)
    dmp = _standardised_design(monomials, spot_prev, factors_prev, mean_prev, std_prev)
    return best_act, dmp.T @ dmp, dmp.T @ best_act.T


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
):
    """Returns (best_act [G, S], xtx [B, B], xty [B, G]).

    CPU tensors take the plain version.  CUDA tensors launch the kernel and
    must be f32 and contiguous; ``out`` is the [G, S] buffer for best_act and
    must not be ``v`` (the kernel reads every v row until the step ends).
    ``idx_lo`` must lie in [0, G-2], as ``ops.interp.interp_weights`` makes
    it: the kernel does not check it, and checking on the host would wait
    for the device every step."""
    if v.device.type == "cpu":
        return decision_update_moments_plain(
            v, spot, factors, spot_prev, factors_prev, mean, std, mean_prev,
            std_prev, idx_lo, w_hi, ci, a, b, monomials,
        )
    g, s = v.shape
    f = factors.shape[0]
    d = ci.shape[0]
    bdim = len(monomials)
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
    shapes = {
        "spot": (spot, (s,)), "factors": (factors, (f, s)),
        "spot_prev": (spot_prev, (s,)), "factors_prev": (factors_prev, (f, s)),
        "mean": (mean, (bdim,)), "std": (std, (bdim,)),
        "mean_prev": (mean_prev, (bdim,)), "std_prev": (std_prev, (bdim,)),
        "idx_lo": (idx_lo, (g, d)), "w_hi": (w_hi, (g, d)),
        "ci": (ci, (d, g, bdim)), "a": (a, (d, g)), "b": (b, (d, g)),
        "out": (out, (g, s)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"decision_update_moments: {name} is {tuple(t.shape)}, want {shape}")
    nblk = -(-s // 128)
    npairs = bdim * bdim + g * bdim
    partials = torch.empty((npairs, nblk), dtype=torch.float32, device=device)
    moments = torch.empty((npairs,), dtype=torch.float32, device=device)
    lib = _build.library()
    rc = lib.stt_decision_update_moments(
        g, s, f, d, _build.basis_table(tuple(monomials), f), v.data_ptr(),
        spot.data_ptr(), factors.data_ptr(), spot_prev.data_ptr(),
        factors_prev.data_ptr(), mean.data_ptr(), std.data_ptr(),
        mean_prev.data_ptr(), std_prev.data_ptr(), idx_lo.data_ptr(),
        w_hi.data_ptr(), dci.data_ptr(), a.data_ptr(), b.data_ptr(),
        out.data_ptr(), partials.data_ptr(), moments.data_ptr(),
        _build.stream_handle(device),
    )
    decision_update_moments.launches += 1
    _build.check(rc, "decision_update_moments")
    xtx = moments[: bdim * bdim].view(bdim, bdim)
    xty = moments[bdim * bdim:].view(g, bdim).T
    return out, xtx, xty


decision_update_moments.launches = 0
