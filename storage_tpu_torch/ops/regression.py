"""Least-squares regression for the LSMC continuation values (counterpart of
``storage_tpu.ops.regression``).

The basis columns are standardised and the normal equations solved with a
Cholesky factorisation:

    X_std = (X - mean) / std          (column 0, the constant, untouched)
    M     = X_stdᵀ X_std  (+ trace-scaled ridge jitter)
    c     = M⁻¹ X_stdᵀ Y                        — Y = [S, G] continuation values

Nothing here reads a value back to the host: a failed factorisation falls
back to the constant-column projection through ``torch.where``, so the
365-step backward loop never waits on the device.

Where the paths are split over a process group (``parallel``), the sums
over sims are all-reduced across it: the stats' two passes, and the normal
equations' two moments in one buffer.  Every rank then solves the same
small system.  Without a group nothing changes.
"""
from __future__ import annotations

import typing as tp

import torch

from ..parallel.reduce import psum, psum_many, size


def column_stats(x, group=None):
    """Mean/std of design-matrix columns [..., S, B] over the sims (two-pass),
    over every rank's sims where ``group`` splits them.  The constant column
    (index 0) keeps mean 0 / std 1 so standardisation leaves it intact."""
    count = x.shape[-2] * size(group)
    mean = psum(torch.sum(x, dim=-2, keepdim=True), group) / count
    std = torch.sqrt(psum(torch.sum((x - mean) ** 2, dim=-2), group) / count)
    mean = mean.squeeze(-2)
    std = torch.where(std > 0, std, torch.ones_like(std))
    first = torch.arange(x.shape[-1], device=x.device) == 0
    mean = torch.where(first, torch.zeros_like(mean), mean)
    std = torch.where(first, torch.ones_like(std), std)
    return mean, std


def standardise_moments(xtx_raw, xty_raw):
    """Standardised normal-equation system from RAW moments.

    Given ``xtx_raw = XᵀX`` [B, B] and ``xty_raw = XᵀY`` [B, G] of a design
    matrix whose column 0 is all ones, returns ``(m, xty, mean, std)`` of the
    column-standardised system:

        n = XᵀX[0,0]; μ = XᵀX[0,:]/n; var = diag(XᵀX)/n − μ²
        X̃ᵀX̃ = D⁻¹(XᵀX − n μμᵀ)D⁻¹;  X̃ᵀY = D⁻¹(XᵀY − μ·(XᵀY)[0,:])

    The variance is clamped at zero; the ridge and the Cholesky fallback of
    ``fit_from_moments`` cover genuine singularity.
    """
    b = xtx_raw.shape[0]
    n = xtx_raw[0, 0]
    mu_true = xtx_raw[0] / n
    ex2 = torch.diagonal(xtx_raw) / n
    first = torch.arange(b, device=xtx_raw.device) == 0
    mean = torch.where(first, torch.zeros_like(mu_true), mu_true)
    var = ex2 - mean**2
    std = torch.sqrt(torch.clamp(var, min=0.0))
    ones = torch.ones_like(std)
    std = torch.where(std > 0, std, ones)
    std = torch.where(first, ones, std)
    m = (xtx_raw - n * mu_true[:, None] * mu_true[None, :]) / (
        std[:, None] * std[None, :]
    )
    # [0, 0] = n - n·1·1 under the subtraction; the constant column's true
    # sum of squares is n.
    m = torch.where(
        first[:, None] & first[None, :], n.expand(b, b), m
    )
    xty = (xty_raw - mean[:, None] * xty_raw[0:1, :]) / std[:, None]
    return m, xty, mean, std


def ridge_for(dtype) -> float:
    """The trace-scaled ridge of ``fit_from_moments``: larger in f32, where
    the valuation day's design columns are collinear to f32 resolution."""
    return 1e-5 if dtype == torch.float32 else 1e-7


def fit_continuation(x_std, y, group=None, ridge: tp.Optional[float] = None):
    """Regression coefficients [B, G] of ``y`` [S, G] on the standardised
    design ``x_std`` [S, B]: the normal equations in full precision (the
    JAX package's ``Precision.HIGHEST``; the caller keeps TF32 off, see
    ``engines.lsmc.full_f32_matmul``), summed over ``group``'s ranks in one
    all-reduce, then ``fit_from_moments``."""
    m, xty = psum_many([x_std.T @ x_std, x_std.T @ y], group)
    return fit_from_moments(m, xty, ridge)


def fit_from_moments(m, xty, ridge: tp.Optional[float] = None, solve_dtype=None):
    """Solve the standardised normal equations (``m = X̃ᵀX̃`` [B, B],
    ``xty = X̃ᵀY`` [B, G]) with a trace-scaled ridge (1e-5 in f32, 1e-7 in
    f64) and fall back to the projection on the constant column — the
    cross-sim mean — where the factorisation fails.  The ridge is added in
    m's dtype; the factorisation and the substitutions run in
    ``solve_dtype`` (default m's) and the coefficients come back in m's.

    ``torch.linalg.cholesky`` raises where JAX returns NaN, so the
    factorisation is ``cholesky_ex`` and its ``info`` joins the non-finite
    check in the fallback condition."""
    if ridge is None:
        ridge = ridge_for(m.dtype)
    b = m.shape[0]
    jitter = ridge * torch.trace(m) / b
    m = m + jitter * torch.eye(b, dtype=m.dtype, device=m.device)
    solve_dtype = m.dtype if solve_dtype is None else solve_dtype
    chol, info = torch.linalg.cholesky_ex(m.to(solve_dtype))
    coeffs = torch.cholesky_solve(xty.to(solve_dtype), chol).to(m.dtype)
    # m[0, 0] is the constant column's sum of squares = the sim count.
    mean_y = xty[0:1] / m[0, 0]
    fallback = torch.cat([mean_y, torch.zeros_like(xty[1:])], dim=0)
    solve_failed = (info != 0) | ~torch.all(torch.isfinite(coeffs))
    return torch.where(solve_failed, fallback, coeffs)
