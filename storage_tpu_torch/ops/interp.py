"""Interpolation over inventory grids (counterpart of
``storage_tpu.ops.interp``).

On uniform (linspace) grids, positions come from arithmetic, not a search,
and every function takes a grid ``[..., G]`` whose leading dims broadcast
against the leading dims of the query ``x``, so one call serves one step
(grid [G]) or all steps at once (grid [N, G], x [N, ...]).  The general
(non-uniform) functions take one row [G] or rows [N, G] the same way, and,
on one row, values [G] or rows of values [..., G] on it (the tree's node
rows), whose leading dims ``x`` leads with; the natural-cubic ones take one
step's 1-D grid.
"""
from __future__ import annotations

import numpy as np
import torch


def _edge(grid, x, i):
    """grid[..., i] shaped to broadcast against ``x``."""
    col = grid[..., i]
    return col.reshape(col.shape + (1,) * (x.dim() - col.dim()))


def grid_positions(grid, x):
    """Fractional positions of ``x`` on a uniform grid; a degenerate grid
    (all points equal) maps everything to position 0."""
    g = grid.shape[-1]
    lo = _edge(grid, x, 0)
    hi = _edge(grid, x, g - 1)
    delta = (hi - lo) / (g - 1)
    safe = torch.where(delta > 0, delta, torch.ones_like(delta))
    pos = (torch.minimum(torch.maximum(x, lo), hi) - lo) / safe
    return torch.where(delta > 0, pos, torch.zeros_like(pos))


def interp_weights(grid, x):
    """(idx_lo, w_hi) for ``x`` on a uniform grid, clamped to the grid range:
    the lower node index (int64, at most G-2) and the weight of node idx_lo+1.
    A degenerate grid yields weight 0 on node 0."""
    g = grid.shape[-1]
    pos = grid_positions(grid, x)
    idx_lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, g - 2)
    w_hi = torch.clamp(pos - idx_lo.to(pos.dtype), 0.0, 1.0)
    return idx_lo, w_hi


def _take_last(values, idx):
    """values[..., idx] along the last axis, ``values`` [*batch, G] and
    ``idx`` [*batch, *q] (batch dims broadcast)."""
    batch = values.shape[:-1]
    q = idx.shape[len(batch):]
    flat = idx.reshape(idx.shape[: len(batch)] + (-1,))
    flat = flat.expand(batch + flat.shape[-1:]) if len(batch) else flat
    out = torch.gather(values, -1, flat)
    return out.reshape(batch + q)


def interp_vector(grid, values, x):
    """Interpolate ``values`` [..., G] at ``x`` [..., *q] (linear, clamped)."""
    idx_lo, w_hi = interp_weights(grid, x)
    lo_vals = _take_last(values, idx_lo)
    hi_vals = _take_last(values, idx_lo + 1)
    return lo_vals + (hi_vals - lo_vals) * w_hi


def interp_per_sim(grid, values, x):
    """Per-sim rows ``values`` [S, G] interpolated at per-sim queries
    ``x`` [S, D] → [S, D]: a two-node gather and a lerp (the JAX package
    contracts a hat tensor over G only because a per-lane gather is slow on
    a TPU)."""
    idx_lo, w_hi = interp_weights(grid, x)
    lo_vals = torch.gather(values, 1, idx_lo)
    hi_vals = torch.gather(values, 1, idx_lo + 1)
    return lo_vals * (1 - w_hi) + hi_vals * w_hi


def interp_coeffs(coeffs, idx_lo, w_hi):
    """Regression coefficients [B, G] interpolated to every (grid point,
    decision) target of one step, ``idx_lo``/``w_hi`` [G, D]: linear
    interpolation commutes with the linear model, so the coefficients are
    interpolated instead of the fitted values.  Returns [D, G, B]."""
    lo = idx_lo.to(torch.int64)
    ci = coeffs[:, lo] * (1 - w_hi) + coeffs[:, lo + 1] * w_hi  # [B, G, D]
    return ci.permute(2, 1, 0).contiguous()


def interp_weights_general(grid, x):
    """(idx_lo, w_hi) for ``x`` on non-uniform, non-decreasing grid rows,
    clamped: the lower node is the count of interior nodes <= x, so a
    zero-span segment (the padding of fixed-spacing and custom grids) gives
    weight 0 on its left node.  ``grid`` is one row [G] or rows [*lead, G]
    whose leading dims ``x`` [*lead, *q] leads with (every step at once)."""
    g = grid.shape[-1]
    lead = grid.shape[:-1]
    flat = x.reshape(lead + (-1,))
    x_c = torch.minimum(torch.maximum(flat, grid[..., :1]), grid[..., g - 1:])
    idx = torch.searchsorted(grid[..., 1:g - 1].contiguous(), x_c.contiguous(), right=True)
    x0 = torch.gather(grid, -1, idx)
    x1 = torch.gather(grid, -1, idx + 1)
    span = x1 - x0
    w = torch.where(span > 0, (x_c - x0) / torch.where(span > 0, span, torch.ones_like(span)),
                    torch.zeros_like(span))
    return idx.reshape(x.shape), w.reshape(x.shape)


def interp_vector_general(grid, values, x):
    """Linear interpolation of ``values`` [..., G] at ``x`` [..., *q] on
    non-uniform, non-decreasing grid rows (``interp_weights_general``'s
    layouts; clamped; zero-span segments take their left node's value)."""
    idx, w = interp_weights_general(grid, x)
    return _take_last(values, idx) * (1 - w) + _take_last(values, idx + 1) * w


def interp_per_sim_general(grid, values, x):
    """``interp_per_sim`` on a non-uniform grid [G]: per-sim rows ``values``
    [S, G] at per-sim queries ``x`` [S, D], a gather of the two nodes of
    ``interp_weights_general`` and a lerp (the JAX package contracts a dense
    hat over G)."""
    idx_lo, w_hi = interp_weights_general(grid, x)
    lo_vals = torch.gather(values, 1, idx_lo)
    hi_vals = torch.gather(values, 1, idx_lo + 1)
    return lo_vals * (1 - w_hi) + hi_vals * w_hi


def natural_cubic_solver(num_points: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """Inverse [G-2, G-2] of the natural-cubic-spline system of a uniform grid
    of G nodes (M_{i-1} + 4 M_i + M_{i+1} = rhs_i for the interior moments),
    inverted once in f64 and cast to ``dtype``."""
    n = num_points - 2
    if n <= 0:
        return torch.zeros((0, 0), dtype=dtype, device=device)
    t = np.zeros((n, n))
    for i in range(n):
        t[i, i] = 4.0
        if i > 0:
            t[i, i - 1] = 1.0
        if i + 1 < n:
            t[i, i + 1] = 1.0
    return torch.tensor(np.linalg.inv(t), dtype=dtype, device=device)


def cubic_moments(grid, values, solver):
    """Second-derivative moments [..., G] of the natural cubic spline through
    (grid, values [..., G]) on a uniform 1-D grid; ``solver`` from
    ``natural_cubic_solver(G)``.  A degenerate grid gives zero moments."""
    g = grid.shape[0]
    h = (grid[g - 1] - grid[0]) / (g - 1)
    safe_h = torch.where(h > 0, h, torch.ones_like(h))
    rhs = 6.0 * (values[..., 2:] - 2.0 * values[..., 1:-1] + values[..., :-2]) / (safe_h * safe_h)
    interior = (solver.to(values.dtype) @ rhs[..., None])[..., 0]
    interior = torch.where(h > 0, interior, torch.zeros_like(rhs))
    zero = torch.zeros(rhs.shape[:-1] + (1,), dtype=values.dtype, device=values.device)
    return torch.cat([zero, interior, zero], dim=-1)


def interp_vector_cubic(grid, values, moments, x):
    """Natural-cubic-spline evaluation of ``values`` [..., G] (``moments`` of
    the same shape) at ``x`` [..., *q] on a uniform 1-D grid, clamped (the
    reference's NaturalCubicSplineInterpolatorFactory,
    IInterpolatorFactory.cs:33-37)."""
    g = grid.shape[0]
    h = (grid[g - 1] - grid[0]) / (g - 1)
    idx_lo, t = interp_weights(grid, x)
    v_lo = _take_last(values, idx_lo)
    v_hi = _take_last(values, idx_lo + 1)
    m_lo = _take_last(moments, idx_lo)
    m_hi = _take_last(moments, idx_lo + 1)
    u = 1.0 - t
    linear = v_lo * u + v_hi * t
    curvature = (h * h / 6.0) * ((u * u * u - u) * m_lo + (t * t * t - t) * m_hi)
    return linear + torch.where(h > 0, curvature, torch.zeros_like(curvature))
