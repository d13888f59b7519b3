"""Linear interpolation over uniform inventory grids (counterpart of the
uniform functions of ``storage_tpu.ops.interp``).

Grid positions come from arithmetic on the linspace grids, not a search.
Every function takes a grid ``[..., G]`` whose leading dims broadcast against
the leading dims of the query ``x``, so one call serves one step (grid [G])
or all steps at once (grid [N, G], x [N, ...]).
"""
from __future__ import annotations

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
