"""Least-Squares Monte Carlo storage valuation engine over materialised path
panels (counterpart of the fused path of ``storage_tpu.engines.lsmc``).

* Backward induction runs one decision kernel per step (``ops.decision_kernel``):
  argmax on REGRESSED values while realising ACTUAL simulated continuations
  (LsmcStorageValuation.cs:310-336).  With factor panels, kernel B also
  accumulates the next step's regression moments in the same pass.  The
  moments are taken on design columns standardised by each step's exact
  two-pass stats, computed for all steps before the loop — the JAX XLA
  path's normal equations, where the TPU's fused path standardises step t−1
  by step t's stats and loses near-deterministic columns to cancellation.
  Between kernels, tensor code solves the [B, B] system and interpolates the
  coefficients to each (grid point, decision) target; ``fullstep=True`` runs
  kernel E instead, which does that solve on the card too, so a step is E's
  launches alone.  Spot-only panels (no factor, ``value_from_sims``) and bases
  with a user callable (``basis.generic``) take the JAX package's plain body:
  each step regresses v on its standardised design (``fit_continuation``)
  and runs kernel D on it.
* The forward pass runs one forward sweep over all steps (kernel C,
  ``ops.forward_kernel``) on an independent valuation-sim set, re-using the
  saved regression (the dual-simulation lower-bound estimator,
  LsmcStorageValuation.cs:352-415); a basis with a user callable runs the
  sweep's design mode on the design built a chunk of steps at a time
  (``forward_kernel.forward_sweep_generic``).  The forward pass produces NPV,
  standard error,
  pathwise deltas (:513-518), expected profiles and trigger prices
  (:523-592); with ``return_sim_data`` kernel C writes its per-sim outputs
  straight into [N, S] panels.
* An interactive run (``segment_cb``, the JAX package's host-chunked
  ``lsmc_core_chunked``) calls back after every 16-step segment of both
  passes: the backward loop between its steps, the forward sweep split into
  a launch a segment, the inventory and PV carried between launches.
* Custom grid rows that are not evenly spaced (``uniform_grids=False``, the
  JAX package's flag) place target inventories by search: the backward's
  interpolation tables by ``interp.interp_weights_general`` (kernels B, D
  and E read only the tables), the forward sweep in kernel C's general-grid
  mode, the trigger prices by ``interp.interp_vector_general``.
* Adjoint deltas (``adjoint=True``, then ``adjoint_deltas``) differentiate
  the pricing run's own forward sweep in the forward curve with the
  regression payload held fixed (``forward_kernel.ForwardSweepFn``, whose
  backward is the VJP kernel), and the terminal value by autograd: no second
  backward pass, and NPV, SE, profiles and triggers stay the pricing run's.

Everything that does not depend on the loop carry — decision sets,
interpolation indices and weights, immediate-value coefficients, the forward
kernel's parameter vectors, the trigger prices — is computed for all steps at
once, outside the backward's 365-step loop, and nothing in that loop or in the
forward sweep reads a value back to the host.

Known deviations from the reference are those of the JAX package (see its
module docstring): threefry draws, linspace grids, each sim's own terminal
value, the valuation sims' end-period spot for the terminal PV.
"""
from __future__ import annotations

import contextlib
import dataclasses
import typing as tp

import numpy as np
import torch

from .. import grid as gridmod
from ..basis import design_columns, design_matrix, has_generic
from ..facility import CompiledStorage
from ..ops import decision_kernel, forward_kernel, interp
from ..ops.regression import column_stats, fit_continuation, fit_from_moments

NUM_TRIGGER_PRICE_VOLUMES = 10  # LsmcStorageValuation.cs:383
# Steps between progress callbacks of an interactive run (the JAX package's
# ``lsmc_core_chunked`` default).
SEG_LEN = 16

_SCALARS = (
    "df_settle", "df_flow", "inj_cost", "wdr_cost", "inj_pcnt", "wdr_pcnt",
    "loss_pcnt", "inv_cost_rate",
)


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matrix products in full float32 on the card (no TF32) inside
    the block — the regression moments are the JAX package's
    ``Precision.HIGHEST`` — and the caller's settings restored after it.
    The matmul TF32 flag is restored through the precision it belongs to:
    restoring the flag itself would mix torch's two precision APIs, which
    newer versions refuse to read back."""
    saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def build_engine_arrays(
    compiled: CompiledStorage,
    fwd: np.ndarray,
    df_settle: np.ndarray,
    df_flow: np.ndarray,
    inventory_lower: np.ndarray,
    inventory_upper: np.ndarray,
    num_grid_points: int,
    dtype,
    device,
    grids: tp.Optional[np.ndarray] = None,
) -> tp.Dict[str, torch.Tensor]:
    """The engines' per-step tables on ``device`` in ``dtype``: the inventory
    grids [N+1, G] (``grids``, or linspace rows of ``num_grid_points``), the
    curve, bands and discount factors, the facility's costs and ratchets."""
    if grids is None:
        grids = gridmod.inventory_grids(inventory_lower, inventory_upper, num_grid_points)
    host = {
        "grids": grids,
        "fwd": fwd,
        "lower": inventory_lower,
        "upper": inventory_upper,
        "df_settle": df_settle,
        "df_flow": df_flow,
        "inj_cost": compiled.inj_cost,
        "wdr_cost": compiled.wdr_cost,
        "inj_pcnt": compiled.inj_consumed_pcnt,
        "wdr_pcnt": compiled.wdr_consumed_pcnt,
        "loss_pcnt": compiled.loss_pcnt,
        "inv_cost_rate": compiled.inv_cost_rate,
        "ratchet_inv": compiled.ratchet_inv,
        "ratchet_min": compiled.ratchet_min,
        "ratchet_max": compiled.ratchet_max,
    }
    return {
        k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
        for k, v in host.items()
    }


def _decision_cashflow_coeffs(decisions, x):
    """Per-decision immediate-PV decomposition pv = a·spot + b; ``x`` holds
    scalars broadcastable against ``decisions``."""
    is_inject = decisions > 0.0
    abs_d = torch.abs(decisions)
    consumed = torch.where(is_inject, x["inj_pcnt"], x["wdr_pcnt"]) * abs_d
    cost_npv = torch.where(is_inject, x["inj_cost"], x["wdr_cost"]) * abs_d * x["df_flow"]
    a = -(decisions + consumed) * x["df_settle"]
    return a, -cost_npv, consumed


def _terminal_values(terminal_fn, spot_end, grid_end, num_grid, num_sims, dtype):
    """Terminal storage values per (grid point, sim) — LsmcStorageValuation.cs:110-131.
    The user's terminal function receives tensors and is broadcast to [G, S]."""
    if terminal_fn is None:
        return torch.zeros((num_grid, num_sims), dtype=dtype, device=spot_end.device)
    value = terminal_fn(spot_end[None, :], grid_end[:, None])
    return torch.as_tensor(value, dtype=dtype, device=spot_end.device).expand(
        num_grid, num_sims
    ).contiguous()


def _backward_prep_all(arrays, num_extra_decisions: int, ratchet_is_step: bool,
                       snap_interp: bool, uniform_grids: bool = True):
    """Coefficient-independent per-step preparation for all N steps at once:
    interpolation rows/weights of every (step, grid point, decision) target
    inventory (by position arithmetic on evenly spaced rows, by search on
    others), and the immediate-value coefficients, in the kernel layouts
    (idx_lo, w_hi [N, G, D]; a, b [N, D, G])."""
    grids = arrays["grids"]
    n = grids.shape[0] - 1
    grid_t, grid_next = grids[:n], grids[1:]
    col = lambda key: arrays[key][:, None]  # noqa: E731  [N] -> [N, 1]
    min_rate, max_rate = gridmod.ratchet_rates(
        arrays["ratchet_inv"][:, None, :], arrays["ratchet_min"][:, None, :],
        arrays["ratchet_max"][:, None, :], ratchet_is_step, grid_t,
    )
    decisions = gridmod.bang_bang_decisions(
        min_rate, max_rate, grid_t, col("loss_pcnt"), arrays["lower"][1:, None],
        arrays["upper"][1:, None], num_extra_decisions,
    )  # [N, G, D]
    loss = col("loss_pcnt") * grid_t
    inv_after = grid_t[..., None] + decisions - loss[..., None]
    weights = interp.interp_weights if uniform_grids else interp.interp_weights_general
    idx_lo, w_hi = weights(grid_next, inv_after)
    if snap_interp:
        w_hi = decision_kernel.snap_weights(w_hi)
    scal = {k: arrays[k][:, None, None] for k in _SCALARS}
    a, b, _ = _decision_cashflow_coeffs(decisions, scal)
    b = b - (col("inv_cost_rate") * grid_t * col("df_flow"))[..., None]
    return {
        "idx_lo": idx_lo.to(torch.int32).contiguous(),
        "w_hi": w_hi.contiguous(),
        "a": a.transpose(1, 2).contiguous(),
        "b": b.transpose(1, 2).contiguous(),
    }


def _design_stats(monomials, spot, factors, chunk: int = 16):
    """Exact two-pass column stats (mean, std) [N, B] of every step's design
    matrix, ``chunk`` steps at a time.  They depend on the regression panels
    alone, so they are made before the backward loop; the decision kernel
    standardises step t−1's moments by them."""
    n = spot.shape[0]
    means, stds = [], []
    for t0 in range(0, n, chunk):
        # Columns stacked [chunk, B, S] (a contiguous copy) and read through a
        # [chunk, S, B] view: stacking on the last axis interleaves B-strided
        # writes, measured ~50 ms per valuation on the card.
        cols = design_columns(monomials, spot[t0:t0 + chunk], factors[t0:t0 + chunk])
        m, s = column_stats(torch.stack(cols, dim=-2).transpose(-1, -2))
        means.append(m)
        stds.append(s)
    return torch.cat(means), torch.cat(stds)


def _fused_bootstrap(monomials, spot_last, factors_last, v_end, mean_last, std_last):
    """Moments of the LAST step's standardised design matrix against the
    terminal values (every earlier step's come out of the decision kernel)."""
    u0 = (design_matrix(monomials, spot_last, factors_last) - mean_last) / std_last
    return u0.T @ u0, u0.T @ v_end.T


def _standardised_design_t(monomials, spot, factors, mean, std):
    """One step's standardised design, transposed: [B, S] contiguous, the
    layout kernel D reads."""
    cols = torch.stack(design_columns(monomials, spot, factors))  # [B, S]
    return (cols - mean[:, None]) / std[:, None]


def _ticker(segment_cb, phase: str, num_steps: int):
    """``tick(t)`` to call after step t of a pass: it calls
    ``segment_cb(phase, done, total)`` at the end of each ``SEG_LEN``-step
    segment (segments start at multiples of ``SEG_LEN``; the backward ends
    them at their first step, so a tail shorter than ``SEG_LEN`` comes
    first, as in the JAX package's ``lsmc_core_chunked``)."""
    seg_len = max(1, min(SEG_LEN, num_steps))
    total = -(-num_steps // seg_len)

    def tick(t: int) -> None:
        if segment_cb is not None and t % seg_len == 0:
            segment_cb(phase, total - t // seg_len, total)

    return tick


def lsmc_backward(
    arrays: tp.Dict[str, torch.Tensor],
    spot_reg: torch.Tensor,  # [N+1, S]
    factors_reg: torch.Tensor,  # [N+1, F, S]
    monomials: tp.Tuple,
    num_extra_decisions: int,
    terminal_fn,
    ratchet_is_step: bool,
    snap_interp: bool = False,
    fullstep: bool = False,
    segment_cb: tp.Optional[tp.Callable[[str, int, int], None]] = None,
    uniform_grids: bool = True,
):
    """Backward induction.  Returns (v0 [G, S], regression payload of stacked
    per-step mean [N, B], std [N, B], coeffs [N, B, G]).

    ``segment_cb("backward", done, total)``, where given, is called after
    each ``SEG_LEN``-step segment, from the last step down (``_ticker``);
    raising from it stops the pass between segments.

    ``snap_interp`` rounds the interpolation weights to the 1/256 grid, the
    quadrature of the TPU run.  Factor panels run kernel B with the tensor
    glue between steps, or kernel E alone with ``fullstep``; spot-only panels
    ([N+1, 0, S] factors) and bases with a user callable run the plain body
    with kernel D on the design read from memory, and refuse ``fullstep``
    (kernels B and E build monomial designs of factor panels on the card).
    ``uniform_grids=False`` places target inventories on the grid rows by
    search (``_backward_prep_all``)."""
    grids = arrays["grids"]
    n = grids.shape[0] - 1
    num_grid = grids.shape[1]
    dtype = grids.dtype
    design_in_memory = factors_reg.shape[1] == 0 or has_generic(monomials)
    if fullstep and design_in_memory:
        raise ValueError("fullstep needs factor panels and a monomial basis: spot-only panels "
                         "and generic bases run kernel D")
    v = _terminal_values(
        terminal_fn, spot_reg[n], grids[n], num_grid, spot_reg.shape[1], dtype
    )
    prep = _backward_prep_all(arrays, num_extra_decisions, ratchet_is_step, snap_interp,
                              uniform_grids)
    mean, std = _design_stats(monomials, spot_reg[:n], factors_reg[:n])  # [N, B]
    coeffs_all = torch.empty((n, len(monomials), num_grid), dtype=dtype, device=grids.device)
    spare = torch.empty_like(v)
    step_args = lambda t: (prep["idx_lo"][t], prep["w_hi"][t])  # noqa: E731
    tick = _ticker(segment_cb, "backward", n)
    if design_in_memory:
        for t in range(n - 1, -1, -1):
            # Regression of the next period's values on this period's
            # standardised design (the JAX plain body, engines/lsmc.py:306-327).
            dm_t = _standardised_design_t(monomials, spot_reg[t], factors_reg[t], mean[t], std[t])
            coeffs = fit_continuation(dm_t.T, v.T)  # [B, G]
            ci = interp.interp_coeffs(coeffs, *step_args(t))
            best_act = decision_kernel.decision_update(
                v, dm_t, spot_reg[t], *step_args(t), ci, prep["a"][t], prep["b"][t], out=spare,
            )
            spare, v = v, best_act
            coeffs_all[t] = coeffs
            tick(t)
        return v, {"mean": mean, "std": std, "coeffs": coeffs_all}

    xtx, xty = _fused_bootstrap(
        monomials, spot_reg[n - 1], factors_reg[n - 1], v, mean[n - 1], std[n - 1]
    )
    if fullstep:
        # Kernel E solves each step's regression from the carried moments
        # (centred by the step's exact stats, so it recovers them to
        # rounding) and writes the payload rows in place: no tensor glue.
        mean_out, std_out = torch.empty_like(mean), torch.empty_like(std)
        for t in range(n - 1, -1, -1):
            prev = max(t - 1, 0)
            best_act, xtx, xty, _, _, _ = decision_kernel.decision_update_fullstep(
                v, spot_reg[t], factors_reg[t], spot_reg[prev], factors_reg[prev], xtx, xty,
                mean[t], std[t], *step_args(t), prep["a"][t], prep["b"][t], monomials,
                mean_prev=mean[prev], std_prev=std[prev], out=spare,
                regression_out=(mean_out[t], std_out[t], coeffs_all[t]),
            )
            spare, v = v, best_act
            tick(t)
        return v, {"mean": mean_out, "std": std_out, "coeffs": coeffs_all}

    for t in range(n - 1, -1, -1):
        # Step t's moments arrive standardised by its exact stats: the
        # normal equations of the JAX XLA path, without a second pass over v.
        coeffs = fit_from_moments(xtx, xty)  # [B, G]
        ci = interp.interp_coeffs(coeffs, prep["idx_lo"][t], prep["w_hi"][t])
        prev = max(t - 1, 0)  # the previous-step slice at t = 0 is step 0
        best_act, xtx, xty = decision_kernel.decision_update_moments(
            v, spot_reg[t], factors_reg[t], spot_reg[prev], factors_reg[prev],
            mean[t], std[t], mean[prev], std[prev], prep["idx_lo"][t],
            prep["w_hi"][t], ci, prep["a"][t], prep["b"][t], monomials, out=spare,
        )
        spare, v = v, best_act
        coeffs_all[t] = coeffs
        tick(t)
    return v, {"mean": mean, "std": std, "coeffs": coeffs_all}


def _trigger_outputs(x, xbar, expected_inventory, ratchet_is_step: bool,
                     num_extra_decisions: int, dtype, uniform_grids: bool = True):
    """Trigger prices at the expected inventory (LsmcStorageValuation.cs:523-592)
    for all N steps at once: ``x`` holds [N]-shaped scalars, [N, R] ratchet
    tables, coeffs [N, B, G] and grid_next [N, G]; ``xbar`` [N, B] is the
    cross-sim mean standardised design row."""
    num_tv = NUM_TRIGGER_PRICE_VOLUMES
    cbar = torch.einsum("nb,nbg->ng", xbar, x["coeffs"])  # [N, G_next]
    e_loss = x["loss_pcnt"] * expected_inventory
    e_min_rate, e_max_rate = gridmod.ratchet_rates(
        x["ratchet_inv"], x["ratchet_min"], x["ratchet_max"], ratchet_is_step,
        expected_inventory,
    )
    e_decisions = gridmod.bang_bang_decisions(
        e_min_rate, e_max_rate, expected_inventory, x["loss_pcnt"], x["next_min"],
        x["next_max"], num_extra_decisions,
    )  # [N, D]
    inf = torch.tensor(float("inf"), dtype=dtype, device=e_decisions.device)
    nan = torch.tensor(float("nan"), dtype=dtype, device=e_decisions.device)
    col = lambda t: t[:, None]  # noqa: E731
    interp_fn = interp.interp_vector if uniform_grids else interp.interp_vector_general

    def pv_parts(volume):  # volume [N, K]
        is_inject = volume > 0.0
        abs_v = torch.abs(volume)
        consumed_v = torch.where(is_inject, col(x["inj_pcnt"]), col(x["wdr_pcnt"])) * abs_v
        cost_v = (
            torch.where(is_inject, col(x["inj_cost"]), col(x["wdr_cost"]))
            * abs_v * col(x["df_flow"])
        )
        cont_v = interp_fn(
            x["grid_next"], cbar,
            col(expected_inventory) + volume - col(e_loss),
        )
        return cont_v, cost_v, consumed_v

    def side(inject: bool):
        if inject:
            extreme = torch.max(e_decisions, dim=1).values
            alternative = torch.min(torch.where(e_decisions >= 0, e_decisions, inf), dim=1).values
            active = (extreme > 0) & (extreme > alternative)
        else:
            extreme = torch.min(e_decisions, dim=1).values
            alternative = torch.max(torch.where(e_decisions <= 0, e_decisions, -inf), dim=1).values
            active = (extreme < 0) & (extreme < alternative)
        alt_cont, alt_cost, alt_consumed = pv_parts(col(alternative))
        j = torch.arange(1, num_tv + 1, dtype=dtype, device=extreme.device)
        volumes = col(alternative) + j * col(extreme - alternative) / num_tv
        cont_v, cost_v, consumed_v = pv_parts(volumes)
        # Price making the trigger volume indifferent to the alternative
        # (CalcTriggerPrice, LsmcStorageValuation.cs:704-723).
        denom = col(x["df_settle"]) * (volumes - col(alternative) + consumed_v - alt_consumed)
        prices = ((cont_v - alt_cont) - (cost_v - alt_cost)) / denom
        volumes = torch.where(col(active), volumes, nan)
        prices = torch.where(col(active), prices, nan)
        return (
            volumes, prices,
            torch.where(active, extreme, nan),
            torch.where(active, prices[:, -1], nan),  # price at the max volume
            torch.where(active, prices[:, 0], nan),   # price nearest the alternative
        )

    inj_volumes, inj_prices, max_inj_vol, max_inj_price, _ = side(True)
    wdr_volumes, wdr_prices, max_wdr_vol, wdr_maxvol_price, wdr_near_price = side(False)
    return {
        "inj_volumes": inj_volumes,
        "inj_prices": inj_prices,
        "wdr_volumes": wdr_volumes,
        "wdr_prices": wdr_prices,
        "max_inj_vol": max_inj_vol,
        # Inject: the reference's MaxInjectTriggerPrice is the max-volume
        # point (LsmcStorageValuation.cs:556).
        "max_inj_price": max_inj_price,
        "max_wdr_vol": max_wdr_vol,
        # Withdraw: the price one increment from the alternative
        # (LsmcStorageValuation.cs:584); the max-volume price is kept apart.
        "max_wdr_price": wdr_near_price,
        "wdr_maxvol_price": wdr_maxvol_price,
    }


@dataclasses.dataclass
class AdjointTape:
    """What ``adjoint_deltas`` differentiates, kept by an ``adjoint=True``
    forward pass: its NPV with the autograd graph back to the forward
    curve's rows (``fwd`` [N], through ``forward_kernel.ForwardSweepFn``) and,
    where the storage has a terminal value, to its last entry (``fwd_end``)."""

    npv: torch.Tensor
    fwd: torch.Tensor
    fwd_end: tp.Optional[torch.Tensor]
    df_settle: torch.Tensor
    discount_deltas: bool


def lsmc_forward(
    arrays: tp.Dict[str, torch.Tensor],
    spot_val: torch.Tensor,  # [N+1, S]
    factors_val: torch.Tensor,  # [N+1, F, S]
    regression: tp.Dict[str, torch.Tensor],
    starting_inventory,
    monomials: tp.Tuple,
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    return_sim_data: bool = False,
    segment_cb: tp.Optional[tp.Callable[[str, int, int], None]] = None,
    uniform_grids: bool = True,
    adjoint: bool = False,
):
    """Forward simulation over materialised valuation panels, one forward
    sweep for all steps; the per-step reductions stay on the device until the
    result dict is read.  With ``segment_cb`` the sweep runs ``SEG_LEN``
    steps a launch and ``segment_cb("forward", done, total)`` is called after
    each (the same bits: ``forward_kernel.sweep_in_chunks``); a generic basis
    then builds its design ``SEG_LEN`` steps at a time.  ``return_sim_data``
    adds the per-sim panels of the JAX package's ``_forward_finalise``:
    inventory and PV [N+1, S] (the last rows the final inventory and the
    terminal PV), and volume, fuel, loss and net volume [N, S].
    ``uniform_grids=False`` runs kernel C's general-grid mode on the grid
    rows.  ``adjoint`` adds ``"adjoint_tape"``, an ``AdjointTape`` of this
    sweep for ``adjoint_deltas`` (the other results are unchanged: the sweep
    writes its volume and fuel panels, which give the same bits); with a
    given regression payload this is the forward-only adjoint."""
    grids = arrays["grids"]
    n = grids.shape[0] - 1
    dtype = grids.dtype
    device = grids.device
    s_count = spot_val.shape[1]
    grid_next = grids[1:]
    grid_rows = None if uniform_grids else grid_next
    step = {k: arrays[k] for k in _SCALARS}
    step.update(next_min=arrays["lower"][1:], next_max=arrays["upper"][1:])
    params = forward_kernel.pack_params(step, grid_next, dtype=dtype)  # [N, 13]
    ratchets = [arrays[k].contiguous() for k in ("ratchet_inv", "ratchet_min", "ratchet_max")]

    inv0 = torch.full((s_count,), float(starting_inventory), dtype=dtype, device=device)
    panel = lambda rows: torch.empty((rows, s_count), dtype=dtype, device=device)  # noqa: E731
    rows = [None] * 4
    if return_sim_data:
        # Kernel C writes its per-sim outputs into panel rows: no copies.
        sim_inventory, sim_pv = panel(n + 1), panel(n + 1)
        sim_dec, sim_cons = panel(n), panel(n)
        sim_inventory[0] = inv0
        rows = [sim_inventory[1:], sim_dec, sim_cons, sim_pv[:n]]
    elif adjoint:
        rows[1], rows[2] = panel(n), panel(n)  # the volume and fuel the VJP reads
    seg_len = max(1, min(SEG_LEN, n))
    chunk_cb = None if segment_cb is None else (
        lambda done, total: segment_cb("forward", done, total))
    tables = (params, regression["mean"], regression["std"], *(r[:n] for r in ratchets))

    def sweep():
        if has_generic(monomials):
            return forward_kernel.forward_sweep_generic(
                *tables, spot_val[:n], factors_val[:n], inv0, regression["coeffs"],
                monomials, num_extra_decisions, ratchet_is_step, panels=rows,
                chunk=None if segment_cb is None else seg_len, chunk_cb=chunk_cb, grid=grid_rows,
            )

        def sweep_chunk(t0, t1, inventory, pv):
            return forward_kernel.forward_sweep(
                *(x[t0:t1] for x in tables), spot_val[t0:t1], factors_val[t0:t1], inventory, pv,
                regression["coeffs"][t0:t1], monomials, num_extra_decisions, ratchet_is_step,
                panels=[None if p is None else p[t0:t1] for p in rows],
                grid=None if grid_rows is None else grid_rows[t0:t1],
            )

        return forward_kernel.sweep_in_chunks(
            n, n if segment_cb is None else seg_len, chunk_cb, sweep_chunk, inv0)

    fwd_rows = fwd_end = None
    with torch.enable_grad() if adjoint else contextlib.nullcontext():
        if adjoint:
            fwd_rows = arrays["fwd"][:n].detach().clone().requires_grad_()
            pv, inventory, sums, xbar = forward_kernel.ForwardSweepFn.apply(
                fwd_rows, arrays["df_settle"], spot_val[:n], rows[1], rows[2], sweep)
        else:
            inventory, pv, sums, xbar = sweep()
        # Terminal period PV for non-empty storage: each sim's own terminal value.
        if terminal_fn is not None:
            spot_end = spot_val[n]
            if adjoint:
                # The same values, with d spot_end / d fwd[N] = spot_end / fwd[N]
                # (spot = forward x stochastic part); inventory carries no gradient.
                fwd_end = arrays["fwd"][n].detach().clone().requires_grad_()
                f_n = arrays["fwd"][n]
                ratio = torch.where(f_n != 0, spot_end / f_n, torch.zeros_like(spot_end))
                spot_end = spot_end + (fwd_end - fwd_end.detach()) * ratio
            terminal_pv = torch.as_tensor(
                terminal_fn(spot_end, inventory), dtype=dtype, device=device
            ).expand(inventory.shape)
            pv = pv + terminal_pv
            end_pv = terminal_pv.mean()
        else:
            terminal_pv = torch.zeros_like(pv)
            end_pv = torch.zeros((), dtype=dtype, device=device)
        npv = pv.mean()
    tape = AdjointTape(npv, fwd_rows, fwd_end, arrays["df_settle"],
                       discount_deltas) if adjoint else None
    npv, pv, terminal_pv, end_pv = (t.detach() for t in (npv, pv, terminal_pv, end_pv))

    count = float(s_count)
    xbar = xbar / count
    expected_inventory = sums[:, forward_kernel._A_INV] / count
    disc = arrays["df_settle"] if discount_deltas else torch.ones_like(arrays["df_settle"])
    delta = sums[:, forward_kernel._A_DELTA] / count / arrays["fwd"][:n] * disc
    trig = {
        **step, "grid_next": grid_next, "coeffs": regression["coeffs"],
        "ratchet_inv": ratchets[0], "ratchet_min": ratchets[1], "ratchet_max": ratchets[2],
    }
    triggers = _trigger_outputs(
        trig, xbar, expected_inventory, ratchet_is_step, num_extra_decisions, dtype,
        uniform_grids,
    )
    # Sample standard error (ddof=1; LsmcStorageValuation.cs:618).
    standard_error = torch.sqrt(torch.sum((pv - npv) ** 2) / (count - 1.0)) / np.sqrt(count)

    zero = torch.zeros((1,), dtype=dtype, device=device)
    sim_panels = {}
    if return_sim_data:
        sim_pv[n] = terminal_pv
        sim_panels = {
            "sim_inventory": sim_inventory,
            "sim_inject_withdraw": sim_dec,
            "sim_cmdty_consumed": sim_cons,
            # The kernel's loss, loss_pcnt·inventory, for all steps at once.
            "sim_inventory_loss": arrays["loss_pcnt"][:, None] * sim_inventory[:n],
            "sim_net_volume": -sim_dec - sim_cons,
            "sim_pv": sim_pv,
        }
    return {
        **sim_panels,
        **({"adjoint_tape": tape} if adjoint else {}),
        "npv": npv,
        "standard_error": standard_error,
        "deltas": torch.cat([delta, zero]),
        "profile_inventory": torch.cat([expected_inventory, inventory.mean()[None]]),
        "profile_inject_withdraw": torch.cat([sums[:, forward_kernel._A_DEC] / count, zero]),
        "profile_cmdty_consumed": torch.cat([sums[:, forward_kernel._A_CONS] / count, zero]),
        "profile_inventory_loss": torch.cat([sums[:, forward_kernel._A_LOSS] / count, zero]),
        "profile_pv": torch.cat([sums[:, forward_kernel._A_IMM] / count, end_pv[None]]),
        "trigger_inject_volumes": triggers["inj_volumes"],
        "trigger_inject_prices": triggers["inj_prices"],
        "trigger_withdraw_volumes": triggers["wdr_volumes"],
        "trigger_withdraw_prices": triggers["wdr_prices"],
        "max_inject_volume": triggers["max_inj_vol"],
        "max_inject_trigger_price": triggers["max_inj_price"],
        "max_withdraw_volume": triggers["max_wdr_vol"],
        "max_withdraw_trigger_price": triggers["max_wdr_price"],
        "withdraw_max_volume_price": triggers["wdr_maxvol_price"],
    }


def adjoint_deltas(tape: AdjointTape) -> torch.Tensor:
    """Deltas [N+1] by reverse mode through an ``adjoint=True`` forward pass
    (the JAX package's ``_forward_value_and_grad`` and
    ``_undiscount_deltas``): d NPV / d fwd, whose first N entries are the
    sweep's VJP and whose last is the terminal value's gradient.  They are
    discounted to the valuation date by construction; without
    ``discount_deltas`` the first N are divided by the settlement discount
    factors and the last is left as it is, as in the JAX package."""
    leaves = [tape.fwd] + ([tape.fwd_end] if tape.fwd_end is not None else [])
    # A terminal value that ignores the price leaves fwd_end unused: zero.
    rows, *end = torch.autograd.grad(tape.npv, leaves, allow_unused=True)
    end = end[0] if end and end[0] is not None else torch.zeros((), dtype=rows.dtype,
                                                                device=rows.device)
    if not tape.discount_deltas:
        rows = rows / tape.df_settle
    return torch.cat([rows, end.reshape(1)]).detach()


def lsmc_core(
    arrays: tp.Dict[str, torch.Tensor],
    spot_reg: torch.Tensor,
    factors_reg: torch.Tensor,
    spot_val: torch.Tensor,
    factors_val: torch.Tensor,
    starting_inventory,
    monomials: tp.Tuple,
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    snap_interp: bool = False,
    return_regression: bool = False,
    return_sim_data: bool = False,
    fullstep: bool = False,
    segment_cb: tp.Optional[tp.Callable[[str, int, int], None]] = None,
    uniform_grids: bool = True,
    adjoint: bool = False,
) -> tp.Dict[str, torch.Tensor]:
    """Full LSMC valuation on one device over materialised panels: regression
    sims drive the backward pass, valuation sims the forward pass.  Results
    stay on the panels' device.  ``return_sim_data`` adds the per-sim panels
    (``lsmc_forward``); ``fullstep`` runs each backward step as kernel E
    alone (factor panels and monomial bases only).  ``uniform_grids=False``
    takes grid rows that are not evenly spaced (the search placement of
    both passes); ``adjoint`` adds the forward sweep's ``"adjoint_tape"``
    for ``adjoint_deltas``.

    ``segment_cb(phase, done, total)`` makes the run interactive, as the JAX
    package's ``lsmc_core_chunked`` (the same function here): it is called
    after every ``SEG_LEN``-step segment of the backward (``phase``
    "backward") and of the forward ("forward", whose sweep then runs a
    launch a segment), and raising from it aborts the valuation between
    segments.  An interactive run gives the uninterrupted run's bits."""
    with full_f32_matmul():
        v0, regression = lsmc_backward(
            arrays, spot_reg, factors_reg, monomials, num_extra_decisions,
            terminal_fn, ratchet_is_step, snap_interp=snap_interp, fullstep=fullstep,
            segment_cb=segment_cb, uniform_grids=uniform_grids,
        )
        result = lsmc_forward(
            arrays, spot_val, factors_val, regression, starting_inventory, monomials,
            num_extra_decisions, discount_deltas, terminal_fn, ratchet_is_step,
            return_sim_data=return_sim_data, segment_cb=segment_cb,
            uniform_grids=uniform_grids, adjoint=adjoint,
        )
    # Backward (upper-ish) estimate: mean of the first-period values at the
    # known starting inventory (grid[0] is degenerate) — LsmcStorageValuation.cs:623.
    result["backward_npv"] = v0[0].mean()
    if return_regression:
        result["regression_mean"] = regression["mean"]
        result["regression_std"] = regression["std"]
        result["regression_coeffs"] = regression["coeffs"]
    return result


# The JAX package's name for its host-chunked engine, which here is
# ``lsmc_core`` given a ``segment_cb``.
lsmc_core_chunked = lsmc_core


def lsmc_npv_and_ad_deltas(
    arrays: tp.Dict[str, torch.Tensor],
    stoch_reg: torch.Tensor,  # [N+1, S] spot / forward (the stochastic part)
    factors_reg: torch.Tensor,
    stoch_val: torch.Tensor,
    factors_val: torch.Tensor,
    starting_inventory,
    monomials: tp.Tuple,
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    uniform_grids: bool = True,
    snap_interp: bool = False,
    segment_cb: tp.Optional[tp.Callable[[str, int, int], None]] = None,
):
    """NPV and deltas [N+1] by reverse mode (the JAX package's function of
    the same name): the spot is fwd x stoch, one backward pass builds the
    regression, and ``adjoint_deltas`` differentiates that valuation's own
    forward sweep in the curve — the JAX package runs the backward again
    inside its differentiated function, to the same payload."""
    fwd = arrays["fwd"][:, None]
    result = lsmc_core(
        arrays, fwd * stoch_reg, factors_reg, fwd * stoch_val, factors_val, starting_inventory,
        monomials, num_extra_decisions, discount_deltas, terminal_fn, ratchet_is_step,
        snap_interp=snap_interp, segment_cb=segment_cb, uniform_grids=uniform_grids,
        adjoint=True,
    )
    return result["npv"], adjoint_deltas(result["adjoint_tape"])
