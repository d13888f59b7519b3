"""Intrinsic storage valuation: the deterministic DP on the forward curve
(counterpart of ``storage_tpu.engines.intrinsic``; reference
``IntrinsicStorageValuation.cs:120-322``).

A backward pass over t = N−1 .. 1 values every grid point of each step (the
best decision's immediate PV plus the interpolated continuation), then a
forward pass walks the single known inventory from the start and re-derives
the optimal decision profile.  One ``decision_values`` serves both passes;
the continuation is linear on uniform (linspace) grids, linear by node
count on fixed-spacing and custom grids, or a natural cubic spline.

``intrinsic_plain`` is the DP in tensor code.  ``intrinsic_core`` runs it on
CPU tensors and, on CUDA tensors, launches the DP kernel
(``ops.intrinsic_kernel``: the whole DP in one launch, on the route the
shape picks, at any grid size).
"""
from __future__ import annotations

import functools
import logging
import typing as tp

import numpy as np
import torch

from .. import grid as gridmod
from ..facility import CompiledStorage
from ..ops import _build, interp, intrinsic_kernel
from . import lsmc

INTERPOLATIONS = ("linear", "cubic")
logger = logging.getLogger(__name__)


class IntrinsicEngineResult(tp.NamedTuple):
    npv: torch.Tensor  # scalar
    inventory: torch.Tensor  # [N+1] inventory after each period's decision (end: final)
    inject_withdraw: torch.Tensor  # [N+1] (end: 0)
    cmdty_consumed: torch.Tensor  # [N+1]
    inventory_loss: torch.Tensor  # [N+1]
    period_pv: torch.Tensor  # [N+1] (end: terminal pv)


def immediate_pv(decision, inventory, price, df_settle, df_flow, inj_cost, wdr_cost,
                 inj_pcnt, wdr_pcnt, inv_cost_rate):
    """Present value of one period's cash flows for a decision volume
    (``StorageHelper.StorageImmediateNpvForDecision``, StorageHelper.cs:224-248,
    plus the inventory cost): the commodity leg settles on the settlement
    date, operating costs on the period's cost date.  Returns (pv, consumed)."""
    is_inject = decision > 0.0
    cost_rate = torch.where(is_inject, inj_cost, wdr_cost)
    consumed_pcnt = torch.where(is_inject, inj_pcnt, wdr_pcnt)
    abs_decision = torch.abs(decision)
    consumed = consumed_pcnt * abs_decision
    iw_npv = -decision * price * df_settle
    cost_npv = cost_rate * abs_decision * df_flow
    consumed_npv = -consumed * price * df_settle
    inv_cost_npv = inv_cost_rate * inventory * df_flow
    return iw_npv - cost_npv + consumed_npv - inv_cost_npv, consumed


def check_interpolation(interpolation: str, uniform_grids: bool) -> None:
    if interpolation not in INTERPOLATIONS:
        raise ValueError("interpolation must be 'linear' or 'cubic'.")
    if not uniform_grids and interpolation == "cubic":
        raise ValueError("cubic interpolation requires the (uniform) linspace grid scheme.")


def terminal_values(terminal_fn, price, inventory) -> torch.Tensor:
    """The terminal function at ``price`` and ``inventory`` (zeros for a
    facility that must end empty), broadcast to their joint shape: user
    functions may return scalars."""
    shape = torch.broadcast_shapes(price.shape, inventory.shape)
    if terminal_fn is None:
        return torch.zeros(shape, dtype=inventory.dtype, device=inventory.device)
    value = terminal_fn(price, inventory)
    return torch.as_tensor(value, dtype=inventory.dtype, device=inventory.device).expand(shape)


def step_tables(arrays, t: int) -> dict:
    """Step t's scalars, ratchet tables [R] and next grid [G]."""
    x = {k: arrays[k][t] for k in (
        "df_settle", "df_flow", "inj_cost", "wdr_cost", "inj_pcnt", "wdr_pcnt", "loss_pcnt",
        "inv_cost_rate", "ratchet_inv", "ratchet_min", "ratchet_max")}
    x.update(fwd=arrays["fwd"][t], next_min=arrays["lower"][t + 1],
             next_max=arrays["upper"][t + 1], grid_next=arrays["grids"][t + 1])
    return x


def decision_totals(x, inventory, v_next, moments_next, num_extra_decisions: int,
                    ratchet_is_step: bool, interpolation: str, uniform_grids: bool):
    """Every decision of one period at ``inventory`` [K]: (total value,
    volume, fuel, immediate PV), each [K, D], and the loss [K].  ``x["fwd"]``
    is the price; the tree passes rows of continuation values ``v_next``
    [M, G] (``moments_next`` alike) and their node's spots as prices
    [M, 1, 1], and the totals and PVs are then [M, K, D]."""
    min_rate, max_rate = gridmod.ratchet_rates(
        x["ratchet_inv"], x["ratchet_min"], x["ratchet_max"], ratchet_is_step, inventory)
    decisions = gridmod.bang_bang_decisions(
        min_rate, max_rate, inventory, x["loss_pcnt"], x["next_min"], x["next_max"],
        num_extra_decisions,
    )  # [K, D]
    pv, consumed = immediate_pv(
        decisions, inventory[:, None], x["fwd"], x["df_settle"], x["df_flow"], x["inj_cost"],
        x["wdr_cost"], x["inj_pcnt"], x["wdr_pcnt"], x["inv_cost_rate"])
    loss = x["loss_pcnt"] * inventory
    inv_after = inventory[:, None] + decisions - loss[:, None]
    inv_after = inv_after.expand(v_next.shape[:-1] + inv_after.shape)
    if interpolation == "cubic":
        continuation = interp.interp_vector_cubic(x["grid_next"], v_next, moments_next, inv_after)
    elif uniform_grids:
        continuation = interp.interp_vector(x["grid_next"], v_next, inv_after)
    else:
        continuation = interp.interp_vector_general(x["grid_next"], v_next, inv_after)
    return pv + continuation, decisions, consumed, pv, loss


def decision_values(x, inventory, v_next, moments_next, num_extra_decisions: int,
                    ratchet_is_step: bool, interpolation: str, uniform_grids: bool):
    """The optimal decision at ``inventory`` [K] for one period: (value,
    decision, consumed, pv, loss), each [K] (``first_best`` of
    ``decision_totals``)."""
    return first_best(*decision_totals(
        x, inventory, v_next, moments_next, num_extra_decisions, ratchet_is_step, interpolation,
        uniform_grids))


def first_best(total, decisions, consumed, pv, loss):
    """``decision_totals``' best decision at each of its K inventories:
    (value, decision, consumed, pv, loss), each [K].  The first maximum over
    the decisions wins, as ``jnp.argmax`` takes it."""
    best_total, best = total[:, 0], torch.zeros_like(loss, dtype=torch.int64)
    for d in range(1, total.shape[1]):
        better = total[:, d] > best_total
        best_total = torch.where(better, total[:, d], best_total)
        best = torch.where(better, d, best)
    take = lambda a: torch.gather(a, 1, best[:, None])[:, 0]  # noqa: E731
    return best_total, take(decisions), take(consumed), take(pv), loss


def _result(inv_path, decisions, consumed, losses, pvs, final_inv, end_pv) -> IntrinsicEngineResult:
    zero = torch.zeros((1,), dtype=pvs.dtype, device=pvs.device)
    return IntrinsicEngineResult(
        npv=pvs.sum() + end_pv,
        inventory=torch.cat([inv_path, final_inv.reshape(1)]),
        inject_withdraw=torch.cat([decisions, zero]),
        cmdty_consumed=torch.cat([consumed, zero]),
        inventory_loss=torch.cat([losses, zero]),
        period_pv=torch.cat([pvs, end_pv.reshape(1)]),
    )


def snap_to_band(new_inventory, inventory, decision, loss, next_min, next_max):
    """The forward walk's next inventory, set to a bound of the next band
    where it lies within 16 units in the last place of the step's operands
    from it.  A decision that fills or empties to a bound lands there in
    exact arithmetic; rounding leaves a residual (~1e-16 of the volumes)
    whose sign decides whether the next step's decision set holds zero
    (``grid.bang_bang_decisions``), and so the path.  The DP kernel snaps
    alike, in the same operations."""
    tol = 16 * torch.finfo(new_inventory.dtype).eps * (inventory.abs() + decision.abs()
                                                        + loss.abs())
    for bound in (next_min, next_max):
        new_inventory = torch.where((new_inventory - bound).abs() <= tol, bound, new_inventory)
    return new_inventory


def backward_values(arrays, num_extra_decisions: int, terminal_fn, ratchet_is_step: bool,
                    interpolation: str = "linear", uniform_grids: bool = True):
    """The plain backward over t = N−1 .. 1: the values vs [N+1] of [G] rows
    (``vs[0]`` stays 0: grid[0] is the single known inventory, valued by the
    forward walk; ``vs[N]`` the terminal values) and, for cubic
    interpolation, each row's spline moments (else None)."""
    check_interpolation(interpolation, uniform_grids)
    grids = arrays["grids"]
    n = grids.shape[0] - 1
    cubic = interpolation == "cubic"
    solver = cubic_solver(grids.shape[1], grids.dtype, grids.device) if cubic else None
    vs = [torch.zeros_like(grids[0])] * n + [terminal_values(terminal_fn, arrays["fwd"][n], grids[n])]
    moments = [None] * (n + 1)
    if cubic:
        moments[n] = interp.cubic_moments(grids[n], vs[n], solver)
    for t in range(n - 1, 0, -1):
        vs[t] = decision_values(step_tables(arrays, t), grids[t], vs[t + 1], moments[t + 1],
                                num_extra_decisions, ratchet_is_step, interpolation,
                                uniform_grids)[0]
        if cubic:
            moments[t] = interp.cubic_moments(grids[t], vs[t], solver)
    return vs, moments


def intrinsic_plain(
    arrays: tp.Dict[str, torch.Tensor],
    starting_inventory,
    num_extra_decisions: int,
    terminal_fn,
    ratchet_is_step: bool,
    interpolation: str = "linear",
    uniform_grids: bool = True,
) -> IntrinsicEngineResult:
    """The DP in tensor code, any dtype and device (``_intrinsic_core`` of the
    JAX package): ``backward_values``, then the forward walk of the inventory
    from ``starting_inventory``, each step's inventory snapped to a band
    bound it lands on (``snap_to_band``)."""
    vs, moments = backward_values(arrays, num_extra_decisions, terminal_fn, ratchet_is_step,
                                  interpolation, uniform_grids)
    grids = arrays["grids"]
    n = grids.shape[0] - 1
    inventory = torch.full((1,), float(starting_inventory), dtype=grids.dtype, device=grids.device)
    path = []
    for t in range(n):
        x = step_tables(arrays, t)
        _, decision, consumed, pv, loss = decision_values(
            x, inventory, vs[t + 1], moments[t + 1], num_extra_decisions, ratchet_is_step,
            interpolation, uniform_grids)
        inventory = snap_to_band(inventory + decision - loss, inventory, decision, loss,
                                 x["next_min"], x["next_max"])
        path.append(torch.stack([inventory[0], decision[0], consumed[0], loss[0], pv[0]]))
    inv_path, decisions, consumed, losses, pvs = torch.stack(path, dim=1)
    end_pv = terminal_values(terminal_fn, arrays["fwd"][n], inventory)[0]
    return _result(inv_path, decisions, consumed, losses, pvs, inventory, end_pv)


def kernel_mode(interpolation: str, uniform_grids: bool) -> str:
    """The DP kernels' continuation mode: "cubic", "linear" on uniform rows,
    "general" on any other."""
    return "cubic" if interpolation == "cubic" else "linear" if uniform_grids else "general"


def log_route(num_steps: int, grids: np.ndarray, num_ratchet_nodes: int, num_extra_decisions: int,
              mode: str, dtype, device) -> None:
    """Logs the DP kernel's route on a CUDA ``device`` (nothing elsewhere),
    decided from the host grids' shape before anything is built on the
    card: the one ``intrinsic_core`` then takes."""
    if torch.device(device).type != "cuda":
        return
    route = intrinsic_kernel.intrinsic_route(
        grids.shape[1], num_ratchet_nodes, num_extra_decisions, mode, dtype.itemsize,
        _build.smem_limit(device), num_steps)
    logger.info("Intrinsic DP route at G=%d (%s, %s): %s.", grids.shape[1], mode, dtype, route)


@functools.lru_cache(maxsize=16)
def cubic_solver(num_points: int, dtype, device) -> torch.Tensor:
    """``interp.natural_cubic_solver`` cached per grid size, dtype and device."""
    return interp.natural_cubic_solver(num_points, dtype, device)


def intrinsic_core(
    arrays: tp.Dict[str, torch.Tensor],
    starting_inventory,
    num_extra_decisions: int,
    terminal_fn,
    ratchet_is_step: bool,
    interpolation: str = "linear",
    uniform_grids: bool = True,
    route: tp.Optional[str] = None,
) -> IntrinsicEngineResult:
    """The intrinsic DP on the device of ``arrays`` (the dict of
    ``engines.lsmc.build_engine_arrays``): CPU tensors run ``intrinsic_plain``,
    CUDA tensors one launch of the DP kernel (f32 or f64), which reads the
    terminal values on the last grid and leaves the NPV on the card.
    ``route`` names the kernel's route instead of the one the shape picks
    (``ops.intrinsic_kernel.intrinsic_route``)."""
    if arrays["grids"].device.type == "cpu":
        return intrinsic_plain(arrays, starting_inventory, num_extra_decisions, terminal_fn,
                               ratchet_is_step, interpolation, uniform_grids)
    check_interpolation(interpolation, uniform_grids)
    grids = arrays["grids"]
    n = grids.shape[0] - 1
    mode = kernel_mode(interpolation, uniform_grids)
    solver = cubic_solver(grids.shape[1], grids.dtype, grids.device) if mode == "cubic" else None
    v_end = terminal_values(terminal_fn, arrays["fwd"][n], grids[n]).contiguous()
    inv_path, decisions, consumed, losses, pvs, final_inv = intrinsic_kernel.intrinsic_dp(
        arrays, v_end, starting_inventory, num_extra_decisions, ratchet_is_step, mode, solver,
        route)
    end_pv = terminal_values(terminal_fn, arrays["fwd"][n], final_inv)[0]
    return _result(inv_path, decisions, consumed, losses, pvs, final_inv, end_pv)


def intrinsic_valuation(
    compiled: CompiledStorage,
    starting_inventory: float,
    fwd: np.ndarray,
    df_settle: np.ndarray,
    df_flow: np.ndarray,
    inventory_lower: np.ndarray,
    inventory_upper: np.ndarray,
    num_grid_points: int = 100,
    num_extra_decisions: int = 0,
    dtype=torch.float32,
    interpolation: str = "linear",
    grid_scheme: str = "linspace",
    grid_calc=None,
    device="cuda",
) -> IntrinsicEngineResult:
    """Run the intrinsic DP on host arrays from the precompute stage.

    ``grid_scheme``: 'linspace' (per-band linspace, uniform rows) or
    'fixed_spacing' (the reference's FixedSpacingStateSpaceGridCalc layout:
    global-range spacing from the band's lower bound, capped at its upper;
    per-period decisions exactly the reference's).  ``grid_calc``: the
    user's ``(lower, upper) -> points`` callable, or the points themselves,
    per period (IDoubleStateSpaceGridCalc.cs:32); it overrides
    ``grid_scheme``."""
    if grid_calc is not None:
        if interpolation == "cubic":
            raise ValueError("cubic interpolation requires the (uniform) linspace grid scheme.")
        grids = gridmod.inventory_grids_custom(inventory_lower, inventory_upper, grid_calc)
        grid_scheme = "custom"
    elif grid_scheme == "linspace":
        grids = gridmod.inventory_grids(inventory_lower, inventory_upper, num_grid_points)
    elif grid_scheme == "fixed_spacing":
        grids = gridmod.inventory_grids_fixed_spacing(
            inventory_lower, inventory_upper, float(np.min(compiled.min_inv)),
            float(np.max(compiled.max_inv)), num_grid_points)
    else:
        raise ValueError("grid_scheme must be 'linspace' or 'fixed_spacing'.")
    uniform_grids = grid_scheme == "linspace"
    log_route(compiled.num_steps, grids, compiled.ratchet_inv.shape[1], num_extra_decisions,
              kernel_mode(interpolation, uniform_grids), dtype, device)
    arrays = lsmc.build_engine_arrays(compiled, fwd, df_settle, df_flow, inventory_lower,
                                      inventory_upper, num_grid_points, dtype, device, grids)
    terminal_fn = None if compiled.must_be_empty_at_end else compiled.terminal_value
    return intrinsic_core(arrays, starting_inventory, num_extra_decisions, terminal_fn,
                          compiled.ratchet_is_step, interpolation, uniform_grids=uniform_grids)
