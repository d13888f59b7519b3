"""Trinomial-tree storage valuation: backward induction over (price node ×
inventory grid) (counterpart of ``storage_tpu.engines.tree``; reference
``TreeStorageValuation.cs:143-433``).

Step t forms every node row's expected continuation ``ev = T_t @ V_{t+1}``
[M, G], then at every grid point of every row the best of the D = 2E + 3
decisions against the node's spot: its immediate PV plus ``ev`` interpolated
(linear on uniform rows, linear by node count on custom rows, or natural
cubic) at the inventory after it.  NPV = Σ_m q0[m]·V0[m, 0] (grid 0 is the
single starting inventory).

The transition reaches the engine as a band (``ops.tree_kernel.band``: row
m of period t has its non-zeros in W ≤ 2·num_substeps + 1 columns from
``band_start[t, m]``), so nothing [N, M, M] is kept on the device.
``tree_plain`` rebuilds each step's dense [M, M] matrix and multiplies in
tensor code; ``tree_core`` runs it on CPU tensors and, on CUDA tensors,
launches the DP kernel (``ops.tree_kernel.tree_dp``: one launch a valuation
of one thread-block cluster; one launch a step for a slab beyond the
cluster's shared memory; a few a step, on rows in device memory, for rows
beyond a block's: any grid size).
"""
from __future__ import annotations

import logging
import typing as tp

import numpy as np
import torch

from .. import grid as gridmod
from ..facility import CompiledStorage
from ..models.trinomial_tree import TrinomialTree
from ..ops import interp, tree_kernel
from . import intrinsic, lsmc

logger = logging.getLogger(__name__)


class TreeEngineResult(tp.NamedTuple):
    npv: torch.Tensor
    values: tp.Optional[torch.Tensor] = None  # [N+1, M, G]


class TreeSimulationResult(tp.NamedTuple):
    """Decisions simulated along one path of branch choices (analog of
    ``TreeStorageValuation.SimulateDecisions``, TreeStorageValuation.cs:344-433)."""

    npv: torch.Tensor
    decisions: torch.Tensor  # [N]
    cmdty_consumed: torch.Tensor  # [N]
    inventory: torch.Tensor  # [N] inventory after each decision
    node_path: torch.Tensor  # [N+1] node level visited per period


def _terminal(terminal_fn, tree, grids) -> torch.Tensor:
    """Terminal values [M, G] at every node's last spot and every point of
    the last grid."""
    return intrinsic.terminal_values(terminal_fn, tree["spot"][-1][:, None], grids[-1][None, :])


def _price_tables(arrays, t: int, price) -> dict:
    """Step t's tables with ``price`` in the forward's place."""
    return dict(intrinsic.step_tables(arrays, t), fwd=price)


def _solver(grids, interpolation: str):
    if interpolation != "cubic":
        return None
    return intrinsic.cubic_solver(grids.shape[1], grids.dtype, grids.device)


def _moments(grid, ev, solver):
    return None if solver is None else interp.cubic_moments(grid, ev, solver)


def tree_plain(
    arrays: tp.Dict[str, torch.Tensor],
    tree: tp.Dict[str, torch.Tensor],
    num_extra_decisions: int,
    terminal_fn,
    ratchet_is_step: bool,
    interpolation: str = "linear",
    uniform_grids: bool = True,
) -> TreeEngineResult:
    """The backward induction in tensor code, any dtype and device
    (``_tree_core`` of the JAX package): for t = N−1 .. 0 the dense step
    matrix rebuilt from the band, ``ev = T_t @ V_{t+1}`` in full f32 or f64
    (no TF32), and every node's and grid point's best decision."""
    intrinsic.check_interpolation(interpolation, uniform_grids)
    grids = arrays["grids"]
    n = grids.shape[0] - 1
    solver = _solver(grids, interpolation)
    values = [None] * n + [_terminal(terminal_fn, tree, grids)]
    with lsmc.full_f32_matmul():
        for t in range(n - 1, -1, -1):
            ev = tree_kernel.dense(tree["band"][t], tree["band_start"][t]) @ values[t + 1]
            x = _price_tables(arrays, t, tree["spot"][t][:, None, None])
            totals = intrinsic.decision_totals(
                x, grids[t], ev, _moments(grids[t + 1], ev, solver), num_extra_decisions,
                ratchet_is_step, interpolation, uniform_grids)[0]
            values[t] = totals.max(dim=-1).values
    values = torch.stack(values)
    return TreeEngineResult(npv=(tree["q0"] * values[0, :, 0]).sum(), values=values)


def tree_core(
    arrays: tp.Dict[str, torch.Tensor],
    tree: tp.Dict[str, torch.Tensor],
    num_extra_decisions: int,
    terminal_fn,
    ratchet_is_step: bool,
    interpolation: str = "linear",
    uniform_grids: bool = True,
    route: tp.Optional[str] = None,
) -> TreeEngineResult:
    """The backward induction on the device of ``arrays`` (the dict of
    ``engines.lsmc.build_engine_arrays``) and ``tree`` (``tree_valuation``'s
    lattice tensors): CPU tensors run ``tree_plain``, CUDA tensors the DP
    kernel (f32 or f64; one launch on the cluster route, N on the large-slab
    route, 2N or 3N on the large route), which reads the terminal values and
    leaves the values and the NPV on the card.  ``route`` names the kernel's
    route instead of the one the slab's shape picks
    (``ops.tree_kernel.tree_route``)."""
    if arrays["grids"].device.type == "cpu":
        return tree_plain(arrays, tree, num_extra_decisions, terminal_fn, ratchet_is_step,
                          interpolation, uniform_grids)
    intrinsic.check_interpolation(interpolation, uniform_grids)
    grids = arrays["grids"]
    n = grids.shape[0] - 1
    mode = intrinsic.kernel_mode(interpolation, uniform_grids)
    v_end = _terminal(terminal_fn, tree, grids).contiguous()
    values = tree_kernel.tree_dp(arrays, tree, v_end, num_extra_decisions, ratchet_is_step, mode,
                                 _solver(grids, interpolation), route)
    return TreeEngineResult(npv=(tree["q0"] * values[0, :, 0]).sum(), values=values)


def tree_arrays(tree: TrinomialTree, tree_offset: int, num_steps: int, dtype,
                device, banded=None) -> tp.Dict[str, torch.Tensor]:
    """The lattice over the storage window on ``device``: spot [N+1, M], the
    transition's band [N, M, W] and first columns [N, M] (``banded``, where
    the caller has them: ``tree_kernel.band``'s), q0 [M] and dest_centre [M]
    (the tree starts at the valuation period, the window ``tree_offset``
    periods later)."""
    o = tree_offset
    band, start = (banded if banded is not None
                   else tree_kernel.band(tree.transition[o : o + num_steps]))
    return {
        "spot": torch.tensor(tree.spot[o : o + num_steps + 1], dtype=dtype, device=device),
        "band": torch.tensor(band, dtype=dtype, device=device),
        "band_start": torch.tensor(start, dtype=torch.int64, device=device),
        "q0": torch.tensor(tree.q[o], dtype=dtype, device=device),
        "dest_centre": torch.tensor(tree.dest_centre, dtype=torch.int64, device=device),
    }


def tree_valuation(
    compiled: CompiledStorage,
    tree: TrinomialTree,
    tree_offset: int,
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
    grid_calc=None,
    device="cuda",
):
    """Run the tree DP; returns (result, arrays, lattice tensors).
    ``tree_offset`` aligns the tree (built from the valuation period) with
    the active storage window; ``starting_inventory`` is grid 0's single
    point, accepted for parity with the JAX package.

    ``interpolation``: 'linear' (default) or 'cubic' (natural cubic spline in
    inventory — the reference's ``NaturalCubicSplineInterpolatorFactory``).
    ``grid_calc``: the user's ``(lower, upper) -> points`` callable, or the
    points, per period (IDoubleStateSpaceGridCalc.cs:32); cubic requires
    the uniform linspace grid."""
    del starting_inventory
    if grid_calc is not None:
        if interpolation == "cubic":
            raise ValueError(
                "cubic interpolation requires the uniform linspace grid "
                "(grid_calc must be None)."
            )
        grids = gridmod.inventory_grids_custom(inventory_lower, inventory_upper, grid_calc)
        uniform_grids = gridmod.rows_uniform(grids)
    else:
        grids = gridmod.inventory_grids(inventory_lower, inventory_upper, num_grid_points)
        uniform_grids = True
    banded = tree_kernel.band(tree.transition[tree_offset : tree_offset + compiled.num_steps])
    if torch.device(device).type == "cuda":
        # The kernel's route, from the shapes alone, before anything is built
        # on the card: the one tree_core then takes.
        mode = intrinsic.kernel_mode(interpolation, uniform_grids)
        m, w = banded[0].shape[1:]
        route = tree_kernel.tree_route(m, grids.shape[1], w, num_extra_decisions, mode, dtype,
                                       device)
        logger.info("Tree DP route at M=%d, G=%d (%s, %s): %s.", m, grids.shape[1], mode, dtype,
                    route)
    arrays = lsmc.build_engine_arrays(compiled, fwd, df_settle, df_flow, inventory_lower,
                                      inventory_upper, num_grid_points, dtype, device, grids)
    lattice = tree_arrays(tree, tree_offset, compiled.num_steps, dtype, device, banded)
    terminal_fn = None if compiled.must_be_empty_at_end else compiled.terminal_value
    result = tree_core(arrays, lattice, num_extra_decisions, terminal_fn,
                       compiled.ratchet_is_step, interpolation, uniform_grids)
    return result, arrays, lattice


def node_totals(arrays, tree, values, t: int, node: int, inventory, num_extra_decisions: int,
                ratchet_is_step: bool, interpolation: str = "linear", uniform_grids: bool = True):
    """Every decision of step t at node ``node`` and ``inventory`` [K], on the
    continuation of ``values`` [N+1, M, G]: ``intrinsic.decision_totals``
    against the node's spot, on its row of the expected continuation."""
    grids = arrays["grids"]
    rows = tree["band_start"][t, node] + torch.arange(tree["band"].shape[-1], device=grids.device)
    ev = tree["band"][t, node] @ values[t + 1].index_select(0, rows)  # [G]
    x = _price_tables(arrays, t, tree["spot"][t, node])
    return intrinsic.decision_totals(
        x, inventory, ev, _moments(grids[t + 1], ev, _solver(grids, interpolation)),
        num_extra_decisions, ratchet_is_step, interpolation, uniform_grids)


def simulate_tree_decisions(
    arrays: tp.Dict[str, torch.Tensor],
    tree: tp.Dict[str, torch.Tensor],
    values: torch.Tensor,  # [N+1, M, G] from the valuation
    transition_path,  # [N] branch indices in {0, 1, 2}
    starting_inventory,
    num_extra_decisions: int,
    terminal_fn,
    ratchet_is_step: bool,
    interpolation: str = "linear",
    uniform_grids: bool = True,
) -> TreeSimulationResult:
    """Follow a path of branch choices through the tree, at each period taking
    the DP-optimal decision given the visited node and current inventory
    (TreeStorageValuation.cs:344-433): tensor code on the device of
    ``values``, a step at a time.  ``interpolation``/``uniform_grids`` must
    match the valuation that produced ``values`` so the simulator reads the
    same continuation surface."""
    grids = arrays["grids"]
    n = grids.shape[0] - 1
    m = tree["spot"].shape[1]
    branches = torch.as_tensor(transition_path).tolist()
    dest_centre = tree["dest_centre"].tolist()
    node = m // 2
    nodes = [node]
    inventory = torch.full((1,), float(starting_inventory), dtype=grids.dtype, device=grids.device)
    npv = torch.zeros((), dtype=grids.dtype, device=grids.device)
    path = []
    for t in range(n):
        _, decision, consumed, pv, loss = intrinsic.first_best(*node_totals(
            arrays, tree, values, t, node, inventory, num_extra_decisions, ratchet_is_step,
            interpolation, uniform_grids))
        inventory = inventory + decision - loss
        npv = npv + pv[0]
        path.append(torch.stack([decision[0], consumed[0], inventory[0]]))
        # Node evolution along the chosen branch: centre destination +/- 1.
        node = min(max(dest_centre[node] + branches[t] - 1, 0), m - 1)
        nodes.append(node)
    if terminal_fn is not None:
        npv = npv + torch.as_tensor(terminal_fn(tree["spot"][n, node], inventory[0]),
                                    dtype=grids.dtype, device=grids.device)
    decisions, consumed, inv_path = torch.stack(path, dim=1)
    return TreeSimulationResult(
        npv=npv, decisions=decisions, cmdty_consumed=consumed, inventory=inv_path,
        node_path=torch.tensor(nodes, dtype=torch.int64, device=grids.device),
    )
