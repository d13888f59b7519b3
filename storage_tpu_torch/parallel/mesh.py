"""Path-parallel LSMC over a ``torch.distributed`` process group (the
counterpart of ``storage_tpu.parallel.mesh``).

The JAX package shards the paths over a 1-D device mesh and sums across it
with ``psum`` on the mesh axis.  Here the mesh is a process group with one
rank per card, launched by ``torchrun --nproc-per-node=N`` or by
``distributed.initialize``: NCCL on CUDA, gloo on the CPU.  Rank r owns the
global paths [r·S_local, (r+1)·S_local) and simulates them itself (the draws
are addressed by global path id, so the answer does not depend on the number
of ranks); the only traffic between ranks is the engine's sums over sims
(``parallel.reduce``): two a segment for the design stats, one a backward
step for the [B, B] and [B, G] moments, a few in the forward.  Every rank
solves the same small regression and ends with the same reduced outputs;
per-sim panels stay on the rank that owns them.

One process a card, not one process driving every card as the JAX local
mesh does: the backward is bound by the host launching its kernels and glue
(PERF.md §5), so each card needs a launching thread of its own.

A mesh here is the group itself: ``make_mesh`` gives the world group, or
None (a group of one) when ``torch.distributed`` is not initialised; None and
a group of one run the single-device engine, bit for bit.  The path count
must divide the group's size (``pad_num_sims``); a valuation never falls
back to fewer ranks, and never values the whole panel on every rank.

Whether a valuation streams its paths is decided here from each rank's share
(``footprint_bytes`` over ``stream_threshold``), and agreed by all ranks: if
any rank's share would not fit, every rank streams.
"""
from __future__ import annotations

import logging
import typing as tp

import torch
import torch.distributed as dist

from ..api import resolve_device
from ..engines import lsmc as lsmc_engine
from ..models import spot_sim
from . import reduce as preduce

logger = logging.getLogger("storage_tpu_torch.parallel")

# A valuation streams its paths (``engines.lsmc.StreamedSims``, ``HostRows``)
# when its materialised footprint on a rank (``footprint_bytes``) exceeds
# ``stream_threshold``: on the CPU the JAX package's 4 GiB
# (storage_tpu/parallel/mesh.py:43), on CUDA a share of the card's free
# memory at the call.  The rest of a materialised valuation's peak is the
# regression payload, the step tables and a segment's temporaries: 0.75
# leaves room for them and for the caching allocator's slack (PERF.md §5
# gives the measured peak beside the footprint at the hourly year).
STREAM_THRESHOLD_BYTES = 4 << 30
STREAM_FREE_SHARE = 0.75


def panel_bytes(num_steps: int, num_sims: int, num_factors: int, itemsize: int,
                num_sets: int = 2) -> int:
    """Bytes of the materialised path panels, spot [N+1, S] and factors
    [N+1, F, S] a set (two sets, or one when the valuation reuses the
    regression paths): the JAX package's ``_panel_bytes``."""
    return num_sets * (num_steps + 1) * num_sims * (num_factors + 1) * itemsize


def footprint_bytes(num_steps: int, num_sims: int, num_factors: int, num_grid: int,
                    itemsize: int, num_sets: int = 2) -> int:
    """A materialised valuation's device footprint over ``num_sims`` paths
    (a rank's share): its path panels and the backward's two [G, S] value
    panels."""
    return (panel_bytes(num_steps, num_sims, num_factors, itemsize, num_sets)
            + 2 * num_grid * num_sims * itemsize)


def stream_threshold(device) -> int:
    """The footprint above which a valuation on ``device`` streams its paths:
    ``STREAM_FREE_SHARE`` of the card's free memory now, or
    ``STREAM_THRESHOLD_BYTES`` off the card."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(STREAM_FREE_SHARE * free)
    return STREAM_THRESHOLD_BYTES


def streams(footprint: int, device, group) -> bool:
    """Whether a valuation whose rank holds ``footprint`` bytes streams: its
    rank's verdict, agreed by every rank of ``group`` (any rank's share
    that does not fit makes them all stream, so that cards with different
    free memory take one route)."""
    return preduce.any_rank(footprint > stream_threshold(device), group)


def make_mesh(num_devices: tp.Optional[int] = None):
    """The paths mesh: the world process group (one rank per card) when
    ``torch.distributed`` is initialised, else None, a group of one.
    ``num_devices``, where given, must be the world's size (or 1 outside a
    group): a rank cannot leave a collective that the others enter."""
    if not (dist.is_available() and dist.is_initialized()):
        if num_devices not in (None, 1):
            raise ValueError(f"a mesh of {num_devices} devices needs a process group of "
                             f"{num_devices} ranks; call parallel.distributed.initialize first")
        return None
    world = dist.get_world_size()
    if num_devices not in (None, world):
        raise ValueError(f"the mesh is the world group of {world} ranks, one a card; "
                         f"{num_devices} asked")
    return dist.group.WORLD


def pad_num_sims(num_sims: int, num_devices: int) -> int:
    """Round the path count up to a multiple of the mesh size."""
    return -(-num_sims // num_devices) * num_devices


def local_sims(num_sims: int, mesh) -> int:
    """Each rank's share of ``num_sims`` paths; raises ``ValueError`` where
    the count does not divide the mesh's size."""
    n = preduce.size(mesh)
    if num_sims % n != 0:
        raise ValueError(f"num_sims ({num_sims}) must be a multiple of the mesh size ({n}); "
                         f"use pad_num_sims.")
    return num_sims // n


def path_ids(num_sims: int, mesh, device) -> torch.Tensor:
    """The global ids [S_local] of this rank's block of ``num_sims`` paths."""
    s_local = local_sims(num_sims, mesh)
    lo = preduce.rank(mesh) * s_local
    return torch.arange(lo, lo + s_local, dtype=torch.int64, device=device)


def sim_inputs_from_precompute(pre, fwd, dtype, device="cuda") -> tp.Dict[str, torch.Tensor]:
    """The OU tables of ``multi_factor.simulation_precompute`` and the curve
    as tensors on ``device`` (CUDA unless the caller names another)."""
    device = resolve_device(device)
    as_t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    out = {k: as_t(getattr(pre, k)) for k in ("decay", "chol", "vols", "half_var")}
    out["fwd"] = as_t(fwd)
    return out


def _log_execution(mesh, num_sims: int, stream: bool) -> None:
    """Record the ranks and the route of a valuation."""
    logger.info("LSMC execution: %d rank(s), %d sims, paths=%s", preduce.size(mesh), num_sims,
                "streamed" if stream else "materialised")


def _replicated(mesh, arrays, sim_inputs, keys):
    """Rank 0's engine tables, OU tables and keys on every rank (they are
    the same on each by construction; ``distributed.replicate_to_global``)."""
    if preduce.active(mesh) is None:
        return arrays, sim_inputs, keys
    from . import distributed as pdist

    arrays, sim_inputs = pdist.replicate_to_global((arrays, sim_inputs), mesh)
    return arrays, sim_inputs, tuple(pdist.replicate_key(k, mesh) for k in keys)


def _rank_panels(mesh, *panels):
    """This rank's blocks of paths, checked to have one shape on every rank."""
    if preduce.active(mesh) is not None:
        from . import distributed as pdist

        pdist.check_uniform([p.shape for p in panels], mesh)
    return panels


def sharded_lsmc_core(
    mesh,
    arrays: tp.Dict[str, torch.Tensor],
    sim_inputs: tp.Dict[str, torch.Tensor],
    reg_key,
    val_key,
    num_sims: int,
    starting_inventory,
    monomials: tp.Tuple,
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    antithetic: bool = False,
    same_sims: bool = False,
    return_sim_data: bool = False,
    stream: tp.Optional[bool] = None,
    return_regression: bool = False,
    **kwargs,
) -> tp.Dict[str, torch.Tensor]:
    """LSMC with ``num_sims`` paths split over ``mesh``'s ranks: each rank
    simulates its own block (global path ids, ``spot_sim.simulate_ou_paths``
    on the keys) and the engine reduces across the group.  Returns the
    engine's result dict, the reduced outputs the same on every rank and
    the per-sim panels (``return_sim_data``) the rank's own [.., S_local].

    ``sim_inputs`` holds the OU tables decay/chol/vols/half_var/fwd
    (``sim_inputs_from_precompute``); ``same_sims`` reuses the regression
    paths for valuation.  ``stream`` regenerates the paths a segment at a
    time (``engines.lsmc.lsmc_core_streamed``, the same bits); where None
    the rank's footprint decides, agreed by every rank.  Other keywords go
    to ``engines.lsmc.lsmc_core_rows`` (``fullstep`` only outside a group of
    more than one rank)."""
    device = arrays["grids"].device
    ids = path_ids(num_sims, mesh, device)  # raises unless the count divides the mesh
    arrays, sim_inputs, (reg_key, val_key) = _replicated(mesh, arrays, sim_inputs,
                                                         (reg_key, val_key))
    if stream is None:
        footprint = footprint_bytes(
            arrays["grids"].shape[0] - 1, ids.shape[0], sim_inputs["decay"].shape[1],
            arrays["grids"].shape[1], arrays["grids"].element_size(),
            num_sets=1 if same_sims else 2)
        stream = not return_sim_data and streams(footprint, device, mesh)
    if stream and return_sim_data:
        raise ValueError("Per-sim panels require materialised paths; pass stream=False "
                         "or return_sim_data=False.")
    _log_execution(mesh, num_sims, stream)
    if stream:
        reg, val = lsmc_engine.streamed_sims(sim_inputs, reg_key, val_key, ids, antithetic,
                                             same_sims)
    else:
        args = [sim_inputs[k] for k in ("decay", "chol", "vols", "half_var", "fwd")]
        reg_paths = spot_sim.simulate_ou_paths(reg_key, ids, *args, antithetic=antithetic)
        val_paths = reg_paths if same_sims else spot_sim.simulate_ou_paths(
            val_key, ids, *args, antithetic=antithetic)
        reg = lsmc_engine.PanelRows(reg_paths.spot, reg_paths.factors)
        val = lsmc_engine.PanelRows(val_paths.spot, val_paths.factors)
    return lsmc_engine.lsmc_core_rows(
        arrays, reg, val, starting_inventory, monomials, num_extra_decisions, discount_deltas,
        terminal_fn, ratchet_is_step, return_sim_data=return_sim_data,
        return_regression=return_regression, group=mesh, **kwargs)


def lsmc_core_from_sims(
    arrays: tp.Dict[str, torch.Tensor],
    spot_reg, factors_reg, spot_val, factors_val,
    starting_inventory,
    monomials: tp.Tuple,
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    return_sim_data: bool = False,
    mesh=None,
    return_regression: bool = False,
    uniform_grids: bool = True,
    **kwargs,
) -> tp.Dict[str, torch.Tensor]:
    """LSMC over pre-simulated panels ([N+1, S] spot, [N+1, F, S] factors
    of each set), split over ``mesh`` (the world group where None and
    ``torch.distributed`` is initialised): the panels are this rank's block
    of the global ones (``distributed.host_local_sims_to_global``), of one
    shape on every rank.  Outside a group, the single-device engine."""
    mesh = make_mesh() if mesh is None else mesh
    panels = _rank_panels(mesh, spot_reg, factors_reg, spot_val, factors_val)
    if preduce.active(mesh) is not None:
        arrays, _, _ = _replicated(mesh, arrays, {}, ())
    _log_execution(mesh, spot_reg.shape[1] * preduce.size(mesh), False)
    return lsmc_engine.lsmc_core(
        arrays, *panels, starting_inventory, monomials, num_extra_decisions, discount_deltas,
        terminal_fn, ratchet_is_step, return_sim_data=return_sim_data,
        return_regression=return_regression, uniform_grids=uniform_grids, group=mesh, **kwargs)


def sharded_ad_deltas(
    mesh,
    arrays: tp.Dict[str, torch.Tensor],
    sim_inputs: tp.Dict[str, torch.Tensor],
    reg_key,
    val_key,
    num_sims: int,
    starting_inventory,
    monomials: tp.Tuple,
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    antithetic: bool = False,
    same_sims: bool = False,
    **kwargs,
):
    """Path-split adjoint deltas with streamed paths: each rank values its
    own block (``engines.lsmc.lsmc_npv_and_ad_deltas_streamed``), takes the
    gradient of its own mean with the VJP kernel on each segment's rows, and
    the ranks' NPVs and gradients are averaged.  Returns (npv, deltas
    [N+1]), the same on every rank."""
    device = arrays["grids"].device
    ids = path_ids(num_sims, mesh, device)
    arrays, sim_inputs, (reg_key, val_key) = _replicated(mesh, arrays, sim_inputs,
                                                         (reg_key, val_key))
    return lsmc_engine.lsmc_npv_and_ad_deltas_streamed(
        arrays, sim_inputs, reg_key, val_key, ids, starting_inventory, monomials,
        num_extra_decisions, discount_deltas, terminal_fn, ratchet_is_step,
        antithetic=antithetic, same_sims=same_sims, group=mesh, **kwargs)


def sharded_ad_deltas_from_sims(
    arrays: tp.Dict[str, torch.Tensor],
    spot_reg, factors_reg, spot_val, factors_val,
    starting_inventory,
    monomials: tp.Tuple,
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    mesh=None,
    uniform_grids: bool = True,
    **kwargs,
):
    """Adjoint deltas over pre-simulated panels, this rank's block of them
    (as ``lsmc_core_from_sims``): the backward with the moments summed
    across the group, then each rank's VJP of its own mean, averaged.
    Returns (npv, deltas [N+1]), the same on every rank."""
    mesh = make_mesh() if mesh is None else mesh
    spot_reg, factors_reg, spot_val, factors_val = _rank_panels(
        mesh, spot_reg, factors_reg, spot_val, factors_val)
    if preduce.active(mesh) is not None:
        arrays, _, _ = _replicated(mesh, arrays, {}, ())
    result = lsmc_engine.lsmc_core(
        arrays, spot_reg, factors_reg, spot_val, factors_val, starting_inventory, monomials,
        num_extra_decisions, discount_deltas, terminal_fn, ratchet_is_step,
        uniform_grids=uniform_grids, adjoint=True, group=mesh, **kwargs)
    return result["npv"], lsmc_engine.adjoint_deltas(result["adjoint_tape"])
