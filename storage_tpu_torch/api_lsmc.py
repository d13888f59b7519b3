"""LSMC public API: ``three_factor_seasonal_value``, ``multi_factor_value``
and ``value_from_sims`` (counterparts of ``storage_tpu.api_lsmc``), pandas at
the boundary and the torch engine inside.  Everything runs on CUDA unless
the caller passes ``device="cpu"``; without a CUDA device a call that names
none raises.

Accepted: every ``sim_data_returned`` flag (per-sim panels of paths held on
the card), pathwise and adjoint deltas (``deltas_method="adjoint"``: reverse
mode through the pricing run's own forward sweep, whose VJP is a kernel;
NPV, SE, profiles and triggers stay the pricing run's bits), antithetic
draws (path 2m+1 takes the negated draws of path 2m, as in the JAX package),
progress and cancel callbacks, a checkpoint of the regression
(``checkpoint_path``, with a DSL-string basis), custom inventory grids
(``grid_calc``: rows that are all evenly spaced keep the main path and its
bits, others take the search placement of both passes, kernel C's
general-grid mode forward), and any basis the JAX package takes: the DSL
string, combinators (``ONE + S + X0**2``) and generic callables, which must
be torch-callable (a generic basis regresses on a design read from memory:
kernel D backward and kernel C's design mode forward).

With ``on_progress_update`` or ``cancellation_poll`` the valuation is
interactive, as the JAX package's host-chunked runs: progress at the
phase marks 0.2 (paths simulated), 0.3 (intrinsic value), 0.9 and 1.0, and
after every 16-step segment of the backward (0.3 to 0.7) and of the forward
(0.7 to 0.9); the poll is read before each, and a true poll raises
``jobs.JobCancelledError``.  An interactive run gives the uninterrupted
run's bits.  A valuation whose materialised panels would exceed the
streaming threshold (``parallel.mesh.stream_threshold``: a share of the
card's free memory) streams them, decided from shapes before anything is
allocated: simulated paths are regenerated a segment at a time
(``engines.lsmc.StreamedSims``), user panels stay in host memory and are
copied a segment at a time (``engines.lsmc.HostRows``); both give the
materialised run's bits.

Where ``torch.distributed`` is initialised with more than one process
(``parallel.distributed.initialize``, or ``torchrun``), every entry point
splits the paths over the world group, one rank a card (``parallel.mesh``):
rank r simulates, or takes from the user's frames, the global paths
[r·S/W, (r+1)·S/W), the engine sums across the ranks, and every rank
returns the same result.  The path count must divide the group's size, no
per-sim or path panel is returned (a rank holds only its own), the route is
agreed by every rank, only rank 0 writes a checkpoint, and an interactive
run polls every rank's ``cancellation_poll`` at each progress mark, so that
all ranks stop at the same segment.  ``value_from_sims_host_local`` takes
each process's own block of the user's paths.  A world of one process is
the single-device run, bit for bit.

Every entry point takes a basis of any size on a model of any factor count,
on either device.  The kernels' route is chosen from those shapes before
anything runs (``engines.lsmc.design_in_memory``): a basis with a user
callable, or of more than 64 terms, builds its design in memory (kernel D
backward, kernel C's design mode forward); any other runs kernels B and C's
monomial mode, which build it on the card (past 16 terms or 8 factors on
their wide routes), as the JAX package's fused kernels do.
Every entry point takes an inventory grid of any size that the card's
memory holds: on CUDA each kernel's grid route, "shared" while a step's
tables fit a block's shared memory, else "large", is decided from the
shapes before anything is simulated (``engines.lsmc.grid_routes``) and
logged.  Seeds keep
the JAX key semantics: ``key(seed)`` for the regression sims,
``fold_in(key, 0x5EED)`` for the valuation sims when ``fwd_sim_seed`` is
None, one shared set when the two seeds are equal.

Every result carries the intrinsic value and profile, as the JAX package's
do: the intrinsic DP (``engines.intrinsic``) on the valuation's own grid
tables, in its dtype, with no extra decision, run after the simulation and
before the LSMC engine (on the card, one launch of the DP kernel).  On custom
rows that are not evenly spaced it takes its general interpolation, as the
JAX package does for every ``grid_calc``; evenly spaced custom rows keep
the linear one here, and with it the main path's bits.
"""
from __future__ import annotations

import logging
import typing as tp

import numpy as np
import pandas as pd
import torch

from . import basis as basis_mod
from . import grid as gridmod
from .api import Device, engine_profile, profile_data_frame, resolve_device
from .engines import intrinsic as intrinsic_engine
from .engines import lsmc as lsmc_engine
from .checkpoint import make_checkpoint
from .facility import CmdtyStorage
from .jobs import JobCancelledError
from .models import multi_factor as mf
from .models import spot_sim
from .ops import _build
from .parallel import distributed as pdist
from .parallel import mesh as pmesh
from .parallel import reduce as preduce
from .profiling import Stopwatches
from .results import (
    MultiFactorValuationResults,
    SimulationDataReturned,
    TriggerPricePoint,
    TriggerPriceProfile,
)
from .utils import discount as dsc
from .utils import periods as pu
from .valuation_inputs import prepare_valuation

logger = logging.getLogger("storage_tpu_torch.multi_factor")

DEFAULT_NUM_GRID_POINTS = 100  # reference default (ExcelArg.cs:130, intrinsic.py:48)


def three_factor_seasonal_value(
    cmdty_storage: CmdtyStorage,
    val_date: pu.PeriodSpec,
    inventory: float,
    fwd_curve: pd.Series,
    interest_rates: tp.Union[float, pd.Series],
    settlement_rule: tp.Optional[dsc.SettlementRule],
    spot_mean_reversion: float,
    spot_vol: float,
    long_term_vol: float,
    seasonal_vol: float,
    num_sims: int,
    basis_funcs: str,
    discount_deltas: bool,
    seed: tp.Optional[int] = None,
    fwd_sim_seed: tp.Optional[int] = None,
    extra_decisions: tp.Optional[int] = None,
    num_inventory_grid_points: int = DEFAULT_NUM_GRID_POINTS,
    numerical_tolerance: float = 1e-12,
    on_progress_update=None,
    sim_data_returned: SimulationDataReturned = SimulationDataReturned.NONE,
    dtype=torch.float32,
    antithetic: bool = False,
    cancellation_poll=None,
    deltas_method: str = "pathwise",
    checkpoint_path: tp.Optional[str] = None,
    grid_calc=None,
    *,
    device: Device = "cuda",
    snap_interp: bool = False,
) -> MultiFactorValuationResults:
    """3-factor seasonal LSMC valuation (reference ``multi_factor.py:99-135``).
    Basis functions may name the factors ``x_st``/``x_lt``/``x_sw`` or
    ``x0``/``x1``/``x2``.  ``device`` is where the sims and the engine run
    (CUDA unless the caller asks for the CPU); ``snap_interp`` rounds
    interpolation weights to the 1/256 grid of the TPU run."""
    val_period = pu.to_period(val_date, cmdty_storage.start.freqstr)
    factors, factor_corrs = mf.create_3_factor_seasonal_params(
        cmdty_storage.freq, spot_mean_reversion, spot_vol, long_term_vol,
        seasonal_vol, val_period, cmdty_storage.end,
    )
    return multi_factor_value(
        cmdty_storage, val_date, inventory, fwd_curve, interest_rates,
        settlement_rule, factors, factor_corrs, num_sims, basis_funcs,
        discount_deltas, seed=seed, fwd_sim_seed=fwd_sim_seed,
        extra_decisions=extra_decisions,
        num_inventory_grid_points=num_inventory_grid_points,
        numerical_tolerance=numerical_tolerance,
        on_progress_update=on_progress_update,
        sim_data_returned=sim_data_returned, dtype=dtype, antithetic=antithetic,
        cancellation_poll=cancellation_poll, deltas_method=deltas_method,
        checkpoint_path=checkpoint_path, grid_calc=grid_calc, device=device,
        snap_interp=snap_interp,
    )


def _check_deltas_method(deltas_method):
    if deltas_method not in ("pathwise", "adjoint"):
        raise ValueError(
            f"deltas_method must be 'pathwise' or 'adjoint', got {deltas_method!r}."
        )


def multi_factor_value(
    cmdty_storage: CmdtyStorage,
    val_date: pu.PeriodSpec,
    inventory: float,
    fwd_curve: pd.Series,
    interest_rates: tp.Union[float, pd.Series],
    settlement_rule: tp.Optional[dsc.SettlementRule],
    factors: tp.Collection[mf.FactorType],
    factor_corrs: mf.FactorCorrsType,
    num_sims: int,
    basis_funcs: str,
    discount_deltas: bool,
    seed: tp.Optional[int] = None,
    fwd_sim_seed: tp.Optional[int] = None,
    extra_decisions: tp.Optional[int] = None,
    num_inventory_grid_points: int = DEFAULT_NUM_GRID_POINTS,
    numerical_tolerance: float = 1e-12,
    on_progress_update=None,
    sim_data_returned: SimulationDataReturned = SimulationDataReturned.NONE,
    dtype=torch.float32,
    antithetic: bool = False,
    cancellation_poll=None,
    deltas_method: str = "pathwise",
    checkpoint_path: tp.Optional[str] = None,
    grid_calc=None,
    *,
    device: Device = "cuda",
    snap_interp: bool = False,
) -> MultiFactorValuationResults:
    """General multi-factor LSMC valuation (reference ``multi_factor.py:138-168``)
    with pathwise deltas (LsmcStorageValuation.cs:513-518) or adjoint ones
    (``deltas_method="adjoint"``).
    ``sim_data_returned`` selects the per-sim panels returned (path panels,
    inventory, volumes, fuel, loss, net volume, PV); it never changes the
    numbers."""
    del numerical_tolerance  # accepted for API parity; a no-op, as in the JAX package
    device = resolve_device(device)
    _check_deltas_method(deltas_method)
    factor_corrs = mf.validate_multi_factor_params(factors, factor_corrs)

    sims = _SimulatedPaths(factors, factor_corrs, cmdty_storage.freq, num_sims, seed,
                           fwd_sim_seed, antithetic, dtype, device, pmesh.make_mesh())
    return _lsmc_calc(
        cmdty_storage, val_date, inventory, fwd_curve, interest_rates, settlement_rule,
        sims, basis_funcs, discount_deltas, extra_decisions,
        num_inventory_grid_points, sim_data_returned, dtype, device, snap_interp,
        on_progress_update, cancellation_poll, checkpoint_path, deltas_method, grid_calc,
    )


def value_from_sims(
    cmdty_storage: CmdtyStorage,
    val_date: pu.PeriodSpec,
    inventory: float,
    fwd_curve: pd.Series,
    interest_rates: tp.Union[float, pd.Series],
    settlement_rule: tp.Optional[dsc.SettlementRule],
    sim_spot_regress: pd.DataFrame,
    sim_spot_valuation: pd.DataFrame,
    basis_funcs: str,
    discount_deltas: bool,
    sim_factors_regress: tp.Optional[tp.Iterable[pd.DataFrame]] = None,
    sim_factors_valuation: tp.Optional[tp.Iterable[pd.DataFrame]] = None,
    extra_decisions: tp.Optional[int] = None,
    num_inventory_grid_points: int = DEFAULT_NUM_GRID_POINTS,
    numerical_tolerance: float = 1e-12,
    on_progress_update=None,
    sim_data_returned: SimulationDataReturned = SimulationDataReturned.NONE,
    dtype=torch.float32,
    cancellation_poll=None,
    deltas_method: str = "pathwise",
    checkpoint_path: tp.Optional[str] = None,
    grid_calc=None,
    *,
    device: Device = "cuda",
    snap_interp: bool = False,
) -> MultiFactorValuationResults:
    """Valuation from user-supplied spot/factor simulations (reference
    ``multi_factor.py:171-208`` / ``SpotSimResultsFromPanels.cs:36-117``).
    DataFrames are period-indexed [periods x sims] and must cover the active
    storage window; spot-only panels (no factor frames) take the engine's
    spot-only backward (kernel D).  The panels are held on ``device``, or,
    beyond the streaming threshold, in host memory and fed to it a segment at
    a time (``sim_data_returned`` then raises ``ValueError``).  In a group
    of processes each rank takes its own block of the frames' columns."""
    del numerical_tolerance  # accepted for API parity; a no-op, as in the JAX package
    device = resolve_device(device)
    _check_deltas_method(deltas_method)
    sims = _UserPanels(sim_spot_regress, sim_spot_valuation, sim_factors_regress,
                       sim_factors_valuation, dtype, device, pmesh.make_mesh())
    return _lsmc_calc(
        cmdty_storage, val_date, inventory, fwd_curve, interest_rates, settlement_rule,
        sims, basis_funcs, discount_deltas, extra_decisions,
        num_inventory_grid_points, sim_data_returned, dtype, device, snap_interp,
        on_progress_update, cancellation_poll, checkpoint_path, deltas_method, grid_calc,
    )


def value_from_sims_host_local(
    cmdty_storage: CmdtyStorage,
    val_date: pu.PeriodSpec,
    inventory: float,
    fwd_curve: pd.Series,
    interest_rates: tp.Union[float, pd.Series],
    settlement_rule: tp.Optional[dsc.SettlementRule],
    sim_spot_regress: pd.DataFrame,
    sim_spot_valuation: pd.DataFrame,
    basis_funcs: str,
    discount_deltas: bool,
    sim_factors_regress: tp.Optional[tp.Iterable[pd.DataFrame]] = None,
    sim_factors_valuation: tp.Optional[tp.Iterable[pd.DataFrame]] = None,
    extra_decisions: tp.Optional[int] = None,
    num_inventory_grid_points: int = DEFAULT_NUM_GRID_POINTS,
    numerical_tolerance: float = 1e-12,
    on_progress_update=None,
    dtype=torch.float32,
    cancellation_poll=None,
    deltas_method: str = "pathwise",
    checkpoint_path: tp.Optional[str] = None,
    grid_calc=None,
    *,
    device: Device = "cuda",
    snap_interp: bool = False,
) -> MultiFactorValuationResults:
    """Multi-process ``value_from_sims``: the frames are THIS process's block
    of paths, and the blocks of all processes form the global panel (process
    p owns global sims [p·S_local, (p+1)·S_local)).  Each block is checked
    as ``value_from_sims`` checks its frames, and every process must hold
    blocks of one shape (``parallel.distributed.host_local_sims_to_global``).
    Per-sim panels are not returned (each process holds only its own), so
    there is no ``sim_data_returned``.  Outside a group of processes, the
    frames are the whole panel."""
    del numerical_tolerance  # accepted for API parity; a no-op, as in the JAX package
    device = resolve_device(device)
    _check_deltas_method(deltas_method)
    sims = _UserPanels(sim_spot_regress, sim_spot_valuation, sim_factors_regress,
                       sim_factors_valuation, dtype, device, pmesh.make_mesh(), host_local=True)
    return _lsmc_calc(
        cmdty_storage, val_date, inventory, fwd_curve, interest_rates, settlement_rule,
        sims, basis_funcs, discount_deltas, extra_decisions,
        num_inventory_grid_points, SimulationDataReturned.NONE, dtype, device, snap_interp,
        on_progress_update, cancellation_poll, checkpoint_path, deltas_method, grid_calc,
    )


class _SimulatedPaths:
    """The paths of a simulated valuation: the regression set from
    ``key(seed)``, the valuation set from ``fold_in(key, 0x5EED)`` when
    ``fwd_sim_seed`` is None (one shared set when the two seeds are equal),
    either simulated whole (``materialise``) or regenerated a segment at a
    time by the engine (``stream``): in a group, this rank's block of the
    global paths (``num_sims`` its share)."""

    user_panels = False

    def __init__(self, factors, factor_corrs, freq, num_sims, seed, fwd_sim_seed, antithetic,
                 dtype, device, group=None):
        self.factors, self.factor_corrs, self.freq = factors, factor_corrs, freq
        self.group, self.total_sims = group, int(num_sims)
        self.num_sims = pmesh.local_sims(self.total_sims, group)
        self.num_factors = len(factors)
        self.antithetic, self.dtype, self.device = antithetic, dtype, device
        self.reg_key = spot_sim.key_from_seed(0 if seed is None else int(seed))
        if fwd_sim_seed is None:
            # Independent stream derived from the regression seed.
            self.val_key = spot_sim.fold_in(self.reg_key, 0x5EED)
        else:
            self.val_key = spot_sim.key_from_seed(int(fwd_sim_seed))
        self.same_sims = (fwd_sim_seed is not None
                          and int(fwd_sim_seed) == int(0 if seed is None else seed))
        self.num_sets = 1 if self.same_sims else 2

    def _tables(self, inputs):
        pre = mf.simulation_precompute(
            self.factors, self.factor_corrs, inputs.val_day, list(inputs.periods), self.freq)
        as_t = lambda a: torch.tensor(np.asarray(a), dtype=self.dtype, device=self.device)  # noqa: E731
        sim_inputs = {k: as_t(getattr(pre, k)) for k in ("decay", "chol", "vols", "half_var")}
        sim_inputs["fwd"] = as_t(inputs.fwd)
        return sim_inputs, pmesh.path_ids(self.total_sims, self.group, self.device)

    def materialise(self, inputs):
        sim_inputs, path_ids = self._tables(inputs)
        args = [sim_inputs[k] for k in ("decay", "chol", "vols", "half_var", "fwd")]
        logger.info("Simulating price paths on %s.", self.device)
        reg = spot_sim.simulate_ou_paths(self.reg_key, path_ids, *args, antithetic=self.antithetic)
        val = reg if self.same_sims else spot_sim.simulate_ou_paths(
            self.val_key, path_ids, *args, antithetic=self.antithetic)
        return (reg.spot, reg.factors), (val.spot, val.factors)

    def stream(self, inputs):
        sim_inputs, path_ids = self._tables(inputs)
        return lsmc_engine.streamed_sims(sim_inputs, self.reg_key, self.val_key, path_ids,
                                         self.antithetic, self.same_sims)


class _UserPanels:
    """The paths of ``value_from_sims``: the user's frames as host arrays,
    copied whole to the device (``materialise``) or kept in host memory and
    copied a segment at a time (``stream``, ``engines.lsmc.HostRows``).  In
    a group, this rank's block of the frames' columns, or (``host_local``)
    the frames whole as this rank's block of the global panel."""

    user_panels = True
    num_sets = 2

    def __init__(self, spot_regress, spot_valuation, factors_regress, factors_valuation, dtype,
                 device, group=None, host_local: bool = False):
        self.frames = [(spot_regress, None if factors_regress is None else list(factors_regress)),
                       (spot_valuation,
                        None if factors_valuation is None else list(factors_valuation))]
        self.dtype, self.device, self.group, self.host_local = dtype, device, group, host_local
        self.num_sims = spot_regress.shape[1]
        if not host_local:
            self.num_sims = pmesh.local_sims(self.num_sims, group)
        self.num_factors = max(len(f or ()) for _, f in self.frames)

    def _host(self, inputs):
        error = None
        try:
            reg, val = (self._block(_frames_to_sims(spot, factors, inputs, label, self.dtype))
                        for (spot, factors), label in zip(self.frames, ("regress", "valuation")))
            if reg[0].shape[1] != val[0].shape[1]:
                raise ValueError(
                    "Regression and valuation simulations must have the same number of sims."
                )
        except ValueError as exc:
            error = exc
        if preduce.active(self.group) is not None:
            # A rank whose frames are refused must not leave the others
            # waiting in a collective; then every rank's blocks are one shape.
            pdist.raise_if_any_failed(error, self.group)
            for spot, factors in (reg, val):
                pdist.host_local_sims_to_global(spot, factors, self.group)
        elif error is not None:
            raise error
        return reg, val

    def _block(self, sims):
        """This rank's columns of the whole panel's arrays (host-local frames
        are the rank's block already)."""
        if self.host_local or preduce.active(self.group) is None:
            return sims
        lo = preduce.rank(self.group) * self.num_sims
        return tuple(np.ascontiguousarray(a[..., lo:lo + self.num_sims]) for a in sims)

    def materialise(self, inputs):
        return tuple((torch.tensor(spot, device=self.device),
                      torch.tensor(fac, device=self.device)) for spot, fac in self._host(inputs))

    def stream(self, inputs):
        return tuple(lsmc_engine.HostRows(spot, fac, self.device)
                     for spot, fac in self._host(inputs))


def _frames_to_sims(spot_frame, factor_frames, inputs, label, dtype):
    """User panels as host numpy arrays of ``dtype``: spot [P, S] and
    factors [P, F, S] (F = 0 for spot-only panels)."""
    periods = inputs.periods
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    spot = _align_frame(spot_frame, periods, f"sim_spot_{label}")
    factors = [
        _align_frame(f, periods, f"sim_factors_{label}[{i}]")
        for i, f in enumerate(factor_frames if factor_frames is not None else [])
    ]
    # C order whatever the frames' dtype: an f32 frame's values come out in
    # Fortran order, and the kernels take contiguous rows.
    spot_arr = np.ascontiguousarray(spot, np_dtype)
    if factors:
        fac_arr = np.ascontiguousarray(np.stack(factors, axis=1), np_dtype)  # [P, F, S]
    else:
        fac_arr = np.zeros((spot_arr.shape[0], 0, spot_arr.shape[1]), np_dtype)
    return spot_arr, fac_arr


def _align_frame(frame: pd.DataFrame, periods: pd.PeriodIndex, name: str) -> np.ndarray:
    if not isinstance(frame.index, pd.PeriodIndex):
        frame = frame.copy()
        frame.index = pd.PeriodIndex(frame.index, freq=periods.freqstr)
    missing = periods.difference(frame.index)
    if len(missing) > 0:
        raise ValueError(f"{name} does not contain a row for period {missing[0]}.")
    return frame.reindex(periods).to_numpy(dtype=np.float64)


def _route(sims, num_steps: int, num_grid: int, sim_data_returned, grid_calc, dtype,
           device, group=None) -> bool:
    """Whether the valuation streams its paths, decided from shapes before
    anything is allocated (the JAX package's rule, storage_tpu/api_lsmc.py:
    520-528 and parallel/mesh.py:247-259): when the materialised footprint
    of this rank's paths (``parallel.mesh.footprint_bytes``) exceeds
    ``stream_threshold``, on any rank of ``group``.  User panels then stay
    in host memory, and asking for panels back raises; simulated paths
    stream only when no path or per-sim panel is asked for and there is no
    ``grid_calc``.  The route is logged."""
    flags = SimulationDataReturned
    wants_panels = _wants_sim_data(sim_data_returned) or bool(sim_data_returned & (
        flags.SPOT_REGRESS | flags.SPOT_VALUATION | flags.FACTORS_REGRESS
        | flags.FACTORS_VALUATION))
    itemsize = torch.finfo(dtype).bits // 8
    footprint = pmesh.footprint_bytes(num_steps, sims.num_sims, sims.num_factors, num_grid,
                                      itemsize, sims.num_sets)
    threshold = pmesh.stream_threshold(device)
    stream = pmesh.streams(footprint, device, group)
    if stream and sims.user_panels and wants_panels:
        raise ValueError(
            "sim_data_returned panels do not fit device memory at this path count; pass "
            "SimulationDataReturned.NONE."
        )
    stream = stream and (sims.user_panels or (not wants_panels and grid_calc is None))
    route = ("host-streamed" if sims.user_panels else "streamed") if stream else "materialised"
    logger.info(
        "LSMC execution: %d device(s) (%s), %d sims a device, paths=%s (%.2f GB of panels, "
        "threshold %.2f GB)", preduce.size(group), device, sims.num_sims, route, footprint / 1e9,
        threshold / 1e9,
    )
    return stream


def _wants_sim_data(flags: SimulationDataReturned) -> bool:
    return bool(flags & (
        SimulationDataReturned.INVENTORY | SimulationDataReturned.INJECT_WITHDRAW_VOLUME
        | SimulationDataReturned.CMDTY_CONSUMED | SimulationDataReturned.INVENTORY_LOSS
        | SimulationDataReturned.NET_VOLUME | SimulationDataReturned.PV
    ))


def _lsmc_calc(
    cmdty_storage: CmdtyStorage,
    val_date,
    inventory,
    fwd_curve,
    interest_rates,
    settlement_rule,
    sims,
    basis_funcs,
    discount_deltas: bool,
    extra_decisions,
    num_grid_points: int,
    sim_data_returned,
    dtype,
    device: torch.device,
    snap_interp: bool,
    on_progress_update=None,
    cancellation_poll=None,
    checkpoint_path: tp.Optional[str] = None,
    deltas_method: str = "pathwise",
    grid_calc=None,
) -> MultiFactorValuationResults:
    """The valuation shared by the entry points: ``sims`` (``_SimulatedPaths``
    or ``_UserPanels``) gives the regression and valuation paths on
    ``device``, materialised or as rows sources (``_route``), this rank's
    block of them in a group (``sims.group``)."""
    group = preduce.active(sims.group)
    if checkpoint_path is not None and not isinstance(basis_funcs, str):
        raise ValueError(
            "checkpoint_path requires basis_funcs as a string (checkpoints "
            "persist the basis DSL, not combinator objects)."
        )
    sim_data_returned = SimulationDataReturned.coerce(sim_data_returned)
    if group is not None and sim_data_returned != SimulationDataReturned.NONE:
        raise ValueError(
            "Per-sim and path panels are not available in a group of processes: each process "
            "holds only its own block of the paths. Pass SimulationDataReturned.NONE."
        )
    if isinstance(fwd_curve, pd.Series) and isinstance(
        fwd_curve.index, pd.PeriodIndex
    ) and cmdty_storage.start.freqstr != fwd_curve.index.freqstr:
        raise ValueError("cmdty_storage and forward_curve have different frequencies.")

    # Expired storage and valuation on the end period (LsmcStorageValuation.cs:64-87).
    val_period = pu.to_period(val_date, cmdty_storage.start.freqstr)
    if val_period > cmdty_storage.end:
        return _degenerate_results(0.0, cmdty_storage.freq)
    if val_period == cmdty_storage.end:
        if cmdty_storage.empty_at_end:
            if inventory > 0:
                raise ValueError(
                    "Storage must be empty at end, but inventory is greater than zero."
                )
            return _degenerate_results(0.0, cmdty_storage.freq)
        curve = fwd_curve
        if not isinstance(curve.index, pd.PeriodIndex):
            curve = curve.copy()
            curve.index = pd.PeriodIndex(curve.index, freq=cmdty_storage.start.freqstr)
        price = float(curve[val_period])
        return _degenerate_results(
            float(cmdty_storage.terminal_storage_npv(price, float(inventory))),
            cmdty_storage.freq,
        )

    # Interactive on every rank where any rank asked: each then takes the
    # same segmented passes and polls at the same marks.
    interactive = preduce.any_rank(
        on_progress_update is not None or cancellation_poll is not None, group)

    def progress(x: float):
        # Cooperative cancellation, polled at phase and segment boundaries
        # (the reference's per-step CancellationToken checks,
        # LsmcStorageValuation.cs:345,521); in a group every rank stops
        # where any rank's poll is true.
        cancelled = cancellation_poll is not None and cancellation_poll()
        if interactive and preduce.any_rank(cancelled, group):
            raise JobCancelledError("Valuation cancelled.")
        if on_progress_update is not None:
            on_progress_update(x)

    def segment_cb(phase, done, total):
        # Backward weighted ~2/3 of the compute phase like the reference
        # (LsmcStorageValuation.cs:48,164,387); capped at the 0.9 phase mark
        # (f64 rounding).
        frac = done / max(total, 1)
        part = 0.4 * frac if phase == "backward" else 0.4 + 0.2 * frac
        progress(min(0.3 + part, 0.9))

    monomials = tuple(basis_mod.coerce_basis_functions(basis_funcs))
    # The kernels' route, from shapes alone, before anything is simulated.
    if lsmc_engine.design_in_memory(monomials, sims.num_factors):
        generic = [str(m) for m in monomials if isinstance(m, basis_mod.GenericBasisFunction)]
        logger.info(
            "%s: the design is built in memory (kernel D backward, kernel C's design mode "
            "forward).",
            f"Generic basis function(s) present ({', '.join(generic)})" if generic else
            f"{len(monomials)} basis functions, past the monomial kernels' "
            f"{_build.MAX_WIDE_BASIS}",
        )
    stopwatches = Stopwatches()
    with stopwatches.time("prepare_inputs"):
        inputs = prepare_valuation(
            cmdty_storage, val_date, inventory, fwd_curve, interest_rates, settlement_rule
        )
    grids = None if grid_calc is None else gridmod.inventory_grids_custom(
        inputs.inventory_lower, inputs.inventory_upper, grid_calc)
    # Custom rows that are all evenly spaced keep the arithmetic placement;
    # others are placed by search (the JAX package's rule, api_lsmc.py:572).
    uniform_grids = grids is None or gridmod.rows_uniform(grids)
    if device.type == "cuda":
        # The kernels' grid routes, from shapes alone, before anything is
        # simulated.
        num_grid = num_grid_points if grids is None else grids.shape[1]
        routes = lsmc_engine.grid_routes(
            num_grid, int(extra_decisions or 0), monomials, sims.num_factors,
            inputs.compiled.ratchet_inv.shape[1], not uniform_grids, _build.smem_limit(device),
            inputs.num_steps, dtype.itemsize)
        logger.info("Kernel routes at G=%d: intrinsic %s, backward %s, forward %s.", num_grid,
                    *(f"{name} ({route})" for name, route in routes.values()))

    stream = _route(sims, len(inputs.periods) - 1, num_grid_points, sim_data_returned,
                    grid_calc, dtype, device, group)
    paths = dict.fromkeys(("spot_regress", "spot_valuation", "factors_regress",
                           "factors_valuation"))
    with stopwatches.time("path_simulation"):
        if stream:
            reg, val = sims.stream(inputs)
        else:
            (spot_reg, factors_reg), (spot_val, factors_val) = sims.materialise(inputs)
            paths = {"spot_regress": spot_reg, "spot_valuation": spot_val,
                     "factors_regress": factors_reg, "factors_valuation": factors_val}
            reg = lsmc_engine.PanelRows(spot_reg, factors_reg)
            val = lsmc_engine.PanelRows(spot_val, factors_val)
    if basis_mod.num_factors_required(monomials) > reg.num_factors:
        raise ValueError(
            f"Basis functions reference factor x{basis_mod.num_factors_required(monomials) - 1} "
            f"but only {reg.num_factors} factors are simulated."
        )
    progress(0.2)
    arrays = lsmc_engine.build_engine_arrays(
        inputs.compiled, inputs.fwd, inputs.df_settle, inputs.df_flow,
        inputs.inventory_lower, inputs.inventory_upper, num_grid_points, dtype, device, grids,
    )
    terminal_fn = None if inputs.compiled.must_be_empty_at_end else inputs.compiled.terminal_value
    logger.info("Calculating intrinsic value.")
    with stopwatches.time("intrinsic_valuation"):
        intrinsic = intrinsic_engine.intrinsic_core(
            arrays, inputs.starting_inventory, 0, terminal_fn, inputs.compiled.ratchet_is_step,
            uniform_grids=uniform_grids)
        intrinsic_profile = engine_profile(inputs.periods, intrinsic)
    progress(0.3)
    logger.info("Calculating LSMC value.")
    with stopwatches.time("lsmc_backward_forward"):
        result = lsmc_engine.lsmc_core_rows(
            arrays, reg, val, inputs.starting_inventory, monomials, int(extra_decisions or 0), bool(discount_deltas), terminal_fn,
            inputs.compiled.ratchet_is_step, snap_interp=snap_interp,
            return_regression=checkpoint_path is not None,
            return_sim_data=_wants_sim_data(sim_data_returned),
            segment_cb=segment_cb if interactive else None,
            uniform_grids=uniform_grids, adjoint=deltas_method == "adjoint", group=group,
        )
    if deltas_method == "adjoint":
        # Reverse mode through the sweep just run: only the deltas change.
        logger.info("Calculating adjoint (AD) deltas.")
        with stopwatches.time("adjoint_deltas"):
            result["deltas"] = lsmc_engine.adjoint_deltas(result.pop("adjoint_tape"))
    result = {k: v.detach().cpu().numpy() for k, v in result.items()}
    if checkpoint_path is not None and preduce.rank(group) == 0:
        # The backward's hand-off to the forward pass, so that a later
        # forward-only revaluation skips the backward (checkpoint.py).  Every
        # rank holds the same payload; rank 0 alone writes it.
        make_checkpoint(
            arrays, {k: result.pop(f"regression_{k}") for k in ("mean", "std", "coeffs")},
            basis_funcs, inputs.starting_inventory, int(extra_decisions or 0),
            bool(discount_deltas), inputs.compiled.ratchet_is_step,
            must_be_empty_at_end=terminal_fn is None,
        ).save(checkpoint_path)
    logger.info(
        "LSMC complete. Forward NPV %.2f (backward %.2f).",
        result["npv"], result["backward_npv"],
    )
    progress(0.9)
    out = _results(inputs.periods, result, sim_data_returned, paths, reg.num_factors,
                   intrinsic=(float(intrinsic.npv), intrinsic_profile))
    if logger.isEnabledFor(logging.INFO):
        logger.info("LSMC phase profile:\n%s", stopwatches.report())
    progress(1.0)
    return out


def _results(periods, result, sim_data_returned: SimulationDataReturned,
             paths, num_factors: int, intrinsic) -> MultiFactorValuationResults:
    """The result container; ``intrinsic`` is the intrinsic (NPV, profile
    frame); the per-sim panels the flags ask for become f64 frames (periods x
    sims); ``paths`` holds None for each path panel of a streamed run."""
    active = periods[:-1]
    f64 = lambda key: result[key].astype(np.float64)  # noqa: E731
    trigger_prices = pd.DataFrame(
        {
            "inject_volume": f64("max_inject_volume"),
            "inject_trigger_price": f64("max_inject_trigger_price"),
            "withdraw_volume": f64("max_withdraw_volume"),
            "withdraw_trigger_price": f64("max_withdraw_trigger_price"),
            "withdraw_max_volume_price": f64("withdraw_max_volume_price"),
        },
        index=active,
    )

    def points(volumes, prices):
        return [
            TriggerPricePoint(float(v), float(p))
            for v, p in zip(volumes, prices)
            if not (np.isnan(v) or np.isnan(p))
        ]

    trigger_profiles = pd.Series(
        data=[
            TriggerPriceProfile(
                points(result["trigger_inject_volumes"][t], result["trigger_inject_prices"][t]),
                points(result["trigger_withdraw_volumes"][t], result["trigger_withdraw_prices"][t]),
            )
            for t in range(len(active))
        ],
        index=active,
    )
    flags = SimulationDataReturned

    def frame(flag, data, index) -> pd.DataFrame:
        if not (sim_data_returned & flag) or data is None:
            return pd.DataFrame()
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()
        return pd.DataFrame(data=np.asarray(data, dtype=np.float64), index=index, copy=False)

    def factor_frames(flag, factors):
        if not sim_data_returned & flag or factors is None:
            return tuple(pd.DataFrame() for _ in range(num_factors))
        host = factors.detach().cpu().numpy()
        return tuple(frame(flag, host[:, i, :], periods) for i in range(host.shape[1]))

    return MultiFactorValuationResults(
        npv=float(result["npv"]),
        val_sim_standard_error=float(result["standard_error"]),
        deltas=pd.Series(data=f64("deltas"), index=periods),
        expected_profile=profile_data_frame(
            periods, result["profile_inventory"], result["profile_inject_withdraw"],
            result["profile_cmdty_consumed"], result["profile_inventory_loss"],
            result["profile_pv"],
        ),
        intrinsic_npv=intrinsic[0],
        intrinsic_profile=intrinsic[1],
        sim_spot_regress=frame(flags.SPOT_REGRESS, paths["spot_regress"], periods),
        sim_spot_valuation=frame(flags.SPOT_VALUATION, paths["spot_valuation"], periods),
        sim_factors_regress=factor_frames(flags.FACTORS_REGRESS, paths["factors_regress"]),
        sim_factors_valuation=factor_frames(flags.FACTORS_VALUATION, paths["factors_valuation"]),
        sim_inventory=frame(flags.INVENTORY, result.get("sim_inventory"), periods),
        sim_inject_withdraw=frame(
            flags.INJECT_WITHDRAW_VOLUME, result.get("sim_inject_withdraw"), active),
        sim_cmdty_consumed=frame(flags.CMDTY_CONSUMED, result.get("sim_cmdty_consumed"), active),
        sim_inventory_loss=frame(flags.INVENTORY_LOSS, result.get("sim_inventory_loss"), active),
        sim_net_volume=frame(flags.NET_VOLUME, result.get("sim_net_volume"), active),
        sim_pv=frame(flags.PV, result.get("sim_pv"), periods),
        trigger_prices=trigger_prices,
        trigger_profiles=trigger_profiles,
    )


def _degenerate_results(npv: float, freq: str) -> MultiFactorValuationResults:
    """Zero/terminal-value results with empty series/frames for expired or
    end-period valuations (LsmcStorageValuationResults.cs:60-105)."""
    empty_idx = pd.PeriodIndex([], freq=freq)
    empty_series = pd.Series(index=empty_idx, dtype=np.float64)
    empty_frame = pd.DataFrame(index=empty_idx)
    return MultiFactorValuationResults(
        npv=float(npv),
        val_sim_standard_error=0.0,
        deltas=empty_series,
        expected_profile=empty_frame,
        intrinsic_npv=float(npv),
        intrinsic_profile=empty_frame,
        sim_spot_regress=pd.DataFrame(),
        sim_spot_valuation=pd.DataFrame(),
        sim_factors_regress=(),
        sim_factors_valuation=(),
        sim_inventory=pd.DataFrame(),
        sim_inject_withdraw=pd.DataFrame(),
        sim_cmdty_consumed=pd.DataFrame(),
        sim_inventory_loss=pd.DataFrame(),
        sim_net_volume=pd.DataFrame(),
        sim_pv=pd.DataFrame(),
        trigger_prices=empty_frame,
        trigger_profiles=empty_series.copy(),
    )
