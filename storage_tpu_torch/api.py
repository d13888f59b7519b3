"""Intrinsic and trinomial-tree valuation API (counterpart of
``storage_tpu.api``): ``intrinsic_value``, ``trinomial_value`` and
``trinomial_deltas``, pandas in, the torch engines inside.  They run on CUDA
unless the caller passes ``device="cpu"``: on the card the intrinsic DP is
one kernel launch (``ops.intrinsic_kernel``) and the tree's backward
induction one launch a valuation (``ops.tree_kernel``; one a step for a
slab beyond a thread-block cluster), on the CPU their plain versions.
"""
from __future__ import annotations

import typing as tp

import numpy as np
import pandas as pd
import torch

from .engines import intrinsic as intrinsic_engine
from .engines import tree as tree_engine
from .facility import CmdtyStorage
from .models import trinomial_tree as tt
from .utils import discount as dsc
from .utils import periods as pu
from .valuation_inputs import prepare_valuation

DEFAULT_NUM_GRID_POINTS = 100  # reference default (ExcelArg.cs:130, intrinsic.py:48)

Device = tp.Union[str, torch.device]


class IntrinsicValuationResults(tp.NamedTuple):
    npv: float
    profile: pd.DataFrame


def resolve_device(device: Device) -> torch.device:
    """The device of a valuation: CUDA unless the caller names another.  A
    CUDA device on a host without one raises rather than running elsewhere."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "storage_tpu_torch runs on a CUDA device, and this host has none; "
            "pass device='cpu' to run the kernels' plain versions on the CPU."
        )
    return device


def profile_data_frame(periods, inventory, inject_withdraw, cmdty_consumed,
                       inventory_loss, period_pv) -> pd.DataFrame:
    """Storage-profile frame in the reference column layout (intrinsic.py:88-111);
    ``net_volume = -inject_withdraw - consumed`` (StorageProfile.cs:28)."""
    net_volume = -np.asarray(inject_withdraw) - np.asarray(cmdty_consumed)
    return pd.DataFrame(
        {
            "inventory": np.asarray(inventory, dtype=np.float64),
            "inject_withdraw_volume": np.asarray(inject_withdraw, dtype=np.float64),
            "cmdty_consumed": np.asarray(cmdty_consumed, dtype=np.float64),
            "inventory_loss": np.asarray(inventory_loss, dtype=np.float64),
            "net_volume": net_volume.astype(np.float64),
            "period_pv": np.asarray(period_pv, dtype=np.float64),
        },
        index=periods,
    )


def engine_profile(periods, result: intrinsic_engine.IntrinsicEngineResult) -> pd.DataFrame:
    """The profile frame of an intrinsic engine result (read back to the host)."""
    host = [x.detach().cpu().numpy() for x in result[1:]]
    return profile_data_frame(periods, *host)


def intrinsic_value(
    cmdty_storage: CmdtyStorage,
    val_date: pu.PeriodSpec,
    inventory: tp.Union[float, int],
    forward_curve: pd.Series,
    interest_rates: tp.Union[float, pd.Series],
    settlement_rule: tp.Optional[dsc.SettlementRule],
    num_inventory_grid_points: int = DEFAULT_NUM_GRID_POINTS,
    numerical_tolerance: float = 1e-12,
    dtype=torch.float32,
    interpolation: str = "linear",
    grid_scheme: str = "linspace",
    grid_calc=None,
    *,
    device: Device = "cuda",
) -> IntrinsicValuationResults:
    """Intrinsic valuation (reference ``intrinsic.py:42-111``).

    ``numerical_tolerance`` is accepted for API parity and ignored, as in the
    JAX package.  ``interpolation``: 'linear' (default) or 'cubic' (natural
    cubic spline in inventory).  ``grid_scheme``: 'linspace' (default) or
    'fixed_spacing' (the reference's grid layout: per-period decisions
    exactly the reference's).  ``grid_calc``: the user's ``(lower, upper) ->
    grid points`` callable, or the points, per period
    (IDoubleStateSpaceGridCalc.cs:32); it overrides ``grid_scheme``.
    ``device`` is where the DP runs (CUDA unless the caller asks for the
    CPU)."""
    del numerical_tolerance  # a no-op, as in the JAX package
    device = resolve_device(device)
    storage = cmdty_storage
    val_period = pu.to_period(val_date, storage.start.freqstr)

    # Degenerate cases (IntrinsicStorageValuation.cs:128-152).
    if val_period > storage.end:
        return IntrinsicValuationResults(0.0, _empty_profile(storage.freq))
    if val_period == storage.end:
        if storage.empty_at_end:
            if inventory > 0:
                raise ValueError(
                    "Storage must be empty at end, but inventory is greater than zero."
                )
            return IntrinsicValuationResults(0.0, _empty_profile(storage.freq))
        price = float(forward_curve[val_period])
        return IntrinsicValuationResults(
            storage.terminal_storage_npv(price, inventory), _empty_profile(storage.freq)
        )

    inputs = prepare_valuation(
        storage, val_date, inventory, forward_curve, interest_rates, settlement_rule
    )
    result = intrinsic_engine.intrinsic_valuation(
        inputs.compiled, inputs.starting_inventory, inputs.fwd, inputs.df_settle,
        inputs.df_flow, inputs.inventory_lower, inputs.inventory_upper,
        num_grid_points=num_inventory_grid_points, dtype=dtype, interpolation=interpolation,
        grid_scheme=grid_scheme, grid_calc=grid_calc, device=device,
    )
    return IntrinsicValuationResults(float(result.npv), engine_profile(inputs.periods, result))


def trinomial_value(
    cmdty_storage: CmdtyStorage,
    val_date: pu.PeriodSpec,
    inventory: float,
    forward_curve: pd.Series,
    spot_volatility: pd.Series,
    mean_reversion: float,
    time_step: float,
    interest_rates: tp.Union[float, pd.Series],
    settlement_rule: tp.Optional[dsc.SettlementRule],
    num_inventory_grid_points: int = DEFAULT_NUM_GRID_POINTS,
    numerical_tolerance: float = 1e-12,
    dtype=torch.float32,
    interpolation: str = "linear",
    grid_calc=None,
    *,
    device: Device = "cuda",
) -> float:
    """One-factor trinomial-tree storage valuation (reference
    ``trinomial.py:36-85``).  Returns the NPV.

    ``interpolation``: 'linear' (default) or 'cubic' — continuation-value
    interpolation in inventory (``IInterpolatorFactory``,
    InterpolatorFactories/IInterpolatorFactory.cs:33).  ``grid_calc``: the
    user's ``(lower, upper) -> grid points`` callable, or the points, per
    period (``IDoubleStateSpaceGridCalc.GetGridPoints`` analog).  The lattice
    raises ``ValueError`` for a mean reversion too weak for its clamped
    edge branching (below ~1.34 at daily steps), as the JAX package's does.
    ``device`` is where the DP runs (CUDA unless the caller asks for the
    CPU)."""
    del numerical_tolerance  # a no-op, as in the JAX package
    device = resolve_device(device)
    storage = cmdty_storage
    freq = storage.start.freqstr
    val_period = pu.to_period(val_date, freq)

    if val_period > storage.end:
        return 0.0
    if val_period == storage.end:
        if storage.empty_at_end:
            if inventory > 0:
                raise ValueError(
                    "Storage must be empty at end, but inventory is greater than zero."
                )
            return 0.0
        price = float(forward_curve[val_period])
        return storage.terminal_storage_npv(price, inventory)

    if isinstance(spot_volatility.index, pd.PeriodIndex):
        if spot_volatility.index.freqstr != freq:
            raise ValueError(
                "cmdty_storage and spot_volatility have different frequencies."
            )
    inputs = prepare_valuation(
        storage, val_date, inventory, forward_curve, interest_rates, settlement_rule
    )
    # The tree starts at the valuation period (TreeStorageValuation.cs:171-184);
    # the storage DP starts at the first active period.
    tree_periods = pu.period_index(val_period, storage.end)
    fwd_tree = forward_curve.reindex(tree_periods)
    if fwd_tree.isna().any():
        raise ValueError(
            "Forward curve starts too late. Must start on or before the current period."
        )
    vols_tree = spot_volatility.reindex(tree_periods)
    if vols_tree.isna().any():
        raise ValueError("Spot volatility curve does not cover the valuation horizon.")
    tree = tt.build_tree(
        fwd_tree.to_numpy(dtype=np.float64),
        vols_tree.to_numpy(dtype=np.float64),
        mean_reversion,
        time_step,
    )
    offset = pu.period_offset(inputs.periods[0], val_period)
    result, _arrays, _lattice = tree_engine.tree_valuation(
        inputs.compiled, tree, offset, inputs.starting_inventory, inputs.fwd, inputs.df_settle,
        inputs.df_flow, inputs.inventory_lower, inputs.inventory_upper,
        num_grid_points=num_inventory_grid_points, dtype=dtype, interpolation=interpolation,
        grid_calc=grid_calc, device=device,
    )
    return float(result.npv)


def trinomial_deltas(
    cmdty_storage: CmdtyStorage,
    val_date: pu.PeriodSpec,
    inventory: float,
    forward_curve: pd.Series,
    spot_volatility: pd.Series,
    mean_reversion: float,
    time_step: float,
    interest_rates: tp.Union[float, pd.Series],
    settlement_rule: tp.Optional[dsc.SettlementRule],
    fwd_contracts: tp.Iterable,
    num_inventory_grid_points: int = DEFAULT_NUM_GRID_POINTS,
    numerical_tolerance: float = 1e-12,
    delta_shift: tp.Optional[float] = None,
    dtype=torch.float32,
    interpolation: str = "linear",
    grid_calc=None,
    *,
    device: Device = "cuda",
) -> tp.List[float]:
    """Deltas by central finite difference of the tree NPV in the forward
    curve, one bump per contract (reference ``trinomial.py:88-118``).
    ``fwd_contracts`` entries are period-likes or (start, end) range tuples.

    The default ``delta_shift`` is precision-aware: the reference's 1e-5 bump
    vanishes below float32 NPV resolution, so f32 valuations use 0.01."""
    device = resolve_device(device)
    if delta_shift is None:
        delta_shift = 1e-5 if dtype.itemsize >= 8 else 1e-2
    freq = cmdty_storage.start.freqstr
    deltas = []
    for contract in fwd_contracts:
        if isinstance(contract, tuple):
            start, end = (pu.to_period(c, freq) for c in contract)
        else:
            start = end = pu.to_period(contract, freq)
        bump = pd.Series(0.0, index=forward_curve.index)
        mask = (forward_curve.index >= start) & (forward_curve.index <= end)
        bump[mask] = delta_shift
        value_up, value_down = (
            trinomial_value(
                cmdty_storage, val_date, inventory, curve, spot_volatility, mean_reversion,
                time_step, interest_rates, settlement_rule, num_inventory_grid_points,
                numerical_tolerance, dtype, interpolation=interpolation, grid_calc=grid_calc,
                device=device,
            )
            for curve in (forward_curve + bump, forward_curve - bump)
        )
        deltas.append((value_up - value_down) / (2.0 * delta_shift))
    return deltas


def _empty_profile(freq: str) -> pd.DataFrame:
    index = pd.PeriodIndex([], freq=pu.normalise_freq(freq))
    return profile_data_frame(
        index, np.array([]), np.array([]), np.array([]), np.array([]), np.array([])
    )
