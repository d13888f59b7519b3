"""Shared host-side precompute for all valuation engines.

Gathers the guards + curve alignment + discount-factor / inventory-space
precompute that the reference repeats inside each engine
(``LsmcStorageValuation.cs:64-146``, ``IntrinsicStorageValuation.cs:125-179``,
``TreeStorageValuation.cs:149-211``) into one ``prepare_valuation`` call whose
output is plain numpy arrays ready to feed jit programs.
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
import typing as tp

import numpy as np
import pandas as pd

from . import grid as gridmod
from .facility import CmdtyStorage, CompiledStorage, compile_storage
from .utils import discount as dsc
from .utils import periods as pu


@dataclasses.dataclass(frozen=True, eq=False)
class ValuationInputs:
    storage: CmdtyStorage
    compiled: CompiledStorage
    val_period: pd.Period
    val_day: _dt.date
    starting_inventory: float
    fwd: np.ndarray  # [N+1] forward prices over active periods
    df_settle: np.ndarray  # [N]
    df_flow: np.ndarray  # [N]
    inventory_lower: np.ndarray  # [N+1]
    inventory_upper: np.ndarray  # [N+1]
    val_is_first_period: bool  # valuation period == first active period

    @property
    def num_steps(self) -> int:
        return self.compiled.num_steps

    @property
    def periods(self) -> pd.PeriodIndex:
        return self.compiled.periods


def prepare_valuation(
    storage: CmdtyStorage,
    val_date: pu.PeriodSpec,
    inventory: float,
    forward_curve: pd.Series,
    interest_rates: tp.Union[float, pd.Series],
    settlement_rule: tp.Optional[dsc.SettlementRule],
) -> ValuationInputs:
    if inventory < 0:
        raise ValueError("Inventory cannot be negative.")
    freq = storage.start.freqstr
    if isinstance(forward_curve.index, pd.PeriodIndex):
        if forward_curve.index.freqstr != freq:
            raise ValueError("cmdty_storage and forward_curve have different frequencies.")
    else:
        forward_curve = forward_curve.copy()
        forward_curve.index = pd.PeriodIndex(forward_curve.index, freq=freq)

    val_period = pu.to_period(val_date, freq)
    if val_period > storage.end:
        raise ValueError("Storage has expired.")
    compiled = compile_storage(storage, val_period)
    periods = compiled.periods

    fwd_aligned = forward_curve.reindex(periods)
    if fwd_aligned.isna().any():
        missing = fwd_aligned.index[fwd_aligned.isna()][0]
        if missing == periods[0]:
            raise ValueError(
                f"Forward curve starts too late. Must start on or before the period {periods[0]}."
            )
        raise ValueError("Forward curve does not extend until storage end period.")
    fwd = fwd_aligned.to_numpy(dtype=np.float64)

    # The valuation date day: first day of the valuation period
    # (LsmcStorageValuation.cs:134).
    val_day = pu.period_start_date(val_period)
    discounter = dsc.Discounter(interest_rates)
    df_settle, _ = dsc.discount_factors_for_periods(
        val_day, periods[:-1], settlement_rule, discounter
    )
    # Operating-cost cash flows settle per the storage's cost settlement rule,
    # defaulting to the period's first day (CmdtyStorage.cs:334-341); passing
    # the cost rule as the "settlement rule" here yields exactly those factors.
    df_flow, _ = dsc.discount_factors_for_periods(
        val_day, periods[:-1], storage.cost_settlement_rule, discounter
    )

    lower, upper = gridmod.calculate_inventory_space(storage, inventory, val_period)
    return ValuationInputs(
        storage=storage,
        compiled=compiled,
        val_period=val_period,
        val_day=val_day,
        starting_inventory=float(inventory),
        fwd=fwd,
        df_settle=df_settle,
        df_flow=df_flow,
        inventory_lower=lower,
        inventory_upper=upper,
        val_is_first_period=val_period >= storage.start,
    )
