"""Result containers for the public API, mirroring the reference Python
package's shapes (``multi_factor.py:47-96``)."""
from __future__ import annotations

import enum
import typing as tp

import pandas as pd


class SimulationDataReturned(enum.Flag):
    """Which per-simulation panels to materialise (mirror of
    ``SimulationDataReturned`` — multi_factor.py:47-61 / SimulationDataReturned.cs:31).
    Controls result memory, never the numbers."""

    NONE = 0
    SPOT_REGRESS = 1
    SPOT_VALUATION = 1 << 2
    SPOT_ALL = SPOT_REGRESS | SPOT_VALUATION
    FACTORS_REGRESS = 1 << 3
    FACTORS_VALUATION = 1 << 4
    FACTORS_ALL = FACTORS_REGRESS | FACTORS_VALUATION
    INVENTORY = 1 << 5
    INJECT_WITHDRAW_VOLUME = 1 << 6
    CMDTY_CONSUMED = 1 << 7
    INVENTORY_LOSS = 1 << 8
    NET_VOLUME = 1 << 9
    PV = 1 << 10
    ALL = (
        SPOT_ALL
        | FACTORS_ALL
        | INVENTORY
        | INJECT_WITHDRAW_VOLUME
        | CMDTY_CONSUMED
        | INVENTORY_LOSS
        | NET_VOLUME
        | PV
    )

    @classmethod
    def coerce(cls, value) -> "SimulationDataReturned":
        """Accept a flag, a member-name string (``"all"``, ``"none"``,
        ``"spot_regress|pv"``), or None (-> ALL, the reference default)."""
        if value is None:
            return cls.ALL
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            result = cls.NONE
            for part in value.split("|"):
                name = part.strip().upper()
                if name not in cls.__members__:
                    raise ValueError(
                        f"Unknown SimulationDataReturned flag {part!r}; expected "
                        f"one of {sorted(cls.__members__)}."
                    )
                result |= cls[name]
            return result
        raise TypeError(
            "sim_data_returned must be a SimulationDataReturned flag or string, "
            f"got {type(value).__name__}."
        )


class DomesticCashFlow(tp.NamedTuple):
    """Dated cash amount (DomesticCashFlow.cs:30)."""

    date: object
    amount: float


class InventoryRange(tp.NamedTuple):
    """Feasible inventory band (InventoryRange.cs:30)."""

    min_inventory: float
    max_inventory: float


class StorageProfile(tp.NamedTuple):
    """Per-period expected storage state (StorageProfile.cs:28)."""

    inventory: float
    inject_withdraw_volume: float
    cmdty_consumed: float
    inventory_loss: float
    period_pv: float

    @property
    def net_volume(self) -> float:
        """Net volume to market = -volume - consumed (StorageProfile.cs:28)."""
        return -self.inject_withdraw_volume - self.cmdty_consumed


class TriggerPricePoint(tp.NamedTuple):
    volume: float
    price: float


class TriggerPrices(tp.NamedTuple):
    """Per-period trigger summary (TriggerPrices.cs:28).  Reference
    semantics: the inject price is at the max inject volume, the withdraw
    price at the volume one increment from the alternative
    (LsmcStorageValuation.cs:556,584)."""

    max_inject_volume: float
    max_inject_trigger_price: float
    max_withdraw_volume: float
    max_withdraw_trigger_price: float


class TriggerPriceProfile(tp.NamedTuple):
    inject_triggers: tp.List[TriggerPricePoint]
    withdraw_triggers: tp.List[TriggerPricePoint]


class MultiFactorValuationResults(tp.NamedTuple):
    npv: float
    val_sim_standard_error: float
    deltas: pd.Series
    expected_profile: pd.DataFrame
    intrinsic_npv: float
    intrinsic_profile: pd.DataFrame
    sim_spot_regress: pd.DataFrame
    sim_spot_valuation: pd.DataFrame
    sim_factors_regress: tp.Tuple[pd.DataFrame, ...]
    sim_factors_valuation: tp.Tuple[pd.DataFrame, ...]
    sim_inventory: pd.DataFrame
    sim_inject_withdraw: pd.DataFrame
    sim_cmdty_consumed: pd.DataFrame
    sim_inventory_loss: pd.DataFrame
    sim_net_volume: pd.DataFrame
    sim_pv: pd.DataFrame
    trigger_prices: pd.DataFrame
    trigger_profiles: pd.Series

    @property
    def extrinsic_npv(self) -> float:
        return self.npv - self.intrinsic_npv
