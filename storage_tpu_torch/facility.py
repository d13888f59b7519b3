"""Storage facility model.

``CmdtyStorage`` mirrors the reference Python API surface
(``cmdty_storage.py:58-277``) — same constructor arguments, same validation
rules, same query methods — but is built natively on pandas + numpy instead of
wrapping a C# fluent builder.  Instead of the reference's delegate-per-property
design (``CmdtyStorage.cs:41-50``), the facility is *compiled* once per
valuation into dense per-step float64 arrays (``CompiledStorage``) so that the
whole valuation is a jit-compatible program over static-shaped arrays.
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
import enum
import typing as tp

import numpy as np
import pandas as pd

from . import constraints as con
from .utils import periods as pu


class RatchetInterp(enum.Enum):
    LINEAR = 1
    STEP = 2
    POLYNOMIAL = 3


class InjectWithdrawRange(tp.NamedTuple):
    min_inject_withdraw_rate: float
    max_inject_withdraw_rate: float


RatchetsType = tp.Optional[
    tp.Iterable[tp.Tuple[pu.PeriodSpec, tp.Iterable[tp.Tuple[float, float, float]]]]
]


# Re-exported from constraints so the constraint inverse solvers can raise the
# same typed exception the band reduction does (StorageHelper.cs:101-102 throws
# it from both levels) without a circular import.
InventoryConstraintsCannotBeFulfilledException = (
    con.InventoryConstraintsCannotBeFulfilledException
)


def _raise_if_not_none(arg, message):
    if arg is not None:
        raise ValueError(message)


def _raise_if_none(arg, message):
    if arg is None:
        raise ValueError(message)


class CmdtyStorage:
    """Commodity storage facility description.

    Parameters mirror the reference Python wrapper (``cmdty_storage.py:60-76``):
    either ``ratchets`` + ``ratchet_interp`` (inventory-varying rates) or the
    explicit ``min_inventory``/``max_inventory``/``max_injection_rate``/
    ``max_withdrawal_rate`` quartet.  Costs and percentages may be scalars or
    pandas Series covering the active window.  ``terminal_storage_npv`` is a
    callable ``(cmdty_price, final_inventory) -> npv``; if None the storage
    must be empty at end.
    """

    def __init__(
        self,
        freq: str,
        storage_start: pu.PeriodSpec,
        storage_end: pu.PeriodSpec,
        injection_cost: tp.Union[float, pd.Series],
        withdrawal_cost: tp.Union[float, pd.Series],
        ratchets: RatchetsType = None,
        ratchet_interp: tp.Optional[RatchetInterp] = None,
        min_inventory: tp.Union[None, float, int, pd.Series] = None,
        max_inventory: tp.Union[None, float, int, pd.Series] = None,
        max_injection_rate: tp.Union[None, float, int, pd.Series] = None,
        max_withdrawal_rate: tp.Union[None, float, int, pd.Series] = None,
        cmdty_consumed_inject: tp.Union[None, float, int, pd.Series] = None,
        cmdty_consumed_withdraw: tp.Union[None, float, int, pd.Series] = None,
        terminal_storage_npv: tp.Optional[tp.Callable[[float, float], float]] = None,
        inventory_loss: tp.Union[None, float, int, pd.Series] = None,
        inventory_cost: tp.Union[None, float, int, pd.Series] = None,
        cost_settlement_rule: tp.Optional[tp.Callable[[pd.Period], _dt.date]] = None,
    ):
        self._freq = freq
        pandas_freq = pu.normalise_freq(freq)
        self._pandas_freq = pandas_freq
        start = pu.to_period(storage_start, pandas_freq)
        end = pu.to_period(storage_end, pandas_freq)
        if start >= end:
            raise ValueError("Storage start period must be before end period.")
        self._start = start
        self._end = end
        # Periods on which the facility can act (decision periods): start..end-1,
        # plus the end period itself for inventory limits / terminal value.
        self._all_periods = pu.period_index(start, end)
        self._active_periods = self._all_periods[:-1]

        if ratchets is not None:
            _raise_if_not_none(
                min_inventory,
                "min_inventory parameter should not be provided if ratchets parameter is provided.",
            )
            _raise_if_not_none(
                max_inventory,
                "max_inventory parameter should not be provided if ratchets parameter is provided.",
            )
            _raise_if_not_none(
                max_injection_rate,
                "max_injection_rate parameter should not be provided if ratchets parameter is provided.",
            )
            _raise_if_not_none(
                max_withdrawal_rate,
                "max_withdrawal_rate parameter should not be provided if ratchets parameter is provided.",
            )
            _raise_if_none(
                ratchet_interp,
                "ratchet_interp parameter should be provided if ratchets parameter is provided.",
            )
            ratchets = list(ratchets)  # may be a generator; iterated twice below
            any_step = ratchet_interp == RatchetInterp.STEP or any(
                len(entry) == 3 and entry[2] == RatchetInterp.STEP
                for entry in ratchets
            )
            if any_step and terminal_storage_npv is None:
                raise ValueError(
                    "When ratchet_interp is RatchetInterp.STEP terminal_storage_npv should be specified"
                )
            self._init_from_ratchets(ratchets, ratchet_interp)
        else:
            _raise_if_not_none(
                ratchet_interp,
                "ratchet_interp should not be provided if ratchets parameter is not provided.",
            )
            _raise_if_none(
                min_inventory,
                "min_inventory parameter should be provided if ratchets parameter is not provided.",
            )
            _raise_if_none(
                max_inventory,
                "max_inventory parameter should be provided if ratchets parameter is not provided.",
            )
            _raise_if_none(
                max_injection_rate,
                "max_injection_rate parameter should be provided if ratchets parameter is not provided.",
            )
            _raise_if_none(
                max_withdrawal_rate,
                "max_withdrawal_rate parameter should be provided if ratchets parameter is not provided.",
            )
            self._init_from_simple_constraints(
                min_inventory, max_inventory, max_injection_rate, max_withdrawal_rate
            )

        active = self._active_periods
        self._injection_cost = pu.series_on_index(injection_cost, active, "injection_cost")
        self._withdrawal_cost = pu.series_on_index(withdrawal_cost, active, "withdrawal_cost")
        self._cmdty_consumed_inject = pu.series_on_index(
            cmdty_consumed_inject, active, "cmdty_consumed_inject", allow_none=True
        )
        self._cmdty_consumed_withdraw = pu.series_on_index(
            cmdty_consumed_withdraw, active, "cmdty_consumed_withdraw", allow_none=True
        )
        self._inventory_loss = pu.series_on_index(
            inventory_loss, active, "inventory_loss", allow_none=True
        )
        self._inventory_cost = pu.series_on_index(
            inventory_cost, active, "inventory_cost", allow_none=True
        )
        self._terminal_storage_npv = terminal_storage_npv
        self._must_be_empty_at_end = terminal_storage_npv is None
        # Date on which inject/withdraw cost cash flows settle; default is the
        # period's first day (the reference's standard builders,
        # CmdtyStorage.cs:334-341), but custom cash-flow dates are supported
        # (the generalisation of WithInjectionCost/WithWithdrawalCost
        # delegates, CmdtyStorage.cs:371-416).
        self._cost_settlement_rule = cost_settlement_rule

    # ------------------------------------------------------------------ build

    def _init_from_simple_constraints(
        self, min_inventory, max_inventory, max_injection_rate, max_withdrawal_rate
    ):
        all_p = self._all_periods
        active = self._active_periods
        self._min_inv = pu.series_on_index(min_inventory, all_p, "min_inventory")
        self._max_inv = pu.series_on_index(max_inventory, all_p, "max_inventory")
        inj = pu.series_on_index(max_injection_rate, active, "max_injection_rate")
        wdr = pu.series_on_index(max_withdrawal_rate, active, "max_withdrawal_rate")
        if np.any(inj < 0):
            raise ValueError("max_injection_rate must be non-negative.")
        if np.any(wdr < 0):
            raise ValueError("max_withdrawal_rate must be non-negative.")
        self._constraints: tp.List[con.BaseConstraint] = [
            con.ConstantInjectWithdrawConstraint(-w, i) for w, i in zip(wdr, inj)
        ]

    def _init_from_ratchets(self, ratchets, ratchet_interp: RatchetInterp):
        # Build per-period constraint objects by forward-filling the supplied
        # ratchet periods (CmdtyStorageBuilderExtensions.cs:145-215): the
        # constraint at a period is that of the latest ratchet period <= it.
        # A ratchet entry may be (period, nodes) — using the facility-level
        # ``ratchet_interp`` — or (period, nodes, interp) overriding it per
        # period (the reference permits per-period constraint objects of any
        # type, CmdtyStorage.cs:41-50; mixed step/continuous facilities are
        # lowered to a single linear table mode in compile_storage).
        parsed: tp.List[tp.Tuple[pd.Period, tp.List[tp.Tuple[float, float, float]], RatchetInterp]] = []
        for entry in ratchets:
            if len(entry) == 3:
                period_spec, nodes, interp = entry
            else:
                period_spec, nodes = entry
                interp = ratchet_interp
            period = pu.to_period(period_spec, self._pandas_freq)
            node_list = [(float(i), float(mn), float(mx)) for (i, mn, mx) in nodes]
            if len(node_list) < 2:
                raise ValueError(
                    f"Period {period} contains less than 2 inject/withdraw/inventory constraints."
                )
            parsed.append((period, node_list, interp))
        if not parsed:
            raise ValueError("No inject/withdraw constraints provided.")
        parsed.sort(key=lambda item: item[0])
        seen = set()
        for period, _, _ in parsed:
            if period in seen:
                raise ValueError("Repeated periods found in inject/withdraw ranges.")
            seen.add(period)

        def build_constraint(node_list, interp) -> con.BaseConstraint:
            # Two rows with identical rates represent a constant constraint
            # (CmdtyStorageBuilderExtensions.cs:163-172).
            if (
                len(node_list) == 2
                and node_list[0][1] == node_list[1][1]
                and node_list[0][2] == node_list[1][2]
            ):
                return con.ConstantInjectWithdrawConstraint(node_list[0][1], node_list[0][2])
            if interp == RatchetInterp.LINEAR:
                return con.PiecewiseLinearInjectWithdrawConstraint(node_list)
            if interp == RatchetInterp.STEP:
                return con.StepInjectWithdrawConstraint(node_list)
            return con.PolynomialInjectWithdrawConstraint(node_list)

        built = [
            (period, build_constraint(nodes, interp), min(n[0] for n in nodes), max(n[0] for n in nodes))
            for period, nodes, interp in parsed
        ]
        self._constraints = []
        min_inv = np.empty(len(self._all_periods))
        max_inv = np.empty(len(self._all_periods))
        idx = -1
        for k, period in enumerate(self._all_periods):
            while idx + 1 < len(built) and built[idx + 1][0] <= period:
                idx += 1
            use = built[max(idx, 0)]
            if k < len(self._active_periods):
                self._constraints.append(use[1])
            min_inv[k] = use[2]
            max_inv[k] = use[3]
        self._min_inv = min_inv
        self._max_inv = max_inv

    # ---------------------------------------------------------------- queries

    @property
    def freq(self) -> str:
        return self._freq

    @property
    def start(self) -> pd.Period:
        return self._start

    @property
    def end(self) -> pd.Period:
        return self._end

    @property
    def empty_at_end(self) -> bool:
        return self._must_be_empty_at_end

    def _period_idx(self, period: pu.PeriodSpec, clamp_to_active: bool = False) -> int:
        p = pu.to_period(period, self._pandas_freq)
        offset = pu.period_offset(p, self._start)
        if offset < 0 or offset >= len(self._all_periods):
            raise ValueError(f"Period {p} outside storage active window.")
        if clamp_to_active and offset >= len(self._active_periods):
            raise ValueError(f"Period {p} is not an active decision period.")
        return offset

    def min_inventory(self, period: pu.PeriodSpec) -> float:
        return float(self._min_inv[self._period_idx(period)])

    def max_inventory(self, period: pu.PeriodSpec) -> float:
        i = self._period_idx(period)
        if self._must_be_empty_at_end and i == len(self._all_periods) - 1:
            # MustBeEmptyAtEnd forces max inventory 0 at the end period
            # (CmdtyStorage.cs:434-441).
            return 0.0
        return float(self._max_inv[i])

    def inject_withdraw_range(self, period: pu.PeriodSpec, inventory: float) -> InjectWithdrawRange:
        i = self._period_idx(period)
        min_inv = self.min_inventory(period)
        max_inv = self.max_inventory(period)
        if inventory < min_inv:
            raise ValueError(
                f"Inventory of {inventory} is below minimum allowed value of {min_inv} during period {period}."
            )
        if inventory > max_inv:
            raise ValueError(
                f"Inventory of {inventory} above maximum allowed value of {max_inv} during period {period}."
            )
        if i >= len(self._active_periods):
            # No actions on/after the end period (CmdtyStorage.cs:96-97).
            return InjectWithdrawRange(0.0, 0.0)
        rng = self._constraints[i].get_inject_withdraw_range(inventory)
        return InjectWithdrawRange(rng.min_inject_withdraw_rate, rng.max_inject_withdraw_rate)

    def injection_cost(self, period: pu.PeriodSpec, inventory: float, injected_volume: float) -> float:
        return float(self._injection_cost[self._period_idx(period, True)] * injected_volume)

    def withdrawal_cost(self, period: pu.PeriodSpec, inventory: float, withdrawn_volume: float) -> float:
        return float(self._withdrawal_cost[self._period_idx(period, True)] * abs(withdrawn_volume))

    def cmdty_consumed_inject(self, period: pu.PeriodSpec, inventory: float, injected_volume: float) -> float:
        return float(self._cmdty_consumed_inject[self._period_idx(period, True)] * abs(injected_volume))

    def cmdty_consumed_withdraw(self, period: pu.PeriodSpec, inventory: float, withdrawn_volume: float) -> float:
        return float(self._cmdty_consumed_withdraw[self._period_idx(period, True)] * abs(withdrawn_volume))

    def inventory_pcnt_loss(self, period: pu.PeriodSpec) -> float:
        return float(self._inventory_loss[self._period_idx(period, True)])

    def inventory_cost(self, period: pu.PeriodSpec, inventory: float) -> float:
        return float(self._inventory_cost[self._period_idx(period, True)] * inventory)

    def terminal_storage_npv(self, cmdty_price: float, terminal_inventory: float) -> float:
        if self._terminal_storage_npv is None:
            return 0.0
        return float(self._terminal_storage_npv(cmdty_price, terminal_inventory))

    # ------------------------------------------------------- internal access

    @property
    def active_periods(self) -> pd.PeriodIndex:
        """Periods on which inject/withdraw decisions can be made (start..end-1)."""
        return self._active_periods

    @property
    def all_periods(self) -> pd.PeriodIndex:
        """All facility periods including the end period."""
        return self._all_periods

    def constraint_at(self, step: int) -> con.BaseConstraint:
        return self._constraints[step]

    def terminal_npv_fn(self) -> tp.Optional[tp.Callable[[float, float], float]]:
        return self._terminal_storage_npv

    @property
    def cost_settlement_rule(self):
        return self._cost_settlement_rule


# ------------------------------------------------------------------ compile


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: identity hash, usable as a jit static arg
class CompiledStorage:
    """Facility lowered to dense per-step arrays for a specific valuation window.

    All arrays are host numpy float64; engines cast once to the compute dtype.
    Step ``t`` maps to active period ``periods[t]`` for t in [0, num_steps);
    ``periods[num_steps]`` is the storage end period.  Replaces the reference's
    per-period delegate lookups (``CmdtyStorage.cs:86-169``) with table data.
    """

    periods: pd.PeriodIndex  # length num_steps + 1
    num_steps: int
    min_inv: np.ndarray  # [num_steps + 1]
    max_inv: np.ndarray  # [num_steps + 1]
    ratchet_inv: np.ndarray  # [num_steps, R]
    ratchet_min: np.ndarray  # [num_steps, R]
    ratchet_max: np.ndarray  # [num_steps, R]
    ratchet_is_step: bool
    inj_cost: np.ndarray  # [num_steps] per-unit injection cost
    wdr_cost: np.ndarray  # [num_steps] per-unit withdrawal cost
    inj_consumed_pcnt: np.ndarray  # [num_steps]
    wdr_consumed_pcnt: np.ndarray  # [num_steps]
    loss_pcnt: np.ndarray  # [num_steps]
    inv_cost_rate: np.ndarray  # [num_steps] per-unit inventory cost
    must_be_empty_at_end: bool
    terminal_npv: tp.Optional[tp.Callable[[tp.Any, tp.Any], tp.Any]]

    def terminal_value(self, price, inventory):
        if self.terminal_npv is None:
            return np.zeros(np.broadcast_shapes(np.shape(price), np.shape(inventory)))
        return self.terminal_npv(price, inventory)


def compile_storage(storage: CmdtyStorage, val_period: pd.Period) -> CompiledStorage:
    """Lower a facility to arrays over max(val_period, start) .. end.

    Mirrors the active-window determination of
    ``StorageHelper.CalculateInventorySpace`` (StorageHelper.cs:45-47).
    """
    start_active = max(storage.start, val_period)
    if val_period > storage.end:
        raise ValueError("Storage has expired.")
    periods = pu.period_index(start_active, storage.end)
    num_steps = len(periods) - 1
    first_step = pu.period_offset(start_active, storage.start)

    min_inv = np.array(
        [storage.min_inventory(p) for p in periods], dtype=np.float64
    )
    max_inv = np.array(
        [storage.max_inventory(p) for p in periods], dtype=np.float64
    )

    tables = [
        storage.constraint_at(first_step + t).table(min_inv[t], max_inv[t])
        for t in range(num_steps)
    ]
    is_step_flags = {tab[3] for tab in tables}
    if len(is_step_flags) > 1:
        # Mixed step + continuous interpolation across periods (the reference
        # permits per-period constraint objects of any type,
        # CmdtyStorage.cs:41-50): the device tables carry ONE global
        # interpolation mode, so STEP constraints are re-lowered as staircase
        # linear-node tables (exact off 2^-22-wide jump windows — see
        # StepInjectWithdrawConstraint.table) and the whole facility runs in
        # linear mode.  All-step facilities keep the exact step lookup.
        tables = [
            storage.constraint_at(first_step + t).table(
                min_inv[t], max_inv[t], step_interp_as_linear_nodes=True
            )
            for t in range(num_steps)
        ]
    ratchet_is_step = tables[0][3] if tables else False
    width = max(len(tab[0]) for tab in tables) if tables else 2
    ratchet_inv = np.zeros((num_steps, width))
    ratchet_min = np.zeros((num_steps, width))
    ratchet_max = np.zeros((num_steps, width))
    for t, (inv, mn, mx, _) in enumerate(tables):
        n = len(inv)
        ratchet_inv[t, :n] = inv
        ratchet_min[t, :n] = mn
        ratchet_max[t, :n] = mx
        if n < width:
            # Pad by repeating the last node: searchsorted-based lookup then
            # never selects a padded segment with distinct values.
            ratchet_inv[t, n:] = inv[-1] + np.arange(1, width - n + 1)
            ratchet_min[t, n:] = mn[-1]
            ratchet_max[t, n:] = mx[-1]

    sl = slice(first_step, first_step + num_steps)
    return CompiledStorage(
        periods=periods,
        num_steps=num_steps,
        min_inv=min_inv,
        max_inv=max_inv,
        ratchet_inv=ratchet_inv,
        ratchet_min=ratchet_min,
        ratchet_max=ratchet_max,
        ratchet_is_step=ratchet_is_step,
        inj_cost=storage._injection_cost[sl].copy(),
        wdr_cost=storage._withdrawal_cost[sl].copy(),
        inj_consumed_pcnt=storage._cmdty_consumed_inject[sl].copy(),
        wdr_consumed_pcnt=storage._cmdty_consumed_withdraw[sl].copy(),
        loss_pcnt=storage._inventory_loss[sl].copy(),
        inv_cost_rate=storage._inventory_cost[sl].copy(),
        must_be_empty_at_end=storage.empty_at_end,
        terminal_npv=storage.terminal_npv_fn(),
    )
