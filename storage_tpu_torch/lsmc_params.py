"""Parameter-object API for LSMC valuations (counterpart of
``storage_tpu.lsmc_params``).

The analog of the reference's ``LsmcValuationParameters<T>`` + staged ``Builder``
(``LsmcValuation/LsmcValuationParameters.cs:38-257``): an immutable parameter
object collecting everything ``LsmcStorageValuation.Calculate`` needs, with a
builder that wires either the multi-factor Monte Carlo simulator
(``Builder.SimulateWithMultiFactorModelAndMersenneTwister``, :185-196 — here a
threefry counter RNG) or user-supplied simulation panels
(``Builder.UseSpotSimResults``, :198-216), plus cooperative cancellation and
progress callbacks and a checkpoint of the regression.

The function API (``three_factor_seasonal_value`` etc.) remains the primary
entry point; this object form suits job queues, checkpointing and programmatic
construction::

    params = (LsmcValuationParameters.builder()
        .with_storage(storage).with_val_date(date).with_inventory(500.0)
        .with_forward_curve(fwd).with_interest_rates(0.03)
        .with_settlement_rule(rule).with_basis_funcs("1 + s + s**2 + x0")
        .simulate_with_multi_factor_model(factors, corrs, num_sims=8192, seed=11)
        .with_device("cuda")
        .build())
    results = lsmc_value(params)
"""
from __future__ import annotations

import dataclasses
import typing as tp

import pandas as pd
import torch

from . import api_lsmc
from .api import Device
from .facility import CmdtyStorage
from .results import MultiFactorValuationResults, SimulationDataReturned


@dataclasses.dataclass(frozen=True)
class MultiFactorSimSpec:
    """Simulate with the multi-factor OU model (LsmcValuationParameters.cs:185-196)."""

    factors: tp.Any
    factor_corrs: tp.Any
    num_sims: int
    seed: tp.Optional[int] = None
    fwd_sim_seed: tp.Optional[int] = None
    antithetic: bool = False


@dataclasses.dataclass(frozen=True)
class PanelSimSpec:
    """Use caller-supplied simulation panels (LsmcValuationParameters.cs:198-216)."""

    sim_spot_regress: pd.DataFrame
    sim_spot_valuation: pd.DataFrame
    sim_factors_regress: tp.Optional[tp.Sequence[pd.DataFrame]] = None
    sim_factors_valuation: tp.Optional[tp.Sequence[pd.DataFrame]] = None


@dataclasses.dataclass(frozen=True)
class LsmcValuationParameters:
    storage: CmdtyStorage
    val_date: tp.Any
    inventory: float
    forward_curve: pd.Series
    interest_rates: tp.Union[float, pd.Series]
    settlement_rule: tp.Optional[tp.Callable]
    basis_funcs: tp.Any
    sim_spec: tp.Union[MultiFactorSimSpec, PanelSimSpec]
    discount_deltas: bool = False
    extra_decisions: int = 0
    num_inventory_grid_points: int = 100
    numerical_tolerance: float = 1e-12
    on_progress_update: tp.Optional[tp.Callable[[float], None]] = None
    cancellation_poll: tp.Optional[tp.Callable[[], bool]] = None
    sim_data_returned: SimulationDataReturned = SimulationDataReturned.NONE
    # (the C# builder default is the zero flag = None, LsmcValuationParameters.cs:102)
    dtype: tp.Any = torch.float32
    deltas_method: str = "pathwise"
    checkpoint_path: tp.Optional[str] = None
    # The reference's open grid extension point (LsmcValuationParameters
    # carries an IDoubleStateSpaceGridCalc): a callable (lower, upper) ->
    # grid points applied per period; overrides num_inventory_grid_points.
    grid_calc: tp.Optional[tp.Callable] = None
    # Where the valuation runs, as every entry point of the port takes it.
    device: Device = "cuda"

    @staticmethod
    def builder() -> "LsmcValuationParametersBuilder":
        return LsmcValuationParametersBuilder()


class LsmcValuationParametersBuilder:
    """Mutable builder with required-field validation on ``build()``
    (LsmcValuationParameters.Builder.Build, LsmcValuationParameters.cs:124-144)."""

    _REQUIRED = (
        "storage", "val_date", "inventory", "forward_curve", "interest_rates",
        "basis_funcs", "sim_spec",
    )

    def __init__(self):
        self._fields: tp.Dict[str, tp.Any] = {"settlement_rule": None}

    def _set(self, key, value) -> "LsmcValuationParametersBuilder":
        self._fields[key] = value
        return self

    def with_storage(self, storage: CmdtyStorage):
        return self._set("storage", storage)

    def with_val_date(self, val_date):
        return self._set("val_date", val_date)

    def with_inventory(self, inventory: float):
        return self._set("inventory", float(inventory))

    def with_forward_curve(self, forward_curve: pd.Series):
        return self._set("forward_curve", forward_curve)

    def with_interest_rates(self, interest_rates):
        return self._set("interest_rates", interest_rates)

    def with_settlement_rule(self, settlement_rule):
        return self._set("settlement_rule", settlement_rule)

    def with_basis_funcs(self, basis_funcs):
        return self._set("basis_funcs", basis_funcs)

    def with_discount_deltas(self, discount_deltas: bool):
        return self._set("discount_deltas", bool(discount_deltas))

    def with_extra_decisions(self, extra_decisions: int):
        return self._set("extra_decisions", int(extra_decisions))

    def with_grid_points(self, num_inventory_grid_points: int):
        return self._set("num_inventory_grid_points", int(num_inventory_grid_points))

    def with_numerical_tolerance(self, tolerance: float):
        return self._set("numerical_tolerance", float(tolerance))

    def with_progress_callback(self, on_progress_update):
        return self._set("on_progress_update", on_progress_update)

    def with_cancellation_poll(self, poll: tp.Callable[[], bool]):
        """Polled at phase and segment boundaries; return True to cancel."""
        return self._set("cancellation_poll", poll)

    def with_sim_data_returned(self, flags):
        return self._set("sim_data_returned", SimulationDataReturned.coerce(flags))

    def with_dtype(self, dtype):
        return self._set("dtype", dtype)

    def with_device(self, device: Device):
        """Where the valuation runs: ``"cuda"`` (the default) or ``"cpu"``."""
        return self._set("device", device)

    def with_deltas_method(self, deltas_method: str):
        """'pathwise' (reference formula) or 'adjoint' (reverse mode through
        the valuation's forward sweep in the forward curve)."""
        if deltas_method not in ("pathwise", "adjoint"):
            raise ValueError(
                f"deltas_method must be 'pathwise' or 'adjoint', got {deltas_method!r}."
            )
        return self._set("deltas_method", deltas_method)

    def with_grid_calc(self, grid_calc: tp.Callable):
        """Per-period grid callable — the ``IDoubleStateSpaceGridCalc``
        analog (IDoubleStateSpaceGridCalc.cs:32)."""
        return self._set("grid_calc", grid_calc)

    def with_checkpoint_path(self, path: str):
        """Persist the backward pass's regression payload to ``path`` after the
        valuation (``checkpoint.RegressionCheckpoint``)."""
        return self._set("checkpoint_path", str(path))

    def simulate_with_multi_factor_model(
        self, factors, factor_corrs, num_sims: int,
        seed: tp.Optional[int] = None, fwd_sim_seed: tp.Optional[int] = None,
        antithetic: bool = False,
    ):
        return self._set(
            "sim_spec",
            MultiFactorSimSpec(factors, factor_corrs, int(num_sims), seed,
                               fwd_sim_seed, antithetic),
        )

    def use_spot_sim_results(
        self, sim_spot_regress: pd.DataFrame, sim_spot_valuation: pd.DataFrame,
        sim_factors_regress=None, sim_factors_valuation=None,
    ):
        return self._set(
            "sim_spec",
            PanelSimSpec(sim_spot_regress, sim_spot_valuation,
                         sim_factors_regress, sim_factors_valuation),
        )

    def build(self) -> LsmcValuationParameters:
        missing = [k for k in self._REQUIRED if k not in self._fields]
        if missing:
            raise ValueError(
                f"LsmcValuationParameters is missing required fields: {missing}. "
                "Call the matching with_*/simulate_with_*/use_spot_sim_results methods."
            )
        return LsmcValuationParameters(**self._fields)


def lsmc_value(params: LsmcValuationParameters) -> MultiFactorValuationResults:
    """Run the LSMC valuation described by ``params``
    (LsmcStorageValuation.Calculate, LsmcStorageValuation.cs:57)."""
    common = dict(
        cmdty_storage=params.storage,
        val_date=params.val_date,
        inventory=params.inventory,
        fwd_curve=params.forward_curve,
        interest_rates=params.interest_rates,
        settlement_rule=params.settlement_rule,
        basis_funcs=params.basis_funcs,
        discount_deltas=params.discount_deltas,
        extra_decisions=params.extra_decisions,
        num_inventory_grid_points=params.num_inventory_grid_points,
        numerical_tolerance=params.numerical_tolerance,
        on_progress_update=params.on_progress_update,
        sim_data_returned=params.sim_data_returned,
        dtype=params.dtype,
        cancellation_poll=params.cancellation_poll,
        deltas_method=params.deltas_method,
        checkpoint_path=params.checkpoint_path,
        grid_calc=params.grid_calc,
        device=params.device,
    )
    spec = params.sim_spec
    if isinstance(spec, MultiFactorSimSpec):
        return api_lsmc.multi_factor_value(
            factors=spec.factors, factor_corrs=spec.factor_corrs,
            num_sims=spec.num_sims, seed=spec.seed, fwd_sim_seed=spec.fwd_sim_seed,
            antithetic=spec.antithetic, **common,
        )
    if isinstance(spec, PanelSimSpec):
        return api_lsmc.value_from_sims(
            sim_spot_regress=spec.sim_spot_regress,
            sim_spot_valuation=spec.sim_spot_valuation,
            sim_factors_regress=spec.sim_factors_regress,
            sim_factors_valuation=spec.sim_factors_valuation,
            **common,
        )
    raise TypeError(f"Unknown sim spec type {type(spec).__name__}.")
