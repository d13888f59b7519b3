"""Multi-factor Ornstein-Uhlenbeck forward/spot price model.

Model (reference ``docs``/``multi_factor_diffusion_model.py``): forward
dynamics dF(t,T)/F(t,T) = Σ_i σ_i(T)·e^{-α_i(T-t)}·dW_i(t) with instantaneous
factor correlations ρ_ij.  The spot is the forward at delivery, so with
dimensionless Markov OU states x_i(t) = ∫_0^t e^{-α_i(t-u)} dz_i(u):

    ln S(T) = ln F(0,T) − ½·V(T) + Σ_i σ_i(T)·x_i(T),
    V(T)    = Σ_ij σ_i(T)σ_j(T)ρ_ij·E[x_i(T)x_j(T)]  (the integrated variance).

``MultiFactorModel`` reproduces the closed-form integrated covariance of the
reference (``multi_factor_diffusion_model.py:49-112``); the simulation step
quantities for the exact-step simulator are derived here on the host in
float64.
"""
from __future__ import annotations

import datetime as _dt
import math
import typing as tp

import numpy as np
import pandas as pd

from ..utils import periods as pu

CurveType = tp.Union[pd.Series, tp.Dict]
FactorType = tp.Tuple[float, CurveType]
FactorCorrsType = tp.Union[None, float, int, np.ndarray]

_DAYS_PER_YEAR_SEASONAL = 365.25
_SECONDS_PER_YEAR = 60 * 60 * 24 * _DAYS_PER_YEAR_SEASONAL


def validate_multi_factor_params(
    factors: tp.Collection[FactorType], factor_corrs: FactorCorrsType
) -> np.ndarray:
    """Validation mirroring ``_multi_factor_common.validate_multi_factor_params``
    (_multi_factor_common.py:38-83): scalar-corr sugar for 2 factors; corr
    matrix square, symmetric, unit diagonal, entries in [-1, 1]; non-negative
    mean reversions."""
    factors = list(factors)
    if len(factors) == 0:
        raise ValueError("factors cannot be empty.")
    if factor_corrs is None:
        if len(factors) == 1:
            factor_corrs = np.array([[1.0]])
        else:
            raise ValueError("factor_corrs must be specified for more than one factor.")
    if isinstance(factor_corrs, (int, float)):
        if len(factors) != 2:
            raise ValueError(
                "Factor correlation can only be specified as a scalar for exactly 2 factors."
            )
        factor_corrs = np.array([[1.0, float(factor_corrs)], [float(factor_corrs), 1.0]])
    factor_corrs = np.asarray(factor_corrs, dtype=np.float64)
    if factor_corrs.ndim != 2 or factor_corrs.shape[0] != factor_corrs.shape[1]:
        raise ValueError("factor_corrs must be a square matrix.")
    if factor_corrs.shape[0] != len(factors):
        raise ValueError("factor_corrs dimension must equal the number of factors.")
    if not np.allclose(factor_corrs, factor_corrs.T):
        raise ValueError("factor_corrs must be symmetric.")
    if not np.allclose(np.diag(factor_corrs), 1.0):
        raise ValueError("factor_corrs diagonal elements must all equal 1.")
    if np.any(factor_corrs < -1.0) or np.any(factor_corrs > 1.0):
        raise ValueError("factor_corrs elements must be in the interval [-1, 1].")
    for mean_reversion, _ in factors:
        if mean_reversion < 0.0:
            raise ValueError("Mean reversion must be non-negative.")
    return factor_corrs


def _vol_lookup(vol_curve: CurveType, contract, freq: str) -> float:
    # Convenience extension over the reference (utils.py:173 CurveType =
    # Series | dict): a bare number means a flat vol curve.
    if isinstance(vol_curve, (int, float, np.floating, np.integer)):
        return float(vol_curve)
    if isinstance(vol_curve, pd.Series):
        key = contract if isinstance(contract, pd.Period) else pd.Period(contract, freq=freq)
        if key in vol_curve.index:
            return float(vol_curve[key])
        raise ValueError(f"No point in vol curve for fwd contract {contract}.")
    # dict keyed by date-likes
    for k, v in vol_curve.items():
        k_period = k if isinstance(k, pd.Period) else pd.Period(k, freq=freq)
        c_period = contract if isinstance(contract, pd.Period) else pd.Period(contract, freq=freq)
        if k_period == c_period:
            return float(v)
    raise ValueError(f"No point in vol curve for fwd contract {contract}.")


def cont_ext(c1: float, c2: float, x: float) -> float:
    """(exp(-x*c2) - exp(-x*c1)) / x, continuously extended to x=0
    (``multi_factor_diffusion_model.py:108-112``)."""
    if x == 0.0:
        return c1 - c2
    return (math.exp(-x * c2) - math.exp(-x * c1)) / x


class MultiFactorModel:
    """Closed-form second moments of log-forwards under the multi-factor OU model
    (reference ``MultiFactorModel``, multi_factor_diffusion_model.py:34-134)."""

    _CORR_TOL = 1e-10

    def __init__(
        self,
        freq: str,
        factors: tp.Collection[FactorType],
        factor_corrs: FactorCorrsType = None,
        time_func: tp.Optional[tp.Callable] = None,
    ):
        self._factor_corrs = validate_multi_factor_params(factors, factor_corrs)
        self._factors = list(factors)
        self._freq = pu.normalise_freq(freq)
        self._time_func = time_func if time_func is not None else self._act365

    @staticmethod
    def _to_date(value) -> _dt.date:
        if isinstance(value, pd.Period):
            return pu.period_start_date(value)
        if isinstance(value, pd.Timestamp):
            return value.date()
        if isinstance(value, _dt.datetime):
            return value.date()
        if isinstance(value, _dt.date):
            return value
        return pd.Timestamp(value).date()

    def _act365(self, start, end) -> float:
        return pu.act365(self._to_date(start), self._to_date(end))

    def integrated_covar(self, obs_start, obs_end, fwd_contract_1, fwd_contract_2) -> float:
        obs_end_t = self._time_func(obs_start, obs_end)
        if obs_end_t < 0.0:
            raise ValueError("obs_end cannot be before obs_start.")
        fwd_1_t = self._time_func(obs_start, fwd_contract_1)
        fwd_2_t = self._time_func(obs_start, fwd_contract_2)
        cov = 0.0
        for i, (mr_i, vol_curve_i) in enumerate(self._factors):
            vol_i = _vol_lookup(vol_curve_i, fwd_contract_1, self._freq)
            for j, (mr_j, vol_curve_j) in enumerate(self._factors):
                vol_j = _vol_lookup(vol_curve_j, fwd_contract_2, self._freq)
                cov += (
                    vol_i
                    * vol_j
                    * self._factor_corrs[i, j]
                    * math.exp(-mr_i * fwd_1_t - mr_j * fwd_2_t)
                    * cont_ext(0.0, -obs_end_t, mr_i + mr_j)
                )
        return cov

    def integrated_variance(self, obs_start, obs_end, fwd_contract) -> float:
        return self.integrated_covar(obs_start, obs_end, fwd_contract, fwd_contract)

    def integrated_stan_dev(self, obs_start, obs_end, fwd_contract) -> float:
        return math.sqrt(self.integrated_variance(obs_start, obs_end, fwd_contract))

    def integrated_vol(self, val_date, expiry, fwd_contract) -> float:
        time_to_expiry = self._time_func(val_date, expiry)
        if time_to_expiry <= 0:
            raise ValueError("val_date must be before expiry.")
        return math.sqrt(self.integrated_variance(val_date, expiry, fwd_contract) / time_to_expiry)

    def integrated_corr(self, obs_start, obs_end, fwd_contract_1, fwd_contract_2) -> float:
        covariance = self.integrated_covar(obs_start, obs_end, fwd_contract_1, fwd_contract_2)
        var_1 = self.integrated_variance(obs_start, obs_end, fwd_contract_1)
        var_2 = self.integrated_variance(obs_start, obs_end, fwd_contract_2)
        corr = covariance / math.sqrt(var_1 * var_2)
        if 1.0 < corr < 1.0 + self._CORR_TOL:
            return 1.0
        if -1.0 - self._CORR_TOL < corr < -1.0:
            return -1.0
        return corr

    @staticmethod
    def for_3_factor_seasonal(
        freq: str,
        spot_mean_reversion: float,
        spot_vol: float,
        long_term_vol: float,
        seasonal_vol: float,
        start,
        end,
        time_func=None,
    ) -> "MultiFactorModel":
        factors, factor_corrs = create_3_factor_seasonal_params(
            freq, spot_mean_reversion, spot_vol, long_term_vol, seasonal_vol, start, end
        )
        return MultiFactorModel(freq, factors, factor_corrs, time_func)

    @staticmethod
    def for_1_factor(freq: str, mean_reversion: float, vol, time_func=None) -> "MultiFactorModel":
        """Single-factor parameterisation (MultiFactorParameters.For1Factor)."""
        import numpy as _np

        return MultiFactorModel(freq, [(mean_reversion, vol)], _np.ones((1, 1)), time_func)

    @staticmethod
    def for_2_factors(
        freq: str, factor_1, factor_2, factor_corr: float, time_func=None
    ) -> "MultiFactorModel":
        """Two-factor parameterisation (MultiFactorParameters.For2Factors);
        ``factor_N`` are (mean_reversion, vol_curve) pairs."""
        return MultiFactorModel(freq, [factor_1, factor_2], factor_corr, time_func)


def create_3_factor_seasonal_params(
    freq: str,
    spot_mean_reversion: float,
    spot_vol: float,
    long_term_vol: float,
    seasonal_vol: float,
    start,
    end,
) -> tp.Tuple[tp.List[FactorType], np.ndarray]:
    """3-factor seasonal parameterisation (``multi_factor_diffusion_model.py:141-172``):
    a mean-reverting spot factor, a non-reverting long-term factor, and a
    non-reverting seasonal factor whose vol is sinusoidal with period one year,
    peaking on Feb 1 of the start year with amplitude seasonal_vol/2."""
    pandas_freq = pu.normalise_freq(freq)
    factor_corrs = np.eye(3)
    start_period = start if isinstance(start, pd.Period) else pd.Period(start, freq=pandas_freq)
    end_period = end if isinstance(end, pd.Period) else pd.Period(end, freq=pandas_freq)
    index = pd.period_range(start=start_period, end=end_period, freq=pandas_freq)
    long_term_vol_curve = pd.Series(index=index, data=float(long_term_vol))
    spot_vol_curve = pd.Series(index=index.copy(), data=float(spot_vol))
    peak_period = pd.Period(
        _dt.date(start_period.year, 2, 1), freq=pandas_freq
    )
    phase = np.pi / 2.0
    amplitude = seasonal_vol / 2.0
    angles = np.empty(len(index))
    for i, p in enumerate(index):
        t_from_peak = (
            (p.start_time - peak_period.start_time).total_seconds() / _SECONDS_PER_YEAR
        )
        angles[i] = 2.0 * np.pi * t_from_peak + phase
    seasonal_vol_curve = pd.Series(index=index.copy(), data=np.sin(angles) * amplitude)
    factors: tp.List[FactorType] = [
        (spot_mean_reversion, spot_vol_curve),
        (0.0, long_term_vol_curve),
        (0.0, seasonal_vol_curve),
    ]
    return factors, factor_corrs


# --------------------------------------------------------- simulation precompute


class SimulationPrecompute(tp.NamedTuple):
    """Host-side float64 arrays feeding the exact-step OU simulator.

    For simulated periods T_0 < ... < T_{P-1} at year fractions ``times`` from
    the valuation date, with F factors:
      decay[k, i]    = exp(-α_i (t_k - t_{k-1}))                  (t_{-1} = 0)
      chol[k]        = cholesky(Σ_k),  Σ_k[i,j] = ρ_ij·cont_ext over (t_{k-1}, t_k]
      vols[k, i]     = σ_i(T_k)
      half_var[k]    = ½·V(T_k)
    """

    times: np.ndarray  # [P]
    decay: np.ndarray  # [P, F]
    chol: np.ndarray  # [P, F, F]
    vols: np.ndarray  # [P, F]
    half_var: np.ndarray  # [P]
    mean_reversions: np.ndarray  # [F]
    corrs: np.ndarray  # [F, F]


def _accumulated_cov(mr_sum: float, t0: float, t1: float) -> float:
    """∫_{t0}^{t1} e^{-mr_sum (t1-u)} du."""
    dt = t1 - t0
    if mr_sum == 0.0:
        return dt
    return (1.0 - math.exp(-mr_sum * dt)) / mr_sum


def simulation_precompute(
    factors: tp.Collection[FactorType],
    factor_corrs: FactorCorrsType,
    current_date,
    sim_periods: tp.Sequence,
    freq: str,
) -> SimulationPrecompute:
    corrs = validate_multi_factor_params(factors, factor_corrs)
    factors = list(factors)
    f = len(factors)
    pandas_freq = pu.normalise_freq(freq)
    periods = [
        p if isinstance(p, pd.Period) else pd.Period(p, freq=pandas_freq) for p in sim_periods
    ]
    base_date = MultiFactorModel._to_date(current_date)
    times = np.array(
        [pu.act365(base_date, pu.period_start_date(p)) for p in periods], dtype=np.float64
    )
    if np.any(np.diff(times) < 0):
        raise ValueError("sim_periods must be non-decreasing in time.")
    if np.any(times < 0):
        raise ValueError("sim_periods cannot be before current_date.")

    mrs = np.array([mr for mr, _ in factors], dtype=np.float64)
    p_count = len(periods)
    decay = np.empty((p_count, f))
    chol = np.empty((p_count, f, f))
    vols = np.empty((p_count, f))
    half_var = np.empty(p_count)

    prev_t = 0.0
    for k, (t_k, period) in enumerate(zip(times, periods)):
        dt = t_k - prev_t
        decay[k] = np.exp(-mrs * dt)
        cov = np.empty((f, f))
        for i in range(f):
            for j in range(f):
                cov[i, j] = corrs[i, j] * _accumulated_cov(mrs[i] + mrs[j], prev_t, t_k)
        # Guard the Cholesky for zero-dt steps / degenerate correlation.
        try:
            chol[k] = np.linalg.cholesky(cov + 1e-18 * np.eye(f))
        except np.linalg.LinAlgError:
            # PSD projection fallback for rank-deficient correlation matrices.
            w, v = np.linalg.eigh(cov)
            chol[k] = v @ np.diag(np.sqrt(np.maximum(w, 0.0)))
        for i, (_, vol_curve) in enumerate(factors):
            vols[k, i] = _vol_lookup(vol_curve, period, pandas_freq)
        # E[x_i x_j](t_k) accumulated from 0.
        exixj = np.empty((f, f))
        for i in range(f):
            for j in range(f):
                exixj[i, j] = corrs[i, j] * _accumulated_cov(mrs[i] + mrs[j], 0.0, t_k)
        half_var[k] = 0.5 * float(vols[k] @ exixj @ vols[k])
        prev_t = t_k
    return SimulationPrecompute(times, decay, chol, vols, half_var, mrs, corrs)
