"""Forward-curve utilities (the port's copy of ``storage_tpu.curves``, numpy
and pandas only).

Analog of the reference's curve helpers (``CurvesXl.InterpolateCurveToDaily``,
Cmdty.Storage.Excel/CurvesXl.cs:41-80): turn sparse forward market quotes
(e.g. monthly contracts) into the daily-granularity curve the valuation
engines consume, either piecewise flat or with a smooth average-preserving
interpolation.

The smooth variant is the discrete max-smoothness problem: daily values
minimise the sum of squared second differences subject to each contract's
average being preserved — the discretisation of the spline used by the
reference's MaxSmoothnessSplineCurveBuilder.  Optional multiplicative
day-of-week shaping factors mirror ``WithMultiplySeasonalAdjustment``.
"""
from __future__ import annotations

import typing as tp

import numpy as np
import pandas as pd

from .utils import periods as pu

ContractsType = tp.Union[
    pd.Series,  # indexed by period-like contract start
    tp.Iterable[tp.Tuple[pu.PeriodSpec, float]],
]


def _parse_contracts(
    contracts: ContractsType, end: pu.PeriodSpec
) -> tp.Tuple[tp.List[pd.Period], tp.List[float], pd.Period]:
    if isinstance(contracts, pd.Series):
        items = list(contracts.items())
    else:
        items = list(contracts)
    if not items:
        raise ValueError("contracts cannot be empty.")
    starts = [pu.to_period(k, "D") for k, _ in items]
    prices = [float(v) for _, v in items]
    if sorted(starts) != starts:
        order = np.argsort([s.ordinal for s in starts])
        starts = [starts[i] for i in order]
        prices = [prices[i] for i in order]
    end_day = pu.to_period(end, "D")
    if end_day <= starts[-1]:
        raise ValueError("end must be after the last contract start.")
    return starts, prices, end_day


def piecewise_flat_to_daily(
    contracts: ContractsType, end: pu.PeriodSpec
) -> pd.Series:
    """Each contract's price held flat until the next contract starts; the
    final contract runs to ``end`` inclusive."""
    starts, prices, end_day = _parse_contracts(contracts, end)
    index = pd.period_range(starts[0], end_day, freq="D")
    boundaries = starts[1:] + [end_day + 1]
    values = np.empty(len(index))
    i = 0
    for start, stop, price in zip(starts, boundaries, prices):
        n = pu.period_offset(stop, start)
        values[i : i + n] = price
        i += n
    return pd.Series(index=index, data=values)


def spline_to_daily(
    contracts: ContractsType,
    end: pu.PeriodSpec,
    shaping_factors: tp.Optional[tp.Dict[int, float]] = None,
) -> pd.Series:
    """Smooth daily curve preserving each contract's average price.

    Minimises Σ (f[d+1] - 2 f[d] + f[d-1])² subject to
    mean(f over contract c) = price_c, solved exactly via the KKT system.
    ``shaping_factors`` maps weekday (Monday=0) to a multiplicative factor
    applied after interpolation, renormalised per contract so averages are
    still preserved.
    """
    starts, prices, end_day = _parse_contracts(contracts, end)
    index = pd.period_range(starts[0], end_day, freq="D")
    n = len(index)
    c = len(starts)
    boundaries = starts[1:] + [end_day + 1]

    # Second-difference operator D: (n-2) x n.
    d_op = np.zeros((max(n - 2, 0), n))
    for i in range(n - 2):
        d_op[i, i] = 1.0
        d_op[i, i + 1] = -2.0
        d_op[i, i + 2] = 1.0
    q = d_op.T @ d_op  # smoothness quadratic form

    # Average constraints A f = b.
    a_mat = np.zeros((c, n))
    b = np.asarray(prices)
    i = 0
    spans = []
    for start, stop in zip(starts, boundaries):
        length = pu.period_offset(stop, start)
        a_mat[len(spans), i : i + length] = 1.0 / length
        spans.append((i, i + length))
        i += length

    # KKT system for min fᵀQf s.t. Af = b.
    kkt = np.zeros((n + c, n + c))
    kkt[:n, :n] = q + 1e-12 * np.eye(n)
    kkt[:n, n:] = a_mat.T
    kkt[n:, :n] = a_mat
    rhs = np.concatenate([np.zeros(n), b])
    f = np.linalg.solve(kkt, rhs)[:n]

    if shaping_factors:
        weights = np.array(
            [shaping_factors.get(p.start_time.dayofweek, 1.0) for p in index]
        )
        shaped = f * weights
        # Renormalise within each contract to keep averages exact.
        for (lo, hi), price in zip(spans, prices):
            seg = shaped[lo:hi]
            mean = seg.mean()
            if mean != 0:
                shaped[lo:hi] = seg * (price / mean)
        f = shaped
    return pd.Series(index=index, data=f)


def interpolate_curve_to_daily(
    contracts: ContractsType,
    end: pu.PeriodSpec,
    interpolation_type: str = "Spline",
    shaping_factors: tp.Optional[tp.Dict[int, float]] = None,
) -> pd.Series:
    """Dispatch mirroring the Excel function's 'Flat' / 'Spline' choice
    (CurvesXl.cs:50-57)."""
    if interpolation_type == "Flat":
        return piecewise_flat_to_daily(contracts, end)
    if interpolation_type == "Spline":
        return spline_to_daily(contracts, end, shaping_factors)
    raise ValueError(
        f"Interpolation type '{interpolation_type}' not recognised. "
        "Should be either 'Flat' or 'Spline'."
    )
