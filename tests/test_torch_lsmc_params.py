"""The host layer of storage_tpu_torch against the JAX package: the parameter
builder and ``lsmc_value``, the simulator facade ``MultiFactorSpotSim``, the
curve helpers and the package's exported names.

``lsmc_value`` only gathers arguments, so it gives the entry point's own
bits; against the JAX package's ``lsmc_value`` it agrees in f64 to 1e-9, as
the entry points do.  ``MultiFactorSpotSim`` draws the JAX package's paths
for the same seed: f64 frames within 1e-12 (the same draws, the same OU
recursion).  The curve helpers are a numpy copy: equal frames.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import storage_tpu as jpkg
import storage_tpu_torch as tpkg
from storage_tpu_torch.models import spot_sim as tss

torch.set_num_threads(1)

RTOL = 1e-9


def _storage(pkg):
    return pkg.CmdtyStorage(
        "D", "2019-12-01", "2020-01-10", 1.23, 0.98,
        min_inventory=0.0, max_inventory=10_000.0,
        max_injection_rate=700.0, max_withdrawal_rate=700.0,
    )


def _market():
    """The 2F facility's market of tests/test_params_and_basis.py."""
    val_date = "2019-11-20"
    idx = pd.period_range(val_date, "2020-01-10", freq="D")
    fwd = pd.Series(index=idx, data=np.linspace(23.0, 28.0, len(idx)))
    rates = pd.Series(index=pd.period_range(val_date, "2020-03-01", freq="D"), data=0.03)

    def settle(period):
        return (period.asfreq("M").asfreq("D", "end") + 20).start_time.date()

    vol_idx = pd.period_range(val_date, "2020-03-01", freq="D")
    factors = [(0.0, pd.Series(index=vol_idx, data=0.14)),
               (16.2, pd.Series(index=vol_idx.copy(), data=1.15))]
    return val_date, fwd, rates, settle, factors


def _builder(pkg, basis="1 + x0 + x0**2 + x1 + x1*x1", num_sims=512):
    val_date, fwd, rates, settle, factors = _market()
    builder = (
        pkg.LsmcValuationParameters.builder()
        .with_storage(_storage(pkg))
        .with_val_date(val_date)
        .with_inventory(0.0)
        .with_forward_curve(fwd)
        .with_interest_rates(rates)
        .with_settlement_rule(settle)
        .with_basis_funcs(basis)
        .with_extra_decisions(1)
        .with_grid_points(20)
        .with_discount_deltas(True)
        .with_dtype(jnp.float64 if pkg is jpkg else torch.float64)
        .simulate_with_multi_factor_model(factors, 0.64, num_sims=num_sims, seed=11,
                                          fwd_sim_seed=13)
    )
    return builder if pkg is jpkg else builder.with_device("cpu")


def _same_bits(got, want):
    assert got.npv == want.npv
    assert got.val_sim_standard_error == want.val_sim_standard_error
    pd.testing.assert_series_equal(got.deltas, want.deltas, check_exact=True)
    pd.testing.assert_frame_equal(got.expected_profile, want.expected_profile, check_exact=True)


def test_lsmc_value_is_multi_factor_value():
    val_date, fwd, rates, settle, factors = _market()
    want = tpkg.multi_factor_value(
        _storage(tpkg), val_date, 0.0, fwd, rates, settle, factors, 0.64, 512,
        "1 + x0 + x0**2 + x1 + x1*x1", True, seed=11, fwd_sim_seed=13, extra_decisions=1,
        num_inventory_grid_points=20, dtype=torch.float64, device="cpu")
    _same_bits(tpkg.lsmc_value(_builder(tpkg).build()), want)


def test_lsmc_value_is_value_from_sims():
    val_date, fwd, rates, settle, factors = _market()
    sim = tpkg.MultiFactorSpotSim("D", factors, 0.64, val_date, fwd,
                                  list(pd.period_range(val_date, "2020-01-10", freq="D")),
                                  seed=3, dtype=torch.float64, device="cpu")
    spot, fac = sim.simulate_with_factors(256)
    want = tpkg.value_from_sims(
        _storage(tpkg), val_date, 0.0, fwd, rates, settle, spot, spot, "1 + s + x0 + x1**2",
        False, sim_factors_regress=fac, sim_factors_valuation=fac, dtype=torch.float64,
        device="cpu")
    params = (_builder(tpkg, basis="1 + s + x0 + x1**2").with_discount_deltas(False)
              .with_extra_decisions(0).with_grid_points(100)
              .use_spot_sim_results(spot, spot, fac, fac).build())
    assert isinstance(params.sim_spec, tpkg.PanelSimSpec)
    _same_bits(tpkg.lsmc_value(params), want)


@pytest.mark.parametrize("basis", ["string", "combinator", "generic"])
def test_lsmc_value_matches_jax_f64(basis):
    def make(pkg):
        if basis == "string":
            return "1 + x0 + x0**2 + x1 + x1*x1"
        if basis == "combinator":
            return pkg.ONE + pkg.X0 + pkg.X0 ** 2 + pkg.X1 + pkg.S * pkg.X1
        xp = jnp if pkg is jpkg else torch
        return [pkg.ONE, pkg.X0, pkg.generic(lambda s, x: xp.exp(-x[1]), num_factors=2)]

    want = jpkg.lsmc_value(_builder(jpkg, make(jpkg)).build())
    got = tpkg.lsmc_value(_builder(tpkg, make(tpkg)).build())
    assert got.npv == pytest.approx(want.npv, rel=RTOL)
    assert got.val_sim_standard_error == pytest.approx(want.val_sim_standard_error, rel=RTOL)
    np.testing.assert_allclose(got.deltas, want.deltas, rtol=RTOL, atol=1e-7)
    pd.testing.assert_frame_equal(got.expected_profile, want.expected_profile, rtol=RTOL,
                                  atol=1e-7)
    assert got.intrinsic_npv == pytest.approx(want.intrinsic_npv, rel=1e-10)


@pytest.mark.parametrize("missing", ["everything", "sim_spec", "basis_funcs"])
def test_missing_fields_raise_as_in_jax(missing):
    def partial(pkg):
        if missing == "everything":
            return pkg.LsmcValuationParameters.builder().with_inventory(1.0)
        b = _builder(pkg)
        del b._fields[missing]
        return b

    with pytest.raises(ValueError) as want:
        partial(jpkg).build()
    with pytest.raises(ValueError, match="missing required fields") as got:
        partial(tpkg).build()
    assert str(got.value) == str(want.value)


def test_builder_checks_deltas_method_and_unknown_spec():
    for pkg in (jpkg, tpkg):
        with pytest.raises(ValueError, match="deltas_method must be"):
            pkg.LsmcValuationParameters.builder().with_deltas_method("finite-difference")
    params = _builder(tpkg).build()
    with pytest.raises(TypeError, match="Unknown sim spec type"):
        tpkg.lsmc_value(tpkg.LsmcValuationParameters(**{**vars(params), "sim_spec": object()}))


def _dense_near_bottom(lo, hi):
    return lo + (hi - lo) * np.linspace(0.0, 1.0, 20) ** 2


@pytest.mark.parametrize(
    "option",
    [dict(deltas_method="adjoint"), dict(grid_calc=_dense_near_bottom)],
    ids=["adjoint", "grid-calc"],
)
def test_lsmc_value_routes_deltas_method_and_grid_calc(option):
    """``with_deltas_method("adjoint")`` and ``with_grid_calc(...)`` reach the
    entry point: ``lsmc_value`` gives the direct call's bits."""
    val_date, fwd, rates, settle, factors = _market()
    want = tpkg.multi_factor_value(
        _storage(tpkg), val_date, 0.0, fwd, rates, settle, factors, 0.64, 512,
        "1 + x0 + x0**2 + x1 + x1*x1", True, seed=11, fwd_sim_seed=13, extra_decisions=1,
        num_inventory_grid_points=20, dtype=torch.float64, device="cpu", **option)
    builder = _builder(tpkg)
    builder = (builder.with_deltas_method("adjoint") if "deltas_method" in option
               else builder.with_grid_calc(_dense_near_bottom))
    _same_bits(tpkg.lsmc_value(builder.build()), want)
    plain = tpkg.lsmc_value(_builder(tpkg).build())
    if "deltas_method" in option:  # the same valuation; the deltas by another route
        assert plain.npv == want.npv and not plain.deltas.equals(want.deltas)
        np.testing.assert_allclose(want.deltas, plain.deltas, rtol=RTOL, atol=1e-9)
    else:
        assert plain.npv != want.npv


def test_lsmc_value_runs_on_the_card_unless_told():
    params = _builder(tpkg).build()
    assert tpkg.LsmcValuationParameters.builder().with_inventory(0.0)._fields.get("device") is None
    assert tpkg.LsmcValuationParameters.__dataclass_fields__["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpkg.lsmc_value(tpkg.LsmcValuationParameters(**{**vars(params), "device": "cuda"}))


# ---------------------------------------------------------- MultiFactorSpotSim


def _daily(start, end, value):
    return pd.Series(index=pd.period_range(start, end, freq="D"), data=float(value))


def _spot_sim(pkg, seed=7, antithetic=False, curve_as_dict=False, f64=True):
    """The facade case of tests/test_multi_factor_model.py (in f32 at the
    packages' default dtype unless ``f64``)."""
    factors = [(0.0, _daily("2021-01-01", "2021-07-01", 0.2)),
               (6.0, _daily("2021-01-01", "2021-07-01", 0.9))]
    periods = pd.period_range("2021-02-01", "2021-06-01", freq="D")
    fwd = pd.Series(index=periods, data=np.linspace(40.0, 60.0, len(periods)))
    if curve_as_dict:
        fwd = {str(p): v for p, v in fwd.items()}
    kwargs = {} if pkg is jpkg else dict(device="cpu")
    if f64:
        kwargs["dtype"] = jnp.float64 if pkg is jpkg else torch.float64
    return pkg.MultiFactorSpotSim("D", factors, 0.3, "2021-01-01", fwd, list(periods), seed=seed,
                                  antithetic=antithetic, **kwargs)


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("curve_as_dict", [False, True])
def test_spot_sim_matches_jax_f64(antithetic, curve_as_dict):
    want_spot, want_fac = _spot_sim(jpkg, antithetic=antithetic,
                                    curve_as_dict=curve_as_dict).simulate_with_factors(96)
    sim = _spot_sim(tpkg, antithetic=antithetic, curve_as_dict=curve_as_dict)
    got_spot, got_fac = sim.simulate_with_factors(96)
    pd.testing.assert_index_equal(got_spot.index, want_spot.index)
    assert got_spot.shape == (121, 96) and got_spot.dtypes.unique().tolist() == [np.float64]
    np.testing.assert_allclose(got_spot, want_spot, rtol=1e-12, atol=0)
    assert len(got_fac) == len(want_fac) == 2
    for g, w in zip(got_fac, want_fac):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-14)
    pd.testing.assert_frame_equal(sim.simulate(96), got_spot, check_exact=True)


def test_spot_sim_frames_keep_the_f32_dtype_as_jax():
    """At the default f32 the frames are float32, as the JAX facade's, and
    hold the same paths to f32 rounding of the OU recursion."""
    want_spot, want_fac = _spot_sim(jpkg, f64=False).simulate_with_factors(96)
    got_spot, got_fac = _spot_sim(tpkg, f64=False).simulate_with_factors(96)
    for got, want in zip([got_spot, *got_fac], [want_spot, *want_fac]):
        assert got.dtypes.unique().tolist() == want.dtypes.unique().tolist() == [np.float32]
        pd.testing.assert_index_equal(got.index, want.index)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)


def test_spot_sim_seed_reproducible():
    a = _spot_sim(tpkg, seed=123).simulate(64)
    pd.testing.assert_frame_equal(a, _spot_sim(tpkg, seed=123).simulate(64), check_exact=True)
    assert not a.equals(_spot_sim(tpkg, seed=124).simulate(64))


def test_spot_sim_antithetic_pairs():
    _, factor_frames = _spot_sim(tpkg, antithetic=True).simulate_with_factors(64)
    x = factor_frames[0].to_numpy()
    np.testing.assert_array_equal(x[:, 0::2], -x[:, 1::2])


def test_spot_sim_path_subset_invariance():
    """A path id fixes its path: paths 32..63 simulated alone are the same
    bits as in the whole set."""
    sim = _spot_sim(tpkg)
    inputs = (sim._decay, sim._chol, sim._vols, sim._half_var, sim._fwd)
    full = tss.simulate_ou_paths(sim._key, torch.arange(64), *inputs)
    shard = tss.simulate_ou_paths(sim._key, torch.arange(32, 64), *inputs)
    assert torch.equal(full.spot[:, 32:], shard.spot)


def test_spot_sim_key_is_jax_key():
    sim = _spot_sim(tpkg, seed=2 ** 40 + 5)
    assert sim._key == tuple(int(w) for w in jax.random.key_data(jax.random.key(2 ** 40 + 5)))


def test_spot_sim_validation_matches_jax():
    factors = [(0.0, _daily("2021-01-01", "2021-07-01", 0.2))]
    periods = pd.period_range("2021-02-01", "2021-02-10", freq="D")
    short = pd.Series(index=periods[:-1], data=40.0)
    with pytest.raises(ValueError) as want:
        jpkg.MultiFactorSpotSim("D", factors, None, "2021-01-01", short, list(periods))
    with pytest.raises(ValueError, match="Forward curve has no point for period 2021-02-10"):
        tpkg.MultiFactorSpotSim("D", factors, None, "2021-01-01", short, list(periods),
                                device="cpu")
    assert "2021-02-10" in str(want.value)
    with pytest.raises(ValueError, match="Forward curve has no point"):
        tpkg.MultiFactorSpotSim("D", factors, None, "2021-01-01", {"2021-02-01": 40.0},
                                list(periods), device="cpu")


def test_spot_sim_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    factors = [(0.0, _daily("2021-01-01", "2021-07-01", 0.2))]
    periods = pd.period_range("2021-02-01", "2021-02-10", freq="D")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpkg.MultiFactorSpotSim("D", factors, None, "2021-01-01",
                                pd.Series(index=periods, data=40.0), list(periods))


# ---------------------------------------------------------------- curves


@pytest.mark.parametrize("case", [
    ("Flat", [("2021-01-01", 10.0), ("2021-02-01", 20.0)], "2021-02-10", None),
    ("Spline", [("2021-01-01", 10.0), ("2021-02-01", 20.0), ("2021-03-01", 14.0)],
     "2021-03-31", None),
    ("Spline", [("2021-01-04", 10.0), ("2021-01-11", 12.0)], "2021-01-17", {5: 0.8, 6: 0.8}),
    ("Spline", pd.Series({"2021-03-01": 14.0, "2021-01-01": 10.0, "2021-02-01": 20.0}),
     "2021-03-31", None),
], ids=["flat", "spline", "spline-shaped", "unsorted-series"])
def test_interpolate_curve_to_daily_equals_jax(case):
    kind, contracts, end, shaping = case
    want = jpkg.interpolate_curve_to_daily(contracts, end, kind, shaping)
    got = tpkg.interpolate_curve_to_daily(contracts, end, kind, shaping)
    pd.testing.assert_series_equal(got, want, check_exact=True)


def test_curve_errors_match_jax():
    for args in (([("2021-01-01", 10.0)], "2021-02-01", "Wiggly"), ([], "2021-02-01"),
                 ([("2021-03-01", 10.0)], "2021-02-01")):
        with pytest.raises(ValueError) as want:
            jpkg.interpolate_curve_to_daily(*args)
        with pytest.raises(ValueError) as got:
            tpkg.interpolate_curve_to_daily(*args)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- exports


def test_exports_are_the_jax_packages_but_the_service_layer():
    """The service layer is ported too: every JAX name is exported."""
    assert set(jpkg.__all__) - set(tpkg.__all__) == set()
    assert set(tpkg.__all__) - set(jpkg.__all__) == {"Monomial"}
    for name in tpkg.__all__:
        assert getattr(tpkg, name) is not None
    assert tpkg.X_ST is tpkg.X0 and tpkg.X_SW is tpkg.X2
    assert tpkg.StorageProfile._fields == jpkg.StorageProfile._fields
    assert tpkg.MultiFactorModel.__module__ == "storage_tpu_torch.models.multi_factor"


def test_host_layer_imports_without_jax():
    script = textwrap.dedent(
        """
        import sys

        class BlockJax:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "storage_tpu"):
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, BlockJax())
        from storage_tpu_torch import (ONE, X0, MultiFactorSpotSim, generic, lsmc_value,
                                       interpolate_curve_to_daily, log_linear_discount_factors)
        import storage_tpu_torch.curves, storage_tpu_torch.lsmc_params
        assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "storage_tpu")]
        print("ok")
        """
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
