"""User-supplied simulations, per-sim panels and the full-step backward of
storage_tpu_torch against the JAX package, in f64 on the same inputs.

* The engine on spot-only panels ([N+1, 0, S] factors: the plain backward
  with kernel D's plain version) and with ``fullstep=True`` (kernel E's plain
  version) against the JAX XLA engine, per-sim panels included.
* ``value_from_sims`` on the same DataFrames in both packages, spot-only and
  with factors; the round trip of ``tests/test_lsmc.py`` (the source run's
  panels fed back reproduce it exactly); every per-sim panel of
  ``multi_factor_value(sim_data_returned=ALL)``; the input errors.

Both packages regress on exactly standardised design columns and run the same
argmax, so the outputs agree to f64 rounding (rel 1e-9).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import storage_tpu as jpkg
import storage_tpu_torch as tpkg
from storage_tpu.basis import parse_basis_functions as jax_parse
from storage_tpu.engines import lsmc as jax_lsmc
from storage_tpu.models.spot_sim import simulate_ou_paths as jax_simulate
from storage_tpu_torch import convert
from storage_tpu_torch.basis import parse_basis_functions
from storage_tpu_torch.engines import lsmc as torch_lsmc

torch.set_num_threads(1)

RTOL = 1e-9
BASIS = "1 + x_st + x_lt + x_sw + x_st**2 + x_lt**2 + x_sw**2 + s + s**2"
SPOT_BASIS = "1 + s + s**2 + s**3"
ALL = tpkg.SimulationDataReturned.ALL
JALL = jpkg.SimulationDataReturned.ALL


def _assert_results_close(got, want, skip=()):
    for key in want:
        if key in skip:
            continue
        w = np.asarray(want[key], dtype=np.float64)
        g = np.asarray(got[key], dtype=np.float64)
        assert g.shape == w.shape, key
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=key)
        mask = ~np.isnan(w)
        scale = max(1.0, float(np.abs(w[mask]).max())) if mask.any() else 1.0
        np.testing.assert_allclose(g[mask], w[mask], rtol=RTOL, atol=RTOL * scale, err_msg=key)


@pytest.fixture(scope="module")
def jax_panels():
    from __graft_entry__ import _build_case

    inputs, arrays, sim_inputs, _ = _build_case(20, 10, 256, jnp.float64)
    sim = [sim_inputs[k] for k in ("decay", "chol", "vols", "half_var", "fwd")]
    reg = jax_simulate(jax.random.key(11), jnp.arange(256), *sim)
    val = jax_simulate(jax.random.key(13), jnp.arange(256), *sim)
    return inputs, arrays, reg, val


def _engine_pair(jax_panels, basis, spot_only, snap_interp=False, fullstep=False):
    inputs, arrays, reg, val = jax_panels
    terminal_fn = inputs.compiled.terminal_value
    f = lambda x: x[:, :0] if spot_only else x  # noqa: E731
    want = jax_lsmc.lsmc_core(
        arrays, reg.spot, f(reg.factors), val.spot, f(val.factors), jnp.asarray(100.0),
        tuple(jax_parse(basis)), 1, True, terminal_fn, False, use_pallas=False,
        snap_interp=snap_interp, return_regression=True, return_sim_data=True,
    )
    f64 = torch.float64
    got = torch_lsmc.lsmc_core(
        convert.engine_arrays_from_numpy({k: np.asarray(v) for k, v in arrays.items()}, f64, "cpu"),
        *convert.panels_from_numpy(reg.spot, f(reg.factors), f64, "cpu"),
        *convert.panels_from_numpy(val.spot, f(val.factors), f64, "cpu"),
        100.0, tuple(parse_basis_functions(basis)), 1, True, terminal_fn, False,
        snap_interp=snap_interp, return_regression=True, return_sim_data=True, fullstep=fullstep,
    )
    return {k: v.numpy() for k, v in got.items()}, {k: np.asarray(v) for k, v in want.items()}


def _assert_engine_close(got, want):
    assert set(got) == set(want)
    for key in ("regression_mean", "regression_std"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=1e-12, err_msg=key)
    # Step 0 is the valuation day, whose design columns are constant across
    # sims: its coefficients are conditioned by the ridge alone.
    np.testing.assert_allclose(got["regression_coeffs"][1:], want["regression_coeffs"][1:],
                               rtol=1e-6, atol=1e-6)
    _assert_results_close(got, want, skip=("regression_coeffs",))


@pytest.mark.parametrize("snap_interp", [False, True])
def test_spot_only_engine_matches_jax_f64(jax_panels, snap_interp):
    """[N+1, 0, S] factor panels: the plain backward body and kernel D."""
    got, want = _engine_pair(jax_panels, SPOT_BASIS, spot_only=True, snap_interp=snap_interp)
    _assert_engine_close(got, want)


def test_fullstep_engine_matches_jax_f64(jax_panels):
    """Kernel E per backward step: the regression solved from the carried
    moments gives the JAX XLA engine's valuation."""
    got, want = _engine_pair(jax_panels, BASIS, spot_only=False, fullstep=True)
    _assert_engine_close(got, want)


def test_fullstep_refuses_spot_only_panels(jax_panels):
    with pytest.raises(ValueError, match="fullstep"):
        _engine_pair(jax_panels, SPOT_BASIS, spot_only=True, fullstep=True)


def _bench_case(pkg, num_steps=20):
    start = pd.Period("2021-01-01", freq="D")
    storage = pkg.CmdtyStorage(
        "D", start, start + num_steps, 0.9, 0.7,
        ratchets=[
            (start, [(0.0, -200.0, 300.0), (2500.0, -250.0, 250.0), (5000.0, -300.0, 200.0)]),
        ],
        ratchet_interp=pkg.RatchetInterp.LINEAR,
        terminal_storage_npv=lambda price, inv: price * inv,
    )
    idx = pd.period_range(start, storage.end, freq="D")
    i = np.arange(len(idx))
    fwd = pd.Series(index=idx, data=30.0 + 6 * np.sin(2 * np.pi * i / 365.0) + 0.4 * np.cos(i))
    return storage, start, fwd


@pytest.fixture(scope="module")
def jax_frames():
    """Path panels of a small 3-factor JAX valuation, as DataFrames."""
    storage, start, fwd = _bench_case(jpkg)
    return jpkg.three_factor_seasonal_value(
        storage, start, 100.0, fwd, 0.02, None, 14.5, 1.1, 0.19, 0.23, 256, BASIS, False,
        seed=11, fwd_sim_seed=13, num_inventory_grid_points=10, dtype=jnp.float64,
        sim_data_returned=jpkg.SimulationDataReturned.SPOT_ALL | jpkg.SimulationDataReturned.FACTORS_ALL,
    )


def _assert_valuations_close(got, want):
    assert got.npv == pytest.approx(want.npv, rel=RTOL)
    assert got.val_sim_standard_error == pytest.approx(want.val_sim_standard_error, rel=RTOL)
    pd.testing.assert_index_equal(got.deltas.index, want.deltas.index)
    np.testing.assert_allclose(got.deltas, want.deltas, rtol=RTOL, atol=1e-7)
    pd.testing.assert_frame_equal(got.expected_profile, want.expected_profile, rtol=RTOL, atol=1e-7)
    pd.testing.assert_frame_equal(got.trigger_prices, want.trigger_prices, rtol=1e-7, atol=1e-7)
    for g, w in zip(got.trigger_profiles, want.trigger_profiles):
        for gs, ws in ((g.inject_triggers, w.inject_triggers),
                       (g.withdraw_triggers, w.withdraw_triggers)):
            np.testing.assert_allclose(np.asarray(gs).reshape(-1, 2), np.asarray(ws).reshape(-1, 2),
                                       rtol=1e-7, atol=1e-7)


@pytest.mark.parametrize("with_factors", [False, True], ids=["spot-only", "factors"])
def test_value_from_sims_matches_jax(jax_frames, with_factors):
    frames = dict(sim_spot_regress=jax_frames.sim_spot_regress,
                  sim_spot_valuation=jax_frames.sim_spot_valuation)
    if with_factors:
        frames.update(sim_factors_regress=jax_frames.sim_factors_regress,
                      sim_factors_valuation=jax_frames.sim_factors_valuation)
    kwargs = dict(basis_funcs=BASIS if with_factors else SPOT_BASIS, discount_deltas=True,
                  extra_decisions=1, num_inventory_grid_points=10, **frames)
    storage, start, fwd = _bench_case(jpkg)
    want = jpkg.value_from_sims(storage, start, 100.0, fwd, 0.02, None, dtype=jnp.float64, **kwargs)
    storage, start, fwd = _bench_case(tpkg)
    got = tpkg.value_from_sims(storage, start, 100.0, fwd, 0.02, None, dtype=torch.float64,
                               device="cpu", **kwargs)
    _assert_valuations_close(got, want)
    assert got.intrinsic_npv == pytest.approx(want.intrinsic_npv, rel=1e-10)
    pd.testing.assert_frame_equal(got.intrinsic_profile, want.intrinsic_profile, rtol=0, atol=1e-6)


def _reg_case(pkg):
    """The regression case of tests/test_lsmc.py (simple_reg_storage,
    reg_market, the two-factor model)."""
    storage = pkg.CmdtyStorage(
        "D", "2019-12-01", "2020-04-01", 1.23, 0.98,
        min_inventory=0.0, max_inventory=100_000.0,
        max_injection_rate=700.0, max_withdrawal_rate=700.0,
    )
    val_date = "2019-08-29"
    idx = pd.period_range(val_date, "2020-04-01", freq="D")
    fwd = pd.Series(
        index=idx,
        data=[23.87 if p < pd.Period("2020-03-12", freq="D") else 150.32 for p in idx],
    )
    rates = pd.Series(index=pd.period_range(val_date, "2020-06-01", freq="D"), data=0.03)

    def settle(period):
        return (period.asfreq("M").asfreq("D", "end") + 20).start_time.date()

    vol_idx = pd.period_range(val_date, "2020-06-01", freq="D")
    factors = [
        (0.0, pd.Series(index=vol_idx, data=0.14)),
        (16.2, pd.Series(index=vol_idx.copy(), data=1.15)),
    ]
    return (storage, val_date, 0.0, fwd, rates, settle), factors


REG_BASIS = "1 + x0 + x0**2 + x1 + x1*x1"
_PANELS = ("sim_spot_regress", "sim_spot_valuation", "sim_inventory", "sim_inject_withdraw",
           "sim_cmdty_consumed", "sim_inventory_loss", "sim_net_volume", "sim_pv")


@pytest.fixture(scope="module")
def reg_valuations():
    args, factors = _reg_case(jpkg)
    want = jpkg.multi_factor_value(*args, factors, 0.64, 300, REG_BASIS, False, seed=11,
                                   fwd_sim_seed=11, dtype=jnp.float64, sim_data_returned=JALL)
    args, factors = _reg_case(tpkg)
    got = tpkg.multi_factor_value(*args, factors, 0.64, 300, REG_BASIS, False, seed=11,
                                  fwd_sim_seed=11, dtype=torch.float64, sim_data_returned=ALL,
                                  device="cpu")
    return got, want


def test_sim_panels_match_jax(reg_valuations):
    got, want = reg_valuations
    assert got.npv == pytest.approx(want.npv, rel=RTOL)
    for name in _PANELS:
        g, w = getattr(got, name), getattr(want, name)
        pd.testing.assert_index_equal(g.index, w.index)
        assert g.shape == w.shape and g.shape[1] == 300, name
        scale = float(np.abs(w.to_numpy()).max())
        np.testing.assert_allclose(g.to_numpy(), w.to_numpy(), rtol=RTOL, atol=RTOL * scale,
                                   err_msg=name)
    for attr in ("sim_factors_regress", "sim_factors_valuation"):
        assert len(getattr(got, attr)) == 2
        for g, w in zip(getattr(got, attr), getattr(want, attr)):
            np.testing.assert_allclose(g.to_numpy(), w.to_numpy(), rtol=RTOL, atol=1e-12)
    # The panels add up to the valuation: PV by sim, and the expected profile.
    np.testing.assert_allclose(got.sim_pv.to_numpy().sum(axis=0).mean(), got.npv, rtol=1e-12)
    np.testing.assert_allclose(got.sim_inventory.to_numpy().mean(axis=1),
                               got.expected_profile["inventory"].to_numpy(), rtol=1e-12)


def test_round_trip_reproduces_source_exactly(reg_valuations):
    source, _ = reg_valuations
    args, _ = _reg_case(tpkg)
    res = tpkg.value_from_sims(
        *args, source.sim_spot_regress, source.sim_spot_valuation, REG_BASIS, False,
        sim_factors_regress=source.sim_factors_regress,
        sim_factors_valuation=source.sim_factors_valuation,
        dtype=torch.float64, device="cpu", sim_data_returned=ALL,
    )
    assert res.npv == source.npv
    assert res.val_sim_standard_error == source.val_sim_standard_error
    pd.testing.assert_series_equal(res.deltas, source.deltas)
    pd.testing.assert_frame_equal(res.expected_profile, source.expected_profile)
    for name in _PANELS:
        pd.testing.assert_frame_equal(getattr(res, name), getattr(source, name))


def test_missing_period_raises():
    args, _ = _reg_case(tpkg)
    periods = pd.period_range("2019-12-01", "2020-03-30", freq="D")  # ends early
    frame = pd.DataFrame(np.full((len(periods), 8), 25.0), index=periods)
    with pytest.raises(ValueError, match="does not contain a row"):
        tpkg.value_from_sims(*args, frame, frame, "1 + s", False, dtype=torch.float64, device="cpu")


def test_unequal_sim_counts_raise():
    args, _ = _reg_case(tpkg)
    periods = pd.period_range("2019-08-29", "2020-04-01", freq="D")
    reg = pd.DataFrame(np.full((len(periods), 8), 25.0), index=periods)
    val = pd.DataFrame(np.full((len(periods), 6), 25.0), index=periods)
    with pytest.raises(ValueError, match="same number of sims"):
        tpkg.value_from_sims(*args, reg, val, "1 + s", False, dtype=torch.float64, device="cpu")


def test_panels_larger_than_the_card_are_host_fed(monkeypatch):
    """User panels whose footprint passes the card's streaming threshold (a
    share of its free memory) stay in host memory and are fed a segment at a
    time; asking for panels back from them raises ``ValueError``, as in the
    JAX package.  Panels that fit, and CPU runs under 4 GiB, are held on the
    device."""
    from storage_tpu_torch import api_lsmc

    periods = pd.period_range("2021-01-01", periods=366, freq="D")
    frame = pd.DataFrame(np.zeros((366, 1000), np.float32), index=periods)
    big = api_lsmc._UserPanels(frame, frame, [frame] * 3, [frame] * 3, torch.float32, "cuda")
    small = api_lsmc._UserPanels(frame, frame, None, None, torch.float32, "cuda")
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device: (10_000_000, 80_000_000_000))
    route = lambda sims, flags, device: api_lsmc._route(  # noqa: E731
        sims, 365, 100, flags, None, torch.float32, torch.device(device))
    none, pv = tpkg.SimulationDataReturned.NONE, tpkg.SimulationDataReturned.PV
    assert route(big, none, "cuda")  # 12.5 MB over 7.5 MB: host-fed
    with pytest.raises(ValueError, match="do not fit device memory"):
        route(big, pv, "cuda")
    assert not route(small, pv, "cuda")  # 3.7 MB: fits
    assert not route(big, pv, "cpu")
