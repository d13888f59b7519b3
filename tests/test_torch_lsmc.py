"""The LSMC slice of storage_tpu_torch against the JAX package.

* The engine (``lsmc_core``) on panels the JAX package simulated, carried over
  with ``convert``, against the JAX engine's XLA path in f64, with and
  without the 1/256 interpolation snap.  Both regress each step on exactly
  standardised design columns and run the same argmax, so every output
  agrees to f64 rounding.
* The public API (``three_factor_seasonal_value``) of both packages on a
  small case with the same seeds: the same threefry draws, hence the same
  valuation.
* The port imports without JAX, runs on CUDA unless told otherwise, and
  refuses an unknown ``deltas_method`` as the JAX package does.
* The reference's regression pins (``BASELINE.md``, tests/test_lsmc.py
  ``TestRegressionBaselines``): the 2F and 3F-seasonal facilities at 4,096
  sims in f64 land within 2 of the reference's standard errors of its NPVs,
  with the JAX tests' assertions.
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
from storage_tpu.engines import lsmc as jax_lsmc
from storage_tpu.models.spot_sim import simulate_ou_paths as jax_simulate
from storage_tpu_torch import convert
from storage_tpu_torch.basis import parse_basis_functions
from storage_tpu_torch.engines import lsmc as torch_lsmc

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
BASIS = "1 + x_st + x_lt + x_sw + x_st**2 + x_lt**2 + x_sw**2 + s + s**2"
RTOL = 1e-9  # f64: the same arithmetic up to summation order


def _case(pkg, num_steps=20):
    """The bench facility (``__graft_entry__._build_case``) cut to 20 days."""
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


def _assert_results_close(got, want):
    for key in want:
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

    inputs, arrays, sim_inputs, monomials = _build_case(20, 10, 512, jnp.float64)
    sim = [sim_inputs[k] for k in ("decay", "chol", "vols", "half_var", "fwd")]
    reg = jax_simulate(jax.random.key(11), jnp.arange(512), *sim)
    val = jax_simulate(jax.random.key(13), jnp.arange(512), *sim)
    return inputs, arrays, monomials, reg, val


@pytest.mark.parametrize("snap_interp", [False, True])
def test_lsmc_core_matches_jax_engine_f64(jax_panels, snap_interp):
    inputs, arrays, monomials, reg, val = jax_panels
    terminal_fn = inputs.compiled.terminal_value
    want = jax_lsmc.lsmc_core(
        arrays, reg.spot, reg.factors, val.spot, val.factors, jnp.asarray(100.0), monomials,
        1, True, terminal_fn, False, use_pallas=False, snap_interp=snap_interp,
        return_regression=True,
    )
    f64 = torch.float64
    got = torch_lsmc.lsmc_core(
        convert.engine_arrays_from_numpy({k: np.asarray(v) for k, v in arrays.items()}, f64, "cpu"),
        *convert.panels_from_numpy(reg.spot, reg.factors, f64, "cpu"),
        *convert.panels_from_numpy(val.spot, val.factors, f64, "cpu"),
        100.0, tuple(parse_basis_functions(BASIS)), 1, True, terminal_fn, False,
        snap_interp=snap_interp, return_regression=True,
    )
    assert set(got) == set(want)
    # The regression payload: step 0 is the valuation day, whose factor
    # columns are near-deterministic, so its coefficients are conditioned
    # by the ridge alone; compare its predictions through NPV/SE instead.
    want_reg = {k: np.asarray(want.pop(k)) for k in list(want) if k.startswith("regression_")}
    got_reg = {k: got.pop(k).numpy() for k in list(got) if k.startswith("regression_")}
    for key in ("regression_mean", "regression_std"):
        np.testing.assert_allclose(got_reg[key], want_reg[key], rtol=RTOL, atol=1e-12, err_msg=key)
    np.testing.assert_allclose(got_reg["regression_coeffs"][1:], want_reg["regression_coeffs"][1:],
                               rtol=1e-6, atol=1e-6)
    _assert_results_close({k: v.numpy() for k, v in got.items()}, want)


def test_lsmc_forward_on_jax_regression_f64(jax_panels):
    """The forward pass alone: the JAX engine's regression payload, carried
    over with ``convert``, drives the port's forward kernel path."""
    inputs, arrays, monomials, reg, val = jax_panels
    terminal_fn = inputs.compiled.terminal_value
    want = jax_lsmc.lsmc_core(
        arrays, reg.spot, reg.factors, val.spot, val.factors, jnp.asarray(100.0), monomials,
        0, False, terminal_fn, False, use_pallas=False, return_regression=True,
    )
    f64 = torch.float64
    regression = convert.regression_from_numpy(
        {k: np.asarray(want.pop(f"regression_{k}")) for k in ("mean", "std", "coeffs")}, f64, "cpu"
    )
    want.pop("backward_npv")
    got = torch_lsmc.lsmc_forward(
        convert.engine_arrays_from_numpy({k: np.asarray(v) for k, v in arrays.items()}, f64, "cpu"),
        *convert.panels_from_numpy(val.spot, val.factors, f64, "cpu"), regression, 100.0,
        tuple(parse_basis_functions(BASIS)), 0, False, terminal_fn, False,
    )
    _assert_results_close({k: v.numpy() for k, v in got.items()}, want)


@pytest.mark.parametrize("seeds", [(11, 13), (11, None), (5, 5)], ids=["two-seeds", "fold-in", "same-sims"])
def test_three_factor_seasonal_value_matches_jax(seeds):
    seed, fwd_seed = seeds
    kwargs = dict(
        inventory=100.0, interest_rates=0.02, settlement_rule=None, spot_mean_reversion=14.5,
        spot_vol=1.1, long_term_vol=0.19, seasonal_vol=0.23, num_sims=512, basis_funcs=BASIS,
        discount_deltas=True, seed=seed, fwd_sim_seed=fwd_seed, extra_decisions=1,
        num_inventory_grid_points=10,
    )
    storage, start, fwd = _case(jpkg)
    want = jpkg.three_factor_seasonal_value(storage, start, fwd_curve=fwd, dtype=jnp.float64, **kwargs)
    storage, start, fwd = _case(tpkg)
    got = tpkg.three_factor_seasonal_value(storage, start, fwd_curve=fwd, dtype=torch.float64,
                                           device="cpu", **kwargs)
    assert got.npv == pytest.approx(want.npv, rel=RTOL)
    assert got.val_sim_standard_error == pytest.approx(want.val_sim_standard_error, rel=RTOL)
    pd.testing.assert_index_equal(got.deltas.index, want.deltas.index)
    np.testing.assert_allclose(got.deltas, want.deltas, rtol=RTOL, atol=1e-7)
    pd.testing.assert_frame_equal(got.expected_profile, want.expected_profile, rtol=RTOL, atol=1e-7)
    pd.testing.assert_frame_equal(got.trigger_prices, want.trigger_prices, rtol=1e-7, atol=1e-7)
    assert len(got.trigger_profiles) == len(want.trigger_profiles)
    for g, w in zip(got.trigger_profiles, want.trigger_profiles):
        for gs, ws in ((g.inject_triggers, w.inject_triggers), (g.withdraw_triggers, w.withdraw_triggers)):
            np.testing.assert_allclose(np.asarray(gs).reshape(-1, 2), np.asarray(ws).reshape(-1, 2),
                                       rtol=1e-7, atol=1e-7)
    assert got.intrinsic_npv == pytest.approx(want.intrinsic_npv, rel=1e-10)
    pd.testing.assert_frame_equal(got.intrinsic_profile, want.intrinsic_profile, rtol=0, atol=1e-6)


@pytest.mark.parametrize("entry", ["three-factor", "multi-factor"])
def test_antithetic_matches_jax(entry):
    """Antithetic draws (path 2m+1 takes the negated normals of path 2m) on
    materialised panels: the same valuation as the JAX package's XLA engine
    in f64 on the same seeds, through both entry points."""
    kwargs = dict(inventory=100.0, interest_rates=0.02, settlement_rule=None, num_sims=512,
                  discount_deltas=False, seed=11, fwd_sim_seed=13, num_inventory_grid_points=10)

    def value(pkg, antithetic, **dtype_device):
        storage, start, fwd = _case(pkg)
        if entry == "three-factor":
            return pkg.three_factor_seasonal_value(
                storage, start, fwd_curve=fwd, spot_mean_reversion=14.5, spot_vol=1.1,
                long_term_vol=0.19, seasonal_vol=0.23, basis_funcs=BASIS, antithetic=antithetic,
                **kwargs, **dtype_device)
        factors = [(12.0, pd.Series(0.9, index=fwd.index)), (0.5, pd.Series(0.2, index=fwd.index))]
        return pkg.multi_factor_value(
            storage, start, fwd_curve=fwd, factors=factors,
            factor_corrs=np.array([[1.0, 0.3], [0.3, 1.0]]), basis_funcs="1 + s + s**2 + x0 + x1",
            antithetic=antithetic, **kwargs, **dtype_device)

    want = value(jpkg, True, dtype=jnp.float64)
    got = value(tpkg, True, dtype=torch.float64, device="cpu")
    assert got.npv == pytest.approx(want.npv, rel=RTOL)
    assert got.val_sim_standard_error == pytest.approx(want.val_sim_standard_error, rel=RTOL)
    np.testing.assert_allclose(got.deltas, want.deltas, rtol=RTOL, atol=1e-7)
    pd.testing.assert_frame_equal(got.expected_profile, want.expected_profile, rtol=RTOL, atol=1e-7)
    assert got.npv != value(tpkg, False, dtype=torch.float64, device="cpu").npv


def test_f32_valuation_close_to_jax():
    """In f32 both packages draw the same paths to a few ULP, but the
    regressions round differently and this small case has many near-tie
    decisions: the JAX package's own f32 NPV moves by ~0.1 standard error
    between one and eight devices here.  The NPVs agree within half a
    standard error."""
    kwargs = dict(
        inventory=100.0, interest_rates=0.02, settlement_rule=None, spot_mean_reversion=14.5,
        spot_vol=1.1, long_term_vol=0.19, seasonal_vol=0.23, num_sims=1024, basis_funcs=BASIS,
        discount_deltas=False, seed=11, fwd_sim_seed=13, num_inventory_grid_points=20,
    )
    storage, start, fwd = _case(jpkg)
    want = jpkg.three_factor_seasonal_value(storage, start, fwd_curve=fwd, dtype=jnp.float32, **kwargs)
    storage, start, fwd = _case(tpkg)
    got = tpkg.three_factor_seasonal_value(storage, start, fwd_curve=fwd, dtype=torch.float32,
                                           device="cpu", **kwargs)
    assert abs(got.npv - want.npv) < 0.5 * want.val_sim_standard_error
    assert got.val_sim_standard_error == pytest.approx(want.val_sim_standard_error, rel=1e-2)


@pytest.mark.parametrize("entry", ["three-factor", "multi-factor", "value-from-sims"])
def test_unknown_deltas_method_raises(entry):
    """``deltas_method`` is 'pathwise' or 'adjoint'; anything else raises
    ``ValueError`` before any simulation, as in the JAX package."""
    storage, start, fwd = _case(tpkg)
    frame = pd.DataFrame(np.full((21, 8), 30.0), index=pd.period_range(start, storage.end))
    calls = {
        "three-factor": lambda: tpkg.three_factor_seasonal_value(
            storage, start, 100.0, fwd, 0.02, None, 14.5, 1.1, 0.19, 0.23, 64, BASIS, False,
            deltas_method="bogus", device="cpu"),
        "multi-factor": lambda: tpkg.multi_factor_value(
            storage, start, 100.0, fwd, 0.02, None, [(12.0, pd.Series(0.9, index=fwd.index))],
            None, 64, "1 + s + x0", False, deltas_method="bogus", device="cpu"),
        "value-from-sims": lambda: tpkg.value_from_sims(
            storage, start, 100.0, fwd, 0.02, None, frame, frame, "1 + s", False,
            deltas_method="bogus", device="cpu"),
    }
    with pytest.raises(ValueError, match="deltas_method must be 'pathwise' or 'adjoint'"):
        calls[entry]()


def _reg_storage():
    """The regression facility of tests/test_lsmc.py (test_multi_factor.py:36-50)."""
    return tpkg.CmdtyStorage(
        "D", "2019-12-01", "2020-04-01", 1.23, 0.98,
        min_inventory=0.0, max_inventory=100_000.0,
        max_injection_rate=700.0, max_withdrawal_rate=700.0,
    )


def _reg_market():
    val_date = "2019-08-29"
    idx = pd.period_range(val_date, "2020-04-01", freq="D")
    fwd = pd.Series(
        index=idx,
        data=[23.87 if p < pd.Period("2020-03-12", freq="D") else 150.32 for p in idx],
    )
    rates = pd.Series(index=pd.period_range(val_date, "2020-06-01", freq="D"), data=0.03)

    def settle(period):
        return (period.asfreq("M").asfreq("D", "end") + 20).start_time.date()

    return val_date, fwd, rates, settle


class TestRegressionBaselines:
    """tests/test_lsmc.py ``TestRegressionBaselines`` on the port: the same
    calls in f64 at 4,096 sims, the same assertions against the reference's
    pins (BASELINE.md)."""

    def test_two_factor_within_two_se_of_reference(self):
        val_date, fwd, rates, settle = _reg_market()
        vol_idx = pd.period_range(val_date, "2020-06-01", freq="D")
        factors = [
            (0.0, pd.Series(index=vol_idx, data=0.14)),
            (16.2, pd.Series(index=vol_idx.copy(), data=1.15)),
        ]
        progresses = []
        res = tpkg.multi_factor_value(
            _reg_storage(), val_date, 0.0, fwd, rates, settle, factors, 0.64,
            4096, "1 + x0 + x0**2 + x1 + x1*x1", False, seed=11, fwd_sim_seed=11,
            dtype=torch.float64, on_progress_update=progresses.append,
            sim_data_returned=tpkg.SimulationDataReturned.ALL, device="cpu",
        )
        assert abs(res.npv - 1_780_380.7581833513) < 2 * 21_405.34
        assert res.val_sim_standard_error == pytest.approx(
            21_405.34 * (500 / 4096) ** 0.5, rel=0.25
        )
        assert res.intrinsic_npv == pytest.approx(1_703_773.0757192627, rel=2e-3)
        assert res.extrinsic_npv > 0
        assert progresses[-1] == 1.0
        assert res.sim_spot_regress.shape == (123, 4096)
        assert res.sim_inventory.shape == (123, 4096)
        assert res.sim_inject_withdraw.shape == (122, 4096)
        assert len(res.sim_factors_regress) == 2
        assert res.npv >= res.intrinsic_npv - 2 * res.val_sim_standard_error

    def test_three_factor_seasonal_within_two_se_of_reference(self):
        val_date, fwd, rates, settle = _reg_market()
        res = tpkg.three_factor_seasonal_value(
            _reg_storage(), val_date, 0.0, fwd, rates, settle,
            spot_mean_reversion=16.2, spot_vol=1.15, long_term_vol=0.14,
            seasonal_vol=0.18, num_sims=4096,
            basis_funcs="1 + x_st + x_sw + x_lt + x_st**2 + x_sw**2 + x_lt**2",
            discount_deltas=False, seed=11, fwd_sim_seed=11, dtype=torch.float64, device="cpu",
        )
        assert abs(res.npv - 1_766_460.137569665) < 2 * 18_459.70
        assert res.val_sim_standard_error == pytest.approx(
            18_459.70 * (500 / 4096) ** 0.5, rel=0.25
        )


def test_degenerate_valuation_dates():
    storage, start, fwd = _case(tpkg)
    args = (100.0, fwd, 0.02, None, 14.5, 1.1, 0.19, 0.23, 64, BASIS, False)
    expired = tpkg.three_factor_seasonal_value(storage, storage.end + 1, *args, device="cpu")
    assert expired.npv == 0.0 and expired.deltas.empty
    at_end = tpkg.three_factor_seasonal_value(storage, storage.end, *args, device="cpu")
    assert at_end.npv == pytest.approx(float(fwd[storage.end]) * 100.0)


def test_imports_without_jax():
    script = textwrap.dedent(
        """
        import sys

        class BlockJax:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "storage_tpu"):
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, BlockJax())
        import storage_tpu_torch
        import storage_tpu_torch.api_lsmc, storage_tpu_torch.convert, storage_tpu_torch.engines.lsmc
        import storage_tpu_torch.api, storage_tpu_torch.engines.intrinsic
        from storage_tpu_torch import intrinsic_value, value_from_sims, value_from_sims_host_local
        from storage_tpu_torch.ops import _build, decision_kernel, forward_kernel, rng_kernel
        from storage_tpu_torch.ops import interp, intrinsic_kernel
        from storage_tpu_torch.ops.decision_kernel import decision_update, decision_update_fullstep
        from storage_tpu_torch.ops.regression import fit_continuation
        assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "storage_tpu")]
        print("ok")
        """
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_device_is_required():
    """The entry points run on CUDA unless the caller names the CPU: on a host
    without CUDA a call that names no device raises, and runs nothing."""
    import inspect

    for fn in (tpkg.three_factor_seasonal_value, tpkg.multi_factor_value, tpkg.value_from_sims):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    storage, start, fwd = _case(tpkg)
    frame = pd.DataFrame(np.full((21, 8), 30.0), index=pd.period_range(start, storage.end))
    calls = [
        lambda: tpkg.three_factor_seasonal_value(storage, start, 100.0, fwd, 0.02, None, 14.5,
                                                 1.1, 0.19, 0.23, 64, BASIS, False),
        lambda: tpkg.value_from_sims(storage, start, 100.0, fwd, 0.02, None, frame, frame,
                                     "1 + s", False),
    ]
    for call in calls:
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA device")
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


BASIS_17 = ("1 + s + s**2 + s**3 + s**4 + x0 + x1 + x2 + x0**2 + x1**2 + x2**2 + s*x0 + s*x1 "
            "+ s*x2 + x0*x1 + x0*x2 + x1*x2")  # one term past the monomial kernels' cap


def test_cpu_takes_any_basis():
    """The CPU path values a basis beyond the monomial kernels' 16 terms, and
    a model of 9 factors."""
    storage, start, fwd = _case(tpkg, num_steps=6)
    res = tpkg.three_factor_seasonal_value(
        storage, start, 100.0, fwd, 0.02, None, 14.5, 1.1, 0.19, 0.23, 64, BASIS_17, False,
        dtype=torch.float64, device="cpu")
    nine = [(0.5 + i, pd.Series(0.2 / (1 + i), index=fwd.index)) for i in range(9)]
    res9 = tpkg.multi_factor_value(
        storage, start, 100.0, fwd, 0.02, None, nine, np.eye(9), 64, "1 + s + x8 + s*x3", False,
        dtype=torch.float64, device="cpu")
    for r in (res, res9):
        assert np.isfinite(r.npv) and r.npv > 0 and r.deltas.notna().all()


@pytest.mark.parametrize("precision", ["medium", "high"])
def test_matmul_precision_restored(precision):
    """The engine keeps its products in full f32 and leaves the caller's
    settings as they were."""
    saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision(precision)
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch_lsmc.full_f32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == precision
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
