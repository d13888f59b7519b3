"""Custom inventory grids in the LSMC of storage_tpu_torch against the JAX
package, in f64 on the CPU.

* The general interpolation (``ops.interp``): the node-count weights on one
  row or on every step's row at once, the per-sim gather and the vector
  interpolation, against the JAX package's, on rows with zero-span padding.
* The engine: ``lsmc_core`` on rows that are not evenly spaced (a bunched
  grid padded by repeating its last point) against JAX ``lsmc_core(...,
  uniform_grids=False)`` on the same JAX-simulated panels, at E = 0 and 1
  and with a generic basis (kernel D's route): NPV, SE, deltas, profiles
  and trigger prices within the engine tests' 1e-9.  The forward pass alone
  on the JAX package's regression; kernel E's full-step backward on those
  rows against the kernel-B route.
* The API: ``multi_factor_value`` with the JAX tests' ``dense_near_bottom``
  grid and with rows of different lengths against the JAX call (500 sims:
  the JAX side's single-device path); evenly spaced rows from a
  ``grid_calc`` give the default grid's bits; adjoint deltas on the custom
  grid equal its pathwise ones (tests/test_ad_deltas_api.py:178-208); an
  interactive run gives the uninterrupted run's bits.
"""
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
from storage_tpu.ops import interp as jax_interp
from storage_tpu_torch import convert
from storage_tpu_torch import grid as gridmod
from storage_tpu_torch.basis import parse_basis_functions
from storage_tpu_torch.engines import lsmc as torch_lsmc
from storage_tpu_torch.ops import interp

torch.set_num_threads(1)

RTOL = 1e-9  # f64: the same arithmetic up to summation order
BASIS = "1 + x_st + x_lt + x_sw + x_st**2 + x_lt**2 + x_sw**2 + s + s**2"
F64 = torch.float64


def _rows(rng, n, g):
    """Bunched rows [N, G] over shrinking bands, the last few points repeated
    (the padding of rows of different lengths)."""
    lo = rng.uniform(0.0, 100.0, (n, 1))
    hi = lo + rng.uniform(500.0, 1000.0, (n, 1))
    rows = lo + (hi - lo) * np.linspace(0.0, 1.0, g) ** 1.7
    rows[:, g - 3:] = rows[:, g - 4:g - 3]
    return rows


def test_general_weights_on_every_row_match_jax():
    rng = np.random.default_rng(5)
    grids = _rows(rng, 6, 11)
    x = rng.uniform(-100.0, 1200.0, (6, 11, 3))
    x[:, 0, 0] = grids[:, 4]  # on a node
    x[:, 1, 0] = grids[:, -1]  # on the padded end
    want_idx, want_w = jax.vmap(jax_interp.interp_weights_general)(jnp.asarray(grids),
                                                                  jnp.asarray(x))
    got_idx, got_w = interp.interp_weights_general(torch.tensor(grids), torch.tensor(x))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=0, atol=1e-15)
    # One row at a time is the same.
    for t in range(6):
        idx_t, w_t = interp.interp_weights_general(torch.tensor(grids[t]), torch.tensor(x[t]))
        assert torch.equal(idx_t, got_idx[t]) and torch.equal(w_t, got_w[t])


def test_per_sim_and_vector_interpolation_match_jax():
    rng = np.random.default_rng(6)
    grid = _rows(rng, 1, 13)[0]
    values = rng.standard_normal((40, 13))
    x = rng.uniform(-50.0, 1200.0, (40, 3))
    want = jax_interp.interp_per_sim_general(jnp.asarray(grid), jnp.asarray(values), jnp.asarray(x))
    got = interp.interp_per_sim_general(torch.tensor(grid), torch.tensor(values), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13, atol=1e-13)
    grids = _rows(rng, 4, 13)
    vals = rng.standard_normal((4, 13))
    xs = rng.uniform(-50.0, 1200.0, (4, 7))
    want = jax.vmap(jax_interp.interp_vector_general)(jnp.asarray(grids), jnp.asarray(vals),
                                                      jnp.asarray(xs))
    got = interp.interp_vector_general(torch.tensor(grids), torch.tensor(vals), torch.tensor(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13, atol=1e-13)


@pytest.fixture(scope="module")
def jax_panels():
    """The bench facility cut to 20 days on bunched 12-point rows (the last
    three repeated), 512 JAX-simulated paths a set in f64."""
    from __graft_entry__ import _build_case

    inputs, arrays, sim_inputs, monomials = _build_case(20, 10, 512, jnp.float64)
    g = np.asarray(arrays["grids"])
    rows = g[:, :1] + (g[:, -1:] - g[:, :1]) * np.linspace(0.0, 1.0, 12) ** 2
    rows[:, -3:] = rows[:, -3:-2]
    assert not gridmod.rows_uniform(rows)
    arrays = {**arrays, "grids": jnp.asarray(rows)}
    sim = [sim_inputs[k] for k in ("decay", "chol", "vols", "half_var", "fwd")]
    reg = jax_simulate(jax.random.key(11), jnp.arange(512), *sim)
    val = jax_simulate(jax.random.key(13), jnp.arange(512), *sim)
    t_arrays = convert.engine_arrays_from_numpy({k: np.asarray(v) for k, v in arrays.items()},
                                                F64, "cpu")
    panels = (convert.panels_from_numpy(reg.spot, reg.factors, F64, "cpu"),
              convert.panels_from_numpy(val.spot, val.factors, F64, "cpu"))
    return inputs, arrays, reg, val, t_arrays, panels


def _assert_results_close(got, want):
    for key in want:
        w = np.asarray(want[key], dtype=np.float64)
        g = np.asarray(got[key], dtype=np.float64)
        assert g.shape == w.shape, key
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=key)
        mask = ~np.isnan(w)
        scale = max(1.0, float(np.abs(w[mask]).max())) if mask.any() else 1.0
        np.testing.assert_allclose(g[mask], w[mask], rtol=RTOL, atol=RTOL * scale, err_msg=key)


def _jax_generic_basis():
    from storage_tpu.basis import coerce_basis_functions

    return tuple(coerce_basis_functions(
        [jpkg.ONE, jpkg.S, jpkg.X0, jpkg.generic(lambda s, x: jnp.exp(-x[1]), num_factors=2)]))


def _torch_generic_basis():
    from storage_tpu_torch.basis import coerce_basis_functions

    return tuple(coerce_basis_functions(
        [tpkg.ONE, tpkg.S, tpkg.X0, tpkg.generic(lambda s, x: torch.exp(-x[1]), num_factors=2)]))


@pytest.mark.parametrize("e,basis", [(0, "monomial"), (1, "monomial"), (0, "generic")])
def test_lsmc_core_matches_jax_on_custom_rows(jax_panels, e, basis):
    inputs, arrays, reg, val, t_arrays, (t_reg, t_val) = jax_panels
    tfn = inputs.compiled.terminal_value
    j_basis = (tuple(jpkg.parse_basis_functions(BASIS)) if basis == "monomial"
               else _jax_generic_basis())
    t_basis = (tuple(parse_basis_functions(BASIS)) if basis == "monomial"
               else _torch_generic_basis())
    want = jax_lsmc.lsmc_core(
        arrays, reg.spot, reg.factors, val.spot, val.factors, jnp.asarray(100.0), j_basis, e,
        True, tfn, False, use_pallas=False, uniform_grids=False)
    got = torch_lsmc.lsmc_core(t_arrays, *t_reg, *t_val, 100.0, t_basis, e, True, tfn, False,
                               uniform_grids=False)
    assert set(got) == set(want)
    _assert_results_close({k: v.numpy() for k, v in got.items()}, want)
    # The evenly spaced placement on the same rows is another valuation.
    uniform = torch_lsmc.lsmc_core(t_arrays, *t_reg, *t_val, 100.0, t_basis, e, True, tfn, False)
    assert abs(float(uniform["npv"]) - float(got["npv"])) > 1e-6 * abs(float(got["npv"]))


def test_lsmc_forward_on_jax_regression_custom_rows(jax_panels):
    inputs, arrays, reg, val, t_arrays, (_, t_val) = jax_panels
    tfn = inputs.compiled.terminal_value
    monomials = tuple(jpkg.parse_basis_functions(BASIS))
    want = jax_lsmc.lsmc_core(
        arrays, reg.spot, reg.factors, val.spot, val.factors, jnp.asarray(100.0), monomials,
        0, False, tfn, False, use_pallas=False, return_regression=True, uniform_grids=False)
    regression = convert.regression_from_numpy(
        {k: np.asarray(want.pop(f"regression_{k}")) for k in ("mean", "std", "coeffs")}, F64,
        "cpu")
    want.pop("backward_npv")
    got = torch_lsmc.lsmc_forward(t_arrays, *t_val, regression, 100.0,
                                  tuple(parse_basis_functions(BASIS)), 0, False, tfn, False,
                                  uniform_grids=False)
    _assert_results_close({k: v.numpy() for k, v in got.items()}, want)


def test_fullstep_on_custom_rows(jax_panels):
    """Kernel E's route reads the same general tables as kernel B's: the
    same valuation, to the rounding of its solve (the tolerance of
    tests/test_torch_fullstep.py's f64 route check)."""
    inputs, _, _, _, t_arrays, (t_reg, t_val) = jax_panels
    args = (t_arrays, *t_reg, *t_val, 100.0, tuple(parse_basis_functions(BASIS)), 0, False,
            inputs.compiled.terminal_value, False)
    want = torch_lsmc.lsmc_core(*args, uniform_grids=False)
    got = torch_lsmc.lsmc_core(*args, uniform_grids=False, fullstep=True)
    for key in ("npv", "standard_error", "deltas", "profile_inventory", "backward_npv"):
        scale = float(want[key].abs().max())
        torch.testing.assert_close(got[key], want[key], rtol=1e-10, atol=1e-10 * scale)


# ---- the API against the JAX package.

def _storage(pkg):
    ratchets = [("2020-01-01", [(0.0, -300.0, 420.0), (2_000.0, -400.0, 300.0),
                                (5_000.0, -480.0, 200.0)])]
    return pkg.CmdtyStorage(
        "D", "2020-01-01", "2020-02-15", 0.6, 0.4, ratchets=ratchets,
        ratchet_interp=pkg.RatchetInterp.LINEAR, cmdty_consumed_inject=0.01,
        terminal_storage_npv=lambda price, inv: 0.9 * price * inv)


def _fwd():
    idx = pd.period_range("2020-01-01", "2020-02-15", freq="D")
    return pd.Series(index=idx, data=30.0 + 7.0 * np.sin(2 * np.pi * np.arange(len(idx)) / 46.0))


def dense_near_bottom(lo, hi):
    return lo + (hi - lo) * np.linspace(0.0, 1.0, 40) ** 2


def uneven_lengths(lo, hi):
    """Rows of 12 to 30 points by band width: padded to one width."""
    n = 12 + int(18 * (hi - lo) / 5_000.0)
    return lo + (hi - lo) * np.linspace(0.0, 1.0, n) ** 1.5


def _multi_factor(pkg, grid_calc, method="pathwise", **kwargs):
    dtype = dict(dtype=jnp.float64) if pkg is jpkg else dict(dtype=F64, device="cpu")
    return pkg.multi_factor_value(
        _storage(pkg), "2020-01-01", 800.0, _fwd(), 0.04, None,
        [(9.0, pd.Series(index=pd.period_range("2020-01-01", "2020-03-15", freq="D"), data=0.8))],
        None, 500, "1 + s + x0 + x0**2", True, seed=7, fwd_sim_seed=8,
        num_inventory_grid_points=40, grid_calc=grid_calc, deltas_method=method, **dtype,
        **kwargs)


@pytest.fixture(scope="module")
def dense_runs():
    return _multi_factor(jpkg, dense_near_bottom), _multi_factor(tpkg, dense_near_bottom)


@pytest.mark.parametrize("grid", ["dense-near-bottom", "uneven-lengths"])
def test_multi_factor_value_matches_jax(dense_runs, grid):
    if grid == "dense-near-bottom":
        want, got = dense_runs
    else:
        want, got = (_multi_factor(pkg, uneven_lengths) for pkg in (jpkg, tpkg))
    assert got.npv == pytest.approx(want.npv, rel=RTOL)
    assert got.val_sim_standard_error == pytest.approx(want.val_sim_standard_error, rel=RTOL)
    np.testing.assert_allclose(got.deltas, want.deltas, rtol=RTOL, atol=1e-7)
    pd.testing.assert_frame_equal(got.expected_profile, want.expected_profile, rtol=RTOL,
                                  atol=1e-7)
    pd.testing.assert_frame_equal(got.trigger_prices, want.trigger_prices, rtol=1e-7, atol=1e-7)
    # The intrinsic DP takes the same custom rows, by its general interpolation.
    assert got.intrinsic_npv == pytest.approx(want.intrinsic_npv, rel=1e-10)
    pd.testing.assert_frame_equal(got.intrinsic_profile, want.intrinsic_profile, rtol=0,
                                  atol=1e-6)


def test_evenly_spaced_rows_keep_the_default_bits():
    default = _multi_factor(tpkg, None)
    got = _multi_factor(tpkg, lambda lo, hi: np.linspace(lo, hi, 40))
    assert got.npv == default.npv and got.intrinsic_npv == default.intrinsic_npv
    pd.testing.assert_series_equal(got.deltas, default.deltas, check_exact=True)
    pd.testing.assert_frame_equal(got.expected_profile, default.expected_profile,
                                  check_exact=True)


def test_adjoint_on_custom_rows(dense_runs):
    """Adjoint deltas on the custom grid: the JAX package's within 1e-9, the
    pathwise run's for t < N; NPV, SE and profile the pathwise bits."""
    jax_pathwise, pathwise = dense_runs
    want = _multi_factor(jpkg, dense_near_bottom, "adjoint")
    got = _multi_factor(tpkg, dense_near_bottom, "adjoint")
    assert want.npv == pytest.approx(jax_pathwise.npv, rel=1e-12)
    np.testing.assert_allclose(got.deltas.to_numpy(), want.deltas.to_numpy(), rtol=RTOL,
                               atol=RTOL * np.abs(want.deltas.to_numpy()).max())
    assert got.npv == pathwise.npv
    assert got.val_sim_standard_error == pathwise.val_sim_standard_error
    pd.testing.assert_frame_equal(got.expected_profile, pathwise.expected_profile,
                                  check_exact=True)
    np.testing.assert_allclose(got.deltas.to_numpy()[:-1], pathwise.deltas.to_numpy()[:-1],
                               rtol=RTOL, atol=RTOL)


def test_interactive_custom_rows_give_the_uninterrupted_bits(dense_runs):
    _, uninterrupted = dense_runs
    progress = []
    got = _multi_factor(tpkg, dense_near_bottom, on_progress_update=progress.append)
    assert progress[-1] == 1.0 and len(progress) > 6
    assert got.npv == uninterrupted.npv
    pd.testing.assert_series_equal(got.deltas, uninterrupted.deltas, check_exact=True)
    pd.testing.assert_frame_equal(got.expected_profile, uninterrupted.expected_profile,
                                  check_exact=True)
