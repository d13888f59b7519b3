"""Adjoint deltas of storage_tpu_torch against the JAX package, in f64 on the
CPU.

* The engine: ``lsmc_npv_and_ad_deltas`` on the JAX package's simulated f64
  panels (handed over as spot / forward, the stochastic part both packages
  take) against ``storage_tpu.engines.lsmc.lsmc_npv_and_ad_deltas``, with
  and without a terminal value, discounted or not, at E = 0 and 1: NPV and
  deltas within the engine tests' 1e-9.  The JAX package runs the backward
  again inside its differentiated function; the port differentiates the
  pricing run's own sweep, with the same regression payload.
* The forward sweep's VJP: ``forward_sweep_vjp_plain`` against
  ``torch.autograd`` through ``forward_sweep_plain`` with spot = fwd x a
  stochastic part, in the monomial, design and general-grid modes (the
  argmax carries no gradient, so the hand-written backward is the true
  VJP), also taken a segment at a time from each segment's own volume and
  fuel rows, as the engine's forward takes it.
* The API: ``multi_factor_value`` and ``value_from_sims`` (with factors and
  spot-only) with ``deltas_method="adjoint"`` against the JAX call, at 500
  sims (a count the conftest's 8 virtual devices do not divide, so the JAX
  side takes its single-device adjoint); NPV, SE and profile are the
  pathwise run's bits and the deltas equal the pathwise ones for t < N
  (tests/test_ad_deltas_api.py); a generic basis; an interactive run gives
  the uninterrupted run's deltas.
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
from storage_tpu_torch import convert
from storage_tpu_torch.basis import design_columns, parse_basis_functions
from storage_tpu_torch.engines import lsmc as torch_lsmc
from storage_tpu_torch.ops import forward_kernel

from _torch_sweep_case import sweep_case

torch.set_num_threads(1)

RTOL = 1e-9  # f64: the same arithmetic up to summation order
BASIS = "1 + x_st + x_lt + x_sw + x_st**2 + x_lt**2 + x_sw**2 + s + s**2"
F64 = torch.float64


@pytest.fixture(scope="module")
def jax_panels():
    """The bench facility cut to 20 days and 10 grid points, 512 JAX-simulated
    paths a set in f64."""
    from __graft_entry__ import _build_case

    inputs, arrays, sim_inputs, monomials = _build_case(20, 10, 512, jnp.float64)
    sim = [sim_inputs[k] for k in ("decay", "chol", "vols", "half_var", "fwd")]
    reg = jax_simulate(jax.random.key(11), jnp.arange(512), *sim)
    val = jax_simulate(jax.random.key(13), jnp.arange(512), *sim)
    return inputs, arrays, monomials, reg, val


@pytest.mark.parametrize("terminal,discount,e", [(True, True, 0), (True, False, 1),
                                                 (False, True, 1), (False, False, 0)],
                         ids=["terminal-discounted-E0", "terminal-undiscounted-E1",
                              "empty-discounted-E1", "empty-undiscounted-E0"])
def test_engine_matches_jax(jax_panels, terminal, discount, e):
    inputs, arrays, monomials, reg, val = jax_panels
    tfn = inputs.compiled.terminal_value if terminal else None
    fwd = arrays["fwd"][:, None]
    want_npv, want = jax_lsmc.lsmc_npv_and_ad_deltas(
        arrays, reg.spot / fwd, reg.factors, val.spot / fwd, val.factors, jnp.asarray(100.0),
        monomials, e, discount, tfn, False)
    t_arrays = convert.engine_arrays_from_numpy({k: np.asarray(v) for k, v in arrays.items()},
                                                F64, "cpu")
    stoch = lambda p: convert.panels_from_numpy(np.asarray(p.spot / fwd), p.factors, F64, "cpu")  # noqa: E731
    got_npv, got = torch_lsmc.lsmc_npv_and_ad_deltas(
        t_arrays, *stoch(reg), *stoch(val), 100.0, tuple(parse_basis_functions(BASIS)), e,
        discount, tfn, False)
    want = np.asarray(want)
    assert float(got_npv) == pytest.approx(float(want_npv), rel=RTOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    assert (want[-1] != 0) == terminal  # the terminal value's gradient, not discounted


def _sweep_inputs(mode):
    """``sweep_case``'s arguments with a positive curve [N] and the spot's
    stochastic part; ``kwargs`` select the design or general-grid mode."""
    case = sweep_case()
    n, s = case["spot"].shape
    rng = np.random.default_rng(3)
    fwd = torch.tensor(25.0 + 10.0 * rng.random(n), dtype=F64)
    stoch = case["spot"] / fwd[:, None]
    g = torch.tensor(rng.standard_normal(s), dtype=F64)
    kwargs = {}
    if mode == "general":
        p = case["params"]
        lo, hi = p[:, forward_kernel._P_GRID_LO], p[:, forward_kernel._P_GRID_HI]
        u = torch.linspace(0.0, 1.0, case["coeffs"].shape[2], dtype=F64) ** 1.3
        kwargs["grid"] = lo[:, None] + (hi - lo)[:, None] * u
    return case, fwd, stoch, g, kwargs


def _plain_sweep(case, spot, mode, kwargs, panels):
    design = None
    if mode == "design":
        design = torch.stack(design_columns(case["entries"], spot, case["factors"]), dim=1)
    return forward_kernel.forward_sweep_plain(
        case["params"], case["mean"], case["std"], case["ratchet_inv"], case["ratchet_min"],
        case["ratchet_max"], spot, case["factors"], case["inventory"], None, case["coeffs"],
        case["entries"], 0, False, panels=panels, design=design, **kwargs)


def _autograd_vjp(case, fwd, stoch, g, mode, kwargs):
    """d(g·pv)/d fwd by torch.autograd through the plain sweep with spot =
    fwd x stoch (the design too reads that spot), and the sweep's volume and
    fuel panels."""
    fwd = fwd.clone().requires_grad_()
    n, s = stoch.shape
    panels = [None, torch.empty((n, s), dtype=F64), torch.empty((n, s), dtype=F64), None]
    _, pv, _, _ = _plain_sweep(case, fwd[:, None] * stoch, mode, kwargs, panels)
    (grad,) = torch.autograd.grad((g * pv).sum(), fwd)
    return grad, panels[1].detach(), panels[2].detach()


@pytest.mark.parametrize("mode", ["monomial", "design", "general"])
def test_vjp_plain_is_autograds_vjp(mode):
    case, fwd, stoch, g, kwargs = _sweep_inputs(mode)
    want, dec, cons = _autograd_vjp(case, fwd, stoch, g, mode, kwargs)
    df_settle = case["params"][:, forward_kernel._P_DF_SETTLE]
    got = forward_kernel.forward_sweep_vjp_plain(dec, cons, fwd[:, None] * stoch, fwd, df_settle, g)
    assert want.abs().max() > 0
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * float(want.abs().max()))
    # On the CPU the wrapper is the plain version.
    assert torch.equal(forward_kernel.forward_sweep_vjp(dec, cons, fwd[:, None] * stoch, fwd,
                                                        df_settle, g), got)


@pytest.mark.parametrize("mode", ["monomial", "design", "general"])
def test_segment_vjps_are_autograds_vjp(mode):
    """The VJP taken a segment at a time, each from the volume and fuel rows
    its own launch of the sweep wrote (as the engine's forward takes it,
    ``lsmc_forward_rows``), is autograd's VJP of the whole sweep, and the
    sweep in segments keeps the one sweep's bits."""
    case, fwd, stoch, g, kwargs = _sweep_inputs(mode)
    want, _, _ = _autograd_vjp(case, fwd, stoch, g, mode, kwargs)
    spot = fwd[:, None] * stoch
    df_settle = case["params"][:, forward_kernel._P_DF_SETTLE]
    steps = ("params", "mean", "std", "ratchet_inv", "ratchet_min", "ratchet_max", "factors",
             "coeffs")
    got = torch.empty_like(fwd)

    def sweep_chunk(t0, t1, inventory, pv):
        sub = {**case, **{k: case[k][t0:t1] for k in steps}}
        dec, cons = (torch.empty((t1 - t0, spot.shape[1]), dtype=F64) for _ in range(2))
        design = None
        if mode == "design":
            design = torch.stack(design_columns(case["entries"], spot[t0:t1], sub["factors"]), dim=1)
        out = forward_kernel.forward_sweep_plain(
            sub["params"], sub["mean"], sub["std"], sub["ratchet_inv"], sub["ratchet_min"],
            sub["ratchet_max"], spot[t0:t1], sub["factors"], inventory, pv, sub["coeffs"],
            case["entries"], 0, False, panels=[None, dec, cons, None], design=design,
            **{k: v[t0:t1] for k, v in kwargs.items()})
        got[t0:t1] = forward_kernel.forward_sweep_vjp(dec, cons, spot[t0:t1], fwd[t0:t1],
                                                      df_settle[t0:t1], g)
        return out

    chunked = forward_kernel.sweep_in_chunks(spot.shape[0], 4, None, sweep_chunk,
                                             case["inventory"])
    for got_x, want_x in zip(chunked, _plain_sweep(case, spot, mode, kwargs, None)):
        assert torch.equal(got_x, want_x)
    assert want.abs().max() > 0
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * float(want.abs().max()))


# ---- the API against the JAX package: tests/test_ad_deltas_api.py's facility.

def _storage(pkg, terminal=False):
    ratchets = [("2020-01-01", [(0.0, -300.0, 420.0), (2_000.0, -400.0, 300.0),
                                (5_000.0, -480.0, 200.0)])]
    return pkg.CmdtyStorage(
        "D", "2020-01-01", "2020-02-15", 0.6, 0.4, ratchets=ratchets,
        ratchet_interp=pkg.RatchetInterp.LINEAR, cmdty_consumed_inject=0.01,
        terminal_storage_npv=(lambda price, inv: 0.9 * price * inv) if terminal else None)


def _fwd():
    idx = pd.period_range("2020-01-01", "2020-02-15", freq="D")
    return pd.Series(index=idx, data=30.0 + 7.0 * np.sin(2 * np.pi * np.arange(len(idx)) / 46.0))


VOL_IDX = pd.period_range("2020-01-01", "2020-03-15", freq="D")


def _multi_factor(pkg, method, basis="1 + s + x0 + x0**2", **kwargs):
    dtype = dict(dtype=jnp.float64) if pkg is jpkg else dict(dtype=F64, device="cpu")
    return pkg.multi_factor_value(
        _storage(pkg), "2020-01-01", 800.0, _fwd(), 0.04, None,
        [(9.0, pd.Series(index=VOL_IDX, data=0.8))], None, 500, basis, True, seed=7,
        fwd_sim_seed=8, num_inventory_grid_points=40, deltas_method=method, **dtype, **kwargs)


def _same_valuation(adjoint, pathwise):
    """NPV, SE and profile are the pathwise run's bits; the deltas agree for
    t < N."""
    assert adjoint.npv == pathwise.npv
    assert adjoint.val_sim_standard_error == pathwise.val_sim_standard_error
    pd.testing.assert_frame_equal(adjoint.expected_profile, pathwise.expected_profile,
                                  check_exact=True)
    np.testing.assert_allclose(adjoint.deltas.to_numpy()[:-1], pathwise.deltas.to_numpy()[:-1],
                               rtol=RTOL, atol=RTOL)


def _close_to_jax(got, want):
    assert got.npv == pytest.approx(want.npv, rel=RTOL)
    np.testing.assert_allclose(got.deltas.to_numpy(), want.deltas.to_numpy(), rtol=RTOL,
                               atol=RTOL * np.abs(want.deltas.to_numpy()).max())


@pytest.fixture(scope="module")
def multi_factor_runs():
    return (_multi_factor(jpkg, "adjoint"), _multi_factor(tpkg, "adjoint"),
            _multi_factor(tpkg, "pathwise"))


def test_multi_factor_value_adjoint_matches_jax(multi_factor_runs):
    want, got, pathwise = multi_factor_runs
    _close_to_jax(got, want)
    _same_valuation(got, pathwise)


def test_interactive_adjoint_gives_the_uninterrupted_deltas(multi_factor_runs):
    _, uninterrupted, _ = multi_factor_runs
    progress = []
    got = _multi_factor(tpkg, "adjoint", on_progress_update=progress.append,
                        cancellation_poll=lambda: False)
    assert progress[-1] == 1.0 and len(progress) > 6
    assert got.npv == uninterrupted.npv
    pd.testing.assert_series_equal(got.deltas, uninterrupted.deltas, check_exact=True)


def test_generic_basis_adjoint_matches_jax():
    def basis(pkg):
        xp = jnp if pkg is jpkg else torch
        return [pkg.ONE, pkg.S, pkg.generic(lambda s, x: x[0], num_factors=1),
                pkg.generic(lambda s, x: xp.exp(x[0]), num_factors=1)]

    want = _multi_factor(jpkg, "adjoint", basis=basis(jpkg))
    got = _multi_factor(tpkg, "adjoint", basis=basis(tpkg))
    _close_to_jax(got, want)
    _same_valuation(got, _multi_factor(tpkg, "pathwise", basis=basis(tpkg)))


@pytest.fixture(scope="module")
def frames():
    """Regression and valuation panels (spot, one factor) from a port run."""
    res = _multi_factor(tpkg, "pathwise", sim_data_returned=tpkg.SimulationDataReturned.ALL)
    return (res.sim_spot_regress, res.sim_spot_valuation, list(res.sim_factors_regress),
            list(res.sim_factors_valuation))


@pytest.mark.parametrize("factors", [True, False], ids=["with-factors", "spot-only"])
def test_value_from_sims_adjoint_matches_jax(frames, factors):
    """``value_from_sims`` with a terminal value: the deltas' last entry is the
    terminal gradient.  Spot-only panels take kernel D backward and kernel C
    with no factor forward."""
    spot_reg, spot_val, fac_reg, fac_val = frames
    basis = "1 + s + x0 + x0**2" if factors else "1 + s + s**2"
    extra = dict(sim_factors_regress=fac_reg, sim_factors_valuation=fac_val) if factors else {}

    def value(pkg, method):
        dtype = dict(dtype=jnp.float64) if pkg is jpkg else dict(dtype=F64, device="cpu")
        return pkg.value_from_sims(
            _storage(pkg, terminal=True), "2020-01-01", 800.0, _fwd(), 0.04, None, spot_reg,
            spot_val, basis, False, num_inventory_grid_points=40, deltas_method=method,
            **extra, **dtype)

    want = value(jpkg, "adjoint")
    got = value(tpkg, "adjoint")
    _close_to_jax(got, want)
    _same_valuation(got, value(tpkg, "pathwise"))
    assert got.deltas.iloc[-1] != 0.0
