"""Bases beyond 16 terms and models beyond 8 factors in storage_tpu_torch,
against the JAX package, which has no such cap.

The kernels that build a monomial design on the card (B, E and C's monomial
mode) take their register routes within 16 terms on 8 factors
(``csrc/common.cuh``) and their wide routes past either, up to 64 terms on
any factor count, as the JAX package's fused kernels take any monomial
basis.  Only a basis with a user callable, or of more than 64 terms, takes
the design-in-memory route (kernel D backward, kernel C's design mode
forward); the route is chosen from the shapes alone before anything is
simulated (``engines.lsmc.design_in_memory``), on either device.  Each entry
point is valued here on the CPU in f64 beside the JAX package on the same
inputs (NPV, SE, deltas and profiles at the ``RTOL`` of
``test_torch_lsmc.py``: both regress each step on exactly standardised
columns and run the same argmax), and called with CUDA stood in, where the
route must be chosen before any simulation, panel copy or launch.
"""
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import storage_tpu as jpkg
import storage_tpu_torch as tpkg
from storage_tpu_torch.basis import generic, parse_basis_functions
from storage_tpu_torch.engines import lsmc as torch_lsmc
from storage_tpu_torch.ops import _build, decision_kernel, forward_kernel, rng_kernel

torch.set_num_threads(1)

RTOL = 1e-9  # f64: the same arithmetic up to summation order
SIMS = 256
GRID = 10
BASIS_9 = "1 + x_st + x_lt + x_sw + x_st**2 + x_lt**2 + x_sw**2 + s + s**2"  # the headline's
# The full quadratic in the spot and the three factors (15 terms), the four
# cubes and s**4: 20 terms.
BASIS_20 = ("1 + s + x_st + x_lt + x_sw + s**2 + x_st**2 + x_lt**2 + x_sw**2 + s*x_st + s*x_lt "
            "+ s*x_sw + x_st*x_lt + x_st*x_sw + x_lt*x_sw + s**3 + x_st**3 + x_lt**3 + x_sw**3 "
            "+ s**4")
TEN = 10
BASIS_10F = "1 + s + s**2 + " + " + ".join(f"x{i}" for i in range(TEN))  # 13 terms
SIM_DATA = "SPOT_ALL", "FACTORS_ALL"


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


def _ten_factors(fwd):
    """Ten factors, mean reversions 0.5..9.5 and falling vols, correlated 0.3
    pairwise: the Cholesky product mixes all ten."""
    factors = [(0.5 + i, pd.Series(0.6 / (1 + i), index=fwd.index)) for i in range(TEN)]
    corrs = np.full((TEN, TEN), 0.3)
    np.fill_diagonal(corrs, 1.0)
    return factors, corrs


def _sim_data(pkg):
    flags = pkg.SimulationDataReturned
    return getattr(flags, SIM_DATA[0]) | getattr(flags, SIM_DATA[1])


def _three_factor(pkg, basis, **kwargs):
    storage, start, fwd = _case(pkg)
    return pkg.three_factor_seasonal_value(
        storage, start, 100.0, fwd, 0.02, None, 14.5, 1.1, 0.19, 0.23, SIMS, basis, True,
        seed=11, fwd_sim_seed=13, extra_decisions=1, num_inventory_grid_points=GRID, **kwargs)


def _multi_factor(pkg, **kwargs):
    storage, start, fwd = _case(pkg)
    factors, corrs = _ten_factors(fwd)
    return pkg.multi_factor_value(
        storage, start, 100.0, fwd, 0.02, None, factors, corrs, SIMS, BASIS_10F, True,
        seed=11, fwd_sim_seed=13, extra_decisions=1, num_inventory_grid_points=GRID, **kwargs)


def _from_sims(pkg, frames, basis, **kwargs):
    storage, start, fwd = _case(pkg)
    return pkg.value_from_sims(
        storage, start, 100.0, fwd, 0.02, None, frames.sim_spot_regress,
        frames.sim_spot_valuation, basis, True, sim_factors_regress=frames.sim_factors_regress,
        sim_factors_valuation=frames.sim_factors_valuation, extra_decisions=1,
        num_inventory_grid_points=GRID, **kwargs)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's 3-factor and 10-factor valuations in f64, with their
    path panels as DataFrames (the frames ``value_from_sims`` takes)."""
    return {
        "three-factor": _three_factor(jpkg, BASIS_20, dtype=jnp.float64,
                                      sim_data_returned=_sim_data(jpkg)),
        "multi-factor": _multi_factor(jpkg, dtype=jnp.float64, sim_data_returned=_sim_data(jpkg)),
    }


# entry: (the JAX run whose frames it reads, or that it is, the port's call
# on a device, the terms and factors of its basis)
CASES = {
    "three-factor-20-terms": ("three-factor", lambda frames, **kw: _three_factor(tpkg, BASIS_20, **kw),
                              20, 3),
    "multi-factor-10-factors": ("multi-factor", lambda frames, **kw: _multi_factor(tpkg, **kw),
                                13, TEN),
    "value-from-sims-20-terms": ("three-factor",
                                 lambda frames, **kw: _from_sims(tpkg, frames, BASIS_20, **kw), 20, 3),
    "value-from-sims-10-factors": ("multi-factor",
                                   lambda frames, **kw: _from_sims(tpkg, frames, BASIS_10F, **kw),
                                   13, TEN),
}


def _assert_valuations_close(got, want):
    assert got.npv == pytest.approx(want.npv, rel=RTOL)
    assert got.val_sim_standard_error == pytest.approx(want.val_sim_standard_error, rel=RTOL)
    pd.testing.assert_index_equal(got.deltas.index, want.deltas.index)
    np.testing.assert_allclose(got.deltas, want.deltas, rtol=RTOL, atol=1e-7)
    pd.testing.assert_frame_equal(got.expected_profile, want.expected_profile, rtol=RTOL, atol=1e-7)


def _launch_counts():
    return [fn.launches for fn in (
        rng_kernel.normal_halves, rng_kernel.simulate_sweep, decision_kernel.decision_update_moments,
        decision_kernel.decision_update, decision_kernel.decision_update_fullstep,
        forward_kernel.forward_sweep, forward_kernel.forward_sweep_design)]


class _Routed(Exception):
    """Raised where the route has been chosen, to stop the valuation there."""


def _route_on_cuda(monkeypatch, call) -> list:
    """Calls ``call(device="cuda")`` with CUDA stood in (no card here): the
    route must be chosen, from shapes alone, before any simulation or panel
    copy, and nothing must launch.  Returns the routes chosen, (terms,
    factors, design in memory) each."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def no_sims(*args, **kwargs):
        raise AssertionError("simulated before the route was chosen")

    monkeypatch.setattr(tpkg.api_lsmc.spot_sim, "simulate_ou_paths", no_sims)
    monkeypatch.setattr(tpkg.api_lsmc, "_frames_to_sims", no_sims)
    routes, real = [], torch_lsmc.design_in_memory

    def spy(monomials, num_factors):
        routes.append((len(monomials), num_factors, real(monomials, num_factors)))
        raise _Routed

    monkeypatch.setattr(torch_lsmc, "design_in_memory", spy)
    before = _launch_counts()
    with pytest.raises(_Routed):
        call(device="cuda")
    assert _launch_counts() == before
    return routes


@pytest.mark.parametrize("entry", list(CASES))
def test_beyond_the_monomial_caps_matches_jax(jax_runs, monkeypatch, entry):
    """The entry point values the shape on the CPU as the JAX package does,
    and on CUDA routes it to kernels B and C's monomial mode (their wide
    routes) before anything runs."""
    source, call, terms, factors = CASES[entry]
    want = jax_runs[source]
    if entry.startswith("value-from-sims"):
        want = _from_sims(jpkg, want, BASIS_20 if terms == 20 else BASIS_10F, dtype=jnp.float64)
    got = call(jax_runs[source], dtype=torch.float64, device="cpu")
    _assert_valuations_close(got, want)
    assert _route_on_cuda(monkeypatch, lambda **kw: call(jax_runs[source], **kw)) == [
        (terms, factors, False)]


def test_headline_basis_keeps_the_monomial_route(monkeypatch):
    """The headline's nine terms on three factors keep kernels B and C's
    monomial mode."""
    routes = _route_on_cuda(monkeypatch, lambda **kw: _three_factor(tpkg, BASIS_9, **kw))
    assert routes == [(9, 3, False)]


BASIS_16 = BASIS_9 + " + s**3 + s**4 + s*x0 + s*x1 + s*x2 + x0*x1 + x0*x2"


def _spot_powers(terms: int) -> str:
    """A monomial basis of ``terms`` terms: 1, s, then the spot's powers."""
    return " + ".join(["1", "s", *(f"s**{k}" for k in range(2, terms))])


@pytest.mark.parametrize("basis,factors,expected", [
    ("1 + s", 0, False), (BASIS_9, 3, False), (BASIS_16, 3, False), (BASIS_20, 3, False),
    (BASIS_10F, 8, False), (BASIS_10F, 9, False), (BASIS_10F, TEN, False),
    (_spot_powers(64), 3, False), (_spot_powers(65), 3, True), ("generic", 3, True)],
    ids=["spot-2", "headline", "16-terms", "20-terms", "8-factors", "9-factors", "10-factors",
         "64-terms", "65-terms", "generic"])
def test_route_by_shape(basis, factors, expected):
    """The route is the basis's alone, at any factor count: a basis with a
    user callable, or of more than the wide routes' 64 terms, builds the
    design in memory; every other monomial basis runs kernels B and C's
    monomial mode."""
    if basis == "generic":
        monomials = (*parse_basis_functions("1 + s"),
                     generic(lambda s, x: torch.exp(-x[0] ** 2), num_factors=1))
    else:
        monomials = tuple(parse_basis_functions(basis))
    assert _build.MAX_BASIS == 16 and _build.MAX_FACTORS == 8 and _build.MAX_WIDE_BASIS == 64
    assert torch_lsmc.design_in_memory(monomials, factors) is expected
