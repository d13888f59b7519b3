"""Kernel E past the register caps (16 basis terms, 8 factors): its wide route.

* E's plain version (``decision_update_fullstep_plain``) against the Pallas
  TPU kernel it replaces (``decision_update_fullstep_pallas``, interpret
  mode, ``pred_passes=1``) at 20 terms on 3 factors and 13 terms on 10
  factors, with the tolerances of tests/test_torch_fullstep.py (the Pallas
  kernel's in-register solver rounds differently and interpolates in bf16
  split passes, ~2⁻¹⁶ relative).
* ``lsmc_core(fullstep=True)`` in f64 on the CPU at both shapes against the
  JAX package's XLA ``lsmc_core`` on the same panels: E recovers the exact
  two-pass stats from its carried moments, so the two valuations agree to
  f64 rounding (``RTOL``, the tolerance of tests/test_torch_lsmc.py).
* The route, from shapes alone, before any simulation or launch: E's wide
  route past either cap (its register row up to 32 padded terms, its shared
  row beyond), its register route within both; spot-only panels, generic
  bases and a group of two still raise ``ValueError``; the wide bodies'
  sizing (``wide_reg_blocks``, ``wide_fixed_words``, ``wide_blocks_per_sm``)
  against its formula on both sides of each crossing.

The wide route itself runs on the card (tests/test_torch_cuda_kernels.py,
``chip_smoke.py``); on the CPU the wrapper takes the plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storage_tpu.basis import parse_basis_functions as jax_parse
from storage_tpu.engines import lsmc as jax_lsmc
from storage_tpu.models import multi_factor as jax_mf
from storage_tpu.models.spot_sim import simulate_ou_paths as jax_simulate
from storage_tpu.ops import decision_kernel as jdk
from storage_tpu.ops.interp import interp_weights as jax_interp_weights
from storage_tpu.parallel import mesh as jax_mesh
from storage_tpu_torch import convert
from storage_tpu_torch.basis import generic, parse_basis_functions
from storage_tpu_torch.engines import lsmc as torch_lsmc
from storage_tpu_torch.models import spot_sim
from storage_tpu_torch.ops import _build, decision_kernel, forward_kernel, rng_kernel

torch.set_num_threads(1)

RTOL = 1e-9  # f64: the same arithmetic up to summation order
# The full quadratic in the spot and the three factors (15 terms), the four
# cubes and s**4: 20 terms (chip_smoke.py's BASIS_20).
BASIS_20 = ("1 + s + x0 + x1 + x2 + s**2 + x0**2 + x1**2 + x2**2 + s*x0 + s*x1 + s*x2 + x0*x1 "
            "+ x0*x2 + x1*x2 + s**3 + x0**3 + x1**3 + x2**3 + s**4")
TEN = 10
BASIS_10F = "1 + s + s**2 + " + " + ".join(f"x{i}" for i in range(TEN))  # 13 terms
SHAPES = {"20-terms-3-factors": (BASIS_20, 3), "13-terms-10-factors": (BASIS_10F, TEN)}


def _kernel_case(basis, f, seed=3, g=12, s=256, d=3):
    """tests/test_torch_fullstep.py's case at another basis and factor
    count: carried raw moments of a previous design's u-columns against
    random values, v rounded to bf16 values (the TPU's hi/lo split of v is
    then exact)."""
    rng = np.random.default_rng(seed)
    b_dim = len(jax_parse(basis))
    u_prev = np.c_[np.ones(s), rng.normal(0.0, 1.0, (s, b_dim - 1))]
    vals = rng.normal(50.0, 10.0, (s, g))
    grid_next = np.linspace(0.0, 1000.0, g)
    idx_lo, w_hi = jax_interp_weights(jnp.asarray(grid_next, jnp.float32),
                                      jnp.asarray(rng.uniform(0.0, 1000.0, (g, d)), jnp.float32))
    case = dict(
        v=np.asarray(jnp.asarray(rng.normal(100.0, 30.0, (g, s)), jnp.float32)
                     .astype(jnp.bfloat16).astype(jnp.float32)),
        spot=rng.uniform(10.0, 50.0, s), factors=rng.normal(0.0, 1.0, (f, s)),
        spot_prev=rng.uniform(10.0, 50.0, s), factors_prev=rng.normal(0.0, 1.0, (f, s)),
        xtx=u_prev.T @ u_prev, xty=u_prev.T @ vals,
        cmean=np.r_[0.0, rng.normal(0.0, 0.2, b_dim - 1)],
        cstd=np.r_[1.0, rng.uniform(0.5, 2.0, b_dim - 1)],
        idx_lo=np.asarray(idx_lo), w_hi=np.asarray(jdk.snap_weights(w_hi)),
        a=rng.normal(0.0, 2.0, (d, g)), b=rng.normal(0.0, 20.0, (d, g)),
    )
    order = ("v", "spot", "factors", "spot_prev", "factors_prev", "xtx", "xty", "cmean", "cstd",
             "idx_lo", "w_hi", "a", "b")
    return [case[k] if k == "idx_lo" else np.asarray(case[k], np.float32) for k in order]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_matches_pallas_kernel_past_the_caps(shape):
    basis, f = SHAPES[shape]
    args = _kernel_case(basis, f)
    g = args[0].shape[0]
    j = [jnp.asarray(a) for a in args]
    w_mat = jdk.interp_weight_matrix(j[9], j[10], g, jnp.float32)
    want = jdk.decision_update_fullstep_pallas(
        *j[:9], w_mat, j[11], j[12], tuple(jax_parse(basis)), sim_tile=128, interpret=True,
        pred_passes=1,
    )
    t = [torch.tensor(a) for a in args]
    t[9] = t[9].to(torch.int32)
    before = decision_kernel.decision_update_fullstep.launches
    got = decision_kernel.decision_update_fullstep(*t, tuple(parse_basis_functions(basis)))
    assert decision_kernel.decision_update_fullstep.launches == before  # the plain version
    names = ("best_act", "xtx", "xty", "mean", "std", "coeffs")
    tols = ((2e-4, 1.0), (2e-4, 2e-2), (2e-3, 2.0), (1e-5, 1e-6), (1e-5, 1e-6), (2e-4, 2e-3))
    for name, gv, wv, (rtol, atol) in zip(names, got, want, tols):
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=rtol, atol=atol, err_msg=name)


STEPS = 20
GRID = 10
SIMS = 300


def _ten_factor_inputs(inputs):
    """The 10-factor model of tests/test_torch_caps.py on the case's days:
    mean reversions 0.5..9.5, falling vols, every pair correlated 0.3."""
    import pandas as pd

    idx = pd.period_range(inputs.periods[0], inputs.periods[-1], freq="D")
    factors = [(0.5 + i, pd.Series(0.6 / (1 + i), index=idx)) for i in range(TEN)]
    corrs = np.full((TEN, TEN), 0.3)
    np.fill_diagonal(corrs, 1.0)
    pre = jax_mf.simulation_precompute(factors, corrs, inputs.val_day, list(inputs.periods), "D")
    return jax_mesh.sim_inputs_from_precompute(pre, inputs.fwd, jnp.float64)


@pytest.fixture(scope="module")
def jax_cases():
    """The bench facility cut to 20 days on 10 grid points, with 300 paths a
    set simulated by the JAX package in f64: the 3-factor seasonal model
    and the 10-factor model."""
    from __graft_entry__ import _build_case

    inputs, arrays, sim_inputs, _ = _build_case(STEPS, GRID, SIMS, jnp.float64)
    t_arrays = convert.engine_arrays_from_numpy({k: np.asarray(v) for k, v in arrays.items()},
                                                torch.float64, "cpu")
    cases = {}
    for shape, sims in (("20-terms-3-factors", sim_inputs),
                        ("13-terms-10-factors", _ten_factor_inputs(inputs))):
        sim = [sims[k] for k in ("decay", "chol", "vols", "half_var", "fwd")]
        reg = jax_simulate(jax.random.key(11), jnp.arange(SIMS), *sim)
        val = jax_simulate(jax.random.key(13), jnp.arange(SIMS), *sim)
        panels = (convert.panels_from_numpy(reg.spot, reg.factors, torch.float64, "cpu"),
                  convert.panels_from_numpy(val.spot, val.factors, torch.float64, "cpu"))
        cases[shape] = (reg, val, panels)
    return inputs, arrays, t_arrays, cases


@pytest.mark.parametrize("shape", list(SHAPES))
def test_fullstep_engine_matches_jax_f64(jax_cases, shape):
    """The port's full-step valuation past the caps (E's plain version on the
    CPU, the wide route's function) against the JAX package's XLA valuation
    in f64 on the same panels, every output to ``RTOL``."""
    inputs, arrays, t_arrays, cases = jax_cases
    basis, _ = SHAPES[shape]
    reg, val, panels = cases[shape]
    tfn = inputs.compiled.terminal_value
    want = jax_lsmc.lsmc_core(arrays, reg.spot, reg.factors, val.spot, val.factors,
                              jnp.asarray(100.0), tuple(jax_parse(basis)), 1, True, tfn, False,
                              use_pallas=False)
    got = torch_lsmc.lsmc_core(t_arrays, *panels[0], *panels[1], 100.0,
                               tuple(parse_basis_functions(basis)), 1, True, tfn, False,
                               fullstep=True)
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w, dtype=np.float64)
        g = got[key].numpy().astype(np.float64)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=key)
        mask = ~np.isnan(w)
        scale = max(1.0, float(np.abs(w[mask]).max())) if mask.any() else 1.0
        np.testing.assert_allclose(g[mask], w[mask], rtol=RTOL, atol=RTOL * scale, err_msg=key)


def _basis(terms: int, factors: int):
    """A monomial basis of ``terms`` terms that reads all ``factors``
    factors: 1, s, each factor, then powers of the spot."""
    names = ["1", "s", *(f"x{i}" for i in range(factors))]
    names += [f"s**{k}" for k in range(2, 2 + terms - len(names))]
    monomials = tuple(parse_basis_functions(" + ".join(names)))
    assert len(monomials) == terms
    return monomials


def _launch_counts():
    return [fn.launches for fn in (
        rng_kernel.normal_halves, rng_kernel.simulate_sweep, decision_kernel.decision_update_moments,
        decision_kernel.decision_update, decision_kernel.decision_update_fullstep,
        forward_kernel.forward_sweep, forward_kernel.forward_sweep_design)]


class _Routed(Exception):
    """Raised where the route has been chosen, to stop the valuation there."""


def _streamed_fullstep(monkeypatch, monomials, factors, group=None):
    """``lsmc_core_streamed(fullstep=True)`` on a path set that is never
    materialised, with CUDA stood in (no card here), as
    tests/test_torch_caps.py's ``_route_on_cuda``: the body must be chosen
    from shapes before the first segment is simulated, and nothing must
    launch.  Returns the body chosen, or raises what the engine raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def no_sims(*args, **kwargs):
        raise AssertionError("simulated before the route was chosen")

    monkeypatch.setattr(torch_lsmc.spot_sim, "simulate_ou_segment", no_sims)
    bodies, real = [], torch_lsmc.fullstep_body

    def spy(*args):
        bodies.append(real(*args))
        raise _Routed

    monkeypatch.setattr(torch_lsmc, "fullstep_body", spy)
    n, s = 4, 8
    sim_inputs = dict(decay=torch.full((n + 1, factors), 0.9, dtype=torch.float64),
                      chol=torch.eye(factors, dtype=torch.float64).expand(n + 1, -1, -1) * 0.1,
                      vols=torch.ones((n + 1, factors), dtype=torch.float64),
                      half_var=torch.zeros(n + 1, dtype=torch.float64),
                      fwd=torch.full((n + 1,), 30.0, dtype=torch.float64))
    arrays = {"grids": torch.linspace(0.0, 100.0, 5, dtype=torch.float64).expand(n + 1, -1)}
    before = _launch_counts()
    try:
        with pytest.raises(_Routed):
            torch_lsmc.lsmc_core_streamed(
                arrays, sim_inputs, spot_sim.key_from_seed(11), spot_sim.key_from_seed(13),
                torch.arange(s), 0.0, monomials, 0, False, None, False, fullstep=True,
                group=group)
    finally:
        assert _launch_counts() == before
    return bodies


H100_SMEM = 232_448  # an H100's shared memory a block (opt-in)


@pytest.mark.parametrize("terms,factors,body", [
    (20, 3, "wide"), (17, 8, "wide"), (16, 9, "wide"), (13, 10, "wide"), (16, 8, "register"),
    (14, 12, "wide"), (29, 3, "wide"), (32, 12, "wide"), (33, 3, "wide-smem"),
    (64, 10, "wide-smem")])
def test_fullstep_route_by_shape(monkeypatch, terms, factors, body):
    """Kernel E's body from the basis size and the factor count alone: the
    wide route past 16 terms or 8 factors, on its register row while the
    basis padded to whole float4s is at most 32 terms and its shared row
    beyond, the register route within both, chosen before anything is
    simulated or launched; the wrapper's rule (``fullstep_route``) takes the
    same body at any grid."""
    monomials = _basis(terms, factors)
    assert _streamed_fullstep(monkeypatch, monomials, factors) == [body]
    assert decision_kernel.fullstep_body(terms, factors) == body
    for g in (100, 1_000):
        plan = decision_kernel.fullstep_route(g, 3, terms, H100_SMEM, num_factors=factors)
        assert (plan.body, plan.wide) == (body, body != "register")


@pytest.mark.parametrize("terms,route,body", [
    (9, "wide-large", "wide"), (9, "wide-smem-shared", "wide-smem"), (32, "wide-shared", "wide"),
    (33, "wide-large", None), (64, "wide-smem-large", "wide-smem"), (65, "wide-smem-large", None)])
def test_fullstep_forced_body(terms, route, body):
    """A route of ``WIDE_ROUTES`` forces its wide body at any shape the body
    takes, and its grid route; past the register row's 32 padded terms, or
    the shared row's 64, forcing raises ``ValueError``: no body stands in
    for another."""
    if body is None:
        with pytest.raises(ValueError, match="at most"):
            decision_kernel.fullstep_route(100, 3, terms, H100_SMEM, route=route, num_factors=3)
        return
    plan = decision_kernel.fullstep_route(100, 3, terms, H100_SMEM, route=route, num_factors=3)
    assert (plan.body, plan.name) == (body, route.rsplit("-", 1)[1])


@pytest.mark.parametrize("terms,factors", [(13, 10), (16, 9), (17, 3), (20, 3), (24, 12), (25, 3),
                                           (28, 3), (32, 12), (33, 3), (36, 12)])
def test_wide_sizing_matches_its_formula(terms, factors):
    """The wide bodies' Python sizing (the copy of csrc/decision_kernel.cu
    that the route reads) against its formula on both sides of each
    crossing: registers capped for 8 blocks per SM up to 16 padded terms and
    6 past them on the register row, 8 on the shared row; shared
    words of step t−1's design tile [B, 128] (the shared row also step t's
    rows [Bp, 128]) and the powers in whole words; blocks per SM the least
    of those the registers, the shared memory (each block's rounded up to
    128 bytes, 1 KB reserved a block) and the threads allow."""
    bp = -(-terms // 4) * 4
    body = decision_kernel.wide_body(terms)
    assert body == ("wide" if bp <= 32 else "wide-smem")
    regs = {"wide-smem": 8}.get(body, 8 if bp <= 16 else 6)
    assert decision_kernel.wide_reg_blocks(terms, body) == regs
    words = (terms + (bp if body == "wide-smem" else 0)) * 128 + -(-terms * (factors + 1) // 4)
    assert decision_kernel.wide_fixed_words(terms, factors, body) == words
    record = 4 + 2 * (4 + bp)  # D = 3
    for g in (decision_kernel.TILE_B, 100):
        smem = 4 * 8 * 128 + 4 * (words + g * record)
        want = min(regs, (H100_SMEM + 1024) // (-(-smem // 128) * 128 + 1024), 2048 // 128)
        assert decision_kernel.wide_blocks_per_sm(g, 3, terms, factors, H100_SMEM) == want
    fits = (H100_SMEM - 4 * 8 * 128) // 4 - words
    assert decision_kernel.wide_max_grid(3, terms, factors, H100_SMEM) == fits // record


@pytest.mark.parametrize("case", ["spot-only", "generic", "group-of-two", "65-terms"])
def test_fullstep_still_refused(monkeypatch, case):
    """Where the JAX package's kernel E never runs either (spot-only panels,
    a basis with a user callable), in a group of more than one rank, and
    past the wide route's 64 terms, the full step raises ``ValueError``
    before any simulation or launch."""
    monomials, factors, group = _basis(9, 3), 3, None
    if case == "spot-only":
        monomials, factors = tuple(parse_basis_functions("1 + s + s**2")), 0
    elif case == "generic":
        monomials = (*monomials, generic(lambda s, x: torch.exp(-x[0] ** 2), num_factors=1))
    elif case == "group-of-two":
        group = object()
        monkeypatch.setattr(torch_lsmc.preduce, "active", lambda g: g)
    else:
        monomials = _basis(_build.MAX_WIDE_BASIS + 1, 3)
    match = {"spot-only": "fullstep needs factor panels and a monomial basis",
             "generic": "fullstep needs factor panels and a monomial basis",
             "group-of-two": "fullstep runs on one device",
             "65-terms": "at most 64 basis functions"}[case]
    with pytest.raises(ValueError, match=match):
        _streamed_fullstep(monkeypatch, monomials, factors, group)
