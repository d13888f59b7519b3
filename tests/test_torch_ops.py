"""The tensor ops of storage_tpu_torch against the JAX package, in f64 on the
same numpy inputs: design matrix, regression, ratchet lookup, bang-bang
decision sets and uniform-grid interpolation.  Unless a test says otherwise
the arithmetic is the same op for op, so the tolerance is f64 rounding."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storage_tpu import grid as jgrid
from storage_tpu.basis import design_matrix as jax_design_matrix
from storage_tpu.basis import parse_basis_functions as jax_parse
from storage_tpu.ops import interp as jinterp
from storage_tpu.ops import regression as jreg
from storage_tpu_torch import grid as tgrid
from storage_tpu_torch.basis import design_matrix, parse_basis_functions
from storage_tpu_torch.ops import interp as tinterp
from storage_tpu_torch.ops import regression as treg

torch.set_num_threads(1)

RTOL = 1e-12
BASIS = "1 + x_st + x_lt + x_sw + x_st**2 + x_lt**2 + x_sw**2 + s + s**2 + s*x0**3"


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _design(seed=0, s=300):
    rng = np.random.default_rng(seed)
    spot = rng.uniform(20.0, 40.0, s)
    factors = rng.normal(0.0, 0.3, (3, s))
    return spot, factors


def test_parse_and_design_matrix():
    assert parse_basis_functions(BASIS) == [tuple(m) for m in jax_parse(BASIS)]
    spot, factors = _design()
    want = jax_design_matrix(tuple(jax_parse(BASIS)), jnp.asarray(spot), jnp.asarray(factors))
    got = design_matrix(tuple(parse_basis_functions(BASIS)), _t(spot), _t(factors))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_design_matrix_batched_over_steps():
    spot = np.stack([_design(i)[0] for i in range(4)])
    factors = np.stack([_design(i)[1] for i in range(4)])
    monomials = tuple(parse_basis_functions(BASIS))
    batched = design_matrix(monomials, _t(spot), _t(factors))
    for i in range(4):
        np.testing.assert_array_equal(
            batched[i].numpy(), design_matrix(monomials, _t(spot[i]), _t(factors[i])).numpy()
        )


def test_column_stats():
    spot, factors = _design(1)
    dm = np.array(jax_design_matrix(tuple(jax_parse(BASIS)), jnp.asarray(spot), jnp.asarray(factors)))
    dm[:, 3] = 7.0  # a constant column keeps std 1
    want = jreg.column_stats(jnp.asarray(dm))
    got = treg.column_stats(_t(dm))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-15)
    assert float(got[1][3]) == 1.0 and float(got[0][0]) == 0.0


def _moments(seed=2, s=400, g=7):
    spot, factors = _design(seed, s)
    dm = np.array(jax_design_matrix(tuple(jax_parse(BASIS)), jnp.asarray(spot), jnp.asarray(factors)))
    y = np.random.default_rng(seed).normal(100.0, 10.0, (s, g))
    return dm.T @ dm, dm.T @ y


def test_standardise_moments():
    xtx, xty = _moments()
    want = jreg.standardise_moments(jnp.asarray(xtx), jnp.asarray(xty))
    got = treg.standardise_moments(_t(xtx), _t(xty))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("case", ["regular", "collinear", "indefinite"])
def test_fit_from_moments(case):
    xtx, xty = _moments()
    m, rhs, _, _ = jreg.standardise_moments(jnp.asarray(xtx), jnp.asarray(xty))
    m, rhs = np.array(m), np.array(rhs)
    if case == "collinear":  # a duplicated column: only the ridge keeps it solvable
        m[:, 2] = m[:, 1]
        m[2, :] = m[1, :]
    elif case == "indefinite":  # the factorisation fails: constant-column fallback
        m[4, 4] = -m[4, 4]
    want = np.asarray(jreg.fit_from_moments(jnp.asarray(m), jnp.asarray(rhs)))
    got = treg.fit_from_moments(_t(m), _t(rhs)).numpy()
    assert np.isfinite(got).all()
    if case == "indefinite":
        np.testing.assert_array_equal(got[1:], 0.0)
    # The collinear system is conditioned by its 1e-7 ridge: ~1e7 amplification.
    np.testing.assert_allclose(got, want, rtol=1e-6 if case == "collinear" else 1e-9, atol=1e-9)


@pytest.mark.parametrize("case", ["regular", "collinear"])
def test_fit_continuation(case):
    """Normal equations of a materialised standardised design, then the
    solve; exactly collinear columns with no ridge take the fallback (the
    JAX package's own singular case)."""
    rng = np.random.default_rng(3)
    s, g = 64, 4
    if case == "collinear":  # tests/test_decision_kernel.py:153-169
        col = rng.normal(0.0, 1.0, s)
        x, ridge = np.stack([np.ones(s), col, col], axis=1), 0.0
    y = rng.normal(50.0, 10.0, (s, g))
    if case != "collinear":
        spot, factors = _design(3, s)
        dm = np.asarray(jax_design_matrix(tuple(jax_parse(BASIS)), jnp.asarray(spot),
                                          jnp.asarray(factors)))
        mean, std = (np.asarray(a) for a in jreg.column_stats(jnp.asarray(dm)))
        x, ridge = (dm - mean) / std, None
    want = np.asarray(jreg.fit_continuation(jnp.asarray(x), jnp.asarray(y), ridge=ridge))
    got = treg.fit_continuation(_t(x), _t(y), ridge=ridge).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    if case == "collinear":
        np.testing.assert_allclose(got[0], y.mean(axis=0), rtol=1e-12)
        np.testing.assert_array_equal(got[1:], 0.0)


def _ratchet():
    return (np.array([0.0, 2500.0, 5000.0]), np.array([-200.0, -250.0, -300.0]),
            np.array([300.0, 250.0, 200.0]))


@pytest.mark.parametrize("is_step", [False, True])
def test_ratchet_rates(is_step):
    inv_t, mn, mx = _ratchet()
    inventory = np.r_[np.linspace(-100.0, 5100.0, 97), 0.0, 2500.0, 5000.0]
    want = jgrid.ratchet_rates(jnp.asarray(inv_t), jnp.asarray(mn), jnp.asarray(mx), is_step,
                               jnp.asarray(inventory))
    got = tgrid.ratchet_rates(_t(inv_t), _t(mn), _t(mx), is_step, _t(inventory))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)
    # A table per step [N, 1, R] looked up at a grid per step [N, G].
    tables = [_t(np.stack([a, a * 1.1])[:, None, :]) for a in _ratchet()]
    grid = _t(np.stack([inventory, inventory[::-1]]))
    batched = tgrid.ratchet_rates(*tables, is_step, grid)
    for n in range(2):
        one = tgrid.ratchet_rates(*(t[n, 0] for t in tables), is_step, grid[n])
        for b, o in zip(batched, one):
            np.testing.assert_array_equal(b[n].numpy(), o.numpy())


@pytest.mark.parametrize("extra", [0, 1])
def test_bang_bang_decisions(extra):
    rng = np.random.default_rng(4)
    inventory = rng.uniform(0.0, 5000.0, 200)
    min_rate = rng.uniform(-300.0, -50.0, 200)
    max_rate = rng.uniform(50.0, 300.0, 200)
    for next_min, next_max in ((0.0, 5000.0), (1000.0, 1200.0), (4000.0, 4000.0)):
        want = jgrid.bang_bang_decisions(
            jnp.asarray(min_rate), jnp.asarray(max_rate), jnp.asarray(inventory), 0.01,
            next_min, next_max, extra,
        )
        got = tgrid.bang_bang_decisions(
            _t(min_rate), _t(max_rate), _t(inventory), 0.01, next_min, next_max, extra
        )
        assert got.shape == (200, 2 * extra + 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("degenerate", [False, True])
def test_uniform_interp(degenerate):
    rng = np.random.default_rng(5)
    grid = np.full(11, 300.0) if degenerate else np.linspace(100.0, 1100.0, 11)
    x = np.r_[rng.uniform(0.0, 1200.0, 50), 100.0, 1100.0, 600.0]
    values = rng.normal(0.0, 50.0, 11)
    rows = rng.normal(0.0, 50.0, (53, 11))
    xq = rng.uniform(0.0, 1200.0, (53, 3))
    jg = jnp.asarray(grid)
    np.testing.assert_allclose(tinterp.grid_positions(_t(grid), _t(x)).numpy(),
                               np.asarray(jinterp.grid_positions(jg, jnp.asarray(x))), rtol=RTOL)
    idx, w = tinterp.interp_weights(_t(grid), _t(x))
    jidx, jw = jinterp.interp_weights(jg, jnp.asarray(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=RTOL, atol=1e-15)
    np.testing.assert_allclose(
        tinterp.interp_vector(_t(grid), _t(values), _t(x)).numpy(),
        np.asarray(jinterp.interp_vector(jg, jnp.asarray(values), jnp.asarray(x))), rtol=RTOL,
    )
    # interp_per_sim: a two-node gather here, a hat contraction in JAX.
    np.testing.assert_allclose(
        tinterp.interp_per_sim(_t(grid), _t(rows), _t(xq)).numpy(),
        np.asarray(jinterp.interp_per_sim(jg, jnp.asarray(rows), jnp.asarray(xq))),
        rtol=1e-11, atol=1e-11,
    )
    # Batched grids [N, G] against queries [N, K] equal the per-row calls.
    grids = np.stack([grid, grid * 2.0])
    vals = np.stack([values, -values])
    xs = np.stack([x, x * 2.0])
    batched = tinterp.interp_vector(_t(grids), _t(vals), _t(xs))
    for n in range(2):
        np.testing.assert_array_equal(
            batched[n].numpy(), tinterp.interp_vector(_t(grids[n]), _t(vals[n]), _t(xs[n])).numpy()
        )
