"""Kernel E's plain version (``decision_update_fullstep_plain``) against the
Pallas TPU kernel it replaces (``decision_update_fullstep_pallas``, interpret
mode, ``pred_passes=1``), and against the regression the engine's kernel-B
path runs (exact two-pass stats, ``fit_continuation``) followed by B's plain
version, in f64.

Tolerances against the Pallas kernel are those of the JAX package's own
test of it (tests/test_decision_kernel.py): its in-register solver rounds
differently, and it interpolates the coefficients and the values in bf16
split passes (~2⁻¹⁶ relative).  In f64 the two routes to the same regression
agree to rounding (1e-10).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storage_tpu.basis import parse_basis_functions as jax_parse
from storage_tpu.ops import decision_kernel as jdk
from storage_tpu.ops.interp import interp_weights as jax_interp_weights
from storage_tpu_torch.basis import design_matrix, parse_basis_functions
from storage_tpu_torch.ops import decision_kernel as tdk
from storage_tpu_torch.ops.interp import interp_coeffs
from storage_tpu_torch.ops.regression import column_stats, fit_continuation

torch.set_num_threads(1)

BASIS = "1 + s + x0 + x1 + x0*x1"


def _case(seed=3, g=12, s=256, d=3, f=2, dtype=np.float32):
    """The JAX package's fullstep test case: carried raw moments of a
    previous design's u-columns against random values."""
    rng = np.random.default_rng(seed)
    b_dim = len(jax_parse(BASIS))
    u_prev = np.c_[np.ones(s), rng.normal(0.0, 1.0, (s, b_dim - 1))]
    vals = rng.normal(50.0, 10.0, (s, g))
    grid_next = np.linspace(0.0, 1000.0, g)
    idx_lo, w_hi = jax_interp_weights(jnp.asarray(grid_next, jnp.float32),
                                      jnp.asarray(rng.uniform(0.0, 1000.0, (g, d)), jnp.float32))
    case = dict(
        # v rounded to bf16 values: the TPU's hi/lo split of v is then exact.
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
    return {k: (v if k == "idx_lo" else np.asarray(v, dtype)) for k, v in case.items()}


def _order(c):
    return [c[k] for k in ("v", "spot", "factors", "spot_prev", "factors_prev", "xtx", "xty",
                           "cmean", "cstd", "idx_lo", "w_hi", "a", "b")]


def _torch(c):
    args = [torch.tensor(a) for a in _order(c)]
    args[9] = args[9].to(torch.int32)
    return args + [tuple(parse_basis_functions(BASIS))]


def test_plain_matches_pallas_kernel():
    c = _case()
    g = c["v"].shape[0]
    w_mat = jdk.interp_weight_matrix(jnp.asarray(c["idx_lo"]), jnp.asarray(c["w_hi"]), g,
                                     jnp.float32)
    j = [jnp.asarray(a) for a in _order(c)]
    want = jdk.decision_update_fullstep_pallas(
        *j[:9], w_mat, j[11], j[12], tuple(jax_parse(BASIS)), sim_tile=128, interpret=True,
        pred_passes=1,
    )
    got = tdk.decision_update_fullstep(*_torch(c))
    assert tdk.decision_update_fullstep.launches == 0  # CPU tensors take the plain version
    names = ("best_act", "xtx", "xty", "mean", "std", "coeffs")
    tols = ((2e-4, 1.0), (2e-4, 2e-2), (2e-3, 2.0), (1e-5, 1e-6), (1e-5, 1e-6), (2e-4, 2e-3))
    for name, gv, wv, (rtol, atol) in zip(names, got, want, tols):
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("prev", [False, True], ids=["u-coordinates", "given-stats"])
def test_plain_matches_exact_stats_route_f64(prev):
    """Moments of step t's design centred by rough stats (cmean, cstd): E
    recovers the exact two-pass stats and the regression that the kernel-B
    path fits on exactly standardised columns."""
    c = _case(5, dtype=np.float64)
    monomials = tuple(parse_basis_functions(BASIS))
    t = {k: torch.tensor(v) for k, v in c.items()}
    x = design_matrix(monomials, t["spot"], t["factors"])  # [S, B]
    u = (x - t["cmean"]) / t["cstd"]
    y = t["v"].T * 0.8 + 5.0
    xtx, xty = u.T @ u, u.T @ y
    args = _torch(c)
    args[5], args[6] = xtx, xty
    prev_stats = dict(mean_prev=t["cmean"] * 0.5, std_prev=t["cstd"] * 2.0) if prev else {}
    got = tdk.decision_update_fullstep(*args, **prev_stats)

    mean, std = column_stats(x)
    coeffs = fit_continuation((x - mean) / std, y)
    ci = interp_coeffs(coeffs, args[9], args[10])
    want = tdk.decision_update_moments_plain(
        t["v"], t["spot"], t["factors"], t["spot_prev"], t["factors_prev"], mean, std,
        prev_stats.get("mean_prev", mean), prev_stats.get("std_prev", std), args[9], args[10],
        ci, t["a"], t["b"], monomials,
    )
    for name, gv, wv in zip(("best_act", "xtx", "xty", "mean", "std", "coeffs"), got,
                            (*want, mean, std, coeffs)):
        scale = float(wv.abs().max())
        np.testing.assert_allclose(gv.numpy(), wv.numpy(), rtol=1e-10, atol=1e-10 * scale,
                                   err_msg=name)


def test_regression_out_buffers():
    """The payload rows the engine hands in are filled in place."""
    c = _case(7, dtype=np.float64)
    args = _torch(c)
    b_dim, g = len(args[-1]), c["v"].shape[0]
    bufs = (torch.empty(b_dim, dtype=torch.float64), torch.empty(b_dim, dtype=torch.float64),
            torch.empty((b_dim, g), dtype=torch.float64))
    out = torch.empty_like(args[0])
    got = tdk.decision_update_fullstep(*args, out=out, regression_out=bufs)
    want = tdk.decision_update_fullstep_plain(*args)
    assert got[0] is out and all(a is b for a, b in zip(got[3:], bufs))
    for gv, wv in zip(got, want):
        np.testing.assert_array_equal(gv.numpy(), wv.numpy())
