"""Kernel D's plain version (``decision_update_plain``) against the Pallas TPU
kernel it replaces (``decision_update_pallas``), run in interpret mode with
``pred_passes=1`` (the exact-f32 regressed gap), also at 17 and 20 basis
functions (past the 16 of the monomial kernels: D takes any basis), and
against the exact formula of the JAX engine's plain backward body in f64.

Tolerance against the Pallas kernel: the TPU kernel interpolates ``v`` as two
bf16 matmuls over a hi/lo split of ``v``, which keeps about 16 bits — 2⁻¹⁵
of max|v| bounds it.  The regressed gaps are computed op for op alike, so the
argmax picks the same decisions and no flip allowance is needed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storage_tpu.ops import decision_kernel as jdk
from storage_tpu.ops.interp import interp_weights as jax_interp_weights
from storage_tpu_torch.ops import decision_kernel as tdk

torch.set_num_threads(1)


def _case(seed, g, s, d, b_dim, dtype=np.float32):
    rng = np.random.default_rng(seed)
    grid_next = np.linspace(0.0, 1000.0, g)
    targets = rng.uniform(-50.0, 1050.0, (g, d))
    idx_lo, w_hi = jax_interp_weights(jnp.asarray(grid_next), jnp.asarray(targets))
    w_hi = jdk.snap_weights(w_hi)  # the Pallas kernel snaps its hat weights
    case = dict(
        v=rng.normal(100.0, 30.0, (g, s)) + grid_next[:, None],
        dm_std_t=np.r_[np.ones((1, s)), rng.normal(0.0, 1.0, (b_dim - 1, s))],
        spot=rng.uniform(10.0, 50.0, s),
        idx_lo=np.asarray(idx_lo), w_hi=np.asarray(w_hi),
        ci=rng.normal(0.0, 20.0, (d, g, b_dim)),
        a=rng.normal(0.0, 2.0, (d, g)), b=rng.normal(0.0, 20.0, (d, g)),
    )
    return {k: (v if k == "idx_lo" else v.astype(dtype)) for k, v in case.items()}


def _torch_args(c):
    t = {k: torch.tensor(v) for k, v in c.items()}
    return (t["v"], t["dm_std_t"], t["spot"], t["idx_lo"].to(torch.int32), t["w_hi"], t["ci"],
            t["a"], t["b"])


@pytest.mark.parametrize("g,s,d,b_dim", [(10, 256, 3, 4), (12, 384, 5, 6), (10, 256, 3, 17),
                                         (12, 256, 3, 20)])
def test_plain_matches_pallas_kernel(g, s, d, b_dim):
    c = _case(g + d, g, s, d, b_dim)
    w_mat = jdk.interp_weight_matrix(jnp.asarray(c["idx_lo"]), jnp.asarray(c["w_hi"]), g,
                                     jnp.float32)
    j = {k: jnp.asarray(v) for k, v in c.items()}
    want = jdk.decision_update_pallas(
        j["v"], j["dm_std_t"], j["spot"], w_mat, j["ci"], j["a"], j["b"], sim_tile=128,
        interpret=True, pred_passes=1,
    )
    got = tdk.decision_update(*_torch_args(c))
    assert tdk.decision_update.launches == 0  # CPU tensors take the plain version
    scale = float(np.abs(c["v"]).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2.0**-15 * scale)


def _row_span_tables(kind, g, d, rng):
    """(idx_lo, w_hi) whose rows cover the grid otherwise than interpolated
    targets do: every grid point reaching from row 0 to row G−2 ("whole-grid"),
    rows falling as g rises ("non-monotone"), or a band of rows following g
    ("monotone")."""
    gi = np.arange(g)[:, None]
    if kind == "whole-grid":
        idx_lo = np.concatenate([np.zeros((g, 1)), rng.integers(0, g - 1, (g, d - 2)),
                                 np.full((g, 1), g - 2)], axis=1)
    elif kind == "non-monotone":
        idx_lo = (g - 2 - gi) + np.array([-3, 0, 3])[None, :d] + rng.integers(-2, 3, (g, d))
    else:
        idx_lo = gi + np.array([-5, 0, 5])[None, :d]
    idx_lo = np.clip(idx_lo, 0, g - 2).astype(np.int32)
    w_hi = np.round(rng.uniform(0.0, 1.0, (g, d)) * 256.0) / 256.0
    return idx_lo, w_hi.astype(np.float32)


@pytest.mark.parametrize("kind,g", [("whole-grid", 20), ("non-monotone", 24), ("monotone", 40)])
def test_plain_matches_pallas_kernel_on_row_spans(kind, g):
    """Row tables that kernel D takes in any order: rows spanning the whole
    grid, rows that fall as g rises, and a band of rows following g.
    Against the Pallas kernel in interpret mode, as above."""
    s, d, b_dim = 256, 3, 4
    c = _case(g + 100, g, s, d, b_dim)
    c["idx_lo"], c["w_hi"] = _row_span_tables(kind, g, d, np.random.default_rng(g))
    w_mat = jdk.interp_weight_matrix(jnp.asarray(c["idx_lo"]), jnp.asarray(c["w_hi"]), g,
                                     jnp.float32)
    j = {k: jnp.asarray(v) for k, v in c.items()}
    want = jdk.decision_update_pallas(
        j["v"], j["dm_std_t"], j["spot"], w_mat, j["ci"], j["a"], j["b"], sim_tile=128,
        interpret=True, pred_passes=1,
    )
    got = tdk.decision_update(*_torch_args(c))
    assert tdk.decision_update.launches == 0
    scale = float(np.abs(c["v"]).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2.0**-15 * scale)


def test_plain_matches_exact_xla_formula_f64():
    """The JAX engine's plain backward body (engines/lsmc.py:329-351): the
    UNcentred regressed values imm + pred[d] with a strict-> running argmax
    from decision 0.  The kernel compares centred gaps instead; in f64 the
    order of the decisions is the same."""
    g, s, d, b_dim = 9, 200, 3, 4
    c = _case(7, g, s, d, b_dim, dtype=np.float64)
    pred = np.einsum("bs,dgb->dgs", c["dm_std_t"], c["ci"])
    best_reg = best_act = None
    for k in range(d):
        lo, w = c["idx_lo"][:, k], c["w_hi"][:, k][:, None]
        act = c["v"][lo] * (1 - w) + c["v"][lo + 1] * w
        imm = c["a"][k][:, None] * c["spot"][None, :] + c["b"][k][:, None]
        if k == 0:
            best_reg, best_act = imm + pred[k], imm + act
        else:
            better = imm + pred[k] > best_reg
            best_reg = np.where(better, imm + pred[k], best_reg)
            best_act = np.where(better, imm + act, best_act)
    got = tdk.decision_update_plain(*_torch_args(c))
    np.testing.assert_allclose(got.numpy(), best_act, rtol=1e-12, atol=1e-9)


def test_same_values_as_kernel_b_on_the_same_design():
    """D on the design B builds itself (basis 1 + s + s²) gives B's values."""
    from storage_tpu_torch.basis import parse_basis_functions

    g, s, d = 8, 160, 3
    c = _case(3, g, s, d, 3, dtype=np.float64)
    monomials = tuple(parse_basis_functions("1 + s + s**2"))
    spot = torch.tensor(c["spot"])
    mean = torch.tensor([0.0, 30.0, 1000.0], dtype=torch.float64)
    std = torch.tensor([1.0, 10.0, 600.0], dtype=torch.float64)
    dm_t = ((torch.stack([torch.ones_like(spot), spot, spot * spot]) - mean[:, None])
            / std[:, None])
    args = _torch_args(c)
    got = tdk.decision_update(args[0], dm_t, spot, *args[3:])
    empty = torch.zeros((0, s), dtype=torch.float64)
    want, _, _ = tdk.decision_update_moments(
        args[0], spot, empty, spot, empty, mean, std, mean, std, *args[3:], monomials)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13, atol=1e-10)
