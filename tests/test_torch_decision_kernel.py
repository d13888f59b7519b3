"""Kernel B's plain version (``decision_update_moments_plain``) against the
Pallas TPU kernel it replaces, run in interpret mode with ``pred_passes=1``
(the exact-f32 regressed gap), and against the exact XLA formula of the JAX
engine's plain backward body in f64.

Tolerance against the Pallas kernel: the TPU kernel interpolates ``v`` as two
bf16 matmuls over a hi/lo split of ``v``, which keeps about 16 bits —
2⁻¹⁶ relative to |v|.  The regressed gaps are computed op for op alike, so
the argmax picks the same decisions and no flip allowance is needed.
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

torch.set_num_threads(1)

BASIS = "1 + s + x0 + x1 + x0**2 + s*x1"


def _case(seed, g, s, d, f, dtype=np.float32):
    rng = np.random.default_rng(seed)
    grid_next = np.linspace(0.0, 1000.0, g)
    targets = rng.uniform(-50.0, 1050.0, (g, d))
    idx_lo, w_hi = jax_interp_weights(jnp.asarray(grid_next), jnp.asarray(targets))
    w_hi = jdk.snap_weights(w_hi)  # the Pallas kernel snaps its hat weights
    b_dim = len(jax_parse(BASIS))
    case = dict(
        v=rng.normal(100.0, 30.0, (g, s)) + grid_next[:, None],
        spot=rng.uniform(10.0, 50.0, s), factors=rng.normal(0.0, 1.0, (f, s)),
        spot_prev=rng.uniform(10.0, 50.0, s), factors_prev=rng.normal(0.0, 1.0, (f, s)),
        mean=np.r_[0.0, rng.normal(0.0, 0.3, b_dim - 1)],
        std=np.r_[1.0, rng.uniform(0.5, 2.0, b_dim - 1)],
        idx_lo=np.asarray(idx_lo), w_hi=np.asarray(w_hi),
        ci=rng.normal(0.0, 20.0, (d, g, b_dim)),
        a=rng.normal(0.0, 2.0, (d, g)), b=rng.normal(0.0, 20.0, (d, g)),
    )
    return {k: (v if k == "idx_lo" else v.astype(dtype)) for k, v in case.items()}


def _torch_args(c, mean_prev=None, std_prev=None):
    t = {k: torch.tensor(v) for k, v in c.items()}
    return (t["v"], t["spot"], t["factors"], t["spot_prev"], t["factors_prev"], t["mean"],
            t["std"], t["mean"] if mean_prev is None else mean_prev,
            t["std"] if std_prev is None else std_prev, t["idx_lo"].to(torch.int32),
            t["w_hi"], t["ci"], t["a"], t["b"], tuple(parse_basis_functions(BASIS)))


@pytest.mark.parametrize("g,s,d,f", [(10, 256, 3, 2), (12, 384, 5, 3),
                                     (400, 256, 3, 3), (1000, 256, 3, 3)])
def test_plain_matches_pallas_kernel(g, s, d, f):
    """Also beyond 338 grid points, where kernel B's first CUDA design ran
    out of shared memory at D=3, B=9."""
    c = _case(g + d, g, s, d, f)
    w_mat = jdk.interp_weight_matrix(jnp.asarray(c["idx_lo"]), jnp.asarray(c["w_hi"]), g,
                                     jnp.float32)
    j = {k: jnp.asarray(v) for k, v in c.items()}
    want = jdk.decision_update_moments_pallas(
        j["v"], j["spot"], j["factors"], j["spot_prev"], j["factors_prev"], j["mean"], j["std"],
        w_mat, j["ci"], j["a"], j["b"], tuple(jax_parse(BASIS)), sim_tile=128,
        interpret=True, pred_passes=1,
    )
    got = tdk.decision_update_moments(*_torch_args(c))
    assert tdk.decision_update_moments.launches == 0  # CPU tensors take the plain version
    scale = float(np.abs(c["v"]).max())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=2.0**-15 * scale)
    # Moments over s sims: f32 sums in another order.
    for k in (1, 2):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=2e-5 * np.abs(w).max())


def test_plain_matches_exact_xla_formula_f64():
    """The JAX engine's plain backward body (engines/lsmc.py:329-351): the
    UNcentred regressed values imm + pred[d] with a strict-> running argmax
    from decision 0.  The kernel compares centred gaps instead; in f64 the
    order of the decisions is the same."""
    g, s, d, f = 9, 200, 3, 2
    c = _case(7, g, s, d, f, dtype=np.float64)
    monomials = tuple(parse_basis_functions(BASIS))
    dm = ((design_matrix(monomials, torch.tensor(c["spot"]), torch.tensor(c["factors"]))
           .numpy() - c["mean"]) / c["std"])
    pred = np.einsum("sb,dgb->dgs", dm, c["ci"])
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
    mean_prev = torch.tensor(c["mean"] * 0.5)
    std_prev = torch.tensor(c["std"] * 1.5)
    got = tdk.decision_update_moments_plain(*_torch_args(c, mean_prev, std_prev))
    np.testing.assert_allclose(got[0].numpy(), best_act, rtol=1e-12, atol=1e-9)
    dmp = ((design_matrix(monomials, torch.tensor(c["spot_prev"]), torch.tensor(c["factors_prev"]))
            .numpy() - mean_prev.numpy()) / std_prev.numpy())
    np.testing.assert_allclose(got[1].numpy(), dmp.T @ dmp, rtol=1e-12)
    np.testing.assert_allclose(got[2].numpy(), dmp.T @ best_act.T, rtol=1e-12)
