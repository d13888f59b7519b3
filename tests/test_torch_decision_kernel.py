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


def _tie_case(seed, g, s, f, dtype=np.float32):
    """Two decisions whose regressed values are equal to the bit (the same
    coefficients and immediate value, so a zero centred gap) but whose
    interpolation rows differ at every grid point."""
    c = _case(seed, g, s, 2, f, dtype)
    for k in ("ci", "a", "b"):
        c[k][1] = c[k][0]
    c["idx_lo"] = np.array(c["idx_lo"])
    c["idx_lo"][:, 1] = (c["idx_lo"][:, 0] + g // 2) % (g - 1)
    return c


def _decision_zero_actual(c):
    """Decision 0's actual value in the plain versions' f32 arithmetic."""
    t = {k: torch.tensor(v) for k, v in c.items()}
    lo, w = t["idx_lo"][:, 0].long(), t["w_hi"][:, 0][:, None]
    imm = t["a"][0][:, None] * t["spot"][None, :] + t["b"][0][:, None]
    act = [t["v"][lo] * (1 - w) + t["v"][lo + 1] * w + imm]
    lo, w = t["idx_lo"][:, 1].long(), t["w_hi"][:, 1][:, None]
    act.append(t["v"][lo] * (1 - w) + t["v"][lo + 1] * w + imm)
    assert float((act[1] - act[0]).abs().gt(1.0).float().mean()) > 0.9  # the tie decides
    return act[0]


@pytest.mark.parametrize("g,s,f", [(10, 256, 2), (40, 384, 3)])
def test_exact_tie_keeps_decision_zero(g, s, f):
    """Kernel B's plain version keeps decision 0 on an exact tie of the
    regressed values (strict >), as the Pallas kernel does in interpret
    mode: best_act is decision 0's actual value, not decision 1's."""
    c = _tie_case(g + 11, g, s, f)
    got = tdk.decision_update_moments_plain(*_torch_args(c))
    act0 = _decision_zero_actual(c)
    assert torch.equal(got[0], act0)
    w_mat = jdk.interp_weight_matrix(jnp.asarray(c["idx_lo"]), jnp.asarray(c["w_hi"]), g,
                                     jnp.float32)
    j = {k: jnp.asarray(v) for k, v in c.items()}
    want = jdk.decision_update_moments_pallas(
        j["v"], j["spot"], j["factors"], j["spot_prev"], j["factors_prev"], j["mean"], j["std"],
        w_mat, j["ci"], j["a"], j["b"], tuple(jax_parse(BASIS)), sim_tile=128,
        interpret=True, pred_passes=1,
    )
    scale = float(np.abs(c["v"]).max())
    np.testing.assert_allclose(np.asarray(want[0]), act0.numpy(), rtol=0, atol=2.0**-15 * scale)


def test_exact_tie_keeps_decision_zero_fullstep():
    """Kernel E's plain version likewise, against the Pallas full-step
    kernel: carried moments against zero values solve to zero coefficients,
    so two decisions with the same immediate value tie exactly."""
    g, s, f = 12, 256, 2
    c = _tie_case(29, g, s, f)
    rng = np.random.default_rng(30)
    b_dim = len(jax_parse(BASIS))
    u = np.c_[np.ones(s), rng.normal(0.0, 1.0, (s, b_dim - 1))]
    # v rounded to bf16 values: the Pallas kernel's hi/lo split of v is exact.
    c["v"] = np.asarray(jnp.asarray(c["v"]).astype(jnp.bfloat16).astype(jnp.float32))
    extra = dict(xtx=(u.T @ u).astype(np.float32), xty=np.zeros((b_dim, g), np.float32),
                 cmean=np.r_[0.0, rng.normal(0.0, 0.2, b_dim - 1)].astype(np.float32),
                 cstd=np.r_[1.0, rng.uniform(0.5, 2.0, b_dim - 1)].astype(np.float32))
    order = ("v", "spot", "factors", "spot_prev", "factors_prev")
    t = [torch.tensor(c[k]) for k in order] + [torch.tensor(extra[k]) for k in extra]
    got = tdk.decision_update_fullstep_plain(
        *t, torch.tensor(c["idx_lo"]).to(torch.int32), torch.tensor(c["w_hi"]),
        torch.tensor(c["a"]), torch.tensor(c["b"]), tuple(parse_basis_functions(BASIS)))
    assert not torch.any(got[5])  # zero coefficients: every regressed gap is 0
    act0 = _decision_zero_actual(c)
    assert torch.equal(got[0], act0)
    w_mat = jdk.interp_weight_matrix(jnp.asarray(c["idx_lo"]), jnp.asarray(c["w_hi"]), g,
                                     jnp.float32)
    j = [jnp.asarray(c[k]) for k in order] + [jnp.asarray(extra[k]) for k in extra]
    want = jdk.decision_update_fullstep_pallas(
        *j, w_mat, jnp.asarray(c["a"]), jnp.asarray(c["b"]), tuple(jax_parse(BASIS)),
        sim_tile=128, interpret=True, pred_passes=1,
    )
    assert not np.any(np.asarray(want[5]))
    np.testing.assert_allclose(np.asarray(want[0]), act0.numpy(), rtol=2e-4, atol=1.0)
