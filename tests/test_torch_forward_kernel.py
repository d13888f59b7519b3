"""Kernel C's plain version (``forward_step_plain``) against the Pallas TPU
kernel it replaces, run in interpret mode with ``pred_passes=1`` (the exact
f32 fitted continuation), over linear and step ratchets, extra decisions,
losses, fuel and inventory cost, and a degenerate next-period grid.

Tolerance: the port evaluates the fitted continuation at the two grid rows a
decision touches and lerps; the TPU kernel sums a hat over all G rows.  Both
are f32 and land within a few ULP of the continuation (|pred| ≲ 1e3 here),
far below the gaps between decisions, so the choices agree and per-sim
outputs match to 1e-5 relative; the cross-sim sums differ by summation
order only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storage_tpu.basis import parse_basis_functions as jax_parse
from storage_tpu.ops import forward_kernel as jfk
from storage_tpu_torch.basis import parse_basis_functions
from storage_tpu_torch.ops import forward_kernel as tfk

torch.set_num_threads(1)

BASIS = "1 + s + x0 + x0**2 + x1"


def _case(seed, *, s=256, g=16, f=2, e=1, is_step=False, r=4, loss=0.02, degenerate=False):
    rng = np.random.default_rng(seed)
    b_dim = len(jax_parse(BASIS))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    scalars = dict(
        df_settle=0.97, df_flow=0.95, inj_cost=1.2, wdr_cost=0.9, inj_pcnt=0.015,
        wdr_pcnt=0.01, loss_pcnt=loss, inv_cost_rate=0.03,
        next_min=500.0 if degenerate else 0.0, next_max=500.0 if degenerate else 1100.0,
    )
    grid_next = np.full(g, 500.0) if degenerate else np.linspace(0.0, 1100.0, g)
    return dict(
        scalars={k: f32(v) for k, v in scalars.items()}, grid_next=f32(grid_next),
        mean=f32(rng.normal(0.0, 1.0, b_dim)), std=f32(rng.uniform(0.5, 2.0, b_dim)),
        ratchet_inv=f32(np.linspace(0.0, 1000.0, r)), ratchet_min=f32(np.linspace(-30.0, -140.0, r)),
        ratchet_max=f32(np.linspace(150.0, 40.0, r)), spot=f32(rng.uniform(20.0, 60.0, s)),
        factors=f32(rng.normal(0.0, 0.5, (f, s))), inventory=f32(rng.uniform(0.0, 1000.0, s)),
        pv=f32(rng.normal(0.0, 100.0, s)), coeffs=f32(rng.normal(0.0, 20.0, (b_dim, g))),
        e=e, is_step=is_step,
    )


def _args(c):
    return (c["mean"], c["std"], c["ratchet_inv"], c["ratchet_min"], c["ratchet_max"],
            c["spot"], c["factors"], c["inventory"], c["pv"], c["coeffs"])


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(),  # linear ratchets, 5 decisions, losses + fuel + inventory cost
        dict(e=0, is_step=True, r=3, loss=0.0),  # step ratchets, bang-bang only
        dict(degenerate=True),  # collapsed next band: every lookup at node 0
        dict(e=2, s=384, g=24, r=5),  # 7 decisions, wider grid
    ],
    ids=["linear-e1", "step-e0", "degenerate-grid", "linear-e2"],
)
def test_plain_matches_pallas_kernel(kwargs):
    c = _case(11 + len(kwargs), **kwargs)
    params = jfk.pack_params({k: jnp.asarray(v) for k, v in c["scalars"].items()},
                             jnp.asarray(c["grid_next"]))
    want = jfk.forward_step_pallas(
        params, *(jnp.asarray(a) for a in _args(c)),
        tuple(jax_parse(BASIS)), c["e"], c["is_step"], 128, interpret=True, pred_passes=1,
    )
    tparams = tfk.pack_params({k: torch.tensor(v) for k, v in c["scalars"].items()},
                              torch.tensor(c["grid_next"]))
    np.testing.assert_array_equal(tparams.numpy(), np.asarray(params))
    got = tfk.forward_step(
        tparams, *(torch.tensor(a) for a in _args(c)),
        tuple(parse_basis_functions(BASIS)), c["e"], c["is_step"],
    )
    # CPU tensors take the plain version (forward_step is the sweep at N = 1).
    assert tfk.forward_sweep.launches == 0
    s = c["spot"].shape[0]
    for name, g_arr, w_arr in zip(("inventory", "pv", "decision", "consumed"), got[:4], want[:4]):
        np.testing.assert_allclose(g_arr.numpy(), np.asarray(w_arr), rtol=1e-5, atol=1e-3,
                                   err_msg=name)
    w_sums = np.asarray(want[4])
    np.testing.assert_allclose(got[4].numpy(), w_sums, rtol=1e-5, atol=1e-4 * s)
    np.testing.assert_array_equal(got[4].numpy()[6:], 0.0)
    np.testing.assert_allclose(got[5].numpy(), np.asarray(want[5]), rtol=1e-5, atol=1e-5 * s)
