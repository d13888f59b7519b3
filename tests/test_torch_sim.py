"""Path simulation of storage_tpu_torch against the JAX package: the exact-step
3-factor seasonal OU model on the same threefry draws, in f32 and f64."""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from storage_tpu.models import multi_factor as jmf
from storage_tpu.parallel.mesh import sim_inputs_from_precompute
from storage_tpu_torch import convert
from storage_tpu_torch.models import multi_factor as tmf
from storage_tpu.models import spot_sim as jss
from storage_tpu_torch.models.spot_sim import ou_step, simulate_ou_paths, spot_from_state

torch.set_num_threads(1)


def _precompute(mf):
    start = pd.Period("2021-01-01", freq="D")
    periods = list(pd.period_range(start, start + 20, freq="D"))
    factors, corrs = mf.create_3_factor_seasonal_params(
        "D", 14.5, 1.1, 0.19, 0.23, start, periods[-1]
    )
    pre = mf.simulation_precompute(factors, corrs, start.to_timestamp().date(), periods, "D")
    fwd = 30.0 + 6.0 * np.sin(np.arange(len(periods)) / 5.0)
    return pre, fwd


# f64: same draws to ~1e-13 and the same OU recursion -> agreement to
# rounding.  f32: draws within 4 ULP, then 21 f32 OU steps and an exp.
@pytest.mark.parametrize(
    "jdt,tdt,rtol,atol",
    [(jnp.float64, torch.float64, 1e-12, 1e-14), (jnp.float32, torch.float32, 2e-6, 2e-6)],
)
def test_simulate_ou_paths_matches_jax(jdt, tdt, rtol, atol):
    pre, fwd = _precompute(jmf)
    tpre, tfwd = _precompute(tmf)
    np.testing.assert_array_equal(tpre.chol, pre.chol)  # carried host layer
    sim_inputs = sim_inputs_from_precompute(pre, fwd, jdt)
    key = jax.random.key(11)
    want = jss.simulate_ou_paths(key, jnp.arange(384), *[sim_inputs[k] for k in
                        ("decay", "chol", "vols", "half_var", "fwd")])
    si = convert.sim_inputs_from_numpy({"decay": tpre.decay, "chol": tpre.chol, "vols": tpre.vols,
                                        "half_var": tpre.half_var, "fwd": tfwd}, tdt, "cpu")
    got = simulate_ou_paths(convert.key_words(jax.random.key_data(key)), torch.arange(384),
                            si["decay"], si["chol"], si["vols"], si["half_var"], si["fwd"])
    assert got.spot.shape == (21, 384) and got.factors.shape == (21, 3, 384)
    assert got.spot.dtype == tdt
    np.testing.assert_allclose(got.factors.numpy(), np.asarray(want.factors), rtol=rtol, atol=atol)
    np.testing.assert_allclose(got.spot.numpy(), np.asarray(want.spot), rtol=rtol, atol=0)


def test_ou_step_and_spot_from_state():
    """The JAX package's single-step forms, in f64: its streamed engine steps
    with them; the port's regenerates a segment by the resumed sweep
    (``spot_sim.simulate_ou_segment``)."""
    pre, fwd = _precompute(tmf)
    rng = np.random.default_rng(3)
    x = rng.normal(0.0, 0.1, (3, 64))
    z = rng.normal(0.0, 1.0, (3, 64))
    k = 7
    want_x = jss.ou_step(jnp.asarray(x), jnp.asarray(z), jnp.asarray(pre.decay[k]), jnp.asarray(pre.chol[k]))
    got_x = ou_step(torch.tensor(x), torch.tensor(z), torch.tensor(pre.decay[k]), torch.tensor(pre.chol[k]))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-13, atol=1e-15)
    want_s = jss.spot_from_state(want_x, fwd[k], pre.half_var[k], jnp.asarray(pre.vols[k]))
    got_s = spot_from_state(got_x, torch.tensor(fwd[k]), torch.tensor(pre.half_var[k]),
                            torch.tensor(pre.vols[k]))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-13)
