"""The simulation sweep's plain version against the JAX package's
``simulate_ou_paths``, on step tables made with numpy from a seed, for 1 to 4,
9 and 10 factors (past the 8 of the monomial kernels: the sweep takes any
F), with and without antithetic draws, over odd and even numbers of
steps: f32 through ``ops.rng_kernel.simulate_sweep_plain`` (the kernel's plain
version), f64 through ``simulate_ou_paths`` (the f64 draws, then the sweep's
step loop ``ou_sweep_plain``).

Tolerances: f64 draws agree to ~1e-13 and the OU recursion is the same up to
the order of the L·z sum (1e-12 relative); f32 draws agree within 4 ULP, then
f32 steps and an exp (2e-6, as the 3-factor test in test_torch_sim.py).  The
f32 draws' addressing (word k·F + i of each path) equals
``multi_step_normals`` bit for bit, and ``simulate_ou_paths`` on the CPU is the
sweep's plain version bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storage_tpu.models import spot_sim as jss
from storage_tpu_torch import convert
from storage_tpu_torch.models import spot_sim as tss
from storage_tpu_torch.ops import rng_kernel as trk

torch.set_num_threads(1)

NUM_PATHS = 256  # a multiple of 32: every element takes torch's vectorised CPU loops


def _tables(p: int, f: int, seed: int):
    """Step tables of an F-factor OU model over P steps: decay in (0.6, 1),
    lower-triangular L with a positive diagonal, vols, half variances and a
    forward curve."""
    rng = np.random.default_rng(seed)
    decay = rng.uniform(0.6, 1.0, (p, f))
    chol = np.tril(rng.normal(0.0, 0.1, (p, f, f)))
    idx = np.arange(f)
    chol[:, idx, idx] = rng.uniform(0.05, 0.2, (p, f))
    vols = rng.uniform(0.5, 1.5, (p, f))
    half_var = rng.uniform(0.0, 0.05, p)
    fwd = rng.uniform(20.0, 40.0, p)
    return decay, chol, vols, half_var, fwd


def _simulate_both(p, f, antithetic, jdt, tdt, seed=11):
    tables = _tables(p, f, seed)
    key = jax.random.key(seed)
    want = jss.simulate_ou_paths(key, jnp.arange(NUM_PATHS), *(jnp.asarray(a, jdt) for a in tables),
                                 antithetic=antithetic)
    decay, chol, vols, half_var, fwd = (torch.tensor(a, dtype=tdt) for a in tables)
    path_ids = torch.arange(NUM_PATHS)
    key_words = convert.key_words(jax.random.key_data(key))
    if tdt == torch.float64:
        got = tss.simulate_ou_paths(key_words, path_ids, decay, chol, vols, half_var, fwd,
                                    antithetic=antithetic)
        return want, (got.factors, got.spot)
    ids = path_ids // 2 if antithetic else path_ids
    sign = torch.where(path_ids % 2 == 0, 1.0, -1.0) if antithetic else None
    return want, trk.simulate_sweep_plain(key_words, ids, sign, decay, chol, vols,
                                          torch.log(fwd) - half_var)


@pytest.mark.parametrize("p", [7, 8], ids=["odd-P", "even-P"])
@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "antithetic"])
@pytest.mark.parametrize("f", [1, 2, 3, 4, 9, 10])
@pytest.mark.parametrize("jdt,tdt,rtol,atol", [
    (jnp.float64, torch.float64, 1e-12, 1e-14), (jnp.float32, torch.float32, 2e-6, 2e-6)],
    ids=["f64", "f32"])
def test_sweep_plain_matches_jax(jdt, tdt, rtol, atol, f, antithetic, p):
    want, (factors, spot) = _simulate_both(p, f, antithetic, jdt, tdt)
    assert factors.shape == (p, f, NUM_PATHS) and spot.shape == (p, NUM_PATHS)
    assert factors.dtype == spot.dtype == tdt
    np.testing.assert_allclose(factors.numpy(), np.asarray(want.factors), rtol=rtol, atol=atol)
    np.testing.assert_allclose(spot.numpy(), np.asarray(want.spot), rtol=rtol, atol=0)


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "antithetic"])
def test_simulate_ou_paths_is_the_sweep(antithetic):
    """``simulate_ou_paths`` in f32 on the CPU gives the sweep's plain
    version's bits, and launches nothing."""
    dtype = torch.float32
    decay, chol, vols, half_var, fwd = (torch.tensor(a, dtype=dtype) for a in _tables(9, 3, 5))
    path_ids = torch.arange(NUM_PATHS)
    key = tss.key_from_seed(5)
    before = trk.simulate_sweep.launches
    got = tss.simulate_ou_paths(key, path_ids, decay, chol, vols, half_var, fwd,
                                antithetic=antithetic)
    ids = path_ids // 2 if antithetic else path_ids
    sign = torch.where(path_ids % 2 == 0, 1.0, -1.0).to(dtype) if antithetic else None
    factors, spot = trk.simulate_sweep_plain(key, ids, sign, decay, chol, vols,
                                             torch.log(fwd) - half_var)
    assert torch.equal(got.factors, factors) and torch.equal(got.spot, spot)
    assert trk.simulate_sweep.launches == before == 0


@pytest.mark.parametrize("f", [1, 2, 3, 4, 5, 8, 9, 12])
def test_sweep_word_addressing(f):
    """The sweep's f32 draws for step k and factor i are the normals that
    ``multi_step_normals`` gives word k·F + i (the kernel walks the blocks two
    words at a time), antithetic signs included."""
    dtype = torch.float32
    key = tss.key_from_seed(13)
    path_ids = torch.arange(1000, 1000 + NUM_PATHS)
    p = 11
    for antithetic in (False, True):
        want = tss.multi_step_normals(key, 0, p, path_ids, f, antithetic, dtype)
        ids = path_ids // 2 if antithetic else path_ids
        sign = torch.where(path_ids % 2 == 0, 1.0, -1.0) if antithetic else None
        got = trk.sweep_normals_plain(key, ids, sign, p, f)
        assert got.shape == (p, f, NUM_PATHS) and got.dtype == dtype
        assert torch.equal(got, want)


def test_sweep_steps_match_ou_step():
    """The sweep's step loop (explicit left-to-right sums, no matmul) against
    the one-step form ``ou_step`` / ``spot_from_state`` in f64."""
    decay, chol, vols, half_var, fwd = (torch.tensor(a) for a in _tables(6, 3, 8))
    z = torch.tensor(np.random.default_rng(4).normal(size=(6, 3, 64)))
    factors, spot = trk.ou_sweep_plain(z, decay, chol, vols, torch.log(fwd) - half_var)
    x = torch.zeros((3, 64), dtype=torch.float64)
    for k in range(6):
        x = tss.ou_step(x, z[k], decay[k], chol[k])
        torch.testing.assert_close(factors[k], x, rtol=1e-13, atol=1e-15)
        torch.testing.assert_close(spot[k], tss.spot_from_state(x, fwd[k], half_var[k], vols[k]),
                                   rtol=1e-13, atol=0)
