"""The counter RNG of storage_tpu_torch against the JAX package.

Threefry words must match bit for bit; normals may differ by a few ULP only,
because XLA's ``log1p`` and torch's round differently and, under the x64 mode
the test suite runs in, the JAX package multiplies by √2 in f64 before
rounding to f32.  The kernel's plain version is also held against the Pallas
kernel, run in interpret mode at a small shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storage_tpu.models import spot_sim as jss
from storage_tpu.ops import rng_kernel as jrk
from storage_tpu_torch import convert
from storage_tpu_torch.models import spot_sim as tss
from storage_tpu_torch.ops import rng_kernel as trk

torch.set_num_threads(1)

F32_ULP = 4  # normals: log1p rounding and the f64 √2 product under x64
F64_RTOL = 1e-13  # f64 normals: log1p rounding through a 23-term polynomial


def _ulp(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _words(rng, n):
    w = rng.integers(0, 2**32, n, dtype=np.uint64)
    w[:4] = [0, 1, 2**32 - 1, 2**31]
    return w.astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 11, 2**33 + 5])
def test_threefry_words_bit_identical(seed):
    rng = np.random.default_rng(seed % 1000)
    key = jax.random.key(seed)
    k0, k1 = convert.key_words(jax.random.key_data(key))
    hi, lo = _words(rng, 4096), _words(rng, 4096)
    got = trk.threefry2x32(k0, k1, torch.tensor(hi.astype(np.int64)), torch.tensor(lo.astype(np.int64)))
    want_kernel = jrk.threefry2x32(jnp.uint32(k0), jnp.uint32(k1), jnp.asarray(hi), jnp.asarray(lo))
    want_xla = jss._hash_counter_pairs(key, jnp.asarray(hi), jnp.asarray(lo))
    for g, wk, wx in zip(got, want_kernel, want_xla):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wk).astype(np.int64))
        np.testing.assert_array_equal(g.numpy(), np.asarray(wx).astype(np.int64))


def test_bits_to_normal_f32_within_ulp():
    bits = _words(np.random.default_rng(1), 200_000)
    got = trk.bits_to_normal(torch.tensor(bits.astype(np.int64)), None, torch.float32)
    want = jss._bits_to_normal(jnp.asarray(bits), None, jnp.float32)
    assert got.dtype == torch.float32
    assert _ulp(got.numpy(), want) <= F32_ULP


def test_bits_to_normal_f64():
    rng = np.random.default_rng(2)
    hi, lo = _words(rng, 100_000), _words(rng, 100_000)
    got = trk.bits_to_normal(
        torch.tensor(hi.astype(np.int64)), torch.tensor(lo.astype(np.int64)), torch.float64
    )
    want = np.asarray(jss._bits_to_normal(jnp.asarray(hi), jnp.asarray(lo), jnp.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=F64_RTOL, atol=1e-300)


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("start,steps,f", [(0, 12, 3), (7, 9, 3), (2, 5, 4)])
def test_draw_normal_halves_and_step_assembly(start, steps, f, antithetic):
    key = jax.random.key(11)
    ids = np.arange(256)
    z1, z2, b0 = jss.draw_normal_halves(
        key, start, steps, jnp.asarray(ids), f, antithetic, jnp.float32, use_pallas=False
    )
    t1, t2, tb0 = tss.draw_normal_halves(
        convert.key_words(jax.random.key_data(key)), start, steps, torch.tensor(ids), f,
        antithetic,
    )
    assert tb0 == int(b0)
    assert _ulp(t1.numpy(), z1) <= F32_ULP and _ulp(t2.numpy(), z2) <= F32_ULP
    bulk = jss.multi_step_normals(key, start, steps, jnp.asarray(ids), f, antithetic, jnp.float32)
    for k in range(start, start + steps):
        want = jss.step_z_from_halves(z1, z2, b0, k, f)
        got = tss.step_z_from_halves(t1, t2, tb0, k, f)
        assert _ulp(got.numpy(), want) <= F32_ULP
        assert _ulp(got.numpy(), bulk[k - start]) <= F32_ULP


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_multi_step_normals(dtype):
    key = jax.random.key(13)
    ids = np.arange(128)
    want = jss.multi_step_normals(key, 3, 6, jnp.asarray(ids), 3, False, dtype)
    tdt = torch.float64 if dtype == jnp.float64 else torch.float32
    got = tss.multi_step_normals(
        convert.key_words(jax.random.key_data(key)), 3, 6, torch.tensor(ids), 3, False, tdt
    )
    assert got.shape == (6, 3, 128) and got.dtype == tdt
    if tdt == torch.float64:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F64_RTOL, atol=1e-300)
    else:
        assert _ulp(got.numpy(), want) <= F32_ULP


@pytest.mark.parametrize("seed", [0, 11, 13, 2**31 + 5, 2**40 + 3])
def test_key_from_seed_and_fold_in(seed):
    key = jax.random.key(seed)
    words = tss.key_from_seed(seed)
    assert words == convert.key_words(jax.random.key_data(key))
    for data in (0x5EED, 7):
        assert tss.fold_in(words, data) == convert.key_words(
            jax.random.key_data(jax.random.fold_in(key, data))
        )


@pytest.mark.parametrize("with_sign", [False, True])
def test_plain_normal_halves_matches_pallas_interpret(with_sign):
    key = jax.random.key(5)
    ids = np.arange(1000, 1128, dtype=np.uint32)
    sign = np.where(np.arange(128) % 2 == 0, 1.0, -1.0).astype(np.float32)
    z1, z2 = jrk.normal_halves_pallas(
        jax.random.key_data(key), 3, 8, jnp.asarray(ids),
        jnp.asarray(sign) if with_sign else None,
        with_sign=with_sign, row_tile=8, s_tile=128, interpret=True,
    )
    t1, t2 = trk.normal_halves(
        convert.key_words(jax.random.key_data(key)), 3, 8, torch.tensor(ids.astype(np.int64)),
        torch.tensor(sign) if with_sign else None,
    )
    assert t1.shape == (8, 128)
    assert _ulp(t1.numpy(), z1) <= F32_ULP and _ulp(t2.numpy(), z2) <= F32_ULP
    assert trk.normal_halves.launches == 0  # CPU tensors never reach the kernel
