"""The streamed engine of storage_tpu_torch (paths regenerated a segment at a
time, never materialised) against the JAX package's ``lsmc_core_streamed``
and against its own materialised engine, on the CPU.

* Against the JAX package (f64, the tolerance of ``tests/test_streaming.py``,
  rtol 1e-8): segment lengths 1, 7, 16 and 40 over 40 steps (a ragged tail of
  5 at 7, of 8 at 16; 40 one segment), by monkeypatching ``SEG_LEN``; a
  terminal value; the regression payload; antithetic draws with
  ``same_sims``; a generic basis; the streamed adjoint.
* Against the port's materialised engine on ``simulate_ou_paths``' panels,
  in f32 and f64: the same bits, adjoint deltas and payload included, also
  through kernel E's full step, a generic basis and antithetic draws.
* The resumed plain sweep (``simulate_sweep_plain``/``sweep_normals_plain``
  at a start step from an entry state, and the f64 draws and steps) against
  the unsegmented one at odd and even start steps, F = 1, 2, 3, 8: the same
  bits.
* The footprint rule and the threshold, and ``segment_cb`` on a streamed
  run.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_sharding import build_case  # noqa: E402

import storage_tpu.basis as jbasis  # noqa: E402
from storage_tpu.engines import lsmc as jax_lsmc  # noqa: E402
from storage_tpu_torch import basis as tbasis  # noqa: E402
from storage_tpu_torch import convert  # noqa: E402
from storage_tpu_torch.engines import lsmc as torch_lsmc  # noqa: E402
from storage_tpu_torch.models import spot_sim  # noqa: E402
from storage_tpu_torch.ops import rng_kernel  # noqa: E402
from storage_tpu_torch.parallel import mesh as pmesh  # noqa: E402

torch.set_num_threads(1)

NUM_SIMS = 64
RESULT_KEYS = (
    "npv", "standard_error", "backward_npv", "deltas", "profile_inventory",
    "profile_inject_withdraw", "profile_pv", "trigger_inject_prices",
    "max_withdraw_volume",
)
BASIS = "1 + x0 + x0**2 + x1 + s"


def terminal(price, inv):
    return price * inv * 0.5


def _generic(b):
    return b.ONE + b.X0 + b.generic(lambda s, x: x[0] * x[1], num_factors=2, label="x0x1") + b.S


@pytest.fixture(scope="module")
def case():
    inputs, arrays, sim_inputs, monomials = build_case()

    def port(dtype):
        host = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
        return (convert.engine_arrays_from_numpy(host(arrays), dtype, "cpu"),
                convert.sim_inputs_from_numpy(host(sim_inputs), dtype, "cpu"))

    return dict(inputs=inputs, arrays=arrays, sim_inputs=sim_inputs, monomials=monomials,
                port={torch.float64: port(torch.float64), torch.float32: port(torch.float32)})


def _key(seed):
    return convert.key_words(jax.random.key_data(jax.random.key(seed)))


def _jax_streamed(case, monomials=None, **kwargs):
    return jax_lsmc.lsmc_core_streamed(
        case["arrays"], case["sim_inputs"], jax.random.key(7), jax.random.key(9),
        jnp.arange(NUM_SIMS), jnp.asarray(case["inputs"].starting_inventory, jnp.float64),
        monomials or case["monomials"], 0, False, kwargs.pop("terminal_fn", None), False,
        axis_name=None, **kwargs)


def _port_streamed(case, dtype=torch.float64, basis=BASIS, **kwargs):
    arrays, sim_inputs = case["port"][dtype]
    return torch_lsmc.lsmc_core_streamed(
        arrays, sim_inputs, _key(7), _key(9), torch.arange(NUM_SIMS),
        case["inputs"].starting_inventory, tuple(tbasis.coerce_basis_functions(basis)), 0, False,
        kwargs.pop("terminal_fn", None), False, **kwargs)


def _port_materialised(case, dtype=torch.float64, basis=BASIS, antithetic=False, **kwargs):
    arrays, sim_inputs = case["port"][dtype]
    args = [sim_inputs[k] for k in ("decay", "chol", "vols", "half_var", "fwd")]
    ids = torch.arange(NUM_SIMS)
    reg = spot_sim.simulate_ou_paths(_key(7), ids, *args, antithetic=antithetic)
    val = spot_sim.simulate_ou_paths(_key(9), ids, *args, antithetic=antithetic)
    return torch_lsmc.lsmc_core(
        arrays, reg.spot, reg.factors, val.spot, val.factors, case["inputs"].starting_inventory,
        tuple(tbasis.coerce_basis_functions(basis)), 0, False, kwargs.pop("terminal_fn", None),
        False, **kwargs)


def _assert_close_to_jax(got, want, rtol=1e-8):
    for k in RESULT_KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=rtol, atol=1e-6,
                                   equal_nan=True, err_msg=k)


@pytest.mark.parametrize("seg_len", [1, 7, 16, 40])
def test_matches_jax_streamed_at_every_segment_length(case, seg_len, monkeypatch):
    want = _jax_streamed(case, seg_len=seg_len)
    monkeypatch.setattr(torch_lsmc, "SEG_LEN", seg_len)
    _assert_close_to_jax(_port_streamed(case), want)


def test_terminal_value_matches_jax(case):
    want = _jax_streamed(case, terminal_fn=terminal)
    _assert_close_to_jax(_port_streamed(case, terminal_fn=terminal), want)


def test_regression_payload_matches_jax(case, monkeypatch):
    want = _jax_streamed(case, seg_len=13, return_regression=True)
    monkeypatch.setattr(torch_lsmc, "SEG_LEN", 13)
    got = _port_streamed(case, return_regression=True)
    for k in ("regression_mean", "regression_std", "regression_coeffs"):
        # Step 0 is the valuation date: its design columns are constant and
        # its coefficients set by the ridge alone (tests/test_streaming.py).
        np.testing.assert_allclose(got[k].numpy()[1:], np.asarray(want[k])[1:], rtol=1e-8,
                                   atol=1e-8, err_msg=k)


def test_antithetic_same_sims_matches_jax(case):
    want = jax_lsmc.lsmc_core_streamed(
        case["arrays"], case["sim_inputs"], jax.random.key(7), jax.random.key(7),
        jnp.arange(NUM_SIMS), jnp.asarray(case["inputs"].starting_inventory, jnp.float64),
        case["monomials"], 0, False, None, False, axis_name=None, antithetic=True,
        same_sims=True)
    arrays, sim_inputs = case["port"][torch.float64]
    got = torch_lsmc.lsmc_core_streamed(
        arrays, sim_inputs, _key(7), _key(9), torch.arange(NUM_SIMS),
        case["inputs"].starting_inventory, tuple(tbasis.parse_basis_functions(BASIS)), 0, False,
        None, False, antithetic=True, same_sims=True)
    _assert_close_to_jax(got, want)


def test_generic_basis_matches_jax(case):
    want = _jax_streamed(case, monomials=tuple(_generic(jbasis)), terminal_fn=terminal)
    _assert_close_to_jax(_port_streamed(case, basis=_generic(tbasis), terminal_fn=terminal), want)


def test_streamed_adjoint_matches_jax(case):
    want_npv, want = jax_lsmc.lsmc_npv_and_ad_deltas_streamed(
        case["arrays"], case["sim_inputs"], jax.random.key(7), jax.random.key(9),
        jnp.arange(NUM_SIMS), jnp.asarray(case["inputs"].starting_inventory, jnp.float64),
        case["monomials"], 0, True, terminal, False)
    arrays, sim_inputs = case["port"][torch.float64]
    got_npv, got = torch_lsmc.lsmc_npv_and_ad_deltas_streamed(
        arrays, sim_inputs, _key(7), _key(9), torch.arange(NUM_SIMS),
        case["inputs"].starting_inventory, tuple(tbasis.parse_basis_functions(BASIS)), 0, True,
        terminal, False)
    assert float(got_npv) == pytest.approx(float(want_npv), rel=1e-8)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-8 * np.abs(want).max())


@pytest.mark.parametrize("dtype,seg_len,variant", [
    (torch.float64, 7, "moments"), (torch.float64, 16, "fullstep"), (torch.float64, 1, "generic"),
    (torch.float32, 16, "moments"), (torch.float32, 7, "fullstep"), (torch.float32, 40, "generic"),
    (torch.float64, 16, "antithetic"), (torch.float32, 7, "antithetic"),
], ids=lambda v: str(v).replace("torch.", ""))
def test_streamed_is_the_materialised_engine_to_the_bit(case, dtype, seg_len, variant,
                                                        monkeypatch):
    """Every output of the streamed engine, the adjoint deltas and the
    regression payload too, is the materialised engine's on the same paths,
    to the bit: kernel B's moments, kernel E's full step, a generic basis,
    antithetic draws."""
    monkeypatch.setattr(torch_lsmc, "SEG_LEN", seg_len)
    kwargs = dict(terminal_fn=terminal, adjoint=True, return_regression=True,
                  fullstep=variant == "fullstep", antithetic=variant == "antithetic",
                  basis=_generic(tbasis) if variant == "generic" else BASIS)
    got = _port_streamed(case, dtype, **kwargs)
    want = _port_materialised(case, dtype, **kwargs)
    assert set(got) == set(want)
    assert torch.equal(torch_lsmc.adjoint_deltas(got.pop("adjoint_tape")),
                       torch_lsmc.adjoint_deltas(want.pop("adjoint_tape")))
    for k in want:
        assert torch.equal(got[k].nan_to_num(), want[k].nan_to_num()), k


@pytest.mark.parametrize("f", [1, 2, 3, 8])
@pytest.mark.parametrize("start", [5, 6], ids=["odd", "even"])
def test_resumed_plain_sweep_is_the_unsegmented_sweep(f, start):
    """Steps start..P−1 resumed from the state entering them are rows
    start.. of the sweep from step 0, to the bit: the f32 draws and the
    sweep's plain version (at F = 3 and an odd start the first word is the
    second half of its block), with and without antithetic signs, and the
    f64 draws and steps."""
    p, s = 11, 37
    gen = torch.Generator().manual_seed(f * 100 + start)
    decay = 0.6 + 0.4 * torch.rand((p, f), generator=gen)
    chol = torch.tril(0.1 * torch.randn((p, f, f), generator=gen))
    vols = 0.5 + torch.rand((p, f), generator=gen)
    c = 3.4 + 0.1 * torch.randn(p, generator=gen)
    path_ids = torch.arange(s) + 3
    key = (5, 7)
    z = rng_kernel.sweep_normals_plain(key, path_ids, None, p, f)
    assert torch.equal(rng_kernel.sweep_normals_plain(key, path_ids, None, p - start, f, start),
                       z[start:])
    for antithetic in (False, True):
        ids = path_ids // 2 if antithetic else path_ids
        sign = (1.0 - 2.0 * (path_ids % 2)).float() if antithetic else None
        factors, spot = rng_kernel.simulate_sweep_plain(key, ids, sign, decay, chol, vols, c)
        tail = rng_kernel.simulate_sweep_plain(key, ids, sign, decay[start:], chol[start:],
                                               vols[start:], c[start:], start, factors[start - 1])
        assert torch.equal(tail[0], factors[start:]) and torch.equal(tail[1], spot[start:])
        # The same through the wrapper that the streamed engine calls.
        seg = spot_sim.simulate_ou_segment(key, path_ids, decay[start:], chol[start:],
                                           vols[start:], c[start:], start, factors[start - 1],
                                           antithetic)
        assert torch.equal(seg.factors, factors[start:]) and torch.equal(seg.spot, spot[start:])
    f64 = [x.double() for x in (decay, chol, vols, c)]
    whole = spot_sim.simulate_ou_segment(key, path_ids, *f64)
    tail = spot_sim.simulate_ou_segment(key, path_ids, *(x[start:] for x in f64), start,
                                        whole.factors[start - 1])
    assert torch.equal(tail.factors, whole.factors[start:])
    assert torch.equal(tail.spot, whole.spot[start:])


def test_footprint_and_threshold(monkeypatch):
    """The JAX package's footprint rule (tests/test_streaming.py): the
    headline's panels stay under the CPU's 4 GiB, 1,048,576 paths do not; on
    CUDA the threshold is a share of the free memory (``parallel.mesh``,
    which applies them to each rank's share of the paths)."""
    assert pmesh.STREAM_THRESHOLD_BYTES == 4 << 30
    assert pmesh.panel_bytes(365, 1_048_576, 3, 4) > pmesh.STREAM_THRESHOLD_BYTES
    assert pmesh.panel_bytes(365, 262_144, 3, 4) < pmesh.STREAM_THRESHOLD_BYTES
    assert pmesh.panel_bytes(365, 262_144, 3, 4, num_sets=1) * 2 == \
        pmesh.panel_bytes(365, 262_144, 3, 4)
    assert (pmesh.footprint_bytes(365, 1000, 3, 100, 4)
            == pmesh.panel_bytes(365, 1000, 3, 4) + 2 * 100 * 1000 * 4)
    assert pmesh.stream_threshold("cpu") == pmesh.STREAM_THRESHOLD_BYTES
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device: (40_000_000_000, 8e10))
    assert pmesh.stream_threshold("cuda") == int(pmesh.STREAM_FREE_SHARE * 4e10)


def test_segment_callbacks_and_cancel(case):
    """``segment_cb`` ticks after every segment of both streamed passes, as
    in a materialised interactive run, with the same bits; raising from it
    stops the run between segments."""
    calls, want_calls = [], []
    got = _port_streamed(case, segment_cb=lambda *a: calls.append(a))
    want = _port_materialised(case, segment_cb=lambda *a: want_calls.append(a))
    assert calls == want_calls
    assert [c[0] for c in calls] == ["backward"] * 3 + ["forward"] * 3  # 40 = 2·16 + 8
    assert calls[-1] == ("forward", 3, 3)
    assert all(torch.equal(got[k].nan_to_num(), want[k].nan_to_num()) for k in want)

    def stop(phase, done, total):
        if (phase, done) == ("backward", 2):
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        _port_streamed(case, segment_cb=stop)


def test_streamed_sims_refuse_an_unplanned_start(case):
    arrays, sim_inputs = case["port"][torch.float64]
    rows = torch_lsmc.StreamedSims(sim_inputs, _key(7), torch.arange(8))
    spot, factors = rows.rows(0, 5)
    assert spot.shape == (5, 8) and factors.shape == (5, 2, 8)
    rows.rows(5, 9)  # resumes from the last call's state
    with pytest.raises(ValueError, match="no state enters step 3"):
        rows.rows(3, 6)
