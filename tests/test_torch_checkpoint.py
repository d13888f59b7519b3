"""Regression checkpoints of storage_tpu_torch against the JAX package
(tests/test_checkpoint.py's cases), in f64 on the CPU, on paths the JAX
package simulates.

* A forward-only revaluation from a checkpoint gives the full run's NPV and
  deltas to the bit, also after a save/load round trip, and also from the
  checkpoint that ``checkpoint_path`` writes during an API valuation (on
  the valuation's own paths).
* The file is the JAX package's: a checkpoint the port writes loads in
  ``storage_tpu.checkpoint.RegressionCheckpoint.load`` and one the JAX
  package writes loads in the port's, with the same keys, arrays and meta;
  the JAX package's revaluation of the port's file on the same paths agrees
  with the port's within 1e-9 relative (the tolerance of
  tests/test_torch_value_from_sims.py).
* A checkpoint made on a custom grid whose rows are not evenly spaced
  revalues to the valuation's bits (the JAX package's revaluation places
  inventories by the evenly spaced arithmetic there).
* A checkpoint of a facility with a terminal value needs ``terminal_fn``;
  ``checkpoint_path`` needs the basis as a DSL string.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import storage_tpu as jpkg
import storage_tpu_torch as tpkg
from storage_tpu import checkpoint as jax_ckpt
from storage_tpu.engines import lsmc as jax_lsmc
from storage_tpu.models import multi_factor as jax_mf
from storage_tpu.models.spot_sim import simulate_ou_paths
from storage_tpu.parallel.mesh import sim_inputs_from_precompute
from storage_tpu.valuation_inputs import prepare_valuation as jax_prepare
from storage_tpu_torch import checkpoint as ckpt
from storage_tpu_torch import grid as gridmod
from storage_tpu_torch.basis import parse_basis_functions
from storage_tpu_torch.engines import lsmc as torch_lsmc

torch.set_num_threads(1)

RTOL = 1e-9
BASIS = "1 + x0 + x0**2 + s"
F64 = torch.float64


def terminal_npv(price, inventory):
    return price * inventory


@pytest.fixture(scope="module")
def case():
    """The 60-day facility of tests/test_checkpoint.py: the port's engine
    arrays, and JAX-simulated regression and valuation paths as f64 tensors."""
    storage = jpkg.CmdtyStorage(
        "D", "2021-01-01", "2021-03-01", 0.9, 0.7, min_inventory=0.0, max_inventory=5_000.0,
        max_injection_rate=300.0, max_withdrawal_rate=300.0,
    )
    idx = pd.period_range("2021-01-01", storage.end, freq="D")
    i = np.arange(len(idx))
    fwd = pd.Series(index=idx, data=30.0 + 6 * np.sin(2 * np.pi * i / 30.0))
    inputs = jax_prepare(storage, "2021-01-01", 100.0, fwd, 0.02, None)
    pre = jax_mf.simulation_precompute(
        [(10.0, pd.Series(index=idx, data=0.8))], None, inputs.val_day, list(inputs.periods), "D")
    sim = sim_inputs_from_precompute(pre, inputs.fwd, jnp.float64)
    arrays = jax_lsmc.build_engine_arrays(
        inputs.compiled, inputs.fwd, inputs.df_settle, inputs.df_flow, inputs.inventory_lower,
        inputs.inventory_upper, 30, jnp.float64)

    def paths(seed):
        res = simulate_ou_paths(jax.random.key(seed), jnp.arange(300), sim["decay"], sim["chol"],
                                sim["vols"], sim["half_var"], sim["fwd"])
        return torch.tensor(np.asarray(res.spot)), torch.tensor(np.asarray(res.factors))

    t_arrays = {k: torch.tensor(np.asarray(v)) for k, v in arrays.items()}
    return t_arrays, paths(1), paths(2)


def _checkpoint(case, terminal_fn=None):
    arrays, reg, _ = case
    return ckpt.run_backward_to_checkpoint(arrays, *reg, BASIS, 100.0, terminal_fn=terminal_fn)


def test_forward_only_revaluation_is_the_full_runs_bits(case):
    arrays, reg, val = case
    full = torch_lsmc.lsmc_core(arrays, *reg, *val, 100.0, tuple(parse_basis_functions(BASIS)),
                                0, False, None, False)
    resumed = ckpt.revalue_from_checkpoint(_checkpoint(case), *val, device="cpu")
    assert float(resumed["npv"]) == float(full["npv"])
    torch.testing.assert_close(resumed["deltas"], full["deltas"], rtol=0, atol=0)


def test_save_load_roundtrip(case, tmp_path):
    _, _, val = case
    saved = _checkpoint(case)
    path = str(tmp_path / "ckpt.npz")
    saved.save(path)
    loaded = tpkg.checkpoint.RegressionCheckpoint.load(path)
    assert loaded.basis_funcs == BASIS and loaded.starting_inventory == 100.0
    r1 = ckpt.revalue_from_checkpoint(saved, *val, device="cpu")
    r2 = ckpt.revalue_from_checkpoint(loaded, *val, device="cpu")
    assert float(r1["npv"]) == float(r2["npv"])


def _same_checkpoint(a, b):
    for field in ("basis_funcs", "starting_inventory", "num_extra_decisions", "discount_deltas",
                  "ratchet_is_step", "must_be_empty_at_end"):
        assert getattr(a, field) == getattr(b, field), field
    for part in ("arrays", "regression"):
        assert set(getattr(a, part)) == set(getattr(b, part)), part
        for key, value in getattr(a, part).items():
            np.testing.assert_array_equal(getattr(b, part)[key], value, err_msg=key)


def test_checkpoints_cross_between_the_packages(case, tmp_path):
    arrays, reg, val = case
    ours = _checkpoint(case)
    ours.save(str(tmp_path / "port.npz"))
    _same_checkpoint(ours, jax_ckpt.RegressionCheckpoint.load(str(tmp_path / "port.npz")))

    j_arrays = {k: jnp.asarray(v.numpy()) for k, v in arrays.items()}
    theirs = jax_ckpt.run_backward_to_checkpoint(
        j_arrays, jnp.asarray(reg[0].numpy()), jnp.asarray(reg[1].numpy()), BASIS, 100.0)
    theirs.save(str(tmp_path / "jax.npz"))
    _same_checkpoint(theirs, ckpt.RegressionCheckpoint.load(str(tmp_path / "jax.npz")))


def test_jax_revaluation_of_the_ports_file_agrees(case, tmp_path):
    _, _, val = case
    path = str(tmp_path / "port.npz")
    _checkpoint(case).save(path)
    got = ckpt.revalue_from_checkpoint(ckpt.RegressionCheckpoint.load(path), *val, device="cpu")
    want = jax_ckpt.revalue_from_checkpoint(
        jax_ckpt.RegressionCheckpoint.load(path), jnp.asarray(val[0].numpy()),
        jnp.asarray(val[1].numpy()), dtype=jnp.float64)
    assert float(got["npv"]) == pytest.approx(float(want["npv"]), rel=RTOL)
    assert float(got["standard_error"]) == pytest.approx(float(want["standard_error"]), rel=RTOL)
    np.testing.assert_allclose(got["deltas"].numpy(), np.asarray(want["deltas"]), rtol=RTOL,
                               atol=RTOL)


def test_terminal_fn_required_when_not_empty(case):
    _, _, val = case
    saved = _checkpoint(case, terminal_fn=lambda p, i: p * i)
    with pytest.raises(ValueError, match="terminal_fn"):
        ckpt.revalue_from_checkpoint(saved, *val, device="cpu")


def _storage(pkg):
    start = pd.Period("2021-01-01", freq="D")
    return pkg.CmdtyStorage(
        "D", start, start + 45, 0.9, 0.7,
        ratchets=[(start, [(0.0, -200.0, 300.0), (2500.0, -250.0, 250.0)])],
        ratchet_interp=pkg.RatchetInterp.LINEAR,
        terminal_storage_npv=terminal_npv,
    ), start


def _three_factor(basis, **kwargs):
    storage, start = _storage(tpkg)
    fwd = pd.Series(index=pd.period_range(start, storage.end, freq="D"),
                    data=30.0 + np.arange(46) % 7)
    return tpkg.three_factor_seasonal_value(
        storage, start, 100.0, fwd, 0.02, None, 14.5, 1.1, 0.19, 0.23, 256, basis, False,
        seed=11, fwd_sim_seed=13, num_inventory_grid_points=20, dtype=F64, device="cpu",
        **kwargs)


def test_api_checkpoint_revalues_to_the_valuations_bits(tmp_path):
    path = str(tmp_path / "api.npz")
    flags = (tpkg.SimulationDataReturned.SPOT_VALUATION
             | tpkg.SimulationDataReturned.FACTORS_VALUATION)
    res = _three_factor("1 + x_st + x_lt + s", checkpoint_path=path, sim_data_returned=flags)
    loaded = ckpt.RegressionCheckpoint.load(path)
    assert loaded.basis_funcs == "1 + x_st + x_lt + s" and not loaded.must_be_empty_at_end
    spot = torch.tensor(res.sim_spot_valuation.to_numpy())
    factors = torch.stack([torch.tensor(f.to_numpy()) for f in res.sim_factors_valuation], dim=1)
    out = ckpt.revalue_from_checkpoint(loaded, spot, factors, terminal_fn=terminal_npv, device="cpu")
    assert float(out["npv"]) == res.npv
    assert float(out["standard_error"]) == res.val_sim_standard_error


def test_custom_grid_checkpoint_revalues_to_the_valuations_bits(tmp_path):
    """A checkpoint made on a ``dense_near_bottom`` grid (rows not evenly
    spaced) revalues on the valuation's own paths to its NPV bits: the
    revaluation places inventories on the stored rows by search, as the
    pricing run did.  The evenly spaced arithmetic on those rows (what the
    JAX package's revaluation does, storage_tpu/checkpoint.py:159-167) is
    another valuation."""
    path = str(tmp_path / "custom.npz")
    flags = (tpkg.SimulationDataReturned.SPOT_VALUATION
             | tpkg.SimulationDataReturned.FACTORS_VALUATION)
    res = _three_factor("1 + x_st + x_lt + s", checkpoint_path=path, sim_data_returned=flags,
                        grid_calc=lambda lo, hi: lo + (hi - lo) * np.linspace(0.0, 1.0, 20) ** 2)
    loaded = ckpt.RegressionCheckpoint.load(path)
    assert not gridmod.rows_uniform(loaded.arrays["grids"])
    spot = torch.tensor(res.sim_spot_valuation.to_numpy())
    factors = torch.stack([torch.tensor(f.to_numpy()) for f in res.sim_factors_valuation], dim=1)
    out = ckpt.revalue_from_checkpoint(loaded, spot, factors, terminal_fn=terminal_npv, device="cpu")
    assert float(out["npv"]) == res.npv
    assert float(out["standard_error"]) == res.val_sim_standard_error
    as_t = lambda a: torch.as_tensor(a, dtype=F64)  # noqa: E731
    arithmetic = torch_lsmc.lsmc_forward(
        {k: as_t(v) for k, v in loaded.arrays.items()}, spot, factors,
        {k: as_t(v) for k, v in loaded.regression.items()}, 100.0, loaded.monomials, 0, False,
        terminal_npv, loaded.ratchet_is_step)
    assert abs(float(arithmetic["npv"]) - res.npv) > 1e-6 * abs(res.npv)


def test_checkpoint_path_needs_a_basis_string(tmp_path):
    with pytest.raises(ValueError, match="requires basis_funcs as a string"):
        _three_factor(tpkg.ONE + tpkg.X0, checkpoint_path=str(tmp_path / "x.npz"))
