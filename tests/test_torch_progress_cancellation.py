"""Interactive valuations of storage_tpu_torch against the JAX package:
progress callbacks and cooperative cancellation
(tests/test_progress_cancellation.py's cases).

* The progress fractions of ``multi_factor_value`` equal the JAX package's
  list on its 122-step case (0.2, 0.3, one tick a 16-step segment of each
  pass, 0.9, 1.0): both monotone, at least N/16 ticks a pass.  At 100 sims
  where the JAX test takes 128: a count that the suite's 8 virtual devices
  do not divide keeps the JAX package on its one-device host-chunked path,
  which compiles in a quarter of the sharded path's minute.
* An interactive valuation gives the uninterrupted one's bits: f64 and f32,
  ``value_from_sims`` on spot+factor and spot-only panels, a generic basis
  (the forward's design built a segment at a time) and the engine's
  ``fullstep=True``; the engine calls back once a segment of each pass.
* A poll that turns true mid-backward raises ``JobCancelledError`` at the
  same poll as in the JAX package, before any forward progress.
* In f64, the port's interactive NPV, SE and deltas against the JAX
  package's interactive run within 1e-9 relative, the tolerance of
  tests/test_torch_value_from_sims.py (both regress on exactly standardised
  designs; only the sums round apart).
"""
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import storage_tpu as jpkg
import storage_tpu_torch as tpkg
from storage_tpu.jobs import JobCancelledError as JaxCancelled
from storage_tpu_torch.basis import parse_basis_functions
from storage_tpu_torch.engines import lsmc as torch_lsmc
from storage_tpu_torch.jobs import JobCancelledError

torch.set_num_threads(1)

RTOL = 1e-9
BASIS = "1 + x0 + x0**2 + x1"
NUM_STEPS = 122
NUM_SIMS = 100


def _case(pkg):
    """The 2F regression facility and market of tests/test_lsmc.py."""
    storage = pkg.CmdtyStorage(
        "D", "2019-12-01", "2020-04-01", 1.23, 0.98,
        min_inventory=0.0, max_inventory=100_000.0,
        max_injection_rate=700.0, max_withdrawal_rate=700.0,
    )
    val_date = "2019-08-29"
    idx = pd.period_range(val_date, "2020-04-01", freq="D")
    fwd = pd.Series(index=idx, data=[23.87 if p < pd.Period("2020-03-12", freq="D") else 150.32
                                     for p in idx])
    rates = pd.Series(index=pd.period_range(val_date, "2020-06-01", freq="D"), data=0.03)

    def settle(period):
        return (period.asfreq("M").asfreq("D", "end") + 20).start_time.date()

    vol_idx = pd.period_range(val_date, "2020-06-01", freq="D")
    factors = [(0.0, pd.Series(index=vol_idx, data=0.14)),
               (16.2, pd.Series(index=vol_idx.copy(), data=1.15))]
    return storage, (val_date, 0.0, fwd, rates, settle), factors


def _run(pkg, dtype=None, basis=BASIS, **kwargs):
    storage, market, factors = _case(pkg)
    extra = dict(dtype=jnp.float64) if pkg is jpkg else dict(dtype=dtype or torch.float64,
                                                              device="cpu")
    return pkg.multi_factor_value(storage, *market, factors, 0.64, NUM_SIMS, basis, False,
                                  seed=11, fwd_sim_seed=11, **extra, **kwargs)


def _from_sims(source, spot_only: bool, **kwargs):
    storage, market, _ = _case(tpkg)
    factors = {} if spot_only else dict(sim_factors_regress=source.sim_factors_regress,
                                        sim_factors_valuation=source.sim_factors_valuation)
    return tpkg.value_from_sims(
        storage, *market, source.sim_spot_regress, source.sim_spot_valuation,
        "1 + s + s**2" if spot_only else BASIS, False, dtype=torch.float64, device="cpu",
        **factors, **kwargs)


def _assert_same_bits(got, want):
    assert got.npv == want.npv
    assert got.val_sim_standard_error == want.val_sim_standard_error
    pd.testing.assert_series_equal(got.deltas, want.deltas, check_exact=True)
    pd.testing.assert_frame_equal(got.expected_profile, want.expected_profile, check_exact=True)
    pd.testing.assert_frame_equal(got.trigger_prices, want.trigger_prices, check_exact=True)


def _assert_monotone_with_both_passes(fractions):
    assert fractions == sorted(fractions)
    assert fractions[-1] == 1.0
    assert sum(0.3 < f <= 0.7 for f in fractions) >= NUM_STEPS / 16
    assert sum(0.7 < f < 0.9 for f in fractions) >= NUM_STEPS / 16 - 1


def test_progress_fractions_equal_jax():
    got, want = [], []
    _run(tpkg, on_progress_update=got.append)
    _run(jpkg, on_progress_update=want.append)
    assert got == want
    assert len(got) == 2 + 2 * -(-NUM_STEPS // 16) + 2
    _assert_monotone_with_both_passes(got)


@pytest.fixture(scope="module")
def source():
    """The case's valuation with its path panels, for value_from_sims."""
    return _run(tpkg, sim_data_returned=tpkg.SimulationDataReturned.ALL)


@pytest.mark.parametrize("kind", ["f64", "f32", "generic", "panels", "spot-only"])
def test_interactive_gives_the_uninterrupted_bits(kind, source):
    fractions = []
    if kind in ("panels", "spot-only"):
        spot_only = kind == "spot-only"
        want = _from_sims(source, spot_only)
        got = _from_sims(source, spot_only, on_progress_update=fractions.append,
                         cancellation_poll=lambda: False)
    else:
        kwargs = dict(dtype=torch.float32) if kind == "f32" else {}
        if kind == "generic":
            kwargs["basis"] = (tpkg.ONE + tpkg.X0 + tpkg.X0 ** 2
                               + tpkg.generic(lambda s, x: x[1], num_factors=2, label="x1"))
        want = _run(tpkg, **kwargs)
        got = _run(tpkg, on_progress_update=fractions.append, **kwargs)
    _assert_same_bits(got, want)
    _assert_monotone_with_both_passes(fractions)


@pytest.mark.parametrize("fullstep", [False, True], ids=["kernel-b", "fullstep"])
def test_engine_calls_back_once_a_segment(fullstep, source):
    """40 steps in 16-step segments: 3 calls a pass, the backward's from the
    last step down; the results are the uninterrupted engine's bits."""
    f64 = torch.float64
    panel = lambda frame: torch.tensor(frame.to_numpy()[:41], dtype=f64)  # noqa: E731
    spot_reg, spot_val = panel(source.sim_spot_regress), panel(source.sim_spot_valuation)
    fac_reg = torch.stack([panel(f) for f in source.sim_factors_regress], dim=1)
    fac_val = torch.stack([panel(f) for f in source.sim_factors_valuation], dim=1)
    storage, market, _ = _case(tpkg)
    from storage_tpu_torch.valuation_inputs import prepare_valuation

    inputs = prepare_valuation(storage, *market)
    arrays = {k: v[:41] if v.shape[0] == NUM_STEPS + 1 else v[:40]
              for k, v in torch_lsmc.build_engine_arrays(
                  inputs.compiled, inputs.fwd, inputs.df_settle, inputs.df_flow,
                  inputs.inventory_lower, inputs.inventory_upper, 20, f64, "cpu").items()}
    args = (arrays, spot_reg, fac_reg, spot_val, fac_val, 0.0,
            tuple(parse_basis_functions(BASIS)), 0, False, None, False)
    want = torch_lsmc.lsmc_core(*args, fullstep=fullstep)
    calls = []
    got = torch_lsmc.lsmc_core_chunked(*args, fullstep=fullstep,
                                       segment_cb=lambda *a: calls.append(a))
    assert calls == [("backward", 1, 3), ("backward", 2, 3), ("backward", 3, 3),
                     ("forward", 1, 3), ("forward", 2, 3), ("forward", 3, 3)]
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, equal_nan=True,
                                   msg=key)


def _cancel_index(pkg, cancelled_error):
    """The poll at which a poll that turns true once backward progress has
    fired raises, and the fractions seen."""
    seen, polls = [], []

    def poll():
        polls.append(len(seen))
        return any(0.3 < f < 0.7 for f in seen)

    with pytest.raises(cancelled_error):
        _run(pkg, on_progress_update=seen.append, cancellation_poll=poll)
    return len(polls), seen


def test_cancel_mid_backward_at_the_same_poll_as_jax():
    got_polls, got_seen = _cancel_index(tpkg, JobCancelledError)
    want_polls, want_seen = _cancel_index(jpkg, JaxCancelled)
    assert (got_polls, got_seen) == (want_polls, want_seen)
    assert not any(f > 0.7 for f in got_seen)
    assert tpkg.JobCancelledError is JobCancelledError


def test_no_cancel_completes():
    assert np.isfinite(_run(tpkg, cancellation_poll=lambda: False).npv)


def test_interactive_npv_close_to_jax_interactive_f64():
    got = _run(tpkg, on_progress_update=lambda f: None)
    want = _run(jpkg, on_progress_update=lambda f: None)
    assert got.npv == pytest.approx(want.npv, rel=RTOL)
    assert got.val_sim_standard_error == pytest.approx(want.val_sim_standard_error, rel=RTOL)
    np.testing.assert_allclose(got.deltas, want.deltas, rtol=RTOL, atol=RTOL)
