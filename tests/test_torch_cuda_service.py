"""Interactive valuations, checkpoints and the service layer on the card, at
a small size (4,096 sims, 60 daily steps, the headline's facility shape and
basis).  Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip
elsewhere.  This file imports no JAX, so it runs on the card with
``python -m pytest --noconftest tests/test_torch_cuda_service.py``.

* An interactive valuation gives the uninterrupted one's bits, kernel C
  launched once a 16-step segment; a cancel mid-backward raises
  ``JobCancelledError`` and the next valuation gives the same bits.
* A checkpoint's forward-only revaluation on the valuation's paths gives its
  NPV bits with one launch of kernel C and no backward kernel.
* ``CalculationService(device="cuda")`` and a two-thread
  ``ValuationJobEngine`` give the serial runs' bits; a calc cancelled
  through ``cancel_running`` ends ``CANCELLED``.
* The intrinsic DP kernel snaps its walk to the band as the plain DP does:
  the same NPV in f64 on a facility that must end empty, at E = 1 and 2.
"""
import time

import numpy as np
import pandas as pd
import pytest
import torch

import storage_tpu_torch as tpkg
from storage_tpu_torch import checkpoint as ckpt
from storage_tpu_torch.engines import intrinsic as intrinsic_engine
from storage_tpu_torch.engines import lsmc as lsmc_engine
from storage_tpu_torch.ops import decision_kernel, forward_kernel
from storage_tpu_torch.valuation_inputs import prepare_valuation

NUM_STEPS = 60
BASIS = "1 + x_st + x_lt + x_sw + x_st**2 + x_lt**2 + x_sw**2 + s + s**2"


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def terminal_npv(price, inventory):
    return price * inventory


def _case():
    start = pd.Period("2021-01-01", freq="D")
    storage = tpkg.CmdtyStorage(
        "D", start, start + NUM_STEPS, 0.9, 0.7,
        ratchets=[(start, [(0.0, -200.0, 300.0), (2500.0, -250.0, 250.0),
                           (5000.0, -300.0, 200.0)])],
        ratchet_interp=tpkg.RatchetInterp.LINEAR, terminal_storage_npv=terminal_npv)
    fwd = pd.Series(index=pd.period_range(start, storage.end, freq="D"),
                    data=30.0 + 6 * np.sin(2 * np.pi * np.arange(NUM_STEPS + 1) / 365.0))
    return storage, start, fwd


def _value(device, num_sims=4096, **kwargs):
    storage, start, fwd = _case()
    return tpkg.three_factor_seasonal_value(
        storage, start, 100.0, fwd, 0.02, None, 14.5, 1.1, 0.19, 0.23, num_sims, BASIS, False,
        seed=11, fwd_sim_seed=13, device=device, **kwargs)


def _same(got, want):
    return (got.npv, got.val_sim_standard_error) == (want.npv, want.val_sim_standard_error) and (
        got.deltas.equals(want.deltas) and got.expected_profile.equals(want.expected_profile))


@pytest.mark.cuda
def test_interactive_valuation_is_the_uninterrupted_bits(device):
    want = _value(device)
    fractions = []
    before = forward_kernel.forward_sweep.launches
    got = _value(device, on_progress_update=fractions.append, cancellation_poll=lambda: False)
    assert forward_kernel.forward_sweep.launches - before == -(-NUM_STEPS // 16)
    assert _same(got, want)
    assert fractions == sorted(fractions) and fractions[-1] == 1.0
    assert len(fractions) == 4 + 2 * -(-NUM_STEPS // 16)


@pytest.mark.cuda
def test_cancel_mid_backward_then_the_same_bits(device):
    want = _value(device)
    seen = []
    with pytest.raises(tpkg.JobCancelledError):
        _value(device, on_progress_update=seen.append,
               cancellation_poll=lambda: any(0.3 < f < 0.7 for f in seen))
    assert not any(f > 0.7 for f in seen)
    assert _same(_value(device), want)


@pytest.mark.cuda
def test_checkpoint_revaluation_launches_one_forward_sweep(device, tmp_path):
    path = str(tmp_path / "ck.npz")
    flags = (tpkg.SimulationDataReturned.SPOT_VALUATION
             | tpkg.SimulationDataReturned.FACTORS_VALUATION)
    res = _value(device, checkpoint_path=path, sim_data_returned=flags)
    spot = torch.tensor(res.sim_spot_valuation.to_numpy(), dtype=torch.float32)
    factors = torch.stack([torch.tensor(f.to_numpy(), dtype=torch.float32)
                           for f in res.sim_factors_valuation], dim=1)
    before = (forward_kernel.forward_sweep.launches,
              decision_kernel.decision_update_moments.launches)
    out = ckpt.revalue_from_checkpoint(ckpt.RegressionCheckpoint.load(path), spot, factors,
                                       terminal_fn=terminal_npv, device=device)
    assert float(out["npv"]) == res.npv
    assert (forward_kernel.forward_sweep.launches - before[0],
            decision_kernel.decision_update_moments.launches - before[1]) == (1, 0)


@pytest.mark.cuda
def test_service_and_job_engine_give_the_serial_bits(device):
    want = _value(device)
    storage, start, fwd = _case()
    kwargs = dict(val_date=start, inventory=100.0, fwd_curve=fwd, interest_rates=0.02,
                  settlement_rule=None, spot_mean_reversion=14.5, spot_vol=1.1,
                  long_term_vol=0.19, seasonal_vol=0.23, basis_funcs=BASIS,
                  discount_deltas=False, seed=11, fwd_sim_seed=13)
    with tpkg.CalculationService(device="cuda") as svc:
        sh = svc.create_storage("fac", **{"freq": "D", "storage_start": start,
                                          "storage_end": storage.end, "injection_cost": 0.9,
                                          "withdrawal_cost": 0.7,
                                          "ratchets": [(start, [(0.0, -200.0, 300.0),
                                                                (2500.0, -250.0, 250.0),
                                                                (5000.0, -300.0, 200.0)])],
                                          "ratchet_interp": tpkg.RatchetInterp.LINEAR,
                                          "terminal_storage_npv": terminal_npv})
        progress = []
        ch = svc.storage_value_three_factor("calc", sh, num_sims=4096, **kwargs)
        svc.subscribe_progress(ch, progress.append)
        svc.start_pending(ch)
        assert _same(svc.calc_result(ch), want)
        slow = svc.storage_value_three_factor("slow", sh, num_sims=262_144, **kwargs)
        svc.start_pending(slow)
        deadline = time.time() + 60
        while svc.calc_progress(slow) < 0.3 and time.time() < deadline:
            time.sleep(0.01)
        svc.cancel_running(slow)
        while svc.calc_status(slow) == tpkg.CalcStatus.RUNNING and time.time() < deadline:
            time.sleep(0.01)
        assert svc.calc_status(slow) == tpkg.CalcStatus.CANCELLED
    assert progress and progress[0] <= progress[-1]
    with tpkg.ValuationJobEngine(num_threads=2) as engine:
        jobs = [engine.submit(lambda ctl: _value(device)) for _ in range(2)]
        assert all(_same(job.result(), want) for job in jobs)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [1, 2])
def test_intrinsic_kernel_snaps_to_the_band_as_the_plain_dp(device, extra):
    start = pd.Period("2021-03-01", freq="D")
    storage = tpkg.CmdtyStorage(
        "D", start, start + 40, 0.05, 0.03,
        ratchets=[(start, [(0.0, -150.0, 250.0), (1500.0, -220.0, 180.0),
                           (3000.0, -300.0, 120.0)])],
        ratchet_interp=tpkg.RatchetInterp.LINEAR, cmdty_consumed_inject=0.01,
        cmdty_consumed_withdraw=0.005, inventory_loss=0.0005, inventory_cost=0.002)
    i = np.arange(41)
    fwd = pd.Series(index=pd.period_range(start, start + 40, freq="D"),
                    data=20.0 + 4.0 * np.sin(2 * np.pi * i / 17.0) + 0.3 * np.cos(i))
    inputs = prepare_valuation(storage, start, 800.0, fwd, 0.03, None)
    npvs = []
    for dev in ("cpu", device):
        arrays = lsmc_engine.build_engine_arrays(
            inputs.compiled, inputs.fwd, inputs.df_settle, inputs.df_flow,
            inputs.inventory_lower, inputs.inventory_upper, 15, torch.float64, dev)
        npvs.append(float(intrinsic_engine.intrinsic_core(arrays, 800.0, extra, None, False).npv))
    assert npvs[1] == pytest.approx(npvs[0], rel=1e-10)
