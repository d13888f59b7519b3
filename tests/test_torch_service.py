"""The service layer of storage_tpu_torch against the JAX package:
``CalculationService`` (tests/test_calc_service.py's cases) and the command
line (tests/test_cli.py's cases), on the CPU.

* The service's valuations run on its device: in f64 its three-factor,
  intrinsic and tree results agree with the JAX service's within 1e-9
  relative (the entry points' own parity); a running calc cancelled through
  ``cancel_running`` ends ``CANCELLED``.  At 100 sims where the JAX test
  takes 128: the JAX service's interactive run then keeps to one of the
  suite's 8 virtual devices, which compiles in seconds, not half a minute.
* The CLI (``--device cpu``) on the JAX CLI's specs: the same printed lines
  and CSV files; the intrinsic value and profile within 1e-5 relative of
  the JAX CLI's and the tree within 1e-5 (both f32, the CLI's dtype); the
  three-factor NPV within half a standard error (f32 regressions round
  apart, as tests/test_torch_lsmc.py's f32 case finds);
  ``python -m storage_tpu_torch version`` runs.
* Without a card, a service or a CLI valuation that names no device raises.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from storage_tpu import calc_service as jax_service
from storage_tpu import cli as jax_cli
from storage_tpu_torch import cli
from storage_tpu_torch.calc_service import CalcMode, CalcStatus, CalculationService, ObjectCache

torch.set_num_threads(1)

RTOL = 1e-9
REPO = Path(__file__).resolve().parents[1]


def _storage_kwargs():
    return dict(
        freq="D", storage_start="2019-12-01", storage_end="2020-01-10",
        injection_cost=1.23, withdrawal_cost=0.98,
        min_inventory=0.0, max_inventory=10_000.0,
        max_injection_rate=700.0, max_withdrawal_rate=700.0,
    )


def _market():
    idx = pd.period_range("2019-11-20", "2020-01-10", freq="D")
    fwd = pd.Series(index=idx, data=np.linspace(23.0, 28.0, len(idx)))
    rates = pd.Series(index=pd.period_range("2019-11-20", "2020-03-01", freq="D"), data=0.03)

    def settle(period):
        return (period.asfreq("M").asfreq("D", "end") + 20).start_time.date()

    return fwd, rates, settle


def _three_factor_kwargs(jax: bool, num_sims=100):
    fwd, rates, settle = _market()
    return dict(val_date="2019-11-20", inventory=0.0, fwd_curve=fwd, interest_rates=rates,
                settlement_rule=settle, spot_mean_reversion=16.2, spot_vol=1.15,
                long_term_vol=0.14, seasonal_vol=0.18, num_sims=num_sims,
                basis_funcs="1 + x_st + x_lt + x_sw", discount_deltas=False, seed=11,
                fwd_sim_seed=11, dtype=jnp.float64 if jax else torch.float64,
                sim_data_returned="none")


def _wait_for(condition, seconds=10.0):
    deadline = time.time() + seconds
    while time.time() < deadline and not condition():
        time.sleep(0.02)
    return condition()


def test_object_cache_versioning():
    cache = ObjectCache()
    h1 = cache.add("storage", 1)
    h2 = cache.add("storage", 2)
    assert h1 == "storage#1" and h2 == "storage#2"
    assert cache.get(h2) == 2
    with pytest.raises(KeyError):
        cache.get(h1)  # superseded handles are evicted
    assert len(cache) == 1


def test_storage_probes_and_info():
    with CalculationService(device="cpu") as svc:
        handle = svc.create_storage("store1", **_storage_kwargs())
        assert handle == "store1#1"
        assert svc.storage_injection_rate(handle, "2019-12-05", 100.0) == 700.0
        assert svc.storage_withdrawal_rate(handle, "2019-12-05", 100.0) == 700.0
        assert svc.storage_min_inventory(handle, "2019-12-05") == 0.0
        assert svc.storage_max_inventory(handle, "2019-12-05") == 10_000.0
        assert svc.version()
        assert svc.linear_algebra_provider() == f"torch {torch.__version__}:cpu"


def test_async_three_factor_calc_with_subscriptions_matches_jax():
    with jax_service.CalculationService() as jsvc:
        jh = jsvc.storage_value_three_factor(
            "calc1", jsvc.create_storage("fac", **_storage_kwargs()),
            **_three_factor_kwargs(jax=True))
        want = jsvc.calc_result(jh)
    with CalculationService(calc_mode=CalcMode.ASYNC, device="cpu") as svc:
        sh = svc.create_storage("fac", **_storage_kwargs())
        ch = svc.storage_value_three_factor("calc1", sh, **_three_factor_kwargs(jax=False))
        assert svc.calc_status(ch) == CalcStatus.PENDING
        progresses, statuses = [], []
        svc.subscribe_progress(ch, progresses.append)
        svc.subscribe_status(ch, statuses.append)
        svc.start_pending(ch)
        result = svc.calc_result(ch)
        assert _wait_for(lambda: progresses and progresses[-1] == 1.0
                         and CalcStatus.SUCCESS in statuses)
        assert svc.get_object_property(ch, "npv") == result.npv
    assert result.npv == pytest.approx(want.npv, rel=RTOL)
    assert result.val_sim_standard_error == pytest.approx(want.val_sim_standard_error, rel=RTOL)


def test_cancel_before_start_and_reset():
    with CalculationService(calc_mode=CalcMode.ASYNC, device="cpu") as svc:
        sh = svc.create_storage("fac", **_storage_kwargs())
        ch = svc.storage_value_three_factor("calc2", sh, **_three_factor_kwargs(False, 64))
        svc.cancel_running(ch)
        assert svc.calc_status(ch) == CalcStatus.CANCELLED
        svc.start_pending(ch)  # no-op while cancelled
        assert svc.calc_status(ch) == CalcStatus.CANCELLED
        svc.reset_cancelled(ch)
        assert svc.calc_status(ch) == CalcStatus.PENDING
        svc.start_pending(ch)
        assert np.isfinite(svc.calc_result(ch).npv)


def test_cancel_running_calc_ends_cancelled():
    """The calc's own progress callback observes the cancel between
    segments."""
    with CalculationService(calc_mode=CalcMode.ASYNC, device="cpu") as svc:
        sh = svc.create_storage("fac", **_storage_kwargs())
        ch = svc.storage_value_three_factor("calc3", sh, **_three_factor_kwargs(False, 4096))
        svc.start_pending(ch)
        assert _wait_for(lambda: svc.calc_progress(ch) >= 0.2)
        svc.cancel_running(ch)
        assert _wait_for(lambda: svc.calc_status(ch) == CalcStatus.CANCELLED)
        assert svc.calc_progress(ch) < 1.0


def test_blocking_mode_and_trinomial_and_intrinsic_match_jax():
    fwd, rates, settle = _market()
    market = dict(val_date="2019-11-20", inventory=0.0, forward_curve=fwd, interest_rates=rates,
                  settlement_rule=settle)
    tree = dict(spot_volatility=pd.Series(index=fwd.index, data=0.6), mean_reversion=14.5,
                time_step=1 / 365.0)

    def values(svc, dtype):
        sh = svc.create_storage("fac", **_storage_kwargs())
        ih = svc.storage_intrinsic_value("icalc", sh, dtype=dtype, **market)
        assert svc.calc_status(ih).name == "SUCCESS"
        th = svc.storage_value_trinomial_tree("tcalc", sh, dtype=dtype, **market, **tree)
        vh = svc.storage_value_intrinsic("vcalc", sh, dtype=dtype, **market)
        out = (svc.calc_result(ih).npv, float(svc.calc_result(th)), svc.calc_result(vh))
        assert svc.number_of_running_calculations == 0
        return out

    with jax_service.CalculationService(calc_mode=jax_service.CalcMode.BLOCKING) as jsvc:
        want = values(jsvc, jnp.float64)
    with CalculationService(calc_mode=CalcMode.BLOCKING, device="cpu") as svc:
        got = values(svc, torch.float64)
    intrinsic, tree_npv, intrinsic_again = got
    assert tree_npv >= intrinsic - 1e-6  # the tree values the optionality
    assert intrinsic_again == pytest.approx(intrinsic)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def _bunched(lo, hi):
    return lo + (hi - lo) * np.linspace(0.0, 1.0, 30) ** 1.5


@pytest.mark.parametrize("option", [dict(deltas_method="adjoint"), dict(grid_calc=_bunched)],
                         ids=["adjoint", "grid-calc"])
def test_three_factor_calc_options_match_jax(option):
    """``deltas_method="adjoint"`` and ``grid_calc`` pass through the
    service's three-factor calc unchanged: its result is the JAX service's
    within 1e-9."""
    with jax_service.CalculationService(calc_mode=jax_service.CalcMode.BLOCKING) as jsvc:
        want = jsvc.calc_result(jsvc.storage_value_three_factor(
            "calc", jsvc.create_storage("fac", **_storage_kwargs()),
            **_three_factor_kwargs(jax=True), **option))
    with CalculationService(calc_mode=CalcMode.BLOCKING, device="cpu") as svc:
        got = svc.calc_result(svc.storage_value_three_factor(
            "calc", svc.create_storage("fac", **_storage_kwargs()),
            **_three_factor_kwargs(jax=False), **option))
    assert got.npv == pytest.approx(want.npv, rel=RTOL)
    np.testing.assert_allclose(got.deltas, want.deltas, rtol=RTOL,
                               atol=RTOL * np.abs(want.deltas.to_numpy()).max())


# ---------------------------------------------------------------- the CLI


@pytest.fixture()
def specs(tmp_path):
    """tests/test_cli.py's specs, at 100 sims (see the service's note)."""
    facility = {
        "freq": "D", "start": "2021-04-01", "end": "2021-06-01",
        "injection_cost": 0.01, "withdrawal_cost": 0.025,
        "ratchets": [["2021-04-01", [[0, -150, 250], [2000, -200, 175]]]],
        "ratchet_interp": "linear",
    }
    idx = pd.period_range("2021-04-01", "2021-06-01", freq="D")
    market = {
        "val_date": "2021-04-01", "inventory": 0.0, "interest_rate": 0.03,
        "fwd": {str(p): round(20.0 + 4.0 * np.sin(i / 365 * 2 * np.pi), 4)
                for i, p in enumerate(idx)},
        "settlement_lag_days": 20,
    }
    model = {
        "spot_mean_reversion": 16.2, "spot_vol": 1.15, "long_term_vol": 0.14,
        "seasonal_vol": 0.18, "num_sims": 100, "seed": 11,
    }
    tree = {"spot_vol": 0.7, "mean_reversion": 14.5, "time_delta": 0.00274}
    paths = {}
    for name, spec in (("facility", facility), ("market", market), ("model", model),
                       ("tree", tree)):
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps(spec))
        paths[name] = str(p)
    paths["out"] = str(tmp_path / "out")
    paths["jax_out"] = str(tmp_path / "jax_out")
    return paths


def _both(capsys, args, out=None):
    """The port's CLI (``--device cpu``) and the JAX package's on the same
    arguments: their printed lines, as (port, JAX)."""
    extra = ["--out", out[0]] if out else []
    assert cli.main([*args, *extra, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    extra = ["--out", out[1]] if out else []
    assert jax_cli.main([*args, *extra]) == 0
    return got, capsys.readouterr().out


def _values(out: str) -> dict:
    return {line.split()[0]: float(line.split()[1].replace(",", ""))
            for line in out.strip().splitlines()}


def test_cli_version():
    out = subprocess.run([sys.executable, "-m", "storage_tpu_torch", "version"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("storage_tpu_torch ") and f"torch {torch.__version__}" in out.stdout


def test_cli_create_storage_and_probe(specs, capsys):
    args = ["create-storage", specs["facility"], "--probe", "2021-05-01:500"]
    assert cli.main(args) == 0
    got = capsys.readouterr().out
    assert jax_cli.main(args) == 0
    assert got == capsys.readouterr().out
    assert "inject_rate=231.25" in got and "withdraw_rate=-162.5" in got


def test_cli_intrinsic_matches_jax(specs, capsys):
    got, want = _both(capsys, ["intrinsic", specs["facility"], specs["market"]],
                      out=(specs["out"], specs["jax_out"]))
    assert _values(got)["intrinsic_npv"] == pytest.approx(_values(want)["intrinsic_npv"],
                                                          rel=1e-5)
    read = lambda d: pd.read_csv(os.path.join(d, "intrinsic_profile.csv"), index_col=0)  # noqa: E731
    pd.testing.assert_frame_equal(read(specs["out"]), read(specs["jax_out"]), rtol=1e-5,
                                  atol=1e-3)


def test_cli_three_factor_matches_jax(specs, capsys):
    args = ["three-factor", specs["facility"], specs["market"], specs["model"], "--quiet",
            "--grid-points", "40"]
    got, want = _both(capsys, args, out=(specs["out"], specs["jax_out"]))
    g, w = _values(got), _values(want)
    assert g.keys() == w.keys() == {"npv", "intrinsic_npv", "extrinsic_npv", "standard_error"}
    assert g["npv"] >= g["intrinsic_npv"] > 0
    assert g["npv"] == pytest.approx(g["intrinsic_npv"] + g["extrinsic_npv"], abs=0.021)
    assert abs(g["npv"] - w["npv"]) < 0.5 * w["standard_error"]
    assert g["intrinsic_npv"] == pytest.approx(w["intrinsic_npv"], rel=1e-5)
    for name in ("deltas.csv", "expected_profile.csv", "intrinsic_profile.csv",
                 "trigger_prices.csv"):
        ours, theirs = _csvs(specs, name)
        assert ours.shape == theirs.shape and list(ours.columns) == list(theirs.columns), name
        pd.testing.assert_index_equal(ours.index, theirs.index)
    # The intrinsic DP is deterministic: f32 values to 1e-5 (as the intrinsic
    # command's profile).  At 100 f32 sims the LSMC columns part on near-tie
    # regressions; test_cli_three_factor_csvs_match_jax_in_f64 holds them.
    pd.testing.assert_frame_equal(*_csvs(specs, "intrinsic_profile.csv"), rtol=1e-5, atol=1e-3)


def _csvs(specs, name):
    """The port's and the JAX CLI's result CSV ``name``."""
    return tuple(pd.read_csv(os.path.join(specs[d], name), index_col=0)
                 for d in ("out", "jax_out"))


def test_cli_three_factor_csvs_match_jax_in_f64(specs, capsys, monkeypatch):
    """Both CLIs' three-factor command with the valuation taken in f64 (the
    CLIs take the API's f32 default; each resolves the API function when it
    runs, so the patch reaches it): every value of every result CSV agrees at
    the f64 tolerance of tests/test_torch_lsmc.py's valuation test (rtol 1e-9,
    trigger prices 1e-7), so no column can be wrong or swapped."""
    from storage_tpu import api_lsmc as jax_api_lsmc
    from storage_tpu_torch import api_lsmc as torch_api_lsmc

    for module, dtype in ((jax_api_lsmc, jnp.float64), (torch_api_lsmc, torch.float64)):
        value = module.three_factor_seasonal_value
        monkeypatch.setattr(module, "three_factor_seasonal_value",
                            lambda *a, _value=value, _dtype=dtype, **k: _value(*a, dtype=_dtype, **k))
    args = ["three-factor", specs["facility"], specs["market"], specs["model"], "--quiet",
            "--grid-points", "40"]
    got, want = _both(capsys, args, out=(specs["out"], specs["jax_out"]))
    g, w = _values(got), _values(want)
    for key in w:  # printed to cents
        assert abs(g[key] - w[key]) <= 0.011, key
    for name, rtol in (("deltas.csv", RTOL), ("expected_profile.csv", RTOL),
                       ("intrinsic_profile.csv", 0.0), ("trigger_prices.csv", 1e-7)):
        ours, theirs = _csvs(specs, name)
        pd.testing.assert_frame_equal(ours, theirs, rtol=rtol, atol=1e-6 if rtol == 0 else 1e-7,
                                      check_exact=False, obj=name)


def test_cli_adjoint_deltas_match_jax_in_f64(specs, capsys, monkeypatch):
    """The model spec's ``deltas_method`` key: both CLIs' adjoint deltas in
    f64 (the patch of ``test_cli_three_factor_csvs_match_jax_in_f64``) agree
    within 1e-9, and equal the port's pathwise ones for t < N."""
    from storage_tpu import api_lsmc as jax_api_lsmc
    from storage_tpu_torch import api_lsmc as torch_api_lsmc

    for module, dtype in ((jax_api_lsmc, jnp.float64), (torch_api_lsmc, torch.float64)):
        value = module.three_factor_seasonal_value
        monkeypatch.setattr(module, "three_factor_seasonal_value",
                            lambda *a, _value=value, _dtype=dtype, **k: _value(*a, dtype=_dtype, **k))
    args = ["three-factor", specs["facility"], specs["market"], specs["model"], "--quiet",
            "--grid-points", "40"]
    assert cli.main([*args, "--out", specs["out"], "--device", "cpu"]) == 0
    pathwise = pd.read_csv(os.path.join(specs["out"], "deltas.csv"), index_col=0)
    model = json.loads(Path(specs["model"]).read_text())
    Path(specs["model"]).write_text(json.dumps({**model, "deltas_method": "adjoint"}))
    _both(capsys, args, out=(specs["out"], specs["jax_out"]))
    ours, theirs = _csvs(specs, "deltas.csv")
    pd.testing.assert_frame_equal(ours, theirs, rtol=RTOL, atol=1e-7, check_exact=False)
    np.testing.assert_allclose(ours.to_numpy()[:-1], pathwise.to_numpy()[:-1], rtol=RTOL,
                               atol=1e-7)


def test_cli_trinomial_matches_jax(specs, capsys):
    got, want = _both(capsys, ["trinomial", specs["facility"], specs["market"], specs["tree"],
                               "--grid-points", "40"])
    assert _values(got)["trinomial_npv"] == pytest.approx(_values(want)["trinomial_npv"],
                                                          rel=1e-5)


def test_entry_points_naming_no_device_raise_without_a_card(specs):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        CalculationService()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["intrinsic", specs["facility"], specs["market"]])
