"""The native host runtime of storage_tpu_torch (``native/``) against the JAX
package (tests/test_native.py's cases).

* The C++ inventory-band reducer gives the port's pure-Python band and the
  JAX package's Python band (``use_native=False``) the same float64 bits on
  the ratcheted, simple and step facilities, the headline daily facility
  and a 1,000-step hourly one.  (The JAX package's own C++ copy blends the
  ratchet rates by weight and parts from its Python band by an ULP on the
  headline; the port's copy takes numpy.interp's arithmetic.)
* Infeasible facilities raise the JAX package's error from both paths; a
  polynomial constraint takes the Python path.
* The library builds from the port's own source into ``build/`` and a
  failed build raises with the compiler's output.
* The job engine: submit and result, an error, progress and cancellation,
  parallel jobs.
"""
import time

import numpy as np
import pandas as pd
import pytest

import storage_tpu as jpkg
import storage_tpu_torch as tpkg
from storage_tpu.grid import calculate_inventory_space as jax_space
from storage_tpu_torch import native
from storage_tpu_torch.grid import calculate_inventory_space as torch_space
from storage_tpu_torch.jobs import JobCancelledError, JobStatus, ValuationJobEngine


def _facility(pkg, kind: str):
    """(storage, starting inventory, valuation period)."""
    start = pd.Period("2021-01-01", freq="D")
    if kind == "ratcheted":
        ratchets = [
            (start, [(0.0, -40.0, 55.0), (500.0, -45.0, 50.0), (1000.0, -48.0, 46.0)]),
            (start + 100, [(0.0, -30.0, 45.0), (500.0, -35.0, 42.0), (1000.0, -38.0, 40.0)]),
        ]
        return pkg.CmdtyStorage("D", start, start + 200, 0.5, 0.4, ratchets=ratchets,
                                ratchet_interp=pkg.RatchetInterp.LINEAR,
                                inventory_loss=0.0005), 300.0, start
    if kind == "simple":
        return pkg.CmdtyStorage("D", "2021-01-01", "2021-06-01", 0.5, 0.4, min_inventory=0.0,
                                max_inventory=2000.0, max_injection_rate=80.0,
                                max_withdrawal_rate=90.0), 100.0, "2021-01-01"
    if kind == "step":
        ratchets = [(start, [(0.0, -40.0, 55.0), (500.0, -45.0, 50.0), (1000.0, -45.0, 50.0)])]
        return pkg.CmdtyStorage("D", start, start + 120, 0.5, 0.4, ratchets=ratchets,
                                ratchet_interp=pkg.RatchetInterp.STEP,
                                terminal_storage_npv=lambda p, i: 0.0), 300.0, start
    if kind == "headline":  # __graft_entry__._build_case
        ratchets = [(start, [(0.0, -200.0, 300.0), (2500.0, -250.0, 250.0),
                             (5000.0, -300.0, 200.0)])]
        return pkg.CmdtyStorage("D", start, start + 365, 0.9, 0.7, ratchets=ratchets,
                                ratchet_interp=pkg.RatchetInterp.LINEAR,
                                terminal_storage_npv=lambda price, inv: price * inv), 100.0, start
    # A 1,000-step hourly facility with linear ratchets and a loss.
    hour = pd.Period("2021-01-01 00:00", freq="h")
    ratchets = [(hour, [(0.0, -8.0, 12.0), (400.0, -9.0, 10.0), (800.0, -10.0, 7.5)])]
    return pkg.CmdtyStorage("h", hour, hour + 1000, 0.02, 0.01, ratchets=ratchets,
                            ratchet_interp=pkg.RatchetInterp.LINEAR,
                            inventory_loss=1e-5), 250.0, hour


@pytest.mark.parametrize("kind", ["ratcheted", "simple", "step", "headline", "hourly"])
def test_native_band_is_the_python_bands_bits(kind):
    storage, inventory, val = _facility(tpkg, kind)
    lo_cc, hi_cc = torch_space(storage, inventory, val, use_native=True)
    lo_py, hi_py = torch_space(storage, inventory, val, use_native=False)
    j_storage, _, _ = _facility(jpkg, kind)
    lo_jx, hi_jx = jax_space(j_storage, inventory, val, use_native=False)
    for got in (lo_cc, lo_py):
        np.testing.assert_array_equal(got, lo_jx)
    for got in (hi_cc, hi_py):
        np.testing.assert_array_equal(got, hi_jx)
    lo_default, _ = torch_space(storage, inventory, val)
    np.testing.assert_array_equal(lo_default, lo_cc)


def test_infeasible_raises_the_jax_error():
    def storage(pkg):
        return pkg.CmdtyStorage("D", "2021-01-01", "2021-01-11", 0.0, 0.0, min_inventory=0.0,
                                max_inventory=1000.0, max_injection_rate=10.0,
                                max_withdrawal_rate=10.0)

    with pytest.raises(jpkg.InventoryConstraintsCannotBeFulfilledException) as want:
        jax_space(storage(jpkg), 900.0, "2021-01-01", use_native=False)
    for flag in (False, True):
        with pytest.raises(tpkg.InventoryConstraintsCannotBeFulfilledException) as got:
            torch_space(storage(tpkg), 900.0, "2021-01-01", use_native=flag)
        assert str(got.value) == str(want.value)


def test_polynomial_constraint_takes_the_python_path():
    nodes = [(0.0, -160.0, 250.0), (500.0, -180.0, 260.0), (1000.0, -250.0, 220.0),
             (1500.0, -310.0, 140.0)]

    def storage(pkg):
        return pkg.CmdtyStorage("D", "2021-01-01", "2021-03-01", 0.8, 0.6,
                                ratchets=[("2021-01-01", nodes)],
                                ratchet_interp=pkg.RatchetInterp.POLYNOMIAL)

    got = torch_space(storage(tpkg), 200.0, "2021-01-01")
    want = jax_space(storage(jpkg), 200.0, "2021-01-01", use_native=False)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="unavailable for this facility"):
        torch_space(storage(tpkg), 200.0, "2021-01-01", use_native=True)


def test_library_builds_from_the_ports_source():
    path = native.library_path()
    native.load()
    assert path.exists() and path.parts[-4:-2] == ("storage_tpu_torch", "native")
    assert native.SOURCE.parent.name == "native" and native.SOURCE.parent.parent.name == (
        "storage_tpu_torch")


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text("int stpu_job_engine_create( { this is not C++ }\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on broken.cpp") as err:
        native.build()
    assert "error" in str(err.value)
    assert not list((tmp_path / "build").rglob("*.so*"))


def test_job_submit_and_result():
    with ValuationJobEngine(num_threads=2) as engine:
        job = engine.submit(lambda ctl: 41 + 1)
        assert job.result() == 42
        assert job.status == JobStatus.SUCCESS
        assert job.progress == 1.0


def test_job_error_propagates():
    def boom(ctl):
        raise ValueError("bad curve")

    with ValuationJobEngine(num_threads=1) as engine:
        job = engine.submit(boom)
        with pytest.raises(ValueError, match="bad curve"):
            job.result()
        assert job.status == JobStatus.ERROR


def test_job_progress_and_cancellation():
    started = []

    def slow(ctl):
        for i in range(200):
            started.append(i)
            ctl.report_progress(i / 200.0)  # raises once cancel requested
            time.sleep(0.01)
        return "done"

    with ValuationJobEngine(num_threads=1) as engine:
        job = engine.submit(slow)
        deadline = time.time() + 5
        while not started and time.time() < deadline:
            time.sleep(0.005)
        job.cancel()
        with pytest.raises(JobCancelledError):
            job.result()
        assert job.status == JobStatus.CANCELLED
        assert 0.0 <= job.progress < 1.0


def test_parallel_jobs():
    def work(k):
        def fn(ctl):
            time.sleep(0.05)
            return k * k
        return fn

    with ValuationJobEngine(num_threads=4) as engine:
        jobs = [engine.submit(work(k)) for k in range(8)]
        assert [j.result() for j in jobs] == [k * k for k in range(8)]
