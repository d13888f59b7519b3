"""``storage_tpu_torch.profiling.Stopwatches`` against the JAX package's:
the same phases, report layout and on-request synchronisation."""
import time

from storage_tpu.profiling import Stopwatches as JaxStopwatches
from storage_tpu_torch.profiling import Stopwatches


def test_phases_report_and_sync_match_jax():
    reports, syncs = [], {}
    for cls in (JaxStopwatches, Stopwatches):
        calls = syncs.setdefault(cls, [])
        sw = cls()
        with sw.time("simulation", sync=lambda calls=calls: calls.append("simulation")):
            time.sleep(0.02)
        with sw.time("backward_induction"):
            time.sleep(0.01)
        with sw.time("simulation"):
            pass
        assert sw.elapsed("simulation") >= 0.02 and sw.elapsed("missing") == 0.0
        reports.append([line.split()[0] for line in sw.report().splitlines()])
    assert reports[0] == reports[1] == ["Phase", "simulation", "backward_induction", "other",
                                        "total"]
    assert syncs[JaxStopwatches] == syncs[Stopwatches] == ["simulation"]
