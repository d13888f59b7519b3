"""Phase profiling for valuations (counterpart of ``storage_tpu.profiling``).

Analog of the reference's ``Stopwatches`` (LsmcValuation/Stopwatches.cs:33-50):
named wall-clock phase timers with a percentage report, logged at the end of a
valuation (LsmcStorageValuation.cs:646-652).  A phase synchronises only on
request (``sync``, e.g. ``torch.cuda.synchronize``), so that timing does not
stall the launches of the next phase.
"""
from __future__ import annotations

import contextlib
import time
import typing as tp


class Stopwatches:
    """Named phase timers.

    >>> sw = Stopwatches()
    >>> with sw.time("regression_simulation"):
    ...     ...
    >>> print(sw.report())
    """

    def __init__(self):
        self._elapsed: tp.Dict[str, float] = {}
        self._order: tp.List[str] = []
        self._total_start = time.perf_counter()

    @contextlib.contextmanager
    def time(self, phase: str, sync: tp.Optional[tp.Callable[[], None]] = None):
        start = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                sync()
            elapsed = time.perf_counter() - start
            if phase not in self._elapsed:
                self._order.append(phase)
                self._elapsed[phase] = 0.0
            self._elapsed[phase] += elapsed

    def elapsed(self, phase: str) -> float:
        return self._elapsed.get(phase, 0.0)

    @property
    def total(self) -> float:
        return time.perf_counter() - self._total_start

    def report(self) -> str:
        """Formatted phase report with percentages of total wall time
        (mirrors Stopwatches.GenerateProfileReport)."""
        total = self.total
        lines = [f"{'Phase':<28}{'Seconds':>10}{'Percent':>9}"]
        accounted = 0.0
        for phase in self._order:
            secs = self._elapsed[phase]
            accounted += secs
            lines.append(f"{phase:<28}{secs:>10.3f}{secs / total:>8.1%}")
        other = max(total - accounted, 0.0)
        lines.append(f"{'other':<28}{other:>10.3f}{other / total:>8.1%}")
        lines.append(f"{'total':<28}{total:>10.3f}{1:>8.1%}")
        return "\n".join(lines)
