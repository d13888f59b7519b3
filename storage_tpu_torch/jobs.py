"""Asynchronous valuation jobs on the native C++ job engine (counterpart of
``storage_tpu.jobs``).

The analog of the reference Excel add-in's async calculation machinery
(``ExcelCalcWrapper.cs:33-187``: Pending/Running/Success/Error/Cancelled job
states, progress events, cooperative cancellation; ``ObjectCache.cs:34-49``
handle registry; ``CachedObjectsXl.cs:40-186`` start/cancel/status functions).
The scheduler, state machine and progress/cancellation flags live in native
code (``native/storage_native.cpp``); Python supplies the valuation callables,
which run on the engine's threads and launch their kernels from there.

Typical use::

    engine = ValuationJobEngine(num_threads=2)
    job = engine.submit(lambda ctl: three_factor_seasonal_value(
        ..., on_progress_update=ctl.report_progress))
    job.status, job.progress   # poll
    job.cancel()               # cooperative: the callable sees ctl.cancelled
    result = job.result()      # blocks; raises on error/cancellation
"""
from __future__ import annotations

import enum
import threading
import typing as tp

from . import native


class JobStatus(enum.Enum):
    PENDING = native.JOB_PENDING
    RUNNING = native.JOB_RUNNING
    SUCCESS = native.JOB_SUCCESS
    ERROR = native.JOB_ERROR
    CANCELLED = native.JOB_CANCELLED


class JobCancelledError(RuntimeError):
    """The job observed a cancellation request and stopped
    (the OperationCanceledException analog, LsmcStorageValuation.cs:345)."""


class JobControl:
    """Handed to the job callable: progress reporting + cancellation polling."""

    def __init__(self, engine: "ValuationJobEngine", job_id: int):
        self._engine = engine
        self._job_id = job_id

    def report_progress(self, fraction: float) -> None:
        self._engine._lib.stpu_job_set_progress(
            self._engine._handle, self._job_id, float(fraction)
        )
        if self.cancelled:
            raise JobCancelledError("Job cancelled.")

    @property
    def cancelled(self) -> bool:
        return (
            self._engine._lib.stpu_job_cancel_requested(
                self._engine._handle, self._job_id
            )
            == 1
        )


class Job:
    def __init__(self, engine: "ValuationJobEngine", job_id: int):
        self._engine = engine
        self.job_id = job_id

    @property
    def status(self) -> JobStatus:
        return JobStatus(self._engine._lib.stpu_job_status(self._engine._handle, self.job_id))

    @property
    def progress(self) -> float:
        return self._engine._lib.stpu_job_progress(self._engine._handle, self.job_id)

    def cancel(self) -> None:
        self._engine._lib.stpu_job_request_cancel(self._engine._handle, self.job_id)

    def wait(self) -> JobStatus:
        return JobStatus(self._engine._lib.stpu_job_wait(self._engine._handle, self.job_id))

    def result(self):
        """Block until done; return the callable's result or raise its error."""
        status = self.wait()
        if status == JobStatus.SUCCESS:
            return self._engine._results[self.job_id]
        if status == JobStatus.CANCELLED:
            raise JobCancelledError("Job cancelled.")
        exc = self._engine._errors.get(self.job_id)
        raise exc if exc is not None else RuntimeError("Job failed.")

    def exception(self) -> tp.Optional[BaseException]:
        return self._engine._errors.get(self.job_id)


class ValuationJobEngine:
    """Thread-pooled async executor for valuation callables."""

    def __init__(self, num_threads: int = 2):
        self._lib = native.load()
        self._handle = self._lib.stpu_job_engine_create(int(num_threads))
        self._results: tp.Dict[int, tp.Any] = {}
        self._errors: tp.Dict[int, BaseException] = {}
        self._callbacks: tp.Dict[int, tp.Any] = {}  # keep ctypes thunks alive
        self._lock = threading.Lock()

    def submit(self, fn: tp.Callable[[JobControl], tp.Any]) -> Job:
        """Queue ``fn(control)`` on the native pool; returns a Job handle."""

        def trampoline(job_id: int, _ctx):
            # A ctypes callback cannot raise: every outcome becomes a status.
            control = JobControl(self, job_id)
            try:
                result = fn(control)
            except JobCancelledError:
                self._lib.stpu_job_set_status(self._handle, job_id, native.JOB_CANCELLED)
            except BaseException as exc:  # noqa: BLE001 - job boundary
                with self._lock:
                    self._errors[job_id] = exc
                self._lib.stpu_job_set_status(self._handle, job_id, native.JOB_ERROR)
            else:
                with self._lock:
                    self._results[job_id] = result
                self._lib.stpu_job_set_progress(self._handle, job_id, 1.0)

        thunk = native.JOB_FN(trampoline)
        job_id = self._lib.stpu_job_submit(self._handle, thunk, None)
        with self._lock:
            self._callbacks[job_id] = thunk
        return Job(self, job_id)

    @property
    def num_running(self) -> int:
        return self._lib.stpu_job_engine_num_running(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.stpu_job_engine_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
