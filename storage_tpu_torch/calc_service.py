"""Handle-based asynchronous calculation service (counterpart of
``storage_tpu.calc_service``).

The framework analog of the reference Excel add-in (``src/Cmdty.Storage.Excel/``,
SURVEY.md §2.4) re-imagined as an embeddable Python service: spreadsheet
worksheet functions become service methods, the Excel-DNA object-handle cache
becomes :class:`ObjectCache`, and the RTD progress/status observables become
subscription callbacks pushed from a watcher thread.  The heavy lifting runs
on the native C++ job engine (``jobs.ValuationJobEngine``), whose threads
launch the valuations' kernels on the service's ``device``.

Mapping to the reference:

=======================================  =====================================
Reference (file:symbol)                  Here
=======================================  =====================================
ObjectCache.cs:34-49                     ObjectCache
ExcelCalcWrapper.cs:33-187               CalcWrapper (Pending/Running/... states)
AddIn.cs:28 CalcMode                     CalcMode.BLOCKING / CalcMode.ASYNC
CmdtyStorageXl.cs:37-113                 create_storage, storage_injection_rate,
                                         storage_withdrawal_rate,
                                         storage_min_inventory, storage_max_inventory
MultiFactorXl.cs:41-79                   storage_value_three_factor
IntrinsicXl.cs:38                        storage_intrinsic_value
TrinomialXl.cs:39-188                    storage_value_trinomial_tree,
                                         storage_value_intrinsic
CurvesXl.cs:41                           interpolate_curve_to_daily (re-export)
AddInInfoXl.cs:34-51                     version, linear_algebra_provider
CachedObjectsXl.cs:40-186                start_pending, cancel_running,
                                         reset_cancelled, subscribe_progress,
                                         subscribe_status, subscribe_error,
                                         get_object_property,
                                         number_of_running_calculations
CalcWrapper*Observable.cs                Subscription (watcher-thread push)
=======================================  =====================================
"""
from __future__ import annotations

import enum
import threading
import time
import typing as tp

import torch

from . import api as _api
from . import api_lsmc as _api_lsmc
from .api import Device, resolve_device
from .curves import interpolate_curve_to_daily  # noqa: F401  (service re-export)
from .facility import CmdtyStorage
from .jobs import Job, JobStatus, ValuationJobEngine


class CalcMode(enum.Enum):
    BLOCKING = "blocking"
    ASYNC = "async"


class ObjectCache:
    """Handle-string-keyed registry of live objects (ObjectCache.cs:34-49).

    Handles are ``name#version`` — re-adding under the same name bumps the
    version and evicts the old object, mirroring Excel recalculation semantics.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._objects: tp.Dict[str, tp.Any] = {}
        self._versions: tp.Dict[str, int] = {}

    def add(self, name: str, obj: tp.Any) -> str:
        with self._lock:
            version = self._versions.get(name, 0) + 1
            self._versions[name] = version
            stale = [h for h in self._objects if h.rsplit("#", 1)[0] == name]
            for h in stale:
                del self._objects[h]
            handle = f"{name}#{version}"
            self._objects[handle] = obj
            return handle

    def get(self, handle: str) -> tp.Any:
        with self._lock:
            try:
                return self._objects[handle]
            except KeyError:
                raise KeyError(f"No cached object with handle '{handle}'.") from None

    def remove(self, handle: str) -> None:
        with self._lock:
            self._objects.pop(handle, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._objects)


class CalcStatus(enum.Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCESS = "Success"
    ERROR = "Error"
    CANCELLED = "Cancelled"


_JOB_TO_CALC = {
    JobStatus.PENDING: CalcStatus.PENDING,
    JobStatus.RUNNING: CalcStatus.RUNNING,
    JobStatus.SUCCESS: CalcStatus.SUCCESS,
    JobStatus.ERROR: CalcStatus.ERROR,
    JobStatus.CANCELLED: CalcStatus.CANCELLED,
}


class CalcWrapper:
    """One valuation calculation with deferred start, progress, cancellation
    and reset (ExcelCalcWrapper.cs:33-187)."""

    def __init__(self, engine: ValuationJobEngine, fn: tp.Callable, mode: CalcMode):
        self._engine = engine
        self._fn = fn
        self._mode = mode
        self._lock = threading.Lock()
        self._job: tp.Optional[Job] = None
        self._cancelled_before_start = False
        if mode == CalcMode.BLOCKING:
            self.start()

    def start(self) -> None:
        with self._lock:
            if self._job is not None or self._cancelled_before_start:
                return
            job = self._engine.submit(
                lambda ctl: self._fn(ctl.report_progress, lambda: ctl.cancelled)
            )
            self._job = job
        if self._mode == CalcMode.BLOCKING:
            job.wait()

    @property
    def status(self) -> CalcStatus:
        with self._lock:
            if self._job is None:
                return (
                    CalcStatus.CANCELLED
                    if self._cancelled_before_start
                    else CalcStatus.PENDING
                )
            job = self._job
        return _JOB_TO_CALC[job.status]

    @property
    def progress(self) -> float:
        with self._lock:
            if self._job is None:
                return 0.0
            job = self._job
        return float(job.progress)

    def cancel(self) -> None:
        with self._lock:
            if self._job is None:
                self._cancelled_before_start = True
                return
            job = self._job
        job.cancel()

    def reset(self) -> None:
        """Return a Cancelled (or never-started) calc to Pending
        (ExcelCalcWrapper reset / ResetCancelled, CachedObjectsXl.cs:76-86)."""
        with self._lock:
            if self._job is not None and _JOB_TO_CALC[self._job.status] not in (
                CalcStatus.CANCELLED, CalcStatus.ERROR,
            ):
                return
            self._job = None
            self._cancelled_before_start = False

    def result(self):
        self.start()
        with self._lock:
            job = self._job
        return job.result()

    def exception(self) -> tp.Optional[BaseException]:
        with self._lock:
            job = self._job
        return None if job is None else job.exception()


class Subscription:
    """A pushed observable (CalcWrapper*Observable.cs): ``callback`` fires on
    every change of the watched property until ``dispose()``."""

    def __init__(self, dispose: tp.Callable[[], None]):
        self._dispose = dispose

    def dispose(self) -> None:
        self._dispose()


class CalculationService:
    """The add-in surface: object creation, async valuations, subscriptions.
    Every valuation it starts runs on ``device`` (CUDA unless the caller
    asks for the CPU; without a card a service that names no device
    raises)."""

    def __init__(self, num_threads: int = 2, calc_mode: CalcMode = CalcMode.ASYNC,
                 poll_interval: float = 0.02, *, device: Device = "cuda"):
        self.device = resolve_device(device)
        self.cache = ObjectCache()
        self.calc_mode = calc_mode
        self._engine = ValuationJobEngine(num_threads=num_threads)
        self._poll_interval = poll_interval
        self._watchers: tp.List[tp.Tuple[CalcWrapper, str, tp.Callable, tp.List]] = []
        self._watch_lock = threading.Lock()
        self._watch_thread: tp.Optional[threading.Thread] = None
        self._closed = False

    # ------------------------------------------------------------ info
    @staticmethod
    def version() -> str:
        """cmdty.StorageAddInVersion (AddInInfoXl.cs:34)."""
        from . import __version__

        return __version__

    def linear_algebra_provider(self) -> str:
        """cmdty.LinearAlgebraProvider (AddInInfoXl.cs:45-51; the reference
        reports the MKL/managed MathNet provider, here torch and the device,
        with the card's name on CUDA)."""
        where = str(self.device)
        if self.device.type == "cuda":
            where += f" ({torch.cuda.get_device_name(self.device)})"
        return f"torch {torch.__version__}:{where}"

    # ------------------------------------------------------------ objects
    def create_storage(self, name: str, **kwargs) -> str:
        """cmdty.CreateStorage (CmdtyStorageXl.cs:37): cache a CmdtyStorage
        under ``name`` and return its handle."""
        return self.cache.add(name, CmdtyStorage(**kwargs))

    def storage_injection_rate(self, handle: str, period, inventory: float) -> float:
        storage: CmdtyStorage = self.cache.get(handle)
        return storage.inject_withdraw_range(period, inventory).max_inject_withdraw_rate

    def storage_withdrawal_rate(self, handle: str, period, inventory: float) -> float:
        storage: CmdtyStorage = self.cache.get(handle)
        return -storage.inject_withdraw_range(period, inventory).min_inject_withdraw_rate

    def storage_min_inventory(self, handle: str, period) -> float:
        return self.cache.get(handle).min_inventory(period)

    def storage_max_inventory(self, handle: str, period) -> float:
        return self.cache.get(handle).max_inventory(period)

    # ------------------------------------------------------------ valuations
    def storage_intrinsic_value(self, name: str, storage_handle: str, **kwargs) -> str:
        """cmdty.StorageIntrinsicValue (IntrinsicXl.cs:38) — async handle."""
        storage = self.cache.get(storage_handle)

        def calc(report_progress, cancelled):
            result = _api.intrinsic_value(storage, device=self.device, **kwargs)
            report_progress(1.0)
            return result

        return self._add_calc(name, calc)

    def storage_value_three_factor(self, name: str, storage_handle: str, **kwargs) -> str:
        """cmdty.StorageValueThreeFactor (MultiFactorXl.cs:41) — async handle."""
        storage = self.cache.get(storage_handle)

        def calc(report_progress, cancelled):
            return _api_lsmc.three_factor_seasonal_value(
                storage, on_progress_update=report_progress, device=self.device, **kwargs
            )

        return self._add_calc(name, calc)

    def storage_value_trinomial_tree(self, name: str, storage_handle: str, **kwargs) -> str:
        """cmdty.StorageValueTrinomialTree (TrinomialXl.cs:39) — async handle."""
        storage = self.cache.get(storage_handle)

        def calc(report_progress, cancelled):
            result = _api.trinomial_value(storage, device=self.device, **kwargs)
            report_progress(1.0)
            return result

        return self._add_calc(name, calc)

    def storage_value_intrinsic(self, name: str, storage_handle: str, **kwargs) -> str:
        """cmdty.StorageValueIntrinsic (TrinomialXl.cs:136-188): intrinsic NPV
        through the degenerate intrinsic tree."""
        storage = self.cache.get(storage_handle)

        def calc(report_progress, cancelled):
            result = _api.intrinsic_value(storage, device=self.device, **kwargs)
            report_progress(1.0)
            return result.npv

        return self._add_calc(name, calc)

    def _add_calc(self, name: str, fn) -> str:
        wrapper = CalcWrapper(self._engine, fn, self.calc_mode)
        return self.cache.add(name, wrapper)

    # ------------------------------------------------------------ calc control
    def _wrapper(self, handle: str) -> CalcWrapper:
        obj = self.cache.get(handle)
        if not isinstance(obj, CalcWrapper):
            raise TypeError(f"Handle '{handle}' is not a calculation.")
        return obj

    def start_pending(self, handle: str) -> None:
        """cmdty.StartPending (CachedObjectsXl.cs:40)."""
        self._wrapper(handle).start()

    def cancel_running(self, handle: str) -> None:
        """cmdty.CancelRunning (CachedObjectsXl.cs:58)."""
        self._wrapper(handle).cancel()

    def reset_cancelled(self, handle: str) -> None:
        """cmdty.ResetCancelled (CachedObjectsXl.cs:76)."""
        self._wrapper(handle).reset()

    def calc_status(self, handle: str) -> CalcStatus:
        return self._wrapper(handle).status

    def calc_progress(self, handle: str) -> float:
        return self._wrapper(handle).progress

    def calc_result(self, handle: str):
        return self._wrapper(handle).result()

    @property
    def number_of_running_calculations(self) -> int:
        """cmdty.NumberOfRunningCalculations (CachedObjectsXl.cs:160)."""
        return self._engine.num_running

    def get_object_property(self, handle: str, prop: str):
        """cmdty.GetObjectProperty (CachedObjectsXl.cs:170-186): read an
        attribute off a cached object or a finished calc's result."""
        obj = self.cache.get(handle)
        if isinstance(obj, CalcWrapper):
            obj = obj.result()
        if not hasattr(obj, prop):
            raise AttributeError(f"Object '{handle}' has no property '{prop}'.")
        return getattr(obj, prop)

    # ------------------------------------------------------------ observables
    def subscribe_progress(self, handle: str, callback: tp.Callable[[float], None]) -> Subscription:
        """cmdty.SubscribeProgress (CachedObjectsXl.cs:88)."""
        return self._subscribe(self._wrapper(handle), "progress", callback)

    def subscribe_status(self, handle: str, callback: tp.Callable[[CalcStatus], None]) -> Subscription:
        """cmdty.SubscribeStatus (CachedObjectsXl.cs:110)."""
        return self._subscribe(self._wrapper(handle), "status", callback)

    def subscribe_error(self, handle: str, callback: tp.Callable[[BaseException], None]) -> Subscription:
        """cmdty.SubscribeError (CachedObjectsXl.cs:130): fires once if/when
        the calc errors."""

        def on_status(status: CalcStatus, wrapper=self._wrapper(handle)):
            if status == CalcStatus.ERROR:
                exc = wrapper.exception()
                if exc is not None:
                    callback(exc)

        return self._subscribe(self._wrapper(handle), "status", on_status)

    def _subscribe(self, wrapper: CalcWrapper, prop: str, callback) -> Subscription:
        entry = [wrapper, prop, callback, [object()]]  # sentinel: always push first value
        with self._watch_lock:
            self._watchers.append(entry)
            if self._watch_thread is None:
                self._watch_thread = threading.Thread(
                    target=self._watch_loop, daemon=True
                )
                self._watch_thread.start()

        def dispose():
            with self._watch_lock:
                if entry in self._watchers:
                    self._watchers.remove(entry)

        return Subscription(dispose)

    def _watch_loop(self):
        while not self._closed:
            with self._watch_lock:
                watchers = list(self._watchers)
            for entry in watchers:
                wrapper, prop, callback, last = entry
                value = getattr(wrapper, prop)
                if value != last[0]:
                    last[0] = value
                    try:
                        callback(value)
                    except Exception:  # noqa: BLE001 — subscriber errors stay local
                        pass
            time.sleep(self._poll_interval)

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        self._closed = True
        self._engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
