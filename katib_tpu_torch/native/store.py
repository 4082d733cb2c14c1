"""ctypes wrappers over the native observation-log engine (port of
``katib_tpu/native/store.py``).

``NativeObservationStore`` is the in-RAM hot-path store (the reference
DB-manager's Report/Get/Delete contract, ``pkg/db/v1beta1/common/kdb.go:23``);
``parse_text_lines_native`` is the C++ TEXT parser the black-box metrics
tail uses for the reference's default filter (a custom regex filter stays
in the Python parser).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Iterable, Sequence

from katib_tpu_torch.core.types import MetricLog
from katib_tpu_torch.native.build import load_lib
from katib_tpu_torch.store.base import ObservationStore


def _drain_query(lib, q) -> list[MetricLog]:
    try:
        n = lib.kt_query_len(q)
        if n == 0:
            return []
        names = lib.kt_query_names_blob(q).decode().split("\n")
        values = (ctypes.c_double * n)()
        ts = (ctypes.c_double * n)()
        steps = (ctypes.c_int64 * n)()
        lib.kt_query_values(q, values)
        lib.kt_query_timestamps(q, ts)
        lib.kt_query_steps(q, steps)
        return [MetricLog(metric_name=names[i], value=values[i], timestamp=ts[i], step=steps[i])
                for i in range(n)]
    finally:
        lib.kt_query_free(q)


class NativeObservationStore(ObservationStore):
    """C++ append-log store; thread safety lives in the C++ mutex, the
    Python side only guards its subscriber list.  Raises if the runtime
    cannot build."""

    def __init__(self) -> None:
        self._lib = load_lib()
        self._handle = self._lib.kt_store_new()
        self._sub_lock = threading.Lock()
        self._subscribers: list[Callable[[str, MetricLog], None]] = []

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.kt_store_free(handle)
            self._handle = None

    def subscribe(self, fn: Callable[[str, MetricLog], None]) -> None:
        with self._sub_lock:
            self._subscribers.append(fn)

    def report(self, trial_name: str, logs: Iterable[MetricLog]) -> None:
        logs = list(logs)
        if not logs:
            return
        n = len(logs)
        metrics = (ctypes.c_char_p * n)(*[log.metric_name.encode() for log in logs])
        values = (ctypes.c_double * n)(*[log.value for log in logs])
        ts = (ctypes.c_double * n)(*[log.timestamp for log in logs])
        steps = (ctypes.c_int64 * n)(*[log.step for log in logs])
        self._lib.kt_store_report_batch(self._handle, trial_name.encode(), n, metrics, values,
                                        ts, steps)
        with self._sub_lock:
            subs = list(self._subscribers)
        for fn in subs:
            for log in logs:
                fn(trial_name, log)

    def get(self, trial_name: str, metric_name: str | None = None) -> list[MetricLog]:
        q = self._lib.kt_store_get(self._handle, trial_name.encode(),
                                   metric_name.encode() if metric_name else b"")
        return _drain_query(self._lib, q)

    def delete(self, trial_name: str) -> None:
        self._lib.kt_store_delete(self._handle, trial_name.encode())

    def total_points(self) -> int:
        return self._lib.kt_store_total(self._handle)

    def trial_names(self) -> list[str]:
        q = self._lib.kt_store_trial_names(self._handle)
        return [log.metric_name for log in _drain_query(self._lib, q)]


def parse_text_lines_native(lines: Sequence[str], metric_names: Sequence[str]) -> list[MetricLog]:
    """The C++ counterpart of ``runner.metrics.parse_text_lines`` for the
    default filter (``common/const.go:47`` semantics)."""
    lib = load_lib()
    # kt_parse_text takes a C string: strip stray NUL bytes (binary progress
    # bars, corrupted output) so they cannot cut the buffer mid-line
    text = "\n".join(lines).replace("\0", "").encode(errors="replace")
    tracked = "\n".join(metric_names).replace("\0", "").encode(errors="replace")
    return _drain_query(lib, lib.kt_parse_text(text, tracked))
