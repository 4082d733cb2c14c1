"""Observation-log storage contract.

The reference fronts MySQL/Postgres with a gRPC DB-manager daemon whose whole
schema is one table ``observation_logs(trial_name, id, time, metric_name,
value)`` (``pkg/db/v1beta1/common/kdb.go:23``, ``mysql/init.go:35``).  The
TPU-native design keeps the same three-operation contract —
report / get / delete per trial — but runs it in-process: trials are white-box
functions, so the metrics path is a function call, not
sidecar → gRPC → SQL → gRPC → controller.

Backends:
- ``MemoryObservationStore``   — dict of lists; fastest, default for local runs.
- ``SqliteObservationStore``   — durable single-file store (``store/sqlite.py``).
- ``NativeObservationStore``   — C++ append-log engine via ctypes (``native/``).

All backends are thread-safe: trial runners report from worker threads while
the orchestrator reads.
"""

from __future__ import annotations

import abc
import threading
import time
from typing import Callable, Iterable

from katib_tpu_torch.core.types import (
    Metric,
    MetricLog,
    MetricStrategyType,
    Observation,
    ObjectiveSpec,
)


class ObservationStore(abc.ABC):
    """Report/Get/Delete observation-log contract (reference ``kdb.go:23-29``)."""

    @abc.abstractmethod
    def report(self, trial_name: str, logs: Iterable[MetricLog]) -> None:
        """Append metric points for a trial (reference ``ReportObservationLog``)."""

    @abc.abstractmethod
    def get(self, trial_name: str, metric_name: str | None = None) -> list[MetricLog]:
        """Fetch a trial's log, optionally filtered to one metric, in report order
        (reference ``GetObservationLog``; the reference also filters by start/end
        time, which callers here do with a list comprehension)."""

    @abc.abstractmethod
    def delete(self, trial_name: str) -> None:
        """Drop a trial's log (reference ``DeleteObservationLog``)."""

    # -- conveniences shared by all backends -------------------------------

    def report_point(
        self, trial_name: str, metric_name: str, value: float, step: int = -1
    ) -> None:
        self.report(
            trial_name,
            [MetricLog(metric_name=metric_name, value=value, timestamp=time.time(), step=step)],
        )

    def reduce(
        self, trial_name: str, metric_name: str, strategy: MetricStrategyType
    ) -> float | None:
        values = [l.value for l in self.get(trial_name, metric_name)]
        return strategy.reduce(values) if values else None

    def observation_for(
        self, trial_name: str, objective: ObjectiveSpec
    ) -> Observation | None:
        """Build a reduced Observation by applying metric strategies — the
        controller-side logic of ``UpdateTrialStatusObservation``
        (reference ``trial_controller_util.go``).  Returns None when the
        objective metric was never reported (→ MetricsUnavailable)."""
        metrics: list[Metric] = []
        for name in objective.all_metric_names():
            values = [l.value for l in self.get(trial_name, name)]
            if not values:
                continue
            metrics.append(
                Metric(
                    name=name,
                    value=objective.strategy_for(name).reduce(values),
                    min=min(values),
                    max=max(values),
                    latest=values[-1],
                )
            )
        if not any(m.name == objective.objective_metric_name for m in metrics):
            return None
        return Observation(metrics=metrics)


class MemoryObservationStore(ObservationStore):
    """In-memory backend with optional live subscribers (the "metrics bus").

    Subscribers receive every reported point; the early-stopping evaluator
    hooks in here instead of tailing files the way the reference sidecar does
    (``file-metricscollector/main.go:143``).
    """

    def __init__(self) -> None:
        self._logs: dict[str, list[MetricLog]] = {}
        self._lock = threading.RLock()
        self._subscribers: list[Callable[[str, MetricLog], None]] = []

    def subscribe(self, fn: Callable[[str, MetricLog], None]) -> None:
        with self._lock:
            self._subscribers.append(fn)

    def report(self, trial_name: str, logs: Iterable[MetricLog]) -> None:
        logs = list(logs)
        with self._lock:
            self._logs.setdefault(trial_name, []).extend(logs)
            subs = list(self._subscribers)
        for fn in subs:
            for log in logs:
                fn(trial_name, log)

    def get(self, trial_name: str, metric_name: str | None = None) -> list[MetricLog]:
        with self._lock:
            logs = list(self._logs.get(trial_name, ()))
        if metric_name is None:
            return logs
        return [l for l in logs if l.metric_name == metric_name]

    def delete(self, trial_name: str) -> None:
        with self._lock:
            self._logs.pop(trial_name, None)

    def trial_names(self) -> list[str]:
        with self._lock:
            return list(self._logs)
