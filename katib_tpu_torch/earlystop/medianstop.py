"""Median-stopping rule generator.

Parity with the reference ``medianstop`` service
(``pkg/earlystopping/v1beta1/medianstop/service.py:100-184``): for every
succeeded trial take the running average of its first ``start_step`` objective
values, aggregate across trials, and stop any new trial whose best-so-far
objective is on the wrong side of that aggregate after ``start_step`` reports.

Two deliberate differences:
- the aggregate is a true median (the reference computes an arithmetic mean
  despite the name, ``service.py:147``); the median is what the algorithm
  (Golovin et al., Vizier) specifies and is robust to divergent trials;
- per-trial averages are recomputed from the observation store on demand
  instead of cached in service memory, so the stopper is restart-safe.

Settings: ``min_trials_required`` (default 3), ``start_step`` (default 4).
"""

from __future__ import annotations

import statistics

from katib_tpu_torch.core.types import (
    ComparisonOp,
    EarlyStoppingRule,
    ObjectiveType,
    TrialCondition,
)
from katib_tpu_torch.earlystop.rules import EarlyStopper, register_early_stopper


@register_early_stopper("medianstop")
class MedianStop(EarlyStopper):
    def __init__(self, spec):
        super().__init__(spec)
        settings = spec.early_stopping.settings if spec.early_stopping else {}
        self.min_trials_required = int(settings.get("min_trials_required", 3))
        self.start_step = int(settings.get("start_step", 4))
        if self.min_trials_required < 1:
            raise ValueError("min_trials_required must be >= 1")
        if self.start_step < 1:
            raise ValueError("start_step must be >= 1")
        self._store = None  # injected by the orchestrator

    def bind_store(self, store) -> None:
        self._store = store

    def _trial_average(self, trial_name: str) -> float | None:
        metric = self.spec.objective.objective_metric_name
        logs = self._store.get(trial_name, metric) if self._store else []
        if not logs:
            return None
        head = [l.value for l in logs[: self.start_step]]
        return sum(head) / len(head)

    def get_rules(self, experiment) -> list[EarlyStoppingRule]:
        averages = []
        for t in experiment.trials.values():
            if t.condition is not TrialCondition.SUCCEEDED:
                continue
            avg = self._trial_average(t.name)
            if avg is not None:
                averages.append(avg)
        if len(averages) < self.min_trials_required:
            return []
        median = statistics.median(averages)
        comparison = (
            ComparisonOp.LESS
            if self.spec.objective.type is ObjectiveType.MAXIMIZE
            else ComparisonOp.GREATER
        )
        return [
            EarlyStoppingRule(
                name=self.spec.objective.objective_metric_name,
                value=float(median),
                comparison=comparison,
                start_step=self.start_step,
            )
        ]
