"""Early-stopping rule evaluation.

The reference evaluates rules inside the metrics-collector sidecar while
tailing the log file (``cmd/metricscollector/v1beta1/file-metricscollector/
main.go:332-393``), then SIGTERMs the training process.  Here trials are
white-box functions, so the evaluator is wired into the metrics path: every
``ctx.report(...)`` updates it, and the training loop stops cooperatively at
the next step boundary (black-box subprocess trials are still terminated by
the runner).

Semantics preserved from the reference:
- a rule with ``start_step`` only fires once its metric has been reported at
  least ``start_step`` times (``main.go:341-346``);
- for the objective metric the *best-so-far* value is compared, not the
  latest (``main.go:346-361``, the documented medianstop workaround), so a
  transient dip doesn't kill a trial that was already above the bar.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from katib_tpu_torch.core.types import (
    EarlyStoppingRule,
    ObjectiveSpec,
    ObjectiveType,
)


@dataclass
class RuleState:
    rule: EarlyStoppingRule
    count: int = 0
    best: float | None = None


class RuleEvaluator:
    """Tracks one trial's metric stream against its stop rules (thread-safe:
    JAX host callbacks may report from non-main threads)."""

    def __init__(
        self, rules: list[EarlyStoppingRule], objective: ObjectiveSpec | None = None
    ):
        self._states = [RuleState(rule=r) for r in rules]
        self._objective = objective
        self._lock = threading.Lock()
        self._triggered: EarlyStoppingRule | None = None

    @property
    def triggered(self) -> EarlyStoppingRule | None:
        return self._triggered

    def should_stop(self) -> bool:
        return self._triggered is not None

    def observe(self, metric_name: str, value: float) -> bool:
        """Feed one metric point; returns True if the trial should stop."""
        with self._lock:
            if self._triggered is not None:
                return True
            for st in self._states:
                if st.rule.name != metric_name:
                    continue
                st.count += 1
                observed = value
                if self._objective and metric_name == self._objective.objective_metric_name:
                    # best-so-far semantics for the objective metric
                    if st.best is None or self._objective.type.better(value, st.best):
                        st.best = value
                    observed = st.best
                if st.count < max(st.rule.start_step, 1):
                    continue
                if st.rule.comparison.holds(observed, st.rule.value):
                    self._triggered = st.rule
                    return True
        return False


@dataclass
class StopDecision:
    stopped: bool
    rule: EarlyStoppingRule | None = None
    message: str = ""


class EarlyStopper:
    """Rule-generator contract — the analog of the gRPC ``EarlyStopping``
    service (``api.proto:42-45``): produce rules for a trial before it starts,
    from the history of completed trials."""

    name: str = ""

    def __init__(self, spec) -> None:  # ExperimentSpec
        self.spec = spec

    def get_rules(self, experiment) -> list[EarlyStoppingRule]:
        raise NotImplementedError


_ES_REGISTRY: dict[str, type] = {}


def register_early_stopper(name: str):
    def deco(cls):
        cls.name = name
        _ES_REGISTRY[name] = cls
        return cls

    return deco


def make_early_stopper(spec) -> EarlyStopper | None:
    """Instantiate the configured early-stopping algorithm, or None."""
    from katib_tpu_torch.earlystop import medianstop  # noqa: F401 registration

    if spec.early_stopping is None:
        return None
    name = spec.early_stopping.name
    if name not in _ES_REGISTRY:
        raise ValueError(
            f"unknown early-stopping algorithm {name!r}; registered: {sorted(_ES_REGISTRY)}"
        )
    return _ES_REGISTRY[name](spec)
