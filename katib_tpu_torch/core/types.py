"""Core domain types for the TPU-native AutoML framework.

These are the framework's equivalent of the reference's CRD type layer (L0):

- Parameter / feasible-space model  -> reference ``pkg/apis/controller/experiments/v1beta1/experiment_types.go:196-215``
- Objective & metric strategies     -> reference ``pkg/apis/controller/common/v1beta1/common_types.go:94-160``
- Algorithm / early-stopping specs  -> reference ``common_types.go:24-66``
- Trial assignments & observations  -> reference ``pkg/apis/controller/trials/v1beta1/trial_types.go:27-126``,
                                       ``pkg/apis/controller/suggestions/v1beta1/suggestion_types.go:77``

The design is deliberately *not* a CRD translation: there is no Kubernetes, no
unstructured YAML round-tripping, no status-condition churn over an API server.
Experiments, trials and suggestions are plain Python objects owned by an
in-process orchestrator; trials are (by default) white-box JAX functions rather
than opaque containers, which collapses the reference's webhook/sidecar
machinery into direct function calls.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import time
from dataclasses import dataclass, field

from katib_tpu_torch.utils.clock import get_clock
from typing import Any, Callable, Iterable, Iterator, Mapping, Sequence

__all__ = [
    "ParameterType",
    "Distribution",
    "FeasibleSpace",
    "ParameterSpec",
    "ParameterAssignment",
    "ObjectiveType",
    "MetricStrategyType",
    "MetricStrategy",
    "ObjectiveSpec",
    "AlgorithmSpec",
    "EarlyStoppingSpec",
    "ComparisonOp",
    "EarlyStoppingRule",
    "MetricsCollectorKind",
    "MetricsCollectorSpec",
    "GraphConfig",
    "NasOperation",
    "NasConfig",
    "ResumePolicy",
    "TrialCondition",
    "Metric",
    "MetricLog",
    "Observation",
    "TrialAssignmentSet",
    "TrialSpec",
    "Trial",
    "ExperimentCondition",
    "ExperimentSpec",
    "Experiment",
    "OptimalTrial",
]


# ---------------------------------------------------------------------------
# Parameters & search space
# ---------------------------------------------------------------------------


class ParameterType(str, enum.Enum):
    """Parameter kinds (reference ``experiment_types.go:196-204``)."""

    DOUBLE = "double"
    INT = "int"
    DISCRETE = "discrete"
    CATEGORICAL = "categorical"


class Distribution(str, enum.Enum):
    """Sampling distribution hints (reference ``experiment_types.go:225-231``)."""

    UNIFORM = "uniform"
    LOG_UNIFORM = "logUniform"
    NORMAL = "normal"
    LOG_NORMAL = "logNormal"


@dataclass(frozen=True)
class FeasibleSpace:
    """Feasible region of one parameter (reference ``experiment_types.go:209-215``).

    ``min``/``max``/``step`` apply to double/int parameters; ``list`` applies to
    discrete/categorical.  Values are kept in native Python types rather than the
    reference's all-strings encoding.
    """

    min: float | None = None
    max: float | None = None
    list: tuple[Any, ...] | None = None
    step: float | None = None
    distribution: Distribution = Distribution.UNIFORM

    def __post_init__(self) -> None:
        if self.list is not None and not isinstance(self.list, tuple):
            object.__setattr__(self, "list", tuple(self.list))

    def width(self) -> float:
        if self.min is None or self.max is None:
            raise ValueError("width() requires min/max bounds")
        return float(self.max) - float(self.min)

    def is_log_scaled(self) -> bool:
        return self.distribution in (Distribution.LOG_UNIFORM, Distribution.LOG_NORMAL)


@dataclass(frozen=True)
class ParameterSpec:
    """One tunable parameter (reference ``experiment_types.go:196-207``)."""

    name: str
    type: ParameterType
    feasible: FeasibleSpace

    def __post_init__(self) -> None:
        t, f = self.type, self.feasible
        if t in (ParameterType.DOUBLE, ParameterType.INT):
            if f.min is None or f.max is None:
                raise ValueError(f"parameter {self.name!r}: {t.value} requires min and max")
            if f.max < f.min:
                raise ValueError(f"parameter {self.name!r}: max < min")
            if f.is_log_scaled() and f.min <= 0:
                raise ValueError(f"parameter {self.name!r}: log distribution requires min > 0")
        else:
            if not f.list:
                raise ValueError(f"parameter {self.name!r}: {t.value} requires a non-empty list")

    # -- value helpers -----------------------------------------------------

    def cast(self, value: Any) -> Any:
        """Coerce a raw value into this parameter's native type."""
        if self.type is ParameterType.DOUBLE:
            return float(value)
        if self.type is ParameterType.INT:
            return int(round(float(value)))
        if self.type is ParameterType.DISCRETE:
            # discrete values are numeric; match against the list
            v = float(value)
            for item in self.feasible.list or ():
                if math.isclose(float(item), v, rel_tol=1e-12, abs_tol=1e-12):
                    return item
            return v
        return value

    def grid_values(self, max_points: int = 25) -> list[Any]:
        """Enumerate candidate grid values (used by grid search & validation)."""
        f = self.feasible
        if self.type in (ParameterType.DISCRETE, ParameterType.CATEGORICAL):
            return [self.cast(v) for v in f.list or ()]
        if self.type is ParameterType.INT:
            step = int(f.step or 1)
            return [int(v) for v in range(int(f.min), int(f.max) + 1, max(step, 1))]
        # double: need an explicit step, otherwise linspace over max_points
        if f.step:
            n = int(math.floor((f.max - f.min) / f.step + 1e-9)) + 1
            return [float(f.min) + i * float(f.step) for i in range(n)]
        n = max_points
        return [float(f.min) + (f.max - f.min) * i / (n - 1) for i in range(n)]

    def contains(self, value: Any) -> bool:
        try:
            v = self.cast(value)
        except (TypeError, ValueError):
            return False
        f = self.feasible
        if self.type in (ParameterType.DOUBLE, ParameterType.INT):
            return f.min - 1e-12 <= float(v) <= f.max + 1e-12
        if self.type is ParameterType.DISCRETE:
            return any(math.isclose(float(x), float(v), rel_tol=1e-12) for x in f.list)
        return v in f.list


@dataclass(frozen=True)
class ParameterAssignment:
    """A concrete (name, value) binding (reference ``common_types.go:178-185``)."""

    name: str
    value: Any

    def as_tuple(self) -> tuple[str, Any]:
        return (self.name, self.value)


def assignments_to_dict(assignments: Sequence[ParameterAssignment]) -> dict[str, Any]:
    return {a.name: a.value for a in assignments}


# ---------------------------------------------------------------------------
# Objective & metrics
# ---------------------------------------------------------------------------


class ObjectiveType(str, enum.Enum):
    """minimize/maximize (reference ``common_types.go:84-91``)."""

    MINIMIZE = "minimize"
    MAXIMIZE = "maximize"

    def better(self, a: float, b: float) -> bool:
        """True if ``a`` is strictly better than ``b`` under this objective."""
        return a < b if self is ObjectiveType.MINIMIZE else a > b

    def best(self, values: Sequence[float]) -> float:
        return min(values) if self is ObjectiveType.MINIMIZE else max(values)


class MetricStrategyType(str, enum.Enum):
    """How to reduce a metric's log to one value (reference ``common_types.go:129-136``)."""

    MIN = "min"
    MAX = "max"
    LATEST = "latest"

    def reduce(self, values: Sequence[float]) -> float:
        if not values:
            raise ValueError("cannot reduce empty metric log")
        if self is MetricStrategyType.MIN:
            return min(values)
        if self is MetricStrategyType.MAX:
            return max(values)
        return values[-1]


@dataclass(frozen=True)
class MetricStrategy:
    """Per-metric extraction strategy (reference ``common_types.go:138-144``)."""

    name: str
    value: MetricStrategyType


@dataclass(frozen=True)
class ObjectiveSpec:
    """Optimization objective (reference ``common_types.go:94-127``).

    ``goal`` stops the experiment early when reached.  ``metric_strategies``
    default to max for maximize / min for minimize on the objective metric and
    latest for additional metrics, matching the reference's defaulting
    (``experiment_defaults.go:55-88``).
    """

    type: ObjectiveType
    objective_metric_name: str
    goal: float | None = None
    additional_metric_names: tuple[str, ...] = ()
    metric_strategies: tuple[MetricStrategy, ...] = ()

    def __post_init__(self) -> None:
        if not isinstance(self.additional_metric_names, tuple):
            object.__setattr__(self, "additional_metric_names", tuple(self.additional_metric_names))
        if not isinstance(self.metric_strategies, tuple):
            object.__setattr__(self, "metric_strategies", tuple(self.metric_strategies))

    def all_metric_names(self) -> tuple[str, ...]:
        return (self.objective_metric_name, *self.additional_metric_names)

    def strategy_for(self, metric_name: str) -> MetricStrategyType:
        for s in self.metric_strategies:
            if s.name == metric_name:
                return s.value
        if metric_name == self.objective_metric_name:
            return (
                MetricStrategyType.MIN
                if self.type is ObjectiveType.MINIMIZE
                else MetricStrategyType.MAX
            )
        return MetricStrategyType.LATEST

    def is_goal_reached(self, value: float) -> bool:
        if self.goal is None:
            return False
        if self.type is ObjectiveType.MINIMIZE:
            return value <= self.goal
        return value >= self.goal


# ---------------------------------------------------------------------------
# Algorithm / early-stopping specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AlgorithmSpec:
    """Suggestion algorithm + settings (reference ``common_types.go:24-40``).

    Settings are a plain mapping; Hyperband mutates them between rounds (the
    reference round-trips the mutation through ``Suggestion.Status.AlgorithmSettings``,
    ``suggestionclient.go:194-196`` — here the orchestrator owns the mutable copy).
    """

    name: str
    settings: Mapping[str, str] = field(default_factory=dict)

    def setting(self, key: str, default: str | None = None) -> str | None:
        return self.settings.get(key, default)


@dataclass(frozen=True)
class EarlyStoppingSpec:
    """Early-stopping algorithm + settings (reference ``common_types.go:42-58``)."""

    name: str
    settings: Mapping[str, str] = field(default_factory=dict)


class ComparisonOp(str, enum.Enum):
    """Rule comparison (reference ``api.proto`` ComparisonType / ``common_types.go:160-176``)."""

    EQUAL = "equal"
    LESS = "less"
    GREATER = "greater"

    def holds(self, observed: float, threshold: float) -> bool:
        if self is ComparisonOp.LESS:
            return observed < threshold
        if self is ComparisonOp.GREATER:
            return observed > threshold
        return math.isclose(observed, threshold, rel_tol=1e-9, abs_tol=1e-12)


@dataclass(frozen=True)
class EarlyStoppingRule:
    """One stop rule attached to a trial (reference ``common_types.go:160-176``).

    ``start_step``: the rule only fires once the metric has been reported at
    least ``start_step`` times (reference ``file-metricscollector/main.go:332-361``).
    """

    name: str
    value: float
    comparison: ComparisonOp
    start_step: int = 0

    def describe(self) -> str:
        return f"rule {self.name} {self.comparison.value} {self.value}"


# ---------------------------------------------------------------------------
# Metrics collection
# ---------------------------------------------------------------------------


class MetricsCollectorKind(str, enum.Enum):
    """Collector kinds (reference ``common_types.go:205-227``).

    ``PUSH`` is the TPU-native default: white-box trials report metrics through
    a direct in-process callback, eliminating the reference's sidecar scraping.
    The file/stdout kinds remain for black-box subprocess trials.
    """

    PUSH = "Push"
    STDOUT = "StdOut"
    FILE = "File"
    JSONL = "JsonLines"
    # TensorBoard event files written by the trial (reference
    # TensorFlowEvent collector, ``common_types.go:212-215``); parsed after
    # the trial exits by ``runner/tfevent.py`` — no TF dependency.
    TFEVENT = "TensorFlowEvent"
    # Scrape the trial's Prometheus exposition endpoint while it runs
    # (reference Prometheus collector kind, ``common_types.go:216-219``).
    PROMETHEUS = "Prometheus"
    NONE = "None"


@dataclass(frozen=True)
class MetricsCollectorSpec:
    """Metrics collection config (reference ``common_types.go:230-260``)."""

    kind: MetricsCollectorKind = MetricsCollectorKind.PUSH
    # For FILE/JSONL collectors: path the black-box trial writes to.
    # For PROMETHEUS: the HTTP path of the exposition endpoint (default
    # ``/metrics``, reference ``common_types.go:47``).
    path: str | None = None
    # Metric line filter, default matches the reference's TEXT format regex
    # ``([\w|-]+)\s*=\s*([+-]?\d...)`` (``pkg/metricscollector/v1beta1/common/const.go``).
    filter: str | None = None
    # PROMETHEUS only: port the trial listens on and scrape cadence.
    port: int | None = None
    scrape_interval: float = 1.0


# ---------------------------------------------------------------------------
# NAS config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GraphConfig:
    """NAS macro-graph bounds (reference ``experiment_types.go:308-315``)."""

    num_layers: int = 8
    input_sizes: tuple[int, ...] = ()
    output_sizes: tuple[int, ...] = ()


@dataclass(frozen=True)
class NasOperation:
    """One NAS primitive with its own sub-search-space (reference ``experiment_types.go:317-320``)."""

    operation_type: str
    parameters: tuple[ParameterSpec, ...] = ()


@dataclass(frozen=True)
class NasConfig:
    """NAS search configuration (reference ``experiment_types.go:304-306``)."""

    graph_config: GraphConfig = field(default_factory=GraphConfig)
    operations: tuple[NasOperation, ...] = ()


# ---------------------------------------------------------------------------
# Trials
# ---------------------------------------------------------------------------


class ResumePolicy(str, enum.Enum):
    """Experiment resume semantics (reference ``experiment_types.go:181-191``)."""

    NEVER = "Never"
    LONG_RUNNING = "LongRunning"
    FROM_VOLUME = "FromVolume"


class TrialCondition(str, enum.Enum):
    """Trial lifecycle states (reference ``trial_types.go:118-126``)."""

    CREATED = "Created"
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    KILLED = "Killed"
    FAILED = "Failed"
    EARLY_STOPPED = "EarlyStopped"
    METRICS_UNAVAILABLE = "MetricsUnavailable"
    # checkpoint-and-exit during an orchestrator drain (preemption SIGTERM):
    # deliberately NON-terminal — a resumed run resubmits the trial under the
    # same name/checkpoint dir and it continues from its last saved step, and
    # the max_trial_count budget is never charged for a preempted slot
    DRAINED = "Drained"

    def is_terminal(self) -> bool:
        return self in (
            TrialCondition.SUCCEEDED,
            TrialCondition.KILLED,
            TrialCondition.FAILED,
            TrialCondition.EARLY_STOPPED,
            TrialCondition.METRICS_UNAVAILABLE,
        )

    def is_completed_ok(self) -> bool:
        """Counts toward the suggestion-request budget (reference
        ``experiment_controller.go:449-461`` counts succeeded + early-stopped)."""
        return self in (TrialCondition.SUCCEEDED, TrialCondition.EARLY_STOPPED)


@dataclass(frozen=True)
class Metric:
    """One reduced metric (reference ``common_types.go:187-195``)."""

    name: str
    value: float
    min: float = math.nan
    max: float = math.nan
    latest: float = math.nan


@dataclass(frozen=True)
class MetricLog:
    """One raw reported point (reference ``api.proto`` MetricLog)."""

    metric_name: str
    value: float
    timestamp: float = 0.0
    step: int = -1


@dataclass
class Observation:
    """Reduced view of a trial's metric logs (reference ``common_types.go:196-203``)."""

    metrics: list[Metric] = field(default_factory=list)

    def get(self, name: str) -> Metric | None:
        for m in self.metrics:
            if m.name == name:
                return m
        return None


@dataclass
class TrialAssignmentSet:
    """A suggester's proposal for one trial (reference ``suggestion_types.go:77-96``).

    ``labels`` carry algorithm lineage (PBT generation/parent), mirroring the
    reference's suggestion-label propagation (``pbt/service.py:183-187``).
    """

    assignments: list[ParameterAssignment]
    name: str | None = None
    early_stopping_rules: list[EarlyStoppingRule] = field(default_factory=list)
    labels: dict[str, str] = field(default_factory=dict)

    def as_dict(self) -> dict[str, Any]:
        return assignments_to_dict(self.assignments)


@dataclass
class TrialSpec:
    """What to run for one trial (reference ``trial_types.go:27-80``).

    Instead of an unstructured Kubernetes ``RunSpec``, a trial either calls a
    white-box Python/JAX ``train_fn(ctx)`` or launches a black-box subprocess
    command (argv with ``${trialParameters.X}`` placeholders, parity with the
    reference's template substitution ``manifest/generator.go:79-99``).
    """

    assignments: list[ParameterAssignment] = field(default_factory=list)
    early_stopping_rules: list[EarlyStoppingRule] = field(default_factory=list)
    labels: dict[str, str] = field(default_factory=dict)
    # Exactly one of train_fn / command should be set.
    train_fn: Callable[..., Any] | None = None
    command: list[str] | None = None
    metrics_collector: MetricsCollectorSpec = field(default_factory=MetricsCollectorSpec)
    # retain trial artifacts (checkpoints, logs) after completion
    retain: bool = False
    # wall-clock deadline for one trial run; None = unbounded (the reference
    # bounds every e2e experiment at 40 min, ``run-e2e-experiment.py:11`` —
    # here the bound is enforced per trial so a hung trial can't pin a slot)
    max_runtime_seconds: float | None = None
    # bounded re-runs when the trial succeeds but never reported the
    # objective metric (the reference requeues metrics-not-reported trials,
    # ``trial_controller.go:182-185``); 0 = classify immediately
    metrics_retries: int = 0
    # bounded re-runs after a TRANSIENT failure (preemption,
    # RESOURCE_EXHAUSTED, OSError family, retryable exit code — see
    # utils/faults.py); retries reuse the trial's name and checkpoint dir so
    # a checkpoint-aware train_fn resumes mid-trial.  Permanent failures
    # (ValueError/assertion/shape errors) never retry.  0 = classify the
    # first failure immediately
    max_retries: int = 0
    # first-retry delay for the shared exponential backoff (doubles per
    # attempt, jittered, capped at ~30s, stop-event responsive)
    retry_backoff_seconds: float = 1.0
    # hang watchdog: fail the trial FailureKind.HANG when no progress
    # (report() call / cohort step / black-box metric activity) lands for
    # this long (utils/watchdog.py).  Unlike max_runtime_seconds — which is
    # only polled at reporting points for white-box trials — the watchdog's
    # monitor thread interrupts a train_fn wedged BETWEEN reports (stuck
    # compile, deadlocked collective).  None = disabled.
    progress_deadline_seconds: float | None = None
    # compile watchdog: budget for jit compile + FIRST dispatch (trace to
    # first ctx.report()).  The progress watchdog only arms per-step cadence;
    # a 470s live compile (BENCH_r05) is indistinguishable from a wedge
    # without a separate budget.  Overruns classify as the retryable
    # FailureKind.COMPILE_HANG.  None = disabled.
    compile_deadline_seconds: float | None = None

    def params(self) -> dict[str, Any]:
        return assignments_to_dict(self.assignments)


@dataclass
class Trial:
    """A trial instance + status (reference ``trial_types.go`` + status)."""

    name: str
    spec: TrialSpec
    experiment_name: str = ""
    condition: TrialCondition = TrialCondition.CREATED
    observation: Observation | None = None
    message: str = ""
    start_time: float = 0.0
    completion_time: float = 0.0
    checkpoint_dir: str | None = None
    # transient-failure retries consumed so far — journaled to status.json so
    # a resume-after-crash continues with the budget already spent rather
    # than resetting it (budget math still counts the trial once)
    retry_count: int = 0
    # FailureKind value ("Transient"/"Permanent") of the most recent failed
    # attempt, None while no attempt has failed (or after a later success)
    failure_kind: str | None = None

    def params(self) -> dict[str, Any]:
        return self.spec.params()

    @property
    def labels(self) -> dict[str, str]:
        return self.spec.labels

    def objective_value(self, objective: ObjectiveSpec) -> float | None:
        if self.observation is None:
            return None
        m = self.observation.get(objective.objective_metric_name)
        return None if m is None else m.value


# ---------------------------------------------------------------------------
# Experiments
# ---------------------------------------------------------------------------


class ExperimentCondition(str, enum.Enum):
    """Experiment lifecycle (reference ``experiment_types.go:136-160``)."""

    CREATED = "Created"
    RUNNING = "Running"
    RESTARTING = "Restarting"
    GOAL_REACHED = "GoalReached"
    MAX_TRIALS_REACHED = "MaxTrialsReached"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"

    def is_terminal(self) -> bool:
        return self in (
            ExperimentCondition.SUCCEEDED,
            ExperimentCondition.FAILED,
            ExperimentCondition.GOAL_REACHED,
            ExperimentCondition.MAX_TRIALS_REACHED,
        )


@dataclass
class ExperimentSpec:
    """Experiment definition (reference ``experiment_types.go:27-80``)."""

    name: str
    objective: ObjectiveSpec
    algorithm: AlgorithmSpec
    parameters: list[ParameterSpec] = field(default_factory=list)
    nas_config: NasConfig | None = None
    early_stopping: EarlyStoppingSpec | None = None
    # Budget knobs (reference ``experiment_types.go:41-53``; defaults
    # ``experiment_defaults.go:31-44``).
    parallel_trial_count: int = 3
    max_trial_count: int | None = None
    # None = unlimited (reference: nil MaxFailedTrialCount never fails the
    # experiment, ``status_util.go:204-205``)
    max_failed_trial_count: int | None = None
    resume_policy: ResumePolicy = ResumePolicy.NEVER
    metrics_collector: MetricsCollectorSpec = field(default_factory=MetricsCollectorSpec)
    # White-box trial entry point: fn(ctx) -> None, metrics via ctx.report(...).
    train_fn: Callable[..., Any] | None = None
    # Black-box alternative: argv template with ${trialParameters.X} placeholders.
    command: list[str] | None = None
    # Keep trial artifacts (checkpoint steps) after successful completion
    # (reference ``trialTemplate.retain``, ``trial_types.go:57``).
    retain: bool = False
    # Per-trial wall-clock deadline + metrics-unavailable retry budget,
    # propagated into every TrialSpec (see TrialSpec for reference parity).
    max_trial_runtime_seconds: float | None = None
    metrics_retries: int = 0
    # Transient-failure retry budget + backoff base, propagated into every
    # TrialSpec (see TrialSpec / utils.faults for the taxonomy).
    max_retries: int = 0
    retry_backoff_seconds: float = 1.0
    # Suggester circuit breaker: this many CONSECUTIVE get_suggestions
    # exceptions fail the experiment with the last traceback; fewer are
    # counted (katib_suggester_errors_total) and retried after a cooldown
    # while in-flight trials keep running.
    suggester_max_errors: int = 5
    # Vectorized trial cohorts: up to this many compatible pending trials
    # (same cohortKey — same model, shapes, step count) execute as ONE
    # vmapped jitted program sharing a single compiled executable
    # (runner/cohort.py).  1 = disabled; requires a cohort-capable train_fn
    # (see runner.cohort.attach_cohort_fn).
    cohort_width: int = 1
    # Default cohort key stamped on every trial when cohort_width > 1;
    # proposals may override per trial via the COHORT_KEY_LABEL label
    # (PBT generations, Hyperband rungs).  None = only labeled proposals
    # group into cohorts.
    cohort_key: str | None = None
    # Cohort shape bucketing: pad each cohort's member axis up to the next
    # power of two (x trial-axis multiple) instead of the exact width, so
    # heterogeneous cohort sizes collapse onto a handful of cached
    # executables — ghost members make the extra rows free
    # (katib_tpu_torch/compile/buckets.py).  Only affects orchestrator-driven
    # cohorts; the direct run_cohort API defaults to exact padding.
    cohort_buckets: bool = True
    # Background prewarm: while trials run, a best-effort daemon worker warms
    # up and captures upcoming groups' programs (via the train_fn's prewarm
    # twin, see compile.prewarm.attach_prewarm_fn) on the orchestrator's
    # device, so this process's first capture set-up is paid off the
    # critical path.  No-op for train_fns without a prewarm twin; never
    # fails a trial.
    prewarm: bool = True
    # Compile-cache directory wired at run() start (KATIB_COMPILE_CACHE
    # wins): the port keeps the shape registry's rows and the local artifact
    # tier of its kernel libraries under <cache>/torch; empty/unset disables.
    compile_cache: str | None = None
    # Shared artifact tier: a fleet-shared directory of the port's compiled
    # kernel libraries (compile/artifacts.py).  A kernel library missing
    # from the build directory is fetched from the tiers before nvcc runs,
    # and one nvcc built is published.  KATIB_ARTIFACT_DIR wins;
    # empty/unset disables the tier (the local <compile_cache>/torch/
    # artifacts tier still works).
    artifact_dir: str | None = None
    # Hang watchdog: classify a trial FailureKind.HANG (and interrupt it)
    # when no progress signal lands for this long — propagated into every
    # TrialSpec (see TrialSpec.progress_deadline_seconds).  None = disabled.
    progress_deadline_seconds: float | None = None
    # Graceful-drain window after SIGTERM/SIGINT on `katib-tpu run`: running
    # trials get this long to checkpoint-and-exit at a step boundary before
    # being hard-killed (still journaled Drained, so resume re-runs them).
    drain_grace_seconds: float = 30.0
    # Compile watchdog: fail a trial FailureKind.COMPILE_HANG (retryable)
    # when its jit compile + first dispatch exceed this budget — propagated
    # into every TrialSpec (see TrialSpec.compile_deadline_seconds).
    # None = disabled.
    compile_deadline_seconds: float | None = None
    # Async orchestrator (podracer-style decoupled suggest/schedule/harvest
    # loops, orchestrator/async_loops.py): None decides from the
    # KATIB_ASYNC_ORCH env var (default ON; "0" keeps the legacy
    # synchronous propose->execute->harvest loop for one release).
    async_orch: bool | None = None
    # Async suggest loop: how many proposed-but-undispatched trials to keep
    # journaled and ready ahead of the scheduler, so suggester latency hides
    # behind training instead of idling the mesh.  None = auto:
    # max(parallel_trial_count, effective cohort width) for an adaptive
    # suggester, 4 x that for one whose points never depend on results.
    suggest_lookahead: int | None = None
    # Async schedule loop backpressure: dispatch new work while measured
    # device occupancy (busy executor slots / parallel_trial_count) is below
    # this target; 1.0 keeps every slot busy with one unit queued behind it,
    # lower values deliberately throttle (e.g. leave headroom for a
    # co-tenant experiment).
    occupancy_target: float = 1.0
    # Async cohort packing: a partially-filled shape bucket flushes after
    # waiting this long for more compatible ready trials (and immediately
    # when the remaining max_trial_count budget can never fill it) instead
    # of waiting indefinitely for a full-width group.
    cohort_fill_deadline_seconds: float = 2.0
    # Loop supervision (orchestrator/supervisor.py): a live async loop whose
    # progress watermark has not advanced for this long — while upstream work
    # was available — is classified STALLED and restarted from journal state.
    loop_stall_deadline_seconds: float = 60.0
    # Per-loop restart budget: after this many restarts of any single loop
    # the supervisor stops healing and degrades to the synchronous path
    # (KATIB_ASYNC_ORCH=0 semantics) instead of dying. 0 = never restart,
    # fall back on the first crash/stall.
    loop_restart_budget: int = 3
    # On-device PBT escape hatch (pbt-ondevice algorithm, parallel/pbt.py):
    # None defers to the algorithm's `on_device` setting (default ON);
    # False forces the host checkpoint-exchange path, True forces the
    # fused on-device generation loop.  KATIB_PBT_ONDEVICE env wins over
    # both (operator kill switch without editing specs).
    pbt_ondevice: bool | None = None
    # Speculative straggler re-dispatch: when a member runs past
    # straggler_factor x the median settle time it is re-submitted as a
    # singleton; first settle wins (exactly-once journal keying), the rival
    # is cancelled/ignored. Off by default — it burns a slot per straggler.
    speculative_redispatch: bool = False
    straggler_factor: float = 4.0

    def parameter(self, name: str) -> ParameterSpec:
        for p in self.parameters:
            if p.name == name:
                return p
        raise KeyError(name)

    def search_space_size(self) -> float:
        """Cardinality of the fully-discrete space, inf if any double lacks a step."""
        size = 1.0
        for p in self.parameters:
            if p.type is ParameterType.DOUBLE and not p.feasible.step:
                return math.inf
            size *= len(p.grid_values())
        return size


@dataclass
class OptimalTrial:
    """Best-so-far tracking (reference ``experiment/util/status_util.go``)."""

    trial_name: str
    objective_value: float
    assignments: list[ParameterAssignment]
    observation: Observation


# Trial label naming the device count the trial's sub-mesh lease should
# span.  Lives here (jax-free module) so the producers (suggesters) and the
# consumer (orchestrator + ElasticSliceAllocator) share one definition
# without dragging jax into metadata-only import paths.
DEVICES_LABEL = "katib-tpu/devices"

# Trial label naming the vectorized-cohort compatibility class: trials whose
# specs carry the same value (same model, shapes, step count) may be batched
# into one vmapped program up to ExperimentSpec.cohort_width.  Jax-free for
# the same reason as DEVICES_LABEL — suggesters stamp it, the orchestrator
# groups on it, runner/cohort.py executes the group.
COHORT_KEY_LABEL = "katib-tpu/cohort-key"


@dataclass
class Experiment:
    """Experiment instance + live status (spec + the reference's ExperimentStatus,
    ``experiment_types.go:83-134``)."""

    spec: ExperimentSpec
    condition: ExperimentCondition = ExperimentCondition.CREATED
    trials: dict[str, Trial] = field(default_factory=dict)
    optimal: OptimalTrial | None = None
    start_time: float = field(default_factory=lambda: get_clock().time())
    completion_time: float = 0.0
    message: str = ""
    # Mutable algorithm settings (Hyperband state lives here; reference
    # round-trips it via Suggestion.Status.AlgorithmSettings).
    algorithm_settings: dict[str, str] = field(default_factory=dict)
    # best-objective@wallclock: one row per improvement of the optimal
    # trial ({time, elapsed_s, objective_value, trial_name}) — the BASELINE
    # driver metric, journaled with the status so every experiment carries
    # its own convergence curve
    optimal_history: list[dict] = field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.algorithm_settings:
            self.algorithm_settings = dict(self.spec.algorithm.settings)

    @property
    def name(self) -> str:
        return self.spec.name

    # -- status accounting (reference ``experiment/util/status_util.go``) ---

    def trials_by_condition(self, cond: TrialCondition) -> list[Trial]:
        return [t for t in self.trials.values() if t.condition is cond]

    @property
    def succeeded_count(self) -> int:
        return len(self.trials_by_condition(TrialCondition.SUCCEEDED))

    @property
    def failed_count(self) -> int:
        return len(self.trials_by_condition(TrialCondition.FAILED))

    @property
    def early_stopped_count(self) -> int:
        return len(self.trials_by_condition(TrialCondition.EARLY_STOPPED))

    @property
    def metrics_unavailable_count(self) -> int:
        return len(self.trials_by_condition(TrialCondition.METRICS_UNAVAILABLE))

    @property
    def running_count(self) -> int:
        return sum(1 for t in self.trials.values() if not t.condition.is_terminal())

    @property
    def completed_count(self) -> int:
        return sum(1 for t in self.trials.values() if t.condition.is_completed_ok())

    def iter_completed(self) -> Iterator[Trial]:
        return (t for t in self.trials.values() if t.condition.is_completed_ok())

    def update_optimal(self, settled: Iterable[Trial] | None = None) -> None:
        """Recompute the best trial (reference ``status_util.go`` optimal-trial agg).

        ``settled`` narrows the aggregation to just-settled trials, folded
        into the standing ``optimal`` instead of rescanning every completed
        trial — the harvest path settles in small batches, so the full scan
        made settlement quadratic in trial count (dominant at simulator /
        large-sweep scale).  A completed trial's objective value is frozen
        at settlement, so folding each exactly once is equivalent to the
        full recompute.  With no argument the full scan runs (resume paths,
        terminal verdicts, anything that mutated history wholesale).
        """
        obj = self.spec.objective
        if settled is None:
            best: OptimalTrial | None = None
            pool: Iterable[Trial] = self.iter_completed()
        else:
            best = self.optimal
            pool = (t for t in settled if t.condition.is_completed_ok())
        for t in pool:
            v = t.objective_value(obj)
            if v is None or math.isnan(v):
                continue
            if best is None or obj.type.better(v, best.objective_value):
                best = OptimalTrial(
                    trial_name=t.name,
                    objective_value=v,
                    assignments=list(t.spec.assignments),
                    observation=t.observation or Observation(),
                )
        self.optimal = best
        if best is not None:
            last = self.optimal_history[-1] if self.optimal_history else None
            if (
                last is None
                or last["objective_value"] != best.objective_value
                or last["trial_name"] != best.trial_name
            ):
                now = get_clock().time()
                # a recompute AFTER completion (e.g. resuming an old journal
                # that predates the curve) must not charge process downtime
                # to the curve: the run's own clock ends at completion_time
                clock = now
                if self.completion_time and self.condition.is_terminal():
                    clock = min(now, self.completion_time)
                self.optimal_history.append(
                    {
                        "time": now,
                        "elapsed_s": round(max(clock - self.start_time, 0.0), 3),
                        "objective_value": best.objective_value,
                        "trial_name": best.trial_name,
                    }
                )


def clone_with(obj: Any, **changes: Any) -> Any:
    """dataclasses.replace that tolerates frozen types."""
    return dataclasses.replace(obj, **changes)
