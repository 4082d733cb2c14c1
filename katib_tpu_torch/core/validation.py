"""Experiment validation — the in-process equivalent of the reference's
validating admission webhook (``pkg/webhook/v1beta1/experiment/validator/validator.go:67``).

Because there is no API server, validation runs synchronously when an
experiment is submitted to the orchestrator; errors raise ``ValidationError``
with all findings aggregated (matching the webhook's multi-error reporting).
"""

from __future__ import annotations

import math
import re

from katib_tpu_torch.core.types import (
    Experiment,
    ExperimentSpec,
    MetricsCollectorKind,
    ObjectiveSpec,
    ParameterSpec,
    ParameterType,
)


class ValidationError(ValueError):
    def __init__(self, errors: list[str]):
        self.errors = errors
        super().__init__("; ".join(errors))


# Algorithms that require a fully enumerable search space
# (reference grid validation in optuna base_service / webhook).
_GRID_ALGORITHMS = {"grid"}

# Algorithms that ignore `parameters` and use nas_config instead
# (reference ``validator.go`` NAS branch).
_NAS_ALGORITHMS = {"darts", "enas"}


def validate_objective(obj: ObjectiveSpec | None, errors: list[str]) -> None:
    """Reference ``validator.go:105-135``."""
    if obj is None:
        errors.append("objective is required")
        return
    if not obj.objective_metric_name:
        errors.append("objective.objective_metric_name is required")
    if obj.objective_metric_name in obj.additional_metric_names:
        errors.append("objective metric must not repeat in additional_metric_names")
    known = set(obj.all_metric_names())
    for s in obj.metric_strategies:
        if s.name not in known:
            errors.append(f"metric strategy for unknown metric {s.name!r}")


def validate_parameters(params: list[ParameterSpec], errors: list[str]) -> None:
    """Reference ``validator.go:137-200`` (parameter-space checks).

    Structural invariants (bounds, list presence) are enforced by
    ``ParameterSpec.__post_init__``; this layer checks cross-parameter rules.
    """
    seen: set[str] = set()
    for p in params:
        if p.name in seen:
            errors.append(f"duplicate parameter name {p.name!r}")
        seen.add(p.name)
        if p.type is ParameterType.DOUBLE and p.feasible.step is not None and p.feasible.step <= 0:
            errors.append(f"parameter {p.name!r}: step must be positive")


def validate_command_template(spec: ExperimentSpec, errors: list[str]) -> None:
    """Dry-run render of the black-box command template — the analog of the
    webhook's trial-template render check (``validator.go:254``): every
    ``${trialParameters.X}`` placeholder must name a declared parameter."""
    if not spec.command:
        return
    declared = {p.name for p in spec.parameters}
    for arg in spec.command:
        for pname in re.findall(r"\$\{trialParameters\.([^}]+)\}", arg):
            if pname not in declared:
                errors.append(
                    f"command references undeclared parameter {pname!r} "
                    f"(placeholder ${{trialParameters.{pname}}})"
                )


def validate_experiment(spec: ExperimentSpec) -> None:
    """Full validation; raises ``ValidationError`` with every finding."""
    errors: list[str] = []

    if not spec.name:
        errors.append("experiment name is required")
    else:
        # the name becomes a workdir path component (status journal,
        # checkpoint dirs) and may arrive from a URL/YAML; refuse anything
        # that escapes the workdir (the reference gets this for free from
        # K8s DNS-1123 object-name rules)
        from katib_tpu_torch.utils.names import is_safe_path_component

        if not is_safe_path_component(spec.name):
            errors.append(f"experiment name {spec.name!r} must not contain path separators")
    validate_objective(spec.objective, errors)

    if not spec.algorithm or not spec.algorithm.name:
        errors.append("algorithm.name is required")
    algo = spec.algorithm.name if spec.algorithm else ""
    # ``remote`` serves the algorithm its ``algorithm`` setting names: ENAS
    # behind a suggestion service is a NAS experiment too.  The JAX package
    # checks the name ``remote`` here and so refuses every NAS spec behind a
    # service (ROADMAP Queue 3, F12; fixed in the port only)
    served = spec.algorithm.setting("algorithm") if algo == "remote" else algo

    if served in _NAS_ALGORITHMS:
        if spec.nas_config is None:
            errors.append(f"algorithm {served!r} requires nas_config")
        elif not spec.nas_config.operations:
            errors.append("nas_config.operations must be non-empty")
    else:
        if not spec.parameters:
            errors.append("parameters must be non-empty for non-NAS algorithms")
        validate_parameters(spec.parameters, errors)

    if algo in _GRID_ALGORITHMS and spec.parameters:
        if math.isinf(spec.search_space_size()):
            errors.append(
                "grid search requires a finite space: every double parameter needs a step"
            )

    if spec.parallel_trial_count < 1:
        errors.append("parallel_trial_count must be >= 1")
    if spec.max_trial_count is not None and spec.max_trial_count < 1:
        errors.append("max_trial_count must be >= 1")
    if spec.max_failed_trial_count is not None and spec.max_failed_trial_count < 0:
        errors.append("max_failed_trial_count must be >= 0")
    if spec.metrics_retries < 0:
        errors.append("metrics_retries must be >= 0")
    if spec.max_retries < 0:
        errors.append("max_retries must be >= 0")
    if spec.retry_backoff_seconds < 0:
        errors.append("retry_backoff_seconds must be >= 0")
    if spec.suggester_max_errors < 1:
        errors.append("suggester_max_errors must be >= 1")
    if spec.cohort_width < 1:
        errors.append("cohort_width must be >= 1")
    if spec.suggest_lookahead is not None and spec.suggest_lookahead < 1:
        errors.append("suggest_lookahead must be >= 1")
    if not (0.0 < spec.occupancy_target <= 1.0):
        errors.append("occupancy_target must be in (0, 1]")
    if spec.cohort_fill_deadline_seconds < 0:
        errors.append("cohort_fill_deadline_seconds must be >= 0")
    if spec.loop_stall_deadline_seconds <= 0:
        errors.append("loop_stall_deadline_seconds must be > 0")
    if spec.loop_restart_budget < 0:
        errors.append("loop_restart_budget must be >= 0")
    if spec.straggler_factor <= 1.0:
        errors.append("straggler_factor must be > 1")
    if spec.cohort_width > 1 and spec.command is not None:
        # cohorts vectorize a white-box JAX program; a subprocess argv has
        # no train step to vmap
        errors.append("cohort_width > 1 applies to white-box train_fn trials only")

    if spec.train_fn is not None and spec.command is not None:
        errors.append("specify exactly one of train_fn or command, not both")
    if spec.train_fn is None and spec.command is None:
        errors.append("one of train_fn or command is required")
    if spec.command is not None and spec.metrics_collector.kind is MetricsCollectorKind.PUSH:
        errors.append(
            "black-box command trials need a file/stdout metrics collector, not Push"
        )
    if spec.metrics_collector.kind in (
        MetricsCollectorKind.FILE,
        MetricsCollectorKind.JSONL,
        MetricsCollectorKind.TFEVENT,
    ) and not spec.metrics_collector.path:
        errors.append(
            f"metrics collector kind {spec.metrics_collector.kind.value} requires a path"
        )
    if (
        spec.early_stopping is not None
        and spec.metrics_collector.kind is MetricsCollectorKind.TFEVENT
    ):
        # event files are parsed once after exit, so rules could never fire
        # mid-run (the reference only wires early stopping into the
        # line-based file collector, ``file-metricscollector/main.go:332``)
        errors.append(
            "early stopping requires a line-based metrics collector "
            "(StdOut/File/JsonLines/Push), not TensorFlowEvent"
        )
    validate_command_template(spec, errors)

    if errors:
        raise ValidationError(errors)


def validate_and_wrap(spec: ExperimentSpec) -> Experiment:
    validate_experiment(spec)
    return Experiment(spec=spec)
