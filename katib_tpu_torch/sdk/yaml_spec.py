"""Katib-style Experiment YAML → ``ExperimentSpec``.

Accepts the reference's Experiment CR shape (``apiVersion: kubeflow.org/...``
``kind: Experiment`` with ``metadata.name`` + ``spec.{objective, algorithm,
parameters, ...}`` — see ``examples/v1beta1/hp-tuning/random.yaml``), so an
unmodified Katib CR loads: a nested K8s ``trialTemplate.trialSpec`` has its
primary container's argv extracted with trialParameter placeholders
rewritten, or the template carries a flat ``command`` argv directly.
White-box trials come from ``trialTemplate.trainFn`` (a dotted import
path to a ``train_fn(ctx)``; a ``katib_tpu.`` path names the port's function
of the same module, :func:`resolve_train_fn`) or by setting ``train_fn`` via
the SDK.  Port of ``katib_tpu/sdk/yaml_spec.py``.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import yaml

from katib_tpu_torch.core.types import (
    AlgorithmSpec,
    Distribution,
    EarlyStoppingSpec,
    ExperimentSpec,
    FeasibleSpace,
    GraphConfig,
    MetricsCollectorKind,
    MetricsCollectorSpec,
    MetricStrategy,
    MetricStrategyType,
    NasConfig,
    NasOperation,
    ObjectiveSpec,
    ObjectiveType,
    ParameterSpec,
    ParameterType,
    ResumePolicy,
)


class SpecError(ValueError):
    pass


def _num(value: Any) -> float:
    # the reference CR encodes feasibleSpace numbers as strings
    return float(value)


def _settings_list(raw: Any) -> dict[str, str]:
    """algorithmSettings come as [{name, value}] in the CR; accept plain
    mappings too."""
    if raw is None:
        return {}
    if isinstance(raw, Mapping):
        return {str(k): str(v) for k, v in raw.items()}
    out: dict[str, str] = {}
    for item in raw:
        out[str(item["name"])] = str(item["value"])
    return out


def _parse_parameter(raw: Mapping[str, Any]) -> ParameterSpec:
    try:
        name = raw["name"]
        ptype = ParameterType(raw.get("parameterType", raw.get("type")))
    except (KeyError, ValueError) as e:
        raise SpecError(f"bad parameter entry {raw!r}: {e}") from e
    fs = raw.get("feasibleSpace", raw.get("feasible", {})) or {}
    dist = fs.get("distribution", "uniform")
    try:
        distribution = Distribution(dist)
    except ValueError as e:
        raise SpecError(f"parameter {name!r}: unknown distribution {dist!r}") from e
    values = fs.get("list")
    if ptype in (ParameterType.DOUBLE, ParameterType.INT):
        feasible = FeasibleSpace(
            min=_num(fs["min"]) if "min" in fs else None,
            max=_num(fs["max"]) if "max" in fs else None,
            step=_num(fs["step"]) if fs.get("step") is not None else None,
            distribution=distribution,
        )
    else:
        if values is None:
            raise SpecError(f"parameter {name!r}: {ptype.value} requires a list")
        if ptype is ParameterType.DISCRETE:
            values = tuple(_num(v) for v in values)
        else:
            values = tuple(str(v) for v in values)
        feasible = FeasibleSpace(list=values, distribution=distribution)
    return ParameterSpec(name=name, type=ptype, feasible=feasible)


def _parse_objective(raw: Mapping[str, Any]) -> ObjectiveSpec:
    try:
        otype = ObjectiveType(raw["type"])
        metric = raw["objectiveMetricName"]
    except (KeyError, ValueError) as e:
        raise SpecError(f"bad objective {raw!r}: {e}") from e
    strategies = tuple(
        MetricStrategy(name=s["name"], value=MetricStrategyType(s["value"]))
        for s in raw.get("metricStrategies") or ()
    )
    return ObjectiveSpec(
        type=otype,
        objective_metric_name=metric,
        goal=float(raw["goal"]) if raw.get("goal") is not None else None,
        additional_metric_names=tuple(raw.get("additionalMetricNames") or ()),
        metric_strategies=strategies,
    )


def _parse_collector(raw: Mapping[str, Any] | None) -> MetricsCollectorSpec:
    if not raw:
        return MetricsCollectorSpec(kind=MetricsCollectorKind.STDOUT)
    # CR shape: {collector: {kind}, source: {filter: {metricsFormat: [...]},
    # fileSystemPath: {path, kind}, httpGet: {port, path}}}; flat shape:
    # {kind, path, filter, port, scrapeInterval}
    kind_raw = (raw.get("collector") or {}).get("kind", raw.get("kind", "StdOut"))
    # the reference CRD spells this kind "PrometheusMetric"
    # (``common_types.go:216``); accept it so upstream YAMLs round-trip
    if kind_raw == "PrometheusMetric":
        kind_raw = "Prometheus"
    try:
        kind = MetricsCollectorKind(kind_raw)
    except ValueError as e:
        raise SpecError(f"unknown metrics collector kind {kind_raw!r}") from e
    source = raw.get("source") or {}
    formats = (source.get("filter") or {}).get("metricsFormat") or []
    http_get = source.get("httpGet") or {}
    path = (
        (source.get("fileSystemPath") or {}).get("path")
        or http_get.get("path")
        or raw.get("path")
    )
    filter_ = formats[0] if formats else raw.get("filter")
    port = http_get.get("port", raw.get("port"))
    interval = raw.get("scrapeInterval", raw.get("scrape_interval", 1.0))
    return MetricsCollectorSpec(
        kind=kind,
        path=path,
        filter=filter_,
        port=int(port) if port is not None else None,
        scrape_interval=float(interval),
    )


def _parse_nas_config(raw: Mapping[str, Any] | None) -> NasConfig | None:
    """CR shape (reference ``experiment_types.go:304-320``):
    {graphConfig: {numLayers, inputSizes, outputSizes},
     operations: [{operationType, parameters: [...]}]}."""
    if not raw:
        return None
    gc_raw = raw.get("graphConfig") or raw.get("graph_config") or {}
    graph = GraphConfig(
        num_layers=int(gc_raw.get("numLayers", gc_raw.get("num_layers", 8))),
        input_sizes=tuple(int(v) for v in gc_raw.get("inputSizes", gc_raw.get("input_sizes")) or ()),
        output_sizes=tuple(int(v) for v in gc_raw.get("outputSizes", gc_raw.get("output_sizes")) or ()),
    )
    operations = tuple(
        NasOperation(
            operation_type=op.get("operationType", op.get("operation_type")),
            parameters=tuple(_parse_parameter(p) for p in op.get("parameters") or ()),
        )
        for op in raw.get("operations") or ()
    )
    return NasConfig(graph_config=graph, operations=operations)


def _find_containers(node: Any) -> list:
    """Collect EVERY ``containers`` list inside an arbitrary K8s manifest
    (Job, TFJob, PyTorchJob... all nest pod templates differently — the
    reference's trial job is an arbitrary GVK, ``trial_types.go:42``).  All
    of them, not the first: a multi-replica TFJob's primary container can
    live in any replica's pod template."""
    out: list = []
    if isinstance(node, Mapping):
        got = node.get("containers")
        if isinstance(got, list):
            out.extend(c for c in got if isinstance(c, Mapping))
        for v in node.values():
            out.extend(_find_containers(v))
    elif isinstance(node, list):
        for v in node:
            out.extend(_find_containers(v))
    return out


def _command_from_trial_spec(template: Mapping[str, Any]) -> list[str] | None:
    """Extract the primary container's argv from a reference-style nested
    ``trialTemplate.trialSpec`` (K8s Job manifest) and rewrite its
    ``${trialParameters.<name>}`` placeholders to the experiment parameter
    each trialParameter references — the loader-side analog of the
    reference's manifest generator substitution (``manifest/generator.go:
    79-126``), so an unmodified Katib CR round-trips (the container image
    itself does not transfer; the user points the argv at a local trainer).
    """
    containers = _find_containers(template.get("trialSpec"))
    if not containers:
        return None
    primary = template.get("primaryContainerName")
    if primary:
        container = next((c for c in containers if c.get("name") == primary), None)
        if container is None:
            # a silent containers[0] fallback would extract a sidecar's argv
            raise SpecError(
                f"primaryContainerName {primary!r} matches no container in "
                f"trialSpec (found: {[c.get('name') for c in containers]})"
            )
    else:
        container = containers[0]
    argv = list(container.get("command") or []) + list(container.get("args") or [])
    if not argv:
        return None
    return _apply_trial_parameter_renames(argv, template)


# single simultaneous pass: sequential str.replace would chain when one
# trialParameter's reference is another trialParameter's name
_TRIAL_PARAM_REF = re.compile(r"\$\{trialParameters\.([^}]+)\}")


def _apply_trial_parameter_renames(
    argv: list, template: Mapping[str, Any]
) -> list[str]:
    """Rewrite ``${trialParameters.<name>}`` placeholders through the
    template's ``trialParameters`` name->reference table (applies to flat
    ``command`` templates and extracted K8s trialSpec argv alike)."""
    renames = {
        str(tp["name"]): str(tp["reference"])
        for tp in template.get("trialParameters") or ()
        if isinstance(tp, Mapping) and tp.get("name") and tp.get("reference")
    }
    if not renames:
        return [str(token) for token in argv]

    def rewrite(m: "re.Match[str]") -> str:
        name = m.group(1)
        ref = renames.get(name, name)
        if ref.startswith("${trialSpec."):
            # metadata reference (reference generator.go:148-171): keep the
            # raw ${trialSpec.*} form — the trial runner resolves it against
            # the materialized trial, not the parameter assignments
            return ref
        return "${trialParameters." + ref + "}"

    return [_TRIAL_PARAM_REF.sub(rewrite, str(token)) for token in argv]


_JAX_PACKAGE = "katib_tpu"
_PORT_PACKAGE = "katib_tpu_torch"


def port_train_fn_path(path: str) -> str:
    """``katib_tpu.<module>.<fn>`` -> ``katib_tpu_torch.<module>.<fn>``; any
    other dotted path is returned as it is."""
    head, _, rest = path.partition(".")
    if head == _JAX_PACKAGE and rest:
        return f"{_PORT_PACKAGE}.{rest}"
    return path


def resolve_train_fn(path: str):
    """Import the ``train_fn(ctx)`` a spec's ``trainFn`` names.

    A JAX-package path resolves to the port's function of the same module
    and name; the JAX package itself is never imported.  Where the port has
    no such function yet, this raises ``NotImplementedError`` naming the JAX
    path, so a spec never runs something other than what it names."""
    import importlib

    mod_name, _, attr = port_train_fn_path(path).rpartition(".")
    if not mod_name:
        raise SpecError(f"trainFn {path!r} must be module.attr")
    ported = mod_name.split(".")[0] == _PORT_PACKAGE
    try:
        module = importlib.import_module(mod_name)
    except ModuleNotFoundError as e:
        if ported and (e.name or "").startswith(_PORT_PACKAGE):
            raise NotImplementedError(
                f"trainFn {path!r}: the port has no module {mod_name} yet"
            ) from e
        raise SpecError(f"trainFn {path!r} not importable: {e}") from e
    except ImportError as e:
        raise SpecError(f"trainFn {path!r} not importable: {e}") from e
    try:
        return getattr(module, attr)
    except AttributeError as e:
        if ported:
            raise NotImplementedError(
                f"trainFn {path!r}: the port has no {mod_name}.{attr} yet"
            ) from e
        raise SpecError(f"trainFn {path!r} not importable: {e}") from e


def experiment_spec_from_dict(data: Mapping[str, Any]) -> ExperimentSpec:
    """Build an ExperimentSpec from a CR-shaped or flat mapping."""
    if "spec" in data:  # CR shape
        name = (data.get("metadata") or {}).get("name")
        spec = data["spec"]
    else:
        name = data.get("name")
        spec = data
    if not name:
        raise SpecError("experiment name missing (metadata.name or name)")
    if "objective" not in spec:
        raise SpecError("spec.objective is required")

    algo_raw = spec.get("algorithm") or {}
    algorithm = AlgorithmSpec(
        name=algo_raw.get("algorithmName", algo_raw.get("name", "random")),
        settings=_settings_list(
            algo_raw.get("algorithmSettings", algo_raw.get("settings"))
        ),
    )
    early_stopping = None
    es_raw = spec.get("earlyStopping")
    if es_raw:
        early_stopping = EarlyStoppingSpec(
            name=es_raw.get("algorithmName", es_raw.get("name", "medianstop")),
            settings=_settings_list(
                es_raw.get("algorithmSettings", es_raw.get("settings"))
            ),
        )

    # trialTemplate: only the command argv carries over (the reference's
    # ${trialParameters.X} placeholders work unchanged); K8s job fields are
    # meaningless here.  A full reference CR with a nested K8s Job trialSpec
    # also loads: the primary container's argv is extracted and its
    # trialParameter names rewritten to the parameter names they reference.
    command = spec.get("command")
    template = spec.get("trialTemplate") or {}
    if command is None:
        command = template.get("command")
        if command is not None:
            command = _apply_trial_parameter_renames(command, template)
    if command is None and template.get("trialSpec"):
        command = _command_from_trial_spec(template)

    # white-box trials from YAML: ``trialTemplate.trainFn`` names a dotted
    # import path to a ``train_fn(ctx)`` (e.g. the packaged workloads in
    # models/ and nas/) — the CR analog of passing train_fn in Python
    train_fn = None
    train_fn_path = template.get("trainFn") or spec.get("trainFn")
    if train_fn_path:
        train_fn = resolve_train_fn(str(train_fn_path))

    resume = spec.get("resumePolicy", "Never")
    try:
        resume_policy = ResumePolicy(resume)
    except ValueError as e:
        raise SpecError(f"unknown resumePolicy {resume!r}") from e

    return ExperimentSpec(
        name=name,
        objective=_parse_objective(spec["objective"]),
        algorithm=algorithm,
        parameters=[_parse_parameter(p) for p in spec.get("parameters") or ()],
        early_stopping=early_stopping,
        parallel_trial_count=int(spec.get("parallelTrialCount", 3)),
        max_trial_count=(
            int(spec["maxTrialCount"]) if spec.get("maxTrialCount") is not None else None
        ),
        max_failed_trial_count=(
            int(spec["maxFailedTrialCount"])
            if spec.get("maxFailedTrialCount") is not None
            else None
        ),
        resume_policy=resume_policy,
        metrics_collector=_parse_collector(spec.get("metricsCollectorSpec")),
        command=[str(c) for c in command] if command else None,
        train_fn=train_fn,
        nas_config=_parse_nas_config(spec.get("nasConfig")),
        retain=bool(spec.get("retain", template.get("retain", False))),
        max_trial_runtime_seconds=(
            float(spec["maxTrialRuntimeSeconds"])
            if spec.get("maxTrialRuntimeSeconds") is not None
            else None
        ),
        metrics_retries=int(spec.get("metricsRetries", 0)),
        max_retries=int(spec.get("maxRetries", 0)),
        retry_backoff_seconds=float(spec.get("retryBackoffSeconds", 1.0)),
        suggester_max_errors=int(spec.get("suggesterMaxErrors", 5)),
        progress_deadline_seconds=(
            float(spec["progressDeadlineSeconds"])
            if spec.get("progressDeadlineSeconds") is not None
            else None
        ),
        drain_grace_seconds=float(spec.get("drainGraceSeconds", 30.0)),
        cohort_width=int(spec.get("cohortWidth", 1)),
        cohort_key=(
            str(spec["cohortKey"]) if spec.get("cohortKey") is not None else None
        ),
        cohort_buckets=bool(spec.get("cohortBuckets", True)),
        prewarm=bool(spec.get("prewarm", True)),
        compile_cache=(
            str(spec["compileCache"]) if spec.get("compileCache") is not None else None
        ),
        artifact_dir=(
            str(spec["artifactDir"]) if spec.get("artifactDir") is not None else None
        ),
        compile_deadline_seconds=(
            float(spec["compileDeadlineSeconds"])
            if spec.get("compileDeadlineSeconds") is not None
            else None
        ),
        async_orch=(
            bool(spec["asyncOrch"]) if spec.get("asyncOrch") is not None else None
        ),
        suggest_lookahead=(
            int(spec["suggestLookahead"])
            if spec.get("suggestLookahead") is not None
            else None
        ),
        occupancy_target=float(spec.get("occupancyTarget", 1.0)),
        cohort_fill_deadline_seconds=float(spec.get("cohortFillDeadlineSeconds", 2.0)),
        loop_stall_deadline_seconds=float(spec.get("loopStallDeadlineSeconds", 60.0)),
        loop_restart_budget=int(spec.get("loopRestartBudget", 3)),
        speculative_redispatch=bool(spec.get("speculativeRedispatch", False)),
        straggler_factor=float(spec.get("stragglerFactor", 4.0)),
        pbt_ondevice=(
            bool(spec["pbtOnDevice"]) if spec.get("pbtOnDevice") is not None else None
        ),
    )


def load_experiment_yaml(path: str) -> ExperimentSpec:
    with open(path) as f:
        data = yaml.safe_load(f)
    if not isinstance(data, Mapping):
        raise SpecError(f"{path} must contain a mapping")
    return experiment_spec_from_dict(data)
