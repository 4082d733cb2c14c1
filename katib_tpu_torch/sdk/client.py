"""User-facing client API (port of ``katib_tpu/sdk/client.py``).

Parity with the reference Python SDK's ``KatibClient``
(``sdk/python/v1beta1/kubeflow/katib/api/katib_client.py:78,152``): the two
entry points users actually touch are ``tune()`` (objective function +
search-space dict in, best hyperparameters out) and experiment CRUD.  The
reference serializes the objective into a container image and round-trips
everything through CRDs; here trials are white-box Python functions and the
client drives the in-process orchestrator directly — same surface, no
cluster.

Trials run on ``device``: ``cuda`` unless the caller names the CPU.  A
``mesh`` (``parallel/mesh.py``) reaches the orchestrator, and each trial
gets it as ``ctx.mesh``; a ``trial`` axis > 1 raises ``NotImplementedError``
(ROADMAP item 9b).
"""

from __future__ import annotations

import inspect
import threading
from typing import Any, Callable, Mapping

from katib_tpu_torch.core.types import (
    AlgorithmSpec,
    EarlyStoppingSpec,
    Experiment,
    ExperimentCondition,
    ExperimentSpec,
    MetricsCollectorKind,
    MetricsCollectorSpec,
    ObjectiveSpec,
    ObjectiveType,
)
from katib_tpu_torch.orchestrator.orchestrator import Orchestrator
from katib_tpu_torch.sdk.search import make_parameters
from katib_tpu_torch.store.base import ObservationStore


def _wrap_objective(objective: Callable, metric_name: str) -> Callable:
    """Adapt a user objective to the trial ``train_fn(ctx)`` contract.

    Accepted shapes (the reference's ``tune()`` only takes
    ``objective(parameters)`` that prints metric lines — we keep that and add
    richer forms):

    - ``f(params) -> float``            return value reported as the objective
    - ``f(params) -> dict``             all keys reported as metrics
    - ``f(params, ctx)`` / ``f(ctx)``   full control: ``ctx.report(...)`` per step
    """
    sig = inspect.signature(objective)
    n_pos = len(
        [
            p
            for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
        ]
    )
    wants_ctx_only = n_pos == 1 and next(iter(sig.parameters)) in ("ctx", "context")

    def train_fn(ctx) -> None:
        if wants_ctx_only:
            result = objective(ctx)
        elif n_pos >= 2:
            result = objective(ctx.params, ctx)
        else:
            result = objective(ctx.params)
        if result is None:
            return
        if isinstance(result, Mapping):
            ctx.report(**{k: float(v) for k, v in result.items()})
        else:
            ctx.report(**{metric_name: float(result)})

    return train_fn


def make_experiment_spec(
    name: str,
    search_space: dict[str, Any] | None = None,
    *,
    objective: Callable | None = None,
    command: list[str] | None = None,
    objective_metric_name: str = "objective",
    objective_type: ObjectiveType | str = ObjectiveType.MAXIMIZE,
    additional_metric_names: tuple[str, ...] = (),
    goal: float | None = None,
    algorithm: str = "random",
    algorithm_settings: Mapping[str, str] | None = None,
    early_stopping: str | None = None,
    early_stopping_settings: Mapping[str, str] | None = None,
    max_trial_count: int | None = None,
    parallel_trial_count: int = 3,
    max_failed_trial_count: int | None = None,
    metrics_collector: MetricsCollectorSpec | None = None,
) -> ExperimentSpec:
    """Assemble a validated ExperimentSpec from tune()-style keyword args."""
    if (objective is None) == (command is None):
        raise ValueError("exactly one of objective= / command= is required")
    if metrics_collector is None:
        metrics_collector = MetricsCollectorSpec(
            kind=MetricsCollectorKind.PUSH
            if objective is not None
            else MetricsCollectorKind.STDOUT
        )
    return ExperimentSpec(
        name=name,
        objective=ObjectiveSpec(
            type=ObjectiveType(objective_type),
            objective_metric_name=objective_metric_name,
            goal=goal,
            additional_metric_names=tuple(additional_metric_names),
        ),
        algorithm=AlgorithmSpec(name=algorithm, settings=dict(algorithm_settings or {})),
        early_stopping=(
            EarlyStoppingSpec(name=early_stopping, settings=dict(early_stopping_settings or {}))
            if early_stopping
            else None
        ),
        parameters=make_parameters(search_space or {}),
        max_trial_count=max_trial_count,
        parallel_trial_count=parallel_trial_count,
        max_failed_trial_count=max_failed_trial_count,
        metrics_collector=metrics_collector,
        train_fn=_wrap_objective(objective, objective_metric_name) if objective else None,
        command=list(command) if command else None,
    )


class KatibClient:
    """Experiment CRUD + wait/optimal accessors (reference ``katib_client.py``).

    Experiments run on daemon threads so ``create_experiment`` returns
    immediately (the reference's CR creation is likewise async); ``tune``
    blocks by default because that is how the reference's notebook flow is
    used in practice.
    """

    def __init__(
        self,
        store: ObservationStore | None = None,
        workdir: str = "katib_runs",
        mesh=None,
        device=None,
    ):
        self._orchestrators: dict[str, Orchestrator] = {}
        self._experiments: dict[str, Experiment] = {}
        self._threads: dict[str, threading.Thread] = {}
        self._errors: dict[str, BaseException] = {}
        self._store = store
        self._workdir = workdir
        self._mesh = mesh
        self._device = device
        self._lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------

    def create_experiment(self, spec: ExperimentSpec) -> Experiment:
        """Start an experiment asynchronously; returns the live object whose
        status the orchestrator mutates in place."""
        with self._lock:
            if spec.name in self._experiments and not self._experiments[
                spec.name
            ].condition.is_terminal():
                raise ValueError(f"experiment {spec.name!r} already running")
            orch = Orchestrator(store=self._store, workdir=self._workdir, mesh=self._mesh,
                                device=self._device)
            exp = Experiment(spec=spec)
            self._orchestrators[spec.name] = orch
            self._experiments[spec.name] = exp
            self._errors.pop(spec.name, None)

            def _run() -> None:
                # surface pre-run failures (bad algorithm, invalid space) —
                # a bare daemon thread would swallow them and leave the
                # experiment stuck non-terminal
                try:
                    orch.run(spec, exp)
                except BaseException as e:  # noqa: BLE001
                    import time as _time

                    exp.condition = ExperimentCondition.FAILED
                    exp.message = f"{type(e).__name__}: {e}"
                    exp.completion_time = _time.time()
                    self._errors[spec.name] = e

            t = threading.Thread(target=_run, name=f"exp-{spec.name}", daemon=True)
            self._threads[spec.name] = t
            t.start()
            return exp

    def tune(self, name: str, objective: Callable, search_space: dict, **kwargs) -> Experiment:
        """Blocking hyperparameter tuning (reference ``katib_client.py:152``)."""
        spec = make_experiment_spec(name, search_space, objective=objective, **kwargs)
        self.create_experiment(spec)
        return self.wait_for_experiment_condition(name)

    # -- accessors ----------------------------------------------------------

    def get_experiment(self, name: str) -> Experiment:
        return self._experiments[name]

    def list_experiments(self) -> list[Experiment]:
        return list(self._experiments.values())

    def is_experiment_succeeded(self, name: str) -> bool:
        cond = self._experiments[name].condition
        return cond in (
            ExperimentCondition.SUCCEEDED,
            ExperimentCondition.GOAL_REACHED,
            ExperimentCondition.MAX_TRIALS_REACHED,
        )

    def wait_for_experiment_condition(
        self, name: str, timeout: float | None = None
    ) -> Experiment:
        """Block until the experiment reaches a terminal condition (reference
        ``wait_for_experiment_condition``, default watches for Succeeded)."""
        t = self._threads[name]
        t.join(timeout)
        if t.is_alive():
            raise TimeoutError(f"experiment {name!r} still running after {timeout}s")
        if name in self._errors:
            raise self._errors[name]
        return self._experiments[name]

    def get_optimal_hyperparameters(self, name: str) -> dict[str, Any]:
        """Best parameter assignment found (reference
        ``katib_client.py`` ``get_optimal_hyperparameters``)."""
        exp = self._experiments[name]
        if exp.optimal is None:
            return {}
        return {a.name: a.value for a in exp.optimal.assignments}

    def get_trials(self, name: str):
        return list(self._experiments[name].trials.values())

    def delete_experiment(self, name: str) -> None:
        """Stop (if running) and forget an experiment."""
        with self._lock:
            orch = self._orchestrators.pop(name, None)
            self._experiments.pop(name, None)
            t = self._threads.pop(name, None)
            self._errors.pop(name, None)
        if orch is not None:
            orch.stop()
        if t is not None:
            t.join(timeout=30)


def tune(
    objective: Callable,
    search_space: dict[str, Any],
    *,
    name: str = "tune",
    store: ObservationStore | None = None,
    workdir: str = "katib_runs",
    mesh=None,
    device=None,
    **kwargs,
) -> Experiment:
    """One-call tuning without instantiating a client — the module-level
    convenience the reference exposes as ``KatibClient().tune(...)``."""
    spec = make_experiment_spec(name, search_space, objective=objective, **kwargs)
    orch = Orchestrator(store=store, workdir=workdir, mesh=mesh, device=device)
    return orch.run(spec)
