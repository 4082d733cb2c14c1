"""Trial runner: the white-box path (port of ``katib_tpu/runner/trial_runner.py``).

The white-box path collapses the reference's trial pipeline (trial controller
creates Job -> pod webhook injects sidecar -> sidecar PNS-waits and scrapes
stdout -> gRPC to DB-manager -> controller polls observation,
``trial_controller.go:147-306`` + ``inject_webhook.go`` + ``pns.go``) into a
function call with a metrics callback.

It honors a shared ``stop_event``: when the orchestrator reaches a terminal
verdict (goal hit, failure budget blown) it sets the event and in-flight
trials wind down as ``Killed`` (the reference deletes running trial jobs on
experiment completion, ``experiment_controller.go:362-403``).

Not ported yet, and raising where asked for:

- the black-box ``command:`` path (``_run_blackbox`` and its metrics
  collectors);
- the persistent compile cache (:func:`init_compile_cache`);
- a trial mesh.

The JAX runner also classifies each trial's first step as a warm or cold
compile and publishes a live roofline through ``costmodel`` and
``compile.registry``.  That is telemetry only, it changes no result, and it
waits for the port's compile and cost layer.
"""

from __future__ import annotations

import os
import threading
import traceback

from katib_tpu_torch.core.types import Trial, TrialCondition
from katib_tpu_torch.earlystop.rules import RuleEvaluator
from katib_tpu_torch.runner.context import TrialContext, TrialEarlyStopped
from katib_tpu_torch.store.base import ObservationStore
from katib_tpu_torch.utils import observability as obs
from katib_tpu_torch.utils import tracing
from katib_tpu_torch.utils.faults import FailureKind, classify_exception

#: the environment variable the JAX runner reads for its compile cache
COMPILE_CACHE_ENV = "KATIB_COMPILE_CACHE"


def init_compile_cache(cache_dir: str | None = None) -> None:
    """The JAX package wires XLA's persistent compilation cache here
    (``KATIB_COMPILE_CACHE``, then the spec's ``compileCache``).  The port
    has no compile cache yet, so asking for one raises."""
    requested = os.environ.get(COMPILE_CACHE_ENV) or cache_dir
    if requested:
        raise NotImplementedError(
            f"compile cache {requested!r} (spec compileCache or "
            f"{COMPILE_CACHE_ENV}): the port has no persistent compile cache "
            "yet (katib_tpu/compile/)"
        )


class TrialResult:
    def __init__(
        self,
        condition: TrialCondition,
        message: str = "",
        failure_kind: FailureKind | None = None,
    ):
        self.condition = condition
        self.message = message
        # why the attempt failed (``utils.faults`` taxonomy) — the
        # orchestrator's retry loop re-runs TRANSIENT failures only
        self.failure_kind = failure_kind


def run_trial(
    trial: Trial,
    store: ObservationStore,
    objective,
    mesh=None,
    stop_event: threading.Event | None = None,
    injector=None,
    watchdog=None,
    drain_event: threading.Event | None = None,
    device=None,
) -> TrialResult:
    """Execute one trial to a terminal condition on ``device`` (``None`` =
    ``cuda``, through the trial's own device resolution).  Never raises: failures
    become ``TrialCondition.FAILED`` with the traceback in ``message`` and
    their ``FailureKind`` classified (budget accounting needs failed trials
    recorded, not exceptions — reference ``experiment_controller.go:274-330``).

    ``injector`` (a ``faults.FaultInjector``) is the chaos seam: it fires
    inside this classification try-block, so injected faults take exactly
    the path a real preemption or shape error would.

    ``watchdog`` (``utils.watchdog.Watchdog``) arms hang detection when the
    trial carries ``progress_deadline_seconds``; ``drain_event`` is the
    orchestrator's checkpoint-and-exit request (preemption SIGTERM) — both
    observable to the train_fn through its context.  A ``mesh`` raises:
    the port runs each trial on one device."""
    evaluator = RuleEvaluator(trial.spec.early_stopping_rules, objective)
    try:
        if injector is not None:
            injector.on_trial_attempt(trial)
            injector.apply_metrics_delay(trial, stop_event)
        if mesh is not None:
            raise NotImplementedError(
                "a trial mesh (katib_tpu/parallel/mesh.py): the port runs each "
                "trial on one device"
            )
        if trial.spec.train_fn is not None:
            return _run_whitebox(
                trial, store, evaluator, objective, stop_event,
                injector=injector, watchdog=watchdog, drain_event=drain_event,
                device=device,
            )
        if trial.spec.command:
            raise NotImplementedError(
                "black-box command: trials (_run_blackbox in "
                "katib_tpu/runner/trial_runner.py) are not ported yet"
            )
        return TrialResult(
            TrialCondition.FAILED,
            "trial has neither train_fn nor command",
            failure_kind=FailureKind.PERMANENT,
        )
    except Exception as e:
        return TrialResult(
            TrialCondition.FAILED,
            traceback.format_exc(limit=20),
            failure_kind=classify_exception(e),
        )


def _finalize(trial: Trial, store: ObservationStore, objective) -> TrialResult:
    """Post-run observation check: succeeded-but-no-objective-metric becomes
    MetricsUnavailable (reference ``newObservationLog`` +
    ``trial_controller.go:249-252``)."""
    obs = store.observation_for(trial.name, objective)
    if obs is None:
        return TrialResult(
            TrialCondition.METRICS_UNAVAILABLE,
            f"objective metric {objective.objective_metric_name!r} was never reported",
        )
    return TrialResult(TrialCondition.SUCCEEDED)


def _run_whitebox(
    trial: Trial,
    store: ObservationStore,
    evaluator: RuleEvaluator,
    objective,
    stop_event: threading.Event | None,
    injector=None,
    watchdog=None,
    drain_event: threading.Event | None = None,
    device=None,
) -> TrialResult:
    hang_event = threading.Event()
    compile_hang_event = threading.Event()
    heartbeat = None
    if watchdog is not None and trial.spec.progress_deadline_seconds:
        heartbeat = watchdog.register(
            trial.name,
            trial.spec.progress_deadline_seconds,
            on_hang=lambda _name: hang_event.set(),
        )
    # compile watchdog: the progress watchdog only measures step-to-step
    # cadence, so a jit compile (or first dispatch) that never completes
    # looks identical to a wedge.  Arm a one-shot budget that covers trace
    # -> compile -> first ctx.report(); the first beat disarms it.
    compile_hb = None
    if watchdog is not None and trial.spec.compile_deadline_seconds:

        def _on_compile_hang(_name: str) -> None:
            obs.compile_hangs.inc()
            compile_hang_event.set()
            hang_event.set()  # reuse the cooperative hang unwind path

        compile_hb = watchdog.register(
            f"compile:{trial.name}",
            trial.spec.compile_deadline_seconds,
            on_hang=_on_compile_hang,
        )

    def _beat() -> None:
        if compile_hb is not None:
            # first metric report = first dispatch completed: compile is done
            compile_hb.close()
        if heartbeat is not None:
            heartbeat.beat()

    ctx = TrialContext(
        trial.params(),
        checkpoint_dir=trial.checkpoint_dir,
        device=device,
        trial_name=trial.name,
        store=store,
        evaluator=evaluator,
        labels=trial.spec.labels,
        stop_event=stop_event,
        max_runtime_seconds=trial.spec.max_runtime_seconds,
        drain_event=drain_event,
        hang_event=hang_event,
        heartbeat=_beat,
    )

    def _deadline_result() -> TrialResult:
        # a deadline blown once will blow again on an identical re-run —
        # never worth a transient retry
        return TrialResult(
            TrialCondition.FAILED,
            f"trial exceeded max_runtime_seconds={trial.spec.max_runtime_seconds}",
            failure_kind=FailureKind.PERMANENT,
        )

    def _hang_result() -> TrialResult:
        if compile_hang_event.is_set():
            return TrialResult(
                TrialCondition.FAILED,
                "compile watchdog: jit compile / first dispatch exceeded "
                f"compileDeadlineSeconds={trial.spec.compile_deadline_seconds}",
                failure_kind=FailureKind.COMPILE_HANG,
            )
        return TrialResult(
            TrialCondition.FAILED,
            "hang watchdog: no progress for "
            f"progress_deadline_seconds={trial.spec.progress_deadline_seconds}",
            failure_kind=FailureKind.HANG,
        )

    try:
        if injector is not None:
            # chaos 'compile-hang' action: wedge *before* the first report,
            # inside the compile budget — only the compile watchdog (or
            # stop/drain) can unwedge it
            injector.maybe_compile_hang(
                trial, events=(compile_hang_event, hang_event, stop_event, drain_event)
            )
            # chaos 'hang' action: wedge here like a stuck step; only the
            # watchdog / stop / drain machinery can unwedge it — and whichever
            # did decides the settlement (HANG / KILLED / DRAINED)
            injector.maybe_hang(trial, events=(hang_event, stop_event, drain_event))
            ctx.raise_if_stopped()
        with tracing.span("train_fn", trial=trial.name):
            trial.spec.train_fn(ctx)
    except TrialEarlyStopped as e:
        if evaluator.triggered is not None:
            return TrialResult(TrialCondition.EARLY_STOPPED, str(e))
        if hang_event.is_set():
            return _hang_result()
        if ctx.deadline_exceeded():
            return _deadline_result()
        if ctx.drain_requested() and not (stop_event is not None and stop_event.is_set()):
            return TrialResult(
                TrialCondition.DRAINED, "checkpointed and exited for drain"
            )
        return TrialResult(TrialCondition.KILLED, str(e))
    except Exception as e:
        return TrialResult(
            TrialCondition.FAILED,
            traceback.format_exc(limit=20),
            failure_kind=classify_exception(e),
        )
    finally:
        if compile_hb is not None:
            compile_hb.close()
        if heartbeat is not None:
            heartbeat.close()
    if evaluator.should_stop():
        return TrialResult(TrialCondition.EARLY_STOPPED, evaluator.triggered.describe())
    if hang_event.is_set():
        return _hang_result()
    if ctx.deadline_exceeded():
        return _deadline_result()
    if stop_event is not None and stop_event.is_set():
        return TrialResult(TrialCondition.KILLED, "experiment reached terminal state")
    if ctx.drain_requested():
        # the train_fn unwound at a step boundary; its last checkpoint (if
        # any) is on disk and the resumed run re-submits this trial
        return TrialResult(TrialCondition.DRAINED, "checkpointed and exited for drain")
    return _finalize(trial, store, objective)
