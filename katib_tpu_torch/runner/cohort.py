"""Vectorized trial cohorts: K compatible trials, one program (port of
``katib_tpu/runner/cohort.py``).

Small-model hyperparameter sweeps are dominated by per-trial overhead: the
same training step is built, captured and dispatched once per trial.  A
*cohort* lifts the K members' hyperparameters into ``[K]`` operands (a
stacked ``[K, ...]`` train state whose optimizer state carries per-member
learning rates) and trains all members in ONE batched step
(``parallel/train.py:make_cohort_train_step``), captured once as a CUDA
graph on the card.

The cohort is an *execution* batch, not a semantic one: each member keeps
its own trial identity.  Metric rows are unstacked per member into the
normal ``ObservationStore`` path, early-stopping rules evaluate per
member, and a member whose objective goes non-finite fails alone
(``Permanent``, "diverged") while its row is frozen in-step so it cannot
poison the rest (the ``torch.where`` guard in ``make_cohort_train_step``).

A train function opts in by attaching a cohort-capable twin::

    def my_trial(ctx): ...            # normal TrialContext path
    def my_cohort(cctx): ...          # CohortContext path, trains all K
    attach_cohort_fn(my_trial, my_cohort)

``run_cohort`` falls back to per-member serial ``run_trial`` whenever the
cohort path is unavailable (K == 1, no cohort fn) or raises mid-flight:
cohort mode is never worse than serial, just slower on the fallback
(``obs.cohort_fallbacks`` counts those).

The cohort's first step is classified warm or cold against the shape
registry on the padded-K cohort signature (``compile/registry.py``), as a
singleton's is.  Left out of the JAX runner: cost publication and the
artifact fetch of a step program (the port's step has no serialized form),
and the elastic degradation of a trial-sharded mesh (ROADMAP Queue 1 item
9b; a cohort runs on one device: a vectorized cohort over a mesh raises, and
``run_cohort`` given a mesh runs its members one by one on it).
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_map

from katib_tpu_torch.compile.buckets import bucket_size
from katib_tpu_torch.core.types import COHORT_KEY_LABEL, MetricLog, Trial, TrialCondition
from katib_tpu_torch.device import resolve_device
from katib_tpu_torch.earlystop.rules import RuleEvaluator
from katib_tpu_torch.runner.trial_runner import TrialResult, _finalize, run_trial
from katib_tpu_torch.store.base import ObservationStore
from katib_tpu_torch.utils import observability as obs
from katib_tpu_torch.utils import tracing
from katib_tpu_torch.utils.faults import FailureKind, classify_exception

#: the attribute by which a train_fn declares its cohort twin
COHORT_ATTR = "__cohort_fn__"


def attach_cohort_fn(train_fn: Callable, cohort_fn: Callable) -> Callable:
    """Declare ``cohort_fn(cctx)`` as the vectorized twin of ``train_fn(ctx)``.
    Returns ``train_fn`` so it can be used as a decorator-style one-liner."""
    setattr(train_fn, COHORT_ATTR, cohort_fn)
    return train_fn


def cohort_fn_of(train_fn: Callable | None) -> Callable | None:
    """The cohort-capable twin of ``train_fn``, or None when it never
    opted in (black-box commands and plain train_fns stay serial)."""
    if train_fn is None:
        return None
    return getattr(train_fn, COHORT_ATTR, None)


def _host_rows(value) -> np.ndarray:
    """A metric value as a flat float64 numpy array: a device tensor moves
    to the host in one copy."""
    if isinstance(value, torch.Tensor):
        value = value.detach().to("cpu", torch.float64).numpy()
    return np.asarray(value, dtype=float).reshape(-1)


class CohortContext:
    """What a cohort_fn sees: the members' hyperparameters (stackable into
    ``[K]`` operand tensors on the cohort's device), a batched ``report``
    that unstacks metric rows per member, and per-member failure/early-stop
    bookkeeping.  ``device`` is the trial's (``None`` = ``cuda``), as in
    ``TrialContext``; a ``mesh`` raises, the port runs a cohort on one
    device."""

    def __init__(
        self,
        members: Sequence[Trial],
        store: ObservationStore,
        objective,
        mesh: Any = None,
        stop_event: threading.Event | None = None,
        drain_event: threading.Event | None = None,
        hang_event: threading.Event | None = None,
        heartbeat: Any = None,
        buckets: bool = False,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "a cohort over a trial-axis mesh (katib_tpu/parallel/mesh.py), not ported yet "
                "(ROADMAP item 9b)"
            )
        self.members = list(members)
        self.params_list = [t.params() for t in self.members]
        self.checkpoint_dirs = [t.checkpoint_dir for t in self.members]
        self.device = device
        # shape bucketing (ExperimentSpec.cohort_buckets): quantize the
        # padded member dimension to the next power of two so cohorts of
        # heterogeneous K share one program shape
        self.buckets = buckets
        self._store = store
        self._objective = objective
        self._stop_event = stop_event
        # drain (orchestrator preemption) + hang-watchdog plumbing, same
        # semantics as TrialContext: the whole cohort checkpoints-and-exits
        # at its next step boundary / is classified hung as one program
        self._drain_event = drain_event
        self._hang_event = hang_event
        self._heartbeat = heartbeat
        self._evaluators = [
            RuleEvaluator(t.spec.early_stopping_rules, objective) for t in self.members
        ]
        k = len(self.members)
        self._failed: list[tuple[str, FailureKind] | None] = [None] * k
        self._early_stopped: list[bool] = [False] * k
        self._step = 0
        # cooperative wall-clock bound like TrialContext: the tightest
        # member deadline bounds the whole cohort (members share one program)
        runtimes = [
            t.spec.max_runtime_seconds
            for t in self.members
            if t.spec.max_runtime_seconds is not None
        ]
        self._deadline = time.monotonic() + min(runtimes) if runtimes else None

    # -- member hyperparameters -------------------------------------------

    def __len__(self) -> int:
        return len(self.members)

    @property
    def padded_size(self) -> int:
        """The leading dimension the stacked state carries: K, or with
        ``buckets`` on, K rounded up to the next power of two so
        different-K cohorts share one program shape.  Rows ``[K:]`` are
        ghost members: they train (on member 0's hyperparameters, so they
        stay finite) but ``report`` drops their metric rows before the
        ObservationStore."""
        if self.buckets:
            return bucket_size(len(self.members))
        return len(self.members)

    def stacked(self, name: str, default: Any = None, dtype=None) -> torch.Tensor:
        """Per-member values of parameter ``name`` as a ``[padded_size]``
        tensor on the cohort's device — the operand that rides inside the
        batched program.  Ghost rows repeat member 0's value (inert but
        finite)."""
        vals = [p.get(name, default) for p in self.params_list]
        vals += [vals[0]] * (self.padded_size - len(vals))
        return torch.tensor(vals, dtype=dtype, device=resolve_device(self.device))

    def place_members(self, tree):
        """Put a stacked ``[padded_size, ...]`` pytree on the cohort's device."""
        dev = resolve_device(self.device)
        return tree_map(lambda t: t.to(dev), tree)

    def place_shared(self, tree):
        """Put member-shared arrays (batches, eval sets; numpy or torch) on
        the cohort's device."""
        dev = resolve_device(self.device)
        return tree_map(lambda t: torch.as_tensor(t).to(dev), tree)

    def shared(self, name: str, default: Any = None) -> Any:
        """A parameter every member must agree on (model shape, batch size —
        anything that changes the program).  Raises when members disagree:
        such trials belong in different cohorts."""
        vals = [p.get(name, default) for p in self.params_list]
        if any(v != vals[0] for v in vals[1:]):
            raise ValueError(
                f"cohort members disagree on structural parameter {name!r}: {vals} "
                "(group them under different cohort keys)"
            )
        return vals[0]

    # -- reporting ---------------------------------------------------------

    def report(self, step: int | None = None, **metrics) -> bool:
        """Report one ``[K]`` row per metric; returns True while any member
        is still alive and the cohort should keep training.

        Row ``i`` of each value belongs to member ``i``; a device tensor
        moves to the host once per metric.  A member whose objective metric
        comes back non-finite is failed ``Permanent`` ("diverged" — the
        identical re-run would diverge again); non-finite values are never
        written to the store so reductions stay clean.
        """
        if self._heartbeat is not None:
            self._heartbeat()  # cohort step boundary = watchdog progress
        if step is None:
            step = self._step
            self._step += 1
        else:
            self._step = step + 1
        k = len(self.members)
        rows: dict[str, np.ndarray] = {}
        for name, value in metrics.items():
            arr = _host_rows(value)
            if arr.size == 1:
                arr = np.full(k, arr[0])
            if arr.size == self.padded_size and self.padded_size != k:
                # ghost-member rows (bucket padding) are dropped before
                # they can reach the store
                arr = arr[:k]
            if arr.size != k:
                raise ValueError(
                    f"metric {name!r} has {arr.size} rows for a {k}-member cohort"
                )
            rows[name] = arr
        obj_name = self._objective.objective_metric_name
        now = time.time()
        for i, trial in enumerate(self.members):
            if not self.alive(i):
                continue
            if obj_name in rows and not np.isfinite(rows[obj_name][i]):
                self.fail_member(
                    i,
                    f"objective metric {obj_name!r} went non-finite at step "
                    f"{step} (diverged)",
                )
                continue
            logs = [
                MetricLog(metric_name=n, value=float(v[i]), timestamp=now, step=step)
                for n, v in rows.items()
                if np.isfinite(v[i])
            ]
            if logs:
                self._store.report(trial.name, logs)
            ev = self._evaluators[i]
            for log in logs:
                ev.observe(log.metric_name, log.value)
            if ev.should_stop():
                self._early_stopped[i] = True
        return not self.should_stop()

    # -- member lifecycle --------------------------------------------------

    def alive(self, i: int) -> bool:
        """True while member ``i`` still wants training steps."""
        return self._failed[i] is None and not self._early_stopped[i]

    def fail_member(self, i: int, message: str, transient: bool = False) -> None:
        """Fail member ``i`` alone; the rest of the cohort keeps training.
        ``transient=True`` marks it retryable (the orchestrator re-runs it
        as a singleton trial)."""
        if self._failed[i] is None:
            kind = FailureKind.TRANSIENT if transient else FailureKind.PERMANENT
            self._failed[i] = (message, kind)

    def should_stop(self) -> bool:
        """True when the whole cohort should wind down: every member is
        done (failed/early-stopped), the experiment hit a terminal state,
        or the wall-clock bound passed."""
        if not any(self.alive(i) for i in range(len(self.members))):
            return True
        if self.deadline_exceeded():
            return True
        if self.hang_flagged() or self.drain_requested():
            return True
        return self._stop_event is not None and self._stop_event.is_set()

    def deadline_exceeded(self) -> bool:
        return self._deadline is not None and time.monotonic() > self._deadline

    def drain_requested(self) -> bool:
        """True once the orchestrator wants the cohort to checkpoint and
        return at its next step boundary (preemption drain)."""
        return self._drain_event is not None and self._drain_event.is_set()

    def hang_flagged(self) -> bool:
        return self._hang_event is not None and self._hang_event.is_set()

    # -- settlement (run_cohort internals) ---------------------------------

    def _settle(self, i: int) -> TrialResult:
        """Terminal condition for member ``i`` after the cohort fn returned,
        mirroring the serial ``_run_whitebox`` postamble ordering."""
        if self._failed[i] is not None:
            message, kind = self._failed[i]
            return TrialResult(TrialCondition.FAILED, message, failure_kind=kind)
        if self._early_stopped[i]:
            triggered = self._evaluators[i].triggered
            return TrialResult(
                TrialCondition.EARLY_STOPPED,
                triggered.describe() if triggered is not None else "early stopped",
            )
        if self.hang_flagged():
            # retryable: the member rejoins as a singleton from its last
            # checkpoint through the orchestrator's retry machinery
            return TrialResult(
                TrialCondition.FAILED,
                "hang watchdog: cohort made no step progress past "
                "progress_deadline_seconds",
                failure_kind=FailureKind.HANG,
            )
        if self.deadline_exceeded():
            return TrialResult(
                TrialCondition.FAILED,
                "cohort exceeded max_runtime_seconds",
                failure_kind=FailureKind.PERMANENT,
            )
        if self._stop_event is not None and self._stop_event.is_set():
            return TrialResult(TrialCondition.KILLED, "experiment reached terminal state")
        if self.drain_requested():
            return TrialResult(TrialCondition.DRAINED, "checkpointed and exited for drain")
        return _finalize(self.members[i], self._store, self._objective)


def run_cohort(
    trials: Sequence[Trial],
    store: ObservationStore,
    objective,
    mesh=None,
    stop_event: threading.Event | None = None,
    injector=None,
    watchdog=None,
    drain_event: threading.Event | None = None,
    buckets: bool = False,
    device=None,
) -> dict[str, TrialResult]:
    """Execute K trials as one vectorized cohort on ``device`` (``None`` =
    ``cuda``); returns a per-trial-name result map.  Never raises: a
    cohort-path failure falls back to serial per-member execution, and
    member failures are isolated results.  A ``mesh`` runs the members
    serially, each through ``run_trial`` on it (a vectorized cohort over a
    mesh is ROADMAP item 9b)."""
    results: dict[str, TrialResult] = {}
    if not trials:
        return results
    cohort_fn = cohort_fn_of(trials[0].spec.train_fn)
    if len(trials) == 1 or cohort_fn is None or mesh is not None:
        for t in trials:
            results[t.name] = run_trial(
                t, store, objective, mesh, stop_event, injector,
                watchdog=watchdog, drain_event=drain_event, device=device,
            )
        return results

    # chaos seam parity with run_trial: injected faults fire per member and
    # fail only that member; survivors still train as a (smaller) cohort
    survivors: list[Trial] = []
    for t in trials:
        if injector is not None:
            try:
                injector.on_trial_attempt(t)
                injector.apply_metrics_delay(t, stop_event)
            except Exception as e:
                results[t.name] = TrialResult(
                    TrialCondition.FAILED,
                    traceback.format_exc(limit=20),
                    failure_kind=classify_exception(e),
                )
                continue
        survivors.append(t)
    if not survivors:
        return results
    if len(survivors) == 1:
        t = survivors[0]
        results[t.name] = run_trial(
            t, store, objective, None, stop_event,
            watchdog=watchdog, drain_event=drain_event, device=device,
        )
        return results

    k = len(survivors)
    key = survivors[0].spec.labels.get(COHORT_KEY_LABEL, "")
    # one heartbeat for the whole cohort (members share one program, so
    # they stall together): tightest member deadline wins
    hang_event = threading.Event()
    heartbeat = None
    deadlines = [
        t.spec.progress_deadline_seconds
        for t in survivors
        if t.spec.progress_deadline_seconds
    ]
    if watchdog is not None and deadlines:
        heartbeat = watchdog.register(
            f"cohort:{key or survivors[0].name}",
            min(deadlines),
            on_hang=lambda _name: hang_event.set(),
        )
    # compile watchdog: one budget for the cohort's shared build, capture
    # and first dispatch, disarmed by the first step-boundary beat
    compile_hang_event = threading.Event()
    compile_deadlines = [
        t.spec.compile_deadline_seconds
        for t in survivors
        if t.spec.compile_deadline_seconds
    ]
    compile_hb_holder: list = [None]

    def _on_compile_hang(_name: str) -> None:
        obs.compile_hangs.inc()
        compile_hang_event.set()
        hang_event.set()  # cooperative unwind through the hang path

    # warm/cold first-step classification on the padded-K cohort signature:
    # the cohort's first step-boundary report closes the window
    from katib_tpu_torch.compile import registry as compile_registry

    sig_holder: list = [None]
    first_step_at: list[float] = [0.0]
    first_step: dict = {}

    def _beat() -> None:
        sig = sig_holder[0]
        if sig is not None:
            sig_holder[0] = None
            try:
                dt = time.perf_counter() - first_step_at[0]
                label = compile_registry.REGISTRY.note_first_step(sig, dt)
                obs.trial_first_step_seconds.set(
                    dt, phase="first_report", cache=label, workload=sig.program
                )
                first_step.update(first_step_cache=label, first_step_s=round(dt, 4))
            except Exception:
                pass  # classification is telemetry, never a cohort failure
        hb = compile_hb_holder[0]
        if hb is not None:
            # first step-boundary report = first dispatch done
            hb.close()
            compile_hb_holder[0] = None
        if heartbeat is not None:
            heartbeat.beat()

    started = time.perf_counter()
    try:
        if watchdog is not None and compile_deadlines:
            compile_hb_holder[0] = watchdog.register(
                f"compile:cohort:{key or survivors[0].name}",
                min(compile_deadlines),
                on_hang=_on_compile_hang,
            )
        try:
            ctx = CohortContext(
                survivors, store, objective, stop_event=stop_event,
                drain_event=drain_event, hang_event=hang_event, heartbeat=_beat,
                buckets=buckets, device=device,
            )
            sig_holder[0] = compile_registry.cohort_signature(
                cohort_fn, survivors, ctx.padded_size
            )
            first_step_at[0] = time.perf_counter()
            with tracing.span(
                "cohort",
                size=k,
                key=key,
                devices=1,
                members_per_device=ctx.padded_size,
                tier=0,
            ) as cohort_sp:
                try:
                    cohort_fn(ctx)
                finally:
                    cohort_sp.set(**first_step)
        except Exception:
            # the vectorized path is an optimization, never a correctness
            # dependency: re-run every member serially (duplicate metric
            # rows from the partial cohort are tolerated by the store's
            # reduction)
            obs.cohort_fallbacks.inc()
            for t in survivors:
                results[t.name] = run_trial(
                    t, store, objective, None, stop_event,
                    watchdog=watchdog, drain_event=drain_event, device=device,
                )
            return results
        finally:
            hb = compile_hb_holder[0]
            if hb is not None:
                hb.close()
                compile_hb_holder[0] = None
    finally:
        if heartbeat is not None:
            heartbeat.close()
    elapsed = max(time.perf_counter() - started, 1e-9)

    obs.cohorts_executed.inc()
    obs.cohort_size.observe(float(k))
    obs.cohort_trials_per_sec.set(k / elapsed)
    obs.cohort_devices.set(1.0)
    per_member = elapsed / k
    for i, t in enumerate(survivors):
        member_result = ctx._settle(i)
        if compile_hang_event.is_set() and member_result.failure_kind is FailureKind.HANG:
            # the hang the watchdog flagged was the compile budget, not
            # step-progress: reclassify so retry telemetry stays honest
            member_result = TrialResult(
                TrialCondition.FAILED,
                "compile watchdog: cohort build, capture or first dispatch "
                "exceeded compileDeadlineSeconds",
                failure_kind=FailureKind.COMPILE_HANG,
            )
        results[t.name] = member_result
        # per-member span so trial-level trace analysis sees cohort members
        # as ordinary trials
        tracing.record_span(
            "trial",
            per_member,
            trial=t.name,
            condition=results[t.name].condition.value,
            cohort=key,
            cohort_size=k,
        )
    return results
