"""Durable experiment resume — reconstruct an :class:`Experiment` from the
status journal so a killed orchestrator process can pick up where it left
off.

The reference survives controller restarts because all state lives in CRs on
the API server plus the suggestion PVC (``suggestion_controller.go:181-193``
``FromVolume``; ``experiment_controller.go:187-206`` re-open on raised
``maxTrialCount``).  Here the equivalents are:

- trial history + optimal + mutable ``algorithm_settings`` (Hyperband's
  state-in-CR round trip) — journaled to ``<workdir>/<exp>/status.json`` on
  every trial completion (``status.py``), read back by
  :func:`experiment_from_dict`;
- in-memory suggester state (ENAS controller pytree, PBT job queue) —
  pickled to ``<workdir>/<exp>/suggester_state.pkl`` by the orchestrator
  (the PVC analog), reloaded through the suggester's
  ``load_state_dict`` hook.

Trials that were still running when the process died are re-materialized
with their original name/assignments/checkpoint dir and resubmitted — the
analog of the job controller recreating pods for a trial CR that still
exists (reference trials keep running across controller restarts; ours
cannot, so they are re-run).  Their Orbax checkpoint dir survives, so a
``train_fn`` that restores from its last step resumes mid-trial.
"""

from __future__ import annotations

import math
import os
import pickle

from katib_tpu_torch.core.types import (
    Experiment,
    ExperimentCondition,
    ExperimentSpec,
    Metric,
    Observation,
    OptimalTrial,
    ParameterAssignment,
    Trial,
    TrialCondition,
    TrialSpec,
)

SUGGESTER_STATE_FILE = "suggester_state.pkl"


def _coerce_assignments(spec: ExperimentSpec, raw: dict) -> list[ParameterAssignment]:
    """Journal values are JSON scalars; cast back through the parameter spec
    where the name matches (NAS/PBT string parameters pass through as-is)."""
    out = []
    by_name = {p.name: p for p in spec.parameters}
    for name, value in raw.items():
        p = by_name.get(name)
        if p is not None:
            try:
                value = p.cast(value)
            except (TypeError, ValueError):
                pass
        out.append(ParameterAssignment(name=name, value=value))
    return out


def _observation_from_list(metrics: list[dict] | None) -> Observation | None:
    if metrics is None:
        return None
    nan = float("nan")

    def f(v):
        return nan if v is None else float(v)

    return Observation(
        metrics=[
            Metric(
                name=m["name"],
                value=f(m.get("value")),
                min=f(m.get("min", nan)),
                max=f(m.get("max", nan)),
                latest=f(m.get("latest", nan)),
            )
            for m in metrics
        ]
    )


def trial_from_dict(spec: ExperimentSpec, data: dict) -> Trial:
    """Rebuild one trial.  The journal does not persist callables or
    early-stopping rules; those come from the experiment spec (rules are
    re-derived if the trial is resubmitted)."""
    condition = TrialCondition(data["condition"])
    resubmit = not condition.is_terminal()
    return Trial(
        name=data["name"],
        experiment_name=spec.name,
        spec=TrialSpec(
            assignments=_coerce_assignments(spec, data.get("assignments", {})),
            labels=dict(data.get("labels", {})),
            train_fn=spec.train_fn,
            command=list(spec.command) if spec.command else None,
            metrics_collector=spec.metrics_collector,
            retain=spec.retain,
            max_runtime_seconds=spec.max_trial_runtime_seconds,
            metrics_retries=spec.metrics_retries,
            max_retries=spec.max_retries,
            retry_backoff_seconds=spec.retry_backoff_seconds,
            progress_deadline_seconds=spec.progress_deadline_seconds,
        ),
        # non-terminal journal entries become PENDING: run() resubmits them.
        # Drained trials (preemption) land here by design: same name +
        # checkpoint dir, so a checkpoint-aware train_fn continues from the
        # step it saved during the drain window instead of step 0.
        condition=TrialCondition.PENDING if resubmit else condition,
        observation=_observation_from_list(data.get("observation")),
        message=data.get("message", "") if not resubmit else "resubmitted after restart",
        start_time=data.get("start_time") or 0.0,
        completion_time=data.get("completion_time") or 0.0,
        checkpoint_dir=data.get("checkpoint_dir"),
        # restoring the spent retry budget is what makes the budget crash-proof:
        # a trial that burned 2 of 3 retries before the crash gets 1 more, not 3
        retry_count=int(data.get("retry_count") or 0),
        failure_kind=data.get("failure_kind"),
    )


def experiment_from_dict(spec: ExperimentSpec, status: dict) -> Experiment:
    """Rebuild the :class:`Experiment` a journal dict describes.

    The caller supplies the spec (callables cannot round-trip through JSON);
    ``status["name"]`` must match ``spec.name``.
    """
    if status.get("name") != spec.name:
        raise ValueError(
            f"journal is for experiment {status.get('name')!r}, spec is {spec.name!r}"
        )
    exp = Experiment(
        spec=spec,
        condition=ExperimentCondition(status.get("condition", "Created")),
        start_time=status.get("start_time") or 0.0,
        completion_time=status.get("completion_time") or 0.0,
        message=status.get("message", ""),
    )
    if status.get("algorithm_settings"):
        exp.algorithm_settings = dict(status["algorithm_settings"])
    # restore the convergence curve BEFORE recomputing the optimal, so the
    # recompute extends the journaled history instead of restarting it
    exp.optimal_history = [
        dict(row) for row in status.get("optimal_history") or ()
    ]
    for name, tdata in (status.get("trials") or {}).items():
        exp.trials[name] = trial_from_dict(spec, tdata)
    exp.update_optimal()
    if not status.get("optimal_history") and exp.optimal_history:
        # pre-curve journal: the row just appended was clocked at load time,
        # charging process downtime; re-anchor it to the optimal trial's own
        # completion time (the best information the old journal carries)
        best_trial = exp.trials.get(exp.optimal_history[-1]["trial_name"])
        if best_trial is not None and best_trial.completion_time:
            exp.optimal_history[-1]["elapsed_s"] = round(
                max(best_trial.completion_time - exp.start_time, 0.0), 3
            )
    # sanity: journal's recorded optimal should agree; recompute wins because
    # it is derived from the same trial set
    if exp.optimal is None and status.get("optimal"):
        o = status["optimal"]
        v = o.get("objective_value")
        if v is not None and not math.isnan(float(v)):
            exp.optimal = OptimalTrial(
                trial_name=o.get("trial_name", ""),
                objective_value=float(v),
                assignments=_coerce_assignments(spec, o.get("assignments", {})),
                observation=Observation(),
            )
    return exp


def load_experiment(spec: ExperimentSpec, workdir: str) -> Experiment | None:
    """Rebuild an Experiment from its durable state; None when none exists
    (fresh run).

    The crash-consistent event journal (``orchestrator/journal.py``) is the
    source of truth when present: replay applies snapshot + suffix with
    exactly-once settlement, so a hard kill mid-publish can neither lose a
    settled trial nor settle one twice.  ``status.json`` remains the
    fallback for pre-journal experiment dirs (and stays the view the
    CLI/UI read)."""
    from katib_tpu_torch.orchestrator import journal as jr
    from katib_tpu_torch.orchestrator.status import read_status
    from katib_tpu_torch.utils import observability as obs

    if os.path.exists(jr.journal_path(workdir, spec.name)) or jr.list_snapshots(
        os.path.join(workdir, spec.name)
    ):
        status, stats = jr.replay_journal(workdir, spec.name)
        if status is not None:
            obs.journal_replayed_events.inc(stats.applied)
            if stats.duplicates:
                obs.settlement_duplicates.inc(stats.duplicates)
            return experiment_from_dict(spec, status)
    status = read_status(workdir, spec.name)
    if status is None:
        return None
    return experiment_from_dict(spec, status)


# -- suggester state (the FromVolume PVC analog) ----------------------------


def suggester_state_path(workdir: str, experiment_name: str) -> str:
    return os.path.join(workdir, experiment_name, SUGGESTER_STATE_FILE)


#: wrapper marker for fenced pickles; bare (legacy) pickles still load
_FENCE_MARKER = "__katib_suggester_state__"


def save_suggester_state(
    suggester, workdir: str, experiment_name: str, fence: int | None = None
) -> bool:
    """Durably pickle ``suggester.state_dict()``; no-op (False) for
    replay-derived suggesters that expose no state hook.

    ``fence`` is the experiment journal's sequence number at persist time.
    It rides inside the pickle so a resume can tell whether the state is
    CURRENT (fence ≥ the journal's last settled seq) or STALE — written
    before settlements the journal proves happened, e.g. a hard kill
    between a trial settling and the next suggester persist.  Stale state
    is discarded and the suggester rebuilds from replayed trial history
    instead of being trusted blindly."""
    from katib_tpu_torch.utils.fsio import atomic_replace

    state_fn = getattr(suggester, "state_dict", None)
    if state_fn is None:
        return False
    exp_dir = os.path.join(workdir, experiment_name)
    os.makedirs(exp_dir, exist_ok=True)
    path = suggester_state_path(workdir, experiment_name)
    payload = pickle.dumps({_FENCE_MARKER: 1, "fence": fence, "state": state_fn()})
    atomic_replace(path, payload, prefix=".sugg-", crash_site="suggester.pickle")
    return True


def read_suggester_fence(workdir: str, experiment_name: str) -> int | None:
    """The fence recorded in the pickled suggester state; None when the
    file is absent/legacy/unreadable.  Used by ``katib-tpu fsck`` to report
    fence mismatches without mutating anything."""
    path = suggester_state_path(workdir, experiment_name)
    try:
        with open(path, "rb") as f:
            state = pickle.load(f)
    except Exception:
        return None
    if isinstance(state, dict) and state.get(_FENCE_MARKER):
        fence = state.get("fence")
        return int(fence) if fence is not None else None
    return None


def load_suggester_state(
    suggester,
    workdir: str,
    experiment_name: str,
    settled_fence: int | None = None,
) -> bool:
    """Restore a previously pickled state into the suggester; False when the
    file or the hook is absent — or when the state is FENCED OUT:
    ``settled_fence`` (the journal's last settled seq) newer than the
    pickle's recorded fence means the state predates settlements the
    journal proves, so it is discarded and the caller's replay-derived
    fresh suggester stands (counted in
    ``katib_suggester_fence_rebuilds_total``)."""
    load_fn = getattr(suggester, "load_state_dict", None)
    if load_fn is None:
        return False
    path = suggester_state_path(workdir, experiment_name)
    try:
        with open(path, "rb") as f:
            state = pickle.load(f)
        fenced = isinstance(state, dict) and state.get(_FENCE_MARKER)
        fence = state.get("fence") if fenced else None
        # a journal that proves settlements fences out any pickle that
        # cannot prove it saw them — including legacy bare pickles, which
        # record no fence at all.  Journal-less dirs (settled_fence 0) keep
        # loading legacy pickles unconditionally.
        if (
            settled_fence is not None
            and settled_fence > 0
            and (fence is None or int(fence) < settled_fence)
        ):
            import logging

            from katib_tpu_torch.utils import observability as obs

            obs.suggester_fence_rebuilds.inc()
            logging.getLogger(__name__).warning(
                "suggester state at %s is stale (fence=%s < journal settled "
                "seq %d); rebuilding from replayed trial history",
                path,
                fence,
                settled_fence,
            )
            return False
        if fenced:
            state = state["state"]
        load_fn(state)
    except Exception:
        # a truncated/corrupt pickle (crash between replace and flush) or a
        # state-schema mismatch must not make the experiment un-resumable:
        # fall back to the replay-derived fresh suggester
        import logging

        logging.getLogger(__name__).warning(
            "suggester state at %s unusable; resuming from trial history only",
            path,
            exc_info=True,
        )
        return False
    return True
