"""Experiment status persistence for CLI/UI views.

The reference exposes experiment/trial status through CR status fields that
the UI backend reads (``pkg/ui/v1beta1/backend.go:86-617``).  Here the
orchestrator journals the same information to
``<workdir>/<experiment>/status.json`` on every trial completion, so
``katib-tpu list/describe`` (and any external dashboard) can watch progress
without holding a reference to the running process.
"""

from __future__ import annotations

import json
import os

from katib_tpu_torch.core.types import Experiment, Observation, Trial

STATUS_FILE = "status.json"


def _observation_to_dict(obs: Observation | None) -> list[dict] | None:
    if obs is None:
        return None
    return [
        {"name": m.name, "value": m.value, "min": m.min, "max": m.max, "latest": m.latest}
        for m in obs.metrics
    ]


def trial_to_dict(trial: Trial) -> dict:
    return {
        "name": trial.name,
        "condition": trial.condition.value,
        "assignments": {a.name: a.value for a in trial.spec.assignments},
        "labels": dict(trial.spec.labels),
        "observation": _observation_to_dict(trial.observation),
        "message": trial.message,
        "start_time": trial.start_time,
        "completion_time": trial.completion_time,
        "checkpoint_dir": trial.checkpoint_dir,
        # fault-tolerance state: journaled so a resumed process continues
        # the retry budget instead of resetting it (utils/faults.py taxonomy)
        "retry_count": trial.retry_count,
        "failure_kind": trial.failure_kind,
    }


def experiment_to_dict(exp: Experiment) -> dict:
    return {
        "name": exp.name,
        "condition": exp.condition.value,
        "message": exp.message,
        "algorithm": exp.spec.algorithm.name,
        "objective_metric": exp.spec.objective.objective_metric_name,
        "objective_type": exp.spec.objective.type.value,
        "goal": exp.spec.objective.goal,
        "start_time": exp.start_time,
        "completion_time": exp.completion_time,
        "counts": {
            "trials": len(exp.trials),
            "succeeded": exp.succeeded_count,
            "failed": exp.failed_count,
            "early_stopped": exp.early_stopped_count,
            "metrics_unavailable": exp.metrics_unavailable_count,
            "running": exp.running_count,
            # preemption drain: non-terminal, resubmitted on resume
            "drained": sum(
                1 for t in exp.trials.values() if t.condition.value == "Drained"
            ),
            # total transient retries spent across all trials (surfaced in
            # the UI counter strip and `katib-tpu describe`)
            "retried": sum(t.retry_count for t in exp.trials.values()),
        },
        # mutable algorithm settings (Hyperband bracket state lives here) —
        # persisting them is what makes the journal a full resume source
        # (reference: state-in-CR, ``suggestionclient.go:194-196``)
        "algorithm_settings": dict(exp.algorithm_settings),
        "optimal": (
            None
            if exp.optimal is None
            else {
                "trial_name": exp.optimal.trial_name,
                "objective_value": exp.optimal.objective_value,
                "assignments": {a.name: a.value for a in exp.optimal.assignments},
            }
        ),
        # best-objective@wallclock rows (the BASELINE driver metric)
        "optimal_history": list(exp.optimal_history),
        # last device-preflight verdict of this process (utils/meshhealth):
        # None until a preflight/doctor probe has run
        "device_health": _device_health(),
        "trials": {name: trial_to_dict(t) for name, t in exp.trials.items()},
    }


def _device_health() -> dict | None:
    from katib_tpu_torch.utils.meshhealth import last_report_dict

    return last_report_dict()


def write_status(exp: Experiment, workdir: str) -> str:
    """Atomically AND durably write the experiment's status file; returns
    its path.  The temp file is fsync'd before the rename and the directory
    after it (utils/fsio.py) — rename-only atomicity still loses the data
    blocks on some filesystems when a hard kill lands right after the
    replace, which is exactly the window ``chaos --crash-at status.write``
    exercises."""
    from katib_tpu_torch.utils.fsio import atomic_replace

    exp_dir = os.path.join(workdir, exp.name)
    os.makedirs(exp_dir, exist_ok=True)
    path = os.path.join(exp_dir, STATUS_FILE)
    payload = json.dumps(experiment_to_dict(exp), indent=1, default=str)
    atomic_replace(
        path, payload.encode(), prefix=".status-", crash_site="status.write"
    )
    return path


def read_status(workdir: str, experiment_name: str) -> dict | None:
    # the name may arrive from a URL (UI backend routes); refuse anything
    # that could escape the workdir ("..", separators, NUL, absolute paths)
    from katib_tpu_torch.utils.names import is_safe_path_component

    if not is_safe_path_component(experiment_name):
        return None
    path = os.path.join(workdir, experiment_name, STATUS_FILE)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def find_trial_log(workdir: str, trial_name: str) -> str | None:
    """Locate a black-box trial's captured stdout (``trial.log``), shared by
    the CLI and UI so the lookup cannot drift.

    Resolution order per experiment journal: the trial's recorded
    ``checkpoint_dir`` (suggester-owned dirs — PBT lineage — live outside
    the ``<workdir>/<exp>/<trial>`` convention), then the conventional
    path.  Returns the log's path or None."""
    from katib_tpu_torch.utils.names import is_safe_path_component

    if not is_safe_path_component(trial_name):
        return None
    try:
        exp_dirs = sorted(os.listdir(workdir))
    except OSError:
        return None
    for exp in exp_dirs:
        status = read_status(workdir, exp)
        candidates = []
        if status is not None:
            tdata = (status.get("trials") or {}).get(trial_name)
            if tdata and tdata.get("checkpoint_dir"):
                candidates.append(os.path.join(tdata["checkpoint_dir"], "trial.log"))
        candidates.append(os.path.join(workdir, exp, trial_name, "trial.log"))
        for path in candidates:
            if os.path.isfile(path):
                return path
    return None


def read_trial_log(workdir: str, trial_name: str) -> str | None:
    """Contents of a trial's captured stdout, or None when absent."""
    path = find_trial_log(workdir, trial_name)
    if path is None:
        return None
    try:
        with open(path, errors="replace") as f:
            return f.read()
    except OSError:
        return None


def list_statuses(workdir: str) -> list[dict]:
    out = []
    try:
        entries = sorted(os.listdir(workdir))
    except OSError:
        return []
    for name in entries:
        status = read_status(workdir, name)
        if status is not None:
            out.append(status)
    return out
