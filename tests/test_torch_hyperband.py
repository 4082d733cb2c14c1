"""The HP-tuning path through the port's orchestrator: the Hyperband, ASHA
and TPE experiments against the JAX orchestrator's synchronous loop on a
closed-form ``train_fn``, the async engine against the synchronous loop,
the 32-trial sweep and ASHA invariants of ``tests/test_hyperband_e2e.py``,
the port's own spec (``katib_tpu_torch/specs/hyperband-mnist.yaml``) run
end to end with ``mnist_trial`` on the CPU under the async default, and the
settings the port refuses."""

from __future__ import annotations

import copy
import math
import os

import pytest
import torch
import yaml

from katib_tpu_torch.models.mnist import mnist_trial
from katib_tpu_torch.orchestrator import Orchestrator
from katib_tpu_torch.orchestrator.fsck import fsck_experiment
from katib_tpu_torch.sdk.yaml_spec import experiment_spec_from_dict
from tests.test_torch_orchestrator import PKGS, seeded_hex

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = os.path.join(REPO, "katib_tpu_torch", "specs", "hyperband-mnist.yaml")
# r_l 16, eta 4: (bracket s, rung i) -> (trials, epochs)
SWEEP_RUNGS = {("2", "0"): (16, 1), ("2", "1"): (4, 4), ("2", "2"): (1, 16),
               ("1", "0"): (6, 4), ("1", "1"): (2, 16), ("0", "0"): (3, 16)}


def epochs_trainer(ctx):
    """Reports ``epochs`` epochs of a closed-form accuracy: best near lr 0.05,
    rising with each epoch (``test_hyperband_e2e.py``'s shape)."""
    lr = float(ctx.params["lr"])
    base = 1.0 - (math.log10(lr) + 1.3) ** 2 / 4
    for epoch in range(int(ctx.params["epochs"])):
        if not ctx.report(step=epoch, accuracy=base * (1.0 - math.exp(-(epoch + 1) / 4.0))):
            return


def _spec(pkg: str, algorithm: str, settings: dict, parallel: int, max_trials: int | None):
    t = PKGS[pkg].types
    return t.ExperimentSpec(
        name=f"{algorithm}-sync",
        objective=t.ObjectiveSpec(type=t.ObjectiveType.MAXIMIZE,
                                  objective_metric_name="accuracy"),
        algorithm=t.AlgorithmSpec(name=algorithm, settings=dict(settings)),
        parameters=[
            t.ParameterSpec("lr", t.ParameterType.DOUBLE, t.FeasibleSpace(min=0.001, max=0.5)),
            t.ParameterSpec("epochs", t.ParameterType.INT, t.FeasibleSpace(min=1, max=4)),
        ],
        max_trial_count=max_trials,
        parallel_trial_count=parallel,
        async_orch=False,
        train_fn=epochs_trainer,
    )


def _run(pkg: str, workdir: str, *args):
    spec = _spec(pkg, *args)
    exp = PKGS[pkg].make(workdir=workdir, token_hex=seeded_hex()).run(spec)
    trials = {
        name: (t.params(), dict(t.labels), t.condition.value,
               [(m.name, m.value, m.latest) for m in t.observation.metrics])
        for name, t in exp.trials.items()
    }
    return (exp.condition.value, trials,
            (exp.optimal.trial_name, exp.optimal.objective_value)), exp


SYNC_CASES = {
    # hyperband needs parallel >= eta^s_max: r_l 4, eta 2 runs 4 at a time
    # (s=2 4@1, 2@2, 1@4; s=1 3@2, 2@4; s=0 3@4), whole budget
    "hyperband": ("hyperband", {"r_l": "4", "eta": "2", "resource_name": "epochs"}, 4, None),
    "asha": ("asha", {"r_max": "4", "eta": "2", "resource_name": "epochs",
                      "random_state": "2"}, 1, 10),
    "tpe": ("tpe", {"n_startup_trials": "3", "random_state": "4"}, 1, 8),
    "multivariate-tpe": ("multivariate-tpe", {"n_startup_trials": "3", "random_state": "6"}, 1,
                         8),
}


@pytest.mark.parametrize("case", sorted(SYNC_CASES))
def test_sync_loop_matches_the_jax_orchestrator(case, tmp_path):
    runs = {pkg: _run(pkg, str(tmp_path / pkg), *SYNC_CASES[case]) for pkg in PKGS}
    (port, port_exp), (jax_run, _) = runs["torch"], runs["jax"]
    assert port == jax_run
    assert port[0] in ("Succeeded", "MaxTrialsReached")
    assert all(cond == "Succeeded" for _, _, cond, _ in port[1].values())
    if case == "hyperband":
        rungs = {}
        for _, labels, _, _ in port[1].values():
            key = (labels["hyperband-s"], labels["hyperband-i"])
            rungs[key] = rungs.get(key, 0) + 1
        assert rungs == {("2", "0"): 4, ("2", "1"): 2, ("2", "2"): 1, ("1", "0"): 3,
                         ("1", "1"): 2, ("0", "0"): 3}
    report = fsck_experiment(os.path.join(str(tmp_path / "torch"), port_exp.name), repair=False)
    assert report.ok(), report.lines()


def _sweep_spec(**changes):
    with open(SPEC) as f:
        doc = yaml.safe_load(f)
    doc = copy.deepcopy(doc)
    for key, value in changes.items():
        if key == "parameters":
            for p in doc["spec"]["parameters"]:
                if p["name"] in value:
                    p["feasibleSpace"] = {"min": value[p["name"]], "max": value[p["name"]]}
        else:
            doc["spec"][key] = value
    return experiment_spec_from_dict(doc)


def _rungs(exp) -> dict:
    rungs: dict = {}
    for t in exp.trials.values():
        key = (t.labels["hyperband-s"], t.labels["hyperband-i"])
        rungs.setdefault(key, []).append(int(t.params()["epochs"]))
    return {k: (len(v), sorted(set(v))) for k, v in rungs.items()}


def _sweep_invariants(exp) -> None:
    """``tests/test_hyperband_e2e.py``'s: 32 trials succeeded, the rung
    table, each promotion from the previous rung of its bracket at the same
    lr with eta times the epochs."""
    assert exp.condition.value == "MaxTrialsReached", exp.message
    assert exp.succeeded_count == len(exp.trials) == 32
    assert _rungs(exp) == {k: (n, [r]) for k, (n, r) in SWEEP_RUNGS.items()}
    promoted = [t for t in exp.trials.values() if "hyperband-parent" in t.labels]
    assert len(promoted) == 4 + 1 + 2
    for t in promoted:
        parent = exp.trials[t.labels["hyperband-parent"]]
        assert parent.labels["hyperband-s"] == t.labels["hyperband-s"]
        assert int(parent.labels["hyperband-i"]) == int(t.labels["hyperband-i"]) - 1
        assert t.params()["lr"] == parent.params()["lr"]
        assert int(t.params()["epochs"]) == 4 * int(parent.params()["epochs"])


def test_the_sweep_spec_keeps_the_invariants_of_the_jax_e2e_test(tmp_path):
    spec = _sweep_spec()
    assert spec.parallel_trial_count == 16 and spec.max_trial_count == 32
    spec.train_fn = epochs_trainer
    exp = Orchestrator(workdir=str(tmp_path), device="cpu").run(spec)
    _sweep_invariants(exp)
    assert int(dict((a.name, a.value) for a in exp.optimal.assignments)["epochs"]) >= 4


def test_the_sweep_spec_runs_mnist_trial_end_to_end_on_the_cpu(tmp_path):
    """The port's spec as shipped but for a smaller split: ``mnist_trial``
    on SmallCNN through the async engine, 16 trials at a time."""
    spec = _sweep_spec(parameters={"n_train": "128", "n_test": "64"})
    assert spec.train_fn is mnist_trial
    exp = Orchestrator(workdir=str(tmp_path), device="cpu").run(spec)
    _sweep_invariants(exp)
    for t in exp.trials.values():
        (acc,) = [m for m in t.observation.metrics if m.name == "accuracy"]
        assert 0.0 <= acc.latest <= 1.0
    report = fsck_experiment(os.path.join(str(tmp_path), spec.name), repair=False)
    assert report.ok(), report.lines()


def _engine_run(spec, workdir: str):
    orch = Orchestrator(workdir=workdir, device="cpu")
    exp = orch.run(spec)
    stats = orch.async_stats
    if stats is not None:
        # a clean engine run: no loop restarted, no fallback to the sync loop
        assert stats["fallback"] is None and not any(stats["loop_restarts"].values()), stats
    return exp, stats


@pytest.mark.parametrize("algorithm", ["hyperband", "asha", "tpe"])
def test_the_async_default_ends_as_the_synchronous_loop(algorithm, tmp_path, monkeypatch):
    """With ``asyncOrch`` unset, the async engine runs the adaptive
    suggesters to the terminal condition and trial count that
    ``KATIB_ASYNC_ORCH=0`` (the synchronous loop) gives; Hyperband's rung
    table is the same too."""
    runs = {}
    for label, env in (("async", None), ("sync", "0")):
        if env is None:
            monkeypatch.delenv("KATIB_ASYNC_ORCH", raising=False)
        else:
            monkeypatch.setenv("KATIB_ASYNC_ORCH", env)
        spec = _spec("torch", *SYNC_CASES[algorithm])
        spec.async_orch = None
        exp, stats = _engine_run(spec, str(tmp_path / label))
        assert (stats is not None) == (label == "async")
        assert all(t.condition.value == "Succeeded" for t in exp.trials.values())
        rungs = None
        if algorithm == "hyperband":
            rungs = {}
            for t in exp.trials.values():
                key = (t.labels["hyperband-s"], t.labels["hyperband-i"])
                rungs[key] = rungs.get(key, 0) + 1
        runs[label] = (exp.condition.value, len(exp.trials), rungs)
    assert runs["async"] == runs["sync"]
    assert runs["async"][0] in ("Succeeded", "MaxTrialsReached")


def test_asha_promotes_under_the_engine(tmp_path, monkeypatch):
    """``tests/test_hyperband_e2e.py::test_asha_async_sweep_e2e`` on the
    port: r_max 9, r_min 1, eta 3, lr in [0.01, 0.5], 24 trials 4 at a time
    under the async default; promotions happen, each raises the resource
    and keeps the lr."""
    monkeypatch.delenv("KATIB_ASYNC_ORCH", raising=False)
    t = PKGS["torch"].types
    spec = t.ExperimentSpec(
        name="asha-sweep",
        objective=t.ObjectiveSpec(type=t.ObjectiveType.MAXIMIZE,
                                  objective_metric_name="accuracy"),
        algorithm=t.AlgorithmSpec(name="asha", settings={
            "r_max": "9", "r_min": "1", "eta": "3", "resource_name": "epochs",
            "random_state": "3"}),
        parameters=[
            t.ParameterSpec("lr", t.ParameterType.DOUBLE, t.FeasibleSpace(min=0.01, max=0.5)),
            t.ParameterSpec("epochs", t.ParameterType.INT, t.FeasibleSpace(min=1, max=9)),
        ],
        max_trial_count=24,
        parallel_trial_count=4,
        train_fn=epochs_trainer,
    )
    exp, stats = _engine_run(spec, str(tmp_path))
    assert stats is not None and stats["trials_settled"] == 24
    assert exp.condition.value in ("Succeeded", "MaxTrialsReached"), exp.message
    assert exp.optimal is not None and exp.succeeded_count == 24
    promoted = [t for t in exp.trials.values() if t.labels.get("asha-parent")]
    assert promoted, "no asynchronous promotions happened in 24 trials"
    for t in promoted:
        parent = exp.trials[t.labels["asha-parent"]]
        assert int(t.params()["epochs"]) > int(parent.params()["epochs"])
        assert t.params()["lr"] == parent.params()["lr"]


@pytest.mark.parametrize("changes,match", [
    # the prewarmer is ported: the sweep runs with mnist_trial's warm-up
    # twin on the worker (at a smaller split), as in the JAX package
    pytest.param({"prewarm": True}, "runs", id="changes0-compile/prewarm.py"),
    # cohorts are ported: the spec passes the run's checks, and the
    # orchestrator refuses nothing of it (the sweep itself runs in
    # tests/test_torch_cohort.py's cohort spec)
    pytest.param({"cohortWidth": 4}, None, id="changes1-runner/cohort.py"),
])
def test_mnist_trial_refuses_prewarm_and_cohorts(changes, match, tmp_path):
    spec = _sweep_spec(**changes)
    orch = Orchestrator(workdir=str(tmp_path), device="cpu")
    if match is None:
        from katib_tpu_torch.core.validation import validate_experiment

        validate_experiment(spec)
        assert orch._resolve_mesh(spec) is None
        return
    spec = _sweep_spec(parameters={"n_train": "128", "n_test": "64"}, **changes)
    assert spec.prewarm and spec.train_fn is mnist_trial
    exp = orch.run(spec)
    _sweep_invariants(exp)
    assert orch.prewarm_stats["failed"] == 0, orch.prewarm_stats
