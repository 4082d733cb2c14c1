"""The port's suggesters against the JAX package's: Hyperband, ASHA, TPE,
multivariate TPE, Sobol, CMA-ES, Bayesian optimization and PBT.  Driven in
lockstep from the same history (the same closed-form objective, the same
seeds), they must propose the same assignments with the same labels, leave
the same state blobs in the experiment's algorithm settings, signal
``SuggestionsNotReady`` and ``SearchExhausted`` at the same asks, and refuse
bad settings with the same errors.  PBT's journaled state must be equal
after the same history, and each package must resume from the other's.
Parity models: ``tests/test_suggesters.py``."""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import uuid
from types import SimpleNamespace
from unittest import mock

import pytest

from katib_tpu.core import types as jtypes
from katib_tpu.suggest import base as jbase
from katib_tpu_torch.core import types as ttypes
from katib_tpu_torch.suggest import base as tbase

PKGS = {"jax": SimpleNamespace(types=jtypes, base=jbase),
        "torch": SimpleNamespace(types=ttypes, base=tbase)}


def _spec(pkg: str, algorithm: str, settings: dict, parallel: int = 1, numeric: bool = False):
    """The parity experiment; ``numeric`` drops the categorical parameter
    (CMA-ES takes only doubles and ints)."""
    t = PKGS[pkg].types
    parameters = [
        t.ParameterSpec("lr", t.ParameterType.DOUBLE, t.FeasibleSpace(min=0.001, max=0.5)),
        t.ParameterSpec("epochs", t.ParameterType.INT, t.FeasibleSpace(min=1, max=16)),
        t.ParameterSpec("arch", t.ParameterType.CATEGORICAL,
                        t.FeasibleSpace(list=("cnn", "mlp"))),
    ]
    return t.ExperimentSpec(
        name=f"{algorithm}-parity",
        objective=t.ObjectiveSpec(type=t.ObjectiveType.MAXIMIZE,
                                  objective_metric_name="accuracy"),
        algorithm=t.AlgorithmSpec(name=algorithm, settings=dict(settings)),
        parameters=parameters[:2] if numeric else parameters,
        parallel_trial_count=parallel,
        train_fn=lambda ctx: None,
    )


def objective(params: dict) -> float:
    """A closed-form accuracy: an interior optimum in lr, better with more
    epochs and with the CNN."""
    lr, epochs = float(params["lr"]), float(params["epochs"])
    return ((1.0 - (math.log10(lr) + 1.3) ** 2 / 4) * (1 - math.exp(-epochs / 4))
            * (1.0 if params.get("arch", "cnn") == "cnn" else 0.9))


def flat(params: dict) -> float:
    """No gradient at all: CMA-ES stagnates and its IPOP restart fires."""
    return 0.5


def _complete(pkg: str, exp, proposal, running: bool):
    """The proposal as a trial of ``exp``, running or succeeded without an
    observation yet (see :func:`_finish`)."""
    t = PKGS[pkg].types
    name = proposal.name or f"{exp.name}-t{len(exp.trials)}"
    trial = t.Trial(
        name=name, experiment_name=exp.name,
        spec=t.TrialSpec(assignments=list(proposal.assignments), labels=dict(proposal.labels),
                         early_stopping_rules=list(proposal.early_stopping_rules)),
        condition=t.TrialCondition.RUNNING if running else t.TrialCondition.SUCCEEDED,
        start_time=float(len(exp.trials)),
    )
    exp.trials[name] = trial
    return trial


def _finish(pkg: str, trial, score=objective) -> None:
    t = PKGS[pkg].types
    value = score({a.name: a.value for a in trial.spec.assignments})
    trial.condition = t.TrialCondition.SUCCEEDED
    trial.observation = t.Observation(
        metrics=[t.Metric(name="accuracy", value=value, latest=value)])


def _ask(suggester, exp, n):
    """The proposals of one ask, or none and the signal it raised."""
    try:
        return suggester.get_suggestions(exp, n), None
    except (jbase.SearchExhausted, tbase.SearchExhausted, jbase.SuggestionsNotReady,
            tbase.SuggestionsNotReady) as e:
        return [], type(e).__name__


@contextlib.contextmanager
def _in_dir(path):
    """Run in ``path`` (PBT writes ``katib_runs/<name>/pbt`` under the cwd)
    with ``uuid4`` counting from zero (PBT names its trials with it)."""
    if path is None:
        yield
        return
    os.makedirs(path, exist_ok=True)
    prev = os.getcwd()
    count = itertools.count()
    os.chdir(path)
    try:
        with mock.patch.object(uuid, "uuid4", lambda: uuid.UUID(int=next(count) << 96)):
            yield
    finally:
        os.chdir(prev)


def drive(pkg, suggester, exp, asks, batch, score=objective, history=None):
    """``asks`` asks of ``batch`` against ``exp``; each ask's last proposal
    stays running until the next ask, so a rung barrier answers
    ``SuggestionsNotReady`` once.  Appends (proposals, signal, algorithm
    settings) per ask to ``history``."""
    history = [] if history is None else history
    running = None
    for _ in range(asks):
        proposals, signal = _ask(suggester, exp, batch)
        if running is not None:
            _finish(pkg, running, score)
            running = None
        history.append(([(p.name, [(a.name, a.value) for a in p.assignments], dict(p.labels))
                         for p in proposals], signal, dict(exp.algorithm_settings)))
        if signal == "SearchExhausted":
            break
        trials = [_complete(pkg, exp, p, running=i == len(proposals) - 1)
                  for i, p in enumerate(proposals)]
        for trial in trials[:-1]:
            _finish(pkg, trial, score)
        running = trials[-1] if trials else None
    return history


def lockstep(algorithm: str, settings: dict, parallel: int, asks: int, batch: int,
             numeric: bool = False, score=objective, workdir=None) -> dict:
    """Drive both packages' suggesters through ``asks`` asks of ``batch``
    (see :func:`drive`).  Returns each package's history."""
    runs = {}
    for pkg in PKGS:
        with _in_dir(None if workdir is None else os.path.join(workdir, pkg)):
            spec = _spec(pkg, algorithm, settings, parallel, numeric)
            suggester = PKGS[pkg].base.make_suggester(spec)
            exp = PKGS[pkg].types.Experiment(spec=spec)
            runs[pkg] = drive(pkg, suggester, exp, asks, batch, score)
    return runs


CASES = {
    # the sweep's settings: 32 trials, rung barriers, then exhaustion
    "hyperband": ("hyperband", {"r_l": "16", "eta": "4", "resource_name": "epochs"}, 16, 40, 16),
    "hyperband-eta3": ("hyperband", {"r_l": "9", "eta": "3", "resource_name": "epochs"}, 9, 40,
                       20),
    "asha": ("asha", {"r_max": "16", "eta": "4", "resource_name": "epochs",
                      "random_state": "3"}, 1, 30, 2),
    "asha-tpe": ("asha", {"r_max": "16", "eta": "2", "resource_name": "epochs",
                          "sampler": "tpe", "n_startup_trials": "4", "random_state": "5"}, 1,
                 30, 3),
    "tpe": ("tpe", {"n_startup_trials": "5", "random_state": "7"}, 1, 25, 1),
    "tpe-batch": ("tpe", {"n_startup_trials": "3", "random_state": "8", "gamma": "0.3"}, 1, 12,
                  3),
    "multivariate-tpe": ("multivariate-tpe", {"n_startup_trials": "5", "random_state": "9"}, 1,
                         25, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_suggestions_are_identical_to_the_jax_suggesters(case):
    algorithm, settings, parallel, asks, batch = CASES[case]
    runs = lockstep(algorithm, settings, parallel, asks, batch)
    assert runs["torch"] == runs["jax"]
    proposed = sum(len(p) for p, _, _ in runs["torch"] if p)
    assert proposed >= min(asks, 10)
    signals = {s for _, s, _ in runs["torch"]}
    if algorithm == "hyperband":
        # the whole budget: rung barriers answered "not ready", then exhausted
        assert signals == {None, "SuggestionsNotReady", "SearchExhausted"}
        assert proposed == (32 if case == "hyperband" else 23)
        assert "_hyperband_state" in runs["torch"][-1][2]
    else:
        assert signals == {None}


def test_hyperband_rungs_of_the_sweep():
    """r_l 16, eta 4: s=2 16@1, 4@4, 1@16; s=1 6@4, 2@16; s=0 3@16."""
    runs = lockstep(*CASES["hyperband"])
    rungs: dict = {}
    for proposals, _, _ in runs["torch"]:
        for _, assigns, labels in proposals or []:
            key = (labels["hyperband-s"], labels["hyperband-i"])
            rungs.setdefault(key, set()).add(dict(assigns)["epochs"])
            rungs[key + ("n",)] = rungs.get(key + ("n",), 0) + 1
    assert {k: (rungs[k + ("n",)], sorted(rungs[k])) for k in
            [("2", "0"), ("2", "1"), ("2", "2"), ("1", "0"), ("1", "1"), ("0", "0")]} == {
        ("2", "0"): (16, [1]), ("2", "1"): (4, [4]), ("2", "2"): (1, [16]),
        ("1", "0"): (6, [4]), ("1", "1"): (2, [16]), ("0", "0"): (3, [16])}


INVALID = {
    "hyperband-no-r_l": ("hyperband", {"resource_name": "epochs"}, 16),
    "hyperband-bad-r_l": ("hyperband", {"r_l": "x", "resource_name": "epochs"}, 16),
    "hyperband-ghost-resource": ("hyperband", {"r_l": "16", "resource_name": "ghost"}, 16),
    "hyperband-parallel": ("hyperband", {"r_l": "16", "eta": "4", "resource_name": "epochs"}, 4),
    "hyperband-eta": ("hyperband", {"r_l": "16", "eta": "1", "resource_name": "epochs"}, 16),
    "hyperband-range": ("hyperband", {"r_l": "64", "eta": "4", "resource_name": "epochs"}, 64),
    "asha-no-r_max": ("asha", {"resource_name": "epochs"}, 1),
    "asha-ghost-resource": ("asha", {"r_max": "9", "resource_name": "ghost"}, 1),
    "asha-range": ("asha", {"r_max": "50", "resource_name": "epochs"}, 1),
    "asha-sampler": ("asha", {"r_max": "9", "resource_name": "epochs", "sampler": "cmaes"}, 1),
    "tpe-gamma": ("tpe", {"gamma": "1.5"}, 1),
    "tpe-prior-weight": ("tpe", {"prior_weight": "0"}, 1),
    "tpe-candidates": ("tpe", {"n_EI_candidates": "0"}, 1),
    "multivariate-tpe-gamma": ("multivariate-tpe", {"gamma": "0"}, 1),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_validation_errors_match_the_jax_suggesters(case):
    algorithm, settings, parallel = INVALID[case]
    errors = []
    for pkg in PKGS:
        with pytest.raises(PKGS[pkg].base.SuggesterError) as err:
            PKGS[pkg].base.make_suggester(_spec(pkg, algorithm, settings, parallel))
        errors.append(str(err.value))
    assert errors[0] == errors[1]


# -- the host suggesters of the black-box specs: Sobol, CMA-ES, Bayesian
# optimization, PBT -------------------------------------------------------

HOST_CASES = {
    "sobol": ("sobol", {"random_state": "4"}, 1, 6, 3, {}),
    "sobol-unseeded": ("sobol", {}, 1, 4, 5, {}),
    "cmaes": ("cmaes", {"random_state": "2", "sigma": "0.3"}, 1, 14, 4, {"numeric": True}),
    "cmaes-population": ("cmaes", {"random_state": "6", "population_size": "4"}, 1, 10, 3,
                         {"numeric": True}),
    # a flat objective: no generation improves, so IPOP restarts after
    # 10 + dim stagnant generations with the population doubled
    "cmaes-ipop-restart": ("cmaes", {"random_state": "1", "restart_strategy": "ipop"}, 1, 28,
                           12, {"numeric": True, "score": flat}),
    "bayesianoptimization": ("bayesianoptimization",
                             {"n_initial_points": "3", "random_state": "5"}, 1, 6, 2, {}),
    "bayesianoptimization-ei": ("bayesianoptimization",
                                {"n_initial_points": "2", "random_state": "8", "acq_func": "EI"},
                                1, 5, 1, {}),
    "pbt": ("pbt", {"n_population": "5", "truncation_threshold": "0.25", "random_state": "3"},
            2, 12, 2, {}),
    "pbt-resample": ("pbt", {"n_population": "6", "truncation_threshold": "0.4",
                             "resample_probability": "0.5", "random_state": "9"}, 2, 10, 3, {}),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_suggestions_are_identical_to_the_jax_suggesters(case, tmp_path):
    algorithm, settings, parallel, asks, batch, kw = HOST_CASES[case]
    runs = lockstep(algorithm, settings, parallel, asks, batch, workdir=str(tmp_path), **kw)
    assert runs["torch"] == runs["jax"]
    proposals = [p for props, _, _ in runs["torch"] for p in props]
    assert len(proposals) >= asks
    if algorithm == "cmaes":
        gens = {}
        for _, _, labels in proposals:
            gens.setdefault(int(labels["cmaes-generation"]), set()).add(
                int(labels["cmaes-index"]))
        if case == "cmaes-ipop-restart":
            # generations 0-12 of 6, then the restarted strategy's 12; the
            # label counter keeps rising across the restart
            assert [len(gens[g]) for g in range(13)] == [6] * 13
            assert gens[13] == set(range(12))
        else:
            assert max(gens) >= 2
    if algorithm == "pbt":
        labels = [lab for _, _, lab in proposals]
        assert {lab["pbt-generation"] for lab in labels} >= {"0", "1", "2"}
        assert any("pbt-parent" in lab for lab in labels)


def test_pbt_state_is_equal_and_each_package_resumes_the_other(tmp_path):
    """After the same history both packages journal the same JSON state;
    a suggester of either package loaded with the other's state proposes
    what the other would have."""
    algorithm, settings, parallel, asks, batch, _ = HOST_CASES["pbt"]
    state, exps = {}, {}
    for pkg in PKGS:
        with _in_dir(str(tmp_path / pkg)):
            spec = _spec(pkg, algorithm, settings, parallel)
            suggester = PKGS[pkg].base.make_suggester(spec)
            exp = exps[pkg] = PKGS[pkg].types.Experiment(spec=spec)
            drive(pkg, suggester, exp, asks, batch)
            state[pkg] = json.dumps(suggester.state_dict(), sort_keys=True)
    assert state["torch"] == state["jax"]
    assert json.loads(state["torch"])["completed"]
    # resume: each package's fresh suggester loads the OTHER's state, then
    # both continue the same experiment history for a few asks
    nxt = {}
    for pkg, other in (("torch", "jax"), ("jax", "torch")):
        with _in_dir(str(tmp_path / f"resume-{pkg}")):
            spec = _spec(pkg, algorithm, settings, parallel)
            suggester = PKGS[pkg].base.make_suggester(spec)
            suggester.load_state_dict(json.loads(state[other]))
            nxt[pkg] = drive(pkg, suggester, exps[pkg], 4, batch)
    assert nxt["torch"] == nxt["jax"]
    assert sum(len(p) for p, _, _ in nxt["torch"]) >= 4


def test_pbt_exploit_copies_the_winners_checkpoint_dir(tmp_path):
    """Exploit is a copy of the parent's whole checkpoint directory, so it
    carries the port's ``torch.save`` steps unchanged."""
    import torch

    from katib_tpu_torch.utils.checkpoint import TrialCheckpointer

    algorithm, settings, parallel, _, batch, _ = HOST_CASES["pbt"]
    with _in_dir(str(tmp_path)):
        spec = _spec("torch", algorithm, settings, parallel)
        suggester = tbase.make_suggester(spec)
        exp = ttypes.Experiment(spec=spec)
        history = []
        for _ in range(12):
            drive("torch", suggester, exp, 1, batch, history=history)
            for name in list(exp.trials):
                d = suggester.checkpoint_dir_for(name)
                if not os.path.isdir(os.path.join(d, "step_00000000")):
                    TrialCheckpointer(d).save({"who": torch.tensor([len(name)])}, 0)
        children = [(n, lab["pbt-parent"]) for props, _, _ in history
                    for n, _, lab in props if "pbt-parent" in lab]
        assert children
        for child, parent in children:
            root = os.path.join("katib_runs", spec.name, "pbt")
            assert suggester.checkpoint_dir_for(child) == os.path.join(root, child)
            got = TrialCheckpointer(os.path.join(root, child)).restore()
            assert got is not None
            assert os.path.isdir(os.path.join(root, parent))


HOST_INVALID = {
    "cmaes-categorical": ("cmaes", {}, False),
    "cmaes-restart": ("cmaes", {"restart_strategy": "lbfgs"}, True),
    "cmaes-sigma": ("cmaes", {"sigma": "0"}, True),
    "bayesianoptimization-estimator": ("bayesianoptimization", {"base_estimator": "RF"}, False),
    "bayesianoptimization-acq": ("bayesianoptimization", {"acq_func": "ucb"}, False),
    "bayesianoptimization-optimizer": ("bayesianoptimization", {"acq_optimizer": "cobyla"},
                                       False),
    "bayesianoptimization-init": ("bayesianoptimization", {"n_initial_points": "0"}, False),
    "pbt-no-population": ("pbt", {"truncation_threshold": "0.2"}, False),
    "pbt-small-population": ("pbt", {"n_population": "3", "truncation_threshold": "0.2"}, False),
    "pbt-truncation": ("pbt", {"n_population": "5", "truncation_threshold": "0.7"}, False),
    "pbt-resample": ("pbt", {"n_population": "5", "truncation_threshold": "0.2",
                             "resample_probability": "2"}, False),
}


@pytest.mark.parametrize("case", sorted(HOST_INVALID))
def test_host_validation_errors_match_the_jax_suggesters(case):
    algorithm, settings, numeric = HOST_INVALID[case]
    errors = []
    for pkg in PKGS:
        with pytest.raises(PKGS[pkg].base.SuggesterError) as err:
            PKGS[pkg].base.validate_spec(_spec(pkg, algorithm, settings, 1, numeric))
        errors.append(str(err.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("missing", ["scipy", "sklearn"])
def test_a_missing_optional_dependency_is_a_suggester_error(monkeypatch, missing):
    """Without scipy (sobol, bayesianoptimization) or scikit-learn
    (bayesianoptimization) the spec is refused at validation, with the JAX
    package's error; nothing else runs in its place."""
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == missing else real(name, *a))
    algorithms = ["bayesianoptimization"] + (["sobol"] if missing == "scipy" else [])
    for algorithm in algorithms:
        errors = []
        for pkg in PKGS:
            with pytest.raises(PKGS[pkg].base.SuggesterError) as err:
                PKGS[pkg].base.validate_spec(_spec(pkg, algorithm, {}))
            errors.append(str(err.value))
        assert errors[0] == errors[1] and missing in errors[1]


def test_only_pbt_ondevice_and_remote_are_unported():
    from katib_tpu_torch.suggest import algorithms

    # pbt-ondevice is ported too (tests/test_torch_pbt_ondevice.py)
    assert set(algorithms.UNPORTED_ALGORITHMS) == {"remote"}
    for name in ("sobol", "cmaes", "bayesianoptimization", "pbt", "pbt-ondevice"):
        assert name in tbase.registered_algorithms()
    for name in ("remote",):
        with pytest.raises(NotImplementedError, match=name):
            tbase.make_suggester(_spec("torch", name, {"n_population": "5",
                                                       "truncation_threshold": "0.2"}))
