"""The port's Hyperband, ASHA, TPE and multivariate-TPE suggesters against
the JAX package's: driven in lockstep from the same history (the same
closed-form objective, the same seeds), they must propose the same
assignments with the same labels, leave the same state blobs in the
experiment's algorithm settings, signal ``SuggestionsNotReady`` and
``SearchExhausted`` at the same asks, and refuse bad settings with the same
errors.  Parity models: ``tests/test_suggesters.py`` ``TestHyperband``,
``TestAsha`` and ``TestTPE``."""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest

from katib_tpu.core import types as jtypes
from katib_tpu.suggest import base as jbase
from katib_tpu_torch.core import types as ttypes
from katib_tpu_torch.suggest import base as tbase

PKGS = {"jax": SimpleNamespace(types=jtypes, base=jbase),
        "torch": SimpleNamespace(types=ttypes, base=tbase)}


def _spec(pkg: str, algorithm: str, settings: dict, parallel: int = 1):
    t = PKGS[pkg].types
    return t.ExperimentSpec(
        name=f"{algorithm}-parity",
        objective=t.ObjectiveSpec(type=t.ObjectiveType.MAXIMIZE,
                                  objective_metric_name="accuracy"),
        algorithm=t.AlgorithmSpec(name=algorithm, settings=dict(settings)),
        parameters=[
            t.ParameterSpec("lr", t.ParameterType.DOUBLE, t.FeasibleSpace(min=0.001, max=0.5)),
            t.ParameterSpec("epochs", t.ParameterType.INT, t.FeasibleSpace(min=1, max=16)),
            t.ParameterSpec("arch", t.ParameterType.CATEGORICAL,
                            t.FeasibleSpace(list=("cnn", "mlp"))),
        ],
        parallel_trial_count=parallel,
        train_fn=lambda ctx: None,
    )


def objective(params: dict) -> float:
    """A closed-form accuracy: an interior optimum in lr, better with more
    epochs and with the CNN."""
    lr, epochs = float(params["lr"]), float(params["epochs"])
    return ((1.0 - (math.log10(lr) + 1.3) ** 2 / 4) * (1 - math.exp(-epochs / 4))
            * (1.0 if params["arch"] == "cnn" else 0.9))


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


def _finish(pkg: str, trial) -> None:
    t = PKGS[pkg].types
    value = objective({a.name: a.value for a in trial.spec.assignments})
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


def lockstep(algorithm: str, settings: dict, parallel: int, asks: int, batch: int) -> dict:
    """Drive both packages' suggesters through ``asks`` asks of ``batch``.
    Each ask's last proposal stays running until the next ask, so a rung
    barrier answers ``SuggestionsNotReady`` once.  Returns each package's
    history of (proposals, signal, algorithm settings)."""
    runs = {}
    for pkg in PKGS:
        spec = _spec(pkg, algorithm, settings, parallel)
        suggester = PKGS[pkg].base.make_suggester(spec)
        exp = PKGS[pkg].types.Experiment(spec=spec)
        history, running = [], None
        for _ in range(asks):
            proposals, signal = _ask(suggester, exp, batch)
            if running is not None:
                _finish(pkg, running)
                running = None
            history.append(([(p.name, [(a.name, a.value) for a in p.assignments], dict(p.labels))
                             for p in proposals], signal, dict(exp.algorithm_settings)))
            if signal == "SearchExhausted":
                break
            trials = [_complete(pkg, exp, p, running=i == len(proposals) - 1)
                      for i, p in enumerate(proposals)]
            for trial in trials[:-1]:
                _finish(pkg, trial)
            running = trials[-1] if trials else None
        runs[pkg] = history
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
