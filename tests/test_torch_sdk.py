"""The port's SDK (``katib_tpu_torch.sdk``) against the JAX package's:
the ``search`` helpers, ``tune()`` and ``KatibClient``.

Every case of ``tests/test_sdk.py`` runs through both SDKs with the same
seed (the experiment name seeds the suggesters) and the same objective.
Where the case's own parallelism makes the suggester calls depend on
thread timing (a refill asks for however many proposals the queue is
short of), the exact comparison of proposals runs the case one trial at a
time on the synchronous loop, where each call asks for one; the case as
written also runs under the async engine and must pass its own checks in
both packages.  Nothing here compiles a JAX program."""

from __future__ import annotations

import pytest

from katib_tpu.core.types import ExperimentCondition as JCondition
from katib_tpu.sdk import KatibClient as JKatibClient
from katib_tpu.sdk import make_experiment_spec as j_make_experiment_spec
from katib_tpu.sdk import search as jsearch
from katib_tpu.sdk import tune as j_tune
from katib_tpu_torch.core.types import ExperimentCondition, ParameterType
from katib_tpu_torch.sdk import KatibClient, make_experiment_spec, search, tune


def _quadratic(params):
    # max at x=2, y=-1
    return -((params["x"] - 2.0) ** 2) - (params["y"] + 1.0) ** 2


def _ctx_objective(params, ctx):
    for step in range(3):
        ctx.report(step=step, objective=params["x"] * (step + 1))


def _ctx_only(ctx):
    ctx.report(step=0, objective=ctx.params["x"])


#: ``tests/test_sdk.py::TestTune``'s cases: (objective, search space from a
#: ``search`` module, tune kwargs, the case's own check of the experiment)
TUNE_CASES = {
    "returns-optimal": (
        _quadratic,
        lambda s: {"x": s.double(0.0, 4.0), "y": s.double(-3.0, 1.0)},
        dict(name="tune-quad", algorithm="tpe", max_trial_count=20, parallel_trial_count=4),
        lambda exp: exp.condition.value == "MaxTrialsReached"
        and exp.optimal is not None and exp.optimal.objective_value > -8.0,
    ),
    "goal-short-circuit": (
        lambda p: 1.0,
        lambda s: {"x": s.double(0.0, 1.0)},
        dict(name="tune-goal", goal=0.5, max_trial_count=50),
        lambda exp: exp.condition.value == "GoalReached" and len(exp.trials) < 50,
    ),
    "minimize": (
        lambda p: (p["x"] - 1.0) ** 2,
        lambda s: {"x": s.double(0.0, 2.0)},
        dict(name="tune-min", objective_type="minimize", algorithm="random",
             max_trial_count=15),
        lambda exp: exp.optimal.objective_value < 0.5,
    ),
    "objective-returning-dict": (
        lambda p: {"objective": p["x"], "aux": 1.0},
        lambda s: {"x": s.double(0.0, 1.0)},
        dict(name="tune-dict", additional_metric_names=("aux",), max_trial_count=3),
        lambda exp: next(iter(exp.trials.values())).observation.get("aux") is not None,
    ),
    "objective-with-ctx": (
        _ctx_objective,
        lambda s: {"x": s.double(0.5, 1.0)},
        dict(name="tune-ctx", max_trial_count=3),
        lambda exp: exp.optimal is not None,
    ),
    "objective-of-ctx-only": (
        _ctx_only,
        lambda s: {"x": s.double(0.0, 1.0)},
        dict(name="tune-ctx-only", max_trial_count=3),
        lambda exp: exp.optimal is not None and exp.optimal.objective_value <= 1.0,
    ),
}


def summary(exp) -> dict:
    """What the two SDKs must agree on: the condition, the trial count, the
    proposals in creation order, every trial's observation and the
    optimum's assignment and value."""
    return {
        "condition": exp.condition.value,
        "trials": len(exp.trials),
        "proposals": [t.params() for t in exp.trials.values()],
        "observations": [
            sorted((m.name, m.value, m.min, m.max, m.latest) for m in t.observation.metrics)
            if t.observation is not None else None
            for t in exp.trials.values()
        ],
        "optimal": None if exp.optimal is None else (
            {a.name: a.value for a in exp.optimal.assignments}, exp.optimal.objective_value),
    }


def both_tunes(case: str, tmp_path, **override):
    objective, space, kwargs, _ = TUNE_CASES[case]
    kwargs = {**kwargs, **override}
    want = j_tune(objective, space(jsearch), workdir=str(tmp_path / "jax"), **kwargs)
    got = tune(objective, space(search), workdir=str(tmp_path / "torch"), device="cpu",
               **kwargs)
    return want, got


@pytest.mark.parametrize("case", sorted(TUNE_CASES))
def test_tune_matches_the_jax_sdk_one_trial_at_a_time(case, tmp_path, monkeypatch):
    monkeypatch.setenv("KATIB_ASYNC_ORCH", "0")
    want, got = both_tunes(case, tmp_path, parallel_trial_count=1)
    assert summary(got) == summary(want)
    assert TUNE_CASES[case][3](got)


@pytest.mark.parametrize("case", sorted(TUNE_CASES))
def test_tune_cases_pass_under_the_engine_in_both_sdks(case, tmp_path, monkeypatch):
    monkeypatch.delenv("KATIB_ASYNC_ORCH", raising=False)
    want, got = both_tunes(case, tmp_path)
    check = TUNE_CASES[case][3]
    assert check(want) and check(got)
    assert got.condition.value == want.condition.value
    if case == "goal-short-circuit":
        assert got.optimal.objective_value == want.optimal.objective_value == 1.0


# -- search helpers (``tests/test_sdk.py::TestSearchHelpers``) ---------------

SPACES = {
    "double": lambda s: {"lr": s.double(0.001, 0.1)},
    "loguniform": lambda s: {"lr": s.loguniform(1e-5, 1e-1)},
    "int": lambda s: {"units": s.int_(16, 256, step=16)},
    "int-reference-spelling": lambda s: {"units": getattr(s, "int")(1, 4)},
    "categorical-and-discrete": lambda s: {"opt": s.categorical(["sgd", "adam"]),
                                           "bs": s.discrete([32, 64, 128])},
    "literal-shorthands": lambda s: {"lr": (0.01, 0.1), "opt": ["sgd", "adam"]},
}


@pytest.mark.parametrize("space", sorted(SPACES))
def test_search_helpers_make_the_jax_parameters(space):
    want = jsearch.make_parameters(SPACES[space](jsearch))
    got = search.make_parameters(SPACES[space](search))
    assert [(p.name, p.type.value, p.feasible.min, p.feasible.max, p.feasible.step,
             p.feasible.list, p.feasible.distribution.value) for p in got] == [
        (p.name, p.type.value, p.feasible.min, p.feasible.max, p.feasible.step,
         p.feasible.list, p.feasible.distribution.value) for p in want]


def test_search_helper_types():
    (lr,) = search.make_parameters({"lr": search.loguniform(1e-5, 1e-1)})
    assert lr.type is ParameterType.DOUBLE and lr.feasible.is_log_scaled()
    (units,) = search.make_parameters({"units": search.int_(16, 256, step=16)})
    assert units.type is ParameterType.INT and units.feasible.step == 16


def test_bad_search_entry_raises_as_in_the_jax_sdk():
    with pytest.raises(TypeError):
        jsearch.make_parameters({"x": object()})
    with pytest.raises(TypeError, match="katib_tpu_torch.sdk.search"):
        search.make_parameters({"x": object()})


# -- KatibClient (``tests/test_sdk.py::TestClient``) -------------------------


def client_lifecycle(client, make_spec) -> tuple:
    spec = make_spec(
        "cl-exp",
        {"x": (search if make_spec is make_experiment_spec else jsearch).double(0.0, 1.0)},
        objective=lambda p: p["x"],
        max_trial_count=6,
        parallel_trial_count=2,
    )
    client.create_experiment(spec)
    exp = client.wait_for_experiment_condition("cl-exp", timeout=60)
    assert client.is_experiment_succeeded("cl-exp")
    best = client.get_optimal_hyperparameters("cl-exp")
    assert "x" in best and 0.0 <= best["x"] <= 1.0
    assert len(client.get_trials("cl-exp")) == 6
    assert client.list_experiments() == [exp]
    out = (summary(exp), best)
    client.delete_experiment("cl-exp")
    assert client.list_experiments() == []
    return out


def test_client_lifecycle_matches_the_jax_client(tmp_path, monkeypatch):
    # 6 trials fit one lookahead (random search, 2 at a time: 8), so the
    # engine asks for all of them in its first call in both packages
    monkeypatch.delenv("KATIB_ASYNC_ORCH", raising=False)
    want = client_lifecycle(JKatibClient(workdir=str(tmp_path / "jax")), j_make_experiment_spec)
    got = client_lifecycle(KatibClient(workdir=str(tmp_path / "torch"), device="cpu"),
                           make_experiment_spec)
    assert got == want
    assert got[0]["condition"] == ExperimentCondition.MAX_TRIALS_REACHED.value


def test_client_tune_blocks_and_matches_the_jax_client(tmp_path, monkeypatch):
    monkeypatch.setenv("KATIB_ASYNC_ORCH", "0")
    kwargs = dict(max_trial_count=5, parallel_trial_count=1, algorithm="random")
    want = JKatibClient(workdir=str(tmp_path / "jax")).tune(
        "cl-tune", _quadratic, {"x": jsearch.double(0.0, 4.0), "y": (-3.0, 1.0)}, **kwargs)
    got = KatibClient(workdir=str(tmp_path / "torch"), device="cpu").tune(
        "cl-tune", _quadratic, {"x": search.double(0.0, 4.0), "y": (-3.0, 1.0)}, **kwargs)
    assert summary(got) == summary(want)


def test_duplicate_running_experiment_is_rejected(tmp_path):
    client = KatibClient(workdir=str(tmp_path), device="cpu")
    spec = make_experiment_spec("cl-dup", {"x": search.double(0.0, 1.0)},
                                objective=lambda p: p["x"], max_trial_count=200,
                                parallel_trial_count=1)
    client.create_experiment(spec)
    with pytest.raises(ValueError):
        client.create_experiment(spec)
    client.delete_experiment("cl-dup")
    assert client.list_experiments() == []


def test_a_pre_run_error_fails_the_experiment_as_in_the_jax_client(tmp_path):
    """An unknown algorithm raises on the daemon thread: the experiment is
    marked ``Failed`` with the error's message and ``wait`` re-raises it."""
    seen = {}
    for label, client, make_spec in (
        ("jax", JKatibClient(workdir=str(tmp_path / "jax")), j_make_experiment_spec),
        ("torch", KatibClient(workdir=str(tmp_path / "torch"), device="cpu"),
         make_experiment_spec),
    ):
        spec = make_spec("cl-bad", {"x": (0.0, 1.0)}, objective=lambda p: p["x"],
                         algorithm="no-such-algorithm", max_trial_count=2)
        exp = client.create_experiment(spec)
        with pytest.raises(Exception) as info:
            client.wait_for_experiment_condition("cl-bad", timeout=60)
        assert exp.condition.value == "Failed"
        assert not client.is_experiment_succeeded("cl-bad")
        seen[label] = (type(info.value).__name__, exp.message.split(":")[0])
    assert seen["torch"] == seen["jax"]


def test_exactly_one_entry_point_is_required():
    with pytest.raises(ValueError):
        make_experiment_spec("x", {}, objective=None, command=None)
    with pytest.raises(ValueError):
        make_experiment_spec("x", {}, objective=lambda p: 0.0, command=["echo", "hi"])


def test_a_command_spec_matches_the_jax_sdks():
    want = j_make_experiment_spec("cmd", {"lr": (0.01, 0.1)}, command=["echo", "${lr}"])
    got = make_experiment_spec("cmd", {"lr": (0.01, 0.1)}, command=["echo", "${lr}"])
    assert got.command == want.command and got.train_fn is None is want.train_fn
    assert got.metrics_collector.kind.value == want.metrics_collector.kind.value == "StdOut"


@pytest.mark.parametrize("entry", ["tune", "client"])
def test_a_mesh_raises_naming_multi_gpu(entry, tmp_path):
    """The SDK's ``mesh=`` reaches every trial as ``ctx.mesh`` (multi-GPU
    meshes are ported); a trial axis > 1 (sharded cohorts) raises naming
    ROADMAP item 9b, as the orchestrator does."""
    from katib_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"data": 2}, devices=["cpu"] * 2)
    seen = []

    def objective(params, ctx):
        seen.append(ctx.mesh)
        return params["x"]

    kw = dict(max_trial_count=2, parallel_trial_count=1)
    if entry == "tune":
        exp = tune(objective, {"x": (0.0, 1.0)}, workdir=str(tmp_path), device="cpu",
                   mesh=mesh, **kw)
    else:
        client = KatibClient(workdir=str(tmp_path), device="cpu", mesh=mesh)
        exp = client.tune("sdk-mesh", objective, {"x": (0.0, 1.0)}, **kw)
    assert exp.condition is ExperimentCondition.MAX_TRIALS_REACHED
    assert seen == [mesh, mesh]
    trial_mesh = make_mesh({"trial": 2}, devices=["cpu"] * 2)
    with pytest.raises(NotImplementedError, match="9b"):
        tune(lambda p: p["x"], {"x": (0.0, 1.0)}, workdir=str(tmp_path / "t"), device="cpu",
             mesh=trial_mesh, max_trial_count=1, name="sdk-trial-mesh")


def test_tune_runs_on_cuda_unless_told_otherwise(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tune(lambda p: p["x"], {"x": (0.0, 1.0)}, workdir=str(tmp_path), max_trial_count=1)
    client = KatibClient(workdir=str(tmp_path))
    spec = make_experiment_spec("cl-gpu", {"x": (0.0, 1.0)}, objective=lambda p: p["x"],
                                max_trial_count=1)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        client.create_experiment(spec)


def test_the_sdk_exports_what_the_jax_sdk_does():
    import katib_tpu.sdk as jsdk
    import katib_tpu_torch.sdk as tsdk

    assert tsdk.__all__ == jsdk.__all__
    from katib_tpu_torch.sdk import yaml_spec  # noqa: F401
    assert JCondition.GOAL_REACHED.value == ExperimentCondition.GOAL_REACHED.value
