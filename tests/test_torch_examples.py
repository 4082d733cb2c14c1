"""The shipped specs that the black-box runner, the host suggesters,
on-device PBT and the compile half lift: the 14 ``command:`` specs,
``simple-pbt.yaml``, ``pbt-ondevice.yaml`` and ``cohort-prewarm.yaml``, each
run as shipped
through the port's loader and ``Orchestrator.run`` on the CPU, must end as
the JAX orchestrator's run of it ends: the same experiment condition, the
same trial count and trial conditions, no failed trial.  Where the outcome
cannot depend on timing (a grid, a Sobol sequence) the two runs must give
the same ``(params, objective)`` pairs exactly.  One spec also runs
through ``python -m katib_tpu_torch run ... --device cpu`` and ``fsck``.

A run writes only under its test's temporary directory (the workdir, and the
cwd: PBT writes ``katib_runs/<name>/pbt`` relative to it) and in the
``/tmp/katib-metrics-<trial>.log`` files of ``file-metrics-collector.yaml``,
which the test removes.  ``cohort-prewarm.yaml`` names a compile cache and
an artifact directory under ``/tmp``: its run points both packages at the
test's temporary directory instead (``KATIB_COMPILE_CACHE``,
``KATIB_ARTIFACT_DIR``, which win over the spec), and the process-global
state that wires them is put back after it.  The JAX run trains its 12
``mnist_trial``s and prewarms on the CPU in about 10 s, so it runs whole."""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import threading

import pytest

from katib_tpu.orchestrator import Orchestrator as JaxOrchestrator
from katib_tpu.sdk.yaml_spec import load_experiment_yaml as jax_load
from katib_tpu_torch.orchestrator import Orchestrator
from katib_tpu_torch.sdk.yaml_spec import load_experiment_yaml
from tests.torch_compile_state import fresh_compile_state  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMAND_SPECS = ["early-stopping/median-stop"] + [
    f"hp-tuning/{name}" for name in (
        "asha", "bayesian-optimization", "cma-es", "file-metrics-collector", "grid",
        "hyperband", "metrics-strategy", "multivariate-tpe", "random", "resume-long-running",
        "sobol", "tpe", "trial-metadata")]
SPECS = COMMAND_SPECS + ["hp-tuning/simple-pbt", "hp-tuning/pbt-ondevice",
                         "hp-tuning/cohort-prewarm"]
#: suggesters whose proposals cannot depend on when trials finish
TIMING_FREE = {"hp-tuning/grid", "hp-tuning/sobol"}


def _path(name: str) -> str:
    return os.path.join(ROOT, "examples", f"{name}.yaml")


def test_the_command_specs_are_every_shipped_command_spec():
    import glob

    shipped = sorted(
        os.path.relpath(p, os.path.join(ROOT, "examples"))[:-5]
        for p in glob.glob(os.path.join(ROOT, "examples", "*", "*.yaml"))
        if "\n    command:" in open(p).read() and "/sim/" not in p)
    assert shipped == sorted(COMMAND_SPECS)


def _run(pkg: str, name: str, tmp_path):
    workdir = tmp_path / pkg
    workdir.mkdir()
    if pkg == "jax":
        orch = JaxOrchestrator(workdir=str(workdir))
        exp = orch.run(jax_load(_path(name)))
    else:
        spec = load_experiment_yaml(_path(name))
        orch = Orchestrator(workdir=str(workdir), device="cpu")
        exp = orch.run(spec)
    for trial in exp.trials:
        metrics_file = f"/tmp/katib-metrics-{trial}.log"
        if os.path.exists(metrics_file):
            os.unlink(metrics_file)
    return exp, orch


@pytest.fixture
def compile_dirs(tmp_path, fresh_compile_state):
    """``KATIB_COMPILE_CACHE`` and ``KATIB_ARTIFACT_DIR`` under ``tmp_path``
    for both packages; the JAX package's process-global compile-cache
    wiring (its runner's directory, the jax config) starts unwired, as
    ``tests/test_cohort.py`` starts it (a JAX test run earlier in the same
    process may have wired another directory, first caller wins), and is
    put back after."""
    import jax

    from katib_tpu.compile import artifacts as jart
    from katib_tpu.runner import trial_runner as jrunner

    monkeypatch = fresh_compile_state
    old = {key: getattr(jax.config, key) for key in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    monkeypatch.setattr(jrunner, "_COMPILE_CACHE_DIR", None)
    monkeypatch.setenv("KATIB_COMPILE_CACHE", str(tmp_path / "cc"))
    monkeypatch.setenv("KATIB_ARTIFACT_DIR", str(tmp_path / "art"))
    yield tmp_path / "cc", tmp_path / "art"
    jart.ARTIFACTS.reset()
    for key, value in old.items():
        jax.config.update(key, value)
    try:
        from jax._src import compilation_cache

        compilation_cache.reset_cache()
    except Exception:
        pass


def _summary(exp) -> dict:
    conditions = collections.Counter(t.condition.value for t in exp.trials.values())
    out = {"condition": exp.condition.value, "failed": conditions.get("Failed", 0),
           "optimal": exp.optimal is not None}
    if exp.condition.value == "GoalReached":
        # the siblings still running at the goal are killed: how many, is timing
        out["conditions"] = sorted(conditions)
    else:
        out["conditions"] = dict(conditions)
        out["trials"] = len(exp.trials)
    return out


@pytest.mark.parametrize("name", SPECS)
def test_shipped_spec_ends_as_the_jax_run(name, tmp_path, monkeypatch, request):
    # the two packages' runs go side by side, on two threads, in one cwd
    monkeypatch.chdir(tmp_path)
    if name == "hp-tuning/cohort-prewarm":
        cache, shared = request.getfixturevalue("compile_dirs")
    runs, orchs, errors = {}, {}, []

    def go(pkg):
        try:
            runs[pkg], orchs[pkg] = _run(pkg, name, tmp_path)
        except BaseException as e:  # re-raised below, on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=go, args=(pkg,)) for pkg in ("jax", "torch")]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    assert _summary(runs["torch"]) == _summary(runs["jax"])
    exp = runs["torch"]
    assert exp.condition.value in ("MaxTrialsReached", "GoalReached"), exp.message
    assert all(t.condition.value in ("Succeeded", "Killed") for t in exp.trials.values())
    spec = exp.spec
    if exp.condition.value == "MaxTrialsReached":
        assert len(exp.trials) == spec.max_trial_count
    else:
        goal, value = spec.objective.goal, exp.optimal.objective_value
        assert (value >= goal) if spec.objective.type.value == "maximize" else (value <= goal)
    if name in TIMING_FREE:
        pairs = {pkg: sorted((tuple(sorted(t.params().items())),
                              t.objective_value(e.spec.objective))
                             for t in e.trials.values()) for pkg, e in runs.items()}
        assert pairs["torch"] == pairs["jax"]
        assert exp.optimal.objective_value == runs["jax"].optimal.objective_value
    if name == "hp-tuning/grid":
        assert len({p for p, _ in pairs["torch"]}) == 12  # 4 lr x 3 num_layers
    if name == "hp-tuning/simple-pbt":
        labels = [t.spec.labels for t in exp.trials.values()]
        assert {lab["pbt-generation"] for lab in labels} >= {"0", "1"}
        parents = {lab["pbt-parent"] for lab in labels if "pbt-parent" in lab}
        assert parents and parents <= set(exp.trials)
        pbt_root = tmp_path / "katib_runs" / spec.name / "pbt"
        assert all((pbt_root / t).is_dir() for t in exp.trials)
    if name == "hp-tuning/pbt-ondevice":
        # one cohort of 16 evolved 10 generations; lineage labels as the
        # JAX run's, every parent a member
        for e in runs.values():
            labels = [t.spec.labels for t in e.trials.values()]
            assert {lab["pbt-generation"] for lab in labels} == {"10"}
            assert {lab["pbt-parent"] for lab in labels} <= set(e.trials)
    if name == "hp-tuning/cohort-prewarm":
        # the worker ran mnist_trial's twin on the CPU; each package keeps its
        # own registry file in the one compile cache; the port published no
        # kernel library (mnist_trial launches none) and left JAX's
        # envelopes in the one artifact dir alone
        stats = orchs["torch"].prewarm_stats
        assert stats["failed"] == 0 and stats["published"] == 0, stats
        rows = [json.loads(line) for line in
                (cache / "torch" / "shape_registry.jsonl").read_text().splitlines()]
        assert {r["program"] for r in rows} == {"mnist_trial"}
        assert all("process" in r and "fingerprint" in r for r in rows)
        assert (cache / "shape_registry.jsonl").is_file()  # the JAX run's
        assert not [n for n in os.listdir(shared) if n.endswith(".katibso")] if shared.is_dir() else True


def test_random_spec_runs_through_the_cli_and_fscks_clean(tmp_path):
    workdir = str(tmp_path / "runs")
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}

    def cli(*args):
        return subprocess.run([sys.executable, "-m", "katib_tpu_torch", *args], cwd=ROOT,
                              env=env, capture_output=True, text=True, timeout=240)

    out = cli("run", _path("hp-tuning/random"), "--device", "cpu", "--workdir", workdir)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "experiment random-example:" in out.stdout and "[ok]" in out.stdout
    (line,) = [ln for ln in out.stderr.splitlines() if ln.startswith("async engine: ")]
    stats = json.loads(line[len("async engine: "):])
    assert stats["fallback"] is None and not any(stats["loop_restarts"].values()), stats
    assert stats["trials_settled"] >= 1
    fsck = cli("fsck", os.path.join(workdir, "random-example"))
    assert fsck.returncode == 0 and "result: consistent" in fsck.stdout, fsck.stdout + fsck.stderr
    # each trial's stdout is kept beside its checkpoints
    logs = [os.path.join(workdir, "random-example", d, "trial.log")
            for d in os.listdir(os.path.join(workdir, "random-example"))]
    assert any(os.path.isfile(p) and "loss=" in open(p).read() for p in logs)


def test_pbt_toy_trial_reports_as_the_jax_trial(tmp_path):
    """``pbt_toy_trial`` from a cold start, then resumed twice from its own
    checkpoint (as an explore step continues a member) and once from a
    copy (as an exploit clones a winner): the same reports as the JAX
    trial, exactly, with the float32 score the checkpoint rounds to."""
    import shutil

    from katib_tpu.models import pbt_toy as jax_pbt_toy
    from katib_tpu.runner.context import TrialContext as JaxContext
    from katib_tpu.store.base import MemoryObservationStore as JaxStore
    from katib_tpu_torch.models.pbt_toy import optimal_lr, pbt_toy_trial
    from katib_tpu_torch.runner.context import TrialContext
    from katib_tpu_torch.store.base import MemoryObservationStore

    assert [optimal_lr(s) for s in range(41)] == [jax_pbt_toy.optimal_lr(s) for s in range(41)]
    reports = {}
    for pkg in ("jax", "torch"):
        root = tmp_path / pkg
        store = JaxStore() if pkg == "jax" else MemoryObservationStore()
        runs = [("a", "a", 0.05), ("a", "a", 0.06), ("a", "a", 0.004), ("b", "a", 0.0123)]
        for i, (name, source, lr) in enumerate(runs):
            if name != source:
                shutil.copytree(root / source, root / name)
            params = {"lr": lr, "steps_per_round": 3 + i}
            if pkg == "jax":
                ctx = JaxContext(f"t{i}", params, store, checkpoint_dir=str(root / name))
                jax_pbt_toy.pbt_toy_trial(ctx)
            else:
                ctx = TrialContext(params, checkpoint_dir=str(root / name), device="cpu",
                                   trial_name=f"t{i}", store=store)
                pbt_toy_trial(ctx)
        reports[pkg] = [[(log.metric_name, log.value, log.step) for log in store.get(f"t{i}")]
                        for i in range(4)]
    assert reports["torch"] == reports["jax"]
    steps = [[s for m, _, s in run if m == "score"] for run in reports["torch"]]
    assert steps == [[0, 1, 2], [3, 4, 5, 6], [7, 8, 9, 10, 11], [12, 13, 14, 15, 16, 17]]
