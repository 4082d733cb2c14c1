"""The port's orchestrator, journal, resume and drain against the JAX
package's, on the same cheap Python ``train_fn`` (no JAX program is
compiled), and the features the port refuses.

The journal, ``status.json`` and ``suggester_state.pkl`` formats are
copies, so each package's ``fsck`` reads the other's experiment directory
clean."""

from __future__ import annotations

import os
import random
import sys
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from katib_tpu.core import types as jtypes
from katib_tpu.orchestrator import journal as jjournal
from katib_tpu.orchestrator.fsck import fsck_experiment as j_fsck
from katib_tpu.orchestrator.orchestrator import Orchestrator as JOrchestrator
from katib_tpu.orchestrator.resume import experiment_from_dict as j_from_dict
from katib_tpu.orchestrator.status import read_status as j_read_status
from katib_tpu_torch.core import types as ttypes
from katib_tpu_torch.core.config import KatibConfig
from katib_tpu_torch.orchestrator import journal as tjournal
from katib_tpu_torch.orchestrator.fsck import fsck_experiment as t_fsck
from katib_tpu_torch.compile.prewarm import _PREWARM_ATTR as PREWARM_ATTR
from katib_tpu_torch.orchestrator.orchestrator import Orchestrator
from katib_tpu_torch.orchestrator.resume import experiment_from_dict as t_from_dict
from katib_tpu_torch.orchestrator.status import read_status as t_read_status
from katib_tpu_torch.parallel.distributed import SliceAllocator
from katib_tpu_torch.parallel.mesh import make_mesh
from katib_tpu_torch.runner.cohort import COHORT_ATTR
from katib_tpu_torch.runner.trial_runner import run_trial
from katib_tpu_torch.store.base import MemoryObservationStore
from katib_tpu_torch.suggest.base import SuggesterError
from katib_tpu_torch.utils import faults
from tests.torch_compile_state import fresh_compile_state  # noqa: F401  (fixture)

PKGS = {
    "jax": SimpleNamespace(types=jtypes, journal=jjournal, fsck=j_fsck,
                           read_status=j_read_status, from_dict=j_from_dict,
                           make=lambda **kw: JOrchestrator(**kw)),
    "torch": SimpleNamespace(types=ttypes, journal=tjournal, fsck=t_fsck,
                             read_status=t_read_status, from_dict=t_from_dict,
                             make=lambda **kw: Orchestrator(device="cpu", **kw)),
}
CLOCK_KEYS = {"start_time", "completion_time", "time", "elapsed_s", "generated_at"}


def quadratic_trainer(ctx):
    """accuracy peaks at x=2, improves over 3 steps
    (``tests/test_runner_orchestrator.py::quadratic_trainer``, shortened)."""
    x = float(ctx.params["x"])
    final = 1.0 - 0.1 * (x - 2.0) ** 2
    for step in range(3):
        if not ctx.report(accuracy=final * (step + 1) / 3, step=step):
            return


def seeded_hex(seed: int = 7):
    rng = random.Random(seed)
    return lambda n: "%0*x" % (2 * n, rng.getrandbits(8 * n))


def grid_spec(pkg: str, name: str, **kw):
    t = PKGS[pkg].types
    kw.setdefault("parallel_trial_count", 1)
    kw.setdefault("max_trial_count", 5)
    kw.setdefault("train_fn", quadratic_trainer)
    return t.ExperimentSpec(
        name=name,
        objective=t.ObjectiveSpec(type=t.ObjectiveType.MAXIMIZE, objective_metric_name="accuracy"),
        algorithm=t.AlgorithmSpec(name=kw.pop("algorithm", "grid"),
                                  settings=kw.pop("algorithm_settings", {})),
        parameters=[t.ParameterSpec("x", t.ParameterType.DOUBLE,
                                    t.FeasibleSpace(min=0.0, max=4.0, step=1.0))],
        async_orch=kw.pop("async_orch", False),
        **kw,
    )


def without_clock(value, workdir: str):
    """``value`` with the clock fields dropped and the workdir made relative."""
    if isinstance(value, dict):
        return {k: without_clock(v, workdir) for k, v in value.items() if k not in CLOCK_KEYS}
    if isinstance(value, list):
        return [without_clock(v, workdir) for v in value]
    if isinstance(value, str):
        return value.replace(workdir, "<workdir>")
    return value


def record_journal_kinds(monkeypatch, pkg: str) -> list[str]:
    """Spy on the package's journal: the kind of every record appended."""
    cls = PKGS[pkg].journal.ExperimentJournal
    kinds: list[str] = []
    append, append_group = cls.append, cls.append_group

    def spy_append(self, event, *args, **kw):
        kinds.append(event)
        return append(self, event, *args, **kw)

    def spy_group(self, records, *args, **kw):
        records = list(records)
        kinds.extend(r[0] for r in records)
        return append_group(self, records, *args, **kw)

    monkeypatch.setattr(cls, "append", spy_append)
    monkeypatch.setattr(cls, "append_group", spy_group)
    return kinds


def run_grid(pkg: str, workdir: str, monkeypatch, **kw):
    kinds = record_journal_kinds(monkeypatch, pkg)
    spec = grid_spec(pkg, "grid-parity", **kw)
    exp = PKGS[pkg].make(workdir=workdir, token_hex=seeded_hex()).run(spec)
    trials = {
        name: (
            t.params(),
            t.condition.value,
            [(m.name, m.value, m.min, m.max, m.latest) for m in t.observation.metrics],
        )
        for name, t in exp.trials.items()
    }
    status = without_clock(PKGS[pkg].read_status(workdir, spec.name), workdir)
    return SimpleNamespace(
        condition=exp.condition.value, trials=trials, kinds=kinds, status=status,
        optimal=(exp.optimal.trial_name, exp.optimal.objective_value),
        dir=os.path.join(workdir, spec.name),
    )


def test_grid_experiment_matches_the_jax_orchestrator(tmp_path, monkeypatch):
    jax_run = run_grid("jax", str(tmp_path / "jax"), monkeypatch)
    port_run = run_grid("torch", str(tmp_path / "torch"), monkeypatch)
    assert port_run.condition == jax_run.condition == "MaxTrialsReached"
    assert port_run.trials == jax_run.trials
    assert port_run.optimal == jax_run.optimal
    assert port_run.kinds == jax_run.kinds
    assert port_run.status == jax_run.status
    # the formats are copies: each fsck reads the other's directory clean
    for fsck, run in ((j_fsck, port_run), (t_fsck, jax_run), (t_fsck, port_run)):
        report = fsck(run.dir, repair=False)
        assert report.ok(), report.lines()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_parallel_grid_runs_every_point_once(pkg, tmp_path, monkeypatch):
    run = run_grid(pkg, str(tmp_path), monkeypatch, parallel_trial_count=3)
    assert sorted(a["x"] for a, _, _ in run.trials.values()) == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert run.optimal[1] == pytest.approx(1.0)
    assert all(cond == "Succeeded" for _, cond, _ in run.trials.values())


def resume_scenarios(pkg: str, root: str) -> dict:
    """``tests/test_resume.py``'s reconstruction, orphan and Never scenarios
    on one package; returns what the two packages must agree on."""
    t = PKGS[pkg].types
    out = {}
    # reconstruction of a completed experiment from status.json
    wd = os.path.join(root, "rt")
    spec = grid_spec(pkg, "rt-exp", resume_policy=t.ResumePolicy.FROM_VOLUME)
    exp = PKGS[pkg].make(workdir=wd, token_hex=seeded_hex()).run(spec)
    rebuilt = PKGS[pkg].from_dict(spec, PKGS[pkg].read_status(wd, "rt-exp"))
    assert rebuilt.condition is exp.condition
    assert set(rebuilt.trials) == set(exp.trials)
    assert rebuilt.optimal.trial_name == exp.optimal.trial_name
    assert rebuilt.optimal_history == exp.optimal_history
    out["rebuilt"] = (rebuilt.condition.value, sorted(rebuilt.trials),
                      rebuilt.optimal.trial_name, rebuilt.succeeded_count)
    # an orphaned in-flight trial reruns under its name, using no extra slot
    wd = os.path.join(root, "orphan")
    spec = grid_spec(pkg, "orphan-exp", max_trial_count=3,
                     resume_policy=t.ResumePolicy.FROM_VOLUME)
    exp = PKGS[pkg].make(workdir=wd, token_hex=seeded_hex()).run(spec)
    victim = sorted(exp.trials)[0]
    status = PKGS[pkg].read_status(wd, "orphan-exp")
    status["trials"][victim]["condition"] = "Running"
    status["trials"][victim]["observation"] = None
    status["condition"] = "Running"
    rebuilt = PKGS[pkg].from_dict(spec, status)
    assert rebuilt.trials[victim].condition is t.TrialCondition.PENDING
    resumed = PKGS[pkg].make(workdir=wd, token_hex=seeded_hex(8)).run(spec, experiment=rebuilt)
    assert resumed.trials[victim].condition is t.TrialCondition.SUCCEEDED
    assert len(resumed.trials) == 3
    out["orphan"] = (resumed.condition.value, sorted(resumed.trials),
                     resumed.trials[victim].observation.metrics[0].value)
    # Never refuses to reopen a terminal experiment
    wd = os.path.join(root, "never")
    spec = grid_spec(pkg, "never-exp", max_trial_count=2, resume_policy=t.ResumePolicy.NEVER)
    PKGS[pkg].make(workdir=wd).run(spec)
    with pytest.raises(RuntimeError, match="Never"):
        PKGS[pkg].make(workdir=wd).run(spec, resume=True)
    return out


def test_resume_matches_the_jax_package(tmp_path):
    assert resume_scenarios("torch", str(tmp_path / "torch")) == resume_scenarios(
        "jax", str(tmp_path / "jax"))


def drain_scenario(pkg: str, workdir: str) -> dict:
    """``tests/test_watchdog_drain.py::test_drain_checkpoints_journal_and_resume_continues``
    on one package: drain while the first trial holds after step 0, then
    resume; the drained trial continues from its checkpointed step."""
    t = PKGS[pkg].types
    release, gate_open = threading.Event(), threading.Event()
    starts: list[int] = []
    reported: dict[str, list[int]] = {}

    def trainer(ctx):
        os.makedirs(ctx.checkpoint_dir, exist_ok=True)
        marker = os.path.join(ctx.checkpoint_dir, "progress.txt")
        start = 0
        if os.path.exists(marker):
            with open(marker) as f:
                start = int(f.read().strip() or 0)
        starts.append(start)
        for step in range(start, 4):
            cont = ctx.report(step=step, accuracy=(step + 1) / 4.0)
            reported.setdefault(ctx.checkpoint_dir, []).append(step)
            with open(marker, "w") as f:
                f.write(str(step + 1))
            if not cont:
                return
            if step == 0 and start == 0:
                gate_open.set()
                while not release.is_set() and not ctx.should_stop():
                    time.sleep(0.005)

    spec = grid_spec(pkg, "drain-resume", train_fn=trainer, max_trial_count=1,
                     resume_policy=t.ResumePolicy.LONG_RUNNING, drain_grace_seconds=10.0)
    orch = PKGS[pkg].make(workdir=workdir, token_hex=seeded_hex())
    runner = threading.Thread(target=lambda: orch.run(spec))
    runner.start()
    assert gate_open.wait(timeout=30)
    orch.drain()
    runner.join(timeout=30)
    assert not runner.is_alive() and orch.drained
    status = PKGS[pkg].read_status(workdir, "drain-resume")
    drained = sorted(n for n, d in status["trials"].items() if d["condition"] == "Drained")
    assert drained and status["counts"]["drained"] == len(drained)
    release.set()
    orch2 = PKGS[pkg].make(workdir=workdir, token_hex=seeded_hex(8))
    exp2 = orch2.run(spec, experiment=orch2.load_experiment(spec))
    assert all(tr.condition is t.TrialCondition.SUCCEEDED for tr in exp2.trials.values())
    return {
        "drained": drained,
        "condition": exp2.condition.value,
        "starts": starts,
        "reported": sorted(reported.values()),
        "optimal": (exp2.optimal.trial_name, exp2.optimal.objective_value),
        "fsck": PKGS[pkg].fsck(os.path.join(workdir, "drain-resume"), repair=False).ok(),
    }


def test_drain_and_resume_match_the_jax_package(tmp_path):
    got = drain_scenario("torch", str(tmp_path / "torch"))
    assert got == drain_scenario("jax", str(tmp_path / "jax"))
    # drained at the report of step 1 (the first after the drain), resumed
    # at step 2: each step reported once
    assert got["starts"] == [0, 2] and got["reported"] == [[0, 1, 2, 3]] and got["fsck"]


def _refused(tmp_path, match, orch_kw=None, env=None, monkeypatch=None,
             error=NotImplementedError, **spec_kw):
    for key, value in (env or {}).items():
        monkeypatch.setenv(key, value)
    spec = grid_spec("torch", "refused", **spec_kw)
    orch = Orchestrator(workdir=str(tmp_path), device="cpu", **(orch_kw or {}))
    with pytest.raises(error, match=match):
        orch.run(spec)
    status = t_read_status(str(tmp_path), "refused")
    if "mesh" in match:
        # as in the JAX package, a mesh is resolved after the experiment is
        # journaled, and settles it Failed before the error surfaces
        assert status["condition"] == "Failed" and "mesh" in status["message"]
    else:
        # refused before anything was journaled
        assert status is None


def _with_attr(attr):
    def fn(ctx):
        quadratic_trainer(ctx)

    setattr(fn, attr, lambda *a, **kw: None)
    return fn


REFUSALS = {
    # meshes and slice leases are ported: an orchestrator mesh, the config's
    # mesh axes (over CPU entries on a CPU orchestrator) and a fixed slice
    # allocator run; a trial axis (sharded cohorts) still raises
    "orchestrator-mesh": dict(match=None, orch_kw={
        "mesh": make_mesh({"data": 2}, devices=["cpu"] * 2)}),
    "config-mesh": dict(match=None, orch_kw={
        "config": KatibConfig.from_dict({"init": {"mesh_axes": {"data": 2}}})}),
    "trial-axis-mesh": dict(match="trial axis .* mesh", orch_kw={
        "mesh": make_mesh({"trial": 2}, devices=["cpu"] * 2)}),
    # vectorized cohorts are ported: a declared twin and a width run (the
    # keyless proposals stay singletons, as in the JAX package)
    "cohort": dict(match=None, cohort_width=2, train_fn=_with_attr(COHORT_ATTR)),
    # the compile half is ported: a declared prewarm twin runs on the worker,
    # and the compile cache and artifact tier are wired (<tmp> is the
    # test's temporary directory)
    "prewarm": dict(match=None, train_fn=_with_attr(PREWARM_ATTR)),
    "compile-cache-spec": dict(match=None, compile_cache="<tmp>/cc"),
    "compile-cache-env": dict(match=None, env={"KATIB_COMPILE_CACHE": "<tmp>/cc"}),
    "artifact-dir-spec": dict(match=None, artifact_dir="<tmp>/art"),
    "artifact-dir-env": dict(match=None, env={"KATIB_ARTIFACT_DIR": "<tmp>/art"}),
    # black-box command: trials are ported: the spec runs to its end
    "command-trials": dict(match=None, train_fn=None,
                           command=[sys.executable, "-c", "print('accuracy=0.5')"],
                           metrics_collector=ttypes.MetricsCollectorSpec(
                               kind=ttypes.MetricsCollectorKind.STDOUT)),
    "slice-allocator": dict(match=None, orch_kw={
        "slice_allocator": SliceAllocator(1, devices=["cpu"] * 2)}),
    # the profiler is ported: a trial is traced into its checkpoint dir
    "profiler": dict(match=None, orch_kw={
        "config": KatibConfig.from_dict({"init": {"enable_profiler": True}})}),
    # the remote suggester is ported: what it refuses is the JAX package's
    # refusal of pbt behind a service, before anything is journaled
    "unported-suggester": dict(match="share a filesystem", algorithm="remote",
                               algorithm_settings={"endpoint": "http://127.0.0.1:9",
                                                   "algorithm": "pbt"},
                               error=SuggesterError, async_orch=False),
}


def _lifted(case, kw, tmp_path, monkeypatch):
    """A case the port no longer lacks runs as in the JAX package, with the
    effect of its setting."""
    from katib_tpu_torch.compile.artifacts import ARTIFACTS
    from katib_tpu_torch.compile.registry import REGISTRY

    def here(value):
        return value.replace("<tmp>", str(tmp_path)) if isinstance(value, str) else value

    for key, value in kw.pop("env", {}).items():
        monkeypatch.setenv(key, here(value))
    orch_kw = kw.pop("orch_kw", {})
    spec = grid_spec("torch", "lifted", max_trial_count=2,
                     **{k: here(v) for k, v in kw.items()})
    orch = Orchestrator(workdir=str(tmp_path / "runs"), device="cpu", **orch_kw)
    exp = orch.run(spec)
    assert exp.succeeded_count == 2, exp.message
    if case == "slice-allocator":  # every lease went back
        assert orch.slice_allocator.available() == orch.slice_allocator.n_slices == 2
    if case == "prewarm":
        # the worker took the group's signature (the twin, or a trial that
        # got there first, warmed it) and nothing failed
        assert orch.prewarm_stats["failed"] == 0
        assert spec.train_fn.__qualname__ in [s["program"] for s in REGISTRY.signatures()]
    if case.startswith("compile-cache"):
        # the port's own registry file, not the JAX package's
        assert (tmp_path / "cc" / "torch" / "shape_registry.jsonl").is_file()
        assert not (tmp_path / "cc" / "shape_registry.jsonl").exists()
    if case.startswith("artifact-dir"):
        assert ARTIFACTS.shared_dir() == str(tmp_path / "art")
    if case == "profiler":  # one trial at a time holds the profiler
        traced = [t for t in exp.trials.values()
                  if os.path.isfile(os.path.join(t.checkpoint_dir, "profile", "trace.json"))]
        assert traced


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_what_the_port_lacks_raises(case, tmp_path, fresh_compile_state):
    monkeypatch = fresh_compile_state
    monkeypatch.delenv("KATIB_ASYNC_ORCH", raising=False)
    kw = dict(REFUSALS[case])
    if kw["match"] is None:  # no longer lacking: it runs as in the JAX package
        kw.pop("match")
        _lifted(case, kw, tmp_path, monkeypatch)
        return
    _refused(tmp_path, monkeypatch=monkeypatch, **kw)


def test_twins_absent_prewarm_and_cohort_width_run_as_in_the_jax_package(tmp_path):
    """The JAX orchestrator engages its prewarmer and cohorts only for a
    train_fn that declares the twin; elsewhere ``prewarm`` (on by default)
    and ``cohortWidth`` change nothing, and the port runs too."""
    spec = grid_spec("torch", "plain", prewarm=True, cohort_width=2, max_trial_count=2)
    exp = Orchestrator(workdir=str(tmp_path), device="cpu").run(spec)
    assert exp.succeeded_count == 2


def test_env_escape_hatch_selects_the_synchronous_loop(tmp_path, monkeypatch):
    monkeypatch.setenv("KATIB_ASYNC_ORCH", "0")
    spec = grid_spec("torch", "hatch", async_orch=None, max_trial_count=2)
    assert Orchestrator(workdir=str(tmp_path), device="cpu").run(spec).succeeded_count == 2


def test_orchestrator_runs_on_cuda_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Orchestrator()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        KatibConfig().make_orchestrator()
    assert Orchestrator(device="cpu").device == torch.device("cpu")


def test_trials_get_the_orchestrators_device(tmp_path):
    seen = []

    def trainer(ctx):
        seen.append(ctx.device)
        ctx.report(step=0, accuracy=1.0)

    spec = grid_spec("torch", "dev", train_fn=trainer, max_trial_count=1)
    Orchestrator(workdir=str(tmp_path), device="cpu").run(spec)
    assert seen == [torch.device("cpu")]


def _trial(**spec_kw):
    return ttypes.Trial(name="t", experiment_name="e",
                        spec=ttypes.TrialSpec(assignments=[], **spec_kw))


def test_run_trial_settles_command_trials_and_meshes_failed():
    obj = ttypes.ObjectiveSpec(type=ttypes.ObjectiveType.MAXIMIZE, objective_metric_name="a")
    res = run_trial(_trial(command=[sys.executable, "-c", "raise SystemExit(2)"]),
                    MemoryObservationStore(), obj)
    assert res.condition is ttypes.TrialCondition.FAILED and "exit code 2" in res.message
    res = run_trial(_trial(command=["echo"]), MemoryObservationStore(), obj, mesh=object())
    assert res.condition is ttypes.TrialCondition.FAILED and "mesh" in res.message
    res = run_trial(_trial(train_fn=lambda ctx: None), MemoryObservationStore(), obj, mesh=object())
    assert res.condition is ttypes.TrialCondition.FAILED and "mesh" in res.message


@pytest.mark.parametrize("text", [
    "CUDA error: uncorrectable ECC error encountered",
    "CUDA error: GPU is lost",
    "Unable to determine the device handle for GPU0000:00:00.0: GPU has fallen off the bus.",
])
def test_cuda_device_faults_classify_as_device(text):
    assert faults.classify_exception(RuntimeError(text)) is faults.FailureKind.DEVICE


def test_cuda_out_of_memory_classifies_as_transient():
    err = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    assert faults.classify_exception(err) is faults.FailureKind.TRANSIENT
