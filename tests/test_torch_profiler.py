"""The port's profiler (``katib_tpu_torch/costmodel/profiler.py``), the
``profile`` verb and ``init.enable_profiler``, against the JAX package's
(``tests/test_costmodel.py::TestProfiler`` and its CLI cases are the
models).  Both packages run on the CPU here: the port's captures record
CPU activity only, the JAX package's write an xprof trace; what is held
equal is the registry, the discovery (``scan_profiles`` and ``profile
--list``), the verbs' exit codes and which trials get traced."""

from __future__ import annotations

import json
import os
import threading

import pytest
import torch

from katib_tpu.cli import main as j_main
from katib_tpu.costmodel import profiler as j_profiler
from katib_tpu_torch.cli import main
from katib_tpu_torch.costmodel import profiler
from katib_tpu_torch.nas.darts import step_loop
from tests.torch_compile_state import fresh_compile_state  # noqa: F401  (fixture)

# tier-1 runs six test processes on the same cores: one torch thread each
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREWARM_YAML = os.path.join(ROOT, "examples", "hp-tuning", "cohort-prewarm.yaml")
DARTS_YAML = os.path.join(ROOT, "examples", "nas", "darts.yaml")


@pytest.fixture(autouse=True)
def _fresh_registries():
    profiler.reset()
    j_profiler.reset()
    yield
    profiler.reset()
    j_profiler.reset()


def _events(trace_dir: str) -> list[dict]:
    with open(os.path.join(trace_dir, profiler.TRACE_FILE)) as f:
        return json.load(f)["traceEvents"]


# -- capture and the registry --------------------------------------------------


def test_capture_registers_and_writes(tmp_path):
    out = tmp_path / "exp" / "t0" / "profile"
    with profiler.capture(str(out), trial="t0", experiment="exp", device="cpu") as d:
        assert d == str(out)
        torch.ones(8, 16) @ torch.ones(16, 16)
    entries = profiler.list_profiles()
    assert len(entries) == 1 and entries[0]["trial"] == "t0"
    assert entries[0]["experiment"] == "exp" and entries[0]["trace_dir"] == str(out)
    assert os.path.isdir(out)
    # the JAX registry's entry has the same keys
    import jax.numpy as jnp

    with j_profiler.capture(str(tmp_path / "j"), trial="t0", experiment="exp"):
        (jnp.ones((8, 16)) @ jnp.ones((16, 16))).block_until_ready()
    assert set(j_profiler.list_profiles()[0]) == set(entries[0])


def test_capture_on_the_cpu_records_cpu_activity_only(tmp_path):
    with profiler.capture(str(tmp_path), device="cpu"):
        torch.ones(8, 16) @ torch.ones(16, 16)
    events = _events(str(tmp_path))
    assert any(e.get("name") == "aten::mm" for e in events)
    assert not any(e.get("cat") in ("kernel", "gpu_memcpy", "cuda_runtime") for e in events)


def test_registry_keeps_the_last_64_captures(tmp_path):
    for i in range(70):
        profiler.register_profile(str(tmp_path / str(i)), trial=f"t{i}")
        j_profiler.register_profile(str(tmp_path / str(i)), trial=f"t{i}")
    assert [e["trial"] for e in profiler.list_profiles()] == [
        e["trial"] for e in j_profiler.list_profiles()] == [f"t{i}" for i in range(6, 70)]


def test_a_nested_capture_raises(tmp_path):
    with profiler.capture(str(tmp_path / "outer"), device="cpu"):
        with pytest.raises(profiler.ProfilerBusy, match="do not nest"):
            with profiler.capture(str(tmp_path / "inner"), device="cpu"):
                pass
    # the outer capture is written, the refused one is not registered
    assert os.path.isfile(tmp_path / "outer" / profiler.TRACE_FILE)
    assert [e["trace_dir"] for e in profiler.list_profiles()] == [str(tmp_path / "outer")]
    with profiler.capture(str(tmp_path / "after"), device="cpu"):
        pass  # the profiler is free again


def test_a_capture_runs_on_cuda_unless_told_otherwise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        with profiler.capture(str(tmp_path)):
            pass
    assert profiler.list_profiles() == []


def test_a_card_capture_starts_and_stops_under_the_capture_lock(tmp_path, monkeypatch):
    """On a CUDA device the profiler starts and stops holding the device's
    capture lock, so it never begins or ends inside another thread's graph
    capture; the traced body runs without it."""
    import torch.profiler as tprof

    lock = step_loop.capture_lock(torch.device("cuda", 0))
    seen = []

    class Recorder:
        def __init__(self, activities):
            seen.append(("activities", sorted(a.name for a in activities)))

        def start(self):
            seen.append(("start", lock.locked()))

        def stop(self):
            seen.append(("stop", lock.locked()))

        def export_chrome_trace(self, path):
            seen.append(("export", lock.locked()))

    monkeypatch.setattr(tprof, "profile", Recorder)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with profiler.capture(str(tmp_path), trial="t", device="cuda:0"):
        seen.append(("body", lock.locked()))
    assert seen == [("activities", ["CPU", "CUDA"]), ("start", True), ("body", False),
                    ("stop", True), ("export", False)]


def test_a_capture_waits_for_a_graph_capture_in_progress(tmp_path, monkeypatch):
    """A thread holding the capture lock (a graph capture) delays the
    profiler's start until it lets go."""
    import torch.profiler as tprof

    lock = step_loop.capture_lock(torch.device("cuda", 0))
    started = threading.Event()

    class Recorder:
        def __init__(self, activities):
            pass

        def start(self):
            started.set()

        def stop(self):
            pass

        def export_chrome_trace(self, path):
            pass

    monkeypatch.setattr(tprof, "profile", Recorder)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def run():
        with profiler.capture(str(tmp_path), device="cuda:0"):
            pass

    with lock:
        worker = threading.Thread(target=run)
        worker.start()
        assert not started.wait(0.3)
    worker.join(timeout=30)
    assert not worker.is_alive() and started.is_set()


# -- discovery -----------------------------------------------------------------


def _strip(entries: list[dict], root) -> list[dict]:
    return [{**e, "trace_dir": os.path.relpath(e["trace_dir"], root)} for e in entries]


def test_scan_profiles_finds_trial_dirs(tmp_path):
    os.makedirs(tmp_path / "exp-a" / "trial-3" / "profile")
    os.makedirs(tmp_path / "exp-a" / "trial-4")  # no capture
    entries = profiler.scan_profiles(str(tmp_path))
    assert [e["trial"] for e in entries] == ["trial-3"]
    assert entries[0]["experiment"] == "exp-a" and entries[0]["source"] == "filesystem"
    assert entries == j_profiler.scan_profiles(str(tmp_path))


def test_scan_profiles_reads_journal_spans(tmp_path):
    from katib_tpu_torch.utils import tracing

    expdir = tmp_path / "exp-b"
    os.makedirs(expdir)
    rec = {"name": profiler.PROFILE_SPAN, "ts": 0.0, "dur": 1.0, "wall": 12.5,
           "args": {"trial": "t7", "trace_dir": str(tmp_path / "elsewhere")}}
    other = {"name": "trial", "ts": 0.0, "dur": 1.0, "args": {"trial": "t7"}}
    (expdir / tracing.TRACE_FILE).write_text(json.dumps(other) + "\n" + json.dumps(rec) + "\n")
    entries = profiler.scan_profiles(str(tmp_path))
    assert entries == [{"trace_dir": str(tmp_path / "elsewhere"), "experiment": "exp-b",
                        "source": "journal", "trial": "t7", "wall": 12.5}]
    assert entries == j_profiler.scan_profiles(str(tmp_path))


def test_profile_list_matches_the_jax_verb(tmp_path, capsys):
    from katib_tpu_torch.utils import tracing

    os.makedirs(tmp_path / "exp-a" / "t1" / "profile")
    os.makedirs(tmp_path / "exp-b")
    rec = {"name": profiler.PROFILE_SPAN, "ts": 0.0, "dur": 1.0,
           "args": {"trial": "t9", "trace_dir": str(tmp_path / "exp-b" / "t9" / "profile")}}
    (tmp_path / "exp-b" / tracing.TRACE_FILE).write_text(json.dumps(rec) + "\n")
    assert main(["profile", "--list", "--workdir", str(tmp_path)]) == 0
    port = capsys.readouterr().out
    assert j_main(["profile", "--list", "--workdir", str(tmp_path)]) == 0
    assert port == capsys.readouterr().out
    assert "exp-a" in port and "t9" in port and "journal" in port


# -- the profile verb ----------------------------------------------------------


def test_profile_list_empty_ok(tmp_path, capsys):
    assert main(["profile", "--list", "--workdir", str(tmp_path)]) == 0
    assert "no profiler captures" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [[], ["--workdir", "x"]], ids=["bare", "workdir-only"])
def test_profile_without_target_is_usage_error(argv, capsys):
    assert main(["profile", *argv]) == 2 == j_main(["profile", *argv])
    assert "--list" in capsys.readouterr().err


def test_profile_of_a_spec_without_a_twin_exits_2(tmp_path, capsys):
    """DARTS declares no prewarm twin in either package."""
    argv = ["profile", DARTS_YAML, "--workdir", str(tmp_path)]
    assert main([*argv, "--device", "cpu"]) == 2 == j_main(argv)
    assert "no prewarm twin" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def test_profile_runs_on_cuda_unless_told_otherwise(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["profile", PREWARM_YAML, "--workdir", str(tmp_path)]) == 2
    assert "no CUDA GPU" in capsys.readouterr().err
    assert profiler.list_profiles() == []


@pytest.fixture
def compile_dirs(tmp_path, fresh_compile_state):
    """The spec's compile cache and artifact dir (under ``/tmp``) moved
    under ``tmp_path`` for both packages (``KATIB_COMPILE_CACHE`` and
    ``KATIB_ARTIFACT_DIR`` win over the spec); the JAX package's
    process-global compile-cache wiring starts unwired and is put back
    after, as ``tests/test_torch_examples.py::compile_dirs`` does."""
    import jax

    from katib_tpu.compile import artifacts as jart
    from katib_tpu.runner import trial_runner as jrunner

    monkeypatch = fresh_compile_state
    old = {key: getattr(jax.config, key) for key in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    monkeypatch.setattr(jrunner, "_COMPILE_CACHE_DIR", None)
    monkeypatch.setenv("KATIB_COMPILE_CACHE", str(tmp_path / "cc"))
    monkeypatch.setenv("KATIB_ARTIFACT_DIR", str(tmp_path / "art"))
    yield
    jart.ARTIFACTS.reset()
    for key, value in old.items():
        jax.config.update(key, value)
    from jax._src import compilation_cache

    compilation_cache.reset_cache()


def test_profile_runs_the_prewarm_twin_where_the_jax_verb_does(tmp_path, capsys, compile_dirs):
    """``profile cohort-prewarm.yaml``: the twin (``mnist_prewarm``) runs
    under the profiler into ``<workdir>/<experiment>/adhoc/profile``, named
    by the closing line and listed by ``--list`` as the JAX verb's capture
    is (the JAX verb writes into a workdir of its own)."""
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    assert main(["profile", PREWARM_YAML, "--workdir", str(port_dir), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    trace = port_dir / "cohort-prewarm-example" / "adhoc" / "profile" / profiler.TRACE_FILE
    assert f"profiler trace: {trace}" in out and "Chrome trace" in out and "xprof" not in out
    names = {e.get("name") for e in _events(str(trace.parent))}
    assert "aten::addmm" in names or "aten::mm" in names  # the twin's steps ran traced
    assert j_main(["profile", PREWARM_YAML, "--workdir", str(jax_dir)]) == 0
    capsys.readouterr()
    assert _strip(profiler.scan_profiles(str(port_dir)), port_dir) == _strip(
        j_profiler.scan_profiles(str(jax_dir)), jax_dir)
    assert [(e["experiment"], e["trial"]) for e in profiler.list_profiles()] == [
        (e["experiment"], e["trial"]) for e in j_profiler.list_profiles()] == [
        ("cohort-prewarm-example", "adhoc")]


# -- enable_profiler -----------------------------------------------------------


def _two_trial_spec(types, barrier: threading.Barrier):
    t = types

    def trainer(ctx):
        # both trials are inside their train_fn at once, so exactly one of
        # them holds the profiler (the other's non-blocking acquire failed)
        barrier.wait(timeout=60)
        ctx.report(step=0, accuracy=float(ctx.params["x"]))

    return t.ExperimentSpec(
        name="prof-x",
        algorithm=t.AlgorithmSpec(name="grid"),
        objective=t.ObjectiveSpec(type=t.ObjectiveType.MAXIMIZE,
                                  objective_metric_name="accuracy"),
        parameters=[t.ParameterSpec("x", t.ParameterType.CATEGORICAL,
                                    t.FeasibleSpace(list=["0.25", "0.75"]))],
        max_trial_count=2,
        parallel_trial_count=2,
        train_fn=trainer,
    )


def test_enable_profiler_traces_one_of_two_parallel_trials_as_the_jax_package(tmp_path):
    """``init.enable_profiler`` with two trials running at once, in both
    packages: one trial traced into ``<checkpoint_dir>/profile`` (its
    capture registered and bracketed by a ``profile.capture`` span), the
    other run unprofiled, both ``Succeeded``."""
    from katib_tpu.core import types as jt
    from katib_tpu.core.config import KatibConfig as JConfig
    from katib_tpu.orchestrator.orchestrator import Orchestrator as JOrchestrator
    from katib_tpu_torch.core import types as tt
    from katib_tpu_torch.core.config import KatibConfig
    from katib_tpu_torch.orchestrator.orchestrator import Orchestrator

    found = {}
    for label, types, make in (
        ("jax", jt, lambda w: JOrchestrator(workdir=w, config=JConfig.from_dict(
            {"init": {"enable_profiler": True}}))),
        ("torch", tt, lambda w: Orchestrator(workdir=w, device="cpu", config=KatibConfig.from_dict(
            {"init": {"enable_profiler": True}}))),
    ):
        workdir = str(tmp_path / label)
        exp = make(workdir).run(_two_trial_spec(types, threading.Barrier(2)))
        assert [t.condition.value for t in exp.trials.values()] == ["Succeeded"] * 2, exp.message
        traced = [t.name for t in exp.trials.values()
                  if os.path.isdir(os.path.join(t.checkpoint_dir, "profile"))]
        assert len(traced) == 1, traced
        entries = (profiler if label == "torch" else j_profiler).scan_profiles(workdir)
        assert [e["trial"] for e in entries] == traced
        registered = (profiler if label == "torch" else j_profiler).list_profiles()
        assert [e["trial"] for e in registered] == traced
        found[label] = [{k: v for k, v in e.items() if k not in ("trace_dir", "trial", "wall")}
                        for e in entries]
    assert found["torch"] == found["jax"] == [{"experiment": "prof-x", "source": "filesystem"}]
    (traced,) = [e for e in profiler.scan_profiles(str(tmp_path / "torch"))]
    assert os.path.isfile(os.path.join(traced["trace_dir"], profiler.TRACE_FILE))
    with open(tmp_path / "torch" / "prof-x" / "trace.jsonl") as f:
        spans = [json.loads(line) for line in f]
    (span,) = [s for s in spans if s["name"] == profiler.PROFILE_SPAN]
    assert span["args"]["trace_dir"] == traced["trace_dir"]


def test_a_failed_capture_fails_the_trial_not_the_run(tmp_path, monkeypatch):
    """As in the JAX orchestrator, an error around the profiled attempt
    settles that trial ``Failed`` and the experiment goes on."""
    from katib_tpu_torch.core import types as tt
    from katib_tpu_torch.core.config import KatibConfig
    from katib_tpu_torch.orchestrator.orchestrator import Orchestrator

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(profiler, "register_profile", broken)
    orch = Orchestrator(workdir=str(tmp_path), device="cpu", config=KatibConfig.from_dict(
        {"init": {"enable_profiler": True}}))
    spec = _two_trial_spec(tt, threading.Barrier(1))
    spec.parallel_trial_count = 1
    spec.max_failed_trial_count = 5
    exp = orch.run(spec)
    conditions = [t.condition.value for t in exp.trials.values()]
    assert conditions == ["Failed", "Failed"], conditions
    assert all("disk full" in t.message for t in exp.trials.values())
