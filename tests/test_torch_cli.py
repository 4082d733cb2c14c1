"""``python -m katib_tpu_torch run|fsck|doctor`` on the CPU: the shipped
DARTS spec, cut to a tiny size through its own algorithm settings, runs to
its successful end through the port's loader, orchestrator, suggester,
trial runner and ``darts_trial``; a drain after epoch 0 exits 75 and
``--resume`` continues at epoch 1.  Every run is a fresh interpreter, as
the card needs (a process that has initialised CUDA cannot fork one that
uses it).

This module imports no JAX at module level: the drain test's child process
imports :func:`gated_darts_trial` from it."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch
import yaml

from katib_tpu_torch.cli import UNPORTED_VERBS, main
from katib_tpu_torch.core.types import Experiment
from katib_tpu_torch.nas.darts.search import darts_trial
from katib_tpu_torch.orchestrator.status import read_status
from katib_tpu_torch.sdk.yaml_spec import load_experiment_yaml
from katib_tpu_torch.store.sqlite import SqliteObservationStore
from katib_tpu_torch.suggest.base import make_suggester
from tests.torch_compile_state import fresh_compile_state  # noqa: F401  (fixture)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DARTS_YAML = os.path.join(ROOT, "examples", "nas", "darts.yaml")
TINY = {"n_train": "16", "n_test": "8", "init_channels": "2"}
EXPERIMENT = "darts-example"


def tiny_spec(path, train_fn: str | None = None) -> str:
    """A copy of ``darts.yaml`` with ``TINY`` in its algorithm settings
    (and, for the drain test, another trainFn)."""
    with open(DARTS_YAML) as f:
        doc = yaml.safe_load(f)
    settings = doc["spec"]["algorithm"]["algorithmSettings"]
    doc["spec"]["algorithm"]["algorithmSettings"] = [
        s for s in settings if s["name"] not in TINY
    ] + [{"name": k, "value": v} for k, v in TINY.items()]
    if train_fn is not None:
        doc["spec"]["trialTemplate"]["trainFn"] = train_fn
    path.write_text(yaml.safe_dump(doc))
    return str(path)


def gated_darts_trial(ctx):
    """``darts_trial`` whose report of epoch 0 holds until the orchestrator
    drains (at most two minutes): the drain lands after epoch 0 whatever the
    host's speed."""
    report = ctx.report

    def gated(step=None, **metrics):
        cont = report(step, **metrics)
        deadline = time.monotonic() + 120
        while step == 0 and cont and not ctx.should_stop() and time.monotonic() < deadline:
            time.sleep(0.01)
        return cont and not ctx.should_stop()

    ctx.report = gated
    darts_trial(ctx)


def sqlite_config(tmp_path, workdir: str) -> str:
    """A ``KatibConfig`` whose observation store is the sqlite file in the
    workdir, so the reported series outlive each process."""
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump({"store": {
        "backend": "sqlite", "path": os.path.join(workdir, "observations.sqlite")}}))
    return str(path)


def cli(*args, **kw) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    return subprocess.Popen([sys.executable, "-m", "katib_tpu_torch", *args], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, **kw)


def finish(proc: subprocess.Popen, timeout: float = 240) -> tuple[int, str, str]:
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return proc.returncode, out, err


def accuracy_steps(workdir: str, trial: str) -> list[int]:
    store = SqliteObservationStore(os.path.join(workdir, "observations.sqlite"))
    try:
        return sorted(log.step for log in store.get(trial, "accuracy"))
    finally:
        store.close()


def test_darts_spec_runs_through_the_cli_and_fscks_clean(tmp_path):
    workdir = str(tmp_path / "runs")
    os.makedirs(workdir)
    rc, out, err = finish(cli("--config", sqlite_config(tmp_path, workdir), "run",
                              tiny_spec(tmp_path / "darts.yaml"), "--device", "cpu",
                              "--workdir", workdir))
    assert rc == 0, err[-3000:]
    # maxTrialCount: 1 settles before the suggester's exhaustion, in both packages
    assert f"experiment {EXPERIMENT}: MaxTrialsReached" in out and "[ok]" in out
    status = read_status(workdir, EXPERIMENT)
    (trial,) = status["trials"].values()
    assert trial["condition"] == "Succeeded"
    assert f"optimal trial {trial['name']}: accuracy=" in out
    assert accuracy_steps(workdir, trial["name"]) == [0, 1]
    assert os.path.isfile(os.path.join(trial["checkpoint_dir"], "genotype.json"))
    # the run went through the async engine, which says so on stderr
    (line,) = [ln for ln in err.splitlines() if ln.startswith("async engine: ")]
    stats = json.loads(line[len("async engine: "):])
    assert stats["trials_settled"] == 1 and stats["fallback"] is None
    assert not any(stats["loop_restarts"].values()), stats
    rc, out, err = finish(cli("fsck", os.path.join(workdir, EXPERIMENT)))
    assert rc == 0 and "result: consistent" in out, out + err


def test_drain_after_epoch_0_then_resume_loses_and_repeats_no_epoch(tmp_path):
    workdir = str(tmp_path / "runs")
    os.makedirs(workdir)
    config = sqlite_config(tmp_path, workdir)
    spec = tiny_spec(tmp_path / "darts.yaml", "tests.test_torch_cli.gated_darts_trial")
    proc = cli("--config", config, "run", spec, "--device", "cpu", "--workdir", workdir,
               "--drain-grace-seconds", "120")
    try:
        deadline = time.monotonic() + 180
        trial = None
        while time.monotonic() < deadline and proc.poll() is None:
            status = read_status(workdir, EXPERIMENT)
            if status and status.get("trials"):
                trial = next(iter(status["trials"]))
                if os.path.exists(os.path.join(workdir, "observations.sqlite")) and \
                        accuracy_steps(workdir, trial) == [0]:
                    break
            time.sleep(0.05)
        else:
            pytest.fail(f"epoch 0 was never reported: {finish(proc, 5)}")
        proc.send_signal(signal.SIGTERM)
        rc, out, err = finish(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 75, err[-3000:]
    assert "drained" in err and "async engine: " in err
    status = read_status(workdir, EXPERIMENT)
    assert status["trials"][trial]["condition"] == "Drained"
    search_dir = os.path.join(status["trials"][trial]["checkpoint_dir"], "search")
    assert os.path.isfile(os.path.join(search_dir, "step_00000001.manifest.json"))
    assert not os.path.exists(os.path.join(search_dir, "step_00000002.manifest.json"))

    rc, out, err = finish(cli("--config", config, "run", spec, "--device", "cpu",
                              "--workdir", workdir, "--resume"))
    assert rc == 0, err[-3000:]
    status = read_status(workdir, EXPERIMENT)
    assert list(status["trials"]) == [trial]
    assert status["trials"][trial]["condition"] == "Succeeded"
    # epoch 0 from the first process, epoch 1 from the resumed one: each once
    assert accuracy_steps(workdir, trial) == [0, 1]
    with open(os.path.join(search_dir, "search_meta.json")) as f:
        assert json.load(f)["epochs_completed"] == 2
    rc, out, err = finish(cli("fsck", os.path.join(workdir, EXPERIMENT)))
    assert rc == 0 and "result: consistent" in out, out + err


def test_doctor_probes_in_a_fresh_interpreter():
    rc, out, err = finish(cli("doctor", "--device", "cpu", "--device-timeout", "60"))
    assert rc == 0, out + err
    assert out.startswith("pool healthy: 1 healthy") and "cpu:0" in out
    rc, out, err = finish(cli("doctor", "--device", "cpu", "--simulate-wedge", "0", "--json"))
    assert rc == 1
    report = json.loads(out)
    assert report["status"] == "wedged" and report["devices"][0]["error"] == "injected device wedge"


def test_doctor_on_cuda_fails_without_a_gpu():
    env_hidden = {"CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "katib_tpu_torch", "doctor", "--json"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": ROOT, **env_hidden})
    assert proc.returncode == 1
    assert json.loads(proc.stdout)["status"] == "absent"


def test_run_on_cuda_without_a_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        main(["run", tiny_spec(tmp_path / "darts.yaml"), "--workdir", str(tmp_path)])


def serve_healthz(*args: str) -> tuple[str, int, dict]:
    """Start ``python -m katib_tpu_torch suggest-server --port 0 <args>`` in a
    fresh interpreter, read the address from its first line, GET
    ``/healthz`` and stop it; returns the line, the status and the reply."""
    import urllib.request

    proc = subprocess.Popen(
        [sys.executable, "-m", "katib_tpu_torch", "suggest-server", "--port", "0", *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": ROOT})
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("katib-tpu suggestion service: "), line + proc.stdout.read()
        address = line.split()[3]
        with urllib.request.urlopen(f"{address}/healthz", timeout=10) as r:
            return line, r.status, json.loads(r.read())
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def db_manager_round_trip(tmp_path) -> tuple[str, int]:
    """Start ``python -m katib_tpu_torch db-manager --port 0 --db <journal>``
    in a fresh interpreter, report and read back through a remote store,
    stop it with SIGTERM; returns its first line and its exit code."""
    from katib_tpu_torch.native.dbmanager import RemoteObservationStore

    journal = str(tmp_path / "obs.journal")
    proc = subprocess.Popen(
        [sys.executable, "-m", "katib_tpu_torch", "db-manager", "--port", "0", "--db", journal],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": ROOT})
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("katib-tpu db-manager: 127.0.0.1:"), line + proc.stdout.read()
        store = RemoteObservationStore("127.0.0.1", int(line.split()[2].split(":")[1]))
        store.report_point("t", "loss", 0.25, step=1)
        assert [(m.value, m.step) for m in store.get("t", "loss")] == [(0.25, 1)]
        store.close()
        proc.send_signal(signal.SIGTERM)
        return line, proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("verb", UNPORTED_VERBS + ("prewarm", "cache", "suggest-server",
                                                   "db-manager"))
def test_unported_verbs_raise(verb, tmp_path, capsys, fresh_compile_state):
    if verb == "db-manager":  # ported: a journaled round trip, SIGTERM exits 0
        line, rc = db_manager_round_trip(tmp_path)
        assert line.endswith(f"(journal: {tmp_path / 'obs.journal'})") and rc == 0
        assert os.path.getsize(tmp_path / "obs.journal") > 0
        return
    if verb == "suggest-server":  # ported: it serves /healthz, on the CPU as asked
        line, status, reply = serve_healthz("--device", "cpu")
        assert line.startswith("katib-tpu suggestion service: http://127.0.0.1:")
        assert line.endswith("(auth: open)") and status == 200 and reply == {"status": "serving"}
        return
    if verb == "cache":  # ported: an empty artifact tier's inventory
        assert main(["cache", str(tmp_path)]) == 0
        assert "(empty)" in capsys.readouterr().out
        return
    if verb == "prewarm":  # ported: a spec whose train_fn has no twin is an error
        assert main(["prewarm", tiny_spec(tmp_path / "darts.yaml"), "--device", "cpu"]) == 2
        assert "no prewarm twin" in capsys.readouterr().err
        return
    match = f"{verb}.*item 8b" if verb in ("cost", "profile") else verb
    with pytest.raises(NotImplementedError, match=match):
        main([verb])


def test_fsck_of_an_artifact_cache_raises(tmp_path, capsys):
    """Ported: fsck of an (empty) artifact dir reports and exits 0."""
    (tmp_path / "artifacts").mkdir()
    assert main(["fsck", str(tmp_path / "artifacts")]) == 0
    assert "0 artifact(s)" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["darts.yaml", "darts-paper-protocol.yaml"])
def test_darts_suggester_emits_the_jax_suggesters_trial(name):
    from katib_tpu.core.types import Experiment as JExperiment
    from katib_tpu.sdk.yaml_spec import load_experiment_yaml as j_load
    from katib_tpu.suggest.base import make_suggester as j_make_suggester

    path = os.path.join(ROOT, "examples", "nas", name)
    want_spec, got_spec = j_load(path), load_experiment_yaml(path)
    (want,) = j_make_suggester(want_spec).get_suggestions(JExperiment(spec=want_spec), 1)
    (got,) = make_suggester(got_spec).get_suggestions(Experiment(spec=got_spec), 1)
    assert [(a.name, a.value) for a in got.assignments] == [
        (a.name, a.value) for a in want.assignments]
    assert got.labels == want.labels and got.name == want.name
