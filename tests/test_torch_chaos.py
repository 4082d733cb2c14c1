"""The port's ``chaos`` verb: its single fault-injection run against the
JAX CLI's, and the crash-consistency scenario at every registered crash
point.

The single run's scenarios (those of ``tests/test_faults.py``: a transient
failure retried with checkpoint resume, a permanent failure not retried,
the suggester's circuit breaker absorbing errors below its threshold and
failing the experiment at it, and the watchdog, drain and engine-supervisor
faults) run through both CLIs in this process and must end with the same
exit code.  ``--crash-at SITE`` kills the port's own child interpreter (JAX
blocked there) at each site of ``CRASH_POINTS`` and resumes in-process
with the invariants held; everything runs on the CPU."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from katib_tpu import cli as jcli
from katib_tpu_torch import cli as tcli
from katib_tpu_torch.utils import faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (flags, the exit code both CLIs give)
SCENARIOS = {
    "default": ([], 0),
    "retry-with-resume": (["--fail-trial", "0:1", "--fail-trial", "0:2"], 0),
    "retry-budget-spent": (["--fail-trial", "0:1", "--fail-trial", "0:2", "--max-retries", "1"],
                           1),
    "permanent-not-retried": (["--fail-trial", "0:1:permanent"], 0),
    "breaker-absorbs": (["--fail-suggester", "1", "--suggester-max-errors", "3"], 0),
    "breaker-trips": (["--fail-suggester", "1", "--fail-suggester", "2",
                       "--suggester-max-errors", "2"], 1),
    "flake": (["--flake-rate", "0.3", "--seed", "2"], 0),
    "hang": (["--hang-trial", "1"], 0),
    "compile-hang": (["--compile-hang", "1"], 0),
    "kill-loop": (["--kill-loop", "schedule"], 0),
    "stall-suggester": (["--stall-suggester", "2.0"], 0),
    "bad-fail-trial": (["--fail-trial", "0"], 2),
    "bad-kill-loop": (["--kill-loop", "nowhere"], 2),
    "bad-hang-trial": (["--hang-trial", "0:1:2"], 2),
    "crash-and-kill": (["--crash-at", "journal.append", "--kill-at", "journal.append"], 2),
}


@pytest.mark.chaos
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_single_run_exits_as_the_jax_cli_does(scenario, capsys):
    flags, code = SCENARIOS[scenario]
    want = jcli.main(["chaos", *flags])
    jax_out = capsys.readouterr()
    got = tcli.main(["chaos", "--device", "cpu", *flags])
    out = capsys.readouterr()
    assert got == want == code, (jax_out.err[-2000:], out.err[-2000:])
    if code == 0:
        assert "CHAOS PASS" in out.out
    if code == 1:
        assert "CHAOS FAIL" in out.err


def test_the_default_scenario_retries_trial_0_twice_and_resumes(capsys):
    assert tcli.main(["chaos", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    lines = [ln.split() for ln in out.splitlines() if ln.startswith("  chaos-random-")]
    assert len(lines) == 4
    assert sorted(ln[2] for ln in lines) == ["attempts=1"] * 3 + ["attempts=3"]
    assert "injected: 2 faults; retries=2" in out


def test_the_preemption_drains_and_resumes_from_the_command_line():
    """``--preempt-at`` sends this process a real SIGTERM: a fresh
    interpreter per CLI, so the drain handlers are each process's own."""
    codes = {}
    for label, argv in (("jax", ["-m", "katib_tpu", "chaos"]),
                        ("torch", ["-m", "katib_tpu_torch", "chaos", "--device", "cpu"])):
        out = subprocess.run(
            [sys.executable, *argv, "--preempt-at", "1"], cwd=ROOT, capture_output=True,
            text=True, timeout=300, env={**os.environ, "PYTHONPATH": ROOT,
                                         "JAX_PLATFORMS": "cpu"})
        codes[label] = out.returncode
        if label == "torch":
            assert "preempted mid-experiment" in out.stdout, out.stdout + out.stderr[-2000:]
            assert "CHAOS PASS" in out.stdout
    assert codes["torch"] == codes["jax"] == 0


@pytest.mark.chaos
@pytest.mark.parametrize("site", faults.registered_crash_points())
def test_crash_at_each_site_resumes_with_the_invariants(site, capsys):
    assert tcli.main(["chaos", "--device", "cpu", "--crash-at", site, "--trials", "3"]) == 0
    out = capsys.readouterr().out
    assert f"chaos crash-at={site} mode=exit: child exited 137" in out
    assert f"CHAOS PASS: hard kill at {site}" in out


def test_kill_at_dies_by_sigkill_and_resumes(capsys):
    assert tcli.main(["chaos", "--device", "cpu", "--kill-at", "journal.append",
                      "--trials", "3"]) == 0
    out = capsys.readouterr().out
    assert "mode=kill: child exited -9" in out and "CHAOS PASS" in out


def test_crash_at_the_nth_hit(capsys):
    assert tcli.main(["chaos", "--device", "cpu", "--crash-at", "journal.append:8",
                      "--trials", "3"]) == 0
    assert "resumed: MaxTrialsReached, 3 trial(s)" in capsys.readouterr().out


def test_an_unknown_crash_site_returns_2(capsys):
    args = ("chaos", "--device", "cpu", "--crash-at", "no.such.site")
    assert tcli.main(list(args)) == 2
    assert "unknown crash point 'no.such.site'" in capsys.readouterr().err


def test_a_site_never_reached_fails_the_scenario(capsys):
    """Armed at a hit the short sweep never makes, the child finishes: the
    scenario proves nothing and says so."""
    assert tcli.main(["chaos", "--device", "cpu", "--crash-at", "journal.snapshot:1000",
                      "--trials", "2"]) == 1
    assert "was never reached" in capsys.readouterr().err


def test_the_crash_child_runs_with_jax_blocked(tmp_path):
    """The child script as the scenario writes it, without a crash point:
    it imports nothing of JAX or of the JAX package (they are blocked) and
    finishes its sweep."""
    script = tcli._CRASH_CHILD_SCRIPT.format(
        syspath=[p for p in sys.path if p], workdir=str(tmp_path), trials=2, device="cpu")
    assert "sys.modules[_name] = None" in script
    env = {k: v for k, v in os.environ.items() if k not in (faults.CRASH_AT_ENV,)}
    out = subprocess.run([sys.executable, "-c", script + "\nimport sys\n"
                          "assert not any(m.split('.')[0] in ('jax', 'katib_tpu') and "
                          "sys.modules[m] is not None for m in sys.modules), 'jax imported'\n"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "child finished: MaxTrialsReached" in out.stdout


def test_the_checkpoint_manifest_site_fires_in_the_port(tmp_path):
    """``TrialCheckpointer.save`` dies at ``checkpoint.manifest`` when it is
    armed: the step directory is in place, its manifest is not."""
    code = ("import sys, torch\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "from katib_tpu_torch.utils.checkpoint import TrialCheckpointer\n"
            f"TrialCheckpointer({str(tmp_path)!r}).save({{'w': torch.zeros(2)}}, 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={**os.environ,
                                           faults.CRASH_AT_ENV: "checkpoint.manifest"})
    assert out.returncode == 137, out.stderr[-2000:]
    names = sorted(os.listdir(tmp_path))
    assert "step_00000000" in names and not any(n.endswith(".manifest.json") for n in names)
    assert any(n.startswith(".manifest-") for n in names)  # the temp file, never renamed


def test_crash_children_run_on_cuda_unless_told_otherwise(monkeypatch):
    """The child gets the parent's ``--device``, ``cuda`` by default;
    where the child fails before any crash point (no GPU), the parent
    reports that instead of resuming."""
    captured = {}

    def fake_run(argv, **kw):
        captured["script"] = argv[-1]
        return subprocess.CompletedProcess(argv, 1, "", "RuntimeError: no CUDA GPU")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert tcli.main(["chaos", "--crash-at", "journal.append"]) == 1
    assert "device='cuda'" in captured["script"]
