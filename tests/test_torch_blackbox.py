"""The port's black-box trial runner against the JAX package's: the same
command, through each package's ``run_trial`` with its own memory store,
must settle the same condition with the same ``failure_kind`` and leave the
same observations ``(metric, value, step)``.  Values are the printed text,
so the comparison is exact.  Each case's script is written so that what it
reports does not depend on timing: lines that must be seen before a signal
go out in one write, and an endpoint's value moves per request.

Parity models: the black-box cases of ``tests/test_runner_orchestrator.py``,
``test_deadlines_retry.py``, ``test_watchdog_drain.py``,
``test_prometheus_collector.py``, ``test_tfevent.py`` and
``test_faults.py::TestProcessGroupCleanup``."""

from __future__ import annotations

import os
import socket
import sys
import textwrap
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from katib_tpu.core import types as jtypes
from katib_tpu.runner import trial_runner as jrunner
from katib_tpu.store import base as jstore
from katib_tpu.utils import watchdog as jwatchdog
from katib_tpu_torch.core import types as ttypes
from katib_tpu_torch.runner import trial_runner as trunner
from katib_tpu_torch.store import base as tstore
from katib_tpu_torch.utils import watchdog as twatchdog

ROOT = Path(__file__).resolve().parents[1]
PKGS = {
    "jax": SimpleNamespace(name="katib_tpu", types=jtypes, runner=jrunner, store=jstore,
                           watchdog=jwatchdog),
    "torch": SimpleNamespace(name="katib_tpu_torch", types=ttypes, runner=trunner,
                             store=tstore, watchdog=twatchdog),
}
PY = sys.executable


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _alive(pid: int) -> bool:
    """Is pid a live (non-zombie) process?"""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


# a trial that prints its metric lines in ONE write, then waits to be
# signalled: every line is in the pipe before the runner can react
_WAIT = "import sys, time\nsys.stdout.write({lines!r}); sys.stdout.flush()\ntime.sleep(60)\n"

# the Prometheus trial: the exposed value moves one step per request and the
# trial exits after serving the last, so every scrape sees a new value
_PROM = textwrap.dedent("""\
    import sys, threading
    from http.server import BaseHTTPRequestHandler, HTTPServer

    port = int(sys.argv[1])
    served = [0]
    done = threading.Event()

    class H(BaseHTTPRequestHandler):
        def do_GET(self):
            served[0] += 1
            body = ("# TYPE accuracy gauge\\naccuracy %.3f\\nloss{shard=\\"0\\"} %.3f\\n"
                    % (served[0] / 10.0, 1.0 / served[0])).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            if served[0] >= 5:
                done.set()
        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", port), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    done.wait(30)
    """)

# a drained trial checkpoints on SIGTERM and reports once more on its way out
_DRAIN = textwrap.dedent("""\
    import signal, sys, time
    def bye(*_):
        print("accuracy=0.4", flush=True)
        sys.exit(0)
    signal.signal(signal.SIGTERM, bye)
    print("accuracy=0.3", flush=True)
    time.sleep(60)
    """)


def _tfevent_script(pkg: str, logdir: str) -> str:
    return (
        f"import sys\nsys.path.insert(0, {str(ROOT)!r})\n"
        f"from {PKGS[pkg].name}.runner.tfevent import TFEventWriter\n"
        f"w = TFEventWriter({logdir!r})\n"
        "w.add_scalar('accuracy', 0.875, step=1, wall_time=1.0)\n"
        "w.add_scalar('accuracy', 0.5, step=0, wall_time=0.5)\n"
        "w.add_scalar('loss', 0.25, step=1, wall_time=1.0)\n"
        "w.close()\n"
        "print('accuracy=0.111')  # stdout is not scraped for TFEvent\n"
    )


def case_spec(name: str, pkg: str, tmp: Path) -> dict:
    """The trial and run settings of case ``name`` for package ``pkg``:
    ``command``, ``collector`` (kind name, path, filter, port, interval),
    ``spec`` (TrialSpec keywords), ``event`` ("stop"/"drain" set once the
    first observation is stored), ``watchdog`` and ``pidfile``."""
    out: dict = {"collector": {"kind": "STDOUT"}, "spec": {}}
    if name == "stdout":
        out["command"] = [PY, "-c", "print('accuracy=0.5'); print('accuracy=0.75')"]
    elif name == "stdout-filter":
        out["command"] = [PY, "-c", "print('accuracy: 0.5'); print('accuracy=0.9'); "
                                    "print('loss: 2e-3')"]
        out["collector"]["filter"] = r"([\w|-]+)\s*:\s*([+-]?\d*(\.\d+)?([Ee][+-]?\d+)?)"
    elif name == "stdout-no-trailing-newline":
        out["command"] = [PY, "-c", "import sys; print('accuracy=0.1'); "
                                    "sys.stdout.write('accuracy=0.93')"]
    elif name == "binary-stdout":
        out["command"] = [PY, "-c", "import sys; sys.stdout.buffer.write("
                                    "b'\\xff\\xfe garbage\\naccuracy=0.5\\n')"]
    elif name == "push-default-reads-stdout":
        out["collector"] = {"kind": "PUSH"}
        out["command"] = [PY, "-c", "print('accuracy=0.625')"]
    elif name == "file":
        # the collector path renders like the command: one file per trial
        path = str(tmp / "m-${trialSpec.Name}.log")
        out["collector"] = {"kind": "FILE", "path": path}
        out["command"] = [PY, "-c", (
            "import sys\n"
            "f = open(sys.argv[1], 'w')\n"
            "f.write('accuracy=0.2\\nloss=0.9\\naccuracy=0.7\\n')\nf.close()\n"
            "print('accuracy=0.99')  # stdout is not scraped for a File collector\n"),
            path]
    elif name == "file-no-trailing-newline":
        path = str(tmp / "m.log")
        out["collector"] = {"kind": "FILE", "path": path}
        out["command"] = [PY, "-c", f"f = open({path!r}, 'w'); f.write('accuracy=0.93'); "
                                    "f.close()"]
    elif name == "jsonl-bad-line":
        path = str(tmp / "m.jsonl")
        out["collector"] = {"kind": "JSONL", "path": path}
        out["command"] = [PY, "-c", (
            f"f = open({path!r}, 'w')\n"
            "f.write('{\"accuracy\": 0.4}\\nnot json at all\\n{\"accuracy\": 0.8, \"loss\": 1}\\n')\n"
            "f.close()\n")]
    elif name == "tfevent":
        logdir = str(tmp / "events")
        out["collector"] = {"kind": "TFEVENT", "path": logdir}
        out["command"] = [PY, "-c", _tfevent_script(pkg, logdir)]
    elif name == "prometheus":
        port = _free_port()
        out["collector"] = {"kind": "PROMETHEUS", "port": port, "scrape_interval": 0.05}
        out["command"] = [PY, "-c", _PROM, str(port)]
    elif name == "collector-none":
        out["collector"] = {"kind": "NONE"}
        out["command"] = [PY, "-c", "print('accuracy=0.5')"]
    elif name == "metrics-unavailable":
        out["command"] = [PY, "-c", "print('hello')"]
    elif name == "nonzero-exit":
        out["command"] = [PY, "-c", "print('accuracy=0.5'); raise SystemExit(3)"]
    elif name == "killed-by-signal":
        out["command"] = [PY, "-c", "import os; print('accuracy=0.5', flush=True); "
                                    "os.kill(os.getpid(), 9)"]
    elif name == "launch-failure":
        out["command"] = [str(tmp / "no-such-trainer"), "--lr=1"]
    elif name == "early-stop":
        out["command"] = [PY, "-c", _WAIT.format(lines="accuracy=0.01\n" * 3)]
        out["spec"]["rules"] = ("accuracy", 0.5, "LESS", 2)
    elif name == "early-stop-file":
        path = str(tmp / "live.log")
        out["collector"] = {"kind": "FILE", "path": path}
        out["command"] = [PY, "-c", (
            "import time\n"
            f"f = open({path!r}, 'w', buffering=1)\n"
            "f.write('accuracy=0.01\\naccuracy=0.01\\naccuracy=0.01\\n')\n"
            "time.sleep(60)\n")]
        out["spec"]["rules"] = ("accuracy", 0.5, "LESS", 2)
    # the deadline and the watchdog run from the launch, so these trials
    # print nothing: a line would race the interpreter's start on a busy host
    elif name == "max-runtime":
        out["command"] = [PY, "-c", "import time; time.sleep(60)"]
        out["spec"]["max_runtime_seconds"] = 1.0
    elif name == "max-runtime-sigterm-ignored":
        # SIGTERM is ignored: the runner escalates to SIGKILL after 10 s
        out["command"] = [PY, "-c", "import signal, time; "
                                    "signal.signal(signal.SIGTERM, signal.SIG_IGN); time.sleep(60)"]
        out["spec"]["max_runtime_seconds"] = 1.0
    elif name == "hang-watchdog":
        out["command"] = [PY, "-c", "import time; time.sleep(60)"]
        out["spec"]["progress_deadline_seconds"] = 0.75
        out["watchdog"] = True
    elif name == "drain":
        out["command"] = [PY, "-c", _DRAIN]
        out["event"] = "drain"
    elif name == "kill":
        out["command"] = [PY, "-c", _DRAIN]
        out["event"] = "stop"
    elif name == "trial-metadata":
        out["command"] = [PY, "-c", (
            "import sys\n"
            "assert sys.argv[1:] == ['bb-trial-metadata', 'bb-exp', 'Trial', 'katib-tpu/v1beta1',"
            " '3', '3', '0.25'], sys.argv\n"
            "print('accuracy=' + sys.argv[-1])\n"),
            "${trialSpec.Name}", "${trialSpec.Namespace}", "${trialSpec.Kind}",
            "${trialSpec.APIVersion}", "${trialSpec.Labels[pbt-generation]}",
            "${trialSpec.Annotations[pbt-generation]}", "${trialParameters.lr}"]
    elif name == "trial-metadata-missing-label":
        out["command"] = [PY, "-c", "print('accuracy=1')", "${trialSpec.Labels[ghost]}"]
    elif name == "trial-metadata-illegal":
        out["command"] = [PY, "-c", "print('accuracy=1')", "${trialSpec.Bogus}"]
    elif name == "forking-trainer-reaped":
        pidfile = tmp / "grandchild.pid"
        out["command"] = [PY, "-c", (
            "import subprocess, sys, time\n"
            "g = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(60)'])\n"
            f"open({str(pidfile)!r}, 'w').write(str(g.pid))\n"
            "print('accuracy=0.1', flush=True)\n"
            "time.sleep(60)\n")]
        out["event"] = "stop"
        out["pidfile"] = pidfile
    else:  # pragma: no cover - a typo in CASES
        raise KeyError(name)
    return out


CASES = [
    "stdout", "stdout-filter", "stdout-no-trailing-newline", "binary-stdout",
    "push-default-reads-stdout", "file", "file-no-trailing-newline", "jsonl-bad-line",
    "tfevent", "prometheus", "collector-none", "metrics-unavailable", "nonzero-exit",
    "killed-by-signal", "launch-failure", "early-stop", "early-stop-file", "max-runtime",
    "max-runtime-sigterm-ignored", "hang-watchdog", "drain", "kill", "trial-metadata",
    "trial-metadata-missing-label", "trial-metadata-illegal", "forking-trainer-reaped",
]


def _objective(pkg: str):
    t = PKGS[pkg].types
    return t.ObjectiveSpec(type=t.ObjectiveType.MAXIMIZE, objective_metric_name="accuracy",
                           additional_metric_names=["loss"])


def run_case(name: str, pkg: str, tmp: Path) -> dict:
    """Run case ``name`` through package ``pkg``'s runner; returns what the
    parity compares, plus the wall time and the case's settings."""
    p = PKGS[pkg]
    t = p.types
    tmp.mkdir(parents=True, exist_ok=True)
    cs = case_spec(name, pkg, tmp)
    col = dict(cs["collector"])
    kind = t.MetricsCollectorKind[col.pop("kind")]
    spec_kw = dict(cs["spec"])
    rules = []
    if "rules" in spec_kw:
        metric, value, op, start = spec_kw.pop("rules")
        rules = [t.EarlyStoppingRule(metric, value, t.ComparisonOp[op], start_step=start)]
    trial = t.Trial(
        name=f"bb-{name}",
        experiment_name="bb-exp",
        spec=t.TrialSpec(
            command=list(cs["command"]),
            assignments=[t.ParameterAssignment("lr", 0.25)],
            labels={"pbt-generation": "3"},
            early_stopping_rules=rules,
            metrics_collector=t.MetricsCollectorSpec(kind=kind, **col),
            **spec_kw,
        ),
        checkpoint_dir=str(tmp / "ckpt"),
    )
    store = p.store.MemoryObservationStore()
    kw = {}
    if cs.get("event"):
        event = threading.Event()
        kw["stop_event" if cs["event"] == "stop" else "drain_event"] = event

        def _set_when_observed():
            deadline = time.monotonic() + 30
            while not store.get(trial.name) and time.monotonic() < deadline:
                time.sleep(0.01)
            event.set()

        threading.Thread(target=_set_when_observed, daemon=True).start()
    wd = p.watchdog.Watchdog(interval=0.05) if cs.get("watchdog") else None
    t0 = time.monotonic()
    try:
        result = p.runner.run_trial(trial, store, _objective(pkg), watchdog=wd, **kw)
    finally:
        if wd is not None:
            wd.stop()
    log_path = tmp / "ckpt" / "trial.log"
    return {
        "condition": result.condition.value,
        "failure_kind": result.failure_kind.name if result.failure_kind else None,
        "observations": [(log.metric_name, log.value, log.step)
                         for log in store.get(trial.name)],
        "log": log_path.read_text() if log_path.exists() else None,
        "message": result.message,
        "wall": time.monotonic() - t0,
        "case": cs,
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through both packages.  The two packages' runs of a case
    go side by side, on two threads (their scripts' reports do not depend
    on timing)."""
    out = {}
    for name in CASES:
        res = {}

        def go(pkg, name=name, res=res):
            res[pkg] = run_case(name, pkg, tmp_path_factory.mktemp(f"{name}-{pkg}"))

        threads = [threading.Thread(target=go, args=(pkg,)) for pkg in PKGS]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        out[name] = res
    return out


#: what each case must settle as (condition, failure kind, observations)
EXPECTED = {
    "stdout": ("Succeeded", None, [("accuracy", 0.5), ("accuracy", 0.75)]),
    "stdout-filter": ("Succeeded", None, [("accuracy", 0.5), ("loss", 0.002)]),
    "stdout-no-trailing-newline": ("Succeeded", None, [("accuracy", 0.1), ("accuracy", 0.93)]),
    "binary-stdout": ("Succeeded", None, [("accuracy", 0.5)]),
    "push-default-reads-stdout": ("Succeeded", None, [("accuracy", 0.625)]),
    "file": ("Succeeded", None, [("accuracy", 0.2), ("loss", 0.9), ("accuracy", 0.7)]),
    "file-no-trailing-newline": ("Succeeded", None, [("accuracy", 0.93)]),
    "jsonl-bad-line": ("Succeeded", None, [("accuracy", 0.4), ("accuracy", 0.8), ("loss", 1.0)]),
    "tfevent": ("Succeeded", None, [("accuracy", 0.5), ("accuracy", 0.875), ("loss", 0.25)]),
    "prometheus": ("Succeeded", None,
                   [(m, v) for i in range(1, 6)
                    for m, v in (("accuracy", i / 10.0), ("loss", round(1.0 / i, 3)))]),
    "collector-none": ("MetricsUnavailable", None, []),
    "metrics-unavailable": ("MetricsUnavailable", None, []),
    "nonzero-exit": ("Failed", "PERMANENT", [("accuracy", 0.5)]),
    "killed-by-signal": ("Failed", "TRANSIENT", [("accuracy", 0.5)]),
    "launch-failure": ("Failed", "TRANSIENT", []),
    "early-stop": ("EarlyStopped", None, [("accuracy", 0.01)] * 3),
    "early-stop-file": ("EarlyStopped", None, [("accuracy", 0.01)] * 3),
    "max-runtime": ("Failed", None, []),
    "max-runtime-sigterm-ignored": ("Failed", None, []),
    "hang-watchdog": ("Failed", "HANG", []),
    "drain": ("Drained", None, [("accuracy", 0.3), ("accuracy", 0.4)]),
    "kill": ("Killed", None, [("accuracy", 0.3), ("accuracy", 0.4)]),
    "trial-metadata": ("Succeeded", None, [("accuracy", 0.25)]),
    "trial-metadata-missing-label": ("Failed", "PERMANENT", []),
    "trial-metadata-illegal": ("Failed", "PERMANENT", []),
    "forking-trainer-reaped": ("Killed", None, [("accuracy", 0.1)]),
}


@pytest.mark.parametrize("name", CASES)
def test_blackbox_trial_settles_as_the_jax_runner(runs, name):
    jax_run, torch_run = runs[name]["jax"], runs[name]["torch"]
    for key in ("condition", "failure_kind", "observations"):
        assert torch_run[key] == jax_run[key], (key, torch_run["message"], jax_run["message"])
    condition, kind, observed = EXPECTED[name]
    assert (torch_run["condition"], torch_run["failure_kind"]) == (condition, kind), \
        torch_run["message"]
    assert [(m, v) for m, v, _ in torch_run["observations"]] == observed


def test_failure_messages_name_the_cause(runs):
    msg = {name: runs[name]["torch"]["message"] for name in CASES}
    assert "exit code 3" in msg["nonzero-exit"]
    assert "exit code -9" in msg["killed-by-signal"]
    assert "failed to launch" in msg["launch-failure"]
    assert "max_runtime_seconds=1.0" in msg["max-runtime"]
    assert "hang watchdog" in msg["hang-watchdog"]
    assert "no label 'ghost'" in msg["trial-metadata-missing-label"]
    assert "illegal trial metadata reference ${trialSpec.Bogus}" in msg["trial-metadata-illegal"]
    for name in ("nonzero-exit", "max-runtime", "hang-watchdog"):
        assert msg[name] == runs[name]["jax"]["message"], name
    # each package's run has a temporary directory of its own
    jax_msg = runs["launch-failure"]["jax"]["message"]
    assert msg["launch-failure"].replace("-torch", "-jax") == jax_msg


def test_signals_land_promptly_and_sigterm_escalates(runs):
    """A signalled trial ends at its signal, not its 60 s sleep; a trial
    that ignores SIGTERM is SIGKILLed 10 s later."""
    for name in ("early-stop", "early-stop-file", "max-runtime", "hang-watchdog", "drain",
                 "kill", "forking-trainer-reaped"):
        assert runs[name]["torch"]["wall"] < 9.0, (name, runs[name]["torch"]["wall"])
    wall = runs["max-runtime-sigterm-ignored"]["torch"]["wall"]
    assert 10.5 < wall < 40.0, wall


def test_trial_log_is_the_jax_runners(runs):
    """stdout is persisted to ``<checkpoint_dir>/trial.log`` as the trial
    prints it, whatever the collector."""
    for name in CASES:
        assert runs[name]["torch"]["log"] == runs[name]["jax"]["log"], name
    assert runs["stdout"]["torch"]["log"] == "accuracy=0.5\naccuracy=0.75\n"
    assert runs["file"]["torch"]["log"] == "accuracy=0.99\n"
    assert runs["launch-failure"]["torch"]["log"] is None


def test_forking_trainer_leaves_no_grandchild(runs):
    """The trial is its own process group, and the kill (here the
    experiment's stop) signals the whole group: the trainer's own child
    dies with it."""
    if os.name != "posix":
        pytest.skip("process groups are POSIX-only")
    for pkg in PKGS:
        pidfile = runs["forking-trainer-reaped"][pkg]["case"]["pidfile"]
        assert pidfile.exists(), "the trial never started its grandchild"
        pid = int(pidfile.read_text())
        deadline = time.monotonic() + 10.0
        while _alive(pid) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not _alive(pid), f"{pkg}: grandchild {pid} outlived the trial"


def test_subprocess_span_is_recorded(tmp_path):
    """The runner records one ``subprocess`` span per black-box trial, with
    its exit code."""
    from katib_tpu_torch.utils import tracing

    tracer = tracing.Tracer(str(tmp_path / "trace.jsonl"))
    try:
        with tracing.use_tracer(tracer):
            run_case("stdout", "torch", tmp_path / "run")
    finally:
        tracer.close()
    spans = [s for s in tracing.read_journal(str(tmp_path / "trace.jsonl"))
             if s["name"] == "subprocess"]
    assert len(spans) == 1 and spans[0]["args"] == {"trial": "bb-stdout", "rc": 0}
    assert 0.0 < spans[0]["dur"] < 30.0


# -- command substitution ----------------------------------------------------

TEMPLATES = [
    (["python", "train.py", "--lr=${trialParameters.lr}", "--u=${trialParameters.units}"],
     {"lr": 0.01, "units": 32}),
    (["--name=${trialSpec.Name}", "--ns=${trialSpec.Namespace}", "--kind=${trialSpec.Kind}",
      "--api=${trialSpec.APIVersion}", "--gen=${trialSpec.Labels[pbt-generation]}",
      "--also=${trialSpec.Annotations[pbt-generation]}"], {}),
    (["--missing=${trialParameters.ghost}", "--lr=${trialParameters.lr}"], {"lr": 0.5}),
    # single pass: a substituted value is never expanded again
    (["--tmpl=${trialParameters.tmpl}"], {"tmpl": "${trialSpec.Labels[ghost]}"}),
    (["${trialSpec.Labels[ghost]}"], {}),
    (["${trialSpec.Bogus}"], {}),
    (["${trialSpec.Labels}"], {}),
]


@pytest.mark.parametrize("i", range(len(TEMPLATES)))
def test_substitute_command_matches_the_jax_runner(i):
    template, params = TEMPLATES[i]
    rendered = {}
    for pkg, p in PKGS.items():
        t = p.types
        trial = t.Trial(name="exp-abc123", experiment_name="exp",
                        spec=t.TrialSpec(command=[], assignments=[],
                                         labels={"pbt-generation": "3"}))
        try:
            rendered[pkg] = ("ok", p.runner.substitute_command(template, params, trial),
                             p.runner.substitute_command(template, params))
        except ValueError as e:
            rendered[pkg] = ("ValueError", str(e))
    assert rendered["torch"] == rendered["jax"]
    if i == 1:
        assert rendered["torch"][1] == ["--name=exp-abc123", "--ns=exp", "--kind=Trial",
                                        "--api=katib-tpu/v1beta1", "--gen=3", "--also=3"]
    if i == 3:
        assert rendered["torch"][1] == ["--tmpl=${trialSpec.Labels[ghost]}"]
