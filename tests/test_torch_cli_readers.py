"""The port's reader, trace and conformance verbs against the JAX CLI's.

One run of the port writes a workdir (a white-box experiment with a
metric named like a parameter, and a black-box experiment whose trials'
stdout is captured) and a sqlite store; then ``list``, ``describe`` (text
and ``--json``), ``export`` (csv and jsonl), ``metrics``, ``logs`` and both
``trace`` verbs run through both CLIs, in this process, on that workdir.
Their standard output is equal once ages and wall-clock fields are masked,
and so are their exit codes, the error exits included.  ``conformance``
passes on the CPU.  Nothing here compiles a JAX program."""

from __future__ import annotations

import json
import re
import sys

import pytest
import yaml

from katib_tpu import cli as jcli
from katib_tpu_torch import cli as tcli
from katib_tpu_torch.core import types as t
from katib_tpu_torch.orchestrator import Orchestrator
from katib_tpu_torch.store.sqlite import SqliteObservationStore

WHITE = "readers-white"
BLACK = "readers-black"


def white_trainer(ctx):
    """accuracy peaks at lr=0.1; ``lr`` is also reported as a metric, so
    ``export`` has to move it to the ``metric:`` namespace."""
    lr = float(ctx.params["lr"])
    for step in range(3):
        if not ctx.report(step=step, accuracy=(1.0 - (lr - 0.1) ** 2) * (step + 1) / 3,
                          lr=lr):
            return


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("readers")
    wd = str(root / "runs")
    db = str(root / "observations.sqlite")
    config = root / "config.yaml"
    config.write_text(yaml.safe_dump({"store": {"backend": "sqlite", "path": db}}))
    store = SqliteObservationStore(db)
    objective = t.ObjectiveSpec(type=t.ObjectiveType.MAXIMIZE, objective_metric_name="accuracy",
                                additional_metric_names=("lr",))
    lr = t.ParameterSpec("lr", t.ParameterType.DOUBLE, t.FeasibleSpace(min=0.01, max=0.2))
    white = t.ExperimentSpec(name=WHITE, objective=objective, parameters=[lr],
                             algorithm=t.AlgorithmSpec(name="random"), max_trial_count=5,
                             parallel_trial_count=2, train_fn=white_trainer)
    black = t.ExperimentSpec(
        name=BLACK,
        objective=t.ObjectiveSpec(type=t.ObjectiveType.MAXIMIZE,
                                  objective_metric_name="accuracy"),
        parameters=[lr], algorithm=t.AlgorithmSpec(name="random"), max_trial_count=2,
        parallel_trial_count=1,
        command=[sys.executable, "-c",
                 "print('epoch 0'); print('accuracy=${trialParameters.lr}')"],
        metrics_collector=t.MetricsCollectorSpec(kind=t.MetricsCollectorKind.STDOUT),
    )
    runs = {}
    for spec in (white, black):
        runs[spec.name] = Orchestrator(workdir=wd, store=store, device="cpu").run(spec)
    store.close()
    return {"dir": wd, "config": str(config), "runs": runs}


#: wall-clock fields: ages in ``list``, the ``@Ns`` of ``describe``'s
#: convergence line, times and durations in JSON
_MASKS = (
    (re.compile(r"\b\d+(s|m\d\ds|h\d\dm)(?=\s*$)", re.M), "<age>"),
    (re.compile(r"@\d+s"), "@<s>"),
)


def mask(text: str) -> str:
    for pattern, sub in _MASKS:
        text = pattern.sub(sub, text)
    return text


def both(capsys, *argv: str, config: str | None = None) -> tuple:
    """Run one verb through each CLI; ``(rc, stdout)`` of each, stdout masked."""
    out = []
    for main in (jcli.main, tcli.main):
        rc = main([*(["--config", config] if config else []), *argv])
        out.append((rc, mask(capsys.readouterr().out)))
    return tuple(out)


def test_the_port_wrote_both_experiments(workdir):
    white, black = workdir["runs"][WHITE], workdir["runs"][BLACK]
    assert white.condition.value == black.condition.value == "MaxTrialsReached"
    assert all(tr.condition.value == "Succeeded" for tr in white.trials.values())
    assert len(black.trials) == 2


@pytest.mark.parametrize("argv", [
    ["list"],
    ["describe", WHITE],
    ["describe", BLACK],
    ["describe", WHITE, "--json"],
    ["export", WHITE],
    ["export", WHITE, "--format", "jsonl"],
    ["export", BLACK, "--format", "csv"],
    ["trace", "summary", WHITE],
    ["trace", "summary", WHITE, "--json"],
    ["trace", "summary", BLACK, "--top", "3"],
    ["trace", "summary", WHITE, "--json", "--top", "4"],
    ["trace", "export", WHITE, "--out", "-"],
], ids=lambda a: "-".join(a).replace("--", ""))
def test_reader_verbs_print_what_the_jax_cli_prints(argv, workdir, capsys):
    (want_rc, want), (got_rc, got) = both(capsys, *argv, "--workdir", workdir["dir"])
    assert got_rc == want_rc == 0
    assert got == want and got.strip()


def test_describe_json_is_the_status_document(workdir, capsys):
    assert tcli.main(["describe", WHITE, "--json", "--workdir", workdir["dir"]]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["name"] == WHITE and len(doc["trials"]) == 5
    assert doc["optimal"]["trial_name"] == workdir["runs"][WHITE].optimal.trial_name


def test_export_names_a_metric_that_shadows_a_parameter(workdir, capsys):
    assert tcli.main(["export", WHITE, "--workdir", workdir["dir"]]) == 0
    header = capsys.readouterr().out.splitlines()[0].split(",")
    assert header[:3] == ["trial", "condition", "lr"] and "metric:lr" in header


def test_metrics_reads_the_configured_store(workdir, capsys):
    trial = sorted(workdir["runs"][WHITE].trials)[0]
    (want_rc, want), (got_rc, got) = both(capsys, "metrics", trial, config=workdir["config"])
    assert got_rc == want_rc == 0
    assert got == want and len(got.splitlines()) == 6  # 3 steps x (accuracy, lr)


def test_logs_print_a_black_box_trials_stdout(workdir, capsys):
    trial = sorted(workdir["runs"][BLACK].trials)[0]
    (want_rc, want), (got_rc, got) = both(capsys, "logs", trial, "--workdir", workdir["dir"])
    assert got_rc == want_rc == 0
    assert got == want and "epoch 0" in got and "accuracy=" in got


def test_trace_export_writes_the_chrome_trace(workdir, tmp_path, capsys):
    outs = []
    for main, name in ((jcli.main, "jax.json"), (tcli.main, "torch.json")):
        assert main(["trace", "export", WHITE, "--workdir", workdir["dir"],
                     "--out", str(tmp_path / name)]) == 0
        outs.append(json.loads((tmp_path / name).read_text()))
        capsys.readouterr()
    assert outs[1] == outs[0] and outs[1]["traceEvents"]


@pytest.mark.parametrize("argv", [
    ["describe", "ghost"],
    ["describe", "ghost", "--json"],
    ["export", "ghost"],
    ["trace", "summary", "ghost"],
    ["trace", "export", "ghost"],
    ["logs", "no-such-trial"],
], ids=lambda a: "-".join(a).replace("--", ""))
def test_error_exits_match_the_jax_cli(argv, workdir, capsys):
    (want_rc, want), (got_rc, got) = both(capsys, *argv, "--workdir", workdir["dir"])
    assert got_rc == want_rc == 1 and got == want


def test_metrics_of_an_unknown_trial_exits_1(workdir, capsys):
    (want_rc, _), (got_rc, _) = both(capsys, "metrics", "no-such-trial",
                                     config=workdir["config"])
    assert got_rc == want_rc == 1


def test_list_of_an_empty_workdir(tmp_path, capsys):
    (want_rc, want), (got_rc, got) = both(capsys, "list", "--workdir", str(tmp_path))
    assert got_rc == want_rc == 0 and got == want
    assert got.startswith("no experiments under")


def test_conformance_passes_on_the_cpu(capsys):
    assert tcli.main(["conformance", "--max-trials", "4", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("CONFORMANCE PASS: MaxTrialsReached, 4 trials")


def test_conformance_runs_on_cuda_unless_told_otherwise(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tcli.main(["conformance", "--max-trials", "1"])
