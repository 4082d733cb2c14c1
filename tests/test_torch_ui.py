"""The port's dashboard backend (``katib_tpu_torch/ui``) against the JAX
package's (``tests/test_ui.py`` is the model).

Experiments of both packages are run into one workdir and one sqlite
observation store (the on-disk formats are shared), and both backends'
``route()`` must give equal JSON for every read route: experiments, detail,
trials, metrics, NAS graphs, logs and the 404s.  The HTTP layer (the
dashboard page, the write path with its content-type, host and token
guards) is exercised through real requests on loopback, on the CPU."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch

from katib_tpu.core import types as jt
from katib_tpu.orchestrator.orchestrator import Orchestrator as JOrchestrator
from katib_tpu.store.sqlite import SqliteObservationStore as JSqlite
from katib_tpu.ui import backend as jbackend
from katib_tpu_torch.core import types as tt
from katib_tpu_torch.costmodel import profiler
from katib_tpu_torch.orchestrator.orchestrator import Orchestrator
from katib_tpu_torch.store.base import MemoryObservationStore
from katib_tpu_torch.store.sqlite import SqliteObservationStore
from katib_tpu_torch.ui import backend, start_ui
from katib_tpu_torch.ui.backend import UiServer, _darts_graph, _enas_graph, nas_graph_for_trial
from katib_tpu_torch.utils import paths

# tier-1 runs six test processes on the same cores: one torch thread each
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _get_raw_status(port, path):
    try:
        return _get(port, path)
    except urllib.error.HTTPError as e:
        return e.code, None, e.read()


def _spec(types, name: str):
    t = types

    def trainer(ctx):
        x = float(ctx.params["x"])
        ctx.report(accuracy=1.0 - 0.1 * (x - 2.0) ** 2, step=0)

    return t.ExperimentSpec(
        name=name,
        algorithm=t.AlgorithmSpec(name="random"),
        objective=t.ObjectiveSpec(type=t.ObjectiveType.MAXIMIZE,
                                  objective_metric_name="accuracy"),
        parameters=[t.ParameterSpec("x", t.ParameterType.DOUBLE,
                                    t.FeasibleSpace(min=0.0, max=4.0))],
        max_trial_count=3,
        parallel_trial_count=1,
        train_fn=trainer,
    )


def _nas_status(workdir: str, darts_ckpt: str) -> None:
    """A journaled NAS experiment: an ENAS trial (arc in its assignment)
    and a DARTS trial (``genotype.json`` in its checkpoint dir)."""
    os.makedirs(os.path.join(workdir, "nas-exp"))
    os.makedirs(darts_ckpt)
    with open(os.path.join(darts_ckpt, "genotype.json"), "w") as f:
        json.dump({"normal": [[["sep_conv_3x3", 0], ["skip_connect", 1]],
                              [["sep_conv_3x3", 2], ["max_pool_3x3", 0]]],
                   "reduce": [[["max_pool_3x3", 0], ["max_pool_3x3", 1]]]}, f)
    with open(os.path.join(workdir, "nas-exp", "status.json"), "w") as f:
        json.dump({
            "name": "nas-exp",
            "condition": "MaxTrialsReached",
            "optimal": {"trial_name": "nas-exp-d0"},
            "trials": {
                "nas-exp-t0": {"name": "nas-exp-t0", "condition": "Succeeded",
                               "assignments": {"architecture": json.dumps([[2], [1, 1]])}},
                "nas-exp-d0": {"name": "nas-exp-d0", "condition": "Succeeded",
                               "assignments": {}, "checkpoint_dir": darts_ckpt},
                "nas-exp-x0": {"name": "nas-exp-x0", "condition": "Succeeded",
                               "assignments": {}},
            },
        }, f)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """One workdir holding a JAX run, a port run and a NAS journal, one
    sqlite store holding both runs' metrics; the port's server on loopback
    and both packages' backends over them."""
    root = tmp_path_factory.mktemp("ui")
    workdir, db = str(root / "runs"), str(root / "obs.sqlite")
    jstore = JSqlite(db)
    jexp = JOrchestrator(store=jstore, workdir=workdir).run(_spec(jt, "ui-jax"))
    store = SqliteObservationStore(db)
    texp = Orchestrator(store=store, workdir=workdir, device="cpu").run(_spec(tt, "ui-torch"))
    _nas_status(workdir, str(root / "darts-ckpt"))
    port_ui = UiServer(workdir, store, device="cpu")
    jax_ui = jbackend.UiServer(workdir, jstore)
    running = port_ui.serve(port=0)
    yield {"port": running.port, "ui": port_ui, "jax": jax_ui, "exps": (jexp, texp),
           "workdir": workdir}
    running.stop()


def _norm(reply):
    status, payload = reply
    return status, (payload if status == "html" else json.loads(json.dumps(payload, default=str)))


def _read_routes(both) -> list[str]:
    jexp, texp = both["exps"]
    routes = ["/api/experiments", "/api/experiment/nope", "/api/experiment/nope/trials",
              "/api/experiment/nope/nas", "/api/bogus", "/api/trial/no-such/metrics",
              "/api/trial/no-such/logs", "/nope", "/api/experiment/nas-exp/nas",
              "/api/experiment/nas-exp/trials"]
    for exp in (jexp, texp):
        trial = sorted(exp.trials)[0]
        routes += [f"/api/experiment/{exp.name}", f"/api/experiment/{exp.name}/trials",
                   f"/api/trial/{trial}/metrics", f"/api/trial/{trial}/logs",
                   f"/api/experiment/{exp.name}/nas"]
    return routes


READ_ROUTES = 20


def test_read_routes_cover_every_get_endpoint(both):
    assert len(_read_routes(both)) == READ_ROUTES


@pytest.mark.parametrize("i", range(READ_ROUTES))
def test_read_route_equals_the_jax_backends(both, i):
    path = _read_routes(both)[i]
    got = _norm(both["ui"].route(path, {}))
    assert got == _norm(both["jax"].route(path, {})), path
    assert got[0] in (200, 404), (path, got)


@pytest.mark.parametrize("trial", ["nas-exp-t0", "nas-exp-d0", "nas-exp-x0"])
def test_nas_graph_for_a_trial_query_equals_the_jax_backends(both, trial):
    query = {"trial": [trial]}
    got = _norm(both["ui"].route("/api/experiment/nas-exp/nas", query))
    assert got == _norm(both["jax"].route("/api/experiment/nas-exp/nas", query))
    if trial == "nas-exp-x0":
        assert got[0] == 404
    else:
        assert got[1]["type"] == ("enas" if trial.endswith("t0") else "darts")


def test_status_serves_the_ports_profiles(both, tmp_path):
    profiler.reset()
    with profiler.capture(str(tmp_path / "p"), trial="t", experiment="e", device="cpu"):
        pass
    try:
        status, _, body = _get(both["port"], "/api/status")
        payload = json.loads(body)
        _, want = both["jax"].route("/api/status", {})
        assert status == 200 and set(payload) == set(want)
        assert payload["workdir"] == both["workdir"]
        assert [(p["trial"], p["trace_dir"]) for p in payload["profiles"]] == [
            ("t", str(tmp_path / "p"))]
        assert "katib_trial_created_total" in payload["metrics"]
    finally:
        profiler.reset()


# -- the page and the HTTP layer ---------------------------------------------


def test_dashboard_html(both):
    status, ctype, body = _get(both["port"], "/")
    assert status == 200 and "text/html" in ctype
    assert b"katib-tpu" in body


def test_dashboard_is_the_ports_own_copy_of_the_jax_page():
    assert backend.DASHBOARD_HTML == jbackend.DASHBOARD_HTML
    assert backend.DASHBOARD_HTML is not jbackend.DASHBOARD_HTML


def test_list_experiments(both):
    status, _, body = _get(both["port"], "/api/experiments")
    exps = {e["name"]: e for e in json.loads(body)}
    assert status == 200 and set(exps) == {"ui-jax", "ui-torch", "nas-exp"}
    for name in ("ui-jax", "ui-torch"):
        assert exps[name]["counts"]["succeeded"] == 3
        assert exps[name]["optimal"] is not None


def test_experiment_detail_and_trials(both):
    status, _, body = _get(both["port"], "/api/experiment/ui-torch")
    assert status == 200 and len(json.loads(body)["trials"]) == 3
    status, _, body = _get(both["port"], "/api/experiment/ui-torch/trials")
    rows = json.loads(body)
    assert status == 200 and len(rows) == 3
    assert all("x" in r["assignments"] for r in rows)
    assert all("accuracy" in r["metrics"] for r in rows)


def test_trial_metrics_from_store(both):
    for exp in both["exps"]:
        trial = next(iter(exp.trials))
        status, _, body = _get(both["port"], f"/api/trial/{trial}/metrics")
        logs = json.loads(body)
        assert status == 200 and logs and logs[0]["metric_name"] == "accuracy"


def test_trial_metrics_without_a_store_is_503(tmp_path):
    got = UiServer(str(tmp_path), device="cpu").route("/api/trial/t/metrics", {})
    assert got == jbackend.UiServer(str(tmp_path)).route("/api/trial/t/metrics", {})
    assert got[0] == 503


@pytest.mark.parametrize("hooks", [
    ("function metricChart", "function nasGraph", "showTrial", "trialdetail", "/metrics",
     "/nas?trial="),
    ("w_build", "w_params", "addParamRow", "trialTemplate", "feasibleSpace", "w_algo"),
    ("flagshipRuns", "/api/flagship/progress", 'id="flagship"'),
], ids=["drilldown", "wizard", "flagship"])
def test_dashboard_carries_its_renderers(both, hooks):
    _, _, body = _get(both["port"], "/")
    page = body.decode()
    for hook in hooks:
        assert hook in page, hook


def test_unknown_routes_404(both):
    for path in ("/api/experiment/nope", "/api/bogus"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(both["port"], path)
        assert e.value.code == 404


class TestNasGraphs:
    def test_darts_graph_shape(self):
        genotype = {
            "normal": [
                [["sep_conv_3x3", 0], ["skip_connect", 1]],
                [["sep_conv_3x3", 2], ["max_pool_3x3", 0]],
            ],
            "reduce": [[["max_pool_3x3", 0], ["max_pool_3x3", 1]]],
        }
        g = _darts_graph(genotype)
        assert g == jbackend._darts_graph(genotype)
        assert g["type"] == "darts" and len(g["nodes"]) == 5 and len(g["edges"]) == 6
        assert {"from": "normal-0", "to": "normal-1", "op": "sep_conv_3x3"} in g["edges"]

    def test_enas_graph_shape(self):
        arc = [[3], [1, 1], [0, 0, 1]]
        g = _enas_graph(arc)
        assert g == jbackend._enas_graph(arc)
        assert len(g["nodes"]) == 5 and len([e for e in g["edges"] if e["op"] == "skip"]) == 2

    def test_recover_from_trial_assignment(self):
        trial = {"assignments": {"architecture": json.dumps([[2], [1, 0]])}}
        g = nas_graph_for_trial(trial)
        assert g is not None and g["type"] == "enas" and g == jbackend.nas_graph_for_trial(trial)

    def test_recover_from_genotype_file(self, tmp_path):
        (tmp_path / "genotype.json").write_text(
            json.dumps({"normal": [[["skip_connect", 0], ["none", 1]]], "reduce": []}))
        trial = {"assignments": {}, "checkpoint_dir": str(tmp_path)}
        g = nas_graph_for_trial(trial)
        assert g is not None and g["type"] == "darts" and g == jbackend.nas_graph_for_trial(trial)

    @pytest.mark.parametrize("trial", [{"assignments": {}}, {"assignments": {
        "architecture": "not json"}}], ids=["nothing", "bad-arc"])
    def test_no_artifact_returns_none(self, tmp_path, trial):
        trial = {**trial, "checkpoint_dir": str(tmp_path)}
        assert nas_graph_for_trial(trial) is None is jbackend.nas_graph_for_trial(trial)


# -- the write path --------------------------------------------------------------

EXP_YAML = """
metadata:
  name: {name}
spec:
  maxTrialCount: 2
  parallelTrialCount: 1
  objective:
    type: maximize
    objectiveMetricName: score
  algorithm:
    algorithmName: random
  parameters:
    - name: x
      parameterType: double
      feasibleSpace: {{min: "0.0", max: "1.0"}}
  trialTemplate:
    command:
      - {python}
      - -c
      - "print('score=' + str(float('${{trialParameters.x}}')))"
"""


def _yaml(name: str) -> str:
    return EXP_YAML.format(name=name, python=json.dumps(sys.executable))


def _post(port, path, payload, token=None, headers=None):
    hdrs = {"Content-Type": "application/json", **(headers or {})}
    if token:
        hdrs["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(), headers=hdrs)
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _delete(port, path, token=None):
    headers = {"Authorization": f"Bearer {token}"} if token else {}
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method="DELETE",
                                 headers=headers)
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait_condition(port, name, conditions, timeout=60.0) -> dict:
    deadline = time.time() + timeout
    while time.time() < deadline:
        s, _, body = _get_raw_status(port, f"/api/experiment/{name}")
        if s == 200 and json.loads(body).get("condition") in conditions:
            return json.loads(body)
        time.sleep(0.2)
    raise AssertionError(f"{name} never reached {conditions}")


@pytest.fixture
def served(tmp_path):
    ui = start_ui(str(tmp_path), MemoryObservationStore(), device="cpu")
    yield ui
    ui.stop()


class TestUiWritePath:
    """POST create / stop + DELETE, as the JAX backend's (``backend.go:86-181``)."""

    def test_create_runs_and_delete(self, served):
        status, reply = _post(served.port, "/api/experiments", {"yaml": _yaml("ui-created")})
        assert status == 201 and reply == {"ok": True, "name": "ui-created"}
        _wait_condition(served.port, "ui-created", ("MaxTrialsReached",))
        status, _ = _post(served.port, "/api/experiments", {"yaml": _yaml("ui-created")})
        assert status == 409  # the journal exists
        status, _ = _delete(served.port, "/api/experiment/ui-created")
        assert status == 200
        assert _get_raw_status(served.port, "/api/experiment/ui-created")[0] == 404

    def test_create_runs_on_the_servers_device(self, tmp_path, monkeypatch):
        seen = []
        orig = Orchestrator.__init__

        def recording(self, *args, **kwargs):
            seen.append(kwargs.get("device"))
            orig(self, *args, **kwargs)

        monkeypatch.setattr(Orchestrator, "__init__", recording)
        ui = UiServer(str(tmp_path), MemoryObservationStore(), device="cpu")
        assert ui.route_post("/api/experiments", {"yaml": _yaml("dev")})[0] == 201
        ui._threads["dev"].join(timeout=60)
        assert seen == [torch.device("cpu")]
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            UiServer(str(tmp_path))

    def test_create_requires_command(self, served):
        bad = _yaml("no-cmd").replace("trialTemplate", "ignored")
        status, reply = _post(served.port, "/api/experiments", {"yaml": bad})
        assert status == 400 and "command" in reply["error"]

    def test_create_refuses_bad_yaml_and_specs(self, served):
        for payload in ({"yaml": "a: [1"}, {"yaml": "[1, 2]"}, {"metadata": {"name": "../x"}}):
            status, reply = _post(served.port, "/api/experiments", payload)
            assert status == 400 and reply["error"], payload

    def test_stop_winds_down_running_experiment(self, served):
        slow = _yaml("ui-slow").replace(
            "print('score=' + str(float('${trialParameters.x}')))",
            "import time; print('score=0.5', flush=True); time.sleep(60)",
        ).replace("maxTrialCount: 2", "maxTrialCount: 50")
        status, _ = _post(served.port, "/api/experiments", {"yaml": slow})
        assert status == 201
        _wait_condition(served.port, "ui-slow", ("Created", "Running"))
        status, reply = _post(served.port, "/api/experiment/ui-slow/stop", {})
        assert status == 202 and reply == {"ok": True, "stopping": "ui-slow"}
        _wait_condition(served.port, "ui-slow", ("Failed",))
        served_ui_thread_done = time.time() + 30
        while time.time() < served_ui_thread_done:
            status, _ = _delete(served.port, "/api/experiment/ui-slow")
            if status == 200:
                break
            time.sleep(0.2)
        assert status == 200
        status, _ = _post(served.port, "/api/experiment/ui-slow/stop", {})
        assert status == 409  # not running here any more

    def test_post_rejects_non_json_content_type(self, served):
        status, _ = _post(served.port, "/api/experiments", {"yaml": _yaml("csrf")},
                          headers={"Content-Type": "text/plain"})
        assert status == 415
        assert _get_raw_status(served.port, "/api/experiment/csrf")[0] == 404

    def test_delete_refuses_foreign_running_journal(self, served, tmp_path):
        exp_dir = tmp_path / "other-proc"
        os.makedirs(exp_dir)
        (exp_dir / "status.json").write_text(json.dumps(
            {"name": "other-proc", "condition": "Running", "trials": {}}))
        status, reply = _delete(served.port, "/api/experiment/other-proc")
        assert status == 409 and "force" in reply["error"] and exp_dir.exists()
        status, _ = _delete(served.port, "/api/experiment/other-proc?force=1")
        assert status == 200 and not exp_dir.exists()
        assert _delete(served.port, "/api/experiment/other-proc")[0] == 404

    def test_trial_logs_served_after_run(self, served):
        status, _ = _post(served.port, "/api/experiments", {"yaml": _yaml("logs-exp")})
        assert status == 201
        _wait_condition(served.port, "logs-exp", ("MaxTrialsReached",))
        _, _, body = _get(served.port, "/api/experiment/logs-exp/trials")
        trial = json.loads(body)[0]["name"]
        s, _, body = _get(served.port, f"/api/trial/{trial}/logs")
        assert s == 200 and "score=" in json.loads(body)["log"]
        assert _get_raw_status(served.port, "/api/trial/no-such-trial/logs")[0] == 404

    def test_tokenless_writes_reject_foreign_host(self, served):
        status, reply = _post(served.port, "/api/experiments", {"yaml": _yaml("rebind")},
                              headers={"Host": "evil.example"})
        assert status == 403 and "DNS-rebinding" in reply["error"]
        status, _ = _post(served.port, "/api/experiments", {"yaml": _yaml("rebind")})
        assert status == 201
        _wait_condition(served.port, "rebind", ("MaxTrialsReached",))

    def test_write_auth_token(self, tmp_path):
        ui = start_ui(str(tmp_path), token="hunter2", device="cpu")
        try:
            status, _ = _post(ui.port, "/api/experiments", {"yaml": _yaml("authed")})
            assert status == 401
            assert _get(ui.port, "/api/experiments")[0] == 200  # reads stay open
            assert _delete(ui.port, "/api/experiment/authed", token="wrong")[0] == 401
            status, _ = _post(ui.port, "/api/experiments", {"yaml": _yaml("authed")},
                              token="hunter2")
            assert status == 201
            _wait_condition(ui.port, "authed", ("MaxTrialsReached",))
        finally:
            ui.stop()

    def test_a_token_accepts_writes_on_other_hosts(self, tmp_path):
        ui = start_ui(str(tmp_path), token="hunter2", device="cpu")
        try:
            status, _ = _post(ui.port, "/api/experiments", {"yaml": _yaml("remote-host")},
                              token="hunter2", headers={"Host": "evil.example"})
            assert status == 201
            _wait_condition(ui.port, "remote-host", ("MaxTrialsReached",))
        finally:
            ui.stop()


# -- flagship progress: the port's root only -------------------------------------


def test_flagship_progress_grouped_by_config_and_garbage_tolerant(tmp_path):
    art = tmp_path / "art" / "flagship"
    art.mkdir(parents=True)
    rows = [
        {"epoch": 0, "accuracy": 0.5, "config": "b64", "platform": "gpu"},
        {"epoch": 1, "accuracy": 0.6, "config": "b64", "platform": "gpu"},
        {"epoch": 0, "accuracy": 0.1, "config": "b16", "platform": "cpu"},
    ]
    (art / "run_progress.jsonl").write_text(
        "\n".join(json.dumps(r) for r in rows) + "\nnot json\nnull\n[1,2]\n")
    with open(art / "run_progress.jsonl", "ab") as f:
        f.write(b'{"epoch": 9, "accuracy": 0.9, "config": "b64\xc3')
    ui = UiServer(str(tmp_path), artifacts_dir=str(tmp_path / "art"), device="cpu")
    status, payload = ui.route("api/flagship/progress", {})
    assert status == 200
    assert [r["epoch"] for r in payload["runs"]["b64"]] == [0, 1]
    assert payload["runs"]["b16"][0]["platform"] == "cpu"
    assert (status, payload) == jbackend.UiServer(
        str(tmp_path), artifacts_dir=str(tmp_path / "art")).route("api/flagship/progress", {})


def test_flagship_missing_stream_is_empty_not_error(tmp_path):
    ui = UiServer(str(tmp_path), artifacts_dir=str(tmp_path / "nope"), device="cpu")
    assert ui.route("api/flagship/progress", {}) == (200, {"runs": {}})


def test_flagship_progress_reads_only_the_ports_root(tmp_path, monkeypatch):
    """By default the port reads its own tree, never the repository's
    ``artifacts/`` of the JAX package's TPU runs; ``KATIB_ARTIFACTS_DIR``
    moves both packages' readers together."""
    monkeypatch.delenv("KATIB_ARTIFACTS_DIR", raising=False)
    assert paths.artifacts_root() == paths.DEFAULT_ROOT
    assert os.path.realpath(paths.DEFAULT_ROOT) != os.path.realpath(os.path.join(ROOT, "artifacts"))
    got = UiServer(str(tmp_path), device="cpu").route("api/flagship/progress", {})
    assert got == UiServer(str(tmp_path), artifacts_dir=paths.DEFAULT_ROOT,
                           device="cpu").route("api/flagship/progress", {})
    jax_default = jbackend.UiServer(str(tmp_path)).route("api/flagship/progress", {})
    assert got != jax_default and jax_default[1]["runs"]  # the JAX package's TPU stream
    monkeypatch.setenv("KATIB_ARTIFACTS_DIR", str(tmp_path / "moved"))
    os.makedirs(tmp_path / "moved" / "flagship")
    (tmp_path / "moved" / "flagship" / "run_progress.jsonl").write_text(
        json.dumps({"epoch": 0, "accuracy": 0.5, "config": "c"}) + "\n")
    got = UiServer(str(tmp_path), device="cpu").route("api/flagship/progress", {})
    assert got == jbackend.UiServer(str(tmp_path)).route("api/flagship/progress", {})
    assert [r["epoch"] for r in got[1]["runs"]["c"]] == [0]


# -- the ui verb ------------------------------------------------------------------


def test_ui_verb_serves_on_loopback_until_interrupted(tmp_path):
    """``python -m katib_tpu_torch ui --port 0 --device cpu``: the first
    line names the loopback address, the API answers there, and SIGINT
    stops it with exit 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "katib_tpu_torch", "ui", "--workdir", str(tmp_path), "--port",
         "0", "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"})
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("katib-tpu dashboard: http://127.0.0.1:"), line
        assert line.endswith("(writes: open)")
        port = int(line.split(":")[3].split("/")[0])
        status, _, body = _get(port, "/api/status")
        assert status == 200 and json.loads(body)["profiles"] == []
        assert json.loads(_get(port, "/api/experiments")[2]) == []
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
