"""The port's suggestion service (``katib_tpu_torch/suggest/service.py``)
against the JAX package's, on the CPU: the counterpart of
``tests/test_suggest_service.py``.

The wire dicts of both packages are equal for the same YAML (NAS config
included); a port client drives a JAX service and a JAX client a port
service, each giving the assignments of the service side's in-process run;
replay by ``request_id``, eviction, 409/410, bearer auth, the write guards,
and the refusals of nested ``remote`` and ``pbt`` behave as in the JAX
package; the composer spawns ``python -m katib_tpu_torch suggest-server
--device cpu`` with JAX and the JAX package unimportable in the child; and
ENAS behind a port service samples round 0 (and trains into round 1) as
the in-process suggester does."""

from __future__ import annotations

import json
import os
import sys
import urllib.error
import urllib.request
import warnings
from types import SimpleNamespace

import pytest
import torch
import yaml

from katib_tpu.core import types as jtypes
from katib_tpu.orchestrator import Orchestrator as JOrchestrator
from katib_tpu.sdk.yaml_spec import experiment_spec_from_dict as j_from_dict
from katib_tpu.suggest import service as jservice
from katib_tpu_torch.core import types as ttypes
from katib_tpu_torch.orchestrator import Orchestrator
from katib_tpu_torch.sdk.yaml_spec import experiment_spec_from_dict as t_from_dict
from katib_tpu_torch.suggest import base as tbase
from katib_tpu_torch.suggest import service as tservice
from katib_tpu_torch.suggest.service import (
    RemoteSuggester,
    SuggestionService,
    proposal_from_wire,
    proposal_to_wire,
    serve_suggestions,
    spec_to_wire,
    trial_from_wire,
    trial_to_wire,
)
from katib_tpu_torch.utils import observability as obs

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "katib_tpu")
PKGS = {
    "jax": SimpleNamespace(types=jtypes, service=jservice, from_dict=j_from_dict,
                           orch=lambda **kw: JOrchestrator(**kw),
                           serve=lambda **kw: jservice.serve_suggestions(**kw)),
    "torch": SimpleNamespace(types=ttypes, service=tservice, from_dict=t_from_dict,
                             orch=lambda **kw: Orchestrator(device="cpu", **kw),
                             serve=lambda **kw: serve_suggestions(device="cpu", **kw)),
}


def _spec(algorithm="random", settings=None, pkg="torch", **kw):
    t = PKGS[pkg].types
    defaults = dict(
        name=kw.pop("name", "svc-exp"),
        algorithm=t.AlgorithmSpec(name=algorithm, settings=settings or {}),
        objective=t.ObjectiveSpec(type=t.ObjectiveType.MAXIMIZE,
                                  objective_metric_name="accuracy"),
        parameters=[
            t.ParameterSpec("x", t.ParameterType.DOUBLE, t.FeasibleSpace(min=0.0, max=4.0)),
            t.ParameterSpec("opt", t.ParameterType.CATEGORICAL,
                            t.FeasibleSpace(list=("sgd", "adam"))),
        ],
        max_trial_count=4,
        parallel_trial_count=2,
    )
    defaults.update(kw)
    return t.ExperimentSpec(**defaults)


def _yaml_doc(rel: str) -> dict:
    """A shipped spec without its trial template (the wire carries none)."""
    with open(os.path.join(ROOT, "examples", rel)) as f:
        doc = yaml.safe_load(f)
    doc["spec"].pop("trialTemplate", None)
    return doc


def _post(port, path, payload, headers=None, scheme="http", context=None):
    req = urllib.request.Request(
        f"{scheme}://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30, context=context) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


@pytest.fixture
def service():
    svc = serve_suggestions(device="cpu")
    yield svc
    svc.stop()


class TestWireFormat:
    @pytest.mark.parametrize("rel", ["nas/enas.yaml", "hp-tuning/tpe.yaml",
                                     "hp-tuning/hyperband.yaml", "hp-tuning/grid.yaml"])
    def test_both_packages_write_the_same_wire_spec(self, rel):
        doc = _yaml_doc(rel)
        want = jservice.spec_to_wire(j_from_dict(doc))
        got = spec_to_wire(t_from_dict(doc))
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
        if rel == "nas/enas.yaml":
            assert got["nasConfig"]["graphConfig"]["numLayers"] == 4
            assert [o["operationType"] for o in got["nasConfig"]["operations"]] == [
                "separable_convolution", "convolution", "max_pooling", "avg_pooling"]

    def test_spec_roundtrip(self):
        spec = _spec(algorithm="tpe", settings={"n_startup_trials": "3"})
        back = t_from_dict(json.loads(json.dumps(spec_to_wire(spec))))
        assert back.name == spec.name and back.algorithm.name == "tpe"
        assert back.algorithm.settings == {"n_startup_trials": "3"}
        assert [p.name for p in back.parameters] == ["x", "opt"]
        assert back.parameters[0].feasible.max == 4.0
        assert back.parameters[1].feasible.list == ("sgd", "adam")

    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_trial_and_proposal_cross_the_packages(self, writer):
        """What one package writes, the other reads back to the same dict."""
        reader = "torch" if writer == "jax" else "jax"
        w, r = PKGS[writer], PKGS[reader]
        t = w.types
        trial = t.Trial(
            name="t-1",
            spec=t.TrialSpec(assignments=[t.ParameterAssignment("x", 1.5)],
                             labels={"pbt-generation": "2"}),
            condition=t.TrialCondition.SUCCEEDED,
            observation=t.Observation(metrics=[t.Metric(name="accuracy", value=0.9,
                                                        latest=0.9)]),
            start_time=12.5,
        )
        wire = json.loads(json.dumps(w.service.trial_to_wire(trial)))
        back = r.service.trial_from_wire(wire)
        assert back.condition.value == "Succeeded" and back.params() == {"x": 1.5}
        assert back.labels == {"pbt-generation": "2"}
        assert back.observation.get("accuracy").value == 0.9
        assert r.service.trial_to_wire(back) == wire
        p = t.TrialAssignmentSet(
            assignments=[t.ParameterAssignment("x", 2.0)], name="exp-abc", labels={"gen": "1"},
            early_stopping_rules=[t.EarlyStoppingRule("accuracy", 0.4, t.ComparisonOp.LESS,
                                                      start_step=3)])
        wire = json.loads(json.dumps(w.service.proposal_to_wire(p)))
        back = r.service.proposal_from_wire(wire)
        assert back.name == "exp-abc" and back.as_dict() == {"x": 2.0}
        assert back.early_stopping_rules[0].comparison.value == "less"
        assert back.early_stopping_rules[0].start_step == 3
        assert r.service.proposal_to_wire(back) == wire

    def test_port_roundtrips(self):
        t = ttypes
        trial = t.Trial(name="t-2", spec=t.TrialSpec(assignments=[]),
                        condition=t.TrialCondition.RUNNING)
        assert trial_from_wire(trial_to_wire(trial)).condition is t.TrialCondition.RUNNING
        p = t.TrialAssignmentSet(assignments=[t.ParameterAssignment("x", 3.0)])
        assert proposal_from_wire(proposal_to_wire(p)).as_dict() == {"x": 3.0}


class TestServiceEndpoints:
    def test_healthz(self, service):
        with urllib.request.urlopen(f"http://127.0.0.1:{service.port}/healthz") as r:
            assert json.loads(r.read())["status"] == "serving"

    def test_validate_rejects_bad_settings(self):
        svc = SuggestionService(device="cpu")
        status, reply = svc.validate({"spec": spec_to_wire(_spec(algorithm="pbt"))})
        assert status == 400 and "pbt" in reply["error"]
        status, reply = svc.validate({"spec": spec_to_wire(_spec())})
        assert status == 200 and reply["ok"]

    def test_suggestions_stateful_per_experiment(self):
        svc = SuggestionService(device="cpu")
        wire = spec_to_wire(_spec(algorithm="tpe"))
        before = obs.suggestion_latency.get_count(algorithm="tpe")
        status, r1 = svc.suggestions({"spec": wire, "trials": [], "count": 2})
        assert status == 200 and len(r1["suggestions"]) == 2
        assert wire["name"] in svc._entries  # instance retained
        # the algorithm's own think time, one sample per call
        assert obs.suggestion_latency.get_count(algorithm="tpe") == before + 1

    def test_reused_name_with_new_spec_rebuilds(self):
        svc = SuggestionService(device="cpu")
        wire = spec_to_wire(_spec(algorithm="tpe"))
        svc.suggestions({"spec": wire, "trials": [], "count": 1})
        first = svc._entries[wire["name"]].suggester
        svc.suggestions({"spec": spec_to_wire(_spec(algorithm="random")), "trials": [],
                         "count": 1})
        assert svc._entries[wire["name"]].suggester is not first

    def test_forget_endpoint_evicts(self, service):
        wire = spec_to_wire(_spec())
        assert _post(service.port, "/api/v1/suggestions",
                     {"spec": wire, "trials": [], "count": 1})[0] == 200
        req = urllib.request.Request(
            f"http://127.0.0.1:{service.port}/api/v1/experiment/{wire['name']}",
            method="DELETE")
        with urllib.request.urlopen(req) as r:
            assert json.loads(r.read())["ok"]
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 404

    def test_the_service_runs_on_cuda_unless_told_otherwise(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            SuggestionService()
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            serve_suggestions()
        assert SuggestionService(device="cpu").device == torch.device("cpu")


def _trainer(ctx):
    x = float(ctx.params["x"])
    ctx.report(accuracy=1.0 - 0.1 * (x - 2.0) ** 2 + (0.05 if ctx.params["opt"] == "adam" else 0),
               step=0)


def _assignments(exp) -> list:
    trials = sorted(exp.trials.values(), key=lambda t: (t.start_time, t.name))
    return [sorted((a.name, a.value) for a in t.spec.assignments) for t in trials]


class TestAcrossPackages:
    @pytest.mark.parametrize("client,server", [("torch", "jax"), ("jax", "torch")])
    @pytest.mark.parametrize("algorithm", ["tpe", "random"])
    def test_client_of_one_package_drives_a_service_of_the_other(self, client, server,
                                                                 algorithm, tmp_path):
        settings = {"random_state": "7"}
        if algorithm == "tpe":
            settings["n_startup_trials"] = "2"
        kw = dict(name=f"cross-{algorithm}", max_trial_count=5, parallel_trial_count=1,
                  async_orch=False, train_fn=_trainer)
        svc = PKGS[server].serve()
        try:
            remote = _spec("remote", dict(settings, endpoint=f"http://127.0.0.1:{svc.port}",
                                          algorithm=algorithm), pkg=client, **kw)
            got = PKGS[client].orch(workdir=str(tmp_path / "remote")).run(remote)
        finally:
            svc.stop()
        local = _spec(algorithm, settings, pkg=server, **kw)
        want = PKGS[server].orch(workdir=str(tmp_path / "local")).run(local)
        assert got.completed_count == want.completed_count == 5
        assert _assignments(got) == _assignments(want)


class TestRemoteSuggester:
    def test_remote_grid_exhaustion_flows_through(self, service, tmp_path):
        t = ttypes

        def trainer(ctx):
            ctx.report(accuracy=float(ctx.params["x"]), step=0)

        spec = t.ExperimentSpec(
            name="remote-grid",
            algorithm=t.AlgorithmSpec(name="remote", settings={
                "endpoint": f"http://127.0.0.1:{service.port}", "algorithm": "grid"}),
            objective=t.ObjectiveSpec(type=t.ObjectiveType.MAXIMIZE,
                                      objective_metric_name="accuracy"),
            parameters=[t.ParameterSpec("x", t.ParameterType.DOUBLE,
                                        t.FeasibleSpace(min=0.0, max=2.0, step=1.0))],
            max_trial_count=10,  # grid only has 3 points; exhaustion (410) ends it
            parallel_trial_count=2,
            train_fn=trainer,
        )
        exp = Orchestrator(workdir=str(tmp_path), device="cpu").run(spec)
        assert exp.condition is t.ExperimentCondition.SUCCEEDED
        assert exp.completed_count == 3

    def test_not_ready_is_409_and_unreachable_is_not_ready(self, tmp_path):
        """ENAS refuses a round while the last one runs: 409, which the
        client raises as NotReady; a dead endpoint is NotReady too, after
        the client's retries."""
        svc = SuggestionService(device="cpu")
        spec = _enas_spec("remote-enas-409")
        wire = spec_to_wire(spec)
        s0, r0 = svc.suggestions({"spec": wire, "trials": [], "count": 2})
        assert s0 == 200 and len(r0["suggestions"]) == 2
        running = [
            trial_to_wire(ttypes.Trial(name=f"r{i}", spec=ttypes.TrialSpec(
                assignments=[], labels=p["labels"]), condition=ttypes.TrialCondition.RUNNING))
            for i, p in enumerate(r0["suggestions"])]
        status, reply = svc.suggestions({"spec": wire, "trials": running, "count": 2})
        assert status == 409 and reply["code"] == "not_ready"
        dead = RemoteSuggester(_spec("remote", {"endpoint": "http://127.0.0.1:9",
                                                "algorithm": "random"}))
        with pytest.raises(tbase.SuggestionsNotReady, match="unreachable"):
            dead.get_suggestions(ttypes.Experiment(spec=dead.spec), 1)

    def test_remote_requires_endpoint_and_algorithm(self):
        with pytest.raises(tbase.SuggesterError, match="endpoint"):
            tbase.make_suggester(_spec("remote", {"algorithm": "tpe"}))
        with pytest.raises(tbase.SuggesterError, match="algorithm"):
            tbase.make_suggester(_spec("remote", {"endpoint": "http://x:1"}))

    def test_remote_pbt_rejected(self):
        with pytest.raises(tbase.SuggesterError, match="share a filesystem"):
            tbase.make_suggester(_spec("remote", {"endpoint": "http://x:1", "algorithm": "pbt"}))

    def test_orchestrator_evicts_remote_state_on_completion(self, service, tmp_path):
        spec = _spec("remote", {"endpoint": f"http://127.0.0.1:{service.port}",
                                "algorithm": "random"},
                     name="remote-evict", max_trial_count=2, train_fn=_trainer)
        exp = Orchestrator(workdir=str(tmp_path), device="cpu").run(spec)
        assert exp.completed_count == 2
        # the DELETE teardown removed the per-experiment entry: 404 == gone
        req = urllib.request.Request(
            f"http://127.0.0.1:{service.port}/api/v1/experiment/remote-evict",
            method="DELETE")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 404

    def test_settings_written_back_and_connection_settings_stripped(self, service,
                                                                     monkeypatch):
        seen = {}
        real = SuggestionService.suggestions

        def spy(self, payload):
            seen.update(payload)
            return real(self, payload)

        monkeypatch.setattr(SuggestionService, "suggestions", spy)
        spec = _spec("remote", {"endpoint": f"http://127.0.0.1:{service.port}",
                                "algorithm": "random", "token": "t", "ca_cert": ""})
        exp = ttypes.Experiment(spec=spec)
        exp.algorithm_settings = {"endpoint": "x", "carried": "1"}
        (p,) = RemoteSuggester(spec).get_suggestions(exp, 1)
        assert seen["spec"]["algorithm"] == {"name": "random", "settings": {}}
        assert seen["settings"] == {"carried": "1"} and seen["request_id"]
        assert set(p.as_dict()) == {"x", "opt"}
        assert exp.algorithm_settings["carried"] == "1"


class TestAuthAndIdempotency:
    def test_token_gates_api_but_not_healthz(self):
        svc = serve_suggestions(token="s3cret", device="cpu")
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{svc.port}/healthz") as r:
                assert r.status == 200
            payload = {"spec": spec_to_wire(_spec())}
            assert _post(svc.port, "/api/v1/validate", payload)[0] == 401
            assert _post(svc.port, "/api/v1/validate", payload,
                         {"Authorization": "Bearer wrong"})[0] == 401
            status, reply = _post(svc.port, "/api/v1/validate", payload,
                                  {"Authorization": "Bearer s3cret"})
            assert status == 200 and reply["ok"]
            # a remote client with the token (setting or environment) gets through
            spec = _spec("remote", {"endpoint": f"http://127.0.0.1:{svc.port}",
                                    "algorithm": "random", "token": "s3cret"})
            assert len(RemoteSuggester(spec).get_suggestions(ttypes.Experiment(spec=spec), 2)) == 2
        finally:
            svc.stop()

    def test_request_id_replays_not_reapplies(self):
        calls = {"n": 0}

        @tbase.register("counting-stub")
        class CountingStub(tbase.Suggester):
            def get_suggestions(self, experiment, count):
                calls["n"] += 1
                return [ttypes.TrialAssignmentSet(
                    assignments=[ttypes.ParameterAssignment("x", float(calls["n"]))])]

        try:
            svc = SuggestionService(device="cpu")
            wire = spec_to_wire(_spec(algorithm="counting-stub", name="idem-exp"))
            payload = {"spec": wire, "trials": [], "count": 1, "request_id": "rid-1"}
            s1, r1 = svc.suggestions(payload)
            s2, r2 = svc.suggestions(payload)  # a transport retry
            assert s1 == s2 == 200 and r1 == r2 and calls["n"] == 1
            _, r3 = svc.suggestions(dict(payload, request_id="rid-2"))
            assert calls["n"] == 2 and r3 != r1
        finally:
            tbase._REGISTRY.pop("counting-stub", None)


class TestServiceGuards:
    def test_nested_remote_rejected(self):
        svc = SuggestionService(device="cpu")
        wire = spec_to_wire(_spec("remote", {"endpoint": "auto", "algorithm": "tpe"},
                                  name="nested"))
        status, reply = svc.validate({"spec": wire})
        assert status == 400 and "remote" in reply["error"]
        status, reply = svc.suggestions({"spec": wire, "trials": [], "count": 1})
        assert status == 400 and "remote" in reply["error"]

    def test_validate_does_not_instantiate(self):
        constructed = {"n": 0}

        @tbase.register("spawny-stub")
        class SpawnyStub(tbase.Suggester):
            def __init__(self, spec):
                constructed["n"] += 1
                super().__init__(spec)

            def get_suggestions(self, experiment, count):
                return []

        try:
            svc = SuggestionService(device="cpu")
            status, _ = svc.validate({"spec": spec_to_wire(_spec("spawny-stub"))})
            assert status == 200 and constructed["n"] == 0
        finally:
            tbase._REGISTRY.pop("spawny-stub", None)

    @pytest.mark.parametrize("pkg", ["jax", "torch"])
    def test_write_guards(self, pkg):
        """415 for a write that is not JSON, 403 for a foreign Host on a
        token-less service; the same codes from both packages."""
        svc = PKGS[pkg].serve()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{svc.port}/api/v1/validate", data=b"{}",
                headers={"Content-Type": "text/plain"})
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=5)
            assert e.value.code == 415
            req = urllib.request.Request(
                f"http://127.0.0.1:{svc.port}/api/v1/validate", data=b"{}",
                headers={"Content-Type": "application/json", "Host": "evil.example"})
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=5)
            assert e.value.code == 403
        finally:
            svc.stop()


def _block_child_imports(tmp_path, monkeypatch) -> None:
    """Make JAX and the JAX package unimportable in every child interpreter
    (a ``sitecustomize`` on ``PYTHONPATH``, which the composer keeps behind
    the port's root)."""
    site = tmp_path / "blocker"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        f"import sys\nfor name in {BANNED!r}:\n    sys.modules[name] = None\n")
    monkeypatch.setenv("PYTHONPATH", str(site))


class TestComposerLifecycle:
    @pytest.mark.parametrize("tls", ["tls", "plain"])
    def test_auto_spawn_health_gate_teardown(self, tls, tmp_path, monkeypatch):
        """``endpoint: auto`` spawns a private ``suggest-server --device
        cpu`` child (JAX blocked in it), gates on its health, serves through
        it and tears it down with its cert dir and log; without
        ``cryptography`` it warns and serves plain HTTP."""
        _block_child_imports(tmp_path, monkeypatch)
        if tls == "plain":
            monkeypatch.setitem(sys.modules, "cryptography", None)
        spec = _spec("remote", {"endpoint": "auto", "algorithm": "tpe"}, name="auto-exp")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            suggester = tbase.make_suggester(spec)
        local = suggester._local
        try:
            assert local is not None and local._proc.poll() is None
            argv = local._proc.args
            assert argv[1:4] == ["-m", "katib_tpu_torch", "suggest-server"]
            assert argv[argv.index("--device") + 1] == "cpu"
            assert local.token not in " ".join(argv)  # the token rides the environment
            if tls == "tls":
                assert suggester.endpoint.startswith("https://127.0.0.1:")
                assert local.ca_cert and os.path.exists(local.ca_cert)
            else:
                assert suggester.endpoint.startswith("http://127.0.0.1:")
                assert any(issubclass(w.category, RuntimeWarning) and "cryptography"
                           in str(w.message) for w in caught)
            props = suggester.get_suggestions(ttypes.Experiment(spec=spec), 2)
            assert len(props) == 2
            cert_dir, log = getattr(local, "_cert_dir", None), local._log.name
        finally:
            suggester.close(ttypes.Experiment(spec=spec))
        assert local._proc.poll() is not None
        assert not os.path.exists(log)
        assert cert_dir is None or not os.path.exists(cert_dir)

    def test_early_exit_reports_the_log_tail(self, tmp_path, monkeypatch):
        """A child that dies before it is healthy fails the composer with its
        output, and leaves nothing behind."""
        _block_child_imports(tmp_path, monkeypatch)
        (tmp_path / "blocker" / "sitecustomize.py").write_text(
            "import os\nprint('child refuses to start', flush=True)\nos._exit(3)\n")
        with pytest.raises(RuntimeError, match="rc=3") as e:
            tservice.LocalSuggesterProcess(readiness_timeout=30.0, tls=False)
        assert "child refuses to start" in str(e.value)

    def test_orchestrator_e2e_with_auto_endpoint(self, tmp_path, monkeypatch):
        _block_child_imports(tmp_path, monkeypatch)
        spec = _spec("remote", {"endpoint": "auto", "algorithm": "random"}, name="auto-e2e",
                     max_trial_count=3, train_fn=_trainer)
        exp = Orchestrator(workdir=str(tmp_path / "runs"), device="cpu").run(spec)
        assert exp.condition is ttypes.ExperimentCondition.MAX_TRIALS_REACHED
        assert exp.succeeded_count == 3


def _enas_spec(name: str, pkg: str = "torch"):
    spec = PKGS[pkg].from_dict(_yaml_doc("nas/enas.yaml"))
    spec.name = name
    return spec


class TestEnasBehindTheService:
    def test_rounds_equal_the_in_process_suggester(self, service):
        """Round 0 through a port service equals a fresh in-process
        ``EnasSuggester`` of the same spec on the CPU, and so does round 1,
        after the served controller trained on round 0's reward."""
        from katib_tpu_torch.nas.enas.service import EnasSuggester

        spec = _enas_spec("enas-remote")
        local = EnasSuggester(_enas_spec("enas-remote"), device="cpu")
        remote_spec = _enas_spec("enas-remote")
        remote_spec.algorithm = ttypes.AlgorithmSpec(name="remote", settings={
            **spec.algorithm.settings, "endpoint": f"http://127.0.0.1:{service.port}",
            "algorithm": "enas"})
        remote = RemoteSuggester(remote_spec)
        exps = {"local": ttypes.Experiment(spec=spec),
                "remote": ttypes.Experiment(spec=remote_spec)}
        rounds = {}
        for key, sug in (("local", local), ("remote", remote)):
            exp, got = exps[key], []
            for r in range(2):
                props = sug.get_suggestions(exp, 4)
                got.append([(p.as_dict(), p.labels) for p in props])
                for i, p in enumerate(props):  # settle the round
                    exp.trials[f"{key}-{r}-{i}"] = ttypes.Trial(
                        name=f"{key}-{r}-{i}",
                        spec=ttypes.TrialSpec(assignments=list(p.assignments),
                                              labels=dict(p.labels)),
                        condition=ttypes.TrialCondition.SUCCEEDED,
                        observation=ttypes.Observation(metrics=[
                            ttypes.Metric(name="accuracy", value=0.1 * (i + 1), latest=0.1)]),
                        start_time=float(r * 10 + i))
            rounds[key] = got
        assert [[lab["enas-round"] for _, lab in rnd] for rnd in rounds["remote"]] == [
            ["0"] * 4, ["1"] * 4]
        assert rounds["remote"][0] == rounds["local"][0]
        assert rounds["remote"][1] == rounds["local"][1]
        remote.close(exps["remote"])

    def test_a_nas_spec_behind_remote_passes_validation(self):
        """``enas.yaml`` over ``remote`` names no ``parameters``: the port
        validates it as the NAS experiment it serves; the JAX package checks
        the name ``remote`` and refuses it (ROADMAP F12, fixed in the port
        only)."""
        from katib_tpu.core.validation import ValidationError as JValidationError
        from katib_tpu.core.validation import validate_experiment as j_validate
        from katib_tpu_torch.core.validation import ValidationError, validate_experiment

        specs = {}
        for pkg in PKGS:
            spec = _enas_spec("enas-behind-remote", pkg)
            spec.algorithm = PKGS[pkg].types.AlgorithmSpec(name="remote", settings={
                "endpoint": "http://127.0.0.1:9", "algorithm": "enas"})
            spec.train_fn = _trainer
            specs[pkg] = spec
        with pytest.raises(JValidationError, match="parameters must be non-empty"):
            j_validate(specs["jax"])
        validate_experiment(specs["torch"])
        specs["torch"].nas_config = None
        with pytest.raises(ValidationError, match="'enas' requires nas_config"):
            validate_experiment(specs["torch"])

    def test_the_served_controller_runs_on_the_services_device(self):
        svc = SuggestionService(device="cpu")
        wire = spec_to_wire(_enas_spec("enas-device"))
        assert svc.suggestions({"spec": wire, "trials": [], "count": 1})[0] == 200
        sug = svc._entries["enas-device"].suggester
        assert type(sug).__name__ == "EnasSuggester" and sug.device == torch.device("cpu")
