"""Suggestion algorithms as standalone services + the client-side proxy
(port of ``katib_tpu/suggest/service.py``).

The reference runs every algorithm as a per-experiment gRPC Deployment
(composer ``composer.go:72``) that the controller dials through
``SyncAssignments`` (``suggestionclient.go:83``: convert CRDs→proto, call
``GetSuggestions``, write mutated algorithm settings back).  The default is
in-process (suggest/base.py), but the service form still matters: a
long-lived ENAS controller on its own GPU, one suggester shared by many
orchestrators, or isolation of heavyweight algorithm state.

This module keeps the same three-call contract over plain HTTP/JSON:

- ``POST /api/v1/validate``     {spec}                       ↔ ValidateAlgorithmSettings
- ``POST /api/v1/suggestions``  {spec, trials, settings, count} ↔ GetSuggestions
- ``GET  /healthz``                                          ↔ gRPC health servicer

The server is **stateful per experiment** (hyperopt-store/ENAS-session/PBT-
queue analogs live as the real Suggester instance keyed by experiment name);
the reply carries the mutated ``algorithm_settings`` so stateless algorithms
(Hyperband) round-trip their state through the caller exactly like the
reference's state-in-CR trick (``suggestionclient.go:194-196``).

Client side, ``RemoteSuggester`` registers as algorithm ``"remote"``::

    algorithm:
      name: remote
      settings: {endpoint: "http://host:6789", algorithm: tpe}

so the orchestrator treats a remote service like any other suggester,
including its NotReady/Exhausted flow control (HTTP 409/410).

The wire format is the JAX package's, byte for byte: a client of either
package talks to a service of either package.  The port adds one thing,
the device: ``SuggestionService(device=None)`` resolves it as every entry
point does (``cuda`` unless the caller names the CPU) and hands it to
``make_suggester``, so a suggester that computes on a device (the ENAS
controller) runs where the service runs.  One service may serve several
experiments whose trials capture CUDA graphs on the same card; its
suggesters follow the capture rule of ``compile/prewarm.py`` (their device
work waits on their own stream only, ``nas/enas/service.py``).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from katib_tpu_torch.core.types import (
    ComparisonOp,
    EarlyStoppingRule,
    Experiment,
    ExperimentSpec,
    Metric,
    Observation,
    ParameterAssignment,
    Trial,
    TrialAssignmentSet,
    TrialCondition,
    TrialSpec,
)
from katib_tpu_torch.device import resolve_device
from katib_tpu_torch.suggest.base import (
    SearchExhausted,
    Suggester,
    SuggesterError,
    SuggestionsNotReady,
    make_suggester,
    register,
)
from katib_tpu_torch.utils import observability as obs
from katib_tpu_torch.utils import tracing

# ---------------------------------------------------------------------------
# wire format (flat dict shapes; spec side reuses sdk.yaml_spec's parser)
# ---------------------------------------------------------------------------


def _param_to_wire(p) -> dict:
    fs: dict[str, Any] = {"distribution": p.feasible.distribution.value}
    if p.feasible.list is not None:
        fs["list"] = list(p.feasible.list)
    if p.feasible.min is not None:
        fs["min"] = p.feasible.min
    if p.feasible.max is not None:
        fs["max"] = p.feasible.max
    if p.feasible.step is not None:
        fs["step"] = p.feasible.step
    return {"name": p.name, "parameterType": p.type.value, "feasibleSpace": fs}


def spec_to_wire(spec: ExperimentSpec) -> dict:
    """Flat mapping accepted by ``experiment_spec_from_dict`` — the analog of
    the controller's CRD→proto conversion (``suggestionclient.go:111-116``)."""
    params = [_param_to_wire(p) for p in spec.parameters]
    objective: dict[str, Any] = {
        "type": spec.objective.type.value,
        "objectiveMetricName": spec.objective.objective_metric_name,
        "additionalMetricNames": list(spec.objective.additional_metric_names),
        "metricStrategies": [
            {"name": s.name, "value": s.value.value}
            for s in spec.objective.metric_strategies
        ],
    }
    if spec.objective.goal is not None:
        objective["goal"] = spec.objective.goal
    wire = {
        "name": spec.name,
        "objective": objective,
        "algorithm": {"name": spec.algorithm.name, "settings": dict(spec.algorithm.settings)},
        "parameters": params,
        "parallelTrialCount": spec.parallel_trial_count,
        "maxTrialCount": spec.max_trial_count,
        "maxFailedTrialCount": spec.max_failed_trial_count,
    }
    if spec.nas_config is not None:
        nc = spec.nas_config
        wire["nasConfig"] = {
            "graphConfig": {
                "numLayers": nc.graph_config.num_layers,
                "inputSizes": list(nc.graph_config.input_sizes),
                "outputSizes": list(nc.graph_config.output_sizes),
            },
            "operations": [
                {
                    "operationType": op.operation_type,
                    "parameters": [
                        _param_to_wire(p) for p in op.parameters
                    ],
                }
                for op in nc.operations
            ],
        }
    return wire


def trial_to_wire(t: Trial) -> dict:
    return {
        "name": t.name,
        "condition": t.condition.value,
        "assignments": [{"name": a.name, "value": a.value} for a in t.spec.assignments],
        "labels": dict(t.spec.labels),
        "start_time": t.start_time,
        "observation": (
            None
            if t.observation is None
            else [
                {"name": m.name, "value": m.value, "min": m.min, "max": m.max, "latest": m.latest}
                for m in t.observation.metrics
            ]
        ),
    }


def trial_from_wire(d: dict) -> Trial:
    obs = None
    if d.get("observation") is not None:
        obs = Observation(
            metrics=[
                Metric(
                    name=m["name"],
                    value=m["value"],
                    min=m.get("min", float("nan")),
                    max=m.get("max", float("nan")),
                    latest=m.get("latest", float("nan")),
                )
                for m in d["observation"]
            ]
        )
    return Trial(
        name=d["name"],
        spec=TrialSpec(
            assignments=[
                ParameterAssignment(a["name"], a["value"])
                for a in d.get("assignments") or ()
            ],
            labels=dict(d.get("labels") or {}),
        ),
        condition=TrialCondition(d.get("condition", "Created")),
        observation=obs,
        start_time=d.get("start_time", 0.0),
    )


def proposal_to_wire(p: TrialAssignmentSet) -> dict:
    return {
        "name": p.name,
        "assignments": [{"name": a.name, "value": a.value} for a in p.assignments],
        "labels": dict(p.labels),
        "early_stopping_rules": [
            {
                "name": r.name,
                "value": r.value,
                "comparison": r.comparison.value,
                "start_step": r.start_step,
            }
            for r in p.early_stopping_rules
        ],
    }


def proposal_from_wire(d: dict) -> TrialAssignmentSet:
    return TrialAssignmentSet(
        assignments=[
            ParameterAssignment(a["name"], a["value"]) for a in d.get("assignments") or ()
        ],
        name=d.get("name"),
        labels=dict(d.get("labels") or {}),
        early_stopping_rules=[
            EarlyStoppingRule(
                name=r["name"],
                value=r["value"],
                comparison=ComparisonOp(r["comparison"]),
                start_step=r.get("start_step", 0),
            )
            for r in d.get("early_stopping_rules") or ()
        ],
    )


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class _Entry:
    def __init__(self, suggester: Suggester, fingerprint: str):
        self.suggester = suggester
        self.fingerprint = fingerprint
        # serializes get_suggestions per experiment: stateful suggesters
        # (TPE store / PBT queue / ENAS controller) are not thread-safe, and
        # ThreadingHTTPServer handles each POST on its own thread
        self.lock = threading.Lock()
        # set (under lock) when the suggester has been torn down; a request
        # that raced the teardown sees it and backs off instead of calling
        # into a closed suggester
        self.closed = False
        # idempotency: a retried POST whose first response was lost must not
        # advance stateful suggesters (grid/sobol/hyperband) a second time —
        # the last request id replays its stored reply instead
        self.last_request_id: str | None = None
        self.last_response: tuple[int, dict] | None = None


class SuggestionService:
    """Holds the per-experiment suggester instances (the stateful analog of
    one algorithm Deployment per experiment).  ``forget()`` /
    ``DELETE /api/v1/experiment/<name>`` is the teardown path (the reference
    deletes the Deployment on experiment completion,
    ``suggestion_controller.go:132-143``).  ``device`` is where suggesters
    that compute on a device run (``None`` = ``cuda``; raises without a
    GPU)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._entries: dict[str, _Entry] = {}
        self._lock = threading.Lock()

    def _spec_from_wire(self, payload: dict) -> ExperimentSpec:
        from katib_tpu_torch.sdk.yaml_spec import experiment_spec_from_dict

        return experiment_spec_from_dict(payload["spec"])

    @staticmethod
    def _fingerprint(wire_spec: dict) -> str:
        return json.dumps(wire_spec, sort_keys=True, default=str)

    @staticmethod
    def _reject_nested_remote(spec: ExperimentSpec) -> None:
        # a service serving algorithm "remote" would proxy to yet another
        # service — and its composer mode would let any network caller spawn
        # subprocesses on this host.  The reference equally has no
        # suggestion image that dials a second suggestion service.
        if spec.algorithm.name == "remote":
            raise SuggesterError(
                "algorithm 'remote' cannot be served by a suggestion service; "
                "point the client at the real algorithm instead"
            )

    def validate(self, payload: dict) -> tuple[int, dict]:
        from katib_tpu_torch.suggest.base import validate_spec

        try:
            spec = self._spec_from_wire(payload)
            self._reject_nested_remote(spec)
            # class-level validate: MUST NOT instantiate (construction can
            # spawn composer subprocesses the validate path would then leak)
            validate_spec(spec)
        except (SuggesterError, KeyError, ValueError) as e:
            return 400, {"ok": False, "error": str(e)}
        return 200, {"ok": True}

    @staticmethod
    def _close_entry(entry: "_Entry | None") -> None:
        """Best-effort resource teardown for an evicted/forgotten suggester
        (anything holding processes/sockets exposes ``close``).  Caller must
        hold ``entry.lock``; the ``closed`` flag tells a request thread that
        looked the entry up before the pop/evict not to use it."""
        if entry is None:
            return
        entry.closed = True
        close = getattr(entry.suggester, "close", None)
        if close is None:
            return
        try:
            close(Experiment(spec=entry.suggester.spec))
        except Exception:
            pass

    def forget(self, name: str) -> tuple[int, dict]:
        with self._lock:
            entry = self._entries.pop(name, None)
        if entry is not None:
            # serialize teardown behind any in-flight get_suggestions on
            # the same entry (its lock is taken for the whole call)
            with entry.lock:
                self._close_entry(entry)
        return (200, {"ok": True}) if entry else (404, {"error": f"unknown experiment {name!r}"})

    def suggestions(self, payload: dict) -> tuple[int, dict]:
        try:
            spec = self._spec_from_wire(payload)
            count = int(payload.get("count", 1))
        except (KeyError, ValueError) as e:
            return 400, {"error": f"bad request: {e}"}
        fingerprint = self._fingerprint(payload["spec"])
        evicted: "_Entry | None" = None
        try:
            self._reject_nested_remote(spec)
            with self._lock:
                entry = self._entries.get(spec.name)
                # a re-used experiment name with a different spec gets a
                # fresh suggester, not the stale one
                if entry is None or entry.fingerprint != fingerprint:
                    evicted = entry
                    entry = _Entry(make_suggester(spec, device=self.device), fingerprint)
                    self._entries[spec.name] = entry
        except SuggesterError as e:
            return 400, {"error": str(e)}
        if evicted is not None:
            with evicted.lock:  # wait out any in-flight call on the old entry
                self._close_entry(evicted)
        exp = Experiment(spec=spec)
        exp.trials = {
            t["name"]: trial_from_wire(t) for t in payload.get("trials") or ()
        }
        if payload.get("settings"):
            exp.algorithm_settings = {
                str(k): str(v) for k, v in payload["settings"].items()
            }
        request_id = payload.get("request_id")
        with entry.lock:
            if entry.closed:
                # raced a forget()/evict between the registry lookup and
                # here; the registry no longer holds this entry, so a retry
                # builds a fresh suggester (409 → client NotReady → retry)
                return 409, {
                    "error": "suggester was torn down concurrently; retry",
                    "code": "not_ready",
                }
            if (
                request_id is not None
                and request_id == entry.last_request_id
                and entry.last_response is not None
            ):
                # retried delivery of a request already applied: replay the
                # stored reply, do not advance suggester state again
                return entry.last_response
            # server-side latency: the algorithm's own think time, without
            # the client's HTTP round-trip (which the orchestrator measures)
            t_sug = time.perf_counter()
            try:
                with tracing.span(
                    "suggest.service", algorithm=spec.algorithm.name, count=count
                ):
                    proposals = entry.suggester.get_suggestions(exp, count)
            except SuggestionsNotReady as e:
                return 409, {"error": str(e), "code": "not_ready"}
            except SearchExhausted as e:
                return 410, {"error": str(e), "code": "exhausted"}
            except SuggesterError as e:
                return 400, {"error": str(e)}
            finally:
                obs.suggestion_latency.observe(
                    time.perf_counter() - t_sug, algorithm=spec.algorithm.name
                )
            response = (
                200,
                {
                    "suggestions": [proposal_to_wire(p) for p in proposals],
                    "algorithm_settings": dict(exp.algorithm_settings),
                },
            )
            if request_id is not None:
                entry.last_request_id = request_id
                entry.last_response = response
            return response

    # -- lifecycle -----------------------------------------------------------

    def serve(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        token: str | None = None,
        ssl_context=None,
    ) -> "RunningService":
        """``token`` enables shared-token auth: every API request must carry
        ``Authorization: Bearer <token>`` (the TPU-native stand-in for the
        reference's RBAC-gated service account, ``suggestion_controller.go:
        209-224``; ``/healthz`` stays open like a readiness probe).
        ``ssl_context`` (from ``utils.certgen.server_ssl_context``) serves the
        API over TLS, the analog of the reference webhook's rotated serving
        cert (``certgenerator/generator.go:37``)."""
        svc = self

        class Handler(BaseHTTPRequestHandler):
            # bounds a stalled peer (incl. a deferred TLS handshake that
            # never arrives) to this per-connection thread, not the server
            timeout = 60

            def _reply(self, status: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _authorized(self) -> bool:
                from katib_tpu_torch.utils.http import bearer_authorized

                return bearer_authorized(self.headers, token)

            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    self._reply(200, {"status": "serving"})
                else:
                    self._reply(404, {"error": "not found"})

            def _write_guards(self) -> bool:
                """CSRF + DNS-rebinding guards, mirroring ui/backend.py."""
                from katib_tpu_torch.utils.http import json_content_type, local_host_allowed

                if self.command == "POST" and not json_content_type(self.headers):
                    self._reply(415, {"error": "Content-Type must be application/json"})
                    return False
                if token is None and not local_host_allowed(self.headers):
                    self._reply(403, {
                        "error": "Host not recognized (DNS-rebinding guard); "
                        "set a bearer token to accept requests on other hosts"
                    })
                    return False
                if not self._authorized():
                    self._reply(401, {"error": "missing or bad bearer token"})
                    return False
                return True

            def do_POST(self):  # noqa: N802
                if not self._write_guards():
                    return
                from katib_tpu_torch.utils.http import read_json_body

                try:
                    payload = read_json_body(self)
                except (ValueError, OSError) as e:
                    self._reply(400, {"error": f"bad payload: {e}"})
                    return
                if self.path == "/api/v1/suggestions":
                    self._reply(*svc.suggestions(payload))
                elif self.path == "/api/v1/validate":
                    self._reply(*svc.validate(payload))
                else:
                    self._reply(404, {"error": "not found"})

            def do_DELETE(self):  # noqa: N802
                if not self._write_guards():
                    return
                prefix = "/api/v1/experiment/"
                if self.path.startswith(prefix):
                    self._reply(*svc.forget(self.path[len(prefix):]))
                else:
                    self._reply(404, {"error": "not found"})

            def log_message(self, *args):
                pass

        server = ThreadingHTTPServer((host, port), Handler)
        if ssl_context is not None:
            from katib_tpu_torch.utils.certgen import wrap_server_socket

            server.socket = wrap_server_socket(ssl_context, server.socket)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return RunningService(server, thread)


class RunningService:
    def __init__(self, server: ThreadingHTTPServer, thread: threading.Thread):
        self._server = server
        self._thread = thread

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def serve_suggestions(
    port: int = 0,
    host: str = "127.0.0.1",
    token: str | None = None,
    ssl_context=None,
    device=None,
) -> RunningService:
    return SuggestionService(device=device).serve(
        port=port, host=host, token=token, ssl_context=ssl_context
    )


# ---------------------------------------------------------------------------
# composer: per-experiment suggester process lifecycle
# ---------------------------------------------------------------------------


class LocalSuggesterProcess:
    """Spawn → readiness-gate → tear down a suggester service subprocess;
    the in-process analog of the reference composer building the algorithm
    Deployment + Service and waiting for availability
    (``composer/composer.go:72-296``, ``suggestion_controller.go:229-238``).

    A fresh auth token is generated per process and passed via environment
    (never argv, which is world-readable in /proc).  With ``tls=True`` the
    composer also provisions a private CA + serving cert for the child and
    the client pins that CA — the reference webhook's rotated-cert setup
    (``certgenerator/generator.go:37``) collapsed to one handshake.

    The child is ``python -m katib_tpu_torch suggest-server --device cpu``
    with ``PYTHONPATH`` at the port's package root.  ``--device cpu`` keeps
    its suggesters off the card, as ``JAX_PLATFORMS=cpu`` keeps the JAX
    package's child off the TPU (``katib_tpu/suggest/service.py:580``); no
    JAX variable is set.  The child imports neither JAX nor the JAX
    package."""

    def __init__(self, readiness_timeout: float = 60.0, tls: bool = True):
        import secrets
        import socket
        import subprocess
        import sys
        import tempfile

        self.token = secrets.token_hex(16)
        # bind-then-release to pick a free port for the child; the tiny race
        # window is acceptable for a localhost helper process
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self.port = s.getsockname()[1]
        self.ca_cert: str | None = None
        self._ssl = None
        extra_args: list[str] = []
        if tls:
            # TLS needs the optional `cryptography` extra; a base install
            # degrades to the pre-TLS localhost behavior instead of crashing
            # mid-experiment (the token still gates the child either way)
            try:
                from katib_tpu_torch.utils.certgen import client_ssl_context, ensure_certs
                import cryptography  # noqa: F401
            except ImportError:
                import warnings

                warnings.warn(
                    "cryptography not installed; composer suggester will "
                    "serve plain HTTP on 127.0.0.1 (install katib-tpu[tls])",
                    RuntimeWarning,
                    stacklevel=2,
                )
                tls = False
        if tls:
            self._cert_dir = tempfile.mkdtemp(prefix="katib-suggest-certs-")
            bundle = ensure_certs(self._cert_dir)
            self.ca_cert = bundle.ca_cert
            self._ssl = client_ssl_context(bundle.ca_cert)
            extra_args = ["--cert-dir", self._cert_dir]
            # connect by IP: the child binds IPv4 only, and the leaf carries
            # an IP SAN for 127.0.0.1 so verification still holds
            self.endpoint = f"https://127.0.0.1:{self.port}"
        else:
            self.endpoint = f"http://127.0.0.1:{self.port}"
        import os as _os

        env = dict(_os.environ)
        env["KATIB_SUGGEST_TOKEN"] = self.token
        # the child must import katib_tpu_torch regardless of the caller's
        # cwd (callers often sys.path-hack rather than install the package)
        import katib_tpu_torch as _pkg

        pkg_root = _os.path.dirname(_os.path.dirname(_os.path.abspath(_pkg.__file__)))
        env["PYTHONPATH"] = (
            pkg_root + _os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH")
            else pkg_root
        )
        # keep the child's output: a child that dies before readiness is
        # undiagnosable if its traceback went to /dev/null
        self._log = tempfile.NamedTemporaryFile(
            mode="w+b", prefix="katib-suggest-", suffix=".log", delete=False
        )
        self._proc = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "katib_tpu_torch",
                "suggest-server",
                "--host",
                "127.0.0.1",
                "--port",
                str(self.port),
                # the suggester service runs algorithm math on the CPU; keep
                # the child off the card so it never contends for it
                "--device",
                "cpu",
                *extra_args,
            ],
            env=env,
            stdout=self._log,
            stderr=subprocess.STDOUT,
        )
        self._wait_healthy(readiness_timeout)

    def _wait_healthy(self, timeout: float) -> None:
        import time as _time

        deadline = _time.monotonic() + timeout
        last: Exception | None = None
        while _time.monotonic() < deadline:
            if self._proc.poll() is not None:
                rc = self._proc.returncode
                tail = self._log_tail()
                self.stop()  # reclaims the cert dir + log like the timeout path
                raise RuntimeError(
                    f"suggester process exited rc={rc} before ready; "
                    f"output tail:\n{tail}"
                )
            try:
                with urllib.request.urlopen(
                    f"{self.endpoint}/healthz", timeout=2, context=self._ssl
                ) as r:
                    if r.status == 200:
                        return
            except OSError as e:
                last = e
            _time.sleep(0.1)
        tail = self._log_tail()
        self.stop()
        raise RuntimeError(
            f"suggester service never became healthy: {last}; output tail:\n{tail}"
        )

    def _log_tail(self, n: int = 2000) -> str:
        import os as _os

        try:
            self._log.flush()
            with open(self._log.name, "rb") as f:
                f.seek(max(0, _os.path.getsize(self._log.name) - n))
                return f.read().decode(errors="replace")
        except OSError:
            return "<unavailable>"

    def stop(self) -> None:
        if self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=10)
            except Exception:
                self._proc.kill()
                self._proc.wait(timeout=10)
        cert_dir = getattr(self, "_cert_dir", None)
        if cert_dir is not None:
            import shutil

            shutil.rmtree(cert_dir, ignore_errors=True)
        log = getattr(self, "_log", None)
        if log is not None:
            import os as _os

            try:
                log.close()
                _os.unlink(log.name)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# client proxy
# ---------------------------------------------------------------------------


@register("remote")
class RemoteSuggester(Suggester):
    """Proxy to a suggestion service — the orchestrator-side analog of
    ``SyncAssignments`` (``suggestionclient.go:83``): ships spec + trial
    history, receives assignments, writes mutated settings back."""

    RETRIES = 3  # the reference's retry middleware does 10 @ 3s linear

    @classmethod
    def validate(cls, spec: ExperimentSpec) -> None:
        if not spec.algorithm.setting("endpoint"):
            raise SuggesterError("remote requires setting 'endpoint'")
        if not spec.algorithm.setting("algorithm"):
            raise SuggesterError("remote requires setting 'algorithm' (the real name)")
        if spec.algorithm.setting("algorithm") == "pbt":
            # PBT's exploit step copies checkpoint directories, which live on
            # the orchestrator host; a remote PbtSuggester would allocate its
            # lineage on the service host and children would silently cold-
            # start (reference PBT equally requires the shared RWX PVC)
            raise SuggesterError(
                "pbt cannot run behind 'remote': checkpoint lineage requires "
                "the suggester and trials to share a filesystem — run pbt "
                "in-process"
            )

    def __init__(self, spec: ExperimentSpec):
        super().__init__(spec)
        endpoint = spec.algorithm.setting("endpoint")
        self._local: LocalSuggesterProcess | None = None
        self._ssl = None
        if endpoint == "auto":
            # composer mode: spawn a private suggester service subprocess
            # (TLS + fresh token), readiness-gated; torn down in close() with
            # the experiment (``composer.go:72-296`` deploy + ``:132-143``)
            self._local = LocalSuggesterProcess()
            endpoint = self._local.endpoint
            self.token: str | None = self._local.token
            self._ssl = self._local._ssl
        else:
            import os as _os

            self.token = spec.algorithm.setting("token") or _os.environ.get(
                "KATIB_SUGGEST_TOKEN"
            )
            # ``ca_cert`` pins a private CA for an https endpoint (the
            # CABundle the reference injects into webhook clientConfig)
            ca = spec.algorithm.setting("ca_cert") or _os.environ.get(
                "KATIB_SUGGEST_CA"
            )
            if ca:
                from katib_tpu_torch.utils.certgen import client_ssl_context

                self._ssl = client_ssl_context(ca)
        self.endpoint = endpoint.rstrip("/")
        self.algorithm = spec.algorithm.setting("algorithm")

    def _wire_spec(self) -> dict:
        wire = spec_to_wire(self.spec)
        settings = {
            k: v
            for k, v in wire["algorithm"]["settings"].items()
            if k not in ("endpoint", "algorithm", "token", "ca_cert")
        }
        wire["algorithm"] = {"name": self.algorithm, "settings": settings}
        return wire

    def _headers(self) -> dict:
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        return headers

    def _post(self, path: str, payload: dict) -> tuple[int, dict]:
        data = json.dumps(payload).encode()
        req = urllib.request.Request(
            f"{self.endpoint}{path}", data=data, headers=self._headers()
        )
        def safe_json(raw: bytes) -> dict:
            # a proxy's HTML error page must not escape as JSONDecodeError
            try:
                out = json.loads(raw or b"{}")
                return out if isinstance(out, dict) else {"error": str(out)}
            except ValueError:
                return {"error": raw[:200].decode(errors="replace")}

        import http.client

        last: Exception | None = None
        for _ in range(self.RETRIES):
            try:
                with urllib.request.urlopen(req, timeout=30, context=self._ssl) as r:
                    return r.status, safe_json(r.read())
            except urllib.error.HTTPError as e:
                return e.code, safe_json(e.read())
            except (OSError, http.client.HTTPException) as e:
                # half-closed connections raise BadStatusLine (not OSError);
                # both are transient — retry, then surface as NotReady so a
                # glitch never fails the experiment
                last = e
        raise SuggestionsNotReady(f"suggestion service unreachable: {last}")

    def get_suggestions(self, experiment: Experiment, count: int):
        import uuid

        payload = {
            "spec": self._wire_spec(),
            "trials": [trial_to_wire(t) for t in experiment.trials.values()],
            "settings": {
                k: v
                for k, v in experiment.algorithm_settings.items()
                if k not in ("endpoint", "algorithm", "token", "ca_cert")
            },
            "count": count,
            # constant across transport retries: the service replays its
            # stored reply instead of advancing stateful suggesters twice
            "request_id": uuid.uuid4().hex,
        }
        status, reply = self._post("/api/v1/suggestions", payload)
        if status == 409:
            raise SuggestionsNotReady(reply.get("error", "not ready"))
        if status == 410:
            raise SearchExhausted(reply.get("error", "exhausted"))
        if status != 200:
            raise SuggesterError(reply.get("error", f"service error {status}"))
        for k, v in (reply.get("algorithm_settings") or {}).items():
            experiment.algorithm_settings[str(k)] = str(v)
        return [proposal_from_wire(p) for p in reply.get("suggestions") or ()]

    def close(self, experiment: Experiment) -> None:
        """Teardown on experiment completion: evict the server-side suggester
        (the reference deletes the per-experiment Deployment,
        ``suggestion_controller.go:132-143``).  Best-effort — the service may
        already be gone."""
        import http.client

        req = urllib.request.Request(
            f"{self.endpoint}/api/v1/experiment/{self.spec.name}",
            method="DELETE",
            headers=self._headers(),
        )
        try:
            urllib.request.urlopen(req, timeout=10, context=self._ssl).close()
        except (OSError, urllib.error.HTTPError, http.client.HTTPException):
            pass
        if self._local is not None:
            self._local.stop()
