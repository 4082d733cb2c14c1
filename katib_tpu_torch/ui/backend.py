"""REST backend + embedded dashboard — parity with the reference UI (port of
``katib_tpu/ui/backend.py``, with its own copy of the dashboard page).

The reference serves an Angular SPA from a Go REST backend that proxies CRD
CRUD, trial logs, DB-manager metric fetches, and a NAS graph view
(``pkg/ui/v1beta1/backend.go:86,138,181,463,514,566,617``, ``nas.go``).
Here there is no API server to proxy: the orchestrator journals
status to ``<workdir>/<experiment>/status.json`` and metrics live in the
observation store, so the backend is a thin read-only HTTP layer over those
two sources plus a single-file HTML dashboard (no build step, no Node).

Endpoints (JSON unless noted):

- ``GET /api/experiments``                     summaries for every journaled experiment
- ``GET /api/experiment/<name>``               full status incl. trials
- ``GET /api/experiment/<name>/trials``        trials table rows
- ``GET /api/trial/<name>/metrics``            raw metric log from the store
- ``GET /api/experiment/<name>/nas``           NAS graph (nodes/edges) for the
                                               best (or named ``?trial=``) trial
- ``GET /api/flagship/progress``               per-epoch stream of long NAS runs
                                               (``<artifacts_root>/flagship/
                                               run_progress.jsonl``), grouped
                                               by config tag
- ``POST /api/experiments``                    create + run a black-box experiment
                                               (body: the YAML spec as JSON, or
                                               ``{"yaml": "<text>"}``) — parity with
                                               ``backend.go:86`` CreateExperiment
- ``POST /api/experiment/<name>/stop``         wind the running experiment down
- ``DELETE /api/experiment/<name>``            remove a finished experiment's journal
                                               (``backend.go:138`` DeleteExperiment)
- ``GET /``                                    dashboard (text/html): experiment
                                               table, create form, best-objective
                                               sparkline, and per-trial drill-down —
                                               click a trial row for its metric
                                               chart (fed by ``/metrics``) and
                                               rendered NAS cell/arc SVG (fed by
                                               ``/nas?trial=``), the single-file
                                               answer to the reference SPA's trial
                                               detail + browser NAS views

Write endpoints optionally require ``Authorization: Bearer <token>``
(``token=`` / ``KATIB_UI_TOKEN``); reads stay open like the reference UI.
The server listens on loopback unless told another host.  Experiments that
``POST /api/experiments`` creates run on the server's ``device`` (``cuda``
unless the caller names the CPU).  ``/api/flagship/progress`` reads only
under the port's artifact root (``utils/paths.py``), never the JAX
package's TPU runs.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import torch

from katib_tpu_torch.core.types import ExperimentCondition
from katib_tpu_torch.device import resolve_device
from katib_tpu_torch.orchestrator.status import list_statuses, read_status
from katib_tpu_torch.store.base import ObservationStore
from katib_tpu_torch.utils.paths import artifacts_root


def _experiment_summary(status: dict) -> dict:
    return {
        "name": status.get("name"),
        "condition": status.get("condition"),
        "algorithm": status.get("algorithm"),
        "objective_metric": status.get("objective_metric"),
        "counts": status.get("counts", {}),
        "optimal": status.get("optimal"),
        "start_time": status.get("start_time"),
        "completion_time": status.get("completion_time"),
    }


def _trial_rows(status: dict) -> list[dict]:
    rows = []
    for name, t in (status.get("trials") or {}).items():
        obs = t.get("observation") or []
        rows.append(
            {
                "name": name,
                "condition": t.get("condition"),
                "assignments": t.get("assignments", {}),
                "labels": t.get("labels", {}),
                "metrics": {m["name"]: m["latest"] for m in obs},
                "start_time": t.get("start_time"),
                "completion_time": t.get("completion_time"),
            }
        )
    return rows


# -- NAS graph extraction ----------------------------------------------------


def _darts_graph(genotype: dict) -> dict:
    """Genotype → node/edge list, the shape the reference's UI renders
    (``nas.go``).  ``normal``/``reduce`` are per-node lists of kept
    ``[op, src_edge]`` pairs (nas/darts/model.py extract_genotype); source
    0/1 are the two cell inputs, source j+2 is intermediate node j."""
    nodes = [{"id": "c_{k-2}", "label": "input-2"}, {"id": "c_{k-1}", "label": "input-1"}]
    edges = []
    for cell in ("normal", "reduce"):
        per_node = genotype.get(cell) or []
        for i in range(len(per_node)):
            nodes.append({"id": f"{cell}-{i}", "label": f"{cell} node {i}"})
        for dst, pairs in enumerate(per_node):
            for op, src in pairs:
                src = int(src)
                src_id = ("c_{k-2}", "c_{k-1}")[src] if src < 2 else f"{cell}-{src - 2}"
                edges.append({"from": src_id, "to": f"{cell}-{dst}", "op": op})
    return {"type": "darts", "nodes": nodes, "edges": edges}


def _enas_graph(architecture: list) -> dict:
    """ENAS arc (per layer ``[op_id, skip...]``) → chain with skip edges."""
    nodes = [{"id": "input", "label": "input"}]
    edges = []
    for i, layer in enumerate(architecture):
        op = layer[0] if layer else 0
        nodes.append({"id": f"layer-{i}", "label": f"layer {i} (op {op})"})
        prev = "input" if i == 0 else f"layer-{i - 1}"
        edges.append({"from": prev, "to": f"layer-{i}", "op": "seq"})
        for j, bit in enumerate(layer[1:]):
            if int(bit):
                src = "input" if j == 0 else f"layer-{j - 1}"
                edges.append({"from": src, "to": f"layer-{i}", "op": "skip"})
    nodes.append({"id": "output", "label": "output"})
    if architecture:
        edges.append({"from": f"layer-{len(architecture) - 1}", "to": "output", "op": "seq"})
    return {"type": "enas", "nodes": nodes, "edges": edges}


def nas_graph_for_trial(trial: dict) -> dict | None:
    """Recover the architecture a trial trained: DARTS trials leave
    ``genotype.json`` in their checkpoint dir (nas/darts/search.py), ENAS
    trials carry it in the ``architecture`` assignment (enas/service.py)."""
    arch = (trial.get("assignments") or {}).get("architecture")
    if arch:
        try:
            return _enas_graph(json.loads(arch) if isinstance(arch, str) else arch)
        except (ValueError, TypeError):
            return None
    ckpt = trial.get("checkpoint_dir")
    if ckpt:
        path = os.path.join(ckpt, "genotype.json")
        try:
            with open(path) as f:
                return _darts_graph(json.load(f))
        except (OSError, ValueError):
            return None
    return None


# -- HTTP layer --------------------------------------------------------------


class UiServer:
    """Dashboard server over a workdir + observation store.  Reads come from
    the status journal; writes (create/stop/delete) own orchestrator runs in
    background threads — the collapse of the reference UI's CRD CRUD proxy
    (``backend.go:86-181``) now that there is no API server between UI and
    controller."""

    def __init__(
        self,
        workdir: str,
        store: ObservationStore | None = None,
        token: str | None = None,
        artifacts_dir: str | None = None,
        device: str | torch.device | None = None,
    ):
        self.workdir = workdir
        self.device = resolve_device(device)
        self.store = store
        # flagship run-progress stream lives in the artifacts tree, not the
        # experiment workdir; the shared resolver keeps this reader and the
        # scripts/ writers on the same root under a redirect
        self.artifacts_dir = artifacts_dir or artifacts_root()
        # empty string (e.g. `KATIB_UI_TOKEN=` in a shell) means "no auth",
        # not "require the empty token"
        self.token = (token or os.environ.get("KATIB_UI_TOKEN")) or None
        self._runs: dict[str, object] = {}  # name -> Orchestrator
        self._threads: dict[str, threading.Thread] = {}
        self._run_lock = threading.Lock()

    # -- write path ----------------------------------------------------------

    def _parse_spec(self, payload: dict):
        from katib_tpu_torch.sdk.yaml_spec import SpecError, experiment_spec_from_dict

        if "yaml" in payload:
            import yaml as _yaml

            try:
                payload = _yaml.safe_load(payload["yaml"])
            except _yaml.YAMLError as e:
                raise SpecError(f"bad YAML: {e}") from e
            if not isinstance(payload, dict):
                raise SpecError("YAML body must be a mapping")
        return experiment_spec_from_dict(payload)

    def create(self, payload: dict):
        from katib_tpu_torch.core.validation import ValidationError, validate_experiment
        from katib_tpu_torch.orchestrator import Orchestrator
        from katib_tpu_torch.sdk.yaml_spec import SpecError

        try:
            spec = self._parse_spec(payload)
            # full admission check HERE so a bad spec (incl. a path-escaping
            # name) is a 400 at the API, not a silent background failure
            validate_experiment(spec)
        except (ValidationError, SpecError, KeyError, TypeError, ValueError) as e:
            return 400, {"error": str(e)}
        if spec.command is None:
            # a callable cannot arrive over HTTP; UI-created experiments are
            # black-box by construction (same restriction as the reference:
            # trials are container commands)
            return 400, {"error": "experiment must define trialTemplate.command"}
        with self._run_lock:
            running = self._threads.get(spec.name)
            if running is not None and running.is_alive():
                return 409, {"error": f"experiment {spec.name!r} is already running"}
            if read_status(self.workdir, spec.name) is not None:
                return 409, {"error": f"experiment {spec.name!r} already exists"}
            # journal the Created state BEFORE 201 so the resource exists the
            # moment the client learns its name — the background run's own
            # first publish lands after its durable-store + event-journal
            # setup, a window where GET /api/experiment/<name> would 404
            try:
                from katib_tpu_torch.core.types import Experiment
                from katib_tpu_torch.orchestrator.status import write_status

                write_status(Experiment(spec=spec), self.workdir)
            except OSError:
                pass  # the run thread's publish will catch up
            orch = Orchestrator(workdir=self.workdir, store=self.store, device=self.device)
            thread = threading.Thread(
                target=self._run_background,
                args=(orch, spec),
                name=f"ui-run-{spec.name}",
                daemon=True,
            )
            self._runs[spec.name] = orch
            self._threads[spec.name] = thread
            thread.start()
        return 201, {"ok": True, "name": spec.name}

    @staticmethod
    def _run_background(orch, spec) -> None:
        try:
            orch.run(spec)
        except Exception:
            pass  # terminal state + message are journaled by the orchestrator

    def stop(self, name: str):
        with self._run_lock:
            orch = self._runs.get(name)
            thread = self._threads.get(name)
        if orch is None or thread is None or not thread.is_alive():
            return 409, {"error": f"experiment {name!r} is not running here"}
        orch.stop()
        return 202, {"ok": True, "stopping": name}

    def delete(self, name: str, force: bool = False):
        status = read_status(self.workdir, name)
        if status is None:
            return 404, {"error": f"experiment {name!r} not found"}
        with self._run_lock:
            thread = self._threads.get(name)
            if thread is not None and thread.is_alive():
                return 409, {"error": f"experiment {name!r} is still running; stop it first"}
            # the journal may belong to an orchestrator in ANOTHER process
            # (`katib-tpu run` sharing this workdir) — deleting out from
            # under it loses its checkpoints mid-run.  A crashed run leaves
            # a stale non-terminal journal; ?force=1 overrides for that case.
            condition = str(status.get("condition", ""))
            try:
                terminal = ExperimentCondition(condition).is_terminal()
            except ValueError:
                terminal = False  # unrecognized journal → treat as live
            if not terminal and not force:
                return 409, {
                    "error": (
                        f"experiment {name!r} is {condition or 'non-terminal'} "
                        "(possibly running in another process); stop it first "
                        "or delete with ?force=1"
                    )
                }
            self._runs.pop(name, None)
            self._threads.pop(name, None)
        shutil.rmtree(os.path.join(self.workdir, name), ignore_errors=True)
        return 200, {"ok": True, "deleted": name}

    # route handlers return (status, payload) with payload JSON-serializable

    def experiments(self):
        return 200, [_experiment_summary(s) for s in list_statuses(self.workdir)]

    def status(self):
        """Live in-process metrics snapshot (counters, gauges, histogram
        aggregates) — the dashboard's counter strip reads this instead of
        scraping the Prometheus endpoint separately."""
        from katib_tpu_torch.costmodel.profiler import list_profiles
        from katib_tpu_torch.utils.observability import REGISTRY
        from katib_tpu_torch.utils.meshhealth import last_report_dict

        return 200, {
            "workdir": self.workdir,
            "metrics": REGISTRY.snapshot(),
            # last device-preflight verdict of this process (None until a
            # doctor/preflight probe ran) — per-device health rows
            "device_health": last_report_dict(),
            # profiler captures taken by this process (enable_profiler
            # trials, ad-hoc `katib-tpu profile` runs): trace_dir + trial
            "profiles": list_profiles(),
        }

    def experiment(self, name: str):
        status = read_status(self.workdir, name)
        if status is None:
            return 404, {"error": f"experiment {name!r} not found"}
        return 200, status

    def trials(self, name: str):
        status = read_status(self.workdir, name)
        if status is None:
            return 404, {"error": f"experiment {name!r} not found"}
        return 200, _trial_rows(status)

    def trial_logs(self, trial_name: str):
        """Captured stdout of a black-box trial (reference UI fetches pod
        logs, ``backend.go:463``); resolution shared with the CLI via
        ``status.read_trial_log``."""
        from katib_tpu_torch.orchestrator.status import read_trial_log

        log = read_trial_log(self.workdir, trial_name)
        if log is None:
            return 404, {
                "error": f"no captured log for trial {trial_name!r} "
                "(white-box trials report metrics in-process and have no stdout log)"
            }
        return 200, {"trial": trial_name, "log": log}

    def trial_metrics(self, trial_name: str):
        if self.store is None:
            return 503, {"error": "no observation store attached"}
        logs = self.store.get(trial_name)
        return 200, [
            {
                "metric_name": l.metric_name,
                "value": l.value,
                "timestamp": l.timestamp,
                "step": l.step,
            }
            for l in logs
        ]

    def nas(self, name: str, trial_name: str | None):
        status = read_status(self.workdir, name)
        if status is None:
            return 404, {"error": f"experiment {name!r} not found"}
        trials = status.get("trials") or {}
        if trial_name is None:
            optimal = status.get("optimal") or {}
            trial_name = optimal.get("trial_name")
        if not trial_name or trial_name not in trials:
            return 404, {"error": "no trial with a recoverable architecture"}
        graph = nas_graph_for_trial(trials[trial_name])
        if graph is None:
            return 404, {"error": f"trial {trial_name!r} has no architecture artifact"}
        graph["trial"] = trial_name
        return 200, graph

    def flagship_progress(self):
        """Per-epoch stream of long NAS runs (``run_progress.jsonl``),
        grouped by config tag — the dashboard's live view of a 50-epoch
        search, fed by the same file that survives a mid-run cutoff."""
        path = os.path.join(self.artifacts_dir, "flagship", "run_progress.jsonl")
        runs: dict[str, list[dict]] = {}
        try:
            # errors="replace": a crash mid-append (the exact cutoff this
            # stream exists to survive) can leave truncated bytes; serve
            # the parseable prefix instead of 500ing
            with open(path, errors="replace") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if not isinstance(rec, dict):
                        continue  # valid JSON but not a record (null, [...])
                    runs.setdefault(rec.get("config") or "untagged", []).append(rec)
        except OSError:
            return 200, {"runs": {}}
        return 200, {"runs": runs}

    def route(self, path: str, query: dict):
        parts = [p for p in path.split("/") if p]
        if not parts:
            return "html", DASHBOARD_HTML
        if parts[0] != "api":
            return 404, {"error": "not found"}
        if parts[1:] == ["flagship", "progress"]:
            return self.flagship_progress()
        if parts[1:] == ["status"]:
            return self.status()
        if parts[1:] == ["experiments"]:
            return self.experiments()
        if len(parts) >= 3 and parts[1] == "experiment":
            name = parts[2]
            rest = parts[3:]
            if not rest:
                return self.experiment(name)
            if rest == ["trials"]:
                return self.trials(name)
            if rest == ["nas"]:
                return self.nas(name, (query.get("trial") or [None])[0])
        if len(parts) == 4 and parts[1] == "trial" and parts[3] == "metrics":
            return self.trial_metrics(parts[2])
        if len(parts) == 4 and parts[1] == "trial" and parts[3] == "logs":
            return self.trial_logs(parts[2])
        return 404, {"error": "not found"}

    def route_post(self, path: str, payload: dict):
        parts = [p for p in path.split("/") if p]
        if parts == ["api", "experiments"]:
            return self.create(payload)
        if len(parts) == 4 and parts[:2] == ["api", "experiment"] and parts[3] == "stop":
            return self.stop(parts[2])
        return 404, {"error": "not found"}

    def route_delete(self, path: str, query: dict | None = None):
        parts = [p for p in path.split("/") if p]
        if len(parts) == 3 and parts[:2] == ["api", "experiment"]:
            force = (query or {}).get("force", ["0"])[0] not in ("", "0", "false")
            return self.delete(parts[2], force=force)
        return 404, {"error": "not found"}

    # -- server lifecycle ----------------------------------------------------

    def serve(
        self, port: int = 0, host: str = "127.0.0.1", ssl_context=None
    ) -> "RunningUi":
        """``ssl_context`` (from ``utils.certgen.server_ssl_context``) serves
        the dashboard + API over TLS with the rotated self-signed bundle."""
        ui = self

        class Handler(BaseHTTPRequestHandler):
            # bounds a stalled peer (incl. a deferred TLS handshake that
            # never arrives) to this per-connection thread, not the server
            timeout = 60

            def _send(self, status, payload) -> None:
                if status == "html":
                    body = payload.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html; charset=utf-8")
                else:
                    body = json.dumps(payload, default=str).encode()
                    self.send_response(status)
                    self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (http.server API)
                parsed = urlparse(self.path)
                self._send(*ui.route(parsed.path, parse_qs(parsed.query)))

            def _write_guards(self) -> bool:
                """CSRF + DNS-rebinding guards for the write endpoints (the
                create endpoint runs trialTemplate commands).  JSON-only
                bodies can't ride a browser "simple" cross-origin request,
                and in token-less mode the Host header must name this
                machine so a rebound domain can't become same-origin."""
                from katib_tpu_torch.utils.http import (
                    bearer_authorized,
                    json_content_type,
                    local_host_allowed,
                )

                if self.command == "POST" and not json_content_type(self.headers):
                    self._send(415, {"error": "Content-Type must be application/json"})
                    return False
                if ui.token is None and not local_host_allowed(self.headers):
                    self._send(403, {
                        "error": "Host not recognized (DNS-rebinding guard); "
                        "set a bearer token to accept writes on other hosts"
                    })
                    return False
                if not bearer_authorized(self.headers, ui.token):
                    self._send(401, {"error": "missing or bad bearer token"})
                    return False
                return True

            def do_POST(self):  # noqa: N802
                from katib_tpu_torch.utils.http import read_json_body

                if not self._write_guards():
                    return
                try:
                    payload = read_json_body(self)
                except (ValueError, OSError) as e:
                    self._send(400, {"error": f"bad payload: {e}"})
                    return
                self._send(*ui.route_post(urlparse(self.path).path, payload))

            def do_DELETE(self):  # noqa: N802
                if not self._write_guards():
                    return
                parsed = urlparse(self.path)
                self._send(*ui.route_delete(parsed.path, parse_qs(parsed.query)))

            def log_message(self, *args):
                pass

        server = ThreadingHTTPServer((host, port), Handler)
        if ssl_context is not None:
            from katib_tpu_torch.utils.certgen import wrap_server_socket

            server.socket = wrap_server_socket(ssl_context, server.socket)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return RunningUi(server, thread)


class RunningUi:
    def __init__(self, server: ThreadingHTTPServer, thread: threading.Thread):
        self._server = server
        self._thread = thread

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def start_ui(
    workdir: str, store: ObservationStore | None = None, port: int = 0,
    host: str = "127.0.0.1", token: str | None = None, ssl_context=None,
    device: str | torch.device | None = None,
) -> RunningUi:
    return UiServer(workdir, store, token=token, device=device).serve(
        port=port, host=host, ssl_context=ssl_context
    )


# -- the dashboard (single file, no build step) ------------------------------

DASHBOARD_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>katib-tpu</title>
<style>
body{font-family:system-ui,sans-serif;margin:2rem;background:#fafafa;color:#222}
h1{font-size:1.3rem} h2{font-size:1.05rem;margin-top:1.5rem}
table{border-collapse:collapse;width:100%;background:#fff;box-shadow:0 1px 2px #0002}
th,td{padding:.45rem .7rem;border-bottom:1px solid #eee;text-align:left;font-size:.88rem}
th{background:#f0f0f3;font-weight:600}
tr.sel{background:#eef4ff} tbody tr{cursor:pointer}
.badge{padding:.1rem .45rem;border-radius:.6rem;font-size:.75rem;color:#fff}
.Succeeded,.MaxTrialsReached,.GoalReached{background:#2e7d32}.Failed{background:#c62828}
.Running{background:#1565c0}.EarlyStopped{background:#ef6c00}.MetricsUnavailable{background:#757575}
#detail{margin-top:1rem} pre{background:#272822;color:#f8f8f2;padding:1rem;overflow:auto;font-size:.8rem}
</style></head><body>
<h1>katib-tpu experiments</h1>
<div id="counters" style="margin:.2rem 0 .8rem;color:#555"></div>
<details id="create"><summary>create experiment</summary>
<fieldset style="border:1px solid #ddd;margin:.5rem 0;padding:.6rem">
<legend>wizard (fills the YAML below — edit freely before running)</legend>
<input id="w_name" placeholder="name" size="14">
<select id="w_algo"><option>random</option><option>grid</option><option>tpe</option>
<option>multivariate-tpe</option><option>bayesianoptimization</option><option>cmaes</option>
<option>sobol</option><option>hyperband</option><option>asha</option><option>pbt</option></select>
<select id="w_otype"><option>minimize</option><option>maximize</option></select>
<input id="w_metric" placeholder="objective metric" size="12" value="loss">
<input id="w_goal" placeholder="goal (opt)" size="8">
<input id="w_max" placeholder="max trials" size="6" value="12">
<input id="w_par" placeholder="parallel" size="5" value="3">
<table id="w_params" style="width:auto;margin:.4rem 0"><thead><tr><th>param</th><th>type</th>
<th>min</th><th>max</th><th>list (comma)</th></tr></thead><tbody></tbody></table>
<button id="w_addp" type="button">+ parameter</button>
<div><small>trial command, one argument per line (use ${trialParameters.&lt;name&gt;}):</small><br>
<textarea id="w_cmd" rows="3" style="width:100%;font-family:monospace">python
-c
print("loss=" + str((${trialParameters.lr}-0.03)**2))</textarea></div>
<button id="w_build" type="button">build YAML</button>
</fieldset>
<textarea id="yaml" rows="14" style="width:100%;font-family:monospace"></textarea><br>
<input id="token" placeholder="bearer token (if required)" style="width:18rem">
<button id="submit">run</button> <span id="createmsg"></span></details>
<table id="exps"><thead><tr><th>name</th><th>status</th><th>algorithm</th>
<th>objective</th><th>trials</th><th>best</th><th></th></tr></thead><tbody></tbody></table>
<div id="flagship"></div>
<div id="detail"></div>
<script>
const esc=s=>String(s??"").replace(/[&<>"]/g,c=>({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;"}[c]));
const badge=c=>`<span class="badge ${esc(c)}">${esc(c)}</span>`;
async function j(u){const r=await fetch(u);return r.json()}
function hdrs(){const t=document.getElementById('token').value;
  return t?{'Content-Type':'application/json','Authorization':'Bearer '+t}:{'Content-Type':'application/json'}}
async function act(u,method,body){const r=await fetch(u,{method,headers:hdrs(),body});
  const p=await r.json();document.getElementById('createmsg').textContent=p.error||'ok';refresh();return p}
let current=null;
async function flagshipRuns(){
  // per-epoch stream of long NAS searches (run_progress.jsonl) — one
  // accuracy-vs-epoch line per config tag
  const p=await j('/api/flagship/progress');const runs=p.runs||{};
  const keys=Object.keys(runs);const el=document.getElementById('flagship');
  if(!keys.length){el.innerHTML='';return}
  el.innerHTML='<h2>flagship NAS runs</h2>'+keys.map(k=>{
    const rows=runs[k],last=rows[rows.length-1],W=260,H=48,n=rows.length;
    const ys=rows.map(r=>r.accuracy),y0=Math.min(...ys),y1=Math.max(...ys);
    const px=i=>4+(W-8)*i/((n-1)||1),py=v=>H-4-(H-8)*(v-y0)/((y1-y0)||1);
    const pts=rows.map((r,i)=>px(i)+','+py(r.accuracy)).join(' ');
    return `<div style="margin:.4rem 0"><small>${esc(k)} — epoch ${esc(last.epoch)}, `+
      `val ${esc(last.accuracy)}, ${esc(last.epoch_secs)}s/epoch (${esc(last.platform)})</small><br>`+
      `<svg width="${W}" height="${H}"><polyline points="${pts}" fill="none" stroke="#15c" stroke-width="2"/></svg></div>`;
  }).join('');
}
async function counters(){
  // live registry snapshot from this server process (/api/status) — no
  // separate Prometheus scrape needed for the counter strip
  const s=await j('/api/status');const m=s.metrics||{};
  const tot=n=>m[n]?m[n].total:0;
  // per-tier slice of a labeled counter (artifact hit/miss strip)
  const tier=(n,t)=>m[n]?m[n].samples.filter(x=>(x.labels||{}).tier===t)
    .reduce((a,x)=>a+x.value,0):0;
  const dur=m['katib_trial_duration_seconds'];
  const mean=dur&&dur.total?(dur.samples.reduce((a,x)=>a+x.sum,0)/dur.total):null;
  // device-health strip: the per-device preflight gauge (1 healthy / 0
  // wedged-or-absent); absent until a doctor/preflight probe ran in-process
  const dh=m['katib_device_healthy'];
  const dhUp=dh?dh.samples.filter(x=>x.value>0).length:0;
  const dhAll=dh?dh.samples.length:0;
  // steps-per-dispatch: the dispatch-overhead diagnostic for the DARTS
  // step loop (window size under the scan loop, 1 under eager stepping)
  const spdM=m['katib_steps_per_dispatch'];
  const spd=spdM&&spdM.samples.length?spdM.samples[0].value:null;
  // async-orchestrator strip: mesh occupancy (busy slot fraction; sustained
  // < 0.5 means the mesh idles between cohorts), the suggest->schedule
  // queue depth, and mean suggester latency from the suggest loop
  const occM=m['katib_mesh_occupancy'];
  const occ=occM&&occM.samples.length?occM.samples[0].value:null;
  const pendM=m['katib_pending_proposals'];
  const pend=pendM&&pendM.samples.length?pendM.samples[0].value:null;
  // loop-supervision strip: any loop whose stalled gauge is up right now,
  // and the cumulative supervisor restart count across all loops
  const stallM=m['katib_loop_stalled'];
  const stalledLoops=stallM?stallM.samples.filter(x=>x.value>0)
    .map(x=>(x.labels||{}).loop||'?'):[];
  const sugM=m['katib_suggest_seconds'];
  const sug=sugM&&sugM.total?(sugM.samples.reduce((a,x)=>a+x.sum,0)/sugM.total):null;
  document.getElementById('counters').innerHTML=
    `<small>trials: ${tot('katib_trial_created_total')} created · `+
    `${tot('katib_trial_succeeded_total')} succeeded · `+
    `${tot('katib_trial_failed_total')} failed · `+
    `${tot('katib_trial_retried_total')} retried · `+
    `${tot('katib_trial_early_stopped_total')} early-stopped · `+
    `experiments running: ${tot('katib_experiments_current')}`+
    (dhAll?` · devices: ${dhUp}/${dhAll} healthy${dhUp<dhAll?' <b>POOL DEGRADED</b>':''}`:'')+
    (tot('katib_mesh_degraded_total')?` · mesh degradations: ${tot('katib_mesh_degraded_total')}`:'')+
    (tot('katib_compile_hangs_total')?` · compile hangs: ${tot('katib_compile_hangs_total')}`:'')+
    (tot('katib_trial_hangs_total')?` · hangs caught: ${tot('katib_trial_hangs_total')}`:'')+
    (tot('katib_checkpoint_fallback_total')?` · ckpt fallbacks: ${tot('katib_checkpoint_fallback_total')}`:'')+
    (tot('katib_drain_requested')?' · <b>DRAINING</b>':'')+
    (tot('katib_suggester_errors_total')?` · suggester errors: ${tot('katib_suggester_errors_total')}`:'')+
    (tot('katib_cohort_executed_total')?` · cohorts: ${tot('katib_cohort_executed_total')}`:'')+
    (tot('katib_pbt_generations_total')?
      ` · pbt: ${tot('katib_pbt_generations_total')} gens / ${tot('katib_pbt_exploits_total')} exploits${tot('katib_pbt_onchip')?' <b>ON-CHIP</b>':''}`:'')+
    ((tot('katib_compile_cache_hits_total')||tot('katib_compile_cache_misses_total'))?
      ` · compile cache: ${tot('katib_compile_cache_hits_total')} warm / ${tot('katib_compile_cache_misses_total')} cold`:'')+
    (tot('katib_prewarm_compiles_total')?` · prewarmed: ${tot('katib_prewarm_compiles_total')}`:'')+
    ((tot('katib_artifact_hits_total')||tot('katib_artifact_publishes_total'))?
      ` · artifacts: ${tier('katib_artifact_hits_total','local')} local / ${tier('katib_artifact_hits_total','shared')} shared fetched · ${tot('katib_artifact_publishes_total')} published`:'')+
    (tot('katib_artifact_quarantines_total')?` · <b>artifact quarantines: ${tot('katib_artifact_quarantines_total')}</b>`:'')+
    (tot('katib_journal_replayed_events_total')?` · journal replayed: ${tot('katib_journal_replayed_events_total')}`:'')+
    (tot('katib_settlement_duplicates_total')?` · settle dups dropped: ${tot('katib_settlement_duplicates_total')}`:'')+
    (tot('katib_suggester_fence_rebuilds_total')?` · fence rebuilds: ${tot('katib_suggester_fence_rebuilds_total')}`:'')+
    (tot('katib_fsck_repairs_total')?` · fsck repairs: ${tot('katib_fsck_repairs_total')}`:'')+
    (spd!==null?` · steps/dispatch: ${spd.toFixed(1)}${spd<=1?' <b>EAGER</b>':''}`:'')+
    (occ!==null?` · occupancy: ${occ.toFixed(2)}${occ<0.5?' <b>MESH IDLE</b>':''}`:'')+
    (pend!==null?` · pending proposals: ${pend.toFixed(0)}`:'')+
    (tot('katib_loop_restarts_total')?` · loop restarts: ${tot('katib_loop_restarts_total')}`:'')+
    (stalledLoops.length?` · <b>LOOP STALLED: ${stalledLoops.map(esc).join(', ')}</b>`:'')+
    (tot('katib_speculative_dispatch_total')?` · speculative: ${tot('katib_speculative_wins_total')}/${tot('katib_speculative_dispatch_total')} won`:'')+
    (sug!==null?` · suggest: ${sug.toFixed(3)}s`:'')+
    (mean!==null?` · mean trial ${mean.toFixed(1)}s`:'')+'</small>';
}
async function refresh(){
  flagshipRuns().catch(()=>{});
  counters().catch(()=>{});
  const exps=await j('/api/experiments');
  document.querySelector('#exps tbody').innerHTML=exps.map(e=>{
    const c=e.counts||{},o=e.optimal,n=encodeURIComponent(e.name);
    const running=e.condition==='Running'||e.condition==='Restarting';
    const btn=running?`<button onclick="event.stopPropagation();act('/api/experiment/${n}/stop','POST')">stop</button>`
      :`<button onclick="event.stopPropagation();act('/api/experiment/${n}','DELETE')">delete</button>`;
    return `<tr data-n="${esc(e.name)}" class="${e.name===current?'sel':''}">`+
      `<td>${esc(e.name)}</td><td>${badge(e.condition)}</td><td>${esc(e.algorithm)}</td>`+
      `<td>${esc(e.objective_metric)}</td><td>${c.succeeded??0}/${c.trials??0}</td>`+
      `<td>${o?esc(o.objective_value?.toFixed?.(5)??o.objective_value):"—"}</td><td>${btn}</td></tr>`;
  }).join('');
  document.querySelectorAll('#exps tbody tr').forEach(tr=>tr.onclick=()=>show(tr.dataset.n));
  if(current)show(current,false);
}
document.getElementById('submit').onclick=()=>
  act('/api/experiments','POST',JSON.stringify({yaml:document.getElementById('yaml').value}));
// -- creation wizard: assembles the Katib-style YAML client-side ----------
function addParamRow(name='',type='double',min='',max='',list=''){
  const tb=document.querySelector('#w_params tbody');
  const tr=document.createElement('tr');
  tr.innerHTML=`<td><input size="8" class="p_n" value="${esc(name)}"></td>`+
    `<td><select class="p_t"><option>double</option><option>int</option>`+
    `<option>discrete</option><option>categorical</option></select></td>`+
    `<td><input size="6" class="p_lo" value="${esc(min)}"></td>`+
    `<td><input size="6" class="p_hi" value="${esc(max)}"></td>`+
    `<td><input size="12" class="p_ls" value="${esc(list)}"></td>`;
  tr.querySelector('.p_t').value=type;
  tb.appendChild(tr);
}
document.getElementById('w_addp').onclick=()=>addParamRow();
addParamRow('lr','double','0.01','0.05');
document.getElementById('w_build').onclick=()=>{
  const v=id=>document.getElementById(id).value.trim();
  const q=JSON.stringify; // YAML-safe scalar quoting
  const msg=[];
  let y='apiVersion: kubeflow.org/v1beta1\nkind: Experiment\nmetadata:\n'+
    `  name: ${q(v('w_name')||'my-experiment')}\nspec:\n  objective:\n`+
    `    type: ${v('w_otype')}\n    objectiveMetricName: ${q(v('w_metric'))}\n`;
  // numeric fields are parsed client-side so stray text can't corrupt
  // the YAML (an unquoted ':' or '#' would truncate or break parsing)
  const goal=parseFloat(v('w_goal'));
  if(v('w_goal')&&!isNaN(goal))y+=`    goal: ${goal}\n`;
  else if(v('w_goal'))msg.push(`goal ${q(v('w_goal'))} is not a number — omitted`);
  y+=`  algorithm:\n    algorithmName: ${v('w_algo')}\n`+
    `  parallelTrialCount: ${parseInt(v('w_par'))||3}\n`+
    `  maxTrialCount: ${parseInt(v('w_max'))||12}\n`+
    '  parameters:\n';
  document.querySelectorAll('#w_params tbody tr').forEach(tr=>{
    const g=c=>tr.querySelector(c).value.trim();
    if(!g('.p_n'))return;
    if(!g('.p_ls')&&(!g('.p_lo')||!g('.p_hi'))){
      msg.push(`parameter ${q(g('.p_n'))} needs min+max or a list — skipped`);
      return;
    }
    y+=`    - name: ${q(g('.p_n'))}\n      parameterType: ${g('.p_t')}\n`;
    if(g('.p_ls'))
      y+=`      feasibleSpace: {list: [${g('.p_ls').split(',').map(s=>q(s.trim())).join(', ')}]}\n`;
    else
      y+=`      feasibleSpace: {min: ${q(g('.p_lo'))}, max: ${q(g('.p_hi'))}}\n`;
  });
  y+='  trialTemplate:\n    command:\n'+
    v('w_cmd').split('\n').filter(l=>l.length).map(l=>`      - ${q(l)}`).join('\n')+'\n';
  document.getElementById('yaml').value=y;
  document.getElementById('createmsg').textContent=msg.join('; ');
};
function sparkline(rows){
  if(!rows||!rows.length)return '';
  const xs=rows.map(r=>r.elapsed_s),ys=rows.map(r=>r.objective_value);
  const last=`best objective vs wallclock (${esc(ys[ys.length-1].toFixed?.(5)??ys[ys.length-1])} @ ${esc(xs[xs.length-1])}s)`;
  const W=260,H=48;
  if(rows.length<2)
    return `<div><small>${last}</small><br><svg width="${W}" height="${H}"><circle cx="8" cy="${H/2}" r="3" fill="#2a7"/></svg></div>`;
  const x0=Math.min(...xs),x1=Math.max(...xs)||1,y0=Math.min(...ys),y1=Math.max(...ys);
  const px=v=>4+(W-8)*(v-x0)/((x1-x0)||1),py=v=>H-4-(H-8)*(v-y0)/((y1-y0)||1);
  const pts=rows.map(r=>px(r.elapsed_s)+','+py(r.objective_value)).join(' ');
  return `<div><small>${last}</small><br>`+
    `<svg width="${W}" height="${H}"><polyline points="${pts}" fill="none" stroke="#2a7" stroke-width="2"/></svg></div>`;
}
const PALETTE=['#2a7','#15c','#e60','#a3c','#c22','#08a','#770'];
function metricChart(rows){
  // per-trial drill-down chart: one polyline per metric series from
  // /api/trial/<name>/metrics (x = step, falling back to report order)
  if(!rows||!rows.length)return '<small>no metric points</small>';
  const series={};
  rows.forEach(r=>{(series[r.metric_name]??=[]).push(r)});
  const W=560,H=180,names=Object.keys(series);
  const ally=rows.map(r=>r.value);
  const y0=Math.min(...ally),y1=Math.max(...ally);
  const py=v=>H-16-(H-32)*(v-y0)/((y1-y0)||1);
  const lines=names.map((nm,i)=>{
    const s=series[nm],useStep=s.every(r=>r.step>=0);
    const xs=s.map((r,k)=>useStep?r.step:k);
    const x0=Math.min(...xs),x1=Math.max(...xs);
    const px=v=>40+(W-56)*(v-x0)/((x1-x0)||1);
    const pts=s.map((r,k)=>px(xs[k])+','+py(r.value)).join(' ');
    return s.length>1
      ?`<polyline points="${pts}" fill="none" stroke="${PALETTE[i%PALETTE.length]}" stroke-width="1.6"/>`
      :`<circle cx="${px(xs[0])}" cy="${py(s[0].value)}" r="3" fill="${PALETTE[i%PALETTE.length]}"/>`;
  }).join('');
  const legend=names.map((nm,i)=>
    `<tspan x="46" dy="14" fill="${PALETTE[i%PALETTE.length]}">● ${esc(nm)}</tspan>`).join('');
  return `<svg id="metricchart" width="${W}" height="${H}" style="background:#fff;box-shadow:0 1px 2px #0002">`+
    `<text x="4" y="14" font-size="10">${esc(y1.toFixed?.(4)??y1)}</text>`+
    `<text x="4" y="${H-6}" font-size="10">${esc(y0.toFixed?.(4)??y0)}</text>`+
    lines+`<text font-size="11">${legend}</text></svg>`;
}
function nasGraph(g){
  // rendered NAS cell/arc graph (the reference UI renders nas.go's graph
  // in the browser); layered left→right by topological depth
  if(!g||!g.nodes||!g.nodes.length)return '';
  const depth={},incoming={};
  g.nodes.forEach(n=>{incoming[n.id]=[]});
  g.edges.forEach(e=>{(incoming[e.to]??=[]).push(e.from)});
  const d=id=>{
    if(depth[id]!=null)return depth[id];
    depth[id]=0; // breaks accidental cycles
    const ins=(incoming[id]||[]).map(d);
    return depth[id]=ins.length?Math.max(...ins)+1:0;
  };
  g.nodes.forEach(n=>d(n.id));
  const cols={};
  g.nodes.forEach(n=>{(cols[depth[n.id]]??=[]).push(n.id)});
  const pos={},CW=150,RH=52;
  const H=40+RH*Math.max(...Object.values(cols).map(c=>c.length));
  Object.entries(cols).forEach(([dep,ids])=>ids.forEach((id,k)=>{
    pos[id]=[30+dep*CW,24+k*RH+((H-48-RH*(ids.length-1))/2)];
  }));
  const W=60+CW*Math.max(...Object.keys(cols).map(Number))+80;
  const edges=g.edges.map(e=>{
    const [x1,y1]=pos[e.from],[x2,y2]=pos[e.to];
    const mx=(x1+x2)/2,my=(y1+y2)/2;
    return `<line x1="${x1+46}" y1="${y1}" x2="${x2-46}" y2="${y2}" stroke="#888" marker-end="url(#arr)"/>`+
      (e.op&&e.op!=='seq'?`<text x="${mx}" y="${my-4}" font-size="9" text-anchor="middle" fill="#555">${esc(e.op)}</text>`:'');
  }).join('');
  const nodes=g.nodes.map(n=>{
    const [x,y]=pos[n.id];
    return `<rect x="${x-46}" y="${y-13}" width="92" height="26" rx="6" fill="#eef4ff" stroke="#15c"/>`+
      `<text x="${x}" y="${y+4}" font-size="10" text-anchor="middle">${esc(n.label||n.id)}</text>`;
  }).join('');
  return `<h2>architecture — ${esc(g.trial||'')} (${esc(g.type)})</h2>`+
    `<svg id="nasgraph" width="${W}" height="${H}" style="background:#fff;box-shadow:0 1px 2px #0002">`+
    `<defs><marker id="arr" markerWidth="7" markerHeight="7" refX="6" refY="3" orient="auto">`+
    `<path d="M0,0 L7,3 L0,6 z" fill="#888"/></marker></defs>`+edges+nodes+`</svg>`;
}
let trialOf=null; // which experiment the drill-down panel belongs to
async function showTrial(exp,trial){
  trialOf=exp;
  const t=encodeURIComponent(trial);
  const [m,nas,logs]=await Promise.all([
    j('/api/trial/'+t+'/metrics'),
    j('/api/experiment/'+encodeURIComponent(exp)+'/nas?trial='+t),
    j('/api/trial/'+t+'/logs')]);
  document.getElementById('trialdetail').innerHTML=
    `<h2>${esc(trial)} — metrics</h2>`+metricChart(Array.isArray(m)?m:[])+
    (nas&&nas.nodes?nasGraph(nas):'')+
    (logs&&logs.log?`<details><summary>captured log (${esc(trial)})</summary>`+
      `<pre>${esc(logs.log.slice(-20000))}</pre></details>`:'');
}
async function show(name,re=true){
  current=name;
  const [st,t]=await Promise.all([
    j('/api/experiment/'+encodeURIComponent(name)),
    j('/api/experiment/'+encodeURIComponent(name)+'/trials')]);
  const cols=[...new Set(t.flatMap(r=>Object.keys(r.metrics||{})))];
  const pcols=[...new Set(t.flatMap(r=>Object.keys(r.assignments||{})))];
  // keep the drill-down across the 3s redraw, but not across a switch to
  // a different experiment (stale charts would masquerade as the new one's)
  const keep=trialOf===name?(document.getElementById('trialdetail')?.innerHTML||''):'';
  document.getElementById('detail').innerHTML=
    sparkline(st.optimal_history)+
    `<h2>${esc(name)} — trials</h2><table><thead><tr><th>trial</th><th>status</th>`+
    pcols.map(p=>`<th>${esc(p)}</th>`).join('')+cols.map(c=>`<th>${esc(c)}</th>`).join('')+
    `</tr></thead><tbody>`+t.map(r=>`<tr data-t="${esc(r.name)}"><td>${esc(r.name)}</td><td>${badge(r.condition)}</td>`+
      pcols.map(p=>`<td>${esc(r.assignments?.[p])}</td>`).join('')+
      cols.map(c=>{const v=r.metrics?.[c];return `<td>${v==null?"—":esc(v.toFixed?.(5)??v)}</td>`}).join('')+
    `</tr>`).join('')+`</tbody></table><div id="trialdetail"></div>`;
  document.getElementById('trialdetail').innerHTML=keep; // survive the 3s redraw
  document.querySelectorAll('#detail tbody tr').forEach(tr=>
    tr.onclick=()=>showTrial(name,tr.dataset.t));
  if(re)refresh();
}
refresh();setInterval(refresh,3000);
</script></body></html>
"""
