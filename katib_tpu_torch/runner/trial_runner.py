"""Trial runners: white-box (Python function) and black-box (subprocess);
port of ``katib_tpu/runner/trial_runner.py``.

The white-box path collapses the reference's trial pipeline (trial controller
creates Job -> pod webhook injects sidecar -> sidecar PNS-waits and scrapes
stdout -> gRPC to DB-manager -> controller polls observation,
``trial_controller.go:147-306`` + ``inject_webhook.go`` + ``pns.go``) into a
function call with a metrics callback.

The black-box path keeps parity with arbitrary-language trials: the command
template's ``${trialParameters.X}`` placeholders are substituted
(``manifest/generator.go:99``), metrics are scraped live — from stdout for
StdOut collectors, by tailing the metrics file for File/JsonLines collectors
(the sidecar's watch loop, ``file-metricscollector/main.go:143``) — and
early-stopping rules terminate the process on trigger (the sidecar's SIGTERM
dance, ``main.go:262-306``).  The argv runs exactly as the spec writes it.

Both paths honor a shared ``stop_event``: when the orchestrator reaches a
terminal verdict (goal hit, failure budget blown) it sets the event and
in-flight trials wind down as ``Killed`` (the reference deletes running trial
jobs on experiment completion, ``experiment_controller.go:362-403``).

Each white-box trial's first step is classified warm or cold against the
shape registry (``compile/registry.py``; warm means this process warmed the
signature before), and :func:`init_compile_cache` wires the directory the
registry and the local artifact tier persist to.  A trial mesh reaches the
train_fn as ``ctx.mesh`` (``parallel/mesh.py``); the JAX runner's live
roofline (``costmodel``) is not ported.
"""

from __future__ import annotations

import dataclasses
import os
import re
import signal
import subprocess
import threading
import traceback

from katib_tpu_torch.core.types import MetricsCollectorKind, Trial, TrialCondition
from katib_tpu_torch.earlystop.rules import RuleEvaluator
from katib_tpu_torch.parallel.mesh import Mesh, serial_mesh
from katib_tpu_torch.runner.context import TrialContext, TrialEarlyStopped
from katib_tpu_torch.runner.metrics import parse_json_lines, parse_text_lines_fast
from katib_tpu_torch.store.base import ObservationStore
from katib_tpu_torch.utils import observability as obs
from katib_tpu_torch.utils import tracing
from katib_tpu_torch.utils.clock import get_clock
from katib_tpu_torch.utils.faults import (
    FailureKind,
    classify_exception,
    classify_exit_code,
)

#: the environment variable that names the compile cache (both packages')
COMPILE_CACHE_ENV = "KATIB_COMPILE_CACHE"


def init_compile_cache(cache_dir: str | None = None) -> str | None:
    """Wire the compile cache, once per process.

    Resolution: ``KATIB_COMPILE_CACHE``, then ``cache_dir``
    (``ExperimentSpec.compile_cache``), else off.  The port keeps its part
    under ``<cache>/torch/``: the shape registry's
    ``shape_registry.jsonl`` and the local artifact tier ``artifacts/`` of
    its kernel libraries (``compile/artifacts.py``); the JAX package's XLA
    cache and registry beside it stay untouched.  The first caller wins; a
    second asking for another directory gets a ``RuntimeWarning``.
    Returns the effective directory (None = off); an unwritable directory
    never fails the run."""
    from katib_tpu_torch.compile import registry

    requested = os.environ.get(COMPILE_CACHE_ENV) or cache_dir
    wired = registry.cache_root()
    if wired is not None:
        if requested and os.path.abspath(requested) != wired:
            import warnings

            warnings.warn(
                f"compile cache already wired to {wired!r}; ignoring the "
                f"requested {os.path.abspath(requested)!r} (process-global — "
                "first caller wins)",
                RuntimeWarning,
                stacklevel=2,
            )
        return wired
    if not requested:
        return None
    resolved = os.path.abspath(requested)
    try:
        os.makedirs(os.path.join(resolved, registry.PORT_SUBDIR), exist_ok=True)
    except OSError:
        return None
    registry._CACHE_ROOT = resolved
    obs.compile_cache_enabled.set(1.0)
    return resolved


class TrialResult:
    def __init__(
        self,
        condition: TrialCondition,
        message: str = "",
        failure_kind: FailureKind | None = None,
    ):
        self.condition = condition
        self.message = message
        # why the attempt failed (``utils.faults`` taxonomy) — the
        # orchestrator's retry loop re-runs TRANSIENT failures only
        self.failure_kind = failure_kind


def run_trial(
    trial: Trial,
    store: ObservationStore,
    objective,
    mesh=None,
    stop_event: threading.Event | None = None,
    injector=None,
    watchdog=None,
    drain_event: threading.Event | None = None,
    device=None,
) -> TrialResult:
    """Execute one trial to a terminal condition on ``device`` (``None`` =
    ``cuda``, through the trial's own device resolution).  Never raises: failures
    become ``TrialCondition.FAILED`` with the traceback in ``message`` and
    their ``FailureKind`` classified (budget accounting needs failed trials
    recorded, not exceptions — reference ``experiment_controller.go:274-330``).

    ``injector`` (a ``faults.FaultInjector``) is the chaos seam: it fires
    inside this classification try-block, so injected faults take exactly
    the path a real preemption or shape error would.

    ``watchdog`` (``utils.watchdog.Watchdog``) arms hang detection when the
    trial carries ``progress_deadline_seconds``; ``drain_event`` is the
    orchestrator's checkpoint-and-exit request (preemption SIGTERM) — both
    observable to the train_fn through its context.  A ``mesh`` reaches
    the train_fn as ``ctx.mesh`` (a trial-axis-only mesh partitions cohort
    members, not tensors, so a singleton trial drops it: ``serial_mesh``);
    a black-box trial ignores it, as in the JAX package."""
    evaluator = RuleEvaluator(trial.spec.early_stopping_rules, objective)
    try:
        if injector is not None:
            injector.on_trial_attempt(trial)
            injector.apply_metrics_delay(trial, stop_event)
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"a trial mesh is a parallel.mesh.Mesh, got {mesh!r}")
            mesh = serial_mesh(mesh)
        if trial.spec.train_fn is not None:
            return _run_whitebox(
                trial, store, evaluator, objective, stop_event,
                injector=injector, watchdog=watchdog, drain_event=drain_event,
                device=device, mesh=mesh,
            )
        if trial.spec.command:
            return _run_blackbox(
                trial, store, evaluator, objective, stop_event,
                watchdog=watchdog, drain_event=drain_event,
            )
        return TrialResult(
            TrialCondition.FAILED,
            "trial has neither train_fn nor command",
            failure_kind=FailureKind.PERMANENT,
        )
    except Exception as e:
        return TrialResult(
            TrialCondition.FAILED,
            traceback.format_exc(limit=20),
            failure_kind=classify_exception(e),
        )


def _finalize(trial: Trial, store: ObservationStore, objective) -> TrialResult:
    """Post-run observation check: succeeded-but-no-objective-metric becomes
    MetricsUnavailable (reference ``newObservationLog`` +
    ``trial_controller.go:249-252``)."""
    obs = store.observation_for(trial.name, objective)
    if obs is None:
        return TrialResult(
            TrialCondition.METRICS_UNAVAILABLE,
            f"objective metric {objective.objective_metric_name!r} was never reported",
        )
    return TrialResult(TrialCondition.SUCCEEDED)


def _run_whitebox(
    trial: Trial,
    store: ObservationStore,
    evaluator: RuleEvaluator,
    objective,
    stop_event: threading.Event | None,
    injector=None,
    watchdog=None,
    drain_event: threading.Event | None = None,
    device=None,
    mesh=None,
) -> TrialResult:
    hang_event = threading.Event()
    compile_hang_event = threading.Event()
    heartbeat = None
    if watchdog is not None and trial.spec.progress_deadline_seconds:
        heartbeat = watchdog.register(
            trial.name,
            trial.spec.progress_deadline_seconds,
            on_hang=lambda _name: hang_event.set(),
        )
    # compile watchdog: the progress watchdog only measures step-to-step
    # cadence, so a jit compile (or first dispatch) that never completes
    # looks identical to a wedge.  Arm a one-shot budget that covers trace
    # -> compile -> first ctx.report(); the first beat disarms it.
    compile_hb = None
    if watchdog is not None and trial.spec.compile_deadline_seconds:

        def _on_compile_hang(_name: str) -> None:
            obs.compile_hangs.inc()
            compile_hang_event.set()
            hang_event.set()  # reuse the cooperative hang unwind path

        compile_hb = watchdog.register(
            f"compile:{trial.name}",
            trial.spec.compile_deadline_seconds,
            on_hang=_on_compile_hang,
        )

    # warm/cold first-step classification: the first ctx.report() marks the
    # first step boundary (build, warm-up, capture and first epoch behind
    # it, read back to the host); the shape registry decides whether this
    # process had warmed the program before
    from katib_tpu_torch.compile import registry as compile_registry

    first_step_sig = compile_registry.trial_signature(trial.spec.train_fn, trial, mesh)
    started_holder = [get_clock().perf_counter()]
    first_step: dict = {}

    def _beat() -> None:
        if not first_step:
            dt = get_clock().perf_counter() - started_holder[0]
            try:
                label = compile_registry.REGISTRY.note_first_step(first_step_sig, dt)
                obs.trial_first_step_seconds.set(
                    dt, phase="first_report", cache=label,
                    workload=first_step_sig.program,
                )
                first_step.update(first_step_cache=label, first_step_s=round(dt, 4))
            except Exception:
                first_step["first_step_cache"] = None  # telemetry, never a failure
        if compile_hb is not None:
            # first metric report = first dispatch completed: compile is done
            compile_hb.close()
        if heartbeat is not None:
            heartbeat.beat()

    ctx = TrialContext(
        trial.params(),
        checkpoint_dir=trial.checkpoint_dir,
        device=device,
        mesh=mesh,
        trial_name=trial.name,
        store=store,
        evaluator=evaluator,
        labels=trial.spec.labels,
        stop_event=stop_event,
        max_runtime_seconds=trial.spec.max_runtime_seconds,
        drain_event=drain_event,
        hang_event=hang_event,
        heartbeat=_beat,
    )

    def _deadline_result() -> TrialResult:
        # a deadline blown once will blow again on an identical re-run —
        # never worth a transient retry
        return TrialResult(
            TrialCondition.FAILED,
            f"trial exceeded max_runtime_seconds={trial.spec.max_runtime_seconds}",
            failure_kind=FailureKind.PERMANENT,
        )

    def _hang_result() -> TrialResult:
        if compile_hang_event.is_set():
            return TrialResult(
                TrialCondition.FAILED,
                "compile watchdog: jit compile / first dispatch exceeded "
                f"compileDeadlineSeconds={trial.spec.compile_deadline_seconds}",
                failure_kind=FailureKind.COMPILE_HANG,
            )
        return TrialResult(
            TrialCondition.FAILED,
            "hang watchdog: no progress for "
            f"progress_deadline_seconds={trial.spec.progress_deadline_seconds}",
            failure_kind=FailureKind.HANG,
        )

    try:
        if injector is not None:
            # chaos 'compile-hang' action: wedge *before* the first report,
            # inside the compile budget — only the compile watchdog (or
            # stop/drain) can unwedge it
            injector.maybe_compile_hang(
                trial, events=(compile_hang_event, hang_event, stop_event, drain_event)
            )
            # chaos 'hang' action: wedge here like a stuck step; only the
            # watchdog / stop / drain machinery can unwedge it — and whichever
            # did decides the settlement (HANG / KILLED / DRAINED)
            injector.maybe_hang(trial, events=(hang_event, stop_event, drain_event))
            ctx.raise_if_stopped()
        started_holder[0] = get_clock().perf_counter()  # first-step clock starts here
        with tracing.span("train_fn", trial=trial.name) as sp:
            try:
                trial.spec.train_fn(ctx)
            finally:
                if first_step.get("first_step_cache"):
                    sp.set(**first_step)
    except TrialEarlyStopped as e:
        if evaluator.triggered is not None:
            return TrialResult(TrialCondition.EARLY_STOPPED, str(e))
        if hang_event.is_set():
            return _hang_result()
        if ctx.deadline_exceeded():
            return _deadline_result()
        if ctx.drain_requested() and not (stop_event is not None and stop_event.is_set()):
            return TrialResult(
                TrialCondition.DRAINED, "checkpointed and exited for drain"
            )
        return TrialResult(TrialCondition.KILLED, str(e))
    except Exception as e:
        return TrialResult(
            TrialCondition.FAILED,
            traceback.format_exc(limit=20),
            failure_kind=classify_exception(e),
        )
    finally:
        if compile_hb is not None:
            compile_hb.close()
        if heartbeat is not None:
            heartbeat.close()
    if evaluator.should_stop():
        return TrialResult(TrialCondition.EARLY_STOPPED, evaluator.triggered.describe())
    if hang_event.is_set():
        return _hang_result()
    if ctx.deadline_exceeded():
        return _deadline_result()
    if stop_event is not None and stop_event.is_set():
        return TrialResult(TrialCondition.KILLED, "experiment reached terminal state")
    if ctx.drain_requested():
        # the train_fn unwound at a step boundary; its last checkpoint (if
        # any) is on disk and the resumed run re-submits this trial
        return TrialResult(TrialCondition.DRAINED, "checkpointed and exited for drain")
    return _finalize(trial, store, objective)


# one pattern for BOTH placeholder families so substitution is a single
# simultaneous pass over the template text — substituted values can never
# be re-expanded (a parameter value containing "${trialSpec...}" stays
# verbatim, and a label value containing "${trialParameters...}" does too)
_PLACEHOLDER = re.compile(
    r"\$\{trialParameters\.([^}]+)\}"
    r"|\$\{trialSpec\.([A-Za-z]+)(?:\[([^\]]+)\])?\}"
)


def _resolve_meta_ref(key: str, idx: str | None, raw: str, trial: Trial) -> str:
    """Trial-metadata references (reference ``manifest/generator.go:148-171``:
    Name/Namespace/Kind/APIVersion/Labels[k]/Annotations[k]).  Mapping:
    Namespace -> the owning experiment (the closest scoping construct),
    Kind/APIVersion -> this framework's type identity, and Annotations
    resolve from the same label map (trials here carry one metadata map, not
    two).  Kind and APIVersion are the JAX runner's strings, so a command
    renders the same under either package."""
    if key == "Name":
        return trial.name
    if key == "Namespace":
        return trial.experiment_name
    if key == "Kind":
        return "Trial"
    if key == "APIVersion":
        return "katib-tpu/v1beta1"
    if key in ("Labels", "Annotations"):
        if idx is None or idx not in trial.spec.labels:
            raise ValueError(
                f"illegal trial metadata reference {raw}: "
                f"trial has no label {idx!r}"
            )
        return trial.spec.labels[idx]
    raise ValueError(f"illegal trial metadata reference {raw}")


def substitute_command(
    command: list[str], params: dict, trial: Trial | None = None
) -> list[str]:
    """Render ``${trialParameters.X}`` placeholders and — when the trial is
    given — ``${trialSpec.*}`` metadata references (reference
    ``manifest/generator.go:99`` applyParameters + meta keys :148-171)."""

    def sub(m: "re.Match[str]") -> str:
        if m.group(1) is not None:  # ${trialParameters.X}
            name = m.group(1)
            return str(params[name]) if name in params else m.group(0)
        if trial is None:
            return m.group(0)
        return _resolve_meta_ref(m.group(2), m.group(3), m.group(0), trial)

    return [_PLACEHOLDER.sub(sub, arg) for arg in command]


class _LineSource:
    """Incremental metric-line source for a running black-box trial."""

    def poll(self) -> list[str]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class _StdoutSource(_LineSource):
    """Drains the process's stdout on a reader thread (never blocks poll).

    When ``log_path`` is given every line is also persisted there — the
    analog of the reference wrapping the trainer as ``<cmd>
    1>/var/log/katib/metrics.log 2>&1`` (``pod/utils.go:199``) so the UI
    can serve trial logs after the pod is gone."""

    def __init__(self, proc: subprocess.Popen, log_path: str | None = None):
        self._lines: list[str] = []
        self._lock = threading.Lock()
        self._log = None
        if log_path:
            try:
                # line-buffered: each line reaches disk as it's drained, so
                # the log is servable while the trial runs and survives a
                # reader thread that never reaches EOF (orphaned pipe)
                self._log = open(log_path, "w", buffering=1, errors="replace")
            except OSError:
                self._log = None  # log capture is best-effort
        self._thread = get_clock().spawn(
            lambda: self._drain(proc), name="katib-stdout-drain", daemon=True
        )

    def _drain(self, proc: subprocess.Popen) -> None:
        assert proc.stdout is not None
        for line in proc.stdout:
            if self._log is not None:
                try:
                    self._log.write(line)
                except OSError:
                    pass
            with self._lock:
                self._lines.append(line)
        if self._log is not None:
            try:
                self._log.close()
            except OSError:
                pass

    def poll(self) -> list[str]:
        with self._lock:
            out, self._lines = self._lines, []
        return out

    def join(self, timeout: float) -> None:
        """Wait for the reader to hit EOF so the final poll sees every line
        the process printed before exiting."""
        self._thread.join(timeout)


class _FileTailSource(_LineSource):
    """Tails the metrics file the trial writes (sidecar watch parity,
    ``file-metricscollector/main.go:143``)."""

    def __init__(self, path: str):
        self._path = path
        self._offset = 0
        self._buffer = ""

    def poll(self) -> list[str]:
        if not os.path.exists(self._path):
            return []
        try:
            with open(self._path, errors="replace") as f:
                f.seek(self._offset)
                chunk = f.read()
                self._offset = f.tell()
        except OSError:
            return []
        self._buffer += chunk
        if "\n" not in self._buffer:
            return []
        *complete, self._buffer = self._buffer.split("\n")
        return complete

    def drain(self) -> list[str]:
        """Flush a trailing line without a newline (process has exited)."""
        rest, self._buffer = self._buffer, ""
        return [rest] if rest.strip() else []


class _PrometheusScraper:
    """Polls the trial's exposition endpoint at the configured cadence;
    reports a sample only when its value changed since the last scrape (each
    scrape is a snapshot, not a stream — dedup keeps the store a series)."""

    def __init__(self, collector, metric_names: list[str]):
        path = collector.path or "/metrics"
        if not path.startswith("/"):
            path = "/" + path
        port = collector.port or 8080
        self.url = f"http://127.0.0.1:{port}{path}"
        self.interval = max(0.05, collector.scrape_interval)
        self.metric_names = metric_names
        self._last_values: dict[str, float] = {}
        self._next_scrape = 0.0

    def poll(self):
        from katib_tpu_torch.runner.metrics import parse_prometheus_samples

        now = get_clock().monotonic()
        if now < self._next_scrape:
            return []
        self._next_scrape = now + self.interval
        import urllib.request

        import http.client

        try:
            with urllib.request.urlopen(self.url, timeout=0.5) as r:
                text = r.read().decode(errors="replace")
        except (OSError, http.client.HTTPException):
            # endpoint not up yet / shutting down / half-closed socket
            # (BadStatusLine is not an OSError) — never fail the trial
            return []
        out = []
        # dedup per labelled series: two series of one base metric must not
        # re-emit each other's snapshots every scrape
        for key, log in parse_prometheus_samples(text, self.metric_names):
            if self._last_values.get(key) != log.value:
                self._last_values[key] = log.value
                out.append(log)
        return out


def _run_blackbox(
    trial: Trial,
    store: ObservationStore,
    evaluator: RuleEvaluator,
    objective,
    stop_event: threading.Event | None,
    watchdog=None,
    drain_event: threading.Event | None = None,
) -> TrialResult:
    collector = trial.spec.metrics_collector
    # the collector path renders like the command (per-trial file paths via
    # ${trialSpec.Name} keep parallel trials from clobbering each other's
    # metrics; the reference gets this isolation from per-pod emptyDirs)
    if collector.path:
        collector = dataclasses.replace(
            collector,
            path=substitute_command([collector.path], trial.params(), trial)[0],
        )
    metric_names = list(objective.all_metric_names())
    argv = substitute_command(trial.spec.command, trial.params(), trial)
    filters = [collector.filter] if collector.filter else []
    use_file = collector.path and collector.kind in (
        MetricsCollectorKind.FILE,
        MetricsCollectorKind.JSONL,
    )
    # TFEvent summaries are parsed once after exit (reference tfevent
    # collector semantics, ``tfevent-metricscollector/main.py:47-79``):
    # event files are binary, so there is no live line stream to tail
    tfevent_dir = (
        collector.path if collector.kind is MetricsCollectorKind.TFEVENT else None
    )

    prom = (
        _PrometheusScraper(collector, metric_names)
        if collector.kind is MetricsCollectorKind.PROMETHEUS
        else None
    )

    def parse(lines: list[str]):
        if (
            tfevent_dir
            or prom is not None
            or collector.kind is MetricsCollectorKind.NONE
        ):
            return []  # metrics come from event files / the endpoint, not stdout
        if collector.kind is MetricsCollectorKind.JSONL:
            # per-line so one malformed line (partial flush, stray diagnostic)
            # doesn't discard the valid lines polled in the same batch
            out = []
            for line in lines:
                try:
                    out.extend(parse_json_lines([line], metric_names))
                except ValueError:
                    continue
            return out
        return parse_text_lines_fast(lines, metric_names, filters)

    try:
        # start_new_session puts the trial in its own process group/session:
        # terminate/kill below signal the WHOLE group, so a trainer that
        # forks workers (data loaders, launchers) can't leave grandchildren
        # holding GPU memory after the trial is reaped
        proc = subprocess.Popen(
            argv,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            errors="replace",
            bufsize=1,
            start_new_session=(os.name == "posix"),
        )
    except OSError as e:
        return TrialResult(
            TrialCondition.FAILED,
            f"failed to launch {argv[0]}: {e}",
            failure_kind=classify_exception(e),
        )
    launched_at = get_clock().perf_counter()

    # metrics come from exactly one source: the file when configured, else
    # stdout (no double-reporting); stdout is always drained to avoid blocking
    log_path = None
    if trial.checkpoint_dir:
        try:
            os.makedirs(trial.checkpoint_dir, exist_ok=True)
            log_path = os.path.join(trial.checkpoint_dir, "trial.log")
        except OSError:
            log_path = None
    stdout_source = _StdoutSource(proc, log_path=log_path)
    source: _LineSource = _FileTailSource(collector.path) if use_file else stdout_source

    early_stopped = False
    killed = False
    deadline_hit = False
    hanged = False
    drained = False
    deadline = (
        get_clock().monotonic() + trial.spec.max_runtime_seconds
        if trial.spec.max_runtime_seconds is not None
        else None
    )
    # hang watchdog: progress = any polled metric line OR the metrics file's
    # mtime moving (a trainer mid-epoch appends without completing a line);
    # a stall past progress_deadline_seconds SIGTERMs through the same
    # escalation as the deadline, classified FailureKind.HANG
    hang_event = threading.Event()
    heartbeat = None
    if watchdog is not None and trial.spec.progress_deadline_seconds:
        heartbeat = watchdog.register(
            trial.name,
            trial.spec.progress_deadline_seconds,
            on_hang=lambda _name: hang_event.set(),
        )
    last_mtime: float | None = None
    terminate_at: float | None = None
    try:
        while True:
            raw = source.poll()
            polled = parse(raw)
            if prom is not None:
                polled += prom.poll()
            if heartbeat is not None:
                progressed = bool(raw) or bool(polled)
                if use_file and not progressed:
                    try:
                        mtime = os.stat(collector.path).st_mtime
                        progressed = mtime != last_mtime
                        last_mtime = mtime
                    except OSError:
                        pass
                if progressed:
                    heartbeat.beat()
            for log in polled:
                store.report(trial.name, [log])
                if evaluator.observe(log.metric_name, log.value):
                    early_stopped = True
            if stop_event is not None and stop_event.is_set():
                killed = True
            if hang_event.is_set():
                hanged = True
            if drain_event is not None and drain_event.is_set():
                # ask the trainer to exit (its own SIGTERM handler may
                # checkpoint); the escalation below bounds a deaf one
                drained = True
            if deadline is not None and get_clock().monotonic() > deadline:
                # per-trial wall-clock bound: SIGTERM (then SIGKILL below) the
                # hung trial instead of pinning an orchestrator slot forever
                deadline_hit = True
            if (
                early_stopped or killed or deadline_hit or hanged or drained
            ) and terminate_at is None:
                _signal_group(proc, signal.SIGTERM)
                terminate_at = get_clock().monotonic()
            if terminate_at is not None and get_clock().monotonic() - terminate_at > 10.0:
                # SIGTERM ignored; escalate (classification unchanged)
                _signal_group(proc, signal.SIGKILL)
                terminate_at = float("inf")
            if proc.poll() is not None:
                break
            get_clock().sleep(0.05)
    finally:
        if heartbeat is not None:
            heartbeat.close()
    rc = proc.wait()
    tracing.record_span(
        "subprocess", get_clock().perf_counter() - launched_at, trial=trial.name, rc=rc
    )

    # final sweep for lines written right before exit (including a last line
    # with no trailing newline); the reader thread must reach EOF first or
    # buffered lines race the sweep and a reported metric is lost
    stdout_source.join(timeout=5.0)
    final_lines = source.poll()
    if isinstance(source, _FileTailSource):
        final_lines += source.drain()
    for log in parse(final_lines):
        store.report(trial.name, [log])
    if tfevent_dir:
        from katib_tpu_torch.runner.tfevent import parse_tfevent_dir

        logs = parse_tfevent_dir(tfevent_dir, metric_names)
        if logs:
            store.report(trial.name, logs)

    if early_stopped:
        return TrialResult(TrialCondition.EARLY_STOPPED, evaluator.triggered.describe())
    if hanged:
        return TrialResult(
            TrialCondition.FAILED,
            "hang watchdog: no metric progress for "
            f"progress_deadline_seconds={trial.spec.progress_deadline_seconds}",
            failure_kind=FailureKind.HANG,
        )
    if deadline_hit:
        return TrialResult(
            TrialCondition.FAILED,
            f"trial exceeded max_runtime_seconds={trial.spec.max_runtime_seconds}",
        )
    if killed:
        return TrialResult(TrialCondition.KILLED, "experiment reached terminal state")
    if drained:
        return TrialResult(
            TrialCondition.DRAINED, "terminated for drain (resume re-runs it)"
        )
    if rc != 0:
        return TrialResult(
            TrialCondition.FAILED,
            f"exit code {rc}",
            failure_kind=classify_exit_code(rc),
        )
    return _finalize(trial, store, objective)


def _signal_group(proc: subprocess.Popen, sig: int) -> None:
    """Signal the trial's whole process group (the child is its own session
    leader, so ``pid == pgid``); fall back to the child alone when the group
    is already gone or group signalling is unsupported."""
    if os.name == "posix":
        try:
            os.killpg(proc.pid, sig)
            return
        except (ProcessLookupError, PermissionError, OSError):
            pass
    try:
        if sig == getattr(signal, "SIGKILL", None):
            proc.kill()
        else:
            proc.terminate()
    except OSError:
        pass
