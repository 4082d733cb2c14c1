"""Prometheus-style metrics + profiling hooks.

Parity with the reference controller's Prometheus instrumentation
(``pkg/controller.v1beta1/experiment/util/prometheus_metrics.go:40-60`` and
``trial/util/prometheus_metrics.go:40-60``: ``katib_experiment_*_total``,
``katib_experiments_current``, ``katib_trial_*_total`` incl.
``katib_trial_metrics_unavailable_total``) without the client_golang
dependency: a tiny thread-safe registry with text exposition and an optional
``/metrics`` HTTP endpoint.  The orchestrator increments these; anything
that scrapes Prometheus text format can consume them.

Beyond the reference set this registry also carries latency histograms
(``_bucket``/``_sum``/``_count`` exposition) and device telemetry gauges —
the aggregate view that pairs with the per-span journal in
``utils.tracing``.
"""

from __future__ import annotations

import bisect
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterable

from katib_tpu_torch.analysis import guarded_by, make_lock


def _escape_label_value(v: str) -> str:
    """Text exposition format: backslash, double-quote, and newline must be
    escaped inside label values or they corrupt the scrape output."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_labels(labels: dict[str, str]) -> str:
    return ",".join(
        f'{k}="{_escape_label_value(str(v))}"' for k, v in sorted(labels.items())
    )


def _format_value(value: float) -> str:
    return f"{value:g}"


class _Metric:
    _GUARDS = guarded_by(_lock=("_values",))

    def __init__(self, name: str, help_text: str, kind: str):
        self.name = name
        self.help = help_text
        self.kind = kind
        self._values: dict[tuple[tuple[str, str], ...], float] = {}
        self._lock = make_lock("metrics.metric")

    def _key(self, labels: dict[str, str]) -> tuple[tuple[str, str], ...]:
        return tuple(sorted(labels.items()))

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[self._key(labels)] = value

    def get(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def samples(self) -> Iterable[tuple[dict[str, str], float]]:
        with self._lock:
            return [(dict(k), v) for k, v in self._values.items()]

    def render_samples(self) -> list[str]:
        samples = self.samples()
        if not samples:
            return [f"{self.name} 0"]
        lines = []
        for labels, value in samples:
            if labels:
                lines.append(
                    f"{self.name}{{{_format_labels(labels)}}} {_format_value(value)}"
                )
            else:
                lines.append(f"{self.name} {_format_value(value)}")
        return lines

    def snapshot(self) -> dict:
        samples = [
            {"labels": labels, "value": value} for labels, value in self.samples()
        ]
        return {
            "kind": self.kind,
            "help": self.help,
            "total": sum(s["value"] for s in samples),
            "samples": samples,
        }


# Default bucket boundaries span sub-millisecond suggestion calls through
# multi-minute trials (seconds).
DEFAULT_BUCKETS = (
    0.001,
    0.005,
    0.01,
    0.05,
    0.1,
    0.25,
    0.5,
    1.0,
    2.5,
    5.0,
    10.0,
    30.0,
    60.0,
    120.0,
    300.0,
    600.0,
)


class _Histogram(_Metric):
    """Prometheus histogram: per-series bucket counts + sum + count, rendered
    as cumulative ``_bucket{le=...}`` / ``_sum`` / ``_count`` series."""

    _GUARDS = guarded_by(_lock=("_series",))

    def __init__(
        self,
        name: str,
        help_text: str,
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help_text, "histogram")
        self.buckets = tuple(sorted(buckets))
        # per label-key: [bucket counts (len+1, last = +Inf overflow), sum, count]
        self._series: dict[tuple[tuple[str, str], ...], list] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = [[0] * (len(self.buckets) + 1), 0.0, 0]
                self._series[key] = series
            series[0][idx] += 1
            series[1] += value
            series[2] += 1

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        raise TypeError(f"histogram {self.name} supports observe(), not inc()")

    set = inc  # type: ignore[assignment]

    def get_count(self, **labels: str) -> int:
        with self._lock:
            series = self._series.get(self._key(labels))
            return series[2] if series else 0

    def get_sum(self, **labels: str) -> float:
        with self._lock:
            series = self._series.get(self._key(labels))
            return series[1] if series else 0.0

    def samples(self) -> Iterable[tuple[dict[str, str], float]]:
        # "samples" for a histogram = per-series observation counts; the
        # full bucket detail lives in render_samples()/snapshot().
        with self._lock:
            return [(dict(k), float(s[2])) for k, s in self._series.items()]

    def _snapshot_series(self) -> list[tuple[dict[str, str], list[int], float, int]]:
        with self._lock:
            return [
                (dict(k), list(s[0]), s[1], s[2]) for k, s in self._series.items()
            ]

    def render_samples(self) -> list[str]:
        series = self._snapshot_series()
        if not series:
            # expose empty bucket/sum/count series so scrapers see the metric
            series = [({}, [0] * (len(self.buckets) + 1), 0.0, 0)]
        lines = []
        for labels, counts, total, count in series:
            cumulative = 0
            for bound, c in zip(self.buckets, counts):
                cumulative += c
                le_labels = dict(labels)
                le_labels["le"] = _format_value(bound)
                lines.append(
                    f"{self.name}_bucket{{{_format_labels(le_labels)}}} {cumulative}"
                )
            cumulative += counts[-1]
            inf_labels = dict(labels)
            inf_labels["le"] = "+Inf"
            lines.append(
                f"{self.name}_bucket{{{_format_labels(inf_labels)}}} {cumulative}"
            )
            suffix = f"{{{_format_labels(labels)}}}" if labels else ""
            lines.append(f"{self.name}_sum{suffix} {_format_value(total)}")
            lines.append(f"{self.name}_count{suffix} {count}")
        return lines

    def snapshot(self) -> dict:
        series = self._snapshot_series()
        return {
            "kind": self.kind,
            "help": self.help,
            "total": sum(count for _, _, _, count in series),
            "samples": [
                {
                    "labels": labels,
                    "count": count,
                    "sum": total,
                    "mean": (total / count) if count else 0.0,
                }
                for labels, _, total, count in series
            ],
        }


class MetricsRegistry:
    _GUARDS = guarded_by(_lock=("_metrics",))

    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._lock = make_lock("metrics.registry")

    def counter(self, name: str, help_text: str = "") -> _Metric:
        return self._register(name, help_text, "counter")

    def gauge(self, name: str, help_text: str = "") -> _Metric:
        return self._register(name, help_text, "gauge")

    def histogram(
        self,
        name: str,
        help_text: str = "",
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
    ) -> _Histogram:
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = _Histogram(name, help_text, buckets)
                self._metrics[name] = metric
            if not isinstance(metric, _Histogram):
                raise TypeError(f"metric {name} already registered as {metric.kind}")
            return metric

    def _register(self, name: str, help_text: str, kind: str) -> _Metric:
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = _Metric(name, help_text, kind)
                self._metrics[name] = metric
            return metric

    def render(self) -> str:
        """Prometheus text exposition format."""
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.render_samples())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict[str, dict]:
        """JSON-friendly view of every metric — served by the UI backend so
        the dashboard shows counters without a separate Prometheus scrape."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.snapshot() for m in metrics}

    def serve(self, port: int = 0, host: str = "127.0.0.1") -> "MetricsServer":
        """Expose ``/metrics`` on a daemon thread; returns a stoppable handle
        (reference serves on ``:8080``, ``config defaults.go:14``)."""
        registry = self

        class Handler(BaseHTTPRequestHandler):
            def _respond(self, include_body: bool) -> None:
                if self.path not in ("/metrics", "/"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = registry.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if include_body:
                    self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (http.server API)
                self._respond(include_body=True)

            def do_HEAD(self):  # noqa: N802 — probes HEAD before scraping
                self._respond(include_body=False)

            def _method_not_allowed(self):
                self.send_response(405)
                self.send_header("Allow", "GET, HEAD")
                self.send_header("Content-Length", "0")
                self.end_headers()

            do_POST = _method_not_allowed  # noqa: N815 (http.server API)
            do_PUT = _method_not_allowed  # noqa: N815
            do_DELETE = _method_not_allowed  # noqa: N815
            do_PATCH = _method_not_allowed  # noqa: N815
            do_OPTIONS = _method_not_allowed  # noqa: N815

            def log_message(self, *args):  # silence per-request stderr noise
                pass

        server = ThreadingHTTPServer((host, port), Handler)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return MetricsServer(server, thread)


class MetricsServer:
    def __init__(self, server: ThreadingHTTPServer, thread: threading.Thread):
        self._server = server
        self._thread = thread

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


# -- default registry + the reference metric set -----------------------------

REGISTRY = MetricsRegistry()

experiments_created = REGISTRY.counter(
    "katib_experiment_created_total", "Experiments started"
)
experiments_succeeded = REGISTRY.counter(
    "katib_experiment_succeeded_total", "Experiments reaching a success condition"
)
experiments_failed = REGISTRY.counter(
    "katib_experiment_failed_total", "Experiments reaching Failed"
)
experiments_current = REGISTRY.gauge(
    "katib_experiments_current", "Experiments currently running"
)
trials_created = REGISTRY.counter("katib_trial_created_total", "Trials launched")
trials_succeeded = REGISTRY.counter(
    "katib_trial_succeeded_total", "Trials completing successfully"
)
trials_failed = REGISTRY.counter("katib_trial_failed_total", "Trials failing")
trials_early_stopped = REGISTRY.counter(
    "katib_trial_early_stopped_total", "Trials stopped by early-stopping rules"
)
trials_killed = REGISTRY.counter(
    "katib_trial_killed_total", "Trials killed by experiment shutdown"
)
trials_metrics_unavailable = REGISTRY.counter(
    "katib_trial_metrics_unavailable_total",
    "Trials finishing without reporting the objective metric",
)
trials_retried = REGISTRY.counter(
    "katib_trial_retried_total",
    "Trial attempts re-run after a classified failure (kind label)",
)
suggester_errors = REGISTRY.counter(
    "katib_suggester_errors_total",
    "get_suggestions exceptions absorbed by the circuit breaker (algorithm label)",
)

# -- latency distributions + device telemetry ---------------------------------

experiment_duration = REGISTRY.histogram(
    "katib_experiment_duration_seconds",
    "Wall-clock duration of completed experiments",
)
trial_duration = REGISTRY.histogram(
    "katib_trial_duration_seconds",
    "Wall-clock duration of completed trials",
)
suggestion_latency = REGISTRY.histogram(
    "katib_suggestion_latency_seconds",
    "Latency of suggester get_suggestions calls",
)
trial_attempts = REGISTRY.histogram(
    "katib_trial_attempts",
    "Executions per terminal trial (1 = no retry; includes transient retries "
    "and metrics re-runs)",
    buckets=(1.0, 2.0, 3.0, 4.0, 5.0, 8.0, 13.0),
)
trial_step_seconds = REGISTRY.histogram(
    "katib_trial_step_seconds",
    "Per-step (or per-epoch-averaged) training step time",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0),
)
trial_first_step_seconds = REGISTRY.gauge(
    "katib_trial_first_step_seconds",
    "First-step latency split into compile vs execute (phase label)",
)
trial_images_per_second = REGISTRY.gauge(
    "katib_trial_images_per_second",
    "Training throughput of the most recent epoch",
)
device_hbm_bytes = REGISTRY.gauge(
    "katib_device_hbm_bytes_in_use",
    "Per-device bytes in use (torch.cuda.memory_stats, where available)",
)
step_loop_window = REGISTRY.gauge(
    "katib_step_loop_window",
    "Configured scan-window size of the device-resident DARTS step loop "
    "(steps folded into one dispatch; 0 when the step loop is not engaged)",
)
steps_per_dispatch = REGISTRY.gauge(
    "katib_steps_per_dispatch",
    "Training steps executed per host dispatch in the most recent epoch "
    "(window size under the device-resident step loop, 1 under eager "
    "stepping — the first thing to check when MFU is low)",
)

# -- roofline telemetry (katib_tpu_torch/costmodel/) --------------------------------

dispatch_mfu = REGISTRY.gauge(
    "katib_dispatch_mfu",
    "Model-flops utilization of the live dispatch path: XLA-counted flops "
    "per measured step second over the device kind's peak "
    "(costmodel.peaks; KATIB_PEAK_FLOPS overrides the denominator)",
)
arithmetic_intensity = REGISTRY.gauge(
    "katib_arithmetic_intensity",
    "Flops per byte accessed of the live program (XLA pre-fusion bytes); "
    "below the device's ridge intensity the program is memory-bound and "
    "no dispatch tuning reaches peak flops",
)
roofline_headroom = REGISTRY.gauge(
    "katib_roofline_headroom",
    "Measured step time over the program's binding roofline floor "
    "(1.0 = running at the roofline; 10 = 10x slack — look at "
    "katib_steps_per_dispatch and the trace journal before the kernel)",
)

# -- async orchestration (orchestrator/async_loops.py) ------------------------

suggest_seconds = REGISTRY.histogram(
    "katib_suggest_seconds",
    "Wall-clock latency of each suggest-loop suggester call (async "
    "orchestrator; hidden behind training when lookahead is healthy)",
)
pending_proposals = REGISTRY.gauge(
    "katib_pending_proposals",
    "Proposed-but-undispatched trials held in the suggest->schedule queue "
    "(0 sustained means the suggester cannot keep up with the mesh)",
)
mesh_occupancy = REGISTRY.gauge(
    "katib_mesh_occupancy",
    "Fraction of executor slots busy with dispatched trials "
    "(sustained < 0.5 means the mesh idles between cohorts)",
)
loop_restarts = REGISTRY.counter(
    "katib_loop_restarts_total",
    "Async loop threads restarted by the supervisor, by loop= label "
    "(suggest/schedule/harvest); a climbing count is a restart storm — "
    "check the journal's supervisor events for the crash tracebacks",
)
loop_stalled = REGISTRY.gauge(
    "katib_loop_stalled",
    "1 while the supervisor classifies the loop= labeled async loop as "
    "STALLED (alive but its progress watermark is frozen past "
    "loopStallDeadlineSeconds with upstream work available), else 0",
)
speculative_dispatches = REGISTRY.counter(
    "katib_speculative_dispatch_total",
    "Straggler trials speculatively re-dispatched as singletons "
    "(stragglerFactor x median settle time exceeded)",
)
speculative_wins = REGISTRY.counter(
    "katib_speculative_wins_total",
    "Speculative re-dispatches that settled before their original attempt "
    "(a low win/dispatch ratio means stragglerFactor is too aggressive)",
)

# -- vectorized trial cohorts (runner/cohort.py) ------------------------------

cohorts_executed = REGISTRY.counter(
    "katib_cohort_executed_total",
    "Vectorized trial cohorts executed (vmap-batched multi-trial programs)",
)
cohort_size = REGISTRY.histogram(
    "katib_cohort_size",
    "Member trials per vectorized cohort",
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0),
)
cohort_trials_per_sec = REGISTRY.gauge(
    "katib_cohort_trials_per_sec",
    "Member-trial throughput of the most recent cohort execution",
)
cohort_fallbacks = REGISTRY.counter(
    "katib_cohort_fallback_total",
    "Cohorts whose vectorized path failed and re-ran members serially",
)
cohort_devices = REGISTRY.gauge(
    "katib_cohort_devices",
    "Devices the most recent cohort's trial axis spanned "
    "(1 = single-device vmap, D = SPMD-sharded member dimension)",
)

# -- on-device Population Based Training (parallel/pbt.py) --------------------

pbt_generations = REGISTRY.counter(
    "katib_pbt_generations_total",
    "PBT generations executed (train + select + clone + perturb rounds)",
)
pbt_exploits = REGISTRY.counter(
    "katib_pbt_exploits_total",
    "PBT exploit events: members overwritten by a top-quantile winner's "
    "state + hyperparameters",
)
pbt_onchip = REGISTRY.gauge(
    "katib_pbt_onchip",
    "1 while a PBT population is evolving on device (fused generation "
    "dispatches, zero host transfers inside a generation); 0 when the "
    "host checkpoint-exchange path is active",
)
compile_cache_enabled = REGISTRY.gauge(
    "katib_compile_cache_enabled",
    "1 when a compile cache is wired (KATIB_COMPILE_CACHE / "
    "ExperimentSpec.compile_cache): the shape registry's rows and the local "
    "artifact tier of kernel libraries persist under <cache>/torch",
)

# -- compile amortization (katib_tpu_torch/compile/) --------------------------------

compile_cache_hits = REGISTRY.counter(
    "katib_compile_cache_hits_total",
    "First steps whose signature this process had already warmed (by a "
    "trial's capture or the prewarm twin: cuDNN/cuBLAS set-up and the "
    "capture machinery paid before; program label)",
)
compile_cache_misses = REGISTRY.counter(
    "katib_compile_cache_misses_total",
    "First steps whose signature this process had not warmed before "
    "(cold: the first warm-up and capture on the critical path; program "
    "label)",
)
prewarm_compiles = REGISTRY.counter(
    "katib_prewarm_compiles_total",
    "Programs warmed up and captured ahead of their trials by the "
    "background prewarm worker / CLI prewarm verb (program label)",
)
first_step_compile_seconds = REGISTRY.histogram(
    "katib_first_step_compile_seconds",
    "Time from trial start to the first step boundary, split warm vs cold "
    "(cache label) — a cache regression shows as the cold series growing",
)
artifact_hits = REGISTRY.counter(
    "katib_artifact_hits_total",
    "Kernel libraries fetched from an artifact tier, per tier "
    "(tier=local|shared) — a shared hit is an nvcc build another host paid",
)
artifact_misses = REGISTRY.counter(
    "katib_artifact_misses_total",
    "Artifact lookups that found nothing in a tier (tier label); a miss "
    "in every tier builds the kernel library with nvcc",
)
artifact_publishes = REGISTRY.counter(
    "katib_artifact_publishes_total",
    "Kernel libraries published to an artifact tier (tier label; deduped "
    "on content address, so fleets publish each library once)",
)
artifact_quarantines = REGISTRY.counter(
    "katib_artifact_quarantines_total",
    "Corrupt or mismatched artifact envelopes moved aside "
    "(tier=local|shared|fsck) instead of crashing the fetch path",
)

# -- preemption / hang robustness (utils/watchdog.py, orchestrator drain) -----

trial_hangs = REGISTRY.counter(
    "katib_trial_hangs_total",
    "Trials interrupted by the hang watchdog "
    "(no progress past progressDeadlineSeconds)",
)
drain_requested = REGISTRY.gauge(
    "katib_drain_requested",
    "1 while the orchestrator is draining after SIGTERM/SIGINT "
    "(checkpoint-and-exit requested; run is resumable)",
)
checkpoint_fallbacks = REGISTRY.counter(
    "katib_checkpoint_fallback_total",
    "Corrupt/unverifiable checkpoint steps skipped by restore() "
    "(quarantined; an older verifiable step was used instead)",
)

# -- device-layer fault tolerance (utils/meshhealth.py, elastic cohorts) ------

device_healthy = REGISTRY.gauge(
    "katib_device_healthy",
    "Per-device preflight verdict: 1 healthy, 0 wedged/absent "
    "(device/platform labels; set by katib-tpu doctor and the run/bench "
    "preflight)",
)
mesh_degraded = REGISTRY.counter(
    "katib_mesh_degraded_total",
    "Elastic cohort degradations after a device fault "
    "(sharded -> narrower mesh -> single-device vmap -> serial)",
)
compile_hangs = REGISTRY.counter(
    "katib_compile_hangs_total",
    "Trials whose jit compile / first dispatch overran "
    "compileDeadlineSeconds (classified retryable CompileHang)",
)
journal_replayed_events = REGISTRY.counter(
    "katib_journal_replayed_events_total",
    "Experiment-journal records applied during a resume replay "
    "(orchestrator/journal.py)",
)
settlement_duplicates = REGISTRY.counter(
    "katib_settlement_duplicates_total",
    "Duplicate/out-of-order settled records dropped by exactly-once "
    "replay (keyed by trial name + attempt epoch)",
)
suggester_fence_rebuilds = REGISTRY.counter(
    "katib_suggester_fence_rebuilds_total",
    "Stale suggester_state.pkl discarded on resume (fence older than the "
    "journal's last settled seq); suggester rebuilt from trial history",
)
fsck_repairs = REGISTRY.counter(
    "katib_fsck_repairs_total",
    "Repairs applied by katib-tpu fsck (torn journal tails truncated, "
    "unverifiable snapshots quarantined)",
)


def record_device_memory(registry_gauge: _Metric | None = None) -> None:
    """Best-effort per-device memory gauges from ``torch.cuda.memory_stats``
    (the caching allocator's ``allocated_bytes.all.current``), labelled
    ``kind="gpu"``.  Reads nothing in a process that has not initialised
    CUDA, so a CPU run never touches the driver."""
    gauge = registry_gauge or device_hbm_bytes
    try:
        import torch

        if not torch.cuda.is_initialized():
            return
        for index in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(index)
            in_use = stats.get("allocated_bytes.all.current")
            if in_use is not None:
                gauge.set(float(in_use), device=str(index), kind="gpu")
    except Exception:
        pass  # telemetry only — never break a training loop
