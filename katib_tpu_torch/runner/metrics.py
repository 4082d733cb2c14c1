"""Metrics-line parsing for black-box trials.

White-box trials report metrics through a direct callback, so they never
touch this module.  Black-box subprocess trials (arbitrary-language training
scripts) write lines to stdout or a file, and this parser extracts metric
points — functional parity with the reference's file/stdout metrics-collector
sidecar (``pkg/metricscollector/v1beta1/file-metricscollector/file-metricscollector.go:45``)
minus the pod machinery (no shared-PID-namespace scans, ``$$$$.pid`` completion
markers or SIGTERM dances: the runner owns the subprocess handle directly).

Formats:
- TEXT: ``name=value`` pairs matched by a filter regex, optional leading
  RFC3339 timestamp (reference ``parseLogsInTextFormat``; default filter
  ``common/const.go:47``).
- JSON lines: one object per line; metric keys map to values, optional
  ``timestamp`` key (reference ``parseLogsInJsonFormat``).
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
from datetime import datetime
from typing import Sequence

from katib_tpu_torch.core.types import MetricLog

# Reference default filter (``pkg/metricscollector/v1beta1/common/const.go:47``):
# word-ish metric name, '=', float with optional sign/decimals/exponent.
DEFAULT_TEXT_FILTER = r"([\w|-]+)\s*=\s*([+-]?\d*(?:\.\d+)?(?:[Ee][+-]?\d+)?)"

# Reported when the objective metric never appears in the logs (reference
# ``consts.UnavailableMetricValue``); the orchestrator turns this into the
# MetricsUnavailable trial condition.
UNAVAILABLE_METRIC_VALUE = "unavailable"


def _parse_rfc3339(token: str) -> float | None:
    # RFC3339 requires a zone offset (the reference parses with Go
    # time.RFC3339); naive/date-only tokens are rejected, which also keeps
    # this parser in lockstep with the native C++ one.
    try:
        dt = datetime.fromisoformat(token.replace("Z", "+00:00"))
    except ValueError:
        return None
    if dt.tzinfo is None:
        return None
    return dt.timestamp()


def parse_text_lines(
    lines: Sequence[str],
    metric_names: Sequence[str],
    filters: Sequence[str] = (),
) -> list[MetricLog]:
    """Parse TEXT-format log lines into metric points.

    Only lines containing a tracked metric name are inspected; each filter
    regex must expose (name, value) capture groups; names not in
    ``metric_names`` are dropped (reference ``parseLogsInTextFormat``).
    """
    regs = [re.compile(f) for f in (filters or [DEFAULT_TEXT_FILTER])]
    names = set(metric_names)
    out: list[MetricLog] = []
    for line in lines:
        if not any(m in line for m in names):
            continue
        ts = 0.0
        head = line.split(" ", 1)[0]
        parsed = _parse_rfc3339(head) if head else None
        if parsed is not None:
            ts = parsed
        for reg in regs:
            for match in reg.finditer(line):
                if match.lastindex is None or match.lastindex < 2:
                    continue
                name = match.group(1).strip()
                raw = match.group(2).strip()
                if name not in names or not raw:
                    continue
                try:
                    value = float(raw)
                except ValueError:
                    continue
                out.append(MetricLog(metric_name=name, value=value, timestamp=ts))
    return out


def parse_json_lines(
    lines: Sequence[str], metric_names: Sequence[str]
) -> list[MetricLog]:
    """Parse JSON-lines logs; each line is an object whose keys may include
    tracked metric names and an optional ``timestamp`` (string RFC3339 or
    epoch number)."""
    out: list[MetricLog] = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            raise ValueError(f"failed to parse json log line: {line[:120]!r}") from e
        if not isinstance(obj, dict):
            continue
        ts = 0.0
        raw_ts = obj.get("timestamp")
        if isinstance(raw_ts, (int, float)):
            ts = float(raw_ts)
        elif isinstance(raw_ts, str):
            ts = _parse_rfc3339(raw_ts) or 0.0
        step = obj.get("step", -1)
        if not isinstance(step, int):
            step = -1
        for name in metric_names:
            if name not in obj:
                continue
            try:
                value = float(obj[name])
            except (TypeError, ValueError):
                continue
            out.append(MetricLog(metric_name=name, value=value, timestamp=ts, step=step))
    return out


_native_parser = None
_native_checked = False
_native_lock = threading.Lock()


def text_parser() -> str:
    """Which parser :func:`parse_text_lines_fast` runs for the default
    filter: ``"native"`` when the C++ runtime is built (building it if
    needed), else ``"python"``."""
    global _native_parser, _native_checked
    with _native_lock:
        if not _native_checked:
            _native_checked = True
            from katib_tpu_torch.native.build import native_available

            if native_available():
                from katib_tpu_torch.native.store import parse_text_lines_native

                _native_parser = parse_text_lines_native
    return "python" if _native_parser is None else "native"


def parse_text_lines_fast(
    lines: Sequence[str],
    metric_names: Sequence[str],
    filters: Sequence[str] = (),
) -> list[MetricLog]:
    """``parse_text_lines`` with the C++ fast path, as the JAX package
    chooses it: the native parser for the default filter when the runtime
    builds, the Python parser otherwise and for custom regex filters (both
    give the same result)."""
    if filters:
        return parse_text_lines(lines, metric_names, filters)
    if text_parser() == "native":
        return _native_parser(lines, metric_names)
    return parse_text_lines(lines, metric_names)


_PROM_SAMPLE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+([^\s]+)(?:\s+\d+)?$"
)


def parse_prometheus_samples(
    text: str, metric_names: Sequence[str]
) -> list[tuple[str, MetricLog]]:
    """Parse Prometheus exposition format (reference Prometheus collector
    kind, ``common_types.go:216-219``): ``name{labels} value [timestamp]``
    samples; comment/HELP/TYPE lines skipped; only tracked base names kept;
    NaN samples dropped like garbage TEXT values.

    Returns ``(series_key, log)`` pairs where the key includes the label set
    — scrapers must dedup per series, not per base name, or two labelled
    series of one metric re-emit forever."""
    names = set(metric_names)
    out: list[tuple[str, MetricLog]] = []
    ts = time.time()
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _PROM_SAMPLE.match(line)
        if m is None or m.group(1) not in names:
            continue
        try:
            value = float(m.group(3))
        except ValueError:
            continue
        if not math.isfinite(value):
            continue
        key = m.group(1) + (m.group(2) or "")
        out.append(
            (key, MetricLog(metric_name=m.group(1), value=value, timestamp=ts))
        )
    return out


def parse_prometheus_text(text: str, metric_names: Sequence[str]) -> list[MetricLog]:
    return [log for _, log in parse_prometheus_samples(text, metric_names)]


def objective_reported(logs: Sequence[MetricLog], objective_metric: str) -> bool:
    """Reference ``newObservationLog``: logs must contain at least one finite
    objective point, else the trial is MetricsUnavailable."""
    return any(
        l.metric_name == objective_metric and math.isfinite(l.value) for l in logs
    )


def now_metric(name: str, value: float, step: int = -1) -> MetricLog:
    return MetricLog(metric_name=name, value=value, timestamp=time.time(), step=step)
