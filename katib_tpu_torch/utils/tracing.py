"""Span tracing — wall-clock attribution for every pipeline stage.

The counters in ``utils.observability`` say *what happened*; this module says
*where the time went*.  Podracer-style TPU systems attribute every wall-clock
second to a pipeline stage before optimizing it — suggestion latency, trial
queueing, XLA compile, per-step training — so the orchestrator opens one
:class:`Tracer` per experiment and every layer (orchestrator, suggesters,
trial runner, NAS loops) records spans into it:

- ``Tracer.span(name, **attrs)`` — context manager measuring ``perf_counter``
  intervals; each finished span is one JSONL line in
  ``<workdir>/<experiment>/trace.jsonl`` (the trace journal).
- the journal is append-only and restart-safe: a resumed experiment
  continues from the previous max elapsed offset (the same monotonic-base
  pattern ``darts/search.py`` uses for ``elapsed_s``), so a single export
  covers the experiment's whole life across process restarts.
- spans carry experiment/trial IDs in ``args`` so one export reconstructs
  the full lifecycle of e.g. a 32-trial Hyperband sweep.

Layers below the orchestrator don't hold a Tracer reference; they use the
ambient per-thread tracer (``activate``/``use_tracer`` set it, the
module-level :func:`span` / :func:`record_span` pick it up and no-op when
none is active — instrumented code stays runnable standalone).

Export: ``to_chrome_trace`` converts journal records to Chrome-trace JSON
(the ``traceEvents`` array Perfetto and ``chrome://tracing`` load directly);
``summarize`` aggregates latency distributions per span name.  CLI verbs
``katib-tpu trace export`` / ``trace summary`` wrap both.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Iterator

TRACE_FILE = "trace.jsonl"

TRACE_ENV = "KATIB_TRACE"


def enabled() -> bool:
    """Span-tracing kill switch: ``KATIB_TRACE=0`` (or ``false``/``off``)
    suppresses the per-experiment trace journal.  Tracing is best-effort by
    contract, and at sweep scale (tens of thousands of short trials — e.g.
    the virtual-time simulator) the per-span write+flush is pure overhead."""
    return os.environ.get(TRACE_ENV, "1").strip().lower() not in (
        "0",
        "false",
        "off",
    )


def trace_path(workdir: str, experiment_name: str) -> str:
    return os.path.join(workdir, experiment_name, TRACE_FILE)


class Span:
    """Handle yielded by ``span(...)``: collects attributes to attach when
    the span closes (``sp.set(condition="Succeeded")``)."""

    __slots__ = ("name", "attrs")

    def __init__(self, name: str, attrs: dict[str, Any]):
        self.name = name
        self.attrs = attrs

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)


class _NullSpan(Span):
    """Returned when no tracer is active; absorbs ``set`` calls."""

    def __init__(self) -> None:
        super().__init__("", {})

    def set(self, **attrs: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


def _journal_elapsed_base(path: str) -> float:
    """Max ``ts + dur`` over an existing journal — the monotonic elapsed
    base a resumed experiment continues from (0.0 for a fresh journal)."""
    base = 0.0
    try:
        with open(path, errors="replace") as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail write from a crash mid-append
                if isinstance(rec, dict):
                    try:
                        end = float(rec.get("ts", 0.0)) + float(rec.get("dur", 0.0))
                    except (TypeError, ValueError):
                        continue
                    base = max(base, end)
    except OSError:
        return 0.0
    return base


class Tracer:
    """Thread-safe span recorder appending to one experiment's trace journal.

    Every write is one line + flush so the journal survives a crash with at
    most the in-flight span lost; recording is best-effort (a full disk must
    never fail the experiment)."""

    def __init__(self, path: str, experiment: str | None = None):
        self.path = path
        self.experiment = experiment
        self._lock = threading.Lock()
        base = _journal_elapsed_base(path)
        # elapsed base continues across restarts so ts stays monotonic over
        # the experiment's whole life (darts/search.py elapsed_s pattern)
        self._t0 = time.perf_counter() - base
        # wall-clock anchor for ts→epoch conversion in exported traces
        self._wall_anchor = time.time() - base
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._fh = open(path, "a")
        self._closed = False

    def elapsed(self) -> float:
        """Seconds since experiment start (monotonic across restarts)."""
        return time.perf_counter() - self._t0

    def record(self, name: str, start_s: float, dur_s: float, **attrs: Any) -> None:
        """Append one finished span (``start_s`` in journal-elapsed seconds)."""
        rec: dict[str, Any] = {
            "name": name,
            "ts": round(start_s, 6),
            "dur": round(max(dur_s, 0.0), 6),
            "wall": round(self._wall_anchor + start_s, 3),
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if self.experiment is not None:
            attrs.setdefault("experiment", self.experiment)
        if attrs:
            rec["args"] = attrs
        try:
            line = json.dumps(rec, default=str)
        except (TypeError, ValueError):
            return
        with self._lock:
            if self._closed:
                return
            try:
                self._fh.write(line + "\n")
                self._fh.flush()
            except (OSError, ValueError):
                pass  # tracing is best-effort; never fail the experiment

    @contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Span]:
        sp = Span(name, attrs)
        start = self.elapsed()
        try:
            yield sp
        except BaseException as e:
            sp.attrs.setdefault("error", type(e).__name__)
            raise
        finally:
            self.record(name, start, self.elapsed() - start, **sp.attrs)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            try:
                self._fh.close()
            except OSError:
                pass


# -- ambient per-thread tracer ------------------------------------------------

_active = threading.local()


def current_tracer() -> Tracer | None:
    return getattr(_active, "tracer", None)


def activate(tracer: Tracer | None) -> Tracer | None:
    """Set the calling thread's ambient tracer; returns the previous one
    (pass it back to :func:`deactivate` to restore)."""
    prev = current_tracer()
    _active.tracer = tracer
    return prev


def deactivate(prev: Tracer | None) -> None:
    _active.tracer = prev


@contextmanager
def use_tracer(tracer: Tracer | None) -> Iterator[Tracer | None]:
    prev = activate(tracer)
    try:
        yield tracer
    finally:
        deactivate(prev)


@contextmanager
def span(name: str, **attrs: Any) -> Iterator[Span]:
    """Span on the ambient tracer; no-op (null span) when none is active."""
    tracer = current_tracer()
    if tracer is None:
        yield _NULL_SPAN
        return
    with tracer.span(name, **attrs) as sp:
        yield sp


def record_span(name: str, dur_s: float, **attrs: Any) -> None:
    """Record a span that ended *now* with the given duration — for code
    that measures intervals itself (e.g. time between epoch callbacks)."""
    tracer = current_tracer()
    if tracer is not None:
        end = tracer.elapsed()
        tracer.record(name, end - dur_s, dur_s, **attrs)


# -- journal readers / exporters ---------------------------------------------


def read_journal(path: str) -> list[dict]:
    """Parse a trace journal, skipping torn/corrupt lines (crash mid-append)."""
    records: list[dict] = []
    try:
        with open(path, errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and "name" in rec and "ts" in rec:
                    records.append(rec)
    except OSError:
        return []
    return records


def to_chrome_trace(records: list[dict]) -> dict:
    """Journal records → Chrome-trace JSON object format (complete events),
    loadable by Perfetto / ``chrome://tracing`` as-is.  Timestamps are µs of
    journal-elapsed time, so restarts stay on one monotonic axis."""

    def _num(rec: dict, key: str) -> float:
        try:
            return float(rec.get(key, 0.0))
        except (TypeError, ValueError):
            return 0.0

    events: list[dict] = []
    pids: set = set()
    for rec in records:
        pid = rec.get("pid", 0)
        pids.add(pid)
        events.append(
            {
                "name": str(rec.get("name", "?")),
                "cat": "katib",
                "ph": "X",
                "ts": round(_num(rec, "ts") * 1e6, 3),
                "dur": round(_num(rec, "dur") * 1e6, 3),
                "pid": pid,
                "tid": rec.get("tid", 0),
                "args": rec.get("args", {}),
            }
        )
    # process metadata rows label each restart's process in the viewer
    for pid in sorted(pids, key=str):
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": f"katib-tpu pid {pid}"},
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def summarize(records: list[dict]) -> list[dict]:
    """Latency distribution per span name: count, total/mean/p50/p95/max
    seconds — ordered by total descending (where the wall-clock went)."""
    by_name: dict[str, list[float]] = {}
    for rec in records:
        try:
            dur = float(rec.get("dur", 0.0))
        except (TypeError, ValueError):
            continue
        by_name.setdefault(str(rec.get("name", "?")), []).append(dur)
    out = []
    for name, durs in by_name.items():
        durs.sort()
        total = sum(durs)
        out.append(
            {
                "name": name,
                "count": len(durs),
                "total_s": round(total, 6),
                "mean_s": round(total / len(durs), 6),
                "p50_s": round(_percentile(durs, 0.50), 6),
                "p95_s": round(_percentile(durs, 0.95), 6),
                "max_s": round(durs[-1], 6),
            }
        )
    out.sort(key=lambda r: r["total_s"], reverse=True)
    return out


def export_chrome_trace(journal_path: str, out_path: str) -> int:
    """Read a journal, write Chrome-trace JSON to ``out_path``; returns the
    number of span events exported (0 when the journal is missing/empty)."""
    records = read_journal(journal_path)
    if not records:
        return 0
    doc = to_chrome_trace(records)
    parent = os.path.dirname(out_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, out_path)
    return len(records)
