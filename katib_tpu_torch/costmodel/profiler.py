"""On-demand ``torch.profiler`` capture + the profile-directory registry
(port of ``katib_tpu/costmodel/profiler.py``).

``enable_profiler`` runs trace each profiled trial into
``<workdir>/<exp>/<trial>/profile``, and this module makes those captures
discoverable three ways, as in the JAX package:

- in-process: :func:`register_profile` records every capture; the UI
  backend serves :func:`list_profiles` under ``/api/status``;
- trace journal: the orchestrator wraps profiled attempts in a
  ``profile.capture`` span carrying ``trace_dir``, so ``python -m
  katib_tpu_torch profile --list`` (and ``trace summary``) see past runs
  from any process;
- filesystem: :func:`scan_profiles` globs ``<workdir>/*/*/profile`` as
  the fallback for journals that predate the span.

:func:`capture` is the one capture wrapper.  It runs ``torch.profiler``
with CPU activity, and CUDA activity on a CUDA device, and writes one
Chrome trace (:data:`TRACE_FILE`, for Perfetto or ``chrome://tracing``)
into the directory, where the JAX package writes an xprof trace.  The
profiler is global to the process: a capture inside another raises
:class:`ProfilerBusy` (the orchestrator holds ``_profile_lock`` around
its captures, so its other trials run unprofiled).  On a CUDA device the
profiler starts and stops under the device's capture lock
(``nas/darts/step_loop.py::capture_lock``), so it never begins or ends
while another thread of the process captures a CUDA graph on that device,
and nothing here synchronizes the device outside that lock.
"""

from __future__ import annotations

import glob
import os
import threading
import time
from contextlib import contextmanager
from typing import Iterator

import torch

from katib_tpu_torch.analysis import make_lock

_PROFILES: list[dict] = []
_PROFILES_MAX = 64
_PROFILES_LOCK = make_lock("costmodel.profiles")
_active = threading.Lock()  # held while a capture of this process runs

PROFILE_SPAN = "profile.capture"
TRACE_FILE = "trace.json"


class ProfilerBusy(RuntimeError):
    """A capture was asked for while another capture of the process runs."""


def register_profile(
    trace_dir: str, *, trial: str | None = None, experiment: str | None = None
) -> dict:
    """Record one capture in the in-process registry (served by
    ``/api/status``); returns the entry."""
    entry = {
        "trace_dir": str(trace_dir),
        "trial": trial,
        "experiment": experiment,
        "wall": round(time.time(), 3),
    }
    with _PROFILES_LOCK:
        _PROFILES.append(entry)
        del _PROFILES[:-_PROFILES_MAX]
    return dict(entry)


def list_profiles() -> list[dict]:
    with _PROFILES_LOCK:
        return [dict(e) for e in _PROFILES]


def reset() -> None:
    """Forget registered captures (tests)."""
    with _PROFILES_LOCK:
        _PROFILES.clear()


@contextmanager
def capture(
    trace_dir: str, *, trial: str | None = None, experiment: str | None = None,
    device: str | torch.device | None = None,
) -> Iterator[str]:
    """Profile the body into ``<trace_dir>/trace.json``, registered on
    entry and bracketed by a ``profile.capture`` span so the directory is
    linked from both ``/api/status`` and the trace journal.  ``device`` is
    where the traced work runs (``cuda`` unless the caller names the CPU,
    raising without a GPU): a CUDA device adds CUDA activity, the CPU
    records CPU activity only.  Raises :class:`ProfilerBusy` inside another
    capture of this process."""
    from torch.profiler import ProfilerActivity, profile

    from katib_tpu_torch.device import resolve_device
    from katib_tpu_torch.utils import tracing

    dev = resolve_device(device)
    if not _active.acquire(blocking=False):
        raise ProfilerBusy(
            "a profiler capture is already running in this process "
            "(torch.profiler is global to the process: captures do not nest)")
    try:
        os.makedirs(trace_dir, exist_ok=True)
        register_profile(trace_dir, trial=trial, experiment=experiment)
        activities = [ProfilerActivity.CPU]
        lock = None
        if dev.type == "cuda":
            from katib_tpu_torch.nas.darts.step_loop import capture_lock

            activities.append(ProfilerActivity.CUDA)
            lock = capture_lock(dev)
        prof = profile(activities=activities)
        with tracing.span(PROFILE_SPAN, trial=trial, trace_dir=trace_dir):
            _under(lock, prof.start)
            try:
                yield trace_dir
            finally:
                _under(lock, prof.stop)
                prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
    finally:
        _active.release()


def _under(lock: threading.Lock | None, fn) -> None:
    if lock is None:
        fn()
        return
    with lock:
        fn()


def scan_profiles(workdir: str) -> list[dict]:
    """Offline discovery: profile directories under
    ``<workdir>/<experiment>/<trial>/profile`` plus any ``trace_dir``
    recorded on ``profile.capture`` spans in the experiments' journals."""
    from katib_tpu_torch.utils import tracing

    found: dict[str, dict] = {}
    for d in sorted(glob.glob(os.path.join(workdir, "*", "*", "profile"))):
        if not os.path.isdir(d):
            continue
        rel = os.path.relpath(d, workdir).split(os.sep)
        found[os.path.abspath(d)] = {
            "trace_dir": d,
            "experiment": rel[0] if len(rel) > 2 else None,
            "trial": rel[1] if len(rel) > 2 else None,
            "source": "filesystem",
        }
    for journal in sorted(glob.glob(os.path.join(workdir, "*", tracing.TRACE_FILE))):
        exp = os.path.basename(os.path.dirname(journal))
        for rec in tracing.read_journal(journal):
            if rec.get("name") != PROFILE_SPAN:
                continue
            args = rec.get("args", {}) or {}
            d = args.get("trace_dir")
            if not d:
                continue
            entry = found.setdefault(
                os.path.abspath(str(d)),
                {"trace_dir": str(d), "experiment": exp, "source": "journal"},
            )
            if args.get("trial"):
                entry["trial"] = args.get("trial")
            if rec.get("wall") is not None:
                entry["wall"] = rec.get("wall")
    return sorted(found.values(), key=lambda e: str(e.get("trace_dir")))
