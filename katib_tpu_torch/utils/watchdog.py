"""Hang watchdog: heartbeat registry + monitor thread for stuck trials.

The cooperative deadline in ``TrialContext`` is only polled at reporting
points (``runner/context.py``), so a white-box trial wedged *between*
``report()`` calls — a stuck XLA compile, a deadlocked collective, an infeed
stall — pins its orchestrator slot forever.  The reference has no analog
(a hung pod is eventually reaped by Kubernetes liveness machinery); on a
single-process TPU orchestrator the watchdog is that machinery:

- trials ``register()`` a heartbeat with their ``progress_deadline_seconds``;
- progress signals ``beat()`` it: white-box trials via ``TrialContext.report``,
  cohorts at step boundaries via ``CohortContext.report``, black-box trials
  from the runner's poll loop on metric-line/metric-file-mtime activity;
- a single monitor daemon thread scans all registered heartbeats; one that
  goes silent past its deadline fires its ``on_hang`` callback exactly once
  and bumps ``katib_trial_hangs_total``.

``on_hang`` is the interruption seam: the white-box runner passes an event
setter the trial observes cooperatively through ``ctx.should_stop()``, the
black-box runner triggers its existing SIGTERM→SIGKILL escalation.  The
resulting failure classifies as :class:`~katib_tpu_torch.utils.faults.FailureKind`
``HANG`` — retryable, so the orchestrator's PR-2 retry machinery re-runs the
trial from its last checkpoint.

The same registry also arms the *compile* watchdog: the white-box runner and
``run_cohort`` register a second, one-shot heartbeat named ``compile:<name>``
with ``compile_deadline_seconds`` that is closed on the first ``beat()``
(first dispatch completed).  If it fires instead, the trial settles as the
retryable ``FailureKind.COMPILE_HANG`` — a stuck XLA compile is otherwise
indistinguishable from a wedged device.

Stdlib-only (no jax) and clock-injectable for deterministic tests.
"""

from __future__ import annotations

import threading
from typing import Callable

from katib_tpu_torch.analysis import guarded_by, make_lock
from katib_tpu_torch.utils.clock import get_clock


class Heartbeat:
    """One registered trial's progress pulse.  ``beat()`` is the only method
    trial code touches; it is safe from any thread and allocation-free."""

    __slots__ = (
        "name", "deadline", "on_hang", "count_metric", "_last", "_fired",
        "_silenced", "_wd",
    )

    def __init__(
        self, wd: "Watchdog", name: str, deadline: float, on_hang,
        count_metric: bool = True,
    ):
        self._wd = wd
        self.name = name
        self.deadline = float(deadline)
        self.on_hang = on_hang
        self.count_metric = count_metric
        self._last = wd._clock()
        self._fired = False
        self._silenced = False

    def beat(self) -> None:
        """Record progress (resets the stall clock)."""
        self._last = self._wd._clock()

    @property
    def fired(self) -> bool:
        """True once the watchdog classified this trial as hung."""
        return self._fired

    @property
    def last(self) -> float:
        """Clock value of the most recent ``beat()`` (the raw watermark)."""
        return self._last

    def silence(self) -> None:
        """Stop scanning this heartbeat without unregistering it — used by
        the loop supervisor while a loop is legitimately idle (STARVED):
        no-work silence must not count toward its stall deadline."""
        self._silenced = True

    def reset(self) -> None:
        """Re-arm after ``silence()`` or after a fire — the stall clock
        restarts from now (a restarted loop begins with a clean deadline)."""
        self._silenced = False
        self._fired = False
        self._last = self._wd._clock()

    def close(self) -> None:
        self._wd.unregister(self)


class Watchdog:
    """Heartbeat registry with one shared monitor thread.

    The thread starts lazily on the first ``register()`` and exits on
    ``stop()`` (or with the process — it is a daemon).  Scanning is O(live
    trials) every ``interval`` seconds, so detection latency is bounded by
    ``deadline + interval``.
    """

    # Heartbeat's own fields (_last/_fired/_silenced) are deliberately
    # lock-free: beat() must be allocation-free and safe from any thread,
    # and a stale read only delays hang detection by one scan interval.
    _GUARDS = guarded_by(_lock=("_beats", "_thread", "hang_count"))

    def __init__(self, interval: float = 0.25, clock=None, start: bool = True):
        self.interval = float(interval)
        # None = the ambient injectable clock (utils.clock); tests and the
        # supervisor may still inject a bare callable.
        self._clock = clock if clock is not None else (lambda: get_clock().monotonic())
        self._autostart = bool(start)
        self._lock = make_lock("watchdog.beats")
        self._beats: list[Heartbeat] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.hang_count = 0

    def register(
        self,
        name: str,
        deadline: float,
        on_hang: Callable[[str], None] | None = None,
        count_metric: bool = True,
    ) -> Heartbeat:
        """Start watching a trial; returns its :class:`Heartbeat` handle.
        ``on_hang(name)`` fires at most once, from the monitor thread.
        ``count_metric=False`` keeps a fire out of ``katib_trial_hangs_total``
        (supervisor loop heartbeats are not trial hangs)."""
        hb = Heartbeat(self, name, deadline, on_hang, count_metric=count_metric)
        with self._lock:
            self._beats.append(hb)
            if self._thread is None and self._autostart:
                self._stop.clear()
                self._thread = get_clock().spawn(
                    self._monitor, name="katib-watchdog", daemon=True
                )
        return hb

    def unregister(self, hb: Heartbeat) -> None:
        with self._lock:
            try:
                self._beats.remove(hb)
            except ValueError:
                pass

    def stop(self) -> None:
        """Stop the monitor thread (idempotent); registered heartbeats stay
        valid but are no longer scanned."""
        self._stop.set()
        # LCK001 fix: take+clear the thread handle under the lock (a
        # concurrent register() reads _thread to decide whether to spawn);
        # join OUTSIDE it — the monitor's _scan takes the same lock
        with self._lock:
            thread = self._thread
            self._thread = None
        if thread is not None:
            get_clock().join_thread(thread, timeout=2.0)

    def check_now(self) -> list[str]:
        """Run one scan synchronously (deterministic tests with a fake
        clock); returns the names newly classified as hung."""
        return self._scan()

    # -- internals ----------------------------------------------------------

    def _monitor(self) -> None:
        while not get_clock().wait(self._stop, self.interval):
            self._scan()

    def _scan(self) -> list[str]:
        now = self._clock()
        with self._lock:
            stalled = [
                hb
                for hb in self._beats
                if not hb._fired
                and not hb._silenced
                and now - hb._last > hb.deadline
            ]
            for hb in stalled:
                hb._fired = True
            self.hang_count += len(stalled)
        if stalled:
            from katib_tpu_torch.utils import observability as obs

            for hb in stalled:
                if hb.count_metric:
                    obs.trial_hangs.inc()
                if hb.on_hang is not None:
                    try:
                        hb.on_hang(hb.name)
                    except Exception:
                        pass  # the monitor must outlive a bad callback
        return [hb.name for hb in stalled]
