"""Loop supervision for the async orchestrator (and anything loop-shaped).

The async engine's three loops (suggest / schedule / harvest,
``async_loops.py``) are plain daemon threads: before this module, a loop
that died or wedged silently starved the mesh until the run was killed by
hand — the "wedged pool, zero diagnosis" failure mode the multi-host and
multi-tenant layers must never inherit.  The
:class:`LoopSupervisor` closes that gap with the primitives the repo
already has:

- **watermarks** — each loop owns a :class:`~katib_tpu_torch.utils.watchdog.
  Heartbeat` (the same registry the hang watchdog uses, ``start=False`` so
  no second monitor thread exists) that the loop ``beat()``s on *real
  progress only*: proposals queued, units dispatched, futures settled.
- **classification** — every ``tick()`` each loop is classified:

  ========== ==========================================================
  OK          thread alive, watermark fresh
  STARVED     thread alive but its upstream has no work — idle silence
              is *not* the loop's fault and never counts toward a stall
              (the heartbeat is ``silence()``d while starved)
  STALLED     thread alive, work available, watermark frozen past the
              ``loopStallDeadlineSeconds`` spec knob
  CRASHED     thread dead without reaching a clean exit condition
  RESTARTING  a restart is scheduled (jittered backoff) but not yet due
  DONE        thread exited and its ``finished`` predicate holds
  ========== ==========================================================

- **recovery** — a CRASHED/STALLED loop is respawned at ``generation+1``
  (the engine fences stale-generation threads out of shared state) under a
  bounded per-loop restart budget with full-jitter backoff
  (``utils/faults.Backoff``).  Restarts are scheduled, not slept: ``tick``
  never blocks, so one ailing loop cannot delay supervision of the others.
- **graceful degradation** — when any loop exhausts its budget the
  supervisor raises the ``fallback`` flag instead of dying; the engine
  finishes in-flight work and degrades to the synchronous path
  (``KATIB_ASYNC_ORCH=0`` semantics).

The supervisor is engine-agnostic and clock-injectable: loops are
``add()``-ed as (spawn, has_work, finished) closures, so the unit tests
drive classification deterministically with a fake clock and bare threads.

Known limitation: restarting a loop wedged while *holding an engine lock*
cannot help (the replacement blocks on the same lock).  The engine places
its chaos seams at iteration tops, outside all locks; a real in-lock wedge
degrades to fallback once the replacement stalls too, which is still a
diagnosed exit rather than a silent hang.

Port of ``katib_tpu/orchestrator/supervisor.py``; host code only.
"""

from __future__ import annotations

import threading
from typing import Callable

from katib_tpu_torch.analysis import guarded_by, make_lock
from katib_tpu_torch.utils import observability as obs
from katib_tpu_torch.utils.clock import get_clock
from katib_tpu_torch.utils.faults import Backoff
from katib_tpu_torch.utils.watchdog import Watchdog

#: classification states returned by :meth:`LoopSupervisor.tick`
OK = "ok"
STALLED = "stalled"
STARVED = "starved"
CRASHED = "crashed"
RESTARTING = "restarting"
DONE = "done"


class _Loop:
    """Supervisor-internal record for one supervised loop."""

    __slots__ = (
        "name", "spawn", "has_work", "finished", "thread", "hb", "gen",
        "restarts", "next_restart_at", "ail_reason",
    )

    def __init__(self, name, spawn, has_work, finished, thread, hb):
        self.name = name
        self.spawn = spawn
        self.has_work = has_work
        self.finished = finished
        self.thread = thread
        self.hb = hb
        self.gen = 0
        self.restarts = 0
        self.next_restart_at: float | None = None
        self.ail_reason: str | None = None


class LoopSupervisor:
    """Heartbeat/classify/restart supervisor over named worker loops.

    ``add()`` registers a loop and spawns its generation-0 thread;
    ``tick()`` classifies every loop, performs due restarts, and returns
    ``{name: state}``.  ``beat(name)`` is the progress watermark bump the
    loop bodies call.  Thread-safety: ``tick`` runs on one thread (the
    engine's caller thread); ``beat``/``generation`` are safe from any.
    """

    # the loop registry is read by beat()/generation() from the loop
    # threads while tick()/add() mutate it on the caller thread; the
    # per-loop _Loop fields themselves are tick-thread-only by contract
    # (beat touches only the Heartbeat, which is lock-free by design)
    _GUARDS = guarded_by(_gen_lock=("_loops",))

    def __init__(
        self,
        stall_deadline: float = 60.0,
        restart_budget: int = 3,
        backoff: Backoff | None = None,
        clock=None,
        on_restart: Callable[[str, int, str, int], None] | None = None,
        on_fallback: Callable[[str], None] | None = None,
    ):
        self.stall_deadline = float(stall_deadline)
        self.restart_budget = int(restart_budget)
        # full jitter decorrelates restart storms; seeded so chaos runs
        # reproduce the same schedule
        self.backoff = backoff or Backoff(
            base=0.5, factor=2.0, cap=10.0, full_jitter=True, seed=0
        )
        # None = the ambient injectable clock (utils.clock); tests still
        # inject bare callables for deterministic classification.
        self._clock = clock if clock is not None else (lambda: get_clock().monotonic())
        self.on_restart = on_restart
        self.on_fallback = on_fallback
        # registry only — no monitor thread; tick() is the scan
        self._wd = Watchdog(clock=self._clock, start=False)
        self._loops: dict[str, _Loop] = {}
        self._gen_lock = make_lock("supervisor.gen")
        self._fallback_reason: str | None = None

    # -- registration / watermarks ------------------------------------------

    def add(
        self,
        name: str,
        spawn: Callable[[int], threading.Thread],
        has_work: Callable[[], bool] = lambda: True,
        finished: Callable[[], bool] = lambda: False,
    ) -> None:
        """Register loop ``name`` and start its generation-0 thread.
        ``spawn(gen)`` must return an already-started thread; ``has_work``
        says whether upstream work is available (False → idle silence is
        STARVED, not STALLED); ``finished`` says whether a dead thread is a
        clean completion (DONE) rather than a crash."""
        hb = self._wd.register(
            f"loop:{name}", self.stall_deadline, count_metric=False
        )
        lp = _Loop(name, spawn, has_work, finished, spawn(0), hb)
        # LCK001 fix: the generation-0 thread is already running and may
        # beat()/generation() concurrently — publish the record under the
        # same lock those readers take
        with self._gen_lock:
            self._loops[name] = lp

    def beat(self, name: str) -> None:
        """Progress watermark bump — call on real work only (enqueue,
        dispatch, settle), never on an idle poll."""
        with self._gen_lock:  # LCK001: add() publishes records concurrently
            lp = self._loops.get(name)
        if lp is not None:
            lp.hb.beat()

    def generation(self, name: str) -> int:
        """Current generation of ``name`` — loop bodies compare against the
        generation they were spawned with to fence stale threads out."""
        with self._gen_lock:
            lp = self._loops.get(name)
            return lp.gen if lp is not None else 0

    # -- introspection -------------------------------------------------------

    @property
    def fallback(self) -> bool:
        """True once any loop exhausted its restart budget — the engine
        should degrade to the synchronous path."""
        return self._fallback_reason is not None

    @property
    def fallback_reason(self) -> str | None:
        return self._fallback_reason

    def restart_counts(self) -> dict[str, int]:
        with self._gen_lock:  # LCK001: registry snapshot vs concurrent add()
            return {name: lp.restarts for name, lp in self._loops.items()}

    def threads(self) -> list[threading.Thread]:
        """Current-generation threads (stale wedged ones are abandoned)."""
        with self._gen_lock:  # LCK001: registry snapshot vs concurrent add()
            return [lp.thread for lp in self._loops.values()]

    # -- the scan ------------------------------------------------------------

    def tick(self) -> dict[str, str]:
        """Classify every loop, perform due restarts, return name→state."""
        now = self._clock()
        # snapshot, then classify OUTSIDE the lock: _restart bumps the
        # generation under _gen_lock (non-reentrant), and spawn/on_restart
        # callbacks may call generation() themselves
        with self._gen_lock:
            loops = list(self._loops.items())
        return {name: self._tick_loop(lp, now) for name, lp in loops}

    def _tick_loop(self, lp: _Loop, now: float) -> str:
        if lp.finished() and not lp.thread.is_alive():
            lp.hb.silence()
            obs.loop_stalled.set(0.0, loop=lp.name)
            return DONE
        if lp.next_restart_at is not None:
            if now < lp.next_restart_at:
                return RESTARTING
            self._restart(lp)
            return OK
        if self.fallback:
            # budget spent somewhere: freeze classification, no new restarts
            return lp.ail_reason or OK
        if not lp.thread.is_alive():
            self._ail(lp, CRASHED, now)
            return CRASHED
        if not lp.has_work():
            # upstream empty: not the loop's fault — stop the stall clock
            lp.hb.silence()
            obs.loop_stalled.set(0.0, loop=lp.name)
            return STARVED
        if lp.hb._silenced:
            # work just became available: the deadline measures from now
            lp.hb.reset()
        if now - lp.hb.last > self.stall_deadline:
            obs.loop_stalled.set(1.0, loop=lp.name)
            self._ail(lp, STALLED, now)
            return STALLED
        obs.loop_stalled.set(0.0, loop=lp.name)
        return OK

    def _ail(self, lp: _Loop, why: str, now: float) -> None:
        lp.ail_reason = why
        if lp.restarts >= self.restart_budget:
            self._fallback_reason = (
                f"loop {lp.name!r} {why} after {lp.restarts} restart(s) "
                f"(loopRestartBudget={self.restart_budget}); degrading to "
                "the synchronous orchestrator"
            )
            if self.on_fallback is not None:
                try:
                    self.on_fallback(self._fallback_reason)
                except Exception:
                    pass
            return
        lp.next_restart_at = now + self.backoff.delay(lp.restarts + 1)

    def _restart(self, lp: _Loop) -> None:
        lp.restarts += 1
        lp.next_restart_at = None
        with self._gen_lock:
            lp.gen += 1
            gen = lp.gen
        obs.loop_restarts.inc(loop=lp.name)
        if self.on_restart is not None:
            try:
                self.on_restart(lp.name, gen, lp.ail_reason or "", lp.restarts)
            except Exception:
                pass  # a bad callback must not kill supervision
        lp.ail_reason = None
        # watermark restarts clean: the new thread gets a full deadline
        lp.hb.reset()
        lp.thread = lp.spawn(gen)
