"""Podracer-style asynchronous orchestration: three decoupled loops joined
by bounded queues (the Podracer architectures pattern from PAPERS.md applied
to HPO control flow).

The synchronous run loop interleaves propose -> execute -> harvest on one
thread, so the mesh idles whenever the suggester is thinking, a cohort is
short of members, or harvest is settling.  This engine splits the loop:

- **suggest loop** (thread): keeps ``suggest_lookahead`` proposals journaled
  and ready ahead of the scheduler, so suggester latency hides behind
  training instead of gating dispatch.  Budget-aware: never materializes
  past ``max_trial_count``.
- **schedule loop** (thread): heterogeneous cohort packing — ready trials
  accumulate into per-key shape buckets (``compile/buckets.py`` pads the
  dispatched width to a power of two, so a 5-member flush reuses the
  8-wide executable) and flush on *any* of: full width, the
  ``cohort_fill_deadline_seconds`` timeout, suggester exhaustion, or a
  remaining budget that can never fill the bucket — a partial cohort never
  waits indefinitely.  Dispatch backpressure is driven by slot occupancy
  (``occupancy_target``) rather than a fixed trial count, and each flushed
  bucket's compile signature feeds the prewarm worker before submit.
- **harvest loop** (thread): settles completions through the exactly-once
  journal path (``Orchestrator._harvest``) and owns terminal verdicts,
  stop, drain, and the livelock guard.

The caller's thread runs the :class:`~katib_tpu_torch.orchestrator.supervisor.
LoopSupervisor` tick loop: all three loops are heartbeated via progress
watermarks, classified (OK / STALLED / STARVED / CRASHED / DONE), and
crashed or stalled loops are respawned at ``generation+1`` with frontier
state re-seeded from the journal-backed trial map (``_reseed_lost``) under
a bounded per-loop restart budget; stale-generation threads are fenced out
of shared state by generation checks at every iteration and hand-off.
After the budget is exhausted ``run()`` returns ``None`` and
``Orchestrator.run`` degrades to the synchronous loop instead of dying.

With ``speculativeRedispatch`` on, the harvest loop also re-dispatches a
straggling member (running past ``stragglerFactor`` x the median settle
time) as a singleton rival on a free slot: the rival executes a *clone* of
the Trial, and first-settle-wins is enforced by object identity — the
winner's object is (or becomes) ``exp.trials[name]``, the loser's eventual
result hits ``Orchestrator._harvest``'s stale-owner guard and is
discarded, so the (trial, attempt-epoch) journal keying never sees a
second settle.

The event journal is the coordination substrate: ``proposed`` (suggest),
``queued`` (entered a packing bucket), ``started`` (dispatched) and the
existing ``settled`` records mean a crash at any hand-off point leaves
non-terminal trials that resume re-seeds into the ready queue —
exactly-once settlement keyed on (trial, retry epoch) is unchanged.

Locking discipline (acquire order: state > queue > futures):

- ``_state_lock`` — inserts into ``exp.trials`` (materialize) vs the
  iterations harvest / ``update_optimal`` / terminal checks perform.  The
  suggester call itself runs OUTSIDE the lock (only its own thread
  inserts), so a slow suggester never stalls settlement or dispatch.
- ``_queue_lock`` — the ready deque, packing buckets, and dispatch queue
  move atomically, so the terminal check can never observe a trial
  "in neither queue nor futures" mid-hand-off.
- ``_futures_lock`` — the shared futures dict (scheduler inserts while
  harvest iterates).

Pool threads (``_execute`` / ``_execute_cohort``) take no engine locks, so
the mesh critical path is untouched.

Port of ``katib_tpu/orchestrator/async_loops.py``.  The loops are host
code: no loop thread touches the device, only the pool threads running
trials and cohorts (``runner/cohort.py``) do.  A trial mesh
(``parallel/mesh.py``) reaches every trial; a ``trial`` axis > 1 raises
here (ROADMAP item 9b); cohort packing engages for a train_fn
with a cohort twin and a width above one.
"""

from __future__ import annotations

import collections
import copy
import statistics
import threading
import traceback

from katib_tpu_torch.analysis import guarded_by, make_lock
from katib_tpu_torch.utils.clock import get_clock
from katib_tpu_torch.core.types import (
    COHORT_KEY_LABEL,
    Experiment,
    ExperimentCondition,
    Trial,
    TrialCondition,
)
from katib_tpu_torch.parallel.mesh import trial_axis_size
from katib_tpu_torch.runner.cohort import cohort_fn_of
from katib_tpu_torch.suggest.base import call_suggester
from katib_tpu_torch.utils import observability as obs
from katib_tpu_torch.utils import tracing

#: how long the wind-down waits for the suggest/schedule threads to notice
#: the halt flag (a suggester blocked mid-call is abandoned on its daemon
#: thread — the breaker/watchdog own misbehaving suggesters, not drain)
_JOIN_TIMEOUT = 5.0

#: livelock guard threshold, matching the synchronous loop's 30s stall cap
_STALL_SECONDS = 30.0


class OccupancyMeter:
    """Time-weighted mean busy-slot fraction.

    The clock starts lazily at the FIRST dispatch (running > 0), so the
    unavoidable cold ramp — the first suggester call before any trial can
    exist — does not dilute the sustained number; what is measured is
    "once work started flowing, how full did the mesh stay".
    """

    def __init__(self, slots: int):
        self.slots = max(1, int(slots))
        self._t0: float | None = None
        self._last = 0.0
        self._frac = 0.0
        self._area = 0.0

    def update(self, busy: int) -> float:
        now = get_clock().monotonic()
        frac = min(1.0, busy / self.slots)
        if self._t0 is None:
            if busy <= 0:
                return frac
            self._t0 = self._last = now
            self._frac = frac
            return frac
        self._area += self._frac * (now - self._last)
        self._last = now
        self._frac = frac
        return frac

    def elapsed(self) -> float:
        return 0.0 if self._t0 is None else self._last - self._t0

    def sustained(self) -> float:
        el = self.elapsed()
        return (self._area / el) if el > 0 else 0.0


class AsyncLoops:
    """One experiment's async engine; ``run()`` replaces the synchronous
    while-loop body inside ``Orchestrator.run``'s pool context and returns
    the terminal (or drained) experiment."""

    # the queues move together (see the module docstring's discipline
    # section), and the dispatch/consumption counters move WITH the queues
    # they describe — the suggest loop's bank-deficit estimate must read
    # both under the same lock or the refill races the scheduler's drain.
    # The futures-side set covers everything the scheduler inserts while
    # the harvest thread iterates, including the speculation bookkeeping.
    _GUARDS = guarded_by(
        _queue_lock=(
            "_ready", "_packing", "_pack_ts", "_dispatchq",
            "_dispatched_total", "_consumed_last_call",
        ),
        _futures_lock=(
            "futures", "_fut_meta", "_rivals", "_speculated",
            "_settle_durations",
        ),
    )

    def __init__(
        self,
        orch,
        exp: Experiment,
        suggester,
        early_stopper,
        mesh,
        pool,
        breaker,
        stop_event: threading.Event,
        drain_event: threading.Event,
        futures: dict,
        initial_ready: list[Trial] = (),
    ):
        self.orch = orch
        self.exp = exp
        self.spec = exp.spec
        self.suggester = suggester
        self.early_stopper = early_stopper
        self.mesh = mesh
        self.pool = pool
        self.breaker = breaker
        self.stop_event = stop_event
        self.drain_event = drain_event
        self.futures = futures

        self._state_lock = make_lock("async.state")
        self._queue_lock = make_lock("async.queue")
        self._futures_lock = make_lock("async.futures")

        #: proposed trials awaiting packing (suggest -> schedule hand-off)
        self._ready: collections.deque[Trial] = collections.deque(initial_ready)
        #: per-cohort-key packing buckets + first-arrival timestamps
        self._packing: dict[str, list[Trial]] = {}
        self._pack_ts: dict[str, float] = {}
        #: flushed units awaiting a free slot (schedule -> pool hand-off)
        self._dispatchq: collections.deque[list[Trial]] = collections.deque()

        self._halt = threading.Event()       # internal: stop all three loops
        self._exhausted = threading.Event()  # suggester returned exhausted
        self._suggest_inflight = False       # a get_suggestions call is running
        self._suggester_busy = False         # erroring / cooling down, not idle
        self._last_activity = get_clock().monotonic()
        #: terminal/drained result hand-off from the harvest thread to the
        #: supervising caller thread
        self._result: Experiment | None = None
        self._done = threading.Event()
        #: first-finalizer-wins guard: a restarted-over stale harvest thread
        #: waking up mid-wind-down must not run _terminal/_drain twice
        self._finalize_once = make_lock("async.finalize")
        self._finalized = False
        self._supervisor = None  # LoopSupervisor, built in run()
        self._fallback_reason: str | None = None
        #: last crash traceback per loop, for the journal's supervisor events
        self._loop_errors: dict[str, str] = {}
        # -- speculative straggler re-dispatch bookkeeping --------------------
        #: future -> dispatch time (monotonic), for settle-duration medians
        #: and straggler detection; guarded by _futures_lock
        self._fut_meta: dict = {}
        self._settle_durations: list[float] = []
        #: rival future -> (original future, trial name, clone trial)
        self._rivals: dict = {}
        self._speculated: set[str] = set()  # one rival per trial per run
        self._spec_wins = 0
        #: members dispatched since engine start (consumption-rate estimator
        #: for the suggest loop's anticipatory refill)
        self._dispatched_total = 0
        self._consumed_last_call = 0
        #: set by _submit; the harvest loop owes a status.json publish
        self._publish_dirty = False

        spec = self.spec
        trial_devices = 1
        if mesh is not None:
            if trial_axis_size(mesh) > 1:
                raise NotImplementedError(
                    f"a trial axis of size {trial_axis_size(mesh)} under the async engine "
                    "shards cohorts over the mesh, not ported yet (ROADMAP item 9b)"
                )
        self.width = max(spec.cohort_width, trial_devices)
        self._use_cohorts = self.width > 1 and cohort_fn_of(spec.train_fn) is not None
        self._default_key = spec.cohort_key or (
            orch._TRIAL_MESH_KEY if trial_devices > 1 else None
        )
        # proposal lookahead: deep for non-adaptive suggesters (the points
        # never depend on results), clamped to the in-flight width for
        # adaptive ones (ASHA/BO/PBT) — racing them ahead of observations
        # burns the budget on uninformed proposals (see Suggester.adaptive)
        base_width = max(spec.parallel_trial_count, self.width)
        self.lookahead = spec.suggest_lookahead or (
            base_width if getattr(suggester, "adaptive", True) else 4 * base_width
        )
        # occupancy backpressure, counted in MEMBER trials (a cohort future
        # carries width members on one slot): ``parallel_trial_count`` is
        # the concurrency contract the sync loop enforces via _shortfall,
        # scaled down by occupancy_target to deliberately throttle.  A unit
        # wider than the limit dispatches alone (the sync loop can never
        # build one, but an explicit suggestLookahead + wide mesh can).
        self.member_limit = max(
            1, round(spec.parallel_trial_count * spec.occupancy_target)
        )
        self.meter = OccupancyMeter(spec.parallel_trial_count)

    # -- entry point ---------------------------------------------------------

    def run(self) -> Experiment | None:
        """Run to a terminal (or drained) experiment under supervision.
        Returns ``None`` when the supervisor exhausted its restart budget:
        the caller (``Orchestrator.run``) then degrades to the synchronous
        loop — in-flight futures stay live in the shared dict, and queued
        proposals were put back to PENDING for resubmission."""
        from katib_tpu_torch.orchestrator.supervisor import LoopSupervisor
        from katib_tpu_torch.utils.faults import Backoff

        spec = self.spec
        sup = self._supervisor = LoopSupervisor(
            stall_deadline=spec.loop_stall_deadline_seconds,
            restart_budget=spec.loop_restart_budget,
            backoff=Backoff(base=0.2, factor=2.0, cap=5.0, full_jitter=True, seed=0),
            on_restart=self._on_loop_restart,
        )
        done_or_halt = lambda: self._halt.is_set() or self._done.is_set()
        sup.add(
            "suggest",
            self._spawner("suggest", self._suggest_loop),
            has_work=self._suggest_has_work,
            finished=lambda: done_or_halt() or self._exhausted.is_set(),
        )
        sup.add(
            "schedule",
            self._spawner("schedule", self._schedule_loop),
            has_work=self._schedule_has_work,
            finished=done_or_halt,
        )
        sup.add(
            "harvest",
            self._spawner("harvest", self._harvest_loop),
            # the harvest loop is the engine's poll heart: it always has
            # work (terminal checks, occupancy metering), so its silence is
            # always a stall, never starvation
            finished=done_or_halt,
        )
        try:
            while not get_clock().wait(self._done, self.orch.poll_interval):
                sup.tick()
                if sup.fallback:
                    return self._fallback_to_sync(sup.fallback_reason)
            # the harvest THREAD ran _finish/_drain_and_exit, which closed
            # the tracer and cleared only that thread's ambient slot — the
            # ambient tracer is thread-local, so the caller thread (the one
            # Orchestrator.run activated it on) restores its own slot here
            tracing.deactivate(self.orch._prev_tracer)
            return self._result
        finally:
            self._stop_loops()
            self._cancel_rivals()
            # satellite guarantee: a finished/fallen-back run never reports
            # stale occupancy or a latched stall flag on /api/status
            obs.pending_proposals.set(0.0)
            obs.mesh_occupancy.set(0.0)
            for name in ("suggest", "schedule", "harvest"):
                obs.loop_stalled.set(0.0, loop=name)

    # -- supervision plumbing ------------------------------------------------

    def _spawner(self, name: str, body):
        """Thread factory for the supervisor: ``spawn(gen)`` starts the loop
        body at generation ``gen``; crashes are recorded (not raised) so the
        supervisor sees a dead thread, classifies, and restarts it."""

        def spawn(gen: int) -> threading.Thread:
            def main():
                try:
                    body(gen)
                except Exception:
                    self._loop_errors[name] = (
                        f"{name} loop error:\n" + traceback.format_exc(limit=20)
                    )

            return get_clock().spawn(
                main, name=f"{name}-{self.exp.name}-g{gen}", daemon=True
            )

        return spawn

    def _current(self, name: str, gen: int) -> bool:
        """Generation fence: a restarted-over (stale) thread must stop
        touching shared state the moment a replacement exists."""
        sup = self._supervisor
        return sup is None or sup.generation(name) == gen

    def _beat(self, name: str) -> None:
        sup = self._supervisor
        if sup is not None:
            sup.beat(name)

    def _seam(self, name: str) -> None:
        """Chaos seam at the top of every loop iteration, OUTSIDE all
        engine locks (so an injected kill never strands a lock)."""
        inj = self.orch.fault_injector
        if inj is not None:
            inj.on_loop_iteration(name)

    def _suggest_has_work(self) -> bool:
        """Upstream-work predicate for stall-vs-starvation: the suggest
        loop is starved (idle through no fault of its own) while the bank
        is full, the budget is spent, the suggester is exhausted, or the
        breaker is cooling down."""
        if self._exhausted.is_set() or not self.breaker.allow():
            return False
        want = self._bank_deficit()
        if self.spec.max_trial_count is not None:
            want = min(want, self.spec.max_trial_count - len(self.exp.trials))
        return want > 0

    def _schedule_has_work(self) -> bool:
        """The schedule loop has work when something can actually MOVE:
        ready trials to pack, a bucket full or past its fill deadline, or a
        dispatchable head unit within the occupancy limit — a queue frozen
        by backpressure or drain is starvation, not a stall."""
        orch = self.orch
        if (
            orch._drain_requested.is_set()
            or orch._stop_requested.is_set()
            or self.stop_event.is_set()
        ):
            return False
        now = get_clock().monotonic()
        with self._queue_lock:
            if self._ready:
                return True
            for key, bucket in self._packing.items():
                if len(bucket) >= self.width:
                    return True
                if (
                    now - self._pack_ts.get(key, now)
                    >= self.spec.cohort_fill_deadline_seconds
                ):
                    return True
            if self._dispatchq:
                head = self._dispatchq[0]
                with self._futures_lock:
                    undone = self._undone_members()
                return undone == 0 or undone + len(head) <= self.member_limit
        return False

    def _on_loop_restart(self, name: str, gen: int, why: str, restarts: int) -> None:
        """Supervisor restart callback: audit the restart in the journal and
        re-seed any frontier state the dying loop dropped."""
        detail = self._loop_errors.pop(name, "")
        self.orch._jappend(
            "supervisor",
            self.exp,
            extra={
                "action": "restart",
                "loop": name,
                "generation": gen,
                "why": why,
                "restarts": restarts,
                "error": detail[-500:] if detail else "",
            },
        )
        self._reseed_lost()

    def _reseed_lost(self) -> None:
        """Rebuild the suggest->schedule frontier after a loop death: every
        non-terminal, non-drained trial that is in no queue and owned by no
        future goes back to the ready deque as PENDING.  ``exp.trials`` is
        the journal-backed state (``proposed``/``queued``/``started``
        records materialized it), so this is exactly what a process-level
        resume would reconstruct — done in-process, without the restart."""
        with self._state_lock, self._queue_lock, self._futures_lock:
            held = {t.name for t in self._ready}
            for bucket in self._packing.values():
                held.update(t.name for t in bucket)
            for unit in self._dispatchq:
                held.update(t.name for t in unit)
            for owner in self.futures.values():
                for t in owner if isinstance(owner, list) else [owner]:
                    held.add(t.name)
            for _orig, name, _clone in self._rivals.values():
                held.add(name)
            lost = [
                t
                for t in self.exp.trials.values()
                if not t.condition.is_terminal()
                and t.condition is not TrialCondition.DRAINED
                and t.name not in held
            ]
            for t in lost:
                t.condition = TrialCondition.PENDING
                self._ready.append(t)
        if lost:
            self._update_pending_gauge()

    def _fallback_to_sync(self, reason: str | None) -> None:
        """Restart budget exhausted: wind the async engine down WITHOUT
        failing the experiment.  Queued proposals go back to PENDING (the
        sync loop resubmits them), in-flight futures stay in the shared
        dict (the sync loop harvests them), and ``run()`` returns None."""
        orch, exp = self.orch, self.exp
        self._fallback_reason = reason or "supervisor fallback"
        # the sync loop owns the experiment from here: no surviving or
        # stale harvest thread may reach _terminal/_drain anymore
        with self._finalize_once:
            self._finalized = True
        self._stop_loops()
        self._cancel_rivals()
        self._reseed_lost()
        for t in self._drain_queues():
            t.condition = TrialCondition.PENDING
            t.message = "async engine fell back to sync; resubmitted"
        sup = self._supervisor
        orch._jappend(
            "supervisor",
            exp,
            extra={
                "action": "fallback",
                "reason": self._fallback_reason,
                "restarts": sup.restart_counts() if sup else {},
            },
        )
        self._record_stats()
        return None

    # -- suggest loop --------------------------------------------------------

    def _suggest_loop(self, gen: int = 0) -> None:
        orch, exp, spec = self.orch, self.exp, self.spec
        while not self._halt.is_set() and self._current("suggest", gen):
            self._seam("suggest")
            if self._exhausted.is_set():
                return
            # anticipatory refill: a refill of exactly (lookahead -
            # queued) arrives one suggester-latency late, by which time
            # the scheduler has consumed ~latency*throughput more — at
            # steady state the bank sits that much below target and the
            # mesh starves briefly every cycle.  Adding the members
            # consumed during the LAST call (a one-step rate estimate)
            # keeps the bank at the full lookahead when the call lands.
            want = self._bank_deficit()
            if spec.max_trial_count is not None:
                want = min(want, spec.max_trial_count - len(exp.trials))
            if want <= 0:
                get_clock().wait(self._halt, orch.poll_interval)
                continue
            if not self.breaker.allow():
                # cooling down after an error: not idle, not progress
                self._suggester_busy = True
                self._last_activity = get_clock().monotonic()
                get_clock().wait(self._halt, orch.poll_interval)
                continue
            self._suggester_busy = False
            sug_start = orch._tracer.elapsed() if orch._tracer else 0.0
            t0 = get_clock().perf_counter()
            with self._queue_lock:  # LCK001: the scheduler bumps it in _submit
                d0 = self._dispatched_total
            self._suggest_inflight = True
            try:
                # the deadline bounds a wedged/blocked get_suggestions:
                # it trips the breaker (bounded retries, then a diagnosed
                # terminal verdict) instead of freezing this loop until
                # the supervisor burns a restart on it.  Half the stall
                # deadline, so a call abandoned at its limit still returns
                # (and beats) before the supervisor classifies the loop
                # stalled — abandonment is the cheap recovery, a restart
                # is the expensive one
                # the experiment's tracer, for the spans the suggester records
                with tracing.use_tracer(orch._tracer):
                    proposals, outcome = call_suggester(
                        self.suggester,
                        exp,
                        want,
                        self.breaker,
                        orch.fault_injector,
                        deadline=0.5 * spec.loop_stall_deadline_seconds,
                        events=(self._halt,),
                    )
            finally:
                self._suggest_inflight = False
            if not self._current("suggest", gen):
                # fenced: a replacement thread owns the frontier now —
                # these proposals were never journaled, drop them
                return
            self._beat("suggest")
            # LCK001 fix: the rate estimate is read by _bank_deficit on this
            # thread AND the supervisor's has_work probe on the caller
            # thread; write it under the same lock the counters live under
            with self._queue_lock:
                self._consumed_last_call = self._dispatched_total - d0
            dur = get_clock().perf_counter() - t0
            obs.suggestion_latency.observe(dur, algorithm=spec.algorithm.name)
            obs.suggest_seconds.observe(dur, algorithm=spec.algorithm.name)
            if orch._tracer is not None and (
                proposals or outcome in ("exhausted", "error") or dur >= 1e-3
            ):
                orch._tracer.record(
                    "suggest",
                    sug_start,
                    dur,
                    algorithm=spec.algorithm.name,
                    count=len(proposals),
                    outcome=outcome,
                )
            if outcome == "error":
                self._suggester_busy = True
                self._last_activity = get_clock().monotonic()
                obs.suggester_errors.inc(algorithm=spec.algorithm.name)
            if proposals:
                with self._state_lock:
                    trials = [
                        orch._materialize(
                            exp,
                            p,
                            # rules attach at DISPATCH (_refresh_rules),
                            # not here: a lookahead proposal materializes
                            # long before the history its rule snapshot
                            # would need
                            None,
                            self.suggester,
                            condition=TrialCondition.PENDING,
                            journal=False,
                        )
                        for p in proposals
                    ]
                # one durability barrier for the whole refill — per-trial
                # appends would serialize ~lookahead fsyncs between the
                # suggester returning and the first dispatch
                orch._jappend_group("proposed", exp, trials)
                with self._queue_lock:
                    self._ready.extend(trials)
                self._update_pending_gauge()
                with self._state_lock:
                    orch._persist_suggester(exp, self.suggester)
                    orch._publish(exp)
                self._last_activity = get_clock().monotonic()
            if outcome == "exhausted":
                # set AFTER the final proposals are queued, so the
                # terminal check never sees "exhausted + empty" early
                self._exhausted.set()
                return
            if not proposals:
                get_clock().wait(self._halt, orch.poll_interval)

    # -- schedule loop -------------------------------------------------------

    def _schedule_loop(self, gen: int = 0) -> None:
        orch = self.orch
        while not self._halt.is_set() and self._current("schedule", gen):
            self._seam("schedule")
            moved = self._pack_ready()
            flushed = self._flush_buckets()
            dispatched = self._dispatch_units()
            if moved or flushed or dispatched:
                self._update_pending_gauge()
                self._beat("schedule")
            else:
                get_clock().wait(self._halt, orch.poll_interval)

    def _cohort_key_for(self, trial: Trial) -> str | None:
        if not self._use_cohorts:
            return None
        key = trial.spec.labels.get(COHORT_KEY_LABEL) or self._default_key
        if key:
            # stamp it back so the journal/UI show which bucket it rode in
            trial.spec.labels.setdefault(COHORT_KEY_LABEL, key)
        return key

    def _pack_ready(self) -> int:
        """Move ready trials into packing buckets (keyless -> straight to
        the dispatch queue as singletons).  Journals the ``queued``
        hand-off records as one batched durability barrier."""
        moved: list[Trial] = []
        prewarms: list[list[Trial]] = []
        while True:
            with self._queue_lock:
                if not self._ready:
                    break
                trial = self._ready.popleft()
                key = self._cohort_key_for(trial)
                if key is None:
                    self._dispatchq.append([trial])
                else:
                    bucket = self._packing.setdefault(key, [])
                    if not bucket:
                        self._pack_ts[key] = get_clock().monotonic()
                    bucket.append(trial)
                    if len(bucket) & (len(bucket) - 1) == 0:
                        # speculative prewarm at each power-of-two fill
                        # level: the bucketed executable for the current
                        # size compiles while the bucket keeps filling
                        # (dedup in the worker makes superseded sizes
                        # cheap no-ops)
                        prewarms.append(list(bucket))
            moved.append(trial)
        if moved:
            self.orch._jappend_group("queued", self.exp, moved)
        for peek in prewarms:
            self.orch._submit_prewarm(self.spec, peek, self.mesh)
        return len(moved)

    def _flush_buckets(self) -> int:
        """Flush full buckets always; flush PARTIAL buckets when the fill
        deadline expires, the suggester is exhausted, or the remaining
        proposal budget can never complete them — the fix for a remainder
        smaller than the cohort width waiting forever."""
        spec = self.spec
        flushed = 0
        now = get_clock().monotonic()
        budget_left = (
            spec.max_trial_count - len(self.exp.trials)
            if spec.max_trial_count is not None
            else None
        )
        with self._queue_lock:
            for key in list(self._packing):
                bucket = self._packing[key]
                while len(bucket) >= self.width:
                    self._dispatchq.append(bucket[: self.width])
                    del bucket[: self.width]
                    self._pack_ts[key] = now
                    flushed += 1
                if not bucket:
                    del self._packing[key]
                    self._pack_ts.pop(key, None)
                    continue
                deadline_hit = (
                    now - self._pack_ts.get(key, now)
                    >= spec.cohort_fill_deadline_seconds
                )
                starved = self._exhausted.is_set() or (
                    budget_left is not None
                    and budget_left <= 0
                    and not self._ready
                )
                if deadline_hit or starved:
                    self._dispatchq.append(list(bucket))
                    del self._packing[key]
                    self._pack_ts.pop(key, None)
                    flushed += 1
        return flushed

    def _undone_members(self) -> int:  # lint: holds(_futures_lock)
        return sum(
            (len(o) if isinstance(o, list) else 1)
            for f, o in self.futures.items()
            if not f.done()
        )

    def _dispatch_units(self) -> int:
        """Submit queued units while occupancy allows.  The hand-off from
        dispatch queue to futures dict is atomic under the queue lock, so
        the terminal check never sees a unit in neither."""
        n = 0
        orch = self.orch
        while not self._halt.is_set():
            # drain/stop freeze dispatch immediately: a draining trial's
            # early return must not free a slot for a NEW trial in the
            # window before the harvest loop acts on the request (queued
            # units become PENDING leftovers / cancelled instead)
            if (
                orch._drain_requested.is_set()
                or orch._stop_requested.is_set()
                or self.stop_event.is_set()
            ):
                return n
            with self._queue_lock:
                if not self._dispatchq:
                    return n
                unit = self._dispatchq[0]
                with self._futures_lock:
                    undone = self._undone_members()
                if undone > 0 and undone + len(unit) > self.member_limit:
                    return n
            # early-stopping rules snapshot at DISPATCH time, not propose
            # time: lookahead materializes trials before any history
            # exists, so a rule frozen at _materialize would be
            # permanently empty.  Outside the queue lock (state > queue
            # ordering); the head is stable because this thread is the
            # only popper while the loops run.
            self._refresh_rules(unit)
            with self._queue_lock:
                if not self._dispatchq or self._dispatchq[0] is not unit:
                    continue
                self._dispatchq.popleft()
                self._submit(unit)
            n += 1
        return n

    def _refresh_rules(self, unit: list[Trial]) -> None:
        es = self.early_stopper
        if es is None:
            return
        # settle completed-but-unharvested futures first: sub-second
        # trials outrun the harvest poll, and the median needs every
        # finished trial counted as SUCCEEDED, not merely future-done
        with self._state_lock, self._futures_lock:
            self.orch._harvest(self.exp, self.futures)
            rules = es.get_rules(self.exp)
        if not rules:
            return
        for t in unit:
            if not t.spec.early_stopping_rules:
                t.spec.early_stopping_rules = rules

    def _submit(self, unit: list[Trial]) -> None:  # lint: holds(_queue_lock)
        orch, exp = self.orch, self.exp
        orch._submit_prewarm(self.spec, unit, self.mesh)
        now = get_clock().time()
        for t in unit:
            t.condition = TrialCondition.RUNNING
            t.start_time = now
        orch._jappend_group("started", exp, unit)
        if len(unit) == 1:
            fut = get_clock().submit(self.pool, orch._execute, exp, unit[0], self.mesh)
            owner: Trial | list[Trial] = unit[0]
        else:
            fut = get_clock().submit(self.pool, orch._execute_cohort, exp, unit, self.mesh)
            owner = unit
        with self._futures_lock:
            self.futures[fut] = owner
            self._fut_meta[fut] = get_clock().monotonic()
        self._dispatched_total += len(unit)
        self._last_activity = get_clock().monotonic()
        # the harvest loop republishes status.json soon after: without
        # this, a run whose trials all dispatch between publishes would
        # never show a Running trial to external watchers
        self._publish_dirty = True

    # -- harvest loop (thread) ----------------------------------------------

    def _harvest_loop(self, gen: int = 0) -> None:
        """Thread body: poll/settle until a terminal (or drained) verdict,
        published to the supervising caller thread via ``_result`` +
        ``_done``.  Returning ``None`` from the cycle means this thread was
        fenced out (restarted over) or lost the finalize race — the
        replacement owns the verdict."""
        result = self._harvest_cycle(gen)
        if result is not None:
            self._result = result
            self._done.set()

    def _finalize(self, fn):
        """First-finalizer-wins: a stale harvest thread waking up mid
        wind-down must not run ``_terminal``/``_drain`` a second time."""
        with self._finalize_once:
            if self._finalized:
                return None
            self._finalized = True
        return fn()

    def _harvest_cycle(self, gen: int) -> Experiment | None:
        orch, exp = self.orch, self.exp
        while not self._halt.is_set() and self._current("harvest", gen):
            self._seam("harvest")
            with self._state_lock, self._futures_lock:
                orch._harvest(exp, self.futures)
            self._note_settled_futures()
            self._check_speculations()
            if self.spec.speculative_redispatch:
                self._maybe_speculate()
            with self._futures_lock:
                # busy in MEMBER trials: a running cohort future fills
                # width slots' worth of the mesh on one pool thread
                busy = sum(
                    (len(o) if isinstance(o, list) else 1)
                    for f, o in self.futures.items()
                    if f.running()
                )
                undone = sum(1 for f in self.futures if not f.done())
            obs.mesh_occupancy.set(self.meter.update(busy))
            if self._publish_dirty:
                self._publish_dirty = False
                with self._state_lock:
                    orch._publish(exp)

            if orch._stop_requested.is_set():
                self.stop_event.set()
            if self.stop_event.is_set():
                return self._finalize(
                    lambda: self._terminal(
                        ExperimentCondition.FAILED, message="experiment stopped"
                    )
                )
            if orch._drain_requested.is_set():
                return self._finalize(self._drain)

            queued = self._queued_count()
            exhausted_eff = self._exhausted.is_set() and queued == 0
            # LCK001 fix: _check_terminal's exhaustion arm tests the futures
            # dict while the scheduler may be inserting — hold both locks
            # (state > futures, same order as the harvest call above)
            with self._state_lock, self._futures_lock:
                verdict = orch._check_terminal(exp, exhausted_eff, self.futures)
            if verdict is not None:
                return self._finalize(lambda: self._terminal(verdict))

            if self.breaker.tripped:
                msg = (
                    f"suggester failed {self.breaker.failures} consecutive "
                    f"times (suggester_max_errors="
                    f"{self.spec.suggester_max_errors}); last error:\n"
                    + self.breaker.last_failure
                )
                return self._finalize(
                    lambda: self._terminal(ExperimentCondition.FAILED, message=msg)
                )

            # livelock guard (the sync loop's 30s stall cap): nothing in
            # flight, nothing queued, suggester idle and answering nothing
            if (
                undone == 0
                and queued == 0
                and not self._exhausted.is_set()
                and not self._suggester_busy
                and not self._suggest_inflight
            ):
                if get_clock().monotonic() - self._last_activity > _STALL_SECONDS:
                    return self._finalize(
                        lambda: self._terminal(
                            ExperimentCondition.FAILED,
                            message=(
                                "orchestrator stalled: suggester proposes "
                                "nothing with no trials in flight"
                            ),
                        )
                    )
            else:
                self._last_activity = max(self._last_activity, get_clock().monotonic() - 1.0)
            self._beat("harvest")
            get_clock().sleep(orch.poll_interval)
        return None

    # -- speculative straggler re-dispatch -----------------------------------

    def _note_settled_futures(self) -> None:
        """Record settle durations (dispatch -> harvested) for the straggler
        median; a future gone from the shared dict was settled/cancelled."""
        now = get_clock().monotonic()
        with self._futures_lock:
            gone = [f for f in self._fut_meta if f not in self.futures]
            for f in gone:
                self._settle_durations.append(now - self._fut_meta.pop(f))

    def _maybe_speculate(self) -> None:
        """Re-dispatch stragglers as singleton rivals on free slots.  Needs
        >= 3 settled durations for a meaningful median; one rival per trial
        per run; rivals only use slack under ``member_limit`` so speculation
        never delays first-run work."""
        # LCK001 fix: _note_settled_futures appends on this thread, but a
        # restarted-over stale harvest generation can still be unwinding —
        # snapshot under the lock before taking the median
        with self._futures_lock:
            durations = list(self._settle_durations)
        if len(durations) < 3:
            return
        threshold = self.spec.straggler_factor * statistics.median(durations)
        now = get_clock().monotonic()
        candidates: list[tuple[object, Trial]] = []
        with self._futures_lock:
            free = self.member_limit - self._undone_members() - len(
                [f for f in self._rivals if not f.done()]
            )
            if free <= 0:
                return
            for f, owner in self.futures.items():
                if f.done():
                    continue
                t0 = self._fut_meta.get(f)
                if t0 is None or now - t0 < threshold:
                    continue
                for t in owner if isinstance(owner, list) else [owner]:
                    if t.name not in self._speculated:
                        candidates.append((f, t))
        for f, t in candidates[: max(0, free)]:
            self._dispatch_rival(f, t)

    def _dispatch_rival(self, orig_fut, trial: Trial) -> None:
        """Submit a speculative singleton rival for ``trial``.  The rival
        executes a CLONE (separate object, suffixed checkpoint dir) so the
        straggling attempt and the rival never write the same Trial or the
        same checkpoint files; metrics land under the same trial name, so
        adoption needs no metric surgery."""
        clone = copy.deepcopy(trial)
        if clone.checkpoint_dir:
            clone.checkpoint_dir = clone.checkpoint_dir + "-speculative"
        clone.condition = TrialCondition.RUNNING
        clone.message = ""
        fut = get_clock().submit(self.pool, self.orch._execute, self.exp, clone, self.mesh)
        with self._futures_lock:
            # LCK001 fix: _maybe_speculate filters candidates against
            # _speculated under this lock; the add used to race it bare
            self._speculated.add(trial.name)
            self._rivals[fut] = (orig_fut, trial.name, clone)
        obs.speculative_dispatches.inc()
        self._last_activity = get_clock().monotonic()

    def _check_speculations(self) -> None:
        """First-settle-wins arbitration.  A rival that finishes with a
        usable result while the original is still unsettled is ADOPTED: the
        clone becomes ``exp.trials[name]`` and its future joins the shared
        dict, so the very next ``_harvest`` settles it through the normal
        exactly-once path; the original future is evicted, and its eventual
        result hits the stale-owner guard.  A rival that loses the race or
        fails is discarded — speculation can never fail a trial that might
        still succeed."""
        # LCK001 fix: the empty-check early-return used to peek at _rivals
        # bare; fold it into the lock (uncontended acquire, same fast path)
        with self._futures_lock:
            if not self._rivals:
                return
            done = [f for f in self._rivals if f.done()]
        for f in done:
            with self._futures_lock:
                orig_fut, name, clone = self._rivals.pop(f)
            try:
                result = f.result()  # _execute never raises
            except Exception:
                continue
            live = self.exp.trials.get(name)
            if live is None or live.condition.is_terminal():
                continue  # the original settled first; rival discarded
            if result.condition not in (
                TrialCondition.SUCCEEDED,
                TrialCondition.EARLY_STOPPED,
            ):
                continue
            with self._state_lock, self._futures_lock:
                self.futures.pop(orig_fut, None)
                self._fut_meta.pop(orig_fut, None)
                self.futures[f] = clone
                self._fut_meta.setdefault(f, get_clock().monotonic())
                self.exp.trials[name] = clone
            self._spec_wins += 1
            obs.speculative_wins.inc()

    def _cancel_rivals(self) -> None:
        with self._futures_lock:
            rivals = list(self._rivals)
            self._rivals.clear()
        for f in rivals:
            f.cancel()

    # -- wind-down -----------------------------------------------------------

    def _queued_count(self) -> int:
        with self._queue_lock:
            return self._queued_count_locked()

    def _queued_count_locked(self) -> int:  # lint: holds(_queue_lock)
        return (
            len(self._ready)
            + sum(len(b) for b in self._packing.values())
            + sum(len(u) for u in self._dispatchq)
        )

    def _bank_deficit(self) -> int:
        """How many proposals the bank is short of ``lookahead``, with the
        one-step consumption estimate folded in — read atomically under the
        queue lock (the counters move with the queues they describe)."""
        with self._queue_lock:
            return (
                self.lookahead
                - self._queued_count_locked()
                + self._consumed_last_call
            )

    def _update_pending_gauge(self) -> None:
        # straggler-reset fix: run()'s finally zeroes this gauge after the
        # halt flag is raised; a loop thread still unwinding through here
        # must not republish a nonzero count after that reset
        if self._halt.is_set():
            return
        obs.pending_proposals.set(float(self._queued_count()))

    def _drain_queues(self) -> list[Trial]:
        with self._queue_lock:
            leftovers = list(self._ready)
            self._ready.clear()
            for bucket in self._packing.values():
                leftovers.extend(bucket)
            self._packing.clear()
            self._pack_ts.clear()
            for unit in self._dispatchq:
                leftovers.extend(unit)
            self._dispatchq.clear()
        return leftovers

    def _stop_loops(self) -> None:
        """Halt the loop threads and JOIN the current-generation ones before
        the caller touches the queues or cancels futures — without the join,
        a dispatch racing the wind-down could submit a unit after
        ``_cancel_pending`` already ran.  Stale (restarted-over) threads are
        already fenced out of shared state and left to die as daemons."""
        self._halt.set()
        sup = self._supervisor
        threads = sup.threads() if sup is not None else []
        for t in threads:
            if t is not threading.current_thread():
                get_clock().join_thread(t, timeout=_JOIN_TIMEOUT)

    def _terminal(
        self, verdict: ExperimentCondition, message: str | None = None
    ) -> Experiment:
        orch, exp = self.orch, self.exp
        self._stop_loops()
        self._cancel_rivals()
        self.stop_event.set()
        with self._futures_lock:
            orch._cancel_pending(self.futures)
        with self._state_lock, self._futures_lock:
            orch._harvest(exp, self.futures, wait_running=True)
        # proposed-but-undispatched trials mirror the sync loop's
        # cancelled-future semantics: settled KILLED, budget consumed
        now = get_clock().time()
        for t in self._drain_queues():
            t.condition = TrialCondition.KILLED
            t.message = "cancelled: experiment terminal before dispatch"
            t.completion_time = now
            if not t.start_time:
                t.start_time = now
            obs.trials_killed.inc()
            orch._jappend("settled", exp, trial=t)
            orch._observe_trial_duration(t)
        exp.condition = verdict
        exp.message = message if message is not None else orch._terminal_message(verdict)
        exp.completion_time = get_clock().time()
        exp.update_optimal()
        self._record_stats()
        orch._finish(exp)
        return exp

    def _drain(self) -> Experiment:
        orch, exp = self.orch, self.exp
        self._stop_loops()
        self._cancel_rivals()
        # undispatched trials never started: back to PENDING so the resumed
        # run re-seeds them into its ready queue (no budget slot consumed)
        for t in self._drain_queues():
            t.condition = TrialCondition.PENDING
            t.message = "drained before start; resubmitted on resume"
            orch._jappend("drained", exp, trial=t)
        self._record_stats()
        return orch._drain_and_exit(
            exp,
            self.futures,  # lint: unguarded-ok(wind-down: loops joined by _stop_loops, single-threaded from here)
            self.suggester,
            self.stop_event,
            self.drain_event,
        )

    def _record_stats(self) -> None:
        """Publish the run's sustained-occupancy + supervision summary for
        bench/CI/chaos assertions."""
        exp = self.exp
        sup = self._supervisor
        elapsed = self.meter.elapsed()
        settled = sum(1 for t in exp.trials.values() if t.condition.is_terminal())
        self.orch.async_stats = {
            "sustained_occupancy": round(self.meter.sustained(), 4),
            "elapsed_s": round(elapsed, 4),
            "trials_settled": settled,
            "trials_per_sec": round(settled / elapsed, 4) if elapsed > 0 else 0.0,
            "lookahead": self.lookahead,
            "width": self.width,
            "member_limit": self.member_limit,
            "loop_restarts": sup.restart_counts() if sup is not None else {},
            "fallback": self._fallback_reason,
            "speculative_dispatches": len(self._speculated),  # lint: unguarded-ok(wind-down: _record_stats runs after _stop_loops joined the loops)
            "speculative_wins": self._spec_wins,
        }
        obs.mesh_occupancy.set(0.0)
