"""Experiment orchestrator — the in-process replacement for the reference's
controller triad (experiment/suggestion/trial reconcilers,
``pkg/controller.v1beta1/``).

Where the reference coordinates through CR status updates bounced off the
API server, this is a single event loop owning the whole experiment:

- budget math: ``parallel_trial_count`` in flight, stop at
  ``max_trial_count``, fail the experiment past ``max_failed_trial_count``
  (reference ``experiment_controller.go:274-330`` ReconcileTrials);
- suggestion sync: ask the suggester for exactly the shortfall
  (reference ``suggestionclient.go:83-96`` requests - suggestionCount);
- trial naming ``<experiment>-<rand8>`` unless the suggester names the trial
  (PBT uids) — reference ``suggestionclient.go:171-192``;
- early-stopping rules attached to each trial before launch (reference
  ``suggestionclient.go:130-189``);
- optimal-trial tracking and goal short-circuit
  (reference ``experiment/util/status_util.go``);
- trials run on a thread pool; PyTorch releases the GIL during device work
  so parallel trials on one host overlap host-side work with GPU steps.

Port of ``katib_tpu/orchestrator/orchestrator.py``: the async engine
(``orchestrator/async_loops.py`` under ``orchestrator/supervisor.py``),
which runs every experiment unless ``asyncOrch: false`` or
``KATIB_ASYNC_ORCH=0`` selects the synchronous loop, and the synchronous
loop, settlement, drain, retries, the journal and the cleanup.  Trials run
on ``device`` (``cuda`` unless the caller names the CPU).  What the port
does not have yet raises ``NotImplementedError`` when a run asks for it
(:meth:`Orchestrator._refuse_unported`): a mesh, cohorts, a declared
prewarm twin, the compile cache and artifact directory, a slice allocator
and the profiler.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import secrets
import shutil
import threading
import traceback

from katib_tpu_torch.core.types import (
    Experiment,
    ExperimentCondition,
    ExperimentSpec,
    ResumePolicy,
    Trial,
    TrialCondition,
    TrialSpec,
)
from katib_tpu_torch.core.validation import validate_experiment
from katib_tpu_torch.device import resolve_device
from katib_tpu_torch.earlystop.rules import make_early_stopper
from katib_tpu_torch.runner.cohort import cohort_fn_of
from katib_tpu_torch.runner.trial_runner import (
    TrialResult,
    init_compile_cache,
    run_trial,
)
from katib_tpu_torch.store.base import MemoryObservationStore, ObservationStore
from katib_tpu_torch.suggest.base import call_suggester, make_suggester
from katib_tpu_torch.utils import faults
from katib_tpu_torch.utils import observability as obs
from katib_tpu_torch.utils.clock import get_clock
from katib_tpu_torch.utils import tracing
from katib_tpu_torch.utils.watchdog import Watchdog

#: process exit code `katib-tpu run` returns after a graceful drain —
#: EX_TEMPFAIL (75), already in faults.RETRYABLE_EXIT_CODES, so a supervisor
#: (or a katib-tpu black-box parent!) reads it as "re-run me with --resume"
DRAIN_EXIT_CODE = 75

#: the attribute by which a train_fn declares its prewarm twin
#: (``katib_tpu/compile/prewarm.py``; the cohort twin's is in ``runner/cohort.py``)
PREWARM_ATTR = "__prewarm_fn__"


class Orchestrator:
    def __init__(
        self,
        store: ObservationStore | None = None,
        workdir: str = "katib_runs",
        mesh=None,
        poll_interval: float = 0.02,
        config=None,
        slice_allocator=None,
        fault_injector: faults.FaultInjector | None = None,
        preflight: bool | None = None,
        run_trial_fn=None,
        token_hex=None,
        journal_snapshot_every: int | None = None,
        status_publish_interval: float = 0.0,
        suggester_fn=None,
        device=None,
    ):
        # every trial of this orchestrator runs here: cuda unless the caller
        # names the CPU, and asking for cuda without a GPU raises now
        self.device = resolve_device(device)
        self.store = store if store is not None else MemoryObservationStore()
        # a defaulted store may be upgraded to the durable sqlite backend at
        # run() time for resumable experiments; an explicit store never is
        self._store_defaulted = store is None
        self.workdir = workdir
        self.mesh = mesh
        # SliceAllocator (parallel/distributed.py): concurrent trials lease
        # disjoint sub-meshes of the machine instead of sharing one mesh —
        # the chip-level analog of parallelTrialCount pod scheduling
        self.slice_allocator = slice_allocator
        self.poll_interval = poll_interval
        # KatibConfig (core/config.py): runtime registry of per-algorithm
        # defaults + profiler flags, merged into specs at run() time — the
        # analog of the reference resolving KatibConfig at reconcile time
        # (``katibconfig/config.go:60``)
        self.config = config
        # deterministic chaos harness (utils.faults.FaultInjector): threaded
        # through the suggester call and every trial attempt so tests and
        # `katib-tpu chaos` exercise the recovery paths on demand
        self.fault_injector = fault_injector
        # device preflight gate (utils.meshhealth): probe every visible
        # device under a deadline before opening the trial pool, so a wedged
        # accelerator pool fails the experiment fast with a per-device
        # health report instead of hanging in the first compile.  Explicit
        # argument wins; else opt-in via KATIB_PREFLIGHT=1 (the CLI `run`
        # verb enables it by default, library embedding stays opt-in).
        if preflight is None:
            preflight = os.environ.get("KATIB_PREFLIGHT") == "1"
        self.preflight = bool(preflight)
        # per-run crash-consistent event journal (orchestrator/journal.py);
        # opened by run(), closed in its finally
        self._journal = None
        # external stop request (client delete / shutdown): sticky so a stop
        # issued before run() enters its loop is not lost; each run() has its
        # own wind-down event for in-flight trials
        self._stop_requested = threading.Event()
        self._stop_event = threading.Event()
        # graceful-drain request (preemption SIGTERM/SIGINT on the CLI):
        # sticky like stop; the per-run _drain_event asks in-flight trials to
        # checkpoint-and-exit at their next step boundary
        self._drain_requested = threading.Event()
        self._drain_event = threading.Event()
        #: True after run() returned via a drain — the CLI maps this to
        #: DRAIN_EXIT_CODE so supervisors re-launch with --resume
        self.drained = False
        #: set by the CLI only: after the grace window, stragglers that
        #: cannot be joined must not block process exit — journal, then
        #: os._exit(DRAIN_EXIT_CODE).  Library callers keep the default
        #: (False): cooperative stragglers are joined on pool shutdown.
        self.drain_hard_exit = False
        # hang watchdog shared by every trial of a run (monitor thread
        # starts lazily on the first progress_deadline_seconds trial)
        self._watchdog: Watchdog | None = None
        # trials whose checkpoint dir belongs to the suggester (PBT lineage)
        # — exempt from retain-cleanup
        self._suggester_owned_ckpts: set[str] = set()
        # per-experiment span tracer (utils.tracing); opened in run(), closed
        # by _finish(); trial pool threads pick it up via self._tracer
        self._tracer: tracing.Tracer | None = None
        self._prev_tracer: tracing.Tracer | None = None
        self._exp_span_start = 0.0
        # Dispatch seam: a modeled executor may replace the real runner
        # while every scheduling/settlement path stays real.
        self._run_trial_fn = run_trial_fn
        # Trial-name entropy seam: secrets.token_hex in production, a seeded
        # stream under the simulator so journals are byte-reproducible.
        self._token_hex = token_hex if token_hex is not None else secrets.token_hex
        # Journal compaction cadence override (None = journal default).  At
        # 50k simulated trials the default every-32-settlements snapshot is
        # O(N^2/32) serialization work.
        self._journal_snapshot_every = journal_snapshot_every
        # Suggester construction seam (None = make_suggester): the simulator
        # wraps the real suggester with a modeled latency distribution.
        self._suggester_fn = suggester_fn
        # status.json republish throttle in clock seconds (0 = every call).
        # Each write serializes EVERY trial; at scale that dominates.
        self._status_publish_interval = float(status_publish_interval)
        self._status_published_at: float | None = None
        #: sustained-occupancy / throughput summary of the most recent async
        #: run (orchestrator/async_loops.py); None under the sync path
        self.async_stats: dict | None = None

    def stop(self) -> None:
        """Request the experiment wind down (the reference's experiment
        deletion path, ``experiment_controller.go:362-403``).  Sticky: a
        stopped orchestrator will not run further experiments."""
        self._stop_requested.set()
        self._stop_event.set()

    def drain(self) -> None:
        """Request a graceful drain (preemption semantics): stop proposing,
        ask running trials/cohorts to checkpoint-and-exit at their next step
        boundary, flush journal + suggester state, and return with the
        experiment still non-terminal so ``--resume`` continues it.  Bounded
        by ``ExperimentSpec.drain_grace_seconds``; see :data:`DRAIN_EXIT_CODE`.
        A second signal should call :meth:`stop` instead (abandon drain)."""
        self._drain_requested.set()
        self._drain_event.set()
        obs.drain_requested.set(1)

    # -- public API ---------------------------------------------------------

    def load_experiment(self, spec: ExperimentSpec) -> Experiment | None:
        """Reconstruct a previously journaled experiment from the workdir
        (``status.json``), or None when no journal exists.  Pass the result
        to :meth:`run` to resume across a process restart (the reference
        resurrects experiments from CR state + the suggestion PVC,
        ``suggestion_controller.go:181-193``)."""
        from katib_tpu_torch.orchestrator.resume import load_experiment

        return load_experiment(spec, self.workdir)

    def run(
        self,
        spec: ExperimentSpec,
        experiment: Experiment | None = None,
        resume: bool = False,
    ) -> Experiment:
        """Run an experiment to a terminal condition; returns it with full
        trial history and optimal-trial status.  Pass an existing
        ``experiment`` — or ``resume=True`` to load one from the status
        journal — to resume (``ResumePolicy`` semantics: a completed
        experiment re-opens when ``max_trial_count`` was raised, reference
        ``experiment_controller.go:187-206``)."""
        if self.config is not None:
            spec = self.config.apply_to(spec)
        validate_experiment(spec)
        self._refuse_unported(spec)
        if resume and experiment is None:
            experiment = self.load_experiment(spec)
        exp = experiment or Experiment(spec=spec)
        if experiment is not None:
            exp.spec = spec
            if exp.condition.is_terminal():
                if spec.resume_policy is ResumePolicy.NEVER:
                    raise RuntimeError(
                        f"experiment {exp.name} is terminal and resume_policy=Never"
                    )
                exp.condition = ExperimentCondition.RESTARTING
                exp.completion_time = 0.0

        suggester = (self._suggester_fn(spec) if self._suggester_fn is not None
                     else make_suggester(spec, device=self.device))
        # restore durable suggester state (ENAS controller pytree, PBT job
        # queue) — the FromVolume PVC analog, FENCED against the experiment
        # journal: a pickle written before settlements the journal proves
        # (hard kill between a settle and the next persist) is stale and is
        # discarded — the replay-derived fresh suggester rebuilds from trial
        # history instead of trusting it blindly.  Never-policy experiments
        # keep no state on disk, matching the reference tearing the service
        # down with nothing to resurrect from.
        if experiment is not None and spec.resume_policy is not ResumePolicy.NEVER:
            from katib_tpu_torch.orchestrator import journal as _journal_mod
            from katib_tpu_torch.orchestrator.resume import load_suggester_state

            load_suggester_state(
                suggester,
                self.workdir,
                exp.name,
                settled_fence=_journal_mod.last_settled_seq(self.workdir, exp.name),
            )
        # Durable-by-default observations: a defaulted in-memory store is
        # upgraded to the sqlite WAL backend for EVERY run, so a hard kill
        # never loses reported series (the reference's observations live in
        # the DB-manager's SQL table and survive controller restarts for
        # free — ``mysql/init.go:35``) and early stopping reads TRUE
        # per-trial series across restarts instead of _backfill_store's
        # one-point approximation.  An explicitly passed store is never
        # touched.
        if self._store_defaulted:
            from katib_tpu_torch.store.sqlite import SqliteObservationStore

            os.makedirs(self.workdir, exist_ok=True)
            self.store = SqliteObservationStore(
                os.path.join(self.workdir, "observations.sqlite")
            )
            self._store_defaulted = False  # keep it for later runs too
        # crash-consistent event journal (orchestrator/journal.py): the
        # durable source of truth for resume; status.json stays the derived
        # CLI/UI view.  Best-effort open — an unwritable workdir degrades to
        # the pre-journal behavior rather than failing the experiment.
        try:
            from katib_tpu_torch.orchestrator.journal import ExperimentJournal

            if self._journal_snapshot_every is not None:
                self._journal = ExperimentJournal(
                    self.workdir, exp.name,
                    snapshot_every=self._journal_snapshot_every,
                )
            else:
                self._journal = ExperimentJournal(self.workdir, exp.name)
        except OSError:
            self._journal = None
        if experiment is not None:
            self._backfill_store(exp)
        early_stopper = make_early_stopper(spec)
        if early_stopper is not None and hasattr(early_stopper, "bind_store"):
            early_stopper.bind_store(self.store)

        exp.condition = ExperimentCondition.RUNNING
        self._jappend(
            "experiment",
            exp,
            extra={"name": exp.name, "algorithm": spec.algorithm.name},
        )
        obs.experiments_created.inc(algorithm=spec.algorithm.name)
        obs.experiments_current.inc()
        # open the span journal (append-mode: a resumed experiment continues
        # from the prior max elapsed offset); tracing is best-effort — an
        # unwritable workdir must not fail the experiment, and KATIB_TRACE=0
        # suppresses it entirely
        try:
            self._tracer = (
                tracing.Tracer(
                    tracing.trace_path(self.workdir, exp.name),
                    experiment=exp.name,
                )
                if tracing.enabled()
                else None
            )
        except OSError:
            self._tracer = None
        self._exp_span_start = self._tracer.elapsed() if self._tracer else 0.0
        self._prev_tracer = tracing.activate(self._tracer)
        self._publish(exp)
        exhausted = False
        stalled_polls = 0
        # suggester fault isolation: absorb up to suggester_max_errors - 1
        # CONSECUTIVE get_suggestions exceptions (counted + cooled down with
        # backoff) while in-flight trials keep running; the Nth trips the
        # breaker and fails the experiment with the last traceback
        breaker = faults.CircuitBreaker(threshold=spec.suggester_max_errors)
        # value is the submitted unit: one Trial, or the member list of a
        # vectorized cohort (runner/cohort.py) sharing a single future
        futures: dict[cf.Future, Trial | list[Trial]] = {}
        # per-run wind-down signal for in-flight trials, set on a terminal
        # verdict or an external stop() (the reference deletes running trial
        # jobs, experiment_controller.go:362).  A fresh run() (resume) gets a
        # fresh event; the sticky _stop_requested flag survives so a stop()
        # racing run() startup is never lost.
        stop_event = threading.Event()
        self._stop_event = stop_event
        if self._stop_requested.is_set():
            stop_event.set()
        # fresh per-run drain event (a resumed run must not inherit the
        # previous process's drain); the sticky request flag is honored on
        # the first loop iteration
        drain_event = threading.Event()
        self._drain_event = drain_event
        if self._drain_requested.is_set():
            drain_event.set()
        self.drained = False
        obs.drain_requested.set(1.0 if self._drain_requested.is_set() else 0.0)
        self._watchdog = Watchdog()

        # a bad mesh config must still settle the experiments_current gauge
        # and the status journal before surfacing
        try:
            mesh = self._resolve_mesh(spec)
        except Exception:
            exp.condition = ExperimentCondition.FAILED
            exp.message = "mesh config error:\n" + traceback.format_exc(limit=5)
            exp.completion_time = get_clock().time()
            exp.update_optimal()
            self._finish(exp)
            raise

        # device preflight gate: a wedged pool fails the experiment FAST
        # (terminal + journaled machine-readable report) instead of hanging
        # in the first trial's compile.  Runs after tracer activation so the
        # "preflight" span lands in the trace journal.
        if self.preflight:
            from katib_tpu_torch.utils import meshhealth

            report = meshhealth.preflight(
                injector=self.fault_injector, device_type=self.device.type
            )
            if not report.ok():
                exp.condition = ExperimentCondition.FAILED
                exp.message = "device preflight failed: " + report.summary()
                exp.completion_time = get_clock().time()
                exp.update_optimal()
                self._finish(exp)
                raise RuntimeError(exp.message)

        # the async engine (orchestrator/async_loops.py): default ON;
        # spec.async_orch wins, else the KATIB_ASYNC_ORCH env var — "0" is
        # the escape hatch back to the synchronous loop
        self.async_stats = None
        use_async = (
            spec.async_orch
            if spec.async_orch is not None
            else os.environ.get("KATIB_ASYNC_ORCH", "1") != "0"
        )

        with cf.ThreadPoolExecutor(
            max_workers=spec.parallel_trial_count, thread_name_prefix=f"trial-{exp.name}"
        ) as pool:
          try:
            # trials orphaned by a process restart (journaled non-terminal →
            # PENDING): same name/assignments/checkpoint dir, so a
            # checkpoint-aware train_fn resumes mid-trial — the analog of
            # trial jobs surviving a controller restart in the reference.
            # The sync loop resubmits them directly; the async engine seeds
            # them into its ready queue so they flow through cohort packing
            # and occupancy backpressure like any other proposal.
            orphans: list[Trial] = []
            for trial in exp.trials.values():
                if trial.condition in (TrialCondition.PENDING, TrialCondition.CREATED):
                    if early_stopper is not None and not trial.spec.early_stopping_rules:
                        trial.spec.early_stopping_rules = early_stopper.get_rules(exp)
                    if hasattr(suggester, "checkpoint_dir_for"):
                        self._suggester_owned_ckpts.add(trial.name)
                    if use_async:
                        trial.condition = TrialCondition.PENDING
                        orphans.append(trial)
                        continue
                    trial.condition = TrialCondition.RUNNING
                    trial.start_time = get_clock().time()
                    self._jappend("started", exp, trial=trial)
                    futures[get_clock().submit(pool, self._execute, exp, trial, mesh)] = trial
            if use_async:
                from katib_tpu_torch.orchestrator.async_loops import AsyncLoops

                engine = AsyncLoops(
                    self,
                    exp,
                    suggester,
                    early_stopper,
                    mesh,
                    pool,
                    breaker,
                    stop_event,
                    drain_event,
                    futures,
                    initial_ready=orphans,
                )
                result = engine.run()
                if result is not None:
                    return result
                # supervisor exhausted its loop-restart budget: degrade to
                # this synchronous loop instead of dying.  In-flight futures
                # stay live in the shared dict and are harvested below; the
                # engine already journaled the fallback and put queued
                # proposals back to PENDING — resubmit them here like
                # restart orphans.
                exhausted = engine._exhausted.is_set()
                inflight: set[str] = set()
                for owner in futures.values():
                    for t in owner if isinstance(owner, list) else [owner]:
                        inflight.add(t.name)
                resubmit = [
                    t
                    for t in exp.trials.values()
                    if t.condition
                    in (TrialCondition.PENDING, TrialCondition.CREATED)
                    and t.name not in inflight
                ]
                for trial in resubmit:
                    trial.condition = TrialCondition.RUNNING
                    trial.start_time = get_clock().time()
                    futures[get_clock().submit(pool, self._execute, exp, trial, mesh)] = trial
                self._jappend_group("started", exp, resubmit)
            while True:
                self._harvest(exp, futures)
                if self._stop_requested.is_set():
                    stop_event.set()
                if stop_event.is_set():
                    # external stop: cancel queued work, wait out running
                    # trials (they observe the event via their context)
                    self._cancel_pending(futures)
                    self._harvest(exp, futures, wait_running=True)
                    exp.condition = ExperimentCondition.FAILED
                    exp.message = "experiment stopped"
                    exp.completion_time = get_clock().time()
                    exp.update_optimal()
                    self._finish(exp)
                    return exp
                if self._drain_requested.is_set():
                    # preemption drain: checkpoint-and-exit within the grace
                    # window, journal everything, return NON-terminal so the
                    # next process resumes from the checkpointed steps
                    return self._drain_and_exit(
                        exp, futures, suggester, stop_event, drain_event
                    )
                verdict = self._check_terminal(exp, exhausted, futures)
                if verdict is not None:
                    stop_event.set()
                    self._cancel_pending(futures)
                    self._harvest(exp, futures, wait_running=True)
                    exp.condition = verdict
                    exp.completion_time = get_clock().time()
                    exp.update_optimal()
                    exp.message = self._terminal_message(verdict)
                    self._finish(exp)
                    return exp

                want = self._shortfall(exp, futures)
                proposals = []
                suggester_busy = False  # erroring or cooling down, not idle
                if want > 0 and not exhausted:
                    if not breaker.allow():
                        # bounded retry-with-backoff: skip the call while the
                        # breaker cools down, keep harvesting in-flight trials
                        suggester_busy = True
                    else:
                        sug_start = self._tracer.elapsed() if self._tracer else 0.0
                        t_sug = get_clock().perf_counter()
                        proposals, outcome = call_suggester(
                            suggester, exp, want, breaker, self.fault_injector
                        )
                        if outcome == "exhausted":
                            exhausted = True
                        elif outcome == "error":
                            suggester_busy = True
                            obs.suggester_errors.inc(algorithm=spec.algorithm.name)
                        sug_dur = get_clock().perf_counter() - t_sug
                        obs.suggestion_latency.observe(
                            sug_dur, algorithm=spec.algorithm.name
                        )
                        # don't journal the thousands of sub-ms not-ready polls a
                        # rung-gated suggester (Hyperband/ENAS) answers per trial
                        if self._tracer is not None and (
                            proposals
                            or outcome in ("exhausted", "error")
                            or sug_dur >= 1e-3
                        ):
                            self._tracer.record(
                                "suggest",
                                sug_start,
                                sug_dur,
                                algorithm=spec.algorithm.name,
                                count=len(proposals),
                                outcome=outcome,
                            )
                        for p in proposals:
                            trial = self._materialize(exp, p, early_stopper, suggester)
                            futures[
                                get_clock().submit(pool, self._execute, exp, trial, mesh)
                            ] = trial
                        if proposals:
                            self._persist_suggester(exp, suggester)
                            # journal the newly in-flight trials so a crash here
                            # leaves resubmittable orphans (and the UI sees them)
                            self._publish(exp)

                if breaker.tripped:
                    # N consecutive suggester failures: terminal.  Wind down
                    # in-flight trials, surface the last traceback.
                    stop_event.set()
                    self._cancel_pending(futures)
                    self._harvest(exp, futures, wait_running=True)
                    exp.condition = ExperimentCondition.FAILED
                    exp.message = (
                        f"suggester failed {breaker.failures} consecutive times "
                        f"(suggester_max_errors={spec.suggester_max_errors}); "
                        "last error:\n" + breaker.last_failure
                    )
                    exp.completion_time = get_clock().time()
                    exp.update_optimal()
                    self._finish(exp)
                    return exp

                # livelock guard: nothing running, nothing proposed, not
                # exhausted — a buggy suggester would spin here forever.  A
                # cooling/erroring suggester is the breaker's problem, not a
                # stall: its own threshold terminates the experiment.
                if not futures and not proposals and not exhausted and not suggester_busy:
                    stalled_polls += 1
                    if stalled_polls * self.poll_interval > 30.0:
                        exp.condition = ExperimentCondition.FAILED
                        exp.message = (
                            "orchestrator stalled: suggester proposes nothing "
                            "with no trials in flight"
                        )
                        exp.completion_time = get_clock().time()
                        exp.update_optimal()
                        self._finish(exp)
                        return exp
                else:
                    stalled_polls = 0
                get_clock().sleep(self.poll_interval)
          except Exception:
            # bookkeeping must not be skipped on an orchestrator/suggester
            # bug: wind down in-flight trials, record the failure, balance
            # the experiments_current gauge, then surface the bug
            stop_event.set()
            self._cancel_pending(futures)
            self._harvest(exp, futures, wait_running=True)
            exp.condition = ExperimentCondition.FAILED
            exp.message = "orchestrator error:\n" + traceback.format_exc(limit=20)
            exp.completion_time = get_clock().time()
            exp.update_optimal()
            self._finish(exp)
            raise
          finally:
            watchdog, self._watchdog = self._watchdog, None
            if watchdog is not None:
                watchdog.stop()
            # final durable-state write so a completed-then-reopened
            # experiment (raised max_trial_count) resumes the suggester too
            self._persist_suggester(exp, suggester)
            # suggester teardown (remote services evict their per-experiment
            # state — the analog of deleting the algorithm Deployment,
            # ``suggestion_controller.go:132-143``); best-effort
            closer = getattr(suggester, "close", None)
            if closer is not None:
                try:
                    closer(exp)
                except Exception:
                    pass
            journal, self._journal = self._journal, None
            if journal is not None:
                journal.close()

    # -- internals ----------------------------------------------------------

    def _journal_exp_state(self, exp: Experiment) -> dict:
        """The experiment-level slice every journal record carries so replay
        is state-identical to a status.json resume (trial dicts ride
        separately per record)."""
        return {
            "condition": exp.condition.value,
            "message": exp.message,
            "start_time": exp.start_time,
            "completion_time": exp.completion_time,
            "algorithm_settings": dict(exp.algorithm_settings),
            "optimal": (
                None
                if exp.optimal is None
                else {
                    "trial_name": exp.optimal.trial_name,
                    "objective_value": exp.optimal.objective_value,
                    "assignments": {
                        a.name: a.value for a in exp.optimal.assignments
                    },
                }
            ),
            "optimal_history": list(exp.optimal_history),
        }

    def _jappend(
        self,
        event: str,
        exp: Experiment,
        trial: Trial | None = None,
        extra: dict | None = None,
    ) -> None:
        """Durably journal one state transition; best-effort like _publish —
        a full disk must degrade resume fidelity, not kill the run loop.
        Thread-safe (the journal locks internally): retry records arrive
        from trial pool threads."""
        j = self._journal
        if j is None:
            return
        try:
            from katib_tpu_torch.orchestrator.status import trial_to_dict

            data: dict = {"exp": self._journal_exp_state(exp)}
            if trial is not None:
                data["trial"] = trial_to_dict(trial)
            if extra:
                data.update(extra)
            j.append(
                event,
                trial=trial.name if trial is not None else None,
                epoch=trial.retry_count if trial is not None else 0,
                data=data,
            )
        except (OSError, ValueError):
            pass

    def _jappend_group(
        self, event: str, exp: Experiment, trials: list[Trial]
    ) -> None:
        """Journal one state transition for a batch of trials with a single
        durability barrier (``Journal.append_group``) — the async engine's
        bulk hand-offs would otherwise pay one fsync per trial."""
        j = self._journal
        if j is None or not trials:
            return
        try:
            from katib_tpu_torch.orchestrator.status import trial_to_dict

            exp_state = self._journal_exp_state(exp)
            j.append_group(
                [
                    (
                        event,
                        t.name,
                        t.retry_count,
                        {"exp": exp_state, "trial": trial_to_dict(t)},
                    )
                    for t in trials
                ]
            )
        except (OSError, ValueError):
            pass

    def _materialize(
        self,
        exp: Experiment,
        proposal,
        early_stopper,
        suggester,
        condition: TrialCondition = TrialCondition.RUNNING,
        journal: bool = True,
    ) -> Trial:
        name = proposal.name or f"{exp.name}-{self._token_hex(4)}"
        rules = list(proposal.early_stopping_rules)
        if early_stopper is not None and not rules:
            rules = early_stopper.get_rules(exp)
        # PBT pre-populates lineage checkpoints in its own directory layout
        if hasattr(suggester, "checkpoint_dir_for"):
            ckpt = suggester.checkpoint_dir_for(name)
            self._suggester_owned_ckpts.add(name)
        else:
            ckpt = os.path.join(self.workdir, exp.name, name)
        trial = Trial(
            name=name,
            experiment_name=exp.name,
            spec=TrialSpec(
                assignments=list(proposal.assignments),
                early_stopping_rules=rules,
                labels=dict(proposal.labels),
                train_fn=exp.spec.train_fn,
                command=list(exp.spec.command) if exp.spec.command else None,
                metrics_collector=exp.spec.metrics_collector,
                retain=exp.spec.retain,
                max_runtime_seconds=exp.spec.max_trial_runtime_seconds,
                metrics_retries=exp.spec.metrics_retries,
                max_retries=exp.spec.max_retries,
                retry_backoff_seconds=exp.spec.retry_backoff_seconds,
                progress_deadline_seconds=exp.spec.progress_deadline_seconds,
                compile_deadline_seconds=exp.spec.compile_deadline_seconds,
            ),
            # async proposals wait in the ready queue as PENDING (started at
            # dispatch); the sync loop submits immediately as RUNNING
            condition=condition,
            start_time=get_clock().time() if condition is TrialCondition.RUNNING else 0.0,
            checkpoint_dir=ckpt,
        )
        exp.trials[name] = trial
        # journal=False lets the async engine batch a whole refill's
        # ``proposed`` records into one append_group durability barrier
        if journal:
            self._jappend("proposed", exp, trial=trial)
        obs.trials_created.inc()
        return trial

    def _refuse_unported(self, spec: ExperimentSpec) -> None:
        """Raise ``NotImplementedError`` for whatever the run asks of the
        JAX orchestrator that the port does not have yet, before anything
        is journaled: nothing is ignored."""
        init_compile_cache(spec.compile_cache)
        artifact_dir = os.environ.get("KATIB_ARTIFACT_DIR") or spec.artifact_dir
        if artifact_dir:
            raise NotImplementedError(
                f"artifact directory {artifact_dir!r} (spec artifactDir or "
                "KATIB_ARTIFACT_DIR): the port has no serialized-executable "
                "tier yet (katib_tpu/compile/artifacts.py)"
            )
        # the JAX orchestrator engages its prewarmer and its cohorts only for
        # a train_fn that declares the twin (``compile/prewarm.py``,
        # ``runner/cohort.py``); elsewhere both are no-ops, as here
        if spec.prewarm and getattr(spec.train_fn, PREWARM_ATTR, None) is not None:
            raise NotImplementedError(
                "spec prewarm with a train_fn that declares a prewarm twin asks "
                "for the background compile prewarmer "
                "(katib_tpu/compile/prewarm.py), not ported yet"
            )
        if spec.cohort_width > 1 and cohort_fn_of(spec.train_fn) is not None:
            raise NotImplementedError(
                f"cohortWidth={spec.cohort_width} with a train_fn that declares "
                "a cohort twin asks for vectorized cohorts "
                "(katib_tpu/runner/cohort.py), not ported yet"
            )
        if self.slice_allocator is not None:
            raise NotImplementedError(
                "a slice allocator (katib_tpu/parallel/distributed.py) needs "
                "multi-GPU meshes, not ported yet"
            )
        if self.config is not None and self.config.init.enable_profiler:
            raise NotImplementedError(
                "init.enable_profiler asks for per-trial profiles "
                "(katib_tpu/costmodel/profiler.py), not ported yet"
            )

    def _resolve_mesh(self, spec: ExperimentSpec):
        """Explicit mesh wins; otherwise the config registry decides.  The
        port runs each trial on one device, so any mesh raises."""
        if self.mesh is not None:
            raise NotImplementedError(
                "an orchestrator mesh (katib_tpu/parallel/mesh.py): the port "
                "runs each trial on one device"
            )
        if self.config is not None:
            self.config.mesh_axes_for(spec.algorithm.name)  # raises for axes
        return None

    #: implicit cohort key stamped when a trial-axis mesh is configured but
    #: neither the proposals nor the spec name one (read by the async
    #: engine's packing; the port has no trial-axis mesh yet)
    _TRIAL_MESH_KEY = "trial-mesh"

    def _submit_prewarm(self, spec: ExperimentSpec, trials: list[Trial], mesh) -> None:
        """Enqueue one group's compile signature on the prewarm worker.  The
        JAX worker compiles only for a train_fn that declares a prewarm
        twin, a run :meth:`_refuse_unported` refuses before the engine
        starts; for every other train_fn it does nothing, as here."""

    def _execute_cohort(self, exp: Experiment, trials: list[Trial], mesh):
        """A cohort on one pool thread: engaged only for a train_fn with a
        cohort twin and a width above one, a run that
        :meth:`_refuse_unported` refuses before the engine starts."""
        raise NotImplementedError(
            "vectorized cohorts (katib_tpu/runner/cohort.py) are not ported yet"
        )

    def _execute(self, exp: Experiment, trial: Trial, mesh):
        # invariant: never raises — _harvest calls f.result() bare.
        # Runs on a pool thread: adopt the experiment tracer as this thread's
        # ambient tracer so runner/NAS spans land in the same journal, and
        # bracket the whole attempt in a "trial" span.
        with tracing.use_tracer(self._tracer):
            with tracing.span("trial", trial=trial.name) as sp:
                result = self._execute_with_retry(exp, trial, mesh)
                sp.set(condition=result.condition.value)
                return result

    def _execute_with_retry(self, exp: Experiment, trial: Trial, mesh):
        """Bounded re-execution of one trial slot; both retry families share
        the exponential-backoff helper (jittered, capped at ~30s, responsive
        to ``stop_event`` so a requested stop is never delayed by a pending
        retry):

        - **transient failures** (``max_retries``): preemptions /
          RESOURCE_EXHAUSTED / retryable exit codes re-run under the same
          name and checkpoint dir so a checkpoint-aware ``train_fn`` resumes
          mid-trial; PERMANENT failures (ValueError/assertion/shape errors)
          classify immediately.  Each spent retry bumps ``trial.retry_count``
          and is journaled *before* the backoff sleep, so resume-after-crash
          continues with the budget already spent instead of resetting it.
        - **metrics-unavailable re-runs** (``metrics_retries``): the trial
          exited cleanly but never reported the objective — the analog of
          the reference requeueing metrics-not-reported trials after 1s
          (``trial_controller.go:182-185``).

        The trial stays non-terminal throughout, so it consumes exactly one
        ``max_trial_count`` slot regardless of attempts."""
        backoff = faults.Backoff(
            base=trial.spec.retry_backoff_seconds,
            cap=30.0,
            seed=f"{exp.name}:{trial.name}",
        )
        attempts = 1
        result = self._execute_on(exp, trial, mesh)
        while (
            result.condition is TrialCondition.FAILED
            and result.failure_kind is not None
            and result.failure_kind.retryable  # TRANSIENT and HANG re-run
            and trial.retry_count < trial.spec.max_retries
            and not self._stop_event.is_set()
            and not self._drain_event.is_set()  # draining: journal, don't re-run
        ):
            trial.retry_count += 1
            trial.failure_kind = result.failure_kind.value
            obs.trials_retried.inc(kind=result.failure_kind.value)
            # journal the spent retry before sleeping: a crash mid-backoff
            # must not reset the per-trial retry budget on resume.  The
            # crash point covers the window where the bump is memory-only.
            faults.crash_point("retry.budget")
            self._jappend("retried", exp, trial=trial)
            self._publish(exp)
            if not backoff.wait(trial.retry_count, self._stop_event):
                break
            attempts += 1
            result = self._execute_on(exp, trial, mesh)
        for i in range(trial.spec.metrics_retries):
            if result.condition is not TrialCondition.METRICS_UNAVAILABLE:
                break
            if self._drain_event.is_set():
                break
            if not backoff.wait(i + 1, self._stop_event):
                break
            attempts += 1
            result = self._execute_on(exp, trial, mesh)
        obs.trial_attempts.observe(float(attempts))
        return result

    def _execute_on(self, exp: Experiment, trial: Trial, mesh):
        return (self._run_trial_fn or run_trial)(
            trial,
            self.store,
            exp.spec.objective,
            mesh=mesh,
            stop_event=self._stop_event,
            injector=self.fault_injector,
            watchdog=self._watchdog,
            drain_event=self._drain_event,
            device=self.device,
        )

    def _finish(self, exp: Experiment) -> None:
        """Terminal bookkeeping: observability counters + final status write
        (reference ``prometheus_metrics.go`` experiment counters)."""
        obs.experiments_current.dec()
        if exp.condition is ExperimentCondition.FAILED:
            obs.experiments_failed.inc(algorithm=exp.spec.algorithm.name)
        else:
            obs.experiments_succeeded.inc(algorithm=exp.spec.algorithm.name)
        duration = (exp.completion_time or get_clock().time()) - exp.start_time
        obs.experiment_duration.observe(
            max(duration, 0.0),
            algorithm=exp.spec.algorithm.name,
            condition=exp.condition.value,
        )
        tracer, self._tracer = self._tracer, None
        if tracer is not None:
            tracer.record(
                "experiment",
                self._exp_span_start,
                tracer.elapsed() - self._exp_span_start,
                algorithm=exp.spec.algorithm.name,
                condition=exp.condition.value,
                trials=len(exp.trials),
            )
            tracing.deactivate(self._prev_tracer)
            tracer.close()
        # terminal record + final snapshot: a later resume replays one
        # snapshot instead of the whole event log
        self._jappend("experiment", exp)
        if self._journal is not None:
            try:
                from katib_tpu_torch.orchestrator.status import experiment_to_dict

                self._journal.snapshot(experiment_to_dict(exp))
            except (OSError, ValueError):
                pass
        self._publish(exp, force=True)

    def _drain_and_exit(
        self,
        exp: Experiment,
        futures: dict,
        suggester,
        stop_event: threading.Event,
        drain_event: threading.Event,
    ) -> Experiment:
        """Graceful preemption wind-down (the run loop's drain branch).

        Ordering is the whole point: (1) stop proposing and cancel queued
        futures, (2) raise the drain flag every running trial/cohort observes
        through its context, (3) wait out ``drain_grace_seconds`` harvesting
        trials that checkpoint-and-exit (settled ``Drained``), (4) journal
        stragglers as ``Drained`` anyway and set the stop event so their
        threads wind down, (5) flush suggester state + status.json, record
        the ``drain`` span, and return with the experiment NON-terminal —
        the resumed process re-submits every Drained/Pending trial under its
        original name and checkpoint dir.  With ``drain_hard_exit`` (the CLI)
        a wedged straggler cannot block process exit: journal first, then
        ``os._exit(DRAIN_EXIT_CODE)``."""
        spec = exp.spec
        grace = max(0.0, spec.drain_grace_seconds)
        obs.drain_requested.set(1.0)
        drain_start = self._tracer.elapsed() if self._tracer else 0.0
        t0 = get_clock().perf_counter()
        self._cancel_pending(futures)
        drain_event.set()
        if futures:
            get_clock().wait_futures(futures, timeout=grace)
        self._harvest(exp, futures, drain=True)
        checkpointed = sum(
            1 for t in exp.trials.values() if t.condition is TrialCondition.DRAINED
        )
        # stragglers: still running past the grace window — journal them
        # Drained (resume re-runs them from their last voluntary checkpoint)
        # and fire the stop event so their threads/subprocesses wind down
        stragglers: list[Trial] = []
        for f in list(futures):
            owner = futures.pop(f)
            members = owner if isinstance(owner, list) else [owner]
            for trial in members:
                trial.condition = TrialCondition.DRAINED
                trial.message = (
                    "preempted: no checkpoint boundary within "
                    f"drain_grace_seconds={grace:g}; resuming from last checkpoint"
                )
                stragglers.append(trial)
                self._jappend("drained", exp, trial=trial)
        stop_event.set()
        exp.update_optimal()
        self._persist_suggester(exp, suggester)
        exp.message = (
            f"drained after preemption signal ({checkpointed} trial(s) "
            f"checkpointed, {len(stragglers)} killed at the grace window); "
            "resumable with --resume"
        )
        self.drained = True
        self._jappend("experiment", exp)
        duration = get_clock().perf_counter() - t0
        obs.experiments_current.dec()
        tracer, self._tracer = self._tracer, None
        if tracer is not None:
            tracer.record(
                "drain",
                drain_start,
                duration,
                checkpointed=checkpointed,
                killed=len(stragglers),
                grace=grace,
            )
            tracer.record(
                "experiment",
                self._exp_span_start,
                tracer.elapsed() - self._exp_span_start,
                algorithm=spec.algorithm.name,
                condition="Drained",
                trials=len(exp.trials),
            )
            tracing.deactivate(self._prev_tracer)
            tracer.close()
        self._publish(exp)
        if stragglers and self.drain_hard_exit:
            # a wedged train_fn cannot be joined; everything durable is
            # flushed, so trade the stuck threads for a prompt resumable exit
            os._exit(DRAIN_EXIT_CODE)
        return exp

    @staticmethod
    def _observe_trial_duration(trial: Trial) -> None:
        obs.trial_duration.observe(
            max(trial.completion_time - trial.start_time, 0.0),
            condition=trial.condition.value,
        )

    _TRIAL_COUNTERS = {
        TrialCondition.SUCCEEDED: obs.trials_succeeded,
        TrialCondition.FAILED: obs.trials_failed,
        TrialCondition.EARLY_STOPPED: obs.trials_early_stopped,
        TrialCondition.KILLED: obs.trials_killed,
        TrialCondition.METRICS_UNAVAILABLE: obs.trials_metrics_unavailable,
    }

    def _backfill_store(self, exp: Experiment) -> None:
        """A restarted process starts with an empty in-memory observation
        store while the journal holds each trial's reduced observation; the
        median early stopper reads per-trial logs from the store
        (``earlystop/medianstop.py``), so seed completed trials' reduced
        metrics back as single points.  An approximation of the lost series
        (the reduced value stands in for the first ``start_step`` points) —
        durable store backends (sqlite/native) that still hold the real
        series are left untouched."""
        import math as _math

        for t in exp.trials.values():
            if t.observation is None or not t.condition.is_terminal():
                continue
            if self.store.get(t.name):
                continue
            for m in t.observation.metrics:
                if not _math.isnan(m.value):
                    self.store.report_point(t.name, m.name, m.value)

    def _persist_suggester(self, exp: Experiment, suggester) -> None:
        """Journal durable suggester state (ENAS pytree, PBT queue) for
        restart resume — the FromVolume PVC analog.  Never-policy
        experiments skip it; best-effort like the status journal."""
        if exp.spec.resume_policy is ResumePolicy.NEVER:
            return
        try:
            from katib_tpu_torch.orchestrator.resume import save_suggester_state

            save_suggester_state(
                suggester,
                self.workdir,
                exp.name,
                fence=self._journal.seq if self._journal is not None else None,
            )
        except Exception:
            # best-effort like the status journal: an unpicklable custom
            # state_dict (TypeError, not just PicklingError) must never mask
            # the experiment result from run()'s finally block
            pass

    def _publish(self, exp: Experiment, force: bool = False) -> None:
        """Journal status for CLI/UI views (``status.json`` per experiment);
        never lets a status-write failure kill the run loop.  Throttled by
        ``status_publish_interval`` (clock seconds) unless ``force``d —
        terminal states always publish."""
        if not force and self._status_publish_interval > 0.0:
            now = get_clock().monotonic()
            last = self._status_published_at
            if last is not None and now - last < self._status_publish_interval:
                return
            self._status_published_at = now
        try:
            from katib_tpu_torch.orchestrator.status import write_status

            write_status(exp, self.workdir)
        except OSError:
            pass

    def _harvest(
        self,
        exp: Experiment,
        futures: dict,
        wait_running: bool = False,
        drain: bool = False,
    ) -> None:
        done = [f for f in futures if f.done()]
        if wait_running and futures:
            done = list(get_clock().wait_futures(futures).done)
        for f in done:
            # A future owns either one trial (serial) or a list (cohort);
            # cohort futures resolve to a {name: TrialResult} dict.
            owner = futures.pop(f)
            members = owner if isinstance(owner, list) else [owner]
            if f.cancelled():
                for trial in members:
                    if drain:
                        # never started: back to PENDING so the resumed run
                        # submits it fresh (no budget slot consumed)
                        trial.condition = TrialCondition.PENDING
                        trial.message = "drained before start; resubmitted on resume"
                        self._jappend("drained", exp, trial=trial)
                        continue
                    trial.condition = TrialCondition.KILLED
                    trial.completion_time = get_clock().time()
                    obs.trials_killed.inc()
                    self._jappend("settled", exp, trial=trial)
                    self._observe_trial_duration(trial)
                continue
            try:
                result = f.result()  # _execute / _execute_cohort never raise
            except Exception as exc:
                # the contract above is defense-in-depth, not a certainty: a
                # pool-level failure for ONE future must settle its members
                # as failed (classified through FailureKind), never raise
                # out of the harvest loop and kill the whole experiment
                kind = faults.classify_exception(exc)
                result = TrialResult(
                    TrialCondition.FAILED,
                    f"settle failed: {exc!r}",
                    failure_kind=kind,
                )
            results = (
                result if isinstance(result, dict) else {members[0].name: result}
            )
            settled: list[Trial] = []
            for trial in members:
                live = exp.trials.get(trial.name)
                if (live is not None and live is not trial) or (
                    trial.condition.is_terminal()
                ):
                    # speculative first-settle-wins: a rival already settled
                    # this member (the winner's object owns exp.trials[name])
                    # — the loser's result is discarded, never re-journaled
                    continue
                try:
                    res = results.get(trial.name)
                    if res is None:  # defense: _execute_cohort backfills missing
                        res = TrialResult(
                            TrialCondition.FAILED,
                            "cohort returned no result for member",
                            failure_kind=faults.FailureKind.PERMANENT,
                        )
                    trial.condition = res.condition
                    trial.message = res.message
                    fk = getattr(res, "failure_kind", None)
                    if fk is not None:
                        trial.failure_kind = fk.value
                    elif not trial.retry_count:
                        # keep the last failure's classification on a recovered
                        # retry (journal answers "what did this trial survive?");
                        # clean first-attempt results clear any resumed leftover
                        trial.failure_kind = None
                    trial.completion_time = get_clock().time()
                    if trial.condition in (
                        TrialCondition.SUCCEEDED,
                        TrialCondition.EARLY_STOPPED,
                    ):
                        trial.observation = self.store.observation_for(
                            trial.name, exp.spec.objective
                        )
                        if trial.observation is None:
                            trial.condition = TrialCondition.METRICS_UNAVAILABLE
                    counter = self._TRIAL_COUNTERS.get(trial.condition)
                    if counter is not None:
                        counter.inc()
                    self._observe_trial_duration(trial)
                    self._cleanup_trial(trial)
                except Exception as exc:
                    # per-member isolation: a bad metrics read / cleanup for
                    # one member fails THAT member, classified, and the rest
                    # of the cohort still settles normally
                    kind = faults.classify_exception(exc)
                    trial.condition = TrialCondition.FAILED
                    trial.message = f"settle failed: {exc!r}"
                    trial.failure_kind = kind.value
                    if not trial.completion_time:
                        trial.completion_time = get_clock().time()
                    obs.trials_failed.inc()
                settled.append(trial)
            members = settled
            # incremental: fold only this settle batch into the optimal —
            # the full recompute per batch is quadratic at sweep scale
            exp.update_optimal(members)
            # durably journal each member's outcome: terminal conditions are
            # exactly-once settlements keyed by (trial, attempt epoch);
            # Drained stays non-terminal (resubmitted on resume).  The
            # "reported" record carries the reduced observation separately
            # so replay can restore metrics for trials the settle record of
            # which is ever lost to a torn tail.  The whole batch goes
            # through one append_group — record content and order are
            # identical to per-trial appends, but the batch pays a single
            # durability barrier instead of two per member.
            if self._journal is not None:
                try:
                    from katib_tpu_torch.orchestrator.status import (
                        _observation_to_dict,
                        trial_to_dict,
                    )

                    exp_state = self._journal_exp_state(exp)
                    records = []
                    for trial in members:
                        tdict = trial_to_dict(trial)
                        if trial.condition is TrialCondition.DRAINED:
                            records.append((
                                "drained",
                                trial.name,
                                trial.retry_count,
                                {"exp": exp_state, "trial": tdict},
                            ))
                            continue
                        if trial.observation is not None:
                            records.append((
                                "reported",
                                trial.name,
                                trial.retry_count,
                                {
                                    "exp": exp_state,
                                    "trial": tdict,
                                    "observation": _observation_to_dict(
                                        trial.observation
                                    ),
                                },
                            ))
                        records.append((
                            "settled",
                            trial.name,
                            trial.retry_count,
                            {"exp": exp_state, "trial": tdict},
                        ))
                    self._journal.append_group(records)
                except (OSError, ValueError):
                    pass
        if done:
            if self._journal is not None:
                try:
                    from katib_tpu_torch.orchestrator.status import experiment_to_dict

                    self._journal.maybe_compact(lambda: experiment_to_dict(exp))
                except (OSError, ValueError):
                    pass
            self._publish(exp)

    def _cleanup_trial(self, trial: Trial) -> None:
        """Honor ``retain`` (the reference deletes the trial job on
        completion unless retained, ``trial_controller.go:297-306``): prune
        the bulky step directories of an orchestrator-owned checkpoint
        dir, keeping small artifacts (genotype.json, profiles).  Suggester-
        owned dirs (PBT lineage) are never touched — exploit copies need
        parent weights after the parent completes."""
        if (
            trial.spec.retain
            or trial.checkpoint_dir is None
            or trial.name in self._suggester_owned_ckpts
            or trial.condition is not TrialCondition.SUCCEEDED
            # nothing was ever checkpointed — skip the per-step scan
            or not os.path.isdir(trial.checkpoint_dir)
        ):
            return
        from katib_tpu_torch.utils.checkpoint import (
            TrialCheckpointer,
            _manifest_path,
            _step_path,
        )

        try:
            ck = TrialCheckpointer(trial.checkpoint_dir, max_to_keep=0)
            for step in ck.all_steps():
                shutil.rmtree(_step_path(trial.checkpoint_dir, step), ignore_errors=True)
                try:
                    os.unlink(_manifest_path(trial.checkpoint_dir, step))
                except OSError:
                    pass
        except (OSError, ValueError):
            pass

    @staticmethod
    def _budget_used(exp: Experiment) -> int:
        """Terminal trials of every kind consume the budget — the reference
        counts succeeded + failed + killed + early-stopped as completed
        (``experiment_controller.go:280-281``)."""
        return sum(1 for t in exp.trials.values() if t.condition.is_terminal())

    def _shortfall(self, exp: Experiment, futures: dict) -> int:
        """Reference budget math (``experiment_controller.go:274-330``):
        keep ``parallel_trial_count`` active, never exceed ``max_trial_count``
        counting every terminal trial plus the ones in flight."""
        spec = exp.spec
        # Cohort futures carry multiple trials on one pool slot; the budget
        # counts members, not futures.
        active = sum(
            len(v) if isinstance(v, list) else 1 for v in futures.values()
        )
        slots = spec.parallel_trial_count - active
        if spec.max_trial_count is not None:
            slots = min(slots, spec.max_trial_count - self._budget_used(exp) - active)
        return max(0, slots)

    def _check_terminal(
        self, exp: Experiment, exhausted: bool, futures: dict
    ) -> ExperimentCondition | None:
        spec = exp.spec
        if (
            spec.max_failed_trial_count is not None
            and exp.failed_count > 0
            and exp.failed_count >= spec.max_failed_trial_count
        ):
            return ExperimentCondition.FAILED
        # exp.optimal is maintained incrementally by _harvest per settle
        # batch (trials terminal-ize nowhere else while the loops run); a
        # full update_optimal() here ran once per poll — quadratic at
        # sweep scale
        if exp.optimal is not None and spec.objective.is_goal_reached(
            exp.optimal.objective_value
        ):
            return ExperimentCondition.GOAL_REACHED
        if (
            spec.max_trial_count is not None
            # terminal trials <= all trials: the O(1) guard keeps the O(n)
            # budget scan off the poll loop until the budget can actually
            # be reached (the final lookahead window)
            and len(exp.trials) >= spec.max_trial_count
            and self._budget_used(exp) >= spec.max_trial_count
        ):
            return ExperimentCondition.MAX_TRIALS_REACHED
        if exhausted and not futures:
            return ExperimentCondition.SUCCEEDED
        return None

    @staticmethod
    def _terminal_message(cond: ExperimentCondition) -> str:
        return {
            ExperimentCondition.GOAL_REACHED: "objective goal reached",
            ExperimentCondition.MAX_TRIALS_REACHED: "max trial count reached",
            ExperimentCondition.FAILED: "max failed trial count exceeded",
            ExperimentCondition.SUCCEEDED: "search space exhausted",
        }.get(cond, "")

    @staticmethod
    def _cancel_pending(futures: dict) -> None:
        for f in futures:
            f.cancel()
