"""Failure classification, retry backoff, circuit breaking, and deterministic
fault injection — the fault-tolerance vocabulary shared by the orchestrator
and the trial runner.

The reference treats trial failure as a controller-level concern: the trial
controller requeues metrics-less trials (``trial_controller.go:182-185``) and
the experiment controller counts failures against ``maxFailedTrialCount``
(``experiment_controller.go:274-330``), but a pod OOM-kill and a shape bug
both land in the same ``Failed`` bucket.  On TPUs that conflation is
expensive: preemptions and ``RESOURCE_EXHAUSTED`` are *normal* events on
long sweeps (Podracer-style architectures treat worker preemption as
routine), while a ``ValueError`` from a bad hyperparameter will fail
identically on every re-run.  This module draws that line once:

- :class:`FailureKind` + the ``classify_*`` helpers decide TRANSIENT
  (retry-worthy: preemption, RESOURCE_EXHAUSTED, OSError family, a
  signal-killed subprocess) vs PERMANENT (deterministic: ValueError /
  assertion / shape errors, ordinary nonzero exits);
- :class:`Backoff` is the one exponential-backoff-with-jitter helper
  (capped, stop-event responsive) used for trial retries, metrics re-runs,
  and suggester cooldowns;
- :class:`CircuitBreaker` isolates a flaky suggester: closed → cooling →
  half-open probe per failure, tripped open (terminal) after ``threshold``
  consecutive failures;
- :class:`FaultInjector` is the seeded, spec-driven chaos harness threaded
  through the orchestrator/runner seams ("fail trial k's attempt j as
  transient", "raise in suggester call n", "corrupt checkpoint step s",
  "delay metrics by d") so every recovery path is exercised
  deterministically in tests and via ``katib-tpu chaos``.

Everything here is stdlib-only (jax-free) so classification is importable
from metadata-only paths (status serialization, the CLI).
"""

from __future__ import annotations

import enum
import os
import random
import threading
import time

from katib_tpu_torch.utils.clock import get_clock


class FailureKind(str, enum.Enum):
    """Why a trial attempt failed — the retry decision in one bit.

    Values are the journal/metric-label strings (``status.json``
    ``failure_kind``, ``katib_trial_retried_total{kind=...}``).
    """

    TRANSIENT = "Transient"
    PERMANENT = "Permanent"
    # no-progress stall past progressDeadlineSeconds, classified by the hang
    # watchdog (utils/watchdog.py).  Retryable like TRANSIENT: a wedged
    # compile or deadlocked collective usually clears on a re-run from the
    # last checkpoint, unlike a deterministic shape bug.
    HANG = "Hang"
    # device/mesh-layer fault: a wedged or vanished accelerator under a
    # running trial/cohort (utils/meshhealth.py classifies the pool, the
    # cohort engine degrades onto survivors).  Retryable: the re-run lands
    # on a rebuilt mesh or the serial fallback, not the dead chip.
    DEVICE = "Device"
    # jit compile / first dispatch exceeded compileDeadlineSeconds (the
    # compile watchdog in runner/trial_runner.py).  Retryable: a warm
    # compile cache or a recovered pool usually clears it.
    COMPILE_HANG = "CompileHang"

    @property
    def retryable(self) -> bool:
        """Whether the orchestrator's bounded retry loop should re-run the
        attempt (same trial name + checkpoint dir)."""
        return self in (
            FailureKind.TRANSIENT,
            FailureKind.HANG,
            FailureKind.DEVICE,
            FailureKind.COMPILE_HANG,
        )


# Infrastructure-failure markers inside exception text / tracebacks.  TPU
# preemptions and allocator exhaustion surface as XlaRuntimeError (a
# RuntimeError) whose *message* carries the gRPC-style status — there is no
# stable exception type to catch across jaxlib versions, so match the text.
_TRANSIENT_MARKERS = (
    "resource_exhausted",
    "resource exhausted",
    "out of memory",
    "unavailable",
    "deadline_exceeded",
    "preempt",  # "preempted", "preemption notice received"
    "connection reset",
    "broken pipe",
    "temporarily",  # EAGAIN-style "resource temporarily unavailable"
    "device or resource busy",
    "injected transient",  # FaultInjector tracebacks classify like the real thing
)

# Device/mesh-layer markers: a chip dying or vanishing under a running
# program.  Checked before the transient markers — a dead device needs the
# mesh-rebuild path (elastic cohort degradation), not a blind same-mesh
# re-run.  libtpu/PJRT surface these as XlaRuntimeError text, like the
# transient family.
_DEVICE_MARKERS = (
    "device is in an invalid state",
    "device not found",
    "device disappeared",
    "chip has been disabled",
    "slice health",
    # CUDA's counterparts: a GPU that fell off the bus or lost its memory
    "uncorrectable ecc error",
    "gpu is lost",
    "fallen off the bus",
    "injected device",  # FaultInjector device wedges classify like the real thing
)

# Exception families with an unambiguous kind.  Checked before the text
# markers: a ValueError whose message happens to say "unavailable" is still
# a deterministic bug.
_TRANSIENT_TYPES = (
    MemoryError,
    ConnectionError,
    TimeoutError,
    InterruptedError,
    OSError,  # the taxonomy's catch-all for host/IO flakiness
)
_PERMANENT_TYPES = (
    ValueError,  # shape errors, bad hyperparameters, failed casts
    TypeError,
    AssertionError,
    KeyError,
    IndexError,
    AttributeError,
    ZeroDivisionError,
    NotImplementedError,
)

# Exit codes worth a re-run: a signal-killed subprocess (Popen reports
# negative returncodes; shells report 128+signum) usually means the host OOM
# killer or a preemption SIGTERM, and EX_TEMPFAIL (75) is the sysexits
# convention for "try again".  SIGABRT (134) is included because libtpu
# aborts the process on slice/device health events.
RETRYABLE_EXIT_CODES = frozenset({75, 128 + 6, 128 + 9, 128 + 15})


def _classify_text(text: str) -> FailureKind:
    low = text.lower()
    if any(marker in low for marker in _DEVICE_MARKERS):
        return FailureKind.DEVICE
    if any(marker in low for marker in _TRANSIENT_MARKERS):
        return FailureKind.TRANSIENT
    return FailureKind.PERMANENT


def classify_exception(exc: BaseException) -> FailureKind:
    """Classify a caught exception.  Unknown types default to PERMANENT —
    retrying a bug wastes the retry budget, while a missed transient only
    costs one trial slot."""
    if isinstance(exc, InjectedFault):
        return exc.kind
    if isinstance(exc, _TRANSIENT_TYPES):
        return FailureKind.TRANSIENT
    if isinstance(exc, _PERMANENT_TYPES):
        return FailureKind.PERMANENT
    return _classify_text(f"{type(exc).__name__}: {exc}")


def classify_traceback(text: str) -> FailureKind:
    """Classify from traceback *text* — the whitebox path journals only the
    formatted traceback, and resumed trials have no live exception object."""
    low = text.lower()
    if any(marker in low for marker in _DEVICE_MARKERS):
        return FailureKind.DEVICE
    if any(marker in low for marker in _TRANSIENT_MARKERS):
        return FailureKind.TRANSIENT
    for name in (
        "oserror",
        "connectionerror",
        "connectionreseterror",
        "brokenpipeerror",
        "timeouterror",
        "memoryerror",
        "interruptederror",
        "filenotfounderror",
        "permissionerror",
    ):
        # the raising line is "SomeError: message"; a colon keeps substring
        # matches from firing on prose that merely mentions the type
        if f"{name}:" in low or low.rstrip().endswith(name):
            return FailureKind.TRANSIENT
    return FailureKind.PERMANENT


def classify_exit_code(rc: int) -> FailureKind:
    """Classify a black-box subprocess exit.  Negative = killed by signal
    (OOM killer, preemption SIGTERM) → transient; the ``RETRYABLE_EXIT_CODES``
    set covers the shell-style 128+signum encodings and EX_TEMPFAIL; any
    other nonzero exit is the trial's own deterministic failure."""
    if rc < 0 or rc in RETRYABLE_EXIT_CODES:
        return FailureKind.TRANSIENT
    return FailureKind.PERMANENT


# ---------------------------------------------------------------------------
# Backoff
# ---------------------------------------------------------------------------


class Backoff:
    """Exponential backoff with deterministic jitter, capped at ``cap``.

    ``delay(attempt)`` for 1-based attempts is ``base * factor**(attempt-1)``
    clamped to ``cap``, then scaled by a ±``jitter`` fraction drawn from a
    seeded RNG (same seed → same schedule, so chaos runs reproduce).
    With ``full_jitter=True`` the delay is instead drawn uniformly from
    ``[0, min(base * factor**(attempt-1), cap)]`` (AWS "full jitter") —
    preferred when many actors may back off in lockstep (loop restarts,
    suggester-timeout retries) because it decorrelates their wakeups.
    ``wait`` sleeps through ``stop_event.wait`` so a requested experiment
    stop is never delayed by a pending retry.

    Both time and randomness are injectable: ``clock`` (a ``utils.clock``
    Clock; None = the ambient one, which the simulator swaps for virtual
    time) and ``rng`` (a ``random.Random``; overrides ``seed`` so the chaos
    soak and the simulator can hand every actor a stream off one root seed).
    """

    def __init__(
        self,
        base: float = 1.0,
        factor: float = 2.0,
        cap: float = 30.0,
        jitter: float = 0.25,
        seed=None,
        full_jitter: bool = False,
        clock=None,
        rng: random.Random | None = None,
    ):
        self.base = max(0.0, float(base))
        self.factor = float(factor)
        self.cap = float(cap)
        self.jitter = float(jitter)
        self.full_jitter = bool(full_jitter)
        self._clock = clock
        self._rng = rng if rng is not None else random.Random(seed)

    def delay(self, attempt: int) -> float:
        d = min(self.base * self.factor ** max(0, attempt - 1), self.cap)
        if self.full_jitter:
            return self._rng.uniform(0.0, d)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, min(d, self.cap))

    def wait(self, attempt: int, stop_event: threading.Event | None = None) -> bool:
        """Sleep out the attempt's delay.  Returns False when interrupted by
        ``stop_event`` (the caller should abandon the retry)."""
        d = self.delay(attempt)
        clock = self._clock if self._clock is not None else get_clock()
        if stop_event is None:
            clock.sleep(d)
            return True
        return not clock.wait(stop_event, d)


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------


class CircuitBreaker:
    """Consecutive-failure breaker for the suggester seam.

    States (``state`` property):

    - ``closed``  — healthy; calls allowed.
    - ``cooling`` — a failure was recorded; ``allow()`` is False until the
      exponential cooldown elapses (bounded retry-with-backoff).
    - ``half-open`` — cooldown elapsed; exactly the next call is the probe.
      Success closes the breaker, failure re-enters cooling.
    - ``open``    — ``threshold`` consecutive failures (``tripped``); the
      caller fails the experiment with ``last_failure``.

    Not thread-safe by design: it lives on the orchestrator's single event
    loop.  ``clock`` is injectable for deterministic tests.
    """

    def __init__(
        self,
        threshold: int = 5,
        base_cooldown: float = 0.05,
        cap: float = 30.0,
        clock=None,
    ):
        self.threshold = max(1, int(threshold))
        self.base_cooldown = float(base_cooldown)
        self.cap = float(cap)
        # bare monotonic callable; None = the ambient injectable clock
        self._clock = clock if clock is not None else (
            lambda: get_clock().monotonic()
        )
        self.failures = 0
        self.last_failure = ""
        self._retry_at = 0.0

    @property
    def tripped(self) -> bool:
        return self.failures >= self.threshold

    @property
    def state(self) -> str:
        if self.tripped:
            return "open"
        if self.failures == 0:
            return "closed"
        return "half-open" if self._clock() >= self._retry_at else "cooling"

    def allow(self) -> bool:
        """May the caller attempt a call right now?"""
        return not self.tripped and self._clock() >= self._retry_at

    def record_failure(self, detail: str = "") -> bool:
        """Count one failure; returns True when this one trips the breaker."""
        self.failures += 1
        self.last_failure = detail
        self._retry_at = self._clock() + min(
            self.base_cooldown * 2.0 ** (self.failures - 1), self.cap
        )
        return self.tripped

    def record_success(self) -> None:
        self.failures = 0
        self.last_failure = ""
        self._retry_at = 0.0


# ---------------------------------------------------------------------------
# Deterministic fault injection
# ---------------------------------------------------------------------------


class InjectedFault(RuntimeError):
    """A failure planted by :class:`FaultInjector`; carries its kind so
    ``classify_exception`` routes it exactly like the real thing."""

    def __init__(self, message: str, kind: FailureKind = FailureKind.TRANSIENT):
        super().__init__(message)
        self.kind = kind


class FaultInjector:
    """Seeded, spec-driven chaos harness.

    Spec builders (chainable) address trials by *creation index* (0-based,
    deterministic under ``parallel_trial_count=1``) or by name; attempts are
    1-based and count every execution of the trial body (transient retries
    and metrics re-runs alike):

    - ``fail_trial(k, j, kind)`` — raise at the start of trial k's attempt j;
    - ``fail_suggester(n)``      — raise inside the n-th (1-based)
      ``get_suggestions`` call;
    - ``corrupt_checkpoint(k, step)`` — overwrite the files of checkpoint
      ``step`` before trial k's next attempt (fires once);
    - ``delay_metrics(k, d)``    — stall trial k's metric production by d
      seconds each attempt (stop-event responsive);
    - ``hang_trial(k, j)``       — wedge trial k's attempt j inside the
      white-box step (sleeps until interrupted — the hang watchdog's
      ``progressDeadlineSeconds`` path must catch it);
    - ``preempt_at(k)``          — deliver SIGTERM to this process when
      trial k starts (fires once — exercises the orchestrator drain path);
    - ``compile_hang(k, j)``     — wedge trial k's attempt j in its compile
      phase (only the ``compileDeadlineSeconds`` watchdog can settle it);
    - ``wedge_device(n)``        — mark device id n wedged: the mesh-health
      prober reports it WEDGED, and cohorts whose mesh contains it raise a
      DEVICE fault (exercises elastic degradation);
    - ``flake(rate, kind)``      — seeded random per-attempt failures.

    The seams (``on_trial_attempt`` / ``on_suggester_call`` /
    ``apply_metrics_delay``) are called by the runner/orchestrator inside
    their normal classification paths, so an injected fault takes exactly
    the code path a real one would.  ``log`` records every injection that
    fired, for assertions and the ``katib-tpu chaos`` report.
    """

    def __init__(
        self,
        seed: int = 0,
        rng: random.Random | None = None,
        clock=None,
    ):
        self.seed = seed
        self._rng = rng if rng is not None else random.Random(seed)
        self._clock = clock  # None = ambient (utils.clock.get_clock())
        self._lock = threading.Lock()
        self._trial_faults: dict[tuple[object, int], FailureKind] = {}
        self._suggester_calls: set[int] = set()
        self._corruptions: dict[object, list[int]] = {}
        self._metric_delays: dict[object, float] = {}
        self._hangs: set[tuple[object, int]] = set()
        self._compile_hangs: set[tuple[object, int]] = set()
        self._wedged_devices: set[int] = set()
        self._preempts: set[object] = set()
        self._loop_kills: dict[str, list[int]] = {}
        self._loop_iters: dict[str, int] = {}
        self._suggester_stalls: dict[int, float] = {}
        self._flake_rate = 0.0
        self._flake_kind = FailureKind.TRANSIENT
        self._order: dict[str, int] = {}  # trial name -> creation index
        self._attempts: dict[str, int] = {}  # trial name -> attempts so far
        self._suggester_count = 0
        self.log: list[dict] = []

    # -- spec builders ------------------------------------------------------

    def fail_trial(self, trial, attempt: int, kind=FailureKind.TRANSIENT):
        self._trial_faults[(trial, int(attempt))] = FailureKind(kind)
        return self

    def fail_suggester(self, call: int):
        self._suggester_calls.add(int(call))
        return self

    def corrupt_checkpoint(self, trial, step: int):
        self._corruptions.setdefault(trial, []).append(int(step))
        return self

    def delay_metrics(self, trial, seconds: float):
        self._metric_delays[trial] = float(seconds)
        return self

    def hang_trial(self, trial, attempt: int = 1):
        """Wedge trial ``trial``'s attempt ``attempt`` inside the white-box
        step: the runner's ``maybe_hang`` seam sleeps until an interruption
        event (hang watchdog / stop / drain) is set."""
        self._hangs.add((trial, int(attempt)))
        return self

    def compile_hang(self, trial, attempt: int = 1):
        """Wedge trial ``trial``'s attempt ``attempt`` in its *compile/first
        dispatch* phase: the runner's ``maybe_compile_hang`` seam sleeps
        until interrupted, so only the compile watchdog
        (``compileDeadlineSeconds``) can settle it as COMPILE_HANG."""
        self._compile_hangs.add((trial, int(attempt)))
        return self

    def wedge_device(self, device_id: int):
        """Mark device ``device_id`` wedged: ``is_device_wedged`` reports it
        to the mesh-health prober (doctor / preflight classify it WEDGED
        without burning wall-clock), and ``on_cohort_execute`` raises a
        DEVICE fault for any cohort whose mesh still contains it — the
        deterministic stand-in for a chip dying under a sharded cohort."""
        self._wedged_devices.add(int(device_id))
        return self

    def wedged_devices(self) -> list[int]:
        """The ids ``wedge_device`` marked, for a prober in a child process."""
        with self._lock:
            return sorted(self._wedged_devices)

    def unwedge_device(self, device_id: int):
        """Clear a wedge (models a pool releasing a stale grant)."""
        self._wedged_devices.discard(int(device_id))
        return self

    def preempt_at(self, trial):
        """SIGTERM this process when trial ``trial`` (creation index or
        name) starts — the deterministic stand-in for a TPU preemption
        notice; ``katib-tpu run``'s drain handler takes it from there."""
        self._preempts.add(trial)
        return self

    def flake(self, rate: float, kind=FailureKind.TRANSIENT):
        self._flake_rate = float(rate)
        self._flake_kind = FailureKind(kind)
        return self

    def kill_loop(self, loop: str, at_iteration: int = 1):
        """Raise out of async loop ``loop`` ('suggest' | 'schedule' |
        'harvest') at the top of its ``at_iteration``-th (1-based) iteration
        — the thread dies exactly the way an unhandled bug would, and only
        the supervisor can notice.  Fires once per arm."""
        self._loop_kills.setdefault(str(loop), []).append(int(at_iteration))
        return self

    def stall_suggester(self, seconds: float, call: int = 1):
        """Wedge the ``call``-th (1-based) ``get_suggestions`` call for
        ``seconds`` (stop-event responsive): exercises the suggester-timeout
        path — the call must trip the CircuitBreaker via its deadline
        instead of blocking the suggest loop forever."""
        self._suggester_stalls[int(call)] = float(seconds)
        return self

    def kill_loop_now(self, loop: str):
        """Time-indexed arming (the simulator's fault schedule): kill loop
        ``loop`` at whatever its NEXT iteration happens to be, instead of a
        pre-counted iteration number."""
        with self._lock:
            n = self._loop_iters.get(str(loop), 0) + 1
            self._loop_kills.setdefault(str(loop), []).append(n)
        return self

    def stall_suggester_now(self, seconds: float):
        """Time-indexed arming: stall whichever ``get_suggestions`` call
        comes next for ``seconds``."""
        with self._lock:
            self._suggester_stalls[self._suggester_count + 1] = float(seconds)
        return self

    # -- seams --------------------------------------------------------------

    def attempts_of(self, trial_name: str) -> int:
        with self._lock:
            return self._attempts.get(trial_name, 0)

    def _keys(self, name: str, idx: int):
        return (name, idx)

    def on_trial_attempt(self, trial) -> None:
        """Runner seam, called at the start of every attempt inside the
        classification try-block.  May corrupt checkpoints or raise."""
        name = trial.name
        with self._lock:
            idx = self._order.setdefault(name, len(self._order))
            attempt = self._attempts[name] = self._attempts.get(name, 0) + 1
            corrupt_steps = []
            for key in self._keys(name, idx):
                corrupt_steps += self._corruptions.pop(key, [])
            preempt = False
            for key in self._keys(name, idx):
                if key in self._preempts:
                    self._preempts.discard(key)
                    preempt = True
                    break
            kind = None
            for key in self._keys(name, idx):
                if (key, attempt) in self._trial_faults:
                    kind = self._trial_faults[(key, attempt)]
                    break
            if kind is None and self._flake_rate and self._rng.random() < self._flake_rate:
                kind = self._flake_kind
        for step in corrupt_steps:
            self._corrupt_step(trial.checkpoint_dir, step, name)
        if preempt:
            # the signal is asynchronous: this attempt keeps running and the
            # orchestrator's drain handler asks it to checkpoint-and-exit
            self.log.append({"seam": "preempt", "trial": name, "attempt": attempt})
            import signal as _signal

            os.kill(os.getpid(), _signal.SIGTERM)
        if kind is not None:
            self.log.append(
                {"seam": "trial", "trial": name, "attempt": attempt, "kind": kind.value}
            )
            raise InjectedFault(
                f"injected {kind.value.lower()} fault: trial={name} attempt={attempt}",
                kind,
            )

    def on_suggester_call(self, events: tuple = (), poll: float = 0.02) -> None:
        """Orchestrator seam, called inside the fault-isolated
        ``get_suggestions`` wrapper.  May stall (``stall_suggester``) or
        raise (``fail_suggester``)."""
        with self._lock:
            self._suggester_count += 1
            n = self._suggester_count
            stall = self._suggester_stalls.pop(n, 0.0)
        if stall > 0.0:
            self.log.append({"seam": "suggester-stall", "call": n, "seconds": stall})
            clock = self._clock if self._clock is not None else get_clock()
            deadline = clock.monotonic() + stall
            while clock.monotonic() < deadline:
                if any(ev.is_set() for ev in events):
                    break
                clock.sleep(poll)
        if n in self._suggester_calls:
            self.log.append({"seam": "suggester", "call": n})
            raise InjectedFault(f"injected suggester fault: call={n}")

    def on_loop_iteration(self, loop: str) -> None:
        """Async-loop seam, called at the top of every suggest/schedule/
        harvest loop iteration *outside all locks*.  Raises to kill the
        thread when a ``kill_loop`` arm matches this iteration."""
        with self._lock:
            n = self._loop_iters[loop] = self._loop_iters.get(loop, 0) + 1
            arms = self._loop_kills.get(loop)
            fire = bool(arms) and n in arms
            if fire:
                arms.remove(n)
        if fire:
            self.log.append({"seam": "kill-loop", "loop": loop, "iteration": n})
            raise InjectedFault(f"injected loop kill: loop={loop} iteration={n}")

    def apply_metrics_delay(self, trial, stop_event: threading.Event | None = None) -> None:
        """Runner seam: stall the trial's metric production (exercises
        deadline / metrics-retry interplay)."""
        with self._lock:
            idx = self._order.get(trial.name)
        delay = 0.0
        for key in (trial.name, idx):
            if key is not None and key in self._metric_delays:
                delay = self._metric_delays[key]
                break
        if delay <= 0.0:
            return
        self.log.append({"seam": "metrics", "trial": trial.name, "delay": delay})
        clock = self._clock if self._clock is not None else get_clock()
        if stop_event is not None:
            clock.wait(stop_event, delay)
        else:
            clock.sleep(delay)

    def maybe_hang(self, trial, events: tuple = (), poll: float = 0.02) -> None:
        """Runner seam, called inside the white-box trial body: when a
        ``hang_trial`` spec matches the current attempt, wedge here —
        sleeping until any of ``events`` (hang-watchdog flag, stop, drain)
        is set — exactly like a stuck compile or deadlocked collective.
        Fires once per (trial, attempt)."""
        name = trial.name
        with self._lock:
            idx = self._order.get(name)
            attempt = self._attempts.get(name, 1)
            key = None
            for k in self._keys(name, idx):
                if (k, attempt) in self._hangs:
                    key = (k, attempt)
                    break
            if key is None:
                return
            self._hangs.discard(key)
        self.log.append({"seam": "hang", "trial": name, "attempt": attempt})
        clock = self._clock if self._clock is not None else get_clock()
        live = [e for e in events if e is not None]
        while not any(e.is_set() for e in live):
            clock.sleep(poll)

    def maybe_compile_hang(self, trial, events: tuple = (), poll: float = 0.02) -> None:
        """Runner seam, called where jit compile / first dispatch would run:
        when a ``compile_hang`` spec matches the current attempt, wedge here
        until any of ``events`` (compile-watchdog flag, stop, drain) is set
        — exactly like an XLA compile that never returns.  Fires once per
        (trial, attempt)."""
        name = trial.name
        with self._lock:
            idx = self._order.get(name)
            attempt = self._attempts.get(name, 1)
            key = None
            for k in self._keys(name, idx):
                if (k, attempt) in self._compile_hangs:
                    key = (k, attempt)
                    break
            if key is None:
                return
            self._compile_hangs.discard(key)
        self.log.append({"seam": "compile-hang", "trial": name, "attempt": attempt})
        clock = self._clock if self._clock is not None else get_clock()
        live = [e for e in events if e is not None]
        while not any(e.is_set() for e in live):
            clock.sleep(poll)

    def is_device_wedged(self, device_id: int) -> bool:
        """Prober seam (``utils.meshhealth``): True when ``wedge_device``
        marked this device id — the probe classifies it WEDGED immediately
        instead of sleeping out the real deadline."""
        with self._lock:
            wedged = int(device_id) in self._wedged_devices
        if wedged:
            self.log.append({"seam": "device-probe", "device": int(device_id)})
        return wedged

    def on_cohort_execute(self, trials, device_ids) -> None:
        """Cohort seam (``runner/cohort.py``), called just before the
        vectorized program executes with the mesh's device ids: a mesh that
        still contains a wedged device raises a DEVICE fault — the elastic
        degradation path must rebuild the mesh from survivors and re-run."""
        with self._lock:
            hit = sorted(self._wedged_devices.intersection(int(d) for d in device_ids))
        if not hit:
            return
        names = [t.name for t in trials]
        self.log.append({"seam": "cohort-device", "devices": hit, "trials": names})
        raise InjectedFault(
            f"injected device fault: wedged device(s) {hit} in cohort mesh "
            f"(members: {', '.join(names)})",
            FailureKind.DEVICE,
        )

    def _corrupt_step(self, checkpoint_dir: str | None, step: int, name: str) -> None:
        if not checkpoint_dir:
            return
        # TrialCheckpointer lays steps out as step_%08d; accept a bare
        # str(step) dir too for non-Orbax custom layouts
        step_dir = os.path.join(checkpoint_dir, f"step_{int(step):08d}")
        if not os.path.isdir(step_dir):
            step_dir = os.path.join(checkpoint_dir, str(step))
        if not os.path.isdir(step_dir):
            return
        self.log.append({"seam": "checkpoint", "trial": name, "step": step})
        for root, _, files in os.walk(step_dir):
            for fname in files:
                try:
                    with open(os.path.join(root, fname), "wb") as f:
                        f.write(b"\x00CORRUPTED-BY-FAULT-INJECTOR")
                except OSError:
                    pass


# ---------------------------------------------------------------------------
# Deterministic crash points (the hard-kill sibling of FaultInjector)
# ---------------------------------------------------------------------------
#
# FaultInjector raises exceptions INSIDE a live process — it exercises the
# retry/classify paths but can never prove crash consistency, because the
# process survives to run its cleanup handlers.  A CrashPoint is the real
# thing: `crash_point("journal.append")` dies instantly (`os._exit` or
# SIGKILL, no atexit, no finally, no flush) when armed, so the bytes on disk
# at that instant are exactly what a power loss there would leave.  Each
# persistence site in the tree calls `crash_point(<site>)` in its
# vulnerable window; `katib-tpu chaos --crash-at/--kill-at <site>[:<n>]`
# and the sweep test in tests/test_journal_crash.py arm them via the
# environment (inherited by subprocesses, which is the point: the parent
# arms, the child dies, the parent resumes and asserts invariants).

#: env var arming one site: "site" or "site:n" (die on the n-th hit, 1-based)
CRASH_AT_ENV = "KATIB_CRASH_AT"
#: env var selecting how to die: "exit" (os._exit 137, default) or "kill"
#: (SIGKILL to self — indistinguishable from the OOM killer)
CRASH_MODE_ENV = "KATIB_CRASH_MODE"

#: every registered persistence site, in journal order.  Static so the
#: sweep test and the chaos CLI can enumerate sites without importing (and
#: therefore executing) every module that hosts one.
CRASH_POINTS = (
    "journal.append",      # journal record written, not yet fsync'd
    "journal.snapshot",    # snapshot temp file written, not yet renamed
    "suggester.pickle",    # suggester state temp file written, not renamed
    "status.write",        # status.json temp file written, not renamed
    "checkpoint.manifest", # checkpoint manifest temp written, not renamed
    "retry.budget",        # retry_count bumped in memory, not yet journaled
    "store.report",        # observation rows inserted, not yet committed
)

_crash_hits: dict[str, int] = {}
_crash_lock = threading.Lock()


def registered_crash_points() -> tuple[str, ...]:
    return CRASH_POINTS


def crash_point(site: str) -> None:
    """Die instantly iff ``KATIB_CRASH_AT`` arms ``site`` and this is the
    armed hit.  Unarmed (the normal case) this is one env read — cheap
    enough to leave in production code paths."""
    spec = os.environ.get(CRASH_AT_ENV)
    if not spec:
        return
    armed, _, nth = spec.partition(":")
    if armed != site:
        return
    try:
        want = max(1, int(nth)) if nth else 1
    except ValueError:
        want = 1
    with _crash_lock:
        _crash_hits[site] = _crash_hits.get(site, 0) + 1
        hit = _crash_hits[site]
    if hit < want:
        return
    if os.environ.get(CRASH_MODE_ENV) == "kill":
        import signal

        os.kill(os.getpid(), signal.SIGKILL)
        # SIGKILL delivery can race the return; never fall through alive
        time.sleep(60)
    os._exit(137)
