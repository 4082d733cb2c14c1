"""Trial execution context — the white-box replacement for the reference's
pod machinery (port of ``katib_tpu/runner/context.py``).

In the reference, a trial is an opaque container: parameters arrive as CLI
args rendered from a template (``manifest/generator.go:79-99``), metrics leave
via stdout scraping by an injected sidecar (``pod/inject_webhook.go:123``),
and early stopping is a SIGTERM from that sidecar.  Here a trial is a
function ``train_fn(ctx)`` and ``TrialContext`` is its whole contract:

- ``ctx.params``           — suggested hyperparameters (strings)
- ``ctx.report(...)``      — metrics straight into the observation store
- ``ctx.should_stop()``    — cooperative early-stopping check
- ``ctx.checkpoint_dir``   — per-trial checkpoint directory
- ``ctx.device``           — the device the trial runs on (``None`` = ``cuda``)
- ``ctx.mesh``             — the device mesh (``parallel/mesh.py``); ``None``
                             is one device

The port keeps its own call form: ``params`` is the first positional
argument, so a trial can be driven by hand (``TrialContext({...},
device="cpu")``); everything the runner passes is a keyword with a default.
Without a ``store`` the reports are kept only in ``ctx.reports``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Mapping

from katib_tpu_torch.core.types import MetricLog
from katib_tpu_torch.earlystop.rules import RuleEvaluator
from katib_tpu_torch.store.base import ObservationStore


class TrialEarlyStopped(Exception):
    """Raised by ``raise_if_stopped`` to unwind a training loop when a stop
    rule fires."""


class TrialContext:
    """What a train function sees of its trial.

    ``step_times``: a list to receive each training step's wall seconds, or
    ``None`` to skip the per-step device sync that measuring needs.
    ``reports`` keeps every ``report()`` call as ``(step, metrics)``;
    ``timings`` receives set-up seconds the trial measures (the DARTS trial
    writes ``graph_capture_s`` when it captures its step on the card)."""

    def __init__(
        self,
        params: Mapping[str, Any],
        checkpoint_dir: str | None = None,
        device: str | None = None,
        step_times: list | None = None,
        mesh: Any = None,
        *,
        trial_name: str = "trial",
        store: ObservationStore | None = None,
        evaluator: RuleEvaluator | None = None,
        labels: Mapping[str, str] | None = None,
        stop_event: Any = None,
        max_runtime_seconds: float | None = None,
        drain_event: Any = None,
        hang_event: Any = None,
        heartbeat: Any = None,
    ):
        self.trial_name = trial_name
        self.params = dict(params)
        self.checkpoint_dir = checkpoint_dir
        self.device = device
        self.step_times = step_times
        self.mesh = mesh
        self.labels = dict(labels or {})
        self.reports: list[tuple[int, dict[str, float]]] = []
        self.timings: dict[str, float] = {}
        self._store = store
        self._evaluator = evaluator
        self._stop_event = stop_event
        # a stop asked for by the caller that drives the trial by hand
        self._requested_stop = threading.Event()
        # orchestrator drain (preemption SIGTERM): checkpoint-and-exit at the
        # next step boundary — report()/should_stop() turn the flag into a
        # cooperative unwind, the runner settles the trial DRAINED
        self._drain_event = drain_event
        # hang watchdog verdict (utils/watchdog.py): set by the monitor
        # thread when no heartbeat landed for progress_deadline_seconds
        self._hang_event = hang_event
        # called on every report() — the watchdog heartbeat
        self._heartbeat = heartbeat
        self._step = 0
        self._checkpointer = None
        # cooperative wall-clock deadline: report()/should_stop() turn False/
        # True past it and the runner classifies the trial FAILED
        self._deadline = (
            time.monotonic() + max_runtime_seconds
            if max_runtime_seconds is not None
            else None
        )

    # -- metrics -----------------------------------------------------------

    def report(self, step: int | None = None, **metrics: float) -> bool:
        """Report metric values; returns True while the trial may continue.

        ``ctx.report(accuracy=0.91, loss=0.3, step=epoch)`` replaces the
        reference's ``print("accuracy=0.91")`` + sidecar regex scrape.
        """
        if self._heartbeat is not None:
            self._heartbeat()
        if step is None:
            step = self._step
        self._step = step + 1
        values = {k: float(v) for k, v in metrics.items()}
        self.reports.append((step, values))
        if self._store is not None:
            now = time.time()
            self._store.report(
                self.trial_name,
                [
                    MetricLog(metric_name=k, value=v, timestamp=now, step=step)
                    for k, v in values.items()
                ],
            )
        if self._evaluator is not None:
            for name, value in values.items():
                self._evaluator.observe(name, value)
        return not self.should_stop()

    # -- early stopping ------------------------------------------------------

    def request_stop(self) -> None:
        """Ask the trial to wind down at its next report."""
        self._requested_stop.set()

    def should_stop(self) -> bool:
        """True when an early-stopping rule fired OR the experiment reached a
        terminal state (goal hit / failure budget) and wants trials to wind
        down OR the trial blew its wall-clock deadline OR a stop was
        requested."""
        if self._evaluator is not None and self._evaluator.should_stop():
            return True
        if self.deadline_exceeded():
            return True
        if self.hang_flagged() or self.drain_requested():
            return True
        if self._requested_stop.is_set():
            return True
        return self._stop_event is not None and self._stop_event.is_set()

    def deadline_exceeded(self) -> bool:
        return self._deadline is not None and time.monotonic() > self._deadline

    def drain_requested(self) -> bool:
        """True once the orchestrator received SIGTERM/SIGINT and wants this
        trial to checkpoint and return at its next step boundary.  A trial
        that saves each epoch before ``report()`` needs no extra code — the
        report's False return unwinds it after the save."""
        return self._drain_event is not None and self._drain_event.is_set()

    def hang_flagged(self) -> bool:
        """True once the hang watchdog classified this trial as stalled (the
        runner settles it ``FailureKind.HANG`` when the train_fn unwinds)."""
        return self._hang_event is not None and self._hang_event.is_set()

    def raise_if_stopped(self) -> None:
        if self._evaluator is not None and self._evaluator.should_stop():
            raise TrialEarlyStopped(self._evaluator.triggered.describe())
        if self.deadline_exceeded():
            raise TrialEarlyStopped("trial max_runtime exceeded")
        if self.hang_flagged():
            raise TrialEarlyStopped("hang watchdog interrupted the trial")
        if self.drain_requested():
            raise TrialEarlyStopped("orchestrator draining (preemption)")
        if self._requested_stop.is_set():
            raise TrialEarlyStopped("stop requested")
        if self._stop_event is not None and self._stop_event.is_set():
            raise TrialEarlyStopped("experiment reached terminal state")

    # -- checkpoints ---------------------------------------------------------

    def ensure_checkpoint_dir(self) -> str:
        if self.checkpoint_dir is None:
            raise RuntimeError("trial has no checkpoint directory configured")
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        return self.checkpoint_dir

    def checkpointer(self, max_to_keep: int = 3):
        """The port's :class:`~katib_tpu_torch.utils.checkpoint.TrialCheckpointer`
        (``torch.save`` steps with a manifest) on this trial's directory."""
        if self._checkpointer is None:
            from katib_tpu_torch.utils.checkpoint import TrialCheckpointer

            self._checkpointer = TrialCheckpointer(
                self.ensure_checkpoint_dir(), max_to_keep=max_to_keep
            )
        return self._checkpointer

    def save_checkpoint(self, tree: dict, step: int) -> str:
        return self.checkpointer().save(tree, step)

    def restore_checkpoint(self, template=None, step: int | None = None):
        """Latest (or given-step) checkpoint as ``(tree, step)``; ``None``
        on a cold start."""
        if self.checkpoint_dir is None or not os.path.isdir(self.checkpoint_dir):
            return None
        return self.checkpointer().restore(template, step)
