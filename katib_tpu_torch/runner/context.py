"""A minimal trial context: the surface ``darts_trial`` and
``transformer_trial`` use (port of the matching part of
``katib_tpu/runner/context.py``; the orchestrator, the observation store and
early-stopping rules are not ported yet)."""

from __future__ import annotations

import os
import threading
from typing import Any, Mapping


class TrialContext:
    """What a train function sees of its trial.

    ``params``: the trial's parameter assignments (strings).
    ``checkpoint_dir``: where the trial writes its artifacts.
    ``device``: the device the trial runs on (``None`` = ``cuda``).
    ``step_times``: a list to receive each training step's wall seconds,
    or ``None`` to skip the per-step device sync that measuring needs.
    ``mesh``: the device mesh the trial should train on, as in the JAX
    context; ``None`` is one device (the only layout the port runs yet).
    ``reports`` keeps every ``report()`` call as ``(step, metrics)``."""

    def __init__(self, params: Mapping[str, Any], checkpoint_dir: str | None = None,
                 device: str | None = None, step_times: list | None = None,
                 mesh: Any = None):
        self.params = dict(params)
        self.checkpoint_dir = checkpoint_dir
        self.device = device
        self.step_times = step_times
        self.mesh = mesh
        self.reports: list[tuple[int, dict[str, float]]] = []
        self._step = 0
        self._stop = threading.Event()

    def report(self, step: int | None = None, **metrics: float) -> bool:
        """Record metric values; returns True while the trial may continue."""
        if step is None:
            step = self._step
        self._step = step + 1
        self.reports.append((step, {k: float(v) for k, v in metrics.items()}))
        return not self.should_stop()

    def request_stop(self) -> None:
        """Ask the trial to wind down at its next report."""
        self._stop.set()

    def should_stop(self) -> bool:
        return self._stop.is_set()

    def ensure_checkpoint_dir(self) -> str:
        if self.checkpoint_dir is None:
            raise RuntimeError("trial has no checkpoint directory configured")
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        return self.checkpoint_dir
