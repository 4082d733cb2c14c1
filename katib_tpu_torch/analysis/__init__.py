"""Runtime concurrency witnesses (port of ``katib_tpu/analysis``'s
``guards`` and ``witness``; the ``lint``, ``lockcheck`` and ``jaxcheck``
checkers are not ported yet).

- :mod:`~katib_tpu_torch.analysis.guards` — ``guarded_by`` declarations
  that name the lock guarding each field.
- :mod:`~katib_tpu_torch.analysis.witness` — runtime lock-order witness
  (``KATIB_LOCK_WITNESS=1``) recording the process-wide lock-acquisition
  graph and turning lock-order inversions into hard failures.

This ``__init__`` stays import-light (stdlib only): production modules
import ``guarded_by``/``make_lock`` from here at module-import time.
"""

from .guards import guarded_by
from .witness import (
    LockOrderInversion,
    make_lock,
    witness_enabled,
    witness_reset,
    witness_summary,
)

__all__ = [
    "guarded_by",
    "make_lock",
    "witness_enabled",
    "witness_reset",
    "witness_summary",
    "LockOrderInversion",
]
