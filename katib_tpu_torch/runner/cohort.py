"""The opt-in protocol of vectorized trial cohorts
(``katib_tpu/runner/cohort.py``), the part the orchestrator reads.

A train_fn declares its vectorized twin under :data:`COHORT_ATTR`; the
async engine's cohort packing (``orchestrator/async_loops.py``) engages
only for such a train_fn and a width above one.  The cohort runner itself
(``CohortContext``, ``run_cohort``) is not ported yet: the orchestrator
refuses a run that would engage it (``Orchestrator._refuse_unported``).
"""

from __future__ import annotations

from typing import Callable

#: the attribute by which a train_fn declares its cohort twin
COHORT_ATTR = "__cohort_fn__"


def cohort_fn_of(train_fn: Callable | None) -> Callable | None:
    """The cohort-capable twin of ``train_fn``, or None when it never
    opted in (black-box commands and plain train_fns stay serial)."""
    if train_fn is None:
        return None
    return getattr(train_fn, COHORT_ATTR, None)
