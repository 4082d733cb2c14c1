"""Suggester contract + registry.

The reference runs every algorithm as a per-experiment gRPC deployment behind
``GetSuggestions`` / ``ValidateAlgorithmSettings`` (``api.proto:34-40``, composer
``composer.go:72``).  Here a suggester is an in-process object owned by the
orchestrator — same contract, no pod, no network:

- ``validate(spec)``        <-> ``ValidateAlgorithmSettings``
- ``get_suggestions(...)``  <-> ``GetSuggestions`` with ``current_request_number``

Statefulness contract (parity with the reference's semantics, §3.2 of
SURVEY.md): suggesters may keep in-memory state for the lifetime of an
experiment (hyperopt Trials store / ENAS session / PBT queue analogs) but must
either (a) derive state from the trial history passed in (random/grid/TPE/
GP/Sobol are fully stateless here), or (b) persist durable state in
``experiment.algorithm_settings`` (Hyperband, mirroring the reference's
state-in-CR round trip ``suggestionclient.go:194-196``) so an orchestrator
restart can resume.
"""

from __future__ import annotations

import abc
import hashlib
from typing import Callable, Type

import numpy as np

from katib_tpu_torch.core.types import (
    Experiment,
    ExperimentSpec,
    Trial,
    TrialAssignmentSet,
)



def parse_eta(settings) -> int:
    """The successive-halving reduction factor: an integer > 1 (default 3).
    One parser for hyperband and asha."""
    raw = settings.get("eta")
    if raw is None:
        return 3
    try:
        eta_f = float(raw)
    except (TypeError, ValueError):
        raise SuggesterError("eta must be an integer > 1") from None
    eta = int(eta_f)
    if eta != eta_f or eta <= 1:
        raise SuggesterError("eta must be an integer > 1")
    return eta

class SuggesterError(ValueError):
    """Invalid algorithm settings (gRPC INVALID_ARGUMENT analog)."""


class SuggestionsNotReady(RuntimeError):
    """The algorithm needs currently-running trials to finish before it can
    propose more (e.g. a Hyperband rung or CMA-ES generation barrier).  The
    orchestrator waits for a trial completion and retries — the analog of the
    reference's controller retry on suggestion-service errors
    (``suggestionclient.go:57-60``)."""


class SearchExhausted(RuntimeError):
    """The algorithm has nothing more to propose (grid fully enumerated,
    Hyperband brackets finished).  The orchestrator completes the experiment —
    the analog of Hyperband's empty reply when ``current_s < 0``
    (``hyperband/service.py:47-49``)."""


#: Exceptions that are suggester *control flow*, not faults — the
#: orchestrator's circuit breaker must never count them as failures.
CONTROL_FLOW_EXCEPTIONS = (SearchExhausted, SuggestionsNotReady)


def call_suggester(
    suggester: "Suggester",
    experiment: Experiment,
    count: int,
    breaker=None,
    injector=None,
    deadline: float | None = None,
    events: tuple = (),
) -> tuple[list[TrialAssignmentSet], str]:
    """One fault-isolated ``get_suggestions`` call — the single seam through
    which the orchestrator talks to an algorithm.

    Returns ``(proposals, outcome)`` with outcome one of ``"ok"``,
    ``"exhausted"``, ``"not_ready"``, ``"error"``.  Control-flow signals
    (:data:`CONTROL_FLOW_EXCEPTIONS`) close the ``breaker`` — they prove the
    suggester is healthy — while any other exception is recorded as a failure
    with its traceback (the reference retries suggestion-service RPC errors
    at the controller, ``suggestionclient.go:57-60``; here the breaker bounds
    those retries).  The caller checks ``breaker.tripped`` for the terminal
    verdict and ``breaker.allow()`` before calling again.  ``injector`` is
    the ``faults.FaultInjector`` chaos seam.

    With ``deadline`` set the call runs on a daemon worker thread and a call
    still blocked after ``deadline`` seconds is abandoned: the breaker
    records the failure (bounded retries, then the experiment fails with a
    diagnosis) instead of the caller blocking forever behind a wedged
    algorithm.  The abandoned call's eventual result, if any, is discarded —
    a proposal set that missed its deadline was never journaled.  ``events``
    are stop/halt events a deadline wait also honors.
    """
    import traceback as _traceback

    if deadline is not None:
        return _call_suggester_deadline(
            suggester, experiment, count, breaker, injector, deadline, events
        )

    try:
        if injector is not None:
            injector.on_suggester_call(events=events)
        proposals = suggester.get_suggestions(experiment, count)
    except SearchExhausted:
        if breaker is not None:
            breaker.record_success()
        return [], "exhausted"
    except SuggestionsNotReady:
        if breaker is not None:
            breaker.record_success()
        return [], "not_ready"
    except Exception:
        if breaker is not None:
            breaker.record_failure(_traceback.format_exc(limit=20))
        return [], "error"
    if breaker is not None:
        breaker.record_success()
    return proposals, "ok"


def _call_suggester_deadline(
    suggester, experiment, count, breaker, injector, deadline, events
) -> tuple[list[TrialAssignmentSet], str]:
    """Deadline wrapper: the call itself runs (fault-isolated, no breaker —
    the outer frame owns the verdict) on a daemon thread; a timeout is a
    breaker failure with a "deadline" diagnosis."""
    import traceback as _traceback

    box: dict = {}

    def _worker():
        try:
            if injector is not None:
                injector.on_suggester_call(events=events)
            box["result"] = (suggester.get_suggestions(experiment, count), "ok")
        except SearchExhausted:
            box["result"] = ([], "exhausted")
        except SuggestionsNotReady:
            box["result"] = ([], "not_ready")
        except Exception:
            box["traceback"] = _traceback.format_exc(limit=20)
            box["result"] = ([], "error")

    from katib_tpu_torch.utils.clock import get_clock

    clock = get_clock()
    t = clock.spawn(_worker, name="katib-suggest-call", daemon=True)
    waited = 0.0
    poll = min(0.05, deadline)
    while waited < deadline and t.is_alive():
        if any(ev.is_set() for ev in events):
            break
        clock.join_thread(t, poll)
        waited += poll
    if "result" not in box:
        if breaker is not None:
            breaker.record_failure(
                f"get_suggestions exceeded its {deadline:.1f}s deadline "
                "(call abandoned; see loopStallDeadlineSeconds)"
            )
        return [], "error"
    proposals, outcome = box["result"]
    if breaker is not None:
        if outcome == "error":
            breaker.record_failure(
                box.get("traceback", "get_suggestions raised")
            )
        else:
            breaker.record_success()
    return proposals, outcome


class Suggester(abc.ABC):
    """One suggestion algorithm bound to one experiment."""

    #: registry key, e.g. "random"
    name: str = ""

    #: whether proposals depend on observed results.  The async suggest
    #: loop keeps a deep proposal lookahead for NON-adaptive suggesters
    #: (random/grid/sobol enumerate the same points regardless of history)
    #: but clamps it to the in-flight width for adaptive ones — racing an
    #: ASHA/BO/PBT suggester far ahead of its observations burns the trial
    #: budget on uninformed proposals (e.g. rung-0 randoms that crowd out
    #: promotions).  Conservative default: adaptive.
    adaptive: bool = True

    def __init__(self, spec: ExperimentSpec):
        self.spec = spec
        self.validate(spec)

    # -- contract ----------------------------------------------------------

    @classmethod
    def validate(cls, spec: ExperimentSpec) -> None:
        """Raise SuggesterError on invalid settings/space for this algorithm."""

    @abc.abstractmethod
    def get_suggestions(
        self, experiment: Experiment, count: int
    ) -> list[TrialAssignmentSet]:
        """Propose up to ``count`` new trials given the experiment's history."""

    # -- shared helpers ----------------------------------------------------

    def seed(self, extra: int = 0) -> int:
        """Deterministic per-experiment seed.  ``random_state`` setting wins;
        otherwise the experiment name seeds it, so reruns are reproducible.

        ``extra`` selects an independent stream: it is HASH-MIXED with the
        base, never added — additive composition makes adjacent seeds
        produce overlapping generator families (seed 2's stream at index n
        equals seed 1's at n+1), which silently correlates what should be
        independent replicates (e.g. a multi-seed benchmark's random
        baseline collapsing to one sample)."""
        s = self.spec.algorithm.setting("random_state") or self.spec.algorithm.setting(
            "seed"
        )
        base = str(int(s)) if s is not None else self.spec.name
        digest = hashlib.sha256(f"{base}:{extra}".encode()).digest()
        # 4 bytes: sklearn's random_state requires [0, 2^32)
        return int.from_bytes(digest[:4], "little")

    def rng(self, extra: int = 0) -> np.random.Generator:
        return np.random.default_rng(self.seed(extra))

    @staticmethod
    def completed_trials(experiment: Experiment) -> list[Trial]:
        """Trials usable as observations, in start order."""
        done = [
            t
            for t in experiment.trials.values()
            if t.condition.is_completed_ok() and t.observation is not None
        ]
        return sorted(done, key=lambda t: t.start_time)

    def top_trials(self, trials: list[Trial], k: int) -> list[Trial]:
        """The k best trials by the experiment objective (missing
        observations dropped).  Shared ranking rule for the
        successive-halving family (hyperband, asha)."""
        obj = self.spec.objective
        scored = [(t.objective_value(obj), t) for t in trials]
        scored = [(v, t) for v, t in scored if v is not None]
        scored.sort(key=lambda p: p[0], reverse=obj.type.value == "maximize")
        return [t for _, t in scored[:k]]

    def rung_device_labels(self, r: int) -> dict[str, str]:
        """``{DEVICES_LABEL: r}`` when the ``devices_per_rung`` setting is
        truthy — the rung's resource value also sizes the trial's sub-mesh
        lease (honored by the orchestrator's ElasticSliceAllocator), so
        promoted survivors get more chips, not just more epochs.  One copy
        of the setting parse for every rung-based suggester."""
        from katib_tpu_torch.utils.booleans import parse_bool

        if parse_bool(self.spec.algorithm.setting("devices_per_rung")):
            from katib_tpu_torch.core.types import DEVICES_LABEL

            return {DEVICES_LABEL: str(r)}
        return {}

    @staticmethod
    def check_resource_in_space(
        spec, resource_name: str, lo: float, hi: float, *, what: str = "resource bounds"
    ) -> None:
        """Raise unless ``[lo, hi]`` lies inside the declared feasible range
        of the resource parameter.  ``ParameterSpec.cast`` rounds but does
        not clamp, so rung resources outside the range would emit trial
        assignments outside the declared search space.  Shared by the
        successive-halving family (hyperband, asha)."""
        p = next((p for p in spec.parameters if p.name == resource_name), None)
        if p is None or p.feasible.min is None or p.feasible.max is None:
            return  # presence / type of the parameter is checked separately
        if lo < p.feasible.min or hi > p.feasible.max:
            raise SuggesterError(
                f"{what} [{lo:g}, {hi:g}] fall outside parameter "
                f"{resource_name!r}'s feasible range "
                f"[{p.feasible.min:g}, {p.feasible.max:g}]"
            )

    @staticmethod
    def observed_xy(
        experiment: Experiment,
    ) -> tuple[list[dict], np.ndarray]:
        """(params, objective values) for completed trials; values are
        sign-flipped so that LOWER IS ALWAYS BETTER internally."""
        obj = experiment.spec.objective
        sign = 1.0 if obj.type.value == "minimize" else -1.0
        xs, ys = [], []
        for t in Suggester.completed_trials(experiment):
            v = t.objective_value(obj)
            if v is None:
                continue
            xs.append(t.params())
            ys.append(sign * v)
        return xs, np.asarray(ys, dtype=np.float64)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[ExperimentSpec], Suggester]] = {}


def register(name: str) -> Callable[[Type[Suggester]], Type[Suggester]]:
    def deco(cls: Type[Suggester]) -> Type[Suggester]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def _resolve(name: str) -> Type[Suggester]:
    """Registry lookup with the lazy-import fallback — shared by construction
    and validation so the two paths can never drift on what's resolvable."""
    # import for registration side effects
    import importlib

    from katib_tpu_torch.suggest import algorithms  # noqa: F401

    if name not in _REGISTRY and name in algorithms.LAZY_ALGORITHMS:
        importlib.import_module(algorithms.LAZY_ALGORITHMS[name])
    if name not in _REGISTRY and name in algorithms.UNPORTED_ALGORITHMS:
        raise NotImplementedError(
            f"algorithm {name!r} needs {algorithms.UNPORTED_ALGORITHMS[name]}, "
            "which the port does not have yet"
        )
    if name not in _REGISTRY:
        raise SuggesterError(
            f"unknown algorithm {name!r}; registered: {sorted(registered_algorithms())}"
        )
    return _REGISTRY[name]


def make_suggester(spec: ExperimentSpec) -> Suggester:
    """Instantiate the registered suggester for an experiment spec — the
    analog of the composer resolving the algorithm image from KatibConfig
    (``composer.go:72``)."""
    return _resolve(spec.algorithm.name)(spec)


def validate_spec(spec: ExperimentSpec) -> None:
    """Run the registered algorithm's ``validate`` WITHOUT instantiating it.
    Construction can have side effects (``remote``'s composer mode spawns a
    service subprocess), which a validate-only caller must never trigger —
    the analog of ``ValidateAlgorithmSettings`` being a separate RPC from
    suggestion serving."""
    _resolve(spec.algorithm.name).validate(spec)


def registered_algorithms() -> list[str]:
    from katib_tpu_torch.suggest import algorithms  # noqa: F401

    return sorted(set(_REGISTRY) | set(algorithms.LAZY_ALGORITHMS))
