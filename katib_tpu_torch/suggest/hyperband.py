"""Hyperband — successive-halving brackets over a resource parameter.

Capability parity with the reference's ``hyperband`` service
(``pkg/suggestion/v1beta1/hyperband/service.py:36-200``), with two design
changes:

1. **Explicit persisted state.**  The reference round-trips mutated algorithm
   settings through ``Suggestion.Status.AlgorithmSettings``
   (``service.py:56`` -> ``suggestionclient.go:194-196``) to stay stateless.
   Here bracket state is a small JSON blob in
   ``experiment.algorithm_settings["_hyperband_state"]`` — same contract
   (restart-safe, no in-memory state), without scattering derived values
   across individual settings keys.
2. **Rung membership via labels.**  The reference selects "the latest N
   trials sorted by start time" (``service.py:127-134``) to find the current
   rung; trials here carry ``hyperband-s`` / ``hyperband-i`` labels, so rung
   membership is exact even with retries or out-of-order starts.

Math (matching the reference): eta (default 3), r_l = max resource,
s_max = floor(log_eta(r_l)); bracket s from s_max down to 0 runs rungs
i = 0..s with sizes n_0 = ceil((s_max+1) * eta^s / (s+1)),
n_i = ceil(n_{i-1} / eta) and resources r_i = r_l * eta^(i-s); each rung
copies the top n_i trials of the previous rung with the resource parameter
raised.
"""

from __future__ import annotations

import json
import math

from katib_tpu_torch.core.types import (
    Experiment,
    ExperimentSpec,
    ParameterAssignment,
    Trial,
    TrialAssignmentSet,
)
from katib_tpu_torch.suggest.base import (
    parse_eta,
    SearchExhausted,
    Suggester,
    SuggesterError,
    SuggestionsNotReady,
    register,
)
from katib_tpu_torch.suggest.space import SpaceEncoder

STATE_KEY = "_hyperband_state"
S_LABEL = "hyperband-s"
I_LABEL = "hyperband-i"




def _s_max(r_l: float, eta: int) -> int:
    # epsilon guards float truncation: log(1000)/log(10) = 2.9999999999999996
    return int(math.floor(math.log(r_l) / math.log(eta) + 1e-9))


@register("hyperband")
class HyperbandSuggester(Suggester):
    @classmethod
    def validate(cls, spec: ExperimentSpec) -> None:
        s = spec.algorithm.settings
        if "r_l" not in s or "resource_name" not in s:
            raise SuggesterError("hyperband requires settings r_l and resource_name")
        try:
            r_l = float(s["r_l"])
        except (TypeError, ValueError):
            raise SuggesterError("r_l must be a positive number") from None
        if r_l <= 0:
            raise SuggesterError("r_l must be a positive number")
        eta = parse_eta(s)
        if not any(p.name == s["resource_name"] for p in spec.parameters):
            raise SuggesterError(
                f"resource_name {s['resource_name']!r} must be a declared parameter"
            )
        s_max = _s_max(r_l, eta)
        max_parallel = int(math.ceil(eta**s_max))
        if spec.parallel_trial_count < max_parallel:
            raise SuggesterError(
                f"parallel_trial_count must be >= {max_parallel} for r_l={r_l}, eta={eta}"
            )
        # smallest rung resource is r_l * eta^(-s_max) (deepest bracket's
        # first rung, _resource with i=0, s=s_max), floored at 1
        cls.check_resource_in_space(
            spec,
            s["resource_name"],
            cls._resource(r_l, eta, s_max, 0),
            r_l,
            what="rung resources",
        )

    # -- parameters --------------------------------------------------------

    def _cfg(self) -> tuple[float, int, int, str]:
        s = self.spec.algorithm.settings
        r_l = float(s["r_l"])
        eta = parse_eta(s)
        return r_l, eta, _s_max(r_l, eta), s["resource_name"]

    @staticmethod
    def _rung_sizes(s_max: int, s: int, eta: int) -> list[int]:
        n0 = int(math.ceil((s_max + 1) * eta**s / (s + 1)))
        sizes = [n0]
        for _ in range(s):
            sizes.append(int(math.ceil(sizes[-1] / eta)))
        return sizes

    @staticmethod
    def _resource(r_l: float, eta: int, s: int, i: int) -> int:
        return max(1, int(r_l * eta ** (i - s)))

    # -- state -------------------------------------------------------------

    def _load_state(self, experiment: Experiment) -> dict:
        raw = experiment.algorithm_settings.get(STATE_KEY)
        if raw:
            return json.loads(raw)
        _, _, s_max, _ = self._cfg()
        return {"s": s_max, "i": 0}

    def _save_state(self, experiment: Experiment, state: dict) -> None:
        experiment.algorithm_settings[STATE_KEY] = json.dumps(state)

    # -- rung helpers ------------------------------------------------------

    @staticmethod
    def _rung_trials(experiment: Experiment, s: int, i: int) -> list[Trial]:
        return [
            t
            for t in experiment.trials.values()
            if t.labels.get(S_LABEL) == str(s) and t.labels.get(I_LABEL) == str(i)
        ]

    # ranking shared with asha via Suggester.top_trials

    # -- main --------------------------------------------------------------

    def get_suggestions(
        self, experiment: Experiment, count: int
    ) -> list[TrialAssignmentSet]:
        r_l, eta, s_max, resource_name = self._cfg()
        state = self._load_state(experiment)
        space = SpaceEncoder(self.spec.parameters)

        while True:
            s, i = state["s"], state["i"]
            if s < 0:
                raise SearchExhausted("hyperband brackets finished")
            sizes = self._rung_sizes(s_max, s, eta)
            r_i = self._resource(r_l, eta, s, i)
            rung = self._rung_trials(experiment, s, i)

            # rung target: nominal size, shrunk to the survivor count when the
            # previous rung had failures (otherwise the rung could never fill
            # and the experiment would deadlock on an empty proposal list)
            if i == 0:
                survivors: list[Trial] = []
                target = sizes[0]
            else:
                prev = self._rung_trials(experiment, s, i - 1)
                if any(not t.condition.is_terminal() for t in prev):
                    raise SuggestionsNotReady(
                        f"hyperband bracket s={s} rung {i-1} still running"
                    )
                survivors = self.top_trials(
                    [t for t in prev if t.condition.is_completed_ok()], sizes[i]
                )
                if not survivors:
                    # whole previous rung failed; abandon bracket
                    state = {"s": s - 1, "i": 0}
                    self._save_state(experiment, state)
                    continue
                target = min(sizes[i], len(survivors))

            if len(rung) < target:
                missing = target - len(rung)
                if i == 0:
                    proposals = self._master_rung(
                        space, resource_name, r_i, missing, s, skip=len(rung)
                    )
                else:
                    proposals = [
                        self._promote(t, resource_name, r_i, s, i)
                        for t in survivors[len(rung) : len(rung) + missing]
                    ]
                return proposals[:count]

            # rung fully proposed: wait for completion, then advance
            if any(not t.condition.is_terminal() for t in rung):
                raise SuggestionsNotReady(
                    f"hyperband bracket s={s} rung {i} has trials in flight"
                )
            completed_ok = [t for t in rung if t.condition.is_completed_ok()]
            if i < s and completed_ok:
                state = {"s": s, "i": i + 1}
            else:
                state = {"s": s - 1, "i": 0}
            self._save_state(experiment, state)

    def _rung_labels(self, s: int, i: int, r: int) -> dict[str, str]:
        """Rung identity labels, plus the per-trial device budget when
        ``devices_per_rung`` is set: the rung's resource value ALSO sizes the
        trial's sub-mesh lease (``katib-tpu/devices``, honored by the
        orchestrator's ElasticSliceAllocator) — survivors get more chips,
        not just more epochs.  TPU-native elasticity the reference has no
        analog for (its ``r_i`` can only reach the container's argv)."""
        return {S_LABEL: str(s), I_LABEL: str(i), **self.rung_device_labels(r)}

    def _master_rung(
        self,
        space: SpaceEncoder,
        resource_name: str,
        r: int,
        n: int,
        s: int,
        skip: int = 0,
    ) -> list[TrialAssignmentSet]:
        # deterministic per-bracket stream; burn `skip` samples so partial
        # proposals (count < rung size) never repeat configurations
        rng = self.rng(extra=1000 * s)
        for _ in range(skip):
            space.sample(rng)
        out = []
        for _ in range(n):
            params = space.sample(rng)
            params[resource_name] = self.spec.parameter(resource_name).cast(r)
            out.append(
                TrialAssignmentSet(
                    assignments=space.to_assignments(params),
                    labels=self._rung_labels(s, 0, r),
                )
            )
        return out

    def _promote(
        self, trial: Trial, resource_name: str, r: int, s: int, i: int
    ) -> TrialAssignmentSet:
        assignments = [
            ParameterAssignment(
                a.name,
                self.spec.parameter(resource_name).cast(r) if a.name == resource_name else a.value,
            )
            for a in trial.spec.assignments
        ]
        labels = self._rung_labels(s, i, r)
        labels["hyperband-parent"] = trial.name
        return TrialAssignmentSet(assignments=assignments, labels=labels)

    def total_budget(self) -> int:
        """Total number of trials hyperband will run (for budget planning)."""
        r_l, eta, s_max, _ = self._cfg()
        return sum(
            sum(self._rung_sizes(s_max, s, eta)) for s in range(s_max, -1, -1)
        )
