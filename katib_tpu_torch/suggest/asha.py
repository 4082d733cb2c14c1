"""ASHA — asynchronous successive halving (Li et al. 2018, arXiv:1810.05934).

The reference ships synchronous Hyperband only
(``pkg/suggestion/v1beta1/hyperband/service.py``), whose rungs are
barriers: every trial in a rung must finish before the next rung starts,
so one straggler idles the whole slice.  ASHA removes the barrier — each
time the orchestrator asks for work it either *promotes* a configuration
that is in the top 1/eta of its rung, or starts a fresh configuration at
the bottom rung.  No waiting, no bracket bookkeeping, and adding trial
slots never deadlocks: exactly the scheduling shape an elastic TPU slice
wants (stragglers keep their sub-mesh; new work fills the rest).

Design notes, mirroring ``hyperband.py``'s conventions:

- **State lives in trial labels, not suggester memory.**  A trial carries
  ``asha-rung`` (its rung index) and promoted children carry
  ``asha-parent``; the promotion frontier is recomputed from
  ``experiment.trials`` on every call, so the suggester is restart-safe by
  construction (no ``state_dict`` needed).
- **Promotion rule.**  From rung ``k``: among the ``n`` completed-ok
  trials at ``k``, the top ``floor(n/eta)`` by objective are promotable;
  any of them without a child at ``k+1`` is promoted (resource raised to
  ``r_min * eta^(k+1)``, capped at ``r_max``).  Higher rungs are scanned
  first so strong configs advance before new ones start.
- **devices_per_rung** behaves exactly like Hyperband's: the rung's
  resource value also sizes the trial's sub-mesh lease
  (``katib-tpu/devices``), so promoted survivors get more chips.

Settings: ``resource_name`` (required, a declared parameter),
``r_max`` (required), ``r_min`` (default 1), ``eta`` (default 3),
``devices_per_rung`` (default off), ``sampler`` (``random`` default, or
``tpe`` for BOHB-style model-based sampling: fresh rung-0 configurations
come from a TPE fitted on ALL completed trials instead of the uniform
prior — Falkner et al. 2018's combination of Bayesian optimization with
successive halving, which neither katib nor its hyperband service has).
"""

from __future__ import annotations

import math

from katib_tpu_torch.core.types import (
    Experiment,
    ExperimentSpec,
    ParameterAssignment,
    Trial,
    TrialAssignmentSet,
)
from katib_tpu_torch.suggest.base import (
    Suggester,
    SuggesterError,
    parse_eta,
    register,
)
from katib_tpu_torch.suggest.space import SpaceEncoder

RUNG_LABEL = "asha-rung"
PARENT_LABEL = "asha-parent"




@register("asha")
class AshaSuggester(Suggester):
    @classmethod
    def validate(cls, spec: ExperimentSpec) -> None:
        s = spec.algorithm.settings
        if "r_max" not in s or "resource_name" not in s:
            raise SuggesterError("asha requires settings r_max and resource_name")
        try:
            r_max = float(s["r_max"])
            r_min = float(s.get("r_min", 1))
        except (TypeError, ValueError):
            raise SuggesterError("r_max/r_min must be numbers") from None
        # resources are integer trial budgets; a fractional r_min would
        # clamp adjacent rungs to the same value and promotions would
        # re-run configs at unchanged fidelity
        if r_min < 1 or r_max < r_min:
            raise SuggesterError("need 1 <= r_min <= r_max")
        parse_eta(s)
        if not any(p.name == s["resource_name"] for p in spec.parameters):
            raise SuggesterError(
                f"resource_name {s['resource_name']!r} must be a declared parameter"
            )
        cls.check_resource_in_space(
            spec, s["resource_name"], r_min, r_max, what="r_min/r_max"
        )
        sampler = s.get("sampler", "random")
        if sampler not in ("random", "tpe"):
            raise SuggesterError(
                f"sampler must be 'random' or 'tpe', got {sampler!r}"
            )
        if sampler == "tpe":
            import importlib.util

            # TPE's model phase needs scipy; presence must fail at
            # submission, not after n_startup_trials completions
            if importlib.util.find_spec("scipy") is None:
                raise SuggesterError("sampler: tpe requires scipy")

    # -- config ------------------------------------------------------------

    def _cfg(self) -> tuple[float, float, int, int, str]:
        s = self.spec.algorithm.settings
        r_max = float(s["r_max"])
        r_min = float(s.get("r_min", 1))
        eta = parse_eta(s)
        max_rung = int(math.floor(math.log(r_max / r_min) / math.log(eta) + 1e-9))
        return r_min, r_max, eta, max_rung, s["resource_name"]

    def _resource(self, k: int) -> int:
        r_min, r_max, eta, max_rung, _ = self._cfg()
        if k >= max_rung:
            # the top rung always runs at FULL fidelity, even when
            # r_min * eta^K undershoots r_max (e.g. r_max=9, eta=2 -> 8)
            return max(1, int(r_max))
        return max(1, int(min(r_min * eta**k, r_max)))

    # -- rung bookkeeping (all from labels) --------------------------------

    @staticmethod
    def _rung_trials(experiment: Experiment, k: int) -> list[Trial]:
        return [
            t
            for t in experiment.trials.values()
            if t.labels.get(RUNG_LABEL) == str(k)
        ]

    def _promotable(self, experiment: Experiment, k: int, eta: int) -> list[Trial]:
        """Top 1/eta of rung k's completed trials without a child above."""
        done = [
            t
            for t in self._rung_trials(experiment, k)
            if t.condition.is_completed_ok()
        ]
        n_top = len(done) // eta
        if n_top == 0:
            return []
        promoted_parents = {
            t.labels.get(PARENT_LABEL)
            for t in experiment.trials.values()
            if t.labels.get(PARENT_LABEL)
        }
        return [
            t
            for t in self.top_trials(done, n_top)
            if t.name not in promoted_parents
        ]

    # -- proposals ---------------------------------------------------------

    def _labels(self, k: int, r: int) -> dict[str, str]:
        return {RUNG_LABEL: str(k), **self.rung_device_labels(r)}

    def _promote(self, trial: Trial, k: int, resource_name: str) -> TrialAssignmentSet:
        r = self._resource(k)
        assignments = [
            ParameterAssignment(
                a.name,
                self.spec.parameter(resource_name).cast(r)
                if a.name == resource_name
                else a.value,
            )
            for a in trial.spec.assignments
        ]
        labels = self._labels(k, r)
        labels[PARENT_LABEL] = trial.name
        return TrialAssignmentSet(assignments=assignments, labels=labels)

    def _fresh_batch(
        self,
        experiment: Experiment,
        space: SpaceEncoder,
        resource_name: str,
        start_index: int,
        n: int,
    ) -> list[TrialAssignmentSet]:
        """``n`` new rung-0 configurations."""
        r = self._resource(0)
        if self.spec.algorithm.setting("sampler") == "tpe":
            # BOHB-style model-based sampling (Falkner et al. 2018):
            # configurations come from a TPE fitted on every completed
            # trial, low-fidelity observations included.  ONE delegate call
            # per batch — TPE's in-batch median-injection diversifies the n
            # draws, where per-slot calls would return n identical configs
            # (same rng seed, same history).  The delegate's space excludes
            # the resource parameter: its value is a rung artifact, not a
            # hyperparameter to model.  TPE is stateless-from-history, so
            # restart determinism is preserved.
            import dataclasses

            from katib_tpu_torch.suggest.tpe import TPESuggester

            sub_spec = dataclasses.replace(
                self.spec,
                parameters=[
                    p for p in self.spec.parameters if p.name != resource_name
                ],
            )
            props = TPESuggester(sub_spec).get_suggestions(experiment, n)
            param_dicts = [{a.name: a.value for a in p.assignments} for p in props]
        else:
            # one rng stream per rung-0 index: deterministic across
            # restarts without replaying the whole history (ASHA's rung 0
            # is unbounded, so hyperband's burn-`skip`-samples pattern
            # would be O(n^2) here)
            param_dicts = [
                space.sample(self.rng(extra=start_index + i)) for i in range(n)
            ]
        out = []
        for params in param_dicts:
            params[resource_name] = self.spec.parameter(resource_name).cast(r)
            out.append(
                TrialAssignmentSet(
                    assignments=space.to_assignments(params),
                    labels=self._labels(0, r),
                )
            )
        return out

    def get_suggestions(
        self, experiment: Experiment, count: int
    ) -> list[TrialAssignmentSet]:
        _, _, eta, max_rung, resource_name = self._cfg()
        space = SpaceEncoder(self.spec.parameters)
        # one scan per call: the promotion frontier, highest rung first so
        # strong configs advance before new ones start.  Each trial appears
        # in at most one rung's candidate list, so in-batch parent dedup is
        # inherent.
        frontier = [
            (k, t)
            for k in range(max_rung - 1, -1, -1)
            for t in self._promotable(experiment, k, eta)
        ]
        n_promote = min(len(frontier), count)
        out = [
            self._promote(t, k + 1, resource_name)
            for k, t in frontier[:n_promote]
        ]
        n_fresh = count - n_promote
        if n_fresh:
            out.extend(
                self._fresh_batch(
                    experiment,
                    space,
                    resource_name,
                    start_index=len(self._rung_trials(experiment, 0)),
                    n=n_fresh,
                )
            )
        return out
