"""Sobol quasi-random search (reference goptuna ``converter.go:40-75`` builds
a Sobol-sampler study).  Uses a scrambled Sobol sequence over the encoded unit
cube; the cursor is the number of existing trials, so the low-discrepancy
stream continues correctly across restarts."""

from __future__ import annotations

from katib_tpu_torch.core.types import Experiment, TrialAssignmentSet
from katib_tpu_torch.suggest.base import Suggester, register
from katib_tpu_torch.suggest.space import SpaceEncoder


@register("sobol")
class SobolSuggester(Suggester):
    adaptive = False  # low-discrepancy sequence, independent of results

    @classmethod
    def validate(cls, spec) -> None:
        # the scipy import itself is deferred to first use for startup
        # speed; presence still fails at submission, not mid-run
        import importlib.util

        if importlib.util.find_spec("scipy") is None:
            from katib_tpu_torch.suggest.base import SuggesterError

            raise SuggesterError("sobol requires scipy (pip install scipy)")

    def get_suggestions(
        self, experiment: Experiment, count: int
    ) -> list[TrialAssignmentSet]:
        # scipy.stats costs ~2s of import; the registry imports this module
        # on every orchestrator start, so defer to first use
        from scipy.stats import qmc

        space = SpaceEncoder(self.spec.parameters)
        sampler = qmc.Sobol(d=space.n_dims, scramble=True, seed=self.seed())
        cursor = len(experiment.trials)
        if cursor:
            sampler.fast_forward(cursor)
        points = sampler.random(count)
        return [
            TrialAssignmentSet(assignments=space.to_assignments(space.decode(u)))
            for u in points
        ]
