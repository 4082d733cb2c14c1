"""Random search (reference ``hyperopt/base_service.py`` with algorithm
``random``).  Stateless: the RNG streams forward by the number of trials
already proposed, so restarts don't repeat configurations."""

from __future__ import annotations

from katib_tpu_torch.core.types import Experiment, TrialAssignmentSet
from katib_tpu_torch.suggest.base import Suggester, register
from katib_tpu_torch.suggest.space import SpaceEncoder


@register("random")
class RandomSuggester(Suggester):
    adaptive = False  # history offsets the stream but never shapes points

    def get_suggestions(
        self, experiment: Experiment, count: int
    ) -> list[TrialAssignmentSet]:
        space = SpaceEncoder(self.spec.parameters)
        # offset the stream by history so resumed experiments continue the
        # sequence instead of replaying it
        rng = self.rng(extra=len(experiment.trials))
        return [
            TrialAssignmentSet(assignments=space.sample_assignments(rng))
            for _ in range(count)
        ]
