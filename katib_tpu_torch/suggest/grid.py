"""Grid search (reference ``optuna/base_service.py:42`` GridSampler over the
combinations of the search space).

Fully stateless: the cartesian product is enumerated in a deterministic
order and the cursor is simply the number of trials already created, so a
restarted orchestrator resumes exactly where it stopped."""

from __future__ import annotations

import itertools

from katib_tpu_torch.core.types import (
    Experiment,
    ExperimentSpec,
    ParameterAssignment,
    TrialAssignmentSet,
)
from katib_tpu_torch.suggest.base import SearchExhausted, Suggester, SuggesterError, register


@register("grid")
class GridSuggester(Suggester):
    adaptive = False  # fixed enumeration, safe to propose far ahead

    @classmethod
    def validate(cls, spec: ExperimentSpec) -> None:
        import math

        if math.isinf(spec.search_space_size()):
            raise SuggesterError(
                "grid search requires a finite space: every double parameter needs a step"
            )

    def _grid(self) -> list[tuple]:
        axes = [p.grid_values() for p in self.spec.parameters]
        return list(itertools.product(*axes))

    def get_suggestions(
        self, experiment: Experiment, count: int
    ) -> list[TrialAssignmentSet]:
        grid = self._grid()
        cursor = len(experiment.trials)
        if cursor >= len(grid):
            raise SearchExhausted(f"grid fully enumerated ({len(grid)} points)")
        out = []
        for combo in grid[cursor : cursor + count]:
            assignments = [
                ParameterAssignment(p.name, v)
                for p, v in zip(self.spec.parameters, combo)
            ]
            out.append(TrialAssignmentSet(assignments=assignments))
        return out
