"""CMA-ES — native implementation of the (mu/mu_w, lambda) evolution strategy
with covariance matrix adaptation (Hansen's tutorial formulation).

Capability parity with the reference's ``cmaes`` algorithm (goptuna CMA-ES
sampler, ``pkg/suggestion/v1beta1/goptuna/converter.go:40-75``, including the
IPOP/BIPOP restart variants selected via the ``restart_strategy`` setting).

State model: CMA-ES is generation-based.  Rather than hiding state in the
process (the reference service loses its study on restart — SURVEY.md §3.2),
every proposed trial carries labels ``cmaes-generation`` and ``cmaes-index``;
the suggester replays completed trials from the experiment history to
reconstruct identical strategy state, so it is restart-safe by construction.
"""

from __future__ import annotations

import math

import numpy as np

from katib_tpu_torch.core.types import (
    Experiment,
    ExperimentSpec,
    TrialAssignmentSet,
)
from katib_tpu_torch.suggest.base import (
    Suggester,
    SuggesterError,
    SuggestionsNotReady,
    register,
)
from katib_tpu_torch.suggest.space import SpaceEncoder

GEN_LABEL = "cmaes-generation"
IDX_LABEL = "cmaes-index"


class CmaState:
    """Pure CMA-ES strategy state over the unit hypercube."""

    def __init__(self, dim: int, seed: int, sigma0: float = 0.25, popsize: int | None = None):
        self.dim = dim
        self.rng = np.random.default_rng(seed)
        self.lam = popsize or (4 + int(3 * math.log(dim)))
        self.mu = self.lam // 2
        w = math.log(self.mu + 0.5) - np.log(np.arange(1, self.mu + 1))
        self.weights = w / w.sum()
        self.mueff = 1.0 / np.sum(self.weights**2)

        n = float(dim)
        self.cc = (4 + self.mueff / n) / (n + 4 + 2 * self.mueff / n)
        self.cs = (self.mueff + 2) / (n + self.mueff + 5)
        self.c1 = 2 / ((n + 1.3) ** 2 + self.mueff)
        self.cmu = min(
            1 - self.c1,
            2 * (self.mueff - 2 + 1 / self.mueff) / ((n + 2) ** 2 + self.mueff),
        )
        self.damps = 1 + 2 * max(0.0, math.sqrt((self.mueff - 1) / (n + 1)) - 1) + self.cs
        self.chiN = math.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n * n))

        self.mean = np.full(dim, 0.5)
        self.sigma = sigma0
        self.C = np.eye(dim)
        self.ps = np.zeros(dim)
        self.pc = np.zeros(dim)
        self.generation = 0

    def ask(self) -> np.ndarray:
        """Sample lambda candidates, clipped to the unit cube."""
        # eigendecomposition each generation (dims are tiny for HP search)
        d2, B = np.linalg.eigh(self.C)
        d2 = np.maximum(d2, 1e-20)
        A = B @ np.diag(np.sqrt(d2))
        z = self.rng.standard_normal((self.lam, self.dim))
        x = self.mean + self.sigma * z @ A.T
        return np.clip(x, 0.0, 1.0)

    def tell(self, xs: np.ndarray, ys: np.ndarray) -> None:
        """Update strategy state from a full generation (lower y better)."""
        order = np.argsort(ys, kind="stable")
        elite = xs[order[: self.mu]]
        old_mean = self.mean.copy()
        self.mean = self.weights @ elite

        d2, B = np.linalg.eigh(self.C)
        d2 = np.maximum(d2, 1e-20)
        inv_sqrt = B @ np.diag(1.0 / np.sqrt(d2)) @ B.T

        y_mean = (self.mean - old_mean) / self.sigma
        self.ps = (1 - self.cs) * self.ps + math.sqrt(
            self.cs * (2 - self.cs) * self.mueff
        ) * inv_sqrt @ y_mean
        hsig = float(
            np.linalg.norm(self.ps)
            / math.sqrt(1 - (1 - self.cs) ** (2 * (self.generation + 1)))
            / self.chiN
            < 1.4 + 2 / (self.dim + 1)
        )
        self.pc = (1 - self.cc) * self.pc + hsig * math.sqrt(
            self.cc * (2 - self.cc) * self.mueff
        ) * y_mean

        artmp = (elite - old_mean) / self.sigma
        self.C = (
            (1 - self.c1 - self.cmu) * self.C
            + self.c1
            * (np.outer(self.pc, self.pc) + (1 - hsig) * self.cc * (2 - self.cc) * self.C)
            + self.cmu * artmp.T @ np.diag(self.weights) @ artmp
        )
        self.sigma = self.sigma * math.exp(
            (self.cs / self.damps) * (np.linalg.norm(self.ps) / self.chiN - 1)
        )
        self.sigma = float(min(self.sigma, 1.0))
        self.generation += 1


@register("cmaes")
class CmaEsSuggester(Suggester):
    @classmethod
    def validate(cls, spec: ExperimentSpec) -> None:
        numeric = [p for p in spec.parameters if p.type.value in ("double", "int")]
        if len(numeric) != len(spec.parameters):
            raise SuggesterError("cmaes supports only double/int parameters")
        if len(numeric) < 2:
            raise SuggesterError("cmaes requires at least 2 parameters")
        rs = spec.algorithm.settings.get("restart_strategy", "none")
        if rs not in ("none", "ipop", "bipop"):
            raise SuggesterError("restart_strategy must be none, ipop, or bipop")
        if "sigma" in spec.algorithm.settings and float(spec.algorithm.settings["sigma"]) <= 0:
            raise SuggesterError("sigma must be positive")

    def _replay(
        self, experiment: Experiment, space: SpaceEncoder
    ) -> tuple[CmaState, int]:
        """Rebuild strategy state from the labeled trial history.

        Returns ``(state, label_gen)`` where ``label_gen`` is the history
        generation the next proposals belong to.  The label counter is
        monotonic across IPOP/BIPOP restarts (the strategy's internal
        generation resets, the labels never do — otherwise post-restart trials
        would collide with old generation-0 labels and corrupt replay).
        """
        sigma0 = float(self.spec.algorithm.settings.get("sigma", 0.25))
        popsize = self.spec.algorithm.settings.get("population_size")
        state = CmaState(
            space.n_dims,
            seed=self.seed(),
            sigma0=sigma0,
            popsize=int(popsize) if popsize else None,
        )
        restart = self.spec.algorithm.settings.get("restart_strategy", "none")

        # group completed labeled trials by generation
        by_gen: dict[int, list] = {}
        for t in experiment.trials.values():
            if GEN_LABEL not in t.labels:
                continue
            by_gen.setdefault(int(t.labels[GEN_LABEL]), []).append(t)

        obj = self.spec.objective
        sign = 1.0 if obj.type.value == "minimize" else -1.0
        gen = 0
        stagnation = 0
        best_y = math.inf
        while gen in by_gen:
            trials = by_gen[gen]
            done = [
                t
                for t in trials
                if t.condition.is_completed_ok()
                and t.observation
                and t.objective_value(obj) is not None
            ]
            if len(done) < state.lam:
                # generation still in flight — ask() below must reproduce it,
                # so do NOT advance; caller handles pending logic
                break
            done = sorted(done, key=lambda t: int(t.labels[IDX_LABEL]))[: state.lam]
            xs = np.stack([space.encode(t.params()) for t in done])
            ys = np.array([sign * t.objective_value(obj) for t in done])
            # burn one ask() so the RNG stream stays aligned with the
            # generation that produced these trials
            state.ask()
            state.tell(xs, ys)
            gen_best = float(np.min(ys))
            if gen_best < best_y - 1e-12:
                best_y, stagnation = gen_best, 0
            else:
                stagnation += 1
            # IPOP restart: double population after prolonged stagnation
            if restart in ("ipop", "bipop") and (
                stagnation >= 10 + state.dim or state.sigma < 1e-8
            ):
                state = CmaState(
                    space.n_dims,
                    seed=self.seed(extra=gen + 1),
                    sigma0=sigma0,
                    popsize=state.lam * 2 if restart == "ipop" else state.lam,
                )
                stagnation = 0
            gen += 1
        return state, gen

    def get_suggestions(
        self, experiment: Experiment, count: int
    ) -> list[TrialAssignmentSet]:
        space = SpaceEncoder(self.spec.parameters)
        state, label_gen = self._replay(experiment, space)

        # which members of the current generation are already proposed?
        current = [
            t
            for t in experiment.trials.values()
            if t.labels.get(GEN_LABEL) == str(label_gen)
        ]
        # an index counts as proposed while its trial is in flight or finished
        # with a usable objective; failed members (and succeeded ones whose
        # observation lacks the objective metric) are retried with the same
        # deterministic point (PBT-style requeue, reference
        # ``pbt/service.py:303-322`` applies the same policy)
        obj = self.spec.objective

        def _usable(t) -> bool:
            if not t.condition.is_terminal():
                return True
            return t.condition.is_completed_ok() and t.objective_value(obj) is not None

        proposed_idx = {int(t.labels[IDX_LABEL]) for t in current if _usable(t)}
        pending = [t for t in current if not t.condition.is_terminal()]
        if len(proposed_idx) >= state.lam and pending:
            raise SuggestionsNotReady(
                f"cmaes generation {label_gen} has {len(pending)} trials in flight"
            )
        xs = state.ask()
        out: list[TrialAssignmentSet] = []
        for i in range(state.lam):
            if i in proposed_idx:
                continue
            if len(out) >= count:
                break
            out.append(
                TrialAssignmentSet(
                    assignments=space.to_assignments(space.decode(xs[i])),
                    labels={GEN_LABEL: str(label_gen), IDX_LABEL: str(i)},
                )
            )
        if not out and not pending:
            raise SuggestionsNotReady(
                "cmaes: waiting for generation results to be observed"
            )
        return out
