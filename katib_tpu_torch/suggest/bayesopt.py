"""Gaussian-process Bayesian optimization.

Capability parity with the reference's ``bayesianoptimization`` service
(skopt ``Optimizer`` with a GP base estimator,
``pkg/suggestion/v1beta1/skopt/base_service.py``).  skopt is not a
dependency; the GP comes from scikit-learn (same underlying model skopt wraps)
and the acquisition loop is implemented here.  Copy of
``katib_tpu/suggest/bayesopt.py``: scikit-learn and scipy are imported inside
the suggester, never at module top, because ``suggest/algorithms.py`` imports
every suggester and scikit-learn is an optional dependency; without it
``validate`` raises ``SuggesterError``.

Settings (mirroring the reference's accepted skopt settings,
``skopt/base_service.py:31-40``):
- ``base_estimator``    only "GP" is supported
- ``n_initial_points``  random-sample count before modeling (default 10)
- ``acq_func``          "ei" | "pi" | "lcb" | "gp_hedge" (case-insensitive;
                        skopt spells them "EI"/"PI"/"LCB").  The reference
                        default is gp_hedge — skopt's portfolio strategy:
                        each acquisition proposes its best candidate, one is
                        picked by softmax over accumulated gains, and every
                        proposal's predicted mean is subtracted from its
                        acquisition's gain so the portfolio adapts toward
                        whichever acquisition proposes low-mean points.
- ``acq_optimizer``     accepted for YAML compat ("auto"/"sampling"/"lbfgs");
                        candidates are always optimized by sampling here
- ``random_state``      seed
"""

from __future__ import annotations

import numpy as np

from katib_tpu_torch.core.types import Experiment, ExperimentSpec, TrialAssignmentSet
from katib_tpu_torch.suggest.base import Suggester, SuggesterError, register
from katib_tpu_torch.suggest.space import SpaceEncoder

_ACQ_FUNCS = ("ei", "pi", "lcb", "gp_hedge")
_ACQ_OPTIMIZERS = ("auto", "sampling", "lbfgs")
# the reference service's skopt default (``skopt/base_service.py:33``)
_DEFAULT_ACQ = "gp_hedge"


@register("bayesianoptimization")
class BayesOptSuggester(Suggester):
    @classmethod
    def validate(cls, spec: ExperimentSpec) -> None:
        import importlib.util

        # sklearn/scipy imports are deferred for startup speed; presence
        # still fails at submission, not mid-run
        for dep in ("scipy", "sklearn"):
            if importlib.util.find_spec(dep) is None:
                raise SuggesterError(
                    f"bayesianoptimization requires {dep} (the 'bayesopt' extra)"
                )
        s = spec.algorithm.settings
        if s.get("base_estimator", "GP") != "GP":
            raise SuggesterError("only base_estimator=GP is supported")
        if s.get("acq_func", _DEFAULT_ACQ).lower() not in _ACQ_FUNCS:
            raise SuggesterError(f"acq_func must be one of {_ACQ_FUNCS}")
        if s.get("acq_optimizer", "auto").lower() not in _ACQ_OPTIMIZERS:
            raise SuggesterError(f"acq_optimizer must be one of {_ACQ_OPTIMIZERS}")
        if "n_initial_points" in s and int(s["n_initial_points"]) < 1:
            raise SuggesterError("n_initial_points must be >= 1")

    def _fit_gp(self, X: np.ndarray, y: np.ndarray, seed: int):
        import warnings

        from sklearn.exceptions import ConvergenceWarning
        from sklearn.gaussian_process import GaussianProcessRegressor
        from sklearn.gaussian_process.kernels import ConstantKernel, Matern, WhiteKernel

        kernel = ConstantKernel(1.0) * Matern(
            length_scale=np.full(X.shape[1], 0.5),
            length_scale_bounds=(1e-2, 1e2),
            nu=2.5,
        ) + WhiteKernel(noise_level=1e-6, noise_level_bounds=(1e-12, 1e-1))
        gp = GaussianProcessRegressor(
            kernel=kernel, normalize_y=True, random_state=seed, n_restarts_optimizer=1
        )
        with warnings.catch_warnings():
            # noise-free synthetic objectives routinely pin the WhiteKernel at
            # its lower bound; that is expected, not a fit failure
            warnings.simplefilter("ignore", ConvergenceWarning)
            gp.fit(X, y)
        return gp

    @staticmethod
    def _scores(
        mu: np.ndarray, sigma: np.ndarray, y_best: float, acq: str, xi: float = 0.01
    ) -> np.ndarray:
        """Acquisition scores from a shared GP posterior (one ``predict``
        serves every acquisition — gp_hedge needs all three per ask)."""
        # scipy.stats costs ~2s of import time; every orchestrator start
        # imports this module via the algorithm registry, so the import
        # stays inside the only function that needs it
        from scipy.stats import norm

        sigma = np.maximum(sigma, 1e-9)
        if acq == "lcb":
            return -(mu - 1.96 * sigma)  # maximize negative lower bound
        imp = y_best - mu - xi  # minimizing internally
        z = imp / sigma
        if acq == "pi":
            return norm.cdf(z)
        return imp * norm.cdf(z) + sigma * norm.pdf(z)  # EI

    # -- gp_hedge portfolio state: call-history state, so it must ride the
    # resume hooks (base contract: everything else derives from trial
    # history; these pickles restore the adaptive portfolio on --resume)

    def state_dict(self) -> dict:
        return {"hedge_gains": list(getattr(self, "_hedge_gains", np.zeros(3)))}

    def load_state_dict(self, data: dict) -> None:
        gains = data.get("hedge_gains")
        if gains is not None and len(gains) == 3:
            self._hedge_gains = np.asarray(gains, dtype=float)

    def get_suggestions(
        self, experiment: Experiment, count: int
    ) -> list[TrialAssignmentSet]:
        space = SpaceEncoder(self.spec.parameters)
        settings = self.spec.algorithm.settings
        n_init = int(settings.get("n_initial_points", 10))
        # default matches the reference service's skopt default (gp_hedge,
        # ``skopt/base_service.py:33``) so an acq-less Katib YAML behaves
        # the same here as upstream
        acq = settings.get("acq_func", _DEFAULT_ACQ).lower()

        xs, ys = self.observed_xy(experiment)
        rng = self.rng(extra=len(experiment.trials))

        out: list[TrialAssignmentSet] = []
        if len(xs) < n_init:
            need = min(count, n_init - len(xs))
            out.extend(
                TrialAssignmentSet(assignments=space.sample_assignments(rng))
                for _ in range(need)
            )
            if len(out) == count:
                return out
        if not xs:
            # no observations to model yet: fill the rest randomly
            out.extend(
                TrialAssignmentSet(assignments=space.sample_assignments(rng))
                for _ in range(count - len(out))
            )
            return out

        X = np.stack([space.encode_onehot(x) for x in xs])
        y = ys.copy()
        seed = self.seed(extra=len(experiment.trials))
        n_cand = 1024
        hedge_gains = getattr(self, "_hedge_gains", None)
        if hedge_gains is None:
            hedge_gains = self._hedge_gains = np.zeros(3)
        hedge_funcs = ("ei", "pi", "lcb")
        while len(out) < count:
            gp = self._fit_gp(X, y, seed)
            # candidate pool: random configurations in one-hot space
            cand_params = [space.sample(rng) for _ in range(n_cand)]
            X_cand = np.stack([space.encode_onehot(p) for p in cand_params])
            # one posterior evaluation serves every acquisition below
            mu, sigma = gp.predict(X_cand, return_std=True)
            y_best = float(np.min(y))
            if acq == "gp_hedge":
                # skopt portfolio: each acquisition nominates its argmax,
                # selection is probability-matched on accumulated gains,
                # and every nominee's predicted mean decrements its gain
                picks = [
                    int(np.argmax(self._scores(mu, sigma, y_best, a)))
                    for a in hedge_funcs
                ]
                logits = hedge_gains - hedge_gains.max()
                probs = np.exp(logits) / np.exp(logits).sum()
                chosen = int(rng.choice(3, p=probs))
                hedge_gains -= mu[picks]
                best = cand_params[picks[chosen]]
            else:
                best = cand_params[
                    int(np.argmax(self._scores(mu, sigma, y_best, acq)))
                ]
            out.append(TrialAssignmentSet(assignments=space.to_assignments(best)))
            # hallucinate the GP mean at the chosen point (constant-liar) so a
            # batch of suggestions spreads out instead of stacking
            x_new = space.encode_onehot(best)[None, :]
            X = np.concatenate([X, x_new])
            y = np.append(y, float(gp.predict(x_new)[0]))
        return out
