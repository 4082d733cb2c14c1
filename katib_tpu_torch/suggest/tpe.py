"""Tree-structured Parzen Estimator — native implementation.

Capability parity with the reference's ``tpe`` (hyperopt,
``hyperopt/base_service.py:28``) and ``multivariate-tpe`` (optuna TPESampler
with ``multivariate=True``, ``optuna/base_service.py:42``), re-implemented
from the TPE paper (Bergstra et al., NeurIPS 2011) rather than wrapping a
library (neither hyperopt nor optuna ships in this image, and the native
version is ~1 page of numpy).

Sketch: split completed trials into the best ``gamma``-quantile ("good") and
the rest ("bad"); fit Parzen density estimators l(x) over good and g(x) over
bad; draw candidates from l and keep the one maximizing l(x)/g(x), which is
monotone in expected improvement.

- Numeric dims: mixture of truncated Gaussians on the encoded unit interval,
  one component per observation plus a uniform prior component; bandwidths
  from a spacing heuristic.
- Categorical dims: Dirichlet-smoothed category counts.
- ``multivariate-tpe``: densities are evaluated jointly (product kernel per
  mixture component) instead of per-dimension, capturing parameter
  interactions the univariate variant ignores.
"""

from __future__ import annotations

import math

import numpy as np

from katib_tpu_torch.core.types import Experiment, ExperimentSpec, TrialAssignmentSet
from katib_tpu_torch.suggest.base import Suggester, SuggesterError, register
from katib_tpu_torch.suggest.space import SpaceEncoder

_SQRT2PI = math.sqrt(2.0 * math.pi)


def _truncnorm_pdf(x: np.ndarray, mu: float, sigma: float) -> np.ndarray:
    """Gaussian truncated to [0,1], evaluated at x (vectorized)."""
    from scipy.stats import norm

    z = norm.cdf((1.0 - mu) / sigma) - norm.cdf((0.0 - mu) / sigma)
    z = max(z, 1e-12)
    return np.exp(-0.5 * ((x - mu) / sigma) ** 2) / (sigma * _SQRT2PI * z)


class _ParzenNumeric:
    """1-D Parzen estimator over [0,1] with a uniform prior component.

    ``prior_weight`` scales the uniform component against the (unit-weight)
    observation kernels — the reference hyperopt setting of the same name
    (``hyperopt/service.py:71``)."""

    def __init__(self, obs: np.ndarray, prior_weight: float = 1.0):
        # observation ORDER is preserved: in multivariate mode component j must
        # be the same observation across every dimension
        self.mus = np.asarray(obs, dtype=np.float64)
        self.prior_weight = float(prior_weight)
        n = len(self.mus)
        if n == 0:
            self.sigmas = np.array([])
            return
        # bandwidth: distance to farther neighbor (hyperopt-style), clipped
        order = np.argsort(self.mus)
        sorted_mus = self.mus[order]
        padded = np.concatenate([[0.0], sorted_mus, [1.0]])
        left = sorted_mus - padded[:-2]
        right = padded[2:] - sorted_mus
        sigma_sorted = np.maximum(left, right)
        sigmas = np.empty(n)
        sigmas[order] = sigma_sorted
        self.sigmas = np.clip(sigmas, 1.0 / (min(100.0, 1.0 + n)), 1.0)

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        out = np.empty(n)
        k = len(self.mus)
        w = self.prior_weight
        for i in range(n):
            # prior component gets weight w/(k+w), each kernel 1/(k+w).
            # w == 1 uses the single-draw form so default-config runs keep
            # their exact pre-prior_weight random streams (reproducibility)
            if w == 1.0:
                j = rng.integers(k + 1)
                pick_prior = j == k
            else:
                pick_prior = rng.random() < w / (k + w)
                j = rng.integers(k) if not pick_prior else k
            if pick_prior:
                out[i] = rng.random()
            else:
                v = rng.normal(self.mus[j], self.sigmas[j])
                out[i] = min(1.0, max(0.0, v))
        return out

    def pdf(self, x: np.ndarray) -> np.ndarray:
        """Mixture density at x; uniform prior always contributes."""
        x = np.asarray(x, dtype=np.float64)
        k = len(self.mus)
        w = self.prior_weight
        total = np.full_like(x, w)  # uniform prior component, pdf = 1 on [0,1]
        for mu, s in zip(self.mus, self.sigmas):
            total = total + _truncnorm_pdf(x, mu, s)
        return total / (k + w)

    def component_pdfs(self, x: np.ndarray) -> np.ndarray:
        """(k+1, len(x)) per-component densities (for multivariate joint)."""
        x = np.asarray(x, dtype=np.float64)
        rows = [np.ones_like(x)]
        for mu, s in zip(self.mus, self.sigmas):
            rows.append(_truncnorm_pdf(x, mu, s))
        return np.stack(rows)


class _ParzenCategorical:
    """Dirichlet-smoothed categorical estimator."""

    def __init__(self, indices: np.ndarray, n_choices: int, prior: float = 1.0):
        counts = np.bincount(indices.astype(int), minlength=n_choices).astype(float)
        self.weights = (counts + prior) / (counts.sum() + prior * n_choices)
        # per-observation one-hot-ish component view for multivariate mode:
        # each component is the smoothed distribution conditioned on one obs
        self.n_choices = n_choices
        self.obs = indices.astype(int)
        self.prior = prior

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.choice(self.n_choices, size=n, p=self.weights)

    def pmf(self, idx: np.ndarray) -> np.ndarray:
        return self.weights[np.asarray(idx, dtype=int)]

    def component_pmfs(self, idx: np.ndarray) -> np.ndarray:
        """(k+1, len(idx)): row 0 is the uniform prior; row j+1 upweights obs j."""
        idx = np.asarray(idx, dtype=int)
        uniform = np.full(len(idx), 1.0 / self.n_choices)
        rows = [uniform]
        for o in self.obs:
            w = np.full(self.n_choices, self.prior / self.n_choices)
            w[o] += 1.0
            w /= w.sum()
            rows.append(w[idx])
        return np.stack(rows)


class _TPECore:
    def __init__(
        self,
        space: SpaceEncoder,
        gamma: float,
        n_candidates: int,
        multivariate: bool,
        prior_weight: float = 1.0,
    ):
        self.space = space
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.multivariate = multivariate
        self.prior_weight = float(prior_weight)

    def split(self, ys: np.ndarray) -> int:
        """Number of 'good' observations (lower y is better)."""
        n = len(ys)
        return max(1, min(int(np.ceil(self.gamma * n)), 25))

    def suggest_one(
        self, xs_enc: np.ndarray, ys: np.ndarray, rng: np.random.Generator
    ) -> np.ndarray:
        order = np.argsort(ys, kind="stable")
        n_good = self.split(ys)
        good = xs_enc[order[:n_good]]
        bad = xs_enc[order[n_good:]]

        d = self.space.n_dims
        good_est, bad_est = [], []
        for dim in range(d):
            if self.space.is_categorical(dim):
                nc = self.space.n_choices(dim)
                scale = max(nc - 1, 1)
                good_est.append(
                    _ParzenCategorical(
                        np.round(good[:, dim] * scale), nc, prior=self.prior_weight
                    )
                )
                bad_est.append(
                    _ParzenCategorical(
                        np.round(bad[:, dim] * scale), nc, prior=self.prior_weight
                    )
                )
            else:
                good_est.append(_ParzenNumeric(good[:, dim], self.prior_weight))
                bad_est.append(_ParzenNumeric(bad[:, dim], self.prior_weight))

        # draw candidates from the good density
        cands = np.empty((self.n_candidates, d))
        for dim in range(d):
            if self.space.is_categorical(dim):
                nc = self.space.n_choices(dim)
                idx = good_est[dim].sample(rng, self.n_candidates)
                cands[:, dim] = idx / max(nc - 1, 1)
            else:
                cands[:, dim] = good_est[dim].sample(rng, self.n_candidates)

        log_l = self._log_density(good_est, cands)
        log_g = self._log_density(bad_est, cands)
        return cands[int(np.argmax(log_l - log_g))]

    def _log_density(self, ests: list, cands: np.ndarray) -> np.ndarray:
        if not self.multivariate:
            total = np.zeros(len(cands))
            for dim, est in enumerate(ests):
                if isinstance(est, _ParzenCategorical):
                    scale = max(est.n_choices - 1, 1)
                    idx = np.round(cands[:, dim] * scale)
                    total += np.log(np.maximum(est.pmf(idx), 1e-300))
                else:
                    total += np.log(np.maximum(est.pdf(cands[:, dim]), 1e-300))
            return total
        # multivariate: joint mixture — components are aligned across dims
        # (component j = observation j in the good/bad set + shared prior row 0)
        per_dim = []
        for dim, est in enumerate(ests):
            if isinstance(est, _ParzenCategorical):
                scale = max(est.n_choices - 1, 1)
                idx = np.round(cands[:, dim] * scale)
                per_dim.append(est.component_pmfs(idx))
            else:
                per_dim.append(est.component_pdfs(cands[:, dim]))
        # (k+1, n_cands): product over dims within each component; weighted
        # mean over components (row 0 = prior at prior_weight, kernels at 1)
        joint = np.ones_like(per_dim[0])
        for mat in per_dim:
            joint = joint * mat
        k = joint.shape[0] - 1
        w = np.full(joint.shape[0], 1.0 / (k + self.prior_weight))
        w[0] *= self.prior_weight
        return np.log(np.maximum((joint * w[:, None]).sum(axis=0), 1e-300))


class _BaseTPESuggester(Suggester):
    multivariate = False

    # the reference spells this key ``n_EI_candidates``
    # (``hyperopt/service.py:72``); accept both so Katib YAMLs round-trip
    @staticmethod
    def _ei_candidates_setting(s) -> str | None:
        for key in ("n_EI_candidates", "n_ei_candidates"):
            if key in s:
                return s[key]
        return None

    @classmethod
    def validate(cls, spec: ExperimentSpec) -> None:
        s = spec.algorithm.settings
        if "gamma" in s and not (0.0 < float(s["gamma"]) < 1.0):
            raise SuggesterError("gamma must be in (0, 1)")
        ei = cls._ei_candidates_setting(s)
        if ei is not None and int(ei) < 1:
            raise SuggesterError("n_EI_candidates must be >= 1")
        if "n_startup_trials" in s and int(s["n_startup_trials"]) < 0:
            raise SuggesterError("n_startup_trials must be >= 0")
        if "prior_weight" in s and not float(s["prior_weight"]) > 0:
            raise SuggesterError("prior_weight must be > 0")

    def get_suggestions(
        self, experiment: Experiment, count: int
    ) -> list[TrialAssignmentSet]:
        space = SpaceEncoder(self.spec.parameters)
        settings = self.spec.algorithm.settings
        n_startup = int(settings.get("n_startup_trials", 10))
        gamma = float(settings.get("gamma", 0.25))
        n_cand = int(self._ei_candidates_setting(settings) or 24)
        prior_weight = float(settings.get("prior_weight", 1.0))

        xs, ys = self.observed_xy(experiment)
        rng = self.rng(extra=len(experiment.trials))

        out: list[TrialAssignmentSet] = []
        if len(xs) < n_startup:
            # startup phase: random exploration (hyperopt does the same)
            while len(out) < count and len(xs) + len(out) < max(n_startup, count):
                out.append(
                    TrialAssignmentSet(assignments=space.sample_assignments(rng))
                )
            out = out[:count]
            if len(out) == count:
                return out

        core = _TPECore(space, gamma, n_cand, self.multivariate, prior_weight)
        xs_enc = np.stack([space.encode(x) for x in xs]) if xs else np.zeros((0, space.n_dims))
        while len(out) < count:
            u = core.suggest_one(xs_enc, ys, rng)
            out.append(TrialAssignmentSet(assignments=space.to_assignments(space.decode(u))))
            # pretend the new point was observed at the median so repeated
            # asks in one batch don't collapse to the same candidate
            xs_enc = np.concatenate([xs_enc, u[None, :]])
            ys = np.append(ys, np.median(ys) if len(ys) else 0.0)
        return out


@register("tpe")
class TPESuggester(_BaseTPESuggester):
    multivariate = False


@register("multivariate-tpe")
class MultivariateTPESuggester(_BaseTPESuggester):
    multivariate = True
