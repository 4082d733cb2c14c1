"""Unified numeric encoding of the search space.

Every numeric algorithm (TPE, GP-BO, CMA-ES, Sobol) works over the same
encoded view: continuous/int parameters map to the unit interval (log-warped
when the distribution is logUniform/logNormal), discrete/categorical map to
index space.  This replaces the per-library domain conversions scattered
through the reference (hyperopt ``base_service.py:54``, skopt/optuna
converters, ``hyperband/parsing_util.py``) with one encoder.

All methods are vectorized numpy; nothing here touches JAX — suggesters run
on host CPU while trials own the TPU.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Sequence

import numpy as np

from katib_tpu_torch.core.types import (
    ParameterAssignment,
    ParameterSpec,
    ParameterType,
)

__all__ = ["SpaceEncoder"]


class SpaceEncoder:
    """Bijection between parameter dicts and points in the unit hypercube.

    One dimension per parameter.  Categorical/discrete dimensions carry the
    value's index scaled to [0, 1]; ``n_choices`` exposes their cardinality so
    algorithms that need special categorical handling (TPE's smoothed counts,
    GP one-hot expansion) can branch on it.
    """

    def __init__(self, params: Sequence[ParameterSpec]):
        if not params:
            raise ValueError("empty search space")
        self.params = list(params)
        self.names = [p.name for p in self.params]

    # -- introspection -----------------------------------------------------

    @property
    def n_dims(self) -> int:
        return len(self.params)

    def is_categorical(self, dim: int) -> bool:
        return self.params[dim].type in (
            ParameterType.CATEGORICAL,
            ParameterType.DISCRETE,
        )

    def n_choices(self, dim: int) -> int:
        p = self.params[dim]
        if not self.is_categorical(dim):
            raise ValueError(f"{p.name} is not categorical")
        return len(p.feasible.list)

    # -- scalar transforms -------------------------------------------------

    def _to_unit(self, dim: int, value: Any) -> float:
        p = self.params[dim]
        f = p.feasible
        if self.is_categorical(dim):
            values = list(f.list)
            try:
                idx = values.index(p.cast(value))
            except ValueError:
                idx = 0
            if len(values) == 1:
                return 0.0
            return idx / (len(values) - 1)
        lo, hi = float(f.min), float(f.max)
        v = float(value)
        if f.is_log_scaled():
            lo, hi, v = math.log(lo), math.log(hi), math.log(max(v, 1e-300))
        if hi <= lo:
            return 0.0
        return min(1.0, max(0.0, (v - lo) / (hi - lo)))

    def _from_unit(self, dim: int, u: float) -> Any:
        p = self.params[dim]
        f = p.feasible
        u = min(1.0, max(0.0, float(u)))
        if self.is_categorical(dim):
            values = list(f.list)
            idx = min(len(values) - 1, int(round(u * (len(values) - 1))))
            return values[idx]
        lo, hi = float(f.min), float(f.max)
        if f.is_log_scaled():
            v = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        else:
            v = lo + u * (hi - lo)
        if f.step:
            v = lo + round((v - lo) / f.step) * f.step
            v = min(hi, max(lo, v))
        return p.cast(v)

    # -- vector API --------------------------------------------------------

    def encode(self, assignment: Mapping[str, Any]) -> np.ndarray:
        return np.array(
            [self._to_unit(i, assignment[p.name]) for i, p in enumerate(self.params)],
            dtype=np.float64,
        )

    def decode(self, u: np.ndarray) -> dict[str, Any]:
        return {
            p.name: self._from_unit(i, u[i]) for i, p in enumerate(self.params)
        }

    def encode_categorical_index(self, dim: int, value: Any) -> int:
        p = self.params[dim]
        values = list(p.feasible.list)
        try:
            return values.index(p.cast(value))
        except ValueError:
            return 0

    def decode_categorical_index(self, dim: int, idx: int) -> Any:
        values = list(self.params[dim].feasible.list)
        return values[int(idx) % len(values)]

    # -- sampling ----------------------------------------------------------

    def sample(self, rng: np.random.Generator) -> dict[str, Any]:
        """Sample one configuration from the prior (uniform in encoded space,
        i.e. log-uniform in value space for log-scaled params)."""
        out: dict[str, Any] = {}
        for i, p in enumerate(self.params):
            if self.is_categorical(i):
                out[p.name] = self.decode_categorical_index(
                    i, rng.integers(self.n_choices(i))
                )
            else:
                out[p.name] = self._from_unit(i, rng.random())
        return out

    def sample_assignments(self, rng: np.random.Generator) -> list[ParameterAssignment]:
        return self.to_assignments(self.sample(rng))

    def to_assignments(self, d: Mapping[str, Any]) -> list[ParameterAssignment]:
        return [ParameterAssignment(p.name, p.cast(d[p.name])) for p in self.params]

    # -- one-hot view for GP models ---------------------------------------

    def onehot_dims(self) -> int:
        n = 0
        for i in range(self.n_dims):
            n += self.n_choices(i) if self.is_categorical(i) else 1
        return n

    def encode_onehot(self, assignment: Mapping[str, Any]) -> np.ndarray:
        parts: list[np.ndarray] = []
        for i, p in enumerate(self.params):
            if self.is_categorical(i):
                vec = np.zeros(self.n_choices(i))
                vec[self.encode_categorical_index(i, assignment[p.name])] = 1.0
                parts.append(vec)
            else:
                parts.append(np.array([self._to_unit(i, assignment[p.name])]))
        return np.concatenate(parts)
