"""Search-space helper constructors.

Parity with the reference SDK's ``kubeflow.katib.search`` helpers
(``sdk/python/v1beta1/kubeflow/katib/api/search.py:19,37,55``): terse
factories users call inside a ``tune()`` search-space dict.  Values come back
as typed ``ParameterSpec`` templates; the parameter name is filled in from the
dict key by ``tune()``/``make_parameters``.
"""

from __future__ import annotations

import builtins
from typing import Any, Sequence

from katib_tpu_torch.core.types import (
    Distribution,
    FeasibleSpace,
    ParameterSpec,
    ParameterType,
)


class _Unnamed:
    """A ParameterSpec missing only its name (bound later from the dict key)."""

    def __init__(self, type: ParameterType, feasible: FeasibleSpace):
        self.type = type
        self.feasible = feasible

    def bind(self, name: str) -> ParameterSpec:
        return ParameterSpec(name=name, type=self.type, feasible=self.feasible)


def double(
    min: float,
    max: float,
    step: float | None = None,
    distribution: Distribution | str = Distribution.UNIFORM,
) -> _Unnamed:
    return _Unnamed(
        ParameterType.DOUBLE,
        FeasibleSpace(
            min=float(min),
            max=float(max),
            step=step,
            distribution=Distribution(distribution),
        ),
    )


def loguniform(min: float, max: float) -> _Unnamed:
    return double(min, max, distribution=Distribution.LOG_UNIFORM)


def int_(
    min: int,
    max: int,
    step: int | None = None,
    distribution: Distribution | str = Distribution.UNIFORM,
) -> _Unnamed:
    return _Unnamed(
        ParameterType.INT,
        FeasibleSpace(
            min=builtins.int(min),
            max=builtins.int(max),
            step=step,
            distribution=Distribution(distribution),
        ),
    )


# the reference names this `search.int`; keep that spelling available (the
# module-global shadows the builtin, hence the explicit builtins. references)
globals()["int"] = int_


def discrete(values: Sequence[float]) -> _Unnamed:
    return _Unnamed(ParameterType.DISCRETE, FeasibleSpace(list=tuple(values)))


def categorical(values: Sequence[Any]) -> _Unnamed:
    return _Unnamed(ParameterType.CATEGORICAL, FeasibleSpace(list=tuple(values)))


def make_parameters(space: dict[str, Any]) -> list[ParameterSpec]:
    """Turn a ``{name: helper-or-spec-or-literal-list}`` dict into parameter
    specs.  Literal lists/tuples become categorical parameters; numeric
    ``(min, max)`` 2-tuples become doubles."""
    params: list[ParameterSpec] = []
    for name, v in space.items():
        if isinstance(v, _Unnamed):
            params.append(v.bind(name))
        elif isinstance(v, ParameterSpec):
            params.append(v)
        elif (
            isinstance(v, tuple)
            and len(v) == 2
            and all(
                isinstance(x, (builtins.int, float)) and not isinstance(x, bool)
                for x in v
            )
        ):
            params.append(double(v[0], v[1]).bind(name))
        elif isinstance(v, (list, tuple)):
            params.append(categorical(v).bind(name))
        else:
            raise TypeError(
                f"search-space entry {name!r}: expected a katib_tpu_torch.sdk.search "
                f"helper, a ParameterSpec, a (min, max) tuple or a list of "
                f"choices; got {type(v).__name__}"
            )
    return params
