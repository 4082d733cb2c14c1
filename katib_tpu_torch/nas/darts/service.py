"""DARTS suggester, config-only half (port of ``katib_tpu/nas/darts/service.py``
without the experiment types and the suggester registry).

All search happens inside the single trial.  The suggester converts the NAS
operations into a primitive list, merges algorithm settings over the
defaults, validates them, and emits exactly ONE trial carrying three string
parameters: ``algorithm-settings``, ``search-space``, ``num-layers``.
"""

from __future__ import annotations

import json
from typing import Any, Mapping, Sequence

from katib_tpu_torch.models.data import NAMED_DATASETS
from katib_tpu_torch.nas.darts.architect import DartsHyper

DEFAULT_SETTINGS: dict[str, object] = {
    # reference defaults ``darts/service.py:118-135``; the optimizer-side
    # values come from DartsHyper so the trial and service can't drift
    "num_epochs": 50,
    **{
        k: v
        for k, v in DartsHyper._field_defaults.items()
        if k not in ("total_steps", "unrolled")
    },
    "batch_size": 128,
    "init_channels": 16,
    "num_nodes": 4,
    "stem_multiplier": 3,
}

_POSITIVE_INT = {
    "num_epochs", "batch_size", "init_channels", "num_nodes",
    "stem_multiplier", "n_train", "n_test",
    "step_loop_window", "stepLoopWindow",
}
# augment_epochs may be 0 (off, the default)
_NON_NEGATIVE_INT = {"augment_epochs"}
_POSITIVE_FLOAT = {
    "w_lr",
    "w_lr_min",
    "w_momentum",
    "w_weight_decay",
    "w_grad_clip",
    "alpha_lr",
    "alpha_weight_decay",
    "augment_lr",
}


class SuggesterError(ValueError):
    """The experiment's DARTS configuration is invalid."""


def search_space_from_nas_config(operations: Sequence[Mapping[str, Any]]) -> list[str]:
    """``nasConfig.operations`` -> primitive names (reference ``get_search_space``:
    ``<operationType>_<k>x<k>`` per filter size; skip_connection bare).

    Each operation is a dict as in the YAML spec: ``operationType`` and
    ``parameters``, each parameter with ``name`` and ``feasibleSpace.list``."""
    primitives: list[str] = []
    for op in operations:
        op_type = op["operationType"]
        if op_type == "skip_connection":
            primitives.append("skip_connection")
            continue
        sizes = []
        for p in op.get("parameters") or ():
            feasible = (p.get("feasibleSpace") or {}).get("list")
            if p.get("name") == "filter_size" and feasible:
                sizes = list(feasible)
        if not sizes:
            raise SuggesterError(
                f"operation {op_type!r} needs a filter_size categorical parameter"
            )
        for k in sizes:
            primitives.append(f"{op_type}_{k}x{k}")
    return primitives


def validate_settings(settings: Mapping[str, Any]) -> None:
    """Reject algorithm settings the trial cannot run (reference ``:162``)."""
    for name, raw in settings.items():
        if name in _POSITIVE_INT or name in _NON_NEGATIVE_INT:
            try:
                v = int(raw)
            except (TypeError, ValueError):
                raise SuggesterError(f"{name} must be an integer") from None
            if v <= 0 and name in _POSITIVE_INT:
                raise SuggesterError(f"{name} must be > 0")
            if v < 0:
                raise SuggesterError(f"{name} must be >= 0")
        elif name in _POSITIVE_FLOAT:
            try:
                v = float(raw)
            except (TypeError, ValueError):
                raise SuggesterError(f"{name} must be a number") from None
            if v < 0:
                raise SuggesterError(f"{name} must be >= 0")
        elif name == "dataset" and str(raw) not in NAMED_DATASETS:
            raise SuggesterError(f"dataset must be one of {NAMED_DATASETS}, got {raw!r}")


def trial_parameters(
    operations: Sequence[Mapping[str, Any]], num_layers: int, settings: Mapping[str, Any]
) -> dict[str, str]:
    """The one search trial's parameters, exactly as the JAX suggester's
    ``get_suggestions`` emits them."""
    primitives = search_space_from_nas_config(operations)
    validate_settings(settings)
    merged = dict(DEFAULT_SETTINGS)
    merged.update(settings)
    return {
        "algorithm-settings": json.dumps(merged),
        "search-space": json.dumps(primitives),
        "num-layers": str(num_layers),
    }
