"""ENAS weight sharing: children inherit a shared parameter pool (port of
``katib_tpu/nas/enas/shared.py``).

The ENAS paper's core efficiency idea (Pham et al. 2018, §2) is that child
models share weights: a sampled architecture trains the shared pool, and the
next child starts from it instead of from scratch.  The reference builds a
fresh model per trial; here sharing is an opt-in trial parameter
(``weight_sharing``) that makes each child overlay the pool's parameters
before training and publish its trained parameters back afterwards.

The pool is a flat ``{parameter name: tensor}`` dict on the CPU, keyed by
the port's parameter names.  A child's parameter is inherited where the
pool has one of the same name, shape and dtype.  Layer ``i``'s op module is
named ``op{i}_{op_name}`` (``child.py``), so the pool holds separate weights
per (layer, op), and a skip-dependent input-width mismatch simply keeps that
parameter's fresh initialisation.  Writes are last-writer-wins under one
process-wide lock: trials run as threads of one orchestrator, and the pool
is a lossy communal resource by design.  The pool is a
:class:`~katib_tpu_torch.utils.checkpoint.TrialCheckpointer` directory; one
written by the JAX package (Orbax) makes :func:`load_pool` raise
``NotImplementedError``: pools are not shared across packages.
"""

from __future__ import annotations

import threading

import torch

from katib_tpu_torch.utils.checkpoint import TrialCheckpointer

_LOCK = threading.Lock()


def overlay_matching(params: dict, shared: dict) -> tuple[dict, int]:
    """Replace every entry of ``params`` whose name, shape and dtype match
    an entry of ``shared``; returns ``(new_params, n_inherited)``."""
    out, n = dict(params), 0
    for key, value in params.items():
        cand = shared.get(key)
        if cand is not None and cand.shape == value.shape and cand.dtype == value.dtype:
            out[key] = cand
            n += 1
    return out, n


def load_pool(directory: str) -> dict | None:
    """The latest shared pool (CPU tensors), or None when none exists yet."""
    with _LOCK:
        restored = TrialCheckpointer(directory, max_to_keep=2).restore()
        return None if restored is None else restored[0]


def publish_pool(directory: str, params: dict[str, torch.Tensor]) -> None:
    """Publish trained parameters as the new pool version (last-writer-wins)."""
    with _LOCK:
        ckpt = TrialCheckpointer(directory, max_to_keep=2)
        latest = ckpt.latest_step()
        ckpt.save(params, 1 if latest is None else latest + 1)
