"""Carry weights from the JAX package's DARTS supernet into the port.

The flax parameter tree (any pytree of the same structure: weights, or
gradients) arrives as nested dicts of numpy arrays.  The port's modules keep
the JAX layouts (``nn.Conv`` HWIO, ``DepthwiseConv`` ``(K, K, 1, C)``,
``PointwiseConv`` ``(C, F)``, ``nn.Dense`` ``(in, out)`` plus bias), so a
leaf carries over as it is, except the ``nn.vmap`` edge groups: their
parameters are stacked on axis 0 in the group's edge order, and each slice
goes to its own per-edge module.

Names follow flax's rule: a child is ``<ClassName>_<n>``, ``n`` counting the
children of that class in creation order.  The port's modules are named and
registered in the JAX package's creation order, so the flax path of each of
their parameters follows from the module tree alone.  A cell is
``CheckpointCell_<n>`` under ``remat=True`` (a lifted ``nn.remat(Cell)``) and
``Cell_<n>`` without it; both are accepted.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Iterator

import numpy as np
import torch
from torch import nn

from katib_tpu_torch.nas.darts.model import Alphas, Cell
from katib_tpu_torch.nas.darts.ops import EdgeGroup


def _children(module: nn.Module, prefix: str) -> Iterator[tuple[str, nn.Module]]:
    """Child modules in registration order, looking through ModuleLists."""
    for name, child in module.named_children():
        if isinstance(child, nn.ModuleList):
            yield from _children(child, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", child


def _flax_paths(module: nn.Module, prefix: str, path: tuple, stack: int | None,
                cell_name: str, out: dict) -> None:
    for pname, _ in module.named_parameters(recurse=False):
        out[f"{prefix}{pname}"] = (path + (pname,), stack)
    counts: Counter = Counter()
    for tname, child in _children(module, prefix):
        cls = type(child).__name__
        if isinstance(child, Cell):
            cls = cell_name
        elif isinstance(child, EdgeGroup):
            cls = "VmapMixedOp"
        name = f"{cls}_{counts[cls]}"
        counts[cls] += 1
        if isinstance(child, EdgeGroup):
            for e, edge in enumerate(child.edges):
                _flax_paths(edge, f"{tname}.edges.{e}.", path + (name,), e, cell_name, out)
        else:
            _flax_paths(child, f"{tname}.", path + (name,), stack, cell_name, out)


def flax_paths(module: nn.Module, remat: bool) -> dict[str, tuple[tuple, int | None]]:
    """``state_dict key -> (flax path, index on the stacked edge axis or None)``."""
    out: dict = {}
    _flax_paths(module, "", (), None, "CheckpointCell" if remat else "Cell", out)
    return out


def state_dict_from_flax(tree: Any, module: nn.Module) -> dict[str, torch.Tensor]:
    """The port's state dict for ``module`` (a :class:`DartsNetwork`, or any
    of its parts) from the flax tree of its JAX counterpart.

    ``tree`` is the flax variables (``{"params": ...}``) or the params alone.
    Raises if a parameter is missing, left over, or of another shape."""
    params = tree["params"] if "params" in tree else tree
    remat = any(k.startswith("CheckpointCell_") for k in params)
    mapping = flax_paths(module, remat)
    own = dict(module.named_parameters())
    result, used = {}, set()
    for key, (path, stack) in mapping.items():
        node = params
        for part in path:
            if part not in node:
                raise KeyError(f"flax tree has no {'/'.join(path)} (for {key})")
            node = node[part]
        used.add(path)
        leaf = np.asarray(node, dtype=np.float32)
        if stack is not None:
            leaf = leaf[stack]
        if leaf.shape != tuple(own[key].shape):
            raise ValueError(
                f"{key}: flax {'/'.join(path)} has shape {leaf.shape}, "
                f"port expects {tuple(own[key].shape)}"
            )
        result[key] = torch.from_numpy(leaf.copy())
    leftover = sorted("/".join(p) for p in _leaf_paths(params) if p not in used)
    if leftover:
        raise KeyError(f"flax parameters with no port counterpart: {leftover[:5]}")
    return result


def _leaf_paths(tree: dict, path: tuple = ()) -> Iterator[tuple]:
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaf_paths(v, path + (k,))
        else:
            yield path + (k,)


def alphas_from_jax(alphas: Any) -> Alphas:
    """The port's :class:`Alphas` from the JAX package's (numpy-convertible)."""
    return Alphas(*(torch.from_numpy(np.array(a, dtype=np.float32)) for a in alphas))
