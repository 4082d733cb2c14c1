"""Carry weights from the JAX package's models into the port.

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
``Cell_<n>`` without it; both are accepted.  The augment phase's
``GenotypeNetwork`` follows the same rule (``Conv_0``, ``GenotypeCell_<n>``
holding the preprocessing modules and then the kept ops in node order,
``Dense_0``), so :func:`state_dict_from_flax` carries it across as well.

The transformer LM (:func:`transformer_state_dict_from_flax`) follows the
same rule with an explicit table, since its modules are named for reading.

The HP-tuning models (:func:`mnist_state_dict_from_flax`) keep PyTorch's
layouts instead: a Dense kernel ``(in, out)`` becomes a Linear weight
``[out, in]`` and a Conv kernel ``HWIO`` an ``OIHW`` weight.  ``SmallCNN``
flattens its last feature map in NHWC order, as flax does, so its first
Dense needs no permutation of rows.

The on-device PBT digits model (:func:`pbt_digits_params_from_jax`) keeps
the JAX layout (``w1`` ``(d_in, hidden)``, ``x @ w1``), so its parameters,
and a stacked population of them (:func:`pbt_digits_state_from_jax`),
carry over as they are.

The ENAS child (:func:`enas_state_dict_from_flax`) keeps PyTorch's layout
for its ``nn.Conv`` and ``nn.Dense`` layers, as the HP-tuning models do, and
the flax layout for ``DepthwiseConv``; its op modules carry flax's names
(``op{i}_{name}``).  The ENAS controller's weights carry over as they are
(:func:`enas_controller_from_jax`).
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Iterator

import numpy as np
import torch
from torch import nn

from katib_tpu_torch.models.mnist import Conv3x3, Linear
from katib_tpu_torch.nas.enas.child import ConvBias, EnasChild
from katib_tpu_torch.nas.enas.controller import ControllerParams
from katib_tpu_torch.nas.darts.model import Alphas, Cell
from katib_tpu_torch.nas.darts.ops import EdgeGroup
from katib_tpu_torch.parallel.train import TrainState


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
    """The port's state dict for ``module`` (a :class:`DartsNetwork` or a
    ``GenotypeNetwork``, or any of their parts) from the flax tree of its
    JAX counterpart.

    ``tree`` is the flax variables (``{"params": ...}``) or the params alone.
    Raises if a parameter is missing, left over, or of another shape."""
    params = tree["params"] if "params" in tree else tree
    remat = any(k.startswith("CheckpointCell_") for k in params)
    return _from_flax(params, flax_paths(module, remat), module)


def _from_flax(params: dict, mapping: dict, module: nn.Module,
               layout: dict | None = None) -> dict[str, torch.Tensor]:
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
        if layout and key in layout:
            leaf = leaf.transpose(layout[key])
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


# the transformer's module names -> flax's names, in flax's creation order
_BLOCK_NAMES = {"ln1": "LayerNorm_0", "qkv": "Dense_0", "proj": "Dense_1",
                "ln2": "LayerNorm_1", "fc1": "Dense_2", "fc2": "Dense_3"}
_LM_NAMES = {"tok_embed": "Embed_0", "pos_embed": "Embed_1", "ln_f": "LayerNorm_0",
             "head": "Dense_0"}


def transformer_flax_paths(model: nn.Module) -> dict[str, tuple[tuple, None]]:
    """``state_dict key -> (flax path, None)`` for a :class:`TransformerLM`."""
    out = {}
    for key, _ in model.named_parameters():
        parts = key.split(".")
        if parts[0] == "blocks":
            path = (f"Block_{parts[1]}", _BLOCK_NAMES[parts[2]], parts[3])
        else:
            path = (_LM_NAMES[parts[0]], parts[1])
        out[key] = (path, None)
    return out


def transformer_state_dict_from_flax(tree: Any, model: nn.Module) -> dict[str, torch.Tensor]:
    """The port's state dict for a :class:`TransformerLM` from the flax tree
    of the JAX ``TransformerLM`` (``Embed_0`` tokens, ``Embed_1`` positions,
    ``Block_<i>``, ``LayerNorm_0``, ``Dense_0``; inside a block
    ``LayerNorm_0``, ``Dense_0`` qkv, ``Dense_1`` out, ``LayerNorm_1``,
    ``Dense_2``, ``Dense_3``).  Dense kernels are ``(in, out)`` in both.

    ``tree`` is the flax variables (``{"params": ...}``) or the params alone.
    Raises if a parameter is missing, left over, or of another shape."""
    params = tree["params"] if "params" in tree else tree
    return _from_flax(params, transformer_flax_paths(model), model)


def mnist_state_dict_from_flax(tree: Any, model: nn.Module) -> dict[str, torch.Tensor]:
    """The port's state dict for an ``MLP`` or a ``SmallCNN``
    (``katib_tpu_torch.models.mnist``) from the flax tree of its JAX
    counterpart: ``Dense_<n>`` and ``Conv_<n>`` in creation order, each
    kernel transposed into PyTorch's layout.

    ``tree`` is the flax variables (``{"params": ...}``) or the params alone.
    Raises if a parameter is missing, left over, or of another shape."""
    params = tree["params"] if "params" in tree else tree
    mapping, layout = {}, {}
    counts: Counter = Counter()
    for name, child in model.named_modules():
        if isinstance(child, (Linear, Conv3x3)):
            cls = "Dense" if isinstance(child, Linear) else "Conv"
            flax_name = f"{cls}_{counts[cls]}"
            counts[cls] += 1
            mapping[f"{name}.weight"] = ((flax_name, "kernel"), None)
            mapping[f"{name}.bias"] = ((flax_name, "bias"), None)
            # (in, out) -> [out, in]; HWIO -> OIHW
            layout[f"{name}.weight"] = (1, 0) if cls == "Dense" else (3, 2, 0, 1)
    return _from_flax(params, mapping, model, layout)


def enas_state_dict_from_flax(tree: Any, model: EnasChild) -> dict[str, torch.Tensor]:
    """The port's state dict for an :class:`EnasChild` from the flax tree of
    the JAX ``EnasChild`` of the same arc: the stem ``Conv_0``, each
    ``op{i}_{name}/{Conv_0,DepthwiseConv_0}`` and ``Dense_0``, conv kernels
    ``HWIO`` to ``OIHW`` and the Dense kernel ``(in, out)`` to ``[out, in]``.

    ``tree`` is the flax variables (``{"params": ...}``) or the params alone.
    Raises if a parameter is missing, left over, or of another shape."""
    params = tree["params"] if "params" in tree else tree
    mapping, layout = {}, {}
    for name, child in model.named_modules():
        if isinstance(child, (ConvBias, Linear)):
            parts = name.split(".")
            if isinstance(child, Linear):
                path, order = ("Dense_0",), (1, 0)
            elif parts == ["stem"]:
                path, order = ("Conv_0",), (3, 2, 0, 1)
            else:
                path, order = (parts[0], "Conv_0"), (3, 2, 0, 1)
            mapping[f"{name}.weight"] = (path + ("kernel",), None)
            mapping[f"{name}.bias"] = (path + ("bias",), None)
            layout[f"{name}.weight"] = order
        elif name.endswith(".depthwise"):
            mapping[f"{name}.kernel"] = ((name.split(".")[0], "DepthwiseConv_0", "kernel"), None)
    return _from_flax(params, mapping, model, layout)


def enas_controller_from_jax(params: Any) -> ControllerParams:
    """The port's :class:`ControllerParams` (CPU, float32) from the JAX
    package's (numpy-convertible), field by field."""
    return ControllerParams(*(torch.from_numpy(np.array(getattr(params, f), dtype=np.float32))
                              for f in ControllerParams._fields))


def _leaf_paths(tree: dict, path: tuple = ()) -> Iterator[tuple]:
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaf_paths(v, path + (k,))
        else:
            yield path + (k,)


def alphas_from_jax(alphas: Any) -> Alphas:
    """The port's :class:`Alphas` from the JAX package's (numpy-convertible)."""
    return Alphas(*(torch.from_numpy(np.array(a, dtype=np.float32)) for a in alphas))


def pbt_digits_params_from_jax(params: Any) -> dict[str, torch.Tensor]:
    """The port's ``models/pbt_digits.py`` parameters (CPU, float32) from the
    JAX package's ``{w1, b1, w2, b2}`` (numpy-convertible, with or without a
    leading member axis).  Raises if a name is missing or left over."""
    names = ("w1", "b1", "w2", "b2")
    if sorted(params) != sorted(names):
        raise ValueError(f"pbt_digits parameters are {names}, got {sorted(params)}")
    return {k: torch.from_numpy(np.array(params[k], dtype=np.float32)) for k in names}


def pbt_digits_state_from_jax(state: Any) -> TrainState:
    """A stacked on-device PBT population of the JAX package
    (``{"params", "velocity", "step"}``, each ``[K, ...]``) as the port's
    stacked :class:`TrainState`: the step counter (int32), the parameters,
    and the momentum trace as the optimizer state."""
    return TrainState(torch.from_numpy(np.array(state["step"], dtype=np.int32)),
                      pbt_digits_params_from_jax(state["params"]),
                      pbt_digits_params_from_jax(state["velocity"]))
