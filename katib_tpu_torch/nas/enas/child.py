"""ENAS child network: a CNN built from a sampled architecture (port of
``katib_tpu/nas/enas/child.py``).

One operation per layer (conv 3x3/5x5, separable conv, avg/max pool) plus
skip connections that concatenate earlier layers' outputs, as the flax
modules build it: every ``nn.Conv`` has a bias (weight ``OIHW`` here, the
flax ``HWIO`` kernel permuted), the depthwise convolution is
``ops/depthwise.py``'s ``DepthwiseConv`` (no bias, the flax layout), the
convolutions use SAME padding, the 3x3 pools are stride 1 with SAME padding
(the average counts the padded zeros, as flax's ``avg_pool`` does), and
after every ``pool_every``-th layer a 2x2 max pool (VALID) is applied to the
running output and to every stored one.  Convolutions, pools and the mean
run in ``dtype`` (bf16 by default); the Dense head runs in float32.

flax infers a layer's input width; here it is worked out from the arc when
the module is built: ``channels * (1 + number of skips)``.  Each op module
is registered as ``op{i}_{op_name}``, the flax module name, so that the
weight-sharing pool (``shared.py``) keeps one entry per (layer, op).
Activations are NCHW inside; the input is an NHWC batch, read through an
NCHW view as ``models/mnist.py``'s ``SmallCNN`` reads it.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from katib_tpu_torch.models.mnist import Linear
from katib_tpu_torch.nas.enas.controller import Arc
from katib_tpu_torch.ops.depthwise import DepthwiseConv, lecun_normal_, pad_same

# operation vocabulary (op_library.py); index = controller's op id
DEFAULT_OPERATIONS = (
    "convolution_3x3",
    "convolution_5x5",
    "separable_convolution_3x3",
    "separable_convolution_5x5",
    "avg_pooling_3x3",
    "max_pooling_3x3",
)


class ConvBias(nn.Module):
    """flax ``nn.Conv(features, (k, k), padding="SAME", dtype=dtype)`` at
    stride 1 (``k`` odd): weight ``OIHW``, bias, ``lecun_normal`` and zeros,
    computed in ``dtype``."""

    def __init__(self, in_channels: int, features: int, kernel: int, dtype: torch.dtype):
        super().__init__()
        self.k, self.dtype = kernel, dtype
        self.weight = nn.Parameter(torch.empty(features, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        lecun_normal_(self.weight, self.k * self.k * self.weight.shape[1], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype),
                        padding=self.k // 2)


def _kernel_size(name: str) -> int:
    """The filter size of ``convolution_5x5`` and the like (the first digit
    of the last ``_`` part, as the JAX package reads it)."""
    last = name.split("_")[-1]
    if not last[:1].isdigit():
        raise ValueError(f"unknown ENAS operation {name!r}")
    return int(last[0])


class _Op(nn.Module):
    """One layer's operation; ``conv`` is flax's ``Conv_0``, ``depthwise``
    its ``DepthwiseConv_0``."""

    def __init__(self, name_: str, in_channels: int, channels: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.name_, self.dtype = name_, dtype
        n = name_
        if n.startswith("convolution"):
            self.conv = ConvBias(in_channels, channels, _kernel_size(n), dtype)
        elif n.startswith("separable_convolution"):
            self.depthwise = DepthwiseConv(in_channels, _kernel_size(n), dtype=dtype)
            self.conv = ConvBias(in_channels, channels, 1, dtype)
        elif n.startswith(("avg_pooling", "max_pooling")):
            self.conv = ConvBias(in_channels, channels, 1, dtype)
        else:
            raise ValueError(f"unknown ENAS operation {n!r}")

    def forward(self, x):
        n = self.name_
        if n.startswith("convolution"):
            return F.relu(self.conv(x))
        if n.startswith("separable_convolution"):
            return F.relu(self.conv(self.depthwise(x)))
        if n.startswith("avg_pooling"):
            # zeros padded first, as the DARTS pools do: on the card,
            # avg_pool2d's own padding gives a wrong gradient on a
            # channels-last input (torch 2.11, CUDA 12.8)
            x = F.avg_pool2d(pad_same(x, 3, 1), 3, stride=1)
        else:
            x = F.max_pool2d(x, 3, stride=1, padding=1)
        return self.conv(x)


class EnasChild(nn.Module):
    """CNN instantiated from a controller arc: a 3x3 stem conv, one
    :class:`_Op` per layer over the concatenation of the running output and
    its skip inputs, a mean over the image and a float32 Dense head.
    ``safe_conv`` is the JAX package's setting for a mesh with a model axis;
    it changes nothing here, as the port's depthwise convolution has one
    form (``ops/depthwise.py``)."""

    def __init__(self, arc_ops: tuple, arc_skips: tuple,
                 operations: Sequence[str] = DEFAULT_OPERATIONS, channels: int = 32,
                 num_classes: int = 10, pool_every: int = 3,
                 dtype: torch.dtype = torch.bfloat16, safe_conv: bool = False,
                 in_channels: int = 3):
        super().__init__()
        self.arc_ops, self.arc_skips = tuple(arc_ops), tuple(arc_skips)
        self.operations, self.pool_every, self.dtype = tuple(operations), pool_every, dtype
        self.stem = ConvBias(in_channels, channels, 3, dtype)
        self.ops = []
        for layer, op_idx in enumerate(self.arc_ops):
            width = channels * (1 + sum(1 for s in self.arc_skips[layer] if s))
            name = self.operations[op_idx]
            op = _Op(name, width, channels, dtype)
            # op-qualified module name: weight-sharing pools key parameters
            # by name, and e.g. avg/max pooling have identically-shaped 1x1
            # projections, so the op name keeps each op's weights separate
            self.add_module(f"op{layer}_{name}", op)
            self.ops.append(op)
        self.head = Linear(channels, num_classes, torch.float32)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Draw every weight anew from ``generator``, module by module."""
        for m in self.modules():
            if isinstance(m, (ConvBias, DepthwiseConv, Linear)):
                m.reset_parameters(generator)

    def forward(self, x):
        x = self.stem(x.to(self.dtype).permute(0, 3, 1, 2))
        outputs = []
        for layer, op in enumerate(self.ops):
            used = [outputs[j] for j, s in enumerate(self.arc_skips[layer]) if s]
            inp = torch.cat([x, *used], dim=1) if used else x
            x = op(inp)
            outputs.append(x)
            if (layer + 1) % self.pool_every == 0:
                x = F.max_pool2d(x, 2, 2)
                # downsample stored outputs so later skip concats still align
                outputs = [F.max_pool2d(o, 2, 2) for o in outputs]
        x = torch.mean(x, dim=(2, 3))
        return self.head(x.float())


def child_from_arc(
    arc: Arc,
    operations: Sequence[str] = DEFAULT_OPERATIONS,
    channels: int = 32,
    num_classes: int = 10,
    safe_conv: bool = False,
    **kwargs,
) -> EnasChild:
    """The :class:`EnasChild` of ``arc``; ``kwargs`` (``dtype``,
    ``in_channels``, ``pool_every``) go to its constructor."""
    ops = tuple(int(o) for o in arc.ops.tolist())
    skips_all = arc.skips.tolist()
    skips = tuple(tuple(int(s) for s in skips_all[layer][:layer]) for layer in range(len(ops)))
    return EnasChild(arc_ops=ops, arc_skips=skips, operations=tuple(operations),
                     channels=channels, num_classes=num_classes, safe_conv=safe_conv, **kwargs)
