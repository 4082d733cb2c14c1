"""Depthwise and pointwise convolutions of the NAS cells (port of
``katib_tpu/ops/depthwise.py``).

Parameters keep the JAX package's layouts, so weights carry across as they
are: :class:`DepthwiseConv` a ``(K, K, 1, C)`` kernel, :class:`PointwiseConv`
a ``(C, F)`` kernel.  Activations are NCHW.  The depthwise convolution has
one form, the native grouped convolution.  The JAX package's shift-MAC form
(``safe=True``) works around XLA's SPMD partitioner, which miscompiles the
grouped form's filter gradient on meshes with a model axis; each replica of
a mesh in the port runs its convolution locally, so the port has no such
partitioner and a ``safe``/``safe_conv`` setting runs the native form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def lecun_normal_(param: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal (±2 std) of variance 1/fan_in."""
    # 0.8796... is the std of a standard normal truncated to [-2, 2]
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(param, 0.0, std, -2 * std, 2 * std, generator=generator)


def same_padding(size: int, kernel: int, stride: int, dilation: int = 1) -> tuple[int, int]:
    """(lo, hi) padding of one spatial dim under XLA's ``"SAME"`` rule.

    Stride 2 on an even size pads (0, 1), not (1, 1): a symmetric
    ``F.conv2d(padding=...)`` would shift every output pixel."""
    extent = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + extent - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int, dilation: int = 1, value: float = 0.0):
    """Pad NCHW ``x`` so a VALID window op reproduces ``"SAME"``."""
    top, bottom = same_padding(x.shape[2], kernel, stride, dilation)
    left, right = same_padding(x.shape[3], kernel, stride, dilation)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def _kernel_oihw(kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # HWIO -> OIHW with the cast in the same copy
    return kernel.permute(3, 2, 0, 1).to(dtype, memory_format=torch.contiguous_format)


class Conv(nn.Module):
    """``nn.Conv(F, (K, K), strides=s, padding="SAME", use_bias=False)``:
    the HWIO ``(K, K, C, F)`` kernel of flax, computed in ``dtype``."""

    def __init__(self, in_channels: int, features: int, kernel: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.k, self.stride, self.dtype = kernel, stride, dtype
        self.kernel = nn.Parameter(torch.empty(kernel, kernel, in_channels, features))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.kernel, self.k * self.k * self.kernel.shape[2], generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pad_same(x.to(self.dtype), self.k, self.stride)
        return F.conv2d(x, _kernel_oihw(self.kernel, self.dtype), stride=self.stride)


class DepthwiseConv(nn.Module):
    """Per-channel KxK conv with SAME padding and dilation; kernel (K, K, 1, C)."""

    def __init__(self, channels: int, kernel: int, stride: int = 1, dilation: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.k, self.stride, self.dilation, self.dtype = kernel, stride, dilation, dtype
        self.kernel = nn.Parameter(torch.empty(kernel, kernel, 1, channels))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.kernel, self.k * self.k, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pad_same(x.to(self.dtype), self.k, self.stride, self.dilation)
        return F.conv2d(
            x, _kernel_oihw(self.kernel, self.dtype), stride=self.stride,
            dilation=self.dilation, groups=x.shape[1],
        )


class PointwiseConv(nn.Module):
    """1x1 conv with stride ``s``: subsample, then a per-pixel matmul with the
    ``(C, F)`` kernel (plus an optional bias)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 use_bias: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.kernel = nn.Parameter(torch.empty(in_channels, features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride > 1:
            x = x[:, :, :: self.stride, :: self.stride]
        weight = self.kernel.t().to(self.dtype, memory_format=torch.contiguous_format)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), weight[:, :, None, None], bias)
