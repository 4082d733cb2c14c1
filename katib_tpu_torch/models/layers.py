"""Counterparts of the flax layers the trial models use (``nn.Dense``,
``nn.LayerNorm``, ``nn.Embed``): the same parameter names, layouts and
default initializers, float32 parameters computed in a ``dtype`` at use,
so weights carry across from flax as they are (``katib_tpu_torch.convert``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from katib_tpu_torch.ops.depthwise import lecun_normal_


class Dense(nn.Module):
    """flax ``nn.Dense``: kernel ``(in, out)``, optional bias, computed in
    ``dtype``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.kernel.to(self.dtype).t(), bias)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: eps 1e-6, float32 statistics, output in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16, eps: float = 1e-6):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        y = F.layer_norm(x.float(), self.scale.shape, self.scale, self.bias, self.eps)
        return y.to(self.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``: table ``(num, features)`` drawn from a normal of
    variance 1/features, looked up in ``dtype``."""

    def __init__(self, num_embeddings: int, features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.embedding.normal_(0.0, self.embedding.shape[1] ** -0.5, generator=generator)

    def forward(self, idx):
        return F.embedding(idx, self.embedding).to(self.dtype)
