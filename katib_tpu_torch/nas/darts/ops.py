"""DARTS primitive operations as PyTorch modules (port of
``katib_tpu/nas/darts/ops.py``).

Activations are NCHW; compute runs in ``dtype`` (bfloat16 by default) with
float32 normalization statistics.  Batch normalization is stateless
training-mode BN without affine parameters, as in the JAX package: DARTS
search never consumes running statistics, so the supernet stays a pure
function of its weights and alphas.  On a mesh its statistics are those of
the global batch, as under the JAX package's partitioner (:func:`batch_norm`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from katib_tpu_torch.nas.darts.fused import FUSED_PRIMITIVES, FusedSepDil
from katib_tpu_torch.ops.depthwise import Conv, DepthwiseConv, PointwiseConv, pad_same
from katib_tpu_torch.ops.mixed_op import mixed_op_sum
from katib_tpu_torch.parallel import collectives
from katib_tpu_torch.parallel.mesh import DATA_AXIS

DEFAULT_PRIMITIVES = (
    "none",
    "max_pooling_3x3",
    "avg_pooling_3x3",
    "skip_connection",
    "separable_convolution_3x3",
    "separable_convolution_5x5",
    "dilated_convolution_3x3",
    "dilated_convolution_5x5",
)


def batch_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Training-mode BN over (N, H, W), no affine, stateless: f32 statistics
    with the population variance, returned in ``x``'s dtype (one fused
    operator forward and backward).

    Inside a replica of a mesh whose data axis splits the batch, the
    statistics are those of the global batch, as the JAX package's
    ``jnp.mean`` over a batch sharded on ``data`` gives them: at a
    rendezvous of the replicas (``parallel/collectives.py::exchange``) the
    per-channel float32 means and variances of their chunks are combined
    over ``data`` (:class:`_GlobalStats`, one autograd node over every
    replica's chunk), and each replica normalizes its own (:class:`_Normalize`).
    Autograd carries the backward: each replica's gradient of the
    statistics meets the others' in the combining node, which hands every
    chunk its part."""
    replica = collectives.current_replica()
    if replica is None or replica.mesh.axis_size(DATA_AXIS) == 1:
        return F.batch_norm(x, None, None, training=True, eps=eps)
    mesh = replica.mesh
    mean, invstd = collectives.exchange(x, lambda xs: _global_stats(xs, mesh, eps))
    return _Normalize.apply(x, mean, invstd)


_CHANNEL = (1, -1, 1, 1)
_DIMS = (0, 2, 3)


def _global_stats(xs: list, mesh, eps: float) -> list:
    """``(mean, invstd)`` of each entry's data group, on the entry's device."""
    out: list = [None] * mesh.size
    for group in mesh.groups(DATA_AXIS):
        stats = _GlobalStats.apply(eps, *(xs[i] for i in group))
        for k, i in enumerate(group):
            out[i] = (stats[2 * k], stats[2 * k + 1])
    return out


class _GlobalStats(torch.autograd.Function):
    """The global ``(mean, invstd)`` of the chunks ``xs`` (one data group),
    returned once per chunk on its device.  Backward: from the summed
    cotangents ``G_mean``, ``G_invstd``, each chunk's part
    ``G_mean / N - G_invstd * invstd^3 * (x - mean) / N``.  On CUDA the
    statistics are ``batch_norm_stats`` per chunk and one
    ``batch_norm_gather_stats_with_counts`` (SyncBatchNorm's kernels); on
    the CPU the same combination in float32 operations."""

    @staticmethod
    def forward(ctx, eps, *xs):
        home = xs[0].device
        counts = [x.numel() // x.shape[1] for x in xs]
        if all(x.is_cuda for x in xs):
            stats = [torch.batch_norm_stats(x, eps) for x in xs]
            mean, invstd = torch.batch_norm_gather_stats_with_counts(
                xs[0], torch.stack([m.to(home) for m, _ in stats]),
                torch.stack([v.to(home) for _, v in stats]), None, None, 0.0, eps,
                # in the input's dtype, as the kernel takes them: the chunks
                # are equal, so no rounding can weigh one above another
                torch.tensor(counts, dtype=xs[0].dtype, device=home))
        else:
            total = sum(counts)
            mean = ex2 = 0.0
            for x, n in zip(xs, counts):
                var, m = (t.to(home) for t in torch.var_mean(x.float(), dim=_DIMS, correction=0))
                mean = mean + m * (n / total)
                ex2 = ex2 + (var + m * m) * (n / total)
            invstd = torch.rsqrt(torch.clamp(ex2 - mean * mean, min=0.0) + eps)
        ctx.save_for_backward(mean, invstd, *xs)
        ctx.total = sum(counts)
        return tuple(t.to(x.device) for x in xs for t in (mean, invstd))

    @staticmethod
    def backward(ctx, *grads):
        mean, invstd, *xs = ctx.saved_tensors
        home = mean.device
        g_mean = sum(g.to(home) for g in grads[0::2])
        g_invstd = sum(g.to(home) for g in grads[1::2])
        c1 = -g_invstd * invstd.pow(3) / ctx.total
        c0 = g_mean / ctx.total - c1 * mean
        dxs = []
        for x in xs:
            a, b = c1.to(x.device), c0.to(x.device)
            if x.is_cuda:  # a * x + b in one kernel, in x's dtype
                dxs.append(torch.batch_norm_elemt(x, a, b, torch.zeros_like(a),
                                                  torch.ones_like(a), 0.0))
            else:
                dxs.append((a.view(_CHANNEL) * x.float() + b.view(_CHANNEL)).to(x.dtype))
        return (None, *dxs)


class _Normalize(torch.autograd.Function):
    """``(x - mean) * invstd`` per channel, in ``x``'s dtype.  Backward:
    ``x``'s direct part ``dy * invstd``, and the statistics' cotangents
    ``-invstd * sum(dy)`` and ``sum(dy * (x - mean))``."""

    @staticmethod
    def forward(ctx, x, mean, invstd):
        ctx.save_for_backward(x, mean, invstd)
        if x.is_cuda:
            return torch.batch_norm_elemt(x, None, None, mean, invstd, 0.0)
        return ((x.float() - mean.view(_CHANNEL)) * invstd.view(_CHANNEL)).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, mean, invstd = ctx.saved_tensors
        dy = dy.contiguous()
        if x.is_cuda:
            sum_dy, sum_dy_xmu, _, _ = torch.batch_norm_backward_reduce(
                dy, x, mean, invstd, None, True, False, False)
            dx = torch.batch_norm_elemt(dy, None, None, torch.zeros_like(mean), invstd, 0.0)
        else:
            dy32 = dy.float()
            sum_dy = dy32.sum(dim=_DIMS)
            sum_dy_xmu = (dy32 * (x.float() - mean.view(_CHANNEL))).sum(dim=_DIMS)
            dx = (dy32 * invstd.view(_CHANNEL)).to(x.dtype)
        return dx, -invstd * sum_dy, sum_dy_xmu


class ReluConvBn(nn.Module):
    def __init__(self, in_channels: int, channels: int, kernel: int = 1, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if kernel == 1:
            self.conv = PointwiseConv(in_channels, channels, stride=stride, dtype=dtype)
        else:
            self.conv = Conv(in_channels, channels, kernel, stride=stride, dtype=dtype)

    def forward(self, x):
        return batch_norm(self.conv(F.relu(x)))


class SepConv(nn.Module):
    """Depthwise-separable conv applied twice (the reference stacks two)."""

    def __init__(self, channels: int, kernel: int, stride: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.depthwise = nn.ModuleList()
        self.pointwise = nn.ModuleList()
        for s in (stride, 1):
            self.depthwise.append(DepthwiseConv(channels, kernel, stride=s, dtype=dtype))
            self.pointwise.append(PointwiseConv(channels, channels, dtype=dtype))

    def forward(self, x):
        for dw, pw in zip(self.depthwise, self.pointwise):
            x = batch_norm(pw(dw(F.relu(x))))
        return x


class DilConv(nn.Module):
    """Dilated depthwise-separable conv (3x3 d2 -> rf 5x5; 5x5 d2 -> rf 9x9)."""

    def __init__(self, channels: int, kernel: int, stride: int, dilation: int = 2,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.depthwise = DepthwiseConv(channels, kernel, stride=stride, dilation=dilation,
                                       dtype=dtype)
        self.pointwise = PointwiseConv(channels, channels, dtype=dtype)

    def forward(self, x):
        return batch_norm(self.pointwise(self.depthwise(F.relu(x))))


class FactorizedReduce(nn.Module):
    """Stride-2 spatial reduction through two offset 1x1 convs."""

    def __init__(self, in_channels: int, channels: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv_a = PointwiseConv(in_channels, channels // 2, stride=2, dtype=dtype)
        self.conv_b = PointwiseConv(in_channels, channels // 2, stride=2, dtype=dtype)

    def forward(self, x):
        x = F.relu(x)
        a = self.conv_a(x)
        b = self.conv_b(x[:, :, 1:, 1:])
        # pad b back to a's spatial shape (off-by-one from the shifted slice)
        b = F.pad(b, (0, a.shape[3] - b.shape[3], 0, a.shape[2] - b.shape[2]))
        return batch_norm(torch.cat([a, b], dim=1))


class Pool(nn.Module):
    """3x3 pooling with SAME padding: the average counts the zero padding
    (flax ``avg_pool``), the max pads with -inf."""

    def __init__(self, kind: str, stride: int):
        super().__init__()
        if kind not in ("avg", "max"):
            raise ValueError(f"pool kind must be 'avg' or 'max', got {kind!r}")
        self.kind, self.stride = kind, stride

    def forward(self, x):
        if self.kind == "avg":
            out = F.avg_pool2d(pad_same(x, 3, self.stride), 3, self.stride)
        else:
            out = F.max_pool2d(pad_same(x, 3, self.stride, value=float("-inf")), 3, self.stride)
        return batch_norm(out)


class Zero(nn.Module):
    def __init__(self, stride: int):
        super().__init__()
        self.stride = stride

    def forward(self, x):
        if self.stride == 1:
            return torch.zeros_like(x)
        return torch.zeros_like(x[:, :, :: self.stride, :: self.stride])


class SkipConnect(nn.Module):
    def __init__(self, channels: int, stride: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.reduce = FactorizedReduce(channels, channels, dtype=dtype) if stride != 1 else None

    def forward(self, x):
        return x if self.reduce is None else self.reduce(x)


def build_op(name: str, channels: int, stride: int, dtype=torch.bfloat16) -> nn.Module:
    """Primitive factory (reference ``OPS`` table, ``operations.py:18``)."""
    table = {
        "none": lambda: Zero(stride),
        "avg_pooling_3x3": lambda: Pool("avg", stride),
        "max_pooling_3x3": lambda: Pool("max", stride),
        "skip_connection": lambda: SkipConnect(channels, stride, dtype=dtype),
        "separable_convolution_3x3": lambda: SepConv(channels, 3, stride, dtype=dtype),
        "separable_convolution_5x5": lambda: SepConv(channels, 5, stride, dtype=dtype),
        "dilated_convolution_3x3": lambda: DilConv(channels, 3, stride, dtype=dtype),
        "dilated_convolution_5x5": lambda: DilConv(channels, 5, stride, dtype=dtype),
    }
    if name not in table:
        raise ValueError(f"unknown primitive {name!r}; known: {sorted(table)}")
    return table[name]()


class MixedOp(nn.Module):
    """Continuous relaxation of one edge: softmax-weighted sum of primitives.

    ``fused=True`` evaluates the four depthwise-separable primitives through
    :class:`~katib_tpu_torch.nas.darts.fused.FusedSepDil` (2 masked depthwise
    + 2 batched-pointwise launches instead of 6 + 6) when all four are in
    the primitive set, as the JAX package does; the other primitives keep
    their own modules.  Same math, another evaluation plan and another
    parameter tree (``fused`` before ``ops``, as flax creates them)."""

    def __init__(self, primitives: Sequence[str], channels: int, stride: int,
                 dtype: torch.dtype = torch.bfloat16, fused: bool = False):
        super().__init__()
        self.primitives = tuple(primitives)
        self.fused = None
        if fused and set(FUSED_PRIMITIVES) <= set(self.primitives):
            self.fused = FusedSepDil(channels, stride, dtype=dtype)
        self.ops = nn.ModuleList(
            build_op(p, channels, stride, dtype) for p in self.primitives
            if self.fused is None or p not in FUSED_PRIMITIVES
        )

    def branches(self, x) -> list[torch.Tensor]:
        """Every primitive's output on ``x``, in primitive order."""
        fused_outs = self.fused(x) if self.fused is not None else {}
        ops = iter(self.ops)
        return [fused_outs[p] if p in fused_outs else next(ops)(x) for p in self.primitives]

    def forward(self, x, weights):
        # weights: (n_ops,) softmax over this edge's alphas
        outs = self.branches(x)
        stacked = torch.stack(outs).reshape(1, len(outs), -1)
        return mixed_op_sum(weights.reshape(1, -1), stacked).reshape(outs[0].shape)


class EdgeGroup(nn.Module):
    """The incoming edges of one node that share a stride: one MixedOp per
    edge (so batch-norm statistics stay per edge) and ONE kernel launch for
    the whole group, which returns the sum over its edges.  The JAX cell
    runs the same group as one ``nn.vmap``-ed MixedOp.  ``fused``: each
    edge's mixed op runs the fused plan; the group still makes one
    launch."""

    def __init__(self, n_edges: int, primitives: Sequence[str], channels: int, stride: int,
                 dtype: torch.dtype = torch.bfloat16, fused: bool = False):
        super().__init__()
        self.edges = nn.ModuleList(
            MixedOp(primitives, channels, stride, dtype, fused=fused) for _ in range(n_edges)
        )

    def forward(self, states: Sequence[torch.Tensor], w_rows: torch.Tensor) -> torch.Tensor:
        # states: one (N, C, H, W) input per edge; w_rows: (n_edges, n_ops)
        outs = [o for edge, s in zip(self.edges, states, strict=True) for o in edge.branches(s)]
        stacked = torch.stack(outs).reshape(len(self.edges), -1, outs[0].numel())
        return mixed_op_sum(w_rows, stacked).sum(dim=0).reshape(outs[0].shape)
