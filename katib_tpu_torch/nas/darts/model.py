"""DARTS supernet: cells of mixed ops with architecture parameters (port of
``katib_tpu/nas/darts/model.py``).

The network takes NHWC images, as the JAX ``DartsNetwork`` does, and
permutes them once to NCHW for cuDNN.  Architecture parameters (alphas) are
not module parameters: they are an explicit :class:`Alphas` argument, so the
bilevel step differentiates weights and alphas independently.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from katib_tpu_torch.models.layers import Dense
from katib_tpu_torch.nas.darts.ops import (
    DEFAULT_PRIMITIVES,
    EdgeGroup,
    FactorizedReduce,
    ReluConvBn,
    batch_norm,
)
from katib_tpu_torch.ops.depthwise import Conv


class Alphas(NamedTuple):
    """Architecture parameters: one row of op-logits per edge."""

    normal: torch.Tensor  # (n_edges, n_ops)
    reduce: torch.Tensor  # (n_edges, n_ops)


def n_edges(n_nodes: int) -> int:
    # node j has j+2 incoming edges (from 2 cell inputs + prior nodes)
    return sum(j + 2 for j in range(n_nodes))


def init_alphas(n_nodes: int, n_ops: int, generator: torch.Generator | None = None,
                scale: float = 1e-3, device=None) -> Alphas:
    k = n_edges(n_nodes)

    def draw():
        return scale * torch.randn(k, n_ops, generator=generator, device=device)

    return Alphas(normal=draw(), reduce=draw())


def _edge_groups(n_nodes: int, reduction: bool):
    """Per node, the (first_state, n_states, stride) of each edge group, in
    the order the JAX cell builds them."""
    plan = []
    for node in range(n_nodes):
        k = node + 2
        if reduction:
            # cell inputs reduce spatially (stride 2); intermediate states
            # are already reduced (stride 1)
            plan.append([(0, 2, 2)] + ([(2, k - 2, 1)] if k > 2 else []))
        else:
            plan.append([(0, k, 1)])
    return plan


class Cell(nn.Module):
    """One DARTS cell: nodes connected by mixed ops; output = channel-concat
    of the intermediate nodes.  Each edge group is one mixed-op launch."""

    def __init__(self, primitives: Sequence[str], in_pp: int, in_p: int, channels: int,
                 n_nodes: int = 4, reduction: bool = False, reduction_prev: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.n_nodes, self.reduction = n_nodes, reduction
        if reduction_prev:
            self.preprocess0 = FactorizedReduce(in_pp, channels, dtype=dtype)
        else:
            self.preprocess0 = ReluConvBn(in_pp, channels, dtype=dtype)
        self.preprocess1 = ReluConvBn(in_p, channels, dtype=dtype)
        self.plan = _edge_groups(n_nodes, reduction)
        self.groups = nn.ModuleList(
            EdgeGroup(count, primitives, channels, stride, dtype)
            for node_groups in self.plan
            for _, count, stride in node_groups
        )

    def forward(self, s0, s1, weights):
        # weights: (n_edges, n_ops) softmaxed alphas for this cell type
        states = [self.preprocess0(s0), self.preprocess1(s1)]
        groups = iter(self.groups)
        offset = 0
        for node_groups in self.plan:
            total = None
            for first, count, _ in node_groups:
                rows = weights[offset + first : offset + first + count]
                out = next(groups)(states[first : first + count], rows)
                total = out if total is None else total + out
            offset += len(states)
            states.append(total)
        return torch.cat(states[2:], dim=1)


def mixed_op_launches_per_forward(num_layers: int, n_nodes: int) -> int:
    """Mixed-op kernel launches in one forward pass of :class:`DartsNetwork`."""
    reductions = len(_reduction_layers(num_layers))
    per_cell = {r: sum(len(g) for g in _edge_groups(n_nodes, r)) for r in (False, True)}
    return (num_layers - reductions) * per_cell[False] + reductions * per_cell[True]


def _reduction_layers(num_layers: int) -> set[int]:
    return {num_layers // 3, 2 * num_layers // 3} if num_layers > 2 else set()


class DartsNetwork(nn.Module):
    """Supernet (reference ``model.py:74`` NetworkCNN): stem conv + BN, cells
    with channel-doubling reductions at 1/3 and 2/3 depth, global average
    pool, float32 classifier head.

    ``remat=True`` recomputes each cell in the backward pass
    (``torch.utils.checkpoint``) instead of keeping its activations."""

    def __init__(self, primitives: Sequence[str] = DEFAULT_PRIMITIVES, init_channels: int = 16,
                 num_layers: int = 8, n_nodes: int = 4, num_classes: int = 10,
                 stem_multiplier: int = 3, in_channels: int = 3, remat: bool = True,
                 remat_policy: str | None = None, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if remat_policy is not None:
            if remat_policy == "dots":
                raise NotImplementedError(
                    'remat_policy="dots" (selective checkpointing that keeps conv '
                    "and matmul outputs) is not ported yet; see ROADMAP.md"
                )
            raise ValueError(
                f"unknown remat_policy {remat_policy!r}; expected 'dots' or None"
            )
        self.remat, self.dtype = remat, dtype
        c_cur = init_channels * stem_multiplier
        self.stem = Conv(in_channels, c_cur, 3, dtype=dtype)
        c_pp, c_p, c = c_cur, c_cur, init_channels
        reduction_prev = False
        reductions = _reduction_layers(num_layers)
        self.cells = nn.ModuleList()
        for layer in range(num_layers):
            reduction = layer in reductions
            if reduction:
                c *= 2
            self.cells.append(Cell(primitives, c_pp, c_p, c, n_nodes, reduction,
                                   reduction_prev, dtype))
            c_pp, c_p = c_p, n_nodes * c
            reduction_prev = reduction
        self.classifier = Dense(c_p, num_classes, dtype=torch.float32)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Draw every weight anew from ``generator``, module by module."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x, alphas: Alphas):
        w_normal = torch.softmax(alphas.normal.float(), dim=-1)
        w_reduce = torch.softmax(alphas.reduce.float(), dim=-1)
        x = self.stem(x.permute(0, 3, 1, 2))
        s0 = s1 = batch_norm(x)
        for cell in self.cells:
            weights = w_reduce if cell.reduction else w_normal
            if self.remat:
                # hand the cell's (possibly functional_call-swapped) parameters
                # to the recompute explicitly: the backward pass re-runs the
                # cell after any outer parameter swap has been undone
                params = dict(cell.named_parameters())
                out = checkpoint(_call_cell, cell, params, s0, s1, weights,
                                 use_reentrant=False)
            else:
                out = cell(s0, s1, weights)
            s0, s1 = s1, out
        return self.classifier(s1.mean(dim=(2, 3)))  # global average pool


def _call_cell(cell, params, s0, s1, weights):
    return torch.func.functional_call(cell, params, (s0, s1, weights))


# ---------------------------------------------------------------------------
# Genotype extraction (reference ``model.py:187``)
# ---------------------------------------------------------------------------


class Genotype(NamedTuple):
    normal: list
    reduce: list

    def render(self) -> str:
        return f"Genotype(normal={self.normal}, reduce={self.reduce})"


def extract_genotype(alphas: Alphas, primitives: Sequence[str], n_nodes: int = 4) -> Genotype:
    """Discretize: per node keep the top-2 incoming edges ranked by their
    strongest non-'none' op weight; each kept edge uses that op."""

    def parse(matrix) -> list:
        weights = torch.softmax(torch.as_tensor(matrix).float().cpu(), dim=-1).numpy()
        try:
            none_idx = list(primitives).index("none")
        except ValueError:
            none_idx = None
        gene = []
        offset = 0
        for node in range(n_nodes):
            k = node + 2
            edges = weights[offset : offset + k]
            scores = []
            for e in range(k):
                row = edges[e].copy()
                if none_idx is not None:
                    row[none_idx] = -np.inf
                best_op = int(np.argmax(row))
                scores.append((float(row[best_op]), e, best_op))
            scores.sort(reverse=True)
            gene.append(
                [(primitives[op], edge) for _, edge, op in sorted(scores[:2], key=lambda t: t[1])]
            )
            offset += k
        return gene

    return Genotype(normal=parse(alphas.normal), reduce=parse(alphas.reduce))
