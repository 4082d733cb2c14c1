"""DARTS augment phase: train the discovered genotype as a fixed network
(port of ``katib_tpu/nas/darts/augment.py``).

:class:`GenotypeNetwork` builds a discrete cell network from a
:class:`~katib_tpu_torch.nas.darts.model.Genotype`: each node is the sum of
its two kept ops, no mixed op and no alphas.  It shares the supernet's
macro skeleton (``model.macro_layout``) and primitive factory
(``ops.build_op``), so the genotype trains on the op implementations that
were scored during the search, and its modules are created in the flax
network's order, so ``convert.state_dict_from_flax`` carries its weights
across.  :func:`train_genotype` trains it with ``train_classifier``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from katib_tpu_torch.models.layers import Dense
from katib_tpu_torch.nas.darts.model import Genotype, macro_layout
from katib_tpu_torch.nas.darts.ops import FactorizedReduce, ReluConvBn, batch_norm, build_op
from katib_tpu_torch.ops.depthwise import Conv


class GenotypeCell(nn.Module):
    """One discrete cell: per node, the genotype's kept ``(op, src)`` edges
    applied and summed; the output concatenates the nodes' states."""

    def __init__(self, gene: Sequence[Sequence[tuple]], in_pp: int, in_p: int, channels: int,
                 reduction: bool = False, reduction_prev: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.gene = tuple(tuple((str(op), int(src)) for op, src in node) for node in gene)
        if reduction_prev:
            self.preprocess0 = FactorizedReduce(in_pp, channels, dtype=dtype)
        else:
            self.preprocess0 = ReluConvBn(in_pp, channels, dtype=dtype)
        self.preprocess1 = ReluConvBn(in_p, channels, dtype=dtype)
        # cell inputs shrink spatially in reduction cells; states made inside
        # the cell are already reduced
        self.ops = nn.ModuleList(
            build_op(op, channels, 2 if reduction and src < 2 else 1, dtype)
            for node in self.gene for op, src in node
        )

    def forward(self, s0, s1):
        states = [self.preprocess0(s0), self.preprocess1(s1)]
        ops = iter(self.ops)
        for node in self.gene:
            total = None
            for _, src in node:
                out = next(ops)(states[src])
                total = out if total is None else total + out
            states.append(total)
        return torch.cat(states[2:], dim=1)


class GenotypeNetwork(nn.Module):
    """Discrete-architecture classifier on NHWC images: stem conv + BN, the
    genotype's cells with reductions at 1/3 and 2/3 depth, global average
    pool, float32 classifier head."""

    def __init__(self, genotype: Genotype, init_channels: int = 16, num_layers: int = 8,
                 num_classes: int = 10, stem_multiplier: int = 3, in_channels: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c_cur, layers, c_out = macro_layout(
            init_channels, num_layers, stem_multiplier,
            lambda c: len(genotype.normal) * c,
        )
        self.stem = Conv(in_channels, c_cur, 3, dtype=dtype)
        self.cells = nn.ModuleList(
            GenotypeCell(genotype.reduce if reduction else genotype.normal, c_pp, c_p, c,
                         reduction, reduction_prev, dtype)
            for c_pp, c_p, c, reduction, reduction_prev in layers
        )
        self.classifier = Dense(c_out, num_classes, dtype=torch.float32)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Draw every weight anew from ``generator``, module by module."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x):
        x = self.stem(x.permute(0, 3, 1, 2))
        s0 = s1 = batch_norm(x)
        for cell in self.cells:
            s0, s1 = s1, cell(s0, s1)
        return self.classifier(s1.mean(dim=(2, 3)))


def train_genotype(
    genotype: Genotype,
    dataset,
    *,
    init_channels: int = 16,
    num_layers: int = 8,
    stem_multiplier: int = 3,
    lr: float = 0.025,
    epochs: int = 10,
    batch_size: int = 96,
    mesh=None,
    report=None,
    data_augment: bool = False,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> float:
    """Train the discrete network with momentum SGD; returns the final
    held-out accuracy.  Weights are drawn from a generator seeded with
    ``seed``.  ``data_augment``: the reference's crop + flip + cutout
    (``models/augmentation.py``)."""
    from katib_tpu_torch.models.mnist import train_classifier

    net = GenotypeNetwork(genotype, init_channels=init_channels, num_layers=num_layers,
                          num_classes=dataset.num_classes, stem_multiplier=stem_multiplier,
                          in_channels=dataset.input_shape[-1])
    net.reset_parameters(torch.Generator().manual_seed(seed))
    augment_fn = None
    if data_augment:
        from katib_tpu_torch.models.augmentation import cifar_train_augment

        augment_fn = cifar_train_augment
    return train_classifier(net, dataset, lr=lr, epochs=epochs, batch_size=batch_size,
                            optimizer="momentum", mesh=mesh, seed=seed, report=report,
                            augment_fn=augment_fn, device=device)
