"""The classifier trainer of the HP-tuning trial (port of the part of
``katib_tpu/models/mnist.py`` that the DARTS augment phase uses):
:func:`train_classifier`, the momentum optimizer with its learning rate
and momentum as runtime state (``_family_optimizer("momentum")`` and
``_set_hyperparams``).

Each epoch draws one permutation from a numpy generator seeded with the
run's seed, as the JAX trainer does on both of its data paths, and runs one
eager step per batch, gathered from the train split held on the device (or,
with ``device_data`` off, on the host); losses are fetched once per epoch.  The MLP and CNN
models, the other optimizers, ``mnist_trial``, cohorts, meshes and the
CUDA-graph epoch are the HP-tuning slice (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from katib_tpu_torch.device import resolve_device
from katib_tpu_torch.models.augmentation import KEY_OFFSET
from katib_tpu_torch.models.data import Dataset
from katib_tpu_torch.utils.booleans import parse_bool
from katib_tpu_torch.parallel.train import (
    TrainState,
    accuracy,
    cross_entropy_loss,
    make_eval_step,
    make_train_step,
)


class SgdState(NamedTuple):
    """``optax.inject_hyperparams(optax.sgd)`` state: the hyperparameters as
    0-d float32 tensors, and the momentum trace."""

    hyperparams: dict
    trace: dict


class MomentumSgd:
    """``optax.inject_hyperparams(optax.sgd)(learning_rate, momentum)``: the
    trace ``t = g + momentum * t``, then ``p + t * -lr``; learning rate and
    momentum live in the state (placeholders 0.0 until
    :func:`set_hyperparams` writes the trial's)."""

    def init(self, params: dict) -> SgdState:
        device = next(iter(params.values())).device
        hp = {name: torch.zeros((), dtype=torch.float32, device=device)
              for name in ("learning_rate", "momentum")}
        return SgdState(hp, {k: torch.zeros_like(v, dtype=torch.float32)
                             for k, v in params.items()})

    def update(self, grads: dict, state: SgdState, params: dict) -> tuple[dict, SgdState]:
        keys = list(params)
        decay, lr = state.hyperparams["momentum"], state.hyperparams["learning_rate"]
        trace = torch._foreach_add([grads[k] for k in keys],
                                   torch._foreach_mul([state.trace[k] for k in keys], decay))
        updates = torch._foreach_mul(trace, -lr)
        new = torch._foreach_add([params[k] for k in keys], updates)
        return dict(zip(keys, new)), SgdState(state.hyperparams, dict(zip(keys, trace)))


def make_optimizer(name: str) -> MomentumSgd:
    """The optimizer family of ``name`` with runtime hyperparameters; only
    ``"momentum"`` is ported."""
    if name != "momentum":
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (only 'momentum', which the DARTS augment "
            "phase uses)"
        )
    return MomentumSgd()


def set_hyperparams(opt_state: SgdState, lr: float, momentum: float) -> SgdState:
    """Write the trial's learning rate and momentum into the state."""
    hp = dict(opt_state.hyperparams)
    hp["learning_rate"] = torch.full_like(hp["learning_rate"], lr)
    hp["momentum"] = torch.full_like(hp["momentum"], momentum)
    return opt_state._replace(hyperparams=hp)


def train_classifier(
    model: nn.Module,
    dataset: Dataset,
    *,
    lr: float,
    epochs: int,
    batch_size: int,
    optimizer: str = "momentum",
    momentum: float = 0.9,
    mesh=None,
    seed: int = 0,
    report=None,
    eval_batch: int = 1024,
    init_transform=None,
    on_finish=None,
    device_data: bool | None = None,
    augment_fn: Callable | None = None,
    device: str | torch.device | None = None,
) -> float:
    """Train ``model`` (NHWC images to logits, its parameters as they are)
    and return the final test accuracy; calls ``report(epoch=, accuracy=,
    loss=)`` per epoch and stops when it returns False.

    ``augment_fn(key, step, x)`` transforms each batch, keyed with
    ``seed + 0x5EED`` and the train state's step counter.  ``device_data``
    (default on for single-device runs, ``KATIB_DEVICE_DATA`` overrides, as
    in the JAX trainer): the train split lives on the device and each batch
    is gathered there; off, each batch is gathered on the host from the same
    permutation and copied over, so both give the same batches.  ``device``:
    ``cuda`` unless the caller names another.  ``mesh``,
    ``init_transform`` and ``on_finish`` raise ``NotImplementedError``."""
    for name, value in (("mesh", mesh), ("init_transform", init_transform),
                        ("on_finish", on_finish)):
        if value is not None:
            raise NotImplementedError(f"train_classifier's {name} is not ported yet")
    tx = make_optimizer(optimizer)
    dev = resolve_device(device)
    model.to(dev)

    def loss_fn(params, batch):
        return cross_entropy_loss(torch.func.functional_call(model, params, (batch[0],)),
                                  batch[1])

    def metric_fn(params, batch):
        return {"accuracy": accuracy(torch.func.functional_call(model, params, (batch[0],)),
                                     batch[1])}

    step, evaluate = make_train_step(loss_fn, tx), make_eval_step(metric_fn)
    state = TrainState.create(dict(model.named_parameters()), tx)
    state = state._replace(opt_state=set_hyperparams(state.opt_state, lr, momentum))
    if device_data is None:
        env = os.environ.get("KATIB_DEVICE_DATA")
        device_data = mesh is None if env is None else parse_bool(env)
    if device_data:
        x_train = torch.from_numpy(dataset.x_train).to(dev)
        y_train = torch.from_numpy(dataset.y_train).to(dev)
    ne = min(eval_batch, len(dataset.x_test))
    ebatch = (torch.from_numpy(dataset.x_test[:ne]).to(dev),
              torch.from_numpy(dataset.y_test[:ne]).to(dev))
    aug_key = seed + KEY_OFFSET
    rng = np.random.default_rng(seed)
    n = len(dataset.x_train) // batch_size
    test_acc = 0.0
    for epoch in range(epochs):
        # one permutation per epoch, the JAX trainer's draw on both of its paths
        idx = rng.permutation(len(dataset.x_train))[: n * batch_size].reshape(n, batch_size)
        losses = []
        for rows in idx:
            if device_data:
                ix = torch.from_numpy(rows).to(dev)
                xb, yb = x_train[ix], y_train[ix]
            else:
                xb = torch.from_numpy(dataset.x_train[rows]).to(dev)
                yb = torch.from_numpy(dataset.y_train[rows]).to(dev)
            if augment_fn is not None:
                xb = augment_fn(aug_key, state.step, xb)
            state, metrics = step(state, (xb, yb))
            losses.append(metrics["loss"])
        train_loss = float(torch.stack(losses).sum()) if losses else 0.0
        test_acc = float(evaluate(state.params, ebatch)["accuracy"])
        if report is not None and report(epoch=epoch, accuracy=test_acc,
                                         loss=train_loss / max(n, 1)) is False:
            break
    return test_acc
