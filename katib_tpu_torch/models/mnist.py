"""Tunable MNIST models, the classifier trainer and the white-box HP-tuning
trial (port of ``katib_tpu/models/mnist.py``).

- :class:`MLP` and :class:`SmallCNN`: the flax modules on NHWC images, float32
  parameters computed in ``dtype`` (bf16 by default) with a float32 head,
  initialised as flax does (``lecun_normal`` kernels, zero biases) from a
  ``torch.Generator``.  Their layouts are PyTorch's (a Linear weight is
  ``[out, in]``, a convolution's ``OIHW``); ``convert.mnist_state_dict_from_flax``
  carries flax weights across.
- The optimizer families ``sgd``, ``momentum`` and ``adam`` with their
  hyperparameters as 0-d float32 tensors in the state
  (``optax.inject_hyperparams``): :func:`_family_optimizer`,
  :func:`_set_hyperparams`, and :func:`make_optimizer` with them fixed.
- :func:`train_classifier`: one numpy permutation per epoch drawn from a
  generator seeded with the run's seed, as the JAX trainer draws on both of
  its data paths.  With the train split on the device (the default) an epoch
  runs in :class:`EpochLoop`: on a CUDA device each step is one replay of a
  captured CUDA graph (the counterpart of the JAX ``lax.scan`` epoch); with
  ``device_data`` off each batch is gathered on the host and stepped eagerly.
- :func:`mnist_trial`, the white-box trial, and its prewarm and cohort twins,
  which raise until ``compile/prewarm.py`` and ``runner/cohort.py`` are
  ported (ROADMAP Queue 1 items 6 and 10).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._pytree import tree_flatten, tree_map

from katib_tpu_torch.device import resolve_device
from katib_tpu_torch.models.augmentation import KEY_OFFSET
from katib_tpu_torch.models.data import Dataset, load_mnist
from katib_tpu_torch.nas.darts.step_loop import WARMUP_STEPS, _capture_stream
from katib_tpu_torch.ops.depthwise import lecun_normal_
from katib_tpu_torch.parallel.train import (
    TrainState,
    accuracy,
    cross_entropy_loss,
    make_eval_step,
    make_train_step,
)
from katib_tpu_torch.utils import tracing
from katib_tpu_torch.utils.booleans import parse_bool


class Linear(nn.Module):
    """flax ``nn.Dense(features, dtype=dtype)``: weight ``[out, in]`` (the
    flax kernel transposed), bias, ``lecun_normal`` and zeros, computed in
    ``dtype``."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


class Conv3x3(nn.Module):
    """flax ``nn.Conv(features, (3, 3), dtype=dtype)``: SAME padding, stride
    1, weight ``OIHW`` (the flax ``HWIO`` kernel permuted), bias,
    ``lecun_normal`` and zeros, computed in ``dtype``."""

    def __init__(self, in_channels: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        lecun_normal_(self.weight, 9 * self.weight.shape[1], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.conv2d(x, self.weight.to(self.dtype), self.bias.to(self.dtype), padding=1)


class _Model(nn.Module):
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Draw every weight anew from ``generator``, layer by layer."""
        for m in self.modules():
            if isinstance(m, (Linear, Conv3x3)):
                m.reset_parameters(generator)


class MLP(_Model):
    """``katib_tpu.models.mnist.MLP``: flatten, ``num_layers`` x (Dense(units)
    + relu) in ``dtype``, a float32 Dense head."""

    def __init__(self, units: int = 64, num_layers: int = 2, num_classes: int = 10,
                 in_features: int = 28 * 28, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        widths = [in_features] + [units] * num_layers
        self.hidden = nn.ModuleList(Linear(a, b, dtype) for a, b in zip(widths, widths[1:]))
        self.head = Linear(widths[-1], num_classes, torch.float32)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for layer in self.hidden:
            x = F.relu(layer(x))
        return self.head(x)


class SmallCNN(_Model):
    """``katib_tpu.models.mnist.SmallCNN`` on NHWC images: two (3x3 conv +
    relu + 2x2 average pool) stages of ``channels`` and ``2 * channels``,
    Dense(``4 * channels``) + relu in ``dtype``, a float32 Dense head.

    The convolutions read the NHWC batch as an NCHW view (channels-last in
    memory, which cuDNN runs as such), and the flatten before the first
    Dense is in NHWC order, as in flax, so that Dense's rows are the flax
    kernel's rows."""

    def __init__(self, channels: int = 32, num_classes: int = 10, in_channels: int = 1,
                 image_size: int = 28, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv0 = Conv3x3(in_channels, channels, dtype)
        self.conv1 = Conv3x3(channels, 2 * channels, dtype)
        pooled = image_size // 2 // 2
        self.dense = Linear(pooled * pooled * 2 * channels, 4 * channels, dtype)
        self.head = Linear(4 * channels, num_classes, torch.float32)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.avg_pool2d(F.relu(self.conv0(x)), 2)
        x = F.avg_pool2d(F.relu(self.conv1(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.head(F.relu(self.dense(x)))


# -- the optimizer families ---------------------------------------------------


class SgdState(NamedTuple):
    """``optax.inject_hyperparams(optax.sgd)`` state: the hyperparameters as
    0-d float32 tensors, and the momentum trace (empty for plain ``sgd``)."""

    hyperparams: dict
    trace: dict


class AdamState(NamedTuple):
    """``optax.inject_hyperparams(optax.adam)`` state: the hyperparameters
    (``learning_rate``, ``b1``, ``b2``, ``eps``, ``eps_root``) as 0-d float32
    tensors, the update count as a 0-d int32 tensor and the two moments."""

    hyperparams: dict
    count: torch.Tensor
    mu: dict
    nu: dict


def _scalars(device, **values: float) -> dict:
    return {k: torch.full((), v, dtype=torch.float32, device=device) for k, v in values.items()}


def _apply(params: dict, keys: list, updates: list, lr: torch.Tensor) -> dict:
    """``optax.scale_by_learning_rate`` then ``optax.apply_updates``:
    ``p + u * -lr``."""
    scaled = torch._foreach_mul(updates, -lr)
    return dict(zip(keys, torch._foreach_add([params[k] for k in keys], scaled)))


class Sgd:
    """``optax.inject_hyperparams(optax.sgd)``: with ``momentum`` the trace
    ``t = g + momentum * t`` and then ``p + t * -lr``; without it (optax's
    ``momentum=None``) ``p + g * -lr``.  The hyperparameters are 0.0 until
    :func:`_set_hyperparams` writes the trial's."""

    def __init__(self, momentum: bool):
        self.momentum = momentum

    def init(self, params: dict) -> SgdState:
        device = next(iter(params.values())).device
        names = ("learning_rate", "momentum") if self.momentum else ("learning_rate",)
        trace = ({k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()}
                 if self.momentum else {})
        return SgdState(_scalars(device, **dict.fromkeys(names, 0.0)), trace)

    def update(self, grads: dict, state: SgdState, params: dict) -> tuple[dict, SgdState]:
        keys = list(params)
        hp = state.hyperparams
        g = [grads[k] for k in keys]
        trace = {}
        if self.momentum:
            g = torch._foreach_add(g, torch._foreach_mul([state.trace[k] for k in keys],
                                                         hp["momentum"]))
            trace = dict(zip(keys, g))
        return _apply(params, keys, g, hp["learning_rate"]), SgdState(hp, trace)


class Adam:
    """``optax.inject_hyperparams(optax.adam)``: ``mu = (1 - b1) g + b1 mu``,
    ``nu = (1 - b2) g^2 + b2 nu``, both bias-corrected by ``1 - b^count``
    with the count a 0-d device tensor (so a captured graph reads it), then
    ``mu_hat / (sqrt(nu_hat + eps_root) + eps)`` scaled by ``-lr``, with
    optax's defaults for b1, b2, eps and eps_root.  ``inject=False`` keeps
    those four as Python numbers, as ``optax.adam(lr)`` does (``1 - b1``
    then rounds once, in float32, where the injected form rounds ``b1``
    first)."""

    DEFAULTS = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0}

    def __init__(self, inject: bool = True):
        self.inject = inject

    def init(self, params: dict) -> AdamState:
        device = next(iter(params.values())).device
        zeros = lambda: {k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()}
        hp = _scalars(device, learning_rate=0.0, **(self.DEFAULTS if self.inject else {}))
        return AdamState(hp, torch.zeros((), dtype=torch.int32, device=device), zeros(), zeros())

    def update(self, grads: dict, state: AdamState, params: dict) -> tuple[dict, AdamState]:
        keys = list(params)
        hp = {**self.DEFAULTS, **state.hyperparams}
        b1, b2 = hp["b1"], hp["b2"]
        g = [grads[k] for k in keys]
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                torch._foreach_mul([state.mu[k] for k in keys], b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                                torch._foreach_mul([state.nu[k] for k in keys], b2))
        count = state.count + 1
        mu_hat = torch._foreach_div(mu, 1 - b1 ** count)
        nu_hat = torch._foreach_div(nu, 1 - b2 ** count)
        # per tensor: a foreach add of a 0-d tensor reads it on the host,
        # which a capture refuses
        den = [torch.sqrt(v + hp["eps_root"]) + hp["eps"] for v in nu_hat]
        new = _apply(params, keys, torch._foreach_div(mu_hat, den), hp["learning_rate"])
        return new, AdamState(state.hyperparams, count, dict(zip(keys, mu)), dict(zip(keys, nu)))


def _family_optimizer(name: str):
    """The optimizer family of ``name`` with its hyperparameters as runtime
    state (placeholders until :func:`_set_hyperparams`): ``adam``,
    ``momentum``, and plain ``sgd`` for any other name, as in the JAX
    package."""
    if name == "adam":
        return Adam()
    return Sgd(momentum=name == "momentum")


def _set_hyperparams(opt_state, lr: float, momentum: float):
    """Write the trial's learning rate, and its momentum where the family
    declares one (``adam`` and ``sgd`` do not), into the state."""
    hp = dict(opt_state.hyperparams)
    hp["learning_rate"] = torch.full_like(hp["learning_rate"], lr)
    if "momentum" in hp:
        hp["momentum"] = torch.full_like(hp["momentum"], momentum)
    return opt_state._replace(hyperparams=hp)


class _Fixed:
    """An optimizer family whose ``init`` writes fixed hyperparameters."""

    def __init__(self, family, lr: float, momentum: float):
        self.family, self.lr, self.momentum = family, lr, momentum

    def init(self, params: dict):
        return _set_hyperparams(self.family.init(params), self.lr, self.momentum)

    def update(self, grads: dict, state, params: dict):
        return self.family.update(grads, state, params)


def make_optimizer(name: str, lr: float, momentum: float = 0.9) -> _Fixed:
    """``optax.adam(lr)``, ``optax.sgd(lr, momentum=momentum)`` for
    ``momentum``, else ``optax.sgd(lr)``."""
    family = Adam(inject=False) if name == "adam" else _family_optimizer(name)
    return _Fixed(family, lr, momentum)


# -- the device-data epoch ----------------------------------------------------


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _copy_(dst, src) -> None:
    for d, s in zip(tree_flatten(dst)[0], tree_flatten(src)[0], strict=True):
        d.copy_(s)


class EpochLoop:
    """Training steps of one classifier run over a train split held on the
    device (the counterpart of the JAX trainer's ``lax.scan`` epoch,
    ``katib_tpu/models/mnist.py:144-154``).

    One step per graph: the train state lives in fixed tensors that each
    step writes back into; the epoch's ``[steps, batch]`` permutation sits
    in a fixed index buffer, refilled once per epoch; the step reads its row
    through a device-side position that it advances itself, gathers its
    batch on the device, augments it (keyed off the state's step counter),
    steps, and writes its loss into row ``position`` of a fixed ``[steps]``
    buffer that is read once per epoch.  A step graph rather than an epoch
    graph: every trial of a sweep pays its capture, and a step's costs one
    step of host time where an epoch's would cost ``steps``; a replay costs
    the host about as much as one kernel launch.

    On a CUDA device (``capture=None``) the step is warmed up on copies of
    every buffer on the thread's capture stream, captured once in
    ``thread_local`` mode under the device's capture lock (as the DARTS step
    loop does, ``nas/darts/step_loop.py``) and replayed; a failed capture or
    replay raises.  On the CPU, or with ``capture=False``, the same step
    function runs eagerly, one call per step, over the same buffers."""

    def __init__(self, step: Callable, state: TrainState, x_train: torch.Tensor,
                 y_train: torch.Tensor, steps: int, batch_size: int,
                 augment_fn: Callable | None = None, aug_key: int = 0,
                 capture: bool | None = None):
        if steps < 1:
            raise ValueError(f"an epoch loop needs at least one step per epoch, got {steps}")
        device = state.step.device
        self.capture = device.type == "cuda" if capture is None else capture
        if self.capture and device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, the state is on {device}")
        self.step_fn, self.x, self.y = step, x_train, y_train
        self.augment_fn, self.aug_key, self.steps = augment_fn, aug_key, steps
        self.bufs = (
            _clone(state),
            torch.zeros(steps, batch_size, dtype=torch.int64, device=device),
            torch.zeros(1, dtype=torch.int64, device=device),
            torch.zeros(steps, dtype=torch.float32, device=device),
        )
        self.graph: torch.cuda.CUDAGraph | None = None
        self.capture_s = 0.0

    @property
    def state(self) -> TrainState:
        return self.bufs[0]

    @property
    def losses(self) -> torch.Tensor:
        """The last epoch's ``[steps]`` float32 losses, on the device."""
        return self.bufs[3]

    def _step(self, bufs) -> None:
        """One step on ``bufs``, written back into them: the function that
        is captured, and that runs eagerly otherwise."""
        state, ix, pos, losses = bufs
        rows = ix.index_select(0, pos)[0]
        xb = self.x.index_select(0, rows)
        if self.augment_fn is not None:
            xb = self.augment_fn(self.aug_key, state.step, xb)
        new, metrics = self.step_fn(state, (xb, self.y.index_select(0, rows)))
        _copy_(state, new)
        losses.index_copy_(0, pos, metrics["loss"].float().reshape(1))
        pos.add_(1)

    def _build_graph(self) -> None:
        """Warm up on copies, then capture one step; ``capture_s`` is the
        time under the capture lock (another trial's capture may make this
        one wait for it first)."""
        side, lock = _capture_stream(self.state.step.device)
        with lock:
            t0 = time.perf_counter()
            copies = tuple(_clone(b) for b in self.bufs)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    self._step(copies)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            del copies
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                self._step(self.bufs)
            torch.cuda.synchronize()
            self.capture_s = time.perf_counter() - t0
        self.graph = graph

    def run_epoch(self, idx: np.ndarray) -> None:
        """Run the epoch whose ``[steps, batch]`` permutation rows are ``idx``;
        the steps are queued without waiting for the device."""
        if self.capture and self.graph is None:
            self._build_graph()
        _, ix, pos, losses = self.bufs
        ix.copy_(torch.from_numpy(idx))
        pos.zero_()
        for _ in range(self.steps):
            if self.graph is not None:
                self.graph.replay()
            else:
                self._step(self.bufs)


def classifier_steps(model: nn.Module, optimizer: str, lr: float,
                     momentum: float) -> tuple[Callable, Callable, TrainState]:
    """:func:`train_classifier`'s train step (softmax cross-entropy, the
    ``optimizer`` family), its evaluation (``{"accuracy"}``) and its initial
    state: the model's parameters and the family's state with ``lr`` and
    ``momentum`` written in."""
    tx = _family_optimizer(optimizer)

    def loss_fn(params, batch):
        return cross_entropy_loss(torch.func.functional_call(model, params, (batch[0],)),
                                  batch[1])

    def metric_fn(params, batch):
        return {"accuracy": accuracy(torch.func.functional_call(model, params, (batch[0],)),
                                     batch[1])}

    state = TrainState.create(dict(model.named_parameters()), tx)
    state = state._replace(opt_state=_set_hyperparams(state.opt_state, lr, momentum))
    return make_train_step(loss_fn, tx), make_eval_step(metric_fn), state


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
    """Train ``model`` (NHWC images to logits, from its parameters as they
    are; the module itself is left unchanged) and return the final test
    accuracy; calls ``report(epoch=, accuracy=, loss=)`` per epoch and stops
    when it returns False.

    ``augment_fn(key, step, x)`` transforms each batch, keyed with
    ``seed + 0x5EED`` and the train state's step counter.  ``device_data``
    (default on for single-device runs, ``KATIB_DEVICE_DATA`` overrides, as
    in the JAX trainer): the train split lives on the device and, given at
    least one full batch, each epoch runs in an :class:`EpochLoop`, by
    CUDA-graph replay on a CUDA device; off, each batch is gathered on the
    host from the same permutation, copied over and stepped eagerly, so
    both give the same batches.  Each epoch records a ``classifier.epoch``
    span; the capturing epoch's carries ``graph_capture_s``.  ``device``:
    ``cuda`` unless the caller names another.  ``mesh``, ``init_transform``
    and ``on_finish`` raise ``NotImplementedError``."""
    for name, value in (("mesh", mesh), ("init_transform", init_transform),
                        ("on_finish", on_finish)):
        if value is not None:
            raise NotImplementedError(f"train_classifier's {name} is not ported yet")
    dev = resolve_device(device)
    model.to(dev)
    step, evaluate, state = classifier_steps(model, optimizer, lr, momentum)
    if device_data is None:
        env = os.environ.get("KATIB_DEVICE_DATA")
        device_data = mesh is None if env is None else parse_bool(env)
    aug_key = seed + KEY_OFFSET
    n = len(dataset.x_train) // batch_size
    loop = None
    if device_data and n >= 1:
        x_train = torch.from_numpy(dataset.x_train).to(dev)
        y_train = torch.from_numpy(dataset.y_train).to(dev)
        loop = EpochLoop(step, state, x_train, y_train, n, batch_size, augment_fn, aug_key)
    ne = min(eval_batch, len(dataset.x_test))
    ebatch = (torch.from_numpy(dataset.x_test[:ne]).to(dev),
              torch.from_numpy(dataset.y_test[:ne]).to(dev))
    rng = np.random.default_rng(seed)
    test_acc = 0.0
    for epoch in range(epochs):
        t_epoch = time.perf_counter()
        span_attrs = {}
        # one permutation per epoch, the JAX trainer's draw on both of its paths
        idx = rng.permutation(len(dataset.x_train))[: n * batch_size].reshape(n, batch_size)
        if loop is not None:
            capturing = loop.capture and loop.graph is None
            loop.run_epoch(idx)
            if capturing:
                span_attrs["graph_capture_s"] = round(loop.capture_s, 3)
            state = loop.state
            train_loss = float(loop.losses.sum())  # one transfer per epoch
        else:
            losses = []
            for rows in idx:
                xb = torch.from_numpy(dataset.x_train[rows]).to(dev)
                yb = torch.from_numpy(dataset.y_train[rows]).to(dev)
                if augment_fn is not None:
                    xb = augment_fn(aug_key, state.step, xb)
                state, metrics = step(state, (xb, yb))
                losses.append(metrics["loss"])
            train_loss = float(torch.stack(losses).sum()) if losses else 0.0
        test_acc = float(evaluate(state.params, ebatch)["accuracy"])
        tracing.record_span("classifier.epoch", time.perf_counter() - t_epoch, epoch=epoch,
                            steps=n, **span_attrs)
        if report is not None and report(epoch=epoch, accuracy=test_acc,
                                         loss=train_loss / max(n, 1)) is False:
            break
    return test_acc


# -- the white-box trial function (workload parity with pytorch-mnist) -------

_DATASET_CACHE: dict[tuple, Dataset] = {}
_DATASET_LOCK = threading.Lock()


def _cached_mnist(n_train: int, n_test: int) -> Dataset:
    """``load_mnist(n_train, n_test)``, made once per process for each size
    (the concurrent trials of a sweep share it)."""
    key = (n_train, n_test)
    with _DATASET_LOCK:
        if key not in _DATASET_CACHE:
            _DATASET_CACHE[key] = load_mnist(n_train, n_test)
        return _DATASET_CACHE[key]


def _model(p) -> nn.Module:
    """``mnist_trial``'s model for the parameters ``p``."""
    if str(p.get("arch", "mlp")) == "cnn":
        return SmallCNN(channels=int(p.get("channels", 32)))
    return MLP(units=int(p.get("units", 64)), num_layers=int(p.get("num_layers", 2)))


def mnist_trial(ctx) -> None:
    """White-box trial: tunable MNIST classifier reporting accuracy/loss.

    Reads ``arch`` (``mlp`` or ``cnn``), ``channels``, ``units``,
    ``num_layers``, ``n_train``, ``n_test``, ``lr``, ``momentum``,
    ``epochs``, ``batch_size`` and ``optimizer`` with the JAX trial's
    defaults; the weights are drawn from a generator seeded with the
    trainer's seed (0).  Runs on ``ctx.device`` (``cuda`` unless it names
    the CPU)."""
    p = ctx.params
    model = _model(p)
    seed = 0  # train_classifier's default, as in the JAX trial
    model.reset_parameters(torch.Generator().manual_seed(seed))
    dataset = _cached_mnist(int(p.get("n_train", 4096)), int(p.get("n_test", 1024)))

    def report(epoch, accuracy, loss):
        return ctx.report(step=epoch, accuracy=accuracy, loss=loss)

    train_classifier(
        model,
        dataset,
        lr=float(p.get("lr", 0.05)),
        momentum=float(p.get("momentum", 0.9)),
        epochs=int(p.get("epochs", 3)),
        batch_size=int(p.get("batch_size", 256)),
        optimizer=str(p.get("optimizer", "momentum")),
        mesh=ctx.mesh,
        seed=seed,
        report=report,
        device=ctx.device,
    )


def mnist_cohort_trial(cctx) -> None:
    """Cohort twin of :func:`mnist_trial` (members differing only in lr and
    momentum trained as one vectorized program); not ported yet."""
    raise NotImplementedError(
        "mnist_trial's cohort twin needs vectorized cohorts "
        "(katib_tpu/runner/cohort.py), not ported yet"
    )


def mnist_prewarm(shared: dict, k: int, mesh=None) -> None:
    """Compile-only twin of :func:`mnist_trial`; not ported yet."""
    raise NotImplementedError(
        "mnist_trial's prewarm twin needs the background compile prewarmer "
        "(katib_tpu/compile/prewarm.py), not ported yet"
    )


# the twins the JAX package attaches (``attach_cohort_fn``,
# ``attach_prewarm_fn``): the orchestrator engages cohorts and prewarm only for
# a train_fn that declares them, so the port refuses exactly where they would run
mnist_trial.__cohort_fn__ = mnist_cohort_trial
mnist_trial.__prewarm_fn__ = mnist_prewarm
