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
- :func:`mnist_trial`, the white-box trial, and its cohort twin
  :func:`mnist_cohort_trial`, which trains K members differing in lr and
  momentum as one vectorized program through the same :class:`EpochLoop`,
  and its prewarm twin :func:`mnist_prewarm`, which warms up and captures
  the same step on zeros for the background prewarmer
  (``compile/prewarm.py``).
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

from katib_tpu_torch import costmodel
from katib_tpu_torch.compile.prewarm import attach_prewarm_fn
from katib_tpu_torch.costmodel.live import structure_key
from katib_tpu_torch.costmodel.record import dtype_name
from katib_tpu_torch.device import resolve_device
from katib_tpu_torch.models.augmentation import KEY_OFFSET
from katib_tpu_torch.models.data import Dataset, load_mnist
from katib_tpu_torch.nas.darts.step_loop import (
    WARMUP_STEPS,
    _capture_stream,
    capture_step,
    count_copied_step,
)
from katib_tpu_torch.ops.depthwise import lecun_normal_
from katib_tpu_torch.parallel.train import (
    TrainState,
    accuracy,
    cross_entropy_loss,
    make_cohort_eval_step,
    make_cohort_train_step,
    make_eval_step,
    make_train_step,
    member_view,
    stack_pytrees,
)
from katib_tpu_torch.runner.cohort import attach_cohort_fn
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

    def update_members(self, grads: dict, state: SgdState, params: dict) -> tuple[dict, SgdState]:
        """:meth:`update` over a stacked ``[K, ...]`` cohort state whose
        hyperparameters are ``[K]`` rows: the same operations, tensor by
        tensor, each hyperparameter broadcast over its member's row (a
        foreach op would broadcast a ``[K]`` value along the last axis)."""
        hp = state.hyperparams
        new, trace = {}, {}
        for k, p in params.items():
            g = grads[k]
            if self.momentum:
                g = g + state.trace[k] * member_view(hp["momentum"], g)
                trace[k] = g
            new[k] = p + g * -member_view(hp["learning_rate"], g)
        return new, SgdState(hp, trace)


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

    def update_members(self, grads: dict, state: AdamState, params: dict) -> tuple[dict, AdamState]:
        """:meth:`update` over a stacked ``[K, ...]`` cohort state whose
        hyperparameters and count are ``[K]`` rows, tensor by tensor (see
        :meth:`Sgd.update_members`)."""
        hp = {**self.DEFAULTS, **state.hyperparams}
        count = state.count + 1
        new, mu, nu = {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            v = lambda h: member_view(h, g) if torch.is_tensor(h) else h  # noqa: E731
            b1, b2, c = v(hp["b1"]), v(hp["b2"]), v(count)
            mu[k] = g * (1 - b1) + state.mu[k] * b1
            nu[k] = g * g * (1 - b2) + state.nu[k] * b2
            mu_hat = mu[k] / (1 - b1 ** c)
            nu_hat = nu[k] / (1 - b2 ** c)
            new[k] = p + mu_hat / (torch.sqrt(nu_hat + v(hp["eps_root"])) + v(hp["eps"])) * \
                -v(hp["learning_rate"])
        return new, AdamState(state.hyperparams, count, mu, nu)


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
    function runs eagerly, one call per step, over the same buffers.

    ``loss_shape`` is the shape of one step's loss: ``()`` for one trial,
    ``(K,)`` for a cohort step over a stacked ``[K, ...]`` state."""

    def __init__(self, step: Callable, state: TrainState, x_train: torch.Tensor,
                 y_train: torch.Tensor, steps: int, batch_size: int,
                 augment_fn: Callable | None = None, aug_key: int = 0,
                 capture: bool | None = None, loss_shape: tuple = ()):
        if steps < 1:
            raise ValueError(f"an epoch loop needs at least one step per epoch, got {steps}")
        device = state.step.device
        self.capture = device.type == "cuda" if capture is None else capture
        if self.capture and device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, the state is on {device}")
        self.step_fn, self.x, self.y = step, x_train, y_train
        self.augment_fn, self.aug_key, self.steps = augment_fn, aug_key, steps
        self.loss_shape = tuple(loss_shape)
        self.bufs = (
            _clone(state),
            torch.zeros(steps, batch_size, dtype=torch.int64, device=device),
            torch.zeros(1, dtype=torch.int64, device=device),
            torch.zeros(steps, *self.loss_shape, dtype=torch.float32, device=device),
        )
        self.graph: torch.cuda.CUDAGraph | None = None
        self.capture_s = 0.0

    @property
    def state(self) -> TrainState:
        return self.bufs[0]

    @property
    def losses(self) -> torch.Tensor:
        """The last epoch's ``[steps, *loss_shape]`` float32 losses, on the
        device."""
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
        losses.index_copy_(0, pos, metrics["loss"].float().reshape(1, *self.loss_shape))
        pos.add_(1)

    def _build_graph(self) -> None:
        """Capture one step (``step_loop.py::capture_step``); ``capture_s``
        includes a wait for another trial's capture."""
        self.graph, _, self.capture_s = capture_step(
            self._step, self.bufs, lambda b: tuple(_clone(t) for t in b), self.state.step.device)

    def count_step(self):
        """Count one step (``costmodel/counter.py``) on copies of the buffers
        at the epoch's first row, eagerly, outside any capture and the
        capture lock; the loop's state is left as it was."""
        return count_copied_step(self._step, self.bufs, lambda b: (
            _clone(b[0]), b[1].clone(), torch.zeros_like(b[2]), b[3].clone()))

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


def _observe_step(label: tuple, loop: EpochLoop | None, step: Callable, state, batch,
                  program: str, per_report: int, model: nn.Module, device) -> None:
    """Count the classifier's step once per ``label`` in the process
    (``costmodel.observe_program``): the epoch loop's step on copies of its
    buffers, else the eager ``step`` on a copy of ``state`` and ``batch``.
    One report covers ``per_report`` steps; the model's compute dtype picks
    the peak (as the JAX package's ``_model_dtype``)."""
    if loop is not None:
        count = loop.count_step
    else:
        count = lambda: count_copied_step(  # noqa: E731
            lambda a: step(*a), (state, batch), lambda b: (_clone(b[0]), b[1]), device)
    costmodel.observe_program(label, count, program=program, steps=1,
                              per_report=max(1, per_report),
                              dtype=dtype_name(getattr(model, "dtype", torch.float32)),
                              device=device)


def _step_label(kind: str, model: nn.Module, params: dict, optimizer: str, batch_size: int,
                *extra) -> tuple:
    """The memo label of a classifier step: what shapes its work."""
    return (kind, type(model).__name__, str(getattr(model, "dtype", None)),
            structure_key(params), optimizer, batch_size, *extra)


def classifier_steps(model: nn.Module, optimizer: str, lr: float, momentum: float,
                     params: dict | None = None) -> tuple[Callable, Callable, TrainState]:
    """:func:`train_classifier`'s train step (softmax cross-entropy, the
    ``optimizer`` family), its evaluation (``{"accuracy"}``) and its initial
    state: ``params`` (the model's own parameters by default) and the
    family's state with ``lr`` and ``momentum`` written in."""
    tx = _family_optimizer(optimizer)

    def loss_fn(params, batch):
        return cross_entropy_loss(torch.func.functional_call(model, params, (batch[0],)),
                                  batch[1])

    def metric_fn(params, batch):
        return {"accuracy": accuracy(torch.func.functional_call(model, params, (batch[0],)),
                                     batch[1])}

    state = TrainState.create(dict(model.named_parameters()) if params is None else params, tx)
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
    ``cuda`` unless the caller names another.

    ``init_transform(params) -> params`` maps the freshly initialised
    ``{name: tensor}`` parameters before the optimizer state and the epoch
    loop are built (ENAS weight sharing overlays its pool there; the result
    is moved to the device); ``on_finish(params)`` receives the final
    parameters as host copies after the last epoch, also when ``report``
    stopped the run.  ``mesh`` raises ``NotImplementedError``.

    With a ``report``, one step is counted after the first epoch's report
    (``costmodel.observe_program``, once per step structure in the
    process: ``train_classifier.step``, one report per epoch of steps) and
    armed for the trial's heartbeat."""
    if mesh is not None:
        raise NotImplementedError(
            "train_classifier on a mesh is not ported yet (ROADMAP item 9b)")
    dev = resolve_device(device)
    model.to(dev)
    params = {k: v.detach() for k, v in model.named_parameters()}
    if init_transform is not None:
        # warm starts (e.g. ENAS weight sharing overlays the shared pool)
        params = {k: v.to(dev) for k, v in init_transform(params).items()}
    step, evaluate, state = classifier_steps(model, optimizer, lr, momentum, params)
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
                batch = (xb, yb)
                state, metrics = step(state, batch)
                losses.append(metrics["loss"])
            train_loss = float(torch.stack(losses).sum()) if losses else 0.0
        test_acc = float(evaluate(state.params, ebatch)["accuracy"])
        tracing.record_span("classifier.epoch", time.perf_counter() - t_epoch, epoch=epoch,
                            steps=n, **span_attrs)
        if report is not None and report(epoch=epoch, accuracy=test_acc,
                                         loss=train_loss / max(n, 1)) is False:
            break
        if epoch == 0 and report is not None and n >= 1:
            _observe_step(_step_label("mnist.step", model, params, optimizer, batch_size,
                                      augment_fn, loop is not None),
                          loop, step, state, None if loop is not None else batch,
                          "train_classifier.step", n, model, dev)
    if on_finish is not None:
        # copies: on the card the state lives in the epoch loop's fixed tensors
        on_finish({k: v.detach().to("cpu", copy=True) for k, v in state.params.items()})
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


def cohort_classifier_steps(model: nn.Module, optimizer: str, lrs: torch.Tensor,
                            momenta: torch.Tensor, params: dict,
                            members: int) -> tuple[Callable, Callable, TrainState]:
    """:func:`classifier_steps` for a cohort (``_build_cohort_steps`` of the
    JAX package): the cohort train step, the cohort evaluation
    (``{"accuracy", "loss"}``, each ``[members]``) and the initial state,
    ``params`` stacked ``members`` times with the ``[members]`` learning
    rates and momenta written into the family's state.

    The JAX package keeps built steps in an LRU (``_cohort_steps_for``) so a
    later cohort of the same shapes reuses the compiled executable; a torch
    step is a closure that costs nothing to build, and its CUDA graph
    belongs to one cohort's :class:`EpochLoop` buffers, so nothing is kept."""
    tx = _family_optimizer(optimizer)

    def loss_fn(params, batch):
        return cross_entropy_loss(torch.func.functional_call(model, params, (batch[0],)),
                                  batch[1])

    def metric_fn(params, batch):
        logits = torch.func.functional_call(model, params, (batch[0],))
        return {"accuracy": accuracy(logits, batch[1]),
                "loss": cross_entropy_loss(logits, batch[1])}

    state = stack_pytrees([TrainState.create(params, tx)] * members)
    hp = dict(state.opt_state.hyperparams)
    hp["learning_rate"] = lrs
    if "momentum" in hp:
        hp["momentum"] = momenta
    state = state._replace(opt_state=state.opt_state._replace(hyperparams=hp))
    return make_cohort_train_step(loss_fn, tx), make_cohort_eval_step(metric_fn), state


def mnist_cohort_trial(cctx) -> None:
    """Cohort twin of :func:`mnist_trial`: K members differing only in lr and
    momentum train as one vectorized program over stacked ``[K, ...]``
    states.

    Structural knobs (arch, units, batch size, ...) go through
    ``cctx.shared``: members that disagree belong in different cohorts.
    lr and momentum ride as ``[K]`` rows of the optimizer state.  The
    weights are drawn as :func:`mnist_trial` draws them (one generator
    seeded 0) and the batch schedule is ``train_classifier``'s with seed 0
    (one ``default_rng(0)`` permutation per epoch, truncated to whole
    batches), so each member follows its serial run.  The steps run in one
    :class:`EpochLoop` over the stacked state: one captured step replayed
    per batch on a CUDA device.  Rows past ``len(cctx)`` are ghost members
    (``cctx.padded_size`` with shape buckets) that ``cctx.report`` drops.
    Each epoch records a ``cohort.epoch`` span; the capturing epoch's
    carries ``graph_capture_s``.

    After the first epoch's report one cohort step is counted on copies
    (``costmodel.observe_program``, ``mnist_cohort_trial.step``, once per
    cohort structure in the process).  The JAX twin's compile-artifact
    dispatch (``compile_artifacts.resolve``) has no counterpart (a captured
    step has no serialized form)."""
    arch = str(cctx.shared("arch", "mlp"))
    if arch == "cnn":
        model = SmallCNN(channels=int(cctx.shared("channels", 32)))
    else:
        model = MLP(units=int(cctx.shared("units", 64)),
                    num_layers=int(cctx.shared("num_layers", 2)))
    seed = 0  # train_classifier's default, as in mnist_trial: cohort == serial
    model.reset_parameters(torch.Generator().manual_seed(seed))
    dataset = _cached_mnist(int(cctx.shared("n_train", 4096)), int(cctx.shared("n_test", 1024)))
    epochs = int(cctx.shared("epochs", 3))
    batch_size = int(cctx.shared("batch_size", 256))
    optimizer = str(cctx.shared("optimizer", "momentum"))
    members = cctx.padded_size
    model.to(resolve_device(cctx.device))
    params = {k: v.detach() for k, v in model.named_parameters()}
    step, evaluate, state = cohort_classifier_steps(
        model, optimizer, cctx.stacked("lr", 0.05, torch.float32),
        cctx.stacked("momentum", 0.9, torch.float32), params, members)
    state = cctx.place_members(state)
    x_train, y_train = cctx.place_shared((dataset.x_train, dataset.y_train))
    n = len(dataset.x_train) // batch_size
    ne = min(1024, len(dataset.x_test))
    ebatch = cctx.place_shared((dataset.x_test[:ne], dataset.y_test[:ne]))
    loop = EpochLoop(step, state, x_train, y_train, n, batch_size, loss_shape=(members,))
    rng = np.random.default_rng(seed)
    for epoch in range(epochs):
        t_epoch = time.perf_counter()
        idx = rng.permutation(len(dataset.x_train))[: n * batch_size].reshape(n, batch_size)
        capturing = loop.capture and loop.graph is None
        loop.run_epoch(idx)
        metrics = evaluate(loop.state.params, ebatch)
        loss = loop.losses.sum(0) / n
        span_attrs = {"graph_capture_s": round(loop.capture_s, 3)} if capturing else {}
        tracing.record_span("cohort.epoch", time.perf_counter() - t_epoch, epoch=epoch,
                            steps=n, members=members, **span_attrs)
        if not cctx.report(step=epoch, accuracy=metrics["accuracy"], loss=loss):
            break
        if epoch == 0:
            _observe_step(_step_label("mnist.cohort", model, params, optimizer, batch_size,
                                      members),
                          loop, step, state, None, "mnist_cohort_trial.step", n, model,
                          loop.state.step.device)


def mnist_prewarm(shared: dict, k: int, mesh=None, device=None) -> float:
    """Warm-up twin of :func:`mnist_trial` / :func:`mnist_cohort_trial` (see
    ``compile.prewarm.attach_prewarm_fn``): builds the step the trial builds
    and runs its warm-up and capture once, on ``device`` (resolved as the
    trial's: ``cuda`` unless it names the CPU).  Returns the capture
    seconds (0.0 where nothing was captured).

    Dataset-free, as in the JAX package: the train split, the batch and the
    evaluation batch are zeros of the trial's shapes and dtypes (MNIST is
    ``[N, 28, 28, 1]`` float32 images and int32 labels).  The model is
    built and its weights drawn as the trial builds and draws them (a
    generator seeded 0 after the constructor's own draw).  ``k == 1``
    builds :func:`classifier_steps` and an :class:`EpochLoop` over them; ``k > 1`` builds
    :func:`cohort_classifier_steps` over a stacked ``[k, ...]`` state with
    per-member learning rates and an :class:`EpochLoop` with
    ``loss_shape=(k,)``.  With the train split on the device (the trial's
    default) a CUDA device captures the step under the device's capture
    lock as the trial does (``EpochLoop._build_graph``), and the CPU runs
    the eager warm-up steps only; with ``KATIB_DEVICE_DATA`` off one eager
    step runs, as the trial steps eagerly then.  The evaluation runs once on
    the thread's capture stream and only that stream is waited on (the
    capture rule of ``compile/prewarm.py``).  Then, outside the capture
    lock, the step is counted (``costmodel.observe_program``) under the
    trial's memo label, so the trials of the process adopt the record and
    the prewarm worker keeps it on the signature's registry row.  Nothing
    else built here is handed to a trial.  A ``mesh`` raises."""
    if mesh is not None:
        raise NotImplementedError("mnist_prewarm on a mesh is not ported yet (ROADMAP item 9b)")
    dev = resolve_device(device)
    p = dict(shared)
    model = _model(p)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(dev)
    n_train = int(p.get("n_train", 4096))
    n_test = int(p.get("n_test", 1024))
    batch_size = int(p.get("batch_size", 256))
    optimizer = str(p.get("optimizer", "momentum"))
    k = int(k)
    params = {name: v.detach() for name, v in model.named_parameters()}
    if k > 1:
        step, evaluate, state = cohort_classifier_steps(
            model, optimizer, torch.full((k,), 0.05, device=dev),
            torch.full((k,), 0.9, device=dev), params, k)
        loss_shape = (k,)
    else:
        step, evaluate, state = classifier_steps(model, optimizer, 0.05, 0.9, params)
        loss_shape = ()
    x_train = torch.zeros(n_train, 28, 28, 1, device=dev)
    y_train = torch.zeros(n_train, dtype=torch.int32, device=dev)
    ne = min(1024, n_test)
    ebatch = (torch.zeros(ne, 28, 28, 1, device=dev), torch.zeros(ne, dtype=torch.int32, device=dev))
    env = os.environ.get("KATIB_DEVICE_DATA")
    n = n_train // batch_size
    capture_s = 0.0
    loop, batch = None, (x_train[:batch_size], y_train[:batch_size])
    if (env is None or parse_bool(env)) and n >= 1:
        loop = EpochLoop(step, state, x_train, y_train, n, batch_size, loss_shape=loss_shape)
        if loop.capture:
            loop._build_graph()
            capture_s = loop.capture_s
        else:
            copies = tuple(_clone(b) for b in loop.bufs)
            for _ in range(WARMUP_STEPS):
                loop._step(copies)
        state = loop.state
    else:
        state, _ = step(state, batch)
    if k > 1:
        label = _step_label("mnist.cohort", model, params, optimizer, batch_size, k)
        program = "mnist_cohort_trial.step"
    else:
        label = _step_label("mnist.step", model, params, optimizer, batch_size, None,
                            loop is not None)
        program = "train_classifier.step"
    _observe_step(label, loop, step, state, batch, program, max(1, n), model, dev)
    if dev.type == "cuda":
        side, _ = _capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            evaluate(state.params, ebatch)
        side.synchronize()
    else:
        evaluate(state.params, ebatch)
    return capture_s


# opt-in: the orchestrator batches compatible mnist_trial proposals through
# the vectorized twin when the experiment declares a cohort (runner/cohort.py),
# and its prewarm worker warms up upcoming groups' programs in the background
# through the warm-up twin (compile/prewarm.py).  The program launches no
# hand-written kernel: its steps are cuDNN and cuBLAS calls.
attach_cohort_fn(mnist_trial, mnist_cohort_trial)
attach_prewarm_fn(mnist_trial, mnist_prewarm, kernels=())
