"""Loss, accuracy, gradient clipping, the train state and step factories,
and the optimizer setup shared by the trial workloads (port of the matching
helpers in ``katib_tpu/parallel/train.py``, and of the optax pieces the
trials use)."""

from __future__ import annotations

import math
import threading
from typing import Any, Callable, NamedTuple

import torch
from torch.utils._pytree import tree_flatten, tree_map

from katib_tpu_torch.parallel import collectives
from katib_tpu_torch.parallel.mesh import (
    TRIAL_AXIS,
    Sharded,
    home_value,
    on_data_axis,
    piece,
    shard_members,
    trial_axis_size,
    trial_sharding,
)


class TrainState(NamedTuple):
    """``katib_tpu.parallel.train.TrainState``: the step counter (0-d int32
    on the parameters' device), the parameters (a ``{name: tensor}`` dict
    that ``torch.func.functional_call`` binds) and the optimizer state."""

    step: torch.Tensor
    params: dict
    opt_state: Any

    @classmethod
    def create(cls, params: dict, tx) -> "TrainState":
        device = next(iter(params.values())).device
        params = {k: v.detach() for k, v in params.items()}
        return cls(torch.zeros((), dtype=torch.int32, device=device), params, tx.init(params))


def make_train_step(loss_fn: Callable[[dict, Any], torch.Tensor], tx) -> Callable:
    """``step(state, batch) -> (state, {"loss": loss})`` for
    ``loss_fn(params, batch) -> scalar`` and an optimizer ``tx`` with
    ``update(grads, opt_state, params) -> (params, opt_state)``; one device
    of the JAX function (``katib_tpu/parallel/train.py:53``)."""

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        params = {k: v.detach().requires_grad_() for k, v in state.params.items()}
        loss = loss_fn(params, batch)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                     allow_unused=True, materialize_grads=True)))
        new_params, opt_state = tx.update(grads, state.opt_state, state.params)
        return TrainState(state.step + 1, new_params, opt_state), {"loss": loss.detach()}

    return step


def make_eval_step(metric_fn: Callable[[dict, Any], dict], mesh=None) -> Callable:
    """``evaluate(params, batch) -> metrics`` without autograd.

    With a ``mesh`` (``katib_tpu/parallel/train.py:214``) the batch lies on
    the mesh's data axis (plain tensors are placed there), the parameters
    are broadcast from their home copy, ``metric_fn`` runs once per replica
    on its chunk, and each metric comes back once, on the home device, as
    the mean over the replicas: ``metric_fn`` returns batch means, and the
    chunks are equal, so that is the mean over the global batch."""
    if mesh is None:
        def evaluate(params: dict, batch) -> dict:
            with torch.no_grad():
                return metric_fn(params, batch)

        return evaluate

    def evaluate_sharded(params: dict, batch) -> dict:
        batch = on_data_axis(batch, mesh)
        with torch.no_grad(), mesh.on_streams():
            ps = collectives.broadcast(home_value(params), mesh)
            outs = mesh.run(lambda r: metric_fn(ps[r], piece(batch, r)))
            return {k: collectives.reduce_to_home([o[k] / mesh.size for o in outs], mesh)
                    for k in outs[0]}

    return evaluate_sharded


# -- vectorized trial cohorts -------------------------------------------------


def stack_pytrees(trees):
    """Stack K structurally identical pytrees into one ``[K, ...]`` pytree
    (member k of the cohort lives at leading-axis row k)."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def unstack_pytree(tree, k: int):
    """Inverse of :func:`stack_pytrees`: one ``[K, ...]`` pytree -> K pytrees."""
    return [tree_map(lambda x: x[i], tree) for i in range(k)]


def member_view(h: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A per-member ``[K]`` value (or a 0-d one) shaped to broadcast over
    the member axis of a stacked ``[K, ...]`` tensor ``t``: ``[K, 1, ..., 1]``."""
    return h.reshape(h.shape + (1,) * (t.ndim - h.ndim))


class _BuildCounter:
    """Counts builds of the cohort step (``katib_tpu``'s
    ``cohort_trace_counter``, which counts jit traces): a K-member cohort
    builds one step, not K, and on a CUDA device captures it once."""

    def __init__(self) -> None:
        self.count = 0
        self._lock = threading.Lock()

    def bump(self) -> None:
        with self._lock:
            self.count += 1


cohort_build_counter = _BuildCounter()


def make_cohort_train_step(loss_fn: Callable[[dict, Any], torch.Tensor], tx,
                           mesh=None) -> Callable:
    """``step(states, batch) -> (states, {"loss": [K]})`` over a whole cohort
    (``katib_tpu/parallel/train.py:125``).

    ``states`` is a stacked ``[K, ...]`` :class:`TrainState` (one member per
    leading row, its hyperparameters ``[K]`` rows of the optimizer state);
    the batch is shared.  The members' forward passes run as one batched
    program (``torch.func.vmap`` of ``loss_fn`` over the parameters), and
    one backward pass of the summed ``[K]`` losses gives each member its own
    gradient, since no member's loss reads another's parameters.  ``tx``
    updates the stacked state with ``update_members(grads, opt_state,
    params)``.

    Divergence is contained per member: a row whose loss is non-finite
    keeps its previous state (``torch.where`` on the device, no host
    read), so one blown-up member never poisons the rest.

    With a ``mesh`` whose ``trial`` axis has size T > 1, the states lie split
    over ``trial`` (``parallel/mesh.py::shard_members``; K a multiple of T,
    plain states are split on entry) and the step returns them so: each
    replica steps the K/T members of its trial coordinate, with the batch
    broadcast to it and no collective between members, and the ``[K]``
    metrics are gathered on the home device in member order.  A mesh
    without a trial axis (or of size 1) steps as no mesh does."""
    cohort_build_counter.bump()
    losses_of = torch.func.vmap(loss_fn, in_dims=(0, None))

    def step(states: TrainState, batch) -> tuple[TrainState, dict]:
        params = {k: v.detach().requires_grad_() for k, v in states.params.items()}
        loss = losses_of(params, batch)
        grads = dict(zip(params, torch.autograd.grad(loss.sum(), list(params.values()),
                                                     allow_unused=True,
                                                     materialize_grads=True)))
        new_params, opt_state = tx.update_members(grads, states.opt_state, states.params)
        new = TrainState(states.step + 1, new_params, opt_state)
        loss = loss.detach()
        ok = torch.isfinite(loss)
        kept = tree_map(lambda n, o: torch.where(member_view(ok, n), n, o), new, states)
        return kept, {"loss": loss}

    if mesh is None or trial_axis_size(mesh) <= 1:
        return step

    placement = trial_sharding(mesh)
    rows = [g[0] for g in zip(*mesh.groups(TRIAL_AXIS))]  # one entry per trial coordinate

    def sharded_step(states, batch):
        if not isinstance(tree_flatten(states)[0][0], Sharded):
            states = shard_members(states, mesh)
        with mesh.on_streams():
            batches = collectives.broadcast(batch, mesh)
            outs = mesh.run(lambda r: step(piece(states, r), batches[r]))
            new = tree_map(lambda *ps: Sharded(ps, placement), *[o[0] for o in outs])
            metrics = {k: torch.cat([outs[r][1][k].to(mesh.home) for r in rows])
                       for k in outs[0][1]}
        return new, metrics

    return sharded_step


def make_cohort_eval_step(metric_fn: Callable[[dict, Any], dict]) -> Callable:
    """``evaluate(params, batch) -> metrics`` over stacked ``[K, ...]``
    parameters with a shared batch; each metric comes back ``[K]``."""
    batched = torch.func.vmap(metric_fn, in_dims=(0, None))

    def evaluate(params: dict, batch) -> dict:
        with torch.no_grad():
            return batched(params, batch)

    return evaluate


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every tensor (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def clip_by_global_norm(grads: dict, max_norm: float):
    """Scale ``grads`` so their global norm is at most ``max_norm``; returns
    ``(clipped, norm)`` (the raw norm is a useful training metric)."""
    gnorm = global_norm(grads.values())
    scale = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
    return dict(zip(grads, torch._foreach_mul(list(grads.values()), scale))), gnorm


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels.long()[:, None]))


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, dim=-1) == labels).float())


def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int,
                        decay_steps: int, end_value: float = 0.0):
    """``optax.warmup_cosine_decay_schedule``: the value at update count ``c``.

    A linear warmup from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then a cosine decay to ``end_value`` over the
    remaining ``decay_steps - warmup_steps`` (which must be positive, as
    optax requires)."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError(
            f"the cosine decay needs decay_steps > warmup_steps, got {decay_steps} and "
            f"{warmup_steps}"
        )
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def adamw_with_schedule(params, schedule, weight_decay: float = 0.01):
    """``optax.adamw(schedule, weight_decay)`` as a ``torch.optim.AdamW`` and
    a ``LambdaLR`` over it: b1 0.9, b2 0.999, eps 1e-8, decay on every
    parameter and scaled by the scheduled lr.

    optax reads the schedule at the update count *before* the update, so
    the first step runs at ``schedule(0)``; ``LambdaLR`` sets that lr when
    it is built, and ``scheduler.step()`` after each ``optimizer.step()``
    moves to the next count.  The base lr is 1, so the factor ``LambdaLR``
    applies is the scheduled lr itself.  Returns ``(optimizer, scheduler)``."""
    opt = torch.optim.AdamW(params, lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)
