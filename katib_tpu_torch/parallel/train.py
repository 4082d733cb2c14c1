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


def make_train_step(loss_fn: Callable[[dict, Any], torch.Tensor], tx, mesh=None) -> Callable:
    """``step(state, batch) -> (state, {"loss": loss})`` for
    ``loss_fn(params, batch) -> scalar`` and an optimizer ``tx`` with
    ``update(grads, opt_state, params) -> (params, opt_state)``
    (``katib_tpu/parallel/train.py:53``).

    With a ``mesh`` it is the data-parallel step of the JAX function under
    its shardings: the parameters and the optimizer state live as one home
    copy (a :func:`~katib_tpu_torch.parallel.mesh.replicate`-d state is
    read from it), the batch lies on the mesh's data axis (plain tensors
    are placed there), the parameters are broadcast to every replica, each
    replica runs ``loss_fn`` on its chunk on its thread, and the loss is
    the mean over the replicas on the home device (chunks are equal, so it
    is the global batch's); autograd carries the gradient of that global
    loss back through the broadcast, and the optimizer runs once, at home,
    on the mesh's leased streams.  ``loss_fn`` must be safe to call from
    the replicas' threads at once (``functional_call`` rebinds a module's
    parameters: one module copy per replica)."""
    if mesh is not None:
        local_loss = loss_fn

        def loss_fn(params: dict, batch) -> torch.Tensor:  # the global batch's
            ps = collectives.broadcast(params, mesh)
            return mesh.run(lambda r: collectives.replica_mean_to_home(
                local_loss(ps[r], piece(batch, r))))[0]

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        params = {k: v.detach().requires_grad_() for k, v in state.params.items()}
        loss = loss_fn(params, batch)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                     allow_unused=True, materialize_grads=True)))
        new_params, opt_state = tx.update(grads, state.opt_state, state.params)
        return TrainState(state.step + 1, new_params, opt_state), {"loss": loss.detach()}

    if mesh is None:
        return step

    def sharded_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        with mesh.on_streams():
            return step(home_value(state), on_data_axis(batch, mesh))

    return sharded_step


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
            return mesh.run(lambda r: {k: collectives.replica_mean_to_home(v) for k, v in
                                       metric_fn(ps[r], piece(batch, r)).items()})[0]

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
    optax requires).  The schedule is computed in float32, as optax does:
    of a count tensor on the device into a 0-d tensor there (so a captured
    step reads its own count), of a Python count into a float."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError(
            f"the cosine decay needs decay_steps > warmup_steps, got {decay_steps} and "
            f"{warmup_steps}"
        )
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps

    def schedule(count):
        c = torch.as_tensor(count, dtype=torch.float32)
        warm = (init_value - peak_value) * (1.0 - c / warmup_steps) + peak_value
        t = torch.clamp(c - warmup_steps, min=0.0, max=float(cosine_steps))
        cosine = 0.5 * (1.0 + torch.cos(math.pi * t / cosine_steps))
        value = torch.where(c < warmup_steps, warm, peak_value * ((1.0 - alpha) * cosine + alpha))
        return value if torch.is_tensor(count) else float(value)

    return schedule


class AdamWState(NamedTuple):
    """``optax.adamw`` state: the update count (0-d int32 on the device) and
    the two moments, one float32 tensor per parameter."""

    count: torch.Tensor
    mu: list
    nu: list


def adamw_init(params) -> AdamWState:
    params = list(params)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=params[0].device),
                      [torch.zeros_like(p, dtype=torch.float32) for p in params],
                      [torch.zeros_like(p, dtype=torch.float32) for p in params])


def adamw_update_(params, grads, state: AdamWState, lr: torch.Tensor,
                  weight_decay: float = 0.01, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> None:
    """One ``optax.adamw`` update, in place on ``params`` and ``state``:
    ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, both
    bias-corrected by ``1 - b^count`` after the count's increment, then
    ``p + (mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p) * -lr``.
    ``lr`` is a 0-d tensor on the device (the schedule at the count before
    the update, as optax reads it), so the update holds no host value and a
    CUDA graph can capture it: a foreach product reads a 0-d tensor on the
    device, where a foreach sum would read it on the host."""
    params, grads = list(params), list(grads)
    with torch.no_grad():
        mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1), torch._foreach_mul(state.mu, b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
                                torch._foreach_mul(state.nu, b2))
        state.count.add_(1)
        mu_hat = torch._foreach_div(mu, 1 - b1 ** state.count)
        nu_hat = torch._foreach_div(nu, 1 - b2 ** state.count)
        update = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), eps))
        update = torch._foreach_add(update, torch._foreach_mul(params, weight_decay))
        torch._foreach_add_(params, torch._foreach_mul(update, -lr))
        torch._foreach_copy_(state.mu, mu)
        torch._foreach_copy_(state.nu, nu)
