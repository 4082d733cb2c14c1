"""Loss, accuracy, gradient clipping, the train state and step factories,
and the optimizer setup shared by the trial workloads (port of the matching
helpers in ``katib_tpu/parallel/train.py``, and of the optax pieces the
trials use)."""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch


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


def make_eval_step(metric_fn: Callable[[dict, Any], dict]) -> Callable:
    """``evaluate(params, batch) -> metrics`` without autograd."""

    def evaluate(params: dict, batch) -> dict:
        with torch.no_grad():
            return metric_fn(params, batch)

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
