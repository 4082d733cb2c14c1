"""DARTS bilevel optimization: the architect (port of
``katib_tpu/nas/darts/architect.py``).

Parity with the reference architect
(``examples/v1beta1/trial-images/darts-cnn-cifar10/architect.py``):

- virtual step     w' = w - xi * (momentum*v + grad_w L_train + wd*w)
- val grads        d_alpha, d_w' of L_val(w', alpha)
- Hessian-vector   finite difference: (grad_a L_train(w+eps*d_w') -
                   grad_a L_train(w-eps*d_w')) / (2 eps), eps=0.01/||d_w'||
- update           alpha_grad = d_alpha - xi * hessian

then Adam on the alphas, and SGD with momentum, weight decay and gradient
clipping on the weights at the NEW alphas.  Weights are a dict of tensors
(``torch.func.functional_call`` binds them to the network), so the virtual
and perturbed weights are just other dicts.  Only first derivatives are
taken; the Hessian term is the finite difference.

The step is one function that runs eagerly or inside a CUDA-graph capture
(``step_loop.py``): the step and Adam counters are 0-d tensors on the
state's device, the cosine lr and Adam's bias corrections are computed
there in float32 (as optax does under ``jit``), and nothing in the step
reads a value back to the host.

On a mesh (``parallel/mesh.py``) the step is the same function of the
global-batch loss (:func:`mesh_loss`): the state lives as one home copy,
every loss evaluation broadcasts the weights and alphas to the grid's
replicas, each replica computes its batch chunk's loss (batch norm over the
global batch), and the losses meet at home; autograd carries every gradient
back through the broadcast, so each is that of the global-batch loss, as
``jax.grad`` gives it under GSPMD.  The optimizer steps run once, at home,
and the metrics come back once.  Nothing in the sharded step reads a value
back to the host or writes a host value into a device tensor either (the
batch norm's rendezvous included, ``norm.py``), so on a mesh of one card
the step loop captures it, every replica's work in one CUDA graph
(``step_loop.py``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from katib_tpu_torch.nas.darts.model import Alphas
from katib_tpu_torch.parallel import collectives
from katib_tpu_torch.parallel.mesh import home_value, on_data_axis, piece
from katib_tpu_torch.parallel.train import clip_by_global_norm, global_norm

LossFn = Callable[[dict, Alphas, tuple], torch.Tensor]


class AdamState(NamedTuple):
    """``optax.chain(add_decayed_weights, adam)`` state for the alphas."""

    count: torch.Tensor  # 0-d int32 on the alphas' device
    mu: Alphas
    nu: Alphas


class SearchState(NamedTuple):
    step: torch.Tensor  # 0-d int32 on the state's device
    weights: dict  # state-dict key -> tensor
    alphas: Alphas
    a_opt: AdamState
    velocity: dict  # momentum buffer mirror for the virtual step


class DartsHyper(NamedTuple):
    """Search hyperparameters (reference defaults ``darts/service.py:118-135``)."""

    w_lr: float = 0.025
    w_lr_min: float = 0.001
    w_momentum: float = 0.9
    w_weight_decay: float = 3e-4
    w_grad_clip: float = 5.0
    alpha_lr: float = 3e-4
    alpha_weight_decay: float = 1e-3
    total_steps: int = 1000  # for the cosine schedule
    unrolled: bool = True  # second-order (hessian correction) on/off
    # the JAX package evaluates the two finite-difference passes as one
    # vmapped pass when set; here they always run as two sequential passes,
    # which is the same math
    paired_hessian: bool = False
    # expose the raw second-order alpha gradient in the step metrics (parity
    # checks compare it rather than the post-Adam alphas, whose sign-like
    # first Adam step turns sub-noise gradient elements into full ±alpha_lr
    # differences)
    debug_alpha_grad: bool = False


ALPHA_BETAS = (0.5, 0.999)
ALPHA_EPS = 1e-8


def cosine_lr(step: torch.Tensor, hyper: DartsHyper) -> torch.Tensor:
    """Cosine-annealed weight learning rate from ``w_lr`` to ``w_lr_min``, a
    0-d float32 tensor on ``step``'s device."""
    t = torch.clamp(step.float() / hyper.total_steps, max=1.0)
    return hyper.w_lr_min + 0.5 * (hyper.w_lr - hyper.w_lr_min) * (1.0 + torch.cos(math.pi * t))


def alpha_update(grad: Alphas, opt: AdamState, alphas: Alphas,
                 hyper: DartsHyper) -> tuple[Alphas, AdamState]:
    """``optax.chain(add_decayed_weights(wd), adam(lr, b1=0.5, b2=0.999))``:
    L2 added to the gradient before Adam (not AdamW), bias-corrected moments,
    eps outside the square root."""
    b1, b2 = ALPHA_BETAS
    count = torch.as_tensor(opt.count, dtype=torch.int32, device=alphas[0].device) + 1
    # bias corrections in float32 on the device, as optax computes them
    bc1, bc2 = (1 - torch.pow(b, count.float()) for b in (b1, b2))
    mu, nu, new = [], [], []
    for g, m, v, p in zip(grad, opt.mu, opt.nu, alphas):
        g = g + hyper.alpha_weight_decay * p
        m = (1 - b1) * g + b1 * m
        v = (1 - b2) * g * g + b2 * v
        m_hat = m / bc1
        v_hat = v / bc2
        new.append(p + (-hyper.alpha_lr) * (m_hat / (torch.sqrt(v_hat) + ALPHA_EPS)))
        mu.append(m)
        nu.append(v)
    return Alphas(*new), AdamState(count, Alphas(*mu), Alphas(*nu))


def _grads(loss_fn: LossFn, weights: dict, alphas: Alphas, batch, wrt_w: bool, wrt_a: bool):
    """``(loss, d/dweights or None, d/dalphas or None)`` at the given point."""
    w = {k: v.detach().requires_grad_(wrt_w) for k, v in weights.items()}
    a = Alphas(*(t.detach().requires_grad_(wrt_a) for t in alphas))
    loss = loss_fn(w, a, batch)
    inputs = [*(w.values() if wrt_w else ()), *(a if wrt_a else ())]
    grads = torch.autograd.grad(loss, inputs, allow_unused=True, materialize_grads=True)
    gw = dict(zip(w, grads[: len(w)])) if wrt_w else None
    ga = Alphas(*grads[-2:]) if wrt_a else None
    return loss.detach(), gw, ga


def _axpy(x: dict, y: dict, alpha) -> dict:
    """``x + alpha * y`` over two weight dicts (``alpha`` a float or 0-d tensor)."""
    return dict(zip(x, torch._foreach_add(list(x.values()), torch._foreach_mul(list(y.values()), alpha))))


def mesh_loss(loss_fn: LossFn, mesh) -> LossFn:
    """The global-batch loss of ``loss_fn`` over ``mesh``:
    ``loss(weights, alphas, sharded_batch)`` broadcasts the weights and
    alphas from their home copy to every replica, runs ``loss_fn`` on each
    replica's batch chunk on the replica's thread, and returns the mean of
    the replicas' losses on the home device (chunks are equal, so it is the
    mean over the global batch; replicas along a non-data axis hold the
    same chunk and count alike).  ``loss_fn`` must be safe to call from the
    replicas' threads at once."""

    def loss(weights: dict, alphas: Alphas, batch) -> torch.Tensor:
        batch = on_data_axis(batch, mesh)
        ws, als = collectives.broadcast(weights, mesh), collectives.broadcast(alphas, mesh)
        return mesh.run(lambda r: collectives.replica_mean_to_home(
            loss_fn(ws[r], Alphas(*als[r]), piece(batch, r))))[0]

    return loss


def make_search_step(loss_fn: LossFn, hyper: DartsHyper, mesh=None) -> Callable:
    """Build ``search_step(state, train_batch, val_batch) -> (state, metrics)``.

    ``loss_fn(weights, alphas, batch) -> scalar`` is the supernet loss.  With
    a ``mesh`` the step takes the batches on the mesh's data axis
    (``shard_batch``; plain tensors are placed there), the state on the
    mesh's home device (a :func:`~katib_tpu_torch.parallel.mesh.replicate`-d
    state is read from its home copy), calls ``loss_fn`` once per replica
    per pass (:func:`mesh_loss`), and runs on the mesh's leased streams
    (inside a capture begun on one of them, it waits on nothing)."""
    if mesh is not None:
        step = make_search_step(mesh_loss(loss_fn, mesh), hyper)

        def sharded_step(state: SearchState, train_batch, val_batch):
            with mesh.on_streams():
                return step(home_value(state), on_data_axis(train_batch, mesh),
                            on_data_axis(val_batch, mesh))

        return sharded_step

    def alpha_grad_unrolled(state: SearchState, lr, train_batch, val_batch):
        w, a = state.weights, state.alphas
        # virtual step with weight decay + momentum lookahead
        _, gw, _ = _grads(loss_fn, w, a, train_batch, True, False)
        keys = list(w)
        step_dir = torch._foreach_mul([state.velocity[k] for k in keys], hyper.w_momentum)
        torch._foreach_add_(step_dir, [gw[k] for k in keys])
        torch._foreach_add_(step_dir, [w[k] for k in keys], alpha=hyper.w_weight_decay)
        w_virtual = _axpy(w, dict(zip(keys, step_dir)), -lr)
        # gradients at the virtual point
        val_loss, dw, da = _grads(loss_fn, w_virtual, a, val_batch, True, True)
        # finite-difference Hessian-vector product
        eps = 0.01 / (global_norm(dw.values()) + 1e-12)
        _, _, da_pos = _grads(loss_fn, _axpy(w, dw, eps), a, train_batch, False, True)
        _, _, da_neg = _grads(loss_fn, _axpy(w, dw, -eps), a, train_batch, False, True)
        alpha_grad = Alphas(*(
            d - lr * ((p - n) / (2.0 * eps)) for d, p, n in zip(da, da_pos, da_neg)
        ))
        return alpha_grad, val_loss

    def alpha_grad_first_order(state: SearchState, lr, train_batch, val_batch):
        val_loss, _, da = _grads(loss_fn, state.weights, state.alphas, val_batch, False, True)
        return da, val_loss

    alpha_grad_fn = alpha_grad_unrolled if hyper.unrolled else alpha_grad_first_order

    def search_step(state: SearchState, train_batch, val_batch):
        lr = cosine_lr(state.step, hyper)

        # 1) architecture update
        a_grad, val_loss = alpha_grad_fn(state, lr, train_batch, val_batch)
        alphas, a_opt = alpha_update(a_grad, state.a_opt, state.alphas, hyper)

        # 2) weight update at the NEW alphas (reference run_trial.py:193-205)
        train_loss, gw, _ = _grads(loss_fn, state.weights, alphas, train_batch, True, False)
        keys = list(state.weights)
        g = [gw[k] for k in keys]
        torch._foreach_add_(g, [state.weights[k] for k in keys], alpha=hyper.w_weight_decay)
        gw, gnorm = clip_by_global_norm(dict(zip(keys, g)), hyper.w_grad_clip)
        velocity = torch._foreach_mul([state.velocity[k] for k in keys], hyper.w_momentum)
        torch._foreach_add_(velocity, [gw[k] for k in keys])
        velocity = dict(zip(keys, velocity))

        new_state = SearchState(
            step=state.step + 1,
            weights=_axpy(state.weights, velocity, -lr),
            alphas=alphas,
            a_opt=a_opt,
            velocity=velocity,
        )
        metrics = {
            "train_loss": train_loss,
            "val_loss": val_loss,
            "w_lr": lr,
            "grad_norm": gnorm,
        }
        if hyper.debug_alpha_grad:
            metrics["alpha_grad"] = a_grad
        return new_state, metrics

    return search_step


def init_search_state(weights: dict, alphas: Alphas, hyper: DartsHyper) -> SearchState:
    zeros = Alphas(*(torch.zeros_like(a) for a in alphas))
    device = alphas[0].device
    return SearchState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        weights={k: v.detach() for k, v in weights.items()},
        alphas=Alphas(*(a.detach() for a in alphas)),
        a_opt=AdamState(torch.zeros((), dtype=torch.int32, device=device), zeros, zeros),
        velocity={k: torch.zeros_like(v) for k, v in weights.items()},
    )


def state_items(state: SearchState) -> list[tuple[str, torch.Tensor]]:
    """The state's tensors under their key paths, in one fixed order: what a
    checkpoint stores and its digest hashes, and what a graph's fixed
    buffers are copied from."""
    return [
        ("step", state.step),
        *((f"weights/{k}", v) for k, v in state.weights.items()),
        *((f"alphas/{n}", t) for n, t in zip(Alphas._fields, state.alphas)),
        ("a_opt/count", state.a_opt.count),
        *((f"a_opt/mu/{n}", t) for n, t in zip(Alphas._fields, state.a_opt.mu)),
        *((f"a_opt/nu/{n}", t) for n, t in zip(Alphas._fields, state.a_opt.nu)),
        *((f"velocity/{k}", v) for k, v in state.velocity.items()),
    ]


def state_from_items(template: SearchState, tensors) -> SearchState:
    """A state shaped like ``template`` holding ``tensors`` (in
    :func:`state_items` order)."""
    it = iter(tensors)
    take = lambda: next(it)  # noqa: E731
    step = take()
    weights = {k: take() for k in template.weights}
    alphas = Alphas(*(take() for _ in Alphas._fields))
    count = take()
    mu = Alphas(*(take() for _ in Alphas._fields))
    nu = Alphas(*(take() for _ in Alphas._fields))
    velocity = {k: take() for k in template.velocity}
    return SearchState(step, weights, alphas, AdamState(count, mu, nu), velocity)


def copy_state_(dst: SearchState, src: SearchState) -> None:
    """Write ``src`` into ``dst``'s tensors in place (a captured graph
    replays against fixed addresses)."""
    torch._foreach_copy_([t for _, t in state_items(dst)], [t for _, t in state_items(src)])


def clone_state(state: SearchState) -> SearchState:
    return state_from_items(state, [t.clone() for _, t in state_items(state)])
