"""ENAS controller: the LSTM architecture sampler and its REINFORCE trainer
(port of ``katib_tpu/nas/enas/controller.py``).

A single-cell LSTM samples one operation per layer and, from layer 1 on, an
attention-scored binary skip decision to every earlier layer; REINFORCE with
an entropy bonus, an EMA baseline and a KL skip-rate penalty trains it on
the children's validation accuracy.

The arithmetic is the JAX package's, step for step:

- :func:`_lstm` is one bias-free ``(2H, 4H)`` matrix over ``cat([x, h])``
  with the gates in the order i, f, o, g (not ``nn.LSTMCell``, which has
  biases and the order i, f, g, o);
- the entropy adds only the sampled action's ``-logp * exp(logp)``,
  detached; the skip KL uses ``sigmoid`` of the two skip logits; the penalty
  is divided by ``max(num_layers - 1, 1)``.

Tensors live on an explicit device and every draw comes from an explicit
``torch.Generator`` on that device (Gumbel-max over ``torch.rand``), so an
arc is sampled on the device without a host sync per layer; the one
transfer is :func:`arc_to_json`.  The draws are not the JAX package's
threefry streams, so the two packages propose different arcs from the same
seed; what they share is the distribution.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from katib_tpu_torch.models.mnist import AdamState, make_optimizer


class ControllerParams(NamedTuple):
    w_lstm: torch.Tensor  # (2H, 4H)
    g_emb: torch.Tensor  # (1, H)
    w_emb: torch.Tensor  # (num_ops, H)
    w_soft: torch.Tensor  # (H, num_ops)
    attn_w1: torch.Tensor  # (H, H)
    attn_w2: torch.Tensor  # (H, H)
    attn_v: torch.Tensor  # (H, 1)


class ControllerConfig(NamedTuple):
    """Defaults mirror ``AlgorithmSettings.py`` (hidden 64, temp 5.0, ...)."""

    num_layers: int = 8
    num_operations: int = 6
    hidden_size: int = 64
    temperature: float | None = 5.0
    tanh_const: float | None = 2.25
    entropy_weight: float | None = 1e-5
    baseline_decay: float = 0.999
    learning_rate: float = 5e-5
    skip_target: float = 0.4
    skip_weight: float | None = 0.8


class Arc(NamedTuple):
    ops: torch.Tensor  # (num_layers,) int64
    skips: torch.Tensor  # (num_layers, num_layers) lower-triangular 0/1, int64


def init_controller(cfg: ControllerConfig, generator: torch.Generator,
                    device: str | torch.device = "cpu") -> ControllerParams:
    """Uniform(-0.01, 0.01) weights drawn on the generator's device, in
    field order, then moved to ``device``."""
    h = cfg.hidden_size
    shapes = ((2 * h, 4 * h), (1, h), (cfg.num_operations, h), (h, cfg.num_operations),
              (h, h), (h, h), (h, 1))
    draw = lambda shape: (torch.rand(shape, generator=generator, device=generator.device)
                          * 0.02 - 0.01).to(device)
    return ControllerParams(*(draw(s) for s in shapes))


def _lstm(x, c, h, w):
    i, f, o, g = torch.chunk(torch.cat([x, h], dim=1) @ w, 4, dim=1)
    c2 = torch.sigmoid(i) * torch.tanh(g) + torch.sigmoid(f) * c
    return c2, torch.sigmoid(o) * torch.tanh(c2)


def _shape_logits(logits, cfg: ControllerConfig):
    if cfg.temperature is not None:
        logits = logits / cfg.temperature
    if cfg.tanh_const is not None:
        logits = cfg.tanh_const * torch.tanh(logits)
    return logits


def _gumbel_argmax(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of ``logits`` (last axis), on the device."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _trace(params: ControllerParams, cfg: ControllerConfig, arc: Arc | None,
           generator: torch.Generator | None = None):
    """Run the controller over a given arc, or sample one with
    ``generator``, accumulating log-probs, entropies and skip penalties.

    Either way the returned quantities are differentiable with respect to
    ``params`` for the supplied or sampled actions (the REINFORCE trick:
    re-evaluate log p(arc) on the stored arc)."""
    device = params.w_lstm.device
    h_size = cfg.hidden_size
    c = torch.zeros((1, h_size), device=device)
    h = torch.zeros((1, h_size), device=device)
    inputs = params.g_emb
    # filled on the device: a tensor built from a list, or a Python number
    # assigned to an element, would copy from the host (which a CUDA graph
    # capture refuses)
    skip_targets = torch.full((2,), cfg.skip_target, device=device)
    skip_targets[0].fill_(1.0 - cfg.skip_target)

    ops: list = []
    skips: list = []
    log_prob = 0.0
    entropy = 0.0
    skip_penalty = 0.0
    skip_count = 0.0
    all_h: list = []
    all_hw: list = []

    for layer in range(cfg.num_layers):
        c, h = _lstm(inputs, c, h, params.w_lstm)
        logits = _shape_logits(h @ params.w_soft, cfg)  # (1, num_ops)
        if generator is not None:
            op = _gumbel_argmax(logits[0], generator).reshape(1)
        else:
            op = arc.ops[layer].reshape(1).to(device, torch.int64)
        logp = torch.log_softmax(logits[0], dim=-1).gather(0, op)[0]
        log_prob = log_prob + logp
        entropy = entropy + (-logp * torch.exp(logp)).detach()
        ops.append(op[0])
        inputs = params.w_emb.index_select(0, op)

        c, h = _lstm(inputs, c, h, params.w_lstm)
        row = torch.zeros((cfg.num_layers,), dtype=torch.int64, device=device)
        if layer > 0:
            prev_h = torch.cat(all_h, dim=0)  # (layer, H)
            prev_hw = torch.cat(all_hw, dim=0)  # (layer, H)
            query = torch.tanh(h @ params.attn_w2 + prev_hw) @ params.attn_v  # (layer, 1)
            sk_logits = _shape_logits(torch.cat([-query, query], dim=1), cfg)  # (layer, 2)
            if generator is not None:
                sk = _gumbel_argmax(sk_logits, generator)
            else:
                sk = arc.skips[layer, :layer].to(device, torch.int64)
            logp_all = torch.log_softmax(sk_logits, dim=-1)
            logp_sk = logp_all.gather(1, sk[:, None]).sum()
            log_prob = log_prob + logp_sk
            entropy = entropy + (-logp_sk * torch.exp(logp_sk)).detach()
            # KL(skip distribution || target rate) penalty (Controller.py:156-159)
            skip_prob = torch.sigmoid(sk_logits)
            kl = (skip_prob * torch.log(skip_prob / skip_targets)).sum()
            skip_penalty = skip_penalty + kl
            skf = sk.to(torch.float32)
            skip_count = skip_count + skf.sum()
            inputs = (skf[None, :] @ prev_h) / (1.0 + skf.sum())
            row[:layer] = sk
        else:
            inputs = params.g_emb
        skips.append(row)
        all_h.append(h)
        all_hw.append(h @ params.attn_w1)

    out_arc = Arc(ops=torch.stack(ops), skips=torch.stack(skips))
    stats = {
        "log_prob": log_prob,
        "entropy": entropy,
        "skip_penalty": skip_penalty / max(cfg.num_layers - 1, 1),
        "skip_count": skip_count,
    }
    return out_arc, stats


def sample_arc(params: ControllerParams, cfg: ControllerConfig, generator: torch.Generator):
    """``(arc, stats)`` of one arc drawn with ``generator`` (on the
    parameters' device)."""
    return _trace(params, cfg, None, generator=generator)


class ReinforceState(NamedTuple):
    params: ControllerParams
    opt_state: AdamState
    baseline: torch.Tensor  # 0-d float32
    step: torch.Tensor  # 0-d int32


def make_reinforce(cfg: ControllerConfig, device: str | torch.device = "cpu"):
    """Build ``(init, train_step, sample)`` for controller REINFORCE
    training on ``device``: ``init(generator)`` draws the weights,
    ``train_step(state, arc, reward)`` is one ``optax.adam(learning_rate)``
    step, ``sample(params, generator)`` draws an arc without autograd."""
    tx = make_optimizer("adam", cfg.learning_rate)

    def init(generator: torch.Generator) -> ReinforceState:
        params = init_controller(cfg, generator, device)
        return ReinforceState(
            params=params,
            opt_state=tx.init(params._asdict()),
            baseline=torch.zeros((), device=device),
            step=torch.zeros((), dtype=torch.int32, device=device),
        )

    def train_step(state: ReinforceState, arc: Arc, reward):
        """One REINFORCE step on an arc with its observed reward
        (``build_trainer``: reward += entropy bonus; EMA baseline; loss =
        -log_prob * (reward - baseline) + skip_weight * skip_penalty)."""
        params = {k: v.detach().requires_grad_() for k, v in state.params._asdict().items()}
        _, stats = _trace(ControllerParams(**params), cfg, arc)
        r = torch.as_tensor(reward, dtype=torch.float32, device=state.baseline.device)
        if cfg.entropy_weight is not None:
            r = r + cfg.entropy_weight * stats["entropy"]
        baseline = state.baseline - (1.0 - cfg.baseline_decay) * (state.baseline - r)
        # REINFORCE under gradient DESCENT: loss = -log p * advantage (the
        # reference's log_probs are TF cross-entropies, i.e. already -log p)
        loss = -stats["log_prob"] * (r - baseline).detach()
        if cfg.skip_weight is not None:
            loss = loss + cfg.skip_weight * stats["skip_penalty"]
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                     allow_unused=True,
                                                     materialize_grads=True)))
        new, opt_state = tx.update(grads, state.opt_state, state.params._asdict())
        return (
            ReinforceState(ControllerParams(**new), opt_state, baseline.detach(),
                           state.step + 1),
            {"loss": loss.detach(), "baseline": baseline.detach()},
        )

    def sample(params: ControllerParams, generator: torch.Generator):
        with torch.no_grad():
            return sample_arc(params, cfg, generator)

    return init, train_step, sample


def arc_to_json(arc: Arc) -> list:
    """Serialize for the trial parameter (nested lists: per layer
    ``[op_id, skip...]``); the arc's one transfer to the host."""
    ops = arc.ops.tolist()
    skips = arc.skips.tolist()
    return [[int(op)] + [int(s) for s in skips[layer][:layer]] for layer, op in enumerate(ops)]


def arc_from_json(data: list, num_layers: int) -> Arc:
    ops = torch.zeros((num_layers,), dtype=torch.int64)
    skips = torch.zeros((num_layers, num_layers), dtype=torch.int64)
    for layer, row in enumerate(data):
        ops[layer] = row[0]
        for j, s in enumerate(row[1:]):
            skips[layer, j] = s
    return Arc(ops=ops, skips=skips)
