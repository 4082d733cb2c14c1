"""Tunable long-context transformer LM (port of ``katib_tpu/models/transformer.py``).

A decoder-only transformer whose attention runs through the hand-written
flash kernels (``katib_tpu_torch.ops.flash_attention``) on the card and
through their plain versions on the CPU.  Tunable parameters understood by
``transformer_trial``: lr, d_model, n_heads, n_layers, seq_len, n_seq,
batch_size, steps, warmup_frac, dropout, attn, vocab_size, data_seed.

The modules follow flax's layout and numerics: ``Dense`` kernels are
``(in, out)``, parameters are float32 and the compute type (bf16 by
default) is applied at use, LayerNorm has eps 1e-6 and float32 statistics,
the MLP uses the tanh-approximate GELU, and the vocab projection is float32.
The head split makes q, k and v contiguous ``[B, H, S, D]`` (one copy of
the qkv projection) because the CUDA kernels take contiguous inputs.

The training task is the JAX package's synthetic first-order Markov
language-modelling problem, made by the same numpy draws.

On a mesh (``parallel/mesh.py``) the attention is sequence-parallel when the
mesh has a ``seq`` axis (``parallel/ring_attention.py``, ring or Ulysses),
and ``train_lm`` runs one replica of the model per grid entry on its data
chunk of the tokens, the parameters broadcast from their home copy and the
loss the mean over the replicas, so the gradient is that of the global
batch (``parallel/collectives.py``).
"""

from __future__ import annotations

import contextlib
import copy
import time
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from katib_tpu_torch.device import resolve_device
from katib_tpu_torch.models.layers import Dense, Embed, LayerNorm
from katib_tpu_torch.ops.flash_attention import (
    count_launches,
    flash_attention,
    recording_launches,
    reference_attention,
)
from katib_tpu_torch.parallel import collectives
from katib_tpu_torch.parallel.mesh import DATA_AXIS, on_data_axis, piece, shard_batch
from katib_tpu_torch.parallel.ring_attention import make_sequence_parallel_attention
from katib_tpu_torch.parallel.train import (
    AdamWState,
    adamw_init,
    adamw_update_,
    clip_by_global_norm,
    warmup_cosine_decay,
)


# The repo's long-context configuration, as ``transformer_trial`` parameters:
# the LM leg of scripts/run_longcontext_tpu.py (bf16, causal attention).
LONG_CONTEXT = {"vocab_size": 256, "d_model": 512, "n_heads": 8, "n_layers": 4,
                "seq_len": 4096, "batch_size": 4}


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout (flax ``nn.Dropout``): keep each element with
    probability ``1 - rate`` and scale the kept ones by ``1 / (1 - rate)``.
    The draws come from ``generator`` (on ``x``'s device); they cannot match
    ``jax.random``'s bits.  Inside a replica of a mesh the mask is drawn once
    for the global batch (at a rendezvous of the replicas, on the
    generator's device) and each replica takes its data chunk's rows, so a
    sharded run draws what the unsharded run draws."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    replica = collectives.current_replica()
    if replica is None:
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    else:
        mesh = replica.mesh
        n = mesh.axis_size(DATA_AXIS)

        def draw(_):
            full = torch.rand((x.shape[0] * n, *x.shape[1:]), generator=generator,
                              device=generator.device if generator is not None else x.device)
            rows = full.chunk(n, dim=0)
            return [rows[mesh.coord(r, DATA_AXIS)].to(mesh.entries[r]) for r in range(mesh.size)]

        mask = collectives.exchange(None, draw) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Block(nn.Module):
    """Pre-norm transformer block; children in flax's creation order
    (``LayerNorm_0``, ``Dense_0`` qkv, ``Dense_1`` out, ``LayerNorm_1``,
    ``Dense_2``, ``Dense_3``)."""

    def __init__(self, d_model: int, n_heads: int, attn_fn: Callable, dropout: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.n_heads, self.attn_fn, self.dropout, self.dtype = n_heads, attn_fn, dropout, dtype
        self.ln1 = LayerNorm(d_model, dtype)
        self.qkv = Dense(d_model, 3 * d_model, use_bias=False, dtype=dtype)
        self.proj = Dense(d_model, d_model, use_bias=False, dtype=dtype)
        self.ln2 = LayerNorm(d_model, dtype)
        self.fc1 = Dense(d_model, 4 * d_model, dtype=dtype)
        self.fc2 = Dense(4 * d_model, d_model, dtype=dtype)

    def forward(self, x, deterministic: bool = True, generator=None):
        rate = 0.0 if deterministic else self.dropout
        b, s, d = x.shape
        qkv = self.qkv(self.ln1(x))
        # [B, S, 3*D] -> three contiguous [B, H, S, d_head] (one copy)
        q, k, v = qkv.reshape(b, s, 3, self.n_heads, d // self.n_heads).permute(
            2, 0, 3, 1, 4).contiguous().unbind(0)
        o = self.attn_fn(q, k, v)
        o = o.transpose(1, 2).reshape(b, s, d).to(self.dtype)
        x = x + dropout(self.proj(o), rate, generator)
        h = self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="tanh"))
        return x + dropout(h, rate, generator)


class TransformerLM(nn.Module):
    """Decoder-only LM: token and position embeddings, ``n_layers`` blocks,
    a final LayerNorm and a float32 vocab projection."""

    def __init__(self, vocab_size: int, d_model: int = 128, n_heads: int = 4,
                 n_layers: int = 2, max_seq_len: int = 2048, dropout: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, attn_fn: Callable | None = None):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of n_heads {n_heads}")
        attn = attn_fn if attn_fn is not None else _dense_causal_attention
        self.dropout, self.dtype = dropout, dtype
        self.tok_embed = Embed(vocab_size, d_model, dtype)
        self.pos_embed = Embed(max_seq_len, d_model, dtype)
        self.blocks = nn.ModuleList(
            Block(d_model, n_heads, attn, dropout, dtype) for _ in range(n_layers)
        )
        self.ln_f = LayerNorm(d_model, dtype)
        self.head = Dense(d_model, vocab_size, dtype=torch.float32)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Draw every parameter anew from ``generator`` with flax's default
        initializers (lecun-normal kernels, zero biases, unit LayerNorm
        scales, normal(1/features) embeddings)."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, tokens, deterministic: bool = True, generator=None):
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        x = self.tok_embed(tokens) + self.pos_embed(positions)
        for block in self.blocks:
            x = block(x, deterministic, generator)
        return self.head(self.ln_f(x))


def _dense_causal_attention(q, k, v):
    return reference_attention(q, k, v, causal=True)


def make_attention_fn(mesh=None, strategy: str = "ring"):
    """Attention for a trial: on one device the flash kernels on a CUDA
    tensor and the plain version on a CPU one; on a mesh, sequence-parallel
    ``strategy`` (``ring`` or ``ulysses``) over its ``seq`` axis, over the
    same kernels (a mesh without one attends on each replica alone)."""
    if mesh is not None:
        return make_sequence_parallel_attention(mesh, strategy=strategy, causal=True)

    def attention(q, k, v):
        if q.device.type == "cuda":
            return flash_attention(q, k, v, causal=True)
        return reference_attention(q, k, v, causal=True)

    return attention


# ---------------------------------------------------------------------------
# synthetic Markov LM data
# ---------------------------------------------------------------------------


def markov_dataset(
    vocab_size: int, n_seq: int, seq_len: int, *, seed: int = 0, branching: int = 4
) -> np.ndarray:
    """Token sequences from a fixed sparse first-order Markov chain: every
    token has ``branching`` likely successors, so the optimal next-token loss
    is about log(branching), far below log(vocab) for an untrained model.
    The JAX package's draws, so the tokens are the same for the same seed."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab_size, size=(vocab_size, branching))
    out = np.empty((n_seq, seq_len), np.int32)
    state = rng.integers(0, vocab_size, size=n_seq)
    for t in range(seq_len):
        out[:, t] = state
        pick = rng.integers(0, branching, size=n_seq)
        state = succ[state, pick]
    return out


# ---------------------------------------------------------------------------
# training loop
# ---------------------------------------------------------------------------


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy over ``[B, S, V]`` logits / ``[B, S]`` tokens."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:].long()[..., None])[..., 0]
    return nll.mean()


class LMTrainStep:
    """``step(tokens) -> loss``: one update of ``model`` (on its device) on a
    ``[B, S]`` token batch, as the JAX ``train_lm``'s ``step_fn`` (which the
    JAX package jits with its state donated): next-token loss, global-norm
    clipping at ``grad_clip``, then ``optax.adamw`` with weight decay 0.01
    under the warmup-cosine schedule over ``steps``.

    The state lives in fixed tensors: the model's parameters, the AdamW
    moments and a 0-d update count on the device, from which the step
    computes its own learning rate, and a token buffer each call fills.  On
    a CUDA device the step is warmed up on copies of every buffer, captured
    once as a CUDA graph (``nas/darts/step_loop.py::capture_step``: the
    thread's capture stream, the device's capture lock, the cyclic
    collector held off) and replayed; on the CPU, or with
    ``capture=False``, the same function runs eagerly on the same buffers.
    Dropout, when the model has it, draws from a generator seeded
    ``seed + 1`` on the model's device, registered with the graph so each
    replay draws what an eager step would.  The flash kernels' launches in
    the capture are tallied by stream (``launches_per_replay``) and counted
    on each replay.

    With a ``mesh`` the loss is the global batch's (:func:`mesh_lm_loss`:
    the parameters broadcast from the model's, a replica of the model per
    grid entry on its data chunk, ring or Ulysses attention across its
    ``seq`` axis), and the update runs once, at home.  A mesh of one card
    is captured the same way, on the mesh's leased stream, so one graph
    holds every replica's work (``step_loop.py::mesh_capture_stream``); a
    mesh over distinct devices steps eagerly, and ``capture=True`` raises
    there."""

    def __init__(self, model: TransformerLM, *, lr: float, steps: int, warmup_frac: float = 0.1,
                 grad_clip: float = 1.0, seed: int = 0, mesh=None,
                 capture: bool | None = None):
        # imported here: the step loop's modules import the model layers
        from katib_tpu_torch.nas.darts.step_loop import mesh_capture_stream, mesh_captures

        self.model, self.mesh, self.grad_clip = model, mesh, grad_clip
        self.names = [n for n, _ in model.named_parameters()]
        self.device = next(model.parameters()).device
        if capture is None:
            capture = self.device.type == "cuda" and (mesh is None or mesh_captures(mesh))
        if capture and self.device.type != "cuda":
            raise ValueError("a captured LM step needs the model on a CUDA device")
        self.capture = capture
        # a mesh's leased stream (raises for distinct devices), else the thread's
        self.stream = mesh_capture_stream(mesh, self.device) if capture else None
        self.mesh_loss = mesh_lm_loss(model, mesh) if mesh is not None else None
        self.schedule = warmup_cosine_decay(0.0, lr, max(1, int(steps * warmup_frac)), steps)
        self.gen = (torch.Generator(device=self.device).manual_seed(seed + 1)
                    if model.dropout > 0.0 else None)
        self.params = [p for _, p in model.named_parameters()]
        self.opt = adamw_init(self.params)
        self.loss = torch.zeros((), dtype=torch.float32, device=self.device)
        self.bufs: tuple | None = None  # (params, opt, tokens, loss): the graph's
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches_per_replay: dict[str, int] = {}
        self.capture_s = 0.0

    def _loss(self, params: list, tokens: torch.Tensor) -> torch.Tensor:
        deterministic = self.gen is None
        if self.mesh_loss is not None:
            return self.mesh_loss(dict(zip(self.names, params)), tokens, deterministic,
                                  self.gen)
        logits = torch.func.functional_call(
            self.model, dict(zip(self.names, params)), (tokens,),
            {"deterministic": deterministic, "generator": self.gen})
        return lm_loss(logits, tokens)

    def _step(self, bufs) -> None:
        """One update on ``bufs``, written back into them: the function that
        is captured, and that runs eagerly off the graph."""
        params, opt, tokens, loss_out = bufs
        with torch.enable_grad(), (self.mesh.on_streams() if self.mesh is not None
                                   else contextlib.nullcontext()):
            loss = self._loss(params, tokens)
            grads = torch.autograd.grad(loss, params)
        clipped, _ = clip_by_global_norm(dict(enumerate(grads)), self.grad_clip)
        lr = self.schedule(opt.count)  # optax reads the count before the update
        adamw_update_(params, clipped.values(), opt, lr)
        loss_out.copy_(loss.detach())

    def _build_graph(self, tokens: torch.Tensor) -> None:
        # imported here: the step loop's modules import the model layers
        from katib_tpu_torch.nas.darts.step_loop import capture_step

        def copy(bufs):
            params, opt, tokens, loss = bufs
            return ([p.detach().clone().requires_grad_() for p in params],
                    AdamWState(opt.count.clone(), [t.clone() for t in opt.mu],
                               [t.clone() for t in opt.nu]),
                    tokens.clone(), loss.clone())

        self.bufs = (self.params, self.opt, tokens.clone(), self.loss)
        gens = (self.gen,) if self.gen is not None else ()
        self.graph, self.launches_per_replay, self.capture_s = capture_step(
            self._step, self.bufs, copy, self.device, stream=self.stream, generators=gens,
            recording=recording_launches)

    def __call__(self, tokens: torch.Tensor) -> torch.Tensor:
        """One step on ``tokens`` (on the model's device; with a mesh, the
        global batch, which the step places on the data axis)."""
        if not self.capture:
            self._step((self.params, self.opt, tokens, self.loss))
            return self.loss.clone()
        if self.graph is None:
            self._build_graph(tokens)
        else:
            self.bufs[2].copy_(tokens)
        self.graph.replay()
        count_launches(self.device, **self.launches_per_replay)
        return self.loss.clone()


def mesh_lm_loss(model: TransformerLM, mesh) -> Callable:
    """``loss(params, tokens, deterministic=True, generator=None)`` of
    ``model`` over ``mesh``: ``tokens`` (the global batch on the home
    device, or already on the data axis) are placed on the data axis, the
    ``{name: tensor}`` parameters are broadcast from their home copy, each
    replica runs a copy of the model on its chunk (``functional_call``
    rebinds a module's parameters while it runs, so each replica has its
    own), and the replicas' mean losses meet at home as their mean, at a
    rendezvous (``collectives.replica_mean_to_home``)."""
    replicas = [model] + [copy.deepcopy(model) for _ in range(1, mesh.size)]

    def loss(params: dict, tokens, deterministic: bool = True, generator=None) -> torch.Tensor:
        tokens = on_data_axis(tokens, mesh)
        ps = collectives.broadcast(params, mesh)

        def one(r):
            t = piece(tokens, r)
            logits = torch.func.functional_call(replicas[r], ps[r], (t,), {
                "deterministic": deterministic, "generator": generator})
            return collectives.replica_mean_to_home(lm_loss(logits, t))

        return mesh.run(one)[0]

    return loss


def train_lm(
    model: TransformerLM,
    data: np.ndarray,
    *,
    lr: float,
    steps: int,
    batch_size: int,
    warmup_frac: float = 0.1,
    grad_clip: float = 1.0,
    mesh=None,
    seed: int = 0,
    report=None,
    report_every: int = 10,
    device: str | torch.device | None = None,
    step_times: list | None = None,
) -> float:
    """Train ``model`` (its parameters set beforehand) on ``data`` [N, S];
    returns the final eval loss on a held-out tail.

    Calls ``report(step, loss, eval_loss)`` every ``report_every`` steps and
    on the last one, and stops when it returns False.  The held-out split
    and the batch indices are the JAX package's draws from
    ``np.random.default_rng(seed)``.  Runs on ``device`` (``cuda`` unless the
    caller names another); ``step_times``, when given, receives each step's
    wall seconds, measured to the device's completion of the step.

    With a ``mesh`` the model trains on the mesh's devices (``device`` is
    its home device): the parameters stay on the home device, each batch and
    the held-out batch are placed on the data axis, and each step's loss is
    that of the global batch (:func:`mesh_lm_loss`), captured on a mesh of
    one card as on one device (:class:`LMTrainStep`)."""
    dev = resolve_device(device) if mesh is None else mesh.home
    rng = np.random.default_rng(seed)
    n_eval = max(batch_size, len(data) // 10)
    train, heldout = data[:-n_eval], data[-n_eval:]
    model.to(dev)
    step = LMTrainStep(model, lr=lr, steps=steps, warmup_frac=warmup_frac,
                       grad_clip=grad_clip, seed=seed, mesh=mesh)

    def place(tokens: np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tokens)).to(dev, torch.long)

    def eval_loss_now() -> float:
        with torch.no_grad():
            if step.mesh_loss is not None:
                with mesh.on_streams():
                    return float(step.mesh_loss(dict(model.named_parameters()), eval_tokens))
            return float(lm_loss(model(eval_tokens), eval_tokens))

    eval_tokens = place(heldout[:batch_size])
    if mesh is not None:
        eval_tokens = shard_batch(eval_tokens, mesh)
    eval_loss: float | None = None
    for s in range(steps):
        idx = rng.integers(0, len(train), size=batch_size)
        t_step = time.perf_counter()
        loss = step(place(train[idx]))
        if step_times is not None:
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            step_times.append(time.perf_counter() - t_step)
        eval_loss = None  # stale after this step's update
        if report is not None and (s % report_every == 0 or s == steps - 1):
            eval_loss = eval_loss_now()
            if report(step=s, loss=float(loss), eval_loss=eval_loss) is False:
                break
    if eval_loss is None:
        eval_loss = eval_loss_now()
    return eval_loss


# -- the white-box trial function -------------------------------------------


def transformer_trial(ctx) -> None:
    """White-box trial: tunable long-context LM reporting train/eval loss.

    Runs on ``ctx.device`` (``cuda`` unless it names the CPU), or on
    ``ctx.mesh`` when the trial has one: sequence-parallel attention
    (``attn``: ring or ulysses) over its ``seq`` axis, the batch over its
    ``data`` axis.  Weights are drawn from a ``torch.Generator`` seeded
    with 0."""
    p = ctx.params
    vocab = int(p.get("vocab_size", 256))
    seq_len = int(p.get("seq_len", 512))
    mesh = getattr(ctx, "mesh", None)
    strategy = str(p.get("attn", "ring"))
    attn_fn = make_attention_fn(mesh, strategy=strategy)
    dev = resolve_device(getattr(ctx, "device", None)) if mesh is None else mesh.home

    model = TransformerLM(
        vocab_size=vocab,
        d_model=int(p.get("d_model", 128)),
        n_heads=int(p.get("n_heads", 4)),
        n_layers=int(p.get("n_layers", 2)),
        max_seq_len=seq_len,
        dropout=float(p.get("dropout", 0.0)),
        attn_fn=attn_fn,
    )
    model.reset_parameters(torch.Generator().manual_seed(0))
    data = markov_dataset(
        vocab, int(p.get("n_seq", 512)), seq_len, seed=int(p.get("data_seed", 0))
    )

    def report(step, loss, eval_loss):
        return ctx.report(step=step, loss=loss, eval_loss=eval_loss)

    train_lm(
        model,
        data,
        lr=float(p.get("lr", 3e-3)),
        steps=int(p.get("steps", 60)),
        batch_size=int(p.get("batch_size", 16)),
        warmup_frac=float(p.get("warmup_frac", 0.1)),
        mesh=mesh,
        report=report,
        device=dev,
        step_times=getattr(ctx, "step_times", None),
    )
