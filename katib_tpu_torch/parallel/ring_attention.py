"""Sequence parallelism: ring attention and all-to-all (Ulysses) attention
(port of ``katib_tpu/parallel/ring_attention.py``).

The JAX package runs both strategies under ``shard_map`` on the mesh's
``seq`` axis; here each replica of the mesh (``parallel/collectives.py``)
runs its local part, and the chunks move between the replicas through the
collectives.  A replica holds its data chunk of the batch over the whole
sequence (the model outside attention runs replicated over ``seq``); the
attention takes the replica's contiguous sequence chunk, as the JAX
``PartitionSpec(data, None, seq, None)`` gives it, and gathers the output
chunks back over ``seq``.

- **ring**: K/V chunks rotate around the ring (:func:`~katib_tpu_torch.
  parallel.collectives.ppermute`) while every replica keeps its Q chunk;
  partial outputs merge through the streaming-softmax identity on the
  per-row logsumexp of the inner kernel.  The accumulator stays float32
  across the ring, and the merge's logsumexp cotangent flows into the
  backward kernels (``dmd = rowsum(dO * O) - dlse``).
- **ulysses**: two all-to-alls re-shard [heads <-> sequence] so each replica
  attends over the full sequence for H/n heads; heads must divide by n.

The inner attention is ``ops/flash_attention.py::flash_attention_with_lse``:
the hand-written kernels on a CUDA tensor, the plain version on a CPU one.
Causality is decided per chunk: a replica's Q chunk attends fully to
earlier chunks, causally to its own, and skips later ones without a launch
(the JAX skip branch's logsumexp ``-1e30`` and zero output are an exact
no-op in the merge, so the port leaves the merge out as well).
"""

from __future__ import annotations

from typing import Callable

import torch

from katib_tpu_torch.ops.flash_attention import flash_attention_with_lse
from katib_tpu_torch.parallel import collectives
from katib_tpu_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS, Mesh, shard_batch

InnerAttention = Callable[..., tuple[torch.Tensor, torch.Tensor]]


def default_inner(q, k, v, causal: bool):
    """Per-chunk attention: the flash kernels on a CUDA tensor, their plain
    version on a CPU one (never SDPA)."""
    return flash_attention_with_lse(q.contiguous(), k.contiguous(), v.contiguous(), causal)


def _chunk(x: torch.Tensor, index: int, n: int) -> torch.Tensor:
    size = x.shape[2] // n
    return x[:, :, index * size:(index + 1) * size].contiguous()


def ring_attention_local(q, k, v, *, axis_name: str = SEQ_AXIS, axis_size: int,
                         causal: bool = True, inner: InnerAttention | None = None):
    """Ring attention for one replica: q/k/v ``[batch, heads, seq_local,
    head_dim]``, this replica's contiguous sequence chunk.  Call inside a
    replica of a mesh run (``Mesh.run``)."""
    inner = inner or default_inner
    replica = collectives.current_replica()
    my = replica.mesh.coord(replica.index, axis_name)
    o_acc = lse_acc = None
    k_cur, v_cur = k, v
    for t in range(axis_size):
        j = (my - t) % axis_size  # origin of the kv chunk this replica holds
        if not causal or j < my:
            o_i, lse_i = inner(q, k_cur, v_cur, False)
        elif j == my:
            o_i, lse_i = inner(q, k_cur, v_cur, True)
        else:
            o_i = None  # a later chunk: skipped, no launch
        if o_i is not None:
            if o_acc is None:
                o_acc, lse_acc = o_i.float(), lse_i
            else:
                lse_new = torch.logaddexp(lse_acc, lse_i)
                o_acc = (o_acc * torch.exp(lse_acc - lse_new)[..., None]
                         + o_i.float() * torch.exp(lse_i - lse_new)[..., None])
                lse_acc = lse_new
        if t < axis_size - 1:
            k_cur, v_cur = collectives.replica_ppermute((k_cur, v_cur), axis_name)
    return o_acc.to(q.dtype)


def ulysses_attention_local(q, k, v, *, axis_name: str = SEQ_AXIS, axis_size: int,
                            causal: bool = True, inner: InnerAttention | None = None):
    """All-to-all (DeepSpeed-Ulysses) attention for one replica: re-shard
    [B, H, S/n, D] -> [B, H/n, S, D], attend over the full sequence, shard
    back.  Heads must divide by the axis size."""
    inner = inner or default_inner
    if q.shape[1] % axis_size:
        raise ValueError(
            f"heads ({q.shape[1]}) must be a multiple of the seq-axis size ({axis_size})"
        )
    qg, kg, vg = (collectives.replica_all_to_all(x, axis_name, 1, 2) for x in (q, k, v))
    o, _ = inner(qg, kg, vg, causal)
    return collectives.replica_all_to_all(o, axis_name, 2, 1)


def make_sequence_parallel_attention(
    mesh: Mesh,
    *,
    strategy: str = "ring",
    causal: bool = True,
    axis_name: str = SEQ_AXIS,
    inner: InnerAttention | None = None,
) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """Build ``attn(q, k, v) -> o`` over ``[B, H, S, D]`` tensors.

    Inside a replica of ``mesh`` (a model running in ``Mesh.run``) q/k/v
    are the replica's data chunk over the whole sequence: the replica takes
    its sequence chunk, runs its part of the strategy, and gathers the
    output over ``seq``.  Called by the controller, q/k/v are global: the
    batch is placed on the data axis and the replicas run the same, the
    output coming back global on the home device.  A size-1 (or absent)
    seq axis degenerates to the single-device call of ``inner``."""
    axis_size = mesh.shape.get(axis_name, 1)
    inn = inner or default_inner
    if strategy not in ("ring", "ulysses"):
        raise ValueError(f"unknown sequence-parallel strategy {strategy!r}")
    local_fn = ring_attention_local if strategy == "ring" else ulysses_attention_local

    def attn_replica(q, k, v):
        if axis_size == 1:
            o, _ = inn(q, k, v, causal)
            return o
        r = collectives.current_replica()
        my = mesh.coord(r.index, axis_name)
        o = local_fn(_chunk(q, my, axis_size), _chunk(k, my, axis_size),
                     _chunk(v, my, axis_size), axis_name=axis_name, axis_size=axis_size,
                     causal=causal, inner=inner)
        return collectives.replica_all_gather(o, axis_name, 2)

    def attn(q, k, v):
        if collectives.current_replica() is not None:
            return attn_replica(q, k, v)
        if axis_size == 1:
            o, _ = inn(q, k, v, causal)
            return o
        placed = shard_batch((q, k, v), mesh)
        with mesh.on_streams():
            outs = mesh.run(lambda r: attn_replica(*(t.pieces[r] for t in placed)))
            # one replica per data coordinate carries that chunk's output
            rows = [g[0] for g in zip(*mesh.groups(DATA_AXIS))]
            return torch.cat([outs[r].to(mesh.home) for r in rows], dim=0)

    return attn
