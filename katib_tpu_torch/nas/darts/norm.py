"""Training-mode batch normalization of the DARTS networks, over the global
batch on a mesh, and its recompute under remat.

Stateless BN without affine parameters, as in the JAX package: f32
statistics with the population variance, the result in the input's dtype.
Off a mesh (or on a data axis of 1) it is one fused ``F.batch_norm``.

Inside a replica of a mesh whose data axis splits the batch
(``parallel/collectives.py``) the statistics are those of the global batch,
as the JAX package's ``jnp.mean`` over a batch sharded on ``data`` gives
them.  It is SyncBatchNorm's computation as three autograd nodes, each a
kernel or two (CUDA: SyncBatchNorm's own kernels; CPU: the same formulas
in float32):

- :class:`_LocalStats`: the replica's chunk's per-channel ``(mean,
  invstd)`` (``batch_norm_stats``), and ``x`` passed through;
- :class:`_Combine`, at a rendezvous of the replicas (``collectives.
  exchange``): the global ``(mean, invstd)`` of one data group
  (``batch_norm_gather_stats_with_counts``), handed to each replica;
- :class:`_Normalize`: ``(x - mean) * invstd`` of the chunk
  (``batch_norm_elemt``).

The tensors between the three nodes are theirs alone, and so are the
values their backward passes hand each other, which are SyncBatchNorm's
rather than the gradients of those tensors: :class:`_Normalize` hands back
its chunk's ``sum(dy)`` and ``sum(dy * (x - mean))``
(``batch_norm_backward_reduce``) and ``dy`` itself; :class:`_Combine` sums
the sums over the group; :class:`_LocalStats` computes the chunk's whole
input gradient from ``dy`` and the global sums in one kernel
(``batch_norm_backward_elemt``).  The gradient that leaves the three, with
respect to ``x``, is the global batch norm's.

**Remat on a mesh.**  A cell recomputed in the backward pass runs on
autograd's device thread (the CPU: the caller's), outside every replica,
where no rendezvous can be made.  The combined statistics need none: a
recompute re-runs the chunk's own :class:`_LocalStats` (so it saves what
the forward saved, in the same order) and takes the global statistics
that the forward exchanged from a per-call stash (:func:`remat_stash`, one
per checkpointed call, taken back in call order), so it repeats the forward
bit for bit.  The backward still runs through the forward's own
:class:`_Combine` node, whose ``[C]`` tensors it keeps itself.

A cost count counts all three as the fused ``native_batch_norm`` of a single
device is counted: their bytes and no flops (``costmodel/counter.py::
as_normalization``).
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from katib_tpu_torch.costmodel.counter import as_normalization
from katib_tpu_torch.parallel import collectives
from katib_tpu_torch.parallel.mesh import DATA_AXIS

_CHANNEL = (1, -1, 1, 1)
_DIMS = (0, 2, 3)

_stash = threading.local()


def _normalization(fn):
    """``fn`` (a Function's forward or backward) counted as one fused
    normalization call is by a cost count (``costmodel/counter.py``)."""

    def counted(*args):
        with as_normalization():
            return fn(*args)

    return counted


class _Stash:
    """The ``(mean, invstd)`` pairs one checkpointed call exchanged in its
    forward, in call order; a recompute takes them back in the same order."""

    def __init__(self):
        self.pairs: list = []
        self.replaying = False
        self.next = 0

    def take(self):
        pair = self.pairs[self.next]
        self.next += 1
        return pair


@contextlib.contextmanager
def _stash_active(stash: _Stash):
    prev = getattr(_stash, "active", None)
    _stash.active = stash
    try:
        yield
    finally:
        _stash.active = prev
        stash.replaying, stash.next = True, 0


def remat_stash(fn):
    """``fn`` (a function to checkpoint) with a stash of its own when this
    thread is a replica of a mesh with a data axis > 1, else ``fn``: the
    first run of the result (the forward) records the statistics its batch
    norms exchange; every later run (a recompute, on whatever thread)
    replays them."""
    replica = collectives.current_replica()
    if replica is None or replica.mesh.axis_size(DATA_AXIS) == 1:
        return fn
    stash = _Stash()

    def stashed(*args):
        with _stash_active(stash):
            return fn(*args)

    return stashed


def batch_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Training-mode BN over (N, H, W) of NCHW ``x``, no affine, stateless
    (the module doc): one fused operator off a mesh; over the global batch
    inside a replica of a mesh with a data axis > 1; from the forward's
    statistics in a recompute under remat."""
    stash = getattr(_stash, "active", None)
    if stash is not None and stash.replaying:
        stats, total = stash.take()
        _, x = _LocalStats.apply(x, eps, total)  # saves what the forward saved
        return _Normalize.apply(x, stats)
    replica = collectives.current_replica()
    if replica is None or replica.mesh.axis_size(DATA_AXIS) == 1:
        return F.batch_norm(x, None, None, training=True, eps=eps)
    mesh = replica.mesh
    # the data group's chunks are equal (the batch splits evenly on the axis)
    total = x.numel() // x.shape[1] * mesh.axis_size(DATA_AXIS)
    local, x = _LocalStats.apply(x, eps, total)
    stats = collectives.exchange((x.numel() // x.shape[1], x.dtype, local),
                                 lambda vals: _combine(vals, mesh, eps))
    if stash is not None:
        stash.pairs.append((stats, total))
    return _Normalize.apply(x, stats)


def _combine(vals: list, mesh, eps: float) -> list:
    """The global ``[2, C]`` ``(mean, invstd)`` of each entry's data group,
    on the entry's device, from each entry's ``(count, dtype, local)``."""
    out: list = [None] * mesh.size
    for group in mesh.groups(DATA_AXIS):
        counts = tuple(vals[i][0] for i in group)
        stats = _Combine.apply(eps, counts, vals[group[0]][1], *(vals[i][2] for i in group))
        for k, i in enumerate(group):
            out[i] = stats[k]
    return out


def _device_counts(counts, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``counts`` as a tensor on ``device``: a device fill, never a host
    copy (the step is captured)."""
    if len(set(counts)) == 1:
        return torch.full((len(counts),), counts[0], dtype=dtype, device=device)
    return torch.stack([torch.full((), n, dtype=dtype, device=device) for n in counts])


class _LocalStats(torch.autograd.Function):
    """A chunk's float32 ``(mean, invstd)`` as rows 0-1 of a ``[4, C]``
    tensor (rows 2-3 are the places of the global statistics in its
    backward), and ``x`` itself, which only :class:`_Normalize` reads.
    Backward, from ``dy`` (handed to ``x``'s output) and the global ``[4,
    C]`` ``(sum(dy), sum(dy * (x - mean)), mean, invstd)`` (handed to the
    statistics) over the group's ``total`` elements: ``(dy - sum(dy) /
    total - (x - mean) * invstd^2 * sum(dy * (x - mean)) / total) *
    invstd``."""

    @staticmethod
    @_normalization
    def forward(ctx, x, eps, total):
        if x.is_cuda:
            mean, invstd = torch.batch_norm_stats(x, eps)
            # the kernel's count: one int32 entry holding the total (a
            # device fill, never a host copy: the step is captured)
            ctx.count = torch.full((1,), total, dtype=torch.int32, device=x.device)
        else:
            var, mean = torch.var_mean(x.float(), dim=_DIMS, correction=0)
            invstd = torch.rsqrt(var + eps)
        ctx.total = total
        ctx.save_for_backward(x)
        return torch.stack([mean, invstd, mean, invstd]), x

    @staticmethod
    @_normalization
    def backward(ctx, g_stats, dy):
        (x,) = ctx.saved_tensors
        sum_dy, sum_dy_xmu, mean, invstd = g_stats
        dy = dy.contiguous()
        if x.is_cuda:
            dx = torch.batch_norm_backward_elemt(dy, x, mean, invstd, None, sum_dy, sum_dy_xmu,
                                                 ctx.count)
        else:
            n = ctx.total
            xmu = x.float() - mean.view(_CHANNEL)
            dx = ((dy.float() - (sum_dy / n).view(_CHANNEL)
                   - xmu * (invstd * invstd * sum_dy_xmu / n).view(_CHANNEL))
                  * invstd.view(_CHANNEL)).to(x.dtype)
        return dx, None, None


class _Combine(torch.autograd.Function):
    """The global ``[2, C]`` ``(mean, invstd)`` of one data group from its
    chunks' statistics (rows 0-1, entry order) and element counts,
    returned once per chunk on its device (CUDA: SyncBatchNorm's
    ``batch_norm_gather_stats_with_counts``; CPU: with ``w_r = n_r / N``
    and ``var_r = invstd_r^-2 - eps``, ``mean = sum w_r mean_r``, ``var =
    sum w_r (var_r + mean_r^2) - mean^2``).  Backward: the chunks' ``sum(dy)``
    and ``sum(dy * (x - mean))`` summed over the group, with the global
    statistics, to each chunk's :class:`_LocalStats`.  Its tensors are
    ``[C]`` and kept on ``ctx`` detached, outside any saved-tensor hooks (a
    checkpointed replica's among them)."""

    @staticmethod
    @_normalization
    def forward(ctx, eps, counts, dtype, *stats):
        home = stats[0].device
        local = torch.stack([t[:2].to(home) for t in stats])  # [R, 2, C]
        if local.is_cuda:
            mean, invstd = torch.batch_norm_gather_stats_with_counts(
                torch.empty(0, dtype=dtype, device=home), local[:, 0], local[:, 1], None, None,
                0.0, eps, _device_counts(counts, dtype, home))  # in the input's dtype
        else:
            w = torch.tensor([n / sum(counts) for n in counts]).view(-1, 1)
            means, invstds = local[:, 0], local[:, 1]
            mean = (w * means).sum(0)
            ex2 = (w * (invstds.pow(-2) - eps + means * means)).sum(0)
            invstd = torch.rsqrt(torch.clamp(ex2 - mean * mean, min=0.0) + eps)
        out = torch.stack([mean, invstd])
        ctx.kept = out.detach()
        ctx.devices = [t.device for t in stats]
        return tuple(out.to(d) for d in ctx.devices)

    @staticmethod
    @_normalization
    def backward(ctx, *grads):
        home = ctx.kept.device
        sums = grads[0].to(home)
        for g in grads[1:]:
            sums = sums + g.to(home)
        back = torch.cat([sums, ctx.kept])  # [4, C]: the sums, then mean and invstd
        return (None, None, None, *(back.to(d) for d in ctx.devices))


class _Normalize(torch.autograd.Function):
    """``(x - mean) * invstd`` per channel, in ``x``'s dtype, from the
    ``[2, C]`` global statistics.  Backward: ``dy`` itself to ``x``, and
    the chunk's ``sum(dy)`` and ``sum(dy * (x - mean))`` to the statistics
    (the module doc)."""

    @staticmethod
    @_normalization
    def forward(ctx, x, stats):
        ctx.save_for_backward(x, stats)
        mean, invstd = stats
        if x.is_cuda:
            return torch.batch_norm_elemt(x, None, None, mean, invstd, 0.0)
        return ((x.float() - mean.view(_CHANNEL)) * invstd.view(_CHANNEL)).to(x.dtype)

    @staticmethod
    @_normalization
    def backward(ctx, dy):
        x, stats = ctx.saved_tensors
        mean, invstd = stats
        dy = dy.contiguous()
        if x.is_cuda:
            sum_dy, sum_dy_xmu, _, _ = torch.batch_norm_backward_reduce(
                dy, x, mean, invstd, None, True, False, False)
        else:
            dy32 = dy.float()
            sum_dy = dy32.sum(dim=_DIMS)
            sum_dy_xmu = (dy32 * (x.float() - mean.view(_CHANNEL))).sum(dim=_DIMS)
        return dy, torch.stack([sum_dy, sum_dy_xmu])
