"""Differentiable collectives and the replica runner of a mesh.

The JAX package has no module like this one: under GSPMD the partitioner
inserts the collectives a sharded program needs.  The port writes a sharded
step as one computation over per-replica shards instead, and tensors move
between replicas only through the functions here, each built from
differentiable operations, so ``torch.autograd`` gives the gradient of the
global computation as ``jax.grad`` does under GSPMD:

- :func:`broadcast` from the home copy (backward: the replicas' cotangents
  summed to home);
- :func:`reduce_to_home`, the transpose of :func:`broadcast`;
- :func:`all_reduce` (sum), :func:`all_gather`, :func:`all_to_all` and
  :func:`ppermute` (a rotation along one axis, for the ring).

Each takes and returns one value per grid entry, in entry order.  A value
moves only between distinct devices (a peer copy, ``Tensor.to``); entries
that repeat a device share the tensor, so a grid over one card moves
nothing.  The route follows from the devices the caller gave the mesh.

:class:`ReplicaRunner` runs a function once per entry, each on a thread of
its own, with that entry's device current and the device's leased stream
(``nas/darts/step_loop.py::lease_stream``) as its stream: one stream per
distinct device, so replicas that share a card are ordered on one stream
and nothing waits on the whole device.  Inside a replica, :func:`exchange`
is the rendezvous: every replica hands in its value, the collective runs
once over all of them, and each gets its own result back.  Batch
normalization over the global batch (``nas/darts/ops.py::batch_norm``), the
ring and Ulysses attention (``parallel/ring_attention.py``) and dropout's
global masks (``models/transformer.py``) are built on it.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, NamedTuple, Sequence

import torch
from torch.utils._pytree import tree_map


class Replica(NamedTuple):
    """The replica a thread runs: its mesh, entry index and device."""

    mesh: Any
    index: int
    device: torch.device


_local = threading.local()


def current_replica() -> Replica | None:
    """The replica this thread runs, or ``None`` outside a mesh run."""
    return getattr(_local, "replica", None)


def replica_index() -> int:
    r = current_replica()
    return 0 if r is None else r.index


def _move(x, device: torch.device):
    return tree_map(lambda t: t if not isinstance(t, torch.Tensor) or t.device == device
                    else t.to(device), x)


# -- collectives over one value per entry --------------------------------------


def broadcast(x, mesh) -> list:
    """The home copy ``x`` on every entry (a pytree of tensors)."""
    return [_move(x, d) for d in mesh.entries]


def _sum_on(xs: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    total = None
    for x in xs:
        x = _move(x, device)
        total = x if total is None else total + x
    return total


def reduce_to_home(xs: Sequence[torch.Tensor], mesh) -> torch.Tensor:
    """The sum of the entries' tensors, on the home device."""
    return _sum_on(xs, mesh.home)


def all_reduce(xs: Sequence[torch.Tensor], mesh, axes) -> list:
    """Each entry gets the sum over its group along ``axes``."""
    out: list = [None] * mesh.size
    for group in mesh.groups(axes):
        total = _sum_on([xs[i] for i in group], mesh.entries[group[0]])
        for i in group:
            out[i] = _move(total, mesh.entries[i])
    return out


def all_gather(xs: Sequence[torch.Tensor], mesh, axis: str, dim: int) -> list:
    """Each entry gets its group's tensors along ``axis``, concatenated on
    ``dim`` in the order of the axis coordinate."""
    out: list = [None] * mesh.size
    for group in mesh.groups(axis):
        for i in group:
            out[i] = torch.cat([_move(xs[j], mesh.entries[i]) for j in group], dim=dim)
    return out


def all_to_all(xs: Sequence[torch.Tensor], mesh, axis: str, split_dim: int,
               concat_dim: int) -> list:
    """``jax.lax.all_to_all(tiled=True)`` along ``axis``: entry ``p`` of a
    group gets the ``p``-th chunk (on ``split_dim``) of every member's
    tensor, concatenated on ``concat_dim`` in member order."""
    out: list = [None] * mesh.size
    for group in mesh.groups(axis):
        n = len(group)
        if xs[group[0]].shape[split_dim] % n:
            raise ValueError(f"dim {split_dim} of {tuple(xs[group[0]].shape)} does not "
                             f"split {n} ways")
        parts = [xs[j].chunk(n, dim=split_dim) for j in group]
        for p, i in enumerate(group):
            out[i] = torch.cat([_move(parts[m][p], mesh.entries[i]) for m in range(n)],
                               dim=concat_dim)
    return out


def ppermute(xs: Sequence, mesh, axis: str, shift: int = 1) -> list:
    """Rotate along ``axis``: the entry at coordinate ``c`` gets the value of
    the one at ``c - shift`` (``jax.lax.ppermute`` with ``r -> r + shift``)."""
    out: list = [None] * mesh.size
    for group in mesh.groups(axis):
        n = len(group)
        for p, i in enumerate(group):
            out[group[(p + shift) % n]] = _move(xs[i], mesh.entries[group[(p + shift) % n]])
    return out


# -- the replica runner --------------------------------------------------------


class ReplicaRunner:
    """One thread per grid entry, and one leased stream per distinct CUDA
    device, for the life of the mesh."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.streams: dict[torch.device, Any] = {}
        for dev in mesh.distinct_devices:
            if dev.type == "cuda":
                from katib_tpu_torch.nas.darts.step_loop import lease_stream

                self.streams[dev] = lease_stream(dev)
        n = mesh.size
        self._pool = ThreadPoolExecutor(n, thread_name_prefix="replica") if n > 1 else None
        if self._pool is not None:
            # the threads end with the runner (and its mesh)
            weakref.finalize(self, self._pool.shutdown, wait=False)
        self._barrier = threading.Barrier(max(n, 1), action=self._collect)
        self._values: list = [None] * n
        self._op: Callable | None = None
        self._results: list = [None] * n
        self._run_lock = threading.Lock()

    def stream(self, device: torch.device):
        lease = self.streams.get(device)
        return None if lease is None else lease.stream

    @contextlib.contextmanager
    def _streams_current(self):
        with contextlib.ExitStack() as stack:
            for lease in self.streams.values():
                stack.enter_context(torch.cuda.stream(lease.stream))
            yield

    @contextlib.contextmanager
    def on_streams(self):
        """Run the caller's work on the leased streams: each waits first on
        the caller's current stream of its device, and the caller's stream
        waits on it after, so values cross in both directions in order."""
        callers = {dev: torch.cuda.current_stream(dev) for dev in self.streams}
        for dev, lease in self.streams.items():
            lease.stream.wait_stream(callers[dev])
        try:
            with self._streams_current():
                yield
        finally:
            for dev, lease in self.streams.items():
                callers[dev].wait_stream(lease.stream)

    def _collect(self) -> None:
        # runs once per rendezvous, on the last replica to arrive
        with self._streams_current():
            self._results = list(self._op(list(self._values)))

    def exchange(self, index: int, value, op: Callable[[list], list]):
        if self.mesh.size == 1:
            return op([value])[0]
        self._values[index] = value
        self._op = op
        self._barrier.wait()
        return self._results[index]

    def _replica(self, index: int, fn, grad: bool):
        dev = self.mesh.entries[index]
        _local.replica = Replica(self.mesh, index, dev)
        try:
            with contextlib.ExitStack() as stack:
                stack.enter_context(torch.set_grad_enabled(grad))
                if dev.type == "cuda":
                    stack.enter_context(torch.cuda.device(dev))
                    stack.enter_context(torch.cuda.stream(self.stream(dev)))
                return fn(index)
        except BaseException:
            # release the replicas waiting at a rendezvous this one will not reach
            self._barrier.abort()
            raise
        finally:
            _local.replica = None

    def run(self, fn: Callable[[int], Any]) -> list:
        """``[fn(0), ..., fn(size - 1)]``, replica ``r`` on its own thread;
        raises the first replica's error (a replica released from a
        rendezvous by it raises ``BrokenBarrierError``, which is dropped)."""
        grad = torch.is_grad_enabled()
        with self._run_lock:
            if self._pool is None:
                return [self._replica(0, fn, grad)]
            futures = [self._pool.submit(self._replica, r, fn, grad)
                       for r in range(self.mesh.size)]
            outputs, errors = [], []
            for f in futures:
                try:
                    outputs.append(f.result())
                except threading.BrokenBarrierError as e:
                    errors.append((1, e))
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    errors.append((0, e))
            if errors:
                self._barrier.reset()
                raise min(errors, key=lambda e: e[0])[1]
            return outputs


def exchange(value, op: Callable[[list], list]):
    """Inside a replica: hand ``value`` to the mesh's rendezvous, where
    ``op`` (one value per entry -> one result per entry) runs once over
    every replica's value; returns this replica's result.  Every replica
    must make the same exchanges in the same order."""
    r = current_replica()
    if r is None:
        raise RuntimeError("exchange() is called inside a replica of a mesh run")
    return r.mesh.runner().exchange(r.index, value, op)


def replica_all_reduce(x: torch.Tensor, axes) -> torch.Tensor:
    """Inside a replica: :func:`all_reduce` of this replica's ``x``."""
    mesh = current_replica().mesh
    return exchange(x, lambda xs: all_reduce(xs, mesh, axes))


def replica_all_gather(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    mesh = current_replica().mesh
    return exchange(x, lambda xs: all_gather(xs, mesh, axis, dim))


def replica_all_to_all(x: torch.Tensor, axis: str, split_dim: int,
                       concat_dim: int) -> torch.Tensor:
    mesh = current_replica().mesh
    return exchange(x, lambda xs: all_to_all(xs, mesh, axis, split_dim, concat_dim))


def replica_ppermute(x, axis: str, shift: int = 1):
    mesh = current_replica().mesh
    return exchange(x, lambda xs: ppermute(xs, mesh, axis, shift))
