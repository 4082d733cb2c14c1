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
its own (the same one every run), with that entry's device current and the
device's leased stream (``nas/darts/step_loop.py::lease_stream``) as its
stream: one stream per distinct device, so replicas that share a card are
ordered on one stream and nothing waits on the whole device.  Inside a replica, :func:`exchange`
is the rendezvous: every replica hands in its value, the collective runs
once over all of them, and each gets its own result back.  Batch
normalization over the global batch (``nas/darts/norm.py::batch_norm``), the
ring and Ulysses attention (``parallel/ring_attention.py``) and dropout's
global masks (``models/transformer.py``) are built on it.  Each replica
thread runs under the caller's grad mode and the caller's dispatch modes
(a cost count, ``costmodel/counter.py``), as autograd's engine carries
them to its device thread.

**One graph over a mesh.**  When every entry names one CUDA device, every
replica launches into that device's one leased stream, so a CUDA graph
capture begun on :meth:`ReplicaRunner.stream` (``nas/darts/step_loop.py::
capture_step``) records all of their work, the rendezvous ops included,
in the order it was enqueued; a replay is one graph launch from the
caller's thread, with no barrier and no replica thread.  A mesh over
distinct devices cannot be captured this way (``step_loop.py::
mesh_capture_stream``).
"""

from __future__ import annotations

import atexit
import contextlib
import functools
import queue
import threading
import weakref
from concurrent.futures import Future
from typing import Any, Callable, NamedTuple, Sequence

import torch
from torch.utils._pytree import tree_map
from torch.utils._python_dispatch import (
    _disable_current_modes,
    _get_current_dispatch_mode_stack,
    _pop_mode,
    _push_mode,
)


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


_seq_nr = torch._C._autograd._get_sequence_nr  # this thread's next autograd sequence number


def _advance_seq_nr(target: int) -> None:
    """Raise this thread's autograd sequence number to ``target`` by making
    (and dropping) one CPU node per number, outside any dispatch mode."""
    n = target - _seq_nr()
    if n <= 0:
        return
    leaf = getattr(_local, "leaf", None)
    if leaf is None:
        leaf = _local.leaf = torch.zeros((), requires_grad=True)
    with _disable_current_modes(), torch.enable_grad():
        for _ in range(n):
            leaf.view(())


# the runners' queues and threads, by key, until stopped
_live: dict[int, tuple[list, list]] = {}


def _stop(key: int) -> list:
    queues, threads = _live.pop(key, ((), ()))
    for q in queues:
        q.put(None)
    return threads


@atexit.register
def _stop_all() -> None:
    """End every runner's threads before the interpreter's finalization,
    which would otherwise stop them inside a PyTorch call."""
    for key in list(_live):
        for t in _stop(key):
            t.join(timeout=10)


def _worker(jobs: queue.SimpleQueue) -> None:
    while (job := jobs.get()) is not None:
        call, future = job
        try:
            future.set_result(call())
        except BaseException as e:  # noqa: BLE001 - handed to the caller
            future.set_exception(e)
        del job, call, future


class ReplicaRunner:
    """One thread per grid entry, and one leased stream per distinct CUDA
    device, for the life of the mesh.

    **One order of the backward pass.**  Autograd's engine runs the ready
    node with the highest sequence number first, and a node takes its
    number from a counter of the thread that made it.  Each replica builds
    its part of the graph on its own thread, and the replicas' parts meet
    (a rendezvous op, the shared parameters), so the order in which the
    engine sums a tensor's gradients from three or more uses depends on
    how the replicas' counters stand against each other.  The runner keeps
    them level, so every run of the same step is summed in the same order,
    bit for bit, whatever the threads' timing: entry ``r`` always runs on
    thread ``r``; a replica starts where the furthest counter of the last
    run stopped; at each rendezvous every replica is raised to the furthest
    counter before the op runs (on whichever replica arrived last) and to
    where the op left it after.  The caller's own counter stands apart, so
    a sharded loss makes its last nodes at a rendezvous too
    (:func:`replica_mean_to_home`), not on the caller's thread.  Handing
    each replica an alias of its own of a shared tensor, through one node
    that sums their gradients in entry order, is not enough: the nodes a
    rendezvous makes still reorder each replica's own nodes, whose sums
    then differ run to run."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.streams: dict[torch.device, Any] = {}
        for dev in mesh.distinct_devices:
            if dev.type == "cuda":
                from katib_tpu_torch.nas.darts.step_loop import lease_stream

                self.streams[dev] = lease_stream(dev)
        n = mesh.size
        self._jobs = [queue.SimpleQueue() for _ in range(n if n > 1 else 0)]
        threads = [threading.Thread(target=_worker, args=(jobs,), name=f"replica-{r}",
                                    daemon=True) for r, jobs in enumerate(self._jobs)]
        for t in threads:
            t.start()
        # the threads end with the runner (and its mesh), or at exit
        _live[id(self._jobs)] = (self._jobs, threads)
        weakref.finalize(self, _stop, id(self._jobs))
        self._barrier = threading.Barrier(max(n, 1), action=self._collect)
        self._values: list = [None] * n
        self._op: Callable | None = None
        self._results: list = [None] * n
        self._seqs: list[int] = [0] * n  # each replica's counter (class doc)
        self._seq_after = 0
        self._run_lock = threading.Lock()

    def stream(self, device: torch.device):
        """The leased stream of ``device`` (``None`` for a CPU entry): every
        replica on ``device`` launches onto it."""
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
        waits on it after, so values cross in both directions in order.  A
        caller already on a leased stream (a capture begun on it) waits on
        nothing."""
        callers = {dev: torch.cuda.current_stream(dev) for dev in self.streams}
        others = [dev for dev, lease in self.streams.items() if callers[dev] != lease.stream]
        for dev in others:
            self.streams[dev].stream.wait_stream(callers[dev])
        try:
            with self._streams_current():
                yield
        finally:
            for dev in others:
                callers[dev].wait_stream(self.streams[dev].stream)

    def _collect(self) -> None:
        # runs once per rendezvous, on the last replica to arrive
        _advance_seq_nr(max(self._seqs))
        with self._streams_current():
            self._results = list(self._op(list(self._values)))
        self._seq_after = _seq_nr()

    def exchange(self, index: int, value, op: Callable[[list], list]):
        if self.mesh.size == 1:
            return op([value])[0]
        self._values[index] = value
        self._op = op
        self._seqs[index] = _seq_nr()
        self._barrier.wait()
        _advance_seq_nr(self._seq_after)
        return self._results[index]

    def _replica(self, index: int, fn, grad: bool, modes: list, start: int):
        dev = self.mesh.entries[index]
        _local.replica = Replica(self.mesh, index, dev)
        try:
            _advance_seq_nr(start)
            with contextlib.ExitStack() as stack:
                stack.enter_context(torch.set_grad_enabled(grad))
                if dev.type == "cuda":
                    stack.enter_context(torch.cuda.device(dev))
                    stack.enter_context(torch.cuda.stream(self.stream(dev)))
                stack.enter_context(_dispatch_modes(modes))
                return fn(index)
        except BaseException:
            # release the replicas waiting at a rendezvous this one will not reach
            self._barrier.abort()
            raise
        finally:
            self._seqs[index] = _seq_nr()
            _local.replica = None

    def run(self, fn: Callable[[int], Any]) -> list:
        """``[fn(0), ..., fn(size - 1)]``, replica ``r`` on thread ``r``
        under the caller's grad mode and dispatch modes; raises the first
        replica's error (a replica released from a rendezvous by it raises
        ``BrokenBarrierError``, which is dropped)."""
        grad = torch.is_grad_enabled()
        modes = list(_get_current_dispatch_mode_stack())
        with self._run_lock:
            if not self._jobs:
                return [self._replica(0, fn, grad, [], 0)]
            start = max(self._seqs)
            futures = []
            for r, jobs in enumerate(self._jobs):
                futures.append(Future())
                jobs.put((functools.partial(self._replica, r, fn, grad, modes, start),
                          futures[-1]))
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


@contextlib.contextmanager
def _dispatch_modes(modes: list):
    """Enter ``modes`` (a caller's dispatch-mode stack, innermost last) on
    this thread: a new thread does not inherit PyTorch's thread-local
    mode stack, as autograd's device threads do."""
    for mode in modes:
        _push_mode(mode)
    try:
        yield
    finally:
        for _ in modes:
            _pop_mode()


def exchange(value, op: Callable[[list], list]):
    """Inside a replica: hand ``value`` to the mesh's rendezvous, where
    ``op`` (one value per entry -> one result per entry) runs once over
    every replica's value; returns this replica's result.  Every replica
    must make the same exchanges in the same order."""
    r = current_replica()
    if r is None:
        raise RuntimeError("exchange() is called inside a replica of a mesh run")
    return r.mesh.runner().exchange(r.index, value, op)


def replica_mean_to_home(x: torch.Tensor) -> torch.Tensor:
    """Inside a replica: the mean of every replica's ``x`` on the mesh's
    home device, the same tensor for each.  A sharded loss ends here, so
    its last nodes are made at a rendezvous, inside the runner's order
    (:class:`ReplicaRunner`), and the caller makes none."""
    mesh = current_replica().mesh
    return exchange(x, lambda xs: [reduce_to_home([t / mesh.size for t in xs], mesh)] * mesh.size)


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
