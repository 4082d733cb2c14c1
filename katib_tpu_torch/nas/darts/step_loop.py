"""The windowed step loop: bilevel steps over device-resident splits, each
step one replay of a captured CUDA graph (the counterpart of the JAX
package's ``lax.scan`` step loop, ``katib_tpu/nas/darts/search.py:390-447``).

Design (one step per graph):

- The search state lives in fixed tensors for the whole search; each step
  writes its new state back into them (``architect.copy_state_``), so a
  replay reads and writes the same addresses as the capture did.
- The epoch's ``[steps, batch]`` permutation indices live in a fixed device
  buffer that the host fills one window of rows at a time.  The step reads
  its row through a device-side position counter that it advances itself,
  gathers its w- and alpha-batch on the device, augments the w-batch
  (keyed off the state's step counter), runs the bilevel step, and writes
  its four scalar metrics into row ``position`` of a fixed ``[4, steps]``
  metrics buffer, fetched once per epoch.
- One captured step serves every window length, so a ragged last window
  needs no second graph.

On a CUDA device the step is warmed up on the thread's capture stream, on
a copy of every buffer (so no step is applied twice), which also builds
and loads the kernel library, creates the cuBLAS and cuDNN handles and
starts the autograd engine; then it is captured once and replayed.  A
capture or replay that fails raises: nothing falls back to eager
stepping.  On the CPU the same step function runs eagerly, one call per
step, over the same buffers.

On a ``mesh`` (``parallel/mesh.py``) the step is the sharded bilevel step
(``architect.py::make_search_step``): the splits stay on the mesh's home
device (replicated: on one card every entry reads the same tensors, as the
JAX package's replicated splits), each step gathers its rows there,
augments them and hands them to the sharded step, which places them on the
data axis (the JAX ``constrain``).  Its replicas run on their threads on
the mesh's leased stream, and the capture is begun on that stream
(:func:`mesh_capture_stream`), so one graph holds every replica's work; a
mesh over distinct devices is not captured.

Launch accounting: the mixed-op wrapper counts each launch in Python, so a
capture would count launches that do not happen and a replay counts none.
The capture therefore runs inside ``mixed_op.recording_launches`` on the
capturing stream, which tallies the launches made onto that stream by any
thread (on a mesh the replicas' threads launch the mixed op) instead of
counting them, and every replay adds the tally, so ``mixed_op.launches``
stays the number of kernels the device ran, whatever other threads launch
meanwhile.  The warm-up's launches are real and stay counted, as are those
of a cost count (:meth:`StepLoop.count_step`).
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable

import numpy as np
import torch

from katib_tpu_torch.costmodel import counter
from katib_tpu_torch.nas.darts.architect import SearchState, clone_state, copy_state_
from katib_tpu_torch.ops import mixed_op

METRICS = ("train_loss", "val_loss", "w_lr", "grad_norm")
WARMUP_STEPS = 1  # steps run (on copies) before the capture

# one capture stream per thread and device.  A graph captured on a stream
# stays tied to it: another thread's eager warm-up on that stream while the
# graph replays changes what the replay computes (on an H100, concurrent
# captured trials sharing one stream trained to results that changed from
# run to run).  A thread keeps its stream for life, so its trials' graphs
# are dead before the stream goes back to the free list as the thread ends;
# a stream is made only when the list is empty (PyTorch hands out its 32
# pooled streams per device in turn, so more than 32 threads capturing at
# once would share again).  Warm-ups and captures take turns under the
# device's lock.
_free_streams: dict[int, list[torch.cuda.Stream]] = {}
_capture_locks: dict[int, threading.Lock] = {}
_streams_lock = threading.Lock()
_thread_streams = threading.local()


class _Lease:
    """A thread's capture stream on one device; back to its free list when
    the thread's local storage is dropped, as the thread ends."""

    def __init__(self, free: list, stream: torch.cuda.Stream):
        self.free, self.stream = free, stream

    def __del__(self):
        self.free.append(self.stream)


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def lease_stream(device: torch.device) -> _Lease:
    """A stream of ``device``'s free list, the caller's alone until the
    lease is dropped: no capture stream of another thread."""
    index = _device_index(device)
    with _streams_lock:
        free = _free_streams.setdefault(index, [])
        _capture_locks.setdefault(index, threading.Lock())
        return _Lease(free, free.pop() if free else torch.cuda.Stream(index))


_gc_lock = threading.Lock()
_gc_holds = 0
_gc_was_enabled = False


@contextlib.contextmanager
def cyclic_gc_paused():
    """Hold Python's cyclic garbage collector off inside (for a graph
    capture).  A collection that ran inside a capture could free an older
    graph held in a reference cycle, and a graph's reset is refused while
    the thread captures (``operation not permitted when stream is
    capturing``), which invalidates the capture.  Nested and concurrent
    holds restore the collector once the last ends."""
    global _gc_holds, _gc_was_enabled
    with _gc_lock:
        if _gc_holds == 0:
            _gc_was_enabled = gc.isenabled()
            gc.disable()
        _gc_holds += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_holds -= 1
            if _gc_holds == 0 and _gc_was_enabled:
                gc.enable()


def count_copied_step(step: Callable, bufs: tuple, copy: Callable,
                      device: torch.device | None = None) -> counter.StepCount:
    """Count (``costmodel/counter.py``) one ``step`` on ``copy(bufs)``:
    eager, never inside a capture or under the device's capture lock; on a
    CUDA ``device`` (default: the last buffer's) on this thread's capture
    stream, which waits for the caller's stream and is waited for by it
    (no host synchronization)."""
    device = bufs[-1].device if device is None else torch.device(device)
    stream = _capture_stream(device)[0] if device.type == "cuda" else None
    return counter.count_step(step, lambda: copy(bufs), device, stream)


def _capture_stream(device: torch.device) -> tuple[torch.cuda.Stream, threading.Lock]:
    """This thread's capture stream on ``device`` and the device's capture
    lock."""
    index = _device_index(device)
    leases = getattr(_thread_streams, "leases", None)
    if leases is None:
        leases = _thread_streams.leases = {}
    if index not in leases:
        leases[index] = lease_stream(device)
    return leases[index].stream, _capture_locks[index]


DISTINCT_DEVICES = (
    "capturing a step over the mesh's distinct devices {devices} as one CUDA graph: "
    "a capture on one card's stream that forks to another card's stream is invalidated "
    "(cudaErrorStreamCaptureInvalidated, on H100s), and PyTorch's capture allocates from "
    "the capturing device's private pool only (not ported, ROADMAP item 9b)"
)


def mesh_captures(mesh) -> bool:
    """Whether a step over ``mesh`` can be captured as one CUDA graph: every
    entry names one CUDA device.  (Nothing is captured on the CPU.)"""
    return len(mesh.distinct_devices) == 1 and mesh.home.type == "cuda"


def mesh_capture_stream(mesh, device: torch.device):
    """The stream a capture of a step over ``mesh`` begins on: its replica
    runner's leased stream of ``device``, onto which every replica
    launches (``collectives.ReplicaRunner.stream``); ``None`` without a
    mesh.  Raises ``NotImplementedError`` for a mesh over distinct devices
    (:func:`capture_step`)."""
    if mesh is None:
        return None
    if not mesh_captures(mesh):
        raise NotImplementedError(DISTINCT_DEVICES.format(
            devices=[str(d) for d in mesh.distinct_devices]))
    return mesh.runner().stream(torch.device(device))


def capture_lock(device: torch.device) -> threading.Lock:
    """``device``'s capture lock (made on first use).  Warm-ups and captures
    take turns under it, and so do a profiler's start and stop
    (``costmodel/profiler.py``)."""
    index = _device_index(torch.device(device))
    with _streams_lock:
        return _capture_locks.setdefault(index, threading.Lock())


def capture_step(step: Callable, bufs, copy: Callable, device: torch.device, *,
                 stream: torch.cuda.Stream | None = None, generators=(),
                 recording: Callable | None = None):
    """Capture ``step(bufs)`` as one CUDA graph, the capture rule of every
    captured step of the port: holding ``device``'s capture lock
    throughout, warm ``step`` up on ``copy(bufs)`` (so no step is applied
    to ``bufs`` twice; the warm-up also builds and loads the kernel
    libraries, creates the cuBLAS and cuDNN handles and starts the autograd
    engine), then capture it on ``stream`` (default: this thread's capture
    stream) with the cyclic collector held off.

    The capture runs in ``thread_local`` mode: it forbids unsafe CUDA calls
    (a device sync, an event query, a plain ``cudaMalloc``) on this thread
    only.  Under the orchestrator other threads live beside the trial's;
    another trial's sync or allocation in the default ``global`` mode would
    invalidate this capture.  PyTorch's caching allocator sends to the
    graph's private pool the allocations made on a stream that is part of
    this capture, whichever thread makes them, and only those.  On one
    device, no other thread issues work to the capture stream or waits on
    an event recorded in it.

    A step over a mesh of one card breaks that on purpose: ``stream`` is
    the mesh's leased stream (:func:`mesh_capture_stream`), and the
    replicas' threads (``parallel/collectives.py``) and autograd's device
    thread, which runs the backward on the stream of each forward op,
    launch onto it.  What holds it together (the sharded DARTS and LM steps
    on an H100, replayed bit-equal to their eager twins, ``chip_smoke.py``'s
    ``mesh:`` lines):

    - every launch and allocation those threads make on the capturing
      stream lands in the graph and its private pool, by the rule above;
    - none of them makes an unsafe call inside: the warm-up runs the same
      step first on the same threads, so each has created its cuBLAS and
      cuDNN handles and their workspaces before the capture, and nothing
      in the sharded steps copies from the host or synchronizes (a mesh's
      batch-norm counts are device fills, ``nas/darts/norm.py``);
    - the replicas' launches between two rendezvous interleave in whatever
      order their threads enqueue them, which may differ from one capture
      to the next; each reads only its own replica's tensors, and each
      rendezvous op runs once, after every replica has enqueued its part
      and before any goes on, over the values in entry order, so every
      capture computes the same numbers.

    One graph cannot span distinct devices: on H100s a capture on one
    card's stream that forks to another card's stream by an event is
    invalidated (``tests/test_torch_mesh_capture_cuda.py::
    test_a_capture_cannot_span_two_cards``), and PyTorch's capture keeps one
    device's private pool besides (:func:`mesh_capture_stream` raises).

    Each generator of ``generators`` is put back after the warm-up and
    registered with the graph, so a replay draws what an eager call from
    the same generator state draws and advances it as far.
    ``recording(stream)``, when given, is a context manager around the
    capture whose value (the capture's tally of hand-written kernel
    launches, which it enqueues nothing for) is returned.  Returns
    ``(graph, tally, seconds)``, the seconds from the call on, a wait for
    another thread's capture included."""
    t0 = time.perf_counter()
    if stream is None:
        side, lock = _capture_stream(device)
    else:
        side, lock = stream, capture_lock(device)
    with lock:
        copies = copy(bufs)
        saved = [g.get_state() for g in generators]
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                step(copies)
        for g, state in zip(generators, saved):
            g.set_state(state)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        del copies
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        record = recording(side) if recording is not None else contextlib.nullcontext()
        with cyclic_gc_paused(), record as tally, \
                torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            step(bufs)
        torch.cuda.synchronize()
    return graph, tally, time.perf_counter() - t0


class StepLoop:
    """Bilevel steps of one search over device-resident splits.

    ``search_step(state, train_batch, val_batch) -> (state, metrics)`` is
    the architect's step; ``splits`` the ``(x_w, y_w, x_a, y_a)`` tensors on
    the state's device; ``augment(key, step, x)`` (or ``None``) transforms
    the w-batch, keyed with ``aug_key``.  ``capture``: replay a CUDA graph
    (``None`` = exactly when the state lives on a CUDA device).  ``mesh``:
    ``search_step`` is the sharded step over it (the module doc); a capture
    begins on its leased stream."""

    def __init__(self, search_step: Callable, state: SearchState, splits, steps: int,
                 batch_size: int, augment: Callable | None = None, aug_key: int = 0,
                 capture: bool | None = None, mesh=None):
        if steps < 1:
            raise ValueError(f"the step loop needs at least one step per epoch, got {steps}")
        device = state.step.device
        self.search_step, self.splits = search_step, splits
        self.augment, self.aug_key = augment, aug_key
        self.steps, self.mesh = steps, mesh
        self.capture = device.type == "cuda" if capture is None else capture
        if self.capture and device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, the state is on {device}")
        if self.capture:
            mesh_capture_stream(mesh, device)  # raises for distinct devices
        # fixed buffers: the state, the epoch's indices, the position, the metrics
        self.bufs = (
            clone_state(state),
            torch.zeros(steps, batch_size, dtype=torch.int64, device=device),
            torch.zeros(steps, batch_size, dtype=torch.int64, device=device),
            torch.zeros(1, dtype=torch.int64, device=device),
            torch.zeros(len(METRICS), steps, dtype=torch.float32, device=device),
        )
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches_per_replay = 0
        self.capture_s = 0.0

    @property
    def state(self) -> SearchState:
        return self.bufs[0]

    @property
    def metrics(self) -> torch.Tensor:
        """``[4, steps]`` float32 on the device: row ``i`` is ``METRICS[i]``."""
        return self.bufs[4]

    def _step(self, bufs) -> None:
        """One bilevel step on ``bufs``, written back into them: the function
        that is captured, and that runs eagerly on the CPU."""
        state, w_ix, a_ix, pos, metrics = bufs
        x_w, y_w, x_a, y_a = self.splits
        wi = w_ix.index_select(0, pos)[0]
        ai = a_ix.index_select(0, pos)[0]
        xb = x_w.index_select(0, wi)
        if self.augment is not None:
            xb = self.augment(self.aug_key, state.step, xb)
        new, m = self.search_step(state, (xb, y_w.index_select(0, wi)),
                                  (x_a.index_select(0, ai), y_a.index_select(0, ai)))
        copy_state_(state, new)
        metrics.index_copy_(1, pos, torch.stack([m[k].float() for k in METRICS])[:, None])
        pos.add_(1)

    def _build_graph(self) -> None:
        """Capture one step (:func:`capture_step`; on a mesh, on its leased
        stream); the capture's mixed-op launches are tallied, and counted
        on each replay."""
        device = self.bufs[0].step.device
        self.graph, recorded, self.capture_s = capture_step(
            self._step, self.bufs,
            lambda b: (clone_state(b[0]), *(t.clone() for t in b[1:])),
            device, stream=mesh_capture_stream(self.mesh, device),
            recording=mixed_op.recording_launches)
        self.launches_per_replay = recorded[0]

    def count_step(self) -> counter.StepCount:
        """Count one bilevel step (:func:`count_copied_step`) on copies of
        the buffers, at the epoch's first row; the search state is left as
        it was."""
        return count_copied_step(self._step, self.bufs, lambda b: (
            clone_state(b[0]), b[1].clone(), b[2].clone(), torch.zeros_like(b[3]), b[4].clone()))

    def run_epoch(self, w_ix: np.ndarray, a_ix: np.ndarray, window: int,
                  step_times: list | None = None) -> None:
        """Run the epoch whose ``[steps, batch]`` permutation indices are
        ``w_ix`` and ``a_ix``, ``window`` steps per shipment of indices.
        ``step_times``, when given, receives each step's wall seconds to the
        device's completion (a sync after each step); otherwise replays are
        queued without waiting."""
        if self.capture and self.graph is None:
            self._build_graph()
        _, w_buf, a_buf, pos, metrics = self.bufs
        pos.zero_()
        metrics.zero_()
        for start in range(0, self.steps, window):
            k = min(window, self.steps - start)
            w_buf[start:start + k].copy_(torch.from_numpy(w_ix[start:start + k]))
            a_buf[start:start + k].copy_(torch.from_numpy(a_ix[start:start + k]))
            for _ in range(k):
                t0 = time.perf_counter()
                if self.graph is not None:
                    self.graph.replay()
                    mixed_op.count_launches(self.launches_per_replay)
                else:
                    self._step(self.bufs)
                if step_times is not None:
                    if self.capture:
                        torch.cuda.synchronize()
                    step_times.append(time.perf_counter() - t0)
