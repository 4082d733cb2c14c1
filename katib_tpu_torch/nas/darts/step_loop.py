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

Launch accounting: the mixed-op wrapper counts each launch in Python, so a
capture would count launches that do not happen and a replay counts none.
The capture therefore runs inside ``mixed_op.recording_launches``, which
tallies this thread's launches instead of counting them, and every replay
adds the tally, so ``mixed_op.launches`` stays the number of kernels the
device ran, whatever other threads launch meanwhile.  The warm-up's
launches are real and stay counted.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np
import torch

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


class StepLoop:
    """Bilevel steps of one search over device-resident splits.

    ``search_step(state, train_batch, val_batch) -> (state, metrics)`` is
    the architect's step; ``splits`` the ``(x_w, y_w, x_a, y_a)`` tensors on
    the state's device; ``augment(key, step, x)`` (or ``None``) transforms
    the w-batch, keyed with ``aug_key``.  ``capture``: replay a CUDA graph
    (``None`` = exactly when the state lives on a CUDA device)."""

    def __init__(self, search_step: Callable, state: SearchState, splits, steps: int,
                 batch_size: int, augment: Callable | None = None, aug_key: int = 0,
                 capture: bool | None = None):
        if steps < 1:
            raise ValueError(f"the step loop needs at least one step per epoch, got {steps}")
        device = state.step.device
        self.search_step, self.splits = search_step, splits
        self.augment, self.aug_key = augment, aug_key
        self.steps = steps
        self.capture = device.type == "cuda" if capture is None else capture
        if self.capture and device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, the state is on {device}")
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
        """Warm up on copies, then capture one step on this thread's capture
        stream, holding the device's capture lock throughout.

        The capture runs in ``thread_local`` mode: it forbids unsafe CUDA
        calls (a device sync, an event query, a plain ``cudaMalloc``) on
        this thread only.  Under the orchestrator other threads live
        beside the trial's (the main loop, the watchdog, the status
        writer); they make no CUDA calls, but a second trial of the same
        process might, and in the default ``global`` mode its sync or
        allocation would invalidate this capture.  That is safe here
        because no other thread ever issues work to this thread's stream or
        waits on an event recorded in it, and PyTorch's caching allocator
        sends only the capturing stream's allocations to the graph's
        private pool."""
        t0 = time.perf_counter()
        side, lock = _capture_stream(self.bufs[0].step.device)
        with lock:
            copies = (clone_state(self.bufs[0]), *(t.clone() for t in self.bufs[1:]))
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    self._step(copies)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            del copies
            graph = torch.cuda.CUDAGraph()
            # the capture enqueues nothing on the device: its launches are
            # tallied, and counted on each replay
            with mixed_op.recording_launches() as recorded, torch.cuda.graph(
                    graph, stream=side, capture_error_mode="thread_local"):
                self._step(self.bufs)
            self.launches_per_replay = recorded[0]
            torch.cuda.synchronize()
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

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
