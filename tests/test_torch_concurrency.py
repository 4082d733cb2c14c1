"""The DARTS step loop and the classifier epoch loop under an
orchestrator's threads (port only): one capture at a time on a device's
shared capture stream, captured in ``thread_local`` mode, and a mixed-op
launch count that other threads' launches cannot corrupt.  The CUDA calls
of the capture are stubs here; the card runs the real ones in
``chip_smoke.py``."""

from __future__ import annotations

import contextlib
import threading
import time
from types import SimpleNamespace

import torch

from katib_tpu_torch.nas.darts import step_loop
from katib_tpu_torch.ops import mixed_op

LAUNCHES_PER_STEP = 3


class _FakeStream:
    def wait_stream(self, other):
        pass


def _stub_cuda(monkeypatch, on_capture):
    monkeypatch.setattr(step_loop, "_capture_streams", {})
    monkeypatch.setattr(step_loop, "_capture_locks", {})
    monkeypatch.setattr(step_loop, "clone_state", lambda s: s)
    monkeypatch.setattr(torch.cuda, "Stream", lambda index: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", on_capture)


def _loop():
    """A step loop whose step only launches the mixed-op kernel's count."""
    loop = object.__new__(step_loop.StepLoop)
    loop.bufs = (SimpleNamespace(step=torch.zeros((), dtype=torch.int64)),)
    loop._step = lambda bufs: mixed_op.count_launches(LAUNCHES_PER_STEP)
    return loop


def test_captures_on_one_device_take_turns_in_thread_local_mode(monkeypatch):
    guard = threading.Lock()
    active, peak, modes = [0], [0], []

    @contextlib.contextmanager
    def capture(graph, stream=None, capture_error_mode="global"):
        modes.append(capture_error_mode)
        with guard:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        time.sleep(0.05)
        yield
        with guard:
            active[0] -= 1

    _stub_cuda(monkeypatch, capture)
    loops = [_loop() for _ in range(4)]
    before = mixed_op.launches
    threads = [threading.Thread(target=loop._build_graph) for loop in loops]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert peak[0] == 1, "two captures ran on the shared stream at once"
    assert modes == ["thread_local"] * 4
    # each capture tallied its own step; only the warm-up steps really ran
    assert [loop.launches_per_replay for loop in loops] == [LAUNCHES_PER_STEP] * 4
    assert mixed_op.launches - before == 4 * step_loop.WARMUP_STEPS * LAUNCHES_PER_STEP
    assert len(step_loop._capture_locks) == 1


def test_a_capture_tallies_only_its_own_threads_launches():
    entered, release = threading.Event(), threading.Event()
    tallies = []

    def capturing():
        with mixed_op.recording_launches() as tally:
            mixed_op.count_launches(2)
            entered.set()
            release.wait(timeout=30)
            mixed_op.count_launches(1)
        tallies.append(tally[0])

    before = mixed_op.launches
    t = threading.Thread(target=capturing)
    t.start()
    assert entered.wait(timeout=30)
    mixed_op.count_launches(5)  # another trial's eager launches, meanwhile
    release.set()
    t.join(timeout=30)
    assert tallies == [3]
    assert mixed_op.launches - before == 5


def test_concurrent_counts_are_not_lost():
    before = mixed_op.launches

    def count():
        for _ in range(2000):
            mixed_op.count_launches()

    threads = [threading.Thread(target=count) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert mixed_op.launches - before == 8000


def _classifier_loop(steps_run: list):
    """A classifier epoch loop whose step only records that it ran."""
    from katib_tpu_torch.models import mnist

    loop = object.__new__(mnist.EpochLoop)
    loop.bufs = (mnist.TrainState(torch.zeros((), dtype=torch.int32), {}, {}),)
    loop._step = lambda bufs: steps_run.append(bufs[0])
    return loop


def test_classifier_and_darts_captures_take_turns_on_one_lock(monkeypatch):
    """The sweep's trials capture their classifier steps beside a DARTS
    trial's: one capture at a time per device, each in thread_local mode,
    each warming up on copies of its buffers."""
    guard = threading.Lock()
    active, peak, modes = [0], [0], []

    @contextlib.contextmanager
    def capture(graph, stream=None, capture_error_mode="global"):
        modes.append(capture_error_mode)
        with guard:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        time.sleep(0.02)
        yield
        with guard:
            active[0] -= 1

    _stub_cuda(monkeypatch, capture)
    steps_run: list = []
    loops = [_classifier_loop(steps_run) for _ in range(6)] + [_loop() for _ in range(2)]
    threads = [threading.Thread(target=loop._build_graph) for loop in loops]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert peak[0] == 1, "two captures ran on the shared stream at once"
    assert modes == ["thread_local"] * 8
    assert len(step_loop._capture_locks) == 1
    # each classifier loop: one warm-up step on a copy, then its capture
    warm, captured = steps_run[0::2], steps_run[1::2]
    assert len(steps_run) == 12
    assert all(w is not loop.bufs[0] for w, loop in zip(warm, loops[:6]))
    assert {id(c) for c in captured} == {id(loop.bufs[0]) for loop in loops[:6]}
    assert all(loop.graph is not None for loop in loops[:6])
