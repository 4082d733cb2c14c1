"""The port's windowed step loop against the JAX package's ``lax.scan``
step loop, against its own eager stepping, and the settings chain that
chooses between them.

The JAX run is ``run_darts_search(step_loop=True, step_loop_window=2)`` in
float32 (its network built in float32, its initial weights recorded); the
port's step loop then starts from those weights.  On the CPU the port runs
the same step function that the card captures, eagerly, over the same
window bookkeeping.
"""

from __future__ import annotations

import functools
import json
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import katib_tpu.costmodel
import katib_tpu.nas.darts.search as jsearch
from katib_tpu.models import data as jdata
from katib_tpu.nas.darts.model import DartsNetwork as JNet
from katib_tpu_torch.convert import alphas_from_jax, state_dict_from_flax
from katib_tpu_torch.models import augmentation, data as tdata
from katib_tpu_torch.nas.darts import search as tsearch
from katib_tpu_torch.nas.darts.architect import (
    DartsHyper,
    init_search_state,
    state_from_items,
    state_items,
)
from katib_tpu_torch.nas.darts.model import DartsNetwork, extract_genotype, init_alphas
from katib_tpu_torch.nas.darts.search import (
    StepLoopUnavailable,
    darts_trial,
    resolve_step_loop,
    run_darts_search,
    search_epochs,
)
from katib_tpu_torch.runner.context import TrialContext

torch.set_num_threads(1)

PRIMS = ("separable_convolution_3x3", "max_pooling_3x3", "skip_connection")
NET = dict(num_layers=3, init_channels=4, n_nodes=2)
ENV = ("KATIB_STEP_LOOP", "KATIB_STEP_LOOP_WINDOW", "KATIB_DEVICE_DATA", "KATIB_NATIVE_LOADER",
       "KATIB_SEARCH_AUG")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


def _dataset(package, n_train=16):
    # 16 train images -> 8 per half -> 2 steps of 4; 8 test images
    return package.synthetic_classification(n_train, 8, (8, 8, 3), 4, seed=7)


class _F32Net(JNet):
    """The JAX supernet in float32, its init jitted."""

    dtype: Any = jnp.float32

    def init(self, rngs, *args, **kwargs):
        return jax.jit(functools.partial(JNet.init, self, **kwargs))(rngs, *args)


@pytest.fixture(scope="module")
def jax_scan_run():
    """Two JAX epochs through the ``lax.scan`` step loop, windows of 2."""
    rec = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(jsearch, "DartsNetwork", _F32Net)
    real_init = jsearch.init_search_state

    def init_state(weights, alphas, hyper):
        rec["weights"], rec["alphas"], rec["hyper"] = (*jax.device_get((weights, alphas)), hyper)
        return real_init(weights, alphas, hyper)

    mp.setattr(jsearch, "init_search_state", init_state)
    mp.setattr(katib_tpu.costmodel, "observe_program", lambda *a, **k: None)
    for name in ENV:
        mp.delenv(name, raising=False)
    try:
        rec["result"] = jsearch.run_darts_search(
            _dataset(jdata), primitives=PRIMS, **NET, num_epochs=2, batch_size=4, seed=3,
            remat=False, step_loop=True, step_loop_window=2,
        )
    finally:
        mp.undo()
    return rec


def _port_state(jax_run, net):
    hyper = DartsHyper(**jax_run["hyper"]._asdict())
    return hyper, init_search_state(
        state_dict_from_flax(jax_run["weights"], net), alphas_from_jax(jax_run["alphas"]), hyper
    )


def test_step_loop_matches_the_jax_scan_step_loop(jax_scan_run):
    net = DartsNetwork(primitives=PRIMS, **NET, num_classes=4, remat=False, dtype=torch.float32)
    hyper, state = _port_state(jax_scan_run, net)
    state, history = search_epochs(
        net, state, _dataset(tdata), hyper=hyper, num_epochs=2, batch_size=4, seed=3,
        device=torch.device("cpu"), step_loop=True, window=2,
    )
    want = jax_scan_run["result"]["history"]
    assert [h["epoch"] for h in history] == [h["epoch"] for h in want] == [0, 1]
    for got, exp in zip(history, want):
        # the JAX step loop's rows, and no per-step metrics
        assert set(got) == set(exp)
        assert got["train_loss"] == pytest.approx(exp["train_loss"], rel=1e-4)
        assert got["val_accuracy"] == exp["val_accuracy"]
    genotype = extract_genotype(state.alphas, PRIMS, n_nodes=NET["n_nodes"])
    assert genotype == jax_scan_run["result"]["genotype"]


def _fresh(dtype=torch.float32, seed=0):
    net = DartsNetwork(primitives=PRIMS, **NET, num_classes=4, remat=True, dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    net.reset_parameters(gen)
    hyper = DartsHyper(total_steps=6)
    state = init_search_state({k: v.detach() for k, v in net.named_parameters()},
                              init_alphas(NET["n_nodes"], len(PRIMS), gen), hyper)
    return net, hyper, state


@pytest.mark.parametrize("augment", [None, augmentation.random_crop_flip])
def test_windows_equal_eager_steps_bitwise(augment):
    """3 steps per epoch in windows of 2 (a ragged last window) against one
    eager call per step, with and without search augmentation."""
    results = []
    for step_loop in (False, True):
        net, hyper, state = _fresh()
        times = []
        state, history = search_epochs(
            net, state, _dataset(tdata, 24), hyper=hyper, num_epochs=2, batch_size=4, seed=1,
            device=torch.device("cpu"), step_loop=step_loop, window=2, augment_fn=augment,
            step_times=times,
        )
        assert len(times) == 6
        results.append((state, history))
    (eager, eager_hist), (loop, loop_hist) = results
    for (key, a), (_, b) in zip(state_items(eager), state_items(loop)):
        assert torch.equal(a, b), key
    assert int(loop.step) == 6
    assert "steps" in eager_hist[0] and "steps" not in loop_hist[0]
    for e, w in zip(eager_hist, loop_hist):
        assert e["val_accuracy"] == w["val_accuracy"]
        assert e["train_loss"] == pytest.approx(w["train_loss"], rel=1e-6)


def test_host_gathered_batches_give_the_same_steps():
    """``KATIB_DEVICE_DATA=0``: eager steps over batches gathered on the host."""
    states = []
    for device_data in (True, False):
        net, hyper, state = _fresh()
        state, _ = search_epochs(
            net, state, _dataset(tdata), hyper=hyper, num_epochs=1, batch_size=4, seed=2,
            device=torch.device("cpu"), device_data=device_data,
        )
        states.append(state)
    for (key, a), (_, b) in zip(*map(state_items, states)):
        assert torch.equal(a, b), key


@pytest.mark.parametrize("env,kwargs,want", [
    ({}, {}, (True, 8, True)),
    ({"KATIB_STEP_LOOP": "0"}, {}, (False, 8, True)),
    ({"KATIB_STEP_LOOP": "0"}, {"step_loop": True}, (True, 8, True)),
    ({"KATIB_STEP_LOOP_WINDOW": "3"}, {}, (True, 3, True)),
    ({"KATIB_STEP_LOOP_WINDOW": "3"}, {"step_loop_window": 5}, (True, 5, True)),
    ({}, {"step_loop_window": 50}, (True, 8, True)),
    ({"KATIB_DEVICE_DATA": "0"}, {}, (False, 8, False)),
    ({"KATIB_DEVICE_DATA": "0", "KATIB_STEP_LOOP": "0"}, {}, (False, 8, False)),
    ({}, {"device_data": False}, (False, 8, False)),
    ({"KATIB_NATIVE_LOADER": "1"}, {"device_data": True}, (True, 8, True)),
    # native prefetch turns the device-data default off; the default step
    # loop then quietly steps eagerly, on the C++ loaders
    ({"KATIB_NATIVE_LOADER": "1"}, {}, (False, 8, False)),
    ({}, {"native_prefetch": True}, (False, 8, False)),
    ({}, {"steps": 0}, (False, 0, True)),
])
def test_settings_resolve_as_in_jax(monkeypatch, env, kwargs, want):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    args = dict(step_loop=None, step_loop_window=None, device_data=None, native_prefetch=None,
                steps=8)
    args.update(kwargs)
    assert resolve_step_loop(**args) == want


@pytest.mark.parametrize("env,kwargs,error,match", [
    ({"KATIB_STEP_LOOP": "1", "KATIB_DEVICE_DATA": "0"}, {}, StepLoopUnavailable,
     "KATIB_DEVICE_DATA=0"),
    ({}, {"step_loop": True, "device_data": False}, StepLoopUnavailable, "device_data=False"),
    ({}, {"step_loop": True, "steps": 0}, StepLoopUnavailable, "smaller than one batch"),
    ({}, {"step_loop_window": 0}, ValueError, "positive"),
    ({"KATIB_STEP_LOOP_WINDOW": "-2"}, {}, ValueError, "positive"),
    ({}, {"native_prefetch": True, "step_loop": True}, StepLoopUnavailable,
     "native prefetch was requested"),
    ({"KATIB_NATIVE_LOADER": "1", "KATIB_STEP_LOOP": "1"}, {}, StepLoopUnavailable,
     "native prefetch was requested"),
])
def test_settings_that_cannot_engage_raise(monkeypatch, env, kwargs, error, match):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    args = dict(step_loop=None, step_loop_window=None, device_data=None, native_prefetch=None,
                steps=8)
    args.update(kwargs)
    with pytest.raises(error, match=match):
        resolve_step_loop(**args)


@pytest.mark.parametrize("env,native_prefetch,device_data,want", [
    (None, None, False, False),
    ("1", None, False, True),
    ("0", None, False, False),
    ("", None, False, False),
    # the JAX rule: any value but "" and "0" asks for the loaders
    ("false", None, False, True),
    ("1", False, False, False),
    (None, True, False, True),
    (None, True, True, False),  # moot with the splits on the device
])
def test_native_prefetch_engages_as_in_jax(monkeypatch, env, native_prefetch, device_data, want):
    if env is None:
        monkeypatch.delenv("KATIB_NATIVE_LOADER", raising=False)
    else:
        monkeypatch.setenv("KATIB_NATIVE_LOADER", env)
    assert tsearch.resolve_native_prefetch(native_prefetch, device_data) is want


def test_search_augment_env_engages_crop_and_flip(monkeypatch):
    calls = []
    real = augmentation.random_crop_flip

    def spy(key, step, x):
        calls.append((key, int(step), tuple(x.shape)))
        return real(key, step, x)

    monkeypatch.setattr(augmentation, "random_crop_flip", spy)
    kw = dict(primitives=PRIMS, **NET, num_epochs=1, batch_size=4, seed=4, device="cpu",
              remat=False)
    run_darts_search(_dataset(tdata), **kw)
    assert calls == []
    monkeypatch.setenv("KATIB_SEARCH_AUG", "1")
    run_darts_search(_dataset(tdata), **kw)
    # the w-batch of each of the 2 steps, keyed with seed + 0x5EED and the step
    assert calls == [(4 + 0x5EED, 0, (4, 8, 8, 3)), (4 + 0x5EED, 1, (4, 8, 8, 3))]
    calls.clear()
    run_darts_search(_dataset(tdata), **kw, search_augment=False)
    assert calls == []


@pytest.mark.parametrize("spelling", ["step_loop_window", "stepLoopWindow"])
def test_trial_reads_both_window_spellings(tmp_path, monkeypatch, spelling):
    seen = {}
    real = tsearch.search_epochs

    def spy(*args, **kwargs):
        seen.update(step_loop=kwargs["step_loop"], window=kwargs["window"])
        return real(*args, **kwargs)

    monkeypatch.setattr(tsearch, "search_epochs", spy)
    settings = {"batch_size": 4, "init_channels": 4, "num_nodes": 2, "num_epochs": 1,
                "n_train": 24, "n_test": 8, "remat": "false", "unrolled": "false", spelling: "2"}
    ctx = TrialContext({"algorithm-settings": json.dumps(settings),
                        "search-space": json.dumps(list(PRIMS)), "num-layers": "3"},
                       checkpoint_dir=str(tmp_path), device="cpu")
    darts_trial(ctx)
    assert seen == {"step_loop": True, "window": 2}


def test_trial_with_step_loop_off_and_no_device_data_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("KATIB_DEVICE_DATA", "0")
    settings = {"batch_size": 4, "init_channels": 4, "num_nodes": 2, "num_epochs": 1,
                "n_train": 16, "n_test": 8, "step_loop": "true"}
    ctx = TrialContext({"algorithm-settings": json.dumps(settings),
                        "search-space": json.dumps(list(PRIMS)), "num-layers": "3"},
                       checkpoint_dir=str(tmp_path), device="cpu")
    with pytest.raises(StepLoopUnavailable):
        darts_trial(ctx)


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: a CUDA graph has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_replayed_graph_matches_eager_on_the_card(cuda_device, monkeypatch):
    from katib_tpu_torch.nas.darts.architect import make_search_step
    from katib_tpu_torch.nas.darts.step_loop import StepLoop
    from katib_tpu_torch.ops import mixed_op
    from katib_tpu_torch.parallel.train import cross_entropy_loss

    # full float32 convolutions (cuDNN defaults to TF32), so the two runs
    # differ only in summation order
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    net, hyper, state = _fresh()
    net.to(cuda_device)
    state = state_from_items(state, [t.to(cuda_device) for _, t in state_items(state)])
    ds = _dataset(tdata, 24)
    (x_w, y_w), (x_a, y_a) = tsearch.split_train(ds, 0)
    splits = tuple(torch.from_numpy(np.ascontiguousarray(t)).to(cuda_device)
                   for t in (x_w, y_w, x_a, y_a))

    def loss_fn(w, a, b):
        return cross_entropy_loss(torch.func.functional_call(net, w, (b[0], a)), b[1])

    step = make_search_step(loss_fn, hyper)
    ix = np.arange(12).reshape(3, 4)
    runs = []
    for capture in (False, True):
        loop = StepLoop(step, state, splits, 3, 4, augmentation.random_crop_flip, 7,
                        capture=capture)
        before = mixed_op.launches
        loop.run_epoch(ix, ix, window=2)
        torch.cuda.synchronize()
        runs.append((loop, mixed_op.launches - before))
    (eager, eager_launches), (graph, graph_launches) = runs
    assert 3 * graph_launches == 4 * eager_launches  # 3 replays + the warm-up step on copies
    torch.testing.assert_close(graph.metrics, eager.metrics, rtol=1e-4, atol=1e-6)
    for (key, a), (_, b) in zip(state_items(eager.state), state_items(graph.state)):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-6, msg=key)


def test_each_thread_captures_on_a_stream_of_its_own(monkeypatch):
    """Threads alive at once get distinct capture streams and share the
    device's capture lock; a thread keeps its stream, which goes back to the
    free list when the thread ends, so a later thread reuses it instead of
    making another."""
    import threading

    from katib_tpu_torch.nas.darts import step_loop

    made = []

    class FakeStream:
        def __init__(self, index):
            made.append(self)

    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(step_loop, "_free_streams", {})
    monkeypatch.setattr(step_loop, "_capture_locks", {})
    monkeypatch.setattr(step_loop, "_thread_streams", threading.local())
    device = torch.device("cuda", 0)
    got = {}

    def capture(name, together):
        got[name] = (step_loop._capture_stream(device), step_loop._capture_stream(device))
        together.wait()

    together = threading.Barrier(3)
    threads = [threading.Thread(target=capture, args=(i, together)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(first == again for first, again in got.values())
    assert len(made) == 3 and {id(s) for (s, _), _ in got.values()} == set(map(id, made))
    assert len({id(lock) for (_, lock), _ in got.values()}) == 1
    assert sorted(map(id, step_loop._free_streams[0])) == sorted(map(id, made))

    late = threading.Thread(target=capture, args=("late", threading.Barrier(1)))
    late.start()
    late.join()
    assert len(made) == 3 and any(got["late"][0][0] is s for s in made)
    assert len(step_loop._free_streams[0]) == 3


def test_captures_hold_the_cyclic_collector_off():
    """A graph capture runs inside ``cyclic_gc_paused``: nested and
    concurrent holds keep the collector off until the last one ends, and the
    collector's earlier state comes back."""
    import gc
    import threading

    from katib_tpu_torch.nas.darts.step_loop import cyclic_gc_paused

    assert gc.isenabled()
    inside, release = threading.Event(), threading.Event()

    def other():
        with cyclic_gc_paused():
            inside.set()
            release.wait(5)

    t = threading.Thread(target=other)
    with cyclic_gc_paused():
        t.start()
        inside.wait(5)
        with cyclic_gc_paused():
            assert not gc.isenabled()
        assert not gc.isenabled()
    assert not gc.isenabled()  # the other thread still holds it
    release.set()
    t.join(5)
    assert gc.isenabled()
    gc.disable()
    try:
        with cyclic_gc_paused():
            pass
        assert not gc.isenabled()  # off before, off after
    finally:
        gc.enable()
