"""The port's native (C++) runtime (``katib_tpu_torch/native``) against the
JAX package's: the observation store, the TEXT parser, the batch loader,
the db-manager daemon and its journal, across the two packages in both
directions, and native prefetch in the DARTS search.  Modelled on
``tests/test_native.py``; the runtime builds here with ``g++``."""

from __future__ import annotations

import functools
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import katib_tpu.costmodel
import katib_tpu.nas.darts.search as jsearch
from katib_tpu.models import data as jdata
from katib_tpu.nas.darts.model import DartsNetwork as JNet
from katib_tpu.native import dataloader as jloader
from katib_tpu.native import dbmanager as jdb
from katib_tpu_torch.convert import alphas_from_jax, state_dict_from_flax
from katib_tpu_torch.core import types as T
from katib_tpu_torch.models import data as tdata
from katib_tpu_torch.nas.darts import search as tsearch
from katib_tpu_torch.nas.darts.model import DartsNetwork
from katib_tpu_torch.native import build
from katib_tpu_torch.native.dataloader import NativeBatchLoader, pack_dataset
from katib_tpu_torch.native.dbmanager import RemoteObservationStore, spawn_db_manager
from katib_tpu_torch.native.store import NativeObservationStore, parse_text_lines_native
from katib_tpu_torch.runner import metrics as tmetrics
from katib_tpu_torch.runner.metrics import parse_text_lines

# tier-1 runs six test processes on the same cores: one torch thread each
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture()
def store():
    return NativeObservationStore()


class TestNativeStore:
    def test_report_get_ordering(self, store):
        store.report_point("t1", "loss", 0.5, step=1)
        store.report_point("t1", "acc", 0.8, step=1)
        store.report_point("t1", "loss", 0.3, step=2)
        assert [(log.metric_name, log.value) for log in store.get("t1")] == [
            ("loss", 0.5), ("acc", 0.8), ("loss", 0.3)]
        assert [log.value for log in store.get("t1", "loss")] == [0.5, 0.3]
        assert store.get("t1", "nope") == [] and store.get("ghost") == []

    def test_delete_and_totals(self, store):
        store.report_point("a", "m", 1.0)
        store.report_point("b", "m", 2.0)
        assert store.total_points() == 2 and store.trial_names() == ["a", "b"]
        store.delete("a")
        assert store.total_points() == 1 and store.trial_names() == ["b"]
        assert store.get("a") == []
        store.delete("a")  # idempotent

    def test_observation_for_strategies(self, store):
        obj = T.ObjectiveSpec(
            type=T.ObjectiveType.MAXIMIZE, objective_metric_name="acc",
            metric_strategies=(T.MetricStrategy("acc", T.MetricStrategyType.MAX),))
        for v in (0.1, 0.9, 0.5):
            store.report_point("t", "acc", v)
        assert store.observation_for("t", obj).get("acc").value == 0.9

    def test_subscribers_fire(self, store):
        seen = []
        store.subscribe(lambda trial, log: seen.append((trial, log.value)))
        store.report_point("t", "loss", 1.5)
        assert seen == [("t", 1.5)]

    def test_concurrent_reports(self, store):
        def worker(i):
            for j in range(200):
                store.report_point(f"trial-{i}", "loss", float(j), step=j)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert store.total_points() == 8 * 200
        for i in range(8):
            assert [log.step for log in store.get(f"trial-{i}", "loss")] == list(range(200))


LINES = [
    "2024-01-02T03:04:05Z loss=0.25 accuracy=0.9",
    "2024-01-02T03:04:05.500+02:00 loss=1e-3",
    "epoch 3 val_accuracy=0.75 accuracy = 0.5",
    "no metrics here",
    "loss=-2.5e2 garbage accuracy=+.75",
    "loss=",
    "loss==5",
    "deep|metric-name=4.25",
    "prefix_loss=9.9",
    "nul\0byte loss=3.5",
]
NAMES = ["loss", "accuracy", "deep|metric-name"]


def test_native_parser_matches_the_python_parser():
    native = parse_text_lines_native(LINES, NAMES)
    py = parse_text_lines(LINES, NAMES)
    assert [(m.metric_name, m.value, m.timestamp, m.step) for m in native] == [
        (m.metric_name, m.value, m.timestamp, m.step) for m in py]
    assert [(m.metric_name, m.value) for m in native][:7] == [
        ("loss", 0.25), ("accuracy", 0.9), ("loss", 1e-3), ("accuracy", 0.5),
        ("loss", -2.5e2), ("accuracy", 0.75), ("deep|metric-name", 4.25)]
    assert native[0].timestamp == 1704164645.0
    assert native[2].timestamp == 1704157445.5  # +02:00 subtracted


def test_fast_parser_runs_native_for_the_default_filter_only(monkeypatch):
    assert tmetrics.text_parser() == "native"
    calls = []
    monkeypatch.setattr(tmetrics, "_native_parser",
                        lambda lines, names: calls.append(1) or parse_text_lines_native(
                            lines, names))
    assert tmetrics.parse_text_lines_fast(LINES, NAMES) == parse_text_lines(LINES, NAMES)
    assert calls == [1]
    custom = [r"([\w|-]+)\s*=\s*([+-]?\d*(\.\d+)?([Ee][+-]?\d+)?)"]
    assert tmetrics.parse_text_lines_fast(LINES, NAMES, custom) == parse_text_lines(
        LINES, NAMES, custom)
    assert calls == [1]


def test_fast_parser_keeps_the_python_parser_when_the_runtime_cannot_build(monkeypatch):
    monkeypatch.setattr(tmetrics, "_native_checked", False)
    monkeypatch.setattr(tmetrics, "_native_parser", None)
    monkeypatch.setattr(build, "_build_error", "g++ not found")
    assert tmetrics.text_parser() == "python"
    assert tmetrics.parse_text_lines_fast(LINES, NAMES) == parse_text_lines(LINES, NAMES)


# -- the batch loader -----------------------------------------------------------

def _data(n=50):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(n, 4, 4, 3)).astype(np.float32),
            rng.integers(0, 10, size=(n,)).astype(np.int32))


def test_packed_file_is_the_jax_packages(tmp_path):
    x, y = _data()
    assert pack_dataset(x, y, str(tmp_path / "t.bin")) == jloader.pack_dataset(
        x, y, str(tmp_path / "j.bin"))
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()


@pytest.mark.parametrize("seed,start_epoch", [(7, 0), (3, 2)])
def test_loader_yields_the_jax_loaders_bytes(tmp_path, seed, start_epoch):
    """The same record file, seed and start epoch: two epochs of batches,
    byte for byte, with the JAX package's loader."""
    x, y = _data()
    path = str(tmp_path / "ds.bin")
    with NativeBatchLoader(x, y, batch=8, seed=seed, cache_path=path,
                           start_epoch=start_epoch) as got_loader, \
            jloader.NativeBatchLoader(x, y, batch=8, seed=seed, cache_path=path,
                                      start_epoch=start_epoch) as want_loader:
        assert got_loader.epoch_index == want_loader.epoch_index == start_epoch
        for _ in range(2):
            got = list(got_loader.epoch())
            want = list(want_loader.epoch())
            assert len(got) == len(want) == 6  # drop-last
            for (gx, gy), (wx, wy) in zip(got, want):
                assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
                assert gx.tobytes() == wx.tobytes() and gy.tobytes() == wy.tobytes()


def test_loader_is_deterministic_across_thread_counts_and_covers_the_epoch(tmp_path):
    x, y = _data()
    pairs = {xr.tobytes(): int(yv) for xr, yv in zip(x.reshape(50, -1), y)}
    path = str(tmp_path / "ds.bin")
    epochs = []
    for threads in (3, 1):
        with NativeBatchLoader(x, y, batch=8, seed=7, cache_path=path, n_threads=threads) as dl:
            epochs.append([(xb.copy(), yb.copy()) for xb, yb in dl.epoch()])
    seen = set()
    for (xa, ya), (xb, yb) in zip(*epochs):
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)
        for xr, yv in zip(xa.reshape(8, -1), ya):
            assert pairs[xr.tobytes()] == int(yv)  # labels ride with their images
            seen.add(xr.tobytes())
    assert len(seen) == 48  # no duplicate within an epoch


def test_loader_batches_are_their_own_arrays(tmp_path):
    """A batch handed out is not overwritten by the next ones (its
    host-to-device copy may still be reading it)."""
    x, y = _data()
    with NativeBatchLoader(x, y, batch=8, seed=1, cache_path=str(tmp_path / "d.bin")) as dl:
        it = dl.epoch()
        first = next(it)
        kept = first[0].copy()
        rest = list(it)
    assert len(rest) == 5 and np.array_equal(first[0], kept)
    assert not any(np.shares_memory(first[0], xb) for xb, _ in rest)


def test_a_loader_that_cannot_open_raises(tmp_path):
    x, y = _data(4)
    with pytest.raises(RuntimeError, match="ktl_open failed"):
        NativeBatchLoader(x, y, batch=8, seed=0, cache_path=str(tmp_path / "d.bin"))


# -- the db-manager daemon ----------------------------------------------------------

def _points(client, trial, metric=None):
    return [(m.metric_name, m.value, m.step) for m in client.get(trial, metric)]


class TestDbManager:
    def test_round_trip(self):
        handle = spawn_db_manager()
        try:
            client = handle.client()
            client.report_point("t1", "loss", 0.5, step=3)
            client.report_point("t1", "acc", 0.9)
            client.report_point("t2", "loss", 1.5)
            assert _points(client, "t1") == [("loss", 0.5, 3), ("acc", 0.9, -1)]
            assert [m.value for m in client.get("t1", "loss")] == [0.5]
            assert client.ping() == 3
            client.delete("t1")
            assert client.get("t1") == [] and client.ping() == 1
            client.close()
        finally:
            handle.stop()

    def test_concurrent_clients(self):
        handle = spawn_db_manager()
        try:
            def worker(i):
                c = handle.client()
                for j in range(50):
                    c.report_point("shared", "m", float(i * 50 + j))
                c.close()

            threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            probe = handle.client()
            assert len(probe.get("shared", "m")) == 200
            probe.close()
        finally:
            handle.stop()

    def test_journal_survives_kill_dash_nine(self, tmp_path):
        db = str(tmp_path / "obs.journal")
        handle = spawn_db_manager(db_path=db)
        try:
            client = handle.client()
            for i in range(5):
                client.report_point("t1", "loss", 1.0 - 0.1 * i, step=i)
            client.report_point("doomed", "loss", 9.9)
            client.delete("doomed")
            client.close()
        finally:
            handle.proc.kill()  # SIGKILL: no shutdown path runs
            handle.proc.wait()
        handle = spawn_db_manager(db_path=db)
        try:
            client = handle.client()
            assert [(m.value, m.step) for m in client.get("t1", "loss")] == [
                (pytest.approx(1.0 - 0.1 * i), i) for i in range(5)]
            assert client.get("doomed") == []  # the delete replayed too
            client.report_point("t1", "loss", 0.42, step=5)
            client.close()
        finally:
            handle.proc.kill()
            handle.proc.wait()
        handle = spawn_db_manager(db_path=db)
        try:
            assert len(handle.client().get("t1", "loss")) == 6
        finally:
            handle.stop()

    def test_journal_trims_a_truncated_tail(self, tmp_path):
        db = str(tmp_path / "obs.journal")
        handle = spawn_db_manager(db_path=db)
        try:
            handle.client().report_point("t", "m", 1.0, step=0)
        finally:
            handle.proc.kill()
            handle.proc.wait()
        with open(db, "ab") as f:
            f.write(b"\x40\x00\x00\x00partial")  # the header promises 64 bytes, 7 follow
        handle = spawn_db_manager(db_path=db)
        try:
            client = handle.client()
            assert [m.value for m in client.get("t", "m")] == [1.0]
            client.report_point("t", "m", 2.0, step=1)
        finally:
            handle.proc.kill()
            handle.proc.wait()
        handle = spawn_db_manager(db_path=db)
        try:
            assert [m.value for m in handle.client().get("t", "m")] == [1.0, 2.0]
        finally:
            handle.stop()

    def test_blackbox_trial_reports_through_the_daemon(self, tmp_path):
        from katib_tpu_torch.runner.trial_runner import run_trial

        handle = spawn_db_manager()
        try:
            store = handle.client()
            script = tmp_path / "train.py"
            script.write_text("print('loss=0.5')\nprint('loss=0.25')\n")
            trial = T.Trial(name="bb-remote", experiment_name="e",
                            spec=T.TrialSpec(command=[sys.executable, str(script)]))
            obj = T.ObjectiveSpec(type=T.ObjectiveType.MINIMIZE, objective_metric_name="loss")
            assert run_trial(trial, store, obj, device="cpu").condition is (
                T.TrialCondition.SUCCEEDED)
            assert [m.value for m in store.get("bb-remote", "loss")] == [0.5, 0.25]
            store.close()
        finally:
            handle.stop()


def _write_some(client) -> None:
    for i in range(3):
        client.report_point("x", "loss", 0.5 - 0.1 * i, step=i)
    client.report_point("gone", "acc", 0.1)
    client.delete("gone")
    client.report_point("y", "acc", 0.75, step=7)


def _expect_some(client) -> None:
    assert _points(client, "x") == [("loss", 0.5, 0), ("loss", 0.4, 1), ("loss", 0.3, 2)]
    assert client.get("gone") == [] and _points(client, "y", "acc") == [("acc", 0.75, 7)]
    assert client.ping() == 4


@pytest.mark.parametrize("daemon,client", [("jax", "port"), ("port", "jax")])
def test_the_wire_protocol_works_across_the_packages(daemon, client):
    spawn = jdb.spawn_db_manager if daemon == "jax" else spawn_db_manager
    make = RemoteObservationStore if client == "port" else jdb.RemoteObservationStore
    handle = spawn()
    try:
        c = make(handle.host, handle.port)
        _write_some(c)
        _expect_some(c)
        c.close()
    finally:
        handle.stop()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_journal_replays_in_the_other_packages_daemon(tmp_path, writer, reader):
    spawn = {"jax": jdb.spawn_db_manager, "port": spawn_db_manager}
    db = str(tmp_path / "obs.journal")
    handle = spawn[writer](db_path=db)
    try:
        _write_some(handle.client())
    finally:
        handle.proc.kill()
        handle.proc.wait()
    handle = spawn[reader](db_path=db)
    try:
        _expect_some(handle.client())
    finally:
        handle.stop()


# -- the build ----------------------------------------------------------------------

def test_the_build_names_outputs_by_their_sources(tmp_path, monkeypatch):
    lib = build.output_path("libkatibnative.so")
    assert lib.parent == ROOT / "build" / "katib_tpu_torch" / "native"
    assert re.fullmatch(r"libkatibnative-[0-9a-f]{12}\.so", lib.name)
    src = tmp_path / "src"
    src.mkdir()
    for f in build.SRC.iterdir():
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "SRC", src)
    assert build.output_path("libkatibnative.so") == lib
    (src / "obslog.h").write_text((src / "obslog.h").read_text() + "\n// edited\n")
    assert build.output_path("libkatibnative.so") != lib


_CONCURRENT = """
import sys
from pathlib import Path
sys.path.insert(0, {root!r})
from katib_tpu_torch.native import build
build.BUILD_DIR = Path({out!r})
print(sorted(n for n, done in build.build().items() if done))
"""


def test_concurrent_builds_compile_each_output_once(tmp_path):
    """Three processes building into one empty directory at once: each
    target is compiled by one of them, and every one finds whole outputs."""
    out = tmp_path / "native"
    script = _CONCURRENT.format(root=str(ROOT), out=str(out))
    procs = [subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(3)]
    results = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), results
    compiled = [name for stdout, _ in results for name in eval(stdout.strip())]
    assert sorted(compiled) == sorted(build.RUNTIME)
    names = sorted(p.name for p in out.iterdir() if not p.name.startswith("."))
    assert names == sorted(build.output_path(n).name for n in build.RUNTIME)


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    for f in build.SRC.iterdir():
        (src / f.name).write_bytes(f.read_bytes())
    (src / "obslog.cc").write_text("this is not C++;\n")
    monkeypatch.setattr(build, "SRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_build_error", None)
    with pytest.raises(build.NativeBuildError, match="g\\+\\+ failed for libkatibnative.so"):
        build.ensure_built()
    assert "error" in build.build_error()
    # remembered: asked again, it raises without compiling
    monkeypatch.setattr(build, "build", lambda names=(): pytest.fail("rebuilt"))
    with pytest.raises(build.NativeBuildError):
        build.ensure_built()
    assert not build.native_available()


def test_what_asked_for_the_runtime_raises_when_it_cannot_build(monkeypatch, tmp_path):
    """The native store, the daemon and native prefetch raise; none falls
    back as the JAX package does."""
    from katib_tpu_torch.core.config import KatibConfig

    monkeypatch.setattr(build, "_build_error", "g++ not found: the native runtime needs a C++17")
    monkeypatch.setattr(build, "_lib", None)
    with pytest.raises(build.NativeBuildError, match="g\\+\\+ not found"):
        KatibConfig.from_dict({"store": {"backend": "native"}}).store.make_store()
    with pytest.raises(build.NativeBuildError):
        spawn_db_manager()
    ds = tdata.synthetic_classification(16, 8, (8, 8, 3), 4, seed=7)
    with pytest.raises(build.NativeBuildError):
        tsearch.run_darts_search(ds, primitives=("skip_connection",), num_layers=1, n_nodes=1,
                                 init_channels=2, num_epochs=1, batch_size=4, device="cpu",
                                 native_prefetch=True)


def test_the_stress_harness_declares_the_loaders_interface():
    """``stress.cc`` declares ``ktl_open`` as ``dataloader.cc`` defines it
    (the JAX package's copy passes one argument too few, F13)."""
    def params(text: str) -> list[str]:
        m = re.search(r"void\* ktl_open\(([^)]*)\)", text)
        return [p.split()[-1] for p in m[1].split(",")]

    defined = params((build.SRC / "dataloader.cc").read_text())
    assert params((build.SRC / "stress.cc").read_text()) == defined
    assert defined[-1] == "start_epoch"
    calls = re.findall(r"ktl_open\(path\.c_str\(\),([^;]*)\);",
                       (build.SRC / "stress.cc").read_text())
    assert calls and all(c.count(",") + 2 == len(defined) for c in calls)


@pytest.mark.parametrize("target", ["katib-native-stress", "katib-native-stress-asan"])
def test_stress_is_clean_under_the_sanitizer(tmp_path, target):
    """The store and the loader hammered under ThreadSanitizer and
    AddressSanitizer (``src/stress.cc``, built by the port's ``build.py``);
    skipped only when the sanitizer's runtime is missing, as in JAX."""
    try:
        build.build([target])
    except build.NativeBuildError as e:
        pytest.skip(f"{target} does not build here: {str(e)[-300:]}")
    run = subprocess.run([str(build.output_path(target)), str(tmp_path)], capture_output=True,
                         text=True, timeout=240)
    assert run.returncode == 0, f"{run.stdout[-500:]}\n{run.stderr[-2000:]}"
    assert "native stress: PASS" in run.stdout


# -- native prefetch in the DARTS search --------------------------------------------

PRIMS = ("separable_convolution_3x3", "max_pooling_3x3", "skip_connection")
NET = dict(num_layers=1, init_channels=4, n_nodes=1)


class _F32Net(JNet):
    dtype: jnp.dtype = jnp.float32

    def init(self, rngs, *args, **kwargs):
        return jax.jit(functools.partial(JNet.init, self, **kwargs))(rngs, *args)


def test_native_prefetch_search_matches_jax(monkeypatch):
    """``run_darts_search(native_prefetch=True)`` in both packages from the
    same weights: each package's C++ loaders feed eager steps with the same
    batches, so the step losses agree."""
    rec: dict = {"steps": []}
    mp = pytest.MonkeyPatch()
    mp.setattr(jsearch, "DartsNetwork", _F32Net)
    real_init, real_make = jsearch.init_search_state, jsearch.make_search_step

    def init_state(weights, alphas, hyper):
        rec["weights"], rec["alphas"] = jax.device_get((weights, alphas))
        return real_init(weights, alphas, hyper)

    def make_step(loss_fn, hyper, mesh=None, jit=True):
        step = real_make(loss_fn, hyper, mesh, jit)

        def recording(state, train, val):
            state, metrics = step(state, train, val)
            rec["steps"].append(jax.device_get(metrics))
            return state, metrics

        return recording

    mp.setattr(jsearch, "init_search_state", init_state)
    mp.setattr(jsearch, "make_search_step", make_step)
    mp.setattr(katib_tpu.costmodel, "observe_program", lambda *a, **k: None)
    kw = dict(primitives=PRIMS, **NET, num_epochs=2, batch_size=4, seed=3, remat=False,
              native_prefetch=True)
    try:
        jsearch.run_darts_search(jdata.synthetic_classification(16, 8, (8, 8, 3), 4, seed=7),
                                 **kw)
    finally:
        mp.undo()
    assert len(rec["steps"]) == 4  # 2 epochs x 2 steps, eager

    net = DartsNetwork(primitives=PRIMS, **NET, num_classes=4, remat=False, dtype=torch.float32)
    weights = state_dict_from_flax(rec["weights"], net)
    real_tinit = tsearch.init_search_state
    monkeypatch.setattr(tsearch, "DartsNetwork",
                        functools.partial(DartsNetwork, dtype=torch.float32))
    monkeypatch.setattr(tsearch, "init_search_state", lambda w, a, hyper: real_tinit(
        weights, alphas_from_jax(rec["alphas"]), hyper))
    timings: dict = {}
    got = tsearch.run_darts_search(tdata.synthetic_classification(16, 8, (8, 8, 3), 4, seed=7),
                                   **kw, device="cpu", timings=timings)
    steps = [m for row in got["history"] for m in row["steps"]]
    assert len(steps) == 4 and timings["loader_wait_s"] >= 0.0
    for i, (g, w) in enumerate(zip(steps, rec["steps"])):
        for name in ("train_loss", "val_loss", "grad_norm"):
            assert g[name] == pytest.approx(float(w[name]), rel=1e-4), (i, name)


def test_native_prefetch_feeds_the_eager_steps_and_cleans_up(monkeypatch, tmp_path):
    """The loaders engage with the splits off the device, feed every eager
    step, and leave no thread or temporary directory; a loader that cannot
    start raises (the JAX package warns and gathers in Python)."""
    import tempfile

    made = []
    real_mkdtemp = tempfile.mkdtemp

    def mkdtemp(*a, **k):
        made.append(real_mkdtemp(*a, dir=str(tmp_path), **{x: v for x, v in k.items()
                                                             if x != "dir"}))
        return made[-1]

    monkeypatch.setattr(tsearch.tempfile, "mkdtemp", mkdtemp)
    monkeypatch.setenv("KATIB_NATIVE_LOADER", "1")
    ds = tdata.synthetic_classification(32, 8, (8, 8, 3), 4, seed=1)
    kw = dict(primitives=("skip_connection", "max_pooling_3x3"), num_layers=1, n_nodes=1,
              init_channels=2, num_epochs=2, seed=0, device="cpu")
    result = tsearch.run_darts_search(ds, batch_size=4, **kw)
    assert [len(row["steps"]) for row in result["history"]] == [4, 4]
    assert len(made) == 1 and not os.path.exists(made[0])
    with pytest.raises(RuntimeError, match="ktl_open failed"):
        tsearch.run_darts_search(ds, batch_size=32, **kw)  # batch > the 16-image split
    assert len(made) == 2 and not os.path.exists(made[1])
