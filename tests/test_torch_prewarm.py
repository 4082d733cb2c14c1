"""The port's prewarm worker (``katib_tpu_torch/compile/prewarm.py``) and
its wiring into the orchestrator and the cohort runner: the counterparts of
``tests/test_prewarm.py``'s worker and orchestrator cases, on the CPU.

A queued signature runs its twin exactly once; a train_fn without a twin is
a no-op; a failing twin is counted and never fails a trial or the
experiment; a slow twin never stalls shutdown; ``prewarm: false`` starts no
worker; a second cohort in the same bucket classifies warm, one in another
bucket cold.  ``mnist_trial``'s twin runs on the orchestrator's device and
leaves the trials' results as they are without it."""

from __future__ import annotations

import threading
import time

import pytest

from katib_tpu_torch.compile.buckets import prewarm_widths
from katib_tpu_torch.compile.prewarm import (
    PrewarmRequest,
    PrewarmWorker,
    attach_prewarm_fn,
    kernels_of,
    prewarm_fn_of,
)
from katib_tpu_torch.compile.registry import REGISTRY, ShapeRegistry
from katib_tpu_torch.core.types import (
    AlgorithmSpec,
    ExperimentCondition,
    ExperimentSpec,
    FeasibleSpace,
    ObjectiveSpec,
    ObjectiveType,
    ParameterAssignment,
    ParameterSpec,
    ParameterType,
    Trial,
    TrialCondition,
    TrialSpec,
)
from katib_tpu_torch.models import mnist as tmnist
from katib_tpu_torch.orchestrator import Orchestrator
from katib_tpu_torch.runner.cohort import attach_cohort_fn, run_cohort
from katib_tpu_torch.store.base import MemoryObservationStore
from katib_tpu_torch.utils import observability as obs
from tests.torch_compile_state import fresh_compile_state  # noqa: F401  (fixture)

OBJECTIVE = ObjectiveSpec(type=ObjectiveType.MINIMIZE, objective_metric_name="loss")
_DONE = (ExperimentCondition.SUCCEEDED, ExperimentCondition.MAX_TRIALS_REACHED,
         ExperimentCondition.GOAL_REACHED)


def _make_trial(name, spec_kw=None, **params):
    return Trial(
        name=name,
        experiment_name="prewarm-test",
        spec=TrialSpec(assignments=[ParameterAssignment(k, v) for k, v in params.items()],
                       **(spec_kw or {})),
    )


def _total(metric) -> float:
    return sum(v for _, v in metric.samples())


def _rows(program_fn) -> list[dict]:
    """The registry's rows of one program (a twin abandoned by an earlier
    test may still record its own signature when it is released)."""
    return [r for r in REGISTRY.signatures() if r["program"] == program_fn.__qualname__]


def test_prewarm_widths_are_the_jax_packages():
    from katib_tpu.compile.buckets import prewarm_widths as jax_widths

    for width in range(1, 10):
        for buckets in (True, False):
            assert prewarm_widths(width, buckets) == jax_widths(width, buckets)


def test_compiles_queued_signature_exactly_once():
    calls = []
    done = threading.Event()

    def train_fn(ctx):  # pragma: no cover - never run here
        pass

    def prewarm(shared, k, mesh=None, device=None):
        calls.append((dict(shared), k, device))
        done.set()
        return 0.5

    attach_prewarm_fn(train_fn, prewarm)
    assert prewarm_fn_of(train_fn) is prewarm and kernels_of(train_fn) == ()
    reg = ShapeRegistry()
    worker = PrewarmWorker(registry=reg)
    req = PrewarmRequest(train_fn=train_fn, shared={"units": 16}, k=4, device="cpu")
    try:
        assert worker.submit(req) is True
        # duplicate submits race the first twin; at most one runs
        worker.submit(req)
        worker.submit(req)
        assert worker.drain(timeout=10.0)
        assert done.wait(5.0)
        assert calls == [({"units": 16}, 4, "cpu")]
        assert worker.compiled == 1 and worker.failed == 0
        assert worker.captures == {req.signature().key(): 0.5}
        # once warm in this process, submission short-circuits to False
        assert worker.submit(req) is False
        assert reg.seen(req.signature())
        (row,) = reg.signatures()
        assert row["source"] == "prewarm" and row["capture_seconds"] == 0.5
    finally:
        worker.stop()


def test_no_prewarm_twin_is_noop():
    worker = PrewarmWorker(registry=ShapeRegistry())
    assert worker.submit(PrewarmRequest(train_fn=lambda ctx: None)) is False
    assert worker.stats() == {"compiled": 0, "failed": 0, "fetched": 0, "published": 0}


def test_failure_is_contained():
    """A twin that raises is counted and logged; the worker serves later
    requests, and the failed signature stays cold."""
    ok = threading.Event()

    def bad_train(ctx):  # pragma: no cover
        pass

    def good_train(ctx):  # pragma: no cover
        pass

    attach_prewarm_fn(bad_train, lambda s, k, m=None, device=None: 1 / 0)
    attach_prewarm_fn(good_train, lambda s, k, m=None, device=None: ok.set())
    reg = ShapeRegistry()
    worker = PrewarmWorker(registry=reg)
    try:
        assert worker.submit(PrewarmRequest(train_fn=bad_train, k=2))
        assert worker.submit(PrewarmRequest(train_fn=good_train, k=2))
        assert worker.drain(timeout=10.0)
        assert ok.wait(5.0)
        assert worker.failed == 1 and worker.compiled == 1
        assert not reg.seen(PrewarmRequest(train_fn=bad_train, k=2).signature())
    finally:
        worker.stop()


def test_stop_mid_compile_is_bounded():
    release = threading.Event()

    def train_fn(ctx):  # pragma: no cover
        pass

    attach_prewarm_fn(train_fn, lambda s, k, m=None, device=None: release.wait(10.0))
    worker = PrewarmWorker(registry=ShapeRegistry())
    assert worker.submit(PrewarmRequest(train_fn=train_fn, k=2))
    t0 = time.monotonic()
    worker.stop(timeout=0.5)
    assert time.monotonic() - t0 < 5.0
    release.set()


def test_fetch_only_runs_no_twin_and_publish_needs_declared_kernels():
    """The worker's artifact modes act on the declared kernel libraries only:
    ``mnist_trial`` declares none, so fetch-only runs nothing and publishing
    publishes nothing."""
    ran = threading.Event()

    def train_fn(ctx):  # pragma: no cover
        pass

    attach_prewarm_fn(train_fn, lambda s, k, m=None, device=None: ran.set())
    for worker in (PrewarmWorker(registry=ShapeRegistry(), fetch_only=True),
                   PrewarmWorker(registry=ShapeRegistry(), publish=True)):
        try:
            assert worker.submit(PrewarmRequest(train_fn=train_fn, k=1))
            assert worker.drain(timeout=10.0)
        finally:
            worker.stop()
        assert worker.fetched == worker.published == 0
    assert ran.is_set()  # by the publishing worker only


class TestWarmClassification:
    @staticmethod
    def _train_fn():
        def train_fn(tctx):  # pragma: no cover - cohort path used
            tctx.report(loss=0.0)

        def cohort(cctx):
            cctx.report(step=0, loss=cctx.stacked("lr").tolist()[: len(cctx)])

        attach_cohort_fn(train_fn, cohort)
        return train_fn, cohort

    def _run(self, train_fn, tag, k):
        return run_cohort(
            [_make_trial(f"{tag}{i}", spec_kw={"train_fn": train_fn}, lr=0.1, units=32)
             for i in range(k)],
            MemoryObservationStore(), OBJECTIVE, buckets=True, device="cpu",
        )

    def test_second_cohort_same_bucket_is_hit(self, fresh_compile_state):
        train_fn, cohort = self._train_fn()
        hits0, misses0 = _total(obs.compile_cache_hits), _total(obs.compile_cache_misses)
        r1 = self._run(train_fn, "w", 3)
        r2 = self._run(train_fn, "x", 4)
        assert all(r.condition is TrialCondition.SUCCEEDED
                   for r in list(r1.values()) + list(r2.values()))
        assert _total(obs.compile_cache_misses) == misses0 + 1
        assert _total(obs.compile_cache_hits) == hits0 + 1
        (row,) = _rows(cohort)
        assert row["k"] == 4

    def test_different_bucket_is_miss(self, fresh_compile_state):
        train_fn, cohort = self._train_fn()
        misses0 = _total(obs.compile_cache_misses)
        for tag, k in (("d", 2), ("e", 5)):  # buckets 2 and 8
            self._run(train_fn, tag, k)
        assert _total(obs.compile_cache_misses) == misses0 + 2
        assert sorted(r["k"] for r in _rows(cohort)) == [2, 8]


def _spec(train_fn, **kw) -> ExperimentSpec:
    kw.setdefault("max_trial_count", 4)
    kw.setdefault("parallel_trial_count", 2)
    return ExperimentSpec(
        name=f"prewarm-{kw.get('cohort_width', 1)}",
        objective=OBJECTIVE,
        algorithm=AlgorithmSpec(name="grid"),
        parameters=[ParameterSpec("x", ParameterType.DOUBLE,
                                  FeasibleSpace(min=0.0, max=3.0, step=1.0))],
        train_fn=train_fn,
        **kw,
    )


class TestOrchestratorPrewarm:
    @staticmethod
    def _fns(prewarm):
        def train_fn(tctx):
            tctx.report(loss=float(tctx.params["x"]))

        def cohort(cctx):
            cctx.report(step=0, loss=cctx.stacked("x").tolist()[: len(cctx)])

        attach_cohort_fn(train_fn, cohort)
        attach_prewarm_fn(train_fn, prewarm)
        return train_fn

    def _run(self, tmp_path, train_fn, **kw):
        orch = Orchestrator(workdir=str(tmp_path), device="cpu")
        return orch, orch.run(_spec(train_fn, **kw))

    def test_failing_prewarm_never_fails_experiment(self, tmp_path, fresh_compile_state):
        train_fn = self._fns(lambda s, k, m=None, device=None: 1 / 0)
        orch, exp = self._run(tmp_path, train_fn, cohort_width=2, cohort_key="c")
        assert exp.condition in _DONE
        assert all(t.condition is TrialCondition.SUCCEEDED for t in exp.trials.values())
        assert orch.prewarm_stats["compiled"] == 0
        assert orch.prewarm_stats["failed"] >= 1

    def test_slow_prewarm_never_stalls_shutdown(self, tmp_path, fresh_compile_state):
        hang = threading.Event()
        train_fn = self._fns(lambda s, k, m=None, device=None: hang.wait(30.0))
        t0 = time.monotonic()
        try:
            orch, exp = self._run(tmp_path, train_fn, cohort_width=2, cohort_key="c")
        finally:
            hang.set()
        assert exp.condition in _DONE
        assert time.monotonic() - t0 < 25.0

    @pytest.mark.parametrize("loop", ["sync", "async"])
    def test_twin_runs_on_the_orchestrators_device(self, loop, tmp_path, fresh_compile_state):
        seen = []

        def twin(s, k, m=None, device=None):
            seen.append((k, str(device)))

        def train_fn(tctx):
            # the group is submitted to the worker first: wait (bounded) for
            # the row the worker records once its twin has returned, not for
            # the twin itself, which runs before that row is written
            deadline = time.monotonic() + 10.0
            while not _rows(train_fn) and time.monotonic() < deadline:
                time.sleep(0.01)
            tctx.report(loss=float(tctx.params["x"]))

        attach_prewarm_fn(train_fn, twin)
        orch, exp = self._run(tmp_path, train_fn, async_orch=loop == "async")
        assert exp.condition in _DONE
        # one singleton signature (x is a float): warmed once, on the CPU,
        # and every first step after it classified warm
        assert seen == [(1, "cpu")]
        assert orch.prewarm_stats == {"compiled": 1, "failed": 0, "fetched": 0, "published": 0}
        (row,) = _rows(train_fn)
        assert row["source"] == "prewarm"

    def test_prewarm_disabled_by_spec(self, tmp_path, fresh_compile_state):
        called = threading.Event()
        train_fn = self._fns(lambda s, k, m=None, device=None: called.set())
        orch, exp = self._run(tmp_path, train_fn, prewarm=False)
        assert exp.condition in _DONE
        time.sleep(0.1)  # a stray worker would have fired by now
        assert not called.is_set()
        assert orch.prewarm_stats is None


def test_mnist_trial_sweep_runs_its_twin_and_keeps_its_results(tmp_path, fresh_compile_state):
    """``mnist_trial`` under the orchestrator with ``prewarm`` on (the
    default) and off: the twin warms the one signature on the CPU, every
    trial classifies its first step, and the reported metrics are the same
    as without the worker."""
    def spec(prewarm):
        return ExperimentSpec(
            name=f"mnist-prewarm-{prewarm}",
            objective=ObjectiveSpec(type=ObjectiveType.MAXIMIZE, objective_metric_name="accuracy"),
            algorithm=AlgorithmSpec(name="grid"),
            parameters=[
                ParameterSpec("lr", ParameterType.DOUBLE,
                              FeasibleSpace(min=0.05, max=0.1, step=0.05)),
                ParameterSpec("units", ParameterType.INT, FeasibleSpace(min=16, max=16)),
                ParameterSpec("n_train", ParameterType.INT, FeasibleSpace(min=256, max=256)),
                ParameterSpec("n_test", ParameterType.INT, FeasibleSpace(min=64, max=64)),
                ParameterSpec("epochs", ParameterType.INT, FeasibleSpace(min=1, max=1)),
                ParameterSpec("batch_size", ParameterType.INT, FeasibleSpace(min=64, max=64)),
            ],
            max_trial_count=2,
            parallel_trial_count=2,
            prewarm=prewarm,
            train_fn=tmnist.mnist_trial,
        )

    results = {}
    for prewarm in (True, False):
        REGISTRY.reset()
        misses0 = _total(obs.compile_cache_misses)
        orch = Orchestrator(workdir=str(tmp_path / str(prewarm)), device="cpu")
        exp = orch.run(spec(prewarm))
        assert exp.succeeded_count == 2, exp.message
        results[prewarm] = sorted(
            (t.params()["lr"], tuple(m.latest for m in t.observation.metrics))
            for t in exp.trials.values())
        # each trial's first step was classified; at most one was cold
        assert _total(obs.compile_cache_misses) - misses0 <= 1
        (row,) = _rows(tmnist.mnist_trial)
        assert row["k"] == 1
        if prewarm:
            assert orch.prewarm_stats["failed"] == 0
        else:
            assert orch.prewarm_stats is None
    assert results[True] == results[False]
