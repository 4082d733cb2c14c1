"""The port's async engine (``katib_tpu_torch/orchestrator/async_loops.py``)
against ``tests/test_async_orchestrator.py``: the spec surface, the
occupancy meter, lookahead and backpressure, sync/async equivalence, and
the drain and crash invariants, on ``device="cpu"``; then the same grid
through the JAX package's engine and the port's, and every algorithm
without a suggester of its own (grid, random, DARTS) under the engine.

The equivalence tests use the GRID suggester: its enumeration is
independent of how proposals are batched, so sync and async runs must
produce bit-identical (params, objective) multisets.  Cohort packing
(``TestCohortPacking``) runs through the port's cohort runner.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import pytest
import torch
import yaml

from katib_tpu_torch.core.types import (
    AlgorithmSpec,
    ExperimentCondition,
    ExperimentSpec,
    FeasibleSpace,
    ObjectiveSpec,
    ObjectiveType,
    ParameterSpec,
    ParameterType,
    ResumePolicy,
    TrialCondition,
)
from katib_tpu_torch.core.validation import ValidationError, validate_experiment
from katib_tpu_torch.orchestrator import Orchestrator as _Orchestrator
from katib_tpu_torch.orchestrator import journal as jr
from katib_tpu_torch.orchestrator.async_loops import AsyncLoops, OccupancyMeter
from katib_tpu_torch.runner.cohort import attach_cohort_fn
from katib_tpu_torch.suggest.base import Suggester, make_suggester

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBJ = ObjectiveSpec(type=ObjectiveType.MAXIMIZE, objective_metric_name="accuracy")


def Orchestrator(**kw):
    """The port's orchestrator on the CPU, as a caller must name it."""
    return _Orchestrator(device="cpu", **kw)


def quadratic_trainer(ctx):
    x = float(ctx.params["x"])
    ctx.report(step=1, accuracy=1.0 - 0.01 * (x - 2.0) ** 2)


def make_spec(**kw):
    defaults = dict(
        name=kw.pop("name", f"async-exp-{time.time_ns()}"),
        objective=OBJ,
        algorithm=AlgorithmSpec(name="random", settings={"seed": "7"}),
        parameters=[
            ParameterSpec("x", ParameterType.DOUBLE, FeasibleSpace(min=-4.0, max=4.0)),
        ],
        train_fn=quadratic_trainer,
        parallel_trial_count=4,
        max_trial_count=8,
    )
    defaults.update(kw)
    return ExperimentSpec(**defaults)


def grid_spec(points=12, **kw):
    """Finite 1-D grid: enumeration order is batch-split independent."""
    kw.setdefault("algorithm", AlgorithmSpec(name="grid"))
    kw.setdefault(
        "parameters",
        [
            ParameterSpec(
                "x",
                ParameterType.DOUBLE,
                FeasibleSpace(min=0.0, max=float(points - 1), step=1.0),
            )
        ],
    )
    kw.setdefault("max_trial_count", points)
    return make_spec(**kw)


class DelaySuggester(Suggester):
    """Wraps the real suggester with a fixed per-call latency — the
    'slow suggester' the lookahead exists to hide."""

    name = "delay"

    def __init__(self, inner: Suggester, delay: float):
        self.inner = inner
        self.delay = delay
        self.calls = 0
        self.adaptive = inner.adaptive
        self.spec = inner.spec

    def get_suggestions(self, experiment, count):
        self.calls += 1
        time.sleep(self.delay)
        return self.inner.get_suggestions(experiment, count)


def outcome_set(exp):
    """The multiset equivalence key: sorted (params, objective) pairs."""
    out = []
    for t in exp.trials.values():
        obj = None
        if t.observation is not None:
            obj = {m.name: m.value for m in t.observation.metrics}.get("accuracy")
        out.append((tuple(sorted((k, v) for k, v in t.params().items())), obj))
    return sorted(out, key=repr)


# ---------------------------------------------------------------------------
# engine plumbing
# ---------------------------------------------------------------------------


class TestSpecSurface:
    def test_new_fields_validate(self):
        spec = make_spec(
            suggest_lookahead=8,
            occupancy_target=0.5,
            cohort_fill_deadline_seconds=0.1,
            async_orch=True,
        )
        validate_experiment(spec)

    @pytest.mark.parametrize(
        "kw",
        [
            dict(suggest_lookahead=0),
            dict(occupancy_target=0.0),
            dict(occupancy_target=1.5),
            dict(cohort_fill_deadline_seconds=-1.0),
        ],
    )
    def test_bad_fields_rejected(self, kw):
        with pytest.raises(ValidationError):
            validate_experiment(make_spec(**kw))

    def test_yaml_round_trip(self):
        from katib_tpu_torch.sdk.yaml_spec import experiment_spec_from_dict

        spec = experiment_spec_from_dict(
            {
                "name": "y",
                "objective": {"type": "maximize", "objectiveMetricName": "accuracy"},
                "algorithm": {"algorithmName": "random"},
                "parameters": [
                    {
                        "name": "x",
                        "parameterType": "double",
                        "feasibleSpace": {"min": "0", "max": "1"},
                    }
                ],
                "trialTemplate": {"trainFn": "tests.test_torch_async_loops.quadratic_trainer"},
                "suggestLookahead": 6,
                "occupancyTarget": 0.75,
                "cohortFillDeadlineSeconds": 0.25,
                "asyncOrch": False,
            }
        )
        assert spec.suggest_lookahead == 6
        assert spec.occupancy_target == 0.75
        assert spec.cohort_fill_deadline_seconds == 0.25
        assert spec.async_orch is False

    def test_queued_event_registered(self):
        assert "queued" in jr.EVENTS

    def test_escape_hatch_env(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KATIB_ASYNC_ORCH", "0")
        orch = Orchestrator(workdir=str(tmp_path))
        exp = orch.run(make_spec(max_trial_count=4))
        assert exp.condition is ExperimentCondition.MAX_TRIALS_REACHED
        assert orch.async_stats is None  # sync loop ran

    def test_spec_flag_beats_env(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KATIB_ASYNC_ORCH", "0")
        orch = Orchestrator(workdir=str(tmp_path))
        exp = orch.run(make_spec(max_trial_count=4, async_orch=True))
        assert exp.condition is ExperimentCondition.MAX_TRIALS_REACHED
        assert orch.async_stats is not None

    def test_async_default_on(self, tmp_path, monkeypatch):
        monkeypatch.delenv("KATIB_ASYNC_ORCH", raising=False)
        orch = Orchestrator(workdir=str(tmp_path))
        exp = orch.run(make_spec(max_trial_count=4))
        assert exp.condition is ExperimentCondition.MAX_TRIALS_REACHED
        assert orch.async_stats is not None
        assert orch.async_stats["trials_settled"] == 4


class TestOccupancyMeter:
    def test_clock_starts_at_first_dispatch(self):
        m = OccupancyMeter(4)
        m.update(0)  # cold ramp: ignored
        assert m.elapsed() == 0.0
        m.update(4)
        time.sleep(0.05)
        m.update(4)
        assert m.elapsed() > 0
        assert m.sustained() == pytest.approx(1.0)

    def test_half_busy_integrates_to_half(self):
        m = OccupancyMeter(4)
        m.update(2)
        time.sleep(0.05)
        m.update(2)
        assert m.sustained() == pytest.approx(0.5, abs=0.01)


# ---------------------------------------------------------------------------
# lookahead + backpressure
# ---------------------------------------------------------------------------


def _cohort_pair(sizes, lock):
    """train_fn/cohort twin that records dispatched cohort sizes."""

    def train_fn(ctx):
        with lock:
            sizes.append(1)
        ctx.report(step=1, accuracy=1.0)

    def cohort_fn(cctx):
        with lock:
            sizes.append(len(cctx.members))
        cctx.report(step=1, accuracy=[1.0] * len(cctx))

    return attach_cohort_fn(train_fn, cohort_fn)


class TestCohortPacking:
    def test_ragged_remainder_flushes_instead_of_waiting(self, tmp_path):
        """10 trials at width 4 -> 4+4+2: the final partial bucket flushes
        on the budget-starvation/deadline path instead of stalling the
        experiment forever (the bug cohortFillDeadlineSeconds fixes)."""
        sizes, lock = [], threading.Lock()
        spec = make_spec(
            train_fn=_cohort_pair(sizes, lock),
            cohort_width=4,
            cohort_key="pack",
            parallel_trial_count=4,
            max_trial_count=10,
            cohort_fill_deadline_seconds=0.2,
        )
        t0 = time.time()
        exp = Orchestrator(workdir=str(tmp_path)).run(spec)
        assert exp.condition is ExperimentCondition.MAX_TRIALS_REACHED
        assert time.time() - t0 < 30, "partial bucket stalled the run"
        assert len(exp.trials) == 10
        assert all(t.condition is TrialCondition.SUCCEEDED for t in exp.trials.values())
        assert sum(sizes) == 10
        assert max(sizes) <= 4
        assert any(s > 1 for s in sizes), f"no cohorts packed: {sizes}"

    def test_fill_deadline_flushes_partial_bucket(self, tmp_path):
        """A suggester that trickles one proposal per call still makes
        progress: the deadline flushes undersized buckets."""
        sizes, lock = [], threading.Lock()

        class Trickle(Suggester):
            name = "trickle"
            adaptive = False

            def get_suggestions(self, experiment, count):
                from katib_tpu_torch.core.types import ParameterAssignment, TrialAssignmentSet

                time.sleep(0.05)
                return [TrialAssignmentSet(assignments=[
                    ParameterAssignment("x", float(len(experiment.trials)))])]

        spec = make_spec(
            train_fn=_cohort_pair(sizes, lock),
            cohort_width=4,
            cohort_key="pack",
            parallel_trial_count=4,
            max_trial_count=4,
            cohort_fill_deadline_seconds=0.05,
            suggest_lookahead=1,
        )
        exp = Orchestrator(workdir=str(tmp_path), suggester_fn=Trickle).run(spec)
        assert exp.condition is ExperimentCondition.MAX_TRIALS_REACHED
        assert sum(sizes) == 4
        # with one proposal per 50ms and a 50ms deadline, at least one
        # bucket must have flushed below full width
        assert min(sizes) < 4, f"deadline never flushed a partial bucket: {sizes}"

    def test_keyless_trials_stay_singletons(self, tmp_path):
        sizes, lock = [], threading.Lock()
        spec = make_spec(
            train_fn=_cohort_pair(sizes, lock),
            cohort_width=4,  # width set but NO cohort_key and no labels
            parallel_trial_count=4,
            max_trial_count=6,
        )
        exp = Orchestrator(workdir=str(tmp_path)).run(spec)
        assert exp.condition is ExperimentCondition.MAX_TRIALS_REACHED
        assert sizes and max(sizes) == 1


class TestLookaheadAndBackpressure:
    def test_slow_suggester_latency_is_hidden(self, tmp_path):
        """16 trials x 0.1s on 4 slots = 0.4s of training floor; a 0.1s
        suggester adds ~0.4s+ to the SYNC critical path (serialized calls)
        but almost nothing to the async one (calls overlap training)."""

        def sleeper(ctx):
            time.sleep(0.1)
            ctx.report(step=1, accuracy=1.0)

        elapsed = {}
        for label, async_flag in (("sync", False), ("async", True)):
            spec = make_spec(
                train_fn=sleeper,
                parallel_trial_count=4,
                max_trial_count=16,
                async_orch=async_flag,
            )
            t0 = time.perf_counter()
            orch = Orchestrator(
                workdir=str(tmp_path / label),
                suggester_fn=lambda s: DelaySuggester(make_suggester(s), 0.1),
            )
            exp = orch.run(spec)
            elapsed[label] = time.perf_counter() - t0
            assert exp.condition is ExperimentCondition.MAX_TRIALS_REACHED
            assert len(exp.trials) == 16
            if async_flag:
                stats = orch.async_stats
        assert elapsed["async"] < elapsed["sync"], elapsed
        # training floor is 0.4s; the async run should not pay much more
        # than one suggester delay on top of it
        assert stats["sustained_occupancy"] > 0.5, stats

    def test_occupancy_target_throttles_concurrency(self, tmp_path):
        """occupancy_target=0.5 with 4 slots caps concurrent member trials
        at 2 even though the pool has 4 workers."""
        peak, cur, lock = [0], [0], threading.Lock()

        def tracker(ctx):
            with lock:
                cur[0] += 1
                peak[0] = max(peak[0], cur[0])
            time.sleep(0.05)
            with lock:
                cur[0] -= 1
            ctx.report(step=1, accuracy=1.0)

        spec = make_spec(
            train_fn=tracker,
            parallel_trial_count=4,
            occupancy_target=0.5,
            max_trial_count=8,
            async_orch=True,
        )
        exp = Orchestrator(workdir=str(tmp_path)).run(spec)
        assert exp.condition is ExperimentCondition.MAX_TRIALS_REACHED
        assert peak[0] <= 2, f"throttle leaked: {peak[0]} concurrent trials"

    def test_parallel_trial_count_still_caps_members(self, tmp_path):
        """Default occupancy_target=1.0 preserves the sync concurrency
        contract: never more than parallel_trial_count members at once."""
        peak, cur, lock = [0], [0], threading.Lock()

        def tracker(ctx):
            with lock:
                cur[0] += 1
                peak[0] = max(peak[0], cur[0])
            time.sleep(0.03)
            with lock:
                cur[0] -= 1
            ctx.report(step=1, accuracy=1.0)

        spec = make_spec(
            train_fn=tracker, parallel_trial_count=3, max_trial_count=9, async_orch=True
        )
        exp = Orchestrator(workdir=str(tmp_path)).run(spec)
        assert exp.condition is ExperimentCondition.MAX_TRIALS_REACHED
        assert peak[0] <= 3, f"{peak[0]} members ran concurrently"

    def test_metrics_published(self, tmp_path):
        from katib_tpu_torch.utils import observability as obs

        before = obs.suggest_seconds.snapshot()["total"]
        orch = Orchestrator(workdir=str(tmp_path))
        orch.run(make_spec(max_trial_count=4, async_orch=True))
        assert obs.suggest_seconds.snapshot()["total"] > before
        # gauges exist and were reset at wind-down
        assert obs.mesh_occupancy.snapshot()["samples"][0]["value"] == 0.0
        assert obs.pending_proposals.snapshot()["samples"][0]["value"] == 0.0


# ---------------------------------------------------------------------------
# sync/async equivalence (grid: batch-split independent)
# ---------------------------------------------------------------------------


def numpy_trainer(ctx):
    """Plain numpy, no JAX program compiled: the same float64 arithmetic in
    both packages' trial threads."""
    x = np.float64(ctx.params["x"])
    for step in range(2):
        acc = (1.0 - 0.01 * np.square(x - 2.0)) * (step + 1) / 2
        if not ctx.report(step=step, accuracy=float(acc)):
            return


class TestEquivalence:
    def test_grid_outcomes_bit_identical(self, tmp_path):
        runs = {}
        for label, async_flag in (("sync", False), ("async", True)):
            spec = grid_spec(points=12, async_orch=async_flag)
            orch = Orchestrator(workdir=str(tmp_path / label))
            exp = orch.run(spec)
            assert exp.condition in (
                ExperimentCondition.MAX_TRIALS_REACHED,
                ExperimentCondition.SUCCEEDED,
            )
            assert (orch.async_stats is not None) == async_flag
            runs[label] = outcome_set(exp)
        assert runs["sync"] == runs["async"]
        assert len(runs["async"]) == 12

    def test_grid_outcomes_match_the_jax_engine(self, tmp_path, monkeypatch):
        """The same 12-point grid through the JAX package's engine and the
        port's, both under the async default: the same outcome set, and each
        package's journal replays with no duplicate settlement."""
        from katib_tpu.core import types as jt
        from katib_tpu.orchestrator import journal as jjr
        from katib_tpu.orchestrator.orchestrator import Orchestrator as JOrchestrator

        monkeypatch.delenv("KATIB_ASYNC_ORCH", raising=False)
        runs = {}
        for label, types, make, journal in (
            ("jax", jt, JOrchestrator, jjr),
            ("torch", None, Orchestrator, jr),
        ):
            if types is None:
                spec = grid_spec(points=12, name="grid-x", train_fn=numpy_trainer)
            else:
                spec = types.ExperimentSpec(
                    name="grid-x",
                    objective=types.ObjectiveSpec(
                        type=types.ObjectiveType.MAXIMIZE, objective_metric_name="accuracy"
                    ),
                    algorithm=types.AlgorithmSpec(name="grid"),
                    parameters=[
                        types.ParameterSpec(
                            "x", types.ParameterType.DOUBLE,
                            types.FeasibleSpace(min=0.0, max=11.0, step=1.0),
                        )
                    ],
                    train_fn=numpy_trainer,
                    parallel_trial_count=4,
                    max_trial_count=12,
                )
            assert spec.async_orch is None
            workdir = str(tmp_path / label)
            orch = make(workdir=workdir)
            exp = orch.run(spec)
            assert orch.async_stats is not None and orch.async_stats["fallback"] is None
            assert exp.condition.value == "MaxTrialsReached", exp.message
            assert all(t.condition.value == "Succeeded" for t in exp.trials.values())
            _, stats = journal.replay_journal(workdir, "grid-x")
            assert stats.duplicates == 0
            runs[label] = outcome_set(exp)
        assert runs["torch"] == runs["jax"]
        assert len(runs["torch"]) == 12


def tiny_darts_spec():
    """``examples/nas/darts.yaml`` through the port's loader, cut to one
    tiny epoch through its own algorithm settings."""
    from katib_tpu_torch.sdk.yaml_spec import experiment_spec_from_dict

    with open(os.path.join(ROOT, "examples", "nas", "darts.yaml")) as f:
        doc = yaml.safe_load(f)
    tiny = {"num_epochs": "1", "n_train": "16", "n_test": "8", "init_channels": "2"}
    algo = doc["spec"]["algorithm"]
    algo["algorithmSettings"] = [
        s for s in algo["algorithmSettings"] if s["name"] not in tiny
    ] + [{"name": k, "value": v} for k, v in tiny.items()]
    return experiment_spec_from_dict(doc)


@pytest.mark.parametrize("algorithm", ["grid", "random", "darts"])
def test_every_algorithm_runs_under_the_engine(algorithm, tmp_path):
    """``grid``, ``random`` and ``darts`` are not pinned to the synchronous
    loop: with ``async_orch=True`` they run through :class:`AsyncLoops`."""
    if algorithm == "darts":
        spec = tiny_darts_spec()
    else:
        spec = make_spec(max_trial_count=4)
        if algorithm == "grid":
            spec = grid_spec(points=4)
    spec.async_orch = True
    ran = []
    orig = AsyncLoops.run

    def spy(self):
        ran.append(self.spec.algorithm.name)
        return orig(self)

    AsyncLoops.run = spy
    try:
        orch = Orchestrator(workdir=str(tmp_path))
        exp = orch.run(spec)
    finally:
        AsyncLoops.run = orig
    assert ran == [algorithm]
    assert orch.async_stats is not None and orch.async_stats["fallback"] is None
    assert exp.condition in (
        ExperimentCondition.MAX_TRIALS_REACHED,
        ExperimentCondition.SUCCEEDED,
    ), exp.message
    assert all(t.condition is TrialCondition.SUCCEEDED for t in exp.trials.values())
    assert orch.async_stats["trials_settled"] == len(exp.trials)


def arc_trainer(ctx):
    """A stub ENAS child: its accuracy is a fixed function of the arc (the
    share of layers that chose op 1), the same in both packages."""
    rows = json.loads(ctx.params["architecture"])
    ctx.report(step=0, accuracy=sum(r[0] == 1 for r in rows) / len(rows))


def enas_spec(types):
    """A tiny ENAS experiment of either package: 3 layers, 3 ops, hidden 16,
    3 REINFORCE steps a round, 12 trials 4 at a time."""
    t = types
    return t.ExperimentSpec(
        name="enas-x",
        objective=t.ObjectiveSpec(type=t.ObjectiveType.MAXIMIZE,
                                  objective_metric_name="accuracy"),
        algorithm=t.AlgorithmSpec(name="enas", settings={
            "controller_hidden_size": "16", "controller_train_steps": "3"}),
        nas_config=t.NasConfig(
            graph_config=t.GraphConfig(num_layers=3),
            operations=(
                t.NasOperation("convolution", parameters=(t.ParameterSpec(
                    "filter_size", t.ParameterType.CATEGORICAL,
                    t.FeasibleSpace(list=("3", "5"))),)),
                t.NasOperation("max_pooling"),
            ),
        ),
        train_fn=arc_trainer,
        parallel_trial_count=4,
        max_trial_count=12,
    )


def test_enas_rounds_match_the_jax_engine(tmp_path, monkeypatch):
    """The same tiny ENAS spec and stub child through both packages'
    engines: 3 rounds of 4 trials with the same ``enas-round`` labels, and
    one controller training (its REINFORCE steps) per round that a later
    round followed; the port's span journal holds each training."""
    from katib_tpu.core import types as jt
    from katib_tpu.orchestrator.orchestrator import Orchestrator as JOrchestrator
    from katib_tpu.suggest.base import make_suggester as j_make_suggester
    from katib_tpu_torch.core import types as tt

    monkeypatch.delenv("KATIB_ASYNC_ORCH", raising=False)
    runs = {}
    for label, types, make, make_suggester_fn in (
        ("jax", jt, JOrchestrator, j_make_suggester),
        ("torch", tt, Orchestrator, lambda spec: make_suggester(spec, device="cpu")),
    ):
        made, steps = [], []

        def build(spec, make_suggester_fn=make_suggester_fn, made=made, steps=steps):
            s = make_suggester_fn(spec)
            inner = s._train_step
            s._train_step = lambda *a: steps.append(s.round) or inner(*a)
            # each get_suggestions call is one ENAS round, and the engines'
            # anticipatory refill asks for the lookahead (4 here) plus the
            # trials dispatched during the previous call: a round's last
            # trial can settle before a call reads 0 dispatched, and then a
            # round of 5 follows (a thread race).  Capping the count at the
            # parallel width makes both engines' rounds 4 wide every time.
            ask = s.get_suggestions
            s.get_suggestions = lambda exp, count: ask(exp, min(count, spec.parallel_trial_count))
            made.append(s)
            return s

        workdir = str(tmp_path / label)
        orch = make(workdir=workdir, suggester_fn=build)
        exp = orch.run(enas_spec(types))
        assert orch.async_stats is not None and orch.async_stats["fallback"] is None
        assert exp.condition.value == "MaxTrialsReached", exp.message
        assert all(t.condition.value == "Succeeded" for t in exp.trials.values())
        (suggester,) = made
        labels = sorted(t.labels["enas-round"] for t in exp.trials.values())
        runs[label] = (labels, sorted(suggester._trained_rounds), steps)
        if label == "torch":
            with open(os.path.join(workdir, "enas-x", "trace.jsonl")) as f:
                spans = [json.loads(line) for line in f]
            trains = [r["args"]["round"] for r in spans if r["name"] == "enas.controller_train"]
            assert trains == [0, 1]
    assert runs["torch"] == runs["jax"]
    # steps: the suggester's next round when each REINFORCE step ran, 3 a training
    assert runs["torch"] == (["0"] * 4 + ["1"] * 4 + ["2"] * 4, [0, 1], [1] * 3 + [2] * 3)


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the controller runs on the orchestrator's device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_the_orchestrator_puts_the_enas_controller_on_the_card(cuda_device, tmp_path,
                                                               monkeypatch):
    from katib_tpu_torch.core import types as tt
    from katib_tpu_torch.orchestrator import orchestrator as orch_mod

    made = []
    orig = orch_mod.make_suggester
    monkeypatch.setattr(orch_mod, "make_suggester",
                        lambda spec, device=None: made.append(orig(spec, device=device))
                        or made[-1])
    exp = _Orchestrator(workdir=str(tmp_path)).run(enas_spec(tt))
    assert exp.condition.value == "MaxTrialsReached", exp.message
    assert made[0].device.type == "cuda"
    assert all(p.device.type == "cuda" for p in made[0].state.params)


# ---------------------------------------------------------------------------
# drain + crash/resume: exactly-once across the queue hand-offs
# ---------------------------------------------------------------------------


@pytest.mark.chaos
class TestDrainAndCrash:
    def test_drain_mid_queue_resumes_without_loss_or_dup(self, tmp_path):
        """Drain while trials sit in every stage (running / ready queue):
        resume completes all of them, none lost, none duplicated."""
        gate_open = threading.Event()
        release = threading.Event()

        def trainer(ctx):
            gate_open.set()
            while not release.is_set() and not ctx.should_stop():
                time.sleep(0.005)
            ctx.report(step=1, accuracy=float(ctx.params["x"]))

        spec = grid_spec(
            points=8,
            name="drain-queue",
            train_fn=trainer,
            parallel_trial_count=2,
            resume_policy=ResumePolicy.LONG_RUNNING,
            drain_grace_seconds=5.0,
            suggest_lookahead=8,  # force a deep ready queue at drain time
            async_orch=True,
        )
        orch = Orchestrator(workdir=str(tmp_path))
        runner = threading.Thread(target=lambda: orch.run(spec))
        runner.start()
        assert gate_open.wait(timeout=30)
        time.sleep(0.3)  # let the suggest loop fill the lookahead
        orch.drain()
        runner.join(timeout=30)
        assert not runner.is_alive()
        assert orch.drained

        release.set()
        orch2 = Orchestrator(workdir=str(tmp_path))
        exp2 = orch2.run(spec, experiment=orch2.load_experiment(spec))
        assert orch2.async_stats is not None
        assert exp2.condition in (
            ExperimentCondition.MAX_TRIALS_REACHED,
            ExperimentCondition.SUCCEEDED,
        )
        assert len(exp2.trials) == 8, "trials lost or duplicated across drain"
        assert all(
            t.condition is TrialCondition.SUCCEEDED for t in exp2.trials.values()
        )
        # every grid point ran exactly once
        xs = sorted(float(t.params()["x"]) for t in exp2.trials.values())
        assert xs == [float(i) for i in range(8)]

    def test_crash_mid_queue_resumes_exactly_once(self, tmp_path):
        """Hard-kill the process at a journal append while proposals sit in
        the suggest->schedule queue, then resume: the journal restores the
        in-flight state and settles every trial exactly once.  The child
        imports the port alone."""
        import subprocess
        import sys
        import textwrap

        from katib_tpu_torch.utils import faults

        workdir = tmp_path / "wd"
        child = textwrap.dedent(
            """
            import sys
            for name in ("jax", "jaxlib", "flax", "optax", "orbax", "katib_tpu"):
                sys.modules[name] = None
            from katib_tpu_torch.core.types import (
                AlgorithmSpec, ExperimentSpec, FeasibleSpace, ObjectiveSpec,
                ObjectiveType, ParameterSpec, ParameterType, ResumePolicy,
            )
            from katib_tpu_torch.orchestrator import Orchestrator

            def trainer(ctx):
                x = float(ctx.params["x"])
                ctx.report(step=1, accuracy=1.0 - 0.01 * (x - 2.0) ** 2)

            spec = ExperimentSpec(
                name="crash-queue",
                objective=ObjectiveSpec(type=ObjectiveType.MAXIMIZE,
                                        objective_metric_name="accuracy"),
                algorithm=AlgorithmSpec(name="grid"),
                parameters=[ParameterSpec("x", ParameterType.DOUBLE,
                                          FeasibleSpace(min=0.0, max=5.0, step=1.0))],
                train_fn=trainer, parallel_trial_count=2, max_trial_count=6,
                suggest_lookahead=6, resume_policy=ResumePolicy.LONG_RUNNING,
            )
            Orchestrator(workdir={workdir!r}, device="cpu").run(spec)
            """
        ).format(workdir=str(workdir))
        env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
        # die on a mid-experiment journal append: by then proposals are
        # queued, some trials started, none of the later ones settled
        env[faults.CRASH_AT_ENV] = "journal.append:8"
        env.pop("KATIB_ASYNC_ORCH", None)
        proc = subprocess.run(
            [sys.executable, "-c", child],
            cwd=ROOT,
            env=env,
            capture_output=True,
            text=True,
            timeout=120,
        )
        assert proc.returncode == 137, proc.stderr[-2000:]

        spec = grid_spec(
            points=6,
            name="crash-queue",
            parallel_trial_count=2,
            suggest_lookahead=6,
            resume_policy=ResumePolicy.LONG_RUNNING,
        )
        orch = Orchestrator(workdir=str(workdir))
        exp = orch.run(spec, resume=True)
        assert exp.condition in (
            ExperimentCondition.MAX_TRIALS_REACHED,
            ExperimentCondition.SUCCEEDED,
        )
        assert len(exp.trials) == 6, "crash lost or duplicated queued trials"
        assert all(
            t.condition is TrialCondition.SUCCEEDED for t in exp.trials.values()
        )
        xs = sorted(float(t.params()["x"]) for t in exp.trials.values())
        assert xs == [float(i) for i in range(6)]
        # the replayed journal holds no duplicate settlements
        _, stats = jr.replay_journal(str(workdir), "crash-queue")
        assert stats.duplicates == 0
