"""The port's vectorized trial cohorts (``katib_tpu_torch/runner/cohort.py``,
the cohort steps of ``parallel/train.py``, ``mnist_cohort_trial``) against
``tests/test_cohort.py``.

Against the JAX package, on the CPU in float32: the cohort step equals the
JAX cohort step (and K serial steps of the port), a NaN member's row is
frozen, and ``mnist_cohort_trial`` at K=4 reports what the JAX twin
reports from the same weights (carried by ``convert.py``).  The port's own
invariants: ``CohortContext``'s unstacking, failure, early stop and ghost
rows, ``run_cohort``'s fallback and success paths, the orchestrator's
grouping, budget and the transient member that rejoins as a singleton.
The card's checks are in ``tests/test_torch_cohort_cuda.py``."""

from __future__ import annotations

import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from katib_tpu.models import mnist as jmnist
from katib_tpu.parallel import train as jtrain
from katib_tpu.runner import cohort as jcohort
from katib_tpu.store.base import MemoryObservationStore as JaxMemoryStore
from katib_tpu.core import types as jtypes
from katib_tpu_torch.compile.buckets import bucket_size, bucket_table, bucketed_cohort_size, next_pow2
from katib_tpu_torch.convert import mnist_state_dict_from_flax
from katib_tpu_torch.core.types import (
    COHORT_KEY_LABEL,
    AlgorithmSpec,
    ComparisonOp,
    EarlyStoppingRule,
    ExperimentSpec,
    FeasibleSpace,
    ObjectiveSpec,
    ObjectiveType,
    ParameterAssignment,
    ParameterSpec,
    ParameterType,
    Trial,
    TrialAssignmentSet,
    TrialCondition,
    TrialSpec,
)
from katib_tpu_torch.models import mnist as tmnist
from katib_tpu_torch.orchestrator import Orchestrator as _Orchestrator
from katib_tpu_torch.parallel import train as ttrain
from katib_tpu_torch.runner.cohort import CohortContext, attach_cohort_fn, cohort_fn_of, run_cohort
from katib_tpu_torch.runner.trial_runner import run_trial
from katib_tpu_torch.store.base import MemoryObservationStore
from katib_tpu_torch.utils import observability as obs
from katib_tpu_torch.utils.faults import FailureKind

torch.set_num_threads(1)

OBJECTIVE = ObjectiveSpec(type=ObjectiveType.MINIMIZE, objective_metric_name="loss")
OBJECTIVE_ACC = ObjectiveSpec(type=ObjectiveType.MAXIMIZE, objective_metric_name="accuracy")
# float32 through batched and per-member products: a few roundings apart
F32 = dict(rtol=1e-5, atol=1e-6)


def Orchestrator(**kw):
    """The port's orchestrator on the CPU, as a caller must name it."""
    return _Orchestrator(device="cpu", **kw)


def _make_trial(name, spec_kw=None, **params):
    return Trial(
        name=name,
        experiment_name="cohort-test",
        spec=TrialSpec(assignments=[ParameterAssignment(k, v) for k, v in params.items()],
                       **(spec_kw or {})),
    )


def make_spec(**kw):
    defaults = dict(
        name=kw.pop("name", f"cohort-exp-{time.time_ns()}"),
        objective=OBJECTIVE,
        algorithm=AlgorithmSpec(name="random", settings={"seed": "3"}),
        parameters=[ParameterSpec("x", ParameterType.DOUBLE, FeasibleSpace(min=-5.0, max=5.0))],
        train_fn=lambda ctx: None,
    )
    defaults.update(kw)
    return ExperimentSpec(**defaults)


# -- the cohort step ----------------------------------------------------------


def _toy_data(dim=4, n=16):
    rng = np.random.default_rng(1)
    w0 = (rng.normal(size=dim) * 0.1).astype(np.float32)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    return w0, x, y


def _jax_toy(lrs, steps, dim=4):
    w0, x, y = _toy_data(dim)

    def loss(params, batch):
        return jnp.mean((batch[0] @ params["w"] + params["b"] - batch[1]) ** 2)

    tx = optax.inject_hyperparams(optax.sgd)(learning_rate=0.0)
    states = []
    for lr in lrs:
        s = jtrain.TrainState.create({"w": jnp.asarray(w0), "b": jnp.zeros((), jnp.float32)}, tx)
        hp = dict(s.opt_state.hyperparams)
        hp["learning_rate"] = jnp.asarray(lr, jnp.float32)
        states.append(s._replace(opt_state=s.opt_state._replace(hyperparams=hp)))
    step = jtrain.make_cohort_train_step(loss, tx, donate=False)
    states = jtrain.stack_pytrees(states)
    for _ in range(steps):
        states, metrics = step(states, (jnp.asarray(x), jnp.asarray(y)))
    return jax.device_get(states.params), np.asarray(metrics["loss"])


def _torch_toy_loss(params, batch):
    return torch.mean((batch[0] @ params["w"] + params["b"] - batch[1]) ** 2)


def _torch_toy(lrs, steps, dim=4):
    w0, x, y = _toy_data(dim)
    tx = tmnist._family_optimizer("sgd")
    base = ttrain.TrainState.create({"w": torch.from_numpy(w0), "b": torch.zeros(())}, tx)
    states = ttrain.stack_pytrees([base] * len(lrs))
    hp = {"learning_rate": torch.tensor(lrs, dtype=torch.float32)}
    states = states._replace(opt_state=states.opt_state._replace(hyperparams=hp))
    step = ttrain.make_cohort_train_step(_torch_toy_loss, tx)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    for _ in range(steps):
        states, metrics = step(states, batch)
    return states, metrics["loss"], batch


class TestCohortStep:
    def test_cohort_step_matches_jax_and_serial_float32(self):
        """K=4 members through ONE batched step == the JAX cohort step ==
        4 serial steps of the port."""
        lrs, steps = [0.01, 0.05, 0.1, 0.2], 10
        want, want_loss = _jax_toy(lrs, steps)
        states, loss, batch = _torch_toy(lrs, steps)
        np.testing.assert_allclose(states.params["w"].numpy(), want["w"], **F32)
        np.testing.assert_allclose(states.params["b"].numpy(), want["b"], **F32)
        np.testing.assert_allclose(loss.numpy(), want_loss, **F32)
        assert states.step.tolist() == [steps] * 4
        tx = tmnist.make_optimizer("sgd", 0.0)
        serial_step = ttrain.make_train_step(_torch_toy_loss, tx)
        w0 = torch.from_numpy(_toy_data()[0])
        for i, member in enumerate(ttrain.unstack_pytree(states, 4)):
            s = ttrain.TrainState.create({"w": w0, "b": torch.zeros(())},
                                         tmnist.make_optimizer("sgd", lrs[i]))
            for _ in range(steps):
                s, _ = serial_step(s, batch)
            torch.testing.assert_close(member.params["w"], s.params["w"], **F32)

    def test_nan_member_frozen_others_unaffected(self):
        """An exploding member's row freezes; healthy rows match JAX's."""
        lrs = [0.01, float("inf"), 0.1]
        want, want_loss = _jax_toy(lrs, 5)
        states, loss, batch = _torch_toy(lrs, 5)
        assert not np.isfinite(want_loss[1]) and not torch.isfinite(loss[1])
        for i in (0, 2):
            np.testing.assert_allclose(states.params["w"][i].numpy(), want["w"][i], **F32)
        frozen = {k: v[1].clone() for k, v in states.params.items()}
        states, _ = ttrain.make_cohort_train_step(_torch_toy_loss, tmnist._family_optimizer("sgd"))(
            states, batch)
        for k, v in frozen.items():
            assert torch.equal(states.params[k][1], v)

    @pytest.mark.parametrize("optimizer", ["sgd", "momentum", "adam"])
    def test_stacked_update_is_each_members_update(self, optimizer):
        """``update_members`` broadcasts each ``[K]`` hyperparameter over its
        member's row: the same numbers as each member's own ``update``."""
        gen = torch.Generator().manual_seed(0)
        params = [{"w": torch.randn(3, 5, generator=gen), "b": torch.randn(5, generator=gen)}
                  for _ in range(3)]
        grads = [{k: torch.randn(v.shape, generator=gen) for k, v in p.items()} for p in params]
        fam = tmnist._family_optimizer(optimizer)
        states = [tmnist._set_hyperparams(fam.init(p), 0.01 * (i + 1), 0.5 + 0.1 * i)
                  for i, p in enumerate(params)]
        want = []
        for p, g, s in zip(params, grads, states):
            for _ in range(2):
                p, s = fam.update(g, s, p)
            want.append(p)
        stacked_p = ttrain.stack_pytrees(params)
        stacked_s = ttrain.stack_pytrees(states)
        stacked_g = ttrain.stack_pytrees(grads)
        for _ in range(2):
            stacked_p, stacked_s = fam.update_members(stacked_g, stacked_s, stacked_p)
        for i, w in enumerate(want):
            for k in w:
                torch.testing.assert_close(stacked_p[k][i], w[k], rtol=1e-6, atol=0)

    def test_one_build_for_a_k8_cohort(self):
        """A K=8 mnist cohort builds ONE step (the JAX package's one trace)."""
        trials = [_mnist_trial(f"b{i}", 0.01 * (i + 1), units=6) for i in range(8)]
        before = ttrain.cohort_build_counter.count
        results = run_cohort(trials, MemoryObservationStore(), OBJECTIVE_ACC, device="cpu")
        assert all(r.condition is TrialCondition.SUCCEEDED for r in results.values())
        assert ttrain.cohort_build_counter.count - before == 1


class TestBuckets:
    def test_bucket_sizes_match_the_jax_module(self):
        from katib_tpu.compile import buckets as jbuckets

        for n in range(0, 20):
            assert next_pow2(n) == jbuckets.next_pow2(n)
        for m in (1, 2, 3, 4, 8):
            assert bucket_table(17, m) == jbuckets.bucket_table(17, m)
        assert bucketed_cohort_size(5) == bucket_size(5) == 8
        with pytest.raises(ValueError):
            bucket_size(0)
        with pytest.raises(NotImplementedError, match="mesh"):
            bucketed_cohort_size(5, mesh=object())


# -- CohortContext ------------------------------------------------------------


class TestCohortContext:
    def _ctx(self, k=3, rules=None, **extra):
        trials = [
            _make_trial(f"t{i}", spec_kw={"early_stopping_rules": rules or []},
                        lr=0.01 * (i + 1), units=32)
            for i in range(k)
        ]
        store = MemoryObservationStore()
        return CohortContext(trials, store, OBJECTIVE, device="cpu", **extra), store, trials

    def test_stacked_and_shared(self):
        ctx, _, _ = self._ctx()
        lrs = ctx.stacked("lr", dtype=torch.float32)
        assert lrs.dtype == torch.float32 and lrs.device.type == "cpu"
        np.testing.assert_allclose(lrs.numpy(), [0.01, 0.02, 0.03], rtol=1e-6)
        assert ctx.shared("units") == 32
        assert len(ctx) == 3 and ctx.padded_size == 3

    def test_shared_disagreement_raises(self):
        trials = [_make_trial("a", units=32), _make_trial("b", units=64)]
        ctx = CohortContext(trials, MemoryObservationStore(), OBJECTIVE, device="cpu")
        with pytest.raises(ValueError, match="disagree"):
            ctx.shared("units")

    def test_report_unstacks_rows_per_member(self):
        ctx, store, trials = self._ctx()
        # a tensor and a list: each metric moves to the host once
        assert ctx.report(step=0, loss=torch.tensor([3.0, 2.0, 1.0]), accuracy=[0.1, 0.2, 0.3])
        for i, t in enumerate(trials):
            (metric,) = [m for m in store.observation_for(t.name, OBJECTIVE).metrics
                         if m.name == "loss"]
            assert float(metric.value) == 3.0 - i

    def test_ghost_rows_in_a_bucket_of_8_never_reach_the_store(self):
        ctx, store, trials = self._ctx(k=5, buckets=True)
        assert ctx.padded_size == 8
        lrs = ctx.stacked("lr", dtype=torch.float32)
        assert lrs.shape == (8,) and torch.equal(lrs[5:], lrs[:1].expand(3))
        ctx.report(step=0, loss=torch.arange(8, dtype=torch.float32))
        assert [[m.value for m in store.get(t.name, "loss")] for t in trials] == [
            [0.0], [1.0], [2.0], [3.0], [4.0]]
        with pytest.raises(ValueError, match="rows"):
            ctx.report(step=1, loss=[1.0] * 6)

    def test_nonfinite_objective_fails_member_permanent(self):
        ctx, store, trials = self._ctx()
        ctx.report(step=0, loss=[1.0, float("nan"), 2.0])
        assert not ctx.alive(1) and ctx.alive(0) and ctx.alive(2)
        res = ctx._settle(1)
        assert res.condition is TrialCondition.FAILED
        assert res.failure_kind is FailureKind.PERMANENT and "diverged" in res.message
        # the NaN row never reached the store
        assert store.observation_for(trials[1].name, OBJECTIVE) is None
        assert ctx._settle(0).condition is TrialCondition.SUCCEEDED

    def test_fail_member_transient_kind(self):
        ctx, _, _ = self._ctx()
        ctx.fail_member(0, "preempted", transient=True)
        res = ctx._settle(0)
        assert res.condition is TrialCondition.FAILED
        assert res.failure_kind is FailureKind.TRANSIENT
        # all members done -> the cohort should stop
        ctx.fail_member(1, "x")
        ctx.fail_member(2, "y")
        assert ctx.should_stop()

    def test_early_stop_rule_stops_one_member(self):
        rule = EarlyStoppingRule(name="loss", value=1.5, comparison=ComparisonOp.GREATER,
                                 start_step=0)
        ctx, _, _ = self._ctx(rules=[rule])
        assert ctx.report(step=0, loss=[1.0, 2.0, 1.2])
        assert ctx.alive(0) and not ctx.alive(1) and ctx.alive(2)
        assert ctx._settle(1).condition is TrialCondition.EARLY_STOPPED

    def test_drain_settles_drained(self):
        drain = threading.Event()
        ctx, _, _ = self._ctx(drain_event=drain)
        drain.set()
        assert not ctx.report(step=0, loss=[1.0, 1.0, 1.0])
        assert ctx._settle(0).condition is TrialCondition.DRAINED

    def test_a_mesh_raises(self):
        with pytest.raises(NotImplementedError, match="mesh"):
            self._ctx(mesh=object())


# -- run_cohort ---------------------------------------------------------------


class TestRunCohort:
    def test_no_cohort_fn_falls_back_serial(self):
        calls = []

        def train_fn(tctx):
            calls.append(tctx.trial_name)
            tctx.report(loss=1.0)

        trials = [_make_trial(f"s{i}", spec_kw={"train_fn": train_fn}, lr=0.1) for i in range(2)]
        results = run_cohort(trials, MemoryObservationStore(), OBJECTIVE, device="cpu")
        assert sorted(calls) == ["s0", "s1"]
        assert all(r.condition is TrialCondition.SUCCEEDED for r in results.values())

    def test_cohort_fn_exception_falls_back_serial(self):
        serial_calls = []

        def train_fn(tctx):
            serial_calls.append(tctx.trial_name)
            tctx.report(loss=1.0)

        def bad_cohort(cctx):
            raise RuntimeError("vectorized path exploded")

        attach_cohort_fn(train_fn, bad_cohort)
        trials = [_make_trial(f"f{i}", spec_kw={"train_fn": train_fn}, lr=0.1) for i in range(3)]
        before = obs.cohort_fallbacks.get()
        results = run_cohort(trials, MemoryObservationStore(), OBJECTIVE, device="cpu")
        assert sorted(serial_calls) == ["f0", "f1", "f2"]
        assert all(r.condition is TrialCondition.SUCCEEDED for r in results.values())
        assert obs.cohort_fallbacks.get() - before == 1

    def test_success_path_results_and_metrics(self):
        def train_fn(tctx):  # pragma: no cover - cohort path used instead
            tctx.report(loss=99.0)

        def cohort(cctx):
            cctx.report(step=0, loss=cctx.stacked("lr", dtype=torch.float64) * 10)

        attach_cohort_fn(train_fn, cohort)
        assert cohort_fn_of(train_fn) is cohort
        trials = [_make_trial(f"c{i}", spec_kw={"train_fn": train_fn}, lr=0.1 * (i + 1))
                  for i in range(4)]
        store = MemoryObservationStore()
        before = obs.cohort_fallbacks.get(), obs.cohorts_executed.get()
        results = run_cohort(trials, store, OBJECTIVE, device="cpu")
        assert all(r.condition is TrialCondition.SUCCEEDED for r in results.values())
        for i, t in enumerate(trials):
            obs_ = store.observation_for(t.name, OBJECTIVE)
            np.testing.assert_allclose(float(obs_.metrics[0].value), i + 1.0, rtol=1e-6)
        assert (obs.cohort_fallbacks.get(), obs.cohorts_executed.get() - 1) == before

    def test_a_mesh_fails_each_member_serially(self):
        def train_fn(tctx):  # pragma: no cover - refused before it runs
            tctx.report(loss=1.0)

        attach_cohort_fn(train_fn, lambda cctx: None)
        trials = [_make_trial(f"m{i}", spec_kw={"train_fn": train_fn}) for i in range(2)]
        results = run_cohort(trials, MemoryObservationStore(), OBJECTIVE, mesh=object(),
                             device="cpu")
        assert all(r.condition is TrialCondition.FAILED and "mesh" in r.message
                   for r in results.values())


# -- the orchestrator ---------------------------------------------------------


def _budget_fns(max_seen, lock):
    """train_fn/cohort_fn pair that records peak concurrent member count."""
    active = [0]

    def _enter(n):
        with lock:
            active[0] += n
            max_seen[0] = max(max_seen[0], active[0])

    def _exit(n):
        with lock:
            active[0] -= n

    def train_fn(tctx):
        _enter(1)
        try:
            time.sleep(0.05)
            tctx.report(loss=float(tctx.params["x"]))
        finally:
            _exit(1)

    def cohort_fn(cctx):
        k = len(cctx)
        _enter(k)
        try:
            time.sleep(0.05)
            cctx.report(step=0, loss=cctx.stacked("x", dtype=torch.float64))
        finally:
            _exit(k)

    return attach_cohort_fn(train_fn, cohort_fn)


class TestOrchestratorCohorts:
    def test_grouping_unit(self, tmp_path):
        orch = Orchestrator(workdir=str(tmp_path))
        train_fn = attach_cohort_fn(lambda ctx: None, lambda cctx: None)
        spec = make_spec(train_fn=train_fn, cohort_width=2, cohort_key="g")
        props = [TrialAssignmentSet(assignments=[ParameterAssignment("x", float(i))])
                 for i in range(5)]
        groups = orch._group_proposals(spec, props)
        assert sorted(len(g) for g in groups) == [1, 2, 2]
        # every grouped proposal carries the key label for status/journal
        assert all(p.labels.get(COHORT_KEY_LABEL) == "g" for g in groups for p in g)

    def test_grouping_without_key_or_twin_stays_singleton(self, tmp_path):
        orch = Orchestrator(workdir=str(tmp_path))
        props = [TrialAssignmentSet(assignments=[ParameterAssignment("x", float(i))])
                 for i in range(4)]
        keyless = make_spec(train_fn=attach_cohort_fn(lambda ctx: None, lambda cctx: None),
                            cohort_width=4)
        no_twin = make_spec(cohort_width=4, cohort_key="g")
        for spec in (keyless, no_twin):
            assert sorted(len(g) for g in orch._group_proposals(spec, props)) == [1, 1, 1, 1]

    @pytest.mark.parametrize("async_orch", [False, True])
    def test_cohorts_respect_parallel_budget(self, tmp_path, async_orch):
        max_seen, lock = [0], threading.Lock()
        spec = make_spec(train_fn=_budget_fns(max_seen, lock), cohort_width=2,
                         cohort_key="budget", parallel_trial_count=2, max_trial_count=6,
                         async_orch=async_orch)
        exp = Orchestrator(workdir=str(tmp_path)).run(spec)
        assert exp.condition.is_terminal()
        assert len(exp.trials) == 6
        assert all(t.condition is TrialCondition.SUCCEEDED for t in exp.trials.values())
        assert max_seen[0] <= 2, f"{max_seen[0]} members ran concurrently"

    @pytest.mark.parametrize("async_orch", [False, True])
    def test_transient_member_rejoins_as_singleton(self, tmp_path, async_orch):
        cohort_runs, serial_runs = [], []

        def train_fn(tctx):
            serial_runs.append(tctx.trial_name)
            tctx.report(loss=1.0)

        def cohort_fn(cctx):
            cohort_runs.append([t.name for t in cctx.members])
            cctx.fail_member(0, "injected preemption", transient=True)
            # row 0 is already failed; report settles the survivors
            cctx.report(step=0, loss=[float("nan")] + [2.0] * (len(cctx) - 1))

        attach_cohort_fn(train_fn, cohort_fn)
        spec = make_spec(train_fn=train_fn, cohort_width=2, cohort_key="rejoin",
                         parallel_trial_count=2, max_trial_count=2, max_retries=1,
                         retry_backoff_seconds=0.0, async_orch=async_orch)
        exp = Orchestrator(workdir=str(tmp_path)).run(spec)
        assert exp.condition.is_terminal()
        assert len(cohort_runs) == 1 and len(cohort_runs[0]) == 2
        # the transient-failed member re-ran serially under its own name
        assert serial_runs == [cohort_runs[0][0]]
        conditions = {t.name: t.condition for t in exp.trials.values()}
        assert all(c is TrialCondition.SUCCEEDED for c in conditions.values()), conditions
        assert exp.trials[cohort_runs[0][0]].retry_count == 1


# -- mnist_cohort_trial --------------------------------------------------------

STRUCT = dict(units=12, num_layers=1, epochs=2, batch_size=64, n_train=256, n_test=128,
              optimizer="momentum")


def _mnist_trial(name, lr, **changes):
    return _make_trial(name, spec_kw={"train_fn": tmnist.mnist_trial}, lr=lr,
                       **dict(STRUCT, **changes))


@pytest.fixture
def float32_mlp(monkeypatch):
    """Both packages' ``MLP`` in float32, the port's drawn as the JAX
    trainer draws (``PRNGKey(0)`` on a zero batch), carried by
    ``convert.py``."""
    monkeypatch.setattr(jmnist, "MLP", functools.partial(jmnist.MLP, dtype=jnp.float32))

    class MLP(tmnist.MLP):
        def __init__(self, **kw):
            super().__init__(dtype=torch.float32, **kw)
            self.jax = jmnist.MLP(units=kw["units"], num_layers=kw["num_layers"])

        def reset_parameters(self, generator=None):
            params = jax.device_get(self.jax.init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, 28, 28, 1), jnp.float32)))
            self.load_state_dict(mnist_state_dict_from_flax(params, self))

    monkeypatch.setattr(tmnist, "MLP", MLP)


def _series(store, names, metric):
    return [[m.value for m in store.get(n, metric)] for n in names]


class TestMnistCohort:
    @pytest.mark.parametrize("optimizer", ["momentum", "adam"])
    def test_mnist_cohort_matches_the_jax_twin_k4(self, float32_mlp, optimizer):
        lrs = [0.02, 0.05, 0.08, 0.11] if optimizer == "momentum" else [0.002, 0.005, 0.01, 0.02]
        struct = dict(STRUCT, optimizer=optimizer)
        jstore = JaxMemoryStore()
        jtrials = [jtypes.Trial(name=f"c{i}", experiment_name="x", spec=jtypes.TrialSpec(
            assignments=[jtypes.ParameterAssignment(k, v) for k, v in dict(struct, lr=lr).items()],
            train_fn=jmnist.mnist_trial)) for i, lr in enumerate(lrs)]
        jobj = jtypes.ObjectiveSpec(type=jtypes.ObjectiveType.MAXIMIZE,
                                    objective_metric_name="accuracy")
        jres = jcohort.run_cohort(jtrials, jstore, jobj)
        assert all(r.condition is jtypes.TrialCondition.SUCCEEDED for r in jres.values())
        store = MemoryObservationStore()
        trials = [_mnist_trial(f"c{i}", lr, optimizer=optimizer) for i, lr in enumerate(lrs)]
        before = obs.cohort_fallbacks.get()
        results = run_cohort(trials, store, OBJECTIVE_ACC, device="cpu")
        assert all(r.condition is TrialCondition.SUCCEEDED for r in results.values())
        assert obs.cohort_fallbacks.get() == before
        names = [t.name for t in trials]
        # float32: the losses a few roundings apart, the accuracies equal
        # but for a test example whose two logits tie within that
        np.testing.assert_allclose(_series(store, names, "loss"),
                                   _series(jstore, names, "loss"), rtol=1e-4)
        np.testing.assert_allclose(_series(store, names, "accuracy"),
                                   _series(jstore, names, "accuracy"), rtol=0, atol=1 / 128)

    @pytest.mark.parametrize("optimizer,k,buckets", [("momentum", 4, False), ("sgd", 3, True),
                                                     ("adam", 3, True)])
    def test_each_member_equals_its_serial_run(self, float32_mlp, optimizer, k, buckets):
        """The cohort equals K serial ``mnist_trial`` runs; a ragged cohort
        of 3 padded to 4 (one ghost row) too."""
        lrs = [0.01, 0.03, 0.05, 0.07][:k]
        serial = MemoryObservationStore()
        for i, lr in enumerate(lrs):
            r = run_trial(_mnist_trial(f"m{i}", lr, optimizer=optimizer), serial, OBJECTIVE_ACC,
                          device="cpu")
            assert r.condition is TrialCondition.SUCCEEDED, r.message
        store = MemoryObservationStore()
        trials = [_mnist_trial(f"m{i}", lr, optimizer=optimizer) for i, lr in enumerate(lrs)]
        results = run_cohort(trials, store, OBJECTIVE_ACC, buckets=buckets, device="cpu")
        assert all(r.condition is TrialCondition.SUCCEEDED for r in results.values())
        names = [t.name for t in trials]
        for metric in ("loss", "accuracy"):
            np.testing.assert_allclose(_series(store, names, metric),
                                       _series(serial, names, metric), rtol=1e-5, atol=1e-6)

    def test_structural_disagreement_falls_back_to_serial(self):
        trials = [_mnist_trial("u0", 0.05, units=6, epochs=1),
                  _mnist_trial("u1", 0.05, units=8, epochs=1)]
        before = obs.cohort_fallbacks.get()
        results = run_cohort(trials, MemoryObservationStore(), OBJECTIVE_ACC, device="cpu")
        assert all(r.condition is TrialCondition.SUCCEEDED for r in results.values())
        assert obs.cohort_fallbacks.get() - before == 1

    def test_cohort_spec_runs_in_cohorts_of_four(self, tmp_path):
        """``katib_tpu_torch/specs/cohort-mnist.yaml`` (cut to a small MLP):
        12 trials in 3 cohorts of 4, each one ``cohort`` span."""
        import json
        import os

        from katib_tpu_torch.sdk.yaml_spec import load_experiment_yaml

        spec = load_experiment_yaml(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "katib_tpu_torch", "specs", "cohort-mnist.yaml"))
        assert spec.train_fn is tmnist.mnist_trial and spec.cohort_width == 4
        spec.parameters = [p for p in spec.parameters if p.name != "units"] + [
            ParameterSpec(name, ParameterType.INT, FeasibleSpace(min=v, max=v))
            for name, v in (("units", 8), ("n_train", 256))]
        before = obs.cohort_fallbacks.get()
        exp = Orchestrator(workdir=str(tmp_path)).run(spec)
        assert exp.condition.value == "MaxTrialsReached", exp.message
        assert [t.condition for t in exp.trials.values()] == [TrialCondition.SUCCEEDED] * 12
        with open(tmp_path / spec.name / "trace.jsonl") as f:
            records = [json.loads(line) for line in f]
        sizes = [r["args"]["size"] for r in records if r["name"] == "cohort"]
        assert sum(sizes) == 12 and max(sizes) == 4, sizes
        assert obs.cohort_fallbacks.get() == before
