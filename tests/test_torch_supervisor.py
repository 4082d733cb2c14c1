"""The port's loop supervision (``katib_tpu_torch/orchestrator/supervisor.py``)
and its engine wiring, against ``tests/test_supervisor.py`` on
``device="cpu"``:
stall-vs-starvation classification, crash restarts with generation
fencing, restart-budget exhaustion degrading to the sync path,
speculative straggler re-dispatch with first-settle-wins, and the
deadline-bounded suggester call.

The unit tests drive :class:`LoopSupervisor` with a fake clock and bare
threads; the engine tests kill real loop threads mid-run through the
``FaultInjector`` seams and assert recovery with zero lost or duplicated
settlements (journal replay is the referee).  Then the ``chaos`` verb:
``--soak`` drives ``orchestrator/soak.py``, its other modes raise.
"""

import os
import threading
import time

import pytest
import torch

from katib_tpu_torch.core.types import (
    AlgorithmSpec,
    ExperimentCondition,
    ExperimentSpec,
    FeasibleSpace,
    ObjectiveSpec,
    ObjectiveType,
    ParameterSpec,
    ParameterType,
    TrialCondition,
)
from katib_tpu_torch.orchestrator import Orchestrator as _Orchestrator
from katib_tpu_torch.orchestrator import journal as jr
from katib_tpu_torch.orchestrator import supervisor as sup_mod
from katib_tpu_torch.orchestrator.supervisor import LoopSupervisor
from katib_tpu_torch.suggest.base import Suggester, call_suggester, make_suggester
from katib_tpu_torch.utils.faults import Backoff, CircuitBreaker, FaultInjector

torch.set_num_threads(1)


def Orchestrator(**kw):
    """The port's orchestrator on the CPU, as a caller must name it."""
    return _Orchestrator(device="cpu", **kw)


OBJ = ObjectiveSpec(type=ObjectiveType.MAXIMIZE, objective_metric_name="accuracy")


def grid_spec(points=8, **kw):
    defaults = dict(
        name=kw.pop("name", f"sup-exp-{time.time_ns()}"),
        objective=OBJ,
        algorithm=AlgorithmSpec(name="grid"),
        parameters=[
            ParameterSpec(
                "x",
                ParameterType.DOUBLE,
                FeasibleSpace(min=0.0, max=float(points - 1), step=1.0),
            )
        ],
        max_trial_count=points,
        parallel_trial_count=4,
        async_orch=True,
        train_fn=lambda ctx: ctx.report(
            step=1, accuracy=1.0 - 0.01 * (float(ctx.params["x"]) - 2.0) ** 2
        ),
    )
    defaults.update(kw)
    return ExperimentSpec(**defaults)


def assert_exactly_once(workdir, exp):
    """Journal replay is the settlement referee: zero duplicate settle
    records, and every in-memory terminal trial terminal in the replay."""
    state, stats = jr.replay_journal(workdir, exp.name)
    assert stats.duplicates == 0, f"double-settled records: {stats.duplicates}"
    replayed = (state or {}).get("trials") or {}
    for t in exp.trials.values():
        if t.condition.is_terminal():
            assert t.name in replayed, f"settled trial lost: {t.name}"
            assert replayed[t.name]["condition"] == t.condition.value


# ---------------------------------------------------------------------------
# supervisor units (fake clock, bare threads)
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def alive_spawn(gen):
    """An 'alive' loop: parks on an event until the test ends."""
    t = threading.Thread(target=threading.Event().wait, daemon=True)
    t.start()
    return t


def dead_spawn(gen):
    """A loop that dies instantly (already joined when returned)."""
    t = threading.Thread(target=lambda: None, daemon=True)
    t.start()
    t.join()
    return t


def make_sup(clock, **kw):
    kw.setdefault("stall_deadline", 10.0)
    kw.setdefault("backoff", Backoff(base=1.0, factor=1.0, cap=1.0, jitter=0.0))
    return LoopSupervisor(clock=clock, **kw)


class TestClassification:
    def test_fresh_loop_is_ok(self):
        clk = FakeClock()
        sup = make_sup(clk)
        sup.add("a", alive_spawn)
        assert sup.tick() == {"a": sup_mod.OK}

    def test_no_work_is_starved_not_stalled(self):
        clk = FakeClock()
        sup = make_sup(clk)
        sup.add("a", alive_spawn, has_work=lambda: False)
        clk.advance(100.0)  # way past the deadline — but there was no work
        assert sup.tick()["a"] == sup_mod.STARVED
        clk.advance(100.0)
        assert sup.tick()["a"] == sup_mod.STARVED

    def test_starved_loop_gets_fresh_deadline_when_work_arrives(self):
        clk = FakeClock()
        work = [False]
        sup = make_sup(clk)
        sup.add("a", alive_spawn, has_work=lambda: work[0])
        clk.advance(100.0)
        assert sup.tick()["a"] == sup_mod.STARVED
        work[0] = True
        # the idle century must not count: the first tick after work
        # arrives re-arms the watermark instead of declaring a stall
        assert sup.tick()["a"] == sup_mod.OK
        clk.advance(9.0)
        assert sup.tick()["a"] == sup_mod.OK  # still inside the deadline
        clk.advance(2.0)
        assert sup.tick()["a"] == sup_mod.STALLED  # now it is overdue

    def test_beat_defers_stall(self):
        clk = FakeClock()
        sup = make_sup(clk)
        sup.add("a", alive_spawn)
        for _ in range(5):
            clk.advance(9.0)
            sup.beat("a")
            assert sup.tick()["a"] == sup_mod.OK

    def test_finished_dead_loop_is_done(self):
        clk = FakeClock()
        sup = make_sup(clk)
        sup.add("a", dead_spawn, finished=lambda: True)
        assert sup.tick()["a"] == sup_mod.DONE

    def test_dead_unfinished_loop_is_crashed(self):
        clk = FakeClock()
        sup = make_sup(clk)
        sup.add("a", dead_spawn)
        assert sup.tick()["a"] == sup_mod.CRASHED


class TestRestartsAndFallback:
    def test_crash_restarts_with_generation_bump(self):
        clk = FakeClock()
        spawned = []

        def spawn(gen):
            spawned.append(gen)
            return alive_spawn(gen) if gen > 0 else dead_spawn(gen)

        restarts = []
        sup = make_sup(clk, on_restart=lambda *a: restarts.append(a))
        sup.add("a", spawn)
        assert sup.tick()["a"] == sup_mod.CRASHED  # schedules the restart
        assert sup.tick()["a"] == sup_mod.RESTARTING  # backoff not yet due
        clk.advance(1.5)
        assert sup.tick()["a"] == sup_mod.OK  # restarted
        assert spawned == [0, 1]
        assert sup.generation("a") == 1
        assert sup.restart_counts() == {"a": 1}
        assert restarts == [("a", 1, sup_mod.CRASHED, 1)]
        assert sup.tick()["a"] == sup_mod.OK  # the replacement is healthy

    def test_budget_exhaustion_raises_fallback(self):
        clk = FakeClock()
        reasons = []
        sup = make_sup(
            clk, restart_budget=2, on_fallback=lambda r: reasons.append(r)
        )
        sup.add("a", dead_spawn)  # every generation dies instantly
        for _ in range(2):
            assert sup.tick()["a"] == sup_mod.CRASHED
            clk.advance(1.5)
            assert sup.tick()["a"] == sup_mod.OK  # restart burned
        assert sup.tick()["a"] == sup_mod.CRASHED  # third death: budget gone
        assert sup.fallback
        assert "'a'" in sup.fallback_reason and "crashed" in sup.fallback_reason
        assert reasons == [sup.fallback_reason]
        # frozen after fallback: no further restarts are scheduled
        assert sup.restart_counts() == {"a": 2}
        sup.tick()
        assert sup.restart_counts() == {"a": 2}

    def test_zero_budget_falls_back_on_first_crash(self):
        clk = FakeClock()
        sup = make_sup(clk, restart_budget=0)
        sup.add("a", dead_spawn)
        assert sup.tick()["a"] == sup_mod.CRASHED
        assert sup.fallback

    def test_stalled_loop_restarts_too(self):
        clk = FakeClock()
        spawned = []

        def spawn(gen):
            spawned.append(gen)
            return alive_spawn(gen)

        sup = make_sup(clk)
        sup.add("a", spawn)
        clk.advance(11.0)  # work available, watermark frozen
        assert sup.tick()["a"] == sup_mod.STALLED
        clk.advance(1.5)
        assert sup.tick()["a"] == sup_mod.OK
        assert spawned == [0, 1]


class TestBackoffJitter:
    def test_full_jitter_bounded_and_seeded(self):
        a = Backoff(base=2.0, factor=2.0, cap=5.0, full_jitter=True, seed=7)
        b = Backoff(base=2.0, factor=2.0, cap=5.0, full_jitter=True, seed=7)
        for attempt in range(1, 8):
            da, db = a.delay(attempt), b.delay(attempt)
            assert da == db  # same seed, same schedule
            assert 0.0 <= da <= min(2.0 * 2.0 ** (attempt - 1), 5.0)


# ---------------------------------------------------------------------------
# engine: kill each loop mid-run, recover exactly-once
# ---------------------------------------------------------------------------


@pytest.mark.chaos
class TestLoopKillRecovery:
    @pytest.mark.parametrize("loop", ["suggest", "schedule", "harvest"])
    def test_killed_loop_recovers_without_loss_or_dup(self, loop, tmp_path):
        # iteration 1 = the loop dies before doing ANY work, so the run
        # can only complete if the supervisor actually restarts it (a
        # later kill can race a fast experiment to completion)
        injector = FaultInjector(seed=0).kill_loop(loop, at_iteration=1)
        spec = grid_spec(points=8, loop_restart_budget=3)
        orch = Orchestrator(workdir=str(tmp_path), fault_injector=injector)
        exp = orch.run(spec)
        assert exp.condition is ExperimentCondition.MAX_TRIALS_REACHED
        assert len(exp.trials) == 8
        assert all(
            t.condition is TrialCondition.SUCCEEDED for t in exp.trials.values()
        )
        st = orch.async_stats
        assert st is not None and st["fallback"] is None
        assert st["loop_restarts"].get(loop, 0) >= 1, st
        assert any(e.get("seam") == "kill-loop" for e in injector.log)
        assert_exactly_once(str(tmp_path), exp)

    def test_budget_exhaustion_degrades_to_sync_path(self, tmp_path):
        # every suggest generation dies on its first iteration: the budget
        # burns down and the engine must hand the experiment to the sync
        # loop, which still completes it
        injector = FaultInjector(seed=0)
        for it in range(1, 13):
            injector.kill_loop("suggest", at_iteration=it)
        spec = grid_spec(points=6, loop_restart_budget=2)
        orch = Orchestrator(workdir=str(tmp_path), fault_injector=injector)
        exp = orch.run(spec)
        assert exp.condition is ExperimentCondition.MAX_TRIALS_REACHED
        assert len(exp.trials) == 6
        assert all(
            t.condition is TrialCondition.SUCCEEDED for t in exp.trials.values()
        )
        st = orch.async_stats
        assert st is not None
        assert st["fallback"] and "suggest" in st["fallback"]
        assert st["loop_restarts"]["suggest"] == 2
        assert_exactly_once(str(tmp_path), exp)


# ---------------------------------------------------------------------------
# engine: speculative straggler re-dispatch
# ---------------------------------------------------------------------------


def straggler_trainer(ctx):
    """x == 0 is a rigged straggler — but only on its ORIGINAL dispatch;
    the speculative rival (checkpoint dir suffixed ``-speculative``) runs
    fast, so the rival must win the settle race."""
    x = float(ctx.params["x"])
    if x == 0.0 and not ctx.checkpoint_dir.endswith("-speculative"):
        deadline = time.monotonic() + 1.5
        while time.monotonic() < deadline:
            time.sleep(0.05)
    ctx.report(step=1, accuracy=1.0 - 0.01 * (x - 2.0) ** 2)


@pytest.mark.chaos
class TestSpeculation:
    def test_straggler_respeculated_first_settle_wins(self, tmp_path):
        spec = grid_spec(
            points=8,
            speculative_redispatch=True,
            straggler_factor=2.0,
            train_fn=straggler_trainer,
        )
        orch = Orchestrator(workdir=str(tmp_path))
        t0 = time.monotonic()
        exp = orch.run(spec)
        elapsed = time.monotonic() - t0
        assert exp.condition is ExperimentCondition.MAX_TRIALS_REACHED
        assert len(exp.trials) == 8
        assert all(
            t.condition is TrialCondition.SUCCEEDED for t in exp.trials.values()
        )
        st = orch.async_stats
        assert st is not None
        assert st["speculative_dispatches"] >= 1, st
        # a win proves the rival settled FIRST and the straggler's later
        # settle was discarded (pool teardown still joins the orphan, so
        # wall-clock alone cannot prove the race)
        assert st["speculative_wins"] >= 1, st
        assert elapsed < 10.0, f"speculation run took too long: {elapsed:.1f}s"
        assert_exactly_once(str(tmp_path), exp)

    def test_speculation_off_by_default(self, tmp_path):
        spec = grid_spec(points=4)
        orch = Orchestrator(workdir=str(tmp_path))
        orch.run(spec)
        assert orch.async_stats["speculative_dispatches"] == 0


# ---------------------------------------------------------------------------
# deadline-bounded suggester call
# ---------------------------------------------------------------------------


class WedgedSuggester(Suggester):
    """get_suggestions blocks far past any reasonable deadline."""

    name = "wedged"
    adaptive = False

    def __init__(self, inner):
        self.inner = inner
        self.spec = inner.spec

    def get_suggestions(self, experiment, count):
        time.sleep(30.0)
        return self.inner.get_suggestions(experiment, count)


class TestSuggesterDeadline:
    def test_deadline_abandons_call_and_records_breaker_failure(self):
        spec = grid_spec(points=4)
        sug = WedgedSuggester(make_suggester(spec))
        breaker = CircuitBreaker(threshold=3)
        from katib_tpu_torch.core.types import Experiment

        exp = Experiment(spec=spec)
        t0 = time.monotonic()
        proposals, outcome = call_suggester(
            sug, exp, 2, breaker, None, deadline=0.3
        )
        assert time.monotonic() - t0 < 2.0  # returned, not wedged
        assert proposals == [] and outcome == "error"
        assert breaker.failures == 1
        assert "deadline" in breaker.last_failure

    def test_wedged_suggester_fails_diagnosed_not_hung(self, tmp_path):
        spec = grid_spec(
            points=4,
            loop_stall_deadline_seconds=0.5,
            suggester_max_errors=2,
        )
        orch = Orchestrator(
            workdir=str(tmp_path),
            suggester_fn=lambda s: WedgedSuggester(make_suggester(s)),
        )
        t0 = time.monotonic()
        exp = orch.run(spec)
        elapsed = time.monotonic() - t0
        assert exp.condition is ExperimentCondition.FAILED
        assert "deadline" in (exp.message or "")
        assert elapsed < 20.0, "wedged suggester froze the run"


# ---------------------------------------------------------------------------
# the soak's arming rule: an armed loop kill always finds its loop with work
# ---------------------------------------------------------------------------


def _soak_rounds(seed: int, trials: int = 8):
    """The rounds ``run_soak`` builds from ``seed``: the core rounds, then
    the seeded mixed rounds in order."""
    import random

    from katib_tpu_torch.orchestrator import soak

    rng = random.Random(seed)
    core = soak._core_rounds(rng)
    return core + [soak._mixed_round(i, rng, trials) for i in range(len(core) - 1, 50)]


def test_soak_arms_suggest_kills_before_the_budget_is_proposed():
    """The suggest loop proposes a whole lookahead (here the whole budget)
    in its first iteration, so every soak schedule arms its kill there."""
    armed = 0
    for seed in range(200):
        for rnd in _soak_rounds(seed):
            inj = FaultInjector(seed=0)
            if rnd.arm is not None:
                rnd.arm(inj)
            for it in inj._loop_kills.get("suggest", []):
                assert it == 1, (seed, rnd.name, it)
                armed += 1
    assert armed > 200


@pytest.mark.chaos
def test_soak_kill_rounds_find_work_left_and_restart(monkeypatch):
    """On the engine, each kill round of seeds 0 and 1 (the seed of the soak
    smoke) kills its loop while that loop still has work: the suggest loop
    with budget unproposed, the schedule loop with trials to dispatch, the
    harvest loop with trials to settle; and the supervisor restarts it."""
    import random

    from katib_tpu_torch.orchestrator import async_loops, soak
    from katib_tpu_torch.utils.clock import get_clock

    at_kill = []
    real_seam = async_loops.AsyncLoops._seam

    def seam(self, name):
        inj = self.orch.fault_injector
        if inj._loop_iters.get(name, 0) + 1 in inj._loop_kills.get(name, ()):
            budget = self.spec.max_trial_count - len(self.exp.trials)
            unsettled = sum(not t.condition.is_terminal() for t in self.exp.trials.values())
            at_kill.append((name, {
                "suggest": budget > 0,
                "schedule": budget > 0 or self._queued_count() > 0,
                "harvest": budget > 0 or unsettled > 0,
            }[name]))
        return real_seam(self, name)

    monkeypatch.setattr(async_loops.AsyncLoops, "_seam", seam)
    killed = set()
    for seed in (0, 1):
        for i, rnd in enumerate(_soak_rounds(seed)[:14]):
            if rnd.expect_restart is None:
                continue
            at_kill.clear()
            exp, orch, errs, _ = soak._run_round(rnd, seed * 1000 + i, 8, 4, get_clock())
            assert errs == [], errs
            assert at_kill == [(rnd.expect_restart, True)], (seed, rnd.name, at_kill)
            killed.add(rnd.expect_restart)
    assert killed == {"suggest", "schedule", "harvest"}


# ---------------------------------------------------------------------------
# bounded soak smoke (excluded from tier-1: slow + soak markers)
# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.soak
def test_soak_smoke():
    from katib_tpu_torch.orchestrator.soak import run_soak

    assert run_soak(seconds=30, seed=1, trials=8) == 0


# ---------------------------------------------------------------------------
# the chaos verb: --soak is ported, its other modes raise naming themselves
# ---------------------------------------------------------------------------


def test_chaos_soak_drives_run_soak(monkeypatch):
    from katib_tpu_torch import cli
    from katib_tpu_torch.orchestrator import soak

    calls = []
    monkeypatch.setattr(soak, "run_soak", lambda **kw: calls.append(kw) or 0)
    assert cli.main(["chaos", "--soak", "30", "--seed", "1", "--trials", "12"]) == 0
    # --trials can only raise the per-round trial count above 10
    assert cli.main(["chaos", "--soak", "5", "--seed", "2"]) == 0
    assert calls == [dict(seconds=30.0, seed=1, trials=12), dict(seconds=5.0, seed=2, trials=10)]


@pytest.mark.parametrize(
    "args,match",
    [
        ([], "single fault-injection run"),
        (["--seed", "3", "--fail-trial", "0:1"], "single fault-injection run.*--fail-trial"),
        (["--soak", "5", "--kill-loop", "suggest"], "single fault-injection run.*--kill-loop"),
        (["--crash-at", "journal.append:8"], "--crash-at"),
        (["--kill-at", "journal.append"], "--kill-at"),
        (["--wedge-device", "0"], "--wedge-device"),
    ],
    ids=["no-mode", "fail-trial", "soak-with-fault-flag", "crash-at", "kill-at", "wedge-device"],
)
def test_chaos_modes_other_than_soak_raise_naming_themselves(args, match):
    from katib_tpu_torch import cli

    with pytest.raises(NotImplementedError, match=match):
        cli.main(["chaos", *args])


def test_chaos_without_soak_raises_from_the_command_line():
    """``python -m katib_tpu_torch chaos`` in a fresh interpreter."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "katib_tpu_torch", "chaos"], cwd=root, capture_output=True,
        text=True, timeout=120, env={**os.environ, "PYTHONPATH": root},
    )
    assert out.returncode != 0
    assert "NotImplementedError: chaos without --soak" in out.stderr, out.stderr[-2000:]
