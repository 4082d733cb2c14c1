"""Seeded chaos soak for the supervised async orchestrator.

``python -m katib_tpu_torch chaos --soak SECONDS --seed N`` drives this
harness (port of ``katib_tpu/orchestrator/soak.py``): a
deterministic, time-bounded sequence of small white-box experiments, each
run under the async engine with a fresh :class:`~katib_tpu_torch.utils.faults.
FaultInjector` planting one scripted failure mix — the loop-kill and
suggester-stall seams of ``utils/faults.py`` plus the trial faults —
and after every round the same invariants are asserted:

- the experiment reaches a terminal condition and is not FAILED;
- journal replay (``orchestrator/journal.py``) reports **zero duplicate
  settlements** and every in-memory terminal trial is terminal with the
  same condition in the replayed state (no settled trial lost);
- per-trial retry budgets are respected;
- per-loop restart counts stay within ``loopRestartBudget`` and the
  engine did not silently degrade to the sync path (no fallback) unless
  the round scripted budget exhaustion;
- a killed loop was actually restarted (the supervisor healed it).

The schedule is a pure function of ``--seed``: the same seed replays the
same fault mix, iteration arms, and round order, so a CI failure
reproduces locally with one flag.  Core rounds (baseline, one kill per
loop, a suggester stall past its deadline, a speculation round) always
run; extra seeded mixed rounds fill whatever remains of the time budget.
The final round repeats the clean baseline and asserts post-fault
sustained occupancy recovered to >= ``OCCUPANCY_RECOVERY`` x the
pre-fault baseline — the "did the mesh come back" check.

The trainer sleeps and touches no device, so every round's orchestrator
runs on the CPU, as a caller must name it, without the device preflight.
"""

from __future__ import annotations

import os
import random

from katib_tpu_torch.utils.clock import get_clock

#: post-fault sustained occupancy must recover to this fraction of the
#: pre-fault baseline
OCCUPANCY_RECOVERY = 0.7

#: trainer step sleep; slow trials multiply this (see _soak_trainer)
_STEP_SLEEP = 0.02
_SLOW_STEP_SLEEP = 0.35
#: lr above this is a deterministic straggler (the random suggester is
#: seeded, so which trials straggle is a function of the round seed) —
#: only when the speculation round arms ``_SLOW_ENV``, so every other
#: round keeps uniform trial durations and a stable occupancy signal
_SLOW_LR = 0.14
_SLOW_ENV = "KATIB_SOAK_STRAGGLERS"


def _soak_trainer(ctx):
    """Checkpoint-aware toy trainer (module-level so crash-round children
    can import it).  With ``KATIB_SOAK_STRAGGLERS=1``, trials whose lr
    exceeds ``_SLOW_LR`` run ~17x slower — deterministic stragglers for
    the speculation round."""
    os.makedirs(ctx.checkpoint_dir, exist_ok=True)
    marker = os.path.join(ctx.checkpoint_dir, "progress.txt")
    start = 0
    if os.path.exists(marker):
        with open(marker) as f:
            start = int(f.read().strip() or 0)
    x = float(ctx.params["lr"])
    slow = os.environ.get(_SLOW_ENV) == "1" and x > _SLOW_LR
    sleep = _SLOW_STEP_SLEEP if slow else _STEP_SLEEP
    for step in range(start, 3):
        with open(marker, "w") as f:
            f.write(str(step + 1))
        get_clock().sleep(sleep)
        if not ctx.report(
            step=step, accuracy=(1.0 - 0.2 * (x - 0.05) ** 2) * (step + 1) / 3
        ):
            return


def _make_spec(
    name: str,
    seed: int,
    trials: int,
    parallel: int,
    stall_deadline: float = 2.0,
    restart_budget: int = 3,
    speculative: bool = False,
):
    from katib_tpu_torch.core.types import (
        AlgorithmSpec,
        ExperimentSpec,
        FeasibleSpace,
        ObjectiveSpec,
        ObjectiveType,
        ParameterSpec,
        ParameterType,
    )

    return ExperimentSpec(
        name=name,
        algorithm=AlgorithmSpec(name="random", settings={"seed": str(seed)}),
        objective=ObjectiveSpec(
            type=ObjectiveType.MAXIMIZE, objective_metric_name="accuracy"
        ),
        parameters=[
            ParameterSpec(
                "lr", ParameterType.DOUBLE, FeasibleSpace(min=0.01, max=0.2)
            )
        ],
        max_trial_count=trials,
        parallel_trial_count=parallel,
        max_retries=2,
        retry_backoff_seconds=0.01,
        suggester_max_errors=3,
        async_orch=True,
        loop_stall_deadline_seconds=stall_deadline,
        loop_restart_budget=restart_budget,
        speculative_redispatch=speculative,
        straggler_factor=2.0,
        train_fn=_soak_trainer,
    )


class _Round:
    """One soak round: a name, an injector-arming closure, spec overrides,
    and round-specific extra assertions."""

    def __init__(
        self, name, arm=None, expect_restart=None, expect_seam=None, **spec_kw
    ):
        self.name = name
        self.arm = arm  # fn(injector) -> None
        self.expect_restart = expect_restart  # loop name or None
        self.expect_seam = expect_seam  # injector.log seam that must fire
        self.spec_kw = spec_kw


def _check_round(rnd, exp, orch, workdir, spec, injector):
    """The invariants every round must satisfy; returns a failures list."""
    from katib_tpu_torch.core.types import ExperimentCondition
    from katib_tpu_torch.orchestrator import journal as jr

    failures: list[str] = []
    tag = f"[{rnd.name}]"
    if not exp.condition.is_terminal():
        failures.append(f"{tag} experiment not terminal: {exp.condition.value}")
    if exp.condition is ExperimentCondition.FAILED:
        head = exp.message.splitlines()[0] if exp.message else ""
        failures.append(f"{tag} experiment failed: {head}")
    # exactly-once settlement: the durable journal must agree with memory
    state, stats = jr.replay_journal(workdir, spec.name)
    if stats.duplicates:
        failures.append(
            f"{tag} journal replay dropped {stats.duplicates} duplicate "
            "settlement record(s) — something settled twice"
        )
    replayed = (state or {}).get("trials") or {}
    for t in exp.trials.values():
        if not t.condition.is_terminal():
            continue
        rt = replayed.get(t.name)
        if rt is None:
            failures.append(f"{tag} settled trial lost from the journal: {t.name}")
        elif rt.get("condition") != t.condition.value:
            failures.append(
                f"{tag} settled trial {t.name} diverges from the journal: "
                f"memory={t.condition.value} journal={rt.get('condition')}"
            )
    for t in exp.trials.values():
        if t.retry_count > spec.max_retries:
            failures.append(
                f"{tag} retry budget exceeded: {t.name} retried "
                f"{t.retry_count} > {spec.max_retries}"
            )
    st = orch.async_stats or {}
    for loop, n in (st.get("loop_restarts") or {}).items():
        if n > spec.loop_restart_budget:
            failures.append(
                f"{tag} loop {loop!r} restarted {n} times, over the "
                f"budget of {spec.loop_restart_budget}"
            )
    if st.get("fallback"):
        failures.append(
            f"{tag} async engine fell back to sync: {st['fallback']}"
        )
    if rnd.expect_restart is not None:
        n = (st.get("loop_restarts") or {}).get(rnd.expect_restart, 0)
        if n < 1:
            failures.append(
                f"{tag} killed loop {rnd.expect_restart!r} was never "
                "restarted by the supervisor"
            )
    if rnd.expect_seam is not None and not any(
        e.get("seam") == rnd.expect_seam for e in injector.log
    ):
        failures.append(f"{tag} armed {rnd.expect_seam!r} fault never fired")
    return failures


def _kill_iteration(loop: str, drawn: int) -> int:
    """The iteration at which a kill of ``loop`` is armed, from the seeded
    draw.  A kill must find its loop with work left: otherwise the round
    can settle before the supervisor's restart is due, and the
    kill-restart check fails on a sound engine.  The suggest loop's first
    iteration proposes up to a whole lookahead, and the soak's random
    suggester is not adaptive, so its lookahead (4x the parallel count)
    covers a round's budget: only iteration 1 is sure to find proposals
    left to make.  The schedule and harvest loops keep work until the last
    trial is dispatched and settled, many iterations after the draw."""
    return 1 if loop == "suggest" else drawn


def _stall(inj) -> None:
    # three times the round's stall deadline: the deadline-bounded
    # suggester call must abandon the worker and trip the breaker
    # instead of freezing the suggest loop.  Call 1 — the lookahead
    # bank usually covers the whole budget in one or two calls
    inj.stall_suggester(seconds=2.25, call=1)


def _core_rounds(rng: random.Random) -> list[_Round]:
    """The rounds every soak runs, in order; the last is the post-fault
    baseline."""

    def kill(loop):
        # arm inside the first few iterations so work definitely remains
        # when the thread dies — recovery, not a lucky clean exit
        it = _kill_iteration(loop, rng.randint(1, 3))
        return lambda inj: inj.kill_loop(loop, at_iteration=it)

    return [
        _Round("baseline"),
        _Round(
            "kill-suggest", kill("suggest"),
            expect_restart="suggest", expect_seam="kill-loop",
        ),
        _Round(
            "kill-schedule", kill("schedule"),
            expect_restart="schedule", expect_seam="kill-loop",
        ),
        _Round(
            "kill-harvest", kill("harvest"),
            expect_restart="harvest", expect_seam="kill-loop",
        ),
        _Round(
            "stall-suggester", _stall,
            expect_seam="suggester-stall", stall_deadline=0.75,
        ),
        _Round("speculation", speculative=True),
        _Round("post-fault"),
    ]


def _mixed_round(i: int, rng: random.Random, trials: int) -> _Round:
    """Seeded mixed round ``i``: one or two of a loop kill, a failing
    trial, flaky trials and a suggester stall."""
    actions = []
    loops = ["suggest", "schedule", "harvest"]
    picks = rng.sample(["kill", "fail", "flake", "stall"], k=rng.randint(1, 2))
    loop = rng.choice(loops)
    it = _kill_iteration(loop, rng.randint(1, 4))
    k, j = rng.randrange(trials), rng.randint(1, 2)
    rate = round(rng.uniform(0.05, 0.2), 3)

    def arm(inj):
        for p in picks:
            if p == "kill":
                inj.kill_loop(loop, at_iteration=it)
                actions.append(f"kill-{loop}@{it}")
            elif p == "fail":
                inj.fail_trial(k, j)
                actions.append(f"fail-trial{k}:{j}")
            elif p == "flake":
                inj.flake(rate)
                actions.append(f"flake{rate}")
            elif p == "stall":
                inj.stall_suggester(seconds=2.25, call=1)
                actions.append("stall@1")

    expect = loop if "kill" in picks else None
    r = _Round(f"mixed-{i}", arm, expect_restart=expect)
    if "kill" in picks:
        r.expect_seam = "kill-loop"
    if "stall" in picks:
        r.spec_kw["stall_deadline"] = 0.75
    return r


def _run_round(rnd: _Round, round_seed: int, trials: int, parallel: int, clock):
    """Run one round under a fresh seeded injector; returns ``(exp, orch,
    failures, faults fired)``."""
    import tempfile

    from katib_tpu_torch.orchestrator import Orchestrator
    from katib_tpu_torch.utils.faults import FaultInjector

    injector = FaultInjector(
        seed=round_seed, rng=random.Random(round_seed), clock=clock
    )
    if rnd.arm is not None:
        rnd.arm(injector)
    spec = _make_spec(
        name=f"soak-{rnd.name}",
        seed=round_seed,
        trials=trials,
        parallel=parallel,
        **rnd.spec_kw,
    )
    if spec.speculative_redispatch:
        os.environ[_SLOW_ENV] = "1"
    try:
        with tempfile.TemporaryDirectory(prefix="katib-soak-") as workdir:
            orch = Orchestrator(
                workdir=workdir,
                fault_injector=injector,
                device="cpu",
                preflight=False,
            )
            exp = orch.run(spec)
            errs = _check_round(rnd, exp, orch, workdir, spec, injector)
    finally:
        os.environ.pop(_SLOW_ENV, None)
    return exp, orch, errs, len(injector.log)


def run_soak(
    seconds: float,
    seed: int = 0,
    trials: int = 10,
    parallel: int = 4,
    verbose: bool = True,
) -> int:
    """Run the seeded soak for ~``seconds``; returns a process exit code
    (0 = every round's invariants held)."""
    # the shared determinism seam: fault schedule and durations flow
    # through the ambient clock (real for a wall soak; a VirtualClock when
    # driven from the simulator) and an explicit seeded rng — the same
    # (clock, rng) injection the sim's ModeledExecutor uses
    clock = get_clock()
    rng = random.Random(seed)
    start = clock.monotonic()
    deadline = start + float(seconds)
    failures: list[str] = []
    occupancy: dict[str, float] = {}
    core = _core_rounds(rng)

    def run_one(rnd, round_seed):
        t0 = clock.monotonic()
        exp, orch, errs, n_faults = _run_round(
            rnd, round_seed, trials, parallel, clock
        )
        dt = clock.monotonic() - t0
        st = orch.async_stats or {}
        occupancy[rnd.name] = float(st.get("sustained_occupancy") or 0.0)
        if verbose:
            restarts = {
                k: v for k, v in (st.get("loop_restarts") or {}).items() if v
            }
            print(
                f"  {rnd.name:<16} {exp.condition.value:<10} {dt:5.1f}s  "
                f"occ={occupancy[rnd.name]:.2f}  restarts={restarts or '-'}  "
                f"spec={st.get('speculative_dispatches', 0)}/"
                f"{st.get('speculative_wins', 0)}  "
                f"faults={n_faults}"
                + (f"  FAIL: {'; '.join(errs)}" if errs else "")
            )
        failures.extend(errs)

    if verbose:
        print(f"soak: seed={seed} budget={seconds:.0f}s trials={trials}/round")

    # core rounds always run (the post-fault baseline is pulled off the
    # tail so it is genuinely last); extra seeded mixed rounds fill the
    # remaining budget
    post = core.pop()
    for i, rnd in enumerate(core):
        run_one(rnd, seed * 1000 + i)
    i = len(core)
    while clock.monotonic() < deadline - 10.0 and i < 50:
        run_one(_mixed_round(i, rng, trials), seed * 1000 + i)
        i += 1
    run_one(post, seed * 1000 + i)

    base, after = occupancy.get("baseline", 0.0), occupancy.get("post-fault", 0.0)
    if base > 0 and after < OCCUPANCY_RECOVERY * base:
        # best of two: single short rounds on a loaded box make the
        # time-weighted occupancy noisy; a genuine regression fails both
        run_one(_Round("post-fault"), seed * 1000 + i + 1)
        after = max(after, occupancy.get("post-fault", 0.0))
    if base > 0 and after < OCCUPANCY_RECOVERY * base:
        failures.append(
            f"post-fault occupancy did not recover: {after:.2f} < "
            f"{OCCUPANCY_RECOVERY} x baseline {base:.2f}"
        )
    # lock-order witness (KATIB_LOCK_WITNESS=1): every engine lock acquired
    # across every round fed the process-wide acquisition graph; an observed
    # inversion of the documented order (state > queue > futures, plus the
    # registry/metrics/watchdog locks) fails the soak even if no round
    # actually deadlocked — the witness sees the near-miss
    from katib_tpu_torch.analysis import witness_enabled
    from katib_tpu_torch.analysis.witness import format_summary, witness_cycles

    if witness_enabled():
        cycles = witness_cycles()
        if verbose or cycles:
            print(format_summary())
        if cycles:
            failures.append(
                f"lock-order witness observed {len(cycles)} inversion(s) "
                "of the documented acquire order: "
                + "; ".join(" -> ".join(c) for c in cycles[:3])
            )
    elapsed = clock.monotonic() - start
    if failures:
        print(
            f"SOAK FAIL ({elapsed:.0f}s, {i + 2} rounds): "
            + "; ".join(failures[:10])
        )
        return 1
    print(
        f"SOAK PASS: {i + 2} rounds in {elapsed:.0f}s, zero lost or "
        f"duplicated settlements, occupancy {base:.2f} -> {after:.2f}"
    )
    return 0
