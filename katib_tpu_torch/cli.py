"""``katib-tpu-torch`` command-line interface (``python -m katib_tpu_torch``).

Port of ``katib_tpu/cli.py``.  The verbs the port has:

- ``run <experiment.yaml>``   create + run an experiment to completion (--resume);
                              ``--device`` names where trials run (``cuda``
                              unless it says ``cpu``); a run on the async
                              engine ends with an ``async engine: {...}``
                              line on stderr (``Orchestrator.async_stats``)
- ``list``                    experiments in the workdir with live counts
- ``describe <experiment>``   trials, assignments, observations, optimal, curve
- ``metrics <trial>``         raw metric log for one trial (the config's store)
- ``logs <trial>``            captured black-box stdout
- ``export <experiment>``     trials as CSV/JSONL for analysis
- ``trace export|summary``    an experiment's span journal as Chrome-trace
                              JSON, or its per-span latency distribution
- ``conformance``             packaged e2e invariants check (conformance/run.sh parity)
- ``chaos``                   deterministic fault-injection run (fault-tolerance
                              invariants); ``--crash-at``/``--kill-at`` hard-kill
                              a child at a registered persistence site and
                              assert crash recovery; ``--soak SECONDS`` is the
                              seeded chaos soak of the async engine
                              (``orchestrator/soak.py``).  ``--wedge-device``
                              and ``--soak`` with a single-run flag raise
                              ``NotImplementedError``
- ``fsck <workdir>/<exp>``    validate + repair an experiment dir (torn journal tail,
                              snapshot checksums, suggester fence), or an
                              artifact dir (envelope checksums and addresses)
- ``prewarm <experiment.yaml>`` run each width's prewarm twin on ``--device``
                              and print its capture seconds; record the
                              signatures; ``--publish`` / ``--fetch-only``
                              act on the kernel libraries in the artifact
                              tiers (a capture warms only its own process)
- ``cache [dir]``             inventory of an artifact tier (the port's kernel
                              libraries; loadable on this host?) and, for a
                              compile-cache dir, its registry's history
- ``cost <dir|experiment.yaml>`` roofline table of the registry's counted step
                              costs against ``--device``'s peaks (``h100`` or
                              ``cpu``; default: this host's device); a YAML
                              with nothing costed runs its prewarm twins
                              first, on the card unless ``--device cpu``
- ``profile <experiment.yaml>`` run the experiment's prewarm twin under
                              ``torch.profiler`` (on the card unless
                              ``--device cpu``) into a Chrome trace;
                              ``--list`` inventories past captures
                              (``enable_profiler`` trials, ``profile.capture``
                              spans)
- ``ui``                      the REST API + dashboard over a workdir, on
                              loopback unless ``--host``; ``--token`` or
                              ``KATIB_UI_TOKEN`` guard the writes,
                              ``--cert-dir`` serves TLS; experiments it
                              creates run on ``--device``
- ``doctor``                  bounded device preflight + environment report
- ``suggest-server``          suggestion-as-a-service daemon (``--token`` or
                              ``KATIB_SUGGEST_TOKEN``, ``--cert-dir`` for TLS);
                              ``--device`` names where its suggesters compute
- ``db-manager``              native observation-log daemon (``--db`` = durable
                              journal); raises if the C++ runtime cannot build

``conformance``, ``chaos``, ``suggest-server``, ``profile`` and ``ui``
take ``--device`` as ``run`` does.  The JAX CLI's other verbs are listed in
:data:`UNPORTED_VERBS`; each raises ``NotImplementedError`` naming it.
This module imports no JAX, and no verb does: the crash scenario's child
interpreter blocks the JAX modules.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from katib_tpu_torch.core.config import KatibConfig

#: the JAX CLI's verbs the port does not have yet (ROADMAP Queue 1 item 11)
UNPORTED_VERBS = ("sim", "lint")


def _fmt_age(start: float, end: float) -> str:
    if not start:
        return "-"
    secs = int((end or time.time()) - start)
    if secs < 60:
        return f"{secs}s"
    if secs < 3600:
        return f"{secs // 60}m{secs % 60:02d}s"
    return f"{secs // 3600}h{(secs % 3600) // 60:02d}m"


def _table(rows: list[list[str]], header: list[str]) -> str:
    widths = [
        max(len(str(r[i])) for r in [header] + rows) for i in range(len(header))
    ]
    lines = ["  ".join(str(h).ljust(w) for h, w in zip(header, widths))]
    for r in rows:
        lines.append("  ".join(str(c).ljust(w) for c, w in zip(r, widths)))
    return "\n".join(lines)


def _install_drain_handlers(orch) -> None:
    """SIGTERM/SIGINT → graceful drain; a second signal escalates to a hard
    stop (running trials are killed at the next boundary instead of being
    given the drain grace window).  Mirrors kubelet pod termination: TERM
    first, impatience escalates."""
    import signal

    seen = {"count": 0}

    def _on_signal(signum, frame):  # noqa: ARG001 - signal handler shape
        seen["count"] += 1
        if seen["count"] == 1:
            print(
                f"received {signal.Signals(signum).name}: draining "
                "(checkpoint running trials, flush journal; signal again to "
                "stop immediately)",
                file=sys.stderr,
            )
            orch.drain()
        else:
            print(
                f"received {signal.Signals(signum).name} again: stopping now",
                file=sys.stderr,
            )
            orch.stop()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _on_signal)
        except (ValueError, OSError):
            # not the main thread (embedded use) — drain stays API-only
            return


def cmd_run(args: argparse.Namespace) -> int:
    from katib_tpu_torch.sdk.yaml_spec import load_experiment_yaml

    cfg = KatibConfig.load(args.config)
    if args.workdir:
        cfg.init.workdir = args.workdir
    spec = load_experiment_yaml(args.experiment)
    if spec.command is None and spec.train_fn is None:
        print(
            "error: experiment file defines no trial command "
            "(spec.command or spec.trialTemplate.command)",
            file=sys.stderr,
        )
        return 2
    orch = cfg.make_orchestrator(device=args.device)
    # CLI runs own the process, so a drain that leaves wedged trial threads
    # behind may hard-exit with the resumable code after journaling
    # (library callers keep the default cooperative wind-down instead)
    orch.drain_hard_exit = True
    # device preflight gate: on by default for CLI runs — a wedged card
    # fails fast with a per-device health report instead of hanging in the
    # first trial.  `--no-preflight` skips the probe.
    orch.preflight = not args.no_preflight
    if args.drain_grace_seconds is not None:
        spec.drain_grace_seconds = args.drain_grace_seconds
    _install_drain_handlers(orch)
    if args.resume:
        existing = orch.load_experiment(spec)
        if existing is None:
            print(
                f"note: no journal for {spec.name!r} under {orch.workdir}; "
                "starting fresh",
                file=sys.stderr,
            )
        try:
            exp = orch.run(spec, experiment=existing)
        except RuntimeError as e:
            # e.g. terminal experiment with resumePolicy: Never
            print(f"error: {e}", file=sys.stderr)
            return 2
    else:
        exp = orch.run(spec)
    if orch.prewarm_stats is not None:
        # the background prewarmer's counters; the artifact tiers carry
        # kernel libraries only, published by the build and the worker
        print(f"prewarm worker: {json.dumps(orch.prewarm_stats)}", file=sys.stderr)
        _note_empty_publish(spec, orch.prewarm_stats)
    if orch.async_stats is not None:
        # the engine's summary: its occupancy, rate, lookahead, and what the
        # loop supervisor did (restarts per loop, a fallback to the sync loop)
        print(f"async engine: {json.dumps(orch.async_stats, default=str)}", file=sys.stderr)
    if orch.drained:
        # resumable preemption exit: SIGTERM arrived, running trials were
        # checkpointed (or journaled Drained), the journal + suggester state
        # were flushed — rerun with --resume to continue where this left off
        print(
            f"experiment {exp.name}: drained ({exp.message}); "
            f"rerun with --resume to continue",
            file=sys.stderr,
        )
        from katib_tpu_torch.orchestrator.orchestrator import DRAIN_EXIT_CODE

        return DRAIN_EXIT_CODE
    status = "ok" if exp.condition.value != "Failed" else "FAILED"
    print(f"experiment {exp.name}: {exp.condition.value} ({exp.message}) [{status}]")
    if exp.optimal is not None:
        print(
            f"optimal trial {exp.optimal.trial_name}: "
            f"{exp.spec.objective.objective_metric_name}={exp.optimal.objective_value}"
        )
        for name, value in sorted(
            {a.name: a.value for a in exp.optimal.assignments}.items()
        ):
            print(f"  {name} = {value}")
    return 0 if exp.condition.value != "Failed" else 1


def cmd_list(args: argparse.Namespace) -> int:
    from katib_tpu_torch.orchestrator.status import list_statuses

    statuses = list_statuses(args.workdir)
    if not statuses:
        print(f"no experiments under {args.workdir}")
        return 0
    rows = []
    for s in statuses:
        counts = s.get("counts", {})
        optimal = s.get("optimal") or {}
        rows.append(
            [
                s.get("name", "?"),
                s.get("condition", "?"),
                s.get("algorithm", "?"),
                f"{counts.get('succeeded', 0)}/{counts.get('trials', 0)}",
                counts.get("failed", 0),
                optimal.get("objective_value", "-"),
                _fmt_age(s.get("start_time") or 0, s.get("completion_time") or 0),
            ]
        )
    print(_table(rows, ["NAME", "STATUS", "ALGORITHM", "SUCCEEDED", "FAILED", "BEST", "AGE"]))
    return 0


def cmd_describe(args: argparse.Namespace) -> int:
    from katib_tpu_torch.orchestrator.status import read_status

    s = read_status(args.workdir, args.experiment)
    if s is None:
        print(f"experiment {args.experiment!r} not found under {args.workdir}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(s, indent=2))
        return 0
    print(f"Name:       {s['name']}")
    print(f"Status:     {s['condition']}  {s.get('message', '')}".rstrip())
    print(f"Algorithm:  {s['algorithm']}")
    goal = f" (goal {s['goal']})" if s.get("goal") is not None else ""
    print(f"Objective:  {s['objective_type']} {s['objective_metric']}{goal}")
    optimal = s.get("optimal")
    if optimal:
        print(
            f"Optimal:    {optimal['trial_name']} -> {optimal['objective_value']}  "
            + " ".join(f"{k}={v}" for k, v in sorted(optimal["assignments"].items()))
        )
    curve = s.get("optimal_history") or []
    if curve:
        # best-objective@wallclock, most recent improvements last
        shown = curve[-5:]
        prefix = "…, " if len(curve) > 5 else ""
        print(
            "Converge:   "
            + prefix
            + ", ".join(
                f"{r['objective_value']:.5g}@{r['elapsed_s']:.0f}s" for r in shown
            )
        )
    rows = []
    for t in s.get("trials", {}).values():
        obs = t.get("observation") or []
        objective = next(
            (m["value"] for m in obs if m["name"] == s["objective_metric"]), "-"
        )
        rows.append(
            [
                t["name"],
                t["condition"],
                objective,
                " ".join(f"{k}={v}" for k, v in sorted(t["assignments"].items())),
            ]
        )
    if rows:
        print()
        print(_table(rows, ["TRIAL", "STATUS", "OBJECTIVE", "ASSIGNMENTS"]))
    return 0


def cmd_metrics(args: argparse.Namespace) -> int:
    """A trial's raw metric log from the config's store (``--config``:
    sqlite, remote, mysql or postgres; the default memory store, and the
    in-process native one, hold nothing across processes)."""
    cfg = KatibConfig.load(args.config)
    store = cfg.store.make_store()
    logs = store.get(args.trial)
    if not logs:
        print(
            f"no metrics for trial {args.trial!r} in store backend "
            f"{cfg.store.backend!r} (persisted stores only: sqlite/remote)",
            file=sys.stderr,
        )
        return 1
    for l in logs:
        print(f"{l.timestamp:.3f}\t{l.step}\t{l.metric_name}\t{l.value}")
    return 0


def cmd_export(args: argparse.Namespace) -> int:
    """Dump an experiment's trials as CSV or JSONL for analysis — flat
    columns: trial, condition, one column per assignment, one per observed
    metric (the strategy-reduced value the journal records)."""
    from katib_tpu_torch.orchestrator.status import read_status

    s = read_status(args.workdir, args.experiment)
    if s is None:
        print(f"experiment {args.experiment!r} not found", file=sys.stderr)
        return 1
    trials = list((s.get("trials") or {}).values())
    # pass 1: the full parameter-column set, so metric renaming can't depend
    # on trial order (a metric sharing a name with a parameter that only a
    # LATER trial introduces must still land in the metric: namespace)
    param_cols: list[str] = []
    for t in trials:
        for k in t.get("assignments") or {}:
            col = f"param:{k}" if k in ("trial", "condition") else k
            if col not in param_cols:
                param_cols.append(col)
    rows = []
    metric_cols: list[str] = []
    for t in trials:
        row: dict = {"trial": t["name"], "condition": t["condition"]}
        for k, v in (t.get("assignments") or {}).items():
            row[f"param:{k}" if k in ("trial", "condition") else k] = v
        for m in t.get("observation") or ():
            # metrics get their own namespace when they'd shadow a reserved
            # or parameter column (a metric literally named like a parameter
            # would otherwise silently overwrite the assignment)
            col = m["name"]
            if col in ("trial", "condition") or col in param_cols:
                col = f"metric:{col}"
            row[col] = m["value"]
            if col not in metric_cols:
                metric_cols.append(col)
        rows.append(row)
    if args.format == "jsonl":
        for row in rows:
            print(json.dumps(row))
        return 0
    import csv

    writer = csv.DictWriter(
        sys.stdout,
        fieldnames=["trial", "condition", *param_cols, *metric_cols],
        extrasaction="ignore",
    )
    writer.writeheader()
    writer.writerows(rows)
    return 0


def cmd_logs(args: argparse.Namespace) -> int:
    """Print a black-box trial's captured stdout (reference: UI pod-log
    fetch, ``backend.go:463``); lookup in ``status.read_trial_log``."""
    from katib_tpu_torch.orchestrator.status import read_trial_log

    log = read_trial_log(args.workdir, args.trial)
    if log is None:
        print(
            f"no captured log for trial {args.trial!r} under {args.workdir} "
            "(white-box trials have no stdout log)",
            file=sys.stderr,
        )
        return 1
    sys.stdout.write(log)
    return 0


def cmd_trace_export(args: argparse.Namespace) -> int:
    from katib_tpu_torch.utils import tracing

    journal = tracing.trace_path(args.workdir, args.experiment)
    if not os.path.exists(journal):
        print(f"no trace journal at {journal}", file=sys.stderr)
        return 1
    if args.out == "-":
        records = tracing.read_journal(journal)
        if not records:
            print(f"trace journal {journal} holds no valid spans", file=sys.stderr)
            return 1
        json.dump(tracing.to_chrome_trace(records), sys.stdout)
        print()
        return 0
    out = args.out or os.path.join(args.workdir, args.experiment, "trace.json")
    n = tracing.export_chrome_trace(journal, out)
    if n == 0:
        print(f"trace journal {journal} holds no valid spans", file=sys.stderr)
        return 1
    print(f"wrote {n} spans to {out} (open in Perfetto / chrome://tracing)")
    return 0


def cmd_trace_summary(args: argparse.Namespace) -> int:
    from katib_tpu_torch.utils import tracing

    journal = tracing.trace_path(args.workdir, args.experiment)
    records = tracing.read_journal(journal)
    if not records:
        print(f"no spans found at {journal}", file=sys.stderr)
        return 1
    summary = tracing.summarize(records)
    slowest = _slowest_spans(records, args.top) if args.top else []
    if args.json:
        doc = {"summary": summary, "slowest": slowest} if args.top else summary
        json.dump(doc, sys.stdout, indent=2)
        print()
        return 0
    rows = [
        [
            s["name"],
            s["count"],
            f"{s['total_s']:.3f}",
            f"{s['mean_s']:.4f}",
            f"{s['p50_s']:.4f}",
            f"{s['p95_s']:.4f}",
            f"{s['max_s']:.4f}",
        ]
        for s in summary
    ]
    print(_table(rows, ["SPAN", "COUNT", "TOTAL_S", "MEAN_S", "P50_S", "P95_S", "MAX_S"]))
    if slowest:
        rows = [
            [
                s["name"],
                f"{s['dur_s']:.3f}",
                s["who"],
                s["mfu"],
                s["roofline"],
                s["headroom"],
            ]
            for s in slowest
        ]
        print(f"\nslowest {len(rows)} spans (roofline attrs where costed):")
        print(_table(rows, ["SPAN", "DUR_S", "WHO", "MFU", "ROOFLINE", "HEADROOM"]))
    return 0


def _slowest_spans(records: list[dict], top: int) -> list[dict]:
    """The ``--top N`` view: individual spans by duration, with the
    roofline attrs (``mfu``, ``roofline``, ``roofline_headroom``) where a
    span carries them."""

    def _dur(rec: dict) -> float:
        try:
            return float(rec.get("dur", 0.0))
        except (TypeError, ValueError):
            return 0.0

    out = []
    for rec in sorted(records, key=_dur, reverse=True)[: max(0, top)]:
        args = rec.get("args", {}) or {}
        mfu = args.get("mfu")
        who = args.get("trial") or args.get("cohort") or args.get("epoch")
        out.append(
            {
                "name": str(rec.get("name", "?")),
                "dur_s": round(_dur(rec), 6),
                "who": str(who) if who is not None else "-",
                "mfu": f"{mfu:.4f}" if isinstance(mfu, (int, float)) else "-",
                "roofline": str(args.get("roofline", "-")),
                "headroom": str(args.get("roofline_headroom", "-")),
            }
        )
    return out


def cmd_conformance(args: argparse.Namespace) -> int:
    """Packaged conformance run (parity with the reference's
    ``conformance/run.sh``: deploy, run random-search e2e, assert the
    invariants from ``run-e2e-experiment.py:52-60``) on ``--device``."""
    import tempfile

    from katib_tpu_torch.core.types import (
        AlgorithmSpec,
        ExperimentCondition,
        ExperimentSpec,
        FeasibleSpace,
        ObjectiveSpec,
        ObjectiveType,
        ParameterSpec,
        ParameterType,
    )
    from katib_tpu_torch.orchestrator import Orchestrator

    def trainer(ctx):
        x = float(ctx.params["lr"])
        n = int(ctx.params["num_layers"])
        acc = 1.0 - 0.2 * (x - 0.05) ** 2 - 0.01 * abs(n - 3)
        for step in range(3):
            if not ctx.report(step=step, accuracy=acc * (step + 1) / 3):
                return

    spec = ExperimentSpec(
        name="conformance-random",
        algorithm=AlgorithmSpec(name="random"),
        objective=ObjectiveSpec(
            type=ObjectiveType.MAXIMIZE, objective_metric_name="accuracy"
        ),
        parameters=[
            ParameterSpec(
                "lr", ParameterType.DOUBLE, FeasibleSpace(min=0.01, max=0.2)
            ),
            ParameterSpec(
                "num_layers", ParameterType.INT, FeasibleSpace(min=1, max=5)
            ),
        ],
        max_trial_count=args.max_trials,
        parallel_trial_count=2,
        train_fn=trainer,
    )
    with tempfile.TemporaryDirectory(prefix="katib-conformance-") as workdir:
        exp = Orchestrator(workdir=workdir, device=args.device).run(spec)

    failures = []
    if exp.optimal is None:
        failures.append("best objective missing")
    if (
        exp.condition is ExperimentCondition.MAX_TRIALS_REACHED
        and exp.completed_count != spec.max_trial_count
    ):
        failures.append(
            f"MaxTrialsReached but completed {exp.completed_count} != {spec.max_trial_count}"
        )
    if exp.condition not in (
        ExperimentCondition.MAX_TRIALS_REACHED,
        ExperimentCondition.GOAL_REACHED,
        ExperimentCondition.SUCCEEDED,
    ):
        failures.append(f"experiment ended {exp.condition.value}: {exp.message}")
    if failures:
        print("CONFORMANCE FAIL: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(
        f"CONFORMANCE PASS: {exp.condition.value}, "
        f"{exp.completed_count} trials, best={exp.optimal.objective_value:.4f}"
    )
    return 0


def cmd_fsck(args: argparse.Namespace) -> int:
    """Validate and repair an experiment directory (journal checksums,
    torn tails, snapshot integrity, suggester fence) — see
    ``orchestrator/fsck.py`` — or an artifact directory (the port's
    envelopes: checksums and content addresses, corrupt or misaddressed
    files quarantined) — see ``compile/artifacts.py``; the JAX package's
    envelopes there are left alone.  Exit 0 when consistent after repairs."""
    from katib_tpu_torch.compile.artifacts import fsck_artifacts, is_artifact_dir

    if is_artifact_dir(args.path):
        report = fsck_artifacts(args.path, repair=not args.dry_run)
        print(f"artifact dir {report.root}")
        print(report.summary())
        for name in report.corrupt:
            print(f"  corrupt: {name}")
        for name in report.misaddressed:
            print(f"  misaddressed: {name}")
        for name in report.stale:
            print(f"  stale(other-env): {name}")
        for name in report.quarantined:
            print(f"  quarantined -> {name}.quarantined (inspect or delete; never loaded)")
        return 0 if report.consistent else 1
    from katib_tpu_torch.orchestrator.fsck import fsck_experiment

    report = fsck_experiment(args.path, repair=not args.dry_run)
    for line in report.lines():
        print(line)
    return 0 if report.ok() else 1


def cmd_doctor(args: argparse.Namespace) -> int:
    """Bounded-time device preflight: probe every visible device of
    ``--device`` with a tiny kernel in a killable CHILD interpreter (a
    wedged driver can block the first CUDA call forever, and a diagnostic
    tool that hangs is worse than the condition it diagnoses).  Exit 0 only
    when every enumerated device ran the probe within the deadline."""
    from katib_tpu_torch.utils import meshhealth

    report = meshhealth.doctor_report(
        deadline=float(args.device_timeout),
        simulate_wedge=args.simulate_wedge or None,
        device_type=args.device,
    )
    if args.json:
        print(report.to_json())
        return 0 if report.ok() else 1

    print(report.summary())
    for d in sorted(report.devices, key=lambda d: d.device):
        line = f"  {d.device:<12} {d.status:<8} probe={d.probe_seconds:.2f}s"
        if d.error:
            line += f"  ({d.error})"
        print(line)
    if report.error:
        print(f"  error: {report.error}")

    import torch

    print(f"torch {torch.__version__} (cuda {torch.version.cuda})")
    from katib_tpu_torch.native.build import build_error, native_available
    from katib_tpu_torch.runner.metrics import text_parser

    if native_available():
        print("native runtime: built")
    else:
        why = (build_error() or "").strip().splitlines() or ["unknown error"]
        print(f"native runtime: unavailable ({why[0]})")
    print(f"text metrics parser: {text_parser()}")
    cfg = KatibConfig.load(args.config)
    print(f"workdir: {cfg.init.workdir}")
    print(f"store: {cfg.store.backend}")
    return 0 if report.ok() else 1


#: the flags of the ``chaos`` verb's single fault-injection run, with how
#: ``katib_tpu/cli.py`` parses each and its default there.  The parser
#: leaves them ``None`` so that ``--soak`` can tell a flag that was given
#: (the JAX soak ignores it; the port refuses it) from a default.
_SINGLE_RUN_ARGS = {
    "--max-retries": (dict(type=int, help="maxRetries of the chaos experiment (default 3)"), 3),
    "--suggester-max-errors": (
        dict(type=int, help="suggesterMaxErrors of the chaos experiment (default 3)"), 3),
    "--fail-trial": (dict(
        action="append", metavar="K:J[:kind]",
        help="fail trial K's attempt J (0-based trial index, 1-based attempt; kind "
        "transient|permanent, default transient); repeatable"), None),
    "--fail-suggester": (dict(
        action="append", metavar="N",
        help="raise inside the N-th (1-based) get_suggestions call; repeatable"), None),
    "--flake-rate": (dict(
        type=float, help="seeded random per-attempt transient failure probability"), 0.0),
    "--hang-trial": (dict(
        action="append", metavar="K[:J]",
        help="wedge trial K's attempt J (default 1) until the hang watchdog interrupts "
        "it; repeatable"), None),
    "--preempt-at": (dict(
        type=int, metavar="N",
        help="deliver a real SIGTERM to this process when trial N starts (drain -> "
        "journal -> in-process resume, asserting zero lost trials)"), None),
    "--compile-hang": (dict(
        action="append", metavar="K[:J]",
        help="wedge trial K's attempt J (default 1) before its first report, inside the "
        "compile budget, until the compile watchdog interrupts it; repeatable"), None),
    "--progress-deadline": (dict(
        type=float, help="progressDeadlineSeconds used when --hang-trial is given "
        "(default 0.75)"), 0.75),
    "--compile-deadline": (dict(
        type=float, help="compileDeadlineSeconds used when --compile-hang is given "
        "(default 0.5)"), 0.5),
    "--drain-grace": (dict(
        type=float, help="drainGraceSeconds for the chaos experiment (default 5)"), 5.0),
    "--kill-loop": (dict(
        action="append", metavar="LOOP[:N]",
        help="kill the named async engine loop (suggest|schedule|harvest) at its N-th "
        "(default 1st) iteration; the supervisor must restart it; repeatable"), None),
    "--stall-suggester": (dict(
        action="append", metavar="SECONDS[:CALL]",
        help="wedge the CALL-th (default 1st) get_suggestions call for SECONDS; past "
        "--loop-stall-deadline the call is abandoned; repeatable"), None),
    "--loop-stall-deadline": (dict(
        type=float, metavar="SECONDS",
        help="loopStallDeadlineSeconds used when --kill-loop or --stall-suggester is "
        "given (default 1)"), 1.0),
}
SINGLE_RUN_FLAGS = tuple(_SINGLE_RUN_ARGS)


def _dest(flag: str) -> str:
    return flag[2:].replace("-", "_")


def _crash_trainer(ctx):
    """The crash scenario's resumable toy trainer, run by the child and by
    the parent's in-process resume: every step checkpoints a 0-d tensor on
    the trial's device through ``TrialCheckpointer`` (the
    ``checkpoint.manifest`` site) and reports (``store.report``)."""
    import torch

    from katib_tpu_torch.utils.checkpoint import TrialCheckpointer

    os.makedirs(ctx.checkpoint_dir, exist_ok=True)
    ck = TrialCheckpointer(ctx.checkpoint_dir, max_to_keep=1)
    start = (ck.latest_step() or -1) + 1
    x = float(ctx.params["lr"])
    for step in range(start, 3):
        ck.save({"step": torch.tensor(step, device=ctx.device)}, step)
        if not ctx.report(step=step, accuracy=(1.0 - (x - 0.05) ** 2) * (step + 1) / 3):
            return


#: the child script for the crashpoint scenarios: a tiny resumable sweep
#: whose trainer exercises every registered persistence site (journal,
#: status, suggester pickle, checkpoint manifest, store report, retry
#: budget via one injected transient failure).  Run in a SUBPROCESS so the
#: armed crash point can genuinely kill it; the parent resumes and asserts.
#: The JAX modules are blocked there: the port's path must not need them.
_CRASH_CHILD_SCRIPT = """
import os, sys
for _name in ("jax", "jaxlib", "flax", "optax", "orbax", "katib_tpu"):
    sys.modules[_name] = None
sys.path[:0] = {syspath!r}
from katib_tpu_torch.orchestrator import Orchestrator
from katib_tpu_torch.utils.faults import FaultInjector
from katib_tpu_torch.cli import _crash_spec, _crash_trainer
injector = FaultInjector(seed=0)
injector.fail_trial(0, 1)  # guarantees the retry.budget site is reached
orch = Orchestrator(workdir={workdir!r}, fault_injector=injector, device={device!r})
exp = orch.run(_crash_spec({trials}, _crash_trainer), resume=True)
print("child finished:", exp.condition.value)
"""


def _crash_spec(trials: int, trainer):
    """The crash scenario's experiment: ``chaos-random`` (random search
    with the resume hooks, so the suggester pickle is written), one trial
    at a time, two retries, a resumable policy (the durable sqlite store)."""
    from katib_tpu_torch.core.types import (
        AlgorithmSpec,
        ExperimentSpec,
        FeasibleSpace,
        ObjectiveSpec,
        ObjectiveType,
        ParameterSpec,
        ParameterType,
        ResumePolicy,
    )
    from katib_tpu_torch.suggest.base import register
    from katib_tpu_torch.suggest.random_search import RandomSuggester

    # random search carries no state; this wrapper adds the resume hooks so
    # the suggester.pickle persistence site is actually exercised
    @register("chaos-random")
    class ChaosRandom(RandomSuggester):
        def state_dict(self):
            return {"chaos": 1}

        def load_state_dict(self, data):
            pass

    return ExperimentSpec(
        name="chaos-crash",
        algorithm=AlgorithmSpec(name="chaos-random", settings={"seed": "0"}),
        objective=ObjectiveSpec(
            type=ObjectiveType.MAXIMIZE, objective_metric_name="accuracy"
        ),
        parameters=[
            ParameterSpec("lr", ParameterType.DOUBLE, FeasibleSpace(min=0.01, max=0.2))
        ],
        max_trial_count=trials,
        parallel_trial_count=1,
        max_retries=2,
        retry_backoff_seconds=0.01,
        resume_policy=ResumePolicy.LONG_RUNNING,
        train_fn=trainer,
    )


def _chaos_crash(args: argparse.Namespace) -> int:
    """The ``--crash-at`` / ``--kill-at`` scenario: arm one registered
    CrashPoint in a child process (via ``KATIB_CRASH_AT``), let it die
    mid-persistence, then resume IN-PROCESS from the journal and assert the
    crash-consistency invariants — no settled trial lost, no duplicate
    observation, retry budget monotone, optimal consistent.  Both run their
    trials on ``args.device``."""
    import sqlite3
    import subprocess
    import tempfile

    from katib_tpu_torch.core.types import TrialCondition
    from katib_tpu_torch.orchestrator import Orchestrator, journal as jr
    from katib_tpu_torch.utils import faults

    site_spec = args.crash_at or args.kill_at
    site = site_spec.split(":", 1)[0]
    if site not in faults.registered_crash_points():
        print(
            f"unknown crash point {site!r}; registered: "
            f"{', '.join(faults.registered_crash_points())}",
            file=sys.stderr,
        )
        return 2
    device = args.device
    mode = "kill" if args.kill_at else "exit"
    failures: list[str] = []
    with tempfile.TemporaryDirectory(prefix="katib-chaos-crash-") as workdir:
        env = dict(os.environ)
        env[faults.CRASH_AT_ENV] = site_spec
        env[faults.CRASH_MODE_ENV] = mode
        script = _CRASH_CHILD_SCRIPT.format(
            syspath=[p for p in sys.path if p],
            workdir=workdir,
            trials=args.trials,
            device=device,
        )
        proc = subprocess.run(
            [sys.executable, "-c", script],
            env=env,
            capture_output=True,
            text=True,
            timeout=300,
        )
        died = proc.returncode not in (0,)
        print(
            f"chaos crash-at={site_spec} mode={mode}: child exited "
            f"{proc.returncode}"
        )
        if not died:
            failures.append(
                f"crash point {site_spec!r} was never reached (child ran to "
                "completion); scenario proves nothing"
            )
        elif proc.returncode not in (137, -9):
            # a crash point exits 137 or dies by SIGKILL; anything else is
            # the child failing on its own, which proves nothing either
            failures.append(
                f"child failed before the crash point (exit {proc.returncode}): "
                f"{proc.stderr.strip()[-2000:]}"
            )
        else:
            # what the journal PROVES happened before the kill
            pre_state, pre_stats = jr.replay_journal(workdir, "chaos-crash")
            pre_trials = (pre_state or {}).get("trials") or {}
            settled_before = {
                n: t
                for n, t in pre_trials.items()
                if TrialCondition(t.get("condition", "Created")).is_terminal()
            }
            # resume in this process — everything it knows comes from disk
            orch = Orchestrator(workdir=workdir, device=device)
            exp = orch.run(_crash_spec(args.trials, _crash_trainer), resume=True)
            print(
                f"resumed: {exp.condition.value}, {len(exp.trials)} trial(s), "
                f"{pre_stats.applied} journal record(s) replayed"
            )
            if not exp.condition.is_terminal():
                failures.append(f"resumed experiment not terminal: {exp.condition.value}")
            # invariant 1: no settled trial lost or demoted
            for name, tdata in settled_before.items():
                t = exp.trials.get(name)
                if t is None:
                    failures.append(f"settled trial lost across the crash: {name}")
                elif t.condition.value != tdata["condition"]:
                    failures.append(
                        f"settled trial {name} changed condition across the "
                        f"crash: {tdata['condition']} -> {t.condition.value}"
                    )
            # invariant 2: no duplicate observations in the durable store
            db = os.path.join(workdir, "observations.sqlite")
            if os.path.exists(db):
                conn = sqlite3.connect(db)
                dups = conn.execute(
                    "SELECT trial_name, metric_name, step, COUNT(*) c FROM"
                    " observation_logs WHERE step >= 0 GROUP BY trial_name,"
                    " metric_name, step HAVING c > 1"
                ).fetchall()
                conn.close()
                if dups:
                    failures.append(f"duplicate observations in store: {dups[:5]}")
            # invariant 3: retry budget monotone across the crash
            for name, tdata in pre_trials.items():
                t = exp.trials.get(name)
                if t is not None and t.retry_count < int(tdata.get("retry_count") or 0):
                    failures.append(
                        f"retry budget reset across the crash for {name}: "
                        f"{tdata.get('retry_count')} -> {t.retry_count}"
                    )
            # invariant 4: the optimal trial is consistent with its own record
            if exp.optimal is not None:
                best = exp.trials.get(exp.optimal.trial_name)
                if best is None:
                    failures.append(
                        f"optimal trial {exp.optimal.trial_name} not in history"
                    )
                elif best.observation is None:
                    failures.append(
                        f"optimal trial {exp.optimal.trial_name} has no observation"
                    )
    if failures:
        print("CHAOS FAIL: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(f"CHAOS PASS: hard kill at {site_spec} recovered with invariants intact")
    return 0


def _chaos_trainer(ctx):
    """The single run's trainer.  Checkpoint-aware: progress survives
    transient retries because the re-run reuses the same checkpoint dir."""
    os.makedirs(ctx.checkpoint_dir, exist_ok=True)
    marker = os.path.join(ctx.checkpoint_dir, "progress.txt")
    start = 0
    if os.path.exists(marker):
        with open(marker) as f:
            start = int(f.read().strip() or 0)
    x = float(ctx.params["lr"])
    for step in range(start, 3):
        with open(marker, "w") as f:
            f.write(str(step + 1))
        if not ctx.report(step=step, accuracy=(1.0 - 0.2 * (x - 0.05) ** 2) * (step + 1) / 3):
            return


def cmd_chaos(args: argparse.Namespace) -> int:
    """Deterministic fault-injection run: a seeded ``FaultInjector`` plants
    transient trial failures and suggester exceptions in a small white-box
    experiment on ``--device``, then the exit status asserts the
    fault-tolerance invariants (transient retries recover with checkpoint
    resume, permanent failures don't retry, the suggester circuit breaker
    absorbs sub-threshold errors).  The chaos analog of ``conformance``:
    same experiment, hostile weather.  ``--crash-at``/``--kill-at`` run the
    crash-consistency scenario, ``--soak`` the seeded soak of the async
    engine.  Exit 0 when the invariants held, 1 when one failed, 2 for a
    malformed flag."""
    if args.crash_at or args.kill_at:
        if args.crash_at and args.kill_at:
            print("--crash-at and --kill-at are mutually exclusive", file=sys.stderr)
            return 2
        return _chaos_crash(args)
    if args.wedge_device:
        raise NotImplementedError(
            "chaos --wedge-device needs a trial-axis mesh over two or more "
            "devices and sharded cohorts with elastic degradation, not ported "
            "yet (ROADMAP item 9b)"
        )
    given = [f for f in SINGLE_RUN_FLAGS if getattr(args, _dest(f)) is not None]
    if args.soak is not None:
        if given:
            raise NotImplementedError(
                f"chaos --soak ignores the single fault-injection run's flags "
                f"({' '.join(given)}) in katib_tpu/cli.py; the port refuses a "
                "setting it would ignore: the soak takes --seed and --trials"
            )
        from katib_tpu_torch.orchestrator.soak import run_soak

        # soak rounds want enough trials per round for occupancy and
        # mid-run kills to mean something; --trials can only raise it
        return run_soak(seconds=args.soak, seed=args.seed, trials=max(args.trials, 10))
    for flag, (_, default) in _SINGLE_RUN_ARGS.items():
        if getattr(args, _dest(flag)) is None:
            setattr(args, _dest(flag), default)
    return _chaos_single_run(args)


def _chaos_single_run(args: argparse.Namespace) -> int:
    import tempfile

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
    from katib_tpu_torch.orchestrator import Orchestrator
    from katib_tpu_torch.utils import observability as obs
    from katib_tpu_torch.utils.faults import FailureKind, FaultInjector

    injector = FaultInjector(seed=args.seed)
    for spec_str in args.fail_trial or []:
        parts = spec_str.split(":")
        if len(parts) not in (2, 3):
            print(f"bad --fail-trial {spec_str!r} (want K:J[:kind])", file=sys.stderr)
            return 2
        kind = FailureKind(parts[2].capitalize()) if len(parts) == 3 else FailureKind.TRANSIENT
        injector.fail_trial(int(parts[0]), int(parts[1]), kind)
    for call in args.fail_suggester or []:
        injector.fail_suggester(int(call))
    for spec_str in args.hang_trial or []:
        parts = spec_str.split(":")
        if len(parts) not in (1, 2):
            print(f"bad --hang-trial {spec_str!r} (want K[:J])", file=sys.stderr)
            return 2
        injector.hang_trial(int(parts[0]), int(parts[1]) if len(parts) == 2 else 1)
    if args.preempt_at is not None:
        injector.preempt_at(args.preempt_at)
    if args.flake_rate:
        injector.flake(args.flake_rate)
    for spec_str in args.compile_hang or []:
        parts = spec_str.split(":")
        if len(parts) not in (1, 2):
            print(f"bad --compile-hang {spec_str!r} (want K[:J])", file=sys.stderr)
            return 2
        injector.compile_hang(int(parts[0]), int(parts[1]) if len(parts) == 2 else 1)
    killed_loops = []
    for spec_str in args.kill_loop or []:
        parts = spec_str.split(":")
        if parts[0] not in ("suggest", "schedule", "harvest") or len(parts) > 2:
            print(f"bad --kill-loop {spec_str!r} (want LOOP[:N])", file=sys.stderr)
            return 2
        injector.kill_loop(parts[0], int(parts[1]) if len(parts) == 2 else 1)
        killed_loops.append(parts[0])
    stall_calls = []
    for spec_str in args.stall_suggester or []:
        parts = spec_str.split(":")
        if len(parts) not in (1, 2):
            print(
                f"bad --stall-suggester {spec_str!r} (want SECONDS[:CALL])",
                file=sys.stderr,
            )
            return 2
        injector.stall_suggester(
            float(parts[0]), int(parts[1]) if len(parts) == 2 else 1
        )
        stall_calls.append(float(parts[0]))
    injected_any = (
        args.fail_trial
        or args.fail_suggester
        or args.flake_rate
        or args.hang_trial
        or args.compile_hang
        or killed_loops
        or stall_calls
        or args.preempt_at is not None
    )
    if not injector.log and not injected_any:
        # default scenario: first trial is preempted twice, one suggester
        # call blows up — the experiment must shrug all of it off
        injector.fail_trial(0, 1).fail_trial(0, 2).fail_suggester(2)

    spec = ExperimentSpec(
        name="chaos-random",
        algorithm=AlgorithmSpec(name="random", settings={"seed": str(args.seed)}),
        objective=ObjectiveSpec(
            type=ObjectiveType.MAXIMIZE, objective_metric_name="accuracy"
        ),
        parameters=[
            ParameterSpec("lr", ParameterType.DOUBLE, FeasibleSpace(min=0.01, max=0.2)),
        ],
        max_trial_count=args.trials,
        # one trial at a time keeps the injector's trial indices deterministic
        parallel_trial_count=1,
        max_retries=args.max_retries,
        retry_backoff_seconds=0.05,
        suggester_max_errors=args.suggester_max_errors,
        # hang watchdog only arms when a deadline is set; keep it off unless
        # the scenario injects hangs so the happy path stays unchanged
        progress_deadline_seconds=(
            args.progress_deadline if args.hang_trial else None
        ),
        # compile watchdog only arms for the --compile-hang scenario
        compile_deadline_seconds=(
            args.compile_deadline if args.compile_hang else None
        ),
        drain_grace_seconds=args.drain_grace,
        # loop-kill / suggester-stall scenarios exercise the async engine's
        # supervisor: force the async path on (env opt-out would silently
        # skip the seams) and tighten the stall deadline so a stalled
        # suggester call is abandoned within the run, not after 60s
        async_orch=(True if (killed_loops or stall_calls) else None),
        loop_stall_deadline_seconds=(
            args.loop_stall_deadline if (killed_loops or stall_calls) else 60.0
        ),
        # the preempt scenario spans two orchestrator lifetimes; a resumable
        # policy upgrades the store to the durable sqlite backend so metrics
        # reported before the SIGTERM survive into the resumed process
        resume_policy=(
            ResumePolicy.LONG_RUNNING
            if args.preempt_at is not None
            else ResumePolicy.NEVER
        ),
        train_fn=_chaos_trainer,
    )
    errors_before = obs.suggester_errors.get(algorithm="random")
    retried_before = obs.trials_retried.get(kind=FailureKind.TRANSIENT.value)
    hangs_before = obs.trial_hangs.get()
    compile_hangs_before = obs.compile_hangs.get()
    degraded_before = obs.mesh_degraded.get()
    preempted = False
    completed_at_drain: set[str] = set()
    with tempfile.TemporaryDirectory(prefix="katib-chaos-") as workdir:
        orch = Orchestrator(workdir=workdir, fault_injector=injector, device=args.device)
        if args.preempt_at is not None:
            # the injected preempt delivers a real SIGTERM to this process:
            # install the same drain handlers `run` uses so the orchestrator
            # checkpoints, journals, and returns resumable state
            _install_drain_handlers(orch)
        exp = orch.run(spec)
        if orch.drained:
            preempted = True
            completed_at_drain = {
                t.name
                for t in exp.trials.values()
                if t.condition is TrialCondition.SUCCEEDED
            }
            drained_names = [
                t.name
                for t in exp.trials.values()
                if t.condition is TrialCondition.DRAINED
            ]
            print(
                f"preempted mid-experiment: {len(completed_at_drain)} trial(s) "
                f"completed, {len(drained_names)} drained "
                f"({', '.join(drained_names) or 'none'}); resuming from journal"
            )
            # fresh orchestrator = new process semantics: everything it knows
            # must come from the journal + suggester pickle, not live memory
            orch = Orchestrator(workdir=workdir, fault_injector=injector, device=args.device)
            _install_drain_handlers(orch)
            exp = orch.run(spec, experiment=orch.load_experiment(spec))

    print(f"chaos seed={args.seed}  experiment={exp.condition.value}")
    for t in sorted(exp.trials.values(), key=lambda t: t.start_time):
        print(
            f"  {t.name}: {t.condition.value:<20} attempts={t.retry_count + 1} "
            f"kind={t.failure_kind or '-'}"
        )
    print(
        f"injected: {len(injector.log)} faults; "
        f"retries={obs.trials_retried.get(kind=FailureKind.TRANSIENT.value) - retried_before:g}; "
        f"suggester errors absorbed={obs.suggester_errors.get(algorithm='random') - errors_before:g}; "
        f"hangs caught={obs.trial_hangs.get() - hangs_before:g}; "
        f"compile hangs caught={obs.compile_hangs.get() - compile_hangs_before:g}; "
        f"mesh degradations={obs.mesh_degraded.get() - degraded_before:g}"
    )

    failures = []
    if args.hang_trial:
        hung = [
            t
            for t in exp.trials.values()
            if t.failure_kind == FailureKind.HANG.value and t.retry_count > 0
        ]
        if obs.trial_hangs.get() - hangs_before <= 0:
            failures.append("injected hang was never caught by the watchdog")
        elif not hung:
            failures.append(
                "no trial journaled failure_kind=Hang with a retry "
                "(watchdog fired but retry machinery did not reclassify)"
            )
        elif not all(t.condition is TrialCondition.SUCCEEDED for t in hung):
            failures.append(
                "hung trial did not recover on retry: "
                f"{[(t.name, t.condition.value) for t in hung]}"
            )
    if args.compile_hang:
        if obs.compile_hangs.get() - compile_hangs_before <= 0:
            failures.append(
                "injected compile hang was never caught by the compile watchdog"
            )
        else:
            compile_hung = [
                t
                for t in exp.trials.values()
                if t.failure_kind == FailureKind.COMPILE_HANG.value
                and t.retry_count > 0
            ]
            if not compile_hung:
                failures.append(
                    "no trial journaled failure_kind=CompileHang with a retry"
                )
            elif not all(
                t.condition is TrialCondition.SUCCEEDED for t in compile_hung
            ):
                failures.append(
                    "compile-hung trial did not recover on retry: "
                    f"{[(t.name, t.condition.value) for t in compile_hung]}"
                )
    if args.preempt_at is not None:
        if not preempted:
            failures.append(
                "injected preemption did not drain the orchestrator "
                "(SIGTERM handler or drain path broken)"
            )
        else:
            still_completed = {
                t.name
                for t in exp.trials.values()
                if t.condition is TrialCondition.SUCCEEDED
            }
            lost = completed_at_drain - still_completed
            if lost:
                failures.append(
                    f"completed trials lost across the drain/resume cycle: {sorted(lost)}"
                )
            leftover = [
                t.name
                for t in exp.trials.values()
                if t.condition is TrialCondition.DRAINED
            ]
            if leftover:
                failures.append(f"drained trials never resubmitted: {leftover}")
    if killed_loops:
        st = orch.async_stats or {}
        fired = {e.get("loop") for e in injector.log if e.get("seam") == "kill-loop"}
        for loop in killed_loops:
            if loop not in fired:
                failures.append(f"injected kill for the {loop!r} loop never fired")
            elif (st.get("loop_restarts") or {}).get(loop, 0) < 1:
                failures.append(
                    f"killed {loop!r} loop was never restarted by the supervisor"
                )
        if st.get("fallback"):
            failures.append(f"async engine fell back to sync: {st['fallback']}")
    if stall_calls:
        if not any(e.get("seam") == "suggester-stall" for e in injector.log):
            failures.append("injected suggester stall never fired")
        elif any(s > args.loop_stall_deadline for s in stall_calls) and (
            obs.suggester_errors.get(algorithm="random") - errors_before <= 0
        ):
            failures.append(
                "over-deadline suggester stall was not abandoned "
                "(deadline-bounded call should have tripped the breaker)"
            )
    if not exp.condition.is_terminal():
        failures.append(f"experiment not terminal: {exp.condition.value}")
    if exp.condition is ExperimentCondition.FAILED:
        failures.append(f"experiment failed: {exp.message.splitlines()[0] if exp.message else ''}")
    recovered = [
        t for t in exp.trials.values()
        if t.retry_count > 0 and t.condition is TrialCondition.SUCCEEDED
    ]
    injected_transient = [
        e
        for e in injector.log
        if e.get("seam") == "trial" and e.get("kind") == FailureKind.TRANSIENT.value
    ]
    if injected_transient and args.max_retries > 0 and not recovered:
        failures.append("no trial recovered from an injected transient fault")
    never_retried = [
        t.name
        for t in exp.trials.values()
        if t.failure_kind == FailureKind.PERMANENT.value and t.retry_count > 0
    ]
    if never_retried:
        failures.append(f"permanent failures were retried: {never_retried}")
    if failures:
        print("CHAOS FAIL: " + "; ".join(failures), file=sys.stderr)
        return 1
    print("CHAOS PASS: every injected fault was absorbed")
    return 0


def _note_empty_publish(spec, stats: dict) -> None:
    """Say why a run with artifact tiers published nothing of its own: the
    tiers carry kernel libraries, and the experiment's program declares
    none."""
    from katib_tpu_torch.compile.artifacts import ARTIFACTS
    from katib_tpu_torch.compile.prewarm import kernels_of

    if ARTIFACTS.enabled() and not stats.get("published") and not kernels_of(spec.train_fn):
        fn = getattr(spec.train_fn, "__qualname__", "the train_fn")
        print(f"artifact tiers: no kernel library published: {fn} launches no "
              "hand-written kernel (its steps are library calls), and a captured "
              "step program has no serialized form", file=sys.stderr)


def _pinned_structural(spec) -> dict:
    """Parameters pinned to a single structural value: the shapes that join
    a prewarm signature (everything else rides the workload's defaults)."""
    from katib_tpu_torch.compile.registry import _structural

    shared = {}
    for p in spec.parameters:
        try:
            vals = p.grid_values()
        except Exception:
            continue
        if len(vals) == 1 and _structural(vals[0]):
            shared[p.name] = vals[0]
    return shared


def _history_rows(rows: list[dict]) -> str:
    from katib_tpu_torch.compile.registry import PROCESS_TOKEN

    table = [
        [r.get("program", "?"), r.get("k", "?"), r.get("source", "?"),
         r.get("compile_seconds", "-"), r.get("capture_seconds", "-"),
         "this process" if r.get("process") == PROCESS_TOKEN else "history"]
        for r in sorted(rows, key=lambda r: (str(r.get("program")), int(r.get("k", 1))))
    ]
    return _table(table, ["program", "k", "source", "compile_s", "capture_s", "warm in"])


def cmd_prewarm(args: argparse.Namespace) -> int:
    """Run an experiment's prewarm twin for each width on ``--device`` and
    print each capture's seconds: the program warms up and captures there.
    A capture warms only the process it runs in (the trials of a later run
    capture their own); what crosses processes is the signature rows
    (history) and, with ``--publish`` / ``--fetch-only``, the kernel
    libraries the program launches, in the artifact tiers."""
    from katib_tpu_torch.compile.artifacts import ARTIFACTS
    from katib_tpu_torch.compile.buckets import prewarm_widths
    from katib_tpu_torch.compile.prewarm import (
        PrewarmRequest,
        PrewarmWorker,
        kernels_of,
        prewarm_fn_of,
    )
    from katib_tpu_torch.compile.registry import REGISTRY
    from katib_tpu_torch.device import resolve_device
    from katib_tpu_torch.runner.cohort import cohort_fn_of
    from katib_tpu_torch.runner.trial_runner import init_compile_cache
    from katib_tpu_torch.sdk.yaml_spec import load_experiment_yaml

    spec = load_experiment_yaml(args.experiment)
    if spec.train_fn is None or prewarm_fn_of(spec.train_fn) is None:
        print("error: the experiment's train_fn declares no prewarm twin "
              "(see katib_tpu_torch.compile.prewarm.attach_prewarm_fn)", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    cache = init_compile_cache(spec.compile_cache)
    if not cache:
        print("note: no compile cache wired (compileCache / KATIB_COMPILE_CACHE): "
              "the signatures are not kept", file=sys.stderr)
    artifact_dir = ARTIFACTS.configure(args.artifact_dir or spec.artifact_dir)
    if args.fetch_only and not artifact_dir:
        print("error: --fetch-only needs a shared artifact tier "
              "(--artifact-dir / artifactDir / KATIB_ARTIFACT_DIR)", file=sys.stderr)
        return 2
    shared = _pinned_structural(spec)
    cohort_fn = cohort_fn_of(spec.train_fn)
    if args.widths:
        widths = sorted({max(1, int(w)) for w in args.widths.split(",")})
    elif spec.cohort_width > 1 and cohort_fn is not None:
        widths = prewarm_widths(spec.cohort_width, buckets=spec.cohort_buckets)
    else:
        widths = [1]
    worker = PrewarmWorker(publish=args.publish, fetch_only=args.fetch_only, force=args.publish)
    requests = [PrewarmRequest(train_fn=spec.train_fn, shared=shared, k=k,
                               program_fn=cohort_fn if k > 1 else None, device=device)
                for k in widths]
    queued = 0
    for req in requests:
        if worker.submit(req):
            queued += 1
        else:
            print(f"k={req.k}: already warm in this process, skipped")
    done = worker.drain(timeout=args.timeout)
    worker.stop()
    if not done:
        print(f"warning: timed out after {args.timeout}s with twins still queued",
              file=sys.stderr)
    for req in requests:
        key = req.signature().key()
        if key in worker.captures:
            capture = worker.captures[key]
            print(f"k={req.k}: {req.signature().program} captured in "
                  f"{capture if capture is not None else '-'} s on {device}")
    stats = worker.stats()
    print(
        f"prewarm: {queued} queued, {stats['compiled']} compiled, "
        f"{stats['fetched']} fetched, {stats['published']} published, "
        f"{stats['failed']} failed (cache: {cache or '<in-process only>'}"
        f"{', artifacts: ' + artifact_dir if artifact_dir else ''})"
    )
    kernels = kernels_of(spec.train_fn)
    if (args.publish or args.fetch_only) and not kernels:
        fn = getattr(spec.train_fn, "__qualname__", "the train_fn")
        print(f"kernel libraries: 0 — {fn} launches no hand-written kernel (its "
              "steps are library calls), and a captured step program has no "
              "serialized form")
    rows = REGISTRY.signatures()
    if rows:
        print(_history_rows(rows))
    return 0 if stats["failed"] == 0 and done else 1


def cmd_cache(args: argparse.Namespace) -> int:
    """Inventory of an artifact tier: one row per kernel library envelope of
    the port with its program, size, publishing toolchain and card, and
    whether this host's fingerprint can load it (``ok``) or not
    (``stale``).  Given a compile-cache dir, its local tier
    (``torch/artifacts``) and its registry's rows (history: a capture warms
    only its own process).  The JAX package's envelopes are not read."""
    from katib_tpu_torch.compile.artifacts import ARTIFACTS, SUFFIX, env_fingerprint, scan_dir
    from katib_tpu_torch.compile.registry import PORT_SUBDIR, read_rows

    path = args.path or ARTIFACTS.shared_dir()
    if not path:
        print("error: no artifact dir (pass a path or set KATIB_ARTIFACT_DIR)",
              file=sys.stderr)
        return 2
    history: list[dict] = []
    local = os.path.join(path, PORT_SUBDIR, "artifacts")
    if not any(n.endswith(SUFFIX) for n in _ls(path)) and os.path.isdir(os.path.join(path, PORT_SUBDIR)):
        history = read_rows(path)  # a compile-cache dir
        path = local
    rows = scan_dir(path)
    if args.json:
        print(json.dumps({"dir": path, "artifacts": rows, "registry": history}, indent=2))
        return 0
    fp = env_fingerprint()
    print(f"artifact dir {os.path.abspath(path)} · this host: torch {fp['torch']} · "
          f"nvcc {fp['nvcc'] or '-'} · {fp['device_name'] or 'no GPU'} "
          f"{fp['capability']}".rstrip())
    if rows:
        table = [
            [r.get("program", "?"), r.get("status", "?"),
             f"{r.get('library_bytes', r.get('bytes', 0)) / 1024:.0f}K",
             r.get("torch", "?"), r.get("nvcc", "?") or "-",
             f"{r.get('device_name', '?') or '-'} {r.get('capability', '')}".strip()]
            for r in rows
        ]
        print(_table(table, ["program", "status", "library", "torch", "nvcc", "target"]))
        loadable = sum(1 for r in rows if r.get("status") == "ok")
        corrupt = sum(1 for r in rows if r.get("status") == "corrupt")
        print(f"{len(rows)} artifact(s), {loadable} loadable here ({corrupt} corrupt — "
              "run `fsck` to quarantine)")
    else:
        print("(empty)")
    if history:
        print("registry history (warm means warmed in the writing process):")
        print(_history_rows(history))
    return 0


def _ls(path: str) -> list[str]:
    try:
        return os.listdir(path)
    except OSError:
        return []


def _read_cost_rows(d: str) -> list[dict]:
    """The port's registry rows under ``d``: a compile-cache dir
    (``<d>/torch/shape_registry.jsonl``), that ``torch`` dir itself, or a
    workdir with cache dirs one level down; the last row of a key wins,
    keeping the cost of an earlier one."""
    import glob

    from katib_tpu_torch.compile.registry import (
        _REGISTRY_FILENAME,
        PORT_SUBDIR,
        _keep_cost,
        read_rows,
    )

    d = os.path.normpath(d)
    if os.path.basename(d) == PORT_SUBDIR and os.path.isfile(os.path.join(d, _REGISTRY_FILENAME)):
        caches = [os.path.dirname(d)]
    else:
        caches = [d] + sorted(
            os.path.dirname(os.path.dirname(p))
            for p in glob.glob(os.path.join(d, "*", PORT_SUBDIR, _REGISTRY_FILENAME)))
    by_key: dict[str, dict] = {}
    for cache in caches:
        for row in read_rows(cache):
            _keep_cost(row, by_key.get(row["key"]))
            by_key[row["key"]] = row
    return list(by_key.values())


def cmd_cost(args: argparse.Namespace) -> int:
    """Roofline table: each step program's counted cost record (the shape
    registry's ``cost`` rows) against a device kind's peaks: flops and
    bytes per step, arithmetic intensity, which roofline (compute or
    device-memory bandwidth) binds, the floor step time, the MFU ceiling
    and the counted step's footprint where one was read.  Given an
    experiment YAML with nothing costed yet, the experiment's prewarm twins
    run in this process and count their step as a side effect: on the card,
    as every entry point runs, unless ``--device cpu`` asks for the CPU.
    ``--device`` defaults to the kind of the device the twins would run on
    (for a directory, this host's).  Exit 1 when nothing is costed, 2 for a
    device kind without peaks or a card that is not there."""
    from katib_tpu_torch import costmodel
    from katib_tpu_torch.device import resolve_device

    target = args.target
    twins_on = None
    if not os.path.isdir(target):
        try:
            twins_on = resolve_device("cpu" if args.device == "cpu" else None)
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    try:
        pk = costmodel.peaks_for(args.device or costmodel.detect_device_kind(twins_on))
    except costmodel.UnknownDevicePeaks as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if twins_on is None:
        recs = _read_cost_rows(target)
    else:
        from katib_tpu_torch.compile.buckets import prewarm_widths
        from katib_tpu_torch.compile.prewarm import PrewarmRequest, PrewarmWorker, prewarm_fn_of
        from katib_tpu_torch.compile.registry import REGISTRY
        from katib_tpu_torch.runner.cohort import cohort_fn_of
        from katib_tpu_torch.runner.trial_runner import init_compile_cache
        from katib_tpu_torch.sdk.yaml_spec import load_experiment_yaml

        spec = load_experiment_yaml(target)
        init_compile_cache(spec.compile_cache)
        recs = REGISTRY.signatures()
        needs_count = not any(isinstance(r.get("cost"), dict) for r in recs)
        if needs_count and spec.train_fn is not None and prewarm_fn_of(spec.train_fn):
            cohort_fn = cohort_fn_of(spec.train_fn)
            if spec.cohort_width > 1 and cohort_fn is not None:
                widths = prewarm_widths(spec.cohort_width, buckets=spec.cohort_buckets)
            else:
                widths = [1]
            worker = PrewarmWorker()
            for k in sorted(widths):
                worker.submit(PrewarmRequest(
                    train_fn=spec.train_fn, shared=_pinned_structural(spec), k=k,
                    program_fn=cohort_fn if k > 1 else None, device=twins_on))
            worker.drain(timeout=args.timeout)
            worker.stop()
            recs = REGISTRY.signatures()
    costed = [r for r in recs if isinstance(r.get("cost"), dict)]
    if not costed:
        print(
            "no cost records on file: run the experiment (or `prewarm`) with a "
            "persistent compile cache first, or point at an experiment YAML whose "
            "train_fn has a prewarm twin",
            file=sys.stderr,
        )
        return 1
    print(
        f"roofline vs {pk.device_kind}: "
        f"{pk.peak_flops('bf16') / 1e12:.1f} TFLOP/s bf16 peak, "
        f"{pk.hbm_bandwidth / 1e9:.0f} GB/s device memory, "
        f"ridge {pk.ridge_intensity:.0f} flops/byte "
        "(bytes are pre-fusion: floors are lower bounds, max_mfu an upper bound)"
    )
    rows = []
    for r in sorted(costed, key=lambda r: (str(r.get("program")), int(r.get("k", 1)))):
        rec = costmodel.CostRecord.from_dict(r["cost"])
        roof = rec.roofline(pk)
        rows.append(
            [
                r.get("program", "?"),
                r.get("k", 1),
                r.get("mesh", "") or "-",
                f"{rec.flops_per_step / 1e9:.3f}",
                f"{rec.bytes_per_step / 1e6:.2f}",
                f"{roof['arithmetic_intensity']:.1f}",
                roof["bound"].replace("-bound", ""),
                f"{roof['floor_step_secs'] * 1e3:.3f}",
                f"{roof['max_mfu']:.2f}",
                f"{rec.hbm_bytes / 2**30:.2f}" if rec.hbm_bytes else "-",
            ]
        )
    print(
        _table(
            rows,
            [
                "program", "k", "mesh", "gflop/step", "mb/step", "ai",
                "bound", "floor_ms", "max_mfu", "hbm_gb",
            ],
        )
    )
    return 0


def cmd_profile(args: argparse.Namespace) -> int:
    """On-demand ``torch.profiler`` capture + the capture inventory.

    ``--list`` discovers past captures under a workdir (per-trial
    ``enable_profiler`` directories and ``profile.capture`` spans in the
    trace journals).  With an experiment YAML it runs the experiment's
    prewarm twin under the profiler, on the card unless ``--device cpu``:
    a Chrome trace of the trial's step program, without scheduling a
    trial.  Exit 2 for a spec whose train_fn has no twin, for neither
    ``--list`` nor a YAML, or for a card that is not there."""
    from katib_tpu_torch.costmodel import profiler as costprofiler

    if args.list:
        entries = costprofiler.scan_profiles(args.workdir)
        if not entries:
            print(f"no profiler captures under {args.workdir}")
            return 0
        rows = [
            [
                e.get("experiment") or "-",
                e.get("trial") or "-",
                e.get("source", "-"),
                e.get("trace_dir", "?"),
            ]
            for e in entries
        ]
        print(_table(rows, ["experiment", "trial", "source", "trace_dir"]))
        return 0
    if not args.experiment:
        print(
            "error: pass an experiment YAML to capture, or --list to "
            "inventory past captures",
            file=sys.stderr,
        )
        return 2
    from katib_tpu_torch.compile.prewarm import prewarm_fn_of
    from katib_tpu_torch.device import resolve_device
    from katib_tpu_torch.runner.trial_runner import init_compile_cache
    from katib_tpu_torch.sdk.yaml_spec import load_experiment_yaml

    spec = load_experiment_yaml(args.experiment)
    fn = prewarm_fn_of(spec.train_fn) if spec.train_fn is not None else None
    if fn is None:
        print(
            "error: the experiment's train_fn declares no prewarm twin to "
            "profile (see katib_tpu_torch.compile.prewarm.attach_prewarm_fn)",
            file=sys.stderr,
        )
        return 2
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    init_compile_cache(spec.compile_cache)
    # default lands on the <workdir>/<experiment>/<trial>/profile layout
    # enable_profiler trials use, so `profile --list` discovers it
    out = args.out or os.path.join(args.workdir, spec.name, "adhoc", "profile")
    with costprofiler.capture(out, trial="adhoc", experiment=spec.name, device=device):
        fn(dict(_pinned_structural(spec)), 1, None, device)
    print(
        f"profiler trace: {os.path.join(out, costprofiler.TRACE_FILE)} (a Chrome trace: "
        "open it in Perfetto or chrome://tracing; listed by `python -m "
        "katib_tpu_torch profile --list`)"
    )
    return 0


def cmd_suggest_server(args: argparse.Namespace) -> int:
    """Run the suggestion-as-a-service daemon (the reference's per-experiment
    algorithm Deployment entrypoint, ``cmd/suggestion/*/v1beta1/main.py``).
    The auth token comes from ``--token`` or ``KATIB_SUGGEST_TOKEN``;
    unset = open (localhost development).  Suggesters that compute on a
    device run on ``--device``."""
    from katib_tpu_torch.suggest.service import serve_suggestions

    token = args.token or os.environ.get("KATIB_SUGGEST_TOKEN") or None
    ssl_context = _maybe_tls(args)
    svc = serve_suggestions(
        port=args.port, host=args.host, token=token, ssl_context=ssl_context,
        device=args.device,
    )
    scheme = "https" if ssl_context else "http"
    print(
        f"katib-tpu suggestion service: {scheme}://{args.host}:{svc.port} "
        f"(auth: {'bearer token' if token else 'open'})",
        flush=True,
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        svc.stop()
    return 0


def _maybe_tls(args: argparse.Namespace):
    """``--cert-dir`` turns a serving command into TLS: the rotator in
    ``utils.certgen`` (re)generates the self-signed bundle there and the
    server wraps its socket with it (reference ``certgenerator/generator.go``)."""
    cert_dir = getattr(args, "cert_dir", None)
    if not cert_dir:
        return None
    import ipaddress
    import socket

    from katib_tpu_torch.utils.certgen import ensure_certs, server_ssl_context

    host = getattr(args, "host", "127.0.0.1")
    dns, ips = ["localhost"], ["127.0.0.1"]
    try:
        ip = ipaddress.ip_address(host)
        if ip.is_unspecified:
            # bound on all interfaces: remote clients will connect via the
            # machine's real addresses, so the leaf needs those SANs too
            dns.append(socket.gethostname())
            try:
                for addr in socket.gethostbyname_ex(socket.gethostname())[2]:
                    if addr not in ips:
                        ips.append(addr)
            except OSError:
                pass
        elif str(ip) != "127.0.0.1":
            ips.append(str(ip))
    except ValueError:
        dns.append(host)
    return server_ssl_context(
        ensure_certs(cert_dir, dns_names=tuple(dns), ip_addresses=tuple(ips))
    )


def cmd_ui(args: argparse.Namespace) -> int:
    """Serve the REST API + dashboard over ``--workdir`` and the config's
    store until interrupted; experiments it creates run on ``--device``."""
    from katib_tpu_torch.ui import start_ui

    cfg = KatibConfig.load(args.config)
    store = cfg.store.make_store()
    token = args.token or os.environ.get("KATIB_UI_TOKEN") or None
    ssl_context = _maybe_tls(args)
    ui = start_ui(
        args.workdir, store, port=args.port, host=args.host, token=token,
        ssl_context=ssl_context, device=args.device,
    )
    scheme = "https" if ssl_context else "http"
    print(
        f"katib-tpu dashboard: {scheme}://{args.host}:{ui.port}/ "
        f"(writes: {'bearer token' if token else 'open'})",
        flush=True,
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        ui.stop()
    return 0


def cmd_db_manager(args: argparse.Namespace) -> int:
    """Run the native db-manager daemon standalone (the reference ships it as
    its own binary, ``cmd/db-manager/v1beta1/main.go:51``).  ``--db`` turns
    on the append-only frame journal: acknowledged mutations survive kill -9
    and replay at the next start.  Blocks until interrupted; clients point a
    ``store: {backend: remote, host, port}`` config (or
    ``RemoteObservationStore``) at the printed address.  Raises if the
    runtime cannot build."""
    import signal

    from katib_tpu_torch.native.dbmanager import spawn_db_manager

    # PDEATHSIG: the daemon dies with this wrapper, so even a wrapper killed
    # by SIGKILL cannot leave a daemon holding the port and the journal
    handle = spawn_db_manager(host=args.host, port=args.port, db_path=args.db,
                              kill_on_parent_exit=True)
    print(
        f"katib-tpu db-manager: {args.host}:{handle.port} "
        f"({'journal: ' + args.db if args.db else 'in-memory'})",
        flush=True,
    )
    stopped_by_us = False

    def _on_term(signum, frame):
        nonlocal stopped_by_us
        stopped_by_us = True
        # signal only: proc.wait() here would deadlock on the Popen lock the
        # interrupted wait() of the main thread holds
        handle.proc.terminate()

    signal.signal(signal.SIGTERM, _on_term)
    try:
        handle.proc.wait()
    except KeyboardInterrupt:
        stopped_by_us = True
        handle.stop()
    # a shutdown this wrapper started is a clean exit, whatever signal ended
    # the daemon; only a daemon that died by itself is a failure
    if stopped_by_us:
        return 0
    rc = handle.proc.returncode
    return rc if rc and rc > 0 else (1 if rc else 0)


def _cmd_unported(args: argparse.Namespace) -> int:
    raise NotImplementedError(
        f"verb {args.cmd!r} of katib_tpu/cli.py is not ported yet (ROADMAP Queue 1 "
        "item 11); the port has run, list, describe, metrics, export, logs, trace, "
        "conformance, chaos, fsck, prewarm, cache, cost, profile, doctor, "
        "suggest-server, ui and db-manager"
    )


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="katib-tpu-torch", description="AutoML framework CLI (PyTorch/CUDA)"
    )
    parser.add_argument("--config", default=None, help="KatibConfig YAML path")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run an experiment from a YAML spec")
    p.add_argument("experiment")
    p.add_argument("--workdir", default=None)
    p.add_argument(
        "--resume",
        action="store_true",
        help="resume from the status journal (honors spec resumePolicy)",
    )
    p.add_argument(
        "--drain-grace-seconds",
        type=float,
        default=None,
        help="on SIGTERM/SIGINT, wait this long for running trials to reach "
        "a checkpoint boundary before journaling them Drained "
        "(overrides the spec's drainGraceSeconds)",
    )
    p.add_argument(
        "--no-preflight",
        action="store_true",
        help="skip the bounded device preflight probe that gates the run "
        "(KATIB_PREFLIGHT_DEADLINE bounds it; see `doctor`)",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="where trials run: cuda (default; raises without a GPU) or cpu",
    )
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser(
        "fsck",
        help="validate and repair an experiment dir (journal, snapshots, fence) "
        "or an artifact dir (envelopes)",
    )
    p.add_argument(
        "path",
        help="experiment directory to check, e.g. <workdir>/<experiment>, or "
        "an artifact dir",
    )
    p.add_argument(
        "--dry-run",
        action="store_true",
        help="report damage without repairing (nonzero exit if any found)",
    )
    p.set_defaults(fn=cmd_fsck)

    p = sub.add_parser(
        "prewarm",
        help="run an experiment's prewarm twin for each width on the device and "
        "print its capture seconds (a capture warms only its own process); "
        "record the signatures, publish or fetch the kernel libraries",
    )
    p.add_argument("experiment", help="experiment YAML")
    p.add_argument(
        "--widths",
        default=None,
        help="comma-separated cohort widths to warm (default: derived from "
        "cohortWidth + shape bucketing)",
    )
    p.add_argument("--timeout", type=float, default=600.0,
                   help="max seconds to wait for queued twins")
    p.add_argument(
        "--publish",
        action="store_true",
        help="publish the kernel libraries the program launches to the artifact "
        "tiers (--artifact-dir / artifactDir / KATIB_ARTIFACT_DIR)",
    )
    p.add_argument(
        "--fetch-only",
        action="store_true",
        help="only fetch the program's kernel libraries from the tiers into the "
        "build directory (no twin runs)",
    )
    p.add_argument(
        "--artifact-dir",
        default=None,
        help="shared artifact tier directory (overrides the spec's artifactDir; "
        "KATIB_ARTIFACT_DIR wins over both)",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="where the twins run: cuda (default; raises without a GPU) or cpu",
    )
    p.set_defaults(fn=cmd_prewarm)

    p = sub.add_parser(
        "cache",
        help="inspect an artifact tier (kernel libraries: program, publishing "
        "toolchain and card, loadable here?) or a compile-cache dir",
    )
    p.add_argument(
        "path",
        nargs="?",
        default=None,
        help="artifact dir or compile-cache dir (default: KATIB_ARTIFACT_DIR)",
    )
    p.add_argument("--json", action="store_true", help="machine-readable inventory")
    p.set_defaults(fn=cmd_cache)

    p = sub.add_parser(
        "doctor",
        help="bounded-time device preflight + environment report "
        "(exit 0 = every device healthy)",
    )
    p.add_argument(
        "--device-timeout",
        default=30.0,
        type=float,
        help="seconds to wait for device enumeration + probes before "
        "declaring the device wedged",
    )
    p.add_argument(
        "--json",
        action="store_true",
        help="print the machine-readable per-device health report only",
    )
    p.add_argument(
        "--simulate-wedge",
        action="append",
        type=int,
        metavar="N",
        help="treat device id N as wedged (testing the non-zero exit path); "
        "repeatable",
    )
    p.add_argument(
        "--device",
        default="cuda",
        choices=("cuda", "cpu"),
        help="which devices to probe: every visible CUDA device (default) or the CPU",
    )
    p.set_defaults(fn=cmd_doctor)

    p = sub.add_parser("list", help="list experiments")
    p.add_argument("--workdir", default="katib_runs")
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("describe", help="describe one experiment")
    p.add_argument("experiment")
    p.add_argument("--workdir", default="katib_runs")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_describe)

    p = sub.add_parser("metrics", help="dump a trial's metric log")
    p.add_argument("trial")
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser("export", help="dump trials as CSV/JSONL for analysis")
    p.add_argument("experiment")
    p.add_argument("--format", choices=("csv", "jsonl"), default="csv")
    p.add_argument("--workdir", default="katib_runs")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("logs", help="print a black-box trial's captured stdout")
    p.add_argument("trial")
    p.add_argument("--workdir", default="katib_runs")
    p.set_defaults(fn=cmd_logs)

    p = sub.add_parser("trace", help="export/summarize an experiment's span journal")
    trace_sub = p.add_subparsers(dest="trace_cmd", required=True)
    tp = trace_sub.add_parser(
        "export", help="trace journal -> Chrome-trace JSON (Perfetto-loadable)"
    )
    tp.add_argument("experiment")
    tp.add_argument("--workdir", default="katib_runs")
    tp.add_argument(
        "--out",
        default=None,
        help="output path (default <workdir>/<experiment>/trace.json; '-' for stdout)",
    )
    tp.set_defaults(fn=cmd_trace_export)
    tp = trace_sub.add_parser(
        "summary", help="per-span latency distribution (count/total/p50/p95)"
    )
    tp.add_argument("experiment")
    tp.add_argument("--workdir", default="katib_runs")
    tp.add_argument("--json", action="store_true")
    tp.add_argument(
        "--top",
        type=int,
        default=0,
        metavar="N",
        help="also list the N slowest individual spans with their roofline "
        "attrs (mfu / bound / headroom) where a span carries them",
    )
    tp.set_defaults(fn=cmd_trace_summary)

    p = sub.add_parser("conformance", help="packaged e2e invariants check")
    p.add_argument("--max-trials", type=int, default=8)
    p.add_argument(
        "--device",
        default="cuda",
        help="where trials run: cuda (default; raises without a GPU) or cpu",
    )
    p.set_defaults(fn=cmd_conformance)

    p = sub.add_parser(
        "chaos", help="deterministic fault-injection run (fault-tolerance invariants)"
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trials", type=int, default=4)
    p.add_argument(
        "--device",
        default="cuda",
        help="where trials run, the crash scenario's child's included: cuda "
        "(default; raises without a GPU) or cpu",
    )
    for flag, (kwargs, _) in _SINGLE_RUN_ARGS.items():
        p.add_argument(flag, default=None, **kwargs)
    p.add_argument(
        "--crash-at",
        metavar="SITE[:N]",
        default=None,
        help="hard-crash (os._exit, no drain, no cleanup) a child sweep at "
        "the N-th (default 1st) hit of a registered persistence crash "
        "point, then resume in-process and assert no settled trial is "
        "lost, no observation duplicated, and the retry budget is "
        "monotone; sites: journal.append, journal.snapshot, "
        "suggester.pickle, status.write, checkpoint.manifest, "
        "retry.budget, store.report",
    )
    p.add_argument(
        "--kill-at",
        metavar="SITE[:N]",
        default=None,
        help="like --crash-at but the child dies by SIGKILL "
        "(indistinguishable from the OOM killer)",
    )
    p.add_argument(
        "--wedge-device",
        action="append",
        type=int,
        metavar="N",
        help="needs a trial-axis mesh with elastic degradation; not ported yet "
        "(raises, ROADMAP item 9b)",
    )
    p.add_argument(
        "--soak",
        type=float,
        default=None,
        metavar="SECONDS",
        help="seeded chaos soak: run scripted fault rounds (loop kills, "
        "suggester stalls, trial faults, speculation) for ~SECONDS, "
        "asserting zero lost/duplicated settlements, restart budgets "
        "respected, and post-fault occupancy recovery; deterministic "
        "per --seed",
    )
    p.set_defaults(fn=cmd_chaos)

    p = sub.add_parser(
        "suggest-server", help="run the suggestion-as-a-service daemon"
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=6789)
    p.add_argument("--token", default=None, help="bearer token (or KATIB_SUGGEST_TOKEN)")
    p.add_argument(
        "--cert-dir", default=None,
        help="serve over TLS with a self-signed bundle rotated in this dir",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="where suggesters compute: cuda (default; raises without a GPU) or cpu",
    )
    p.set_defaults(fn=cmd_suggest_server)

    p = sub.add_parser(
        "cost", help="roofline table of the shape registry's counted step costs"
    )
    p.add_argument(
        "target",
        help="experiment YAML (runs the prewarm twins, on the card unless --device "
        "cpu, if nothing is costed yet) or a compile-cache/workdir directory "
        "holding the port's torch/shape_registry.jsonl",
    )
    p.add_argument(
        "--device",
        default=None,
        help="device kind for the peaks table (h100 or cpu; default: the kind of "
        "the device the twins run on, for a directory this host's; cpu also runs "
        "the twins on the CPU; KATIB_PEAK_FLOPS/KATIB_PEAK_BW override)",
    )
    p.add_argument(
        "--timeout",
        type=float,
        default=300.0,
        help="prewarm-twin budget in seconds (YAML targets only)",
    )
    p.set_defaults(fn=cmd_cost)

    p = sub.add_parser(
        "profile",
        help="on-demand torch.profiler capture (or --list past captures)",
    )
    p.add_argument(
        "experiment",
        nargs="?",
        default=None,
        help="experiment YAML whose prewarm twin to run under the profiler",
    )
    p.add_argument("--workdir", default="katib_runs")
    p.add_argument(
        "--out",
        default=None,
        help="trace output dir (default <workdir>/<experiment>/adhoc/profile)",
    )
    p.add_argument(
        "--list",
        action="store_true",
        help="inventory captures under --workdir instead of capturing",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="where the twin runs: cuda (default; exit 2 without a GPU) or cpu",
    )
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("ui", help="serve the REST API + dashboard")
    p.add_argument("--workdir", default="katib_runs")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument(
        "--token", default=None, help="bearer token for write endpoints (or KATIB_UI_TOKEN)"
    )
    p.add_argument(
        "--cert-dir", default=None,
        help="serve over TLS with a self-signed bundle rotated in this dir",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="where experiments the ui creates run: cuda (default; raises without a GPU) "
        "or cpu",
    )
    p.set_defaults(fn=cmd_ui)

    p = sub.add_parser("db-manager", help="run the native observation-log daemon")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=6789)
    p.add_argument(
        "--db", default=None,
        help="journal file: acked mutations survive crashes and replay on start",
    )
    p.set_defaults(fn=cmd_db_manager)

    for verb in UNPORTED_VERBS:
        p = sub.add_parser(verb, help="not ported yet", add_help=False)
        p.add_argument("rest", nargs=argparse.REMAINDER)
        p.set_defaults(fn=_cmd_unported)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # output piped into e.g. `head`; suppress the noise and let the
        # interpreter exit without re-raising on stdout flush
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    sys.exit(main())
