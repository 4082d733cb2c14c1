"""``katib-tpu-torch`` command-line interface (``python -m katib_tpu_torch``).

Port of ``katib_tpu/cli.py``'s ``run``, ``fsck``, ``doctor`` and
``chaos --soak`` verbs:

- ``run <experiment.yaml>``   create + run an experiment to completion (--resume);
                              ``--device`` names where trials run (``cuda``
                              unless it says ``cpu``); a run on the async
                              engine ends with an ``async engine: {...}``
                              line on stderr (``Orchestrator.async_stats``)
- ``fsck <workdir>/<exp>``    validate + repair an experiment dir (torn journal tail,
                              snapshot checksums, suggester fence)
- ``doctor``                  bounded device preflight + environment report
- ``chaos --soak SECONDS``    seeded chaos soak of the async engine
                              (``orchestrator/soak.py``); ``chaos``'s other
                              modes raise ``NotImplementedError``

The JAX CLI's other verbs are listed in :data:`UNPORTED_VERBS`; each raises
``NotImplementedError`` naming it.  This module imports no JAX, and no verb
does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from katib_tpu_torch.core.config import KatibConfig

#: the JAX CLI's verbs the port does not have yet
UNPORTED_VERBS = (
    "list", "describe", "metrics", "export", "logs", "trace",
    "cost", "profile", "prewarm", "cache", "ui", "sim", "lint",
    "suggest-server", "db-manager", "conformance",
)


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


#: artifact envelope suffixes (``katib_tpu/compile/artifacts.py``)
_ARTIFACT_SUFFIX = ".katibx"
_QUARANTINE_SUFFIX = ".quarantined"


def _is_artifact_dir(path: str) -> bool:
    """The JAX CLI's ``is_artifact_dir`` test: envelope files, or a
    directory named ``artifacts``."""
    try:
        names = os.listdir(path)
    except OSError:
        return False
    if any(n.endswith((_ARTIFACT_SUFFIX, _ARTIFACT_SUFFIX + _QUARANTINE_SUFFIX)) for n in names):
        return True
    return os.path.basename(os.path.normpath(path)) == "artifacts"


def cmd_fsck(args: argparse.Namespace) -> int:
    """Validate and repair an experiment directory (journal checksums,
    torn tails, snapshot integrity, suggester fence) — see
    ``orchestrator/fsck.py``.  Exit 0 when consistent after repairs.  An
    artifact-cache directory raises: the port has no artifact cache yet."""
    if _is_artifact_dir(args.path):
        raise NotImplementedError(
            f"{args.path} looks like an artifact-cache directory; fsck of "
            "artifact caches (katib_tpu/compile/artifacts.py) is not ported yet"
        )
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
    print("native runtime: not ported")
    cfg = KatibConfig.load(args.config)
    print(f"workdir: {cfg.init.workdir}")
    print(f"store: {cfg.store.backend}")
    return 0 if report.ok() else 1


#: the flags of the JAX ``chaos`` verb's single fault-injection run
#: (``katib_tpu/cli.py::cmd_chaos``), which the port has not ported
SINGLE_RUN_FLAGS = (
    "--max-retries", "--suggester-max-errors", "--fail-trial", "--fail-suggester",
    "--flake-rate", "--hang-trial", "--preempt-at", "--compile-hang",
    "--progress-deadline", "--compile-deadline", "--drain-grace", "--kill-loop",
    "--stall-suggester", "--loop-stall-deadline",
)


def cmd_chaos(args: argparse.Namespace) -> int:
    """``chaos --soak SECONDS --seed N [--trials N]``: the seeded chaos soak
    of the async engine (``orchestrator/soak.py``); exit 0 when every
    round's invariants held.  The JAX verb's other modes raise, each naming
    itself."""
    if args.crash_at or args.kill_at:
        raise NotImplementedError(
            "chaos --crash-at/--kill-at, the crash-consistency scenario of "
            "katib_tpu/cli.py (_chaos_crash), is not ported yet"
        )
    if args.wedge_device:
        raise NotImplementedError(
            "chaos --wedge-device, the wedged-device scenario of "
            "katib_tpu/cli.py (cmd_chaos), is not ported yet"
        )
    given = [f for f in SINGLE_RUN_FLAGS if getattr(args, f[2:].replace("-", "_")) is not None]
    if args.soak is None:
        raise NotImplementedError(
            "chaos without --soak, the single fault-injection run of "
            f"katib_tpu/cli.py (cmd_chaos{'; ' + ' '.join(given) if given else ''}), "
            "is not ported yet; the port has chaos --soak SECONDS --seed N "
            "[--trials N]"
        )
    if given:
        raise NotImplementedError(
            "chaos --soak: the single fault-injection run's flags "
            f"({' '.join(given)}) are not ported yet (katib_tpu/cli.py "
            "cmd_chaos); the soak takes --seed and --trials"
        )
    from katib_tpu_torch.orchestrator.soak import run_soak

    # soak rounds want enough trials per round for occupancy and mid-run
    # kills to mean something; --trials can only raise it
    return run_soak(seconds=args.soak, seed=args.seed, trials=max(args.trials, 10))


def _cmd_unported(args: argparse.Namespace) -> int:
    raise NotImplementedError(
        f"verb {args.cmd!r} of katib_tpu/cli.py is not ported yet; the port "
        "has run, fsck, doctor and chaos --soak"
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
        help="validate and repair an experiment dir (journal, snapshots, fence)",
    )
    p.add_argument(
        "path",
        help="experiment directory to check, e.g. <workdir>/<experiment>",
    )
    p.add_argument(
        "--dry-run",
        action="store_true",
        help="report damage without repairing (nonzero exit if any found)",
    )
    p.set_defaults(fn=cmd_fsck)

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

    p = sub.add_parser(
        "chaos",
        help="seeded chaos soak of the async engine (only --soak is ported)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trials", type=int, default=4)
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
    p.add_argument("--crash-at", metavar="SITE[:N]", default=None, help="not ported yet")
    p.add_argument("--kill-at", metavar="SITE[:N]", default=None, help="not ported yet")
    p.add_argument("--wedge-device", action="append", type=int, metavar="N",
                   help="not ported yet")
    for flag in SINGLE_RUN_FLAGS:
        p.add_argument(flag, default=None,
                       help="the single fault-injection run's; not ported yet")
    p.set_defaults(fn=cmd_chaos)

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
