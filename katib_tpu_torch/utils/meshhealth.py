"""Bounded-time device health probing — the preflight behind
``python -m katib_tpu_torch doctor`` and the ``run`` gate (port of
``katib_tpu/utils/meshhealth.py`` as a CUDA prober).

The failure mode this exists for: a wedged accelerator (a GPU that fell off
the bus, a driver stuck in a reset) makes the first CUDA call, or the first
kernel on one card, block or fail.  Trial-level robustness (retries, hang
watchdog, drain) never fires because nothing ever starts.

So the probe runs in a CHILD process that is a fresh interpreter
(``subprocess`` with ``sys.executable``), never a ``fork``: a process that
has initialised CUDA cannot fork a child that uses it, and a child stuck in
the driver can be killed where a thread cannot.  The child enumerates the
devices of the asked type (every visible CUDA device, or the CPU), runs a
tiny kernel on each under one deadline (host-to-device copy, a reduction, a
host fetch), and prints a tagged JSON :class:`HealthReport`.  A probe that
does not complete inside the deadline classifies the device WEDGED; probes
that raise record the error; devices the caller expected but enumeration did
not return classify ABSENT.  The parent kills a child that outlives the
deadline and reports the pool WEDGED.

``FaultInjector.wedge_device`` plugs in through the ``injector`` seam:
injector-wedged device ids pass to the child, which classifies them WEDGED
without running them, so chaos tests and ``doctor --simulate-wedge`` are
deterministic and fast.

Nothing here imports torch in the calling process.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

#: default overall preflight deadline, seconds (env-overridable)
DEADLINE_ENV = "KATIB_PREFLIGHT_DEADLINE"
DEFAULT_DEADLINE = 60.0

HEALTHY = "healthy"
WEDGED = "wedged"
ABSENT = "absent"


def default_deadline() -> float:
    try:
        return float(os.environ.get(DEADLINE_ENV, ""))
    except ValueError:
        pass
    return DEFAULT_DEADLINE


@dataclasses.dataclass
class DeviceHealth:
    """One device's preflight verdict."""

    device: str  # "<platform>:<id>", stable across report consumers
    platform: str
    status: str  # HEALTHY | WEDGED | ABSENT
    probe_seconds: float = 0.0
    error: str = ""

    def to_dict(self) -> dict:
        d = {
            "device": self.device,
            "platform": self.platform,
            "status": self.status,
            "probe_seconds": round(self.probe_seconds, 3),
        }
        if self.error:
            d["error"] = self.error
        return d


@dataclasses.dataclass
class HealthReport:
    """Machine-readable pool verdict: the doctor's output, the bench
    artifact's ``health`` block, and ``status.json``'s ``device_health``."""

    status: str  # HEALTHY | WEDGED | ABSENT
    deadline_seconds: float
    elapsed_seconds: float
    devices: list[DeviceHealth] = dataclasses.field(default_factory=list)
    generated_at: float = 0.0
    error: str = ""  # enumeration-level failure (no per-device detail)

    def ok(self) -> bool:
        return self.status == HEALTHY and bool(self.devices)

    @property
    def healthy_count(self) -> int:
        return sum(1 for d in self.devices if d.status == HEALTHY)

    @property
    def wedged_count(self) -> int:
        return sum(1 for d in self.devices if d.status == WEDGED)

    @property
    def absent_count(self) -> int:
        return sum(1 for d in self.devices if d.status == ABSENT)

    def to_dict(self) -> dict:
        d = {
            "status": self.status,
            "deadline_seconds": self.deadline_seconds,
            "elapsed_seconds": round(self.elapsed_seconds, 3),
            "healthy": self.healthy_count,
            "wedged": self.wedged_count,
            "absent": self.absent_count,
            "generated_at": self.generated_at,
            "devices": [dev.to_dict() for dev in self.devices],
        }
        if self.error:
            d["error"] = self.error
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    def summary(self) -> str:
        """One line for log messages and experiment failure text."""
        if self.error and not self.devices:
            return f"pool {self.status}: {self.error}"
        parts = [f"{self.healthy_count} healthy"]
        if self.wedged_count:
            parts.append(f"{self.wedged_count} wedged")
        if self.absent_count:
            parts.append(f"{self.absent_count} absent")
        return (
            f"pool {self.status}: {', '.join(parts)} "
            f"({self.elapsed_seconds:.1f}s/{self.deadline_seconds:.0f}s probe)"
        )


# last preflight of this process, embedded into status.json by
# orchestrator/status.py (None until a preflight ran)
_LAST_REPORT: HealthReport | None = None
_LAST_LOCK = threading.Lock()


def last_report() -> HealthReport | None:
    with _LAST_LOCK:
        return _LAST_REPORT


def last_report_dict() -> dict | None:
    r = last_report()
    return r.to_dict() if r is not None else None


def _record(report: HealthReport) -> None:
    global _LAST_REPORT
    with _LAST_LOCK:
        _LAST_REPORT = report


@dataclasses.dataclass(frozen=True)
class ProbeDevice:
    """One device as the prober sees it: ``platform`` is ``gpu`` or ``cpu``,
    ``id`` the CUDA ordinal (0 on the CPU)."""

    platform: str
    id: int

    def torch_device(self) -> str:
        return f"cuda:{self.id}" if self.platform == "gpu" else "cpu"


def _default_prober(device: ProbeDevice) -> None:
    """The tiny end-to-end proof a device is alive: host->device copy, a
    reduction kernel, and a host fetch.  Enumeration alone can succeed on a
    wedged card; only a round-tripped execution exercises it."""
    import torch

    x = torch.arange(8, dtype=torch.float32).to(device.torch_device())
    if float((x * 2.0).sum()) != 56.0:
        raise RuntimeError(f"probe kernel on {device.torch_device()} returned a wrong sum")


def _device_key(device) -> str:
    return f"{getattr(device, 'platform', '?')}:{getattr(device, 'id', '?')}"


def probe_devices(
    devices,
    deadline: float | None = None,
    clock=time.monotonic,
    prober=None,
    injector=None,
    expect_ids=None,
) -> HealthReport:
    """Probe every device in ``devices`` concurrently under ONE overall
    ``deadline``.  Each probe runs on a daemon thread so a genuinely wedged
    device is abandoned, not waited out.  ``expect_ids`` (optional iterable
    of device ids) adds ABSENT rows for ids enumeration did not return —
    how a 4-chip mesh notices it came back with 3.

    ``injector`` (``faults.FaultInjector``) short-circuits devices marked
    by ``wedge_device`` to WEDGED without consuming wall-clock, keeping
    chaos runs deterministic.  ``prober``/``clock`` are injectable for
    tests (a slow prober + a small real deadline exercises the timeout
    path in milliseconds)."""
    if deadline is None:
        deadline = default_deadline()
    probe = prober or _default_prober
    devices = list(devices)
    t0 = clock()
    entries: dict[int, DeviceHealth] = {}
    threads: list[tuple[int, threading.Thread]] = []
    done: dict[int, tuple[float, str]] = {}  # slot -> (probe_seconds, error)
    done_lock = threading.Lock()

    for slot, dev in enumerate(devices):
        key = _device_key(dev)
        platform = getattr(dev, "platform", "?")
        if injector is not None and injector.is_device_wedged(getattr(dev, "id", -1)):
            entries[slot] = DeviceHealth(
                key, platform, WEDGED, 0.0, "injected device wedge"
            )
            continue
        entries[slot] = DeviceHealth(key, platform, WEDGED)  # until proven alive

        def _probe(slot=slot, dev=dev):
            t = clock()
            err = ""
            try:
                probe(dev)
            except Exception as e:  # a raising probe is a diagnosis
                err = f"{type(e).__name__}: {e}"
            with done_lock:
                done[slot] = (clock() - t, err)

        th = threading.Thread(target=_probe, daemon=True, name=f"probe-{key}")
        th.start()
        threads.append((slot, th))

    for slot, th in threads:
        remaining = deadline - (clock() - t0)
        if remaining > 0:
            th.join(remaining)
        with done_lock:
            outcome = done.get(slot)
        e = entries[slot]
        if outcome is None:
            e.probe_seconds = clock() - t0
            e.error = f"probe did not complete within {deadline:.0f}s"
        else:
            e.probe_seconds, e.error = outcome
            if not e.error:
                e.status = HEALTHY

    report_devices = [entries[i] for i in range(len(devices)) if i in entries]
    if expect_ids is not None:
        seen = {getattr(d, "id", None) for d in devices}
        for missing in sorted(set(int(i) for i in expect_ids) - seen):
            report_devices.append(
                DeviceHealth(
                    f"?:{missing}", "?", ABSENT, 0.0, "device not enumerated"
                )
            )

    if any(d.status == WEDGED for d in report_devices):
        status = WEDGED
    elif any(d.status == ABSENT for d in report_devices) or not report_devices:
        status = ABSENT
    else:
        status = HEALTHY
    return HealthReport(
        status=status,
        deadline_seconds=float(deadline),
        elapsed_seconds=clock() - t0,
        devices=report_devices,
        generated_at=time.time(),
    )


def _enumerate_devices(deadline: float, device_type: str = "cuda", clock=time.monotonic):
    """The devices of ``device_type`` on a bounded daemon thread (the first
    CUDA call initialises the driver, which can block on a wedged card).
    Returns (devices|None, error)."""
    box: dict = {}

    def _enum():
        try:
            if device_type == "cpu":
                box["devices"] = [ProbeDevice("cpu", 0)]
                return
            import torch

            box["devices"] = [
                ProbeDevice("gpu", i) for i in range(torch.cuda.device_count())
            ]
        except Exception as e:
            box["error"] = f"{type(e).__name__}: {e}"

    th = threading.Thread(target=_enum, daemon=True, name="device-enumeration")
    t0 = clock()
    th.start()
    th.join(deadline)
    if "devices" in box:
        return box["devices"], ""
    if "error" in box:
        return None, box["error"]
    return None, (
        f"device enumeration did not complete within {deadline:.0f}s "
        f"(driver wedged?); waited {clock() - t0:.1f}s"
    )


def probe_local(
    deadline: float | None = None,
    device_type: str = "cuda",
    injector=None,
    expect_ids=None,
    prober=None,
    clock=time.monotonic,
) -> HealthReport:
    """Enumerate the devices of ``device_type`` (bounded) and probe each
    (bounded, concurrent) in THIS process — what the probe child runs.
    Never raises and never blocks past ~deadline."""
    if deadline is None:
        deadline = default_deadline()
    t0 = clock()
    devices, enum_error = _enumerate_devices(deadline, device_type, clock=clock)
    if devices is None:
        return HealthReport(
            status=WEDGED,
            deadline_seconds=float(deadline),
            elapsed_seconds=clock() - t0,
            devices=[],
            generated_at=time.time(),
            error=enum_error,
        )
    remaining = max(0.5, deadline - (clock() - t0))
    report = probe_devices(
        devices,
        deadline=remaining,
        clock=clock,
        prober=prober,
        injector=injector,
        expect_ids=expect_ids,
    )
    report.elapsed_seconds = clock() - t0
    report.deadline_seconds = float(deadline)
    return report


def preflight(
    deadline: float | None = None,
    injector=None,
    record: bool = True,
    expect_ids=None,
    prober=None,
    clock=time.monotonic,
    device_type: str = "cuda",
) -> HealthReport:
    """The full bounded preflight: probe every device of ``device_type`` in
    a killable child interpreter (:func:`doctor_report`), publish
    ``katib_device_healthy`` gauges, record a ``preflight`` span in the
    ambient trace journal, and stash the report for ``status.json``.  An
    injected ``prober`` (tests) runs in this process instead, since a
    Python callable cannot cross into the child.  Never raises and never
    blocks past ~deadline plus the child's start-up grace."""
    from katib_tpu_torch.utils import observability as obs
    from katib_tpu_torch.utils import tracing

    if deadline is None:
        deadline = default_deadline()
    if prober is not None:
        report = probe_local(
            deadline, device_type, injector=injector, expect_ids=expect_ids,
            prober=prober, clock=clock,
        )
    else:
        report = doctor_report(
            deadline,
            simulate_wedge=injector.wedged_devices() if injector is not None else None,
            device_type=device_type,
            expect_ids=expect_ids,
            record=False,
        )
    for d in report.devices:
        obs.device_healthy.set(
            1.0 if d.status == HEALTHY else 0.0,
            device=d.device,
            platform=d.platform,
        )
    tracing.record_span(
        "preflight",
        report.elapsed_seconds,
        status=report.status,
        healthy=report.healthy_count,
        wedged=report.wedged_count,
        absent=report.absent_count,
    )
    if record:
        _record(report)
    return report


# -- subprocess isolation -----------------------------------------------------
#
# Threads bound the wait but cannot reclaim a thread stuck inside a wedged
# driver call, and a process that has initialised CUDA cannot fork a child
# that uses it.  So the probe runs in a fresh interpreter that prints the
# JSON line below; the parent enforces deadline+grace with SIGKILL.

_REPORT_TAG = "@@KATIB_HEALTH@@"
_SIMULATE_ENV = "KATIB_DOCTOR_SIMULATE_WEDGE"
_DEVICE_TYPE_ENV = "KATIB_PROBE_DEVICE_TYPE"
_EXPECT_ENV = "KATIB_PROBE_EXPECT_IDS"


def _ids_from_env(name: str) -> list[int]:
    return [int(p) for p in os.environ.get(name, "").split(",") if p.strip()]


def _doctor_child() -> None:
    """Child entrypoint: probe the devices, print the tagged report JSON,
    exit 0 healthy / 1 otherwise.  Reads the device type
    (``KATIB_PROBE_DEVICE_TYPE``), the expected ids and
    ``KATIB_DOCTOR_SIMULATE_WEDGE`` (comma-separated device ids) for
    deterministic wedged-device simulation."""
    import sys

    injector = None
    simulate = _ids_from_env(_SIMULATE_ENV)
    if simulate:
        from katib_tpu_torch.utils.faults import FaultInjector

        injector = FaultInjector(seed=0)
        for device_id in simulate:
            injector.wedge_device(device_id)
    expect = _ids_from_env(_EXPECT_ENV)
    report = probe_local(
        device_type=os.environ.get(_DEVICE_TYPE_ENV, "cuda"),
        injector=injector,
        expect_ids=expect or None,
    )
    print(_REPORT_TAG + json.dumps(report.to_dict()), flush=True)
    sys.exit(0 if report.ok() else 1)


def doctor_report(
    deadline: float | None = None,
    simulate_wedge=None,
    env: dict | None = None,
    device_type: str = "cuda",
    expect_ids=None,
    record: bool = True,
) -> HealthReport:
    """Parent side: run :func:`_doctor_child` in a fresh interpreter and
    parse its report.  A child that outlives deadline + grace is SIGKILLed
    and synthesized into a WEDGED report — the doctor itself can never
    hang."""
    import subprocess
    import sys

    if deadline is None:
        deadline = default_deadline()
    child_env = dict(os.environ if env is None else env)
    child_env[DEADLINE_ENV] = str(deadline)
    child_env[_DEVICE_TYPE_ENV] = device_type
    # the child must import the package the same way the parent did, even
    # when it was path-inserted rather than installed (the child inherits
    # cwd, not the parent's sys.path)
    pkg_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    existing = child_env.get("PYTHONPATH", "")
    if pkg_root not in existing.split(os.pathsep):
        child_env["PYTHONPATH"] = (
            pkg_root + (os.pathsep + existing if existing else "")
        )
    if simulate_wedge:
        child_env[_SIMULATE_ENV] = ",".join(str(int(i)) for i in simulate_wedge)
    else:
        child_env.pop(_SIMULATE_ENV, None)
    if expect_ids:
        child_env[_EXPECT_ENV] = ",".join(str(int(i)) for i in expect_ids)
    else:
        child_env.pop(_EXPECT_ENV, None)
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [
            sys.executable,
            "-c",
            "from katib_tpu_torch.utils.meshhealth import _doctor_child; _doctor_child()",
        ],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
        env=child_env,
    )
    grace = 30.0  # interpreter start + torch import on top of the probe deadline
    try:
        out, err = proc.communicate(timeout=deadline + grace)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        return HealthReport(
            status=WEDGED,
            deadline_seconds=float(deadline),
            elapsed_seconds=time.monotonic() - t0,
            devices=[],
            generated_at=time.time(),
            error=(
                "device runtime did not respond within "
                f"{deadline + grace:.0f}s (probe child killed)"
            ),
        )
    for line in (out or "").splitlines():
        if line.startswith(_REPORT_TAG):
            try:
                d = json.loads(line[len(_REPORT_TAG):])
            except ValueError:
                continue
            report = HealthReport(
                status=d.get("status", WEDGED),
                deadline_seconds=float(d.get("deadline_seconds", deadline)),
                elapsed_seconds=float(d.get("elapsed_seconds", 0.0)),
                devices=[
                    DeviceHealth(
                        device=e.get("device", "?"),
                        platform=e.get("platform", "?"),
                        status=e.get("status", WEDGED),
                        probe_seconds=float(e.get("probe_seconds", 0.0)),
                        error=e.get("error", ""),
                    )
                    for e in d.get("devices", [])
                ],
                generated_at=float(d.get("generated_at", 0.0)),
                error=d.get("error", ""),
            )
            if record:
                _record(report)
            return report
    tail = (err or "").strip().splitlines()
    return HealthReport(
        status=WEDGED,
        deadline_seconds=float(deadline),
        elapsed_seconds=time.monotonic() - t0,
        devices=[],
        generated_at=time.time(),
        error=(
            f"probe child exited rc={proc.returncode} without a report"
            + (f" ({tail[-1]})" if tail else "")
        ),
    )
