"""Where one training step spends its time on the GPU.

``profile_step`` times a step function with a device sync, traces more
steps with ``torch.profiler`` and prints the step's wall time with and
without the profiler, the device time summed over kernels and its share of
the wall time, the number of kernels and of host-side operator calls per
step, the named kernels' device time and launches, and the kernels and
host operators that take the most time.  Used by the profile modules of
each trial (``python3 -m katib_tpu_torch.nas.darts.profile``,
``python3 -m katib_tpu_torch.models.profile``).
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, NamedTuple, Sequence


class StepProfile(NamedTuple):
    """What :func:`profile_step` measured, per call of the step function."""

    wall_s: float  # the median untraced call's wall seconds
    busy: float  # CUDA kernel time per call under the profiler / wall_s
    kernels: float  # CUDA kernels per call
    host_ops: float  # aten operator calls per call (nested calls included)


def profile_step(
    step: Callable[[], object],
    *,
    steps: int,
    warmup: int,
    kernel_names: Sequence[str],
    top: int,
    trace: str | None = None,
    substeps: int = 1,
) -> StepProfile:
    """Run ``warmup`` calls of ``step``, time ``steps`` calls, trace
    ``steps`` more and print the summary; ``trace`` also writes the Chrome
    trace there.  A call that runs ``substeps`` training steps (an epoch of
    replays, say) has its kernels, operator calls and times also printed per
    training step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def run(n):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return times

    run(warmup)
    plain = run(steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = run(steps)
    if trace:
        prof.export_chrome_trace(trace)

    events = prof.key_averages()
    # a range such as the optimizer's step annotation also shows on the
    # device timeline; it spans kernels counted on their own, so it is no kernel
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    device_us = sum(e.self_device_time_total for e in kernels) / steps
    n_kernels = sum(e.count for e in kernels) / steps
    host_ops = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
                and e.key.startswith("aten::")]
    n_host_ops = sum(e.count for e in host_ops) / steps
    wall_s = statistics.median(plain)
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}")
    print(f"step wall_s median={wall_s:.4f} (runs {[round(t, 4) for t in plain]}); "
          f"under the profiler {statistics.median(traced):.4f}")
    print(f"per step: device kernel time {device_us / 1e3:.2f} ms = "
          f"{device_us / 1e6 / wall_s:.1%} of the unprofiled wall time; "
          f"{n_kernels:.0f} kernels; {n_host_ops:.0f} aten operator calls "
          f"({wall_s / max(n_host_ops, 1) * 1e6:.1f} us of wall per call)")
    if substeps > 1:
        print(f"per training step ({substeps} a call): wall {wall_s / substeps * 1e3:.4f} ms, "
              f"device kernel time {device_us / substeps / 1e3:.4f} ms, "
              f"{n_kernels / substeps:.1f} kernels, {n_host_ops / substeps:.1f} aten operator "
              "calls")
    print(f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in kernel_names:
        mine = [e for e in kernels if name in e.key]
        us = sum(e.self_device_time_total for e in mine) / steps
        print(f"{name}: {us / 1e3:.3f} ms per step over "
              f"{sum(e.count for e in mine) / steps:.0f} launches "
              f"= {us / max(device_us, 1e-9):.1%} of device kernel time")
    print(f"top {top} kernels by device time per step:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / steps / 1e3:9.3f} ms "
              f"{e.count / steps:7.0f}x  {e.key[:110]}")
    print(f"top {top} host operators by self host time per step:")
    for e in sorted(host_ops, key=lambda e: -e.self_cpu_time_total)[:top]:
        print(f"  {e.self_cpu_time_total / steps / 1e3:9.3f} ms "
              f"{e.count / steps:7.0f}x  {e.key}")
    return StepProfile(wall_s, device_us / 1e6 / wall_s, n_kernels, n_host_ops)
