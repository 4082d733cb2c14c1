"""Where one bilevel search step spends its time on the GPU.

    python3 -m katib_tpu_torch.nas.darts.profile [--steps N] [--trace PATH]

Builds the search at the DARTS search width (8 cells, 16 channels, 4 nodes,
the 8 default primitives, batch 64, bf16, second order, no remat), takes
warm-up steps, times steps with a device sync, then traces steps with
``torch.profiler`` and prints: the step's wall time with and without the
profiler, the device time summed over kernels and its share of the wall
time, the number of kernels and of host-side operator calls per step, the
kernels that take the most device time, and the host operators that take
the most host time.  ``--trace`` also writes the Chrome trace there.
Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import statistics
import time


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from katib_tpu_torch.device import resolve_device
    from katib_tpu_torch.models.data import load_cifar10
    from katib_tpu_torch.nas.darts.architect import DartsHyper, init_search_state, make_search_step
    from katib_tpu_torch.nas.darts.model import DartsNetwork, init_alphas
    from katib_tpu_torch.nas.darts.ops import DEFAULT_PRIMITIVES
    from katib_tpu_torch.nas.darts.search import split_train
    from katib_tpu_torch.parallel.train import cross_entropy_loss

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2, help="steps timed, then steps traced")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", help="write the Chrome trace here")
    args = ap.parse_args()

    dev = resolve_device("cuda")
    batch = args.batch
    dataset = load_cifar10(n_train=2 * batch, n_test=8)
    (x_w, y_w), (x_a, y_a) = split_train(dataset, seed=0)
    train = (torch.from_numpy(x_w[:batch]).to(dev), torch.from_numpy(y_w[:batch]).to(dev))
    val = (torch.from_numpy(x_a[:batch]).to(dev), torch.from_numpy(y_a[:batch]).to(dev))
    net = DartsNetwork(DEFAULT_PRIMITIVES, init_channels=16, num_layers=8, n_nodes=4,
                       num_classes=10, remat=False, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    net.reset_parameters(gen)
    alphas = init_alphas(4, len(DEFAULT_PRIMITIVES), gen)
    net.to(dev)

    def loss_fn(w, a, b):
        return cross_entropy_loss(torch.func.functional_call(net, w, (b[0], a)), b[1])

    hyper = DartsHyper(total_steps=1000)
    step = make_search_step(loss_fn, hyper)
    state = init_search_state(
        {k: v.detach() for k, v in net.named_parameters()},
        type(alphas)(*(a.to(dev) for a in alphas)), hyper,
    )

    def run(n):
        nonlocal state
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            state, _ = step(state, train, val)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return times

    run(args.warmup)
    plain = run(args.steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = run(args.steps)
    if args.trace:
        prof.export_chrome_trace(args.trace)

    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels) / args.steps
    n_kernels = sum(e.count for e in kernels) / args.steps
    host_ops = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
                and e.key.startswith("aten::")]
    n_host_ops = sum(e.count for e in host_ops) / args.steps
    wall_s = statistics.median(plain)
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}")
    print(f"step wall_s median={wall_s:.4f} (runs {[round(t, 4) for t in plain]}); "
          f"under the profiler {statistics.median(traced):.4f}")
    print(f"per step: device kernel time {device_us / 1e3:.2f} ms = "
          f"{device_us / 1e6 / wall_s:.1%} of the unprofiled wall time; "
          f"{n_kernels:.0f} kernels; {n_host_ops:.0f} aten operator calls "
          f"({wall_s / max(n_host_ops, 1) * 1e6:.1f} us of wall per call)")
    print(f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    mixed = [e for e in kernels if "mixed_op" in e.key]
    mixed_us = sum(e.self_device_time_total for e in mixed) / args.steps
    print(f"mixed-op kernel: {mixed_us / 1e3:.3f} ms per step over "
          f"{sum(e.count for e in mixed) / args.steps:.0f} launches "
          f"= {mixed_us / max(device_us, 1e-9):.1%} of device kernel time")
    print(f"top {args.top} kernels by device time per step:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[: args.top]:
        print(f"  {e.self_device_time_total / args.steps / 1e3:9.3f} ms "
              f"{e.count / args.steps:7.0f}x  {e.key[:110]}")
    print(f"top {args.top} host operators by self host time per step:")
    for e in sorted(host_ops, key=lambda e: -e.self_cpu_time_total)[: args.top]:
        print(f"  {e.self_cpu_time_total / args.steps / 1e3:9.3f} ms "
              f"{e.count / args.steps:7.0f}x  {e.key}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
