"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit) when it fails:

1. the card's name and power limit, torch and CUDA versions;
2. build every CUDA kernel of the port from the sources in this checkout
   (one ``nvcc`` per source, all started together);
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, forward and gradient;
4. time each kernel, its plain version and the one PyTorch call that
   computes the same function, beside the least time the card could take;
5. drive the main path: ``darts_trial`` through ``TrialContext`` at the DARTS
   search width (8 cells, 16 channels, 4 nodes, the 8 default primitives,
   batch 64, bf16), with each kernel's launch count set to 0 just before
   and read just after; then a small f32 supernet on the card against the
   same weights on the CPU.

Its last three lines are the ``{"kernels": [...]}`` JSON line, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": {...}}``.
The script needs a CUDA GPU and the ``katib_tpu_torch`` package beside it,
and exits nonzero without printing a result when either is missing.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, launches: int = 20, reps: int = 21) -> float:
    """Device time of one ``fn()`` in ms: ``launches`` calls captured in a
    CUDA graph, the graph replayed ``reps`` times between CUDA events, the
    median replay divided by ``launches``.  Replaying keeps the host's
    per-call cost (Python, the wrapper's checks) out of the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def bf16_within_one_ulp(got, want) -> bool:
    """``|got - want| <= one bf16 spacing at want`` element-wise."""
    import torch

    want32 = want.float()
    _, exp = torch.frexp(want32)
    spacing = torch.ldexp(torch.ones_like(want32), exp - 8)  # 8 significant bits
    spacing = torch.clamp(spacing, min=torch.finfo(torch.bfloat16).tiny)
    return bool(((got.float() - want32).abs() <= spacing).all())


def phase_kernel_parity(torch, mixed_op) -> float:
    """Kernel vs plain version, forward and gradient; returns the largest
    forward error seen."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for e in (1, 5):
            for n_ops in (3, 8):
                for m in (1_048_576, 1_000_003):
                    w = torch.softmax(torch.randn(e, n_ops, device="cuda", generator=gen), -1)
                    x = torch.randn(e, n_ops, m, device="cuda", generator=gen).to(dtype)
                    got = mixed_op.mixed_op_sum(w, x)
                    want = mixed_op.mixed_op_sum_reference(w, x)
                    torch.cuda.synchronize()
                    check(got.shape == (e, m) and got.dtype == dtype, "output shape/dtype")
                    err = float((got.float() - want.float()).abs().max())
                    worst = max(worst, err)
                    if dtype == torch.float32:
                        ok = err <= 1e-5
                    else:
                        ok = bf16_within_one_ulp(got, want)
                    print(f"parity {str(dtype):15s} E={e} n_ops={n_ops} M={m}: "
                          f"max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
                    check(ok, f"mixed_op_sum disagrees with its plain version ({dtype}, E={e}, "
                              f"n_ops={n_ops}, M={m}, err {err})")
    # gradients through the autograd Function vs autograd of the plain version
    for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        w = torch.softmax(torch.randn(5, 8, device="cuda", generator=gen), -1)
        x = torch.randn(5, 8, 1_048_576, device="cuda", generator=gen).to(dtype)
        g = torch.randn(5, 1_048_576, device="cuda", generator=gen).to(dtype)
        grads = []
        for fn in (mixed_op.mixed_op_sum, mixed_op.mixed_op_sum_reference):
            wi, xi = w.clone().requires_grad_(), x.clone().requires_grad_()
            fn(wi, xi).backward(g)
            grads.append((wi.grad, xi.grad))
        (dw_k, dx_k), (dw_p, dx_p) = grads
        dw_err = float((dw_k - dw_p).abs().max() / dw_p.abs().max())
        dx_err = float((dx_k.float() - dx_p.float()).abs().max())
        print(f"grad parity {dtype}: dw rel {dw_err:.3e}  dx abs {dx_err:.3e}", flush=True)
        check(dw_err <= 1e-5 and dx_err <= atol, f"mixed_op_sum gradient disagrees ({dtype})")
    return worst


def phase_kernel_timing(torch, mixed_op) -> dict:
    """Times at the stage-1 edge group of a normal cell (E=5, n_ops=8,
    M = 64*16*32*32, bf16)."""
    e, n_ops, m = 5, 8, 64 * 16 * 32 * 32
    gen = torch.Generator(device="cuda").manual_seed(1)
    w = torch.softmax(torch.randn(e, n_ops, device="cuda", generator=gen), -1)
    x = torch.randn(e, n_ops, m, device="cuda", generator=gen).to(torch.bfloat16)
    w_lib = w.to(torch.bfloat16)
    kernel_ms = cuda_ms(lambda: mixed_op.mixed_op_sum(w, x))
    plain_ms = cuda_ms(lambda: mixed_op.mixed_op_sum_reference(w, x))
    library_ms = cuda_ms(lambda: torch.einsum("eo,eom->em", w_lib, x))
    moved = (x.numel() + e * m) * x.element_size() + w.numel() * w.element_size()
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * e * n_ops * m / F32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"timing E={e} n_ops={n_ops} M={m} bf16: kernel_ms={kernel_ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} "
          f"({moved / 1e6:.1f} MB at 3.35 TB/s; {bytes_ms / kernel_ms:.0%} of the bound)",
          flush=True)
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_main_path(torch, mixed_op) -> int:
    """``darts_trial`` at the search width; returns the mixed-op launches."""
    from katib_tpu_torch.nas.darts.model import mixed_op_launches_per_forward
    from katib_tpu_torch.nas.darts.ops import DEFAULT_PRIMITIVES
    from katib_tpu_torch.nas.darts.search import darts_trial
    from katib_tpu_torch.runner.context import TrialContext

    settings = {
        "batch_size": 64, "init_channels": 16, "num_nodes": 4, "num_epochs": 1,
        "n_train": 1024, "n_test": 1024, "remat": "false",
    }
    num_layers, n_nodes = 8, 4
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as out_dir:
        ctx = TrialContext(
            {
                "algorithm-settings": json.dumps(settings),
                "search-space": json.dumps(list(DEFAULT_PRIMITIVES)),
                "num-layers": str(num_layers),
            },
            checkpoint_dir=out_dir,
            device="cuda",
            step_times=[],
        )
        torch.cuda.reset_peak_memory_stats()
        mixed_op.launches = 0
        t0 = time.perf_counter()
        darts_trial(ctx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = mixed_op.launches
        with open(os.path.join(out_dir, "genotype.json")) as f:
            genotype = json.load(f)

    steps = (settings["n_train"] // 2) // settings["batch_size"]
    # second order, no remat: grad_w, val grads, 2 finite-difference
    # passes, the weight step; plus one evaluation forward
    predicted = (steps * 5 + 1) * mixed_op_launches_per_forward(num_layers, n_nodes)
    times = ctx.step_times
    print(f"main path: darts_trial 8 layers x 16 ch x 4 nodes, 8 primitives, batch 64, bf16, "
          f"{steps} second-order steps + eval in {wall:.2f}s", flush=True)
    print(f"main path: step_s first={times[0]:.4f} rest={[round(t, 4) for t in times[1:]]} "
          f"median_rest={statistics.median(times[1:]):.4f} "
          f"steps_per_s={1 / statistics.median(times[1:]):.3f} "
          f"images_per_s={settings['batch_size'] / statistics.median(times[1:]):.1f}", flush=True)
    print(f"main path: max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    print(f"main path: reports={ctx.reports}", flush=True)
    print(f"main path: mixed_op launches={launches} predicted={predicted}", flush=True)
    check(len(times) == steps, f"expected {steps} steps, timed {len(times)}")
    check(len(ctx.reports) == 1, "one report per epoch")
    (step, metrics), = ctx.reports
    check(step == 0 and all(math.isfinite(v) for v in metrics.values()), "finite metrics")
    check(0.0 <= metrics["accuracy"] <= 1.0, "accuracy in [0, 1]")
    check(len(genotype["normal"]) == n_nodes and len(genotype["reduce"]) == n_nodes,
          "genotype has one entry per node")
    check(all(op in DEFAULT_PRIMITIVES and op != "none" for node in genotype["normal"]
              + genotype["reduce"] for op, _ in node), "genotype ops are primitives")
    check(launches == predicted and launches > 0,
          f"mixed-op kernel launched {launches} times, the path predicts {predicted}")
    return launches


def phase_small_reference(torch) -> None:
    """A small f32 supernet step on the card against the same weights on
    the CPU (plain mixed-op version there): logits and gradients agree."""
    from katib_tpu_torch.nas.darts.model import DartsNetwork, init_alphas
    from katib_tpu_torch.parallel.train import cross_entropy_loss

    gen = torch.Generator().manual_seed(3)
    net = DartsNetwork(init_channels=4, num_layers=3, n_nodes=2, num_classes=4,
                       remat=False, dtype=torch.float32)
    net.reset_parameters(gen)
    alphas = init_alphas(2, 8, gen, scale=0.5)
    x = torch.randn(8, 16, 16, 3, generator=gen)
    y = torch.randint(0, 4, (8,), generator=gen)
    results = []
    for dev in ("cpu", "cuda"):
        w = {k: v.detach().to(dev).requires_grad_() for k, v in net.named_parameters()}
        a = [t.to(dev).requires_grad_() for t in alphas]
        logits = torch.func.functional_call(net.to(dev), w, (x.to(dev), type(alphas)(*a)))
        grads = torch.autograd.grad(cross_entropy_loss(logits, y.to(dev)), [*w.values(), *a])
        results.append((logits.detach().cpu(), [g.cpu() for g in grads]))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = results
    logit_err = float((l_cpu - l_gpu).abs().max())
    grad_err = max(float((a - b).abs().max() / (a.abs().max() + 1e-12)) for a, b in zip(g_cpu, g_gpu))
    print(f"small f32 supernet, card vs CPU: logits max_abs_err={logit_err:.3e} "
          f"grads max_rel_err={grad_err:.3e}", flush=True)
    check(logit_err <= 1e-4 and grad_err <= 1e-3, "small supernet disagrees between card and CPU")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    from katib_tpu_torch.ops import _build, mixed_op

    # every f32 comparison below runs in full f32 (cuDNN convs default to TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = smi_line()
    print(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    built = _build.build(["mixed_op"])
    print(f"build: {built} ({time.perf_counter() - t0:.2f}s wall)", flush=True)

    max_err = phase_kernel_parity(torch, mixed_op)
    timing = phase_kernel_timing(torch, mixed_op)
    launches = phase_main_path(torch, mixed_op)
    phase_small_reference(torch)

    kernels = [{
        "name": "mixed_op_sum",
        "route": "cuda",
        "source": "katib_tpu_torch/ops/csrc/mixed_op.cu",
        "replaces": "katib_tpu/ops/mixed_op.py:71",
        "launches": launches,
        "max_abs_err": max_err,
        **timing,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
