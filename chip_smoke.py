"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit) when it fails:

1. the card's name and power limit, torch and CUDA versions;
2. build every CUDA kernel of the port from the sources in this checkout
   (one ``nvcc`` per source, all started together), print each kernel's
   registers and fail if any spills;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it, forward and gradient;
4. time each kernel, its plain version and the one PyTorch call that
   computes the same function, beside the least time the card could take;
5. drive the first main path: ``darts_trial`` through ``TrialContext`` at
   the DARTS search width (8 cells, 16 channels, 4 nodes, the 8 default
   primitives, batch 64, bf16), with the mixed-op launch count set to 0 just
   before and read just after; then a small f32 supernet on the card
   against the same weights on the CPU;
6. drive the second main path: ``transformer_trial`` at the long-context
   width (vocab 256, d_model 512, 8 heads, 4 layers, seq 4096, batch 4,
   bf16) for 10 steps, with the three flash-attention launch counts set to
   0 just before and read just after.

Its last three lines are the ``{"kernels": [...]}`` JSON line, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": {...}}``.
The script needs a CUDA GPU and the ``katib_tpu_torch`` package beside it,
and exits nonzero without printing a result when either is missing.
"""

from __future__ import annotations

import functools
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
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores

TRANSFORMER_STEPS = 10  # steps of the transformer main path
# the float32-FMA bf16 kernels that the tensor-core ones replaced, at the main
# path's attention shape on an H100 SXM at 700 W (PERF.md section 6)
FMA_FORWARD_MS = 3.5548
FMA_BACKWARD_MS = {"dq": 6.4359, "dkv": 6.5682}

def long_context() -> tuple[dict, tuple[int, int, int, int]]:
    """The transformer main path's ``transformer_trial`` parameters (the
    repo's long-context configuration) and its attention's shape
    ``[batch, heads, seq, d_head]``, bf16, causal."""
    from katib_tpu_torch.models.transformer import LONG_CONTEXT as c

    return c, (c["batch_size"], c["n_heads"], c["seq_len"], c["d_model"] // c["n_heads"])


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


def event_ms(fn, iters: int = 5, reps: int = 5) -> float:
    """Device time of one ``fn()`` in ms for calls that autograd or large
    temporaries keep out of a CUDA graph: ``iters`` calls between CUDA
    events, the median of ``reps`` such runs divided by ``iters``.  At the
    millisecond scale of these calls the host enqueues ahead of the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bf16_spacing(want32):
    """One bf16 spacing (8 significant bits) at each float32 value of
    ``want32``, at least bf16's smallest normal."""
    import torch

    _, exp = torch.frexp(want32)
    spacing = torch.ldexp(torch.ones_like(want32), exp - 8)
    return torch.clamp(spacing, min=torch.finfo(torch.bfloat16).tiny)


def bf16_within_one_ulp(got, want) -> bool:
    """``|got - want| <= one bf16 spacing at want`` element-wise."""
    want32 = want.float()
    return bool(((got.float() - want32).abs() <= bf16_spacing(want32)).all())


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


def flash_close(got, want, mask_value: float) -> tuple[bool, float]:
    """Kernel output against its plain version's float32 value on the same
    inputs.  Entries where the plain value is ``mask_value`` (the lse of a
    row that sees no key) must be exactly that; the others, with ``top``
    their largest magnitude: float32 within 1e-5 of max(1, top), as the two
    differ only in summation order and exp's last bits; bfloat16 within one
    bf16 spacing at the plain value (the kernel rounds its float32 result
    once, half a spacing) plus 1e-5 of top for the same float32 noise where
    sums cancel.  Returns (ok, max abs error over the visible entries)."""
    import torch

    want32, got32 = want.float(), got.float()
    masked = want32 <= mask_value / 2
    if not bool((got32[masked] == want32[masked]).all()):
        return False, math.inf
    diff = torch.where(masked, 0.0, (got32 - want32).abs())
    err = float(diff.max())
    top = float(torch.where(masked, 0.0, want32.abs()).max())
    if got.dtype == torch.float32:
        return err <= 1e-5 * max(1.0, top), err
    return bool((diff <= bf16_spacing(want32) + 1e-5 * top).all()), err


def phase_flash_parity(torch, fa) -> dict[str, float]:
    """Each flash kernel against its plain version on the same inputs
    (forward: o and lse; dq and dk/dv from the kernel's own lse and a dmd
    with a nonzero lse cotangent), then the kernels through autograd
    against autograd of the plain forward.  Returns each kernel's largest
    error."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [(2, 4, 1024, 1024, 64), (2, 4, 512, 1024, 32), (2, 4, 1000, 300, 64),
              (1, 2, 77, 77, 32), (1, 2, 256, 192, 128)]
    cases = [(causal, dtype, shape) for shape in shapes for causal in (True, False)
             for dtype in (f32, bf16)]
    b, h, s, d = long_context()[1]
    cases.append((True, bf16, (b, h, s, s, d)))  # the main path's own
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for causal, dtype, (b, h, sq, sk, d) in cases:
        q = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(dtype)
        k, v = (torch.randn(b, h, sk, d, device="cuda", generator=gen).to(dtype) for _ in range(2))
        do = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(dtype)
        dlse = torch.randn(b, h, sq, device="cuda", generator=gen)
        scale = d ** -0.5
        o, lse = fa.launch_fwd(q, k, v, causal, scale)
        dmd = ((do.float() * o.float()).sum(-1) - dlse).contiguous()
        dq = fa.launch_dq(q, k, v, do, lse, dmd, causal, scale)
        dk, dv = fa.launch_dkv(q, k, v, do, lse, dmd, causal, scale)
        torch.cuda.synchronize()
        check(o.dtype == dtype and lse.shape == (b, h, sq) and dk.dtype == dtype,
              "flash output shapes and dtypes")
        x32 = [t.float() for t in (q, k, v, do)]
        o_ref, lse_ref = fa.reference_attention_with_lse(*x32[:3], causal, scale)
        close = functools.partial(flash_close, mask_value=fa.MASK_VALUE)
        results = {"o": close(o, o_ref), "lse": close(lse, lse_ref),
                   "dq": close(dq, fa.reference_attention_dq(*x32, lse, dmd, causal, scale))}
        dk_ref, dv_ref = fa.reference_attention_dkv(*x32, lse, dmd, causal, scale)
        results["dk"], results["dv"] = close(dk, dk_ref), close(dv, dv_ref)
        if causal and sq > sk:  # the first sq - sk rows see no key
            check(bool((o[:, :, : sq - sk] == 0).all())
                  and bool((lse[:, :, : sq - sk] == fa.MASK_VALUE).all()),
                  f"fully masked rows must give o 0 and lse {fa.MASK_VALUE} ({dtype})")
        worst["fwd"] = max(worst["fwd"], results["o"][1], results["lse"][1])
        worst["dq"] = max(worst["dq"], results["dq"][1])
        worst["dkv"] = max(worst["dkv"], results["dk"][1], results["dv"][1])
        ok = all(r[0] for r in results.values())
        print(f"flash parity {str(dtype):14s} causal={causal!s:5} B={b} H={h} Sq={sq} Sk={sk} "
              f"D={d}: " + " ".join(f"{n} {e:.2e}" for n, (_, e) in results.items())
              + f" {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"flash kernels disagree with their plain versions ({dtype}, causal={causal}, "
                  f"{(b, h, sq, sk, d)}): {results}")
        del o_ref, dk_ref, dv_ref, results
    # through autograd, with an lse cotangent, against autograd of the plain forward
    for causal, (b, h, sq, sk, d) in [(True, (2, 4, 512, 1024, 32)), (True, (1, 2, 384, 256, 64)),
                                      (False, (2, 2, 256, 256, 64))]:
        x = [torch.randn(b, h, n, d, device="cuda", generator=gen) for n in (sq, sk, sk)]
        do = torch.randn(b, h, sq, d, device="cuda", generator=gen)
        dlse = torch.randn(b, h, sq, device="cuda", generator=gen)
        grads = []
        for fn in (fa.flash_attention_with_lse, fa.reference_attention_with_lse):
            leaves = [t.clone().requires_grad_() for t in x]
            o, lse = fn(*leaves, causal)
            torch.autograd.backward([o, lse], [do, dlse])
            grads.append([t.grad for t in leaves])
        errs = [flash_close(g, w, fa.MASK_VALUE) for g, w in zip(*grads)]
        print(f"flash autograd vs plain autograd f32 causal={causal} {(b, h, sq, sk, d)}: "
              f"dq {errs[0][1]:.2e} dk {errs[1][1]:.2e} dv {errs[2][1]:.2e}", flush=True)
        check(all(ok for ok, _ in errs), "flash gradients through autograd disagree")
    return worst


def phase_flash_timing(torch, fa) -> dict[str, dict]:
    """Times at the main path's attention shape, bf16 causal."""
    import torch.nn.functional as F

    b, h, s, d = long_context()[1]
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, do = (torch.randn(b, h, s, d, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    scale = d ** -0.5
    o, lse = fa.launch_fwd(q, k, v, True, scale)
    dmd = (do.float() * o.float()).sum(-1)
    ms = {
        "fwd": cuda_ms(lambda: fa.launch_fwd(q, k, v, True, scale), launches=5, reps=11),
        "dq": cuda_ms(lambda: fa.launch_dq(q, k, v, do, lse, dmd, True, scale), launches=5, reps=11),
        "dkv": cuda_ms(lambda: fa.launch_dkv(q, k, v, do, lse, dmd, True, scale),
                       launches=5, reps=11),
    }
    plain = {
        "fwd": event_ms(lambda: fa.reference_attention_with_lse(q, k, v, True, scale), 2, 3),
        "dq": event_ms(lambda: fa.reference_attention_dq(q, k, v, do, lse, dmd, True, scale), 2, 3),
        "dkv": event_ms(lambda: fa.reference_attention_dkv(q, k, v, do, lse, dmd, True, scale),
                        2, 3),
    }
    # the library's fused attention (top-left causal mask = the port's at Sq == Sk):
    # timed as a yardstick, never called by the port
    sdpa_fwd = event_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 10, 5)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    sdpa_o = F.scaled_dot_product_attention(*leaves, is_causal=True)
    sdpa_bwd = event_ms(lambda: torch.autograd.grad(sdpa_o, leaves, do, retain_graph=True), 10, 5)
    library = {"fwd": sdpa_fwd, "dq": sdpa_bwd, "dkv": sdpa_bwd}

    pairs = b * h * s * (s + 1) // 2  # visible (query, key) pairs under the causal mask
    n, rows = b * h * s * d, b * h * s
    work = {  # (flops: products x 2*D per pair, bytes: each input read once, each output once)
        "fwd": (2 * 2 * d * pairs, 4 * n * 2 + 4 * rows),
        "dq": (3 * 2 * d * pairs, 5 * n * 2 + 2 * 4 * rows),
        "dkv": (4 * 2 * d * pairs, 6 * n * 2 + 2 * 4 * rows),
    }
    out = {}
    for name, (flops, moved) in work.items():
        ops_ms, bytes_ms = flops / BF16_FLOPS * 1e3, moved / HBM_BYTES_PER_S * 1e3
        out[name] = {"ms": ms[name], "plain_ms": plain[name], "library_ms": library[name],
                     "bound_ms": max(ops_ms, bytes_ms),
                     "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
        fma_ms = {"fwd": FMA_FORWARD_MS, **FMA_BACKWARD_MS}[name]
        earlier = f"; {fma_ms / ms[name]:.2f}x faster than the float32-FMA design's {fma_ms:.4f} ms"
        print(f"flash timing {name} {[b, h, s, d]} bf16 causal: kernel_ms={ms[name]:.4f} "
              f"plain_ms={plain[name]:.4f} library_ms={library[name]:.4f} "
              f"bound_ms={out[name]['bound_ms']:.4f} ({flops / 1e9:.1f} GFLOP at 989 TFLOP/s, "
              f"{moved / 1e6:.1f} MB at 3.35 TB/s; {out[name]['bound_ms'] / ms[name]:.1%} of the "
              f"bound; {flops / ms[name] / 1e9:.1f} TFLOP/s{earlier})", flush=True)
    print(f"flash timing: library forward {sdpa_fwd:.4f} ms vs kernel fwd {ms['fwd']:.4f} ms "
          f"({ms['fwd'] / sdpa_fwd:.1f}x; the float32-FMA forward {FMA_FORWARD_MS:.4f} ms)",
          flush=True)
    pair = ms["dq"] + ms["dkv"]
    print(f"flash timing: library backward (dq+dk+dv in one call) {sdpa_bwd:.4f} ms vs "
          f"kernels dq+dkv {pair:.4f} ms ({pair / sdpa_bwd:.1f}x; the float32-FMA pair "
          f"{sum(FMA_BACKWARD_MS.values()):.4f} ms)", flush=True)
    return out


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


def phase_transformer(torch, fa, kernel_ms: float) -> dict[str, int]:
    """``transformer_trial`` at the long-context width; returns the flash
    launches.  ``kernel_ms``: one forward + dq + dk/dv at its attention
    shape, to set beside the step time."""
    from katib_tpu_torch.models import transformer_trial
    from katib_tpu_torch.runner.context import TrialContext

    params = {**long_context()[0], "steps": TRANSFORMER_STEPS}
    layers, steps, batch = params["n_layers"], params["steps"], params["batch_size"]
    ctx = TrialContext({k: str(v) for k, v in params.items()}, device="cuda", step_times=[])
    torch.cuda.reset_peak_memory_stats()
    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
    t0 = time.perf_counter()
    transformer_trial(ctx)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fwd": fa.fwd_launches, "dq": fa.dq_launches, "dkv": fa.dkv_launches}

    # train_lm evaluates after step 0 and every 10th step, and after the last
    evals = sum(1 for s in range(steps) if s % 10 == 0 or s == steps - 1)
    predicted = {"fwd": layers * (steps + evals), "dq": layers * steps, "dkv": layers * steps}
    times = ctx.step_times
    median = statistics.median(times[1:])
    width = ", ".join(f"{k} {v}" for k, v in params.items())
    print(f"main path 2: transformer_trial {width}, bf16: {steps} steps + {evals} evaluations "
          f"in {wall:.2f}s", flush=True)
    print(f"main path 2: step_s first={times[0]:.4f} rest={[round(t, 4) for t in times[1:]]} "
          f"median_rest={median:.4f} tokens_per_s={batch * params['seq_len'] / median:.0f}",
          flush=True)
    print(f"main path 2: attention kernels {layers} x {kernel_ms:.3f} ms = "
          f"{layers * kernel_ms:.2f} ms per step = {layers * kernel_ms / 1e3 / median:.1%} of the "
          f"median step", flush=True)
    print(f"main path 2: max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    print(f"main path 2: reports={ctx.reports}", flush=True)
    print(f"main path 2: flash launches={launches} predicted={predicted}", flush=True)
    check(len(times) == steps, f"expected {steps} steps, timed {len(times)}")
    check(len(ctx.reports) == evals, f"expected {evals} reports, got {len(ctx.reports)}")
    check(all(math.isfinite(v) for _, m in ctx.reports for v in m.values()), "finite losses")
    first, last = ctx.reports[0][1]["eval_loss"], ctx.reports[-1][1]["eval_loss"]
    check(last < first, f"eval_loss did not fall: {first} -> {last}")
    check(launches == predicted, f"flash kernels launched {launches}, the path predicts {predicted}")
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
    from katib_tpu_torch.ops import flash_attention as fa

    # every f32 comparison below runs in full f32 (cuDNN convs default to TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = smi_line()
    print(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    t_start = t0 = time.perf_counter()
    built = _build.build(["mixed_op", "flash_attention"])
    print(f"build: {built} ({time.perf_counter() - t0:.2f}s wall)", flush=True)
    for name in built:
        for kernel, (registers, spilled) in _build.ptxas_report(name).items():
            print(f"ptxas {kernel}: {registers} registers, {spilled} bytes spilled", flush=True)
            # the flash kernels keep their fragments and accumulators in registers
            check(name != "flash_attention" or spilled == 0, f"{kernel} spills {spilled} bytes")

    max_err = phase_kernel_parity(torch, mixed_op)
    flash_err = phase_flash_parity(torch, fa)
    timing = phase_kernel_timing(torch, mixed_op)
    flash_timing = phase_flash_timing(torch, fa)
    launches = phase_main_path(torch, mixed_op)
    phase_small_reference(torch)
    flash_launches = phase_transformer(
        torch, fa, sum(t["ms"] for t in flash_timing.values()))

    kernels = [{
        "name": "mixed_op_sum",
        "route": "cuda",
        "source": "katib_tpu_torch/ops/csrc/mixed_op.cu",
        "replaces": "katib_tpu/ops/mixed_op.py:71",
        "launches": launches,
        "max_abs_err": max_err,
        **timing,
    }]
    for name, line in (("fwd", 60), ("dq", 150), ("dkv", 190)):
        kernels.append({
            "name": f"flash_attention_{name}",
            "route": "cuda",
            "source": "katib_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": f"katib_tpu/ops/flash_attention.py:{line}",
            "launches": flash_launches[name],
            "max_abs_err": flash_err[name],
            **flash_timing[name],
        })
    print(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f}s (build included)",
          flush=True)
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
