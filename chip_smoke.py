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
5. hold the DARTS step replayed from a CUDA graph against the same step
   run eagerly on the card (16 channels, 4 nodes, batch 64, 3 cells,
   ``remat_policy="dots"``, 2 steps);
6. drive the first main path: ``darts_trial`` through ``TrialContext`` at
   the DARTS search width (8 cells, 16 channels, 4 nodes, the 8 default
   primitives, batch 64, bf16, 2 epochs of 8 steps by CUDA-graph replay in
   windows of 3, search augmentation, a checkpoint dir, one augment epoch),
   with the mixed-op launch count set to 0 just before and read just after;
   then the same trial stopped after epoch 0 and resumed on its dir, against
   the uninterrupted run; then a small f32 supernet on the card against the
   same weights on the CPU;
7. drive the orchestrator path: ``examples/nas/darts.yaml`` at the search
   width (8 cells, 16 channels, batch 64, 1,024 images, 2 epochs, windows
   of 3, search augmentation, its own 3 operations) through the loader's
   ``experiment_spec_from_dict``, ``Orchestrator.run`` on ``cuda`` under
   the async engine (its default), the DARTS suggester, ``run_trial`` and
   ``darts_trial``, with the mixed-op launch count set to 0 just before and
   read just after; the same trial parameters through ``darts_trial``
   directly, for the orchestrator's overhead;
8. drive the CLI: ``python -m katib_tpu_torch run examples/nas/darts.yaml``
   as shipped, in a fresh interpreter, under the async engine, SIGTERM once
   the trial is journaled running (the drain lands at epoch 0's report;
   exit 75), then ``--resume`` to its end, ``fsck`` clean and each epoch
   reported once; ``python -m katib_tpu_torch doctor`` beside the resumed
   run (the native runtime built);
9. drive the second main path: ``transformer_trial`` at the long-context
   width (vocab 256, d_model 512, 8 heads, 4 layers, seq 4096, batch 4,
   bf16) for 10 steps, with the three flash-attention launch counts set to
   0 just before and read just after;
10. hold the HP-tuning trial's classifier epoch replayed from its captured
   step graph against the same epoch stepped eagerly, from the same weights
   (``SmallCNN`` with 32 channels in bf16, batch 64, 8,192 synthetic MNIST
   images: 2 epochs with momentum; ``MLP`` one epoch each with adam and
   sgd), profile a captured epoch, and check that 8 successive
   ``train_classifier`` calls give their device memory back;
11. drive the HP-tuning path: ``python -m katib_tpu_torch run
   katib_tpu_torch/specs/hyperband-mnist.yaml`` in a fresh interpreter (a
   32-trial Hyperband sweep of ``mnist_trial``, 16 trials at a time) under
   the async engine, and check the experiment, the rungs, each trial's
   reported epochs and ``fsck`` (the synchronous loop's run of the same
   sweep was cut for the ``remote:`` phase's seconds; phase 15 still holds
   both loops against each other);
12. ``blackbox:`` ``python -m katib_tpu_torch run
   examples/hp-tuning/hyperband.yaml`` as shipped, in a fresh interpreter,
   on ``cuda`` with the preflight: 32 black-box ``python -c`` trials, 16 at
   a time, under the async engine; the experiment, the rung table, one
   ``subprocess`` span per trial and ``fsck``, beside the white-box sweep's
   wall;
13. ``pbt:`` ``examples/hp-tuning/simple-pbt.yaml`` as shipped (15 trials of
   ``pbt_toy_trial``, population 5) through ``Orchestrator.run`` on
   ``cuda``: every trial succeeds, the generations rise, and a trial
   resumes its parent's checkpoint at the next step;
14. an ASHA sweep of ``mnist_trial`` (24 trials, 4 at a time) built from
   the Hyperband spec through the port's loader, on the async engine:
   every trial succeeds and promotions raise the epochs at the same lr;
15. an 8-point ``grid`` over ``mnist_trial`` (MLP, one epoch, sgd, 4 trials
   at a time) through ``Orchestrator.run`` on ``cuda`` with the synchronous
   loop and with the async engine, in turns, 3 runs each: every outcome set
   is bit-equal to the first;
16. ``python -m katib_tpu_torch chaos --soak 20 --seed 1 --trials 10``, the
   seeded chaos soak of the async engine (on the CPU: its trainer sleeps);
17. ``enas parity:`` the ENAS controller's trace on a fixed arc and one
   REINFORCE step, and an 8-layer float32 child with every op and a skip
   into every later layer (forward and gradient), on the card against the
   CPU;
18. ``enas width:`` ENAS through ``Orchestrator.run`` on ``cuda`` under the
   async engine at the reference's widths (the controller at
   ``ControllerConfig()``'s defaults with 50 REINFORCE steps a round;
   children of 32 channels on 8,192 synthetic CIFAR-10 images, batch 128,
   3 epochs; two rounds of 4 trials, 4 at a time): each child's capture,
   epochs, images/s and accuracy, the controller's trainings, one REINFORCE
   step and one arc's sampling timed and profiled, a child's captured epoch
   profiled, peak memory;
19. ``enas cli:`` ``python -m katib_tpu_torch run examples/nas/enas.yaml`` as
   shipped: 12 trials ``Succeeded`` in rounds 0, 1 and 2 of 4, the
   controller trained between rounds, ``fsck`` clean;
20. ``enas sharing:`` two children of one arc with ``weight_sharing`` in one
   experiment directory: the pool published, every parameter of the second
   child overlaid from it;
21. ``cohort:`` ``katib_tpu_torch/specs/cohort-mnist.yaml`` (12 random
   ``mnist_trial`` trials, MLP 64 units, in cohorts of up to 4 that differ
   in lr and momentum) through ``Orchestrator.run`` on ``cuda`` under the
   async engine: 12 ``Succeeded``, one capture per ``cohort`` span, no
   cohort fallback, ``fsck`` clean; then a direct K=4 cohort against its 4
   members run serially (walls, each member's accuracy and loss within the
   stated tolerance, one capture) and a ragged cohort of 3 padded to 4;
22. ``pbt ondevice:`` ``examples/hp-tuning/pbt-ondevice.yaml``'s settings
   (16 members, 10 generations of 300 steps, batch 64, truncation 0.25,
   seed 7) through ``Orchestrator.run`` on ``cuda`` on synthetic digits (the
   card's machine has no scikit-learn): 16 ``Succeeded`` at generation 10,
   10 ``pbt-generation`` spans, one capture, no cohort fallback; a
   same-seed rerun bit-equal in scores and lineage; a drain at the first
   generation boundary and a resume that loses no member and replays the
   same generations;
23. ``sdk:`` ``katib_tpu_torch.sdk.tune`` on ``cuda`` (random search over
   ``lr``, 4 trials 2 at a time, an ``f(params, ctx)`` objective training
   ``SmallCNN`` at the Hyperband sweep's cell for one epoch): every trial
   ``Succeeded``, an optimum, each trial's epoch run as its captured step;
   the same through ``KatibClient``; then, at once, ``list``, ``describe
   --json``, ``export --format jsonl``, ``trace summary --json`` and
   ``conformance`` in one fresh interpreter on the tune workdir, ``chaos``
   in its default scenario and ``chaos --crash-at journal.append``, each
   exit 0;
24. ``compile:`` the kernel libraries built in phase 2 published to a
   temporary shared artifact tier, then loaded from it by a fresh
   interpreter whose build directory is empty and whose ``nvcc`` raises
   (the same bytes, the ``ptxas`` lines read back, the fetched mixed-op
   kernel bit-equal to this process's on one input), ``fsck`` and ``cache``
   of that tier; ``python -m katib_tpu_torch run
   examples/hp-tuning/cohort-prewarm.yaml`` as shipped with
   ``KATIB_COMPILE_CACHE`` and ``KATIB_ARTIFACT_DIR`` in temporary
   directories: 12 ``Succeeded``, the prewarm worker's twin run and none
   failed, every first step labelled warm or cold, the port's registry file
   written and the shared tier left empty; then the same spec with
   ``prewarm: false``, both runs' walls and first steps side by side;
25. ``remote:`` one suggestion service (``serve_suggestions`` on ``cuda``
   with a bearer token) in this process serving two ``Orchestrator.run``
   experiments on ``cuda`` at once, each on the async engine in a thread of
   its own: ``examples/nas/enas.yaml`` rewritten to ``remote`` over
   ``enas`` with 8 trials (two rounds of 4), and
   ``katib_tpu_torch/specs/hyperband-mnist.yaml`` rewritten to ``remote``
   over ``random`` (fixed ``random_state``, 8 trials, each epoch captured):
   both end with every trial ``Succeeded`` and ``fsck`` clean, the served
   ENAS controller trained once on ``cuda`` between its rounds, round 0's
   architectures equal a fresh in-process ``EnasSuggester``'s on the card,
   the mnist assignments equal the in-process ``random`` suggester's, every
   trial captured its graph; then ``python -m katib_tpu_torch run`` of a
   4-trial mnist spec with ``endpoint: auto`` (the composer's
   ``suggest-server --device cpu`` child): exit 0, the in-process
   assignments, the child gone after the run, TLS or plain HTTP printed;
26. ``fused:`` the fused mixed-op plan at the search width: ``FusedSepDil``
   against ``SepConv``/``DilConv`` on the same parameters at both strides,
   in float32 and bf16; the fused supernet (8 cells, 16 channels, 4 nodes,
   8 primitives, batch 64, bf16, second order, no remat) replayed from its
   captured step against the same 2 steps run eagerly, bit for bit, with
   its mixed-op launches per replay; its replayed step's wall, images/s,
   capture seconds and peak memory beside the unfused step's; then a copy
   of ``examples/nas/darts.yaml`` with ``fused: true`` at the search width
   (1,024 images, 1 epoch, its operations widened to the 7 primitives a
   spec can name) through ``Orchestrator.run``: ``Succeeded``, ``fsck``
   clean, launches as predicted;
27. ``native:`` ``darts_trial`` with ``KATIB_NATIVE_LOADER=1`` at the search
   width on 3 eager steps fed by the C++ loaders (the loader's wait per
   batch beside each step's wall); ``python -m katib_tpu_torch db-manager
   --db <journal>`` as a child, then at once ``run --no-preflight`` of a
   4-trial random copy of ``katib_tpu_torch/specs/hyperband-mnist.yaml``
   with ``store: remote`` and the same copy with ``store: native``; the
   daemon killed by SIGKILL, restarted on its journal, and ``metrics``
   reading back every row;
28. ``mesh:`` the mesh path (``katib_tpu_torch/parallel/``): the route
   (``torch.cuda.device_count()``; replicas sharing ``cuda:0`` on one card,
   distinct cards where there are four; with two or more cards
   ``dryrun_multigpu(2)`` on the distinct-card route, with one
   ``dryrun_multigpu(4)`` on ``cuda:0`` and the CPU in turns, the same
   route with host copies), then
   ``dryrun_multigpu(4)`` on a grid named explicitly (the mixed-op kernel
   launched in every replica); ``darts.yaml`` at the search width cut to
   384 training images and one epoch (3 eager steps) through
   ``Orchestrator.run`` with ``init.mesh_axes`` ``{data: 2}`` against the
   same trial unsharded, every step's train loss within the stated bf16
   tolerance, 190 mixed-op launches per replica-step; ``transformer_trial``
   at the long-context width on ``{seq: 4}``, ring then Ulysses, 3 steps
   each, against the unsharded trial, flash launches as predicted; one
   small ring step's q/k/v gradients, kernels against the plain inner.
   Its seconds were cut from the preflights of the resumed ``cli:`` run,
   ``hyperband:`` and ``enas cli:`` (``cli:`` and ``blackbox:`` still gate
   on the preflight).

Every run of the async engine prints its ``async_stats`` (a CLI run prints
them on its ``async engine:`` line) and fails the script if a loop
restarted or the engine fell back to the synchronous loop.

The ``kernels`` line gives each kernel's launches on the main path
(``launches``) and on the mesh paths (``mesh_launches``: the sharded DARTS
run; the ring and Ulysses runs).

Its last three lines are the ``{"kernels": [...]}`` JSON line, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": {...}}``.
The script needs a CUDA GPU and the ``katib_tpu_torch`` package beside it,
and exits nonzero without printing a result when either is missing.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import contextlib
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


DARTS_LAYERS, DARTS_NODES = 8, 4
# replay against eager under remat "dots": cut from 8 cells to 3 (the fused
# phase holds its replay bit-equal to eager at 8 cells without remat); at 8
# cells its eager steps and capture took about 57 s on an H100
GRAPH_VS_EAGER_LAYERS = 3
# the DARTS main path: the search width, its specs' step-loop window, search
# augmentation, the augment phase and a checkpoint dir
DARTS_SETTINGS = {
    "batch_size": 64, "init_channels": 16, "num_nodes": DARTS_NODES, "num_epochs": 2,
    "n_train": 1024, "n_test": 1024, "remat": "false", "stepLoopWindow": 3,
    "search_augment": "true", "augment_epochs": 1,
}
# Replay against eager, and a resumed search against the uninterrupted one,
# on the card.  Both sides run the same kernels, but cuDNN may choose other
# algorithms under capture, which reorders float32 sums inside bf16 compute:
# a step's loss (a mean over 64 images) may move by about 1e-3 of itself.
# The state may differ by at most 1 % of the largest distance it moved over
# the compared steps, weights and alphas each: a state not written back
# differs by all of that distance, a batch or augmentation draw replayed
# from the wrong step by about as much.
LOSS_RTOL = 2e-3
MOVE_RTOL = 1e-2


def darts_context(out_dir: str, stop_after: int | None = None):
    """A ``TrialContext`` for the DARTS main path; ``stop_after``: its report
    asks the trial to stop after that epoch, as an early-stopping rule would."""
    from katib_tpu_torch.nas.darts.ops import DEFAULT_PRIMITIVES
    from katib_tpu_torch.runner.context import TrialContext

    class Ctx(TrialContext):
        def report(self, step=None, **metrics):
            cont = super().report(step, **metrics)
            return cont and (stop_after is None or step != stop_after)

    return Ctx(
        {
            "algorithm-settings": json.dumps(DARTS_SETTINGS),
            "search-space": json.dumps(list(DEFAULT_PRIMITIVES)),
            "num-layers": str(DARTS_LAYERS),
        },
        checkpoint_dir=out_dir, device="cuda", step_times=[],
    )


def final_state(trial_dir: str, step: int | None = None) -> dict:
    """The search's last snapshot in a trial dir, or that of ``step``
    (``{key path: tensor}``)."""
    from katib_tpu_torch.utils.checkpoint import TrialCheckpointer

    restored = TrialCheckpointer(os.path.join(trial_dir, "search")).restore(step=step)
    check(restored is not None, f"no snapshot under {trial_dir}")
    return restored[0]


def move_diff(got: dict, want: dict, start: dict, prefix: str) -> tuple[float, float]:
    """``(max |got - want|, max |want - start|)`` over the tensors under
    ``prefix``: the disagreement and the distance the state moved."""
    keys = [k for k in want if k.startswith(prefix)]
    diff = max(float((got[k].float() - want[k].float()).abs().max()) for k in keys)
    moved = max(float((want[k].float() - start[k].float()).abs().max()) for k in keys)
    return diff, moved


def check_moves(got: dict, want: dict, start: dict, what: str,
                prefixes: tuple = ("weights/", "alphas/")) -> str:
    """The tensors under each prefix (weights and alphas by default) of
    ``got`` within ``MOVE_RTOL`` of their move from ``start`` to ``want``;
    returns the printed differences."""
    out = []
    for prefix in prefixes:
        diff, moved = move_diff(got, want, start, prefix)
        out.append(f"{prefix[:-1]} max |diff| {diff:.3e} (moved up to {moved:.3e})")
        check(moved > 0 and diff <= MOVE_RTOL * moved,
              f"{what}: {prefix[:-1]} differ by {diff:.3e}, more than {MOVE_RTOL} of their "
              f"move {moved:.3e}")
    return "; ".join(out)


def phase_graph_vs_eager(torch) -> None:
    """One state at the search width with ``remat=true`` and
    ``remat_policy="dots"``: a window of 2 steps run eagerly on the card and
    by CUDA-graph replay of the same step function; losses, weights and
    alphas compared."""
    import numpy as np

    from katib_tpu_torch.models.augmentation import KEY_OFFSET, random_crop_flip
    from katib_tpu_torch.models.data import load_cifar10
    from katib_tpu_torch.nas.darts.architect import (
        DartsHyper, init_search_state, make_search_step, state_items)
    from katib_tpu_torch.nas.darts.model import Alphas, DartsNetwork, init_alphas
    from katib_tpu_torch.nas.darts.ops import DEFAULT_PRIMITIVES
    from katib_tpu_torch.nas.darts.search import _draw_epoch_indices, split_train
    from katib_tpu_torch.nas.darts.step_loop import StepLoop
    from katib_tpu_torch.parallel.train import cross_entropy_loss

    s = DARTS_SETTINGS
    # 2 steps: the second step reads what the first wrote, in the replay as
    # eagerly; GRAPH_VS_EAGER_LAYERS cells (a normal and two reduction cells)
    steps, batch = 2, s["batch_size"]
    net = DartsNetwork(DEFAULT_PRIMITIVES, init_channels=s["init_channels"],
                       num_layers=GRAPH_VS_EAGER_LAYERS, n_nodes=DARTS_NODES, remat=True,
                       remat_policy="dots")
    gen = torch.Generator().manual_seed(5)
    net.reset_parameters(gen)
    alphas = init_alphas(DARTS_NODES, len(DEFAULT_PRIMITIVES), gen)
    net.cuda()
    (x_w, y_w), (x_a, y_a) = split_train(load_cifar10(n_train=s["n_train"], n_test=8), seed=5)
    splits = tuple(torch.from_numpy(np.ascontiguousarray(t)).cuda() for t in (x_w, y_w, x_a, y_a))
    w_ix, a_ix = (ix.reshape(-1, batch)[:steps]
                  for ix in _draw_epoch_indices(5, 0, len(x_w), len(x_a), steps * batch))

    def loss_fn(w, a, b):
        return cross_entropy_loss(torch.func.functional_call(net, w, (b[0], a)), b[1])

    hyper = DartsHyper(total_steps=16)
    state = init_search_state({k: v.detach() for k, v in net.named_parameters()},
                              Alphas(*(a.cuda() for a in alphas)), hyper)
    step = make_search_step(loss_fn, hyper)
    runs = {}
    for capture in (False, True):
        loop = StepLoop(step, state, splits, steps, batch, random_crop_flip, 5 + KEY_OFFSET,
                        capture=capture)
        t0 = time.perf_counter()
        loop.run_epoch(w_ix, a_ix, window=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[capture] = (dict((k, v.cpu()) for k, v in state_items(loop.state)),
                         loop.metrics.cpu(), wall, loop.capture_s)
        del loop
    (eager, eager_m, eager_s, _), (graph, graph_m, graph_s, capture_s) = runs[False], runs[True]
    init = dict((k, v.cpu()) for k, v in state_items(state))
    loss_rel = float(((graph_m - eager_m).abs() / eager_m.abs().clamp(min=1e-30)).max())
    print(f"graph vs eager: {GRAPH_VS_EAGER_LAYERS} cells, remat dots, search augment, "
          f"{steps} steps: eager "
          f"{eager_s:.2f}s, capture {capture_s:.2f}s (warm-up included) + replays "
          f"{graph_s - capture_s:.2f}s; train losses eager "
          f"{[round(float(v), 6) for v in eager_m[0]]} graph "
          f"{[round(float(v), 6) for v in graph_m[0]]}; step metrics max rel diff "
          f"{loss_rel:.2e}; steps {int(eager['step'])} and {int(graph['step'])}", flush=True)
    check(int(eager["step"]) == int(graph["step"]) == steps, f"both runs take {steps} steps")
    check(loss_rel <= LOSS_RTOL, f"replayed step metrics differ from eager by {loss_rel:.2e}")
    print(f"graph vs eager: {check_moves(graph, eager, init, 'graph vs eager')}", flush=True)


def phase_main_path(torch, mixed_op) -> tuple[int, str, list]:
    """``darts_trial`` at the search width through CUDA-graph replay with
    ``stepLoopWindow: 3``, search augmentation, a checkpoint dir and the
    augment phase; returns the mixed-op launches, the trial dir and the
    reports (kept for the resume phase)."""
    from katib_tpu_torch.nas.darts.model import mixed_op_launches_per_forward
    from katib_tpu_torch.nas.darts.ops import DEFAULT_PRIMITIVES
    from katib_tpu_torch.nas.darts.search import darts_trial
    from katib_tpu_torch.nas.darts.step_loop import WARMUP_STEPS

    out_dir = tempfile.mkdtemp(prefix="chip-smoke-darts-")
    ctx = darts_context(out_dir)
    torch.cuda.reset_peak_memory_stats()
    mixed_op.launches = 0
    with captured_loops() as augment_loops:
        t0 = time.perf_counter()
        darts_trial(ctx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    augment_captures = [loop.capture_s for loop in augment_loops]
    launches = mixed_op.launches
    with open(os.path.join(out_dir, "genotype.json")) as f:
        genotype = json.load(f)

    s = DARTS_SETTINGS
    epochs, steps = s["num_epochs"], (s["n_train"] // 2) // s["batch_size"]
    # second order, no remat: grad_w, val grads, 2 finite-difference passes and
    # the weight step per step (the warm-up's step on copies included), one
    # evaluation forward per epoch; the augment phase's network has no mixed op
    predicted = ((epochs * steps + WARMUP_STEPS) * 5 + epochs) * mixed_op_launches_per_forward(
        DARTS_LAYERS, DARTS_NODES)
    times = ctx.step_times
    median = statistics.median(times[1:])
    print(f"main path: darts_trial 8 layers x 16 ch x 4 nodes, 8 primitives, batch 64, bf16, "
          f"{epochs} epochs x {steps} second-order steps by CUDA-graph replay (windows of "
          f"{s['stepLoopWindow']}), search augment, checkpoint, augment phase "
          f"{s['augment_epochs']} epoch, in {wall:.2f}s", flush=True)
    print(f"main path: graph capture {ctx.timings.get('graph_capture_s', float('nan')):.3f}s "
          f"(warm-up step included)", flush=True)
    print(f"main path: step_s first={times[0]:.4f} rest={[round(t, 4) for t in times[1:]]} "
          f"median_rest={median:.4f} steps_per_s={1 / median:.3f} "
          f"images_per_s={s['batch_size'] / median:.1f}", flush=True)
    print(f"main path: max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    print(f"main path: reports={ctx.reports}", flush=True)
    print(f"main path: mixed_op launches={launches} predicted={predicted}", flush=True)
    print(f"main path: augment phase through the captured classifier epoch: "
          f"{len(augment_captures)} capture(s), {[round(t, 3) for t in augment_captures]}s",
          flush=True)
    check(len(augment_captures) == 1, "the augment phase captured its classifier step once")
    check(len(times) == epochs * steps, f"expected {epochs * steps} steps, timed {len(times)}")
    check("graph_capture_s" in ctx.timings, "the step loop captured no graph")
    check([st for st, _ in ctx.reports] == [0, 1, epochs + s["augment_epochs"]],
          f"reports at epochs 0, 1 and the augment step, got {ctx.reports}")
    check(all(math.isfinite(v) for _, m in ctx.reports for v in m.values()), "finite metrics")
    check(all(0.0 <= m["accuracy"] <= 1.0 for _, m in ctx.reports[:epochs]), "accuracy in [0, 1]")
    check(0.0 <= ctx.reports[-1][1]["augment_accuracy"] <= 1.0, "augment_accuracy reported")
    check(len(genotype["normal"]) == DARTS_NODES and len(genotype["reduce"]) == DARTS_NODES,
          "genotype has one entry per node")
    check(all(op in DEFAULT_PRIMITIVES and op != "none" for node in genotype["normal"]
              + genotype["reduce"] for op, _ in node), "genotype ops are primitives")
    check(launches == predicted and launches > 0,
          f"mixed-op kernel launched {launches} times, the path predicts {predicted}")
    return launches, out_dir, ctx.reports


@contextlib.contextmanager
def captured_loops():
    """Collect every ``EpochLoop`` that captures its step graph inside the
    block (classifier epochs, cohorts, PBT generations)."""
    from katib_tpu_torch.models.mnist import EpochLoop

    loops: list = []
    build = EpochLoop._build_graph

    def recording(loop):
        build(loop)
        loops.append(loop)

    EpochLoop._build_graph = recording
    try:
        yield loops
    finally:
        EpochLoop._build_graph = build


def phase_resume(full_dir: str, full_reports: list) -> None:
    """The main path's trial stopped by its report after epoch 0, then rerun
    on the same dir: it resumes at epoch 1 and ends where the uninterrupted
    run ended."""
    from katib_tpu_torch.nas.darts.search import darts_trial

    out_dir = tempfile.mkdtemp(prefix="chip-smoke-resume-")
    first = darts_context(out_dir, stop_after=0)
    darts_trial(first)
    second = darts_context(out_dir)
    darts_trial(second)
    full, resumed = final_state(full_dir), final_state(out_dir)
    after_first = final_state(full_dir, step=1)
    print(f"resume: stopped run reports {first.reports}; resumed run reports {second.reports}, "
          f"{len(second.step_times)} steps; steps {int(resumed['step'])} and {int(full['step'])}",
          flush=True)
    check([st for st, _ in first.reports] == [0], "the stopped run reports epoch 0 only")
    s = DARTS_SETTINGS
    steps = (s["n_train"] // 2) // s["batch_size"]
    check([st for st, _ in second.reports] == [1, s["num_epochs"] + s["augment_epochs"]],
          "the resumed run continues at epoch 1 and then reports the augment phase")
    check(len(second.step_times) == len(first.step_times) == steps, "one epoch in each run")
    check(int(resumed["step"]) == int(full["step"]) == 2 * steps, "both end after 2 epochs")
    (_, got), (_, want) = second.reports[0], full_reports[1]
    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    print(f"resume: epoch 1 loss {got['loss']:.6f} vs {want['loss']:.6f} (rel {loss_rel:.2e}), "
          f"accuracy {got['accuracy']:.4f} vs {want['accuracy']:.4f}; final state vs the "
          f"uninterrupted run's, against its move over epoch 1: "
          f"{check_moves(resumed, full, after_first, 'resume')}", flush=True)
    check(loss_rel <= LOSS_RTOL, f"resumed epoch-1 loss differs by {loss_rel:.2e}")
    check(abs(got["accuracy"] - want["accuracy"]) <= 4 / DARTS_SETTINGS["n_test"],
          "resumed epoch-1 accuracy differs by more than 4 images")


HERE = os.path.dirname(os.path.abspath(__file__))
DARTS_YAML = os.path.join(HERE, "examples", "nas", "darts.yaml")
# the orchestrator path: darts.yaml's algorithm settings set to the search width
ORCH_LAYERS = 8
ORCH_SETTINGS = {
    "batch_size": "64", "init_channels": "16", "num_epochs": "2", "n_train": "1024",
    "n_test": "1024", "remat": "false", "stepLoopWindow": "3", "search_augment": "true",
}
# experiment conditions of a run that ended well (darts.yaml's maxTrialCount: 1
# settles as MaxTrialsReached before the suggester's exhaustion)
SUCCESS = ("Succeeded", "MaxTrialsReached", "GoalReached")


def search_width_spec(extra: dict | None = None):
    """``darts.yaml`` through the SDK entry with the search width set (and
    ``extra`` algorithm settings)."""
    import yaml

    from katib_tpu_torch.sdk.yaml_spec import experiment_spec_from_dict

    with open(DARTS_YAML) as f:
        doc = yaml.safe_load(f)
    algo = doc["spec"]["algorithm"]
    settings = {**ORCH_SETTINGS, **(extra or {})}
    algo["algorithmSettings"] = [s for s in algo["algorithmSettings"]
                                 if s["name"] not in settings]
    algo["algorithmSettings"] += [{"name": k, "value": v} for k, v in settings.items()]
    doc["spec"]["nasConfig"]["graphConfig"]["numLayers"] = ORCH_LAYERS
    return experiment_spec_from_dict(doc)


def span_totals(workdir: str, experiment: str) -> str:
    """The experiment's span journal summed by span name: ``name count x
    seconds``, the breakdown of a run's wall, and the graph captures the
    DARTS epochs carry."""
    totals: dict[str, list] = {"graph_capture_s": [0, 0.0]}
    with open(os.path.join(workdir, experiment, "trace.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            for name, dur in ((rec["name"], rec["dur"]),
                              ("graph_capture_s", rec["args"].get("graph_capture_s"))):
                if dur is not None:
                    entry = totals.setdefault(name, [0, 0.0])
                    entry[0] += 1
                    entry[1] += dur
    return ", ".join(f"{name} {n}x {dur:.3f}s" for name, (n, dur) in totals.items() if n)


ENGINE_KEYS = ("sustained_occupancy", "trials_per_sec", "lookahead", "loop_restarts", "fallback")


def engine_stats(what: str, stats: dict | None) -> None:
    """Print an async engine run's ``async_stats`` and fail unless the run
    went through the engine with no loop restarted and no fallback to the
    synchronous loop."""
    check(stats is not None, f"{what}: the run did not go through the async engine")
    print(f"{what}: async engine {({k: stats[k] for k in ENGINE_KEYS})} "
          f"(elapsed {stats['elapsed_s']}s, {stats['trials_settled']} settled, "
          f"member limit {stats['member_limit']})", flush=True)
    check(not any(stats["loop_restarts"].values()), f"{what}: loops restarted {stats}")
    check(stats["fallback"] is None, f"{what}: the engine fell back to the sync loop {stats}")


def phase_orchestrator(torch, mixed_op) -> None:
    """The search-width spec through ``Orchestrator.run`` on ``cuda``,
    between runs of its trial's parameters through ``darts_trial`` directly:
    one before (it pays what a network's first run in a process pays) and
    one after, on a pool thread as the orchestrator runs trials."""
    from katib_tpu_torch.core.types import Experiment
    from katib_tpu_torch.nas.darts.model import mixed_op_launches_per_forward
    from katib_tpu_torch.nas.darts.search import darts_trial
    from katib_tpu_torch.nas.darts.step_loop import WARMUP_STEPS
    from katib_tpu_torch.orchestrator import Orchestrator
    from katib_tpu_torch.orchestrator.fsck import fsck_experiment
    from katib_tpu_torch.runner.context import TrialContext
    from katib_tpu_torch.suggest.base import make_suggester

    spec = search_width_spec()
    (proposal,) = make_suggester(spec).get_suggestions(Experiment(spec=spec), 1)
    params = {a.name: a.value for a in proposal.assignments}

    def direct():
        ctx = TrialContext(params, device="cuda",
                           checkpoint_dir=tempfile.mkdtemp(prefix="chip-smoke-direct-"))
        t0 = time.perf_counter()
        darts_trial(ctx)
        torch.cuda.synchronize()
        return ctx, time.perf_counter() - t0

    ctx, before_wall = direct()
    workdir = tempfile.mkdtemp(prefix="chip-smoke-orch-")
    orch = Orchestrator(workdir=workdir, device="cuda")
    mixed_op.launches = 0
    t0 = time.perf_counter()
    exp = orch.run(spec)
    torch.cuda.synchronize()
    run_wall = time.perf_counter() - t0
    launches = mixed_op.launches
    (trial,) = exp.trials.values()
    trial_wall = trial.completion_time - trial.start_time

    check(trial.params() == params, "the orchestrator's trial has the suggester's parameters")
    # the orchestrator runs its trials on pool threads: the same, directly
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pooled, pooled_wall = pool.submit(direct).result()
    direct_wall = min(before_wall, pooled_wall)

    s = ORCH_SETTINGS
    epochs, steps = int(s["num_epochs"]), (int(s["n_train"]) // 2) // int(s["batch_size"])
    # second order, no remat: 5 network passes a step (the warm-up's included)
    # and one evaluation forward an epoch, as on the main path
    predicted = ((epochs * steps + WARMUP_STEPS) * 5 + epochs) * mixed_op_launches_per_forward(
        ORCH_LAYERS, int(json.loads(trial.params()["algorithm-settings"])["num_nodes"]))
    accuracy = exp.optimal.objective_value if exp.optimal is not None else float("nan")
    report = fsck_experiment(os.path.join(workdir, spec.name), repair=False)
    print(f"orchestrator: darts.yaml at the search width ({ORCH_LAYERS} layers, "
          f"{json.loads(trial.params()['search-space'])}, {s}) through Orchestrator.run on cuda: "
          f"experiment {exp.condition.value} ({exp.message}); trial {trial.name} "
          f"{trial.condition.value}; optimal accuracy={accuracy}", flush=True)
    print(f"orchestrator: wall run={run_wall:.3f}s trial={trial_wall:.3f}s; direct darts_trial "
          f"before={before_wall:.3f}s, after on a pool thread={pooled_wall:.3f}s "
          f"(graph capture {ctx.timings.get('graph_capture_s', math.nan):.3f}s and "
          f"{pooled.timings.get('graph_capture_s', math.nan):.3f}s); "
          f"overhead per trial against the "
          f"faster direct run: run-direct={run_wall - direct_wall:.3f}s "
          f"trial-direct={trial_wall - direct_wall:.3f}s", flush=True)
    print(f"orchestrator: spans {span_totals(workdir, spec.name)}", flush=True)
    engine_stats("orchestrator", orch.async_stats)
    print(f"orchestrator: mixed_op launches={launches} predicted={predicted}; fsck "
          f"{'consistent' if report.ok() else report.lines()}", flush=True)
    check(exp.condition.value in SUCCESS, f"experiment ended {exp.condition.value}: {exp.message}")
    check(trial.condition.value == "Succeeded", f"trial {trial.condition.value}: {trial.message}")
    check(0.0 <= accuracy <= 1.0, f"optimal accuracy {accuracy}")
    check(launches == predicted, f"mixed-op kernel launched {launches}, the path predicts {predicted}")
    check(report.ok(), f"fsck: {report.lines()}")
    check([st for st, _ in ctx.reports] == [0, 1], f"direct run reports {ctx.reports}")


def _cli(*args: str, log: str, env: dict | None = None) -> subprocess.Popen:
    """``python -m katib_tpu_torch ...`` in a fresh interpreter, its output to
    ``log``."""
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-m", "katib_tpu_torch", *args], cwd=HERE,
                                env={**os.environ, "PYTHONPATH": HERE, **(env or {})},
                                stdout=f, stderr=subprocess.STDOUT, text=True)


def cli_engine(what: str, out: str, engine: bool = True) -> None:
    """Read a CLI run's ``async engine:`` line (the run's ``async_stats``;
    the supervisor's restarts and fallback are in it): print it, fail unless
    the run went through the engine (``engine``) or did not, and on any
    restart or fallback."""
    lines = [ln for ln in out.splitlines() if ln.startswith("async engine: ")]
    if engine:
        check(len(lines) == 1, f"{what}: {len(lines)} async engine lines, not 1")
        engine_stats(what, json.loads(lines[0][len("async engine: "):]))
    else:
        check(not lines, f"{what}: the synchronous run went through the engine: {lines}")


def _wait(proc: subprocess.Popen, log: str, timeout: float) -> tuple[int, str]:
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(log) as f:
        return proc.returncode, f.read()


def phase_cli() -> None:
    """``python -m katib_tpu_torch run examples/nas/darts.yaml`` as shipped:
    drained by SIGTERM during epoch 0 (exit 75), resumed with ``--resume``,
    fsck'd; ``doctor`` beside the resumed run."""
    from katib_tpu_torch.orchestrator.status import read_status
    from katib_tpu_torch.store.sqlite import SqliteObservationStore

    workdir = tempfile.mkdtemp(prefix="chip-smoke-cli-")
    store_path = os.path.join(workdir, "observations.sqlite")
    config = os.path.join(workdir, "config.yaml")
    with open(config, "w") as f:
        json.dump({"store": {"backend": "sqlite", "path": store_path}}, f)  # JSON is YAML
    run = ("--config", config, "run", DARTS_YAML, "--workdir", workdir,
           "--drain-grace-seconds", "300")
    name = "darts-example"

    def steps(trial: str) -> list[int]:
        store = SqliteObservationStore(store_path)
        try:
            return sorted(log.step for log in store.get(trial, "accuracy"))
        finally:
            store.close()

    log = os.path.join(workdir, "run.log")
    t0 = time.perf_counter()
    proc = _cli(*run, log=log)
    trial = None
    while proc.poll() is None and time.perf_counter() - t0 < 300:
        # the engine journals a proposal Pending before it dispatches it
        status = read_status(workdir, name)
        running = [t for t, rec in ((status or {}).get("trials") or {}).items()
                   if rec["condition"] == "Running"]
        if running:
            trial = running[0]
            break
        time.sleep(0.05)
    if trial is None:
        check(False, f"the CLI run journaled no trial: {_wait(proc, log, 5)}")
    signalled = time.perf_counter() - t0
    proc.send_signal(15)  # SIGTERM
    rc, out = _wait(proc, log, 600)
    drained_wall = time.perf_counter() - t0
    status = read_status(workdir, name)
    first_steps = steps(trial)
    print(f"cli: run darts.yaml as shipped: SIGTERM at {signalled:.2f}s once {trial} was journaled "
          f"running; exit {rc} at {drained_wall:.2f}s; trial "
          f"{status['trials'][trial]['condition']}; accuracy reported at epochs {first_steps}",
          flush=True)
    print(f"cli: drained run spans {span_totals(workdir, name)}", flush=True)
    cli_engine("cli: drained run", out)
    check(rc == 75, f"drained CLI run exited {rc}:\n{out[-3000:]}")
    check(status["trials"][trial]["condition"] == "Drained", "the trial settled Drained")
    check(first_steps == [0], f"the drained run reported epochs {first_steps}, not [0]")

    t0 = time.perf_counter()
    # doctor runs beside the resumed run: its probe interpreter and the
    # trial share the card, and the two walls overlap
    doctor_log = os.path.join(workdir, "doctor.log")
    doctor = _cli("doctor", log=doctor_log)
    # the preflight ran in the drained run: the resumed run skips it (cut for
    # the mesh phase's seconds)
    rc, out = _wait(_cli(*run, "--resume", "--no-preflight", log=log), log, 600)
    resume_wall = time.perf_counter() - t0
    status = read_status(workdir, name)
    lines = [ln for ln in out.splitlines() if ln.startswith(("experiment ", "optimal trial "))]
    print(f"cli: --resume exit {rc} in {resume_wall:.2f}s: {lines}; trial "
          f"{status['trials'][trial]['condition']}; accuracy reported at epochs {steps(trial)}",
          flush=True)
    print(f"cli: both runs' spans {span_totals(workdir, name)}", flush=True)
    cli_engine("cli: resumed run", out)
    check(rc == 0 and status["condition"] in SUCCESS, f"resumed run exited {rc}:\n{out[-3000:]}")
    check(list(status["trials"]) == [trial], "the resumed run reran the drained trial only")
    check(status["trials"][trial]["condition"] == "Succeeded", "the resumed trial succeeded")
    check(steps(trial) == [0, 1], f"epochs reported {steps(trial)}, each should be once")
    check(any(ln.startswith(f"optimal trial {trial}: accuracy=") for ln in lines),
          "the CLI printed the optimal accuracy")

    rc, out = _wait(_cli("fsck", os.path.join(workdir, name), log=log), log, 120)
    print(f"cli: fsck exit {rc}: {out.strip().splitlines()[-1]}", flush=True)
    check(rc == 0 and "result: consistent" in out, f"fsck:\n{out}")

    rc, out = _wait(doctor, doctor_log, 180)
    print(f"doctor: exit {rc} beside the resumed run, done {time.perf_counter() - t0:.2f}s after "
          f"it started: {' | '.join(out.strip().splitlines())}", flush=True)
    check(rc == 0 and out.startswith("pool healthy"), f"doctor:\n{out}")
    check("native runtime: built" in out, f"doctor: the native runtime did not build:\n{out}")


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


def _classifier_run(torch, capture: bool, optimizer: str, arch: str, epochs: int):
    """One classifier loop at the sweep's cell from seed 0's weights:
    ``epochs`` epochs, each ended by reading its losses; returns the losses,
    the epoch walls, the start and final parameters (``params/<name>``), the
    loop and its permutation rows."""
    from katib_tpu_torch.models.profile import classifier_loop

    loop, idx = classifier_loop(capture, optimizer, arch)
    start = {f"params/{k}": v.to("cpu", copy=True) for k, v in loop.state.params.items()}
    losses, walls = [], []
    for epoch in range(epochs):
        t0 = time.perf_counter()
        loop.run_epoch(idx if epoch % 2 == 0 else idx[::-1].copy())
        losses.append(loop.losses.to("cpu", copy=True))
        walls.append(time.perf_counter() - t0)
    final = {f"params/{k}": v.to("cpu", copy=True) for k, v in loop.state.params.items()}
    return torch.cat(losses), walls, start, final, loop, idx


def phase_classifier(torch) -> None:
    """The classifier epoch replayed from its captured step graph against
    the same epoch stepped eagerly from the same weights; a profiled
    captured epoch; device memory over 8 successive ``train_classifier``
    calls."""
    import gc

    from katib_tpu_torch.models.mnist import SmallCNN, _cached_mnist, train_classifier
    from katib_tpu_torch.models.profile import CLASSIFIER
    from katib_tpu_torch.profiling import profile_step

    c = CLASSIFIER
    torch.cuda.reset_peak_memory_stats()
    for arch, optimizer, epochs in (("cnn", "momentum", 2), ("mlp", "adam", 1),
                                    ("mlp", "sgd", 1)):
        eager_l, eager_w, start, eager, _, _ = _classifier_run(torch, False, optimizer, arch,
                                                               epochs)
        graph_l, graph_w, _, graph, loop, idx = _classifier_run(torch, True, optimizer, arch,
                                                                epochs)
        equal = torch.equal(graph_l, eager_l) and all(torch.equal(graph[k], eager[k])
                                                      for k in eager)
        loss_rel = float(((graph_l - eager_l).abs() / eager_l.abs().clamp(min=1e-30)).max())
        what = f"classifier: {arch} {optimizer}, {epochs} epoch(s) of {loop.steps} steps"
        means = [[round(float(v), 6) for v in t.view(epochs, -1).mean(1)] for t in (graph_l, eager_l)]
        print(f"{what}: captured vs eager bit-equal={equal}; losses max rel diff {loss_rel:.2e}, "
              f"epoch means captured {means[0]} eager {means[1]}; "
              f"{check_moves(graph, eager, start, what, ('params/',))}", flush=True)
        print(f"{what}: epoch seconds captured {[round(t, 4) for t in graph_w]} (the first "
              f"includes the capture, {loop.capture_s:.3f}s with its warm-up step), eager "
              f"{[round(t, 4) for t in eager_w]}", flush=True)
        check(bool(torch.isfinite(graph_l).all()), f"{what}: finite losses")
        check(loss_rel <= LOSS_RTOL, f"{what}: captured losses differ from eager by {loss_rel:.2e}")
        if arch == "cnn":
            cnn = (loop, idx)
    print(f"classifier: max_memory_allocated={torch.cuda.max_memory_allocated() / 2**20:.1f} MiB",
          flush=True)
    loop, idx = cnn
    print("classifier: profile of a captured SmallCNN epoch:", flush=True)
    prof = profile_step(lambda: loop.run_epoch(idx), steps=3, warmup=1, top=5, kernel_names=(),
                        substeps=loop.steps)
    print(f"classifier: captured epoch {prof.wall_s:.4f}s = "
          f"{loop.steps * c['batch_size'] / prof.wall_s:.0f} images/s, device busy "
          f"{prof.busy:.1%}", flush=True)
    del loop, cnn

    ds = _cached_mnist(c["n_train"], 2048)

    def one_trial():
        model = SmallCNN(channels=c["channels"])
        model.reset_parameters(torch.Generator().manual_seed(0))
        train_classifier(model, ds, lr=c["lr"], epochs=1, batch_size=c["batch_size"],
                         device="cuda")

    one_trial()
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for _ in range(8):
        one_trial()
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    print(f"classifier: memory_allocated before 8 train_classifier calls {before / 2**20:.1f} MiB, "
          f"after {after / 2**20:.1f} MiB", flush=True)
    check(after - before <= 64 * 2**20,
          f"8 train_classifier calls kept {(after - before) / 2**20:.1f} MiB of device memory")


HYPERBAND_YAML = os.path.join(HERE, "katib_tpu_torch", "specs", "hyperband-mnist.yaml")
# r_l 16, eta 4: (bracket s, rung i) -> (trials, epochs)
HYPERBAND_RUNGS = {("2", "0"): (16, 1), ("2", "1"): (4, 4), ("2", "2"): (1, 16),
                   ("1", "0"): (6, 4), ("1", "1"): (2, 16), ("0", "0"): (3, 16)}


def trial_spans(workdir: str, experiment: str) -> tuple[dict, dict]:
    """Per trial of an experiment's span journal: its ``classifier.epoch``
    spans (those on the trial's thread within its ``train_fn`` span) and
    its graph capture's seconds."""
    with open(os.path.join(workdir, experiment, "trace.jsonl")) as f:
        records = [json.loads(line) for line in f]
    fns = [r for r in records if r["name"] == "train_fn"]
    epochs: dict = {r["args"]["trial"]: [] for r in fns}
    captures: dict = {}
    for r in records:
        if r["name"] != "classifier.epoch":
            continue
        (owner,) = [f["args"]["trial"] for f in fns if f["tid"] == r["tid"]
                    and f["ts"] <= r["ts"] and r["ts"] + r["dur"] <= f["ts"] + f["dur"]]
        epochs[owner].append(r["args"]["epoch"])
        if "graph_capture_s" in r["args"]:
            captures[owner] = r["args"]["graph_capture_s"]
    return epochs, captures


def hyperband_run(engine: bool) -> tuple[float, dict]:
    """``python -m katib_tpu_torch run katib_tpu_torch/specs/hyperband-mnist.yaml``
    in a fresh interpreter, on the async engine (the spec's default) or with
    ``KATIB_ASYNC_ORCH=0``: 32 trials ``Succeeded``, ``MaxTrialsReached``,
    the Hyperband rung table, every trial's epochs run once each, one graph
    capture per trial, ``fsck`` clean.  Returns the wall and the rung table."""
    from katib_tpu_torch.orchestrator.status import read_status

    what = "hyperband" if engine else "hyperband (KATIB_ASYNC_ORCH=0)"
    workdir = tempfile.mkdtemp(prefix="chip-smoke-hyperband-")
    name, log = "hyperband-mnist", os.path.join(workdir, "run.log")
    t0 = time.perf_counter()
    # --no-preflight: the cli: and blackbox: runs gate on the preflight (cut
    # for the mesh phase's seconds)
    rc, out = _wait(_cli("run", HYPERBAND_YAML, "--workdir", workdir, "--no-preflight",
                         log=log, env={"KATIB_ASYNC_ORCH": "1" if engine else "0"}), log, 600)
    wall = time.perf_counter() - t0
    check(rc == 0, f"the Hyperband run exited {rc}:\n{out[-3000:]}")
    status = read_status(workdir, name)
    trials = status["trials"]
    epochs_run, captures = trial_spans(workdir, name)
    rungs: dict = {}
    for t, rec in trials.items():
        key = (rec["labels"].get("hyperband-s"), rec["labels"].get("hyperband-i"))
        rungs.setdefault(key, []).append(int(rec["assignments"]["epochs"]))
    table = {k: (len(v), sorted(set(v))) for k, v in sorted(rungs.items(), reverse=True)}
    seconds = sorted(rec["completion_time"] - rec["start_time"] for rec in trials.values())
    capture_s = sorted(captures.values())
    # accuracy at chance: the lr drove the loss to inf or nan
    chance = sorted(rec["assignments"]["lr"] for rec in trials.values()
                    if rec["observation"] and rec["observation"][0]["latest"] < 0.2)
    optimal = status.get("optimal") or {}
    conditions = sorted({rec["condition"] for rec in trials.values()})
    print(f"{what}: run {os.path.relpath(HYPERBAND_YAML, HERE)}: exit {rc} in {wall:.2f}s = "
          f"{len(trials) / wall * 3600:.0f} trials/hour; experiment {status['condition']}; "
          f"{len(trials)} trials {conditions}", flush=True)
    print(f"{what}: rungs (s, i) -> (trials, epochs) {table}", flush=True)
    print(f"{what}: best accuracy (synthetic MNIST) {optimal.get('objective_value')} by "
          f"{optimal.get('trial_name')} {optimal.get('assignments')}; {len(chance)} trials "
          f"ended below 0.2 accuracy, at lr {[round(v, 4) for v in chance]}",
          flush=True)
    print(f"{what}: trial seconds min {seconds[0]:.3f} median {statistics.median(seconds):.3f} "
          f"max {seconds[-1]:.3f}; graph capture seconds per trial ({len(capture_s)}, under "
          f"the device's capture lock): min {min(capture_s, default=math.nan):.3f} median "
          f"{statistics.median(capture_s) if capture_s else math.nan:.3f} max "
          f"{max(capture_s, default=math.nan):.3f}", flush=True)
    print(f"{what}: run spans {span_totals(workdir, name)}", flush=True)
    for t, rec in sorted(trials.items()):
        if rec["condition"] != "Succeeded":
            print(f"{what}: {t} {rec['condition']}: {rec['message']}", flush=True)
    cli_engine(what, out, engine=engine)
    check(status["condition"] == "MaxTrialsReached", f"experiment {status['condition']}")
    check(len(trials) == 32 and conditions == ["Succeeded"], f"trials {conditions}")
    check(table == {k: (n, [r]) for k, (n, r) in HYPERBAND_RUNGS.items()},
          f"rung table {table}")
    bad = {t: (trials[t]["assignments"]["epochs"], e) for t, e in epochs_run.items()
           if sorted(e) != list(range(int(trials[t]["assignments"]["epochs"])))}
    check(set(epochs_run) == set(trials) and not bad,
          f"trials whose epochs differ from their resource: {bad}")
    check(len(captures) == 32, f"{len(captures)} trials captured a graph, of 32")
    check(0.0 <= float(optimal.get("objective_value", -1)) <= 1.0, f"optimal {optimal}")
    rc, out = _wait(_cli("fsck", os.path.join(workdir, name), log=log), log, 120)
    print(f"{what}: fsck exit {rc}: {out.strip().splitlines()[-1]}", flush=True)
    check(rc == 0 and "result: consistent" in out, f"fsck:\n{out}")
    return wall, table


def phase_hyperband() -> float:
    """The Hyperband sweep on the async engine; returns its wall."""
    wall_engine, _ = hyperband_run(True)
    print(f"hyperband: async engine {wall_engine:.2f}s = {32 / wall_engine * 3600:.0f} "
          f"trials/hour", flush=True)
    return wall_engine


# -- black-box command: trials and the host PBT suggester ---------------------

BLACKBOX_YAML = os.path.join(HERE, "examples", "hp-tuning", "hyperband.yaml")


def spans_named(workdir: str, experiment: str, name: str) -> list[float]:
    """The durations of an experiment's spans called ``name``."""
    return [rec["dur"] for rec in spans_of(workdir, experiment, name)]


def phase_blackbox(whitebox_wall: float) -> None:
    """``python -m katib_tpu_torch run examples/hp-tuning/hyperband.yaml`` as
    shipped, in a fresh interpreter, on ``cuda`` with the preflight: 32
    ``python -c`` trials, 16 at a time, each a subprocess whose stdout the
    runner scrapes; the command twin of the white-box ``hyperband:`` sweep.
    The argv runs as the spec writes it: where no ``python`` is on the
    PATH, the child's PATH gets a directory holding a ``python`` link to
    this interpreter first."""
    import shutil

    from katib_tpu_torch.orchestrator.status import read_status

    workdir = tempfile.mkdtemp(prefix="chip-smoke-blackbox-")
    env = {"KATIB_ASYNC_ORCH": "1"}
    if shutil.which("python") is None:
        bindir = os.path.join(workdir, "bin")
        os.makedirs(bindir)
        os.symlink(sys.executable, os.path.join(bindir, "python"))
        env["PATH"] = bindir + os.pathsep + os.environ.get("PATH", "")
        print(f"blackbox: no python on the PATH; the child's PATH starts with {bindir}, "
              f"holding python -> {sys.executable}", flush=True)
    name, log = "hyperband-example", os.path.join(workdir, "run.log")
    t0 = time.perf_counter()
    rc, out = _wait(_cli("run", BLACKBOX_YAML, "--workdir", workdir, log=log, env=env), log, 300)
    wall = time.perf_counter() - t0
    check(rc == 0, f"the black-box Hyperband run exited {rc}:\n{out[-3000:]}")
    status = read_status(workdir, name)
    trials = status["trials"]
    rungs: dict = {}
    for rec in trials.values():
        key = (rec["labels"].get("hyperband-s"), rec["labels"].get("hyperband-i"))
        rungs.setdefault(key, []).append(int(rec["assignments"]["epochs"]))
    table = {k: (len(v), sorted(set(v))) for k, v in sorted(rungs.items(), reverse=True)}
    conditions = sorted({rec["condition"] for rec in trials.values()})
    sub = sorted(spans_named(workdir, name, "subprocess"))
    preflight = spans_named(workdir, name, "preflight")
    lines = [ln for ln in out.splitlines() if ln.startswith("async engine: ")]
    occupancy = json.loads(lines[0][len("async engine: "):])["sustained_occupancy"] \
        if len(lines) == 1 else math.nan
    optimal = status.get("optimal") or {}
    print(f"blackbox: run {os.path.relpath(BLACKBOX_YAML, HERE)} on cuda with the preflight: "
          f"exit {rc} in {wall:.2f}s = {len(trials) / wall * 3600:.0f} trials/hour; experiment "
          f"{status['condition']}; {len(trials)} trials {conditions}; white-box sweep on the "
          f"engine in this run {whitebox_wall:.2f}s", flush=True)
    print(f"blackbox: preflight {sum(preflight):.3f}s ({len(preflight)} span); subprocess spans "
          f"{len(sub)}, sum {sum(sub):.3f}s, median {statistics.median(sub) if sub else math.nan:.4f}s, "
          f"max {max(sub, default=math.nan):.4f}s; sustained occupancy {occupancy}", flush=True)
    print(f"blackbox: rungs (s, i) -> (trials, epochs) {table}; best accuracy "
          f"{optimal.get('objective_value')} by {optimal.get('assignments')}", flush=True)
    print(f"blackbox: run spans {span_totals(workdir, name)}", flush=True)
    cli_engine("blackbox", out)
    check(status["condition"] == "MaxTrialsReached", f"experiment {status['condition']}")
    check(len(trials) == 32 and conditions == ["Succeeded"], f"trials {conditions}")
    check(len(sub) == 32, f"{len(sub)} subprocess spans, not 32")
    check(len(preflight) == 1, f"{len(preflight)} preflight spans, not 1")
    check(table == {k: (n, [r]) for k, (n, r) in HYPERBAND_RUNGS.items()},
          f"rung table {table}")
    check(0.0 <= float(optimal.get("objective_value", -1)) <= 1.0, f"optimal {optimal}")
    rc, out = _wait(_cli("fsck", os.path.join(workdir, name), log=log), log, 120)
    print(f"blackbox: fsck exit {rc}: {out.strip().splitlines()[-1]}", flush=True)
    check(rc == 0 and "result: consistent" in out, f"fsck:\n{out}")


PBT_YAML = os.path.join(HERE, "examples", "hp-tuning", "simple-pbt.yaml")


def phase_pbt(torch) -> None:
    """``examples/hp-tuning/simple-pbt.yaml`` as shipped (15 trials of
    ``pbt_toy_trial``, population 5, 2 at a time) through ``Orchestrator.run``
    on ``cuda``, in a temporary cwd (the suggester keeps its population's
    checkpoints under ``katib_runs/<name>/pbt`` there): every trial
    succeeds, the generation labels rise, and an exploiting trial resumes
    its parent's checkpoint, its first step the one after the parent's
    last."""
    from katib_tpu_torch.orchestrator import Orchestrator
    from katib_tpu_torch.sdk.yaml_spec import load_experiment_yaml
    from katib_tpu_torch.suggest.pbt import GENERATION_LABEL, PARENT_LABEL

    spec = load_experiment_yaml(PBT_YAML)
    cwd = os.getcwd()
    workdir = tempfile.mkdtemp(prefix="chip-smoke-pbt-")
    os.chdir(workdir)
    try:
        orch = Orchestrator(workdir=workdir, device="cuda")
        t0 = time.perf_counter()
        exp = orch.run(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    trials = exp.trials
    steps = {t: sorted(log.step for log in orch.store.get(t, "score")) for t in trials}
    gens = sorted({int(t.spec.labels[GENERATION_LABEL]) for t in trials.values()})
    resumed = [(t.name, t.spec.labels[PARENT_LABEL], steps[t.name][0],
                steps[t.spec.labels[PARENT_LABEL]][-1])
               for t in trials.values()
               if t.spec.labels.get(PARENT_LABEL) in trials and steps[t.name]
               and steps[t.spec.labels[PARENT_LABEL]]]
    exploits = [r for r in resumed if r[2] == r[3] + 1]
    conditions = sorted({t.condition.value for t in trials.values()})
    best = exp.optimal.objective_value if exp.optimal is not None else math.nan
    ckpt = os.path.join(workdir, "katib_runs", spec.name, "pbt")
    print(f"pbt: simple-pbt.yaml through Orchestrator.run on cuda: {exp.condition.value} in "
          f"{wall:.2f}s; {len(trials)} trials {conditions}; generations {gens}; best score "
          f"{best}", flush=True)
    print(f"pbt: trials resuming a parent's checkpoint (trial, parent, first step, parent's "
          f"last step): {resumed}", flush=True)
    engine_stats("pbt", orch.async_stats)
    check(exp.condition.value == "MaxTrialsReached", f"experiment {exp.condition.value}")
    check(len(trials) == 15 and conditions == ["Succeeded"], f"trials {conditions}")
    check(len(gens) >= 2 and gens == list(range(len(gens))), f"generations {gens}")
    check(bool(exploits), f"no trial continued its parent's checkpoint step: {resumed}")
    check(all(os.path.isdir(os.path.join(ckpt, t)) for t in trials), f"checkpoint dirs in {ckpt}")
    check(0.0 < best < 1.0, f"best score {best}")


def phase_asha(torch) -> None:
    """An ASHA sweep of ``mnist_trial`` on SmallCNN at batch 64, on the
    Hyperband spec's synthetic data, through ``Orchestrator.run`` on
    ``cuda`` under the async engine: ``tests/test_hyperband_e2e.py::
    test_asha_async_sweep_e2e``'s shape (r_max 9, r_min 1, eta 3, lr in
    [0.01, 0.5], 24 trials, 4 at a time).  The spec is the Hyperband spec's,
    changed through the port's loader.  The store is the memory one: a
    diverging trial reports a NaN loss, which the sqlite store refuses
    (ROADMAP Queue 3, F3)."""
    import yaml

    from katib_tpu_torch.orchestrator import Orchestrator
    from katib_tpu_torch.sdk.yaml_spec import experiment_spec_from_dict
    from katib_tpu_torch.store.base import MemoryObservationStore

    with open(HYPERBAND_YAML) as f:
        doc = yaml.safe_load(f)
    spec = doc["spec"]
    doc["metadata"]["name"] = "asha-mnist"
    spec["algorithm"] = {"algorithmName": "asha", "algorithmSettings": [
        {"name": k, "value": v}
        for k, v in {"r_max": "9", "r_min": "1", "eta": "3", "resource_name": "epochs"}.items()]}
    spec["maxTrialCount"], spec["parallelTrialCount"] = 24, 4
    for p in spec["parameters"]:
        if p["name"] == "lr":
            p["feasibleSpace"] = {"min": "0.01", "max": "0.5"}
        elif p["name"] == "epochs":
            p["feasibleSpace"] = {"min": "1", "max": "9"}
    spec = experiment_spec_from_dict(doc)
    check(spec.async_orch is None, "the ASHA spec selects no loop: the async engine is the default")
    workdir = tempfile.mkdtemp(prefix="chip-smoke-asha-")
    orch = Orchestrator(workdir=workdir, device="cuda", store=MemoryObservationStore())
    t0 = time.perf_counter()
    exp = orch.run(spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trials = exp.trials.values()
    conditions = sorted({t.condition.value for t in trials})
    promoted = [t for t in trials if t.labels.get("asha-parent")]
    epochs = sorted(int(t.params()["epochs"]) for t in trials)
    print(f"asha: 24-trial sweep of mnist_trial (SmallCNN, batch 64) through Orchestrator.run "
          f"on cuda: experiment {exp.condition.value}; {len(exp.trials)} trials {conditions} in "
          f"{wall:.2f}s = {len(exp.trials) / wall * 3600:.0f} trials/hour; epochs per trial "
          f"{epochs}; {len(promoted)} promotions; best accuracy "
          f"{exp.optimal.objective_value if exp.optimal else None}", flush=True)
    engine_stats("asha", orch.async_stats)
    check(exp.condition.value in SUCCESS, f"experiment {exp.condition.value}: {exp.message}")
    check(len(exp.trials) == 24 and conditions == ["Succeeded"], f"trials {conditions}")
    check(promoted, "no asynchronous promotion in 24 trials")
    for t in promoted:
        parent = exp.trials[t.labels["asha-parent"]]
        check(int(t.params()["epochs"]) > int(parent.params()["epochs"])
              and t.params()["lr"] == parent.params()["lr"],
              f"promotion {parent.params()} -> {t.params()}")


# the async phase's grid: MLP, sgd, one epoch of 8,192 synthetic MNIST
# images at batch 64, over 8 learning rates, 4 trials at a time
GRID_FIXED = {"arch": "mlp", "optimizer": "sgd", "epochs": "1", "batch_size": "64",
              "n_train": "8192", "n_test": "2048"}
GRID_LRS = ["0.01", "0.02", "0.05", "0.1", "0.15", "0.2", "0.3", "0.4"]
GRID_PAIRS = 3  # runs of each loop, in turns


def run_grid(torch, engine: bool):
    """One run of the grid through ``Orchestrator.run`` on ``cuda``, on the
    async engine or the synchronous loop; returns the experiment, the
    orchestrator, the wall and the outcome ``[(lr, {metric: [values]})]``."""
    from katib_tpu_torch.core import types as t
    from katib_tpu_torch.models.mnist import mnist_trial
    from katib_tpu_torch.orchestrator import Orchestrator
    from katib_tpu_torch.store.base import MemoryObservationStore

    spec = t.ExperimentSpec(
        name="grid-mnist",
        objective=t.ObjectiveSpec(type=t.ObjectiveType.MAXIMIZE,
                                  objective_metric_name="accuracy"),
        algorithm=t.AlgorithmSpec(name="grid"),
        parameters=[t.ParameterSpec("lr", t.ParameterType.CATEGORICAL,
                                    t.FeasibleSpace(list=GRID_LRS))] + [
            t.ParameterSpec(k, t.ParameterType.CATEGORICAL, t.FeasibleSpace(list=[v]))
            for k, v in GRID_FIXED.items()],
        max_trial_count=len(GRID_LRS),
        parallel_trial_count=4,
        prewarm=False,
        async_orch=engine,
        train_fn=mnist_trial,
    )
    store = MemoryObservationStore()
    orch = Orchestrator(workdir=tempfile.mkdtemp(prefix="chip-smoke-grid-"), device="cuda",
                        store=store)
    t0 = time.perf_counter()
    exp = orch.run(spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outcome = sorted(
        (tr.params()["lr"], {m: [log.value for log in store.get(tr.name, m)]
                             for m in ("accuracy", "loss")})
        for tr in exp.trials.values())
    return exp, orch, wall, outcome


def phase_async(torch) -> None:
    """The 8-point ``grid`` of ``mnist_trial`` through ``Orchestrator.run`` on
    ``cuda``, with the synchronous loop and with the async engine, in turns,
    ``GRID_PAIRS`` times each: every run's outcome set (assignments to the
    reported accuracy and loss) is bit-equal to the first's, across loops and
    across runs of one loop, while 4 trials capture and replay at once."""
    outcomes, walls = [], {False: [], True: []}
    for i in range(GRID_PAIRS):
        for engine in (False, True) if i % 2 == 0 else (True, False):
            exp, orch, wall, outcome = run_grid(torch, engine)
            what = "async: engine" if engine else "async: synchronous loop"
            print(f"{what}: grid of 8 MLP trials (sgd, one epoch) on cuda: experiment "
                  f"{exp.condition.value} in {wall:.2f}s; {outcome}", flush=True)
            if engine:
                engine_stats("async", orch.async_stats)
            else:
                check(orch.async_stats is None, "the synchronous run went through the engine")
            check(exp.condition.value in SUCCESS and len(outcome) == 8,
                  f"grid experiment {exp.condition.value}: {exp.message}")
            outcomes.append(outcome)
            walls[engine].append(round(wall, 3))
    differ = [i for i, o in enumerate(outcomes) if o != outcomes[0]]
    check(not differ, f"grid runs {differ} differ from the first: "
          f"{[outcomes[i] for i in differ]} vs {outcomes[0]}")
    print(f"async: {len(outcomes)} runs in turns (walls: synchronous loop "
          f"{walls[False]}s, engine {walls[True]}s), every outcome set bit-equal", flush=True)


def phase_chaos() -> None:
    """``python -m katib_tpu_torch chaos --soak 20 --seed 1 --trials 10``:
    the seeded chaos soak of the async engine exits 0."""
    workdir = tempfile.mkdtemp(prefix="chip-smoke-chaos-")
    log = os.path.join(workdir, "soak.log")
    t0 = time.perf_counter()
    rc, out = _wait(_cli("chaos", "--soak", "20", "--seed", "1", "--trials", "10", log=log),
                    log, 300)
    wall = time.perf_counter() - t0
    for line in out.strip().splitlines():
        print(f"chaos: {line.strip()}", flush=True)
    summary = [ln for ln in out.splitlines() if ln.startswith(("SOAK PASS", "SOAK FAIL"))]
    base = after = math.nan
    if summary and summary[-1].startswith("SOAK PASS"):
        base, after = (float(v) for v in summary[-1].rsplit("occupancy", 1)[1].split("->"))
    print(f"chaos: exit {rc} in {wall:.2f}s; post-fault occupancy {after} / baseline {base} "
          f"= {after / base if base else math.nan:.3f}", flush=True)
    check(rc == 0 and summary and summary[-1].startswith("SOAK PASS"), f"soak:\n{out[-3000:]}")


# -- ENAS (the controller and its children on the card) ------------------------

ENAS_YAML = os.path.join(HERE, "examples", "nas", "enas.yaml")
# the children of the width phase: child_from_arc's default width on the
# reference's synthetic CIFAR-10 split, batch 128, 3 epochs
ENAS_CHILD = {"channels": "32", "n_train": "8192", "n_test": "2048", "batch_size": "128",
              "num_epochs": "3"}
# an 8-layer arc with every default op and a skip into every later layer
ENAS_PARITY_ARC = [[0], [1, 1], [2, 0, 1], [3, 1, 0, 1], [4, 0, 1, 0, 1], [5, 1, 1, 0, 0, 1],
                   [0, 0, 0, 1, 1, 0, 1], [2, 1, 0, 1, 0, 1, 0, 1]]


def phase_enas_parity(torch) -> None:
    """The controller's trace on a fixed arc and one REINFORCE step, and an
    8-layer float32 child (every op, a skip into every later layer), forward
    and gradient, on the card against the same weights on the CPU."""
    from katib_tpu_torch.nas.enas.child import child_from_arc
    from katib_tpu_torch.nas.enas.controller import (
        ControllerConfig,
        _trace,
        arc_from_json,
        make_reinforce,
    )

    cfg = ControllerConfig()
    arc = arc_from_json(ENAS_PARITY_ARC, cfg.num_layers)
    results = []
    for dev in ("cpu", "cuda"):
        init, train_step, _ = make_reinforce(cfg, dev)
        state = init(torch.Generator().manual_seed(0))
        dev_arc = type(arc)(*(t.to(dev) for t in arc))
        _, stats = _trace(state.params, cfg, dev_arc)
        new, metrics = train_step(state, dev_arc, 0.6)
        results.append(({k: float(v) for k, v in stats.items()},
                         {k: float(v) for k, v in metrics.items()},
                         [p.cpu() for p in new.params]))
    (s_cpu, m_cpu, p_cpu), (s_gpu, m_gpu, p_gpu) = results
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    stat_err = max(rel(s_gpu[k], s_cpu[k]) for k in s_cpu)
    step_err = max(rel(m_gpu[k], m_cpu[k]) for k in m_cpu)
    param_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(p_gpu, p_cpu))
    print(f"enas parity: controller (8 layers, 6 ops, hidden 64) trace on a fixed arc, card vs "
          f"CPU: {s_gpu} vs {s_cpu}, max rel err {stat_err:.2e} (tolerance 1e-5); one REINFORCE "
          f"step: loss and baseline max rel err {step_err:.2e} (1e-5), parameters max err "
          f"{param_err:.2e} of each tensor's largest (1e-5)", flush=True)
    check(stat_err <= 1e-5 and step_err <= 1e-5 and param_err <= 1e-5,
          "the controller disagrees between card and CPU")

    gen = torch.Generator().manual_seed(5)
    net = child_from_arc(arc, channels=16, num_classes=10, dtype=torch.float32)
    net.reset_parameters(gen)
    x = torch.randn(8, 32, 32, 3, generator=gen)
    cot = torch.randn(8, 10, generator=gen)
    results = []
    for dev in ("cpu", "cuda"):
        w = {k: v.detach().to(dev).requires_grad_() for k, v in net.named_parameters()}
        logits = torch.func.functional_call(net.to(dev), w, (x.to(dev),))
        grads = torch.autograd.grad((logits * cot.to(dev)).sum(), list(w.values()))
        results.append((logits.detach().cpu(), [g.cpu() for g in grads]))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = results
    logit_err = float((l_gpu - l_cpu).abs().max() / l_cpu.abs().max())
    grad_err = max(float((a - b).abs().max() / (b.abs().max() + 1e-12))
                   for a, b in zip(g_gpu, g_cpu))
    print(f"enas parity: 8-layer float32 child (16 channels, every op, a skip into every later "
          f"layer, batch 8 of 32x32x3), card vs CPU: logits max err {logit_err:.2e} of the "
          f"largest (tolerance 1e-4), gradients max err {grad_err:.2e} of each tensor's "
          f"largest (1e-3)", flush=True)
    check(logit_err <= 1e-4 and grad_err <= 1e-3, "the ENAS child disagrees between card and CPU")


def enas_width_trial(ctx) -> None:
    """``enas_trial`` at the width phase's child settings."""
    from katib_tpu_torch.nas.enas.trial import enas_trial

    for k, v in ENAS_CHILD.items():
        ctx.params.setdefault(k, v)
    enas_trial(ctx)


def enas_spans(workdir: str, experiment: str) -> tuple[list, dict]:
    """The run's ``enas.controller_train`` spans, and per trial its
    ``enas.epoch`` spans and its graph capture seconds (the
    ``classifier.epoch`` span on the trial's thread within its ``train_fn``
    span)."""
    with open(os.path.join(workdir, experiment, "trace.jsonl")) as f:
        records = [json.loads(line) for line in f]
    trains = [r for r in records if r["name"] == "enas.controller_train"]
    fns = [r for r in records if r["name"] == "train_fn"]
    children: dict = {r["args"]["trial"]: {"epochs": [], "capture_s": math.nan} for r in fns}
    for r in records:
        if r["name"] == "enas.epoch":
            children[r["args"]["trial"]]["epochs"].append(r)
        elif r["name"] == "classifier.epoch" and "graph_capture_s" in r["args"]:
            (owner,) = [f["args"]["trial"] for f in fns if f["tid"] == r["tid"]
                        and f["ts"] <= r["ts"] and r["ts"] + r["dur"] <= f["ts"] + f["dur"]]
            children[owner]["capture_s"] = r["args"]["graph_capture_s"]
    return trains, children


def enas_rounds(what: str, exp_trials: dict, trains: list, rounds: int, per_round: int) -> None:
    """Every trial succeeded, ``rounds`` rounds of ``per_round`` trials, and
    one controller training between each round and the next: after the
    round's last trial settled and before the next round's first started."""
    by_round: dict = {}
    for rec in exp_trials.values():
        by_round.setdefault(rec["labels"].get("enas-round"), []).append(rec)
    conditions = sorted({rec["condition"] for rec in exp_trials.values()})
    table = {k: len(v) for k, v in sorted(by_round.items())}
    print(f"{what}: {len(exp_trials)} trials {conditions}, per round {table}; controller "
          f"trainings {[(r['args']['round'], round(r['dur'], 4)) for r in trains]} "
          f"(round, seconds)", flush=True)
    check(conditions == ["Succeeded"], f"{what}: trials ended {conditions}")
    check(table == {str(r): per_round for r in range(rounds)}, f"{what}: rounds {table}")
    check([r["args"]["round"] for r in trains] == list(range(rounds - 1)),
          f"{what}: controller trainings {[r['args'] for r in trains]}")
    for r in trains:
        done = max(rec["completion_time"] for rec in by_round[str(r["args"]["round"])])
        nxt = min(rec["start_time"] for rec in by_round[str(r["args"]["round"] + 1)])
        check(done - 0.01 <= r["wall"] and r["wall"] + r["dur"] <= nxt + 0.01,
              f"{what}: the controller trained outside its round's gap: {r}")


def enas_child_loop(torch, rows: list, operations, channels: int, lr: float, batch: int):
    """The width phase's child of ``rows`` in an :class:`EpochLoop` on the card,
    as ``train_classifier`` builds it, its graph captured; returns the loop and
    one epoch's permutation rows."""
    import numpy as np

    from katib_tpu_torch.models.data import load_cifar10
    from katib_tpu_torch.models.mnist import EpochLoop, classifier_steps
    from katib_tpu_torch.nas.enas.child import child_from_arc
    from katib_tpu_torch.nas.enas.controller import arc_from_json

    ds = load_cifar10(int(ENAS_CHILD["n_train"]), int(ENAS_CHILD["n_test"]))
    model = child_from_arc(arc_from_json(rows, len(rows)), operations, channels=channels)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to("cuda")
    step, _, state = classifier_steps(model, "momentum", lr, 0.9)
    n = len(ds.x_train) // batch
    loop = EpochLoop(step, state, torch.from_numpy(ds.x_train).cuda(),
                     torch.from_numpy(ds.y_train).cuda(), n, batch)
    idx = np.random.default_rng(0).permutation(len(ds.x_train))[: n * batch].reshape(n, batch)
    loop.run_epoch(idx)
    torch.cuda.synchronize()
    return loop, idx


def phase_enas_width(torch) -> None:
    """ENAS through ``Orchestrator.run`` on ``cuda`` under the async engine
    at the reference's widths: the controller at ``ControllerConfig()``'s
    defaults (8 layers, the six default operations, hidden 64) with 50
    REINFORCE steps a round, children of 32 channels on 8,192 synthetic
    CIFAR-10 images (batch 128, 3 epochs), two rounds of 4 trials, 4 at a
    time (``enas.yaml`` through the SDK entry with these settings); then a
    REINFORCE step and one arc's sampling timed and profiled, and a child's
    captured epoch profiled."""
    import yaml

    from katib_tpu_torch.nas.enas.child import DEFAULT_OPERATIONS
    from katib_tpu_torch.nas.enas.controller import arc_to_json
    from katib_tpu_torch.orchestrator import Orchestrator
    from katib_tpu_torch.orchestrator import orchestrator as orch_mod
    from katib_tpu_torch.orchestrator.fsck import fsck_experiment
    from katib_tpu_torch.orchestrator.status import read_status
    from katib_tpu_torch.profiling import profile_step
    from katib_tpu_torch.sdk.yaml_spec import experiment_spec_from_dict
    from katib_tpu_torch.store.base import MemoryObservationStore

    sized = lambda name, sizes: {"operationType": name, "parameters": [{
        "name": "filter_size", "parameterType": "categorical",
        "feasibleSpace": {"list": sizes}}]}
    operations = [sized("convolution", ["3", "5"]), sized("separable_convolution", ["3", "5"]),
                  sized("avg_pooling", ["3"]), sized("max_pooling", ["3"])]
    with open(ENAS_YAML) as f:
        doc = yaml.safe_load(f)
    doc["spec"]["algorithm"]["algorithmSettings"] = [
        {"name": "controller_train_steps", "value": "50"}]
    doc["spec"]["nasConfig"] = {"graphConfig": {"numLayers": 8}, "operations": operations}
    doc["spec"]["maxTrialCount"] = 8
    spec = experiment_spec_from_dict(doc)
    spec.train_fn = enas_width_trial
    made = []
    make = orch_mod.make_suggester
    workdir = tempfile.mkdtemp(prefix="chip-smoke-enas-")
    # the memory store: a child that diverges reports a NaN loss, which the
    # sqlite store refuses (ROADMAP Queue 3, F3)
    orch = Orchestrator(workdir=workdir, device="cuda", store=MemoryObservationStore())
    torch.cuda.reset_peak_memory_stats()
    orch_mod.make_suggester = lambda s, device=None: made.append(make(s, device=device)) or made[-1]
    try:
        t0 = time.perf_counter()
        exp = orch.run(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        orch_mod.make_suggester = make
    peak = torch.cuda.max_memory_allocated()
    (suggester,) = made
    check(list(suggester.operations) == list(DEFAULT_OPERATIONS)
          and suggester.cfg.hidden_size == 64 and suggester.train_steps == 50,
          f"the width phase's controller {suggester.cfg}")
    check(suggester.state.params.w_lstm.device.type == "cuda", "the controller ran on the card")
    status = read_status(workdir, spec.name)
    trains, children = enas_spans(workdir, spec.name)
    print(f"enas width: 2 rounds of 4 children (8 layers, 6 ops, 32 channels, batch 128, "
          f"8192 synthetic CIFAR-10 images, 3 epochs) under a controller of hidden 64 with 50 "
          f"REINFORCE steps a round, through Orchestrator.run on cuda: experiment "
          f"{exp.condition.value} in {wall:.3f}s; peak memory {peak / 2**30:.3f} GiB", flush=True)
    print(f"enas width: spans {span_totals(workdir, spec.name)}", flush=True)
    for name, rec in sorted(status["trials"].items(), key=lambda kv: kv[1]["start_time"]):
        c = children[name]
        eps = sorted(c["epochs"], key=lambda r: r["args"]["epoch"])
        print(f"enas width: child {name} round {rec['labels']['enas-round']} "
              f"{rec['assignments']['architecture']}: {rec['condition']}; capture "
              f"{c['capture_s']:.3f}s; epoch seconds {[round(r['dur'], 4) for r in eps]} "
              f"(the first includes the data's copy and the capture); images/s "
              f"{[r['args']['images_per_s'] for r in eps]}; accuracy "
              f"{[r['args']['accuracy'] for r in eps]}", flush=True)
    failed = [n for n, rec in status["trials"].items() if rec["condition"] != "Succeeded"]
    print(f"enas width: failed trials {[(n, status['trials'][n]['message']) for n in failed]}",
          flush=True)
    engine_stats("enas width", orch.async_stats)
    enas_rounds("enas width", status["trials"], trains, 2, 4)
    check(exp.condition.value in SUCCESS, f"experiment {exp.condition.value}: {exp.message}")
    report = fsck_experiment(os.path.join(workdir, spec.name), repair=False)
    check(report.ok(), f"fsck: {report.lines()}")

    # the controller's round, piece by piece: one arc's sampling (with its
    # transfer to the host) and one REINFORCE step (a fresh sample and a train step)
    saved_state, saved_steps = suggester.state, suggester.train_steps
    suggester.train_steps = 1

    def sample_one():
        arc, _ = suggester._sample(suggester.state.params, suggester._gen)
        return arc_to_json(arc)

    sample_one()
    sample_s = []
    for _ in range(20):
        t0 = time.perf_counter()
        sample_one()
        sample_s.append(time.perf_counter() - t0)
    print("enas width: profile of one REINFORCE step (a fresh sample and a train step):",
          flush=True)
    prof = profile_step(lambda: suggester.train_controller(0.5), steps=5, warmup=2, top=5,
                        kernel_names=())
    suggester.state, suggester.train_steps = saved_state, saved_steps
    print(f"enas width: one arc sampled and sent to the host in {statistics.median(sample_s):.5f}s "
          f"(median of 20); one REINFORCE step {prof.wall_s:.5f}s, {prof.host_ops:.0f} aten "
          f"operator calls and {prof.kernels:.0f} kernels, device busy {prof.busy:.1%}; "
          f"50 steps predicted {50 * prof.wall_s:.3f}s against the trainings' "
          f"{[round(r['dur'], 4) for r in trains]}s", flush=True)

    first, rec = min(status["trials"].items(), key=lambda kv: kv[1]["start_time"])
    loop, idx = enas_child_loop(torch, json.loads(rec["assignments"]["architecture"]),
                                DEFAULT_OPERATIONS, int(ENAS_CHILD["channels"]), 0.05,
                                int(ENAS_CHILD["batch_size"]))
    print(f"enas width: profile of child {first}'s captured epoch "
          f"(capture {loop.capture_s:.3f}s):", flush=True)
    prof = profile_step(lambda: loop.run_epoch(idx), steps=3, warmup=1, top=5, kernel_names=(),
                        substeps=loop.steps)
    print(f"enas width: captured child epoch {prof.wall_s:.4f}s = "
          f"{loop.steps * int(ENAS_CHILD['batch_size']) / prof.wall_s:.0f} images/s, device "
          f"busy {prof.busy:.1%}", flush=True)


def phase_enas_cli() -> None:
    """``python -m katib_tpu_torch run examples/nas/enas.yaml`` as shipped, in
    a fresh interpreter on the async engine: exit 0, 12 trials ``Succeeded``
    in rounds 0, 1 and 2 of 4, the controller trained between rounds, no
    loop restart or fallback, ``fsck`` clean."""
    from katib_tpu_torch.orchestrator.status import read_status

    workdir = tempfile.mkdtemp(prefix="chip-smoke-enas-cli-")
    name, log = "enas-example", os.path.join(workdir, "run.log")
    t0 = time.perf_counter()
    # --no-preflight: cut for the mesh phase's seconds (cli: and blackbox:
    # gate on the preflight)
    rc, out = _wait(_cli("run", ENAS_YAML, "--workdir", workdir, "--no-preflight", log=log),
                    log, 600)
    wall = time.perf_counter() - t0
    check(rc == 0, f"the ENAS run exited {rc}:\n{out[-3000:]}")
    status = read_status(workdir, name)
    trains, children = enas_spans(workdir, name)
    optimal = status.get("optimal") or {}
    captures = sorted(c["capture_s"] for c in children.values())
    print(f"enas cli: run {os.path.relpath(ENAS_YAML, HERE)}: exit {rc} in {wall:.2f}s; "
          f"experiment {status['condition']}; best accuracy (synthetic CIFAR-10) "
          f"{optimal.get('objective_value')} by {optimal.get('trial_name')}", flush=True)
    print(f"enas cli: spans {span_totals(workdir, name)}", flush=True)
    print(f"enas cli: graph capture seconds per child min {captures[0]:.3f} median "
          f"{statistics.median(captures):.3f} max {captures[-1]:.3f}", flush=True)
    cli_engine("enas cli", out)
    enas_rounds("enas cli", status["trials"], trains, 3, 4)
    rc, out = _wait(_cli("fsck", os.path.join(workdir, name), log=log), log, 120)
    print(f"enas cli: fsck exit {rc}: {out.strip().splitlines()[-1]}", flush=True)
    check(rc == 0 and "result: consistent" in out, f"fsck:\n{out}")


def phase_enas_sharing(torch) -> None:
    """Two children of one arc with ``weight_sharing`` in one experiment
    directory, on the card: the first publishes the pool, the second
    overlays every one of its parameters from it."""
    from katib_tpu_torch.nas.enas import shared
    from katib_tpu_torch.nas.enas.trial import enas_trial
    from katib_tpu_torch.runner.context import TrialContext
    from katib_tpu_torch.utils.checkpoint import TrialCheckpointer

    exp_dir = tempfile.mkdtemp(prefix="chip-smoke-enas-shared-")
    overlays = []
    overlay = shared.overlay_matching

    def spy(params, pool):
        merged, n = overlay(params, pool)
        overlays.append((n, len(params)))
        return merged, n

    params = {"architecture": json.dumps(ENAS_PARITY_ARC[:4]),
              "nn_config": json.dumps({"num_layers": 4}), **ENAS_CHILD, "num_epochs": "2",
              "weight_sharing": "true"}
    what = f"{params['channels']} channels, {params['num_epochs']} epochs"
    runs = []
    shared.overlay_matching = spy
    try:
        for trial in ("t1", "t2"):
            ctx = TrialContext(params, checkpoint_dir=os.path.join(exp_dir, trial), device="cuda")
            enas_trial(ctx)
            runs.append([round(m["accuracy"], 4) for _, m in ctx.reports])
    finally:
        shared.overlay_matching = overlay
    pool = TrialCheckpointer(os.path.join(exp_dir, "enas-shared")).all_steps()
    print(f"enas sharing: two children of {params['architecture']} ({what}) "
          f"with weight_sharing in one experiment dir: pool versions {pool}; the second "
          f"overlaid {overlays} (inherited, of) parameters; accuracy per epoch {runs[0]} then "
          f"{runs[1]} (epoch 0: {runs[0][0]} cold, {runs[1][0]} from the pool)", flush=True)
    check(pool == [1, 2], f"pool versions {pool}, not [1, 2]")
    check(len(overlays) == 1 and overlays[0][0] == overlays[0][1] > 0,
          f"the second child inherited {overlays}, not every parameter")


def spans_of(workdir: str, experiment: str, name: str) -> list[dict]:
    """The ``name`` spans of an experiment's span journal, in order."""
    with open(os.path.join(workdir, experiment, "trace.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["name"] == name]


COHORT_YAML = os.path.join(HERE, "katib_tpu_torch", "specs", "cohort-mnist.yaml")
# (lr, momentum) of the direct cohort: the spec's ranges' corners and middle
COHORT_MEMBERS = [(0.01, 0.5), (0.04, 0.9), (0.07, 0.7), (0.1, 0.95)]
# a member against its serial run: bf16 products batched over the members
# and unbatched round apart (8 significant bits), over 48 momentum steps;
# the absolute part covers a member trained to a loss near 0
COHORT_LOSS_RTOL, COHORT_LOSS_ATOL = 5e-2, 1e-3
COHORT_ACC_ATOL = 0.03  # of 1,024 test images


def phase_cohort(torch) -> None:
    """Vectorized cohorts of ``mnist_trial`` on the card: the cohort spec
    through ``Orchestrator.run``, then a direct K=4 cohort against its
    members run serially, and a ragged cohort of 3 padded to 4."""
    from katib_tpu_torch.core import types as t
    from katib_tpu_torch.models.mnist import mnist_trial
    from katib_tpu_torch.orchestrator import Orchestrator
    from katib_tpu_torch.orchestrator.fsck import fsck_experiment
    from katib_tpu_torch.runner.cohort import run_cohort
    from katib_tpu_torch.runner.trial_runner import run_trial
    from katib_tpu_torch.sdk.yaml_spec import load_experiment_yaml
    from katib_tpu_torch.store.base import MemoryObservationStore
    from katib_tpu_torch.utils import observability as obs

    t_phase = time.perf_counter()
    smi = smi_line()
    fallbacks = obs.cohort_fallbacks.get()
    spec = load_experiment_yaml(COHORT_YAML)
    check(spec.async_orch is None and spec.cohort_width == 4, "the cohort spec's loop and width")
    workdir = tempfile.mkdtemp(prefix="chip-smoke-cohort-")
    orch = Orchestrator(workdir=workdir, device="cuda")
    with captured_loops() as loops:
        t0 = time.perf_counter()
        exp = orch.run(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    conditions = sorted({tr.condition.value for tr in exp.trials.values()})
    cohorts = spans_of(workdir, spec.name, "cohort")
    sizes = [c["args"]["size"] for c in cohorts]
    epochs = spans_of(workdir, spec.name, "cohort.epoch")
    print(f"cohort: {os.path.relpath(COHORT_YAML, HERE)} through Orchestrator.run on cuda "
          f"({smi}): experiment {exp.condition.value} in {wall:.2f}s = "
          f"{len(exp.trials) / wall * 3600:.0f} trials/hour; {len(exp.trials)} trials "
          f"{conditions}; cohort sizes {sizes} (spans {[round(c['dur'], 3) for c in cohorts]}s); "
          f"captures {len(loops)} ({[round(lp.capture_s, 3) for lp in loops]}s); cohort "
          f"epochs {[round(e['dur'], 4) for e in epochs]}s; best accuracy "
          f"{exp.optimal.objective_value if exp.optimal else None}", flush=True)
    engine_stats("cohort", orch.async_stats)
    report = fsck_experiment(os.path.join(workdir, spec.name), repair=False)
    check(exp.condition.value == "MaxTrialsReached", f"experiment {exp.condition.value}")
    check(len(exp.trials) == 12 and conditions == ["Succeeded"], f"trials {conditions}")
    check(sum(sizes) == 12 and max(sizes) <= 4, f"cohort sizes {sizes}")
    check(len(loops) == len(cohorts), f"{len(loops)} captures for {len(cohorts)} cohorts")
    check(report.ok(), f"fsck: {report.lines()}")

    obj = spec.objective

    def members(names):
        return [t.Trial(name=n, spec=t.TrialSpec(train_fn=mnist_trial, assignments=[
            t.ParameterAssignment("lr", lr), t.ParameterAssignment("momentum", m),
            t.ParameterAssignment("units", 64)])) for n, (lr, m) in zip(names, COHORT_MEMBERS)]

    def final(store, name):
        return {m: store.get(name, m)[-1].value for m in ("accuracy", "loss")}

    serial_store, serial_walls = MemoryObservationStore(), []
    for tr in members([f"m{i}" for i in range(4)]):
        t0 = time.perf_counter()
        result = run_trial(tr, serial_store, obj, device="cuda")
        torch.cuda.synchronize()
        serial_walls.append(time.perf_counter() - t0)
        check(result.condition.value == "Succeeded", f"serial {tr.name}: {result.message}")
    serial = [final(serial_store, f"m{i}") for i in range(4)]
    for k, what in ((4, "direct K=4"), (3, "ragged 3 padded to 4")):
        store = MemoryObservationStore()
        with captured_loops() as loops:
            t0 = time.perf_counter()
            results = run_cohort(members([f"m{i}" for i in range(k)]), store, obj,
                                 buckets=True, device="cuda")
            torch.cuda.synchronize()
            cohort_wall = time.perf_counter() - t0
        got = [final(store, f"m{i}") for i in range(k)]
        loss_rel = max(abs(g["loss"] - w["loss"]) / (abs(w["loss"]) + COHORT_LOSS_ATOL / COHORT_LOSS_RTOL)
                       for g, w in zip(got, serial))
        acc_abs = max(abs(g["accuracy"] - w["accuracy"]) for g, w in zip(got, serial))
        print(f"cohort: {what} cohort (MLP 64 units, 3 epochs of 16 steps, batch 256, bf16) "
              f"{cohort_wall:.3f}s against the serial sum {sum(serial_walls[:k]):.3f}s "
              f"({[round(w, 3) for w in serial_walls[:k]]}) = "
              f"{sum(serial_walls[:k]) / cohort_wall:.2f}x; captures {len(loops)} of "
              f"{[lp.loss_shape for lp in loops]} rows; final (accuracy, loss) cohort "
              f"{[(round(g['accuracy'], 4), round(g['loss'], 5)) for g in got]} serial "
              f"{[(round(w['accuracy'], 4), round(w['loss'], 5)) for w in serial[:k]]}: loss "
              f"|d| / (|serial| + {COHORT_LOSS_ATOL / COHORT_LOSS_RTOL:g}) {loss_rel:.2e} "
              f"(tolerance {COHORT_LOSS_RTOL} relative, {COHORT_LOSS_ATOL} absolute), accuracy abs "
              f"{acc_abs:.4f} (tolerance {COHORT_ACC_ATOL}) ({smi})", flush=True)
        check(all(r.condition.value == "Succeeded" for r in results.values()),
              f"{what}: {[r.message for r in results.values()]}")
        check(len(loops) == 1 and loops[0].loss_shape == (4,), f"{what}: captures {len(loops)}")
        check(loss_rel <= COHORT_LOSS_RTOL and acc_abs <= COHORT_ACC_ATOL,
              f"{what}: members differ from their serial runs")
    check(obs.cohort_fallbacks.get() == fallbacks,
          f"cohort fallbacks {fallbacks} -> {obs.cohort_fallbacks.get()}")
    print(f"cohort: phase wall {time.perf_counter() - t_phase:.2f}s", flush=True)


def pbt_generation_parts(torch, members: int, steps: int, batch: int) -> tuple[float, float]:
    """Median seconds of a generation's train part (``steps`` replays) and
    of a whole generation step (train, eval, selection, clone), on the
    card, for the digits population at the spec's sizes."""
    import numpy as np

    from katib_tpu_torch.device import resolve_device
    from katib_tpu_torch.models import pbt_digits
    from katib_tpu_torch.parallel import pbt
    from katib_tpu_torch.parallel.train import TrainState, stack_pytrees

    ds = pbt_digits._DATASET_CACHE[(1400, 397)]
    dev = resolve_device("cuda")
    prm = pbt_digits._init_params(torch.Generator().manual_seed(0), 64, 10, dev)
    state = stack_pytrees([TrainState(torch.zeros((), dtype=torch.int32, device=dev), prm,
                                      {n: torch.zeros_like(v) for n, v in prm.items()})] * members)
    specs = (pbt.HyperSpec("lr", "double", lo=0.005, hi=0.5),)
    lrs = [{"lr": 0.005 + 0.03 * i} for i in range(members)]
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    gen = pbt.make_pbt_generation_step(
        pbt_digits.member_loss, pbt_digits.member_update, pbt_digits.member_eval, states=state,
        hypers=pbt.encode_hypers(specs, lrs, members, device=dev),
        data=(to(ds.x_train.reshape(1400, -1)), to(ds.y_train)),
        eval_batch=(to(ds.x_test.reshape(397, -1)), to(ds.y_test)),
        steps=steps, batch_size=batch, specs=specs, k=members, truncation=0.25)
    idx = np.random.default_rng(0).integers(0, 1400, size=(steps, batch))
    parts = {"train": lambda: gen.loop.run_epoch(idx),
             "generation": lambda: gen(idx, torch.Generator(device=dev).manual_seed(0))}
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = statistics.median(times)
    return out["train"], out["generation"]


PBT_ONDEVICE_YAML = os.path.join(HERE, "examples", "hp-tuning", "pbt-ondevice.yaml")


def pbt_ondevice_run(torch, spec) -> tuple:
    """One run of the on-device PBT spec through ``Orchestrator.run`` on
    ``cuda`` in a temporary cwd (the suggester keeps the population's
    checkpoints under ``katib_runs/<name>/pbt`` there).  Returns the
    experiment, the orchestrator, the workdir, the wall, the captures and
    ``{slot: (accuracies, parents)}``."""
    from katib_tpu_torch.orchestrator import Orchestrator

    cwd = os.getcwd()
    workdir = tempfile.mkdtemp(prefix="chip-smoke-pbt-ondevice-")
    os.chdir(workdir)
    try:
        orch = Orchestrator(workdir=workdir, device="cuda")
        with captured_loops() as loops:
            t0 = time.perf_counter()
            exp = orch.run(spec)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    series = {int(tr.params()["pbt_slot"]): tuple(
        tuple(log.value for log in orch.store.get(tr.name, m)) for m in ("accuracy", "pbt_parent"))
        for tr in exp.trials.values()}
    return exp, orch, workdir, wall, len(loops), series


def phase_pbt_ondevice(torch) -> None:
    """``pbt-ondevice.yaml`` as shipped through ``Orchestrator.run`` on
    ``cuda``, twice, on synthetic digits; then its population drained at the
    first generation boundary and resumed, through ``run_cohort``."""
    import threading

    from katib_tpu_torch.core import types as t
    from katib_tpu_torch.models import pbt_digits
    from katib_tpu_torch.models.data import synthetic_classification
    from katib_tpu_torch.runner.cohort import run_cohort
    from katib_tpu_torch.sdk.yaml_spec import load_experiment_yaml
    from katib_tpu_torch.store.base import MemoryObservationStore
    from katib_tpu_torch.suggest.base import make_suggester
    from katib_tpu_torch.suggest.pbt import GENERATION_LABEL, PARENT_LABEL
    from katib_tpu_torch.utils import observability as obs
    from katib_tpu_torch.utils.checkpoint import TrialCheckpointer

    t_phase = time.perf_counter()
    smi = smi_line()
    # a fixture of this script: the trial's real digits come from
    # scikit-learn, which the card's machine lacks; a synthetic set of the
    # same shape (1,400 / 397 images of 8x8x1, 10 classes) stands in
    pbt_digits._DATASET_CACHE[(1400, 397)] = synthetic_classification(1400, 397, (8, 8, 1), 10)
    fallbacks = obs.cohort_fallbacks.get()
    runs = []
    for _ in range(2):
        spec = load_experiment_yaml(PBT_ONDEVICE_YAML)
        runs.append(pbt_ondevice_run(torch, spec))
    exp, orch, workdir, wall, captures, series = runs[0]
    s = spec.algorithm.settings
    members, generations, steps = (int(s["n_population"]), int(s["generations"]),
                                   int(s["steps_per_generation"]))
    gens = spans_of(workdir, spec.name, "pbt-generation")
    gen_s = sorted(g["dur"] for g in gens)
    conditions = sorted({tr.condition.value for tr in exp.trials.values()})
    labels = [tr.spec.labels for tr in exp.trials.values()]
    print(f"pbt ondevice: {os.path.relpath(PBT_ONDEVICE_YAML, HERE)} ({members} members, "
          f"{generations} generations of {steps} steps, batch 64, truncation "
          f"{s['truncation_threshold']}, seed {s['random_state']}) through Orchestrator.run on "
          f"cuda on SYNTHETIC digits (8x8x1, 1,400/397; no scikit-learn on this machine) "
          f"({smi}): experiment {exp.condition.value} in {wall:.2f}s (rerun "
          f"{runs[1][3]:.2f}s); {len(exp.trials)} trials {conditions}; captures {captures}",
          flush=True)
    print(f"pbt ondevice: seconds per generation min {gen_s[0]:.4f} median "
          f"{statistics.median(gen_s):.4f} max {gen_s[-1]:.4f} (the first pays the capture); "
          f"population {steps / statistics.median(gen_s):.0f} train steps/s = "
          f"{members * steps / statistics.median(gen_s):.0f} member steps/s at the median; "
          f"exploits per generation {[g['args']['exploits'] for g in gens]}; winners "
          f"{[g['args']['winners'] for g in gens]}; best accuracy "
          f"{exp.optimal.objective_value if exp.optimal else None} ({smi})", flush=True)
    engine_stats("pbt ondevice", orch.async_stats)
    check(exp.condition.value == "MaxTrialsReached", f"experiment {exp.condition.value}")
    check(len(exp.trials) == members and conditions == ["Succeeded"], f"trials {conditions}")
    check({lab[GENERATION_LABEL] for lab in labels} == {str(generations)},
          f"generation labels {[lab[GENERATION_LABEL] for lab in labels]}")
    check({lab[PARENT_LABEL] for lab in labels} <= set(exp.trials), "a parent is not a member")
    check(len(gens) == generations, f"{len(gens)} pbt-generation spans")
    check(captures == 1 and runs[1][4] == 1, f"captures {captures}, {runs[1][4]}")
    check(runs[1][5] == series, "the same-seed rerun differs in scores or lineage")
    print(f"pbt ondevice: same-seed rerun bit-equal in scores and lineage ({members} members x "
          f"{generations} generations)", flush=True)
    train_s, step_s = pbt_generation_parts(torch, members, steps, 64)
    print(f"pbt ondevice: a generation's parts, median of 5 on the card: {steps} replayed train "
          f"steps {train_s:.4f}s ({train_s / steps * 1e3:.4f} ms a step); eval, selection and "
          f"clone {step_s - train_s:.4f}s; the rest of the median span (host transfers, report, "
          f"{members} member checkpoints) {statistics.median(gen_s) - step_s:.4f}s", flush=True)

    # drain at the first generation boundary, then resume on the same dirs
    cwd = os.getcwd()
    os.chdir(tempfile.mkdtemp(prefix="chip-smoke-pbt-drain-"))
    try:
        spec = load_experiment_yaml(PBT_ONDEVICE_YAML)
        suggester = make_suggester(spec)
        proposals = suggester.get_suggestions(t.Experiment(spec=spec), members)
    finally:
        os.chdir(cwd)

    def population():
        return [t.Trial(name=p.name, experiment_name=spec.name, spec=t.TrialSpec(
            assignments=list(p.assignments), labels=dict(p.labels), train_fn=spec.train_fn),
            checkpoint_dir=suggester.checkpoint_dir_for(p.name)) for p in proposals]

    drain = threading.Event()
    drain.set()
    t0 = time.perf_counter()
    drained = run_cohort(population(), MemoryObservationStore(), spec.objective,
                         drain_event=drain, buckets=True, device="cuda")
    drain_wall = time.perf_counter() - t0
    kept = {p.name: TrialCheckpointer(suggester.checkpoint_dir_for(p.name)).all_steps()
            for p in proposals}
    store = MemoryObservationStore()
    t0 = time.perf_counter()
    resumed = run_cohort(population(), store, spec.objective, buckets=True, device="cuda")
    torch.cuda.synchronize()
    resume_wall = time.perf_counter() - t0
    slot = {p.name: int(p.as_dict()["pbt_slot"]) for p in proposals}
    steps_seen = {tuple(log.step for log in store.get(p.name, "accuracy")) for p in proposals}
    replayed = all(tuple(log.value for log in store.get(p.name, "accuracy"))
                   == series[slot[p.name]][0][1:] for p in proposals)
    print(f"pbt ondevice: drained at the first boundary in {drain_wall:.2f}s: "
          f"{sorted({r.condition.value for r in drained.values()})}, checkpoint generations "
          f"{sorted({tuple(v) for v in kept.values()})}; resumed in {resume_wall:.2f}s: "
          f"{sorted({r.condition.value for r in resumed.values()})}, generations reported "
          f"{sorted(steps_seen)}; scores equal the uninterrupted run's: {replayed}", flush=True)
    check(all(r.condition.value == "Drained" for r in drained.values()), "drain")
    check(set(map(tuple, kept.values())) == {(0,)}, f"checkpoints after the drain {kept}")
    check(len(resumed) == members and all(r.condition.value == "Succeeded"
                                          for r in resumed.values()), "resume")
    check(steps_seen == {tuple(range(1, generations))}, f"resumed generations {steps_seen}")
    check(replayed, "the resumed generations differ from the uninterrupted run's")
    check(obs.cohort_fallbacks.get() == fallbacks,
          f"cohort fallbacks {fallbacks} -> {obs.cohort_fallbacks.get()}")
    print(f"pbt ondevice: phase wall {time.perf_counter() - t_phase:.2f}s", flush=True)


# -- the user's surface: tune(), KatibClient, the reader verbs, chaos ----------

# tune()'s trials: SmallCNN at the Hyperband sweep's cell (32 channels in
# bf16, batch 64, momentum, synthetic MNIST 8,192/2,048), one epoch each
SDK_CELL = {"channels": 32, "batch_size": 64, "n_train": 8192, "n_test": 2048,
            "optimizer": "momentum", "epochs": 1}
SDK_TRIALS, SDK_PARALLEL = 4, 2

# one interpreter runs the reader verbs in turn: {"argv": [rc, stdout]}
READERS_CHILD = """
import contextlib, io, json, sys
from katib_tpu_torch.cli import main
out = {}
for argv in json.loads(sys.argv[1]):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out[" ".join(argv)] = [rc, buf.getvalue()]
print(json.dumps(out))
"""


def sdk_objective(params, ctx):
    """``tune()``'s objective, of the ``f(params, ctx)`` shape: SmallCNN
    trained by ``train_classifier`` on the trial's device, the test
    accuracy reported each epoch through ``ctx``."""
    import torch

    from katib_tpu_torch.models.mnist import SmallCNN, _cached_mnist, train_classifier

    c = SDK_CELL
    model = SmallCNN(channels=c["channels"])
    model.reset_parameters(torch.Generator().manual_seed(0))
    train_classifier(model, _cached_mnist(c["n_train"], c["n_test"]), lr=float(params["lr"]),
                     epochs=c["epochs"], batch_size=c["batch_size"], optimizer=c["optimizer"],
                     report=lambda epoch, accuracy, loss: ctx.report(step=epoch,
                                                                     accuracy=accuracy),
                     device=ctx.device)


def sdk_gate(what: str, exp, workdir: str, wall: float) -> None:
    """Every trial ``Succeeded``, an optimum, and each trial's epoch run as
    the captured classifier step (its ``classifier.epoch`` span carries the
    capture); prints the wall and trials per hour."""
    trials = exp.trials
    epochs_run, captures = trial_spans(workdir, exp.spec.name)
    conditions = sorted({t.condition.value for t in trials.values()})
    best = exp.optimal
    print(f"sdk: {what}: {exp.condition.value} ({exp.message}) in {wall:.2f}s = "
          f"{len(trials) / wall * 3600:.0f} trials/hour; {len(trials)} trials {conditions}; "
          f"optimal {best.trial_name if best else None} accuracy "
          f"{best.objective_value if best else None} at "
          f"{ {a.name: a.value for a in best.assignments} if best else None}; graph capture "
          f"seconds {sorted(captures.values())}", flush=True)
    check(exp.condition.value in SUCCESS, f"{what}: experiment {exp.condition.value}: "
          f"{exp.message}")
    check(len(trials) == SDK_TRIALS and conditions == ["Succeeded"],
          f"{what}: trials {[(t.name, t.condition.value, t.message) for t in trials.values()]}")
    check(best is not None and 0.0 <= best.objective_value <= 1.0, f"{what}: optimal {best}")
    check(set(epochs_run) == set(trials) and all(e == [0] for e in epochs_run.values()),
          f"{what}: epochs per trial {epochs_run}")
    check(set(captures) == set(trials),
          f"{what}: trials whose epoch ran as the captured step: {sorted(captures)}")


def phase_sdk(torch) -> None:
    """``katib_tpu_torch.sdk.tune`` and ``KatibClient`` on ``cuda`` (random
    search over ``lr``, 4 trials 2 at a time, SmallCNN at the sweep's cell);
    then, at once, the reader verbs and ``conformance`` in one fresh
    interpreter on the tune workdir, ``chaos`` in its default scenario and
    ``chaos --crash-at journal.append``, each exit 0."""
    from katib_tpu_torch.sdk import KatibClient, make_experiment_spec, search, tune

    space = {"lr": search.loguniform(0.001, 0.5)}
    kwargs = dict(algorithm="random", max_trial_count=SDK_TRIALS,
                  parallel_trial_count=SDK_PARALLEL, objective_metric_name="accuracy")
    workdir = tempfile.mkdtemp(prefix="chip-smoke-sdk-")
    t0 = time.perf_counter()
    exp = tune(sdk_objective, space, name="sdk-tune", workdir=workdir, device="cuda", **kwargs)
    torch.cuda.synchronize()
    sdk_gate("tune()", exp, workdir, time.perf_counter() - t0)

    client_dir = tempfile.mkdtemp(prefix="chip-smoke-sdk-client-")
    client = KatibClient(workdir=client_dir, device="cuda")
    t0 = time.perf_counter()
    live = client.create_experiment(make_experiment_spec("sdk-client", space,
                                                         objective=sdk_objective, **kwargs))
    done = client.wait_for_experiment_condition("sdk-client", timeout=300)
    torch.cuda.synchronize()
    sdk_gate("KatibClient", done, client_dir, time.perf_counter() - t0)
    best = client.get_optimal_hyperparameters("sdk-client")
    print(f"sdk: KatibClient: get_optimal_hyperparameters {best}", flush=True)
    check(live is done and client.is_experiment_succeeded("sdk-client"),
          f"KatibClient: condition {done.condition.value}")
    check(set(best) == {"lr"} and 0.001 <= best["lr"] <= 0.5, f"KatibClient: optimal {best}")

    verbs = [["list", "--workdir", workdir],
             ["describe", "sdk-tune", "--json", "--workdir", workdir],
             ["export", "sdk-tune", "--format", "jsonl", "--workdir", workdir],
             ["trace", "summary", "sdk-tune", "--json", "--workdir", workdir],
             ["conformance", "--device", "cuda"]]
    logs = {k: os.path.join(workdir, f"{k}.log") for k in ("readers", "chaos", "crash")}
    started = time.perf_counter()
    with open(logs["readers"], "w") as f:
        readers = subprocess.Popen([sys.executable, "-c", READERS_CHILD, json.dumps(verbs)],
                                   cwd=HERE, env={**os.environ, "PYTHONPATH": HERE},
                                   stdout=f, stderr=subprocess.STDOUT, text=True)
    procs = {"readers": readers,
             "chaos": _cli("chaos", log=logs["chaos"]),
             "crash": _cli("chaos", "--crash-at", "journal.append", log=logs["crash"])}
    results = {}
    for key, proc in procs.items():
        rc, out = _wait(proc, logs[key], 300)
        results[key] = (rc, out, time.perf_counter() - started)
    for key in ("chaos", "crash"):
        rc, out, wall = results[key]
        print(f"sdk: chaos{' --crash-at journal.append' if key == 'crash' else ''}: exit {rc} "
              f"in {wall:.2f}s: {' | '.join(out.strip().splitlines()[-2:])}", flush=True)
        check(rc == 0 and "CHAOS PASS" in out, f"chaos ({key}):\n{out[-3000:]}")
    rc, out, wall = results["readers"]
    check(rc == 0, f"reader verbs exited {rc}:\n{out[-3000:]}")
    got = json.loads(out.strip().splitlines()[-1])
    rcs = {argv: r for argv, (r, _) in got.items()}
    text = {argv.split()[0] + ("-" + argv.split()[1] if argv.startswith("trace") else ""): o
            for argv, (_, o) in got.items()}
    listed = [ln.split()[0] for ln in text["list"].splitlines()[1:]]
    described = json.loads(text["describe"])
    exported = [json.loads(ln) for ln in text["export"].splitlines()]
    spans = {s["name"]: s["count"] for s in json.loads(text["trace-summary"])}
    print(f"sdk: readers (one interpreter, {wall:.2f}s): exits {sorted(set(rcs.values()))}; "
          f"list {listed}; describe {len(described['trials'])} trials "
          f"{described['condition']}; export {len(exported)} rows; trace summary "
          f"classifier.epoch x{spans.get('classifier.epoch')} train_fn x{spans.get('train_fn')}; "
          f"{text['conformance'].strip()}", flush=True)
    check(set(rcs.values()) == {0}, f"reader verbs' exits {rcs}")
    check(listed == ["sdk-tune"], f"list rows {listed}")
    check(len(described["trials"]) == len(exported) == SDK_TRIALS and
          {r["trial"] for r in exported} == set(exp.trials), "describe/export rows")
    check(spans.get("classifier.epoch") == spans.get("train_fn") == SDK_TRIALS,
          f"trace summary {spans}")
    check(text["conformance"].startswith("CONFORMANCE PASS"), text["conformance"])
    print(f"sdk: {smi_line()}", flush=True)


COHORT_PREWARM_YAML = os.path.join(HERE, "examples", "hp-tuning", "cohort-prewarm.yaml")
COMPILE_KERNELS = ("mixed_op", "flash_attention")

# a fresh interpreter loads the kernel libraries from a shared tier: its
# build directory is an empty temporary one and nvcc raises, so a library
# can only come from the tier
KERNEL_FETCH_CHILD = """
import hashlib, json, sys, tempfile, time
from pathlib import Path
import torch
from katib_tpu_torch.compile.artifacts import ARTIFACTS
from katib_tpu_torch.ops import _build, mixed_op
from katib_tpu_torch.utils import observability as obs

shared, out_path, names = sys.argv[1], sys.argv[2], sys.argv[3].split(",")
_build.BUILD_DIR = Path(tempfile.mkdtemp(prefix="chip-smoke-fetched-"))

def no_nvcc():
    raise RuntimeError("nvcc started")

_build._nvcc = no_nvcc
ARTIFACTS.configure(shared)
t0 = time.perf_counter()
seconds = _build.build(names)
fetch_s = time.perf_counter() - t0
w, x = (t.cuda() for t in torch.load(out_path))
y = mixed_op.mixed_op_sum(w, x)
torch.cuda.synchronize()
torch.save(y.cpu(), out_path)
print(json.dumps({
    "seconds": seconds, "fetch_s": fetch_s,
    "sha256": {n: hashlib.sha256(_build.library_path(n).read_bytes()).hexdigest() for n in names},
    "ptxas": {n: {k: list(v) for k, v in _build.ptxas_report(n).items()} for n in names},
    "build_dir": sorted(p.name for p in _build.BUILD_DIR.iterdir()),
    "shared_hits": sum(v for labels, v in obs.artifact_hits.samples()
                       if (labels or {}).get("tier") == "shared"),
}))
"""


def compile_run(spec_path: str, what: str) -> dict:
    """``python -m katib_tpu_torch run <spec_path> --no-preflight`` (the
    ``doctor:`` phase probes the card) with the compile cache and
    the shared artifact tier in fresh temporary directories: exit 0, 12
    trials ``Succeeded`` through the async engine, each ``train_fn`` span
    labelled warm or cold.  Returns the run's wall, its dirs, its output and
    its ``train_fn`` spans."""
    from katib_tpu_torch.orchestrator.status import read_status

    workdir = tempfile.mkdtemp(prefix="chip-smoke-compile-")
    cache, shared = os.path.join(workdir, "cc"), os.path.join(workdir, "art")
    name, log = "cohort-prewarm-example", os.path.join(workdir, "run.log")
    t0 = time.perf_counter()
    rc, out = _wait(_cli("run", spec_path, "--workdir", workdir, "--no-preflight", log=log,
                         env={"KATIB_COMPILE_CACHE": cache, "KATIB_ARTIFACT_DIR": shared}),
                    log, 300)
    wall = time.perf_counter() - t0
    check(rc == 0, f"compile: {what}: the run exited {rc}:\n{out[-3000:]}")
    trials = read_status(workdir, name)["trials"]
    conditions = sorted({t["condition"] for t in trials.values()})
    fns = sorted(spans_of(workdir, name, "train_fn"), key=lambda r: r["ts"])
    labels = [r["args"].get("first_step_cache") for r in fns]
    firsts = [r["args"].get("first_step_s") for r in fns]
    print(f"compile: {what}: exit {rc} in {wall:.2f}s; {len(trials)} trials {conditions}; "
          f"first steps {[f'{lab} {s}s' for lab, s in zip(labels, firsts)]}", flush=True)
    cli_engine(f"compile: {what}", out)
    check(len(trials) == 12 and conditions == ["Succeeded"],
          f"{what}: trials {[(t['name'], t['condition'], t['message'][-300:]) for t in trials.values()]}")
    check(not any("stream is capturing" in t["message"] for t in trials.values()),
          f"{what}: a trial hit another's capture")
    check(len(fns) == 12 and set(labels) <= {"warm", "cold"} and None not in firsts,
          f"{what}: train_fn spans without a warm/cold first step: {labels}")
    return {"wall": wall, "cache": cache, "shared": shared, "out": out, "first_s": firsts[0],
            "labels": labels}


def phase_compile(torch, mixed_op, built: dict) -> None:
    """The compile half: the kernel tier's round trip (publish the libraries
    phase 2 built to a temporary shared tier; a fresh interpreter with an
    empty build directory and no nvcc loads them from it; the same bytes,
    the ptxas lines, the fetched mixed-op kernel bit-equal on one input;
    ``fsck`` and ``cache`` of the tier), then ``cohort-prewarm.yaml`` as
    shipped through the CLI with the prewarm worker, and again with
    ``prewarm: false``."""
    import hashlib

    from katib_tpu_torch.compile.artifacts import ArtifactCache, publish_kernel
    from katib_tpu_torch.ops import _build

    work = tempfile.mkdtemp(prefix="chip-smoke-kernel-tier-")
    shared = os.path.join(work, "shared")
    tier = ArtifactCache()
    tier.configure(shared)
    for name in COMPILE_KERNELS:
        check(publish_kernel(name, tier) == ["shared"], f"compile: {name} was not published")
    published = {n: hashlib.sha256(_build.library_path(n).read_bytes()).hexdigest()
                 for n in COMPILE_KERNELS}
    gen = torch.Generator().manual_seed(15)
    w = torch.softmax(torch.randn(5, 8, generator=gen), -1)
    x = torch.randn(5, 8, 65_537, generator=gen)
    io_path = os.path.join(work, "mixed_op.pt")
    torch.save((w, x), io_path)
    logs = {k: os.path.join(work, f"{k}.log") for k in ("fetch", "readers")}
    started = time.perf_counter()
    with open(logs["fetch"], "w") as f:
        fetch = subprocess.Popen(
            [sys.executable, "-c", KERNEL_FETCH_CHILD, shared, io_path, ",".join(COMPILE_KERNELS)],
            cwd=HERE, env={**os.environ, "PYTHONPATH": HERE}, stdout=f,
            stderr=subprocess.STDOUT, text=True)
    with open(logs["readers"], "w") as f:
        readers = subprocess.Popen(
            [sys.executable, "-c", READERS_CHILD,
             json.dumps([["fsck", shared], ["cache", shared, "--json"]])],
            cwd=HERE, env={**os.environ, "PYTHONPATH": HERE}, stdout=f,
            stderr=subprocess.STDOUT, text=True)
    rc, out = _wait(fetch, logs["fetch"], 180)
    fetch_wall = time.perf_counter() - started
    check(rc == 0, f"compile: the fetching interpreter exited {rc}:\n{out[-3000:]}")
    got = json.loads(out.strip().splitlines()[-1])
    mine = mixed_op.mixed_op_sum(w.cuda(), x.cuda()).cpu()
    theirs = torch.load(io_path)
    same = {n: got["sha256"][n] == published[n] for n in COMPILE_KERNELS}
    ptxas = {n: {k: list(v) for k, v in _build.ptxas_report(n).items()} for n in COMPILE_KERNELS}
    print(f"compile: kernel tier: fetched {sorted(got['seconds'])} in "
          f"{ {n: round(s, 4) for n, s in got['seconds'].items()} }s "
          f"(build, whole child {fetch_wall:.2f}s) against nvcc "
          f"{ {n: round(s, 2) for n, s in built.items()} }s in phase 2; shared hits "
          f"{got['shared_hits']}; same bytes {same}; ptxas lines read back "
          f"{ {n: len(got['ptxas'][n]) for n in COMPILE_KERNELS} }; fetched mixed_op "
          f"bit-equal {torch.equal(mine, theirs)}", flush=True)
    check(all(same.values()), f"compile: fetched libraries differ from the published {same}")
    check(got["ptxas"] == ptxas, "compile: the fetched ptxas logs differ")
    check(got["shared_hits"] == len(COMPILE_KERNELS), f"compile: shared hits {got['shared_hits']}")
    check(all(s > 0 for s in got["seconds"].values()), f"compile: {got['seconds']}")
    check(torch.equal(mine, theirs), "compile: the fetched mixed-op kernel is not bit-equal")
    rc, out = _wait(readers, logs["readers"], 180)
    check(rc == 0, f"compile: fsck/cache exited {rc}:\n{out[-3000:]}")
    verbs = json.loads(out.strip().splitlines()[-1])
    (fsck_rc, fsck_out), (cache_rc, cache_out) = verbs.values()
    rows = json.loads(cache_out)["artifacts"]
    print(f"compile: fsck exit {fsck_rc}: {fsck_out.strip().splitlines()[1]}; cache exit "
          f"{cache_rc}: {[(r['program'], r['status'], r['library_bytes']) for r in rows]}",
          flush=True)
    check(fsck_rc == 0 and f"{len(COMPILE_KERNELS)} artifact(s): {len(COMPILE_KERNELS)} valid"
          in fsck_out, f"compile: fsck:\n{fsck_out}")
    check(cache_rc == 0 and sorted(r["program"] for r in rows)
          == [f"kernel:{n}" for n in sorted(COMPILE_KERNELS)]
          and all(r["status"] == "ok" for r in rows), f"compile: cache rows {rows}")

    on = compile_run(COHORT_PREWARM_YAML, "cohort-prewarm.yaml")
    lines = [ln for ln in on["out"].splitlines() if ln.startswith("prewarm worker: ")]
    check(len(lines) == 1, f"compile: {len(lines)} prewarm worker lines")
    stats = json.loads(lines[0][len("prewarm worker: "):])
    reason = [ln for ln in on["out"].splitlines() if ln.startswith("artifact tiers: ")]
    left = os.listdir(on["shared"]) if os.path.isdir(on["shared"]) else []
    print(f"compile: prewarm worker {stats}; shared tier {left} ({reason[0] if reason else ''}); "
          f"registry {os.path.relpath(os.path.join(on['cache'], 'torch', 'shape_registry.jsonl'), on['cache'])}",
          flush=True)
    check(stats["compiled"] >= 1 and stats["failed"] == 0, f"compile: prewarm worker {stats}")
    check(os.path.isfile(os.path.join(on["cache"], "torch", "shape_registry.jsonl")),
          "compile: the port's shape registry was not written")
    check(not os.path.exists(os.path.join(on["cache"], "shape_registry.jsonl")),
          "compile: the JAX package's registry file was written")
    check(not left and reason, f"compile: the shared tier holds {left}")

    spec_dir = tempfile.mkdtemp(prefix="chip-smoke-noprewarm-")
    off_spec = os.path.join(spec_dir, "cohort-prewarm.yaml")
    with open(COHORT_PREWARM_YAML) as f:
        text = f.read()
    check("  prewarm: true\n" in text, "compile: the spec no longer sets prewarm: true")
    with open(off_spec, "w") as f:
        f.write(text.replace("  prewarm: true\n", "  prewarm: false\n"))
    off = compile_run(off_spec, "prewarm: false")
    check(not any(ln.startswith("prewarm worker: ") for ln in off["out"].splitlines()),
          "compile: prewarm: false started the worker")
    print(f"compile: what prewarm buys: wall {on['wall']:.2f}s with the worker, "
          f"{off['wall']:.2f}s without; first trial's first step {on['first_s']}s "
          f"({on['labels'][0]}) with, {off['first_s']}s ({off['labels'][0]}) without; "
          f"cold first steps {on['labels'].count('cold')} with, "
          f"{off['labels'].count('cold')} without; {smi_line()}", flush=True)


# -- the suggestion service ----------------------------------------------------

REMOTE_SEED = "17"  # the random suggester's random_state behind the service


def remote_spec_file(src: str, out: str, settings: dict, **spec_kw) -> str:
    """A copy of the spec at ``src`` whose algorithm is ``remote`` over its
    own (keeping its settings) or over ``settings["algorithm"]`` (dropping
    them), with ``settings`` added and ``spec_kw`` set in its ``spec``;
    returns the copy's path."""
    import yaml

    with open(src) as f:
        doc = yaml.safe_load(f)
    algo = doc["spec"]["algorithm"]
    own = algo["algorithmName"]
    settings = {"algorithm": own, **settings}
    kept = algo.get("algorithmSettings") or [] if settings["algorithm"] == own else []
    algo["algorithmName"] = "remote"
    algo["algorithmSettings"] = kept + [{"name": k, "value": v} for k, v in settings.items()]
    doc["spec"].update(spec_kw)
    with open(out, "w") as f:
        yaml.safe_dump(doc, f)
    return out


def in_process_random(n: int):
    """The assignments ``random`` (at ``REMOTE_SEED``) proposes in one call
    of ``n`` for the Hyperband spec's space, sorted."""
    from katib_tpu_torch.core.types import AlgorithmSpec, Experiment
    from katib_tpu_torch.sdk.yaml_spec import load_experiment_yaml
    from katib_tpu_torch.suggest.base import make_suggester

    spec = load_experiment_yaml(HYPERBAND_YAML)
    spec.algorithm = AlgorithmSpec(name="random", settings={"random_state": REMOTE_SEED})
    return sorted(sorted(p.as_dict().items()) for p in
                  make_suggester(spec).get_suggestions(Experiment(spec=spec), n))


def suggest_server_pids() -> set[int]:
    """The running processes whose command line names ``suggest-server``."""
    pids = set()
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/cmdline", "rb") as f:
                    if b"suggest-server" in f.read():
                        pids.add(int(entry))
            except OSError:
                pass
    return pids


def phase_remote(torch) -> None:
    """One suggestion service on the card serving two experiments at once
    (ENAS and a random mnist sweep), then the composer through the CLI."""
    import secrets
    import threading

    from katib_tpu_torch.core.types import Experiment
    from katib_tpu_torch.nas.enas.service import EnasSuggester
    from katib_tpu_torch.orchestrator import Orchestrator
    from katib_tpu_torch.orchestrator.fsck import fsck_experiment
    from katib_tpu_torch.orchestrator.status import read_status
    from katib_tpu_torch.sdk.yaml_spec import load_experiment_yaml
    from katib_tpu_torch.store.base import MemoryObservationStore
    from katib_tpu_torch.suggest.service import serve_suggestions
    from katib_tpu_torch.utils.clock import get_clock

    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip-smoke-remote-")
    token = secrets.token_hex(16)
    svc = serve_suggestions(device="cuda", token=token)
    endpoint = f"http://127.0.0.1:{svc.port}"
    specs = {
        "enas-example": remote_spec_file(
            ENAS_YAML, os.path.join(workdir, "enas.yaml"),
            {"endpoint": endpoint, "token": token}, maxTrialCount=8),
        "hyperband-mnist": remote_spec_file(
            HYPERBAND_YAML, os.path.join(workdir, "mnist.yaml"),
            {"endpoint": endpoint, "token": token, "algorithm": "random",
             "random_state": REMOTE_SEED}, maxTrialCount=8),
    }
    # the served controller's trainings: (device, start, end) on the run's clock
    trainings: list = []
    train_controller = EnasSuggester.train_controller

    def recorded(self, reward):
        t0 = get_clock().time()
        train_controller(self, reward)
        trainings.append((str(self.device), t0, get_clock().time()))

    results: dict = {}

    def run(name: str) -> None:
        try:
            # the memory store: a diverged mnist trial's NaN loss fails it
            # under sqlite (ROADMAP F3)
            orch = Orchestrator(workdir=os.path.join(workdir, "runs"), device="cuda",
                                store=MemoryObservationStore())
            t0 = time.perf_counter()
            exp = orch.run(load_experiment_yaml(specs[name]))
            results[name] = (exp, orch.async_stats, time.perf_counter() - t0)
        except Exception:  # reported below, on the main thread
            import traceback

            results[name] = RuntimeError(traceback.format_exc())

    EnasSuggester.train_controller = recorded
    try:
        threads = [threading.Thread(target=run, args=(n,)) for n in specs]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        both_wall = time.perf_counter() - t0
    finally:
        EnasSuggester.train_controller = train_controller
        svc.stop()
    for name, got in results.items():
        check(not isinstance(got, Exception), f"remote: {name} raised {got}")
    check(set(results) == set(specs), f"remote: runs that did not end {set(specs) - set(results)}")
    runs = os.path.join(workdir, "runs")
    for name, (exp, stats, wall) in results.items():
        conditions = sorted({t.condition.value for t in exp.trials.values()})
        report = fsck_experiment(os.path.join(runs, name), repair=False)
        print(f"remote: {name} through the service: experiment {exp.condition.value} in "
              f"{wall:.2f}s; {len(exp.trials)} trials {conditions}; fsck ok {report.ok()}",
              flush=True)
        engine_stats(f"remote: {name}", stats)
        check(exp.condition.value in SUCCESS and conditions == ["Succeeded"]
              and len(exp.trials) == 8, f"remote: {name} ended {exp.condition} {conditions}")
        check(report.ok(), f"remote: fsck of {name}: {report}")

    # ENAS behind the service: trained once on cuda between its rounds, and
    # round 0 as a fresh in-process suggester of the same spec samples it
    status = read_status(runs, "enas-example")
    _, children = enas_spans(runs, "enas-example")
    spans = [{"args": {"round": 0}, "wall": t0, "dur": t1 - t0} for _, t0, t1 in trainings]
    enas_rounds("remote: enas-example", status["trials"], spans, 2, 4)
    check(all(d.startswith("cuda") for d, _, _ in trainings),
          f"remote: the served controller trained on {trainings}")
    exp_enas = results["enas-example"][0]
    round0 = [t.params()["architecture"] for t in exp_enas.trials.values()
              if t.labels.get("enas-round") == "0"]
    local_spec = load_experiment_yaml(ENAS_YAML)
    local = EnasSuggester(local_spec, device="cuda").get_suggestions(
        Experiment(spec=local_spec), len(round0))
    want = [p.as_dict()["architecture"] for p in local]
    print(f"remote: served ENAS controller on {trainings[0][0]}, trained "
          f"{[round(t1 - t0, 4) for _, t0, t1 in trainings]}s; round 0 architectures equal the "
          f"in-process suggester's on the card: {round0 == want}", flush=True)
    check(round0 == want, f"remote: round 0 {round0} != in-process {want}")
    # the random sweep behind the service: the in-process suggester's points
    exp_mnist = results["hyperband-mnist"][0]
    got = sorted(sorted(t.params().items()) for t in exp_mnist.trials.values())
    check(got == in_process_random(8), "remote: the mnist assignments differ from the "
          f"in-process random suggester's: {got}")
    epochs_run, captures = trial_spans(runs, "hyperband-mnist")
    enas_captures = sorted(c["capture_s"] for c in children.values())
    print(f"remote: mnist assignments equal the in-process random suggester's; "
          f"{len(captures)} of 8 mnist trials captured their epoch, seconds "
          f"{sorted(round(v, 4) for v in captures.values())}; ENAS children's captures "
          f"{[round(v, 4) for v in enas_captures]}", flush=True)
    check(len(captures) == 8 and all(math.isfinite(v) for v in captures.values()),
          f"remote: mnist captures {captures}")
    check(len(enas_captures) == 8 and all(math.isfinite(v) for v in enas_captures),
          f"remote: ENAS captures {enas_captures}")
    bad = {t: e for t, e in epochs_run.items()
           if sorted(e) != list(range(int(exp_mnist.trials[t].params()["epochs"])))}
    check(not bad, f"remote: mnist trials whose epochs differ from their resource: {bad}")
    print(f"remote: both experiments at once {both_wall:.2f}s", flush=True)

    # the composer through the CLI: endpoint auto, a 4-trial mnist sweep
    path = remote_spec_file(HYPERBAND_YAML, os.path.join(workdir, "auto.yaml"),
                            {"endpoint": "auto", "algorithm": "random",
                             "random_state": REMOTE_SEED},
                            maxTrialCount=4, parallelTrialCount=4)
    before = suggest_server_pids()
    log = os.path.join(workdir, "auto.log")
    t0 = time.perf_counter()
    proc = _cli("run", path, "--workdir", os.path.join(workdir, "auto"), "--no-preflight",
                log=log)
    children_seen: set[int] = set()
    # seconds into the run when the child was first seen, and last seen
    child_at = child_gone = math.nan
    while proc.poll() is None and time.perf_counter() - t0 < 300:
        alive = suggest_server_pids() - before
        children_seen |= alive
        if alive and math.isnan(child_at):
            child_at = time.perf_counter() - t0
        if alive:
            child_gone = time.perf_counter() - t0
        time.sleep(0.1)
    rc, out = _wait(proc, log, 30)
    wall = time.perf_counter() - t0
    left = {pid for pid in children_seen if os.path.exists(f"/proc/{pid}")}
    try:
        import cryptography  # noqa: F401
        tls = "TLS (cryptography present)"
    except ImportError:
        tls = "plain HTTP (no cryptography on this host)"
    warned = "serve plain HTTP" in out
    status = read_status(os.path.join(workdir, "auto"), "hyperband-mnist")
    got = sorted(sorted((k, v) for k, v in rec["assignments"].items())
                 for rec in status["trials"].values())
    conditions = sorted({rec["condition"] for rec in status["trials"].values()})
    print(f"remote: composer: run {os.path.basename(path)} with endpoint auto: exit {rc} in "
          f"{wall:.2f}s; {len(status['trials'])} trials {conditions}; the child "
          f"suggest-server pids {sorted(children_seen)}, left running {sorted(left)}; "
          f"transport {tls}; plain-HTTP warning printed: {warned}", flush=True)
    print(f"remote: composer: the child seen from {child_at:.2f}s to {child_gone:.2f}s into "
          f"the run; spans "
          f"{span_totals(os.path.join(workdir, 'auto'), 'hyperband-mnist')}", flush=True)
    cli_engine("remote: composer", out)
    check(rc == 0 and conditions == ["Succeeded"] and len(got) == 4,
          f"remote: composer run exited {rc}:\n{out[-3000:]}")
    check(children_seen and not left, f"remote: composer children {children_seen}, left {left}")
    check(warned == tls.startswith("plain"), f"remote: transport {tls}, warning {warned}")
    check(got == in_process_random(4), f"remote: composer run's assignments {got}")
    print(f"remote: phase {time.perf_counter() - t_phase:.2f}s", flush=True)


# -- the fused mixed-op plan ----------------------------------------------------

# (stride, channels, input size) of FusedSepDil on the main path: a normal
# cell's edges at 16 channels on 32x32, and the first reduction cell's
# stride-2 edges at 32 channels on 32x32 (the reduction halves the size)
FUSED_SHAPES = ((1, 16, 32), (2, 32, 32))
FUSED_F32_ATOL = 1e-4  # float32 with TF32 off: rounding of two summation orders
FUSED_STEPS, FUSED_EPOCHS = 2, 4  # epoch 0 against eager, epochs 1-3 timed
# darts.yaml's operations widened to the four conv primitives the fused plan
# needs, and the two pools (a spec cannot name "none": 7 primitives)
FUSED_OPERATIONS = [
    {"operationType": t, "parameters": [{"name": "filter_size", "parameterType": "categorical",
                                         "feasibleSpace": {"list": sizes}}]}
    for t, sizes in (("separable_convolution", ["3", "5"]), ("dilated_convolution", ["3", "5"]),
                     ("max_pooling", ["3"]), ("avg_pooling", ["3"]))
] + [{"operationType": "skip_connection"}]


def fused_embedded(unfused: dict) -> dict:
    """A ``FusedSepDil`` state dict holding the parameters of the unfused
    ``SepConv``/``DilConv`` modules in ``unfused`` (``{primitive: module}``)."""
    import torch

    from katib_tpu_torch.nas.darts.fused import BRANCH_SPECS

    sd = {}
    for name, _, _, second in BRANCH_SPECS:
        mod = unfused[name]
        first = mod.depthwise[0] if second else mod.depthwise
        sd[f"stage_a.dw_{name}_0"] = first.kernel
        if second:
            sd[f"stage_b.dw_{name}_1"] = mod.depthwise[1].kernel
    sd["pw_0"] = torch.stack([unfused[n].pointwise[0].kernel if s else unfused[n].pointwise.kernel
                              for n, _, _, s in BRANCH_SPECS])
    sd["pw_1"] = torch.stack([unfused[n].pointwise[1].kernel for n, _, _, s in BRANCH_SPECS if s])
    return {k: v.detach().clone() for k, v in sd.items()}


def fused_module_parity(torch) -> None:
    """(a) ``FusedSepDil`` against ``SepConv``/``DilConv`` on the same
    parameters embedded in it, at the main path's shapes and both strides:
    float32 within ``FUSED_F32_ATOL``; in bf16 the fused output no further
    from the float32 value than twice the unfused bf16 output is."""
    from katib_tpu_torch.nas.darts.fused import FUSED_PRIMITIVES, FusedSepDil
    from katib_tpu_torch.nas.darts.ops import build_op

    for stride, c, hw in FUSED_SHAPES:
        gen = torch.Generator().manual_seed(stride)
        mods = {}
        for dtype in (torch.float32, torch.bfloat16):
            mods[dtype] = {n: build_op(n, c, stride, dtype=dtype) for n in FUSED_PRIMITIVES}
            mods[dtype]["fused"] = FusedSepDil(c, stride, dtype=dtype)
        for name, mod in mods[torch.float32].items():
            if name != "fused":
                for m in mod.modules():
                    if m is not mod and hasattr(m, "reset_parameters"):
                        m.reset_parameters(gen)
        mods[torch.float32]["fused"].load_state_dict(fused_embedded(mods[torch.float32]))
        for name, mod in mods[torch.bfloat16].items():
            mod.load_state_dict(mods[torch.float32][name].state_dict())
        x = torch.randn(64, c, hw, hw, generator=gen).cuda()
        xb = x.bfloat16().float()
        with torch.no_grad():
            out = {dtype: {name: mod.cuda()(x if dtype == torch.float32 else xb)
                           for name, mod in ms.items()} for dtype, ms in mods.items()}
            ref = {n: mods[torch.float32][n](xb) for n in FUSED_PRIMITIVES}
        torch.cuda.synchronize()
        f32_err = max(float((out[torch.float32]["fused"][n] - out[torch.float32][n]).abs().max())
                      for n in FUSED_PRIMITIVES)
        bf = {}
        for n in FUSED_PRIMITIVES:
            bf[n] = (float((out[torch.bfloat16]["fused"][n].float() - ref[n]).abs().max()),
                     float((out[torch.bfloat16][n].float() - ref[n]).abs().max()))
        print(f"fused: FusedSepDil vs SepConv/DilConv, stride {stride}, {c} channels, "
              f"{hw}x{hw}, batch 64: float32 max_abs_err={f32_err:.3e} (tolerance "
              f"{FUSED_F32_ATOL}); bf16 max_abs_err against float32, fused/unfused "
              f"{ {n[:-4]: (round(a, 5), round(b, 5)) for n, (a, b) in bf.items()} }", flush=True)
        check(f32_err <= FUSED_F32_ATOL, f"fused plan differs in float32 by {f32_err:.3e}")
        for n, (fused_err, unfused_err) in bf.items():
            check(fused_err <= 2 * unfused_err,
                  f"fused {n} in bf16 is {fused_err:.3e} from float32, the unfused "
                  f"{unfused_err:.3e}")


def phase_fused(torch, mixed_op) -> None:
    """The fused mixed-op plan at the search width: (a) the module against
    the unfused primitives; (b) the fused supernet's captured step replayed
    against the same steps run eagerly, bit for bit, and its mixed-op
    launches per replay; (c) its replayed step's wall, images/s, capture
    seconds and peak memory beside the unfused step's, in this process;
    (d) ``darts_trial`` with ``fused`` through ``Orchestrator.run`` on a
    temporary copy of ``darts.yaml``."""
    import numpy as np
    import yaml

    from katib_tpu_torch.models.augmentation import KEY_OFFSET, random_crop_flip
    from katib_tpu_torch.models.data import load_cifar10
    from katib_tpu_torch.nas.darts.architect import (
        DartsHyper, init_search_state, make_search_step, state_items)
    from katib_tpu_torch.nas.darts.fused import FusedSepDil
    from katib_tpu_torch.nas.darts.model import (
        Alphas, DartsNetwork, init_alphas, mixed_op_launches_per_forward, n_edges)
    from katib_tpu_torch.nas.darts.ops import DEFAULT_PRIMITIVES
    from katib_tpu_torch.nas.darts.search import _draw_epoch_indices, split_train
    from katib_tpu_torch.nas.darts.step_loop import WARMUP_STEPS, StepLoop
    from katib_tpu_torch.orchestrator import Orchestrator
    from katib_tpu_torch.orchestrator.fsck import fsck_experiment
    from katib_tpu_torch.parallel.train import cross_entropy_loss
    from katib_tpu_torch.sdk.yaml_spec import load_experiment_yaml

    fused_module_parity(torch)
    s = DARTS_SETTINGS
    batch, seed = s["batch_size"], 7
    (x_w, y_w), (x_a, y_a) = split_train(load_cifar10(n_train=s["n_train"], n_test=8), seed=seed)
    splits = tuple(torch.from_numpy(np.ascontiguousarray(t)).cuda() for t in (x_w, y_w, x_a, y_a))
    per_step = 5 * mixed_op_launches_per_forward(DARTS_LAYERS, DARTS_NODES)

    def indices(epoch):
        return tuple(ix.reshape(-1, batch) for ix in _draw_epoch_indices(
            seed, epoch, len(x_w), len(x_a), FUSED_STEPS * batch))

    def search(fused: bool):
        net = DartsNetwork(DEFAULT_PRIMITIVES, init_channels=s["init_channels"],
                           num_layers=DARTS_LAYERS, n_nodes=DARTS_NODES, remat=False,
                           fused_convs=fused)
        gen = torch.Generator().manual_seed(seed)
        net.reset_parameters(gen)
        alphas = init_alphas(DARTS_NODES, len(DEFAULT_PRIMITIVES), gen)
        net.cuda()

        def loss_fn(w, a, b):
            return cross_entropy_loss(torch.func.functional_call(net, w, (b[0], a)), b[1])

        hyper = DartsHyper(total_steps=16)
        state = init_search_state({k: v.detach() for k, v in net.named_parameters()},
                                  Alphas(*(a.cuda() for a in alphas)), hyper)
        return net, make_search_step(loss_fn, hyper), state

    def loop(step, state, capture):
        return StepLoop(step, state, splits, FUSED_STEPS, batch, random_crop_flip,
                        seed + KEY_OFFSET, capture=capture)

    def captured(step, state) -> dict:
        torch.cuda.reset_peak_memory_stats()
        mixed_op.launches = 0
        lp = loop(step, state, capture=True)
        lp.run_epoch(*indices(0), window=FUSED_STEPS)
        torch.cuda.synchronize()
        out = {"launches": mixed_op.launches, "per_replay": lp.launches_per_replay,
               "capture_s": lp.capture_s, "times": [],
               "state": {k: v.to("cpu", copy=True) for k, v in state_items(lp.state)},
               "metrics": lp.metrics.to("cpu", copy=True)}
        for epoch in range(1, FUSED_EPOCHS):
            lp.run_epoch(*indices(epoch), window=FUSED_STEPS, step_times=out["times"])
        out["peak"] = torch.cuda.max_memory_allocated()
        return out

    net, step, state = search(True)
    n_fused = sum(isinstance(m, FusedSepDil) for m in net.modules())
    check(n_fused == DARTS_LAYERS * n_edges(DARTS_NODES),
          f"{n_fused} FusedSepDil modules in the fused supernet")
    eager = loop(step, state, capture=False)
    t0 = time.perf_counter()
    eager.run_epoch(*indices(0), window=FUSED_STEPS)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    want = ({k: v.to("cpu", copy=True) for k, v in state_items(eager.state)},
            eager.metrics.to("cpu", copy=True))
    del eager
    runs = {True: captured(step, state)}
    del net, step, state
    runs[False] = captured(*search(False)[1:])
    got = runs[True]
    same_metrics = torch.equal(got["metrics"], want[1])
    differ = sorted(k for k in want[0] if not torch.equal(got["state"][k], want[0][k]))
    print(f"fused: 8 cells x 16 ch x 4 nodes, 8 primitives, batch 64, bf16, no remat, "
          f"{FUSED_STEPS} steps: eager {eager_s:.2f}s; replayed train losses "
          f"{[round(float(v), 6) for v in got['metrics'][0]]}, eager "
          f"{[round(float(v), 6) for v in want[1][0]]}; step metrics bit-equal {same_metrics}; "
          f"state tensors that differ {len(differ)} of {len(want[0])} {differ[:4]}", flush=True)
    predicted = (WARMUP_STEPS + FUSED_STEPS) * per_step
    print(f"fused: mixed_op launches per replay {got['per_replay']} (predicted {per_step}); "
          f"warm-up and {FUSED_STEPS} replays {got['launches']} (predicted {predicted})",
          flush=True)
    check(same_metrics and not differ, "the fused step replayed differs from its eager run")
    check(got["per_replay"] == per_step and got["launches"] == predicted,
          f"fused mixed-op launches {got['per_replay']} per replay, {got['launches']} in all")
    for fused in (True, False):
        r = runs[fused]
        median = statistics.median(r["times"])
        print(f"fused: {'fused  ' if fused else 'unfused'} replayed step median {median:.4f}s "
              f"({[round(t, 4) for t in r['times']]}) = {batch / median:.1f} images/s; capture "
              f"{r['capture_s']:.3f}s (warm-up included); max_memory_allocated "
              f"{r['peak'] / 2**30:.2f} GiB", flush=True)
        check(len(r["times"]) == (FUSED_EPOCHS - 1) * FUSED_STEPS, "timed replays")

    # (d) darts_trial with fused through the orchestrator, on a copy of darts.yaml
    workdir = tempfile.mkdtemp(prefix="chip-smoke-fused-")
    with open(DARTS_YAML) as f:
        doc = yaml.safe_load(f)
    settings = {**ORCH_SETTINGS, "num_epochs": "1", "fused": "true"}
    algo = doc["spec"]["algorithm"]
    algo["algorithmSettings"] = [x for x in algo["algorithmSettings"] if x["name"] not in settings]
    algo["algorithmSettings"] += [{"name": k, "value": v} for k, v in settings.items()]
    doc["spec"]["nasConfig"] = {"graphConfig": {"numLayers": ORCH_LAYERS},
                                "operations": FUSED_OPERATIONS}
    path = os.path.join(workdir, "darts-fused.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)
    spec = load_experiment_yaml(path)
    mixed_op.launches = 0
    t0 = time.perf_counter()
    exp = Orchestrator(workdir=workdir, device="cuda").run(spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mixed_op.launches
    (trial,) = exp.trials.values()
    prims = json.loads(trial.params()["search-space"])
    steps = (int(settings["n_train"]) // 2) // int(settings["batch_size"])
    trial_predicted = ((steps + WARMUP_STEPS) * 5 + 1) * mixed_op_launches_per_forward(
        ORCH_LAYERS, DARTS_NODES)
    report = fsck_experiment(os.path.join(workdir, spec.name), repair=False)
    print(f"fused: darts.yaml copy ({ORCH_LAYERS} layers, {len(prims)} primitives {prims}, "
          f"{settings}) through Orchestrator.run on cuda in {wall:.2f}s: experiment "
          f"{exp.condition.value}; trial {trial.condition.value}; mixed_op launches {launches} "
          f"(predicted {trial_predicted}); spans {span_totals(workdir, spec.name)}; fsck "
          f"{'consistent' if report.ok() else report.lines()}", flush=True)
    check(exp.condition.value in SUCCESS and trial.condition.value == "Succeeded",
          f"fused trial {trial.condition.value}: {trial.message}")
    check(launches == trial_predicted, f"fused trial launched {launches}")
    check(report.ok(), f"fused fsck: {report.lines()}")


# -- the native runtime ---------------------------------------------------------

# native prefetch at the search width: 3 eager steps of batch 64 (384 images)
NATIVE_SETTINGS = {"batch_size": 64, "init_channels": 16, "num_nodes": DARTS_NODES,
                   "num_epochs": 1, "n_train": 384, "n_test": 64, "remat": "false"}
NATIVE_TRIALS = 4


def daemon_pids(journal: str) -> set[int]:
    """The running ``katib-db-manager`` processes serving ``journal``."""
    pids = set()
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/cmdline", "rb") as f:
                    argv = f.read().split(b"\0")
            except OSError:
                continue
            if argv and b"katib-db-manager" in argv[0] and journal.encode() in argv:
                pids.add(int(entry))
    return pids


# every db-manager wrapper started, killed at exit if still running (its
# daemon dies with it: PR_SET_PDEATHSIG)
DB_MANAGERS: list[subprocess.Popen] = []


@atexit.register
def stop_db_managers() -> None:
    for proc in DB_MANAGERS:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def start_db_manager(journal: str, log: str) -> tuple[subprocess.Popen, int]:
    """``python -m katib_tpu_torch db-manager --port 0 --db journal`` in a
    fresh interpreter; returns it and the port its first line names."""
    proc = _cli("db-manager", "--port", "0", "--db", journal, log=log)
    DB_MANAGERS.append(proc)
    deadline = time.perf_counter() + 120
    while time.perf_counter() < deadline:
        with open(log) as f:
            line = f.readline()
        if line.endswith("\n"):
            check(line.startswith("katib-tpu db-manager: 127.0.0.1:"), f"db-manager: {line}")
            return proc, int(line.split()[2].split(":")[1])
        check(proc.poll() is None, f"db-manager exited {proc.returncode}: {line}")
        time.sleep(0.05)
    check(False, "db-manager printed no address in 120 s")


def phase_native(torch, mixed_op) -> None:
    """The native runtime: (a) ``darts_trial`` with ``KATIB_NATIVE_LOADER=1``
    at the search width on eager steps fed by the C++ loaders; (b) a
    ``db-manager`` child serving a 4-trial copy of the Hyperband spec run
    through ``run`` with ``store: remote``, the daemon killed by SIGKILL and
    restarted on its journal, ``metrics`` reading back the same rows; (c) the
    same copy under ``store: native``, beside (b)'s run."""
    import yaml

    from katib_tpu_torch.nas.darts.model import mixed_op_launches_per_forward
    from katib_tpu_torch.nas.darts.ops import DEFAULT_PRIMITIVES
    from katib_tpu_torch.nas.darts.search import darts_trial
    from katib_tpu_torch.native.dbmanager import RemoteObservationStore
    from katib_tpu_torch.orchestrator.status import read_status
    from katib_tpu_torch.runner.context import TrialContext

    # (b) and (c) start first: a db-manager child with a journal, then the
    # two CLI runs at once; (a) runs in this process meanwhile
    workdir = tempfile.mkdtemp(prefix="chip-smoke-native-")
    with open(HYPERBAND_YAML) as f:
        doc = yaml.safe_load(f)
    doc["spec"]["algorithm"] = {"algorithmName": "random", "algorithmSettings": [
        {"name": "random_state", "value": REMOTE_SEED}]}
    doc["spec"].update(maxTrialCount=NATIVE_TRIALS, parallelTrialCount=NATIVE_TRIALS)
    spec_path = os.path.join(workdir, "hyperband-mnist-4.yaml")
    with open(spec_path, "w") as f:
        yaml.safe_dump(doc, f)
    journal = os.path.join(workdir, "obs.journal")
    t_daemon = time.perf_counter()
    daemon, port = start_db_manager(journal, os.path.join(workdir, "daemon.log"))
    daemon_start = time.perf_counter() - t_daemon

    def config(name: str, store: dict) -> str:
        path = os.path.join(workdir, f"{name}.yaml")
        with open(path, "w") as f:
            json.dump({"store": store}, f)  # JSON is YAML
        return path

    def run(backend: str, store: dict):
        """One CLI run with ``store``: its exit code, output and wall."""
        log = os.path.join(workdir, f"{backend}.log")
        t0 = time.perf_counter()
        proc = _cli("--config", config(backend, store), "run", spec_path, "--workdir",
                    os.path.join(workdir, backend), "--no-preflight", log=log)
        rc, out = _wait(proc, log, 300)
        return rc, out, time.perf_counter() - t0

    pool = concurrent.futures.ThreadPoolExecutor(2)
    pending = {backend: pool.submit(run, backend, store) for backend, store in (
        ("remote", {"backend": "remote", "host": "127.0.0.1", "port": port}),
        ("native", {"backend": "native"}))}

    # (a) native prefetch
    out_dir = tempfile.mkdtemp(prefix="chip-smoke-native-darts-")
    ctx = TrialContext({"algorithm-settings": json.dumps(NATIVE_SETTINGS),
                        "search-space": json.dumps(list(DEFAULT_PRIMITIVES)),
                        "num-layers": str(DARTS_LAYERS)},
                       checkpoint_dir=out_dir, device="cuda", step_times=[])
    os.environ["KATIB_NATIVE_LOADER"] = "1"
    mixed_op.launches = 0
    t0 = time.perf_counter()
    try:
        darts_trial(ctx)
    finally:
        del os.environ["KATIB_NATIVE_LOADER"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = (NATIVE_SETTINGS["n_train"] // 2) // NATIVE_SETTINGS["batch_size"]
    predicted = (steps * 5 + 1) * mixed_op_launches_per_forward(DARTS_LAYERS, DARTS_NODES)
    wait = ctx.timings.get("loader_wait_s", math.nan)
    print(f"native: darts_trial with KATIB_NATIVE_LOADER=1 at the search width "
          f"({NATIVE_SETTINGS}), beside the two CLI runs, in {wall:.2f}s: {len(ctx.step_times)} "
          f"eager steps {[round(t, 4) for t in ctx.step_times]}s, loader wait "
          f"{wait / steps:.6f}s per batch; reports {ctx.reports}; mixed_op launches "
          f"{mixed_op.launches} (predicted {predicted})", flush=True)
    check("loader_wait_s" in ctx.timings, "the native loaders did not feed the steps")
    check(len(ctx.step_times) == steps, f"{len(ctx.step_times)} steps, predicted {steps}")
    check(mixed_op.launches == predicted, f"native prefetch trial launched {mixed_op.launches}")
    check([st for st, _ in ctx.reports] == [0]
          and all(math.isfinite(v) for _, m in ctx.reports for v in m.values()),
          f"native prefetch reports {ctx.reports}")

    results = {}
    for backend, future in pending.items():
        rc, out, run_wall = future.result()
        status = read_status(os.path.join(workdir, backend), "hyperband-mnist")
        trials = sorted((status or {}).get("trials") or {})
        conditions = sorted({rec["condition"] for rec in status["trials"].values()})
        results[backend] = trials
        print(f"native: run {os.path.basename(spec_path)} with store {backend}: exit {rc} in "
              f"{run_wall:.2f}s; {len(trials)} trials {conditions}", flush=True)
        cli_engine(f"native: {backend} run", out)
        check(rc == 0 and conditions == ["Succeeded"] and len(trials) == NATIVE_TRIALS,
              f"native: the {backend} run exited {rc}:\n{out[-3000:]}")
    pool.shutdown()

    def rows(p: int) -> dict:
        client = RemoteObservationStore("127.0.0.1", p)
        try:
            return {t: [f"{m.timestamp:.3f}\t{m.step}\t{m.metric_name}\t{m.value}"
                        for m in client.get(t)] for t in results["remote"]}
        finally:
            client.close()

    before = rows(port)
    pids = daemon_pids(journal)
    check(len(pids) == 1, f"native: daemons serving the journal {pids}")
    os.kill(pids.pop(), 9)  # SIGKILL: no shutdown path runs
    rc, _ = _wait(daemon, os.path.join(workdir, "daemon.log"), 30)
    t_daemon = time.perf_counter()
    daemon, port = start_db_manager(journal, os.path.join(workdir, "daemon2.log"))
    restart = time.perf_counter() - t_daemon
    cfg = config("restarted", {"backend": "remote", "host": "127.0.0.1", "port": port})
    readers = {t: _cli("--config", cfg, "metrics", t, log=os.path.join(workdir, f"{t}.metrics"))
               for t in results["remote"]}
    after = {}
    for t, proc in readers.items():
        rc_m, out = _wait(proc, os.path.join(workdir, f"{t}.metrics"), 120)
        check(rc_m == 0, f"native: metrics {t} exited {rc_m}: {out}")
        after[t] = out.strip().splitlines()
    daemon.terminate()
    rc_stop, _ = _wait(daemon, os.path.join(workdir, "daemon2.log"), 30)
    n_rows = sum(len(v) for v in before.values())
    print(f"native: db-manager started in {daemon_start:.2f}s; {n_rows} rows of "
          f"{len(before)} trials through the wire; the daemon killed by SIGKILL (its wrapper "
          f"exited {rc}), restarted on the journal in {restart:.2f}s; metrics read back "
          f"{sum(len(v) for v in after.values())} rows, the same: {after == before}; "
          f"SIGTERM exit {rc_stop}", flush=True)
    check(n_rows > 0 and after == before, "native: the rows read back after the restart differ")
    check(rc_stop == 0, f"native: db-manager exited {rc_stop} on SIGTERM")


# the mesh path: a sharded step's train loss against the unsharded step's,
# both eager in bf16 from the same seed and batches.  The replicas' batch norm
# reduces its statistics in another order than cuDNN's; that difference
# grows step by step (`python3 -m katib_tpu_torch.nas.darts.mesh_drift` on an
# H100: in bf16 the sharded pair drifts as far as an unsharded run on
# permuted rows, 1.8e-3 by step 3, 1.2e-2 by step 16; in float32 within 2.3x
# of the same control; PERF.md, the mesh path).  This trial drifted 3.1e-3
# over 3 steps, 2.3e-2 by step 6 and 4.9e-2 by step 16 on the same card, so
# past a few steps bf16 noise reaches any bound that would still catch a
# defect: 3 steps, 1e-2.
MESH_LOSS_RTOL = 1e-2
# the sharded DARTS trial's depth: one epoch of 3 steps (384 training
# images at batch 64); its eager sharded steps take about 6.7 s each on one card
MESH_DARTS = {"n_train": "384", "num_epochs": "1"}
MESH_EVAL_RTOL = 2e-2
MESH_LM_STEPS = 3
# one ring step's q/k/v gradients, bf16 kernels against the ring over the
# plain inner: the largest error within 2e-2 of the largest gradient
MESH_GRAD_RTOL = 2e-2


def _mesh_darts_run(torch, mixed_op, spec, orch_kw: dict, label: str, gpus=None) -> dict:
    """One ``Orchestrator.run`` of the search-width spec, each bilevel step
    recorded (train loss, wall to the step's completion on the card).
    ``gpus``: the devices a config mesh takes in place of the visible GPUs
    (a list that repeats ``cuda:0`` on one card)."""
    from katib_tpu_torch.nas.darts import search as dsearch
    from katib_tpu_torch.parallel import mesh as pmesh
    from katib_tpu_torch.orchestrator import Orchestrator
    from katib_tpu_torch.orchestrator.fsck import fsck_experiment
    from katib_tpu_torch.store.base import MemoryObservationStore

    losses, walls = [], []
    real = dsearch.make_search_step

    def recording(loss_fn, hyper, mesh=None):
        step = real(loss_fn, hyper, mesh)

        def run(state, train, val):
            t0 = time.perf_counter()
            state, metrics = step(state, train, val)
            torch.cuda.current_stream().synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(metrics["train_loss"])
            return state, metrics

        return run

    workdir = tempfile.mkdtemp(prefix=f"chip-smoke-mesh-{label}-")
    orch = Orchestrator(workdir=workdir, device="cuda", store=MemoryObservationStore(), **orch_kw)
    real_gpus = pmesh.visible_gpus
    dsearch.make_search_step = recording
    if gpus is not None:
        pmesh.visible_gpus = lambda: [torch.device(d) for d in gpus]
    mixed_op.launches = 0
    try:
        t0 = time.perf_counter()
        exp = orch.run(spec)
        wall = time.perf_counter() - t0
    finally:
        dsearch.make_search_step = real
        pmesh.visible_gpus = real_gpus
    launches = mixed_op.launches
    (trial,) = exp.trials.values()
    report = fsck_experiment(os.path.join(workdir, spec.name), repair=False)
    check(exp.condition.value in SUCCESS and trial.condition.value == "Succeeded",
          f"mesh: {label} run {exp.condition.value}: {exp.message} / {trial.message}")
    check(report.ok(), f"mesh: {label} fsck {report.lines()}")
    return {"losses": [float(x) for x in losses], "walls": walls, "launches": launches,
            "wall": wall, "accuracy": exp.optimal.objective_value, "params": trial.params()}


def phase_mesh(torch, mixed_op, fa) -> dict[str, int]:
    """The mesh path on the card: the route, ``dryrun_multigpu(4)``, the
    search-width ``darts_trial`` on ``{data: 2}`` through ``Orchestrator.run``
    against the same trial unsharded, ``transformer_trial`` at the
    long-context width on ``{seq: 4}`` (ring, then Ulysses) against the
    unsharded trial, and one small ring step's gradients against the ring
    over the plain inner.  Returns the kernels' launches on the mesh paths
    (the sharded DARTS run; the ring and Ulysses runs)."""
    from katib_tpu_torch.core.config import KatibConfig
    from katib_tpu_torch.entry import dryrun_multigpu
    from katib_tpu_torch.models import transformer_trial
    from katib_tpu_torch.nas.darts.model import mixed_op_launches_per_forward
    from katib_tpu_torch.ops.flash_attention import reference_attention_with_lse
    from katib_tpu_torch.parallel.mesh import make_mesh
    from katib_tpu_torch.parallel.ring_attention import make_sequence_parallel_attention
    from katib_tpu_torch.runner.context import TrialContext

    smi = smi_line()
    count = torch.cuda.device_count()
    shared = count < 4
    grid = ["cuda:0"] * 4 if shared else [f"cuda:{i}" for i in range(4)]
    pair = ["cuda:0", "cuda:0"] if count < 2 else ["cuda:0", "cuda:1"]
    where = ("replicas share cuda:0 (one card): no transfer between cards is made, and no "
             "time below is a multi-GPU number" if shared else
             "replicas sit on distinct cards (peer copies between them)")
    print(f"mesh: route: torch.cuda.device_count()={count}; {where} [{smi}]", flush=True)
    if count >= 2:
        t0 = time.perf_counter()
        out = dryrun_multigpu(2, devices=["cuda:0", "cuda:1"])
        print(f"mesh: the distinct-card route ran: dryrun_multigpu(2) on cuda:0, cuda:1 "
              f"({out['route']}) passed in {time.perf_counter() - t0:.2f}s: {out}", flush=True)
    else:
        print("mesh: the distinct-card route did not run: one GPU is visible; nothing is "
              "claimed for transfers between cards", flush=True)
        # the same route between distinct devices, with the CPU as the other
        # device: host copies, not peer copies between cards
        t0 = time.perf_counter()
        out = dryrun_multigpu(4, devices=["cuda:0", "cpu", "cuda:0", "cpu"])
        print(f"mesh: the distinct-device route ran between cuda:0 and the CPU "
              f"({out['route']}, replicas on the CPU run the plain versions): "
              f"dryrun_multigpu(4) passed in {time.perf_counter() - t0:.2f}s: {out}",
              flush=True)

    # 1. the gate, on a grid named explicitly
    t0 = time.perf_counter()
    out = dryrun_multigpu(4, devices=grid)
    per_replica = out["darts"]["launches_per_replica"]
    print(f"mesh: dryrun_multigpu(4) on {grid} passed in {time.perf_counter() - t0:.2f}s "
          f"[{smi}]: {out}", flush=True)
    check(min(per_replica) > 0, f"a replica launched no mixed-op kernel: {per_replica}")

    # 2. the search-width DARTS trial on {data: 2}, against the same trial
    # unsharded (eager steps on both sides: the mesh path has no capture)
    t_part = time.perf_counter()
    layers = ORCH_LAYERS
    s = {**ORCH_SETTINGS, **MESH_DARTS}
    epochs, steps = int(s["num_epochs"]), (int(s["n_train"]) // 2) // int(s["batch_size"])
    config = KatibConfig.from_dict({"init": {"mesh_axes": {"data": 2}}})
    sharded = _mesh_darts_run(torch, mixed_op, search_width_spec(MESH_DARTS),
                              {"config": config}, "data2", gpus=pair)
    plain = _mesh_darts_run(torch, mixed_op,
                            search_width_spec({**MESH_DARTS, "step_loop": "false"}), {}, "plain")
    nodes = int(json.loads(sharded["params"]["algorithm-settings"])["num_nodes"])
    per_forward = mixed_op_launches_per_forward(layers, nodes)
    replicas = 2
    predicted = replicas * (epochs * steps * 5 + epochs) * per_forward
    per_step = (sharded["launches"] - replicas * epochs * per_forward) / (replicas * epochs * steps)
    errs = [abs(a - b) / abs(b) for a, b in zip(sharded["losses"], plain["losses"])]
    median = {k: statistics.median(r["walls"][1:]) for k, r in (("data2", sharded),
                                                                ("plain", plain))}
    print(f"mesh: darts_trial at the search width ({layers} layers, batch "
          f"{s['batch_size']}, {s['n_train']} images, {epochs} epochs of {steps} eager steps) "
          f"on {{data: 2}} over {pair} and unsharded, through Orchestrator.run [{smi}]", flush=True)
    print(f"mesh: train_loss data2={[round(x, 5) for x in sharded['losses']]}", flush=True)
    print(f"mesh: train_loss plain={[round(x, 5) for x in plain['losses']]}", flush=True)
    print(f"mesh: step_s data2 first={sharded['walls'][0]:.4f} median_rest={median['data2']:.4f}; "
          f"plain first={plain['walls'][0]:.4f} median_rest={median['plain']:.4f} "
          f"({'replicas sharing one card' if pair[0] == pair[1] else 'two cards'}); "
          f"max rel loss diff={max(errs):.3e} (tolerance {MESH_LOSS_RTOL}); "
          f"accuracy data2={sharded['accuracy']} plain={plain['accuracy']}", flush=True)
    print(f"mesh: mixed_op launches data2={sharded['launches']} predicted={predicted}; per "
          f"replica-step={per_step:g} predicted={5 * per_forward}; plain={plain['launches']}",
          flush=True)
    check(len(sharded["losses"]) == len(plain["losses"]) == epochs * steps,
          f"mesh: steps {len(sharded['losses'])} / {len(plain['losses'])}")
    check(max(errs) <= MESH_LOSS_RTOL, f"mesh: sharded train loss off by {max(errs):.3e}")
    check(sharded["launches"] == predicted,
          f"mesh: mixed-op launched {sharded['launches']}, the path predicts {predicted}")
    check(per_step == 5 * per_forward, f"mesh: {per_step} launches per replica-step")
    print(f"mesh: the two DARTS runs took {time.perf_counter() - t_part:.2f}s "
          f"(sharded {sharded['wall']:.2f}s, unsharded {plain['wall']:.2f}s)", flush=True)
    t_part = time.perf_counter()

    # 3. the long-context LM on {seq: 4}, ring then Ulysses, against unsharded
    params = {**long_context()[0], "steps": MESH_LM_STEPS}
    layers_lm, lm_steps = params["n_layers"], params["steps"]
    evals = sum(1 for i in range(lm_steps) if i % 10 == 0 or i == lm_steps - 1)
    base = TrialContext({k: str(v) for k, v in params.items()}, device="cuda", step_times=[])
    transformer_trial(base)
    want = [m["eval_loss"] for _, m in base.reports]
    lm_mesh = make_mesh({"seq": 4}, devices=grid)
    flash = {"fwd": 0, "dq": 0, "dkv": 0}
    for strategy, chunks in (("ring", 4 * 5 // 2), ("ulysses", 4)):
        ctx = TrialContext({**{k: str(v) for k, v in params.items()}, "attn": strategy},
                           device="cuda", mesh=lm_mesh, step_times=[])
        fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
        transformer_trial(ctx)
        got_launches = {"fwd": fa.fwd_launches, "dq": fa.dq_launches, "dkv": fa.dkv_launches}
        pred = {"fwd": layers_lm * (lm_steps + evals) * chunks,
                "dq": layers_lm * lm_steps * chunks, "dkv": layers_lm * lm_steps * chunks}
        got = [m["eval_loss"] for _, m in ctx.reports]
        errs = [abs(a - b) / abs(b) for a, b in zip(got, want)]
        print(f"mesh: transformer_trial {strategy} on {{seq: 4}} over {grid}: eval_loss {got} "
              f"vs unsharded {want} (max rel {max(errs):.3e}, tolerance {MESH_EVAL_RTOL}); "
              f"step_s {[round(t, 4) for t in ctx.step_times]} vs unsharded "
              f"{[round(t, 4) for t in base.step_times]} [{smi}]", flush=True)
        print(f"mesh: {strategy} flash launches={got_launches} predicted={pred}", flush=True)
        check(len(got) == len(want) == evals, f"mesh: {strategy} reports {ctx.reports}")
        check(max(errs) <= MESH_EVAL_RTOL, f"mesh: {strategy} eval loss off by {max(errs):.3e}")
        check(got_launches == pred, f"mesh: {strategy} flash launched {got_launches}, "
                                    f"predicted {pred}")
        for k in flash:
            flash[k] += got_launches[k]

    print(f"mesh: the three LM runs took {time.perf_counter() - t_part:.2f}s", flush=True)
    # 4. one small ring step's gradients: the kernels against the plain inner
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(1, 2, 256, 64, generator=gen, device="cuda", dtype=torch.bfloat16)
               .requires_grad_(True) for _ in range(3))
    ct = torch.randn(1, 2, 256, 64, generator=gen, device="cuda")
    grads = []
    for inner in (None, lambda a, b, c, causal: reference_attention_with_lse(a, b, c, causal)):
        ring = make_sequence_parallel_attention(lm_mesh, inner=inner)
        grads.append(torch.autograd.grad((ring(q, k, v).float() * ct).sum(), (q, k, v)))
    errs = [float((g.float() - r.float()).abs().max() / r.float().abs().max())
            for g, r in zip(*grads)]
    print(f"mesh: ring step on {{seq: 4}} [1, 2, 256, 64] bf16, dq/dk/dv kernels vs the ring "
          f"over the plain inner: max err / max |grad| = {[f'{e:.3e}' for e in errs]} "
          f"(tolerance {MESH_GRAD_RTOL})", flush=True)
    check(max(errs) <= MESH_GRAD_RTOL, f"mesh: ring gradients off by {errs}")
    return {"mixed_op": sharded["launches"], **flash}


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

    walls: dict[str, float] = {}

    def timed(fn, *args):
        """Run one phase and keep its wall for the ``phases:`` line."""
        t0 = time.perf_counter()
        out = fn(*args)
        walls[fn.__name__.removeprefix("phase_")] = round(time.perf_counter() - t0, 2)
        return out

    max_err = timed(phase_kernel_parity, torch, mixed_op)
    flash_err = timed(phase_flash_parity, torch, fa)
    timing = timed(phase_kernel_timing, torch, mixed_op)
    flash_timing = timed(phase_flash_timing, torch, fa)
    timed(phase_graph_vs_eager, torch)
    launches, darts_dir, darts_reports = timed(phase_main_path, torch, mixed_op)
    timed(phase_resume, darts_dir, darts_reports)
    timed(phase_small_reference, torch)
    timed(phase_orchestrator, torch, mixed_op)
    timed(phase_cli)
    flash_launches = timed(phase_transformer, torch, fa,
                           sum(t["ms"] for t in flash_timing.values()))
    timed(phase_classifier, torch)
    whitebox_wall = timed(phase_hyperband)
    timed(phase_blackbox, whitebox_wall)
    timed(phase_pbt, torch)
    timed(phase_asha, torch)
    timed(phase_async, torch)
    timed(phase_chaos)
    timed(phase_enas_parity, torch)
    timed(phase_enas_width, torch)
    timed(phase_enas_cli)
    timed(phase_enas_sharing, torch)
    timed(phase_cohort, torch)
    timed(phase_pbt_ondevice, torch)
    timed(phase_sdk, torch)
    timed(phase_compile, torch, mixed_op, built)
    timed(phase_remote, torch)
    timed(phase_fused, torch, mixed_op)
    timed(phase_native, torch, mixed_op)
    mesh_launches = timed(phase_mesh, torch, mixed_op, fa)

    kernels = [{
        "name": "mixed_op_sum",
        "route": "cuda",
        "source": "katib_tpu_torch/ops/csrc/mixed_op.cu",
        "replaces": "katib_tpu/ops/mixed_op.py:71",
        "launches": launches,
        "mesh_launches": mesh_launches["mixed_op"],
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
            "mesh_launches": mesh_launches[name],
            "max_abs_err": flash_err[name],
            **flash_timing[name],
        })
    print(f"phases: seconds each {walls}", flush=True)
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
