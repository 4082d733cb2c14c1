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
   run eagerly on the card (search width, ``remat_policy="dots"``, 3 steps);
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
   ``experiment_spec_from_dict``, ``Orchestrator.run`` on ``cuda``, the
   DARTS suggester, ``run_trial`` and ``darts_trial``, with the mixed-op
   launch count set to 0 just before and read just after; the same trial
   parameters through ``darts_trial`` directly, for the orchestrator's
   overhead;
8. drive the CLI: ``python -m katib_tpu_torch run examples/nas/darts.yaml``
   as shipped, in a fresh interpreter, SIGTERM once the trial is journaled
   running (the drain lands at epoch 0's report; exit 75), then
   ``--resume`` to its end, ``fsck`` clean and each epoch reported once;
   then ``python -m katib_tpu_torch doctor``;
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
   32-trial Hyperband sweep of ``mnist_trial``, 16 trials at a time), then
   check the experiment, its rungs, each trial's reported epochs and
   ``fsck``.

Its last three lines are the ``{"kernels": [...]}`` JSON line, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": {...}}``.
The script needs a CUDA GPU and the ``katib_tpu_torch`` package beside it,
and exits nonzero without printing a result when either is missing.
"""

from __future__ import annotations

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
    ``remat_policy="dots"``: a window of 3 steps run eagerly on the card and
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
    steps, batch = 3, s["batch_size"]
    net = DartsNetwork(DEFAULT_PRIMITIVES, init_channels=s["init_channels"], num_layers=DARTS_LAYERS,
                       n_nodes=DARTS_NODES, remat=True, remat_policy="dots")
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
    print(f"graph vs eager: 8 cells, remat dots, search augment, {steps} steps: eager "
          f"{eager_s:.2f}s, capture {capture_s:.2f}s (warm-up included) + replays "
          f"{graph_s - capture_s:.2f}s; train losses eager "
          f"{[round(float(v), 6) for v in eager_m[0]]} graph "
          f"{[round(float(v), 6) for v in graph_m[0]]}; step metrics max rel diff "
          f"{loss_rel:.2e}; steps {int(eager['step'])} and {int(graph['step'])}", flush=True)
    check(int(eager["step"]) == int(graph["step"]) == steps, "both runs take 3 steps")
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
    with classifier_captures() as augment_captures:
        t0 = time.perf_counter()
        darts_trial(ctx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
def classifier_captures():
    """Collect the seconds of every classifier-step capture (warm-up
    included) that ``EpochLoop`` makes inside the block."""
    from katib_tpu_torch.models.mnist import EpochLoop

    seconds: list[float] = []
    build = EpochLoop._build_graph

    def recording(loop):
        build(loop)
        seconds.append(loop.capture_s)

    EpochLoop._build_graph = recording
    try:
        yield seconds
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


def search_width_spec():
    """``darts.yaml`` through the SDK entry with the search width set."""
    import yaml

    from katib_tpu_torch.sdk.yaml_spec import experiment_spec_from_dict

    with open(DARTS_YAML) as f:
        doc = yaml.safe_load(f)
    algo = doc["spec"]["algorithm"]
    algo["algorithmSettings"] = [s for s in algo["algorithmSettings"]
                                 if s["name"] not in ORCH_SETTINGS]
    algo["algorithmSettings"] += [{"name": k, "value": v} for k, v in ORCH_SETTINGS.items()]
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


def phase_orchestrator(torch, mixed_op) -> None:
    """The search-width spec through ``Orchestrator.run`` on ``cuda``,
    between runs of its trial's parameters through ``darts_trial`` directly:
    one before (it pays what a network's first run in a process pays), one
    on a pool thread as the orchestrator runs trials, one after."""
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
    after, after_wall = direct()
    direct_wall = min(before_wall, after_wall)

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
          f"before={before_wall:.3f}s, on a pool thread={pooled_wall:.3f}s, after={after_wall:.3f}s "
          f"(graph capture {ctx.timings.get('graph_capture_s', math.nan):.3f}s, "
          f"{pooled.timings.get('graph_capture_s', math.nan):.3f}s and "
          f"{after.timings.get('graph_capture_s', math.nan):.3f}s); "
          f"overhead per trial against the "
          f"faster direct run: run-direct={run_wall - direct_wall:.3f}s "
          f"trial-direct={trial_wall - direct_wall:.3f}s", flush=True)
    print(f"orchestrator: spans {span_totals(workdir, spec.name)}", flush=True)
    print(f"orchestrator: mixed_op launches={launches} predicted={predicted}; fsck "
          f"{'consistent' if report.ok() else report.lines()}", flush=True)
    check(exp.condition.value in SUCCESS, f"experiment ended {exp.condition.value}: {exp.message}")
    check(trial.condition.value == "Succeeded", f"trial {trial.condition.value}: {trial.message}")
    check(0.0 <= accuracy <= 1.0, f"optimal accuracy {accuracy}")
    check(launches == predicted, f"mixed-op kernel launched {launches}, the path predicts {predicted}")
    check(report.ok(), f"fsck: {report.lines()}")
    check([st for st, _ in ctx.reports] == [0, 1], f"direct run reports {ctx.reports}")


def _cli(*args: str, log: str) -> subprocess.Popen:
    """``python -m katib_tpu_torch ...`` in a fresh interpreter, its output to ``log``."""
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-m", "katib_tpu_torch", *args], cwd=HERE,
                                env={**os.environ, "PYTHONPATH": HERE}, stdout=f,
                                stderr=subprocess.STDOUT, text=True)


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
    fsck'd; then ``doctor``."""
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
        status = read_status(workdir, name)
        if status and status.get("trials"):
            trial = next(iter(status["trials"]))
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
    check(rc == 75, f"drained CLI run exited {rc}:\n{out[-3000:]}")
    check(status["trials"][trial]["condition"] == "Drained", "the trial settled Drained")
    check(first_steps == [0], f"the drained run reported epochs {first_steps}, not [0]")

    t0 = time.perf_counter()
    rc, out = _wait(_cli(*run, "--resume", log=log), log, 600)
    resume_wall = time.perf_counter() - t0
    status = read_status(workdir, name)
    lines = [ln for ln in out.splitlines() if ln.startswith(("experiment ", "optimal trial "))]
    print(f"cli: --resume exit {rc} in {resume_wall:.2f}s: {lines}; trial "
          f"{status['trials'][trial]['condition']}; accuracy reported at epochs {steps(trial)}",
          flush=True)
    print(f"cli: both runs' spans {span_totals(workdir, name)}", flush=True)
    check(rc == 0 and status["condition"] in SUCCESS, f"resumed run exited {rc}:\n{out[-3000:]}")
    check(list(status["trials"]) == [trial], "the resumed run reran the drained trial only")
    check(status["trials"][trial]["condition"] == "Succeeded", "the resumed trial succeeded")
    check(steps(trial) == [0, 1], f"epochs reported {steps(trial)}, each should be once")
    check(any(ln.startswith(f"optimal trial {trial}: accuracy=") for ln in lines),
          "the CLI printed the optimal accuracy")

    rc, out = _wait(_cli("fsck", os.path.join(workdir, name), log=log), log, 120)
    print(f"cli: fsck exit {rc}: {out.strip().splitlines()[-1]}", flush=True)
    check(rc == 0 and "result: consistent" in out, f"fsck:\n{out}")

    t0 = time.perf_counter()
    rc, out = _wait(_cli("doctor", log=log), log, 180)
    print(f"doctor: exit {rc} in {time.perf_counter() - t0:.2f}s: "
          f"{' | '.join(out.strip().splitlines())}", flush=True)
    check(rc == 0 and out.startswith("pool healthy"), f"doctor:\n{out}")


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


def phase_hyperband() -> None:
    """``python -m katib_tpu_torch run katib_tpu_torch/specs/hyperband-mnist.yaml``
    in a fresh interpreter: 32 trials ``Succeeded``, ``MaxTrialsReached``,
    the Hyperband rung table, every trial's epochs run once each, one graph
    capture per trial, ``fsck`` clean."""
    from katib_tpu_torch.orchestrator.status import read_status

    workdir = tempfile.mkdtemp(prefix="chip-smoke-hyperband-")
    name, log = "hyperband-mnist", os.path.join(workdir, "run.log")
    t0 = time.perf_counter()
    rc, out = _wait(_cli("run", HYPERBAND_YAML, "--workdir", workdir, log=log), log, 600)
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
    print(f"hyperband: run {os.path.relpath(HYPERBAND_YAML, HERE)}: exit {rc} in {wall:.2f}s = "
          f"{len(trials) / wall * 3600:.0f} trials/hour; experiment {status['condition']}; "
          f"{len(trials)} trials {conditions}", flush=True)
    print(f"hyperband: rungs (s, i) -> (trials, epochs) {table}", flush=True)
    print(f"hyperband: best accuracy (synthetic MNIST) {optimal.get('objective_value')} by "
          f"{optimal.get('trial_name')} {optimal.get('assignments')}; {len(chance)} trials "
          f"ended below 0.2 accuracy, at lr {[round(v, 4) for v in chance]}",
          flush=True)
    print(f"hyperband: trial seconds min {seconds[0]:.3f} median {statistics.median(seconds):.3f} "
          f"max {seconds[-1]:.3f}; graph capture seconds per trial ({len(capture_s)}, under "
          f"the device's capture lock): min {min(capture_s, default=math.nan):.3f} median "
          f"{statistics.median(capture_s) if capture_s else math.nan:.3f} max "
          f"{max(capture_s, default=math.nan):.3f}", flush=True)
    print(f"hyperband: run spans {span_totals(workdir, name)}", flush=True)
    for t, rec in sorted(trials.items()):
        if rec["condition"] != "Succeeded":
            print(f"hyperband: {t} {rec['condition']}: {rec['message']}", flush=True)
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
    print(f"hyperband: fsck exit {rc}: {out.strip().splitlines()[-1]}", flush=True)
    check(rc == 0 and "result: consistent" in out, f"fsck:\n{out}")


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
    phase_graph_vs_eager(torch)
    launches, darts_dir, darts_reports = phase_main_path(torch, mixed_op)
    phase_resume(darts_dir, darts_reports)
    phase_small_reference(torch)
    phase_orchestrator(torch, mixed_op)
    phase_cli()
    flash_launches = phase_transformer(
        torch, fa, sum(t["ms"] for t in flash_timing.values()))
    phase_classifier(torch)
    phase_hyperband()

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
