"""Entry points of the port (counterpart of the JAX package's
``__graft_entry__.py``).

``entry()``              — the supernet forward step of the flagship model
                           (the DARTS supernet) and example arguments, on
                           ``device`` (``cuda`` unless the caller names one).
``dryrun_multigpu(n)``   — the mesh path's gate: one sharded DARTS bilevel
                           step over an ``n``-entry mesh held to the
                           single-device step (sequential and paired
                           Hessian), for ``n % 4 == 0`` one ring-attention
                           LM run held to dense attention, and a
                           trial-sharded cohort held to the single-device
                           cohort, with the JAX gate's tolerances.

``devices=None`` takes ``n`` distinct GPUs and raises when there are fewer;
a grid that repeats a device (``["cuda:0"] * 4`` on one card, CPU entries on
the CPU) is passed explicitly::

    python -c "from katib_tpu_torch.entry import dryrun_multigpu; \\
               dryrun_multigpu(4, devices=['cpu'] * 4)"
"""

from __future__ import annotations

import contextlib
import copy
import time

import numpy as np
import torch

from katib_tpu_torch.nas.darts.model import DartsNetwork, init_alphas
from katib_tpu_torch.nas.darts.ops import DEFAULT_PRIMITIVES
from katib_tpu_torch.ops import mixed_op
from katib_tpu_torch.parallel import mesh as pmesh
from katib_tpu_torch.parallel.collectives import replica_index


def entry(device=None):
    """``(forward, (weights, alphas, x))``: the supernet forward step (4
    layers, 8 channels, 3 nodes) and example arguments on ``device``."""
    from katib_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    net = DartsNetwork(DEFAULT_PRIMITIVES, init_channels=8, num_layers=4, n_nodes=3,
                       remat=False)
    gen = torch.Generator().manual_seed(0)
    net.reset_parameters(gen)
    alphas = init_alphas(3, len(DEFAULT_PRIMITIVES), gen, device=None)
    net.to(dev)
    weights = {k: v.detach() for k, v in net.named_parameters()}

    def forward(weights, alphas, x):
        return torch.func.functional_call(net, weights, (x, alphas))

    x = torch.zeros(8, 32, 32, 3, device=dev)
    return forward, (weights, type(alphas)(*(a.to(dev) for a in alphas)), x)


def _close(got: float, want: float, rel: float) -> bool:
    return abs(got - want) <= rel * max(1.0, abs(want))


@contextlib.contextmanager
def full_float32():
    """Float32 products and convolutions in full float32 on the card for the
    duration: TF32 off for cuBLAS and cuDNN, each setting restored after.
    A float32 parity gate needs it, as PyTorch's default lets cuDNN take
    TF32 (10-bit mantissa) convolutions; the settings are process-wide."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@full_float32()
def _darts_gate(mesh: pmesh.Mesh) -> dict:
    """One sharded bilevel step on ``mesh`` against the single-device step
    on its home device, from the same weights and the same batch, in full
    float32 (the JAX gate's reason: in bf16, sub-noise alpha-gradient
    elements flip sign under a reassociated reduction; TF32 convolutions
    flip them too)."""
    from katib_tpu_torch.nas.darts.architect import (
        DartsHyper,
        init_search_state,
        make_search_step,
    )
    from katib_tpu_torch.parallel.train import cross_entropy_loss

    home = mesh.home
    net = DartsNetwork(DEFAULT_PRIMITIVES, init_channels=4, num_layers=2, n_nodes=2,
                       num_classes=10, remat=False, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    net.reset_parameters(gen)
    alphas = init_alphas(2, len(DEFAULT_PRIMITIVES), gen)
    net.to(home)
    alphas = type(alphas)(*(a.to(home) for a in alphas))
    weights = {k: v.detach() for k, v in net.named_parameters()}
    # random data, deliberately: identical shards would hide wrong routing
    batch = mesh.axis_size(pmesh.DATA_AXIS) * 2
    data_gen = torch.Generator().manual_seed(7)
    x = torch.randn(batch, 16, 16, 3, generator=data_gen).to(home)
    y = torch.randint(0, 10, (batch,), generator=data_gen).to(home)
    nets = [net] + [copy.deepcopy(net) for _ in range(1, mesh.size)]
    launches = [0] * mesh.size

    def loss_fn(w, a, b):
        with mixed_op.tallying() as tally:
            logits = torch.func.functional_call(nets[replica_index()], w, (b[0], a))
        launches[replica_index()] += tally[0]
        return cross_entropy_loss(logits, b[1])

    hyper = DartsHyper(total_steps=10, unrolled=True, debug_alpha_grad=True)

    def one_step(run_mesh, h):
        step = make_search_step(loss_fn, h, run_mesh)
        state = init_search_state(weights, alphas, h)
        b = pmesh.shard_batch((x, y), run_mesh) if run_mesh is not None else (x, y)
        return step(state, b, b)

    state, metrics = one_step(mesh, hyper)
    if int(state.step) != 1:
        raise AssertionError("search step did not advance")
    sharded_launches = list(launches)
    _, ref = one_step(None, hyper)
    out = {"launches_per_replica": sharded_launches}
    for k in ("train_loss", "val_loss"):
        got, want = float(metrics[k]), float(ref[k])
        out[k] = (got, want)
        if not _close(got, want, 1e-3):
            raise AssertionError(f"sharded {k} {got} != single-device {want}")
    for name, h in (("sequential", hyper), ("paired", hyper._replace(paired_hessian=True))):
        _, m = one_step(mesh, h) if name == "paired" else (state, metrics)
        for got, want in zip(m["alpha_grad"], ref["alpha_grad"]):
            np.testing.assert_allclose(
                got.float().cpu().numpy(), want.float().cpu().numpy(), rtol=1e-3, atol=1e-6,
                err_msg=f"{name} second-order alpha gradient diverges across the mesh",
            )
        out[f"alpha_grad_{name}_max_abs_err"] = max(
            float((g.float() - w.float()).abs().max()) for g, w in zip(m["alpha_grad"],
                                                                      ref["alpha_grad"]))
    # a replica on a CUDA device runs the kernel (one on the CPU, its plain version)
    if any(n < 1 for n, d in zip(sharded_launches, mesh.entries) if d.type == "cuda"):
        raise AssertionError(f"a replica on a GPU launched no mixed-op kernel: "
                             f"{sharded_launches} on {[str(d) for d in mesh.entries]}")
    return out


def _lm_gate(devices: list, n: int) -> dict:
    """One ring-attention LM run on ``{data: n/4, seq: 4}`` against dense
    attention on the same data, parameters and seed (2e-2 relative, bf16)."""
    from katib_tpu_torch.models.transformer import (
        TransformerLM,
        make_attention_fn,
        markov_dataset,
        train_lm,
    )

    sp_mesh = pmesh.make_mesh({pmesh.DATA_AXIS: n // 4, pmesh.SEQ_AXIS: 4}, devices=devices)
    # head dim 32, which the flash kernels take (the JAX gate's d_model 32
    # over 4 heads has head dim 8); chunks of 64 tokens per seq replica
    lm_kwargs = dict(vocab_size=64, d_model=128, n_heads=4, n_layers=1, max_seq_len=256)
    tokens = markov_dataset(64, max(8, 2 * (n // 4) + 2), 256, seed=0)
    train_kwargs = dict(lr=1e-3, steps=2, batch_size=max(2, sp_mesh.shape[pmesh.DATA_AXIS]),
                        seed=0)

    def run(model_mesh, attn_fn):
        model = TransformerLM(attn_fn=attn_fn, **lm_kwargs)
        model.reset_parameters(torch.Generator().manual_seed(0))
        return train_lm(model, tokens, mesh=model_mesh, device=sp_mesh.home, **train_kwargs)

    loss_ring = run(sp_mesh, make_attention_fn(sp_mesh, strategy="ring"))
    if not np.isfinite(loss_ring):
        raise AssertionError("ring-attention LM step non-finite loss")
    loss_dense = run(None, None)
    if not _close(loss_ring, loss_dense, 2e-2):
        raise AssertionError(f"ring-attention loss {loss_ring} != dense reference {loss_dense}")
    return {"loss_ring": loss_ring, "loss_dense": loss_dense}


@full_float32()
def _cohort_gate(devices: list, n: int) -> dict:
    """An ``n``-member cohort split over ``{trial: n}`` against the
    single-device cohort, 3 SGD steps at per-member learning rates (rtol
    1e-6, atol 1e-7), its state split over ``trial``."""
    from katib_tpu_torch.models.mnist import Sgd
    from katib_tpu_torch.parallel.train import (
        TrainState,
        make_cohort_train_step,
        stack_pytrees,
    )

    trial_mesh = pmesh.make_mesh({pmesh.TRIAL_AXIS: n}, devices=devices)
    home = trial_mesh.home
    gen = torch.Generator().manual_seed(11)
    cx = torch.randn(16, 8, generator=gen)
    cy = cx.sum(dim=1)
    w0 = torch.randn(8, generator=gen) * 0.1
    cbatch = (cx.to(home), cy.to(home))
    tx = Sgd(momentum=False)

    def cohort_loss(params, b):
        xb, yb = b
        return torch.mean((xb @ params["w"] - yb) ** 2)

    def cohort_states():
        s = stack_pytrees([TrainState.create({"w": w0.to(home)}, tx)] * n)
        hp = dict(s.opt_state.hyperparams)
        hp["learning_rate"] = torch.tensor([0.01 * (i + 1) for i in range(n)],
                                           dtype=torch.float32, device=home)
        return s._replace(opt_state=s.opt_state._replace(hyperparams=hp))

    ref_step = make_cohort_train_step(cohort_loss, tx)
    ref_states = cohort_states()
    for _ in range(3):
        ref_states, ref_m = ref_step(ref_states, cbatch)
    sh_step = make_cohort_train_step(cohort_loss, tx, mesh=trial_mesh)
    sh_states = pmesh.shard_members(cohort_states(), trial_mesh)
    for _ in range(3):
        sh_states, sh_m = sh_step(sh_states, cbatch)
    w = sh_states.params["w"]
    if not (isinstance(w, pmesh.Sharded) and w.placement.axis == pmesh.TRIAL_AXIS):
        raise AssertionError(f"cohort state not split over the trial axis: {w!r}")
    if pmesh.trial_axis_size(trial_mesh) != n:
        raise AssertionError("trial axis size")
    np.testing.assert_allclose(w.full().cpu().numpy(), ref_states.params["w"].cpu().numpy(),
                               rtol=1e-6, atol=1e-7,
                               err_msg="trial-sharded cohort diverges from the single-device "
                                       "cohort")
    np.testing.assert_allclose(sh_m["loss"].cpu().numpy(), ref_m["loss"].cpu().numpy(),
                               rtol=1e-6, atol=1e-7,
                               err_msg="trial-sharded cohort metrics diverge")
    return {"members": n, "max_abs_err": float((w.full() - ref_states.params["w"]).abs().max())}


def dryrun_multigpu(n_devices: int, devices=None) -> dict:
    """The mesh path's gate over ``n_devices`` grid entries (module doc);
    raises ``AssertionError`` on a parity failure and returns the numbers
    it compared."""
    devs = list(devices) if devices is not None else pmesh.visible_gpus()
    if len(devs) < n_devices:
        raise RuntimeError(
            f"dryrun_multigpu({n_devices}) needs {n_devices} distinct GPUs and "
            f"{len(devs)} are visible; pass devices= for a grid that repeats a device"
        )
    devs = devs[:n_devices]
    if n_devices % 2 == 0:
        mesh = pmesh.make_mesh({pmesh.DATA_AXIS: n_devices // 2, pmesh.MODEL_AXIS: 2},
                               devices=devs)
    else:
        mesh = pmesh.make_mesh({pmesh.DATA_AXIS: n_devices}, devices=devs)
    seconds = {}
    t0 = time.perf_counter()
    out = {"mesh": dict(mesh.shape), "route": mesh.route, "darts": _darts_gate(mesh)}
    seconds["darts"] = round(time.perf_counter() - t0, 3)
    if n_devices >= 4 and n_devices % 4 == 0:
        t0 = time.perf_counter()
        out["lm"] = _lm_gate(devs, n_devices)
        seconds["lm"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    out["cohort"] = _cohort_gate(devs, n_devices)
    seconds["cohort"] = round(time.perf_counter() - t0, 3)
    out["seconds"] = seconds
    return out
