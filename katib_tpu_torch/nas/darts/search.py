"""DARTS search loop: the white-box trial workload (port of
``katib_tpu/nas/darts/search.py``).

Split the train data 50/50 into a w-set and an alpha-set, run one bilevel
step per batch pair, evaluate each epoch, and write the discrete genotype
to ``genotype.json`` in the trial's checkpoint dir.  The splits live on the
device for the whole search and each batch is gathered there from the
per-epoch permutation indices, which are the JAX package's own draws, so
batch composition is the same in both packages.  Steps run eagerly, one
Python step per iteration.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from katib_tpu_torch.device import resolve_device
from katib_tpu_torch.models.data import Dataset, load_named_dataset
from katib_tpu_torch.nas.darts.architect import (
    DartsHyper,
    SearchState,
    init_search_state,
    make_search_step,
)
from katib_tpu_torch.nas.darts.model import (
    Alphas,
    DartsNetwork,
    extract_genotype,
    init_alphas,
)
from katib_tpu_torch.nas.darts.ops import DEFAULT_PRIMITIVES
from katib_tpu_torch.parallel.train import accuracy, cross_entropy_loss
from katib_tpu_torch.utils.booleans import parse_bool

EVAL_IMAGES = 1024


def _draw_epoch_indices(seed: int, epoch: int, n_w: int, n_a: int, n_used: int):
    """Per-epoch batch permutations, one stream per (seed, epoch): w's draw
    first, then a's (the JAX package's draw, so batches match)."""
    erng = np.random.default_rng([seed, epoch])
    return erng.permutation(n_w)[:n_used], erng.permutation(n_a)[:n_used]


def split_train(dataset: Dataset, seed: int):
    """The 50/50 split: w trains on one half, alpha on the other."""
    rng = np.random.default_rng(seed)
    n = len(dataset.x_train)
    perm = rng.permutation(n)
    half = n // 2
    w_idx, a_idx = perm[:half], perm[half:]
    return (
        (dataset.x_train[w_idx], dataset.y_train[w_idx]),
        (dataset.x_train[a_idx], dataset.y_train[a_idx]),
    )


def search_epochs(
    net: DartsNetwork,
    state: SearchState,
    dataset: Dataset,
    *,
    hyper: DartsHyper,
    num_epochs: int,
    batch_size: int,
    seed: int,
    device: torch.device,
    report: Callable | None = None,
    step_times: list | None = None,
) -> tuple[SearchState, list[dict]]:
    """The epoch loop from ``state``: returns the final state and one history
    row per epoch; its ``steps`` holds each step's metrics (floats, and the
    raw ``alpha_grad`` on the CPU when ``hyper.debug_alpha_grad`` is set).

    ``step_times``, when given, receives each step's wall seconds, measured
    to the device's completion of the step."""

    def loss_fn(w, a, batch):
        x, y = batch
        return cross_entropy_loss(torch.func.functional_call(net, w, (x, a)), y)

    search_step = make_search_step(loss_fn, hyper)
    (x_w, y_w), (x_a, y_a) = split_train(dataset, seed)
    xw_d, yw_d, xa_d, ya_d = (
        torch.from_numpy(np.ascontiguousarray(t)).to(device) for t in (x_w, y_w, x_a, y_a)
    )
    ne = min(len(dataset.x_test), EVAL_IMAGES)
    x_eval = torch.from_numpy(dataset.x_test[:ne]).to(device)
    y_eval = torch.from_numpy(dataset.y_test[:ne]).to(device)
    steps = len(x_w) // batch_size
    best_acc = 0.0
    history: list[dict] = []
    t0 = time.perf_counter()
    for epoch in range(num_epochs):
        n_used = steps * batch_size
        w_ix, a_ix = _draw_epoch_indices(seed, epoch, len(x_w), len(x_a), n_used)
        w_ix = torch.from_numpy(w_ix.reshape(steps, batch_size)).to(device)
        a_ix = torch.from_numpy(a_ix.reshape(steps, batch_size)).to(device)
        step_metrics = []
        for i in range(steps):
            t_step = time.perf_counter()
            wi, ai = w_ix[i], a_ix[i]
            state, metrics = search_step(state, (xw_d[wi], yw_d[wi]), (xa_d[ai], ya_d[ai]))
            # metrics stay on the device until the epoch ends: one transfer
            step_metrics.append(metrics)
            if step_times is not None:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                step_times.append(time.perf_counter() - t_step)
        step_metrics = [
            {k: Alphas(*(t.cpu() for t in v)) if k == "alpha_grad" else float(v)
             for k, v in m.items()}
            for m in step_metrics
        ]
        with torch.no_grad():
            logits = torch.func.functional_call(net, state.weights, (x_eval, state.alphas))
            val_acc = float(accuracy(logits, y_eval))
            val_loss = float(cross_entropy_loss(logits, y_eval))
        best_acc = max(best_acc, val_acc)
        train_loss = sum(m["train_loss"] for m in step_metrics) / max(steps, 1)
        history.append({
            "epoch": epoch,
            "val_accuracy": val_acc,
            "val_loss": val_loss,
            "train_loss": train_loss,
            "steps": step_metrics,
            "elapsed_s": round(time.perf_counter() - t0, 3),
            "best_accuracy": best_acc,
        })
        if report is not None and report(epoch=epoch, accuracy=val_acc, loss=train_loss) is False:
            break
    return state, history


def run_darts_search(
    dataset: Dataset,
    *,
    primitives=DEFAULT_PRIMITIVES,
    num_layers: int = 8,
    init_channels: int = 16,
    n_nodes: int = 4,
    stem_multiplier: int = 3,
    num_epochs: int = 10,
    batch_size: int = 128,
    hyper: DartsHyper | None = None,
    seed: int = 0,
    report=None,
    remat: bool = True,
    remat_policy: str | None = None,
    device: str | torch.device | None = None,
    step_times: list | None = None,
) -> dict[str, Any]:
    """Run the bilevel architecture search; returns genotype + final metrics.

    Runs in bf16 on ``device`` (``cuda`` unless the caller names another;
    raises when CUDA is asked for and absent).  Weights and alphas are drawn
    from a ``torch.Generator`` seeded with ``seed``.  ``step_times``: see
    :func:`search_epochs`."""
    dev = resolve_device(device)
    net = DartsNetwork(
        primitives=tuple(primitives),
        init_channels=init_channels,
        num_layers=num_layers,
        n_nodes=n_nodes,
        num_classes=dataset.num_classes,
        stem_multiplier=stem_multiplier,
        in_channels=dataset.input_shape[-1],
        remat=remat,
        remat_policy=remat_policy,
    )
    gen = torch.Generator().manual_seed(seed)
    net.reset_parameters(gen)
    alphas = init_alphas(n_nodes, len(primitives), gen)
    net.to(dev)
    half = len(dataset.x_train) // 2
    steps_per_epoch = max(1, half // batch_size)
    hyper = (hyper or DartsHyper())._replace(total_steps=max(1, steps_per_epoch * num_epochs))
    weights = {k: v.detach() for k, v in net.named_parameters()}
    state = init_search_state(weights, Alphas(*(a.to(dev) for a in alphas)), hyper)
    state, history = search_epochs(
        net, state, dataset, hyper=hyper, num_epochs=num_epochs, batch_size=batch_size,
        seed=seed, device=dev, report=report, step_times=step_times,
    )
    alphas = Alphas(*(a.cpu() for a in state.alphas))
    return {
        "genotype": extract_genotype(alphas, primitives, n_nodes=n_nodes),
        "best_accuracy": max((h["val_accuracy"] for h in history), default=0.0),
        "history": history,
        "alphas": alphas,
    }


_STEP_LOOP = "the lax.scan step loop (device-resident windowed steps)"


def _reject_unported(settings: dict) -> None:
    """Raise for settings that ask for parts of the JAX trial not ported yet
    (ROADMAP.md): never run without what was asked for."""
    asked = [
        ("step_loop", _STEP_LOOP, parse_bool(settings.get("step_loop"))),
        ("step_loop_window", _STEP_LOOP, settings.get("step_loop_window") is not None),
        ("stepLoopWindow", _STEP_LOOP, settings.get("stepLoopWindow") is not None),
        ("fused", "the fused mixed-op plan (nas/darts/fused.py)",
         parse_bool(settings.get("fused"))),
        ("search_augment", "search augmentation (models/augmentation.py)",
         parse_bool(settings.get("search_augment"))),
        ("augment_epochs", "the augment phase (nas/darts/augment.py)",
         int(settings.get("augment_epochs", 0)) > 0),
    ]
    for name, what, engaged in asked:
        if engaged:
            raise NotImplementedError(
                f"setting {name}={settings[name]!r} asks for {what}, not ported yet"
            )


def darts_trial(ctx) -> None:
    """White-box DARTS trial (reference workload ``run_trial.py`` main).

    Consumes the three parameters the DARTS suggester emits:
    ``algorithm-settings`` (JSON dict), ``search-space`` (JSON list of
    primitives), ``num-layers``.  Runs on ``ctx.device`` (``cuda`` unless
    it names the CPU)."""
    settings = json.loads(ctx.params.get("algorithm-settings", "{}"))
    primitives = tuple(json.loads(ctx.params.get("search-space", "null")) or DEFAULT_PRIMITIVES)
    num_layers = int(ctx.params.get("num-layers", 8))
    _reject_unported(settings)
    if ctx.checkpoint_dir and os.path.isdir(os.path.join(ctx.checkpoint_dir, "search")):
        raise NotImplementedError(
            "the trial's checkpoint dir holds a search snapshot to resume from; "
            "checkpoint and resume (utils/checkpoint.py) are not ported yet"
        )

    n_train = settings.get("n_train")
    n_test = settings.get("n_test")
    dataset = load_named_dataset(
        str(settings.get("dataset", "cifar10")),
        int(n_train) if n_train is not None else None,
        int(n_test) if n_test is not None else None,
    )
    # DartsHyper's field defaults are the single source of truth; settings
    # override field-by-field (total_steps is derived from the schedule)
    overrides = {}
    for name in DartsHyper._fields:
        if name == "total_steps" or name not in settings:
            continue
        raw = settings[name]
        default = DartsHyper._field_defaults.get(name)
        if isinstance(default, bool):
            overrides[name] = parse_bool(raw, default=default)
        else:
            overrides[name] = float(raw)
    hyper = DartsHyper(**overrides)

    def report(epoch, accuracy, loss):
        return ctx.report(step=epoch, accuracy=accuracy, loss=loss)

    result = run_darts_search(
        dataset,
        primitives=primitives,
        num_layers=num_layers,
        init_channels=int(settings.get("init_channels", 16)),
        n_nodes=int(settings.get("num_nodes", 4)),
        stem_multiplier=int(settings.get("stem_multiplier", 3)),
        num_epochs=int(settings.get("num_epochs", 10)),
        batch_size=int(settings.get("batch_size", 128)),
        hyper=hyper,
        report=report,
        remat=parse_bool(settings.get("remat"), default=True),
        remat_policy=(
            str(settings["remat_policy"])
            if settings.get("remat_policy") not in (None, "")
            else None
        ),
        device=ctx.device,
        step_times=ctx.step_times,
    )
    out_dir = ctx.ensure_checkpoint_dir()
    with open(os.path.join(out_dir, "genotype.json"), "w") as f:
        json.dump(
            {
                "normal": result["genotype"].normal,
                "reduce": result["genotype"].reduce,
                "best_accuracy": result["best_accuracy"],
            },
            f,
            indent=2,
        )
