"""DARTS search loop: the white-box trial workload (port of
``katib_tpu/nas/darts/search.py``).

Split the train data 50/50 into a w-set and an alpha-set, run one bilevel
step per batch pair, evaluate each epoch, and write the discrete genotype
to ``genotype.json`` in the trial's checkpoint dir.  The splits live on the
device for the whole search and each batch is gathered there from the
per-epoch permutation indices, which are the JAX package's own draws, so
batch composition is the same in both packages.

Two ways to step, chosen as the JAX package chooses them (parameter, then
environment variable, then default):

- **the step loop** (the default): windows of steps over the device-resident
  splits, each step one replay of a captured CUDA graph on the card and one
  eager call of the same function on the CPU (``step_loop.py``); per-step
  losses stay on the device and are fetched once per epoch;
- **eager stepping** (``step_loop=False`` or ``KATIB_STEP_LOOP=0``): one
  Python call of the bilevel step per batch, each history row carrying its
  steps' metrics; ``KATIB_DEVICE_DATA=0`` gathers these batches on the host,
  and native prefetch (``native_prefetch=True`` or ``KATIB_NATIVE_LOADER=1``)
  has two C++ loaders (``native/dataloader.py``) gather them on worker
  threads while the card steps.  A loader that cannot start raises; the
  JAX package warns and gathers in Python instead.

``fused=True`` (the trial setting ``fused``) runs the fused mixed-op plan
(``fused.py``); a snapshot of the other plan raises instead of restoring.

On a ``mesh`` (``parallel/mesh.py``; the trial's ``ctx.mesh``) each step is
the sharded bilevel step (``architect.py::make_search_step``) run eagerly:
the splits stay on the mesh's home device, each batch is gathered there,
augmented, and placed on the data axis.  The network is the one of a single
device: its depthwise convolutions keep the native form on every mesh
(``ops/depthwise.py``).  What the mesh path does not have yet raises ``NotImplementedError`` naming ROADMAP
item 9b: capturing the sharded step (an explicit step loop), remat's
recompute (a recomputed batch norm cannot rejoin the replicas' all-reduce,
so a mesh keeps activations), and the fused plan.

With a checkpoint dir the state is saved after every epoch and a restarted
search resumes at the newest snapshot that verifies, its history, best
accuracy and elapsed time continued (``utils/checkpoint.py``).

``KATIB_EPOCH_TRACE=1`` prints the JAX package's ``epoch-trace:`` tags (the
seconds since the previous tag, per phase of each epoch).
``KATIB_SCAN_UNROLL`` (the JAX ``lax.scan`` unroll of the step loop) has no
counterpart under graph replay: ``1`` is accepted, anything else raises.
Each epoch publishes the JAX package's step-time, throughput, device-memory
and steps-per-dispatch gauges and one ``darts.epoch`` span; the epoch that
captured the step's graph also carries ``graph_capture_s`` in its span.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import shutil
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch

from katib_tpu_torch.device import resolve_device
from katib_tpu_torch.models.augmentation import KEY_OFFSET
from katib_tpu_torch.models.data import Dataset, load_named_dataset
from katib_tpu_torch.nas.darts.architect import (
    DartsHyper,
    SearchState,
    init_search_state,
    make_search_step,
    state_from_items,
    state_items,
)
from katib_tpu_torch.nas.darts.model import (
    Alphas,
    DartsNetwork,
    extract_genotype,
    init_alphas,
)
from katib_tpu_torch.nas.darts.ops import DEFAULT_PRIMITIVES
from katib_tpu_torch.nas.darts.step_loop import METRICS, StepLoop
from katib_tpu_torch.parallel.collectives import replica_index
from katib_tpu_torch.parallel.mesh import shard_batch
from katib_tpu_torch.parallel.train import accuracy, cross_entropy_loss, make_eval_step
from katib_tpu_torch.utils import observability as obs
from katib_tpu_torch.utils import tracing
from katib_tpu_torch.utils.booleans import parse_bool
from katib_tpu_torch.utils.checkpoint import TrialCheckpointer
from katib_tpu_torch.utils.fsio import atomic_replace

EVAL_IMAGES = 1024
SEARCH_META = "search_meta.json"


class StepLoopUnavailable(RuntimeError):
    """An explicitly requested step loop cannot engage (the JAX package's
    class of the same name): raised instead of running the eager path."""


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


def read_search_meta(checkpoint_dir: str) -> dict | None:
    try:
        with open(os.path.join(checkpoint_dir, SEARCH_META)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def _write_search_meta(checkpoint_dir: str, meta: dict) -> None:
    atomic_replace(os.path.join(checkpoint_dir, SEARCH_META), json.dumps(meta).encode())


def check_plan(checkpoint_dir: str, fused: bool) -> None:
    """Raise when the search snapshot under ``checkpoint_dir`` was written
    by the other mixed-op plan (``search_meta.json``'s ``fused``, False when
    absent): its parameter tree cannot restore into this network."""
    meta = read_search_meta(checkpoint_dir)
    if meta is not None and bool(meta.get("fused", False)) != bool(fused):
        plans = {True: "the fused mixed-op plan", False: "the unfused plan"}
        raise ValueError(
            f"the search snapshot in {checkpoint_dir} was written by {plans[not fused]}; "
            f"this search runs {plans[bool(fused)]}, whose parameter tree differs"
        )


@dataclasses.dataclass
class Resumed:
    """Where a restarted search continues: the first epoch to run, the
    history before it, the best accuracy and the elapsed seconds so far."""

    start_epoch: int = 0
    history: list = dataclasses.field(default_factory=list)
    best_accuracy: float = 0.0
    elapsed_s: float = 0.0


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
    step_loop: bool = False,
    window: int | None = None,
    device_data: bool = True,
    augment_fn: Callable | None = None,
    checkpointer: TrialCheckpointer | None = None,
    resumed: Resumed | None = None,
    timings: dict | None = None,
    loaders: tuple | None = None,
    split: tuple | None = None,
    mesh=None,
) -> tuple[SearchState, list[dict]]:
    """The epoch loop from ``state``: returns the final state and the
    history, one row per epoch (after ``resumed.history``, when resuming).

    ``step_loop``: windows of ``window`` steps (default the whole epoch)
    through :class:`StepLoop`; the rows then carry what the JAX package's
    carry.  Otherwise eager steps, each row's ``steps`` holding each step's
    metrics (floats, and the raw ``alpha_grad`` on the CPU when
    ``hyper.debug_alpha_grad`` is set); ``device_data=False`` gathers their
    batches on the host.  ``augment_fn(key, step, x)`` transforms each
    w-batch, keyed with ``seed + 0x5EED`` and the state's step counter.

    ``step_times``, when given, receives each step's wall seconds, measured
    to the device's completion of the step.  ``checkpointer``: save the
    state after each epoch, before the report, with ``search_meta.json``
    beside it (recording ``net``'s mixed-op plan).  ``timings`` receives
    ``graph_capture_s`` under the step loop on the card.  ``loaders``: the
    w- and alpha-split :class:`~katib_tpu_torch.native.NativeBatchLoader`
    feeding the eager steps (with ``device_data=False``), one epoch of each
    per epoch, in lockstep; ``timings`` then receives ``loader_wait_s``,
    the seconds spent waiting for their batches.  ``split``: the
    :func:`split_train` of ``dataset`` and ``seed``, when the caller has
    it already.  ``mesh``: eager sharded steps and a sharded evaluation
    (``device`` is then the mesh's home device)."""
    # functional_call rebinds a module's parameters while it runs, so each
    # replica of a mesh calls its own copy of the network
    nets = [net] + [copy.deepcopy(net) for _ in range(1, mesh.size if mesh is not None else 1)]

    def loss_fn(w, a, batch):
        x, y = batch
        return cross_entropy_loss(torch.func.functional_call(nets[replica_index()], w, (x, a)), y)

    def metric_fn(params, batch):
        (w, a), (x, y) = params, batch
        logits = torch.func.functional_call(nets[replica_index()], w, (x, a))
        return {"accuracy": accuracy(logits, y), "loss": cross_entropy_loss(logits, y)}

    resumed = resumed or Resumed()
    search_step = make_search_step(loss_fn, hyper, mesh)
    evaluate = make_eval_step(metric_fn, mesh)
    aug_key = seed + KEY_OFFSET
    (x_w, y_w), (x_a, y_a) = split if split is not None else split_train(dataset, seed)
    splits = tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                   for t in (x_w, y_w, x_a, y_a)) if device_data else None
    ne = min(len(dataset.x_test), EVAL_IMAGES)
    if mesh is not None:  # the eval batch must split over the data axis
        ne -= ne % mesh.axis_size("data")
    x_eval = torch.from_numpy(dataset.x_test[:ne]).to(device)
    y_eval = torch.from_numpy(dataset.y_test[:ne]).to(device)
    eval_batch = (x_eval, y_eval) if mesh is None else shard_batch((x_eval, y_eval), mesh)
    steps = len(x_w) // batch_size
    loop = None
    if step_loop:
        loop = StepLoop(search_step, state, splits, steps, batch_size, augment_fn, aug_key)
        state = loop.state
    window = steps if window is None else max(1, min(window, steps))
    best_acc = resumed.best_accuracy
    history = list(resumed.history)
    t0 = time.perf_counter() - resumed.elapsed_s
    trace_epochs = parse_bool(os.environ.get("KATIB_EPOCH_TRACE"))

    def _trace(tag: str, since: float) -> float:
        now = time.perf_counter()
        if trace_epochs:
            print(f"epoch-trace: {tag} {now - since:.2f}s", flush=True)
        return now

    for epoch in range(resumed.start_epoch, num_epochs):
        t_mark = t_epoch = time.perf_counter()
        n_used = steps * batch_size
        w_ix, a_ix = _draw_epoch_indices(seed, epoch, len(x_w), len(x_a), n_used)
        w_ix, a_ix = w_ix.reshape(steps, batch_size), a_ix.reshape(steps, batch_size)
        row: dict[str, Any] = {"epoch": epoch}
        span_attrs = {}
        if loop is not None:
            capturing = loop.capture and loop.graph is None
            loop.run_epoch(w_ix, a_ix, window, step_times)
            if capturing:
                span_attrs["graph_capture_s"] = round(loop.capture_s, 3)
            t_mark = _trace("scan-dispatch", t_mark)
            # one device-to-host transfer per epoch
            train_loss = float(loop.metrics[METRICS.index("train_loss")].sum()) / steps
            t_mark = _trace("loss-fetch", t_mark)
            if timings is not None and loop.graph is not None:
                timings["graph_capture_s"] = loop.capture_s
        else:
            step_metrics = []
            pairs = zip(loaders[0].epoch(), loaders[1].epoch()) if loaders else None
            for i in range(steps):
                t_step = time.perf_counter()
                if pairs is not None:  # gathered by the C++ loaders' threads
                    batches = next(pairs)
                    if timings is not None:
                        timings["loader_wait_s"] = (timings.get("loader_wait_s", 0.0)
                                                    + time.perf_counter() - t_step)
                    train, val = (tuple(torch.from_numpy(t).to(device) for t in pair)
                                  for pair in batches)
                elif splits is not None:
                    wi = torch.from_numpy(w_ix[i]).to(device)
                    ai = torch.from_numpy(a_ix[i]).to(device)
                    train = (splits[0][wi], splits[1][wi])
                    val = (splits[2][ai], splits[3][ai])
                else:  # gathered on the host, shipped per step
                    train, val = (
                        tuple(torch.from_numpy(t[ix]).to(device) for t in pair)
                        for pair, ix in (((x_w, y_w), w_ix[i]), ((x_a, y_a), a_ix[i]))
                    )
                if augment_fn is not None:
                    train = (augment_fn(aug_key, state.step, train[0]), train[1])
                if mesh is not None:
                    train, val = shard_batch(train, mesh), shard_batch(val, mesh)
                state, metrics = search_step(state, train, val)
                # metrics stay on the device until the epoch ends: one transfer
                step_metrics.append(metrics)
                if step_times is not None:
                    if device.type == "cuda":
                        torch.cuda.current_stream(device).synchronize()
                    step_times.append(time.perf_counter() - t_step)
            t_mark = _trace("step-dispatch", t_mark)
            step_metrics = [
                {k: Alphas(*(t.cpu() for t in v)) if k == "alpha_grad" else float(v)
                 for k, v in m.items()}
                for m in step_metrics
            ]
            train_loss = sum(m["train_loss"] for m in step_metrics) / max(steps, 1)
            t_mark = _trace("loss-fetch", t_mark)
        evaluated = evaluate((state.weights, state.alphas), eval_batch)
        val_acc, val_loss = float(evaluated["accuracy"]), float(evaluated["loss"])
        t_mark = _trace("eval", t_mark)
        best_acc = max(best_acc, val_acc)
        # per-epoch telemetry, as the JAX search publishes it: step time,
        # throughput, device memory, steps per dispatch (one replay or one
        # eager call per step: 1.0) and one "darts.epoch" span
        epoch_s = time.perf_counter() - t_epoch
        obs.trial_step_seconds.observe(epoch_s / max(steps, 1), workload="darts")
        images_per_s = (steps * batch_size) / epoch_s if epoch_s > 0 else 0.0
        obs.trial_images_per_second.set(images_per_s, workload="darts")
        obs.record_device_memory()
        spd = 1.0 if steps else 0.0
        obs.steps_per_dispatch.set(spd, workload="darts")
        tracing.record_span(
            "darts.epoch",
            epoch_s,
            epoch=epoch,
            steps=steps,
            images_per_s=round(images_per_s, 1),
            val_accuracy=round(val_acc, 4),
            step_loop=loop is not None,
            step_loop_window=window if loop is not None else 0,
            device_data=device_data,
            steps_per_dispatch=spd,
            **span_attrs,
        )
        row.update(val_accuracy=val_acc, train_loss=train_loss)
        if loop is None:
            row.update(val_loss=val_loss, steps=step_metrics)
        row.update(elapsed_s=round(time.perf_counter() - t0, 3), best_accuracy=best_acc)
        history.append(row)
        if checkpointer is not None:
            # snapshot index = epochs completed: a restart resumes at epoch + 1
            host_state = {k: t.detach().cpu() for k, t in state_items(state)}
            t_mark = _trace("state-download", t_mark)
            checkpointer.save(host_state, epoch + 1)
            t_mark = _trace("ckpt-save", t_mark)
            _write_search_meta(checkpointer.directory, {
                "fused": net.fused_convs,
                "epochs_completed": epoch + 1,
                "best_accuracy": best_acc,
                "history": [{k: v for k, v in h.items() if k != "steps"} for h in history],
                "elapsed_s": round(time.perf_counter() - t0, 3),
            })
        if report is not None and report(epoch=epoch, accuracy=val_acc, loss=train_loss) is False:
            break
    return state, history


def resolve_step_loop(
    *,
    step_loop: bool | None,
    step_loop_window: int | None,
    device_data: bool | None,
    native_prefetch: bool | None,
    steps: int,
) -> tuple[bool, int, bool]:
    """``(step_loop, window, device_data)`` as the JAX package resolves them
    (``katib_tpu/nas/darts/search.py:287-377``): parameter, then
    ``KATIB_STEP_LOOP`` / ``KATIB_STEP_LOOP_WINDOW`` / ``KATIB_DEVICE_DATA``
    / ``KATIB_NATIVE_LOADER``, then the defaults (step loop on, window the
    whole epoch, splits on the device).

    An explicit step loop that cannot engage (splits not on the device, or
    a split smaller than one batch) raises :class:`StepLoopUnavailable`; a
    default one quietly steps eagerly.  A native-prefetch request turns the
    device-data default off; whether its loaders engage is
    :func:`resolve_native_prefetch`."""
    prefetch_requested = native_prefetch is True or parse_bool(
        os.environ.get("KATIB_NATIVE_LOADER"))
    env_sl = os.environ.get("KATIB_STEP_LOOP")
    explicit = step_loop is True or (env_sl is not None and parse_bool(env_sl))
    if step_loop is None:
        step_loop = parse_bool(env_sl, default=True)
    env_dd = os.environ.get("KATIB_DEVICE_DATA")
    if device_data is None:
        device_data = not prefetch_requested if env_dd is None else parse_bool(env_dd)
    if step_loop and (not device_data or steps < 1):
        reasons = []
        if prefetch_requested:
            reasons.append(
                "native prefetch was requested (it disables the device-resident data default)")
        if env_dd is not None and not parse_bool(env_dd):
            reasons.append("KATIB_DEVICE_DATA=0 disables the device-data path")
        elif not device_data and not reasons:
            reasons.append("device_data=False was passed")
        if steps < 1:
            reasons.append("the train split is smaller than one batch")
        if explicit:
            raise StepLoopUnavailable(
                "the device-resident step loop was explicitly requested "
                "(step_loop/KATIB_STEP_LOOP) but cannot engage: " + "; ".join(reasons)
            )
        step_loop = False
    if step_loop_window is None:
        env_w = os.environ.get("KATIB_STEP_LOOP_WINDOW", "").strip()
        step_loop_window = int(env_w) if env_w else None
    if step_loop_window is not None and step_loop_window < 1:
        raise ValueError(
            f"step_loop_window must be a positive step count, got {step_loop_window}"
        )
    window = steps if step_loop_window is None else max(1, min(step_loop_window, steps))
    return step_loop, window, device_data


def resolve_native_prefetch(native_prefetch: bool | None, device_data: bool) -> bool:
    """Whether the C++ loaders feed the steps, as the JAX package decides it
    (``katib_tpu/nas/darts/search.py:478-482``): the parameter, else
    ``KATIB_NATIVE_LOADER`` set to anything but ``""`` and ``"0"``; moot
    with the splits on the device."""
    if native_prefetch is None:
        native_prefetch = os.environ.get("KATIB_NATIVE_LOADER", "") not in ("", "0")
    return bool(native_prefetch) and not device_data


@contextlib.contextmanager
def native_loaders(split, *, batch_size: int, seed: int, start_epoch: int):
    """The two C++ loaders of native prefetch, over packed copies of
    ``split`` (:func:`split_train`'s) in a temporary directory that is
    removed with them.  The
    alpha-split is cut to the w-split's length (it can be one longer), so
    the two streams keep their epochs in lockstep; the w-loader is seeded
    with ``seed``, the alpha-loader with ``seed + 1``; both open at
    ``start_epoch``.  Raises if either cannot start."""
    from katib_tpu_torch.native.dataloader import NativeBatchLoader

    (x_w, y_w), (x_a, y_a) = split
    cache_dir = tempfile.mkdtemp(prefix="darts-loader-")
    n_sync = len(x_w)
    built: list = []
    try:
        for xs, ys, sd, name in ((x_w, y_w, seed, "w.bin"),
                                 (x_a[:n_sync], y_a[:n_sync], seed + 1, "a.bin")):
            built.append(NativeBatchLoader(xs, ys, batch=batch_size, seed=sd,
                                           cache_path=os.path.join(cache_dir, name),
                                           start_epoch=start_epoch))
        yield tuple(built)
    finally:
        # an exception mid-epoch must not leak the worker threads, the
        # mapping or a dataset-sized directory
        for loader in built:
            loader.close()
        shutil.rmtree(cache_dir, ignore_errors=True)


def check_mesh_settings(step_loop: bool | None, remat: bool | None,
                        remat_policy: str | None, fused: bool) -> tuple[bool, bool]:
    """``(step_loop, remat)`` of a search on a mesh: eager steps and no
    remat.  Raises ``NotImplementedError`` naming ROADMAP item 9b for what
    the mesh path does not have: an explicit step loop (``step_loop`` or
    ``KATIB_STEP_LOOP``; capturing the sharded step), ``remat`` or a
    ``remat_policy`` (a cell recomputed in the backward pass cannot rejoin
    the replicas' batch-norm all-reduce), and the fused plan (its batch
    norm is single-device)."""
    env_sl = os.environ.get("KATIB_STEP_LOOP")
    if step_loop is True or (step_loop is None and env_sl is not None and parse_bool(env_sl)):
        raise NotImplementedError(
            "an explicit step loop on a mesh asks to capture the sharded step as CUDA "
            "graphs, not ported yet (ROADMAP item 9b); the mesh path steps eagerly"
        )
    if remat or remat_policy is not None:
        raise NotImplementedError(
            "remat on a mesh recomputes cells whose batch norm all-reduces over the "
            "replicas, not ported yet (ROADMAP item 9b); the mesh path keeps activations"
        )
    if fused:
        raise NotImplementedError(
            "the fused mixed-op plan on a mesh is not ported yet (ROADMAP item 9b)"
        )
    return False, False


def check_scan_unroll(scan_unroll: int | None) -> None:
    """The JAX search unrolls its ``lax.scan`` step loop ``scan_unroll``
    steps per XLA while-loop iteration (parameter, else
    ``KATIB_SCAN_UNROLL``, default 1).  A replayed CUDA graph has no loop to
    unroll, so the port accepts 1 and raises for anything else."""
    if scan_unroll is None:
        scan_unroll = int(os.environ.get("KATIB_SCAN_UNROLL", "1"))
    if scan_unroll != 1:
        raise NotImplementedError(
            f"scan unroll {scan_unroll} (scan_unroll or KATIB_SCAN_UNROLL) unrolls "
            "the JAX lax.scan step loop; the port replays one captured step per "
            "graph and has no counterpart (only 1 is accepted)"
        )


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
    native_prefetch: bool | None = None,
    checkpoint_dir: str | None = None,
    remat: bool | None = None,
    remat_policy: str | None = None,
    device_data: bool | None = None,
    step_loop: bool | None = None,
    step_loop_window: int | None = None,
    augment_fn=None,
    search_augment: bool | None = None,
    device: str | torch.device | None = None,
    step_times: list | None = None,
    timings: dict | None = None,
    scan_unroll: int | None = None,
    fused: bool = False,
    mesh=None,
) -> dict[str, Any]:
    """Run the bilevel architecture search; returns genotype + final metrics.

    Runs in bf16 on ``device`` (``cuda`` unless the caller names another;
    raises when CUDA is asked for and absent).  Weights and alphas are drawn
    from a ``torch.Generator`` seeded with ``seed``.  The step-loop,
    device-data and native-prefetch settings resolve as in
    :func:`resolve_step_loop` and :func:`resolve_native_prefetch`;
    ``fused``: the fused mixed-op plan (``fused.py``); ``search_augment``
    (else ``KATIB_SEARCH_AUG``) picks ``augment_fn`` = :func:`~katib_tpu_torch.models.augmentation.random_crop_flip`.
    ``checkpoint_dir``: snapshot every epoch and resume from it.
    ``step_times`` and ``timings``: see :func:`search_epochs`.
    ``scan_unroll`` (else ``KATIB_SCAN_UNROLL``): see :func:`check_scan_unroll`.
    ``remat`` (default on) recomputes each cell in the backward pass.
    ``mesh``: the sharded search on the mesh's devices (see the module doc;
    :func:`check_mesh_settings` names what raises there)."""
    check_scan_unroll(scan_unroll)
    if mesh is not None:
        step_loop, remat = check_mesh_settings(step_loop, remat, remat_policy, fused)
    elif remat is None:
        remat = True
    dev = resolve_device(device) if mesh is None else mesh.home
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
        fused_convs=fused,
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

    step_loop, window, device_data = resolve_step_loop(
        step_loop=step_loop, step_loop_window=step_loop_window, device_data=device_data,
        native_prefetch=native_prefetch, steps=half // batch_size,
    )
    if search_augment is None:
        search_augment = parse_bool(os.environ.get("KATIB_SEARCH_AUG"))
    if augment_fn is None and search_augment:
        from katib_tpu_torch.models.augmentation import random_crop_flip

        augment_fn = random_crop_flip

    checkpointer, resumed = None, Resumed()
    if checkpoint_dir is not None:
        check_plan(checkpoint_dir, fused)
        checkpointer = TrialCheckpointer(checkpoint_dir, max_to_keep=2)
        items = state_items(state)
        restored = checkpointer.restore(template=dict(items))
        if restored is not None:
            tree, latest = restored
            state = state_from_items(state, [tree[k].to(dev) for k, _ in items])
            resumed.start_epoch = latest  # snapshot index == epochs completed
            # the sidecar carries what the state cannot: the history and
            # the wall-clock base, so a resumed run reports the whole search
            meta = read_search_meta(checkpoint_dir)
            if meta is not None and meta.get("epochs_completed") == latest:
                resumed.history = [h for h in meta.get("history", ()) if h["epoch"] < latest]
                resumed.best_accuracy = float(meta.get("best_accuracy", 0.0))
                resumed.elapsed_s = float(meta.get("elapsed_s", 0.0))

    split = split_train(dataset, seed)
    # a resumed run's loaders open at its epoch: the (seed, epoch) shuffle of
    # the uninterrupted run, not a replay of epoch 0
    with (native_loaders(split, batch_size=batch_size, seed=seed, start_epoch=resumed.start_epoch)
          if resolve_native_prefetch(native_prefetch, device_data)
          else contextlib.nullcontext()) as loaders:
        state, history = search_epochs(
            net, state, dataset, hyper=hyper, num_epochs=num_epochs, batch_size=batch_size,
            seed=seed, device=dev, report=report, step_times=step_times, step_loop=step_loop,
            window=window, device_data=device_data, augment_fn=augment_fn,
            checkpointer=checkpointer, resumed=resumed, timings=timings, loaders=loaders,
            split=split, mesh=mesh,
        )
    alphas = Alphas(*(a.cpu() for a in state.alphas))
    return {
        "genotype": extract_genotype(alphas, primitives, n_nodes=n_nodes),
        "best_accuracy": max([resumed.best_accuracy] + [h["val_accuracy"] for h in history]),
        "history": history,
        "alphas": alphas,
    }


def darts_trial(ctx) -> None:
    """White-box DARTS trial (reference workload ``run_trial.py`` main).

    Consumes the three parameters the DARTS suggester emits:
    ``algorithm-settings`` (JSON dict), ``search-space`` (JSON list of
    primitives), ``num-layers``.  Runs on ``ctx.device`` (``cuda`` unless
    it names the CPU), or sharded on ``ctx.mesh`` when the trial has one
    (``run_darts_search``'s ``mesh``), snapshots the search under
    ``<checkpoint_dir>/search`` and resumes from it, and with
    ``augment_epochs`` > 0 trains the genotype found and reports its
    ``augment_accuracy`` at step ``num_epochs + augment_epochs`` (skipped
    when the search was stopped or the trial asked to stop)."""
    settings = json.loads(ctx.params.get("algorithm-settings", "{}"))
    primitives = tuple(json.loads(ctx.params.get("search-space", "null")) or DEFAULT_PRIMITIVES)
    num_layers = int(ctx.params.get("num-layers", 8))

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

    stopped = False

    def report(epoch, accuracy, loss):
        nonlocal stopped
        cont = ctx.report(step=epoch, accuracy=accuracy, loss=loss)
        stopped = stopped or not cont
        return cont

    init_channels = int(settings.get("init_channels", 16))
    batch_size = int(settings.get("batch_size", 128))
    stem_multiplier = int(settings.get("stem_multiplier", 3))
    num_epochs = int(settings.get("num_epochs", 10))
    # both spellings of the window resolve: snake_case and Katib's camelCase
    raw_window = settings.get("step_loop_window", settings.get("stepLoopWindow"))
    result = run_darts_search(
        dataset,
        primitives=primitives,
        num_layers=num_layers,
        init_channels=init_channels,
        n_nodes=int(settings.get("num_nodes", 4)),
        stem_multiplier=stem_multiplier,
        num_epochs=num_epochs,
        batch_size=batch_size,
        hyper=hyper,
        report=report,
        # the fused mixed-op evaluation plan (fused.py)
        fused=parse_bool(settings.get("fused")),
        step_loop=parse_bool(settings["step_loop"]) if "step_loop" in settings else None,
        step_loop_window=int(raw_window) if raw_window is not None else None,
        # on by default, off on a mesh (run_darts_search)
        remat=parse_bool(settings["remat"]) if "remat" in settings else None,
        remat_policy=(
            str(settings["remat_policy"])
            if settings.get("remat_policy") not in (None, "")
            else None
        ),
        search_augment=(
            parse_bool(settings["search_augment"]) if "search_augment" in settings else None
        ),
        checkpoint_dir=(
            os.path.join(ctx.checkpoint_dir, "search") if ctx.checkpoint_dir else None
        ),
        device=ctx.device,
        step_times=ctx.step_times,
        timings=ctx.timings,
        mesh=ctx.mesh,
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

    aug_epochs = int(settings.get("augment_epochs", 0))
    # an early-stopped search, or a stop asked for since, skips the phase:
    # the genotype is already written, so leaving here loses nothing
    if aug_epochs > 0 and not stopped and not ctx.should_stop():
        from katib_tpu_torch.nas.darts.augment import train_genotype

        acc = train_genotype(
            result["genotype"],
            dataset,
            init_channels=init_channels,
            num_layers=num_layers,
            stem_multiplier=stem_multiplier,
            lr=float(settings.get("augment_lr", 0.025)),
            epochs=aug_epochs,
            batch_size=batch_size,
            mesh=ctx.mesh,
            device=ctx.device,
        )
        # the step continues past the search epochs, so the series stays monotonic
        ctx.report(step=num_epochs + aug_epochs, augment_accuracy=float(acc))
