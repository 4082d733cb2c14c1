"""ENAS child-training trial workload (port of ``katib_tpu/nas/enas/trial.py``).

Build the CNN from the ``architecture`` and ``nn_config`` parameters, train
it with ``train_classifier`` (momentum; the device-data epoch replays a
captured CUDA-graph step on the card) and report the test accuracy per
epoch.  Runs on ``ctx.device``: ``cuda`` unless the context names the CPU.
"""

from __future__ import annotations

import json
import os
import time

import torch

from katib_tpu_torch.models.data import load_named_dataset
from katib_tpu_torch.models.mnist import train_classifier
from katib_tpu_torch.nas.enas.child import child_from_arc
from katib_tpu_torch.nas.enas.controller import arc_from_json
from katib_tpu_torch.utils import observability as obs
from katib_tpu_torch.utils import tracing
from katib_tpu_torch.utils.booleans import parse_bool


def enas_trial(ctx) -> None:
    """Reads ``architecture``, ``nn_config``, ``channels`` (24),
    ``num_classes`` (10), ``dataset`` (``cifar10``), ``n_train`` and
    ``n_test`` (the loader's defaults), ``num_epochs`` (3), ``batch_size``
    (128), ``lr`` (0.05) and ``weight_sharing``, as the JAX trial does; the
    weights are drawn from a generator seeded with the trainer's seed (0).

    With ``weight_sharing`` and a checkpoint dir, the child overlays the
    experiment's pool (``<dirname(checkpoint_dir)>/enas-shared``) before
    training and publishes its final parameters back."""
    arch = json.loads(ctx.params["architecture"])
    nn_config = json.loads(ctx.params["nn_config"])
    num_layers = int(nn_config["num_layers"])
    operations = nn_config.get("operations")

    n_train = ctx.params.get("n_train")
    n_test = ctx.params.get("n_test")
    dataset = load_named_dataset(
        str(ctx.params.get("dataset", "cifar10")),
        int(n_train) if n_train is not None else None,
        int(n_test) if n_test is not None else None,
    )
    kwargs = {"operations": tuple(operations)} if operations else {}
    model = child_from_arc(
        arc_from_json(arch, num_layers),
        channels=int(ctx.params.get("channels", 24)),
        num_classes=int(ctx.params.get("num_classes", 10)),
        in_channels=dataset.input_shape[-1],
        **kwargs,
    )
    seed = 0  # train_classifier's default, as in the JAX trial
    model.reset_parameters(torch.Generator().manual_seed(seed))

    # per-epoch telemetry rides the report callback: the interval between
    # calls is one training epoch (train_classifier reports once per epoch)
    epochs = int(ctx.params.get("num_epochs", 3))
    batch_size = int(ctx.params.get("batch_size", 128))
    last_report = [time.perf_counter()]

    def report(epoch, accuracy, loss):
        now = time.perf_counter()
        epoch_s, last_report[0] = now - last_report[0], now
        steps = max(len(dataset.x_train) // batch_size, 1)
        obs.trial_step_seconds.observe(epoch_s / steps, workload="enas")
        images_per_s = (steps * batch_size) / epoch_s if epoch_s > 0 else 0.0
        obs.trial_images_per_second.set(images_per_s, workload="enas")
        obs.record_device_memory()
        tracing.record_span(
            "enas.epoch",
            epoch_s,
            trial=ctx.trial_name,
            epoch=epoch,
            images_per_s=round(images_per_s, 1),
            accuracy=round(float(accuracy), 4),
        )
        return ctx.report(step=epoch, accuracy=accuracy, loss=loss)

    # opt-in ENAS weight sharing: children overlay the experiment's shared
    # parameter pool before training and publish back afterwards
    init_transform = on_finish = None
    if parse_bool(ctx.params.get("weight_sharing")) and ctx.checkpoint_dir:
        from katib_tpu_torch.nas.enas.shared import (
            load_pool,
            overlay_matching,
            publish_pool,
        )

        pool_dir = os.path.join(os.path.dirname(ctx.checkpoint_dir), "enas-shared")
        pool = load_pool(pool_dir)

        def init_transform(params, _pool=pool):
            if _pool is None:
                return params
            merged, _ = overlay_matching(params, _pool)
            return merged

        def on_finish(params):
            publish_pool(pool_dir, params)

    train_classifier(
        model,
        dataset,
        lr=float(ctx.params.get("lr", 0.05)),
        epochs=epochs,
        batch_size=batch_size,
        optimizer="momentum",
        mesh=ctx.mesh,
        seed=seed,
        report=report,
        init_transform=init_transform,
        on_finish=on_finish,
        device=ctx.device,
    )
