"""Where one training step of the long-context transformer, or one epoch of
the HP-tuning trial's classifier, spends its time on the GPU.

    python3 -m katib_tpu_torch.models.profile [--steps N] [--trace PATH]
    python3 -m katib_tpu_torch.models.profile --classifier [--steps N]

Builds ``TransformerLM`` at the repo's long-context configuration
(``LONG_CONTEXT``: vocab 256, d_model 512, 8 heads, 4 layers, seq 4096,
batch 4, bf16) with random weights from a seed and prints the summary of
``katib_tpu_torch.profiling.profile_step`` for its train step, replayed
from its captured CUDA graph as the trial runs it, the flash-attention
kernels' share among it, and tokens per second.

``--classifier`` profiles one epoch of ``train_classifier``'s device-data
loop at the Hyperband sweep's cell (``CLASSIFIER``: ``SmallCNN`` with 32
channels in bf16, batch 64, momentum, 8,192 synthetic MNIST images, 128
steps an epoch), first replayed from its captured step graph, then stepped
eagerly, with the summary also per training step, and images per second.
Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse

# the classifier of katib_tpu_torch/specs/hyperband-mnist.yaml's trials
CLASSIFIER = {"channels": 32, "batch_size": 64, "n_train": 8192, "optimizer": "momentum",
              "lr": 0.05, "momentum": 0.9}


def classifier_loop(capture: bool, optimizer: str = CLASSIFIER["optimizer"], arch: str = "cnn"):
    """An :class:`~katib_tpu_torch.models.mnist.EpochLoop` at ``CLASSIFIER``
    on the card (``arch="mlp"``: ``mnist_trial``'s default ``MLP`` in its
    place), with weights drawn from seed 0, and an epoch's ``[steps,
    batch]`` permutation rows."""
    import numpy as np
    import torch

    from katib_tpu_torch.device import resolve_device
    from katib_tpu_torch.models.mnist import (
        MLP,
        EpochLoop,
        SmallCNN,
        _cached_mnist,
        classifier_steps,
    )

    c = CLASSIFIER
    dev = resolve_device("cuda")
    model = SmallCNN(channels=c["channels"]) if arch == "cnn" else MLP()
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(dev)
    step, _, state = classifier_steps(model, optimizer, c["lr"], c["momentum"])
    ds = _cached_mnist(c["n_train"], 8)
    x, y = (torch.from_numpy(a).to(dev) for a in (ds.x_train, ds.y_train))
    steps, batch = c["n_train"] // c["batch_size"], c["batch_size"]
    idx = np.random.default_rng(0).permutation(c["n_train"])[: steps * batch]
    return EpochLoop(step, state, x, y, steps, batch, capture=capture), idx.reshape(steps, batch)


def classifier(args) -> int:
    from katib_tpu_torch.profiling import profile_step

    c = CLASSIFIER
    print("config: SmallCNN " + ", ".join(f"{k} {v}" for k, v in c.items()) + ", bf16, "
          "synthetic MNIST")
    for capture in (True, False):
        loop, idx = classifier_loop(capture)
        print(f"{'captured' if capture else 'eager'} epoch ({loop.steps} steps):")
        prof = profile_step(lambda: loop.run_epoch(idx), steps=args.steps, warmup=args.warmup,
                            top=args.top, trace=args.trace and f"{args.trace}.{capture}",
                            kernel_names=(), substeps=loop.steps)
        print(f"images_per_s={loop.steps * c['batch_size'] / prof.wall_s:.0f}"
              + (f"; graph capture {loop.capture_s:.3f}s (warm-up step included)"
                 if capture else ""))
    return 0


def main() -> int:
    import torch

    from katib_tpu_torch.device import resolve_device
    from katib_tpu_torch.models.transformer import (
        LONG_CONTEXT,
        TransformerLM,
        LMTrainStep,
        make_attention_fn,
        markov_dataset,
    )
    from katib_tpu_torch.profiling import profile_step

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3, help="steps timed, then steps traced")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace", help="write the Chrome trace here")
    ap.add_argument("--classifier", action="store_true",
                    help="profile the HP-tuning trial's classifier epoch instead")
    args = ap.parse_args()
    if args.classifier:
        return classifier(args)

    c = LONG_CONTEXT
    dev = resolve_device("cuda")
    model = TransformerLM(vocab_size=c["vocab_size"], d_model=c["d_model"],
                          n_heads=c["n_heads"], n_layers=c["n_layers"],
                          max_seq_len=c["seq_len"], attn_fn=make_attention_fn())
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(dev)
    total = args.warmup + 2 * args.steps
    train_step = LMTrainStep(model, lr=3e-3, steps=total)
    data = markov_dataset(c["vocab_size"], c["batch_size"] * total, c["seq_len"])
    batches = iter(torch.from_numpy(data).to(dev, torch.long).split(c["batch_size"]))

    print("config: " + ", ".join(f"{k} {v}" for k, v in c.items()) + ", bf16")
    wall_s = profile_step(lambda: train_step(next(batches)), steps=args.steps,
                          warmup=args.warmup, top=args.top, trace=args.trace,
                          kernel_names=("flash_fwd_kernel", "flash_dq_kernel",
                                        "flash_dkv_kernel")).wall_s
    print(f"tokens_per_s={c['batch_size'] * c['seq_len'] / wall_s:.0f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
