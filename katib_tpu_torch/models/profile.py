"""Where one training step of the long-context transformer spends its time
on the GPU.

    python3 -m katib_tpu_torch.models.profile [--steps N] [--trace PATH]

Builds ``TransformerLM`` at the repo's long-context configuration
(``LONG_CONTEXT``: vocab 256, d_model 512, 8 heads, 4 layers, seq 4096,
batch 4, bf16) with random weights from a seed and prints the summary of
``katib_tpu_torch.profiling.profile_step``, the flash-attention kernels'
share among it, and tokens per second.  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse


def main() -> int:
    import torch

    from katib_tpu_torch.device import resolve_device
    from katib_tpu_torch.models.transformer import (
        LONG_CONTEXT,
        TransformerLM,
        make_attention_fn,
        make_train_step,
        markov_dataset,
    )
    from katib_tpu_torch.profiling import profile_step

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3, help="steps timed, then steps traced")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace", help="write the Chrome trace here")
    args = ap.parse_args()

    c = LONG_CONTEXT
    dev = resolve_device("cuda")
    model = TransformerLM(vocab_size=c["vocab_size"], d_model=c["d_model"],
                          n_heads=c["n_heads"], n_layers=c["n_layers"],
                          max_seq_len=c["seq_len"], attn_fn=make_attention_fn())
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(dev)
    total = args.warmup + 2 * args.steps
    train_step = make_train_step(model, lr=3e-3, steps=total)
    data = markov_dataset(c["vocab_size"], c["batch_size"] * total, c["seq_len"])
    batches = iter(torch.from_numpy(data).to(dev, torch.long).split(c["batch_size"]))

    print("config: " + ", ".join(f"{k} {v}" for k, v in c.items()) + ", bf16")
    wall_s = profile_step(lambda: train_step(next(batches)), steps=args.steps,
                          warmup=args.warmup, top=args.top, trace=args.trace,
                          kernel_names=("flash_fwd_kernel", "flash_dq_kernel",
                                        "flash_dkv_kernel"))
    print(f"tokens_per_s={c['batch_size'] * c['seq_len'] / wall_s:.0f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
