"""Where one bilevel search step spends its time on the GPU.

    python3 -m katib_tpu_torch.nas.darts.profile [--steps N] [--trace PATH]

Builds the search at the DARTS search width (8 cells, 16 channels, 4 nodes,
the 8 default primitives, batch 64, bf16, second order, no remat) and
prints the summary of ``katib_tpu_torch.profiling.profile_step``, the
mixed-op kernel's share among it.  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse


def main() -> int:
    import torch

    from katib_tpu_torch.device import resolve_device
    from katib_tpu_torch.models.data import load_cifar10
    from katib_tpu_torch.nas.darts.architect import DartsHyper, init_search_state, make_search_step
    from katib_tpu_torch.nas.darts.model import DartsNetwork, init_alphas
    from katib_tpu_torch.nas.darts.ops import DEFAULT_PRIMITIVES
    from katib_tpu_torch.nas.darts.search import split_train
    from katib_tpu_torch.parallel.train import cross_entropy_loss
    from katib_tpu_torch.profiling import profile_step

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2, help="steps timed, then steps traced")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", help="write the Chrome trace here")
    args = ap.parse_args()

    dev = resolve_device("cuda")
    batch = 64
    dataset = load_cifar10(n_train=2 * batch, n_test=8)
    (x_w, y_w), (x_a, y_a) = split_train(dataset, seed=0)
    train = (torch.from_numpy(x_w[:batch]).to(dev), torch.from_numpy(y_w[:batch]).to(dev))
    val = (torch.from_numpy(x_a[:batch]).to(dev), torch.from_numpy(y_a[:batch]).to(dev))
    net = DartsNetwork(DEFAULT_PRIMITIVES, init_channels=16, num_layers=8, n_nodes=4,
                       num_classes=10, remat=False, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    net.reset_parameters(gen)
    alphas = init_alphas(4, len(DEFAULT_PRIMITIVES), gen)
    net.to(dev)

    def loss_fn(w, a, b):
        return cross_entropy_loss(torch.func.functional_call(net, w, (b[0], a)), b[1])

    hyper = DartsHyper(total_steps=1000)
    step = make_search_step(loss_fn, hyper)
    state = init_search_state(
        {k: v.detach() for k, v in net.named_parameters()},
        type(alphas)(*(a.to(dev) for a in alphas)), hyper,
    )

    def search_step():
        nonlocal state
        state, _ = step(state, train, val)

    profile_step(search_step, steps=args.steps, warmup=args.warmup, top=args.top,
                 trace=args.trace, kernel_names=("mixed_op",))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
