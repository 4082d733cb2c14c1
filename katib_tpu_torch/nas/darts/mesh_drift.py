"""How far the sharded DARTS search drifts from the unsharded one, step by
step, and how far a mere change of reduction order moves it.

    python3 -m katib_tpu_torch.nas.darts.mesh_drift [--steps N] [--out PATH.json]

Builds the search at the DARTS search width (8 cells, 16 channels, 4 nodes,
the 8 default primitives, batch 64, second order, no remat) and runs
``--steps`` bilevel steps from the same weights over the same batches:

- ``float32``: the sharded step on ``{data: 2}`` (both replicas on
  ``cuda:0``) against the unsharded step, in float32 with TF32 off;
- ``float32_control``: the unsharded step against itself with the rows of
  every batch permuted, which changes only the order of each reduction;
- ``bf16`` and ``bf16_control``: the same two pairs in bfloat16.

A sharded step that carries wrong state or a wrong global batch norm
shows in ``float32`` above its control; a drift that is bf16 rounding
alone shows in ``bf16`` as in ``bf16_control``.  Prints each run's train
losses, each pair's relative difference per step, and one JSON line of
the largest differences (the whole result to ``--out`` when given).  Needs
a CUDA GPU.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time


def main() -> int:
    import torch

    from katib_tpu_torch.device import resolve_device
    from katib_tpu_torch.entry import full_float32
    from katib_tpu_torch.models.data import load_cifar10
    from katib_tpu_torch.nas.darts.architect import DartsHyper, init_search_state, make_search_step
    from katib_tpu_torch.nas.darts.model import DartsNetwork, init_alphas
    from katib_tpu_torch.nas.darts.ops import DEFAULT_PRIMITIVES
    from katib_tpu_torch.nas.darts.search import split_train
    from katib_tpu_torch.parallel.collectives import replica_index
    from katib_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from katib_tpu_torch.parallel.train import cross_entropy_loss

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--out", help="write the whole result here as JSON")
    args = ap.parse_args()

    dev = resolve_device("cuda")
    batch, steps = 64, args.steps
    dataset = load_cifar10(n_train=2 * batch * steps, n_test=8)
    (x_w, y_w), (x_a, y_a) = split_train(dataset, seed=0)
    batches = [
        tuple(torch.from_numpy(a[i * batch:(i + 1) * batch]).to(dev) for a in (x_w, y_w, x_a, y_a))
        for i in range(steps)
    ]
    perm = torch.randperm(batch, generator=torch.Generator().manual_seed(1)).to(dev)
    mesh = make_mesh({"data": 2}, devices=[dev, dev])
    hyper = DartsHyper(total_steps=steps)

    def run(dtype, sharded: bool, permuted: bool) -> dict:
        net = DartsNetwork(DEFAULT_PRIMITIVES, init_channels=16, num_layers=8, n_nodes=4,
                           num_classes=10, remat=False, dtype=dtype)
        gen = torch.Generator().manual_seed(0)
        net.reset_parameters(gen)
        alphas = init_alphas(4, len(DEFAULT_PRIMITIVES), gen)
        net.to(dev)
        nets = [net] + ([copy.deepcopy(net)] if sharded else [])

        def loss_fn(w, a, b):
            model = nets[replica_index()] if sharded else net
            return cross_entropy_loss(torch.func.functional_call(model, w, (b[0], a)), b[1])

        step = make_search_step(loss_fn, hyper, mesh if sharded else None)
        state = init_search_state({k: v.detach() for k, v in net.named_parameters()},
                                  type(alphas)(*(a.to(dev) for a in alphas)), hyper)
        losses, walls = [], []
        for xw, yw, xa, ya in batches:
            if permuted:
                xw, yw, xa, ya = (t[perm] for t in (xw, yw, xa, ya))
            train, val = (xw, yw), (xa, ya)
            if sharded:
                train, val = shard_batch(train, mesh), shard_batch(val, mesh)
            t0 = time.perf_counter()
            state, metrics = step(state, train, val)
            losses.append(float(metrics["train_loss"]))
            walls.append(time.perf_counter() - t0)
        return {"losses": losses, "walls": walls}

    def rel(a: list, b: list) -> list:
        return [abs(x - y) / abs(y) for x, y in zip(a, b)]

    runs = {}
    with full_float32():
        runs["float32_sharded"] = run(torch.float32, True, False)
        runs["float32_plain"] = run(torch.float32, False, False)
        runs["float32_permuted"] = run(torch.float32, False, True)
    runs["bf16_sharded"] = run(torch.bfloat16, True, False)
    runs["bf16_plain"] = run(torch.bfloat16, False, False)
    runs["bf16_permuted"] = run(torch.bfloat16, False, True)
    pairs = {
        "float32": rel(runs["float32_sharded"]["losses"], runs["float32_plain"]["losses"]),
        "float32_control": rel(runs["float32_permuted"]["losses"], runs["float32_plain"]["losses"]),
        "bf16": rel(runs["bf16_sharded"]["losses"], runs["bf16_plain"]["losses"]),
        "bf16_control": rel(runs["bf16_permuted"]["losses"], runs["bf16_plain"]["losses"]),
    }
    for name, r in runs.items():
        print(f"mesh_drift: {name} train_loss {r['losses']} step_s {r['walls']}", flush=True)
    for name, d in pairs.items():
        print(f"mesh_drift: {name} rel diff per step {d}", flush=True)
    summary = {name: {f"max_to_step_{k}": max(d[:k]) for k in (3, 8, steps) if k <= steps}
               for name, d in pairs.items()}
    result = {"steps": steps, "batch": batch, "route": mesh.route, "pairs": pairs,
              "summary": summary, "runs": runs}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"steps": steps, "summary": summary}), flush=True)
    finite = all(x == x and abs(x) != float("inf") for r in runs.values() for x in r["losses"])
    if not finite:
        print("mesh_drift: a train loss is not finite", flush=True)
    return 0 if finite else 1


if __name__ == "__main__":
    raise SystemExit(main())
