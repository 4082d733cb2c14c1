"""One trial on a mesh, captured on the card (``cuda``-marked; they skip
without a GPU): the sharded DARTS step, the data-parallel classifier step
and the sequence-parallel LM step, each on a mesh whose replicas share
``cuda:0``, replayed from one CUDA graph and held bit for bit against the
same steps run eagerly from the same state.  This file imports no JAX, so
that it runs where the port runs:

    python -m pytest --noconftest -q tests/test_torch_mesh_capture_cuda.py -m cuda
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from katib_tpu_torch.models import mnist as tmnist
from katib_tpu_torch.models.transformer import LMTrainStep, TransformerLM, make_attention_fn
from katib_tpu_torch.nas.darts import architect as tarch
from katib_tpu_torch.nas.darts.model import (
    DartsNetwork,
    init_alphas,
    mixed_op_launches_per_forward,
)
from katib_tpu_torch.nas.darts.step_loop import StepLoop
from katib_tpu_torch.parallel.collectives import replica_index
from katib_tpu_torch.parallel.mesh import make_mesh
from katib_tpu_torch.parallel.train import cross_entropy_loss


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: a CUDA graph has no CPU mode")
    return torch.device("cuda", 0)


def _shared_mesh(axes: dict, device):
    return make_mesh(axes, devices=[device] * int(np.prod(list(axes.values()))))


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
def test_the_sharded_darts_step_replays_bit_equal_to_eager(cuda_device, remat):
    """2 steps of the bf16 supernet on ``{data: 2}`` through the step loop,
    captured against eager; the mixed-op launches per replay are both
    replicas' forward passes (and, under remat, their recomputes)."""
    mesh = _shared_mesh({"data": 2}, cuda_device)
    runs = []
    for capture in (False, True):
        net = DartsNetwork(init_channels=4, num_layers=3, n_nodes=2, num_classes=4, remat=remat)
        gen = torch.Generator().manual_seed(0)
        net.reset_parameters(gen)
        alphas = init_alphas(2, len(net.primitives), gen)
        net.to(cuda_device)
        nets = [net] + [copy.deepcopy(net)]

        def loss_fn(w, a, batch):
            logits = torch.func.functional_call(nets[replica_index()], w, (batch[0], a))
            return cross_entropy_loss(logits, batch[1])

        hyper = tarch.DartsHyper(total_steps=4)
        state = tarch.init_search_state(dict(net.named_parameters()),
                                        tarch.Alphas(*(a.to(cuda_device) for a in alphas)),
                                        hyper)
        g = torch.Generator().manual_seed(1)
        splits = (torch.randn(16, 8, 8, 3, generator=g).to(cuda_device),
                  torch.randint(0, 4, (16,), generator=g).to(cuda_device),
                  torch.randn(16, 8, 8, 3, generator=g).to(cuda_device),
                  torch.randint(0, 4, (16,), generator=g).to(cuda_device))
        loop = StepLoop(tarch.make_search_step(loss_fn, hyper, mesh), state, splits, 2, 8,
                        capture=capture, mesh=mesh)
        ix = np.arange(16).reshape(2, 8)
        loop.run_epoch(ix, ix[::-1].copy(), 2)
        torch.cuda.synchronize()
        runs.append(([t.cpu() for _, t in tarch.state_items(loop.state)], loop.metrics.cpu(),
                     loop))
    (eager, eager_m, _), (got, got_m, loop) = runs
    assert loop.graph is not None
    # 5 forward passes a second-order step, in each of the 2 replicas, each
    # launched twice under remat (the backward recomputes every cell)
    passes = 5 * (2 if remat else 1)
    assert loop.launches_per_replay == passes * 2 * mixed_op_launches_per_forward(3, 2)
    assert torch.equal(got_m, eager_m) and _equal(got, eager)


@pytest.mark.cuda
def test_the_data_parallel_classifier_epoch_replays_bit_equal_to_eager(cuda_device):
    mesh = _shared_mesh({"data": 2}, cuda_device)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(256, 28, 28, 1, generator=g).to(cuda_device)
    y = torch.randint(0, 10, (256,), generator=g, dtype=torch.int32).to(cuda_device)
    idx = np.random.default_rng(0).permutation(256).reshape(8, 32)
    runs = []
    for capture in (False, True):
        net = tmnist.SmallCNN(channels=4)
        net.reset_parameters(torch.Generator().manual_seed(0))
        net.to(cuda_device)
        step, _, state = tmnist.classifier_steps(net, "momentum", 0.05, 0.9, mesh=mesh)
        loop = tmnist.EpochLoop(step, state, x, y, 8, 32, capture=capture, mesh=mesh)
        loop.run_epoch(idx)
        loop.run_epoch(idx[::-1].copy())
        torch.cuda.synchronize()
        runs.append((loop, [t.cpu() for t in tmnist.tree_flatten(loop.state)[0]],
                     loop.losses.cpu()))
    (eager, want, want_losses), (graph, got, losses) = runs
    assert graph.graph is not None and eager.graph is None
    assert torch.equal(losses, want_losses) and _equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_the_sequence_parallel_lm_step_replays_bit_equal_to_eager(cuda_device, strategy):
    """4 bf16 steps on ``{seq: 2}``; the flash launches per replay are the
    strategy's (ring: 3 forward chunks a layer, Ulysses: 1 per replica)."""
    mesh = _shared_mesh({"seq": 2}, cuda_device)
    data = torch.randint(0, 64, (4, 4, 128), generator=torch.Generator().manual_seed(3))
    runs = []
    for capture in (False, True):
        model = TransformerLM(vocab_size=64, d_model=64, n_heads=2, n_layers=2,
                              max_seq_len=128, attn_fn=make_attention_fn(mesh, strategy))
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.to(cuda_device)
        step = LMTrainStep(model, lr=3e-3, steps=5, mesh=mesh, capture=capture)
        losses = [step(t.to(cuda_device)).cpu() for t in data]
        torch.cuda.synchronize()
        runs.append((step, losses, [p.detach().cpu() for p in model.parameters()]))
    (eager, want_losses, want), (step, losses, got) = runs
    assert step.graph is not None and eager.graph is None
    # forward launches a layer over both replicas: the ring's causal chunks
    # (replica 0 attends to its own, replica 1 to both), Ulysses' one each
    per_layer = 3 if strategy == "ring" else 2
    assert step.launches_per_replay["fwd"] == 2 * per_layer  # 2 layers
    assert _equal(losses, want_losses) and _equal(got, want)


@pytest.fixture
def two_cards():
    """Two CUDA devices; the test skips where there are fewer."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs: a capture across cards")
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.cuda
def test_a_capture_cannot_span_two_cards(two_cards):
    """Why a mesh over distinct cards steps eagerly: a capture on one card's
    stream that forks to another card's stream by an event, runs a kernel
    there into a tensor allocated before the capture and joins back, is
    invalidated (``cudaErrorStreamCaptureInvalidated``)."""
    d0, d1 = two_cards
    x0, x1 = torch.ones(1024, device=d0), torch.ones(1024, device=d1)
    out1 = torch.empty(1024, device=d1)
    s0, s1 = torch.cuda.Stream(d0), torch.cuda.Stream(d1)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(graph, stream=s0, capture_error_mode="thread_local"):
            y0 = x0 * 2
            fork = torch.cuda.Event()
            fork.record(s0)
            with torch.cuda.device(d1), torch.cuda.stream(s1):
                s1.wait_event(fork)
                torch.mul(x1, 3, out=out1)
                join = torch.cuda.Event()
                join.record(s1)
            s0.wait_event(join)
            y0.add_(out1.to(d0, non_blocking=True))
