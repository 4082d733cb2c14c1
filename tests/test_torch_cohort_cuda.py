"""Vectorized cohorts and on-device PBT on the card (``cuda``-marked; they
skip without a GPU).  This file imports no JAX, so that it runs where the
port runs:

    python -m pytest --noconftest -q tests/test_torch_cohort_cuda.py -m cuda

A K-member cohort captures ONE step graph and follows its members' serial
runs; a PBT population captures one step graph for all its generations,
and the replayed generations are bit-equal to the same generations run
eagerly on the card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from katib_tpu_torch.core.types import (
    ObjectiveSpec,
    ObjectiveType,
    ParameterAssignment,
    Trial,
    TrialCondition,
    TrialSpec,
)
from katib_tpu_torch.models import mnist as tmnist
from katib_tpu_torch.models import pbt_digits as tdigits
from katib_tpu_torch.models.data import synthetic_classification
from katib_tpu_torch.parallel import pbt as tpbt
from katib_tpu_torch.parallel.train import TrainState, stack_pytrees
from katib_tpu_torch.runner.cohort import run_cohort
from katib_tpu_torch.runner.trial_runner import run_trial
from katib_tpu_torch.store.base import MemoryObservationStore

OBJECTIVE_ACC = ObjectiveSpec(type=ObjectiveType.MAXIMIZE, objective_metric_name="accuracy")
STRUCT = dict(units=12, num_layers=1, epochs=2, batch_size=64, n_train=256, n_test=128,
              optimizer="momentum")


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: a CUDA graph has no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def captures(monkeypatch):
    """Every ``EpochLoop`` that captures its step graph in the test."""
    loops = []
    build = tmnist.EpochLoop._build_graph

    def counting(loop):
        build(loop)
        loops.append(loop)

    monkeypatch.setattr(tmnist.EpochLoop, "_build_graph", counting)
    return loops


def _mnist_trial(name, lr):
    return Trial(name=name, experiment_name="cohort-cuda", spec=TrialSpec(
        assignments=[ParameterAssignment(k, v) for k, v in dict(STRUCT, lr=lr).items()],
        train_fn=tmnist.mnist_trial))


def _series(store, names, metric):
    return [[m.value for m in store.get(n, metric)] for n in names]


@pytest.mark.cuda
def test_a_cohort_captures_once_and_follows_its_serial_runs(cuda_device, captures):
    lrs = [0.02, 0.05, 0.08]
    store = MemoryObservationStore()
    trials = [_mnist_trial(f"g{i}", lr) for i, lr in enumerate(lrs)]
    results = run_cohort(trials, store, OBJECTIVE_ACC, buckets=True, device="cuda")
    assert all(r.condition is TrialCondition.SUCCEEDED for r in results.values())
    assert len(captures) == 1 and captures[0].loss_shape == (4,)
    serial = MemoryObservationStore()
    for i, lr in enumerate(lrs):
        run_trial(_mnist_trial(f"g{i}", lr), serial, OBJECTIVE_ACC, device="cuda")
    names = [t.name for t in trials]
    # bf16 products batched over the members and unbatched round apart
    # (8 significant bits) over 2 epochs of 4 steps
    np.testing.assert_allclose(_series(store, names, "loss"), _series(serial, names, "loss"),
                               rtol=2e-2, atol=1e-3)
    np.testing.assert_allclose(_series(store, names, "accuracy"),
                               _series(serial, names, "accuracy"), atol=0.05)


def _generation(lrs, capture):
    ds = synthetic_classification(1400, 397, (8, 8, 1), 10)
    k = len(lrs)
    prm = tdigits._init_params(torch.Generator().manual_seed(0), 64, 10, "cuda")
    state = stack_pytrees([TrainState(torch.zeros((), dtype=torch.int32, device="cuda"), prm,
                                      {n: torch.zeros_like(v) for n, v in prm.items()})] * k)
    specs = (tpbt.HyperSpec("lr", "double", lo=1e-4, hi=1.0),)
    to = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return tpbt.make_pbt_generation_step(
        tdigits.member_loss, tdigits.member_update, tdigits.member_eval, states=state,
        hypers=tpbt.encode_hypers(specs, [{"lr": lr} for lr in lrs], k, device="cuda"),
        data=(to(ds.x_train.reshape(1400, -1)), to(ds.y_train)),
        eval_batch=(to(ds.x_test.reshape(397, -1)), to(ds.y_test)),
        steps=5, batch_size=16, specs=specs, k=k, truncation=0.25, capture=capture)


@pytest.mark.cuda
def test_a_generation_captures_once_and_replays_as_eager(cuda_device, captures, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    lrs = [0.001, 0.01, 0.05, 0.1, 0.3, 0.5]
    runs = []
    for capture in (False, True):
        gen = _generation(lrs, capture)
        hist = []
        for g in range(3):
            idx = np.random.default_rng((7, g)).integers(0, 1400, size=(5, 16))
            scores, parent, _ = gen(idx, torch.Generator(device="cuda").manual_seed(
                tpbt.generation_seed(7, g)))
            hist.append((scores.tolist(), parent.tolist(), gen.hypers["lr"].tolist()))
        runs.append((hist, [v.cpu() for v in gen.states.params.values()]))
    assert len(captures) == 1
    (eager, p_eager), (graph, p_graph) = runs
    assert graph == eager
    assert all(torch.equal(a, b) for a, b in zip(p_eager, p_graph))
