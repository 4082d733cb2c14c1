"""The port's entry points (``katib_tpu_torch/entry.py``), the counterpart
of the JAX package's ``__graft_entry__.py``.

``dryrun_multigpu`` is the mesh path's gate; on the CPU it runs over grids
of CPU entries.  Its tolerances are the JAX gate's (``dryrun_multichip``):
train and val loss within 1e-3 relative and the raw alpha gradient within
rtol 1e-3 / atol 1e-6 of the single-device step, sequential and paired;
the ring-attention LM within 2e-2 relative of dense attention; the
trial-sharded cohort within rtol 1e-6 / atol 1e-7 of the single-device
cohort.  With the batch routing broken on purpose the gate fails.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from katib_tpu_torch import entry
from katib_tpu_torch.parallel import mesh as pmesh

# tier-1 runs six test processes on the same cores: one torch thread each
torch.set_num_threads(1)


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multigpu_passes_on_a_cpu_grid(n):
    out = entry.dryrun_multigpu(n, devices=["cpu"] * n)
    assert out["mesh"] == {"data": n // 2, "model": 2}
    assert out["route"] == "shared device"
    for name in ("train_loss", "val_loss"):
        got, want = out["darts"][name]
        assert abs(got - want) <= 1e-3 * max(1.0, abs(want))
    assert out["darts"]["alpha_grad_paired_max_abs_err"] < 1e-5
    assert np.isfinite(out["lm"]["loss_ring"])
    assert out["cohort"]["members"] == n


def test_dryrun_multigpu_odd_grid_is_data_only():
    out = entry.dryrun_multigpu(3, devices=["cpu"] * 3)
    assert out["mesh"] == {"data": 3} and "lm" not in out


def test_devices_none_without_gpus_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs 4 distinct GPUs and 0 are visible"):
        entry.dryrun_multigpu(4)


def test_the_gate_fails_when_every_replica_gets_the_same_chunk(monkeypatch):
    real = pmesh.shard_batch

    def same_chunk(batch, mesh):
        placed = real(batch, mesh)
        for leaf in placed:
            leaf.pieces = tuple(leaf.pieces[0] for _ in leaf.pieces)
        return placed

    monkeypatch.setattr(pmesh, "shard_batch", same_chunk)
    with pytest.raises(AssertionError, match="sharded (train|val)_loss|alpha gradient"):
        entry.dryrun_multigpu(4, devices=["cpu"] * 4)


def test_the_float32_gates_turn_tf32_off_and_restore_it(monkeypatch):
    """The DARTS and cohort gates compare in full float32 whatever the
    caller's TF32 settings: both are off while each gate builds its steps,
    and the caller's values are back afterwards."""
    from katib_tpu_torch.nas.darts import architect
    from katib_tpu_torch.parallel import train

    seen = []

    def recording(real):
        def make(*args, **kwargs):
            seen.append((real.__name__, torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
            return real(*args, **kwargs)

        return make

    monkeypatch.setattr(architect, "make_search_step", recording(architect.make_search_step))
    monkeypatch.setattr(train, "make_cohort_train_step",
                        recording(train.make_cohort_train_step))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    entry.dryrun_multigpu(2, devices=["cpu"] * 2)
    assert {name for name, _, _ in seen} == {"make_search_step", "make_cohort_train_step"}
    assert all(not matmul and not cudnn for _, matmul, cudnn in seen), seen
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def test_entry_is_a_supernet_forward_step():
    forward, (weights, alphas, x) = entry.entry(device="cpu")
    logits = forward(weights, alphas, x)
    assert logits.shape == (8, 10) and torch.isfinite(logits).all()
