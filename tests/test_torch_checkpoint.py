"""The port's trial checkpointer, and the DARTS search's resume through it.

The checkpointer keeps the JAX package's layout and recovery rules (step
dirs with a sidecar manifest, retention, quarantine of a step that fails
verification, fall back to the newest step that verifies) with
``torch.save`` in place of Orbax; a step written by the JAX package raises.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from katib_tpu.utils.checkpoint import TrialCheckpointer as JaxCheckpointer
from katib_tpu_torch.models import data as tdata
from katib_tpu_torch.nas.darts.search import SEARCH_META, read_search_meta, run_darts_search
from katib_tpu_torch.utils.checkpoint import (
    TrialCheckpointer,
    copy_checkpoint_tree,
    tree_digest,
)

torch.set_num_threads(1)

PRIMS = ("separable_convolution_3x3", "max_pooling_3x3", "skip_connection")


def _tree(seed: float = 0.0) -> dict:
    return {"step": torch.tensor(3, dtype=torch.int32),
            "weights/a": torch.arange(6, dtype=torch.float32).reshape(2, 3) + seed,
            "alphas/normal": torch.full((4,), seed)}


def test_save_restore_round_trip_and_manifest(tmp_path):
    ckpt = TrialCheckpointer(str(tmp_path), max_to_keep=2)
    assert ckpt.restore() is None
    ckpt.save(_tree(1.0), 1)
    tree, step = ckpt.restore(template=_tree())
    assert step == 1 and list(tree) == list(_tree())
    for k, v in _tree(1.0).items():
        assert torch.equal(tree[k], v)
    with open(tmp_path / "step_00000001.manifest.json") as f:
        manifest = json.load(f)
    assert manifest["format"] == "torch" and manifest["step"] == 1
    assert manifest["tree_digest"] == tree_digest(_tree())
    assert manifest["files"] == {"state.pt": os.path.getsize(tmp_path / "step_00000001" / "state.pt")}
    assert ckpt.verify_step(1) is True


def test_retention_keeps_the_newest(tmp_path):
    ckpt = TrialCheckpointer(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        ckpt.save(_tree(step), step)
    assert ckpt.all_steps() == [2, 3] and ckpt.latest_step() == 3
    assert not os.path.exists(tmp_path / "step_00000001.manifest.json")
    tree, step = ckpt.restore()
    assert step == 3 and torch.equal(tree["alphas/normal"], torch.full((4,), 3.0))


def test_truncated_newest_step_is_quarantined_and_the_older_restores(tmp_path):
    ckpt = TrialCheckpointer(str(tmp_path))
    ckpt.save(_tree(1.0), 1)
    ckpt.save(_tree(2.0), 2)
    path = tmp_path / "step_00000002" / "state.pt"
    path.write_bytes(path.read_bytes()[:50])
    assert ckpt.verify_step(2) is False
    tree, step = ckpt.restore(template=_tree())
    assert step == 1 and torch.equal(tree["alphas/normal"], torch.full((4,), 1.0))
    assert ckpt.all_steps() == [1]
    quarantined = tmp_path / "quarantine-step_00000002"
    assert "manifest verification failed" in (quarantined / "QUARANTINE_REASON").read_text()
    assert os.path.exists(str(quarantined) + ".manifest.json")


def test_digest_mismatch_quarantines(tmp_path):
    ckpt = TrialCheckpointer(str(tmp_path))
    ckpt.save(_tree(1.0), 1)
    other = {**_tree(), "weights/a": torch.zeros(3, 2)}
    assert ckpt.restore(template=other) is None
    assert ckpt.all_steps() == []
    reason = (tmp_path / "quarantine-step_00000001" / "QUARANTINE_REASON").read_text()
    assert "digest" in reason


def test_unreadable_step_without_manifest_is_quarantined(tmp_path):
    ckpt = TrialCheckpointer(str(tmp_path))
    ckpt.save(_tree(1.0), 1)
    os.makedirs(tmp_path / "step_00000002")
    (tmp_path / "step_00000002" / "state.pt").write_bytes(b"not a torch file")
    tree, step = ckpt.restore()
    assert step == 1 and ckpt.all_steps() == [1]
    assert os.path.isdir(tmp_path / "quarantine-step_00000002")


def test_a_jax_written_step_raises_and_is_left_alone(tmp_path):
    """A step the JAX package wrote through Orbax is named as a JAX
    checkpoint; it is neither quarantined nor overwritten."""
    JaxCheckpointer(str(tmp_path)).save({"w": np.ones(3, np.float32)}, 1)
    ckpt = TrialCheckpointer(str(tmp_path))
    with pytest.raises(NotImplementedError, match="JAX checkpoint"):
        ckpt.restore()
    assert ckpt.all_steps() == [1]
    assert not any(n.startswith("quarantine-") for n in os.listdir(tmp_path))
    # without its manifest it is still recognised by its Orbax files
    os.unlink(tmp_path / "step_00000001.manifest.json")
    with pytest.raises(NotImplementedError, match="JAX checkpoint"):
        ckpt.restore()


def test_copy_checkpoint_tree(tmp_path):
    src, dst = tmp_path / "a", tmp_path / "b"
    assert copy_checkpoint_tree(str(src), str(dst)) is False
    TrialCheckpointer(str(src)).save(_tree(5.0), 4)
    assert copy_checkpoint_tree(str(src), str(dst)) is True
    tree, step = TrialCheckpointer(str(dst)).restore()
    assert step == 4 and torch.equal(tree["alphas/normal"], torch.full((4,), 5.0))


# -- the search's resume --------------------------------------------------------

KW = dict(primitives=PRIMS, num_layers=3, init_channels=4, n_nodes=2, num_epochs=3,
          batch_size=4, seed=6, remat=False, device="cpu", step_loop_window=2,
          search_augment=True)


def _ds():
    # 24 train images -> 3 steps of 4 per epoch
    return tdata.synthetic_classification(24, 8, (8, 8, 3), 4, seed=2)


def _stop_after(epoch):
    return lambda **kw: kw["epoch"] != epoch


@pytest.mark.parametrize("step_loop", [True, False])
def test_interrupted_and_resumed_search_equals_the_uninterrupted_one(tmp_path, step_loop):
    full = run_darts_search(_ds(), **KW, step_loop=step_loop,
                            checkpoint_dir=str(tmp_path / "full"))
    part = str(tmp_path / "part")
    first = run_darts_search(_ds(), **KW, step_loop=step_loop, checkpoint_dir=part,
                             report=_stop_after(0))
    assert [h["epoch"] for h in first["history"]] == [0]
    meta = read_search_meta(part)
    assert meta["epochs_completed"] == 1 and [h["epoch"] for h in meta["history"]] == [0]
    reports = []
    resumed = run_darts_search(_ds(), **KW, step_loop=step_loop, checkpoint_dir=part,
                               report=lambda **kw: reports.append(kw["epoch"]) or True)
    assert reports == [1, 2]
    for a, b in zip(resumed["alphas"], full["alphas"]):
        assert torch.equal(a, b)
    want, got = TrialCheckpointer(str(tmp_path / "full")).restore(), TrialCheckpointer(part).restore()
    assert got[1] == want[1] == 3
    for k, v in want[0].items():
        assert torch.equal(got[0][k], v), k
    # the history and the elapsed time continue across the restart
    hist = resumed["history"]
    assert [h["epoch"] for h in hist] == [0, 1, 2]
    assert hist[0] == {k: v for k, v in first["history"][0].items() if k != "steps"}
    for h, w in zip(hist, full["history"]):
        assert h["val_accuracy"] == w["val_accuracy"]
        assert h["train_loss"] == pytest.approx(w["train_loss"], rel=1e-6)
    assert hist[1]["elapsed_s"] >= hist[0]["elapsed_s"]
    assert resumed["genotype"] == full["genotype"]
    assert resumed["best_accuracy"] == full["best_accuracy"]


def test_resume_falls_back_past_a_torn_snapshot(tmp_path):
    d = str(tmp_path / "s")
    run_darts_search(_ds(), **{**KW, "num_epochs": 2}, checkpoint_dir=d)
    path = tmp_path / "s" / "step_00000002" / "state.pt"
    path.write_bytes(path.read_bytes()[:100])
    reports = []
    run_darts_search(_ds(), **KW, checkpoint_dir=d,
                     report=lambda **kw: reports.append(kw["epoch"]) or True)
    # epoch 2's snapshot is quarantined: the search reruns from epoch 1, and
    # the sidecar (written for 2 epochs) no longer matches, so history restarts
    assert reports == [1, 2]
    assert os.path.isdir(tmp_path / "s" / "quarantine-step_00000002")
    assert json.load(open(tmp_path / "s" / SEARCH_META))["epochs_completed"] == 3


def test_search_refuses_a_jax_checkpoint_dir(tmp_path):
    JaxCheckpointer(str(tmp_path)).save({"w": np.ones(3, np.float32)}, 1)
    with pytest.raises(NotImplementedError, match="JAX checkpoint"):
        run_darts_search(_ds(), **KW, checkpoint_dir=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["step_00000001", "step_00000001.manifest.json"]


def test_snapshot_holds_the_whole_search_state(tmp_path):
    result = run_darts_search(_ds(), **{**KW, "num_epochs": 1}, checkpoint_dir=str(tmp_path))
    tree, step = TrialCheckpointer(str(tmp_path)).restore()
    assert step == 1 and int(tree["step"]) == 3 and int(tree["a_opt/count"]) == 3
    assert torch.equal(tree["alphas/normal"], result["alphas"].normal)
    prefixes = {k.split("/")[0] for k in tree}
    assert prefixes == {"step", "weights", "alphas", "a_opt", "velocity"}
