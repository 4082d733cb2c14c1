"""Settings the JAX package reads, resolved the same way by the port or
refused: ``train_classifier(device_data=...)`` and ``KATIB_DEVICE_DATA``,
``KATIB_PALLAS_MIXED_OP``, ``KATIB_SCAN_UNROLL`` and ``KATIB_EPOCH_TRACE``.
No JAX program is compiled: the JAX side is read from its source, or from
functions that run no computation."""

from __future__ import annotations

import json
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch import nn

from katib_tpu.ops import mixed_op as j_mixed_op
from katib_tpu_torch.models import data as tdata
from katib_tpu_torch.models.mnist import train_classifier
from katib_tpu_torch.nas.darts.search import check_scan_unroll, darts_trial
from katib_tpu_torch.ops import mixed_op
from katib_tpu_torch.runner.context import TrialContext

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class CountingArray(np.ndarray):
    """An array that counts the batches gathered from it on the host."""

    gathers = 0

    def __getitem__(self, index):
        if isinstance(index, np.ndarray):
            CountingArray.gathers += 1
        return np.asarray(self).__getitem__(index)


def _train(device_data, counting=False):
    ds = tdata.synthetic_classification(16, 8, (8, 8, 3), 4, seed=7)
    if counting:
        ds = ds._replace(x_train=ds.x_train.view(CountingArray))
    torch.manual_seed(0)
    net = nn.Sequential(nn.Flatten(), nn.Linear(8 * 8 * 3, 4))
    reports = []
    acc = train_classifier(net, ds, lr=0.05, epochs=2, batch_size=4, seed=3, device="cpu",
                           device_data=device_data,
                           report=lambda **kw: reports.append(kw) or True)
    return acc, reports, [p.detach().clone() for p in net.parameters()]


def test_device_data_off_gathers_the_same_batches_on_the_host(monkeypatch):
    monkeypatch.delenv("KATIB_DEVICE_DATA", raising=False)
    CountingArray.gathers = 0
    want = _train(None)
    assert CountingArray.gathers == 0
    got = _train(False, counting=True)
    assert CountingArray.gathers == 2 * 4  # 2 epochs of 4 batches, each gathered on the host
    assert got[0] == want[0] and got[1] == want[1]
    assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))


def test_device_data_env_resolves_as_in_the_jax_package(monkeypatch):
    want = _train(True)
    monkeypatch.setenv("KATIB_DEVICE_DATA", "0")
    CountingArray.gathers = 0
    got = _train(None, counting=True)
    assert CountingArray.gathers == 8 and got[1] == want[1]
    # an explicit argument wins over the environment, as in the JAX trainer
    CountingArray.gathers = 0
    _train(True, counting=True)
    assert CountingArray.gathers == 0


MODE_SPELLINGS = ["", "auto", "AUTO", "1", "true", "on", "pallas", "interpret",
                  "0", "false", "off", "lax", " lax "]


@pytest.mark.parametrize("raw", MODE_SPELLINGS)
def test_mixed_op_mode_spellings_match_the_jax_package(raw, monkeypatch):
    monkeypatch.setenv("KATIB_PALLAS_MIXED_OP", raw)
    assert mixed_op._mode() == j_mixed_op._mode()


def _inputs(device="cpu"):
    gen = torch.Generator().manual_seed(0)
    w = torch.softmax(torch.randn(3, 4, generator=gen), -1)
    x = torch.randn(3, 4, 10, generator=gen)
    return w.to(device), x.to(device)


@pytest.mark.parametrize("raw", ["auto", "pallas", "interpret", "lax"])
def test_cpu_tensors_take_the_plain_version_under_every_mode(raw, monkeypatch):
    monkeypatch.setenv("KATIB_PALLAS_MIXED_OP", raw)
    w, x = _inputs()
    before = mixed_op.launches
    assert torch.equal(mixed_op.mixed_op_sum(w, x), mixed_op.mixed_op_sum_reference(w, x))
    assert mixed_op.launches == before


def test_an_unknown_mode_raises_as_in_the_jax_package(monkeypatch):
    monkeypatch.setenv("KATIB_PALLAS_MIXED_OP", "triton")
    with pytest.raises(ValueError, match="KATIB_PALLAS_MIXED_OP"):
        j_mixed_op._mode()
    w, x = _inputs()
    with pytest.raises(ValueError, match="KATIB_PALLAS_MIXED_OP"):
        mixed_op.mixed_op_sum(w, x)


def _cuda_like():
    """A stand-in for a CUDA tensor: the mode is checked before any launch."""
    return SimpleNamespace(device=torch.device("cuda"))


@pytest.mark.parametrize("raw", ["auto", "pallas", "1"])
def test_kernel_modes_launch_the_cuda_kernel(raw, monkeypatch):
    monkeypatch.setenv("KATIB_PALLAS_MIXED_OP", raw)
    launched = []
    monkeypatch.setattr(mixed_op, "_launch", lambda w, x: launched.append((w, x)) or "out")
    stacked = _cuda_like()
    assert mixed_op._MixedOpSum.forward(None, stacked) == "out"
    assert launched == [(None, stacked)]


@pytest.mark.parametrize("raw", ["interpret", "lax", "0", "off"])
def test_non_kernel_modes_raise_on_cuda(raw, monkeypatch):
    monkeypatch.setenv("KATIB_PALLAS_MIXED_OP", raw)
    monkeypatch.setattr(mixed_op, "_launch", lambda w, x: pytest.fail("launched"))
    with pytest.raises(NotImplementedError, match="KATIB_PALLAS_MIXED_OP"):
        mixed_op._MixedOpSum.forward(None, _cuda_like())


def test_scan_unroll_accepts_one_and_refuses_the_rest(monkeypatch):
    monkeypatch.delenv("KATIB_SCAN_UNROLL", raising=False)
    check_scan_unroll(None)
    check_scan_unroll(1)
    monkeypatch.setenv("KATIB_SCAN_UNROLL", "1")
    check_scan_unroll(None)
    with pytest.raises(NotImplementedError, match="scan unroll 4"):
        check_scan_unroll(4)
    monkeypatch.setenv("KATIB_SCAN_UNROLL", "2")
    with pytest.raises(NotImplementedError, match="KATIB_SCAN_UNROLL"):
        darts_trial(_ctx(None, {}))


SMALL = {"batch_size": 4, "init_channels": 2, "num_nodes": 1, "num_epochs": 1,
         "n_train": 16, "n_test": 8, "remat": "false", "unrolled": "false"}


def _ctx(tmp_path, settings):
    params = {"algorithm-settings": json.dumps({**SMALL, **settings}),
              "search-space": json.dumps(["max_pooling_3x3", "skip_connection"]),
              "num-layers": "2"}
    return TrialContext(params, checkpoint_dir=None if tmp_path is None else str(tmp_path),
                        device="cpu")


def _jax_trace_tags() -> list[str]:
    """The tags the JAX search prints, in source order
    (``katib_tpu/nas/darts/search.py``)."""
    with open(os.path.join(REPO, "katib_tpu", "nas", "darts", "search.py")) as f:
        return re.findall(r'_trace\("([a-z-]+)"', f.read())


@pytest.mark.parametrize("step_loop", ["true", "false"])
def test_epoch_trace_prints_the_jax_packages_tags(step_loop, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("KATIB_EPOCH_TRACE", "1")
    darts_trial(_ctx(tmp_path, {"step_loop": step_loop}))
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("epoch-trace:")]
    assert all(re.fullmatch(r"epoch-trace: [a-z-]+ \d+\.\d\ds", ln) for ln in lines), lines
    tags = [ln.split()[1] for ln in lines]
    dispatch = "scan-dispatch" if step_loop == "true" else "step-dispatch"
    assert tags == [dispatch, "loss-fetch", "eval", "state-download", "ckpt-save"]
    assert set(tags) <= set(_jax_trace_tags())
    assert set(_jax_trace_tags()) == {"scan-dispatch", "step-dispatch", "loss-fetch", "eval",
                                      "state-download", "ckpt-save"}


def test_epoch_trace_is_off_by_default(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("KATIB_EPOCH_TRACE", raising=False)
    darts_trial(_ctx(tmp_path, {}))
    assert "epoch-trace:" not in capsys.readouterr().out
