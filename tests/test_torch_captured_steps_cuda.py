"""The captured LM train step, the captured ENAS controller and the
profiler on the card (``cuda``-marked; they skip without a GPU).  This
file imports no JAX, so that it runs where the port runs:

    python -m pytest --noconftest -q tests/test_torch_captured_steps_cuda.py -m cuda

Each replayed step is held bit for bit against the same step run eagerly
on the card from the same state and generator."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from katib_tpu_torch.core import types as ttypes
from katib_tpu_torch.costmodel import profiler
from katib_tpu_torch.models.transformer import (
    LMTrainStep,
    TransformerLM,
    make_attention_fn,
    markov_dataset,
)
from katib_tpu_torch.nas.enas import service as tservice
from katib_tpu_torch.ops import flash_attention as fa
from katib_tpu_torch.suggest.base import make_suggester

SMALL_LM = dict(vocab_size=64, d_model=64, n_heads=2, n_layers=2, max_seq_len=128)


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: a CUDA graph has no CPU mode")
    return torch.device("cuda", 0)


def _lm_run(device, capture: bool, dropout: float, steps: int = 4):
    model = TransformerLM(**SMALL_LM, dropout=dropout, attn_fn=make_attention_fn())
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(device)
    step = LMTrainStep(model, lr=3e-3, steps=steps + 1, seed=3, capture=capture)
    data = torch.from_numpy(markov_dataset(SMALL_LM["vocab_size"], 4 * steps,
                                           SMALL_LM["max_seq_len"])).long().to(device)
    losses = [step(batch).cpu() for batch in data.split(4)]
    torch.cuda.synchronize()
    return step, losses, [p.detach().cpu() for p in model.parameters()]


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["no-dropout", "dropout"])
def test_replayed_lm_steps_equal_eager_steps(cuda_device, dropout):
    eager, want_losses, want = _lm_run(cuda_device, False, dropout)
    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
    step, losses, got = _lm_run(cuda_device, True, dropout)
    assert step.graph is not None and eager.graph is None
    # 2 layers: one forward, one dq and one dk/dv each per replay; the
    # warm-up step's launches are real, then 4 replays
    assert step.launches_per_replay == {"fwd": 2, "dq": 2, "dkv": 2}
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == (10, 10, 10)
    assert all(torch.equal(a, b) for a, b in zip(losses, want_losses))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(np.isfinite(float(x)) for x in losses)


def _enas_spec():
    t = ttypes
    return t.ExperimentSpec(
        name="enas-card",
        objective=t.ObjectiveSpec(type=t.ObjectiveType.MAXIMIZE,
                                  objective_metric_name="accuracy"),
        algorithm=t.AlgorithmSpec(name="enas", settings={"controller_train_steps": "5"}),
        nas_config=t.NasConfig(
            graph_config=t.GraphConfig(num_layers=6),
            operations=(
                t.NasOperation("convolution", parameters=(t.ParameterSpec(
                    "filter_size", t.ParameterType.CATEGORICAL,
                    t.FeasibleSpace(list=("3", "5"))),)),
                t.NasOperation("max_pooling"),
            ),
        ),
        train_fn=lambda ctx: None,
    )


@pytest.mark.cuda
def test_replayed_controller_equals_the_eager_controller(cuda_device):
    spec = _enas_spec()
    runs = {}
    for capture in (False, True):
        s = make_suggester(spec, device=str(cuda_device))
        s.capture = capture
        exp = ttypes.Experiment(spec=spec)
        arcs = [p.as_dict()["architecture"] for p in s.get_suggestions(exp, 3)]
        s.train_controller(0.4)
        arcs += [p.as_dict()["architecture"] for p in s.get_suggestions(exp, 3)]
        runs[capture] = (arcs, [t.cpu() for t in tservice._leaves(s.state)], s)
    assert sorted(runs[True][2]._graphs) == ["reinforce", "sample"]
    assert runs[True][0] == runs[False][0]
    assert len({json.dumps(a) for a in runs[True][0]}) > 1
    assert all(torch.equal(a, b) for a, b in zip(runs[True][1], runs[False][1]))


@pytest.mark.cuda
def test_a_card_capture_traces_the_kernels_of_a_replayed_step(cuda_device, tmp_path):
    profiler.reset()
    model = TransformerLM(**SMALL_LM, attn_fn=make_attention_fn())
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(cuda_device)
    step = LMTrainStep(model, lr=3e-3, steps=4)
    tokens = torch.from_numpy(markov_dataset(SMALL_LM["vocab_size"], 4,
                                             SMALL_LM["max_seq_len"])).long().to(cuda_device)
    step(tokens)  # captured outside the profile
    with profiler.capture(str(tmp_path), trial="t", device=cuda_device):
        step(tokens)
        torch.cuda.synchronize()
    with open(os.path.join(tmp_path, profiler.TRACE_FILE)) as f:
        kernels = [e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    assert sum("flash_fwd" in k for k in kernels) == 2, kernels
    assert sum("flash_dkv" in k for k in kernels) == 2
    assert [e["trial"] for e in profiler.list_profiles()] == ["t"]
