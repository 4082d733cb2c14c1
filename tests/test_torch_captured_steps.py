"""The two steps the JAX package compiles and the port captures as CUDA
graphs, on their capture code path, against the JAX package: the LM train
step (``models/transformer.py::LMTrainStep``, JAX ``train_lm``'s jitted
step) and the ENAS controller's REINFORCE step and sampler
(``nas/enas/service.py``, JAX ``make_reinforce``'s jitted ``train_step`` and
``sample``).

A CUDA graph has no CPU mode, so here ``capture_step`` is replaced by a
stand-in that does what the real one does around the graph: it warms the
step up on the copies (and checks that the fixed tensors are untouched),
puts each generator back, and returns a "graph" whose replay runs the
captured function on the fixed tensors.  Everything else (the fixed
tensors, the device-side schedule and count, the write-back, the launch
tally and its count per replay) runs as on the card.  The card's own
replays are held bit for bit against eager steps in
``tests/test_torch_captured_steps_cuda.py`` and ``chip_smoke.py``."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from katib_tpu.models.transformer import TransformerLM as JLM
from katib_tpu.models.transformer import train_lm as j_train_lm
from katib_tpu.nas.enas import controller as jctl
from katib_tpu_torch.convert import enas_controller_from_jax, transformer_state_dict_from_flax
from katib_tpu_torch.core import types as ttypes
from katib_tpu_torch.models import transformer as ttransformer
from katib_tpu_torch.models.transformer import (
    LMTrainStep,
    TransformerLM,
    make_attention_fn,
    markov_dataset,
    train_lm,
)
from katib_tpu_torch.nas.darts import step_loop
from katib_tpu_torch.nas.enas import controller as tctl
from katib_tpu_torch.nas.enas import service as tservice
from katib_tpu_torch.suggest.base import make_suggester

# tier-1 runs six test processes on the same cores: one torch thread each
torch.set_num_threads(1)

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, max_seq_len=32)


@pytest.fixture
def captures(monkeypatch):
    """Replace ``capture_step`` with its CPU stand-in; yields the list of
    captures made (one ``(step, bufs)`` per graph)."""
    made = []

    def capture(step, bufs, copy, device, *, stream=None, generators=(), recording=None):
        before = [t.clone() for t in tree_leaves(bufs)]
        saved = [g.get_state() for g in generators]
        step(copy(bufs))  # the warm-up
        for g, state in zip(generators, saved):
            g.set_state(state)
        assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(bufs))), \
            "the warm-up touched the fixed tensors"
        made.append((step, bufs))

        class Graph:
            def replay(self):
                step(bufs)

        tally = {"fwd": 2, "dq": 2, "dkv": 2} if recording is not None else None
        return Graph(), tally, 0.0

    monkeypatch.setattr(step_loop, "capture_step", capture)
    monkeypatch.setattr(tservice, "capture_step", capture)
    return made


# -- the LM train step -----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_init():
    jm = JLM(**CFG, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, CFG["max_seq_len"]), jnp.int32))
    return jm, jax.tree_util.tree_map(np.asarray, params)


def _port_model(params, dropout_rate=0.0) -> TransformerLM:
    model = TransformerLM(**CFG, dropout=dropout_rate, dtype=torch.float32,
                          attn_fn=make_attention_fn())
    model.load_state_dict(transformer_state_dict_from_flax(params, model))
    return model


def _captured(monkeypatch, made: list):
    """``train_lm`` building its step on the capture path."""

    class Captured(LMTrainStep):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.capture = True  # on the CPU: the stand-in's replays
            made.append(self)

    monkeypatch.setattr(ttransformer, "LMTrainStep", Captured)


def test_captured_lm_step_follows_the_jax_loop(jax_init, captures, monkeypatch):
    """Five replayed steps of ``train_lm`` against the JAX loop's jitted
    steps from the same weights on the same batches: every train and eval
    loss within 1e-5 relative (float32 rounding over five AdamW updates),
    and bit-equal to the same steps run eagerly; one capture, its flash
    launches counted on each replay."""
    from katib_tpu_torch.ops import flash_attention as fa

    jm, params = jax_init
    data = markov_dataset(CFG["vocab_size"], 40, CFG["max_seq_len"], seed=0)
    kwargs = dict(lr=3e-3, steps=5, batch_size=4, report_every=1, seed=0)
    jax_log, eager_log, port_log = [], [], []
    j_final = j_train_lm(jm, data, **kwargs,
                         report=lambda step, loss, eval_loss: jax_log.append((step, loss, eval_loss)))
    eager = _port_model(params)
    train_lm(eager, data, **kwargs, device="cpu",
             report=lambda step, loss, eval_loss: eager_log.append((step, loss, eval_loss)))
    steps = []
    _captured(monkeypatch, steps)
    model = _port_model(params)
    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
    p_final = train_lm(model, data, **kwargs, device="cpu",
                       report=lambda step, loss, eval_loss: port_log.append((step, loss, eval_loss)))
    (step,) = steps
    assert len(captures) == 1 and step.graph is not None
    assert step.launches_per_replay == {"fwd": 2, "dq": 2, "dkv": 2}
    # the stand-in's tally, once per replay after the first step's capture
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == (10, 10, 10)
    assert port_log == eager_log
    np.testing.assert_allclose(np.array(port_log)[:, 1:], np.array(jax_log)[:, 1:], rtol=1e-5)
    assert p_final == pytest.approx(j_final, rel=1e-5)
    for a, b in zip(model.parameters(), eager.parameters()):
        assert torch.equal(a, b)
    assert int(step.opt.count) == 5


def test_the_learning_rate_follows_the_count_on_the_device(jax_init, captures):
    """The replayed step reads its schedule from its own update count, so
    the rate moves from replay to replay (a host value would be frozen in
    the graph): the first update runs at rate 0 and leaves the weights."""
    _, params = jax_init
    model = _port_model(params)
    step = LMTrainStep(model, lr=1e-2, steps=6, warmup_frac=0.4)
    step.capture = True
    tokens = torch.from_numpy(markov_dataset(CFG["vocab_size"], 2, CFG["max_seq_len"])).long()
    start = [p.detach().clone() for p in model.parameters()]
    rates = []
    for _ in range(4):
        rates.append(float(step.schedule(step.opt.count)))
        step(tokens)
        if len(rates) == 1:  # lr 0 (weight decay is scaled by it too)
            assert all(torch.equal(a, b) for a, b in zip(start, model.parameters()))
    assert rates == pytest.approx([0.0, 0.005, 0.01, float(step.schedule(3))])
    assert rates[1] < rates[2] and int(step.opt.count) == 4


def test_captured_dropout_draws_what_eager_steps_draw(jax_init, captures):
    """With dropout the step's generator is put back after the warm-up and
    advanced by each replay, so three replayed steps equal three eager
    steps from the same seed, bit for bit, and differ from a zero rate."""
    _, params = jax_init
    tokens = torch.from_numpy(markov_dataset(CFG["vocab_size"], 4, CFG["max_seq_len"])).long()
    runs = {}
    for label, rate, capture in (("eager", 0.3, False), ("captured", 0.3, True),
                                 ("plain", 0.0, True)):
        model = _port_model(params, dropout_rate=rate)
        step = LMTrainStep(model, lr=3e-3, steps=5, seed=7)
        step.capture = capture
        losses = [float(step(tokens)) for _ in range(3)]
        runs[label] = (losses, [p.detach().clone() for p in model.parameters()])
    assert runs["captured"][0] == runs["eager"][0] != runs["plain"][0]
    assert all(torch.equal(a, b) for a, b in zip(runs["captured"][1], runs["eager"][1]))


def test_the_captured_step_refuses_what_it_cannot_capture(jax_init):
    _, params = jax_init
    with pytest.raises(ValueError, match="CUDA device"):
        LMTrainStep(_port_model(params), lr=1e-3, steps=4, capture=True)
    from katib_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"seq": 2}, devices=["cpu"] * 2)
    assert not LMTrainStep(_port_model(params), lr=1e-3, steps=4, mesh=mesh).capture
    assert not LMTrainStep(_port_model(params), lr=1e-3, steps=4).capture  # the CPU


# -- the ENAS controller ------------------------------------------------------------


def _enas_spec(settings: dict):
    t = ttypes
    return t.ExperimentSpec(
        name="enas-c",
        objective=t.ObjectiveSpec(type=t.ObjectiveType.MAXIMIZE,
                                  objective_metric_name="accuracy"),
        algorithm=t.AlgorithmSpec(name="enas", settings=settings),
        nas_config=t.NasConfig(
            graph_config=t.GraphConfig(num_layers=5),
            operations=(
                t.NasOperation("convolution", parameters=(t.ParameterSpec(
                    "filter_size", t.ParameterType.CATEGORICAL,
                    t.FeasibleSpace(list=("3", "5", "7"))),)),
                t.NasOperation("max_pooling"),
                t.NasOperation("skip_connection"),
            ),
        ),
        train_fn=lambda ctx: None,
    )


def _rounds(s, rounds: int, rewards):
    exp = ttypes.Experiment(spec=s.spec)
    arcs = []
    for rnd in range(rounds):
        if rnd:
            s.train_controller(rewards[rnd - 1])
        arcs.append([json.loads(p.as_dict()["architecture"])
                     for p in s.get_suggestions(exp, 3)])
    return arcs


def test_captured_controller_replays_what_the_eager_controller_runs(captures):
    """Three rounds of suggestions with a training between rounds: the
    suggester on its capture path (two graphs, a REINFORCE step on a fresh
    sample and a sample, replayed) proposes the same arcs as the eager
    suggester from the same seeds and ends in the same state, bit for
    bit."""
    spec = _enas_spec({"controller_hidden_size": "16", "controller_train_steps": "4",
                       "controller_learning_rate": "0.01"})
    eager, captured = make_suggester(spec, device="cpu"), make_suggester(spec, device="cpu")
    captured.capture = True
    rewards = (0.3, 0.8)
    want, got = _rounds(eager, 3, rewards), _rounds(captured, 3, rewards)
    assert got == want and len({json.dumps(a) for r in got for a in r}) > 1
    assert sorted(captured._graphs) == ["reinforce", "sample"] and len(captures) == 2
    for a, b in zip(tservice._leaves(captured.state), tservice._leaves(eager.state)):
        assert torch.equal(a, b)
    assert int(captured.state.step) == 8 and float(captured.state.baseline) != 0.0


def test_captured_reinforce_steps_hold_the_jax_train_steps(captures, monkeypatch):
    """The replayed REINFORCE step on the arcs and rewards the JAX package
    trains on (its sampler swapped for the arcs, weights carried by
    ``convert.py``): the loss's inputs and every parameter, Adam moment and
    baseline within 1e-5 of the JAX step's largest magnitude."""
    spec = _enas_spec({"controller_hidden_size": "16", "controller_train_steps": "3",
                       "controller_learning_rate": "0.005"})
    s = make_suggester(spec, device="cpu")
    s.capture = True
    jcfg = jctl.ControllerConfig(**s.cfg._asdict())
    init, j_step, _ = jctl.make_reinforce(jcfg)
    jstate = init(jax.random.PRNGKey(3))
    carried = enas_controller_from_jax(jax.device_get(jstate.params))
    torch._foreach_copy_(list(s.state.params), list(carried))
    rows = [[[1], [0, 1], [3, 0, 0], [4, 1, 0, 1], [2, 0, 1, 1, 0]],
            [[0], [2, 0], [1, 1, 1], [4, 0, 0, 0], [3, 1, 0, 0, 1]],
            [[4], [4, 1], [0, 0, 1], [2, 1, 1, 0], [1, 0, 0, 1, 1]]]
    # the capture's warm-up (on copies of the state) draws one arc first
    feed = iter(rows[:1] + rows * 2)
    monkeypatch.setattr(s, "_sample", lambda params, gen: (
        tctl.arc_from_json(next(feed), 5), {}))
    for reward in (0.3, 0.9):
        s.train_controller(reward)
        for arc in rows:
            jstate, _ = j_step(jstate, jctl.arc_from_json(arc, 5), np.float32(reward))
    adam = jstate.opt_state[0]
    assert int(s.state.step) == int(jstate.step) == 6
    assert int(s.state.opt_state.count) == int(adam.count) == 6

    def close(got, want):
        want = np.asarray(want, dtype=np.float64)
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want, rtol=1e-5,
                                   atol=1e-5 * scale)

    close(s.state.baseline, jstate.baseline)
    for field in tctl.ControllerParams._fields:
        close(getattr(s.state.params, field), getattr(jstate.params, field))
        close(s.state.opt_state.mu[field], getattr(adam.mu, field))
        close(s.state.opt_state.nu[field], getattr(adam.nu, field))
    assert tctl.arc_to_json(s.arc) == rows[-1]  # the last arc trained on, in the fixed tensors


def test_a_loaded_state_lands_in_the_fixed_tensors(captures):
    """``load_state_dict`` writes into the tensors the graphs read, so a
    resumed suggester replays from the loaded state."""
    spec = _enas_spec({"controller_hidden_size": "16", "controller_train_steps": "2"})
    trained = make_suggester(spec, device="cpu")
    trained.get_suggestions(ttypes.Experiment(spec=spec), 1)
    trained.train_controller(0.5)
    resumed = make_suggester(spec, device="cpu")
    resumed.capture = True
    resumed.get_suggestions(ttypes.Experiment(spec=spec), 1)  # captures the sampler
    fixed = [t.data_ptr() for t in tservice._leaves(resumed.state)]
    resumed.load_state_dict(trained.state_dict())
    assert [t.data_ptr() for t in tservice._leaves(resumed.state)] == fixed
    for a, b in zip(tservice._leaves(resumed.state), tservice._leaves(trained.state)):
        assert torch.equal(a, b)
