"""ENAS in the port against the JAX package's: the controller's trace and
its REINFORCE steps with weights carried by ``convert.py``, sampling by
distribution, the arc's JSON, the child CNN forward and backward, the
suggester's validation, rounds and state, ``train_classifier``'s two hooks
and weight sharing.  JAX runs on the CPU in float32 (bf16 where a test says
so), at small sizes: controller hidden 16 over 4-5 layers, children of 8
channels on 16x16 images."""

from __future__ import annotations

import copy
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from katib_tpu.models import data as jdata
from katib_tpu.models import mnist as jmnist
from katib_tpu.nas.enas import child as jchild
from katib_tpu.nas.enas import controller as jctl
from katib_tpu.nas.enas import service as jservice
from katib_tpu.orchestrator import resume as jresume
from katib_tpu.sdk.yaml_spec import experiment_spec_from_dict as j_from_dict
from katib_tpu_torch.convert import enas_controller_from_jax, enas_state_dict_from_flax
from katib_tpu_torch.core import types as ttypes
from katib_tpu_torch.models import data as tdata
from katib_tpu_torch.models import mnist as tmnist
from katib_tpu_torch.nas.enas import child as tchild
from katib_tpu_torch.nas.enas import controller as tctl
from katib_tpu_torch.nas.enas import service as tservice
from katib_tpu_torch.nas.enas import shared as tshared
from katib_tpu_torch.nas.enas.trial import enas_trial
from katib_tpu_torch.orchestrator import resume as tresume
from katib_tpu_torch.runner.context import TrialContext
from katib_tpu_torch.sdk.yaml_spec import experiment_spec_from_dict as t_from_dict
from katib_tpu_torch.suggest.base import SuggesterError, SuggestionsNotReady, make_suggester

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENAS_YAML = os.path.join(ROOT, "examples", "nas", "enas.yaml")
RTOL = 1e-5
NULLABLE = ("temperature", "tanh_const", "entropy_weight", "skip_weight")


def _close(got, want, rtol=RTOL):
    """Within ``rtol`` of the largest magnitude of ``want``."""
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _jax_params(cfg, seed: int = 0, scale: float | None = None):
    """The JAX controller's weights: its own init, or normal draws of
    ``scale`` (a spread distribution over the ops)."""
    if scale is None:
        return jax.device_get(jctl.init_controller(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    shapes = jctl.init_controller(cfg, jax.random.PRNGKey(seed))
    return jctl.ControllerParams(*(
        (rng.normal(size=p.shape) * scale).astype(np.float32) for p in shapes))


def _arcs(num_layers: int):
    """Fixed arcs as per-layer JSON rows: no skips, every skip, a pattern."""
    ops = [(3 * i + 1) % 6 for i in range(num_layers)]
    return [
        [[o] + [0] * i for i, o in enumerate(ops)],
        [[o] + [1] * i for i, o in enumerate(ops)],
        [[o] + [(i + j) % 2 for j in range(i)] for i, o in enumerate(ops)],
    ]


def _cfgs(name=None, value=None, **kw):
    base = dict(num_layers=5, num_operations=6, hidden_size=16, **kw)
    if name is not None:
        base[name] = value
    return jctl.ControllerConfig(**base), tctl.ControllerConfig(**base)


def _jax_loss(params, cfg, arc, reward, baseline):
    """The JAX train step's loss (``make_reinforce.loss_fn``) for one arc."""
    _, stats = jctl._trace(params, cfg, arc)
    r = reward
    if cfg.entropy_weight is not None:
        r = r + cfg.entropy_weight * stats["entropy"]
    b = baseline - (1.0 - cfg.baseline_decay) * (baseline - r)
    loss = -stats["log_prob"] * jax.lax.stop_gradient(r - b)
    if cfg.skip_weight is not None:
        loss = loss + cfg.skip_weight * stats["skip_penalty"]
    return loss


# -- the controller ------------------------------------------------------------


@pytest.mark.parametrize("value", ["set", "None"])
@pytest.mark.parametrize("name", NULLABLE)
def test_trace_and_reinforce_gradient_match_jax(name, value):
    default = jctl.ControllerConfig._field_defaults[name]
    jcfg, tcfg = _cfgs(name, default if value == "set" else None)
    jparams = _jax_params(jcfg, seed=1, scale=0.5)
    tparams = enas_controller_from_jax(jparams)
    for rows in _arcs(5):
        jarc, tarc = jctl.arc_from_json(rows, 5), tctl.arc_from_json(rows, 5)
        _, want = jctl._trace(jparams, jcfg, jarc)
        grad_params = tctl.ControllerParams(*(p.clone().requires_grad_() for p in tparams))
        got_arc, got = tctl._trace(grad_params, tcfg, tarc)
        assert tctl.arc_to_json(got_arc) == rows
        for key in ("log_prob", "entropy", "skip_penalty", "skip_count"):
            _close(torch.as_tensor(got[key]).detach(), want[key])
        want_g = jax.grad(_jax_loss)(jparams, jcfg, jarc, 0.7, 0.2)
        # the port's loss, written as the port's train step writes it
        r = torch.tensor(0.7)
        if tcfg.entropy_weight is not None:
            r = r + tcfg.entropy_weight * got["entropy"]
        b = 0.2 - (1.0 - tcfg.baseline_decay) * (0.2 - r)
        loss = -got["log_prob"] * (r - b).detach()
        if tcfg.skip_weight is not None:
            loss = loss + tcfg.skip_weight * got["skip_penalty"]
        grads = torch.autograd.grad(loss, list(grad_params))
        for field, g in zip(tctl.ControllerParams._fields, grads):
            _close(g, getattr(want_g, field))


def test_lstm_gate_order_is_ifog_without_bias():
    """``_lstm`` is not ``nn.LSTMCell``: gates i, f, o, g of one bias-free
    ``(2H, 4H)`` matrix, as the JAX package's."""
    rng = np.random.default_rng(0)
    x, c, h = (rng.normal(size=(1, 4)).astype(np.float32) for _ in range(3))
    w = rng.normal(size=(8, 16)).astype(np.float32)
    want = jctl._lstm(x, c, h, w)
    got = tctl._lstm(*(torch.from_numpy(a) for a in (x, c, h, w)))
    for g, wnt in zip(got, want):
        _close(g, wnt)


def test_five_train_steps_match_jax():
    jcfg, tcfg = _cfgs(learning_rate=5e-3)
    init, j_step, _ = jctl.make_reinforce(jcfg)
    jstate = init(jax.random.PRNGKey(3))
    t_init, t_step, _ = tctl.make_reinforce(tcfg)
    tstate = t_init(torch.Generator().manual_seed(0))
    # Adam's initial state is zeros whatever the weights: carry the weights
    tstate = tstate._replace(params=enas_controller_from_jax(jax.device_get(jstate.params)))
    rows = _arcs(5) + _arcs(5)[:2]
    for step, (arc, reward) in enumerate(zip(rows, (0.3, 0.9, 0.5, 0.1, 0.7))):
        jstate, jm = j_step(jstate, jctl.arc_from_json(arc, 5), np.float32(reward))
        tstate, tm = t_step(tstate, tctl.arc_from_json(arc, 5), reward)
        adam = jstate.opt_state[0]
        assert int(tstate.step) == int(jstate.step) == step + 1
        assert int(tstate.opt_state.count) == int(adam.count)
        _close(tm["loss"], jm["loss"])
        _close(tm["baseline"], jm["baseline"])
        _close(tstate.baseline, jstate.baseline)
        for field in tctl.ControllerParams._fields:
            _close(getattr(tstate.params, field), getattr(jstate.params, field))
            _close(tstate.opt_state.mu[field], getattr(adam.mu, field))
            _close(tstate.opt_state.nu[field], getattr(adam.nu, field))


def test_sampling_is_lower_triangular_and_reproducible():
    _, tcfg = _cfgs()
    params = enas_controller_from_jax(_jax_params(jctl.ControllerConfig(**tcfg._asdict())))
    _, _, sample = tctl.make_reinforce(tcfg)
    arcs = [sample(params, torch.Generator().manual_seed(s))[0] for s in (1, 1, 2)]
    for arc in arcs:
        assert arc.ops.shape == (5,) and arc.skips.shape == (5, 5)
        assert arc.ops.dtype == arc.skips.dtype == torch.int64
        assert not torch.triu(arc.skips).any()
        assert ((arc.ops >= 0) & (arc.ops < 6)).all() and set(arc.skips.unique().tolist()) <= {0, 1}
    assert tctl.arc_to_json(arcs[0]) == tctl.arc_to_json(arcs[1])


def test_layer0_op_frequencies_match_the_jax_softmax():
    """Layer 0's logits depend on the weights alone, so both packages
    compute the same distribution; 4,000 of the port's draws land within 4
    standard errors of it."""
    jcfg = jctl.ControllerConfig(num_layers=4, num_operations=6, hidden_size=16)
    tcfg = tctl.ControllerConfig(**jcfg._asdict())
    jparams = _jax_params(jcfg, seed=5, scale=1.0)
    zeros = jnp.zeros((1, 16))
    _, h = jctl._lstm(jparams.g_emb, zeros, zeros, jparams.w_lstm)
    probs = np.asarray(jax.nn.softmax(jctl._shape_logits(h @ jparams.w_soft, jcfg)[0]))
    assert probs.max() > 2 * probs.min()  # a spread distribution, not a uniform one
    params = enas_controller_from_jax(jparams)
    _, _, sample = tctl.make_reinforce(tcfg)
    gen = torch.Generator().manual_seed(11)
    n = 4000
    counts = np.bincount([int(sample(params, gen)[0].ops[0]) for _ in range(n)], minlength=6)
    freq = counts / n
    stderr = np.sqrt(probs * (1 - probs) / n)
    assert np.all(np.abs(freq - probs) <= 4 * stderr), (freq, probs)


def test_reinforce_learns_preference():
    cfg = tctl.ControllerConfig(
        num_layers=3, num_operations=3, learning_rate=5e-3, entropy_weight=None,
        skip_weight=None, baseline_decay=0.9,
    )
    init, train_step, sample = tctl.make_reinforce(cfg)
    state = init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    for _ in range(200):
        arc, _ = sample(state.params, gen)
        reward = float((arc.ops == 1).float().mean())
        state, _ = train_step(state, arc, reward)
    counts = np.zeros(3)
    for _ in range(40):
        arc, _ = sample(state.params, gen)
        for o in arc.ops.tolist():
            counts[o] += 1
    assert counts[1] == counts.max()


@pytest.mark.parametrize("rows", [[[2], [0, 1], [1, 0, 1]], [[0], [3, 1], [5, 0, 0], [1, 1, 1, 1]]],
                         ids=["3-layers", "4-layers"])
def test_arc_json_matches_jax(rows):
    n = len(rows)
    jarc, tarc = jctl.arc_from_json(rows, n), tctl.arc_from_json(rows, n)
    assert tctl.arc_to_json(tarc) == jctl.arc_to_json(jarc) == rows
    np.testing.assert_array_equal(tarc.ops.numpy(), np.asarray(jarc.ops))
    np.testing.assert_array_equal(tarc.skips.numpy(), np.asarray(jarc.skips))


# -- the child -------------------------------------------------------------------

SPEC_OPS = ("separable_convolution_3x3", "separable_convolution_5x5", "convolution_3x3",
            "max_pooling", "avg_pooling")
CHILDREN = {
    # all six ops, a skip into every later layer, pools after layers 3 and 6
    "default-ops": (jchild.DEFAULT_OPERATIONS,
                    [[0], [1, 1], [2, 0, 1], [3, 1, 1, 0], [4, 0, 1, 1, 1], [5, 1, 0, 0, 1, 0],
                     [2, 1, 1, 1, 1, 1, 1]]),
    # the spec's unsized pool names, across a pool
    "spec-ops": (SPEC_OPS, [[3], [4, 1], [0, 1, 1], [1, 0, 0, 1], [2, 1, 0, 1, 1]]),
}


def _children(kind, dtype):
    ops, rows = CHILDREN[kind]
    jnet = jchild.child_from_arc(jctl.arc_from_json(rows, len(rows)), operations=ops,
                                 channels=8, num_classes=4)
    jnet = jnet.clone(dtype=getattr(jnp, dtype))
    tnet = tchild.child_from_arc(tctl.arc_from_json(rows, len(rows)), operations=ops,
                                 channels=8, num_classes=4, dtype=getattr(torch, dtype))
    return jnet, tnet


def _child_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(3, 16, 16, 3)).astype(np.float32),
            rng.normal(size=(3, 4)).astype(np.float32))


@pytest.mark.parametrize("kind", sorted(CHILDREN))
def test_child_forward_and_gradients_match_flax(kind):
    jnet, tnet = _children(kind, "float32")
    x, cot = _child_inputs()
    params = jax.device_get(jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x)))
    want_g = jax.device_get(jax.jit(jax.grad(
        lambda p: jnp.sum(jnet.apply(p, jnp.asarray(x)) * cot)))(params))
    tnet.load_state_dict(enas_state_dict_from_flax(params, tnet))
    got = tnet(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 4)
    _close(got.detach(), want)
    names = [k for k, _ in tnet.named_parameters()]
    grads = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), list(tnet.parameters()))
    want_grads = enas_state_dict_from_flax(want_g, tnet)
    assert set(want_grads) == set(names)
    for name, g in zip(names, grads):
        _close(g, want_grads[name])


# bf16 keeps 8 significant bits and the two packages round at different
# points (XLA widens bf16 sums inside a fusion, PyTorch per operator): allow
# four spacings at the largest logit, as tests/test_torch_mnist.py does (these
# children differ by under one)
BF16_RTOL = 4 * 2.0**-8


@pytest.mark.parametrize("kind", sorted(CHILDREN))
def test_child_bf16_forward_matches_flax(kind):
    jnet, tnet = _children(kind, "bfloat16")
    x, _ = _child_inputs(1)
    params = jax.device_get(jax.jit(jnet.init)(jax.random.PRNGKey(1), jnp.asarray(x)))
    want = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x)))
    tnet.load_state_dict(enas_state_dict_from_flax(params, tnet))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got, want, rtol=BF16_RTOL)


def test_child_modules_carry_the_flax_names_and_input_widths():
    _, tnet = _children("default-ops", "float32")
    names = dict(tnet.named_parameters())
    assert names["op3_separable_convolution_5x5.depthwise.kernel"].shape == (5, 5, 1, 8 * 3)
    assert names["op3_separable_convolution_5x5.conv.weight"].shape == (8, 24, 1, 1)
    assert names["op6_separable_convolution_3x3.depthwise.kernel"].shape == (3, 3, 1, 8 * 7)
    assert names["op0_convolution_3x3.conv.weight"].shape == (8, 8, 3, 3)
    assert names["stem.weight"].shape == (8, 3, 3, 3) and names["head.weight"].shape == (4, 8)


def test_child_refuses_unknown_ops_and_the_safe_conv():
    arc = tctl.arc_from_json([[0]], 1)
    for bad in ("convolution", "identity"):
        with pytest.raises(ValueError, match="unknown ENAS operation"):
            tchild.child_from_arc(arc, operations=(bad,))
        with pytest.raises(ValueError):
            jchild.child_from_arc(jctl.arc_from_json([[0]], 1), operations=(bad,)).init(
                jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 3)))
    # safe_conv is accepted and keeps the native depthwise form: the same
    # parameters and, in float32, the flax child's shift-MAC output (1e-5)
    rows = [[2], [3, 1]]
    jnet = jchild.child_from_arc(jctl.arc_from_json(rows, 2), channels=8, num_classes=4,
                                 safe_conv=True).clone(dtype=jnp.float32)
    tnet = tchild.child_from_arc(tctl.arc_from_json(rows, 2), channels=8, num_classes=4,
                                 dtype=torch.float32, safe_conv=True)
    native = tchild.child_from_arc(tctl.arc_from_json(rows, 2), channels=8, num_classes=4,
                                   dtype=torch.float32)
    assert [k for k, _ in tnet.named_parameters()] == [k for k, _ in native.named_parameters()]
    x, _ = _child_inputs()
    params = jax.device_get(jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    tnet.load_state_dict(enas_state_dict_from_flax(params, tnet))
    got = tnet(torch.from_numpy(x)).detach()
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


def test_conversion_refuses_a_tree_of_another_arc():
    jnet, _ = _children("spec-ops", "float32")
    params = jax.device_get(jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
    _, other = _children("default-ops", "float32")
    with pytest.raises(KeyError):
        enas_state_dict_from_flax(params, other)
    wider = tchild.child_from_arc(tctl.arc_from_json(CHILDREN["spec-ops"][1], 5),
                                  operations=SPEC_OPS, channels=16, num_classes=4)
    with pytest.raises(ValueError, match="shape"):
        enas_state_dict_from_flax(params, wider)


# -- the suggester ---------------------------------------------------------------


def _enas_doc(settings: dict | None = None):
    with open(ENAS_YAML) as f:
        doc = yaml.safe_load(f)
    if settings is not None:
        doc["spec"]["algorithm"]["algorithmSettings"] = [
            {"name": k, "value": v} for k, v in settings.items()]
    return doc


SETTINGS = {
    "shipped": None,
    "defaults": {},
    "nulls": {k: "None" for k in ("controller_temperature", "controller_tanh_const",
                                  "controller_entropy_weight", "controller_skip_weight")},
    "null-hidden": {"controller_hidden_size": "None"},
    "null-steps": {"controller_train_steps": "None"},
    "bad-int": {"controller_hidden_size": "3.5"},
    "bad-float": {"controller_learning_rate": "fast"},
    "decay-high": {"controller_baseline_decay": "1.5"},
    "decay-edge": {"controller_baseline_decay": "1.0"},
}


@pytest.mark.parametrize("case", sorted(SETTINGS))
def test_validate_accepts_and_refuses_as_jax(case):
    doc = _enas_doc(SETTINGS[case])
    jspec, tspec = j_from_dict(copy.deepcopy(doc)), t_from_dict(copy.deepcopy(doc))
    outcomes = []
    for cls, spec in ((jservice.EnasSuggester, jspec), (tservice.EnasSuggester, tspec)):
        try:
            cls.validate(spec)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append((type(e).__name__, str(e)))
    assert outcomes[0] == outcomes[1]


def test_validate_refuses_a_spec_without_operations():
    spec = t_from_dict(_enas_doc())
    spec.nas_config = None
    with pytest.raises(SuggesterError, match="enas requires nas_config with operations"):
        tservice.EnasSuggester.validate(spec)


def test_operations_and_nn_config_are_byte_equal_to_jax():
    jspec, tspec = j_from_dict(_enas_doc()), t_from_dict(_enas_doc())
    assert tservice._operations_from_nas_config(tspec.nas_config) == (
        jservice._operations_from_nas_config(jspec.nas_config))
    from katib_tpu.core.types import Experiment as JExperiment

    jprops = jservice.EnasSuggester(jspec).get_suggestions(JExperiment(spec=jspec), 2)
    tprops = make_suggester(tspec, device="cpu").get_suggestions(ttypes.Experiment(spec=tspec), 2)
    for jp, tp in zip(jprops, tprops):
        assert tp.as_dict()["nn_config"] == jp.as_dict()["nn_config"]
        assert tp.labels == jp.labels == {"enas-round": "0"}
        rows = json.loads(tp.as_dict()["architecture"])
        assert [len(r) for r in rows] == [1, 2, 3, 4]
        assert all(0 <= r[0] < 5 and set(r[1:]) <= {0, 1} for r in rows)


def _nas_spec(settings):
    t = ttypes
    return t.ExperimentSpec(
        name="nas-enas",
        objective=t.ObjectiveSpec(type=t.ObjectiveType.MAXIMIZE,
                                  objective_metric_name="accuracy"),
        algorithm=t.AlgorithmSpec(name="enas", settings=settings),
        nas_config=t.NasConfig(
            graph_config=t.GraphConfig(num_layers=4),
            operations=(
                t.NasOperation("separable_convolution", parameters=(
                    t.ParameterSpec("filter_size", t.ParameterType.CATEGORICAL,
                                    t.FeasibleSpace(list=("3", "5"))),)),
                t.NasOperation("skip_connection"),
            ),
        ),
        train_fn=lambda ctx: None,
    )


def _complete(exp, proposal, value, condition=ttypes.TrialCondition.SUCCEEDED):
    t = ttypes
    name = proposal.name or f"{exp.name}-t{len(exp.trials)}"
    trial = t.Trial(
        name=name, experiment_name=exp.name,
        spec=t.TrialSpec(assignments=list(proposal.assignments), labels=dict(proposal.labels)),
        condition=condition, start_time=float(len(exp.trials)),
    )
    if condition.is_completed_ok():
        trial.observation = t.Observation(
            metrics=[t.Metric(name="accuracy", value=value, latest=value)])
    exp.trials[name] = trial
    return trial


def test_round_lifecycle():
    spec = _nas_spec({"controller_train_steps": "2", "controller_hidden_size": "16"})
    s = make_suggester(spec, device="cpu")
    exp = ttypes.Experiment(spec=spec)
    round0 = s.get_suggestions(exp, 3)
    assert len(round0) == 3
    for p in round0:
        params = p.as_dict()
        assert len(json.loads(params["architecture"])) == 4
        assert json.loads(params["nn_config"])["num_layers"] == 4
        assert p.labels["enas-round"] == "0"
    t = _complete(exp, round0[0], 0.0, condition=ttypes.TrialCondition.RUNNING)
    with pytest.raises(SuggestionsNotReady):
        s.get_suggestions(exp, 3)
    assert s._trained_rounds == set()
    t.condition = ttypes.TrialCondition.SUCCEEDED
    t.observation = ttypes.Observation(
        metrics=[ttypes.Metric(name="accuracy", value=0.6, latest=0.6)])
    for p in round0[1:]:
        _complete(exp, p, 0.5)
    before = s.state.params.w_lstm.clone()
    round1 = s.get_suggestions(exp, 2)
    assert all(p.labels["enas-round"] == "1" for p in round1)
    assert s._trained_rounds == {0} and int(s.state.step) == 2
    assert not torch.equal(before, s.state.params.w_lstm)
    assert s._mean_reward(list(exp.trials.values())) == pytest.approx((0.6 + 0.5 + 0.5) / 3)


def test_mean_reward_is_sign_flipped_for_minimize():
    spec = _nas_spec({"controller_hidden_size": "16"})
    spec.objective = ttypes.ObjectiveSpec(type=ttypes.ObjectiveType.MINIMIZE,
                                          objective_metric_name="accuracy")
    s = make_suggester(spec, device="cpu")
    exp = ttypes.Experiment(spec=spec)
    trials = [_complete(exp, p, v) for p, v in zip(s.get_suggestions(exp, 2), (0.2, 0.4))]
    assert s._mean_reward(trials) == pytest.approx(-0.3)


def test_state_dict_round_trip_on_the_cpu():
    spec = _nas_spec({"controller_hidden_size": "16"})
    s = make_suggester(spec, device="cpu")
    exp = ttypes.Experiment(spec=spec)
    s.get_suggestions(exp, 1)
    s.train_controller(0.5)
    data = pickle.loads(pickle.dumps(s.state_dict()))
    tensors = [data["controller"]["baseline"], data["controller"]["step"],
               *data["controller"]["params"].values(), *data["controller"]["opt_state"]["mu"].values()]
    assert all(t.device.type == "cpu" for t in tensors)
    s2 = make_suggester(spec, device="cpu")
    s2.load_state_dict(data)
    assert s2.round == 1 and int(s2.state.step) == int(s.state.step) == 50
    for a, b in zip(s2.state.params, s.state.params):
        assert torch.equal(a, b)
    assert torch.equal(s2.state.opt_state.nu["w_soft"], s.state.opt_state.nu["w_soft"])
    assert float(s2.state.baseline) == float(s.state.baseline) != 0.0


def test_a_jax_state_pickle_is_refused_and_its_fence_still_reads(tmp_path):
    """A JAX package's ENAS state unpickles without importing its classes
    (fsck reads its fence) and the port's suggester refuses it, so the
    orchestrator rebuilds from the journal."""
    from katib_tpu.core.types import Experiment as JExperiment

    jspec, tspec = j_from_dict(_enas_doc()), t_from_dict(_enas_doc())
    js = jservice.EnasSuggester(jspec)
    js.get_suggestions(JExperiment(spec=jspec), 1)
    workdir = str(tmp_path)
    assert jresume.save_suggester_state(js, workdir, jspec.name, fence=7)
    assert tresume.read_suggester_fence(workdir, tspec.name) == 7 == (
        jresume.read_suggester_fence(workdir, jspec.name))
    ts = make_suggester(tspec, device="cpu")
    assert not tresume.load_suggester_state(ts, workdir, tspec.name)
    assert ts.round == 0


def test_a_bare_suggester_resolves_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = _nas_spec({"controller_hidden_size": "16"})
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tservice.EnasSuggester(spec)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        make_suggester(spec)
    assert make_suggester(spec, device="cpu").state.params.w_lstm.device.type == "cpu"


# -- the trainer's hooks and the trial -----------------------------------------


def _hook_calls(package, model, dataset):
    calls = []

    def init_transform(params):
        calls.append("init_transform")
        return params

    def report(epoch, accuracy, loss):
        calls.append(f"report {epoch}")
        return epoch < 1  # stop after epoch 1 of 3

    package.train_classifier(model, dataset, lr=0.1, epochs=3, batch_size=8, report=report,
                             init_transform=init_transform,
                             on_finish=lambda p: calls.append(("on_finish", p)),
                             **({"device": "cpu"} if package is tmnist else {}))
    return calls


def test_train_classifier_hooks_follow_the_jax_order(monkeypatch):
    loops = []

    class SpyLoop(tmnist.EpochLoop):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            loops.append(self)

    monkeypatch.setattr(tmnist, "EpochLoop", SpyLoop)
    want = _hook_calls(jmnist, jmnist.MLP(units=8, num_layers=1, dtype=jnp.float32),
                       jdata.synthetic_classification(32, 8, (4, 4, 1), 10, seed=2))
    model = tmnist.MLP(units=8, num_layers=1, in_features=16, dtype=torch.float32)
    got = _hook_calls(tmnist, model, tdata.synthetic_classification(32, 8, (4, 4, 1), 10, seed=2))
    assert [c if isinstance(c, str) else c[0] for c in got] == (
        [c if isinstance(c, str) else c[0] for c in want]) == [
        "init_transform", "report 0", "report 1", "on_finish"]
    final = got[-1][1]
    (loop,) = loops
    assert set(final) == set(loop.state.params)
    for k, t in final.items():
        assert t.device.type == "cpu" and torch.equal(t, loop.state.params[k])
        assert t.data_ptr() != loop.state.params[k].data_ptr()


def test_init_transform_output_is_what_trains():
    ds = tdata.synthetic_classification(32, 8, (4, 4, 1), 10, seed=2)
    donor = tmnist.MLP(units=8, num_layers=1, in_features=16, dtype=torch.float32)
    donor.reset_parameters(torch.Generator().manual_seed(4))
    runs = []
    for model, transform in (
        (copy.deepcopy(donor), None),
        (tmnist.MLP(units=8, num_layers=1, in_features=16, dtype=torch.float32),
         lambda p: {k: v.detach().clone() for k, v in donor.named_parameters()}),
    ):
        reports = []
        tmnist.train_classifier(model, ds, lr=0.1, epochs=2, batch_size=8, device="cpu",
                                report=lambda **kw: reports.append(kw) or True,
                                init_transform=transform)
        runs.append(reports)
    assert runs[0] == runs[1]


def test_overlay_matches_name_shape_and_dtype():
    params = {"a": torch.zeros(2), "b": torch.zeros(3), "c": torch.zeros(2), "d": torch.zeros(1)}
    shared = {"a": torch.ones(2), "b": torch.ones(4), "c": torch.ones(2, dtype=torch.float64),
              "e": torch.ones(1)}
    merged, n = tshared.overlay_matching(params, shared)
    assert n == 1 and torch.equal(merged["a"], torch.ones(2))
    assert all(torch.equal(merged[k], params[k]) for k in "bcd") and set(merged) == set(params)


def test_pool_publishes_versions_and_refuses_a_jax_pool(tmp_path):
    pool = str(tmp_path / "enas-shared")
    assert tshared.load_pool(pool) is None
    tshared.publish_pool(pool, {"w": torch.ones(2)})
    tshared.publish_pool(pool, {"w": torch.full((2,), 2.0)})
    assert torch.equal(tshared.load_pool(pool)["w"], torch.full((2,), 2.0))
    jax_pool = tmp_path / "jax-shared"
    (jax_pool / "step_00000001" / "default").mkdir(parents=True)
    (jax_pool / "step_00000001" / "default" / "_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="JAX checkpoint"):
        tshared.load_pool(str(jax_pool))


def test_enas_trial_reads_the_jax_trials_parameters(tmp_path):
    ctx = TrialContext({"architecture": json.dumps([[3], [4, 1], [0, 1, 1], [1, 0, 0, 1]]),
                        "nn_config": json.dumps({"num_layers": 4, "operations": list(SPEC_OPS)}),
                        "n_train": "64", "n_test": "16", "channels": "4", "num_epochs": "2",
                        "batch_size": "32"},
                       checkpoint_dir=str(tmp_path / "t"), device="cpu")
    enas_trial(ctx)
    assert [s for s, _ in ctx.reports] == [0, 1]
    assert all(0.0 <= m["accuracy"] <= 1.0 and np.isfinite(m["loss"]) for _, m in ctx.reports)
    assert not (tmp_path / "enas-shared").exists()  # no weight_sharing, no pool


def test_child_inherits_pool_and_publishes_back(tmp_path):
    """``weight_sharing``: a child overlays the shared pool before training
    (same arc: it starts at the previous child's final accuracy) and
    publishes its trained parameters back (``tests/test_nas.py::
    TestEnasWeightSharing`` on the port)."""
    runs = []

    def run(trial_dir):
        ctx = TrialContext({
            "architecture": json.dumps([[0], [1, 1]]),
            "nn_config": json.dumps({"num_layers": 2}),
            "dataset": "digits",
            # enough steps that the first child learns: the assertion needs
            # accuracy daylight between a cold and a warm start
            "num_epochs": "5",
            "batch_size": "64",
            "channels": "8",
            "weight_sharing": "true",
        }, checkpoint_dir=str(trial_dir), device="cpu")
        enas_trial(ctx)
        runs.append([m for _, m in ctx.reports])

    exp_dir = tmp_path / "exp"
    run(exp_dir / "t1")
    assert (exp_dir / "enas-shared").is_dir()
    first_final = runs[0][-1]["accuracy"]
    run(exp_dir / "t2")
    assert runs[1][0]["accuracy"] >= first_final - 0.05
    assert runs[1][0]["accuracy"] > runs[0][0]["accuracy"] + 0.05
