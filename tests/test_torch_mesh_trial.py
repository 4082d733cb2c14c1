"""One trial on a mesh, whole: the port against the JAX package on its
virtual CPU devices, in float32, at small sizes.

- the step loop on ``{data: 2}`` (with remat, the JAX default) against the
  JAX ``lax.scan`` window on its ``{data: 2}`` mesh: the losses, weights and
  alphas after a window;
- remat and ``remat_policy="dots"`` on a mesh: one sharded second-order step
  against the JAX remat step on its mesh, and bit-equal to the port's step
  without remat;
- the fused plan on ``{data: 2}`` and on ``{data: 2, model: 2}`` (``safe``):
  the loss and every gradient against the JAX fused network on its mesh;
- ``make_train_step`` on a mesh against the JAX data-parallel step;
- the DARTS trial with an augment phase, and an ENAS child, on a mesh;
- the counted mesh search against the unsharded count;
- the LM's mesh step through ``LMTrainStep``, ring and Ulysses;
- a capture's mixed-op tally follows its stream into the replicas' threads.

The replicas' order of the backward pass is fixed
(``parallel/collectives.py::ReplicaRunner``), so two runs of a sharded step
are bit-equal, and so are a step with and without remat.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import threading
import time
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import katib_tpu.costmodel
import katib_tpu.nas.darts.search as jsearch
from katib_tpu.models import data as jdata
from katib_tpu.models import mnist as jmnist
from katib_tpu.nas.darts import architect as jarch
from katib_tpu.nas.darts.model import Alphas as JAlphas
from katib_tpu.nas.darts.model import DartsNetwork as JNet
from katib_tpu.parallel import mesh as jmesh
from katib_tpu.parallel import train as jtrain
from katib_tpu.parallel.train import cross_entropy_loss as j_cross_entropy
from katib_tpu_torch.convert import (
    alphas_from_jax,
    mnist_state_dict_from_flax,
    state_dict_from_flax,
)
from katib_tpu_torch.costmodel import counter
from katib_tpu_torch.models import data as tdata
from katib_tpu_torch.models import mnist as tmnist
from katib_tpu_torch.models.transformer import LMTrainStep, TransformerLM, make_attention_fn
from katib_tpu_torch.nas.darts import architect as tarch
from katib_tpu_torch.nas.darts.model import DartsNetwork, init_alphas, n_edges
from katib_tpu_torch.nas.darts.search import darts_trial, search_epochs
from katib_tpu_torch.nas.enas.trial import enas_trial
from katib_tpu_torch.ops import mixed_op
from katib_tpu_torch.parallel import collectives
from katib_tpu_torch.parallel import mesh as tmesh
from katib_tpu_torch.parallel.collectives import replica_index
from katib_tpu_torch.parallel.train import TrainState, cross_entropy_loss, make_train_step
from katib_tpu_torch.runner.context import TrialContext

# tier-1 runs six test processes on the same cores: one torch thread each
torch.set_num_threads(1)

LOOP_PRIMS = ("separable_convolution_3x3", "max_pooling_3x3", "skip_connection")
NET = dict(num_layers=3, init_channels=4, n_nodes=2)


def _cpu_mesh(axes: dict):
    n = int(np.prod(list(axes.values())))
    return tmesh.make_mesh(axes, devices=["cpu"] * n)


def _jax_mesh(axes: dict):
    n = int(np.prod(list(axes.values())))
    return jmesh.make_mesh(axes, devices=jax.devices()[:n])


def _loss_fn(nets):
    """The supernet loss, one network copy per replica."""

    def loss_fn(w, a, batch):
        return cross_entropy_loss(
            torch.func.functional_call(nets[replica_index()], w, (batch[0], a)), batch[1])

    return loss_fn


def _items(state):
    return [t for _, t in tarch.state_items(state)]


def _bit_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_items(a), _items(b)))


# -- the step loop on a mesh against the JAX window ----------------------------


def _dataset(package):
    # 16 train images -> 8 per half -> 2 steps of 4; 8 test images
    return package.synthetic_classification(16, 8, (8, 8, 3), 4, seed=7)


class _F32Net(JNet):
    """The JAX supernet in float32, its init jitted."""

    dtype: Any = jnp.float32

    def init(self, rngs, *args, **kwargs):
        return jax.jit(functools.partial(JNet.init, self, **kwargs))(rngs, *args)


@pytest.fixture(scope="module")
def jax_window_run():
    """One JAX epoch of 2 steps through the ``lax.scan`` window on a
    ``{data: 2}`` mesh, remat on (its defaults), its initial weights and
    the state after the window recorded."""
    rec: dict = {"windows": []}
    mp = pytest.MonkeyPatch()
    mp.setattr(jsearch, "DartsNetwork", _F32Net)
    real_init, real_jit = jsearch.init_search_state, jax.jit

    def init_state(weights, alphas, hyper):
        rec["weights"], rec["alphas"], rec["hyper"] = (*jax.device_get((weights, alphas)), hyper)
        return real_init(weights, alphas, hyper)

    def recording_jit(fn, *args, **kwargs):
        jitted = real_jit(fn, *args, **kwargs)

        def call(*a, **k):
            out = jitted(*a, **k)
            if isinstance(out, tuple) and isinstance(out[0], jarch.SearchState):
                rec["windows"].append(jax.device_get(out))
            return out

        return call

    mp.setattr(jsearch, "init_search_state", init_state)
    mp.setattr(jax, "jit", recording_jit)
    mp.setattr(katib_tpu.costmodel, "observe_program", lambda *a, **k: None)
    for name in ("KATIB_STEP_LOOP", "KATIB_STEP_LOOP_WINDOW", "KATIB_DEVICE_DATA",
                 "KATIB_NATIVE_LOADER", "KATIB_SEARCH_AUG"):
        mp.delenv(name, raising=False)
    try:
        rec["result"] = jsearch.run_darts_search(
            _dataset(jdata), primitives=LOOP_PRIMS, **NET, num_epochs=1, batch_size=4, seed=3,
            step_loop=True, step_loop_window=2, mesh=_jax_mesh({"data": 2}))
    finally:
        mp.undo()
    return rec


def _port_state(jax_run, net):
    hyper = tarch.DartsHyper(**jax_run["hyper"]._asdict())
    return hyper, tarch.init_search_state(
        state_dict_from_flax(jax_run["weights"], net), alphas_from_jax(jax_run["alphas"]), hyper)


def test_step_loop_on_a_mesh_matches_the_jax_window(jax_window_run):
    """The port's step loop on ``{data: 2}`` with remat (the defaults) from
    the JAX run's weights: the window's losses within 1e-4 relative (float32,
    the same global-batch steps, reassociated sums), every weight and alpha
    within 1e-3 of its move over the window plus 1e-6 (a sub-noise alpha
    gradient can take Adam's first step either way: those elements within
    two alpha_lr, 3e-4 each)."""
    net = DartsNetwork(primitives=LOOP_PRIMS, **NET, num_classes=4, remat=True,
                       dtype=torch.float32)
    hyper, start = _port_state(jax_window_run, net)
    state, history = search_epochs(
        net, tarch.clone_state(start), _dataset(tdata), hyper=hyper, num_epochs=1,
        batch_size=4, seed=3, device=torch.device("cpu"), step_loop=True, window=2,
        mesh=_cpu_mesh({"data": 2}))
    (want_state, want_losses), = jax_window_run["windows"]
    (row,) = history
    assert row["train_loss"] == pytest.approx(float(np.mean(want_losses)), rel=1e-4)
    assert row["train_loss"] == pytest.approx(
        jax_window_run["result"]["history"][0]["train_loss"], rel=1e-4)
    got_w = state.weights
    want_w = state_dict_from_flax(want_state.weights, net)
    for k, v in got_w.items():
        move = (want_w[k] - start.weights[k]).abs()
        assert torch.all((v - want_w[k]).abs() <= 1e-3 * move + 1e-6), k
    for got, want, first in zip(state.alphas, alphas_from_jax(want_state.alphas), start.alphas):
        move = (want - first).abs()
        assert torch.all((got - want).abs() <= torch.maximum(1e-3 * move + 1e-6,
                                                            torch.full_like(move, 6e-4)))


# -- remat on a mesh -----------------------------------------------------------

STEP_PRIMS = ("none", "max_pooling_3x3", "skip_connection", "separable_convolution_3x3",
              "dilated_convolution_3x3")
STEP_CFG = dict(primitives=STEP_PRIMS, init_channels=4, num_layers=3, n_nodes=1, num_classes=4)


@pytest.fixture(scope="module")
def step_setup():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, size=4).astype(np.int32)
    k = n_edges(STEP_CFG["n_nodes"])
    alphas = JAlphas(*(rng.normal(0, 1e-3, size=(k, len(STEP_PRIMS))).astype(np.float32)
                       for _ in range(2)))
    jm = _jax_mesh({"data": 2})
    jnet = JNet(**STEP_CFG, remat=True, remat_policy="dots", dtype=jnp.float32)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), alphas)
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(0.0, 0.5, size=s.shape).astype(np.float32), shapes)

    def loss_fn(w, a, batch):
        return j_cross_entropy(jnet.apply(w, batch[0], a), batch[1])

    hyper = jarch.DartsHyper(total_steps=10, debug_alpha_grad=True)
    step = jarch.make_search_step(loss_fn, hyper, jm)
    state = jmesh.replicate(jarch.init_search_state(
        jax.tree_util.tree_map(jnp.asarray, params), JAlphas(*map(jnp.asarray, alphas)),
        hyper), jm)
    batch = jmesh.shard_batch((x, y), jm)
    state, metrics = step(state, batch, batch)
    return dict(x=x, y=y, alphas=alphas, params=params,
                jax=(jax.device_get(metrics), jax.device_get(state.alphas)))


def _port_steps(setup, remat, policy, steps=2, axes=None):
    mesh = _cpu_mesh(axes or {"data": 2})
    net = DartsNetwork(**STEP_CFG, remat=remat, remat_policy=policy, dtype=torch.float32)
    nets = [net] + [copy.deepcopy(net) for _ in range(mesh.size - 1)]
    hyper = tarch.DartsHyper(total_steps=10, debug_alpha_grad=True)
    step = tarch.make_search_step(_loss_fn(nets), hyper, mesh)
    state = tarch.init_search_state(state_dict_from_flax(setup["params"], net),
                                    alphas_from_jax(setup["alphas"]), hyper)
    batch = tmesh.shard_batch((torch.from_numpy(setup["x"]), torch.from_numpy(setup["y"])), mesh)
    out = []
    for _ in range(steps):
        state, metrics = step(state, batch, batch)
        out.append(metrics)
    return state, out


@pytest.mark.parametrize("policy", [None, "dots"])
def test_remat_on_a_mesh_matches_jax_and_the_step_without_remat(step_setup, policy):
    """Remat's recompute on a mesh reuses the global batch-norm statistics
    the forward exchanged: two sharded steps bit-equal to the same steps
    without remat, and the first against the JAX remat step on its mesh
    (JAX's ``dots`` policy; the same tolerances as the sharded-step gate:
    losses 1e-4, the raw alpha gradient rtol 1e-3, atol 1e-6)."""
    plain_state, plain = _port_steps(step_setup, False, None)
    state, got = _port_steps(step_setup, True, policy)
    assert _bit_equal(state, plain_state)
    for g, p in zip(got, plain):
        assert all(torch.equal(g[k], p[k]) for k in ("train_loss", "val_loss", "grad_norm"))
    want, _ = step_setup["jax"]
    for name in ("train_loss", "val_loss", "grad_norm", "w_lr"):
        np.testing.assert_allclose(float(got[0][name]), float(want[name]), rtol=1e-4,
                                   err_msg=name)
    for g, w in zip(got[0]["alpha_grad"], want["alpha_grad"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-6)


def test_two_runs_of_a_sharded_step_are_bit_equal(step_setup):
    """Four replicas (``{data: 2, model: 2}``): the engine sums each shared
    weight's four gradients in one order, run after run."""
    axes = {"data": 2, "model": 2}
    first, _ = _port_steps(step_setup, True, None, steps=1, axes=axes)
    again, _ = _port_steps(step_setup, True, None, steps=1, axes=axes)
    assert _bit_equal(first, again)


def test_the_order_of_the_backward_holds_whatever_the_threads_timing(monkeypatch):
    """Four replicas (``{data: 4}``), two runs of a sharded step, each
    replica's autograd counter pushed ahead by a random number of nodes
    before the run and every rendezvous entered after a random wait: the
    runs are still bit-equal (``ReplicaRunner``'s class doc)."""
    rng = np.random.default_rng(5)
    real_exchange = collectives.ReplicaRunner.exchange

    def late(self, index, value, op):
        time.sleep(float(rng.random()) * 2e-4)
        return real_exchange(self, index, value, op)

    monkeypatch.setattr(collectives.ReplicaRunner, "exchange", late)

    def push_counters(mesh):
        def make_nodes(_):
            leaf = torch.zeros((), requires_grad=True)
            with torch.enable_grad():
                for _ in range(int(rng.integers(0, 400))):
                    leaf.view(())

        mesh.run(make_nodes)

    runs = []
    for _ in range(2):
        mesh = _cpu_mesh({"data": 4})
        net = DartsNetwork(**NET, num_classes=4, dtype=torch.float32)
        gen = torch.Generator().manual_seed(0)
        net.reset_parameters(gen)
        alphas = init_alphas(NET["n_nodes"], len(net.primitives), gen)
        nets = [net] + [copy.deepcopy(net) for _ in range(mesh.size - 1)]
        hyper = tarch.DartsHyper(total_steps=10)
        step = tarch.make_search_step(_loss_fn(nets), hyper, mesh)
        state = tarch.init_search_state(dict(net.named_parameters()), alphas, hyper)
        g = torch.Generator().manual_seed(1)
        batch = tmesh.shard_batch((torch.randn(8, 8, 8, 3, generator=g),
                                   torch.randint(0, 4, (8,), generator=g)), mesh)
        push_counters(mesh)
        state, _ = step(state, batch, batch)
        runs.append(state)
    assert _bit_equal(*runs)


# -- the fused plan on a mesh --------------------------------------------------

FUSED_PRIMS = ("none", "skip_connection", "separable_convolution_3x3",
               "separable_convolution_5x5", "dilated_convolution_3x3",
               "dilated_convolution_5x5")
FUSED_CFG = dict(primitives=FUSED_PRIMS, init_channels=4, num_layers=3, n_nodes=1,
                 num_classes=4)


@pytest.mark.parametrize("axes", [{"data": 2}, {"data": 2, "model": 2}],
                         ids=["data2", "data2-model2"])
def test_fused_plan_on_a_mesh_matches_jax(axes):
    """The fused supernet's loss and its gradients to every weight and to
    the alphas over a mesh (its batch norms over the global batch), against
    the JAX fused network under its mesh's shardings (``safe_conv`` on the
    model axis: ``tests/test_fused_ops.py:193``): the loss within 1e-5
    relative, each gradient within 1e-4 of its largest element (float32,
    reassociated sums)."""
    rng = np.random.default_rng(13)
    k = n_edges(FUSED_CFG["n_nodes"])
    alphas = JAlphas(*(rng.normal(0, 1e-1, size=(k, len(FUSED_PRIMS))).astype(np.float32)
                       for _ in range(2)))
    x = rng.normal(size=(4, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, size=4).astype(np.int32)
    jm = _jax_mesh(axes)
    jnet = JNet(**FUSED_CFG, remat=True, fused_convs=True, dtype=jnp.float32,
                safe_conv=jmesh.needs_safe_conv(jm))
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), alphas)
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(0.0, 0.5, size=s.shape).astype(np.float32), shapes)

    from jax.sharding import NamedSharding, PartitionSpec

    rep, data = jmesh.replicated(jm), NamedSharding(jm, PartitionSpec("data"))

    def jloss(w, a, xx, yy):
        return j_cross_entropy(jnet.apply(w, xx, a), yy)

    want, (gw, ga) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)),
                             in_shardings=(rep, rep, data, data))(params, alphas, x, y)
    mesh = _cpu_mesh(axes)
    net = DartsNetwork(**FUSED_CFG, remat=True, fused_convs=True, dtype=torch.float32)
    nets = [net] + [copy.deepcopy(net) for _ in range(mesh.size - 1)]
    loss_of = tarch.mesh_loss(_loss_fn(nets), mesh)
    weights = state_dict_from_flax(params, net)
    loss, got_w, got_a = tarch._grads(loss_of, weights, alphas_from_jax(alphas),
                                      (torch.from_numpy(x), torch.from_numpy(y)), True, True)
    assert float(loss) == pytest.approx(float(want), rel=1e-5)
    want_w = state_dict_from_flax(jax.device_get(gw), net)
    for name, g in got_w.items():
        scale = float(want_w[name].abs().max()) + 1e-12
        assert float((g - want_w[name]).abs().max()) <= 1e-4 * scale, name
    for g, w in zip(got_a, alphas_from_jax(jax.device_get(ga))):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()) + 1e-12


# -- the classifier step on a mesh ---------------------------------------------


def test_train_step_on_a_mesh_matches_jax():
    """``make_train_step(loss_fn, tx, mesh)`` on ``{data: 2}`` against the
    JAX data-parallel step on its mesh: 3 momentum steps of an MLP from the
    same weights, losses within 1e-5 relative and parameters within 1e-6
    (float32)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(8, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=8).astype(np.int32)
    jnet = jmnist.MLP(units=16, num_layers=2, dtype=jnp.float32)
    params = jax.device_get(jnet.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    jm = _jax_mesh({"data": 2})
    jtx = jmnist._family_optimizer("momentum")

    def jloss(p, batch):
        return j_cross_entropy(jnet.apply(p, batch[0]), batch[1])

    jstep = jtrain.make_train_step(jloss, jtx, jm, donate=False)
    jstate = jtrain.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), jtx)
    jstate = jmesh.replicate(jstate._replace(
        opt_state=jmnist._set_hyperparams(jstate.opt_state, 0.1, 0.9)), jm)
    mesh = _cpu_mesh({"data": 2})
    net = tmnist.MLP(units=16, num_layers=2, in_features=64, dtype=torch.float32)
    net.load_state_dict(mnist_state_dict_from_flax(params, net))
    step, _, state = tmnist.classifier_steps(net, "momentum", 0.1, 0.9, mesh=mesh)
    for _ in range(3):
        jstate, jm_metrics = jstep(jstate, jmesh.shard_batch((x, y), jm))
        state, metrics = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
        assert float(metrics["loss"]) == pytest.approx(float(jm_metrics["loss"]), rel=1e-5)
    want = mnist_state_dict_from_flax(jax.device_get(jstate.params), net)
    for k, v in state.params.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6)
    assert int(state.step) == 3


# -- trials on a mesh ----------------------------------------------------------

TRIAL = {"batch_size": 4, "init_channels": 4, "num_nodes": 2, "num_epochs": 2,
         "n_train": 16, "n_test": 8, "unrolled": "false", "augment_epochs": "1"}


def test_darts_trial_with_an_augment_phase_on_a_mesh(tmp_path):
    """``darts_trial`` on ``ctx.mesh`` ``{data: 2}`` with its defaults (the
    step loop, remat) and one augment epoch, which trains the genotype
    data-parallel on the same mesh (``train_classifier``): every report,
    ``augment_accuracy`` at step ``num_epochs + augment_epochs``."""
    params = {"algorithm-settings": json.dumps(TRIAL),
              "search-space": json.dumps(list(LOOP_PRIMS)), "num-layers": "3"}
    ctx = TrialContext(params, checkpoint_dir=str(tmp_path / "t"), device="cpu",
                       mesh=_cpu_mesh({"data": 2}))
    darts_trial(ctx)
    assert [step for step, _ in ctx.reports] == [0, 1, 3]
    assert all(np.isfinite(m["loss"]) for _, m in ctx.reports[:2])
    (_, last) = ctx.reports[-1]
    assert set(last) == {"augment_accuracy"} and 0.0 <= last["augment_accuracy"] <= 1.0


def test_an_enas_child_trains_on_a_mesh(tmp_path):
    """An ENAS child trial on ``ctx.mesh`` ``{data: 2}``: the data-parallel
    trainer, from the same seeded weights and batches as the unsharded
    child; bf16, its gradient summed in another order, so the losses agree
    to 2e-2 relative."""
    def ctx(name, mesh=None):
        return TrialContext({"architecture": json.dumps([[3], [4, 1], [0, 1, 1]]),
                             "nn_config": json.dumps({"num_layers": 3}),
                             "n_train": "64", "n_test": "16", "channels": "4",
                             "num_epochs": "2", "batch_size": "32"},
                            checkpoint_dir=str(tmp_path / name), device="cpu", mesh=mesh)

    sharded = ctx("sharded", _cpu_mesh({"data": 2}))
    enas_trial(sharded)
    plain = ctx("plain")
    enas_trial(plain)
    assert [s for s, _ in sharded.reports] == [s for s, _ in plain.reports] == [0, 1]
    for (_, got), (_, want) in zip(sharded.reports, plain.reports):
        assert got["loss"] == pytest.approx(want["loss"], rel=2e-2)
        assert 0.0 <= got["accuracy"] <= 1.0


# -- the counted mesh search ---------------------------------------------------


def test_the_counted_mesh_search_matches_the_unsharded_count(step_setup):
    """One sharded bilevel step counted under the count's dispatch mode,
    which the replicas' threads enter: the mixed-op kernels' declared work
    equal to the unsharded count's to the flop (each replica declares its
    half-batch launches), and the counted flops those of the unsharded
    count plus the replicas' sums: of each shared weight's and alpha's
    gradients (an all-reduce's adds, in each of the three passes that take
    them), of the batch norms' ``[C]`` statistics and of the losses, 0.2 %
    at most here (the mesh's batch norm counts as the fused one does)."""
    counts = {}
    for axes in (None, {"data": 2}):
        mesh = _cpu_mesh(axes) if axes else None
        net = DartsNetwork(**STEP_CFG, remat=False, dtype=torch.float32)
        nets = [net] + [copy.deepcopy(net) for _ in range(1, mesh.size if mesh else 1)]
        hyper = tarch.DartsHyper(total_steps=10)
        step = tarch.make_search_step(_loss_fn(nets), hyper, mesh)
        state = tarch.init_search_state(state_dict_from_flax(step_setup["params"], net),
                                        alphas_from_jax(step_setup["alphas"]), hyper)
        batch = (torch.from_numpy(step_setup["x"]), torch.from_numpy(step_setup["y"]))
        counts[bool(axes)] = counter.count_step(
            lambda args: step(*args), lambda: (tarch.clone_state(state), batch, batch),
            torch.device("cpu"))
    plain, sharded = counts[False], counts[True]
    assert sharded.kernel_flops == plain.kernel_flops > 0
    assert sharded.launches["mixed_op"] == 2 * plain.launches["mixed_op"]
    weights = sum(v.numel() for v in state.weights.values())
    alphas = sum(a.numel() for a in state.alphas)
    assert 3 * (weights + alphas) <= sharded.flops - plain.flops <= 2e-3 * plain.flops


# -- the LM on a mesh ----------------------------------------------------------


def _lm(attn_fn=None):
    model = TransformerLM(vocab_size=32, d_model=32, n_heads=4, n_layers=2, max_seq_len=16,
                          dtype=torch.float32, attn_fn=attn_fn)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_lm_mesh_step_through_lmtrainstep(strategy):
    """``LMTrainStep`` with a ``{seq: 2}`` mesh (the step the card captures;
    eager on the CPU): 3 steps against the unsharded step from the same
    weights, losses within 1e-5 relative and parameters within 1e-5
    (float32; the ring merges two partial softmaxes), and a second run
    bit-equal to the first."""
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 32, size=(3, 4, 16)))
    mesh = _cpu_mesh({"seq": 2})
    runs = []
    for use_mesh in (True, True, False):
        model = _lm(make_attention_fn(mesh, strategy) if use_mesh else None)
        step = LMTrainStep(model, lr=1e-2, steps=6, mesh=mesh if use_mesh else None)
        assert not step.capture
        losses = [float(step(t)) for t in tokens]
        runs.append((losses, [p.detach().clone() for p in model.parameters()]))
    (got, got_p), (again, again_p), (want, want_p) = runs
    assert got == again and all(torch.equal(a, b) for a, b in zip(got_p, again_p))
    assert got == pytest.approx(want, rel=1e-5)
    for a, b in zip(got_p, want_p):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# -- launch accounting on a mesh -----------------------------------------------


def test_replica_launches_are_tallied_by_the_capturing_stream(monkeypatch):
    """A capture on a mesh's stream: the mixed-op launches its replicas'
    threads make onto that stream go to the capture's tally and are not
    counted as run; a launch onto another stream meanwhile is counted."""

    class Stream:
        def __init__(self, handle):
            self.cuda_stream = handle

    current = threading.local()

    @contextlib.contextmanager
    def on(stream):
        prev, current.stream = getattr(current, "stream", None), stream
        try:
            yield
        finally:
            current.stream = prev

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: getattr(current, "stream", None) or Stream(0))
    side = Stream(7)
    mesh = _cpu_mesh({"data": 2})

    def replica(r):
        with on(side):  # a replica's current stream: the mesh's leased one
            mixed_op.count_launches(5, "cuda")
        return r

    before = mixed_op.launches
    with mixed_op.recording_launches(side) as tally:
        assert mesh.run(replica) == [0, 1]
        mixed_op.count_launches(1, "cuda")  # the caller's own stream
    assert tally == [10]
    assert mixed_op.launches - before == 1
