"""The port's sharded DARTS search against the JAX package's, in float32.

- One sharded bilevel step on a 4-entry CPU grid ``{data: 2, model: 2}``
  against JAX's sharded step on 4 CPU devices, from the same weights
  (numpy draws on the JAX tree, carried across with ``convert``): the
  losses, the raw second-order alpha gradient, sequential and paired, and
  the post-step alphas.  JAX takes the shift-MAC depthwise form there
  (``needs_safe_conv``), the port its one native form.
- The port's native depthwise convolution against JAX's shift-MAC form,
  forward and gradient.
- The search epoch loop on ``{data: 2}`` against the JAX loop on its mesh,
  and ``darts_trial`` on ``ctx.mesh`` against the JAX trial on its mesh and
  against the port's unsharded trial, all in float32.
- What the mesh path does not have raises, naming ROADMAP item 9b.
"""

from __future__ import annotations

import copy
import functools
import json
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import katib_tpu.costmodel
import katib_tpu.nas.darts.search as jsearch
from katib_tpu.models import data as jdata
from katib_tpu.nas.darts import architect as jarch
from katib_tpu.nas.darts.model import Alphas as JAlphas
from katib_tpu.nas.darts.model import DartsNetwork as JNet
from katib_tpu.ops.depthwise import DepthwiseConv as JDepthwise
from katib_tpu.parallel import mesh as jmesh
from katib_tpu.parallel.train import cross_entropy_loss as j_cross_entropy
from katib_tpu.runner.context import TrialContext as JaxTrialContext
from katib_tpu.store.base import MemoryObservationStore as JaxMemoryStore
from katib_tpu_torch.convert import alphas_from_jax, state_dict_from_flax
from katib_tpu_torch.models import data as tdata
from katib_tpu_torch.nas.darts import architect as tarch
from katib_tpu_torch.nas.darts import search as tsearch
from katib_tpu_torch.nas.darts.model import DartsNetwork, n_edges
from katib_tpu_torch.nas.darts.search import darts_trial, search_epochs
from katib_tpu_torch.ops.depthwise import DepthwiseConv
from katib_tpu_torch.parallel import mesh as tmesh
from katib_tpu_torch.parallel.collectives import replica_index
from katib_tpu_torch.parallel.train import cross_entropy_loss
from katib_tpu_torch.runner.context import TrialContext

# tier-1 runs six test processes on the same cores: one torch thread each
torch.set_num_threads(1)

# a small operation set with both depthwise primitives (the shift-MAC form
# unrolls every tap, which the JAX side compiles slowly at the full set)
PRIMS = ("none", "max_pooling_3x3", "skip_connection", "separable_convolution_3x3",
         "dilated_convolution_3x3")
CFG = dict(primitives=PRIMS, init_channels=4, num_layers=2, n_nodes=1, num_classes=4)
AXES = {"data": 2, "model": 2}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, size=4).astype(np.int32)
    k = n_edges(CFG["n_nodes"])
    alphas = JAlphas(*(rng.normal(0, 1e-3, size=(k, len(PRIMS))).astype(np.float32)
                       for _ in range(2)))
    jm = jmesh.make_mesh(AXES, devices=jax.devices()[:4])
    jnet = JNet(**CFG, remat=False, dtype=jnp.float32, safe_conv=jmesh.needs_safe_conv(jm))
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), alphas)
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(0.0, 0.5, size=s.shape).astype(np.float32), shapes)

    def loss_fn(w, a, batch):
        return j_cross_entropy(jnet.apply(w, batch[0], a), batch[1])

    out = {}
    for paired in (False, True):
        hyper = jarch.DartsHyper(total_steps=10, debug_alpha_grad=True, paired_hessian=paired)
        step = jarch.make_search_step(loss_fn, hyper, jm)
        state = jmesh.replicate(jarch.init_search_state(
            jax.tree_util.tree_map(jnp.asarray, params), JAlphas(*map(jnp.asarray, alphas)),
            hyper), jm)
        batch = jmesh.shard_batch((x, y), jm)
        state, metrics = step(state, batch, batch)
        out[paired] = (jax.device_get(metrics), jax.device_get(state.alphas))
    return dict(x=x, y=y, alphas=alphas, params=params, jax=out)


def _port_step(setup, paired: bool):
    mesh = tmesh.make_mesh(AXES, devices=["cpu"] * 4)
    net = DartsNetwork(**CFG, remat=False, dtype=torch.float32)
    # functional_call rebinds a module's parameters: one copy per replica
    nets = [net] + [copy.deepcopy(net) for _ in range(mesh.size - 1)]

    def loss_fn(w, a, batch):
        logits = torch.func.functional_call(nets[replica_index()], w, (batch[0], a))
        return cross_entropy_loss(logits, batch[1])

    hyper = tarch.DartsHyper(total_steps=10, debug_alpha_grad=True, paired_hessian=paired)
    step = tarch.make_search_step(loss_fn, hyper, mesh)
    state = tarch.init_search_state(state_dict_from_flax(setup["params"], net),
                                    alphas_from_jax(setup["alphas"]), hyper)
    batch = tmesh.shard_batch((torch.from_numpy(setup["x"]), torch.from_numpy(setup["y"])), mesh)
    return step(state, batch, batch)


@pytest.mark.parametrize("paired", [False, True])
def test_sharded_step_matches_jax_sharded_step(setup, paired):
    want, want_alphas = setup["jax"][paired]
    state, got = _port_step(setup, paired)
    assert int(state.step) == 1
    # losses: 1e-4 relative (float32 over a reassociated global mean)
    for name in ("train_loss", "val_loss", "grad_norm", "w_lr"):
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-4, err_msg=name)
    # the raw second-order alpha gradient: the JAX gate's rtol 1e-3, atol 1e-6
    for g, w in zip(got["alpha_grad"], want["alpha_grad"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-6)
    # post-Adam alphas: 1e-6 where the gradient is above noise; an element
    # whose gradient is within 1e-6 of zero may take Adam's first step the
    # other way, a full alpha_lr (3e-4) each side
    for a, w, gw in zip(state.alphas, want_alphas, want["alpha_grad"]):
        tol = np.where(np.abs(np.asarray(gw)) > 1e-6, 1e-6, 2 * 3e-4 + 1e-6)
        assert np.all(np.abs(a.numpy() - np.asarray(w)) <= tol)


@pytest.mark.parametrize("kernel, stride, dilation", [(3, 1, 1), (5, 2, 1), (3, 1, 2),
                                                      (5, 2, 2)])
def test_safe_depthwise_matches_jax(kernel, stride, dilation):
    rng = np.random.default_rng(kernel + stride + dilation)
    x = rng.normal(size=(2, 9, 10, 4)).astype(np.float32)
    ct = None
    jconv = JDepthwise(kernel=kernel, stride=stride, dilation=dilation, dtype=jnp.float32,
                       safe=True)
    params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kern = np.array(params["params"]["kernel"])

    def jloss(p, xx):
        out = jconv.apply(p, xx)
        return jnp.sum(out * jnp.asarray(ct)), out

    out_shape = jax.eval_shape(jconv.apply, params, jnp.asarray(x)).shape
    ct = rng.normal(size=out_shape).astype(np.float32)
    (_, jout), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    # the port's one (native) form on JAX's shift-MAC kernel: 1e-5, float32
    tconv = DepthwiseConv(4, kernel, stride=stride, dilation=dilation, dtype=torch.float32)
    assert tuple(tconv.kernel.shape) == kern.shape
    with torch.no_grad():
        tconv.kernel.copy_(torch.from_numpy(kern))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    out = tconv(xt)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jout), **tol)
    gx, gk = torch.autograd.grad(out, (xt, tconv.kernel),
                                 torch.from_numpy(ct).permute(0, 3, 1, 2))
    np.testing.assert_allclose(gx.permute(0, 2, 3, 1).numpy(), np.asarray(jgx), **tol)
    np.testing.assert_allclose(gk.numpy(), np.asarray(jgp["params"]["kernel"]), **tol)


# -- the search loop and the trial --------------------------------------------

LOOP_PRIMS = ("separable_convolution_3x3", "max_pooling_3x3", "skip_connection")
NET = dict(num_layers=3, init_channels=4, n_nodes=2)


def _dataset(package):
    # 16 train images -> 8 per half -> 2 steps of 4; 8 test images
    return package.synthetic_classification(16, 8, (8, 8, 3), 4, seed=7)


class _F32Net(JNet):
    """The JAX supernet in float32, its init jitted."""

    dtype: Any = jnp.float32

    def init(self, rngs, *args, **kwargs):
        return jax.jit(functools.partial(JNet.init, self, **kwargs))(rngs, *args)


@pytest.fixture(scope="module")
def jax_mesh_run():
    """One JAX search epoch on a {data: 2} mesh, eager steps, float32."""
    rec = {"steps": []}
    mp = pytest.MonkeyPatch()
    mp.setattr(jsearch, "DartsNetwork", _F32Net)

    def init_state(weights, alphas, hyper):
        rec["weights"], rec["alphas"] = jax.device_get((weights, alphas))
        return real_init(weights, alphas, hyper)

    def make_step(loss_fn, hyper, mesh=None, jit=True):
        rec["hyper"] = hyper
        step = real_make(loss_fn, hyper, mesh, jit)

        def recording(state, train, val):
            state, metrics = step(state, train, val)
            rec["steps"].append(jax.device_get(metrics))
            return state, metrics

        return recording

    real_init, real_make = jsearch.init_search_state, jsearch.make_search_step
    mp.setattr(jsearch, "init_search_state", init_state)
    mp.setattr(jsearch, "make_search_step", make_step)
    mp.setattr(katib_tpu.costmodel, "observe_program", lambda *a, **k: None)
    reports = []
    try:
        jsearch.run_darts_search(
            _dataset(jdata), primitives=LOOP_PRIMS, **NET, num_epochs=1, batch_size=4, seed=3,
            remat=False, step_loop=False,
            mesh=jmesh.make_mesh({"data": 2}, devices=jax.devices()[:2]),
            report=lambda **kw: reports.append(kw) or True,
        )
    finally:
        mp.undo()
    rec["reports"] = reports
    return rec


def test_epoch_loop_on_a_mesh_matches_jax(jax_mesh_run):
    mesh = tmesh.make_mesh({"data": 2}, devices=["cpu"] * 2)
    net = DartsNetwork(primitives=LOOP_PRIMS, **NET, num_classes=4, remat=False,
                       dtype=torch.float32)
    hyper = tarch.DartsHyper(**jax_mesh_run["hyper"]._asdict())
    state = tarch.init_search_state(state_dict_from_flax(jax_mesh_run["weights"], net),
                                    alphas_from_jax(jax_mesh_run["alphas"]), hyper)
    reports = []
    _, history = search_epochs(
        net, state, _dataset(tdata), hyper=hyper, num_epochs=1, batch_size=4, seed=3,
        device=mesh.home, report=lambda **kw: reports.append(kw) or True, mesh=mesh,
    )
    (row,) = history
    assert len(row["steps"]) == len(jax_mesh_run["steps"]) == 2
    # 1e-4 relative: float32, the same global-batch step on both sides
    for i, (got, want) in enumerate(zip(row["steps"], jax_mesh_run["steps"])):
        for name in ("train_loss", "val_loss", "grad_norm", "w_lr"):
            assert got[name] == pytest.approx(float(want[name]), rel=1e-4), (i, name)
    (want,) = jax_mesh_run["reports"]
    (got,) = reports
    assert got["epoch"] == want["epoch"] == 0
    assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-6)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)


SMALL = {"batch_size": 4, "init_channels": 4, "num_nodes": 2, "num_epochs": 2,
         "n_train": 16, "n_test": 8, "unrolled": "true"}
# both packages' trials in float32, eager, no remat: the same computation
TRIAL = {**SMALL, "remat": "false", "step_loop": "false"}


def _ctx(tmp_path, name, settings, mesh=None):
    params = {"algorithm-settings": json.dumps(settings),
              "search-space": json.dumps(list(LOOP_PRIMS)), "num-layers": "3"}
    return TrialContext(params, checkpoint_dir=str(tmp_path / name), device="cpu", mesh=mesh)


class _JaxCtx(JaxTrialContext):
    """The JAX trial context, its reports recorded as the port's are."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.reports = []

    def report(self, step=None, **metrics):
        self.reports.append((step, metrics))
        return super().report(step=step, **metrics)


@pytest.fixture(scope="module")
def jax_trial_run(tmp_path_factory):
    """The JAX ``darts_trial`` on a ``{data: 2}`` mesh in float32 (its
    supernet patched to float32 as in ``jax_mesh_run``), its initial
    weights and alphas recorded."""
    rec = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(jsearch, "DartsNetwork", _F32Net)
    real_init = jsearch.init_search_state

    def init_state(weights, alphas, hyper):
        rec["weights"], rec["alphas"] = jax.device_get((weights, alphas))
        return real_init(weights, alphas, hyper)

    mp.setattr(jsearch, "init_search_state", init_state)
    mp.setattr(katib_tpu.costmodel, "observe_program", lambda *a, **k: None)
    params = {"algorithm-settings": json.dumps(TRIAL),
              "search-space": json.dumps(list(LOOP_PRIMS)), "num-layers": "3"}
    ctx = _JaxCtx("jax-mesh", params, JaxMemoryStore(),
                  checkpoint_dir=str(tmp_path_factory.mktemp("jax-trial")),
                  mesh=jmesh.make_mesh({"data": 2}, devices=jax.devices()[:2]))
    try:
        jsearch.darts_trial(ctx)
    finally:
        mp.undo()
    rec["reports"] = ctx.reports
    return rec


@pytest.fixture
def port_from_jax(jax_trial_run, monkeypatch):
    """The port's trial in float32 from the JAX trial's initial weights and
    alphas (its own draws replaced when the search state is built)."""
    built = []

    class F32Net(DartsNetwork):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **{**kwargs, "dtype": torch.float32})
            built.append(self)

    def init_state(weights, alphas, hyper):
        home = next(iter(weights.values())).device
        converted = state_dict_from_flax(jax_trial_run["weights"], built[-1])
        return real_init({k: converted[k].to(home) for k in weights},
                         type(alphas)(*(a.to(home) for a in
                                        alphas_from_jax(jax_trial_run["alphas"]))), hyper)

    real_init = tsearch.init_search_state
    monkeypatch.setattr(tsearch, "DartsNetwork", F32Net)
    monkeypatch.setattr(tsearch, "init_search_state", init_state)


def _assert_reports_match(got_reports, want_reports):
    # float32, the same global-batch steps: loss within 1e-4 relative (a
    # reassociated global mean), accuracy the same count of correct images
    assert [s for s, _ in got_reports] == [s for s, _ in want_reports] == [0, 1]
    for (_, got), (_, want) in zip(got_reports, want_reports):
        assert got["loss"] == pytest.approx(float(want["loss"]), rel=1e-4)
        assert got["accuracy"] == pytest.approx(float(want["accuracy"]), abs=1e-6)


def test_darts_trial_on_a_mesh_matches_jax(tmp_path, jax_trial_run, port_from_jax):
    """``darts_trial`` on ``ctx.mesh`` {data: 2} against the JAX trial on
    its {data: 2} mesh: the same reports, epoch by epoch."""
    mesh = tmesh.make_mesh({"data": 2}, devices=["cpu"] * 2)
    sharded = _ctx(tmp_path, "sharded", TRIAL, mesh=mesh)
    darts_trial(sharded)
    _assert_reports_match(sharded.reports, jax_trial_run["reports"])


def test_darts_trial_on_a_mesh_matches_the_unsharded_trial(tmp_path, port_from_jax):
    """The same trial sharded over {data: 2} and on one device, from the
    same weights: the same reports and steps, the same genotype file's
    shape; the snapshot resumes as usual."""
    mesh = tmesh.make_mesh({"data": 2}, devices=["cpu"] * 2)
    sharded = _ctx(tmp_path, "sharded", TRIAL, mesh=mesh)
    darts_trial(sharded)
    plain = _ctx(tmp_path, "plain", TRIAL)
    darts_trial(plain)
    _assert_reports_match(sharded.reports, plain.reports)
    with open(tmp_path / "sharded" / "genotype.json") as f:
        assert len(json.load(f)["normal"]) == 2
    # rerun on the same dir: resumes past both epochs and reports nothing new
    again = _ctx(tmp_path, "sharded", TRIAL, mesh=mesh)
    darts_trial(again)
    assert again.reports == []


@pytest.mark.parametrize("setting, match", [({"step_loop": "true"}, "capture the sharded step"),
                                            ({"remat": "true"}, "remat on a mesh"),
                                            ({"fused": "true"}, "fused")])
def test_unported_mesh_settings_raise_naming_9b(tmp_path, setting, match):
    mesh = tmesh.make_mesh({"data": 2}, devices=["cpu"] * 2)
    with pytest.raises(NotImplementedError, match=match) as info:
        darts_trial(_ctx(tmp_path, "t", {**SMALL, **setting}, mesh=mesh))
    assert "9b" in str(info.value)


def test_an_explicit_step_loop_from_the_environment_raises_on_a_mesh(tmp_path, monkeypatch):
    monkeypatch.setenv("KATIB_STEP_LOOP", "1")
    mesh = tmesh.make_mesh({"data": 2}, devices=["cpu"] * 2)
    with pytest.raises(NotImplementedError, match="9b"):
        darts_trial(_ctx(tmp_path, "t", SMALL, mesh=mesh))
