"""The port's fused mixed-op plan (``katib_tpu_torch/nas/darts/fused.py``)
against the JAX package's, and against the port's own unfused primitives.

Every comparison is float32 on the CPU with inputs made by numpy from a
seed.  JAX parameters carry across with ``katib_tpu_torch.convert``; the
unfused primitives' parameters are embedded into the fused form (the
shapes are the same by design), as ``tests/test_fused_ops.py`` does in the
JAX package.  Tolerances: rtol and atol 2e-5 for one module (the JAX
test's), 5e-5 for a supernet's output (the JAX supernet test's), and the
step metrics of ``tests/test_torch_architect.py``.
"""

from __future__ import annotations

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katib_tpu.nas.darts import architect as jarch
from katib_tpu.nas.darts.fused import FusedSepDil as JFused
from katib_tpu.nas.darts.fused import _taps as j_taps
from katib_tpu.nas.darts.model import Alphas as JAlphas
from katib_tpu.nas.darts.model import DartsNetwork as JNet
from katib_tpu.nas.darts.ops import MixedOp as JMixedOp
from katib_tpu.parallel.train import cross_entropy_loss as j_cross_entropy
from katib_tpu_torch.convert import _from_flax, alphas_from_jax, flax_paths, state_dict_from_flax
from katib_tpu_torch.models.data import synthetic_classification
from katib_tpu_torch.nas.darts import architect as tarch
from katib_tpu_torch.nas.darts import ops as tops
from katib_tpu_torch.nas.darts.fused import (
    BRANCH_SPECS,
    FUSED_PRIMITIVES,
    FusedSepDil,
    _window_kernel,
)
from katib_tpu_torch.nas.darts.model import (
    Alphas,
    DartsNetwork,
    mixed_op_launches_per_forward,
    n_edges,
)
from katib_tpu_torch.nas.darts.ops import DEFAULT_PRIMITIVES, MixedOp, build_op
from katib_tpu_torch.nas.darts.search import run_darts_search
from katib_tpu_torch.parallel.train import cross_entropy_loss

# tier-1 runs six test processes on the same cores: one torch thread each
torch.set_num_threads(1)

C = 8
TOL = dict(rtol=2e-5, atol=2e-5)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _load_from_flax(module: torch.nn.Module, params: dict) -> None:
    module.load_state_dict(_from_flax(params, flax_paths(module, False), module))


def _embed(unfused: dict, prefix_out: str = "fused.") -> dict:
    """The fused parameters of one mixed op from its unfused primitives'
    (``{primitive: module}``), as port state-dict entries."""
    sd = {}
    for name, _, dilation, second in BRANCH_SPECS:
        mod = unfused[name]
        if second:  # SepConv: two reps
            sd[f"{prefix_out}stage_a.dw_{name}_0"] = mod.depthwise[0].kernel
            sd[f"{prefix_out}stage_b.dw_{name}_1"] = mod.depthwise[1].kernel
        else:
            sd[f"{prefix_out}stage_a.dw_{name}_0"] = mod.depthwise.kernel
    pw = [unfused[n].pointwise[0].kernel if s else unfused[n].pointwise.kernel
          for n, _, _, s in BRANCH_SPECS]
    sd[f"{prefix_out}pw_0"] = torch.stack(pw)
    sd[f"{prefix_out}pw_1"] = torch.stack([unfused[n].pointwise[1].kernel
                                           for n, _, _, s in BRANCH_SPECS if s])
    return {k: v.detach().clone() for k, v in sd.items()}


@pytest.mark.parametrize("kernel,dilation,window", [(3, 1, 9), (5, 1, 9), (3, 2, 9), (5, 2, 9),
                                                    (3, 1, 5), (5, 1, 5)])
def test_masked_kernel_puts_each_tap_where_jax_does(kernel, dilation, window):
    rng = np.random.default_rng(kernel * 10 + dilation)
    kern = rng.normal(size=(kernel, kernel, 1, 3)).astype(np.float32)
    want = np.zeros((3, 1, window, window), np.float32)
    taps = j_taps(kernel, dilation, window)
    for i, ti in enumerate(taps):
        for j, tj in enumerate(taps):
            want[:, 0, ti, tj] = kern[i, j, 0]
    got = _window_kernel(torch.from_numpy(kern), dilation, window, torch.float32)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("stride", [1, 2])
def test_fused_matches_jax(stride):
    """The port's FusedSepDil on the JAX module's parameters, forward and
    the gradient of a fixed random projection of the four outputs (a sum of
    squares of batch-normalized outputs is constant) to every parameter and
    the input."""
    rng = np.random.default_rng(42)
    x = rng.normal(size=(2, 8, 8, C)).astype(np.float32)
    jmod = JFused(C, stride, dtype=jnp.float32)
    params = jmod.init(jax.random.PRNGKey(0), x)
    out_hw = -(-8 // stride)
    proj = {n: rng.normal(size=(2, out_hw, out_hw, C)).astype(np.float32)
            for n in FUSED_PRIMITIVES}

    def jloss(p, xb):
        return sum(jnp.sum(o * proj[n]) for n, o in jmod.apply(p, xb).items())

    want = jmod.apply(params, x)
    jgrad_p, jgrad_x = jax.grad(jloss, argnums=(0, 1))(params, x)
    mod = FusedSepDil(C, stride, dtype=torch.float32)
    _load_from_flax(mod, params["params"])
    xt = _nchw(x).clone().requires_grad_()
    got = mod(xt)
    assert list(got) == list(FUSED_PRIMITIVES)
    for name in FUSED_PRIMITIVES:
        np.testing.assert_allclose(_nhwc(got[name]), np.asarray(want[name]), **TOL,
                                   err_msg=f"{name} stride={stride}")
    sum(torch.sum(o * _nchw(proj[n])) for n, o in got.items()).backward()
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(jgrad_x), rtol=1e-4, atol=1e-4)
    want_g = _from_flax(jax.device_get(jgrad_p)["params"], flax_paths(mod, False), mod)
    for key, p in mod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[key].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("stride", [1, 2])
def test_fused_matches_the_ports_unmerged_primitives(stride):
    """Embedding the unfused SepConv/DilConv kernels into the masked form
    reproduces every branch, at both strides (pads (4, 4) at stride 1,
    (3, 4) at stride 2 on an even size)."""
    gen = torch.Generator().manual_seed(stride)
    unfused = {n: build_op(n, C, stride, dtype=torch.float32) for n in FUSED_PRIMITIVES}
    for mod in unfused.values():
        for m in mod.modules():
            if m is not mod and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
    fused = FusedSepDil(C, stride, dtype=torch.float32)
    fused.load_state_dict(_embed(unfused, prefix_out=""))
    x = _nchw(np.random.default_rng(7).normal(size=(2, 8, 8, C)).astype(np.float32))
    got = fused(x)
    for name in FUSED_PRIMITIVES:
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   unfused[name](x).detach().numpy(), **TOL, err_msg=name)


@pytest.mark.parametrize("stride", [1, 2])
def test_mixed_op_fused_matches_jax_and_the_unfused_op(stride):
    """MixedOp(fused=True) against the JAX one on its parameters, and the
    port's unfused MixedOp against it on embedded parameters: the whole
    contraction over the 8 primitives."""
    x = np.random.default_rng(3).normal(size=(2, 8, 8, C)).astype(np.float32)
    w = np.array(jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(4), (8,))))
    jmod = JMixedOp(DEFAULT_PRIMITIVES, C, stride, dtype=jnp.float32, fused=True)
    params = jmod.init(jax.random.PRNGKey(0), x, w)
    want = np.asarray(jmod.apply(params, x, w))
    fused = MixedOp(DEFAULT_PRIMITIVES, C, stride, dtype=torch.float32, fused=True)
    assert isinstance(fused.fused, FusedSepDil)
    assert [type(op).__name__ for op in fused.ops] == (
        ["Zero", "Pool", "Pool", "SkipConnect"])
    _load_from_flax(fused, params["params"])
    got = fused(_nchw(x), torch.from_numpy(w))
    np.testing.assert_allclose(_nhwc(got), want, **TOL)

    plain = MixedOp(DEFAULT_PRIMITIVES, C, stride, dtype=torch.float32)
    embedded = {f"ops.{i}.{k}": v for i, op in enumerate(fused.ops)
                for k, v in op.state_dict().items()}
    for i, op in enumerate(plain.ops[:4]):
        for k, v in op.state_dict().items():
            embedded[f"ops.{i}.{k}"] = v.clone()
    embedded.update(_embed(dict(zip(DEFAULT_PRIMITIVES[4:], plain.ops[4:]))))
    fused.load_state_dict(embedded)
    np.testing.assert_allclose(fused(_nchw(x), torch.from_numpy(w)).detach().numpy(),
                               plain(_nchw(x), torch.from_numpy(w)).detach().numpy(), **TOL)


def test_fused_needs_all_four_conv_primitives():
    """As in JAX: with a conv primitive missing, fused=True changes nothing."""
    prims = ("max_pooling_3x3", "separable_convolution_3x3", "dilated_convolution_3x3")
    op = MixedOp(prims, C, 1, dtype=torch.float32, fused=True)
    assert op.fused is None and len(op.ops) == 3


@pytest.mark.parametrize("stride", [1, 2])
def test_the_safe_form_is_the_same_plan(stride):
    """``safe=True`` (the JAX setting for a mesh with a model axis) raised
    until the fused plan ran on a mesh; the port's depthwise convolution has
    one form, so it is the same plan: the same parameters, the same
    outputs, bit for bit."""
    plain = FusedSepDil(C, stride, dtype=torch.float32)
    safe = FusedSepDil(C, stride, dtype=torch.float32, safe=True)
    safe.load_state_dict(plain.state_dict())
    x = torch.from_numpy(np.random.default_rng(stride).normal(size=(2, C, 8, 8)).astype(np.float32))
    want, got = plain(x), safe(x)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


# -- the fused supernet ------------------------------------------------------

CFG = dict(primitives=DEFAULT_PRIMITIVES, init_channels=4, num_layers=3, n_nodes=1,
           num_classes=4)


class _F32Net(JNet):
    """The JAX supernet in float32, its init jitted."""

    def init(self, rngs, *args, **kwargs):
        return jax.jit(functools.partial(JNet.init, self, **kwargs))(rngs, *args)


def _jax_params(jnet, alphas, rng, x_shape):
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros(x_shape), alphas)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(0.0, 0.5, size=s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("policy", [None, "dots"])
def test_fused_supernet_loss_and_grads_match_jax(policy):
    """A fused supernet with a reduction cell (stride 2) at both strides:
    the loss, and its gradients to every weight and to the alphas, against
    the JAX network's; ``remat_policy="dots"`` recomputes the fused
    pointwise as JAX does, with the same numbers."""
    rng = np.random.default_rng(11)
    k = n_edges(CFG["n_nodes"])
    alphas = JAlphas(*(rng.normal(0, 1e-1, size=(k, 8)).astype(np.float32) for _ in range(2)))
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, size=2).astype(np.int32)
    remat = policy is not None
    jnet = JNet(**CFG, remat=remat, remat_policy=policy, fused_convs=True, dtype=jnp.float32)
    params = _jax_params(jnet, alphas, rng, (1, 8, 8, 3))

    def jloss(w, a):
        return j_cross_entropy(jnet.apply(w, x, a), y)

    want, (gw, ga) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(params, alphas)
    net = DartsNetwork(**CFG, remat=remat, remat_policy=policy, fused_convs=True,
                       dtype=torch.float32)
    assert sum(isinstance(m, FusedSepDil) for m in net.modules()) == 3 * k
    weights = {n: p.requires_grad_() for n, p in state_dict_from_flax(params, net).items()}
    t_alphas = alphas_from_jax(alphas)
    for a in t_alphas:
        a.requires_grad_()
    loss = cross_entropy_loss(torch.func.functional_call(net, weights, (torch.from_numpy(x),
                                                                         t_alphas)),
                              torch.from_numpy(y))
    loss.backward()
    assert loss.item() == pytest.approx(float(want), rel=1e-5)
    want_w = state_dict_from_flax(jax.device_get(gw), net)
    for key, p in weights.items():
        np.testing.assert_allclose(p.grad.numpy(), want_w[key].numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=key)
    for got_a, want_a in zip(t_alphas, ga):
        np.testing.assert_allclose(got_a.grad.numpy(), np.asarray(want_a), rtol=1e-3, atol=1e-6)


def test_fused_supernet_launches_one_mixed_op_per_edge_group(monkeypatch):
    """The fused plan keeps the launch count: one ``mixed_op_sum`` per edge
    group, the stacked outputs of all 8 primitives of every edge in it."""
    calls = []
    real = tops.mixed_op_sum

    def counting(w, stacked):
        calls.append(tuple(stacked.shape[:2]))
        return real(w, stacked)

    monkeypatch.setattr(tops, "mixed_op_sum", counting)
    net = DartsNetwork(**CFG, remat=False, fused_convs=True, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(2, n_edges(CFG["n_nodes"]), 8, generator=gen) * 1e-3
    net(torch.randn(2, 8, 8, 3, generator=gen), Alphas(a[0], a[1]))
    assert len(calls) == mixed_op_launches_per_forward(CFG["num_layers"], CFG["n_nodes"])
    assert all(n_ops == 8 for _, n_ops in calls)


# -- one fused bilevel step against the JAX step --------------------------------

STEP_CFG = dict(primitives=DEFAULT_PRIMITIVES, init_channels=4, num_layers=2, n_nodes=1,
                num_classes=4)


def test_fused_search_step_matches_jax():
    """One second-order step of a fused supernet: the step metrics and the
    raw alpha gradient against the JAX step's, at
    ``tests/test_torch_architect.py``'s tolerances."""
    rng = np.random.default_rng(5)
    train, val = (
        (rng.normal(size=(4, 8, 8, 3)).astype(np.float32),
         rng.integers(0, 4, size=4).astype(np.int32))
        for _ in range(2)
    )
    k = n_edges(STEP_CFG["n_nodes"])
    alphas = JAlphas(*(rng.normal(0, 1e-3, size=(k, 8)).astype(np.float32) for _ in range(2)))
    jnet = JNet(**STEP_CFG, remat=False, fused_convs=True, dtype=jnp.float32)
    params = _jax_params(jnet, alphas, rng, (1, 8, 8, 3))

    def jloss_fn(w, a, batch):
        return j_cross_entropy(jnet.apply(w, batch[0], a), batch[1])

    jhyper = jarch.DartsHyper(total_steps=10, debug_alpha_grad=True)
    jstate = jarch.init_search_state(jax.tree_util.tree_map(jnp.asarray, params),
                                     JAlphas(*map(jnp.asarray, alphas)), jhyper)
    _, want = jarch.make_search_step(jloss_fn, jhyper)(
        jstate, tuple(map(jnp.asarray, train)), tuple(map(jnp.asarray, val)))

    net = DartsNetwork(**STEP_CFG, remat=False, fused_convs=True, dtype=torch.float32)

    def loss_fn(w, a, batch):
        return cross_entropy_loss(torch.func.functional_call(net, w, (batch[0], a)), batch[1])

    hyper = tarch.DartsHyper(total_steps=10, debug_alpha_grad=True)
    state = tarch.init_search_state(state_dict_from_flax(params, net), alphas_from_jax(alphas),
                                    hyper)
    _, got = tarch.make_search_step(loss_fn, hyper)(
        state, tuple(map(torch.from_numpy, train)), tuple(map(torch.from_numpy, val)))
    for name in ("train_loss", "val_loss", "grad_norm", "w_lr"):
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-4, err_msg=name)
    for ga, wa in zip(got["alpha_grad"], want["alpha_grad"]):
        np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-3, atol=1e-6)


# -- the trial: checkpoints of the fused plan -----------------------------------

def test_fused_snapshot_resumes_fused_and_refuses_the_unfused_plan(tmp_path):
    ds = synthetic_classification(16, 8, (8, 8, 3), 4, seed=1)
    kw = dict(primitives=DEFAULT_PRIMITIVES, num_layers=2, init_channels=2, n_nodes=1,
              batch_size=4, seed=0, remat=False, device="cpu", checkpoint_dir=str(tmp_path))
    first = run_darts_search(ds, num_epochs=1, fused=True, **kw)
    with open(tmp_path / "search_meta.json") as f:
        assert json.load(f)["fused"] is True
    resumed = run_darts_search(ds, num_epochs=2, fused=True, **kw)
    assert [h["epoch"] for h in resumed["history"]] == [0, 1]
    assert resumed["history"][0]["val_accuracy"] == first["history"][0]["val_accuracy"]
    with pytest.raises(ValueError, match="fused mixed-op plan"):
        run_darts_search(ds, num_epochs=3, fused=False, **kw)
