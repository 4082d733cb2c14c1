"""``remat_policy="dots"``: selective checkpointing of the supernet's cells,
held against the JAX package's ``dots_with_no_batch_dims_saveable``.

The gradients equal the run without remat; a spy on the port's policy
records what it saves, and that set is the one JAX's policy saves in the
same network (read from ``saved_residuals`` of the JAX supernet).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals
from torch.utils.checkpoint import CheckpointPolicy

from katib_tpu.nas.darts.model import DartsNetwork as JNet
from katib_tpu.nas.darts.model import init_alphas as j_init_alphas
from katib_tpu_torch.convert import alphas_from_jax, state_dict_from_flax
from katib_tpu_torch.nas.darts import model as tmodel
from katib_tpu_torch.nas.darts.model import DartsNetwork
from katib_tpu_torch.parallel.train import cross_entropy_loss

torch.set_num_threads(1)

PRIMS = ("separable_convolution_3x3", "max_pooling_3x3", "skip_connection",
         "dilated_convolution_3x3")
CFG = dict(primitives=PRIMS, init_channels=4, num_layers=3, n_nodes=2, num_classes=4)
BATCH, SIDE = 2, 8


@pytest.fixture(scope="module")
def jax_side():
    jnet = JNet(**CFG, remat=True, remat_policy="dots", dtype=jnp.float32)
    alphas = j_init_alphas(CFG["n_nodes"], len(PRIMS), jax.random.PRNGKey(1), scale=0.3)
    x = np.random.default_rng(0).normal(size=(BATCH, SIDE, SIDE, 3)).astype(np.float32)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(x), alphas)
    residuals = saved_residuals(lambda w: jnet.apply(w, jnp.asarray(x), alphas).sum(), params)
    saved = sorted(
        tuple(aval.shape) for aval, src in residuals
        if src.endswith("(PointwiseConv.__call__)") or src.endswith("(FactorizedReduce.__call__)")
    )
    return dict(params=jax.device_get(params), alphas=jax.device_get(alphas), x=x, saved=saved)


def _grads(jax_side, remat, policy):
    net = DartsNetwork(**CFG, remat=remat, remat_policy=policy, dtype=torch.float32)
    w = {k: v.requires_grad_() for k, v in state_dict_from_flax(jax_side["params"], net).items()}
    a = tmodel.Alphas(*(t.requires_grad_() for t in alphas_from_jax(jax_side["alphas"])))
    x = torch.from_numpy(jax_side["x"])
    y = torch.tensor([1, 3])
    loss = cross_entropy_loss(torch.func.functional_call(net, w, (x, a)), y)
    return loss, torch.autograd.grad(loss, [*w.values(), *a])


@pytest.mark.parametrize("policy", [None, "dots"])
def test_remat_gradients_equal_the_run_without_remat(jax_side, policy):
    want_loss, want = _grads(jax_side, False, None)
    got_loss, got = _grads(jax_side, True, policy)
    assert torch.equal(got_loss, want_loss)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)


def test_dots_saves_what_the_jax_policy_saves(jax_side, monkeypatch):
    decisions = []
    real = tmodel.dots_policy

    def spy(ctx, op, *args, **kwargs):
        choice = real(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            decisions.append((op, choice, args))
        return choice

    monkeypatch.setitem(tmodel.REMAT_POLICIES, "dots", spy)
    _grads(jax_side, True, "dots")
    saved = [(op, args) for op, choice, args in decisions if choice == CheckpointPolicy.MUST_SAVE]
    assert saved and all(op is torch.ops.aten.convolution.default for op, _ in saved)
    # a 1x1 convolution's output: (N, F, H, W) of its (already subsampled) input
    shapes = sorted((x.shape[0], x.shape[2], x.shape[3], w.shape[0])  # as NHWC
                    for _, (x, w, *_rest) in saved)
    assert all(tuple(w.shape[2:]) == (1, 1) for _, (x, w, *_rest) in saved)
    assert shapes == jax_side["saved"]
    # every other convolution of the cells (the edges' depthwise and
    # pointwise ones) is recomputed
    recomputed = [op for op, choice, _ in decisions if op is torch.ops.aten.convolution.default
                  and choice != CheckpointPolicy.MUST_SAVE]
    assert len(recomputed) > len(saved)


def test_unknown_policy_raises_even_without_remat():
    with pytest.raises(ValueError, match="remat_policy"):
        DartsNetwork(**CFG, remat=False, remat_policy="everything")
