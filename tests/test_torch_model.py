"""The port's DARTS supernet against the JAX package's, in float32.

Weights are drawn by numpy from a seed on the JAX parameter tree and carried
across with ``katib_tpu_torch.convert``.  The JAX side is evaluated once,
without remat (remat changes what JAX keeps in memory, not what it
computes); the port is held to it with remat off and on, the latter loading
the same weights from the ``CheckpointCell_<n>`` tree that a JAX
``remat=True`` network has.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katib_tpu.nas.darts.model import Alphas as JAlphas
from katib_tpu.nas.darts.model import DartsNetwork as JNet
from katib_tpu.nas.darts.model import extract_genotype as j_extract_genotype
from katib_tpu.parallel.train import cross_entropy_loss as j_cross_entropy
from katib_tpu_torch.convert import alphas_from_jax, state_dict_from_flax
from katib_tpu_torch.nas.darts import ops as tops
from katib_tpu_torch.nas.darts.model import (
    Alphas,
    DartsNetwork,
    extract_genotype,
    init_alphas,
    mixed_op_launches_per_forward,
    n_edges,
)
from katib_tpu_torch.parallel.train import cross_entropy_loss

# tier-1 runs six test processes on the same cores: one torch thread each
torch.set_num_threads(1)

CFG = dict(init_channels=4, num_layers=3, n_nodes=2, num_classes=4)


def _jax_net(remat: bool) -> JNet:
    return JNet(**CFG, remat=remat, dtype=jnp.float32)


@pytest.fixture(scope="module")
def reference():
    """Weights, alphas, a batch, and the JAX logits and gradients there."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, size=4).astype(np.int32)
    k = n_edges(CFG["n_nodes"])
    alphas = JAlphas(*(rng.normal(0.0, 0.5, size=(k, 8)).astype(np.float32) for _ in range(2)))
    net = _jax_net(remat=False)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.asarray(x[:1]), alphas)
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(0.0, 0.5, size=s.shape).astype(np.float32), shapes
    )

    @jax.jit
    def value_and_grads(p, a):
        def loss(p, a):
            logits = net.apply(p, jnp.asarray(x), a)
            return j_cross_entropy(logits, jnp.asarray(y)), logits

        return jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(p, a)

    (_, logits), (gw, ga) = value_and_grads(params, alphas)
    return dict(x=x, y=y, alphas=alphas, params=params, logits=np.asarray(logits),
                gw=jax.device_get(gw), ga=jax.device_get(ga))


def _as_remat_tree(tree):
    """The same leaves under the names a JAX ``remat=True`` network uses."""
    inner = {
        (f"Checkpoint{k}" if k.startswith("Cell_") else k): v for k, v in tree["params"].items()
    }
    return {"params": inner}


@pytest.mark.parametrize("remat", [False, True])
def test_network_logits_and_gradients_match_jax(reference, remat):
    net = DartsNetwork(**CFG, remat=remat, dtype=torch.float32)
    params, gw = reference["params"], reference["gw"]
    if remat:
        shapes = jax.eval_shape(
            _jax_net(True).init, jax.random.PRNGKey(0),
            jnp.asarray(reference["x"][:1]), reference["alphas"],
        )
        params, gw = _as_remat_tree(params), _as_remat_tree(gw)
        assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(params)
    weights = {k: v.requires_grad_() for k, v in state_dict_from_flax(params, net).items()}
    alphas = Alphas(*(a.requires_grad_() for a in alphas_from_jax(reference["alphas"])))
    logits = torch.func.functional_call(net, weights, (torch.from_numpy(reference["x"]), alphas))
    np.testing.assert_allclose(logits.detach().numpy(), reference["logits"], rtol=0, atol=1e-4)

    loss = cross_entropy_loss(logits, torch.from_numpy(reference["y"]))
    grads = torch.autograd.grad(loss, [*weights.values(), *alphas])
    want_w = state_dict_from_flax(gw, net)
    for key, got in zip(weights, grads):
        np.testing.assert_allclose(got.numpy(), want_w[key].numpy(), rtol=1e-3, atol=1e-6,
                                   err_msg=key)
    for got, want in zip(grads[len(weights):], reference["ga"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-6)


def test_convert_rejects_a_tree_of_another_network(reference):
    net = DartsNetwork(**{**CFG, "init_channels": 6}, remat=False, dtype=torch.float32)
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_flax(reference["params"], net)


@pytest.mark.parametrize("num_layers,n_nodes", [(3, 2), (8, 4), (2, 3)])
def test_mixed_op_launches_per_forward_counts_the_edge_groups(num_layers, n_nodes, monkeypatch):
    calls = []
    real = tops.mixed_op_sum

    def counting(w, x):
        calls.append(w.shape[0])
        return real(w, x)

    monkeypatch.setattr(tops, "mixed_op_sum", counting)
    net = DartsNetwork(init_channels=2, num_layers=num_layers, n_nodes=n_nodes, num_classes=3,
                       remat=False, dtype=torch.float32)
    alphas = init_alphas(n_nodes, 8, torch.Generator().manual_seed(0))
    with torch.no_grad():
        net(torch.zeros(2, 8, 8, 3), alphas)
    assert len(calls) == mixed_op_launches_per_forward(num_layers, n_nodes)
    assert sum(calls) == num_layers * n_edges(n_nodes)  # every edge exactly once


def test_remat_policy_dots_is_not_ported_and_typos_raise():
    # "dots" is ported now (tests/test_torch_remat.py holds it against JAX):
    # it builds; a typo still raises
    assert DartsNetwork(**CFG, remat_policy="dots")._context_fn is not None
    assert DartsNetwork(**CFG)._context_fn is None
    with pytest.raises(ValueError, match="unknown remat_policy"):
        DartsNetwork(**CFG, remat_policy="dot")


def test_genotype_matches_jax():
    prims = tops.DEFAULT_PRIMITIVES
    rng = np.random.default_rng(5)
    for n_nodes in (2, 4):
        k = n_edges(n_nodes)
        alphas = [rng.normal(size=(k, len(prims))).astype(np.float32) for _ in range(2)]
        want = j_extract_genotype(JAlphas(*alphas), prims, n_nodes=n_nodes)
        got = extract_genotype(Alphas(*(torch.from_numpy(a) for a in alphas)), prims,
                               n_nodes=n_nodes)
        assert got == want
        assert got.render() == want.render()


def test_reset_parameters_is_seeded():
    def draw(seed):
        net = DartsNetwork(**CFG, dtype=torch.float32)
        net.reset_parameters(torch.Generator().manual_seed(seed))
        return torch.cat([p.flatten() for p in net.parameters()])

    assert torch.equal(draw(3), draw(3))
    assert not torch.equal(draw(3), draw(4))
