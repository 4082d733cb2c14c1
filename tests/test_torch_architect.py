"""The port's bilevel search step against the JAX package's, in float32.

Both sides start from the same weights (numpy draws on the JAX parameter
tree, carried across with ``katib_tpu_torch.convert``) and take two steps
on the same batches.  The raw second-order alpha gradient is compared, not
the post-Adam alphas: Adam's sign-like first step turns sub-noise gradient
elements into full ±alpha_lr differences (``katib_tpu/nas/darts/architect.py``
``DartsHyper.debug_alpha_grad``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from katib_tpu.nas.darts import architect as jarch
from katib_tpu.nas.darts.model import Alphas as JAlphas
from katib_tpu.nas.darts.model import DartsNetwork as JNet
from katib_tpu.parallel.train import cross_entropy_loss as j_cross_entropy
from katib_tpu_torch.convert import alphas_from_jax, state_dict_from_flax
from katib_tpu_torch.nas.darts import architect as tarch
from katib_tpu_torch.nas.darts.model import Alphas, DartsNetwork, n_edges
from katib_tpu_torch.parallel.train import cross_entropy_loss

# tier-1 runs six test processes on the same cores: one torch thread each
torch.set_num_threads(1)

# the operation set of examples/nas/darts.yaml
PRIMS = ("separable_convolution_3x3", "max_pooling_3x3", "skip_connection")
CFG = dict(primitives=PRIMS, init_channels=4, num_layers=3, n_nodes=2, num_classes=4)
STEPS = 2


def test_darts_hyper_matches_jax_field_by_field():
    assert tarch.DartsHyper._fields == jarch.DartsHyper._fields
    assert tarch.DartsHyper._field_defaults == jarch.DartsHyper._field_defaults


def test_alpha_update_matches_optax():
    hyper = tarch.DartsHyper()
    tx = optax.chain(
        optax.add_decayed_weights(hyper.alpha_weight_decay),
        optax.adam(hyper.alpha_lr, b1=0.5, b2=0.999),
    )
    rng = np.random.default_rng(0)
    alphas = [rng.normal(0, 1e-3, size=(5, 8)).astype(np.float32) for _ in range(2)]
    j_alphas = JAlphas(*map(jnp.asarray, alphas))
    j_opt = tx.init(j_alphas)
    t_alphas = Alphas(*map(torch.from_numpy, alphas))
    zeros = Alphas(*(torch.zeros(5, 8) for _ in range(2)))
    t_opt = tarch.AdamState(0, zeros, zeros)
    for _ in range(3):
        grads = [rng.normal(0, 1e-2, size=(5, 8)).astype(np.float32) for _ in range(2)]
        updates, j_opt = tx.update(JAlphas(*map(jnp.asarray, grads)), j_opt, j_alphas)
        j_alphas = optax.apply_updates(j_alphas, updates)
        t_alphas, t_opt = tarch.alpha_update(
            Alphas(*map(torch.from_numpy, grads)), t_opt, t_alphas, hyper
        )
        # rtol 1e-4: the float32 ``b2**count`` of the bias correction may
        # differ by an ulp between the frameworks' pow, 6e-5 relative in
        # 1 - b2**count at count 1
        for got, want in zip(t_alphas, j_alphas):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-9)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    batches = [
        tuple(
            (rng.normal(size=(6, 8, 8, 3)).astype(np.float32),
             rng.integers(0, 4, size=6).astype(np.int32))
            for _ in range(2)
        )
        for _ in range(STEPS)
    ]
    k = n_edges(CFG["n_nodes"])
    alphas = JAlphas(*(rng.normal(0, 1e-3, size=(k, len(PRIMS))).astype(np.float32)
                       for _ in range(2)))
    jnet = JNet(**CFG, remat=False, dtype=jnp.float32)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), alphas)
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(0.0, 0.5, size=s.shape).astype(np.float32), shapes
    )
    return dict(batches=batches, alphas=alphas, params=params, jnet=jnet)


def _jax_run(setup, unrolled: bool):
    jnet = setup["jnet"]

    def loss_fn(w, a, batch):
        return j_cross_entropy(jnet.apply(w, batch[0], a), batch[1])

    hyper = jarch.DartsHyper(unrolled=unrolled, total_steps=10, debug_alpha_grad=True)
    step = jarch.make_search_step(loss_fn, hyper)
    state = jarch.init_search_state(
        jax.tree_util.tree_map(jnp.asarray, setup["params"]),
        JAlphas(*map(jnp.asarray, setup["alphas"])), hyper,
    )
    out = []
    for train, val in setup["batches"]:
        state, m = step(state, tuple(map(jnp.asarray, train)), tuple(map(jnp.asarray, val)))
        out.append(jax.device_get(m))
    return out


def _port_run(setup, unrolled: bool):
    net = DartsNetwork(**CFG, remat=False, dtype=torch.float32)

    def loss_fn(w, a, batch):
        return cross_entropy_loss(torch.func.functional_call(net, w, (batch[0], a)), batch[1])

    hyper = tarch.DartsHyper(unrolled=unrolled, total_steps=10, debug_alpha_grad=True)
    step = tarch.make_search_step(loss_fn, hyper)
    state = tarch.init_search_state(
        state_dict_from_flax(setup["params"], net), alphas_from_jax(setup["alphas"]), hyper
    )
    out = []
    for train, val in setup["batches"]:
        state, m = step(state, tuple(map(torch.from_numpy, train)),
                        tuple(map(torch.from_numpy, val)))
        out.append(m)
    return out


@pytest.mark.parametrize("unrolled", [True, False])
def test_search_step_matches_jax(setup, unrolled):
    want = _jax_run(setup, unrolled)
    got = _port_run(setup, unrolled)
    for step, (g, w) in enumerate(zip(got, want)):
        for name in ("train_loss", "val_loss", "grad_norm", "w_lr"):
            np.testing.assert_allclose(float(g[name]), float(w[name]), rtol=1e-4,
                                       err_msg=f"step {step} {name}")
        for ga, wa in zip(g["alpha_grad"], w["alpha_grad"]):
            np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-3, atol=1e-6,
                                       err_msg=f"step {step} alpha_grad")


def test_mesh_is_not_ported(setup):
    """Ported since: on a {data: 2} mesh of CPU entries (3 images per
    replica) the sharded step is the step of the global batch, so it follows
    the JAX package's single-device steps as the port's own steps do (rtol
    1e-4; alpha gradient rtol 1e-3 / atol 1e-6)."""
    import copy

    from katib_tpu_torch.parallel.collectives import replica_index
    from katib_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"data": 2}, devices=["cpu"] * 2)
    net = DartsNetwork(**CFG, remat=False, dtype=torch.float32)
    nets = [net, copy.deepcopy(net)]  # one per replica: functional_call rebinds parameters

    def loss_fn(w, a, batch):
        logits = torch.func.functional_call(nets[replica_index()], w, (batch[0], a))
        return cross_entropy_loss(logits, batch[1])

    hyper = tarch.DartsHyper(total_steps=10, debug_alpha_grad=True)
    step = tarch.make_search_step(loss_fn, hyper, mesh)
    state = tarch.init_search_state(
        state_dict_from_flax(setup["params"], net), alphas_from_jax(setup["alphas"]), hyper)
    want = _jax_run(setup, True)
    for i, (train, val) in enumerate(setup["batches"]):
        state, g = step(state, tuple(map(torch.from_numpy, train)),
                        tuple(map(torch.from_numpy, val)))
        for name in ("train_loss", "val_loss", "grad_norm", "w_lr"):
            np.testing.assert_allclose(float(g[name]), float(want[i][name]), rtol=1e-4,
                                       err_msg=f"step {i} {name}")
        for ga, wa in zip(g["alpha_grad"], want[i]["alpha_grad"]):
            np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-3, atol=1e-6)
