"""The DARTS augment phase of the port against the JAX package's: the
discrete ``GenotypeNetwork`` with converted weights, ``train_classifier``
from the same weights, the momentum optimizer against optax, and the
phase inside ``darts_trial``."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from katib_tpu.models import data as jdata
from katib_tpu.models.mnist import _family_optimizer, _set_hyperparams
from katib_tpu.models.mnist import train_classifier as j_train_classifier
from katib_tpu.nas.darts.augment import GenotypeNetwork as JGenotypeNetwork
from katib_tpu.nas.darts.model import Genotype as JGenotype
from katib_tpu_torch.convert import state_dict_from_flax
from katib_tpu_torch.models import data as tdata
from katib_tpu_torch.models.mnist import _family_optimizer as t_family_optimizer
from katib_tpu_torch.models.mnist import _set_hyperparams as t_set_hyperparams
from katib_tpu_torch.models.mnist import train_classifier
from katib_tpu_torch.nas.darts.augment import GenotypeNetwork, train_genotype
from katib_tpu_torch.nas.darts.model import Genotype
from katib_tpu_torch.nas.darts.search import darts_trial
from katib_tpu_torch.runner.context import TrialContext

torch.set_num_threads(1)

# every primitive but "none" (a genotype never keeps it), stride-2 skip
# connections in the reduction cells
NORMAL = [[("separable_convolution_3x3", 0), ("skip_connection", 1)],
          [("dilated_convolution_3x3", 2), ("max_pooling_3x3", 0)]]
REDUCE = [[("skip_connection", 0), ("avg_pooling_3x3", 1)],
          [("separable_convolution_5x5", 2), ("dilated_convolution_5x5", 1)]]
NET = dict(init_channels=4, num_layers=3, num_classes=4)


def _dataset(package):
    return package.synthetic_classification(16, 8, (8, 8, 3), 4, seed=5)


@pytest.fixture(scope="module")
def jax_net():
    net = JGenotypeNetwork(genotype=JGenotype(NORMAL, REDUCE), **NET, dtype=jnp.float32)
    params = jax.jit(net.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))
    return net, jax.device_get(params)


def _port_net(params):
    net = GenotypeNetwork(Genotype(NORMAL, REDUCE), **NET, dtype=torch.float32)
    net.load_state_dict(state_dict_from_flax(params, net))
    return net


def test_genotype_network_forward_matches_flax(jax_net):
    jnet, params = jax_net
    x = np.random.default_rng(1).normal(size=(4, 8, 8, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_net(params)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_train_classifier_steps_match_jax(jax_net):
    jnet, params = jax_net
    want = []
    acc = j_train_classifier(
        jnet, _dataset(jdata), lr=0.05, epochs=2, batch_size=4, seed=3,
        init_transform=lambda p: jax.tree_util.tree_map(jnp.asarray, params),
        report=lambda **kw: want.append(kw) or True,
    )
    got = []
    port_acc = train_classifier(
        _port_net(params), _dataset(tdata), lr=0.05, epochs=2, batch_size=4, seed=3,
        device="cpu", report=lambda **kw: got.append(kw) or True,
    )
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1]
    for g, w in zip(got, want):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-4)
        assert g["accuracy"] == w["accuracy"]
    assert port_acc == acc


def test_momentum_optimizer_matches_optax():
    rng = np.random.default_rng(2)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    tx = _family_optimizer("momentum")
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_state = _set_hyperparams(tx.init(j_params), 0.05, 0.9)
    t_opt = t_family_optimizer("momentum")
    t_params = {k: torch.from_numpy(v) for k, v in params.items()}
    t_state = t_set_hyperparams(t_opt.init(t_params), 0.05, 0.9)
    for _ in range(3):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        updates, j_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        t_params, t_state = t_opt.update({k: torch.from_numpy(v) for k, v in grads.items()},
                                         t_state, t_params)
        for k in params:
            np.testing.assert_allclose(t_params[k].numpy(), np.asarray(j_params[k]),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kwargs,match", [
    ({"mesh": {"data": 2}}, "mesh"),
    ({"init_transform": lambda p: p}, "init_transform"),
    ({"on_finish": lambda p: None}, "on_finish"),
])
def test_unported_trainer_options_raise(jax_net, kwargs, match):
    """``mesh``, ``init_transform`` and ``on_finish`` each raised until a
    later slice ported it; each case now checks it as the JAX trainer runs
    it.  ``mesh``: the data-parallel trainer on a ``{data: 2}`` mesh (the
    genotype network's batch norms over the global batch) against the JAX
    trainer on its ``{data: 2}`` mesh, from the same weights.  A transform
    that loads the converted weights into a fresh network trains as the
    converted network does, and ``on_finish`` gets host copies of the final
    parameters once, also when ``report`` stops the run after epoch 0."""
    run = lambda net, **kw: train_classifier(net, _dataset(tdata), lr=0.1, epochs=2,
                                             batch_size=4, device="cpu", seed=3, **kw)
    if match == "mesh":
        from katib_tpu.parallel.mesh import make_mesh as j_make_mesh
        from katib_tpu_torch.parallel.mesh import make_mesh

        jnet, params = jax_net
        want = []
        want_acc = j_train_classifier(
            jnet, _dataset(jdata), lr=0.1, epochs=2, batch_size=4, seed=3,
            mesh=j_make_mesh(kwargs["mesh"], devices=jax.devices()[:2]),
            init_transform=lambda p: jax.tree_util.tree_map(jnp.asarray, params),
            report=lambda **kw: want.append(kw) or True)
        got = []
        acc = run(_port_net(params), mesh=make_mesh(kwargs["mesh"], devices=["cpu"] * 2),
                  report=lambda **kw: got.append(kw) or True)
        # float32, the same global-batch steps: 1e-4 relative on the loss,
        # the same count of correct images
        assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1]
        for g, w in zip(got, want):
            assert g["loss"] == pytest.approx(float(w["loss"]), rel=1e-4)
            assert g["accuracy"] == pytest.approx(float(w["accuracy"]), abs=1e-6)
        assert acc == pytest.approx(float(want_acc), abs=1e-6)
        return
    want = []
    want_acc = run(_port_net(jax_net[1]), report=lambda **kw: want.append(kw) or True)
    fresh = GenotypeNetwork(Genotype(NORMAL, REDUCE), **NET, dtype=torch.float32)
    if match == "init_transform":
        got = []
        acc = run(fresh, report=lambda **kw: got.append(kw) or True,
                  init_transform=lambda p: state_dict_from_flax(jax_net[1], fresh))
        assert got == want and acc == want_acc
        return
    finished = []
    acc = run(_port_net(jax_net[1]), report=lambda **kw: False, on_finish=finished.append)
    assert acc == want[0]["accuracy"] and len(finished) == 1
    (final,) = finished
    assert set(final) == set(dict(fresh.named_parameters()))
    assert all(t.device.type == "cpu" and t.dtype == torch.float32 for t in final.values())


def test_train_genotype_trains_and_reports():
    reports = []
    acc = train_genotype(Genotype(NORMAL, REDUCE), _dataset(tdata), init_channels=4,
                         num_layers=3, epochs=2, batch_size=4, device="cpu",
                         data_augment=True, report=lambda **kw: reports.append(kw) or True)
    assert [r["epoch"] for r in reports] == [0, 1] and acc == reports[-1]["accuracy"]
    assert all(np.isfinite(r["loss"]) and 0.0 <= r["accuracy"] <= 1.0 for r in reports)


PRIMS = ("separable_convolution_3x3", "max_pooling_3x3", "skip_connection")
SETTINGS = {"batch_size": 4, "init_channels": 4, "num_nodes": 2, "num_epochs": 2,
            "n_train": 16, "n_test": 8, "remat": "false", "unrolled": "false",
            "augment_epochs": "1"}


def _ctx(tmp_path, settings):
    return TrialContext({"algorithm-settings": json.dumps(settings),
                         "search-space": json.dumps(list(PRIMS)), "num-layers": "3"},
                        checkpoint_dir=str(tmp_path / "trial"), device="cpu")


def test_darts_trial_reports_augment_accuracy(tmp_path):
    ctx = _ctx(tmp_path, SETTINGS)
    darts_trial(ctx)
    assert [step for step, _ in ctx.reports] == [0, 1, 3]
    (step, metrics) = ctx.reports[-1]
    assert set(metrics) == {"augment_accuracy"} and 0.0 <= metrics["augment_accuracy"] <= 1.0


def test_a_stopped_search_skips_the_augment_phase(tmp_path):
    ctx = _ctx(tmp_path, SETTINGS)
    ctx.request_stop()
    darts_trial(ctx)
    assert [step for step, _ in ctx.reports] == [0]
