"""The HP-tuning trial of the port against the JAX package's: ``MLP`` and
``SmallCNN`` with weights carried by ``convert.py``, the three optimizer
families against optax, ``train_classifier`` against the JAX trainer (its
``lax.scan`` epoch), and ``mnist_trial`` through a port ``TrialContext``.
JAX runs on the CPU in float32 (bf16 where a test says so), at small sizes."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from katib_tpu.models import data as jdata
from katib_tpu.models import mnist as jmnist
from katib_tpu_torch.convert import mnist_state_dict_from_flax
from katib_tpu_torch.models import data as tdata
from katib_tpu_torch.models import mnist as tmnist
from katib_tpu_torch.runner.context import TrialContext

torch.set_num_threads(1)

# bf16 keeps 8 significant bits: each layer rounds its output to within half
# a spacing (2**-9 relative) and the two packages round at different points
# (XLA widens bf16 sums to float32 inside a fusion, PyTorch per operator), so
# allow four spacings at the largest logit over the four or five roundings
BF16_RTOL = 4 * 2.0**-8


def _models(kind: str, size: int, jdtype, tdtype):
    if kind == "mlp":
        return (jmnist.MLP(units=16, num_layers=2, dtype=jdtype),
                tmnist.MLP(units=16, num_layers=2, in_features=size * size, dtype=tdtype))
    return (jmnist.SmallCNN(channels=4, dtype=jdtype),
            tmnist.SmallCNN(channels=4, image_size=size, dtype=tdtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [28, 8])
@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_forward_matches_flax_with_converted_weights(kind, size, dtype):
    jnet, tnet = _models(kind, size, getattr(jnp, dtype), getattr(torch, dtype))
    x = np.random.default_rng(size).normal(size=(6, size, size, 1)).astype(np.float32)
    params = jax.device_get(jax.jit(jnet.init)(jax.random.PRNGKey(1), jnp.asarray(x)))
    want = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x)))
    tnet.load_state_dict(mnist_state_dict_from_flax(params, tnet))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape == (6, 10)
    scale = np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_RTOL * scale)


def test_cnn_flatten_order_is_nhwc():
    """A flatten in NCHW order leaves every shape as it is and changes the
    logits: the first Dense's rows must follow flax's NHWC flatten."""
    jnet, tnet = _models("cnn", 8, jnp.float32, torch.float32)
    x = np.random.default_rng(3).normal(size=(2, 8, 8, 1)).astype(np.float32)
    params = jax.device_get(jnet.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    want = np.asarray(jnet.apply(params, jnp.asarray(x)))
    tnet.load_state_dict(mnist_state_dict_from_flax(params, tnet))
    nchw = tnet.dense.weight.detach().reshape(16, 2, 2, 8).permute(0, 3, 1, 2).reshape(16, 32)
    with torch.no_grad():
        np.testing.assert_allclose(tnet(torch.from_numpy(x)).numpy(), want, rtol=1e-5, atol=1e-6)
        tnet.dense.weight.copy_(nchw)
        assert not np.allclose(tnet(torch.from_numpy(x)).numpy(), want, rtol=1e-3, atol=1e-3)


def test_conversion_refuses_a_tree_of_another_model():
    jnet, tnet = _models("mlp", 8, jnp.float32, torch.float32)
    params = jax.device_get(jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 1))))
    with pytest.raises(ValueError, match="shape"):
        mnist_state_dict_from_flax(params, tmnist.MLP(units=8, num_layers=2, in_features=64,
                                                      dtype=torch.float32))
    with pytest.raises(KeyError, match="Conv_0"):
        mnist_state_dict_from_flax(params, tmnist.SmallCNN(channels=4, image_size=8))


def test_init_follows_flax_lecun_normal_from_a_seeded_generator():
    a, b = tmnist.SmallCNN(), tmnist.SmallCNN()
    a.reset_parameters(torch.Generator().manual_seed(0))
    b.reset_parameters(torch.Generator().manual_seed(0))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        if name.endswith("bias"):
            assert not p.any(), name
        else:
            fan_in = p[0].numel()
            # a normal truncated at two standard deviations, of variance 1/fan_in
            assert p.abs().max() <= 2 * (1 / fan_in) ** 0.5 / 0.87962566103423978 + 1e-6
            assert float(p.detach().std()) == pytest.approx((1 / fan_in) ** 0.5, rel=0.25)


@pytest.mark.parametrize("fixed", [False, True], ids=["family", "make_optimizer"])
@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_optimizer_updates_match_optax(name, fixed):
    rng = np.random.default_rng(2)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    t_params = {k: torch.from_numpy(v) for k, v in params.items()}
    if fixed:
        jtx, ttx = jmnist.make_optimizer(name, 0.05, 0.8), tmnist.make_optimizer(name, 0.05, 0.8)
        j_state, t_state = jtx.init(j_params), ttx.init(t_params)
    else:
        jtx, ttx = jmnist._family_optimizer(name), tmnist._family_optimizer(name)
        j_state = jmnist._set_hyperparams(jtx.init(j_params), 0.05, 0.8)
        t_state = tmnist._set_hyperparams(ttx.init(t_params), 0.05, 0.8)
        assert set(t_state.hyperparams) == set(j_state.hyperparams)
        for k, v in t_state.hyperparams.items():
            assert v.dtype == torch.float32 and v.dim() == 0
            assert float(v) == float(j_state.hyperparams[k]), k
    for _ in range(3):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        updates, j_state = jtx.update(jax.tree_util.tree_map(jnp.asarray, grads), j_state,
                                      j_params)
        j_params = optax.apply_updates(j_params, updates)
        t_params, t_state = ttx.update({k: torch.from_numpy(v) for k, v in grads.items()},
                                       t_state, t_params)
        for k in params:
            np.testing.assert_allclose(t_params[k].numpy(), np.asarray(j_params[k]),
                                       rtol=1e-6, atol=1e-7)


def test_set_hyperparams_writes_only_the_keys_a_family_declares():
    params = {"w": torch.zeros(2)}
    adam = tmnist._set_hyperparams(tmnist._family_optimizer("adam").init(params), 0.1, 0.7)
    assert "momentum" not in adam.hyperparams and float(adam.hyperparams["learning_rate"]) == \
        pytest.approx(0.1)
    sgd = tmnist._set_hyperparams(tmnist._family_optimizer("sgd").init(params), 0.1, 0.7)
    assert set(sgd.hyperparams) == {"learning_rate"} and sgd.trace == {}
    mom = tmnist._set_hyperparams(tmnist._family_optimizer("momentum").init(params), 0.1, 0.7)
    assert float(mom.hyperparams["momentum"]) == pytest.approx(0.7)
    # any other name is plain sgd, as in the JAX package
    assert isinstance(tmnist._family_optimizer("rmsprop"), tmnist.Sgd)


def _dataset(package):
    return package.synthetic_classification(256, 64, (28, 28, 1), 10, seed=4)


@pytest.mark.parametrize("kind,optimizer", [("cnn", "sgd"), ("cnn", "momentum"),
                                            ("cnn", "adam"), ("mlp", "adam")])
def test_train_classifier_matches_the_jax_trainer(kind, optimizer):
    jnet, tnet = _models(kind, 28, jnp.float32, torch.float32)
    seed, lr = 3, (0.002 if optimizer == "adam" else 0.05)
    want = []
    acc = jmnist.train_classifier(jnet, _dataset(jdata), lr=lr, epochs=2, batch_size=32,
                                  optimizer=optimizer, seed=seed,
                                  report=lambda **kw: want.append(kw) or True)
    # the JAX trainer initialises from PRNGKey(seed); the port trains from
    # the module's weights, so carry that init across
    params = jax.device_get(jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 28, 28, 1))))
    tnet.load_state_dict(mnist_state_dict_from_flax(params, tnet))
    got = []
    port_acc = tmnist.train_classifier(tnet, _dataset(tdata), lr=lr, epochs=2, batch_size=32,
                                       optimizer=optimizer, seed=seed, device="cpu",
                                       report=lambda **kw: got.append(kw) or True)
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1]
    for g, w in zip(got, want):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-4)
        assert g["accuracy"] == pytest.approx(w["accuracy"], rel=1e-4)
    assert port_acc == pytest.approx(acc, rel=1e-4)
    assert got[1]["loss"] < got[0]["loss"]


def test_the_epoch_loop_leaves_the_module_and_equals_the_streamed_path():
    ds = _dataset(tdata)
    net = tmnist.SmallCNN(channels=4, dtype=torch.float32)
    before = [p.detach().clone() for p in net.parameters()]
    runs = []
    for device_data in (True, False):
        reports = []
        tmnist.train_classifier(net, ds, lr=0.05, epochs=2, batch_size=32, device="cpu",
                                device_data=device_data, report=lambda **kw: reports.append(kw))
        runs.append(reports)
    assert runs[0] == runs[1]
    assert all(torch.equal(p, q) for p, q in zip(net.parameters(), before))


def test_a_capture_needs_the_card():
    ds = _dataset(tdata)
    net = tmnist.MLP(units=8, dtype=torch.float32)
    step, _, state = tmnist.classifier_steps(net, "sgd", 0.1, 0.9)
    x, y = torch.from_numpy(ds.x_train), torch.from_numpy(ds.y_train)
    assert not tmnist.EpochLoop(step, state, x, y, 8, 32).capture
    with pytest.raises(ValueError, match="CUDA device"):
        tmnist.EpochLoop(step, state, x, y, 8, 32, capture=True)


def test_report_false_stops_after_that_epoch():
    reports = []
    tmnist.train_classifier(tmnist.MLP(units=8, dtype=torch.float32), _dataset(tdata), lr=0.1,
                            epochs=3, batch_size=64, device="cpu",
                            report=lambda **kw: reports.append(kw) or False)
    assert [r["epoch"] for r in reports] == [0]


def _trial_ctx(**params):
    base = {"arch": "cnn", "channels": "4", "n_train": "128", "n_test": "32", "epochs": "2",
            "batch_size": "32", "lr": "0.1"}
    return TrialContext({**base, **{k: str(v) for k, v in params.items()}}, device="cpu")


@pytest.mark.parametrize("params", [{}, {"arch": "mlp", "units": 8, "optimizer": "adam",
                                         "lr": 0.01}])
def test_mnist_trial_reports_each_epoch(params):
    ctx = _trial_ctx(**params)
    tmnist.mnist_trial(ctx)
    assert [step for step, _ in ctx.reports] == [0, 1]
    assert all(set(m) == {"accuracy", "loss"} and math.isfinite(m["loss"])
               and 0.0 <= m["accuracy"] <= 1.0 for _, m in ctx.reports)
    # the same seeded weights and batches give the same run
    again = _trial_ctx(**params)
    tmnist.mnist_trial(again)
    assert again.reports == ctx.reports


def test_mnist_trial_declares_the_jax_twins_and_they_raise():
    """Both twins are declared as in the JAX package, and both run: the
    cohort twin in ``tests/test_torch_cohort.py``, the warm-up twin here on
    the CPU (its eager warm-up steps; nothing is captured, so no capture
    seconds), declaring no kernel library; only a mesh raises."""
    from katib_tpu_torch.compile.prewarm import kernels_of, prewarm_fn_of
    from katib_tpu_torch.runner.cohort import cohort_fn_of

    assert cohort_fn_of(tmnist.mnist_trial) is tmnist.mnist_cohort_trial
    assert prewarm_fn_of(tmnist.mnist_trial) is tmnist.mnist_prewarm
    assert kernels_of(tmnist.mnist_trial) == ()
    assert hasattr(jmnist.mnist_trial, "__cohort_fn__")
    assert hasattr(jmnist.mnist_trial, "__prewarm_fn__")
    shared = {"units": 16, "n_train": 256, "n_test": 64, "batch_size": 64}
    assert tmnist.mnist_prewarm(shared, 2, device="cpu") == 0.0
    assert tmnist.mnist_prewarm(dict(shared, arch="cnn", channels=4), 1, device="cpu") == 0.0
    with pytest.raises(NotImplementedError, match="mesh"):
        tmnist.mnist_prewarm({}, 2, mesh=object(), device="cpu")


def test_mnist_trial_refuses_a_mesh():
    ctx = _trial_ctx()
    ctx.mesh = object()
    with pytest.raises(NotImplementedError, match="mesh"):
        tmnist.mnist_trial(ctx)


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: a CUDA graph has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["momentum", "adam", "sgd"])
def test_captured_epoch_equals_the_eager_one_on_the_card(cuda_device, optimizer, monkeypatch):
    # full float32 convolutions and products (cuDNN and cuBLAS may take
    # TF32), so the two runs differ at most in summation order
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    ds = _dataset(tdata)
    net = tmnist.SmallCNN(channels=4, dtype=torch.float32).to(cuda_device)
    step, _, state = tmnist.classifier_steps(net, optimizer, 0.01, 0.9)
    x = torch.from_numpy(ds.x_train).to(cuda_device)
    y = torch.from_numpy(ds.y_train).to(cuda_device)
    idx = np.random.default_rng(0).permutation(256).reshape(8, 32)
    loops = []
    for capture in (False, True):
        loop = tmnist.EpochLoop(step, state, x, y, 8, 32, capture=capture)
        loop.run_epoch(idx)
        loop.run_epoch(idx[::-1].copy())
        torch.cuda.synchronize()
        loops.append(loop)
    eager, graph = loops
    assert graph.graph is not None and eager.graph is None
    torch.testing.assert_close(graph.losses, eager.losses, rtol=1e-5, atol=1e-6)
    for a, b in zip(tmnist.tree_flatten(eager.state)[0], tmnist.tree_flatten(graph.state)[0]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
