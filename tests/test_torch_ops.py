"""The port's DARTS primitives and convolutions against the JAX package's.

Each case builds the flax module, swaps in weights drawn by numpy from a
seed, carries them across with ``katib_tpu_torch.convert`` and feeds both
sides the same NHWC input (NCHW on the port's side), in float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katib_tpu.nas.darts import ops as jops
from katib_tpu.ops import depthwise as jdw
from katib_tpu_torch.convert import state_dict_from_flax
from katib_tpu_torch.nas.darts import ops as tops
from katib_tpu_torch.ops import depthwise as tdw

# tier-1 runs six test processes on the same cores: one torch thread each
torch.set_num_threads(1)

C = 4


def _numpy_weights(variables, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.5, size=a.shape).astype(np.float32), variables
    )


def _run_both(jmod, tmod, x_nhwc: np.ndarray, *extra, seed: int = 0):
    """(JAX output NHWC, port output permuted to NHWC), same weights."""
    jx = jnp.asarray(x_nhwc)
    variables = _numpy_weights(jmod.init(jax.random.PRNGKey(0), jx, *extra), seed)
    want = np.asarray(jmod.apply(variables, jx, *extra))
    tmod.load_state_dict(state_dict_from_flax(variables, tmod))
    t_extra = [torch.from_numpy(np.asarray(e)) for e in extra]
    got = tmod(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2), *t_extra)
    return want, got.detach().permute(0, 2, 3, 1).numpy()


def _x(size: int, channels: int = C, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(4, size, size, channels)).astype(np.float32)


@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("name", jops.DEFAULT_PRIMITIVES)
def test_primitive_matches_jax(name, stride, size):
    jmod = jops.build_op(name, C, stride, dtype=jnp.float32)
    tmod = tops.build_op(name, C, stride, dtype=torch.float32)
    want, got = _run_both(jmod, tmod, _x(size))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_mixed_op_matches_jax(stride, monkeypatch):
    monkeypatch.setenv("KATIB_PALLAS_MIXED_OP", "interpret")
    prims = jops.DEFAULT_PRIMITIVES
    w = np.random.default_rng(2).dirichlet(np.ones(len(prims))).astype(np.float32)
    jmod = jops.MixedOp(prims, C, stride, dtype=jnp.float32)
    tmod = tops.MixedOp(prims, C, stride, dtype=torch.float32)
    want, got = _run_both(jmod, tmod, _x(8), w)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_edge_group_is_the_sum_of_its_mixed_ops():
    """One launch for k edges equals k single-edge mixed ops, summed."""
    prims = jops.DEFAULT_PRIMITIVES
    torch.manual_seed(0)
    group = tops.EdgeGroup(3, prims, C, 1, dtype=torch.float32)
    states = [torch.randn(2, C, 8, 8) for _ in range(3)]
    rows = torch.softmax(torch.randn(3, len(prims)), -1)
    want = sum(edge(s, r) for edge, s, r in zip(group.edges, states, rows))
    torch.testing.assert_close(group(states, rows), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kernel,stride,dilation", [
    (3, 1, 1), (3, 2, 1), (5, 1, 1), (3, 1, 2), (5, 2, 2),
])
@pytest.mark.parametrize("size", [8, 9])
def test_depthwise_conv_matches_jax(kernel, stride, dilation, size):
    jmod = jdw.DepthwiseConv(kernel=kernel, stride=stride, dilation=dilation, dtype=jnp.float32)
    tmod = tdw.DepthwiseConv(C, kernel, stride=stride, dilation=dilation, dtype=torch.float32)
    want, got = _run_both(jmod, tmod, _x(size))
    # summation-order noise over up to 25 taps (tests/test_depthwise.py)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride,use_bias", [(1, False), (2, True)])
def test_pointwise_conv_matches_jax(stride, use_bias):
    jmod = jdw.PointwiseConv(6, stride=stride, use_bias=use_bias, dtype=jnp.float32)
    tmod = tdw.PointwiseConv(C, 6, stride=stride, use_bias=use_bias, dtype=torch.float32)
    want, got = _run_both(jmod, tmod, _x(9))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_relu_conv_bn_matches_jax(kernel, stride):
    jmod = jops.ReluConvBn(6, kernel=kernel, stride=stride, dtype=jnp.float32)
    tmod = tops.ReluConvBn(C, 6, kernel=kernel, stride=stride, dtype=torch.float32)
    want, got = _run_both(jmod, tmod, _x(8))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [8, 9])
def test_factorized_reduce_matches_jax(size):
    jmod = jops.FactorizedReduce(6, dtype=jnp.float32)
    tmod = tops.FactorizedReduce(C, 6, dtype=torch.float32)
    want, got = _run_both(jmod, tmod, _x(size))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_batch_norm_matches_jax_and_keeps_dtype():
    x = _x(8) * 3 + 1
    want = np.asarray(jops.batch_norm(jnp.asarray(x)))
    got = tops.batch_norm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    xb = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    assert tops.batch_norm(xb).dtype == torch.bfloat16


def test_unknown_primitive_raises():
    with pytest.raises(ValueError, match="unknown primitive"):
        tops.build_op("conv_7x7", C, 1)
