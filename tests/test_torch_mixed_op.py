"""The port's mixed-op contraction against the JAX package's Pallas kernel.

On the CPU the port's ``mixed_op_sum`` runs its plain PyTorch version and
the JAX side runs the Pallas kernel in interpret mode
(``KATIB_PALLAS_MIXED_OP=interpret``).  Inputs come from numpy with a seed.
The CUDA kernel itself is held against the plain version on the card
(``chip_smoke.py`` and the ``cuda``-marked test below).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katib_tpu.ops.mixed_op import mixed_op_sum as jax_mixed_op_sum
from katib_tpu_torch.ops import mixed_op

# tier-1 runs six test processes on the same cores: one torch thread each
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU or interpret mode")
    return torch.device("cuda", 0)


def _inputs(e: int, n_ops: int, m: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(e, n_ops)).astype(np.float32)
    w = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    x = rng.normal(size=(e, n_ops, m)).astype(np.float32)
    # cotangent scaled so dw = sum_m x*g is O(1): the absolute tolerance
    # then sits well above f32 summation-order noise at any M
    g = (rng.normal(size=(e, m)) / np.sqrt(m)).astype(np.float32)
    return w.astype(np.float32), x, g


# n_ops 3 (examples/nas/darts.yaml) and 8 (DEFAULT_PRIMITIVES); M ragged
# against the 512-wide Pallas tile and against 16-byte vectors
CASES = [(1, 3, 1000), (5, 8, 1000), (2, 8, 513), (4, 3, 2048 + 7)]


@pytest.mark.parametrize("e,n_ops,m", CASES)
def test_forward_matches_pallas_interpret(e, n_ops, m, monkeypatch):
    monkeypatch.setenv("KATIB_PALLAS_MIXED_OP", "interpret")
    w, x, _ = _inputs(e, n_ops, m)
    want = jax.vmap(jax_mixed_op_sum)(jnp.asarray(w), jnp.asarray(x))
    got = mixed_op.mixed_op_sum(torch.from_numpy(w), torch.from_numpy(x))
    assert got.shape == (e, m) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("e,n_ops,m", CASES)
def test_gradients_match_jax_grad(e, n_ops, m, monkeypatch):
    monkeypatch.setenv("KATIB_PALLAS_MIXED_OP", "interpret")
    w, x, g = _inputs(e, n_ops, m, seed=1)

    def jloss(wj, xj):
        return jnp.sum(jax.vmap(jax_mixed_op_sum)(wj, xj) * jnp.asarray(g))

    dw_want, dx_want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(x))
    wt = torch.from_numpy(w).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    (mixed_op.mixed_op_sum(wt, xt) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_want), rtol=0, atol=1e-5)


def test_bf16_keeps_dtype_and_accumulates_in_f32():
    w, x, _ = _inputs(2, 8, 300)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = mixed_op.mixed_op_sum(torch.from_numpy(w), xb)
    assert got.dtype == torch.bfloat16
    want = torch.einsum("eo,eom->em", torch.from_numpy(w), xb.float()).to(torch.bfloat16)
    assert torch.equal(got, want)


def test_cpu_path_counts_no_launch():
    w, x, _ = _inputs(1, 3, 10)
    before = mixed_op.launches
    mixed_op.mixed_op_sum(torch.from_numpy(w), torch.from_numpy(x))
    assert mixed_op.launches == before


@pytest.mark.parametrize(
    "w_shape,x_shape,w_dtype,x_dtype,exc",
    [
        ((2, 3), (2, 3, 5), torch.float64, torch.float32, TypeError),
        ((2, 3), (2, 3, 5), torch.float32, torch.float16, TypeError),
        ((2, 4), (2, 3, 5), torch.float32, torch.float32, ValueError),
        ((3,), (3, 5), torch.float32, torch.float32, ValueError),
        ((1, 17), (1, 17, 5), torch.float32, torch.float32, ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(w_shape, x_shape, w_dtype, x_dtype, exc):
    with pytest.raises(exc):
        mixed_op.mixed_op_sum(torch.ones(w_shape, dtype=w_dtype), torch.ones(x_shape, dtype=x_dtype))


def test_wrapper_rejects_non_contiguous():
    x = torch.ones(2, 5, 3).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        mixed_op.mixed_op_sum(torch.ones(2, 3), x)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for e, n_ops, m in [(1, 3, 1_000_003), (5, 8, 1 << 20), (3, 16, 77)]:
            w = torch.softmax(torch.randn(e, n_ops, device=cuda_device, generator=gen), -1)
            x = torch.randn(e, n_ops, m, device=cuda_device, generator=gen).to(dtype)
            before = mixed_op.launches
            got = mixed_op.mixed_op_sum(w, x)
            torch.cuda.synchronize()
            assert mixed_op.launches == before + 1
            want = mixed_op.mixed_op_sum_reference(w, x)
            torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
