"""The port's flash attention against the JAX package's Pallas kernels.

On the CPU the port's ``flash_attention_with_lse`` runs its plain PyTorch
versions (forward, and the dq and dk/dv formulas of the backward) and the
JAX side runs the three Pallas kernels in interpret mode, float32.  Inputs
come from numpy with a seed.  Tolerance 1e-5 on outputs and logsumexp and
2e-5 on gradients, as in ``tests/test_attention_transformer.py``: both
sides compute in float32 and differ only in summation order.  The CUDA
kernels are held against the plain versions on the card (``chip_smoke.py``
and the ``cuda``-marked test below).  Here the kernels' CUDA source also
runs on the CPU, compiled with ``g++`` against the stand-in headers of
``tests/cuda_host/``, against the plain versions; and the rounding of the
bf16 tensor-core kernels is emulated in plain torch and held against the
JAX kernels under the card's tolerance.
"""

from __future__ import annotations

import ctypes
import functools
import re
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import flash_close
from katib_tpu.ops.flash_attention import _bwd as jax_flash_bwd
from katib_tpu.ops.flash_attention import flash_attention_with_lse as jax_flash
from katib_tpu_torch.ops import flash_attention as fa

# tier-1 runs six test processes on the same cores: one torch thread each
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU or interpret mode")
    return torch.device("cuda", 0)


def _qkv(b=2, h=2, sq=64, sk=None, d=16, seed=0):
    rng = np.random.default_rng(seed)
    sk = sq if sk is None else sk
    return tuple(
        rng.normal(size=shape).astype(np.float32)
        for shape in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d))
    )


def _torch(arrays, grad=False):
    return tuple(torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays)


def _jax_grads(loss, arrays):
    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))


def _assert_grads(got, want, atol=2e-5):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("blocks", [(32, 32), (32, 64)])
def test_forward_matches_pallas_interpret(causal, blocks):
    arrays = _qkv()
    bq, bk = blocks
    o_want, lse_want = jax_flash(*(jnp.asarray(a) for a in arrays), causal, None, bq, bk, True)
    o, lse = fa.flash_attention_with_lse(*_torch(arrays), causal, None, bq, bk)
    assert o.shape == (2, 2, 64, 16) and o.dtype == torch.float32 and lse.shape == (2, 2, 64)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_want), rtol=0, atol=1e-5)


def test_gradients_of_sin_match_pallas_interpret():
    arrays = _qkv(sq=32, d=8, seed=1)

    def jloss(q, k, v):
        return jnp.sum(jnp.sin(jax_flash(q, k, v, True, None, 16, 16, True)[0]))

    want = _jax_grads(jloss, arrays)
    q, k, v = _torch(arrays, grad=True)
    torch.sin(fa.flash_attention(q, k, v, causal=True, block_q=16, block_k=16)).sum().backward()
    _assert_grads((q.grad, k.grad, v.grad), want)


@pytest.mark.parametrize("sq,sk", [(32, 64), (64, 32)])
def test_causal_cross_length_matches_pallas_interpret(sq, sk):
    """Bottom-right-aligned mask; with sq > sk the first sq - sk rows see no
    key: output 0 and logsumexp -1e30 on both sides."""
    arrays = _qkv(sq=sq, sk=sk, d=8, seed=3)
    o_want, lse_want = jax_flash(*(jnp.asarray(a) for a in arrays), True, None, 16, 16, True)
    o, lse = fa.flash_attention_with_lse(*_torch(arrays), True, None, 16, 16)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_want), rtol=0, atol=1e-5)
    if sq > sk:
        assert np.all(lse.numpy()[:, :, : sq - sk] == fa.MASK_VALUE)
        assert np.all(o.numpy()[:, :, : sq - sk] == 0.0)

    def jloss(q, k, v):
        return jnp.sum(jnp.sin(jax_flash(q, k, v, True, None, 16, 16, True)[0]))

    want = _jax_grads(jloss, arrays)
    q, k, v = _torch(arrays, grad=True)
    torch.sin(fa.flash_attention(q, k, v, causal=True, block_q=16, block_k=16)).sum().backward()
    _assert_grads((q.grad, k.grad, v.grad), want)


def test_lse_cotangent_flows():
    arrays = _qkv(sq=32, d=8, seed=2)

    def jloss(q, k, v):
        o, lse = jax_flash(q, k, v, True, None, 16, 16, True)
        return jnp.sum(o * o) + jnp.sum(jnp.cos(lse))

    want = _jax_grads(jloss, arrays)
    q, k, v = _torch(arrays, grad=True)
    o, lse = fa.flash_attention_with_lse(q, k, v, True, None, 16, 16)
    (torch.sum(o * o) + torch.sum(torch.cos(lse))).backward()
    _assert_grads((q.grad, k.grad, v.grad), want)


@pytest.mark.parametrize("causal,sq,sk", [(True, 48, 48), (False, 40, 24), (True, 40, 24)])
def test_plain_backward_equals_autograd_of_plain_forward(causal, sq, sk):
    """The dq and dk/dv plain versions (the kernels' references) against
    autograd through ``reference_attention_with_lse``, with an lse
    cotangent."""
    arrays = _qkv(b=1, h=2, sq=sq, sk=sk, d=8, seed=4)
    rng = np.random.default_rng(5)
    do = torch.from_numpy(rng.normal(size=(1, 2, sq, 8)).astype(np.float32))
    dlse = torch.from_numpy(rng.normal(size=(1, 2, sq)).astype(np.float32))
    grads = []
    for fn in (fa.flash_attention_with_lse, fa.reference_attention_with_lse):
        q, k, v = _torch(arrays, grad=True)
        o, lse = fn(q, k, v, causal)
        torch.autograd.backward([o, lse], [do, dlse])
        grads.append((q.grad, k.grad, v.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_missing_lse_cotangent_counts_as_zero():
    arrays = _qkv(sq=32, d=8, seed=6)
    grads = []
    for explicit in (False, True):
        q, k, v = _torch(arrays, grad=True)
        o, lse = fa.flash_attention_with_lse(q, k, v, True, None, 16, 16)
        if explicit:
            torch.autograd.backward([o, lse], [torch.ones_like(o), torch.zeros_like(lse)])
        else:
            o.sum().backward()
        grads.append((q.grad, k.grad, v.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_block_sizes_refused_as_in_the_jax_package():
    arrays = _qkv(sq=48, d=8)
    with pytest.raises(ValueError, match="must divide"):
        jax_flash(*(jnp.asarray(a) for a in arrays), True, None, 32, 32, True)
    with pytest.raises(ValueError, match="must divide"):
        fa.flash_attention_with_lse(*_torch(arrays), True, None, 32, 32)
    # a block larger than the sequence shrinks to it
    fa.flash_attention(*_torch(_qkv(sq=40, d=8)), block_q=128, block_k=128)


def test_bf16_keeps_dtype_and_returns_f32_lse():
    q, k, v = (t.to(torch.bfloat16) for t in _torch(_qkv(sq=32, d=8)))
    o, lse = fa.flash_attention_with_lse(q, k, v)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    o_ref, lse_ref = fa.reference_attention_with_lse(q.float(), k.float(), v.float())
    assert torch.equal(o, o_ref.to(torch.bfloat16)) and torch.equal(lse, lse_ref)


def test_cpu_path_counts_no_launch():
    before = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    q, k, v = _torch(_qkv(sq=32, d=8), grad=True)
    fa.flash_attention(q, k, v).sum().backward()
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == before


@pytest.mark.parametrize(
    "shapes,dtypes,exc",
    [
        (((1, 2, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)), (torch.float16,) * 3, TypeError),
        (((1, 2, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)),
         (torch.float32, torch.bfloat16, torch.float32), TypeError),
        (((1, 2, 8, 16), (1, 2, 8, 16), (1, 2, 9, 16)), (torch.float32,) * 3, ValueError),
        (((1, 2, 8, 16), (1, 3, 8, 16), (1, 3, 8, 16)), (torch.float32,) * 3, ValueError),
        (((2, 8, 16), (2, 8, 16), (2, 8, 16)), (torch.float32,) * 3, ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernels_do_not_take(shapes, dtypes, exc):
    q, k, v = (torch.ones(s, dtype=t) for s, t in zip(shapes, dtypes))
    with pytest.raises(exc):
        fa.flash_attention_with_lse(q, k, v)


def test_kernel_check_takes_contiguous_inputs_with_supported_head_dims():
    ok = torch.ones(1, 2, 8, 64)
    fa.kernel_check(ok, ok, ok)
    with pytest.raises(ValueError, match="head_dim"):
        t = torch.ones(1, 2, 8, 16)
        fa.kernel_check(t, t, t)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.ones(1, 8, 2, 64).transpose(1, 2)
        fa.kernel_check(t, t, t)


@pytest.mark.parametrize("bad", ["do_dtype", "do_shape", "lse_dtype", "dmd_shape", "dmd_strided"])
@pytest.mark.parametrize("launch", [fa.launch_dq, fa.launch_dkv])
def test_backward_launchers_check_their_extra_inputs(bad, launch):
    """Refused before any pointer reaches the kernel (and before the build)."""
    q = torch.ones(1, 2, 8, 32)
    do, lse, dmd = torch.ones_like(q), torch.ones(1, 2, 8), torch.ones(1, 2, 8)
    if bad == "do_dtype":
        do = do.to(torch.bfloat16)
    elif bad == "do_shape":
        do = torch.ones(1, 2, 9, 32)
    elif bad == "lse_dtype":
        lse = lse.double()
    elif bad == "dmd_shape":
        dmd = torch.ones(1, 2, 9)
    else:
        dmd = torch.ones(1, 8, 2).transpose(1, 2)
    with pytest.raises(ValueError):
        launch(q, q, q, do, lse, dmd, True, 0.125)


def _bf16_values(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


@functools.lru_cache(maxsize=None)
def _jax_kernels_on_bf16_inputs(sq, sk, d):
    """q, k, v, dO, lse, dmd (float32 holding bf16 values, as the kernels
    see them) and the JAX ``_fwd_kernel`` (o, lse) and
    ``_dq_kernel``/``_dkv_kernel`` (dq, dk, dv) results on them in float32,
    Pallas interpret mode, causal."""
    rng = np.random.default_rng(7)
    x = [_bf16_values(torch.from_numpy(rng.normal(size=(1, 2, n, d)).astype(np.float32)))
         for n in (sq, sk, sk, sq)]
    dlse = rng.normal(size=(1, 2, sq)).astype(np.float32)
    jx = [jnp.asarray(t.numpy()) for t in x]
    o, lse = jax_flash(*jx[:3], True, None, 32, 32, True)
    want = jax_flash_bwd(*jx[:3], o, lse, jx[3], jnp.asarray(dlse), sm_scale=d ** -0.5,
                         causal=True, block_q=32, block_k=32, interpret=True)
    o_lse = [torch.from_numpy(np.array(t)) for t in (o, lse)]
    dmd = (x[3] * o_lse[0]).sum(-1) - torch.from_numpy(dlse)
    return (*x, o_lse[1], dmd), o_lse + [torch.from_numpy(np.array(w)) for w in want]


def _second_product(x, eq, y, split: bool):
    """``einsum(eq, x, y)`` with x handed to the tensor cores as a bf16
    hi + lo pair (two products into one float32 sum) or, with ``split``
    False, rounded to one bf16."""
    hi = _bf16_values(x)
    parts = (hi, _bf16_values(x - hi)) if split else (hi,)
    return sum(torch.einsum(eq, part, y) for part in parts)


def _tensor_core_forward_rounding(q, k, v, scale, split: bool, tile=64):
    """The bf16 forward kernel's arithmetic in plain torch, causal: k tiles
    of ``tile`` keys in order, scores in float32 from bf16 operands, a
    running max from -1e30 with masked scores -inf, the running sum of the
    float32 p, the accumulator rescaled by alpha before each tile's P.V,
    p handed to P.V as in ``_second_product``; o = acc / l rounded once to
    bf16, lse = m + log l, and a row that saw no key gets o 0, lse -1e30."""
    sq, sk = q.shape[2], k.shape[2]
    mask = fa._causal_mask(sq, sk, q.device)
    m = torch.full((*q.shape[:3], 1), fa.MASK_VALUE)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for k0 in range(0, sk, tile):
        kt, vt = k[:, :, k0:k0 + tile], v[:, :, k0:k0 + tile]
        s = torch.einsum("bhqd,bhkd->bhqk", q, kt) * scale
        s = torch.where(mask[:, k0:k0 + tile], s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _second_product(p, "bhqk,bhkd->bhqd", vt, split)
        m = m_new
    o = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)
    lse = torch.where(l > 0, m + torch.log(l), fa.MASK_VALUE)[..., 0]
    return o.to(torch.bfloat16), lse


def _tensor_core_rounding(q, k, v, do, lse, dmd, scale, split: bool):
    """The bf16 kernels' arithmetic in plain torch: bf16 operands, float32
    products and sums, p (forward, dk/dv) and ds (dq, dk/dv) handed to the
    second products as in ``_second_product``; one bf16 store of o, dq, dk
    and dv (lse stays float32).  The backward takes the JAX forward's lse,
    as the card's parity cases take the kernel's own."""
    o, lse_fwd = _tensor_core_forward_rounding(q, k, v, scale, split)
    p, ds = fa._probs_and_ds(q, k, v, do, lse, dmd, True, scale)
    dq = scale * _second_product(ds, "bhqk,bhkd->bhqd", k, split)
    dk = scale * _second_product(ds, "bhqk,bhqd->bhkd", q, split)
    dv = _second_product(p, "bhqk,bhqd->bhkd", do, split)
    return [o, lse_fwd] + [t.to(torch.bfloat16) for t in (dq, dk, dv)]


@pytest.mark.parametrize("split", [True, False], ids=["hi_lo_pair", "one_bf16"])
@pytest.mark.parametrize("sq,sk", [(96, 160), (160, 96)])
def test_tensor_core_rounding_meets_the_card_tolerance_only_when_split(sq, sk, split):
    """The bf16 kernels' rounding, emulated, against the JAX kernels in
    float32 on the same bf16 inputs, under ``chip_smoke.py``'s tolerance
    (one bf16 spacing plus 1e-5 of the largest magnitude): with p and ds as
    hi + lo pairs o, dq, dk and dv pass (at about half of it, the final
    bf16 store); rounded to one bf16 each exceeds it (by 20-60x at these
    shapes), which is why the kernels split them.  The forward's lse does
    not pass through a second product and passes either way; with
    sq > sk its fully masked rows must come out as exactly -1e30."""
    inputs, want = _jax_kernels_on_bf16_inputs(sq, sk, 32)
    got = _tensor_core_rounding(*inputs, scale=32 ** -0.5, split=split)
    results = [flash_close(g, w, fa.MASK_VALUE) for g, w in zip(got, want)]
    assert [ok for ok, _ in results] == [split, True, split, split, split], results


# bodies of the kernel source's PTX helpers, replaced by the per-lane
# emulations of tests/cuda_host/cuda_bf16.h when the source runs on the host
_HOST_HELPER_BODIES = {
    "smem_u32": "{ return 0; }",
    "cp_async16": "{ host_cp_async(dst, src, valid, 16); }",
    "cp_async4": "{ host_cp_async(dst, src, valid, 4); }",
    "cp_async_commit": "{}",
    "cp_async_wait": "{}",
    "ldmatrix_x4": "{ host_ldmatrix_x4(r, row, false); }",
    "ldmatrix_x4_trans": "{ host_ldmatrix_x4(r, row, true); }",
    "mma_bf16": "{ host_mma_bf16(c, a, b0, b1); }",
}


def _host_source(src: str) -> str:
    """``flash_attention.cu`` rewritten for the host stand-in headers: PTX
    helper bodies replaced, dynamic shared memory bound to the block's
    buffer, ``<<<>>>`` launches made ``host_launch`` calls."""
    for name, body in _HOST_HELPER_BODIES.items():
        m = re.search(rf"__device__ __forceinline__ \w+ {name}\(", src)
        assert m, f"helper {name} not found in the kernel source"
        start = src.index("{", m.end())
        depth = 0
        for end in range(start, len(src)):  # the asm strings' braces balance
            depth += {"{": 1, "}": -1}.get(src[end], 0)
            if depth == 0:
                break
        src = src[:start] + body + src[end + 1:]
    src = src.replace("extern __shared__ float smem[];",
                      "float* smem = (float*)host_shared_memory();")
    src = src.replace("extern __shared__ uint4 tc_smem[];",
                      "uint4* tc_smem = (uint4*)host_shared_memory();")
    src, launches = re.subn(r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\((.*?)\);",
                            r"host_launch(\2, [=] { \1(\3); });", src)
    assert launches, "no kernel launch found in the kernel source"
    return src


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """The flash kernels' CUDA source compiled for the CPU with the host
    C++ compiler against ``tests/cuda_host/``; skips without ``g++``."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    root = Path(__file__).resolve().parents[1]
    out = tmp_path_factory.mktemp("flash_host")
    src = out / "flash_attention_host.cpp"
    src.write_text(_host_source((root / "katib_tpu_torch/ops/csrc/flash_attention.cu").read_text()))
    lib_path = out / "libflash_attention_host.so"
    built = subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                            f"-I{root / 'tests/cuda_host'}", "-o", str(lib_path), str(src)],
                           capture_output=True, text=True, timeout=300)
    assert built.returncode == 0, built.stderr[-4000:]
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    tail = [i32, i32, i32, i32, ctypes.c_float, i32, i32, ptr]
    lib.katib_flash_fwd.argtypes = [ptr] * 5 + tail
    lib.katib_flash_dq.argtypes = [ptr] * 7 + tail
    lib.katib_flash_dkv.argtypes = [ptr] * 8 + tail
    return lib


@pytest.mark.parametrize(
    "causal,dtype,shape",
    [
        (True, torch.bfloat16, (1, 2, 130, 70, 32)),
        (False, torch.bfloat16, (1, 1, 77, 77, 32)),
        (True, torch.bfloat16, (1, 1, 96, 200, 64)),
        (True, torch.bfloat16, (1, 1, 70, 150, 128)),
        (True, torch.bfloat16, (1, 1, 150, 70, 128)),
        (True, torch.float32, (1, 1, 130, 70, 64)),
        (False, torch.float32, (1, 1, 77, 100, 32)),
    ],
)
def test_kernel_source_on_the_host_matches_plain_versions(host_kernels, causal, dtype, shape):
    """The forward, dq and dk/dv kernels of ``flash_attention.cu``, run on
    the CPU through the host stand-ins (bf16: the tensor-core kernels with
    emulated ``cp.async``/``ldmatrix``/``mma.sync`` and quad shuffles;
    float32: the FMA ones), against the plain versions under
    ``chip_smoke.py``'s tolerance: ragged tiles, cross lengths with fully
    masked rows (o exactly 0, lse exactly -1e30), D = 32, 64 and 128.  It
    checks the kernels' logic and fragment layouts as the PTX ISA states
    them, not the card: ``chip_smoke.py`` does that."""
    b, h, sq, sk, d = shape
    gen = torch.Generator().manual_seed(11)
    q, do = (torch.randn(b, h, sq, d, generator=gen).to(dtype) for _ in range(2))
    k, v = (torch.randn(b, h, sk, d, generator=gen).to(dtype) for _ in range(2))
    dlse = torch.randn(b, h, sq, generator=gen)
    scale = d ** -0.5
    o, lse = torch.empty_like(q), torch.empty(b, h, sq)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def launch(fn, *tensors):
        err = fn(*(t.data_ptr() for t in tensors), b * h, sq, sk, d, scale, int(causal),
                 fa._DTYPE_CODES[dtype], None)
        assert err == 0, err

    launch(host_kernels.katib_flash_fwd, q, k, v, o, lse)
    dmd = ((do.float() * o.float()).sum(-1) - dlse).contiguous()
    launch(host_kernels.katib_flash_dq, q, k, v, do, lse, dmd, dq)
    launch(host_kernels.katib_flash_dkv, q, k, v, do, lse, dmd, dk, dv)
    x32 = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = fa.reference_attention_with_lse(*x32[:3], causal, scale)
    dk_ref, dv_ref = fa.reference_attention_dkv(*x32, lse, dmd, causal, scale)
    results = {
        "o": flash_close(o, o_ref, fa.MASK_VALUE),
        "lse": flash_close(lse, lse_ref, fa.MASK_VALUE),
        "dq": flash_close(dq, fa.reference_attention_dq(*x32, lse, dmd, causal, scale),
                          fa.MASK_VALUE),
        "dk": flash_close(dk, dk_ref, fa.MASK_VALUE),
        "dv": flash_close(dv, dv_ref, fa.MASK_VALUE),
    }
    assert all(ok for ok, _ in results.values()), results
    if causal and sq > sk:
        assert torch.all(o[:, :, : sq - sk] == 0) and torch.all(lse[:, :, : sq - sk] == fa.MASK_VALUE)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for causal, sq, sk, d in [(True, 256, 256, 64), (False, 200, 130, 32), (True, 130, 70, 128)]:
        q = torch.randn(2, 3, sq, d, device=cuda_device, generator=gen)
        k, v = (torch.randn(2, 3, sk, d, device=cuda_device, generator=gen) for _ in range(2))
        do = torch.randn_like(q)
        dlse = torch.randn(2, 3, sq, device=cuda_device, generator=gen)
        scale = d ** -0.5
        before = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
        o, lse = fa.launch_fwd(q, k, v, causal, scale)
        dmd = (do * o).sum(-1) - dlse
        dq = fa.launch_dq(q, k, v, do, lse, dmd, causal, scale)
        dk, dv = fa.launch_dkv(q, k, v, do, lse, dmd, causal, scale)
        torch.cuda.synchronize()
        assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == tuple(n + 1 for n in before)
        o_ref, lse_ref = fa.reference_attention_with_lse(q, k, v, causal, scale)
        torch.testing.assert_close(o, o_ref, rtol=0, atol=1e-5)
        torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-5)
        torch.testing.assert_close(dq, fa.reference_attention_dq(q, k, v, do, lse, dmd, causal, scale),
                                   rtol=0, atol=1e-5)
        dk_ref, dv_ref = fa.reference_attention_dkv(q, k, v, do, lse, dmd, causal, scale)
        torch.testing.assert_close(dk, dk_ref, rtol=0, atol=1e-5)
        torch.testing.assert_close(dv, dv_ref, rtol=0, atol=1e-5)
