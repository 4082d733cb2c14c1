"""Blockwise (flash) attention: the CUDA kernels and their plain versions.

Counterpart of ``katib_tpu/ops/flash_attention.py``.  Attention over
``[batch, heads, seq, head_dim]`` inputs that returns the output and the
per-row logsumexp, differentiable in both (the logsumexp is what a
sequence-parallel ring merge consumes).  On a CUDA tensor the forward
launches the hand-written forward kernel and the backward the dq and dk/dv
kernels of ``csrc/flash_attention.cu``; on a CPU tensor both run the plain
PyTorch versions below.  There is no other fallback: a CUDA tensor the
kernels do not take raises.

Semantics, shared by kernels and plain versions: float32 scores, a
bottom-right-aligned causal mask (``tril(k = sk - sq)``), and rows that see
no key give output 0 and logsumexp ``-1e30``.  The backward recomputes the
probabilities from the saved logsumexp, with
``dmd = rowsum(dO * O) - dlse`` folding the logsumexp cotangent into the
usual flash "delta" term (computed here in plain torch, as the JAX
package's ``_bwd`` does).
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

MASK_VALUE = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since import or the last reset; the CPU path does not count
# (replicas of a mesh launch from threads of their own: counted under a lock)
fwd_launches = 0
dq_launches = 0
dkv_launches = 0
_lib = None
_lock = threading.Lock()


def _block_sizes(seq_q: int, seq_k: int, block_q: int, block_k: int) -> tuple[int, int]:
    """The JAX package's block check: a block that does not divide its
    sequence is refused on every device (the CUDA kernels pick their own
    tiles, so on the card the blocks are only checked)."""
    bq = min(block_q, seq_q)
    bk = min(block_k, seq_k)
    if seq_q % bq or seq_k % bk:
        raise ValueError(
            f"block sizes ({bq}, {bk}) must divide sequence lengths ({seq_q}, {seq_k})"
        )
    return bq, bk


def _scale(q: torch.Tensor, sm_scale: float | None) -> float:
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    return torch.ones(sq, sk, dtype=torch.bool, device=device).tril(sk - sq)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def reference_attention_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """O(S^2)-memory attention returning ``(output, logsumexp)``: the plain
    version of the forward kernel, differentiable by autograd."""
    scale = _scale(q, sm_scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    visible = None
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        mask = _causal_mask(sq, sk, q.device)
        s = torch.where(mask, s, MASK_VALUE)
        if sq > sk:
            visible = mask.any(-1)  # rows before the diagonal see no key
    lse_raw = torch.logsumexp(s, dim=-1)
    if visible is None:
        lse = lse_raw
        p = torch.exp(s - lse[..., None])
    else:
        # fully masked rows: output 0 and lse MASK_VALUE
        lse = torch.where(visible, lse_raw, MASK_VALUE)
        p = torch.exp(s - torch.where(visible, lse_raw, 0.0)[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype), lse


def reference_attention(q, k, v, *, causal: bool = True, sm_scale=None) -> torch.Tensor:
    o, _ = reference_attention_with_lse(q, k, v, causal, sm_scale)
    return o


def _probs_and_ds(q, k, v, do, lse, dmd, causal, scale):
    """``p = exp(scale * q.k - lse)`` (masked after the subtraction) and
    ``ds = p * (dO.v - dmd)``, float32 ``[b, h, sq, sk]``."""
    e = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale - lse[..., None]
    if causal:
        e = torch.where(_causal_mask(q.shape[2], k.shape[2], q.device), e, MASK_VALUE)
    p = torch.exp(e)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, p * (dp - dmd[..., None])


def reference_attention_dq(q, k, v, do, lse, dmd, causal: bool = True, sm_scale=None):
    """The plain version of the dq kernel: ``dq = scale * ds.k``."""
    scale = _scale(q, sm_scale)
    _, ds = _probs_and_ds(q, k, v, do, lse, dmd, causal, scale)
    return (scale * torch.einsum("bhqk,bhkd->bhqd", ds, k.float())).to(q.dtype)


def reference_attention_dkv(q, k, v, do, lse, dmd, causal: bool = True, sm_scale=None):
    """The plain version of the dk/dv kernel: ``dk = scale * ds^T.q``,
    ``dv = p^T.dO``."""
    scale = _scale(q, sm_scale)
    p, ds = _probs_and_ds(q, k, v, do, lse, dmd, causal, scale)
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            f"q, k, v must share float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"expected q [B, H, Sq, D], k and v [B, H, Sk, D]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on B, H or D")


def kernel_check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the CUDA kernels take beyond :func:`_check`: contiguous inputs,
    a head dim in ``HEAD_DIMS``, at most 65,535 batch x head rows."""
    b, h, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head_dim in {HEAD_DIMS}, got {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if b * h > 65535 or sq < 1 or k.shape[2] < 1:
        raise ValueError(f"kernel takes B*H <= 65535 and non-empty sequences, got {tuple(q.shape)}")


def _backward_check(q: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                    dmd: torch.Tensor) -> None:
    """What the dq and dk/dv kernels take besides q, k, v: ``do`` like q,
    ``lse`` and ``dmd`` float32 ``[B, H, Sq]``, all contiguous on q's device."""
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must match q {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("dmd", dmd)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {tuple(q.shape[:3])}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if any(t.device != q.device or not t.is_contiguous() for t in (do, lse, dmd)):
        raise ValueError("do, lse and dmd must be contiguous and on q's device")


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (first use builds)."""
    global _lib
    with _lock:
        return _lib if _lib is not None else _load()


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from katib_tpu_torch.ops import _build

        lib = _build.load("flash_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        tail = [i32, i32, i32, i32, ctypes.c_float, i32, i32, ptr]  # bh sq sk d scale causal dtype stream
        lib.katib_flash_fwd.argtypes = [ptr] * 5 + tail
        lib.katib_flash_dq.argtypes = [ptr] * 7 + tail
        lib.katib_flash_dkv.argtypes = [ptr] * 8 + tail
        for fn in (lib.katib_flash_fwd, lib.katib_flash_dq, lib.katib_flash_dkv):
            fn.restype = ctypes.c_int
        lib.katib_flash_error_string.argtypes = [ctypes.c_int]
        lib.katib_flash_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _call(name: str, tensors, q, sk, scale, causal) -> None:
    lib = _library()
    b, h, sq, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(
            *(t.data_ptr() for t in tensors), b * h, sq, sk, d, scale, int(causal),
            _DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        reason = lib.katib_flash_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {reason} ({err})")


def launch_fwd(q, k, v, causal: bool, scale: float):
    """The forward kernel: ``(o, lse)``."""
    global fwd_launches
    kernel_check(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _call("katib_flash_fwd", (q, k, v, o, lse), q, k.shape[2], scale, causal)
    with _lock:
        fwd_launches += 1
    return o, lse


def launch_dq(q, k, v, do, lse, dmd, causal: bool, scale: float):
    """The dq kernel."""
    global dq_launches
    kernel_check(q, k, v)
    _backward_check(q, do, lse, dmd)
    dq = torch.empty_like(q)
    _call("katib_flash_dq", (q, k, v, do, lse, dmd, dq), q, k.shape[2], scale, causal)
    with _lock:
        dq_launches += 1
    return dq


def launch_dkv(q, k, v, do, lse, dmd, causal: bool, scale: float):
    """The dk/dv kernel: ``(dk, dv)``."""
    global dkv_launches
    kernel_check(q, k, v)
    _backward_check(q, do, lse, dmd)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call("katib_flash_dkv", (q, k, v, do, lse, dmd, dk, dv), q, k.shape[2], scale, causal)
    with _lock:
        dkv_launches += 1
    return dk, dv


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda, not {t.device}")
    return t.device.type


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, causal, scale):
        if _device_kind(q) == "cpu":
            return reference_attention_with_lse(q, k, v, causal, scale)
        return launch_fwd(q, k, v, causal, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, scale = inputs
        ctx.save_for_backward(q, k, v, *output)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        # a missing cotangent counts as zeros
        do = torch.zeros_like(o) if do is None else do.to(o.dtype).contiguous()
        dmd = torch.sum(do.float() * o.float(), dim=-1)
        if dlse is not None:
            dmd = dmd - dlse.float()
        args = (q, k, v, do, lse, dmd.contiguous(), ctx.causal, ctx.scale)
        if _device_kind(q) == "cpu":
            dq = reference_attention_dq(*args)
            dk, dv = reference_attention_dkv(*args)
        else:
            dq = launch_dq(*args)
            dk, dv = launch_dkv(*args)
        return dq, dk, dv, None, None


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: float | None = None,
    block_q: int = 128,
    block_k: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused attention over ``[batch, heads, seq, head_dim]`` inputs.

    Returns ``(output, logsumexp)``, both differentiable; output in q's
    dtype, logsumexp float32 ``[batch, heads, seq_q]``.  Rows with every
    key masked give output 0 and logsumexp -1e30.  ``block_q``/``block_k``
    must divide the sequences, as in the JAX package; the CUDA kernels tile
    by 64 rows whatever they are."""
    _check(q, k, v)
    _block_sizes(q.shape[2], k.shape[2], block_q, block_k)
    return _FlashAttention.apply(q, k, v, causal, _scale(q, sm_scale))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Standard entry point: fused attention output only."""
    o, _ = flash_attention_with_lse(q, k, v, causal, sm_scale, block_q, block_k)
    return o
