"""Softmax-weighted mixed-op contraction: the CUDA kernel and its plain version.

Counterpart of ``katib_tpu/ops/mixed_op.py``.  The DARTS supernet's mixed
op ends in ``out[e] = sum_o weights[e, o] * stacked[e, o]`` over the stacked
primitive outputs of every edge ``e`` of one edge group.  On a CUDA tensor
:func:`mixed_op_sum` launches the hand-written kernel in
``csrc/mixed_op.cu`` (one launch per edge group); on a CPU tensor it
computes :func:`mixed_op_sum_reference`, the same contraction in plain
PyTorch.  There is no other fallback: a CUDA tensor the kernel does not
take raises.

The backward pass is plain PyTorch on both devices, as the JAX package's is
(``katib_tpu/ops/mixed_op.py::_bwd``): ``dw`` is a full f32 reduction over
the activation, ``dx`` a rank-1 broadcast, both bound by memory bandwidth.
"""

from __future__ import annotations

import ctypes

import torch

MAX_OPS = 16
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since import or the last reset; the CPU path does not count
launches = 0
_lib = None


def mixed_op_sum_reference(weights: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    """``(E, n_ops)`` f32 weights x ``(E, n_ops, M)`` stacked -> ``(E, M)``.

    f32 weights and f32 accumulation, cast to the activation dtype: the
    Pallas kernel's semantics (the JAX ``_lax_reference`` casts the weights
    to the activation dtype instead; the two agree in f32)."""
    return torch.einsum("eo,eom->em", weights.float(), stacked.float()).to(stacked.dtype)


def _check(weights: torch.Tensor, stacked: torch.Tensor) -> None:
    if weights.device != stacked.device:
        raise ValueError(
            f"weights on {weights.device} but stacked on {stacked.device}"
        )
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, got {weights.dtype}")
    if stacked.dtype not in _DTYPE_CODES:
        raise TypeError(f"stacked must be float32 or bfloat16, got {stacked.dtype}")
    if stacked.dim() != 3 or weights.dim() != 2 or weights.shape != stacked.shape[:2]:
        raise ValueError(
            f"expected weights (E, n_ops) and stacked (E, n_ops, M), got "
            f"{tuple(weights.shape)} and {tuple(stacked.shape)}"
        )
    e, n_ops, m = stacked.shape
    if not (1 <= n_ops <= MAX_OPS and 1 <= e <= 65535 and m >= 1):
        raise ValueError(
            f"kernel takes 1 <= n_ops <= {MAX_OPS}, 1 <= E <= 65535, M >= 1; "
            f"got E={e}, n_ops={n_ops}, M={m}"
        )
    if not (weights.is_contiguous() and stacked.is_contiguous()):
        raise ValueError("weights and stacked must be contiguous")


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (first use builds)."""
    global _lib
    if _lib is None:
        from katib_tpu_torch.ops import _build

        lib = _build.load("mixed_op")
        lib.katib_mixed_op_sum.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.katib_mixed_op_sum.restype = ctypes.c_int
        lib.katib_cuda_error_string.argtypes = [ctypes.c_int]
        lib.katib_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(weights: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    global launches
    lib = _library()
    e, n_ops, m = stacked.shape
    out = torch.empty((e, m), dtype=stacked.dtype, device=stacked.device)
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.katib_mixed_op_sum(
            weights.data_ptr(), stacked.data_ptr(), out.data_ptr(), e, n_ops, m,
            _DTYPE_CODES[stacked.dtype], stream,
        )
    if err != 0:
        reason = lib.katib_cuda_error_string(err).decode()
        raise RuntimeError(f"mixed_op kernel launch failed: {reason} ({err})")
    launches += 1
    return out


class _MixedOpSum(torch.autograd.Function):
    @staticmethod
    def forward(weights, stacked):
        if stacked.device.type == "cpu":
            return mixed_op_sum_reference(weights, stacked)
        if stacked.device.type != "cuda":
            raise ValueError(f"mixed_op_sum runs on cpu or cuda, not {stacked.device}")
        return _launch(weights, stacked)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        weights, stacked = ctx.saved_tensors
        dw = dx = None
        if ctx.needs_input_grad[0]:
            dw = torch.einsum("eom,em->eo", stacked.float(), g.float())
        if ctx.needs_input_grad[1]:
            dx = (weights.to(g.dtype)[:, :, None] * g[:, None, :]).to(stacked.dtype)
        return dw, dx


def mixed_op_sum(weights: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    """``sum_o weights[e, o] * stacked[e, o]`` for each edge ``e``.

    ``weights``: ``(E, n_ops)`` float32, the softmax over each edge's alphas.
    ``stacked``: ``(E, n_ops, M)`` contiguous, float32 or bfloat16.
    Returns ``(E, M)`` in ``stacked``'s dtype.  Differentiable in both."""
    _check(weights, stacked)
    return _MixedOpSum.apply(weights, stacked)
