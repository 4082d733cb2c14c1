"""Softmax-weighted mixed-op contraction: the CUDA kernel and its plain version.

Counterpart of ``katib_tpu/ops/mixed_op.py``.  The DARTS supernet's mixed
op ends in ``out[e] = sum_o weights[e, o] * stacked[e, o]`` over the stacked
primitive outputs of every edge ``e`` of one edge group.  On a CUDA tensor
:func:`mixed_op_sum` launches the hand-written kernel in
``csrc/mixed_op.cu`` (one launch per edge group); on a CPU tensor it
computes :func:`mixed_op_sum_reference`, the same contraction in plain
PyTorch.  There is no other fallback: a CUDA tensor the kernel does not
take raises.

``KATIB_PALLAS_MIXED_OP`` resolves as in the JAX package (:func:`_mode`):
``auto`` and ``pallas`` take the CUDA kernel on a CUDA tensor;
``interpret`` and ``lax`` ask for a non-kernel path, which the port does not
have on CUDA, so they raise there; a CPU tensor takes the plain version
under every valid value; any other value raises ``ValueError``.

The backward pass is plain PyTorch on both devices, as the JAX package's is
(``katib_tpu/ops/mixed_op.py::_bwd``): ``dw`` is a full f32 reduction over
the activation, ``dx`` a rank-1 broadcast, both bound by memory bandwidth.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading

import torch

MAX_OPS = 16
_VALID_MODES = ("auto", "pallas", "interpret", "lax")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since import or the last reset; the CPU path does not count.
# A captured CUDA graph launches without calling the wrapper: its owner adds
# the launches the capture recorded on each replay (nas/darts/step_loop.py)
launches = 0
_lib = None
_lib_lock = threading.Lock()  # replicas of a mesh may make the first call at once
_count_lock = threading.Lock()
# per thread: the tally of a graph capture in progress on that thread
_recording = threading.local()


def count_launches(n: int = 1) -> None:
    """Add ``n`` launches to :data:`launches` (thread-safe).  A launch made
    by a thread inside :func:`recording_launches` is recorded into that
    thread's graph, not run, so it goes to the capture's tally instead.
    Inside :func:`tallying` the thread's tally counts it too."""
    global launches
    tally = getattr(_recording, "tally", None)
    if tally is not None:
        tally[0] += n
        return
    own = getattr(_recording, "own", None)
    if own is not None:
        own[0] += n
    with _count_lock:
        launches += n


@contextlib.contextmanager
def tallying():
    """Also tally, in the yielded one-element list, the launches this thread
    counts inside (a replica of a mesh run counts its own this way);
    :data:`launches` counts them as usual."""
    prev = getattr(_recording, "own", None)
    own = [0]
    _recording.own = own
    try:
        yield own
    finally:
        _recording.own = prev


@contextlib.contextmanager
def recording_launches():
    """Tally the launches this thread makes inside, without counting them:
    for a CUDA graph capture, whose launches run only when it is replayed.
    Yields a one-element list holding the tally.  Launches of other threads
    meanwhile count as usual."""
    tally = [0]
    _recording.tally = tally
    try:
        yield tally
    finally:
        _recording.tally = None


def _mode() -> str:
    """``KATIB_PALLAS_MIXED_OP`` with the JAX package's spellings
    (``katib_tpu/ops/mixed_op.py::_mode``)."""
    raw = os.environ.get("KATIB_PALLAS_MIXED_OP", "auto").strip().lower()
    if raw in ("", "auto"):
        return "auto"
    if raw in ("1", "true", "yes", "on", "pallas"):
        return "pallas"
    if raw == "interpret":
        return "interpret"
    if raw in ("0", "false", "no", "off", "lax"):
        return "lax"
    raise ValueError(
        f"KATIB_PALLAS_MIXED_OP={raw!r} is not one of {_VALID_MODES}"
    )


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
    with _lib_lock:
        return _lib if _lib is not None else _load()


def _load() -> ctypes.CDLL:
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
    count_launches()
    return out


class _MixedOpSum(torch.autograd.Function):
    @staticmethod
    def forward(weights, stacked):
        mode = _mode()
        if stacked.device.type == "cpu":
            return mixed_op_sum_reference(weights, stacked)
        if stacked.device.type != "cuda":
            raise ValueError(f"mixed_op_sum runs on cpu or cuda, not {stacked.device}")
        if mode not in ("auto", "pallas"):
            raise NotImplementedError(
                f"KATIB_PALLAS_MIXED_OP={mode} asks for the mixed op without its "
                "kernel; on CUDA the port has only the kernel (auto or pallas)"
            )
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
