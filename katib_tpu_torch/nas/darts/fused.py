"""Fused evaluation of the four depthwise-separable DARTS primitives (port
of ``katib_tpu/nas/darts/fused.py``).

The four conv primitives (separable 3x3/5x5, two reps each; dilated
3x3/5x5, one rep at dilation 2) all read the same input, and every
branch's taps fit a centred 9x9 window:

==========================  =======  ========  =========================
branch                      kernel   dilation  taps inside the 9x9 grid
==========================  =======  ========  =========================
separable_convolution_3x3   3x3      1         rows/cols {3,4,5}
separable_convolution_5x5   5x5      1         rows/cols {2..6}
dilated_convolution_3x3     3x3      2         rows/cols {2,4,6}
dilated_convolution_5x5     5x5      2         rows/cols {0,2,4,6,8}
==========================  =======  ========  =========================

Activations are NCHW, as in ``ops/depthwise.py``.

- **Stage A** runs the four first reps as ONE ``F.conv2d`` with
  ``groups=C`` and a ``(4C, 1, 9, 9)`` weight: output channel ``c*4+b`` is
  branch ``b`` of input channel ``c`` (the JAX layout).  Then ONE batched
  pointwise product ``(N, B, C, H, W) x (B, C, F)`` (``torch.matmul``; JAX
  computes it as an ``einsum``) and a training-mode batch norm per
  (branch, channel).
- **Stage B** runs the separable branches' second rep as ONE ``groups=2C``
  5x5 convolution over the two branches' slices, a ``(2, C, F)`` batched
  pointwise and the batch norm.

The input is padded with :func:`~katib_tpu_torch.ops.depthwise.pad_same`
for the 9x9 (or 5x5) window and convolved VALID: at stride 2 on an even
size XLA's SAME pads ``(3, 4)``, which a symmetric ``padding=`` would not
reproduce, and with that pad every branch reads exactly the offsets its own
SAME-padded convolution reads.

The parameters are the unmerged ones: each depthwise kernel keeps its
``(k, k, 1, C)`` shape and lecun-normal fan-in ``k*k``; ``pw_0`` is
``(4, C, C)`` and ``pw_1`` ``(2, C, C)``, lecun-normal with fan-in ``C``
per branch.  The masked kernels are built from them on every forward by
dilating (zero rows and columns between taps), padding and stacking: no
scatter or ``index_add``, so the weight gradient is a plain slice and sum,
and nothing reads a host value (the step captures in a CUDA graph).  The
fusion is an evaluation-plan change, not a model change.

The batch norms are ``norm.py::batch_norm``, so on a mesh whose data axis
splits the batch they normalize over the global batch, as the unfused
plan's do.  ``safe=True`` (the JAX package's setting for a mesh with a
model axis, which picks its shift-MAC depthwise form there) is accepted and
changes nothing: the port's depthwise convolution has one form
(``ops/depthwise.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from katib_tpu_torch.nas.darts.norm import batch_norm
from katib_tpu_torch.ops.depthwise import lecun_normal_, pad_same

# (name, kernel, dilation, has_second_rep) in fixed branch order
BRANCH_SPECS = (
    ("separable_convolution_3x3", 3, 1, True),
    ("separable_convolution_5x5", 5, 1, True),
    ("dilated_convolution_3x3", 3, 2, False),
    ("dilated_convolution_5x5", 5, 2, False),
)
FUSED_PRIMITIVES = tuple(s[0] for s in BRANCH_SPECS)


def _taps(kernel: int, dilation: int, window: int) -> list[int]:
    """Row/col offsets of a centred k x k (dilation d) kernel inside the
    fused window."""
    extent = (kernel - 1) * dilation + 1
    base = (window - extent) // 2
    return [base + i * dilation for i in range(kernel)]


def _window_kernel(kern: torch.Tensor, dilation: int, window: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """A ``(k, k, 1, C)`` kernel as its ``(C, 1, window, window)`` masked
    form: tap ``(i, j)`` at ``_taps(k, d, window)[i], [j]``, zeros
    elsewhere."""
    w = kern.to(dtype).permute(3, 2, 0, 1)  # (C, 1, k, k)
    c, k = w.shape[0], w.shape[2]
    if dilation > 1:
        # d - 1 zero rows after each tap row, then the same for columns;
        # the trailing zeros past the last tap are cut off
        extent = (k - 1) * dilation + 1
        zeros = [torch.zeros_like(w)] * (dilation - 1)
        w = torch.stack([w, *zeros], dim=3).reshape(c, 1, k * dilation, k)[:, :, :extent]
        zeros = [torch.zeros_like(w)] * (dilation - 1)
        w = torch.stack([w, *zeros], dim=4).reshape(c, 1, extent, k * dilation)[..., :extent]
    lo = _taps(k, dilation, window)[0]
    hi = window - w.shape[2] - lo
    return F.pad(w, (lo, hi, lo, hi))


class _MaskedDepthwise(nn.Module):
    """Masked-window depthwise conv evaluating B branches in one launch.

    ``specs``: ``((param_name, kernel, dilation), ...)``, one branch each.
    ``shared_input=True``: input ``(N, C, H, W)``, every branch convolves
    the same C channels (channel multiplier B).  ``shared_input=False``:
    input ``(N, B, C, H, W)``, branch b convolves its own slice
    (multiplier 1 over the B*C channels).  Output ``(N, B, C, H', W')``
    either way."""

    def __init__(self, specs, channels: int, window: int, stride: int = 1,
                 shared_input: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.specs, self.window, self.stride = tuple(specs), window, stride
        self.shared_input, self.dtype = shared_input, dtype
        for name, k, _ in self.specs:
            self.register_parameter(name, nn.Parameter(torch.empty(k, k, 1, channels)))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        for name, k, _ in self.specs:
            lecun_normal_(getattr(self, name), k * k, generator)

    def merged_kernel(self) -> torch.Tensor:
        """The grouped convolution's weight: ``(C*B, 1, win, win)`` channel
        ``c*B+b`` for a shared input, ``(B*C, 1, win, win)`` channel
        ``b*C+c`` for a sliced one."""
        kerns = [_window_kernel(getattr(self, name), d, self.window, self.dtype)
                 for name, _, d in self.specs]
        c = kerns[0].shape[0]
        if self.shared_input:
            return torch.stack(kerns, dim=1).reshape(c * len(kerns), 1, self.window, self.window)
        return torch.cat(kerns, dim=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nb = len(self.specs)
        if not self.shared_input:
            x = x.flatten(1, 2)  # (N, B*C, H, W), branch-major
        x = pad_same(x.to(self.dtype), self.window, self.stride)
        out = F.conv2d(x, self.merged_kernel(), stride=self.stride, groups=x.shape[1])
        n, _, h, w = out.shape
        if self.shared_input:
            return out.view(n, -1, nb, h, w).transpose(1, 2)
        return out.view(n, nb, -1, h, w)


def _grouped_pointwise(y: torch.Tensor, kern: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Per-branch 1x1 convs as ONE batched product:
    ``(N, B, C, H, W) x (B, C, F) -> (N, B, F, H, W)``."""
    n, b, c, h, w = y.shape
    out = torch.matmul(kern.to(dtype).transpose(1, 2), y.to(dtype).reshape(n, b, c, h * w))
    return out.view(n, b, -1, h, w)


def _branch_norm(y: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Training-mode BN per (branch, channel): the statistics of each
    unmerged branch's own batch norm (over N, H, W, the global batch on a
    mesh)."""
    n, b, c, h, w = y.shape
    return batch_norm(y.reshape(n, b * c, h, w), eps=eps).view(n, b, c, h, w)


class FusedSepDil(nn.Module):
    """All four depthwise-separable primitives of one mixed op, fused.

    ``forward`` returns ``{primitive: (N, C, H', W')}``, the same function
    (up to rounding) as ``SepConv``/``DilConv`` on the same parameters.
    Children and parameters carry the flax names (``_MaskedDepthwise_0``
    holding ``dw_<primitive>_0``, ``_MaskedDepthwise_1`` holding
    ``dw_<primitive>_1`` of the separable branches, ``pw_0``, ``pw_1``)."""

    def __init__(self, channels: int, stride: int, dtype: torch.dtype = torch.bfloat16,
                 safe: bool = False):
        super().__init__()
        del safe  # one depthwise form (the module doc)
        self.dtype = dtype
        self.stage_a = _MaskedDepthwise(
            tuple((f"dw_{n}_0", k, d) for n, k, d, _ in BRANCH_SPECS), channels,
            window=9, stride=stride, shared_input=True, dtype=dtype)
        self.stage_b = _MaskedDepthwise(
            tuple((f"dw_{n}_1", k, d) for n, k, d, second in BRANCH_SPECS if second),
            channels, window=5, stride=1, shared_input=False, dtype=dtype)
        self.pw_0 = nn.Parameter(torch.empty(len(BRANCH_SPECS), channels, channels))
        self.pw_1 = nn.Parameter(torch.empty(len(self.stage_b.specs), channels, channels))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        # fan-in C per branch (flax lecun_normal(batch_axis=0)), not B*C
        for p in (self.pw_0, self.pw_1):
            lecun_normal_(p, p.shape[1], generator)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        y = self.stage_a(F.relu(x))
        y = _branch_norm(_grouped_pointwise(y, self.pw_0, self.dtype))
        z = self.stage_b(F.relu(y[:, :2]))
        z = _branch_norm(_grouped_pointwise(z, self.pw_1, self.dtype))
        return {
            "separable_convolution_3x3": z[:, 0],
            "separable_convolution_5x5": z[:, 1],
            "dilated_convolution_3x3": y[:, 2],
            "dilated_convolution_5x5": y[:, 3],
        }
