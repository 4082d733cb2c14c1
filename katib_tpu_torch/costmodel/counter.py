"""The port's cost count: the flops and bytes of one eager step.

The JAX package reads a step program's cost from XLA's HLO cost analysis.
The port has no such program, so it counts one step as it runs, once per
step signature, under a ``TorchDispatchMode`` that sees every aten call
below autograd (the backward pass included):

- matrix products and convolutions take ``torch.utils.flop_counter``'s
  formulas (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``convolution`` and its
  backward, grouped convolutions included, the attention calls);
- an elementwise call (``torch.Tag.pointwise``, and the optimizers'
  ``_foreach_*`` calls over their first list) counts one flop per output
  element, a reduction (``torch.Tag.reduction``) one per input element, as
  XLA's cost analysis counts its elementwise and reduce instructions;
- bytes are each call's tensor operands and results, the eager analogue of
  XLA's pre-fusion bytes; a view moves none.

Left at zero flops (their bytes still count): copies (``clone``,
``copy_``, ``_to_copy``) and dtype conversions, ``fill_``, indexing (``index_select``, ``gather``, ``scatter``,
``index_put``, ``index_copy``), padding, concatenation and stacking,
allocation (``empty``, ``zeros``, ``full``, ``*_like``), random draws, the
fused normalization and softmax calls that carry no pointwise or reduction
tag (``native_batch_norm``, ``cudnn_batch_norm`` and their backward,
``native_layer_norm``, ``_softmax``, ``_log_softmax`` and their backward),
pooling (``max_pool2d_with_indices``, ``avg_pool2d`` and their backward),
``nll_loss`` and ``embedding``'s backward.  The batch norm of a mesh
(``nas/darts/norm.py``) runs as SyncBatchNorm's untagged kernels on the
card and as float32 formulas on the CPU; its calls run inside
:func:`as_normalization`, so they count as the fused normalization calls
do, on either device.  Bytes are pre-fusion, so the bandwidth floor they
give is a lower bound on step time and ``max_mfu`` an upper bound.

**The hand-written kernels declare their work.**  A kernel library is a
foreign call (``ctypes``) that writes into a ``torch.empty`` output: a
dispatch mode sees the ``empty`` and nothing of the kernel.  So each
kernel wrapper (``ops/mixed_op.py``, ``ops/flash_attention.py``) runs its
launch, or on the CPU its plain version, inside :func:`kernel_work`, which
adds the kernel's declared ``(flops, bytes)`` once and counts none of the
aten calls inside.  The declared part of a step's count is therefore the
same, to the flop, on the card and on the CPU, and a count keeps it as a
total of its own (``kernel_flops``, ``kernel_bytes``, ``launches``).

**Where a count runs** (``EpochLoop.count_step``, ``StepLoop.count_step``):
one eager step on copies of the state, after the trial's first report,
outside any capture and outside the device's capture lock, on the
thread's leased stream.  The count never synchronizes the device: the
caller's stream and the leased stream wait on each other.  Nothing here
builds on the meta device or under ``FakeTensorMode``.

``hbm_bytes``, the step's device footprint, stays 0, which the record
allows ("not read"): the caching allocator's current figure mixes in the
allocations of every other thread of the process, and its peak needs a
device-wide reset that other trials read.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils.flop_counter import flop_registry

from katib_tpu_torch.costmodel.record import CostRecord

# allocation calls write nothing worth a byte: their result is uninitialised
_NO_DATA = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}
# tagged pointwise, but a copy: no flops
_COPIES = {"clone"}


@dataclass
class StepCount:
    """What one counted step did: totals with the declared kernel work
    included, the declared part on its own, and the count's own cost."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    kernel_flops: float = 0.0
    kernel_bytes: float = 0.0
    launches: dict[str, int] = field(default_factory=dict)  # kernel -> launches
    aten_calls: int = 0  # counted calls (views and declared kernels' insides excluded)
    hbm_bytes: int = 0
    seconds: float = 0.0  # wall seconds the count took

    def record(self, program: str, steps: int = 1, dtype: str = "bf16") -> CostRecord:
        """The :class:`CostRecord` of this count."""
        return CostRecord(program=program, flops=self.flops, bytes_accessed=self.bytes_accessed,
                          hbm_bytes=int(self.hbm_bytes), steps=max(1, int(steps)), dtype=dtype)


def _nbytes(tree) -> int:
    """The bytes of the tensors in an aten call's arguments or result
    (tuples, lists and dicts of them, nested)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return 0
    n = 0
    for x in tree:
        if isinstance(x, torch.Tensor):
            n += x.numel() * x.element_size()  # Tensor.nbytes raises on a sparse tensor
        elif isinstance(x, (list, tuple, dict)):
            n += _nbytes(x)
    return n


def _first(tree) -> torch.Tensor | None:
    """The first tensor of an aten call's arguments or result."""
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, (list, tuple)):
        for x in tree:
            t = _first(x)
            if t is not None:
                return t
    return None


_KIND: dict[Any, tuple] = {}  # OpOverload -> (kind, formula, is_view, no_data)


def _kind(func) -> tuple:
    """How ``func`` is counted: its kind (``shapes`` or ``formula`` with
    flop_counter's formula, taking shapes or the call's own arguments,
    ``foreach``, ``pointwise``, ``reduction`` or ``other``),
    whether it is a view, and whether its result is uninitialised."""
    got = _KIND.get(func)
    if got is None:
        packet = func.overloadpacket
        tags = getattr(func, "tags", ())
        if packet in flop_registry:
            formula = flop_registry[packet]
            # the formula without flop_counter's pytree walk over the call
            # (its shape wrapper): _flops passes the shapes itself
            wrapped = getattr(formula, "__wrapped__", None)
            kind = ("shapes", wrapped) if wrapped is not None else ("formula", formula)
        elif packet.__name__.startswith("_foreach_") and packet.__name__ != "_foreach_copy_":
            kind = ("foreach", None)
        elif torch.Tag.pointwise in tags and packet.__name__ not in _COPIES:
            kind = ("pointwise", None)
        elif torch.Tag.reduction in tags:
            kind = ("reduction", None)
        else:
            kind = ("other", None)
        view = bool(getattr(func, "is_view", False))
        got = _KIND[func] = (*kind, view, packet.__name__ in _NO_DATA)
    return got


def _shape(x):
    """What flop_counter's shape wrapper passes a formula for ``x``: a
    tensor's shape, a list of tensors' shapes, anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.shape
    if isinstance(x, (list, tuple)):
        return type(x)(_shape(i) for i in x)
    return x


def _flops(kind, formula, args, kwargs, out) -> int:
    if kind == "shapes":
        return int(formula(*map(_shape, args), out_shape=_shape(out),
                           **{k: _shape(v) for k, v in kwargs.items()}))
    if kind == "formula":
        return int(formula(*args, **kwargs, out_val=out))
    if kind == "pointwise":
        t = _first(out)
        return t.numel() if t is not None else 0
    if kind == "foreach":  # elementwise over a list: one flop per element of it
        return sum(t.numel() for t in args[0] if isinstance(t, torch.Tensor))
    if kind == "reduction":
        t = _first(args)
        return t.numel() if t is not None else 0
    return 0


class _CountingMode(TorchDispatchMode):
    """Counts every aten call it sees, except inside :func:`kernel_work`.
    The backward of a CUDA step runs on autograd's device thread, which
    inherits the mode: the tallies are guarded by a lock, and suspension is
    kept per thread."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # PyTorch wraps a mode's __torch_dispatch__ in a Dynamo guard whose
        # first call imports torch._dynamo and sympy (seconds, on a trial's
        # thread); no count ever runs under torch.compile, so no guard
        return False

    def __init__(self):
        super().__init__()
        self.count = StepCount()
        self._lock = threading.Lock()
        self._suspended: dict[int, int] = {}
        self._no_flops: dict[int, int] = {}

    # -- suspension and declared work --------------------------------------

    def declare(self, name: str, flops: int, nbytes: int) -> None:
        with self._lock:
            c = self.count
            c.kernel_flops += flops
            c.kernel_bytes += nbytes
            c.flops += flops
            c.bytes_accessed += nbytes
            c.launches[name] = c.launches.get(name, 0) + 1

    @contextlib.contextmanager
    def _holding(self, holds: dict):
        tid = threading.get_ident()
        with self._lock:
            holds[tid] = holds.get(tid, 0) + 1
        try:
            yield
        finally:
            with self._lock:
                holds[tid] -= 1
                if not holds[tid]:
                    del holds[tid]

    def suspended(self):
        return self._holding(self._suspended)

    def without_flops(self):
        return self._holding(self._no_flops)

    # -- the count ---------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **kwargs) if kwargs else func(*args)
        kind, formula, view, no_data = _KIND.get(func) or _kind(func)
        if view or self._suspended and self._suspended.get(threading.get_ident()):
            return out
        flops = _flops(kind, formula, args, kwargs or {}, out) if kind != "other" else 0
        if flops and self._no_flops and self._no_flops.get(threading.get_ident()):
            flops = 0
        nbytes = 0 if no_data else _nbytes(args) + _nbytes(out) + (_nbytes(kwargs) if kwargs else 0)
        with self._lock:
            c = self.count
            c.flops += flops
            c.bytes_accessed += nbytes
            c.aten_calls += 1
        return out


def _active_mode() -> _CountingMode | None:
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, _CountingMode):
            return mode
    return None


def counting() -> bool:
    """True when a count is active on this thread."""
    return _active_mode() is not None


@contextlib.contextmanager
def kernel_work(name: str, work: Callable[[], tuple[int, int]]):
    """Around one launch of the hand-written kernel ``name`` (or its plain
    version on the CPU): while a count is active, add the kernel's declared
    ``work() -> (flops, bytes)`` once, and count none of the aten calls
    inside.  Outside a count it does nothing."""
    mode = _active_mode()
    if mode is None:
        yield
        return
    flops, nbytes = work()
    mode.declare(name, int(flops), int(nbytes))
    with mode.suspended():
        yield


@contextlib.contextmanager
def as_normalization():
    """Around the calls of a normalization that PyTorch has as no one fused
    call (the mesh's batch norm): while a count is active, they count their
    bytes and no flops, as ``native_batch_norm`` and its backward do.
    Outside a count it does nothing."""
    mode = _active_mode()
    if mode is None:
        yield
        return
    with mode.without_flops():
        yield


def count_step(step: Callable[[Any], Any], make_args: Callable[[], Any],
               device: torch.device, stream: "torch.cuda.Stream | None" = None) -> StepCount:
    """Count ``step(make_args())`` once.

    ``make_args`` builds the step's inputs (copies of the state) before the
    count starts.  On a CUDA ``device``
    both run on ``stream`` (the thread's leased stream) after it waits for
    the caller's stream, and the caller's stream waits for it after: no
    host synchronization.  The caller keeps the count outside any capture
    and outside the device's capture lock."""
    device = torch.device(device)
    mode = _CountingMode()
    t0 = time.perf_counter()
    cuda = device.type == "cuda"
    if cuda and stream is not None:
        stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream) if cuda and stream is not None else contextlib.nullcontext():
        args = make_args()
        with mode:
            step(args)
        del args
    if cuda and stream is not None:
        torch.cuda.current_stream(device).wait_stream(stream)
    count = mode.count
    count.seconds = time.perf_counter() - t0
    return count

