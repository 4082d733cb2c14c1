"""Roofline cost model: counted step costs and live MFU telemetry (port of
``katib_tpu/costmodel/``).

- :mod:`peaks`: peak flops and device-memory bandwidth by device kind (the
  MFU denominator): an ``h100`` row from the NVIDIA H100 SXM5 80GB
  datasheet and the JAX package's nominal ``cpu`` row, with the
  ``KATIB_PEAK_FLOPS`` / ``KATIB_PEAK_BW`` overrides; an unknown device
  raises :class:`UnknownDevicePeaks`.
- :mod:`record`: :class:`CostRecord`, the JAX record's fields and
  roofline arithmetic.
- :mod:`counter`: the port's count of one eager step (aten calls under a
  dispatch mode, plus the work each hand-written kernel declares), where
  the JAX package asks XLA's cost analysis.
- :mod:`live`: the ambient per-thread cost slot; the runner, cohort and
  DARTS epoch seams publish ``katib_dispatch_mfu`` /
  ``katib_arithmetic_intensity`` / ``katib_roofline_headroom`` against the
  measured step time.

Cost records persist at the compile-signature seam: the shape registry
(``compile/registry.py``) merges each program's cost into its signature
row in ``<cache>/torch/shape_registry.jsonl``, so ``python -m
katib_tpu_torch cost`` prints the roofline table of a finished sweep.

- :mod:`profiler`: on-demand ``torch.profiler`` captures into Chrome
  traces and their registry (``enable_profiler`` trials, the ``profile``
  verb, the dashboard's ``/api/status``).

Not ported here: ``costmodel/aot.py``, a deviceless XLA compile for a TPU
topology, has no counterpart (the port has no ahead-of-time program to
compile), nor have the JAX extraction helpers (``cost_of_lowered``,
``cost_of_compiled``, ``extract_cost``), which the counter replaces.
"""

from __future__ import annotations

from katib_tpu_torch.costmodel.live import (
    active_cost,
    clear_active,
    observe_program,
    publish_dispatch,
    set_active_cost,
    span_attrs,
)
from katib_tpu_torch.costmodel.peaks import (
    DevicePeaks,
    UnknownDevicePeaks,
    detect_device_kind,
    normalize_device_kind,
    peaks_for,
)
from katib_tpu_torch.costmodel.record import CostRecord

__all__ = [
    "CostRecord",
    "DevicePeaks",
    "UnknownDevicePeaks",
    "active_cost",
    "clear_active",
    "detect_device_kind",
    "normalize_device_kind",
    "observe_program",
    "peaks_for",
    "publish_dispatch",
    "set_active_cost",
    "span_attrs",
]
