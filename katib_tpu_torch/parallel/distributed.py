"""Process-group initialization and per-trial slice leasing (port of
``katib_tpu/parallel/distributed.py``).

- :func:`initialize_distributed`: the port is single-controller, one process
  driving every local device (``parallel/collectives.py``), so a single
  process is a no-op; a multi-process group (``NUM_PROCESSES`` > 1) is
  multi-host, which is not ported yet.
- :class:`SliceAllocator` partitions a device list into fixed-size shares
  and leases one per trial, so ``parallelTrialCount`` concurrent trials
  each get a disjoint sub-mesh.  A share is a set of *positions* of the
  list, so an allocator over a list that repeats a device (several shares
  of one card, or CPU entries) still leases disjoint shares.

The elastic allocator (:class:`ElasticSliceAllocator`) goes with the trial
axis and raises (ROADMAP item 9b).
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

from katib_tpu_torch.core.types import DEVICES_LABEL  # noqa: F401 - the lease-size label
from katib_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh, visible_gpus


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: Sequence[int] | None = None,
) -> bool:
    """The JAX package's process-group bring-up, for the port's single
    controller.  Explicit args win; otherwise ``COORDINATOR_ADDRESS`` /
    ``NUM_PROCESSES`` / ``PROCESS_ID``.  One process (the common case) is a
    no-op and returns False; a group of more raises ``NotImplementedError``
    (multi-host is ROADMAP item 9b)."""
    del process_id, local_device_ids
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if coordinator_address is None or not num_processes or num_processes <= 1:
        return False
    raise NotImplementedError(
        f"a process group of {num_processes} processes at {coordinator_address} is "
        "multi-host, not ported yet (ROADMAP item 9b); one process drives every local GPU"
    )


# -- topology presets --------------------------------------------------------

#: chips per named TPU slice topology (the JAX package's presets, which the
#: port keeps so the same configuration names resolve in both packages)
SLICE_TOPOLOGIES: dict[str, int] = {
    "v5e-1": 1,
    "v5e-4": 4,
    "v5e-8": 8,
    "v5e-16": 16,
    "v5e-32": 32,
    "v5e-64": 64,
    "v5e-128": 128,
    "v5e-256": 256,
}


def topology_size(topology: str) -> int:
    if topology not in SLICE_TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r}; known: {sorted(SLICE_TOPOLOGIES)}")
    return SLICE_TOPOLOGIES[topology]


# -- per-trial slice leasing -------------------------------------------------


@dataclass
class SliceLease:
    """A leased share of the device list: ``positions`` in the allocator's
    list, ``devices`` at them; build the trial's mesh from it."""

    index: int
    devices: tuple
    axes: Mapping[str, int]
    positions: tuple = ()

    def mesh(self):
        return make_mesh(dict(self.axes), devices=self.devices)


def _default_devices(devices: Sequence[Any] | None) -> tuple:
    if devices is None:
        devices = visible_gpus()
        if not devices:
            raise RuntimeError("no CUDA GPU is visible; pass devices= to lease CPU entries")
    return tuple(devices)


class _MeshLeaseMixin:
    """Shared lease -> mesh -> release context manager."""

    @contextmanager
    def slice_mesh(self, *args, **kwargs):
        """``with allocator.slice_mesh(...) as mesh:`` lease, build, release;
        arguments pass through to ``lease``."""
        lease = self.lease(*args, **kwargs)
        try:
            yield lease.mesh()
        finally:
            self.release(lease)


class SliceAllocator(_MeshLeaseMixin):
    """Partition a device list into equal shares; lease one per trial.

    ``axes`` is the per-trial mesh template (one axis may be -1 to absorb
    the share size), e.g. ``{"data": -1}`` or ``{"data": 2, "model": 2}``.
    ``lease()`` blocks until a share frees up.  ``devices`` defaults to the
    visible GPUs."""

    def __init__(self, slice_size: int, *, devices: Sequence[Any] | None = None,
                 axes: Mapping[str, int] | None = None):
        devices = _default_devices(devices)
        if slice_size <= 0:
            raise ValueError("slice_size must be positive")
        if len(devices) < slice_size:
            raise ValueError(f"need at least {slice_size} devices, have {len(devices)}")
        self.slice_size = slice_size
        self.axes = dict(axes) if axes else {DATA_AXIS: -1}
        n_slices = len(devices) // slice_size
        self._free: list[SliceLease] = [
            SliceLease(
                index=i,
                devices=tuple(devices[i * slice_size:(i + 1) * slice_size]),
                axes=self.axes,
                positions=tuple(range(i * slice_size, (i + 1) * slice_size)),
            )
            for i in range(n_slices)
        ]
        self._cond = threading.Condition()
        self.n_slices = n_slices

    def available(self) -> int:
        with self._cond:
            return len(self._free)

    def lease(self, timeout: float | None = None) -> SliceLease:
        with self._cond:
            if not self._cond.wait_for(lambda: self._free, timeout=timeout):
                raise TimeoutError(f"no free slice within {timeout}s ({self.n_slices} total)")
            return self._free.pop()

    def release(self, lease: SliceLease) -> None:
        with self._cond:
            if any(free.index == lease.index for free in self._free):
                raise ValueError(f"slice {lease.index} is not leased")
            self._free.append(lease)
            self._cond.notify()


class ElasticSliceAllocator(_MeshLeaseMixin):
    """The JAX package's variable-size allocator (a lease of the number of
    devices a trial's ``DEVICES_LABEL`` asks for).  It goes with the trial
    axis and is not ported yet: building one raises."""

    def __init__(self, devices: Sequence[Any] | None = None, *, axes=None):
        raise NotImplementedError(
            "ElasticSliceAllocator (leases sized by the devices label, elastic cohorts) "
            "is not ported yet (ROADMAP item 9b); SliceAllocator leases fixed shares"
        )
