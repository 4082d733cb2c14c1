"""Device meshes, placements and sharding helpers (port of
``katib_tpu/parallel/mesh.py``).

One controller drives every device of a mesh, as the JAX package's single
process does: a :class:`Mesh` is a named grid of ``torch.device`` entries,
and each entry runs one replica of the trial's step on a thread of its own
(``parallel/collectives.py``).  The axes keep the JAX names and order:

- ``data``    — the batch dimension: each replica takes a contiguous chunk
- ``model``   — replicas along it hold the same chunk (the JAX package's
  partitioner replicates the DARTS step over it)
- ``seq``     — sequence parallelism (``parallel/ring_attention.py``)
- ``trial``   — the cohort member axis: a stacked ``[K, ...]`` cohort splits
  its member dimension over it (``parallel/train.py::make_cohort_train_step``)

:func:`make_mesh` without devices takes distinct visible GPUs and raises
when there are too few.  A grid may name one device more than once (several
replicas on one card, or CPU entries in the tests) when the caller passes
those devices: such entries share the device's memory and need no transfer.

Placements are descriptors (:class:`Placement`): :func:`shard_batch`,
:func:`replicate` and :func:`shard_members` return :class:`Sharded` values
that hold one piece per grid entry, on that entry's device.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Mapping, NamedTuple, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_map

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
TRIAL_AXIS = "trial"


def _as_device(d: Any) -> torch.device:
    dev = d if isinstance(d, torch.device) else torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A named grid of devices: ``devices`` an object array of
    ``torch.device`` shaped by the axes, ``shape`` the axis sizes in order
    (as ``jax.sharding.Mesh.shape``).  Entry ``r`` is the ``r``-th device of
    the grid in row-major order; entry 0 is the home of the state."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.entries: tuple[torch.device, ...] = tuple(devices.flat)
        self.size = len(self.entries)
        self.home = self.entries[0]
        self._runner = None
        self._runner_lock = threading.Lock()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.entries]})"

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, index: int, axis: str) -> int:
        """Entry ``index``'s position along ``axis`` (0 when absent)."""
        if axis not in self.shape:
            return 0
        return int(np.unravel_index(index, self.devices.shape)[self.axis_names.index(axis)])

    def groups(self, axes: Sequence[str] | str) -> list[list[int]]:
        """The entries partitioned by their coordinates off ``axes``: each
        group varies only along ``axes`` and lists its entries in row-major
        order (for one axis, by the coordinate along it)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        ids = np.arange(self.size).reshape(self.devices.shape)
        keep = [i for i, n in enumerate(self.axis_names) if n in axes]
        rest = [i for i, n in enumerate(self.axis_names) if n not in axes]
        moved = np.transpose(ids, rest + keep)
        return [list(map(int, g)) for g in moved.reshape(-1, int(np.prod(
            [self.devices.shape[i] for i in keep], dtype=np.int64)))]

    @property
    def distinct_devices(self) -> list[torch.device]:
        return list(dict.fromkeys(self.entries))

    @property
    def route(self) -> str:
        """How tensors move between the replicas: ``"shared device"`` when
        every entry names one device (no transfer), else ``"peer copies"``
        between distinct devices."""
        return "shared device" if len(self.distinct_devices) == 1 else "peer copies"

    def runner(self):
        """The mesh's replica runner (``collectives.ReplicaRunner``), made on
        first use: its threads and its leased streams live with the mesh."""
        with self._runner_lock:
            if self._runner is None:
                from katib_tpu_torch.parallel.collectives import ReplicaRunner

                self._runner = ReplicaRunner(self)
            return self._runner

    def run(self, fn) -> list:
        """``[fn(0), ..., fn(size - 1)]``, each on its entry's thread, device
        and stream (``collectives.ReplicaRunner.run``)."""
        return self.runner().run(fn)

    def on_streams(self):
        """Run the caller's own work on the mesh's leased streams
        (``collectives.ReplicaRunner.on_streams``)."""
        return self.runner().on_streams()


def visible_gpus() -> list[torch.device]:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    axis_sizes: Mapping[str, int] | None = None,
    devices: Sequence[Any] | None = None,
) -> Mesh:
    """Build a mesh over ``devices``.

    ``axis_sizes`` maps axis name -> size; one axis may be -1 to absorb the
    remaining devices.  Default: a 1-D data mesh over every device.  Without
    ``devices`` the mesh takes the first distinct visible GPUs (all of them
    when an axis is -1) and raises when there are fewer than the axes ask
    for; it never goes on on the CPU.  Given ``devices``, their count must
    match the axes, as in the JAX package, and they may repeat."""
    if devices is None:
        gpus = visible_gpus()
        sizes = list((axis_sizes or {}).values())
        want = math.prod(s for s in sizes if s != -1) if sizes else len(gpus)
        if -1 in sizes:
            want = len(gpus) - len(gpus) % max(want, 1)
        if not gpus or len(gpus) < max(want, 1):
            raise RuntimeError(
                f"mesh {dict(axis_sizes or {})} asks for {max(want, 1)} GPUs and "
                f"{len(gpus)} are visible; pass devices= to build a grid that "
                "repeats a device"
            )
        devices = gpus[:want]
    devs = [_as_device(d) for d in devices]
    n = len(devs)
    if axis_sizes is None:
        axis_sizes = {DATA_AXIS: n}
    names = tuple(axis_sizes)
    sizes = list(axis_sizes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(sizes), names)


# -- placements ---------------------------------------------------------------


class Placement(NamedTuple):
    """Where a value lives on a mesh: ``axis`` splits its leading dimension
    in contiguous chunks (``None`` replicates it on every entry)."""

    mesh: Mesh
    axis: str | None


def data_sharding(mesh: Mesh, *, extra_dims: int = 1) -> Placement:
    """A batch: leading dim split over ``data``, the rest replicated."""
    del extra_dims  # every dimension after the first is replicated
    return Placement(mesh, DATA_AXIS)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, None)


def trial_sharding(mesh: Mesh) -> Placement:
    """A stacked ``[K, ...]`` cohort pytree: the member dimension split over
    ``trial``, everything else replicated."""
    return Placement(mesh, TRIAL_AXIS)


class Sharded:
    """A global value held as one piece per grid entry (entry order): the
    chunk of its leading dimension that the entry's coordinate along
    ``placement.axis`` selects, or the whole value when replicated."""

    def __init__(self, pieces: Sequence[torch.Tensor], placement: Placement):
        self.pieces = tuple(pieces)
        self.placement = placement

    @property
    def mesh(self) -> Mesh:
        return self.placement.mesh

    def __repr__(self) -> str:
        return f"Sharded(axis={self.placement.axis}, shape={tuple(self.shape)})"

    @property
    def shape(self) -> torch.Size:
        first = self.pieces[0].shape
        n = self.mesh.axis_size(self.placement.axis) if self.placement.axis else 1
        return torch.Size((first[0] * n, *first[1:])) if self.placement.axis else first

    def full(self) -> torch.Tensor:
        """The global value on the home device."""
        mesh, axis = self.mesh, self.placement.axis
        if axis is None or mesh.axis_size(axis) == 1:
            return self.pieces[0].to(mesh.home)
        return torch.cat([self.pieces[g[0]].to(mesh.home)
                          for g in zip(*mesh.groups(axis))], dim=0)


def _split_leading(x, mesh: Mesh, axis: str | None) -> Sharded:
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    n = mesh.axis_size(axis) if axis else 1
    if t.dim() == 0 and n > 1:
        raise ValueError("a 0-d value cannot split over an axis")
    if n > 1 and t.shape[0] % n:
        raise ValueError(f"leading dim {t.shape[0]} does not divide by the {axis} axis ({n})")
    chunks = t.chunk(n, dim=0) if n > 1 else (t,)
    pieces = [chunks[mesh.coord(r, axis) if axis else 0].to(mesh.entries[r])
              for r in range(mesh.size)]
    return Sharded(pieces, Placement(mesh, axis if n > 1 else None))


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def shard_batch(batch, mesh: Mesh):
    """Place a pytree of arrays with leading batch dims onto the mesh's data
    axis: entry ``r`` gets the contiguous chunk of its ``data`` coordinate,
    as ``PartitionSpec(DATA_AXIS)`` gives it.  The batch must divide by the
    data-axis size (callers pad); a mesh without a data axis hands every
    entry the whole batch."""
    return tree_map(lambda x: _split_leading(x, mesh, DATA_AXIS) if _is_leaf(x) else x, batch)


def on_data_axis(batch, mesh: Mesh):
    """``batch`` (a tensor or a tuple/list of them) placed on ``mesh``'s data
    axis by :func:`shard_batch`, unless it is placed already."""
    first = next(iter(batch)) if isinstance(batch, (tuple, list)) else batch
    return batch if isinstance(first, Sharded) else shard_batch(batch, mesh)


def replicate(tree, mesh: Mesh):
    """Replicate a pytree (parameters, opt state) on every entry; entries
    that repeat a device share one tensor."""
    return tree_map(lambda x: _split_leading(x, mesh, None) if _is_leaf(x) else x, tree)


def local_mesh_size(mesh: Mesh, axis: str = DATA_AXIS) -> int:
    return mesh.shape[axis] if axis in mesh.shape else 1


def home_value(tree):
    """A pytree with every :class:`Sharded` leaf replaced by its global value
    on the home device."""
    return tree_map(lambda x: x.full() if isinstance(x, Sharded) else x, tree,
                    is_leaf=lambda x: isinstance(x, Sharded))


def piece(tree, index: int):
    """Entry ``index``'s pieces of a pytree of :class:`Sharded` leaves."""
    return tree_map(lambda x: x.pieces[index] if isinstance(x, Sharded) else x, tree,
                    is_leaf=lambda x: isinstance(x, Sharded))


# -- trial-parallel cohorts ---------------------------------------------------


def trial_axis_size(mesh: Mesh | None) -> int:
    """Devices on the cohort member axis (1 when absent / no mesh)."""
    if mesh is None:
        return 1
    return mesh.shape[TRIAL_AXIS] if TRIAL_AXIS in mesh.shape else 1


def padded_cohort_size(k: int, mesh: Mesh | None) -> int:
    """``k`` rounded up to a multiple of the trial-axis size so every entry
    carries the same member count (callers pad with inert ghost members)."""
    t = trial_axis_size(mesh)
    return -(-k // t) * t


def shard_members(tree, mesh: Mesh):
    """Place a stacked ``[K, ...]`` cohort pytree with its member axis split
    over ``trial`` (K must be a multiple of the trial-axis size, see
    :func:`padded_cohort_size`)."""
    return tree_map(lambda x: _split_leading(x, mesh, TRIAL_AXIS) if _is_leaf(x) else x, tree)


def serial_mesh(mesh: Mesh | None) -> Mesh | None:
    """The mesh a SINGLETON trial should train on.  The ``trial`` axis
    partitions cohort members, not tensors, so a trial-axis-only mesh drops
    to the default single-device layout; a mesh that also carries tensor
    axes is returned unchanged (the singleton replicates over ``trial``)."""
    if mesh is None:
        return None
    if set(mesh.shape) == {TRIAL_AXIS}:
        return None
    return mesh


def narrowed_trial_mesh(mesh: Mesh | None, survivors: Sequence[Any]) -> Mesh | None:
    """Rebuild ``mesh`` over the surviving devices after a device fault,
    shrinking only the ``trial`` axis.  Non-trial axes keep their sizes, so
    the trial axis becomes ``len(survivors) // prod(other axes)`` and
    leftover survivors are dropped to keep the grid rectangular.  Returns
    ``None`` when no strictly narrower mesh exists."""
    if mesh is None or TRIAL_AXIS not in mesh.shape:
        return None
    old_t = mesh.shape[TRIAL_AXIS]
    other = math.prod(s for name, s in mesh.shape.items() if name != TRIAL_AXIS)
    new_t = len(survivors) // other
    if new_t < 1 or new_t >= old_t:
        return None
    sizes = {name: (new_t if name == TRIAL_AXIS else mesh.shape[name])
             for name in mesh.axis_names}
    return make_mesh(sizes, devices=list(survivors)[: new_t * other])


def needs_safe_conv(mesh: Mesh | None) -> bool:
    """True when the mesh carries a non-data axis of size > 1, where the JAX
    package selects the partitioner-safe conv forms.  The port's networks do
    not consult it: their depthwise convolution has one form
    (``ops/depthwise.py``)."""
    if mesh is None:
        return False
    return any(size > 1 for name, size in mesh.shape.items() if name != DATA_AXIS)
