"""The native batch loader (port of ``katib_tpu/native/dataloader.py``).

``NativeBatchLoader`` streams shuffled ``(x, y)`` batches from a
memory-mapped record file, C++ worker threads doing the gather
(``src/dataloader.cc``), so the host's batch assembly overlaps the card's
step.  The record file is written once by :func:`pack_dataset`: each record
is one sample's image bytes followed by its label bytes.  The file format,
the ``(seed, epoch)`` shuffle, the ``start_epoch`` rule and drop-last are
the JAX package's, so both loaders yield the same bytes.

Unlike the JAX package, a loader that cannot build or open raises (the
runtime's build error, or ``RuntimeError``); nothing falls back to Python
batches here.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from katib_tpu_torch.native.build import load_lib


def pack_dataset(x: np.ndarray, y: np.ndarray, path: str) -> tuple[int, int]:
    """Write ``(x[i] || y[i])`` records to ``path``; returns
    ``(record_bytes, n)``.

    An existing file of exactly the expected size is reused without
    rewriting (size only: a caller that packs other data of the same shape
    to the same path removes the file first)."""
    x = np.ascontiguousarray(x)
    y = np.ascontiguousarray(y)
    n = len(x)
    if len(y) != n or n == 0:
        raise ValueError(f"pack_dataset needs as many labels as samples, got {n} and {len(y)}")
    record_bytes = (x.nbytes + y.nbytes) // n
    try:
        if os.path.getsize(path) == record_bytes * n:
            return record_bytes, n
    except OSError:
        pass
    xb = x.reshape(n, -1).view(np.uint8).reshape(n, -1)
    yb = y.reshape(n, -1).view(np.uint8).reshape(n, -1)
    rec = np.concatenate([xb, yb], axis=1)
    tmp = path + ".tmp"
    rec.tofile(tmp)
    os.replace(tmp, path)
    return rec.shape[1], n


class NativeBatchLoader:
    """Iterate epochs of shuffled batches gathered by C++ worker threads.

    Deterministic: epoch ``e`` of a loader with seed ``s`` always yields the
    same batches in the same order, whatever the thread count.
    ``start_epoch``: the first :meth:`epoch` yields that epoch's shuffle (a
    resumed run), not epoch 0's."""

    def __init__(self, x: np.ndarray, y: np.ndarray, *, batch: int, seed: int = 0,
                 cache_path: str, n_threads: int = 2, queue_cap: int = 8,
                 start_epoch: int = 0):
        self._lib = load_lib()
        self.x_shape, self.x_dtype = x.shape[1:], x.dtype
        self.y_shape, self.y_dtype = y.shape[1:], y.dtype
        self._x_bytes = int(np.prod(self.x_shape, dtype=np.int64)) * x.dtype.itemsize
        self._y_bytes = int(np.prod(self.y_shape, dtype=np.int64) or 1) * y.dtype.itemsize
        self.batch = batch
        record_bytes, n = pack_dataset(x, y, cache_path)
        if record_bytes != self._x_bytes + self._y_bytes:
            raise ValueError(f"{cache_path} holds {record_bytes}-byte records, not "
                             f"{self._x_bytes + self._y_bytes}")
        self._h = self._lib.ktl_open(cache_path.encode(), record_bytes, n, batch, seed,
                                     n_threads, queue_cap, start_epoch)
        if not self._h:
            raise RuntimeError(f"ktl_open failed for {cache_path} (batch {batch}, {n} records)")
        self._record_bytes = record_bytes

    @property
    def batches_per_epoch(self) -> int:
        return int(self._lib.ktl_batches_per_epoch(self._h))

    @property
    def epoch_index(self) -> int:
        """Epoch of the next batch to be delivered."""
        return int(self._lib.ktl_epoch(self._h))

    def epoch(self):
        """Yield this epoch's ``(x, y)`` batches (drop-last).  Each batch is
        gathered into an array of its own and copied out of it, so a batch
        still being read (a host-to-device copy) is never the buffer the
        next ``ktl_next`` writes."""
        for _ in range(self.batches_per_epoch):
            raw = np.empty((self.batch, self._record_bytes), dtype=np.uint8)
            got = self._lib.ktl_next(self._h, raw.ctypes.data_as(ctypes.c_char_p))
            if got != self.batch:
                raise RuntimeError(f"native loader returned {got}")
            xb = (raw[:, : self._x_bytes].copy().view(self.x_dtype)
                  .reshape(self.batch, *self.x_shape))
            yb = raw[:, self._x_bytes:].copy().view(self.y_dtype)
            yb = yb.reshape(self.batch, *self.y_shape) if self.y_shape else yb.reshape(self.batch)
            yield xb, yb

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.ktl_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # best effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass
