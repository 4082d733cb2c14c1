"""The native (C++) runtime (port of ``katib_tpu/native``).

- ``NativeObservationStore``: in-RAM append-log metrics store (ctypes);
- ``parse_text_lines_native``: the C++ TEXT metrics parser (default filter);
- ``spawn_db_manager`` / ``RemoteObservationStore``: the standalone
  metrics daemon and its wire client;
- ``NativeBatchLoader`` / ``pack_dataset``: the mmap'd prefetching batch
  loader (C++ worker threads gather shuffled batches).

Importing the package builds nothing; the first use builds ``src/`` with
``g++`` (``build.py``) and raises :class:`NativeBuildError` if it cannot,
where the JAX package falls back to its Python backends.
"""

from katib_tpu_torch.native.build import (
    NativeBuildError,
    build_error,
    ensure_built,
    native_available,
)

__all__ = [
    "NativeBatchLoader",
    "NativeBuildError",
    "NativeObservationStore",
    "RemoteObservationStore",
    "build_error",
    "ensure_built",
    "native_available",
    "pack_dataset",
    "parse_text_lines_native",
    "spawn_db_manager",
]


def __getattr__(name):  # lazy: importing the package must not build
    if name in ("NativeObservationStore", "parse_text_lines_native"):
        from katib_tpu_torch.native import store

        return getattr(store, name)
    if name in ("RemoteObservationStore", "spawn_db_manager"):
        from katib_tpu_torch.native import dbmanager

        return getattr(dbmanager, name)
    if name in ("NativeBatchLoader", "pack_dataset"):
        from katib_tpu_torch.native import dataloader

        return getattr(dataloader, name)
    raise AttributeError(name)
