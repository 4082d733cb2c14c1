"""Durable file replacement (copy of ``katib_tpu/utils/fsio.py``'s
``atomic_replace`` and ``fsync_dir``, with the fault harness's crash point).

``os.replace`` alone is atomic (readers see the old or the new file, never
a mix) but not durable: the rename can reach the disk before the data.  The
recipe is fsync(temp file), ``os.replace``, fsync(directory).
"""

from __future__ import annotations

import os
import tempfile


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry is durable (best-effort:
    some filesystems refuse to open a directory read-only)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_replace(
    path: str,
    data: bytes,
    *,
    prefix: str = ".tmp-",
    crash_site: str | None = None,
) -> None:
    """Durably replace ``path`` with ``data``: write a sibling temp file,
    flush and fsync it, rename it over ``path``, fsync the directory.

    ``crash_site`` names the :func:`katib_tpu_torch.utils.faults.crash_point`
    fired between the temp-file write and the rename."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=prefix)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        if crash_site is not None:
            from katib_tpu_torch.utils.faults import crash_point

            crash_point(crash_site)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    fsync_dir(d)
