"""Durable file replacement (copy of ``katib_tpu/utils/fsio.py``'s
``atomic_replace`` and ``fsync_dir``; the crash-injection hook of the JAX
package's fault harness is not ported).

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


def atomic_replace(path: str, data: bytes, *, prefix: str = ".tmp-") -> None:
    """Durably replace ``path`` with ``data``: write a sibling temp file,
    flush and fsync it, rename it over ``path``, fsync the directory."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=prefix)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    fsync_dir(d)
