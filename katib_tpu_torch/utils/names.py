"""Single-sourced safety predicate for names that become workdir path
components (experiment names from YAML, URLs, or the SDK).

The reference gets this for free from K8s DNS-1123 object-name rules; here
one shared helper keeps the admission webhook (``core/validation.py``) and
the journal reader (``orchestrator/status.py``) from drifting apart on what
counts as path-safe."""

from __future__ import annotations

import os


def is_safe_path_component(name: str) -> bool:
    """True iff ``name`` can be joined under a workdir without escaping it:
    non-empty, not a dot-dir, and free of separators and NUL bytes."""
    if not name or name in (".", ".."):
        return False
    if "/" in name or "\x00" in name:
        return False
    if os.sep in name or (os.altsep and os.altsep in name):
        return False
    return True
