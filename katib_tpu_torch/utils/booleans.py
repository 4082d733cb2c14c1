"""One boolean parser for user-supplied flag strings.

Copy of ``katib_tpu/utils/booleans.py``: settings, trial params, and env
knobs all carry booleans as strings; ad-hoc ``not in ("", "0")`` checks
treat explicit opt-outs like ``"false"`` or ``"no"`` as TRUE.  Every
surface that accepts a boolean-ish string goes through this one function so
the accepted spellings can't drift.
"""

from __future__ import annotations

_FALSY = ("", "0", "false", "no", "none", "off")


def parse_bool(raw: object, default: bool = False) -> bool:
    """``"false"/"no"/"none"/"off"/"0"/"" -> False``; other strings True;
    ``None`` -> ``default``; real bools pass through."""
    if raw is None:
        return default
    if isinstance(raw, bool):
        return raw
    return str(raw).strip().lower() not in _FALSY
