"""The ``guarded_by`` annotation convention for lock discipline.

A class declares which lock guards which attributes with a single class
attribute the AST checker can read without importing the module::

    class AsyncLoops:
        _GUARDS = guarded_by(
            _queue_lock=("_ready", "_packing", "_pack_ts"),
            _futures_lock=("futures", "_fut_meta"),
        )

The checker (``katib_tpu/analysis/lockcheck.py``, not ported yet) flags every read
or write of a guarded attribute outside a lexical ``with self.<lock>:``
scope.  Two comment annotations refine it:

- ``# lint: unguarded-ok(<reason>)`` on the flagged line suppresses the
  finding (any lint code, not just lock codes); the reason is mandatory.
- ``# lint: holds(_lock_a[, _lock_b])`` on a ``def`` line declares that
  every caller enters the function with those locks held (the
  "called under X lock" helper pattern).

At runtime ``guarded_by`` returns the ``{attr: lock}`` mapping, so the
declaration doubles as machine-readable documentation.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Tuple, Union

AttrSpec = Union[str, Iterable[str]]

# comment grammar shared by the checkers --------------------------------
_SUPPRESS_RE = re.compile(r"#\s*lint:\s*unguarded-ok\(([^)]+)\)")
_HOLDS_RE = re.compile(r"#\s*lint:\s*holds\(([^)]+)\)")


def guarded_by(**locks: AttrSpec) -> Dict[str, str]:
    """Map each named attribute to the lock that guards it.

    Keyword names are lock attribute names (``_queue_lock``); values are
    an attribute name or an iterable of attribute names.  An attribute
    may be guarded by exactly one lock.
    """
    mapping: Dict[str, str] = {}
    for lock, attrs in locks.items():
        if isinstance(attrs, str):
            attrs = (attrs,)
        attrs = tuple(attrs)
        if not attrs:
            raise ValueError(
                f"guarded_by({lock}=...): a lock must guard at least one attribute"
            )
        for attr in attrs:
            if not isinstance(attr, str) or not attr:
                raise TypeError(f"guarded_by({lock}=...): attribute names must be non-empty strings")
            if attr in mapping and mapping[attr] != lock:
                raise ValueError(
                    f"attribute {attr!r} declared guarded by both {mapping[attr]!r} and {lock!r}"
                )
            mapping[attr] = lock
    return mapping


def parse_annotations(source: str) -> Tuple[Dict[int, str], Dict[int, Tuple[str, ...]]]:
    """Extract lint comment annotations from *source*.

    Returns ``(suppressed, holds)`` where ``suppressed`` maps a 1-based
    line number to the suppression reason and ``holds`` maps a ``def``
    line number to the tuple of lock names the caller is declared to
    hold.
    """
    suppressed: Dict[int, str] = {}
    holds: Dict[int, Tuple[str, ...]] = {}
    for lineno, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if m and m.group(1).strip():
            suppressed[lineno] = m.group(1).strip()
        m = _HOLDS_RE.search(line)
        if m:
            names = tuple(n.strip() for n in m.group(1).split(",") if n.strip())
            if names:
                holds[lineno] = names
    return suppressed, holds


def is_suppressed(suppressed: Dict[int, str], lineno: int, end_lineno: int = None) -> bool:
    """True when any line of the node's span carries a suppression."""
    end = end_lineno if end_lineno is not None else lineno
    return any(ln in suppressed for ln in range(lineno, end + 1))
