"""Runtime lock-order witness (``KATIB_LOCK_WITNESS=1``).

The engine's locks are created through :func:`make_lock`.  By default
that returns a plain ``threading.Lock`` — zero overhead, the witness is
compiled out.  With ``KATIB_LOCK_WITNESS=1`` in the environment at lock
creation time it returns a :class:`WitnessLock` instead, which records
the process-wide lock-acquisition graph: an edge ``A -> B`` means some
thread acquired ``B`` while holding ``A``.  Acquiring a lock that would
close a cycle in that graph is a *potential lock-order inversion* — two
threads interleaving those paths can deadlock — and the witness turns it
into a hard failure (:class:`LockOrderInversion`) at the acquisition
site, before the lock is taken.

Nodes are lock *roles* (the name passed to ``make_lock``), not
instances: lock-order discipline is a property of roles ("async.state
before async.queue before async.futures"), and per-instance locks of the
same role (every ``_Metric._lock``) share one node.  Consequences:

- acquiring a role already held anywhere on the thread's stack records
  no edge (instance-level nesting within a role is indistinguishable
  from re-acquisition, so it cannot be ordered);
- the witness therefore does not detect single-role self-deadlock.

The chaos soak prints :func:`witness_summary` and fails on any recorded
inversion (``orchestrator/soak.py``); tests exercise the cycle detector
directly (``tests/test_lint.py``).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

ENV_VAR = "KATIB_LOCK_WITNESS"


class LockOrderInversion(AssertionError):
    """Acquiring this lock would close a cycle in the acquisition graph."""


def witness_enabled() -> bool:
    return os.environ.get(ENV_VAR, "").strip() not in ("", "0", "false", "no")


class _Graph:
    """Process-global acquisition graph.  All mutation under one mutex."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        # role -> {successor role -> acquisition count}
        self.edges: Dict[str, Dict[str, int]] = {}
        self.acquires: Dict[str, int] = {}
        self.inversions: List[Tuple[str, ...]] = []

    def note_acquire(self, name: str) -> None:
        with self._mu:
            self.acquires[name] = self.acquires.get(name, 0) + 1

    def note_edge(self, held: str, acquiring: str) -> Optional[Tuple[str, ...]]:
        """Record ``held -> acquiring``; return the cycle path if one forms."""
        with self._mu:
            cycle = self._path(acquiring, held)
            succ = self.edges.setdefault(held, {})
            succ[acquiring] = succ.get(acquiring, 0) + 1
            if cycle is not None:
                path = tuple(cycle) + (acquiring,)
                self.inversions.append(path)
                return path
            return None

    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS path src -> dst over recorded edges (None if unreachable)."""
        if src == dst:
            return [src]
        stack: List[Tuple[str, List[str]]] = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            for nxt in self.edges.get(node, ()):
                if nxt == dst:
                    return path + [nxt]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def cycles(self) -> List[Tuple[str, ...]]:
        """All inversions recorded at acquire time plus any residual graph
        cycle (belt and braces: the graph is checked even if an inversion
        exception was swallowed by a retry path)."""
        with self._mu:
            found = list(self.inversions)
            # iterative DFS cycle scan over the whole graph
            WHITE, GREY, BLACK = 0, 1, 2
            color = {n: WHITE for n in set(self.edges) | {v for s in self.edges.values() for v in s}}
            for root in list(color):
                if color[root] != WHITE:
                    continue
                stack: List[Tuple[str, List[str]]] = [(root, [root])]
                while stack:
                    node, path = stack.pop()
                    if node == "\x00pop":
                        color[path[-1]] = BLACK
                        continue
                    if color[node] == BLACK:
                        continue
                    color[node] = GREY
                    stack.append(("\x00pop", path))
                    for nxt in self.edges.get(node, ()):
                        if color.get(nxt, WHITE) == GREY and nxt in path:
                            cyc = tuple(path[path.index(nxt):]) + (nxt,)
                            if cyc not in found:
                                found.append(cyc)
                        elif color.get(nxt, WHITE) == WHITE:
                            stack.append((nxt, path + [nxt]))
            return found

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "acquires": dict(self.acquires),
                "edges": [
                    (u, v, n)
                    for u, succ in sorted(self.edges.items())
                    for v, n in sorted(succ.items())
                ],
                "inversions": [list(p) for p in self.inversions],
            }

    def reset(self) -> None:
        with self._mu:
            self.edges.clear()
            self.acquires.clear()
            self.inversions.clear()


_GRAPH = _Graph()
_HELD = threading.local()


def _stack() -> List[str]:
    stack = getattr(_HELD, "stack", None)
    if stack is None:
        stack = _HELD.stack = []
    return stack


class WitnessLock:
    """Drop-in ``threading.Lock`` wrapper that witnesses acquisition order."""

    __slots__ = ("name", "_lk")

    def __init__(self, name: str, lk=None) -> None:
        self.name = name
        self._lk = lk if lk is not None else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        stack = _stack()
        if stack and self.name not in stack:
            cycle = _GRAPH.note_edge(stack[-1], self.name)
            if cycle is not None:
                raise LockOrderInversion(
                    "lock-order inversion: acquiring %r while holding %r closes the cycle %s"
                    % (self.name, stack[-1], " -> ".join(cycle))
                )
        ok = self._lk.acquire(blocking, timeout)
        if ok:
            _GRAPH.note_acquire(self.name)
            stack.append(self.name)
        return ok

    def release(self) -> None:
        stack = _stack()
        # pop the most recent occurrence (release order may not be LIFO)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == self.name:
                del stack[i]
                break
        self._lk.release()

    def locked(self) -> bool:
        return self._lk.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<WitnessLock {self.name!r} {'locked' if self.locked() else 'unlocked'}>"


def make_lock(name: str, *, factory=threading.Lock):
    """Create the lock for role *name*.

    Plain ``factory()`` (default ``threading.Lock``) unless
    ``KATIB_LOCK_WITNESS=1`` was set when the lock is created — the
    witness is opt-in and carries zero cost when disabled.
    """
    if not witness_enabled():
        return factory()
    return WitnessLock(name, factory())


def witness_reset() -> None:
    """Clear the acquisition graph (tests / between soak rounds)."""
    _GRAPH.reset()


def witness_cycles() -> List[Tuple[str, ...]]:
    return _GRAPH.cycles()


def witness_summary() -> dict:
    """Graph snapshot: per-role acquire counts, edges, recorded inversions."""
    return _GRAPH.snapshot()


def format_summary() -> str:
    snap = _GRAPH.snapshot()
    lines = ["lock-order witness: acquisition graph"]
    if not snap["acquires"]:
        lines.append("  (no witnessed acquisitions — was KATIB_LOCK_WITNESS=1 set?)")
        return "\n".join(lines)
    for name, n in sorted(snap["acquires"].items()):
        lines.append(f"  {name}: {n} acquisitions")
    if snap["edges"]:
        lines.append("  observed order (held -> acquired):")
        for u, v, n in snap["edges"]:
            lines.append(f"    {u} -> {v}  (x{n})")
    cycles = _GRAPH.cycles()
    if cycles:
        lines.append("  INVERSIONS DETECTED:")
        for path in cycles:
            lines.append("    " + " -> ".join(path))
    else:
        lines.append("  no inversions: the observed order is acyclic")
    return "\n".join(lines)
