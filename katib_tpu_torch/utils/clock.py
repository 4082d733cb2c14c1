"""Injectable clock seam for the orchestrator path.

Every time-dependent operation in the orchestrator / supervisor / watchdog /
runner stack (reading the monotonic clock, sleeping, waiting on events,
joining threads, waiting on futures, spawning worker threads, submitting
pool work) routes through one ambient :class:`Clock` so the discrete-event
simulator (``katib_tpu_torch/sim``) can substitute a virtual clock and run a
50k-trial sweep in seconds of wall time — with the *real* scheduler code in
the loop.

The module is stdlib-only and imports nothing from ``katib_tpu_torch`` so every
layer (``core.types`` included) can depend on it without cycles.

Production behavior is unchanged: the default :class:`SystemClock` is a
thin passthrough to ``time`` / ``threading`` / ``concurrent.futures``.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
import time
from typing import Any, Callable, Iterable, Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    """The full seam surface.  See :class:`SystemClock` for semantics."""

    def monotonic(self) -> float: ...

    def perf_counter(self) -> float: ...

    def time(self) -> float: ...

    def sleep(self, seconds: float) -> None: ...

    def wait(self, event: threading.Event, timeout: float | None = None) -> bool: ...

    def join_thread(
        self, thread: threading.Thread, timeout: float | None = None
    ) -> bool: ...

    def wait_futures(
        self, futures: Iterable[cf.Future], timeout: float | None = None
    ) -> Any: ...

    def spawn(
        self,
        target: Callable[[], Any],
        *,
        name: str | None = None,
        daemon: bool = True,
    ) -> threading.Thread: ...

    def submit(
        self, pool: cf.Executor, fn: Callable[..., Any], /, *args: Any, **kwargs: Any
    ) -> cf.Future: ...


class SystemClock:
    """Real time.  The production default: trivial passthroughs."""

    def monotonic(self) -> float:
        return time.monotonic()

    def perf_counter(self) -> float:
        return time.perf_counter()

    def time(self) -> float:
        return time.time()

    def sleep(self, seconds: float) -> None:
        time.sleep(max(0.0, seconds))

    def wait(self, event: threading.Event, timeout: float | None = None) -> bool:
        return event.wait(timeout)

    def join_thread(
        self, thread: threading.Thread, timeout: float | None = None
    ) -> bool:
        thread.join(timeout)
        return not thread.is_alive()

    def wait_futures(
        self, futures: Iterable[cf.Future], timeout: float | None = None
    ) -> Any:
        return cf.wait(list(futures), timeout=timeout)

    def spawn(
        self,
        target: Callable[[], Any],
        *,
        name: str | None = None,
        daemon: bool = True,
    ) -> threading.Thread:
        t = threading.Thread(target=target, name=name, daemon=daemon)
        t.start()
        return t

    def submit(
        self, pool: cf.Executor, fn: Callable[..., Any], /, *args: Any, **kwargs: Any
    ) -> cf.Future:
        return pool.submit(fn, *args, **kwargs)


_DEFAULT = SystemClock()
_ambient: Clock = _DEFAULT
_ambient_lock = threading.Lock()


def get_clock() -> Clock:
    """The process-ambient clock (SystemClock unless a simulator swapped it)."""
    return _ambient


def set_clock(clock: Clock | None) -> Clock:
    """Install ``clock`` as the ambient clock; returns the previous one.

    Pass ``None`` to restore the real :class:`SystemClock`.  Callers must
    restore the previous clock when done (the simulator and tests use
    try/finally); the swap is process-global by design — the orchestrator
    stack reaches the clock ambiently rather than threading a parameter
    through every constructor.
    """
    global _ambient
    with _ambient_lock:
        prev = _ambient
        _ambient = clock if clock is not None else _DEFAULT
        return prev
