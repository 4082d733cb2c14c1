"""The launch tallies of CUDA graph captures in progress, by stream.

A kernel launched while its stream is being captured does not run: it runs
each time the graph is replayed.  So a kernel wrapper does not count such a
launch; it adds it to the tally of the capture recording that stream, and
the capture's owner adds the tally to the counts on every replay.  The
tallies are keyed by the capturing stream, not by thread: on a mesh the
replicas' threads launch onto the capturing stream
(``parallel/collectives.py``), and a captured backward launches from
autograd's device thread.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable

import torch


class StreamTallies:
    """One kernel library's tallies, each made by ``new_tally`` and guarded
    by that library's count lock ``lock``."""

    def __init__(self, lock: threading.Lock, new_tally: Callable[[], Any]):
        self._lock, self._new = lock, new_tally
        self._by_stream: dict[int, Any] = {}

    def find(self, device: torch.device | None):
        """The tally of the capture recording ``device``'s current stream,
        or ``None``; call it holding the lock."""
        if not self._by_stream or device is None:
            return None
        return self._by_stream.get(torch.cuda.current_stream(device).cuda_stream)

    @contextlib.contextmanager
    def recording(self, stream: torch.cuda.Stream):
        """Record the launches made onto ``stream`` inside, by any thread,
        into a new tally, which it yields."""
        tally = self._new()
        with self._lock:
            self._by_stream[stream.cuda_stream] = tally
        try:
            yield tally
        finally:
            with self._lock:
                del self._by_stream[stream.cuda_stream]
