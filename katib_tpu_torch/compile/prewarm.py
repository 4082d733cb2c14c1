"""Background prewarm worker: strictly best-effort, never on the critical
path (port of ``katib_tpu/compile/prewarm.py``).

While the current trials train, the orchestrator already knows the next
groups' structural parameters and padded widths.  The worker drains those
signatures on a daemon thread and calls each train function's *prewarm
twin*, which builds the step the trial will build and warms it up and
captures it once on zeros of the trial's shapes.  In the port that pays,
in the background, what a process's first warm-up and capture costs once
(cuDNN and cuBLAS handles, the allocator's pools, the capture machinery):
it helps the process it runs in.  Nothing of the twin's graph is handed to
a trial; each trial still captures its own.

A train function opts in as in the JAX package::

    def my_trial(ctx): ...
    def my_prewarm(shared, k, mesh=None, device=None): ...  # warm, don't train
    attach_prewarm_fn(my_trial, my_prewarm, kernels=("mixed_op",))

``prewarm(shared, k, mesh, device)`` receives the member-agreed structural
parameters, the padded cohort width, the mesh (the port has none) and the
device to run on (the orchestrator's); it returns its capture seconds (or
None) and has no side effect beyond warming.  ``kernels`` names the
hand-written kernel libraries (``ops/csrc/<name>.cu``) the program
launches: the worker's ``publish`` and ``fetch_only`` act on those, the
only compiled code of the port that another process can take over
(``compile/artifacts.py``).

**The capture rule.**  A twin on a CUDA device warms up and captures on the
capture stream its thread takes from the free list
(``nas/darts/step_loop.py::_capture_stream``) and holds the device's
capture lock for the whole of its warm-up and capture, as a trial's
``EpochLoop._build_graph`` does; it never calls ``torch.cuda.synchronize()``
outside that lock, and waits on nothing but its own stream otherwise.  A
device-wide sync outside the lock could land inside a trial's capture.

Failure contract: every exception is counted, logged and swallowed,
``stop()`` bounds its wait, and the thread is a daemon.  Duplicate
submissions dedupe against the shape registry, so a queued signature
warms once per process.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

from katib_tpu_torch.analysis import guarded_by, make_lock
from katib_tpu_torch.compile.registry import (
    REGISTRY,
    CompileSignature,
    ShapeRegistry,
    _program_name,
    _shapes_of,
    mesh_signature,
)
from katib_tpu_torch.utils import observability as obs

_log = logging.getLogger(__name__)

_PREWARM_ATTR = "__prewarm_fn__"
_KERNELS_ATTR = "__prewarm_kernels__"


def attach_prewarm_fn(train_fn: Callable, prewarm_fn: Callable,
                      kernels: tuple[str, ...] = ()) -> Callable:
    """Declare ``prewarm_fn(shared, k, mesh=None, device=None)`` as the
    warm-up twin of ``train_fn``, whose program launches the hand-written
    kernel libraries ``kernels``; returns ``train_fn``."""
    setattr(train_fn, _PREWARM_ATTR, prewarm_fn)
    setattr(train_fn, _KERNELS_ATTR, tuple(kernels))
    return train_fn


def prewarm_fn_of(train_fn: Callable | None) -> Callable | None:
    if train_fn is None:
        return None
    return getattr(train_fn, _PREWARM_ATTR, None)


def kernels_of(train_fn: Callable | None) -> tuple[str, ...]:
    """The kernel libraries ``train_fn``'s program launches, as declared."""
    return tuple(getattr(train_fn, _KERNELS_ATTR, ()) or ())


@dataclass
class PrewarmRequest:
    """One upcoming program: who warms it, with what shapes, where."""

    train_fn: Callable
    shared: Mapping[str, Any] = field(default_factory=dict)
    k: int = 1
    mesh: Any = None
    # the cohort twin (if any) names the program, matching the signature
    # run_cohort classifies against
    program_fn: Callable | None = None
    #: the device the twin runs on (the orchestrator's)
    device: Any = None

    def signature(self) -> CompileSignature:
        return CompileSignature(
            program=_program_name(self.program_fn or self.train_fn),
            shapes=_shapes_of(
                {n: v for n, v in self.shared.items() if not isinstance(v, float)}
            ),
            k=int(self.k),
            mesh=mesh_signature(self.mesh),
        )


class PrewarmWorker:
    """Daemon-thread warm-up worker over a bounded queue of requests.

    Counters: ``compiled`` (twins run to their end),
    ``failed`` (twins that raised), ``fetched`` (kernel libraries fetched
    from an artifact tier) and ``published`` (kernel libraries published to
    one).  ``publish``: after a twin, publish the kernel libraries its
    program launches (built ones only; the content address dedupes).
    ``fetch_only``: fetch those libraries into the build directory and run
    no twin.  ``force``: bypass the registry dedupe (the ``prewarm`` verb)."""

    _GUARDS = guarded_by(
        _lock=("_thread", "compiled", "failed", "fetched", "published", "captures")
    )

    def __init__(
        self,
        registry: ShapeRegistry = REGISTRY,
        max_queue: int = 64,
        publish: bool = True,
        fetch_only: bool = False,
        force: bool = False,
    ):
        self._registry = registry
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._lock = make_lock("prewarm.worker")
        self._publish = publish
        self._fetch_only = fetch_only
        self._force = force
        self.compiled = 0
        self.failed = 0
        self.fetched = 0
        self.published = 0
        #: capture seconds of each twin run, by signature key (CLI/tests)
        self.captures: dict[str, float | None] = {}

    def submit(self, request: PrewarmRequest) -> bool:
        """Enqueue a request; returns False (without queuing) when the
        train_fn has no twin, the signature is warm in this process, or the
        queue is full; never blocks the caller."""
        if prewarm_fn_of(request.train_fn) is None:
            return False
        if not self._force and self._registry.seen(request.signature()):
            return False
        try:
            self._queue.put_nowait(request)
        except queue.Full:
            return False  # backpressure: drop, the trial warms up live
        self._ensure_thread()
        return True

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, name="katib-prewarm", daemon=True
                )
                self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                req = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self._compile(req)
            except Exception:
                with self._lock:
                    self.failed += 1
                _log.warning(
                    "prewarm failed for %s (best-effort, the trial warms up live)",
                    _program_name(req.train_fn),
                    exc_info=True,
                )
            finally:
                self._queue.task_done()

    def _kernels(self, req: PrewarmRequest) -> None:
        """Fetch (``fetch_only``) or publish the request's kernel libraries."""
        from katib_tpu_torch.compile import artifacts
        from katib_tpu_torch.ops._build import library_path

        for name in kernels_of(req.train_fn):
            if self._fetch_only:
                if not library_path(name).exists() and artifacts.fetch_kernel(name):
                    with self._lock:
                        self.fetched += 1
            elif artifacts.publish_kernel(name):
                with self._lock:
                    self.published += 1

    def _compile(self, req: PrewarmRequest) -> None:
        sig = req.signature()
        if not self._force and self._registry.seen(sig):
            return  # raced with a trial (or a duplicate submit): already warm
        fn = prewarm_fn_of(req.train_fn)
        if fn is None:
            return
        if self._fetch_only:
            self._kernels(req)
            return
        started = time.perf_counter()
        capture_s = fn(dict(req.shared), int(req.k), req.mesh, device=req.device)
        elapsed = time.perf_counter() - started
        with self._lock:
            self.captures[sig.key()] = capture_s
        # a trial of the same signature may have recorded it meanwhile: the
        # twin still ran to its end, and counts
        self._registry.record(sig, source="prewarm", compile_seconds=elapsed,
                              capture_seconds=capture_s)
        with self._lock:
            self.compiled += 1
        obs.prewarm_compiles.inc(program=sig.program)
        if self._publish:
            self._kernels(req)

    def stats(self) -> dict:
        """The counters, for a run's summary line."""
        with self._lock:
            return {"compiled": self.compiled, "failed": self.failed,
                    "fetched": self.fetched, "published": self.published}

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait (bounded) for the queue to empty: the CLI verb and tests
        only; the orchestrator never blocks on the worker."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._queue.unfinished_tasks == 0:
                return True
            time.sleep(0.02)
        return False

    def stop(self, timeout: float = 1.0) -> None:
        """Ask the worker to wind down; bounded, never raises.  A twin in
        flight keeps running on the daemon thread and is abandoned."""
        self._stop.set()
        with self._lock:
            t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
