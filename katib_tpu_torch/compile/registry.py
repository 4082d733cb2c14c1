"""Compile-signature registry: what this process has warmed, and was a
trial's first step warm? (port of ``katib_tpu/compile/registry.py``)

A *compile signature* is the coarse identity of a trial program: which
train function, which structural hyperparameters (model widths, batch
sizes, optimizer family), the padded cohort width K, the mesh layout, and
whether the carried state is donated.  For the same train function and
trial parameters :meth:`CompileSignature.key` is the JAX package's string,
byte for byte.

The registry records every signature warmed (by a trial's first step, by
the prewarm worker's twin, by the ``prewarm`` verb) and classifies each
trial's first step warm/cold against it, feeding
``katib_compile_cache_hits_total`` / ``katib_compile_cache_misses_total``
and the warm-vs-cold ``katib_first_step_compile_seconds`` histogram.

**Warm means this process.**  The JAX registry's warmth crosses processes:
an XLA executable persists in the compilation cache, so a row another
process wrote makes a first step warm.  The port's step program is a CUDA
graph captured per trial, and a capture dies with its process; what a
first warm-up and capture pays once per process (cuDNN and cuBLAS handles,
the caching allocator's pools, the capture machinery) is paid again by
every new process.  So :meth:`ShapeRegistry.classify` answers ``warm``
only for a signature this process has warmed.  Rows loaded from the file
are history: :meth:`ShapeRegistry.signatures` returns them, and the
``prewarm`` and ``cache`` verbs print them.

With a compile cache wired (``init_compile_cache``), rows persist to
``<cache>/torch/shape_registry.jsonl``: a file of the port's own, beside
the JAX package's ``<cache>/shape_registry.jsonl``, so neither package's
rows classify the other's first steps.  A port row also carries the
writer's process token (:data:`PROCESS_TOKEN`) and the environment
fingerprint of ``compile/artifacts.py``.  Everything here is best-effort
telemetry: an unreadable registry file or a full disk never fails a trial.

Classification heuristics, as in the JAX package:

- float-valued parameters are excluded from the signature (lr and momentum
  ride as 0-d tensors in the optimizer state and change no program);
- cohort signatures use only the parameters every member agrees on;
- over-keying errs toward classifying cold, never falsely warm.

Not ported: the cost records (``record_cost``/``cost_of``), which belong to
the cost model.
"""

from __future__ import annotations

import json
import os
import secrets
import socket
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Sequence

from katib_tpu_torch.analysis import guarded_by, make_lock
from katib_tpu_torch.parallel.mesh import Mesh, trial_axis_size
from katib_tpu_torch.utils import observability as obs

_REGISTRY_FILENAME = "shape_registry.jsonl"
#: the port's directory under a compile cache shared with the JAX package
PORT_SUBDIR = "torch"
#: identifies the process that wrote a registry row
PROCESS_TOKEN = f"{socket.gethostname()}:{os.getpid()}:{secrets.token_hex(4)}"

#: the wired compile cache (``runner.trial_runner.init_compile_cache``);
#: process-global, the first caller wins
_CACHE_ROOT: str | None = None


def cache_root() -> str | None:
    """The wired compile-cache directory, or None."""
    return _CACHE_ROOT


def _cache_dir() -> str | None:
    """The port's part of the wired compile cache (``<cache>/torch``)."""
    return os.path.join(_CACHE_ROOT, PORT_SUBDIR) if _CACHE_ROOT else None


def _program_name(fn: Callable | None) -> str:
    if fn is None:
        return "<none>"
    return getattr(fn, "__qualname__", getattr(fn, "__name__", repr(fn)))


def mesh_signature(mesh: Any) -> str:
    """The mesh part of a signature, the JAX registry's key: ``""`` without a
    mesh, else the axis layout and the platform (``data=2,model=2:cpu``; a
    CUDA device is JAX's ``gpu``).  A ``trial`` axis > 1 (a sharded cohort)
    and anything that is not a port mesh raise ``NotImplementedError``: the
    trial axis is ROADMAP item 9b."""
    if mesh is None:
        return ""
    if not isinstance(mesh, Mesh) or trial_axis_size(mesh) > 1:
        raise NotImplementedError(
            f"a compile signature over the mesh {mesh!r}: a trial-axis mesh (a sharded "
            "cohort) is not ported yet (ROADMAP item 9b)"
        )
    axes = ",".join(f"{n}={s}" for n, s in mesh.shape.items())
    platform = {"cuda": "gpu"}.get(mesh.home.type, mesh.home.type)
    return f"{axes}:{platform}"


def _structural(value: Any) -> bool:
    """True for values that shape the program (ints, strs, bools); floats
    ride as runtime operands and are excluded."""
    return isinstance(value, (int, str, bool)) and not isinstance(value, float)


@dataclass(frozen=True)
class CompileSignature:
    """Coarse identity of one trial program."""

    program: str
    shapes: tuple[tuple[str, str], ...] = ()
    k: int = 1
    mesh: str = ""
    donation: bool = True

    def key(self) -> str:
        return json.dumps(
            {
                "program": self.program,
                "shapes": list(self.shapes),
                "k": self.k,
                "mesh": self.mesh,
                "donation": self.donation,
            },
            sort_keys=True,
        )


def shared_structural(param_dicts: Sequence[Mapping[str, Any]]) -> dict[str, Any]:
    """Structural parameters every member agrees on: the signature's shape
    component.  Per-member varying values (lr, momentum, seeds) drop out."""
    if not param_dicts:
        return {}
    out: dict[str, Any] = {}
    first = param_dicts[0]
    for name, value in first.items():
        if not _structural(value):
            continue
        if all(p.get(name) == value for p in param_dicts[1:]):
            out[name] = value
    return out


def _shapes_of(shared: Mapping[str, Any]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in shared.items()))


def cohort_signature(
    cohort_fn: Callable | None,
    trials: Sequence[Any],
    k: int,
    mesh: Any = None,
) -> CompileSignature:
    """Signature of a cohort execution: the cohort twin's program, the
    member-agreed structural parameters, and the padded width ``k`` the
    stacked state carries."""
    params = [t.params() for t in trials]
    return CompileSignature(
        program=_program_name(cohort_fn),
        shapes=_shapes_of(shared_structural(params)),
        k=int(k),
        mesh=mesh_signature(mesh),
    )


def trial_signature(train_fn: Callable | None, trial: Any, mesh: Any = None) -> CompileSignature:
    """Signature of a singleton white-box trial (k=1)."""
    params = trial.params()
    shared = {n: v for n, v in params.items() if _structural(v)}
    return CompileSignature(
        program=_program_name(train_fn),
        shapes=_shapes_of(shared),
        k=1,
        mesh=mesh_signature(mesh),
    )


def _fingerprint() -> dict:
    try:
        from katib_tpu_torch.compile.artifacts import env_fingerprint

        return env_fingerprint()
    except Exception:
        return {}


class ShapeRegistry:
    """Thread-safe signature rows with optional JSONL persistence.

    ``_warm`` holds the keys this process warmed; ``_seen`` holds one row
    per key, this process's or, for a key it has not warmed, the last row
    the file holds.  Reached from trial threads (first steps), the async
    harvest thread and the prewarm worker: every access goes through
    ``_lock``, including the JSONL append.
    """

    _GUARDS = guarded_by(_lock=("_seen", "_warm", "_loaded_dir", "_truncate_to"))

    def __init__(self) -> None:
        self._lock = make_lock("compile.registry")
        self._seen: dict[str, dict] = {}
        self._warm: set[str] = set()
        self._loaded_dir: str | None = None
        # byte length of the valid prefix when the registry file ends in a
        # torn line (crash mid-append); the next _append truncates to it
        self._truncate_to: int | None = None

    # -- persistence (best-effort) ----------------------------------------

    def _path(self) -> str | None:
        d = _cache_dir()
        return os.path.join(d, _REGISTRY_FILENAME) if d else None

    def _maybe_load(self) -> None:  # lint: holds(_lock)
        """Fold the cache dir's registry file into the history, once per
        directory.  The last row of a key wins; duplicate rows are compacted
        to one per key, which also heals a torn tail."""
        d = _cache_dir()
        if d is None or d == self._loaded_dir:
            return
        self._loaded_dir = d
        self._truncate_to = None
        path = os.path.join(d, _REGISTRY_FILENAME)
        try:
            with open(path, "rb") as f:
                offset = valid_end = torn = dupes = 0
                in_file: set[str] = set()
                for raw in f:
                    offset += len(raw)
                    line = raw.decode("utf-8", errors="replace").strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        torn += 1
                        continue
                    torn = 0
                    valid_end = offset
                    key = rec.get("key") if isinstance(rec, dict) else None
                    if not key:
                        continue
                    if key in in_file:
                        dupes += 1
                    in_file.add(key)
                    if key not in self._warm:
                        self._seen[key] = rec
            if torn:
                warnings.warn(
                    f"shape registry {path} ends in {torn} torn/corrupt "
                    f"line(s) ({offset - valid_end} bytes) — skipped; "
                    "will truncate on next append",
                    RuntimeWarning,
                    stacklevel=3,
                )
                self._truncate_to = valid_end
            if dupes:
                self._compact(path)
        except OSError:
            pass

    def _compact(self, path: str) -> None:  # lint: holds(_lock)
        """Durably rewrite the registry file as one row per signature."""
        try:
            from katib_tpu_torch.utils.fsio import atomic_replace

            body = "".join(json.dumps(rec) + "\n" for rec in self._seen.values())
            atomic_replace(path, body.encode("utf-8"), prefix=".compact-")
            self._truncate_to = None
        except OSError:
            pass  # compaction is housekeeping, never a failure

    def _append(self, rec: dict) -> None:  # lint: holds(_lock)
        path = self._path()
        if path is None:
            return
        rec["fingerprint"] = _fingerprint()
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            if self._truncate_to is not None:
                with open(path, "rb+") as f:
                    f.truncate(self._truncate_to)
                self._truncate_to = None
            with open(path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            pass  # registry persistence is telemetry, never a failure

    # -- the registry proper ----------------------------------------------

    def seen(self, sig: CompileSignature) -> bool:
        """True when this process has warmed ``sig``."""
        with self._lock:
            self._maybe_load()
            return sig.key() in self._warm

    def record(
        self,
        sig: CompileSignature,
        source: str = "trial",
        compile_seconds: float | None = None,
        capture_seconds: float | None = None,
    ) -> bool:
        """Record that this process warmed ``sig``; returns True when it had
        not before."""
        key = sig.key()
        rec = {
            "key": key,
            "program": sig.program,
            "k": sig.k,
            "mesh": sig.mesh,
            "shapes": dict(sig.shapes),
            "donation": sig.donation,
            "source": source,
            "process": PROCESS_TOKEN,
        }
        if compile_seconds is not None:
            rec["compile_seconds"] = round(float(compile_seconds), 4)
        if capture_seconds is not None:
            rec["capture_seconds"] = round(float(capture_seconds), 4)
        with self._lock:
            self._maybe_load()
            fresh = key not in self._warm
            if fresh:
                self._warm.add(key)
                self._seen[key] = rec
                self._append(rec)
        return fresh

    def classify(self, sig: CompileSignature) -> str:
        """``"warm"`` when this process warmed the signature before, else
        ``"cold"``; no counter side effects (see :meth:`note_first_step`)."""
        return "warm" if self.seen(sig) else "cold"

    def note_first_step(
        self, sig: CompileSignature, seconds: float, source: str = "trial"
    ) -> str:
        """Classify a first step warm/cold, bump the hit/miss counters, feed
        the warm-vs-cold histogram, and record the signature so the next
        same-shape first step of this process classifies warm.  Returns the
        label."""
        label = self.classify(sig)
        if label == "warm":
            obs.compile_cache_hits.inc(program=sig.program)
        else:
            obs.compile_cache_misses.inc(program=sig.program)
        try:
            obs.first_step_compile_seconds.observe(float(seconds), cache=label)
        except (TypeError, ValueError):
            pass
        self.record(sig, source=source, compile_seconds=seconds)
        return label

    def signatures(self) -> list[dict]:
        """Every row: this process's, and the file's history for the keys
        this process has not warmed."""
        with self._lock:
            self._maybe_load()
            return [dict(rec) for rec in self._seen.values()]

    def reset(self) -> None:
        """Forget everything (tests); the on-disk file is left alone."""
        with self._lock:
            self._seen.clear()
            self._warm.clear()
            self._loaded_dir = None
            self._truncate_to = None


def read_rows(cache_dir: str) -> list[dict]:
    """The rows of ``<cache_dir>/torch/shape_registry.jsonl`` (the last row
    of a key wins), without touching the live registry; ``[]`` when there
    is no file.  For the ``prewarm`` and ``cache`` verbs."""
    by_key: dict[str, dict] = {}
    try:
        with open(os.path.join(cache_dir, PORT_SUBDIR, _REGISTRY_FILENAME),
                  errors="replace") as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and rec.get("key"):
                    by_key[rec["key"]] = rec
    except OSError:
        return []
    return list(by_key.values())


REGISTRY = ShapeRegistry()
