"""Build and load the native runtime (port of ``katib_tpu/native/build.py``).

``src/`` compiles with ``g++ -O2 -std=c++17`` called directly (no
``make``: a host with the CUDA toolkit is only known to have its host
compiler), one ``g++`` process per target, all started together.  The
outputs land in ``build/katib_tpu_torch/native/`` beside the package, each
named by a digest of its sources and flags, so an edited source is rebuilt
and an unchanged one is used as it is.  A build holds a file lock in that
directory and renames each output into place, so concurrent test workers
and a ``db-manager`` child never see half a library.

One deliberate difference from the JAX package, which degrades gracefully
(``native_available()`` is False and its callers fall back to the Python
backends): here :func:`ensure_built` RAISES :class:`NativeBuildError` with
the compiler's output, and so does every caller that asked for the native
runtime (the ``native`` store, native prefetch, ``db-manager``).  Only
``runner.metrics.parse_text_lines_fast``, which nobody asks for by name,
keeps the JAX choice of the Python parser when the runtime cannot build
(:func:`native_available`).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "katib_tpu_torch" / "native"
CXXFLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra")
#: output -> (sources, extra flags, libraries)
TARGETS = {
    "libkatibnative.so": (("obslog.cc", "dataloader.cc"), ("-fPIC", "-shared"), ("-lpthread",)),
    "katib-db-manager": (("dbmanager.cc", "obslog.cc"), (), ("-lpthread",)),
    # the race and memory-safety stress of the store and the loader
    "katib-native-stress": (("stress.cc", "obslog.cc", "dataloader.cc"),
                            ("-fsanitize=thread", "-g"), ("-lpthread",)),
    "katib-native-stress-asan": (("stress.cc", "obslog.cc", "dataloader.cc"),
                                 ("-fsanitize=address", "-fno-omit-frame-pointer", "-g"),
                                 ("-lpthread",)),
}
#: what the runtime needs: the library and the daemon
RUNTIME = ("libkatibnative.so", "katib-db-manager")
TIMEOUT_S = 300

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_error: str | None = None


class NativeBuildError(RuntimeError):
    """The native runtime did not build: the message holds the compiler's
    output (or why no compiler ran)."""


def output_path(name: str) -> Path:
    """Where target ``name`` is built: its name with a digest of its
    sources, the headers and its flags."""
    sources, extra, libs = TARGETS[name]
    digest = hashlib.sha256()
    for src in sorted(set(sources) | {p.name for p in SRC.glob("*.h")}):
        digest.update(src.encode() + b"\0" + (SRC / src).read_bytes())
    digest.update(" ".join(CXXFLAGS + extra + libs).encode())
    stem, dot, suffix = name.partition(".")
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:12]}{dot}{suffix}"


def _compiler() -> str:
    found = shutil.which("g++")
    if found is None:
        raise NativeBuildError("g++ not found: the native runtime needs a C++17 compiler")
    return found


def build(names=RUNTIME) -> dict[str, bool]:
    """Compile the targets of ``names`` that are not built yet, in parallel,
    under the build directory's file lock.  Returns ``{name: compiled}``
    (False for an output already there).  Raises :class:`NativeBuildError`
    with the compiler's output if any compile fails."""
    outs = {name: output_path(name) for name in names}
    compiled = {name: False for name in names}
    if all(out.exists() for out in outs.values()):
        return compiled
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        procs = {}
        for name, out in outs.items():
            if out.exists():  # built by another process while this one waited
                continue
            sources, extra, libs = TARGETS[name]
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_compiler(), *CXXFLAGS, *extra, *(str(SRC / s) for s in sources),
                   "-o", str(tmp), *libs]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), tmp, out)
        failures = []
        for name, (proc, tmp, out) in procs.items():
            try:
                log, _ = proc.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                log, _ = proc.communicate()
                log += f"\ng++ timed out after {TIMEOUT_S} s"
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failures.append(f"g++ failed for {name} (rc {proc.returncode}):\n{log[-4000:]}")
                continue
            os.replace(tmp, out)  # atomic: a reader sees no file or a whole one
            compiled[name] = True
    if failures:
        raise NativeBuildError("\n".join(failures))
    return compiled


def ensure_built() -> None:
    """Build the runtime (the library and the daemon) if needed; raises
    :class:`NativeBuildError` if it cannot build.  A failure is remembered,
    so later calls raise it again without recompiling."""
    global _build_error
    with _lock:
        if _build_error is not None:
            raise NativeBuildError(_build_error)
        try:
            build(RUNTIME)
        except NativeBuildError as e:
            _build_error = str(e)
            raise


def native_available() -> bool:
    """True when the runtime is built (building it if needed), False when it
    cannot build (:func:`build_error` says why)."""
    try:
        ensure_built()
    except NativeBuildError:
        return False
    return True


def build_error() -> str | None:
    """Why the runtime did not build, or None."""
    return _build_error


def library_path() -> Path:
    return output_path("libkatibnative.so")


def dbmanager_path() -> Path:
    return output_path("katib-db-manager")


def load_lib() -> ctypes.CDLL:
    """The loaded runtime library (built at first use) with the store's and
    the parser's C interface declared; raises if it cannot build."""
    global _lib
    if _lib is not None:
        return _lib
    ensure_built()
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(library_path()))
        c = ctypes
        lib.kt_store_new.restype = c.c_void_p
        lib.kt_store_new.argtypes = []
        lib.kt_store_free.argtypes = [c.c_void_p]
        lib.kt_store_report.argtypes = [
            c.c_void_p, c.c_char_p, c.c_char_p, c.c_double, c.c_double, c.c_int64,
        ]
        lib.kt_store_report_batch.argtypes = [
            c.c_void_p, c.c_char_p, c.c_int32,
            c.POINTER(c.c_char_p), c.POINTER(c.c_double),
            c.POINTER(c.c_double), c.POINTER(c.c_int64),
        ]
        lib.kt_store_get.restype = c.c_void_p
        lib.kt_store_get.argtypes = [c.c_void_p, c.c_char_p, c.c_char_p]
        lib.kt_store_delete.argtypes = [c.c_void_p, c.c_char_p]
        lib.kt_store_total.restype = c.c_int64
        lib.kt_store_total.argtypes = [c.c_void_p]
        lib.kt_store_trial_names.restype = c.c_void_p
        lib.kt_store_trial_names.argtypes = [c.c_void_p]
        lib.kt_query_len.restype = c.c_int32
        lib.kt_query_len.argtypes = [c.c_void_p]
        lib.kt_query_names_blob.restype = c.c_char_p
        lib.kt_query_names_blob.argtypes = [c.c_void_p]
        lib.kt_query_values.argtypes = [c.c_void_p, c.POINTER(c.c_double)]
        lib.kt_query_timestamps.argtypes = [c.c_void_p, c.POINTER(c.c_double)]
        lib.kt_query_steps.argtypes = [c.c_void_p, c.POINTER(c.c_int64)]
        lib.kt_query_free.argtypes = [c.c_void_p]
        lib.kt_parse_text.restype = c.c_void_p
        lib.kt_parse_text.argtypes = [c.c_char_p, c.c_char_p]
        lib.ktl_open.restype = c.c_void_p
        lib.ktl_open.argtypes = [
            c.c_char_p, c.c_uint64, c.c_uint64, c.c_uint64,
            c.c_uint64, c.c_uint32, c.c_uint32, c.c_uint64,
        ]
        lib.ktl_next.restype = c.c_int64
        lib.ktl_next.argtypes = [c.c_void_p, c.c_char_p]
        lib.ktl_epoch.restype = c.c_uint64
        lib.ktl_epoch.argtypes = [c.c_void_p]
        lib.ktl_batches_per_epoch.restype = c.c_uint64
        lib.ktl_batches_per_epoch.argtypes = [c.c_void_p]
        lib.ktl_close.restype = None
        lib.ktl_close.argtypes = [c.c_void_p]
        _lib = lib
        return lib
