"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).  The
library lands in ``build/katib_tpu_torch/`` beside the package, named by a
digest of its source and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Sources that need building are compiled
by one ``nvcc`` process each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "katib_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: list[str]) -> dict[str, float]:
    """Compile the libraries of ``names`` that are not built yet, in parallel.

    Returns the seconds each compile took (0 for a library already built).
    Raises with the compiler's output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    started = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - started
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: another process loading it sees a whole file
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib
