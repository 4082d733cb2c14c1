"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).  The
library lands in ``build/katib_tpu_torch/`` beside the package, named by a
digest of its source and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Sources that need building are compiled
by one ``nvcc`` process each, all started together.  ``ptxas -v``'s report
(registers and spills of every kernel) is kept beside each library.

With an artifact tier wired (``compile/artifacts.py``: a compile cache's
local tier, or ``KATIB_ARTIFACT_DIR`` / a spec's ``artifactDir``), a missing
library is first fetched from the tiers, with its log, and a library that
``nvcc`` built is published to them.  Without a tier, nothing is fetched or
published.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "katib_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def _tiers():
    """The artifact cache when a tier is wired, else None."""
    from katib_tpu_torch.compile.artifacts import ARTIFACTS

    return ARTIFACTS if ARTIFACTS.enabled() else None


def build(names: list[str]) -> dict[str, float]:
    """Compile the libraries of ``names`` that are not built yet, in parallel.

    Returns the seconds each compile took (0 for a library already built; a
    library fetched from an artifact tier, the seconds its fetch took).
    Raises with the compiler's output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    started = time.perf_counter()
    seconds = {name: 0.0 for name in names}
    tiers = _tiers()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        if tiers is not None:
            from katib_tpu_torch.compile.artifacts import fetch_kernel

            t0 = time.perf_counter()
            if fetch_kernel(name, tiers) is not None:
                seconds[name] = time.perf_counter() - t0
                continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - started
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: another process loading it sees a whole file
    if failures:
        raise RuntimeError("\n".join(failures))
    if tiers is not None and procs:
        from katib_tpu_torch.compile.artifacts import publish_kernel

        for name in procs:
            publish_kernel(name, tiers)
    return seconds


def _demangle(names: list[str]) -> list[str]:
    """C++ symbol names demangled by ``c++filt`` where it is installed."""
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    lines = out.stdout.splitlines()
    return lines if out.returncode == 0 and len(lines) == len(names) else names


def ptxas_report(name: str) -> dict[str, tuple[int, int]]:
    """``{kernel: (registers, spilled bytes stored + loaded)}`` for every
    kernel of the built ``csrc/<name>.cu``, from the compiler's log."""
    rows, kernel, spilled = [], None, 0
    for line in library_path(name).with_suffix(".log").read_text().splitlines():
        if m := re.search(r"Compiling entry function '(.*?)' for", line):
            kernel = m[1]
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spilled = int(m[1]) + int(m[2])
        elif (m := re.search(r"Used (\d+) registers", line)) and kernel is not None:
            rows.append((kernel, int(m[1]), spilled))
    report = {}
    for full, (_, registers, spilled) in zip(_demangle([r[0] for r in rows]), rows):
        short = re.search(r"(\w+(?:<[^<>()]*>)?)\(", full)  # drop scope and arguments
        report[short[1] if short else full] = (registers, spilled)
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib
