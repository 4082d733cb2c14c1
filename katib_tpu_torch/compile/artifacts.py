"""The port's compiled CUDA kernel libraries in a content-addressed, tiered
artifact cache (port of ``katib_tpu/compile/artifacts.py``).

The JAX package serializes AOT-compiled XLA executables so a fresh host's
first step fetches instead of compiling.  The port compiles two kinds of
thing: its step programs, captured as CUDA graphs per trial (a capture has
no serialized form and dies with its process), and its hand-written
kernels, built by ``nvcc`` into shared libraries at first use
(``ops/_build.py``).  A library outlives its process and can be copied
between hosts that share the toolchain and the card, so the libraries are
this tier's payload.

Lookup order (cheapest first)::

    the build directory -> local tier (<compile_cache>/torch/artifacts)
        -> shared tier (KATIB_ARTIFACT_DIR / ExperimentSpec.artifact_dir)
        -> nvcc

An envelope is ``MAGIC + header-json + \\n + body``; its body is the raw
``.so`` bytes followed by the ``ptxas`` log (registers and spills of every
kernel, which ``_build.ptxas_report`` reads), their lengths and checksums in
the header.  A body is never a pickle.  Artifacts are content-addressed:
the file name is the SHA-256 of the :class:`CompileSignature` key
(``program="kernel:<name>"``, the SHA-256 of the ``.cu`` source in
``shapes``) plus an environment fingerprint (torch, its CUDA, the ``nvcc``
release, the driver, the card and its compute capability, the nvcc flags).
A changed toolchain or card gives another address, so a stale library is
never looked up.  Anything corrupt, truncated or misaddressed on the fetch
path is quarantined (renamed ``*.quarantined``) and counted; a failed fetch
builds with ``nvcc`` as without a tier.

The port's envelopes have a magic and a suffix of their own
(:data:`MAGIC`, :data:`SUFFIX`), so one directory can serve both packages:
neither package's scan, fsck or ``cache`` reads the other's files.

Not ported: ``resolve()``, ``publish_observed`` and ``fetch_family``'s
dispatch seam, which hand a fetched XLA executable to a model's step; the
port's step program has no serialized form.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from typing import Any, Mapping

from katib_tpu_torch.analysis import guarded_by, make_lock
from katib_tpu_torch.compile.registry import REGISTRY, CompileSignature, _cache_dir
from katib_tpu_torch.utils import observability as obs
from katib_tpu_torch.utils.fsio import atomic_replace

_log = logging.getLogger(__name__)

MAGIC = b"KATIBTORCHSO1\n"
SUFFIX = ".katibso"
QUARANTINE_SUFFIX = ".quarantined"
_ENV_VAR = "KATIB_ARTIFACT_DIR"
#: the program name prefix of a kernel library's signature
KERNEL_PROGRAM = "kernel:"


class ArtifactCorrupt(Exception):
    """Envelope failed integrity verification (magic/header/checksum)."""


class ArtifactMismatch(Exception):
    """Envelope is intact but belongs to a different signature or
    environment than its address claims (tampered or misplaced file)."""


# -- environment fingerprint --------------------------------------------------

_FP_CACHE: dict | None = None


def _cuda_home() -> str | None:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            return os.environ[env]
    found = shutil.which("nvcc")
    if found:
        return os.path.dirname(os.path.dirname(os.path.realpath(found)))
    return "/usr/local/cuda" if os.path.isdir("/usr/local/cuda") else None


def _nvcc_release() -> str:
    """The toolkit's ``nvcc`` version, read from its ``version.json`` (no
    process started); ``nvcc --version``'s release line where the file is
    missing; ``""`` without a toolkit."""
    home = _cuda_home()
    if not home:
        return ""
    try:
        with open(os.path.join(home, "version.json")) as f:
            info = json.load(f)
        return str(info.get("cuda_nvcc", info.get("cuda", {})).get("version", ""))
    except (OSError, ValueError, AttributeError):
        pass
    nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        return ""
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=30)
        lines = [ln for ln in out.stdout.splitlines() if "release" in ln]
        return lines[-1].strip() if lines else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def _driver_version() -> str:
    tool = shutil.which("nvidia-smi")
    if tool is None:
        return ""
    try:
        out = subprocess.run(
            [tool, "--query-gpu=driver_version", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def env_fingerprint(refresh: bool = False) -> dict:
    """The fields that decide whether a kernel library built elsewhere loads
    and runs here: torch and its CUDA, the ``nvcc`` release, the driver,
    the card and its compute capability, and the nvcc flags.  Computed once
    per process (``refresh`` for tests)."""
    global _FP_CACHE
    if _FP_CACHE is not None and not refresh:
        return dict(_FP_CACHE)
    import torch

    from katib_tpu_torch.ops._build import NVCC_FLAGS

    fp = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "",
        "nvcc": _nvcc_release(),
        "driver": _driver_version(),
        "device_name": "",
        "capability": "",
        "nvcc_flags": " ".join(NVCC_FLAGS),
    }
    try:
        if torch.cuda.is_available():
            fp["device_name"] = torch.cuda.get_device_name(0)
            fp["capability"] = "%d.%d" % torch.cuda.get_device_capability(0)
    except Exception:
        pass  # a deviceless environment still fingerprints (coarsely)
    _FP_CACHE = fp
    return dict(fp)


def fingerprint_key(fp: Mapping[str, Any]) -> str:
    return json.dumps(dict(fp), sort_keys=True)


def artifact_name(sig_key: str, fp: Mapping[str, Any]) -> str:
    """Content address: SHA-256 over (signature key, env fingerprint)."""
    digest = hashlib.sha256((sig_key + "\x00" + fingerprint_key(fp)).encode()).hexdigest()
    return digest + SUFFIX


def sig_from_key(key: str) -> CompileSignature:
    """Reconstruct a :class:`CompileSignature` from its ``key()`` json."""
    rec = json.loads(key)
    return CompileSignature(
        program=str(rec.get("program", "?")),
        shapes=tuple((str(a), str(b)) for a, b in rec.get("shapes") or []),
        k=int(rec.get("k", 1)),
        mesh=str(rec.get("mesh", "")),
        donation=bool(rec.get("donation", True)),
    )


# -- envelope (checksummed container) -----------------------------------------


def pack_envelope(
    sig: CompileSignature,
    fp: Mapping[str, Any],
    library: bytes,
    log: str = "",
) -> bytes:
    """``MAGIC + header-json + \\n + body``: the body is the library's bytes
    then the ``ptxas`` log's; the header carries the signature, the
    environment fingerprint, both lengths and the SHA-256 of the body and of
    the library."""
    log_bytes = log.encode("utf-8")
    body = library + log_bytes
    header = {
        "version": 1,
        "key": sig.key(),
        "program": sig.program,
        "k": sig.k,
        "mesh": sig.mesh,
        "shapes": dict(sig.shapes),
        "donation": sig.donation,
        "fingerprint": dict(fp),
        "created": time.time(),
        "library_len": len(library),
        "library_sha256": hashlib.sha256(library).hexdigest(),
        "log_len": len(log_bytes),
        "body_len": len(body),
        "body_sha256": hashlib.sha256(body).hexdigest(),
    }
    return MAGIC + json.dumps(header, sort_keys=True).encode() + b"\n" + body


def _split(data: bytes) -> tuple[dict, bytes]:
    if not data.startswith(MAGIC):
        raise ArtifactCorrupt("bad magic")
    rest = data[len(MAGIC):]
    nl = rest.find(b"\n")
    if nl < 0:
        raise ArtifactCorrupt("no header terminator")
    try:
        header = json.loads(rest[:nl].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ArtifactCorrupt(f"unparseable header: {e}") from e
    if not isinstance(header, dict):
        raise ArtifactCorrupt("header is not an object")
    body = rest[nl + 1:]
    if len(body) != int(header.get("body_len", -1)):
        raise ArtifactCorrupt(f"body length {len(body)} != declared {header.get('body_len')}")
    if hashlib.sha256(body).hexdigest() != header.get("body_sha256"):
        raise ArtifactCorrupt("body checksum mismatch")
    return header, body


def read_header(data: bytes) -> dict:
    """Header-only parse with the envelope's integrity checks (the ``cache``
    and ``fsck`` verbs' inspection)."""
    return _split(data)[0]


def unpack_envelope(data: bytes) -> tuple[dict, dict]:
    """Parse and verify an envelope; returns ``(header, {"library": bytes,
    "log": str})``.  Raises :class:`ArtifactCorrupt` on any structural or
    checksum failure."""
    header, body = _split(data)
    n = int(header.get("library_len", -1))
    if not 0 <= n <= len(body) or int(header.get("log_len", -1)) != len(body) - n:
        raise ArtifactCorrupt("library/log lengths do not add up to the body")
    library = body[:n]
    if hashlib.sha256(library).hexdigest() != header.get("library_sha256"):
        raise ArtifactCorrupt("library checksum mismatch")
    try:
        log = body[n:].decode("utf-8")
    except UnicodeDecodeError as e:
        raise ArtifactCorrupt(f"undecodable ptxas log: {e}") from e
    return header, {"library": library, "log": log}


# -- backends (object-store-shaped) -------------------------------------------


class ArtifactBackend:
    """Minimal blob-store surface a tier needs.  A directory implements it
    today; an object store could implement the same five methods."""

    def get(self, name: str) -> bytes | None:  # pragma: no cover - interface
        raise NotImplementedError

    def put(self, name: str, data: bytes) -> None:  # pragma: no cover
        raise NotImplementedError

    def exists(self, name: str) -> bool:  # pragma: no cover - interface
        raise NotImplementedError

    def list(self) -> list[str]:  # pragma: no cover - interface
        raise NotImplementedError

    def delete(self, name: str) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def quarantine(self, name: str) -> bool:
        """Move a blob out of the lookup namespace, keeping its bytes."""
        data = self.get(name)
        if data is None:
            return False
        self.put(name + QUARANTINE_SUFFIX, data)
        self.delete(name)
        return True

    def describe(self) -> str:  # pragma: no cover - interface
        return type(self).__name__


class DirectoryBackend(ArtifactBackend):
    """Shared-filesystem tier: one envelope file per artifact, published by
    temp file and rename, so no reader sees a torn file.  Lists only the
    port's envelopes (:data:`SUFFIX`)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    def _path(self, name: str) -> str:
        return os.path.join(self.root, os.path.basename(name))

    def get(self, name: str) -> bytes | None:
        try:
            with open(self._path(name), "rb") as f:
                return f.read()
        except OSError:
            return None

    def put(self, name: str, data: bytes) -> None:
        os.makedirs(self.root, exist_ok=True)
        atomic_replace(self._path(name), data, prefix=".pub-")

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))

    def list(self) -> list[str]:
        try:
            return sorted(n for n in os.listdir(self.root) if n.endswith(SUFFIX))
        except OSError:
            return []

    def delete(self, name: str) -> None:
        try:
            os.unlink(self._path(name))
        except OSError:
            pass

    def quarantine(self, name: str) -> bool:
        src = self._path(name)
        try:
            os.replace(src, src + QUARANTINE_SUFFIX)
            return True
        except OSError:
            return False

    def describe(self) -> str:
        return self.root


# -- the tiered cache ---------------------------------------------------------


@dataclass
class LoadedArtifact:
    """A fetched, verified kernel library."""

    sig_key: str
    program: str
    library: bytes
    log: str
    tier: str


class ArtifactCache:
    """Process-wide tiered artifact cache with per-tier hit/miss counters.

    Reached from trial threads (a kernel's first use builds it), the prewarm
    worker and the CLI: the loaded map and the shared-dir setting go through
    ``_lock``."""

    _GUARDS = guarded_by(_lock=("_loaded", "_shared_dir"))

    def __init__(self) -> None:
        self._lock = make_lock("compile.artifacts")
        self._loaded: dict[str, LoadedArtifact] = {}
        self._shared_dir: str | None = None

    # -- configuration -------------------------------------------------------

    def configure(self, shared_dir: str | None = None) -> str | None:
        """Wire the shared tier: ``KATIB_ARTIFACT_DIR`` first, then the
        argument (``ExperimentSpec.artifact_dir``).  The first caller wins;
        a second asking for another directory gets a ``RuntimeWarning``.
        Returns the effective dir (None = shared tier off)."""
        resolved = os.environ.get(_ENV_VAR) or shared_dir
        with self._lock:
            if self._shared_dir is not None:
                if resolved and os.path.abspath(resolved) != self._shared_dir:
                    import warnings

                    warnings.warn(
                        "shared artifact tier already wired to "
                        f"{self._shared_dir!r}; ignoring the requested "
                        f"{os.path.abspath(resolved)!r} (first caller wins)",
                        RuntimeWarning,
                        stacklevel=2,
                    )
                return self._shared_dir
            if not resolved:
                return None
            self._shared_dir = os.path.abspath(resolved)
            return self._shared_dir

    def shared_dir(self) -> str | None:
        with self._lock:
            d = self._shared_dir
        return d or (os.environ.get(_ENV_VAR) or None)

    def local_dir(self) -> str | None:
        """The local tier rides in the port's part of the compile cache
        (``<compile_cache>/torch/artifacts``)."""
        d = _cache_dir()
        return os.path.join(d, "artifacts") if d else None

    def tiers(self) -> list[tuple[str, ArtifactBackend]]:
        """Ordered (name, backend) lookup chain, cheapest first."""
        out: list[tuple[str, ArtifactBackend]] = []
        local = self.local_dir()
        if local:
            out.append(("local", DirectoryBackend(local)))
        shared = self.shared_dir()
        if shared:
            out.append(("shared", DirectoryBackend(shared)))
        return out

    def enabled(self) -> bool:
        return bool(self.tiers())

    # -- publish -------------------------------------------------------------

    def publish(
        self,
        sig: CompileSignature,
        library: bytes,
        log: str = "",
    ) -> list[str]:
        """Publish one library to every configured tier that lacks it (the
        content address dedupes).  Returns the tiers written; never raises."""
        tiers = self.tiers()
        if not tiers:
            return []
        try:
            fp = env_fingerprint()
            data = pack_envelope(sig, fp, library, log)
            name = artifact_name(sig.key(), fp)
        except Exception:
            _log.warning("artifact pack failed for %s", sig.program, exc_info=True)
            return []
        written: list[str] = []
        for tier, backend in tiers:
            try:
                if backend.exists(name):
                    continue  # first writer wins
                backend.put(name, data)
                obs.artifact_publishes.inc(tier=tier)
                written.append(tier)
            except Exception:
                _log.warning("artifact publish to %s tier failed", tier, exc_info=True)
        return written

    # -- fetch ---------------------------------------------------------------

    def fetch(self, sig: CompileSignature) -> LoadedArtifact | None:
        """Walk the tiers for ``sig``'s artifact under this environment's
        fingerprint.  On a hit: verify, promote a shared hit into the local
        tier, record the signature, return it.  On an integrity failure:
        quarantine, count and keep walking.  None on a full miss; never
        raises."""
        try:
            key = sig.key()
            with self._lock:
                loaded = self._loaded.get(key)
            if loaded is not None:
                return loaded
            tiers = self.tiers()
            if not tiers:
                return None
            fp = env_fingerprint()
            name = artifact_name(key, fp)
            for tier, backend in tiers:
                data = backend.get(name)
                if data is None:
                    obs.artifact_misses.inc(tier=tier)
                    continue
                try:
                    la = self._load(tier, data, key, fp)
                except (ArtifactCorrupt, ArtifactMismatch) as e:
                    _log.warning("quarantining %s artifact %s: %s", tier, name, e)
                    try:
                        backend.quarantine(name)
                    except Exception:
                        pass
                    obs.artifact_quarantines.inc(tier=tier)
                    obs.artifact_misses.inc(tier=tier)
                    continue
                obs.artifact_hits.inc(tier=tier)
                if tier != "local":
                    self._promote_local(name, data)
                with self._lock:
                    self._loaded[key] = la
                REGISTRY.record(sig, source=f"artifact:{tier}")
                return la
            return None
        except Exception:
            _log.warning("artifact fetch failed for %s", sig.program, exc_info=True)
            return None

    def _load(self, tier: str, data: bytes, key: str, fp: Mapping[str, Any]) -> LoadedArtifact:
        header, body = unpack_envelope(data)
        if header.get("key") != key:
            raise ArtifactMismatch("signature key != address")
        if header.get("fingerprint") != dict(fp):
            raise ArtifactMismatch("environment fingerprint mismatch")
        return LoadedArtifact(
            sig_key=key,
            program=str(header.get("program", "?")),
            library=body["library"],
            log=body["log"],
            tier=tier,
        )

    def _promote_local(self, name: str, data: bytes) -> None:
        """A shared-tier hit seeds the local tier."""
        local = self.local_dir()
        if not local:
            return
        try:
            backend = DirectoryBackend(local)
            if not backend.exists(name):
                backend.put(name, data)
        except Exception:
            pass  # promotion is an optimization, never a failure

    # -- introspection / tests -----------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            loaded = len(self._loaded)
        tiers = {
            tier: {"dir": backend.describe(), "artifacts": len(backend.list())}
            for tier, backend in self.tiers()
        }
        return {"loaded": loaded, "tiers": tiers}

    def reset(self) -> None:
        """Forget loaded artifacts and the shared-dir setting (tests); the
        tiers on disk are left alone."""
        with self._lock:
            self._loaded.clear()
            self._shared_dir = None


ARTIFACTS = ArtifactCache()


# -- the kernel libraries (ops/_build.py) -------------------------------------


def kernel_signature(name: str) -> CompileSignature:
    """Signature of ``csrc/<name>.cu``'s library: ``kernel:<name>`` and the
    SHA-256 of its source."""
    from katib_tpu_torch.ops._build import CSRC

    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return CompileSignature(program=KERNEL_PROGRAM + name, shapes=(("source_sha256", digest),))


def publish_kernel(name: str, cache: ArtifactCache | None = None) -> list[str]:
    """Publish the built library of ``csrc/<name>.cu`` and its ``ptxas`` log
    to the tiers of ``cache`` (:data:`ARTIFACTS` by default).  Returns the
    tiers written; ``[]`` when the library is not built or no tier is on."""
    from katib_tpu_torch.ops._build import library_path

    cache = ARTIFACTS if cache is None else cache
    path = library_path(name)
    try:
        library = path.read_bytes()
        log = path.with_suffix(".log").read_text()
    except OSError:
        return []
    return cache.publish(kernel_signature(name), library, log)


def fetch_kernel(name: str, cache: ArtifactCache | None = None) -> LoadedArtifact | None:
    """Fetch the library of ``csrc/<name>.cu`` from the tiers of ``cache``
    and install it and its log at ``_build.library_path(name)``, the log
    first and each by temp file and rename.  None on a miss."""
    from katib_tpu_torch.ops._build import library_path

    cache = ARTIFACTS if cache is None else cache
    la = cache.fetch(kernel_signature(name))
    if la is None:
        return None
    out = library_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    atomic_replace(str(out.with_suffix(".log")), la.log.encode("utf-8"), prefix=".fetch-")
    atomic_replace(str(out), la.library, prefix=".fetch-")
    return la


# -- artifact-dir maintenance (fsck / cache verbs) ----------------------------


@dataclass
class ArtifactFsckReport:
    """What ``fsck`` found (and fixed) in an artifact dir."""

    root: str = ""
    scanned: int = 0
    valid: int = 0
    stale: list[str] = field(default_factory=list)  # other-env, intact
    corrupt: list[str] = field(default_factory=list)
    quarantined: list[str] = field(default_factory=list)
    misaddressed: list[str] = field(default_factory=list)

    @property
    def consistent(self) -> bool:
        """True when every remaining envelope is intact and correctly
        addressed (stale ones serve the environment that published them)."""
        bad = set(self.corrupt) | set(self.misaddressed)
        return not (bad - set(self.quarantined))

    def summary(self) -> str:
        return (
            f"{self.scanned} artifact(s): {self.valid} valid, "
            f"{len(self.stale)} stale(other-env), "
            f"{len(self.corrupt)} corrupt, "
            f"{len(self.misaddressed)} misaddressed, "
            f"{len(self.quarantined)} quarantined"
        )


def is_artifact_dir(path: str) -> bool:
    """True when ``path`` holds the port's envelopes, or is named
    ``artifacts`` (``fsck``'s dispatch: an experiment workdir and an
    artifact tier share one verb)."""
    try:
        names = os.listdir(path)
    except OSError:
        return False
    if any(n.endswith((SUFFIX, SUFFIX + QUARANTINE_SUFFIX)) for n in names):
        return True
    return os.path.basename(os.path.normpath(path)) == "artifacts"


def fsck_artifacts(path: str, repair: bool = True) -> ArtifactFsckReport:
    """Verify every port envelope under an artifact dir: integrity, checksum,
    and address (file name == content address of its own header).
    ``repair`` quarantines corrupt and misaddressed files; stale ones are
    reported and left."""
    backend = DirectoryBackend(path)
    report = ArtifactFsckReport(root=backend.root)
    fp_now = fingerprint_key(env_fingerprint())
    for name in backend.list():
        report.scanned += 1
        data = backend.get(name)
        if data is None:
            continue  # raced a concurrent quarantine/delete
        try:
            header = unpack_envelope(data)[0]
        except ArtifactCorrupt:
            report.corrupt.append(name)
            if repair and backend.quarantine(name):
                report.quarantined.append(name)
                obs.artifact_quarantines.inc(tier="fsck")
            continue
        expect = artifact_name(str(header.get("key", "")), header.get("fingerprint") or {})
        if expect != name:
            report.misaddressed.append(name)
            if repair and backend.quarantine(name):
                report.quarantined.append(name)
                obs.artifact_quarantines.inc(tier="fsck")
            continue
        if fingerprint_key(header.get("fingerprint") or {}) != fp_now:
            report.stale.append(name)
        else:
            report.valid += 1
    return report


def scan_dir(path: str) -> list[dict]:
    """Header inventory of an artifact dir (the ``cache`` verb's table): one
    row per port envelope with its identity, size and whether this host's
    fingerprint can load it (``ok``) or not (``stale``)."""
    backend = DirectoryBackend(path)
    fp_now = fingerprint_key(env_fingerprint())
    rows: list[dict] = []
    for name in backend.list():
        data = backend.get(name)
        if data is None:
            continue
        row: dict = {"name": name, "bytes": len(data)}
        try:
            header = unpack_envelope(data)[0]
        except ArtifactCorrupt as e:
            row.update(status="corrupt", error=str(e))
            rows.append(row)
            continue
        fp = header.get("fingerprint") or {}
        row.update(
            status="ok" if fingerprint_key(fp) == fp_now else "stale",
            program=header.get("program", "?"),
            k=header.get("k", 1),
            library_bytes=header.get("library_len", 0),
            library_sha256=header.get("library_sha256", ""),
            torch=fp.get("torch", "?"),
            nvcc=fp.get("nvcc", "?"),
            device_name=fp.get("device_name", "?"),
            capability=fp.get("capability", "?"),
            created=header.get("created", 0),
        )
        rows.append(row)
    return rows
