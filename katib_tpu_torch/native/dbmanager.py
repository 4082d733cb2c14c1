"""Client and spawn helper of the native ``katib-db-manager`` daemon (port
of ``katib_tpu/native/dbmanager.py``).

The daemon (``src/dbmanager.cc``) is the cross-process metrics front door,
the counterpart of the reference's standalone DB-manager gRPC service
(``cmd/db-manager/v1beta1/main.go:51-70``): black-box trials and workers in
other processes report through :class:`RemoteObservationStore`; in-process
trials use their store directly.

The wire protocol (length-prefixed little-endian frames, documented in
``dbmanager.cc``) and the journal (the mutating request frames, appended)
are the JAX package's: a client of either package talks to a daemon of the
other, and a journal written by either daemon replays in the other.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Iterable

from katib_tpu_torch.core.types import MetricLog
from katib_tpu_torch.native.build import dbmanager_path, ensure_built
from katib_tpu_torch.store.base import ObservationStore

_OP_REPORT, _OP_GET, _OP_DELETE, _OP_PING = 1, 2, 3, 4
DEFAULT_PORT = 6789


def _str16(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<H", len(b)) + b


class RemoteObservationStore(ObservationStore):
    """Observation store speaking the db-manager wire protocol over one
    persistent socket (one reconnect on a stale socket)."""

    def __init__(self, host: str = "127.0.0.1", port: int = DEFAULT_PORT, timeout: float = 10.0):
        self.host, self.port, self.timeout = host, port, timeout
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None

    def _connect(self) -> socket.socket:
        sock = socket.create_connection((self.host, self.port), timeout=self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    @staticmethod
    def _recv_exact(sock: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("db-manager closed connection")
            buf += chunk
        return buf

    def _call(self, payload: bytes) -> bytes:
        with self._lock:
            for attempt in (0, 1):  # one reconnect on a stale socket
                if self._sock is None:
                    self._sock = self._connect()
                sent = False
                try:
                    self._sock.sendall(struct.pack("<I", len(payload)) + payload)
                    sent = True
                    (rlen,) = struct.unpack("<I", self._recv_exact(self._sock, 4))
                    resp = self._recv_exact(self._sock, rlen)
                    break
                except (OSError, ConnectionError):
                    try:
                        self._sock.close()
                    finally:
                        self._sock = None
                    # retry only a frame that never went out: after a send the
                    # daemon may have applied it, and a second REPORT would
                    # duplicate its points
                    if attempt or sent:
                        raise
            if not resp or resp[0] != 0:
                raise RuntimeError("db-manager rejected request")
            return resp[1:]

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None

    def report(self, trial_name: str, logs: Iterable[MetricLog]) -> None:
        logs = list(logs)
        if not logs:
            return
        parts = [struct.pack("<B", _OP_REPORT), _str16(trial_name), struct.pack("<I", len(logs))]
        for log in logs:
            parts.append(_str16(log.metric_name))
            parts.append(struct.pack("<ddq", log.value, log.timestamp, log.step))
        self._call(b"".join(parts))

    def get(self, trial_name: str, metric_name: str | None = None) -> list[MetricLog]:
        body = self._call(struct.pack("<B", _OP_GET) + _str16(trial_name)
                          + _str16(metric_name or ""))
        (n,) = struct.unpack_from("<I", body, 0)
        off = 4
        out: list[MetricLog] = []
        for _ in range(n):
            (nlen,) = struct.unpack_from("<H", body, off)
            off += 2
            name = body[off : off + nlen].decode()
            off += nlen
            value, ts, step = struct.unpack_from("<ddq", body, off)
            off += 24
            out.append(MetricLog(metric_name=name, value=value, timestamp=ts, step=step))
        return out

    def delete(self, trial_name: str) -> None:
        self._call(struct.pack("<B", _OP_DELETE) + _str16(trial_name))

    def ping(self) -> int:
        """Liveness probe; returns the daemon's total stored point count."""
        (total,) = struct.unpack("<q", self._call(struct.pack("<B", _OP_PING)))
        return total


class DbManagerHandle:
    def __init__(self, proc: subprocess.Popen, host: str, port: int):
        self.proc, self.host, self.port = proc, host, port

    def client(self) -> RemoteObservationStore:
        return RemoteObservationStore(self.host, self.port)

    def stop(self) -> None:
        self.proc.terminate()
        try:
            self.proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


# resolved at import: no dlopen or symbol lookup may run in the post-fork
# preexec_fn (allocator locks held by other threads); without prctl
# (macOS, musl) the daemon is not tied to its parent's life
try:
    _libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6", use_errno=True)
    _prctl = _libc.prctl if sys.platform.startswith("linux") else None
except OSError:  # pragma: no cover - non-glibc platforms
    _prctl = None


def _set_pdeathsig() -> None:
    """In the child: die by SIGKILL when the parent exits (Linux prctl), so
    a daemon spawned by a wrapper cannot outlive it, even a wrapper killed
    by SIGKILL."""
    PR_SET_PDEATHSIG = 1
    if _prctl is not None:
        _prctl(PR_SET_PDEATHSIG, signal.SIGKILL)


def spawn_db_manager(host: str = "127.0.0.1", port: int = 0, db_path: str | None = None,
                     kill_on_parent_exit: bool = False) -> DbManagerHandle:
    """Start the daemon (port 0: an ephemeral port) and wait until it
    listens; raises if the runtime cannot build or the daemon does not
    start within 10 s.

    ``db_path`` turns on the append-only frame journal: acknowledged
    mutations survive a daemon crash and replay at the next start.
    ``kill_on_parent_exit`` ties the daemon's life to the caller's
    (``PR_SET_PDEATHSIG``; the ``db-manager`` verb uses it)."""
    ensure_built()
    cmd = [str(dbmanager_path()), "--host", host, "--port", str(port)]
    if db_path is not None:
        cmd += ["--db", db_path]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                            preexec_fn=_set_pdeathsig if kill_on_parent_exit else None)
    assert proc.stdout is not None
    deadline = time.monotonic() + 10.0
    line = ""
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if line.startswith("LISTENING "):
            return DbManagerHandle(proc, host, int(line.split()[1]))
        if proc.poll() is not None:
            break
    proc.kill()
    proc.wait()
    raise RuntimeError(f"db-manager failed to start (last output: {line!r})")
