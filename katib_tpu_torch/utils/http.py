"""Shared helpers for the framework's ``http.server``-based endpoints (the
suggestion service, and the UI backend once it is ported) — one
implementation of bearer-token auth and JSON body reading so the servers
cannot drift.  Copy of ``katib_tpu/utils/http.py``."""

from __future__ import annotations

import functools as _functools
import hmac
import json


def bearer_authorized(headers, token: str | None) -> bool:
    """Constant-time check of ``Authorization: Bearer <token>``; a ``None``
    token means the endpoint is open.  Any undecodable/malformed header is
    an auth failure, never an exception (a 500 would leak whether a token is
    configured)."""
    if token is None:
        return True
    try:
        got = headers.get("Authorization", "") or ""
        return hmac.compare_digest(got.encode("utf-8"), f"Bearer {token}".encode("utf-8"))
    except (UnicodeError, TypeError):
        return False


def local_host_allowed(headers) -> bool:
    """DNS-rebinding guard for token-less servers: the Content-Type check
    stops cross-origin *requests*, but a malicious domain can rebind its DNS
    to 127.0.0.1 and become same-origin — so when no bearer token protects
    the writes, the ``Host`` header must name this machine (localhost, its
    hostname, or one of its addresses; extend via ``KATIB_ALLOWED_HOSTS``,
    comma-separated).  Token-protected deployments skip this check — the
    token already gates the write, and their legit DNS names are unknowable
    here."""
    import os
    from urllib.parse import urlsplit

    try:
        name = (urlsplit("//" + (headers.get("Host") or "")).hostname or "").lower()
    except ValueError:
        return False
    if not name:
        return False
    allowed = set(_machine_hosts())
    extra = os.environ.get("KATIB_ALLOWED_HOSTS", "")
    allowed.update(h.strip().lower() for h in extra.split(",") if h.strip())
    return name in allowed


_HOSTS_TTL_S = 60.0
_hosts_cache: tuple[float, frozenset[str]] | None = None


def _machine_hosts() -> frozenset[str]:
    """This machine's names/addresses.  ``gethostbyname_ex`` can mean a real
    (slow) DNS query, so don't resolve per request — but don't cache forever
    either: a resolver that was down at first request, or an address that
    changed (DHCP), must converge within the TTL instead of pinning a
    degraded set for the process lifetime."""
    global _hosts_cache
    import time

    now = time.monotonic()
    if _hosts_cache is not None and now - _hosts_cache[0] < _HOSTS_TTL_S:
        return _hosts_cache[1]
    import socket

    allowed = {"localhost", "127.0.0.1", "::1"}
    try:
        hostname = socket.gethostname().lower()
        allowed.add(hostname)
        allowed.update(socket.gethostbyname_ex(hostname)[2])
    except OSError:
        pass
    _hosts_cache = (now, frozenset(allowed))
    return _hosts_cache[1]


def json_content_type(headers) -> bool:
    """True iff the request declares ``Content-Type: application/json``.
    Enforcing this on state-changing endpoints is the CSRF guard: a JSON
    content type can't ride a browser's "simple" cross-origin request, so
    the attempt dies in a CORS preflight this server never answers."""
    ctype = (headers.get("Content-Type") or "").split(";")[0].strip().lower()
    return ctype == "application/json"


def read_json_body(handler) -> dict:
    """Read and parse the request body of a ``BaseHTTPRequestHandler`` as a
    JSON object.  Raises ``ValueError`` on anything malformed."""
    n = int(handler.headers.get("Content-Length", 0))
    payload = json.loads(handler.rfile.read(n) or b"{}")
    if not isinstance(payload, dict):
        raise ValueError("body must be a JSON object")
    return payload
