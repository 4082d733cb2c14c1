"""Self-signed certificate generation + rotation for the framework's network
surfaces (UI backend, suggestion service).

The reference runs a cert-controller rotator that maintains a self-signed CA
("katib-ca", org "katib") and a webhook serving cert for the service DNS name,
regenerating before expiry (``pkg/certgenerator/v1beta1/generator.go:37-58``).
Here the same contract is a library: ``ensure_certs`` is the rotator (generate
if absent, regenerate inside the expiry grace window), and the PEM bundle on
disk is the Secret analog.  Servers wrap their listening socket with
``server_ssl_context``; clients verify against the CA with
``client_ssl_context`` — no system trust store involvement, exactly like the
reference injecting its CA bundle into the webhook clientConfig.

Copy of ``katib_tpu/utils/certgen.py``: the bundle on disk is the same, so
either package's client verifies either package's server.  ``cryptography``
(the ``tls`` extra) is imported only inside the functions that need it.
"""

from __future__ import annotations

import datetime
import ipaddress
import os
from dataclasses import dataclass

CA_NAME = "katib-ca"
ORGANIZATION = "katib"
# cert-controller defaults: 10y CA, 1y leaf, rotate when <90d remain
CA_VALIDITY_DAYS = 3650
LEAF_VALIDITY_DAYS = 365
ROTATE_BEFORE_DAYS = 90


@dataclass(frozen=True)
class CertBundle:
    """Paths of the PEM material one server needs (the Secret analog)."""

    ca_cert: str
    cert: str
    key: str


def _paths(cert_dir: str) -> CertBundle:
    return CertBundle(
        ca_cert=os.path.join(cert_dir, "ca.crt"),
        cert=os.path.join(cert_dir, "tls.crt"),
        key=os.path.join(cert_dir, "tls.key"),
    )


def _write_private(path: str, data: bytes) -> None:
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "wb") as f:
        f.write(data)


def generate_certs(
    cert_dir: str,
    dns_names: tuple[str, ...] = ("localhost",),
    ip_addresses: tuple[str, ...] = ("127.0.0.1",),
) -> CertBundle:
    """Create a fresh CA + server leaf under ``cert_dir`` (overwrites).

    Mirrors the rotator's shape: CA CN ``katib-ca`` / org ``katib``; the leaf
    carries the server's DNS/IP SANs the way the reference leaf carries
    ``<service>.<namespace>.svc``.  Keys are written 0600; certs 0644.
    """
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID

    os.makedirs(cert_dir, exist_ok=True)
    paths = _paths(cert_dir)
    now = datetime.datetime.now(datetime.timezone.utc)

    ca_key = ec.generate_private_key(ec.SECP256R1())
    ca_subject = x509.Name(
        [
            x509.NameAttribute(NameOID.COMMON_NAME, CA_NAME),
            x509.NameAttribute(NameOID.ORGANIZATION_NAME, ORGANIZATION),
        ]
    )
    ca_cert = (
        x509.CertificateBuilder()
        .subject_name(ca_subject)
        .issuer_name(ca_subject)
        .public_key(ca_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=CA_VALIDITY_DAYS))
        .add_extension(x509.BasicConstraints(ca=True, path_length=0), critical=True)
        .add_extension(
            x509.KeyUsage(
                digital_signature=True,
                key_cert_sign=True,
                crl_sign=True,
                content_commitment=False,
                key_encipherment=False,
                data_encipherment=False,
                key_agreement=False,
                encipher_only=False,
                decipher_only=False,
            ),
            critical=True,
        )
        .sign(ca_key, hashes.SHA256())
    )

    leaf_key = ec.generate_private_key(ec.SECP256R1())
    sans: list[x509.GeneralName] = [x509.DNSName(d) for d in dns_names]
    sans += [x509.IPAddress(ipaddress.ip_address(i)) for i in ip_addresses]
    leaf_cert = (
        x509.CertificateBuilder()
        .subject_name(
            x509.Name(
                [
                    x509.NameAttribute(NameOID.COMMON_NAME, dns_names[0]),
                    x509.NameAttribute(NameOID.ORGANIZATION_NAME, ORGANIZATION),
                ]
            )
        )
        .issuer_name(ca_subject)
        .public_key(leaf_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=LEAF_VALIDITY_DAYS))
        .add_extension(x509.SubjectAlternativeName(sans), critical=False)
        .add_extension(x509.BasicConstraints(ca=False, path_length=None), critical=True)
        .add_extension(
            x509.ExtendedKeyUsage([ExtendedKeyUsageOID.SERVER_AUTH]), critical=False
        )
        .sign(ca_key, hashes.SHA256())
    )

    with open(paths.ca_cert, "wb") as f:
        f.write(ca_cert.public_bytes(serialization.Encoding.PEM))
    with open(paths.cert, "wb") as f:
        f.write(leaf_cert.public_bytes(serialization.Encoding.PEM))
        # servers load cert+chain from one file; append the CA so clients
        # that did not pin ca.crt can still build the chain
        f.write(ca_cert.public_bytes(serialization.Encoding.PEM))
    _write_private(
        paths.key,
        leaf_key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        ),
    )
    # the CA key is intentionally NOT persisted: nothing needs to issue a
    # second leaf from the same CA, and a missing key cannot leak (the
    # rotator regenerates the whole bundle instead of re-issuing)
    return paths


def _load_leaf(cert_path: str):
    from cryptography import x509

    try:
        with open(cert_path, "rb") as f:
            return x509.load_pem_x509_certificate(f.read())
    except (OSError, ValueError):
        return None


def _leaf_covers(leaf, dns_names, ip_addresses) -> bool:
    """True iff every requested SAN is already on the leaf — a bundle
    generated for a different --host must be rotated even if unexpired."""
    from cryptography import x509

    try:
        san = leaf.extensions.get_extension_for_class(x509.SubjectAlternativeName).value
    except x509.ExtensionNotFound:
        return False
    have_dns = set(san.get_values_for_type(x509.DNSName))
    have_ips = {str(i) for i in san.get_values_for_type(x509.IPAddress)}
    return set(dns_names) <= have_dns and set(ip_addresses) <= have_ips


def ensure_certs(
    cert_dir: str,
    dns_names: tuple[str, ...] = ("localhost",),
    ip_addresses: tuple[str, ...] = ("127.0.0.1",),
    rotate_before_days: float = ROTATE_BEFORE_DAYS,
) -> CertBundle:
    """The rotator: return the existing bundle if every file is present, the
    leaf is outside the rotation window, AND its SANs cover the requested
    names (a bundle minted for another host must not be silently reused —
    pinned clients would fail verification for a year)."""
    paths = _paths(cert_dir)
    complete = all(os.path.exists(p) for p in (paths.ca_cert, paths.cert, paths.key))
    if complete:
        leaf = _load_leaf(paths.cert)
        if leaf is not None and _leaf_covers(leaf, dns_names, ip_addresses):
            remaining = leaf.not_valid_after_utc - datetime.datetime.now(
                datetime.timezone.utc
            )
            if remaining > datetime.timedelta(days=rotate_before_days):
                return paths
    return generate_certs(cert_dir, dns_names, ip_addresses)


def server_ssl_context(bundle: CertBundle):
    """TLS-server context for wrapping an ``http.server`` socket."""
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(bundle.cert, bundle.key)
    return ctx


def wrap_server_socket(ssl_context, sock):
    """Wrap a listening socket for a threading HTTP server WITHOUT doing the
    handshake in ``accept()``: with ``do_handshake_on_connect=True`` a client
    that connects and never sends a ClientHello would block the single accept
    loop and wedge every other client.  Deferred, the handshake happens on
    first read inside the per-connection handler thread (which must set a
    socket timeout to bound a stalled peer)."""
    return ssl_context.wrap_socket(
        sock, server_side=True, do_handshake_on_connect=False
    )


def client_ssl_context(ca_cert_path: str):
    """Client context that trusts ONLY the generated CA (full hostname
    verification stays on) — the CABundle-injection analog."""
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_verify_locations(cafile=ca_cert_path)
    return ctx
