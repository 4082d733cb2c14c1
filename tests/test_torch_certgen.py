"""The port's TLS layer (``katib_tpu_torch/utils/certgen.py``): the
counterpart of ``tests/test_certgen.py`` on the suggestion service.

The bundle is the JAX package's (CA ``katib-ca``/``katib``, the leaf's
SANs, 0600 key, no CA key on disk), the rotator reuses a fresh bundle and
replaces an expiring, mismatched or incomplete one, and a bundle minted by
either package's ``certgen`` serves one package's suggestion service to the
other package's ``client_ssl_context``."""

from __future__ import annotations

import datetime
import json
import os
import ssl
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

from katib_tpu.suggest import service as jservice
from katib_tpu.utils import certgen as jcertgen
from katib_tpu_torch.suggest import service as tservice
from katib_tpu_torch.utils import certgen as tcertgen
from katib_tpu_torch.utils.certgen import (
    CA_NAME,
    ORGANIZATION,
    client_ssl_context,
    ensure_certs,
    generate_certs,
    server_ssl_context,
)

PKGS = {
    "jax": SimpleNamespace(certgen=jcertgen,
                           serve=lambda **kw: jservice.serve_suggestions(**kw)),
    "torch": SimpleNamespace(certgen=tcertgen,
                             serve=lambda **kw: tservice.serve_suggestions(device="cpu", **kw)),
}


def _load(path):
    from cryptography import x509

    with open(path, "rb") as f:
        return x509.load_pem_x509_certificate(f.read())


class TestGeneration:
    def test_bundle_files_and_permissions(self, tmp_path):
        b = generate_certs(str(tmp_path / "certs"))
        assert os.path.exists(b.ca_cert) and os.path.exists(b.cert) and os.path.exists(b.key)
        assert (os.stat(b.key).st_mode & 0o777) == 0o600
        # the CA private key is not persisted (rotation regenerates)
        assert sorted(os.listdir(tmp_path / "certs")) == ["ca.crt", "tls.crt", "tls.key"]

    def test_ca_signs_leaf_with_reference_names(self, tmp_path):
        from cryptography.x509.oid import NameOID

        b = generate_certs(str(tmp_path), dns_names=("suggest.local", "localhost"))
        ca, leaf = _load(b.ca_cert), _load(b.cert)
        assert ca.subject.get_attributes_for_oid(NameOID.COMMON_NAME)[0].value == CA_NAME
        assert ca.subject.get_attributes_for_oid(
            NameOID.ORGANIZATION_NAME)[0].value == ORGANIZATION
        assert (CA_NAME, ORGANIZATION) == (jcertgen.CA_NAME, jcertgen.ORGANIZATION)
        assert leaf.issuer == ca.subject
        leaf.verify_directly_issued_by(ca)  # raises on a bad signature

    def test_leaf_sans(self, tmp_path):
        from cryptography import x509

        b = generate_certs(str(tmp_path), dns_names=("a.example",),
                           ip_addresses=("127.0.0.1",))
        san = _load(b.cert).extensions.get_extension_for_class(
            x509.SubjectAlternativeName).value
        assert "a.example" in san.get_values_for_type(x509.DNSName)
        assert [str(i) for i in san.get_values_for_type(x509.IPAddress)] == ["127.0.0.1"]

    def test_ensure_reuses_fresh_bundle(self, tmp_path):
        serial = _load(ensure_certs(str(tmp_path)).cert).serial_number
        assert _load(ensure_certs(str(tmp_path)).cert).serial_number == serial

    def test_ensure_rotates_expiring_leaf(self, tmp_path):
        serial = _load(ensure_certs(str(tmp_path)).cert).serial_number
        # a leaf with fewer than rotate_before_days of life left is replaced
        b2 = ensure_certs(str(tmp_path), rotate_before_days=400)
        assert _load(b2.cert).serial_number != serial

    def test_ensure_rotates_on_san_mismatch(self, tmp_path):
        serial = _load(ensure_certs(str(tmp_path), dns_names=("localhost",)).cert).serial_number
        b2 = ensure_certs(str(tmp_path), dns_names=("localhost", "other.host"))
        assert _load(b2.cert).serial_number != serial
        b3 = ensure_certs(str(tmp_path), dns_names=("localhost", "other.host"))
        assert _load(b3.cert).serial_number == _load(b2.cert).serial_number

    def test_ensure_regenerates_missing_file(self, tmp_path):
        b1 = ensure_certs(str(tmp_path))
        os.remove(b1.key)
        b2 = ensure_certs(str(tmp_path))
        assert os.path.exists(b2.key)
        server_ssl_context(b2)  # key and cert match again

    def test_leaf_validity_window(self, tmp_path):
        leaf = _load(generate_certs(str(tmp_path)).cert)
        now = datetime.datetime.now(datetime.timezone.utc)
        assert leaf.not_valid_before_utc <= now <= leaf.not_valid_after_utc

    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_each_package_reuses_the_others_bundle(self, writer, tmp_path):
        """The files on disk are one format: the other package's rotator
        keeps a fresh bundle it did not write."""
        reader = "torch" if writer == "jax" else "jax"
        b = PKGS[writer].certgen.ensure_certs(str(tmp_path))
        serial = _load(b.cert).serial_number
        again = PKGS[reader].certgen.ensure_certs(str(tmp_path))
        assert again.cert == b.cert and _load(again.cert).serial_number == serial


class TestHttpsServing:
    def test_suggest_service_over_tls(self, tmp_path):
        bundle = ensure_certs(str(tmp_path))
        svc = tservice.serve_suggestions(ssl_context=server_ssl_context(bundle), device="cpu")
        try:
            ctx = client_ssl_context(bundle.ca_cert)
            with urllib.request.urlopen(f"https://127.0.0.1:{svc.port}/healthz", timeout=5,
                                        context=ctx) as r:
                assert json.loads(r.read())["status"] == "serving"
            # a client with the default trust (no pin of our CA) is refused
            with pytest.raises((urllib.error.URLError, ssl.SSLError)):
                urllib.request.urlopen(f"https://127.0.0.1:{svc.port}/healthz", timeout=5)
        finally:
            svc.stop()

    def test_plain_http_client_fails_against_tls_server(self, tmp_path):
        bundle = ensure_certs(str(tmp_path))
        svc = tservice.serve_suggestions(ssl_context=server_ssl_context(bundle), device="cpu")
        try:
            with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
                urllib.request.urlopen(f"http://127.0.0.1:{svc.port}/healthz", timeout=5)
        finally:
            svc.stop()

    @pytest.mark.parametrize("minted_by,served_by", [("jax", "torch"), ("torch", "jax")])
    def test_a_bundle_of_one_package_verified_by_the_others_client(self, minted_by, served_by,
                                                                  tmp_path):
        """Minted by one package's certgen, served by one package's service,
        trusted through the other package's ``client_ssl_context`` — and a
        remote suggester pinning the CA gets its suggestions."""
        trusting = "torch" if minted_by == "jax" else "jax"
        bundle = PKGS[minted_by].certgen.ensure_certs(str(tmp_path))
        svc = PKGS[served_by].serve(
            ssl_context=PKGS[minted_by].certgen.server_ssl_context(bundle))
        try:
            ctx = PKGS[trusting].certgen.client_ssl_context(bundle.ca_cert)
            with urllib.request.urlopen(f"https://127.0.0.1:{svc.port}/healthz", timeout=5,
                                        context=ctx) as r:
                assert json.loads(r.read())["status"] == "serving"
            from katib_tpu_torch.core import types as t

            spec = t.ExperimentSpec(
                name="tls-exp",
                algorithm=t.AlgorithmSpec(name="remote", settings={
                    "endpoint": f"https://127.0.0.1:{svc.port}", "algorithm": "random",
                    "ca_cert": bundle.ca_cert}),
                objective=t.ObjectiveSpec(type=t.ObjectiveType.MAXIMIZE,
                                          objective_metric_name="accuracy"),
                parameters=[t.ParameterSpec("x", t.ParameterType.DOUBLE,
                                            t.FeasibleSpace(min=0.0, max=1.0))],
                max_trial_count=2,
            )
            sug = tservice.RemoteSuggester(spec)
            assert len(sug.get_suggestions(t.Experiment(spec=spec), 2)) == 2
        finally:
            svc.stop()
