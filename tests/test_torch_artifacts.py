"""The port's artifact tier (``katib_tpu_torch/compile/artifacts.py``): the
counterparts of ``tests/test_artifacts.py``'s cases with a small byte
payload in place of a kernel library, and the tier's use by the kernel
build (``ops/_build.py``).

The envelope's corruption matrix; publish and fetch with bytes and log
returned as published; the content address dedupes and changes with the
environment fingerprint; a corrupt envelope is quarantined and counted and
the fetch degrades; a shared hit is promoted to the local tier; eight
threads publishing at once leave one intact envelope; fsck and the scan;
``_build.build`` installing a fetched library and its ``ptxas`` log without
starting ``nvcc``, and publishing what ``nvcc`` built.  And coexistence: one
directory holds a JAX envelope and a port envelope, and each package's fsck
leaves the other's file alone."""

from __future__ import annotations

import os
import sys
import threading

import pytest

import katib_tpu_torch.compile.artifacts as artifacts
from katib_tpu_torch.compile import registry
from katib_tpu_torch.compile.artifacts import (
    ArtifactCache,
    ArtifactCorrupt,
    artifact_name,
    env_fingerprint,
    fetch_kernel,
    fsck_artifacts,
    is_artifact_dir,
    kernel_signature,
    pack_envelope,
    publish_kernel,
    read_header,
    scan_dir,
    sig_from_key,
    unpack_envelope,
)
from katib_tpu_torch.compile.registry import CompileSignature
from katib_tpu_torch.ops import _build
from katib_tpu_torch.utils import observability as obs
from tests.torch_compile_state import fresh_compile_state  # noqa: F401  (fixture)

LIBRARY = bytes(range(256)) * 3 + b"\x7fELF-not-really"
LOG = ("ptxas info    : Compiling entry function '_Z11demo_kernelPf' for 'sm_90a'\n"
       "ptxas info    : Function properties for _Z11demo_kernelPf\n"
       "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
       "ptxas info    : Used 32 registers\n")


def _tier_total(metric, tier: str) -> float:
    return sum(v for labels, v in metric.samples() if (labels or {}).get("tier") == tier)


def _sig(program: str = "kernel:artifact_test", k: int = 1) -> CompileSignature:
    return CompileSignature(program=program, shapes=(("source_sha256", "ab" * 32),), k=k)


@pytest.fixture
def tiers(tmp_path, fresh_compile_state):
    """A two-tier world: local under ``tmp_path/cc/torch/artifacts`` (a
    wired compile cache), shared at ``tmp_path/shared``."""
    fresh_compile_state.setattr(registry, "_CACHE_ROOT", str(tmp_path / "cc"))
    cache = ArtifactCache()
    cache.configure(str(tmp_path / "shared"))
    return cache, tmp_path


class TestEnvelope:
    def test_pack_unpack_roundtrip(self):
        sig, fp = _sig(), env_fingerprint()
        data = pack_envelope(sig, fp, LIBRARY, LOG)
        assert data.startswith(artifacts.MAGIC) and not data.startswith(b"KATIBART1")
        header, body = unpack_envelope(data)
        assert header["key"] == sig.key() and header["program"] == sig.program
        assert header["fingerprint"] == fp
        assert body == {"library": LIBRARY, "log": LOG}
        assert read_header(data)["library_len"] == len(LIBRARY)

    @pytest.mark.parametrize("mutate", [
        lambda d: b"NOTMAGIC" + d[8:],  # bad magic
        lambda d: d[:-3],  # torn body
        lambda d: d[:-3] + b"xyz",  # flipped content, same length
        lambda d: artifacts.MAGIC + b"not json\n" + d[-4:],  # bad header
    ], ids=["magic", "torn", "flipped", "header"])
    def test_corruption_raises(self, mutate):
        data = pack_envelope(_sig(), env_fingerprint(), LIBRARY, LOG)
        with pytest.raises(ArtifactCorrupt):
            unpack_envelope(mutate(data))
        with pytest.raises(ArtifactCorrupt):
            read_header(mutate(data))

    def test_library_and_log_split_is_checked(self):
        """The body's checksum holds, but the header's split of it into the
        library and the log does not: the envelope is corrupt."""
        import hashlib
        import json

        data = pack_envelope(_sig(), env_fingerprint(), LIBRARY, LOG)
        rest = data[len(artifacts.MAGIC):]
        header = json.loads(rest[:rest.index(b"\n")])
        header["library_len"] += 1
        bad = artifacts.MAGIC + json.dumps(header).encode() + b"\n" + rest[rest.index(b"\n") + 1:]
        assert read_header(bad)["body_sha256"] == hashlib.sha256(LIBRARY + LOG.encode()).hexdigest()
        with pytest.raises(ArtifactCorrupt, match="lengths"):
            unpack_envelope(bad)

    def test_sig_key_roundtrip(self):
        sig = _sig(k=4)
        assert sig_from_key(sig.key()).key() == sig.key()

    def test_name_changes_with_fingerprint_and_sig(self):
        fp = env_fingerprint()
        name = artifact_name(_sig().key(), fp)
        assert name.endswith(artifacts.SUFFIX) and artifacts.SUFFIX != ".katibx"
        assert artifact_name(_sig().key(), dict(fp, nvcc="99.9")) != name
        assert artifact_name(_sig().key(), dict(fp, device_name="other")) != name
        assert artifact_name(_sig(k=4).key(), fp) != name

    def test_the_fingerprint_names_the_toolchain_and_the_card(self):
        fp = env_fingerprint()
        assert set(fp) == {"torch", "cuda", "nvcc", "driver", "device_name",
                           "capability", "nvcc_flags"}
        assert fp["nvcc_flags"] == " ".join(_build.NVCC_FLAGS)


class TestPublishFetch:
    def test_round_trip_is_byte_identical(self, tiers):
        cache, tmp = tiers
        sig = _sig()
        assert cache.publish(sig, LIBRARY, LOG) == ["local", "shared"]
        other = ArtifactCache()
        other.configure(str(tmp / "shared"))
        la = other.fetch(sig)
        assert la is not None and la.tier == "local"
        assert la.library == LIBRARY and la.log == LOG
        # the fetch records the signature in this process's registry
        assert registry.REGISTRY.seen(sig)

    def test_publish_dedupes_on_content_address(self, tiers):
        cache, _ = tiers
        assert cache.publish(_sig(), LIBRARY, LOG)
        p0 = _tier_total(obs.artifact_publishes, "shared")
        assert cache.publish(_sig(), LIBRARY, LOG) == []
        assert _tier_total(obs.artifact_publishes, "shared") == p0

    def test_fingerprint_invalidation(self, tiers, monkeypatch):
        cache, tmp = tiers
        sig = _sig()
        cache.publish(sig, LIBRARY, LOG)
        # same dirs, another toolchain: another address, a plain miss
        monkeypatch.setattr(artifacts, "_FP_CACHE", dict(env_fingerprint(), nvcc="99.9"))
        upgraded = ArtifactCache()
        upgraded.configure(str(tmp / "shared"))
        m0 = _tier_total(obs.artifact_misses, "shared")
        assert upgraded.fetch(sig) is None
        assert _tier_total(obs.artifact_misses, "shared") == m0 + 1
        # the other environment's envelope is stale, not corrupt
        report = fsck_artifacts(str(tmp / "shared"))
        assert report.stale and not report.corrupt and report.consistent

    def test_corrupt_artifact_quarantined_and_fetch_degrades(self, tiers):
        cache, tmp = tiers
        sig = _sig()
        cache.publish(sig, LIBRARY, LOG)
        shared = tmp / "shared"
        for d in (tmp / "cc" / "torch" / "artifacts", shared):
            for name in os.listdir(d):
                p = d / name
                p.write_bytes(p.read_bytes()[:-16])  # tear both copies
        q0 = {t: _tier_total(obs.artifact_quarantines, t) for t in ("local", "shared")}
        other = ArtifactCache()
        other.configure(str(shared))
        assert other.fetch(sig) is None  # degraded, no raise
        for tier in ("local", "shared"):
            assert _tier_total(obs.artifact_quarantines, tier) == q0[tier] + 1
        assert all(n.endswith(artifacts.QUARANTINE_SUFFIX) for n in os.listdir(shared))
        assert other.fetch(sig) is None  # the emptied tiers are a plain miss

    def test_shared_hit_promotes_to_local_tier(self, tiers, monkeypatch):
        cache, tmp = tiers
        sig = _sig()
        monkeypatch.setattr(registry, "_CACHE_ROOT", None)  # a host with no local tier
        assert cache.publish(sig, LIBRARY, LOG) == ["shared"]
        monkeypatch.setattr(registry, "_CACHE_ROOT", str(tmp / "cc"))
        h0 = _tier_total(obs.artifact_hits, "shared")
        other = ArtifactCache()
        other.configure(str(tmp / "shared"))
        la = other.fetch(sig)
        assert la is not None and la.tier == "shared"
        assert _tier_total(obs.artifact_hits, "shared") == h0 + 1
        promoted = os.listdir(tmp / "cc" / "torch" / "artifacts")
        assert promoted == [artifact_name(sig.key(), env_fingerprint())]

    def test_concurrent_publish_atomic(self, tiers):
        _, tmp = tiers
        sig, n = _sig(), 8
        barrier = threading.Barrier(n)
        errors: list[BaseException] = []

        def racer():
            try:
                barrier.wait(10.0)
                c = ArtifactCache()
                c.configure(str(tmp / "shared"))
                c.publish(sig, LIBRARY, LOG)
            except BaseException as e:  # pragma: no cover - fail loudly
                errors.append(e)

        threads = [threading.Thread(target=racer) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        assert not errors
        for d in (tmp / "cc" / "torch" / "artifacts", tmp / "shared"):
            # exactly one intact envelope and no .pub- temp residue
            names = os.listdir(d)
            assert names == [artifact_name(sig.key(), env_fingerprint())]
            assert unpack_envelope((d / names[0]).read_bytes())[1]["library"] == LIBRARY

    def test_no_tiers_is_noop(self, fresh_compile_state):
        cache = ArtifactCache()
        assert not cache.enabled()
        assert cache.publish(_sig(), LIBRARY, LOG) == []
        assert cache.fetch(_sig()) is None
        assert cache.stats() == {"loaded": 0, "tiers": {}}

    def test_the_env_var_names_the_shared_tier(self, tmp_path, fresh_compile_state):
        fresh_compile_state.setenv("KATIB_ARTIFACT_DIR", str(tmp_path / "env"))
        cache = ArtifactCache()
        assert cache.configure(str(tmp_path / "spec")) == str(tmp_path / "env")
        fresh_compile_state.delenv("KATIB_ARTIFACT_DIR")
        with pytest.warns(RuntimeWarning, match="first caller wins"):
            assert cache.configure(str(tmp_path / "spec")) == str(tmp_path / "env")


class TestFsckAndScan:
    def _publish_one(self, tiers):
        cache, tmp = tiers
        cache.publish(_sig(), LIBRARY, LOG)
        return tmp / "shared"

    def test_is_artifact_dir(self, tiers, tmp_path):
        shared = self._publish_one(tiers)
        assert is_artifact_dir(str(shared))
        assert not is_artifact_dir(str(tmp_path / "nope"))

    def test_fsck_quarantines_corrupt_and_misaddressed(self, tiers):
        shared = self._publish_one(tiers)
        bad, moved = "deadbeef" + artifacts.SUFFIX, "0" * 64 + artifacts.SUFFIX
        (shared / bad).write_bytes(b"garbage")
        good = next(n for n in os.listdir(shared) if n != bad)
        os.rename(shared / good, shared / moved)
        report = fsck_artifacts(str(shared), repair=False)
        assert report.corrupt == [bad] and report.misaddressed == [moved]
        assert not report.consistent
        q0 = _tier_total(obs.artifact_quarantines, "fsck")
        report = fsck_artifacts(str(shared))
        assert sorted(report.quarantined) == sorted([bad, moved]) and report.consistent
        assert _tier_total(obs.artifact_quarantines, "fsck") == q0 + 2
        report = fsck_artifacts(str(shared))
        assert report.consistent and not report.corrupt and report.scanned == 0

    def test_scan_dir_rows(self, tiers):
        shared = self._publish_one(tiers)
        (shared / ("1" * 64 + artifacts.SUFFIX)).write_bytes(b"garbage")
        rows = {r["status"]: r for r in scan_dir(str(shared))}
        assert rows["ok"]["program"] == "kernel:artifact_test"
        assert rows["ok"]["library_bytes"] == len(LIBRARY)
        assert rows["ok"]["torch"] == env_fingerprint()["torch"]
        assert rows["corrupt"]["name"] == "1" * 64 + artifacts.SUFFIX


def test_each_packages_fsck_leaves_the_others_envelopes(tmp_path, fresh_compile_state):
    """One artifact dir shared by both packages (as ``cohort-prewarm.yaml``
    names one ``artifactDir``): JAX's ``fsck_artifacts(repair=True)`` leaves
    the port's envelope untouched, and the port's fsck, scan and cache leave
    JAX's."""
    from katib_tpu.compile import artifacts as jart
    from katib_tpu.compile.registry import CompileSignature as JaxSignature

    shared = tmp_path / "shared"
    shared.mkdir()
    jsig = JaxSignature(program="train_classifier.step", k=1)
    jfp = jart.env_fingerprint()
    jname = jart.artifact_name(jsig.key(), jfp)
    jdata = jart.pack_envelope(jsig, jfp, b"xla-payload", None, None)
    (shared / jname).write_bytes(jdata)
    cache = ArtifactCache()
    cache.configure(str(shared))
    assert cache.publish(_sig(), LIBRARY, LOG) == ["shared"]
    (tname,) = [n for n in os.listdir(shared) if n.endswith(artifacts.SUFFIX)]
    tdata = (shared / tname).read_bytes()

    jreport = jart.fsck_artifacts(str(shared), repair=True)
    assert jreport.scanned == 1 and jreport.valid == 1 and not jreport.quarantined
    treport = fsck_artifacts(str(shared), repair=True)
    assert treport.scanned == 1 and treport.valid == 1 and not treport.quarantined
    assert [r["name"] for r in scan_dir(str(shared))] == [tname]
    assert [r["name"] for r in jart.scan_dir(str(shared))] == [jname]
    assert sorted(os.listdir(shared)) == sorted([jname, tname])
    assert (shared / jname).read_bytes() == jdata and (shared / tname).read_bytes() == tdata


class TestKernelBuild:
    """``_build.build`` with the tiers: a library missing from the build
    directory is fetched with its log (``nvcc`` made to raise), and one that
    ``nvcc`` built is published.  Without a tier, build runs ``nvcc``."""

    @pytest.fixture
    def build_dir(self, tmp_path, monkeypatch):
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(_build, "_loaded", {})
        return tmp_path / "build"

    @staticmethod
    def _no_nvcc(monkeypatch):
        def refuse():
            raise AssertionError("nvcc started")

        monkeypatch.setattr(_build, "_nvcc", refuse)

    def test_a_fetched_library_and_its_log_need_no_nvcc(self, tiers, build_dir, monkeypatch):
        cache, tmp = tiers
        sig = kernel_signature("mixed_op")
        assert sig.program == "kernel:mixed_op"
        assert dict(sig.shapes)["source_sha256"] == __import__("hashlib").sha256(
            (_build.CSRC / "mixed_op.cu").read_bytes()).hexdigest()
        cache.publish(sig, LIBRARY, LOG)
        fresh_shared_only = ArtifactCache()
        fresh_shared_only.configure(str(tmp / "shared"))
        monkeypatch.setattr(artifacts, "ARTIFACTS", fresh_shared_only)
        monkeypatch.setattr(registry, "_CACHE_ROOT", None)  # a fresh host: shared tier only
        self._no_nvcc(monkeypatch)
        h0 = _tier_total(obs.artifact_hits, "shared")
        seconds = _build.build(["mixed_op"])
        assert seconds["mixed_op"] > 0.0
        assert _tier_total(obs.artifact_hits, "shared") == h0 + 1
        path = _build.library_path("mixed_op")
        assert path.read_bytes() == LIBRARY
        assert path.with_suffix(".log").read_text() == LOG
        assert list(_build.ptxas_report("mixed_op").values()) == [(32, 0)]
        assert sorted(os.listdir(build_dir)) == sorted([path.name, path.with_suffix(".log").name])
        # built now: the next build neither fetches nor compiles
        assert _build.build(["mixed_op"]) == {"mixed_op": 0.0}
        assert _tier_total(obs.artifact_hits, "shared") == h0 + 1

    def test_a_miss_builds_with_nvcc_and_publishes(self, tiers, build_dir, monkeypatch, tmp_path):
        cache, tmp = tiers
        fake = tmp_path / "nvcc"
        fake.write_text(
            f"#!{sys.executable}\n"
            "import sys\n"
            "out = sys.argv[sys.argv.index('-o') + 1]\n"
            f"open(out, 'wb').write({LIBRARY!r})\n"
            f"sys.stdout.write({LOG!r})\n")
        fake.chmod(0o755)
        monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
        monkeypatch.setattr(artifacts, "ARTIFACTS", cache)
        m0 = _tier_total(obs.artifact_misses, "shared")
        _build.build(["mixed_op"])
        assert _tier_total(obs.artifact_misses, "shared") == m0 + 1
        name = artifact_name(kernel_signature("mixed_op").key(), env_fingerprint())
        for d in (tmp / "cc" / "torch" / "artifacts", tmp / "shared"):
            header, body = unpack_envelope((d / name).read_bytes())
            assert body == {"library": LIBRARY, "log": LOG}
        # already in both tiers: publishing again writes nothing
        assert publish_kernel("mixed_op", cache) == []

    def test_without_a_tier_build_runs_nvcc_as_before(self, build_dir, monkeypatch,
                                                      fresh_compile_state):
        self._no_nvcc(monkeypatch)
        with pytest.raises(AssertionError, match="nvcc started"):
            _build.build(["mixed_op"])
        assert fetch_kernel("mixed_op") is None  # no tier: nothing to fetch
