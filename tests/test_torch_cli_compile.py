"""The port's compile verbs (``katib_tpu_torch/cli.py``): ``prewarm``,
``cache`` and ``fsck`` of an artifact dir, with their exit codes, on the
CPU and at the shipped ``cohort-prewarm.yaml``'s shapes."""

from __future__ import annotations

import json
import os

import pytest

from katib_tpu_torch.cli import main
from katib_tpu_torch.compile import artifacts, registry
from katib_tpu_torch.compile.artifacts import ArtifactCache, kernel_signature
from tests.torch_compile_state import fresh_compile_state  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = os.path.join(ROOT, "examples", "hp-tuning", "cohort-prewarm.yaml")


@pytest.fixture
def dirs(tmp_path, fresh_compile_state):
    fresh_compile_state.setenv("KATIB_COMPILE_CACHE", str(tmp_path / "cc"))
    fresh_compile_state.setenv("KATIB_ARTIFACT_DIR", str(tmp_path / "art"))
    return tmp_path / "cc", tmp_path / "art"


def test_prewarm_runs_each_width_and_records_it(dirs, capsys):
    cache, _ = dirs
    assert main(["prewarm", SPEC, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    # cohortWidth 4 with buckets: the singleton program and cohorts of 2 and 4
    assert "prewarm: 3 queued, 3 compiled, 0 fetched, 0 published, 0 failed" in out
    for k, program in ((1, "mnist_trial"), (2, "mnist_cohort_trial"), (4, "mnist_cohort_trial")):
        assert f"k={k}: {program} captured in 0.0 s on cpu" in out
    rows = registry.read_rows(str(cache))
    assert sorted((r["program"], r["k"], r["source"]) for r in rows) == [
        ("mnist_cohort_trial", 2, "prewarm"), ("mnist_cohort_trial", 4, "prewarm"),
        ("mnist_trial", 1, "prewarm")]
    assert "this process" in out
    # a second run in this process finds every width warm and runs nothing
    assert main(["prewarm", SPEC, "--device", "cpu", "--widths", "1"]) == 0
    assert "k=1: already warm in this process, skipped" in capsys.readouterr().out


def test_prewarm_publish_and_fetch_only_act_on_kernel_libraries(dirs, capsys):
    _, shared = dirs
    assert main(["prewarm", SPEC, "--device", "cpu", "--widths", "1", "--publish",
                 "--artifact-dir", str(shared)]) == 0
    out = capsys.readouterr().out
    assert "1 compiled, 0 fetched, 0 published, 0 failed" in out
    assert "kernel libraries: 0 — mnist_trial launches no hand-written kernel" in out
    assert not shared.exists() or not os.listdir(shared)
    assert main(["prewarm", SPEC, "--device", "cpu", "--widths", "2", "--fetch-only"]) == 0
    out = capsys.readouterr().out
    assert "0 compiled, 0 fetched, 0 published, 0 failed" in out


def test_fetch_only_needs_a_shared_tier(tmp_path, fresh_compile_state, capsys):
    spec = tmp_path / "no-tier.yaml"
    text = open(SPEC).read().replace("  artifactDir: /tmp/katib-artifacts\n", "")
    spec.write_text(text.replace("compileCache: /tmp/katib-compile-cache",
                                 f"compileCache: {tmp_path / 'cc'}"))
    assert main(["prewarm", str(spec), "--device", "cpu", "--fetch-only"]) == 2
    assert "--fetch-only needs a shared artifact tier" in capsys.readouterr().err


def _publish(shared, name="mixed_op") -> str:
    cache = ArtifactCache()
    cache.configure(str(shared))
    assert cache.publish(kernel_signature(name), b"\x7fELF" + bytes(64), "ptxas log\n") == ["shared"]
    (found,) = [n for n in os.listdir(shared) if n.endswith(artifacts.SUFFIX)]
    return found


def test_cache_lists_the_ports_envelopes_only(dirs, capsys):
    from katib_tpu.compile import artifacts as jart
    from katib_tpu.compile.registry import CompileSignature as JaxSignature

    _, shared = dirs
    name = _publish(shared)
    jsig = JaxSignature(program="train_classifier.step")
    jfp = jart.env_fingerprint()
    (shared / jart.artifact_name(jsig.key(), jfp)).write_bytes(
        jart.pack_envelope(jsig, jfp, b"xla", None, None))
    assert main(["cache", str(shared)]) == 0
    out = capsys.readouterr().out
    assert "kernel:mixed_op" in out and "train_classifier" not in out
    assert "1 artifact(s), 1 loadable here (0 corrupt" in out
    assert main(["cache", str(shared), "--json"]) == 0
    inventory = json.loads(capsys.readouterr().out)
    assert [(r["name"], r["status"]) for r in inventory["artifacts"]] == [(name, "ok")]


def test_cache_of_a_compile_cache_prints_its_history(dirs, capsys):
    cache, _ = dirs
    assert main(["prewarm", SPEC, "--device", "cpu", "--widths", "1"]) == 0
    capsys.readouterr()
    assert main(["cache", str(cache)]) == 0
    out = capsys.readouterr().out
    assert "(empty)" in out and "registry history" in out and "mnist_trial" in out
    assert main(["cache", str(cache), "--json"]) == 0
    inventory = json.loads(capsys.readouterr().out)
    assert inventory["dir"] == str(cache / "torch" / "artifacts")
    assert [r["program"] for r in inventory["registry"]] == ["mnist_trial"]


def test_cache_without_a_dir_is_an_error(fresh_compile_state, capsys):
    assert main(["cache"]) == 2
    assert "no artifact dir" in capsys.readouterr().err


def test_fsck_of_an_artifact_dir_quarantines_and_exits_by_consistency(tmp_path,
                                                                     fresh_compile_state,
                                                                     capsys):
    shared = tmp_path / "art"
    _publish(shared)
    bad = "deadbeef" + artifacts.SUFFIX
    (shared / bad).write_bytes(b"garbage")
    assert main(["fsck", str(shared), "--dry-run"]) == 1
    out = capsys.readouterr().out
    assert f"corrupt: {bad}" in out and "2 artifact(s): 1 valid" in out
    assert main(["fsck", str(shared)]) == 0
    assert f"quarantined -> {bad}.quarantined" in capsys.readouterr().out
    assert main(["fsck", str(shared)]) == 0
    assert "1 artifact(s): 1 valid" in capsys.readouterr().out
