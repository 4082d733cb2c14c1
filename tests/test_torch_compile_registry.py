"""The port's shape registry (``katib_tpu_torch/compile/registry.py``)
against the JAX package's (``katib_tpu/compile/registry.py``): the same
signature keys for the same train function and trial parameters (float
parameters left out, a cohort keyed by its shared parameters and padded K),
and the JSONL file's torn-tail tolerance and duplicate-row compaction.
Where the port differs by design: it keeps its own file under
``<cache>/torch/``, and a first step is warm only after this process warmed
its signature, never from a row another process wrote."""

from __future__ import annotations

import json
import os

import pytest

from katib_tpu.compile import registry as jreg
from katib_tpu.core import types as jtypes
from katib_tpu_torch.compile import registry as treg
from katib_tpu_torch.core import types as ttypes
from katib_tpu_torch.runner import trial_runner
from katib_tpu_torch.utils import observability as obs
from tests.torch_compile_state import fresh_compile_state  # noqa: F401  (fixture)


def _trial(types, name: str, **params):
    return types.Trial(
        name=name,
        experiment_name="registry-test",
        spec=types.TrialSpec(
            assignments=[types.ParameterAssignment(k, v) for k, v in params.items()]
        ),
    )


def mnist_trial(ctx):  # pragma: no cover - named, never run
    pass


def mnist_cohort_trial(cctx):  # pragma: no cover - named, never run
    pass


PARAMS = [
    {"lr": 0.05, "units": 64},
    {"lr": 0.01, "momentum": 0.9, "units": 64, "arch": "mlp", "batch_size": 128},
    {"lr": 0.3, "num_layers": 3, "optimizer": "adam", "flag": True},
    {},
]


@pytest.mark.parametrize("params", PARAMS, ids=range(len(PARAMS)))
def test_trial_keys_are_the_jax_packages(params):
    want = jreg.trial_signature(mnist_trial, _trial(jtypes, "t", **params)).key()
    got = treg.trial_signature(mnist_trial, _trial(ttypes, "t", **params)).key()
    assert got == want


@pytest.mark.parametrize("k", [2, 4, 8])
def test_cohort_keys_are_the_jax_packages(k):
    members = [{"lr": 0.01 * (i + 1), "momentum": 0.9, "units": 64, "seed": i} for i in range(3)]
    want = jreg.cohort_signature(
        mnist_cohort_trial, [_trial(jtypes, f"m{i}", **p) for i, p in enumerate(members)], k)
    got = treg.cohort_signature(
        mnist_cohort_trial, [_trial(ttypes, f"m{i}", **p) for i, p in enumerate(members)], k)
    assert got.key() == want.key()
    # the member-varying seed and the floats drop out; the padded K stays
    assert dict(got.shapes) == {"units": "64"} and got.k == k


def test_float_parameters_stay_out_of_the_key():
    t1 = _trial(ttypes, "r1", lr=0.01, units=32)
    t2 = _trial(ttypes, "r2", lr=0.2, units=32)
    t3 = _trial(ttypes, "r3", lr=0.01, units=64)
    assert treg.trial_signature(None, t1).key() == treg.trial_signature(None, t2).key()
    assert treg.trial_signature(None, t1).key() != treg.trial_signature(None, t3).key()
    assert treg.shared_structural(
        [{"units": 32, "lr": 0.1, "s": 1}, {"units": 32, "lr": 0.5, "s": 2}]) == {"units": 32}


def test_a_ragged_cohort_keys_as_its_padded_bucket():
    three = [_trial(ttypes, f"k{i}", lr=0.1 * i, units=8) for i in range(3)]
    four = three + [_trial(ttypes, "k3", lr=0.9, units=8)]
    assert (treg.cohort_signature(None, three, 4).key()
            == treg.cohort_signature(None, four, 4).key())
    assert (treg.cohort_signature(None, three, 4).key()
            != treg.cohort_signature(None, three, 3).key())


def test_a_mesh_raises():
    with pytest.raises(NotImplementedError, match="mesh"):
        treg.mesh_signature(object())


def test_classify_then_record_flips_warm_and_counts_once():
    reg = treg.ShapeRegistry()
    sig = treg.CompileSignature(program="torch_registry_count_prog", k=2)
    h0 = obs.compile_cache_hits.get(program=sig.program)
    m0 = obs.compile_cache_misses.get(program=sig.program)
    assert reg.classify(sig) == "cold"
    assert reg.note_first_step(sig, 0.5) == "cold"
    assert reg.note_first_step(sig, 0.1) == "warm"
    assert reg.record(sig) is False
    assert obs.compile_cache_misses.get(program=sig.program) == m0 + 1
    assert obs.compile_cache_hits.get(program=sig.program) == h0 + 1


def _wire(tmp_path) -> str:
    return trial_runner.init_compile_cache(str(tmp_path / "cc"))


def test_rows_persist_to_the_ports_own_file(tmp_path, fresh_compile_state):
    assert _wire(tmp_path) == str(tmp_path / "cc")
    assert obs.compile_cache_enabled.get() == 1.0
    sig = treg.CompileSignature(program="torch_registry_file_prog", shapes=(("units", "8"),))
    treg.REGISTRY.note_first_step(sig, 0.25)
    path = tmp_path / "cc" / "torch" / "shape_registry.jsonl"
    (row,) = [json.loads(line) for line in path.read_text().splitlines()]
    assert row["key"] == sig.key() and row["source"] == "trial"
    assert row["process"] == treg.PROCESS_TOKEN and row["compile_seconds"] == 0.25
    assert set(row["fingerprint"]) >= {"torch", "cuda", "nvcc", "driver", "device_name",
                                       "capability", "nvcc_flags"}
    # the JAX package's file beside it is not written
    assert not (tmp_path / "cc" / "shape_registry.jsonl").exists()
    assert treg.read_rows(str(tmp_path / "cc")) == [row]


def test_a_second_directory_warns_and_the_first_stays(tmp_path, fresh_compile_state):
    first = _wire(tmp_path)
    with pytest.warns(RuntimeWarning, match="first caller wins"):
        assert trial_runner.init_compile_cache(str(tmp_path / "other")) == first
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert trial_runner.init_compile_cache(first) == first


def test_the_env_var_wins_over_the_spec(tmp_path, fresh_compile_state):
    fresh_compile_state.setenv("KATIB_COMPILE_CACHE", str(tmp_path / "env"))
    assert trial_runner.init_compile_cache(str(tmp_path / "spec")) == str(tmp_path / "env")
    assert (tmp_path / "env" / "torch").is_dir() and not (tmp_path / "spec").exists()


def _row(sig, process="elsewhere:1:abcd", **extra) -> dict:
    return {"key": sig.key(), "program": sig.program, "k": sig.k, "mesh": sig.mesh,
            "shapes": dict(sig.shapes), "donation": sig.donation, "source": "trial",
            "process": process, **extra}


def test_another_processes_row_is_history_not_warmth(tmp_path, fresh_compile_state):
    sig = treg.CompileSignature(program="torch_registry_history_prog")
    path = tmp_path / "cc" / "torch" / "shape_registry.jsonl"
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps(_row(sig)) + "\n")
    _wire(tmp_path)
    reg = treg.ShapeRegistry()
    # the row is history: listed, but the first step of this process is cold
    assert [r["process"] for r in reg.signatures()] == ["elsewhere:1:abcd"]
    assert not reg.seen(sig) and reg.classify(sig) == "cold"
    assert reg.note_first_step(sig, 1.0) == "cold"
    assert reg.classify(sig) == "warm"
    assert [r["process"] for r in reg.signatures()] == [treg.PROCESS_TOKEN]
    # the file keeps both rows; a fresh registry (another process) compacts
    # them to the last one, and is cold again
    assert len(path.read_text().splitlines()) == 2
    other = treg.ShapeRegistry()
    assert other.classify(sig) == "cold"
    kept = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["process"] for r in kept] == [treg.PROCESS_TOKEN]


def test_unique_rows_are_left_alone(tmp_path, fresh_compile_state):
    path = tmp_path / "cc" / "torch" / "shape_registry.jsonl"
    path.parent.mkdir(parents=True)
    body = "".join(json.dumps(_row(treg.CompileSignature(program=f"p{i}.step", k=2))) + "\n"
                   for i in range(3))
    path.write_text(body)
    _wire(tmp_path)
    assert len(treg.ShapeRegistry().signatures()) == 3
    assert path.read_text() == body  # byte-identical: no rewrite


def test_duplicate_rows_compact_and_a_torn_tail_heals(tmp_path, fresh_compile_state):
    sig = treg.CompileSignature(program="torn.step", shapes=(("units", "8"),), k=2)
    path = tmp_path / "cc" / "torch" / "shape_registry.jsonl"
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps(_row(sig, "a:1:0")) + "\n" + json.dumps(_row(sig, "b:2:0"))
                    + "\n" + '{"key": "to')
    _wire(tmp_path)
    with pytest.warns(RuntimeWarning, match="torn"):
        reg = treg.ShapeRegistry()
        rows = reg.signatures()
    assert [r["process"] for r in rows] == ["b:2:0"]  # the last row of a key wins
    kept = path.read_text()
    assert kept.endswith("\n") and len(kept.splitlines()) == 1
    assert os.listdir(path.parent) == ["shape_registry.jsonl"]  # no temp residue


def test_a_torn_tail_alone_is_truncated_on_the_next_append(tmp_path, fresh_compile_state):
    old = treg.CompileSignature(program="kept.step")
    path = tmp_path / "cc" / "torch" / "shape_registry.jsonl"
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps(_row(old)) + "\n" + '{"key": "half')
    _wire(tmp_path)
    reg = treg.ShapeRegistry()
    with pytest.warns(RuntimeWarning, match="torn"):
        reg.signatures()
    reg.record(treg.CompileSignature(program="new.step"))
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["program"] for r in rows] == ["kept.step", "new.step"]
