"""The port's TFEvent reader and writer against the JAX package's: the
same scalars give byte-identical event files, each package reads the
other's files to the same metric logs, and the framing, CRC and protobuf
cases of ``tests/test_tfevent.py`` hold for the port."""

from __future__ import annotations

import os
import struct

import numpy as np
import pytest

from katib_tpu.runner import tfevent as jtf
from katib_tpu_torch.runner import tfevent as ttf

PKGS = {"jax": jtf, "torch": ttf}


def _scalars(seed: int, n: int = 40):
    """Seeded scalars: three tags, steps (some negative, which the writer
    clamps to 0), large and tiny values, wall times out of order."""
    rng = np.random.default_rng(seed)
    tags = ["accuracy", "loss", "Validation-Accuracy/top_1"]
    return [
        (tags[int(rng.integers(3))], float(rng.normal() * 10.0 ** int(rng.integers(-8, 9))),
         int(rng.integers(-2, 300_000)), float(rng.uniform(1.6e9, 1.8e9)))
        for _ in range(n)
    ]


def _write(mod, logdir, scalars) -> str:
    w = mod.TFEventWriter(str(logdir))
    for tag, value, step, wall in scalars:
        w.add_scalar(tag, value, step=step, wall_time=wall)
    w.close()
    return w.path


def _logs(logs):
    return [(l.metric_name, l.value, l.step, l.timestamp) for l in logs]


@pytest.mark.parametrize("seed", range(3))
def test_writer_bytes_equal_the_jax_writer(tmp_path, seed):
    scalars = _scalars(seed)
    paths = {pkg: _write(mod, tmp_path / pkg, scalars) for pkg, mod in PKGS.items()}
    data = {pkg: open(p, "rb").read() for pkg, p in paths.items()}
    assert data["torch"] == data["jax"]
    assert len(data["torch"]) > 40 * 16
    assert os.path.basename(paths["torch"]).startswith("events.out.tfevents.")


@pytest.mark.parametrize("writer", sorted(PKGS))
def test_each_package_reads_the_others_files(tmp_path, writer):
    scalars = _scalars(7)
    path = _write(PKGS[writer], tmp_path / "w", scalars)
    read = {pkg: _logs(mod.parse_tfevent_file(path)) for pkg, mod in PKGS.items()}
    assert read["torch"] == read["jax"]
    assert [(t, max(s, 0), w) for t, _, s, w in read["torch"]] == [
        (t, max(s, 0), w) for t, _, s, w in scalars]
    # values are float32 on disk
    assert [v for _, v, _, _ in read["torch"]] == [
        float(np.float32(v)) for _, v, _, _ in scalars]
    dirs = {pkg: _logs(mod.parse_tfevent_dir(str(tmp_path), ["loss", "accuracy"]))
            for pkg, mod in PKGS.items()}
    assert dirs["torch"] == dirs["jax"]
    assert [w for *_, w in dirs["torch"]] == sorted(w for *_, w in dirs["torch"])


def test_crc32c_known_vectors():
    # RFC 3720 B.4 test vector
    assert ttf.crc32c(b"123456789") == 0xE3069283
    assert ttf.crc32c(b"") == 0
    rng = np.random.default_rng(0)
    for n in (1, 7, 64, 1000):
        blob = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert ttf.crc32c(blob) == jtf.crc32c(blob)
        assert ttf._masked_crc(blob) == jtf._masked_crc(blob)


def test_varint_and_field_encoding_match():
    for v in (0, 1, 127, 128, 300, 2**31, 2**63 - 1):
        assert ttf._varint(v) == jtf._varint(v)
    assert ttf._field(5, 2) == jtf._field(5, 2)


def test_writer_reader_round_trip(tmp_path):
    w = ttf.TFEventWriter(str(tmp_path))
    w.add_scalar("accuracy", 0.5, step=1, wall_time=100.0)
    w.add_scalar("accuracy", 0.75, step=2, wall_time=101.0)
    w.add_scalar("loss", 1.5, step=1, wall_time=100.0)
    w.close()
    logs = ttf.parse_tfevent_file(w.path)
    assert [(l.metric_name, l.step) for l in logs] == [
        ("accuracy", 1), ("accuracy", 2), ("loss", 1)]
    assert abs(logs[1].value - 0.75) < 1e-6
    assert logs[0].timestamp == 100.0
    assert [l.metric_name for l in ttf.parse_tfevent_file(w.path, ["loss"])] == ["loss"]


def test_dir_scan_merges_sorted(tmp_path):
    (tmp_path / "sub").mkdir()
    _write(ttf, tmp_path, [("m", 1.0, 2, 200.0)])
    _write(ttf, tmp_path / "sub", [("m", 0.5, 1, 100.0)])
    assert [l.value for l in ttf.parse_tfevent_dir(str(tmp_path))] == [0.5, 1.0]
    assert ttf.parse_tfevent_dir(str(tmp_path / "nothing")) == []


def test_truncated_tail_is_ignored(tmp_path):
    w = ttf.TFEventWriter(str(tmp_path))
    w.add_scalar("m", 1.0, step=0, wall_time=1.0)
    w.flush()
    # a live trial mid-write: a half frame at the tail
    with open(w.path, "ab") as f:
        f.write(struct.pack("<Q", 10_000) + b"\x00\x01\x02")
    assert len(ttf.parse_tfevent_file(w.path)) == 1
    assert _logs(ttf.parse_tfevent_file(w.path)) == _logs(jtf.parse_tfevent_file(w.path))
    w.close()


def test_corrupt_crc_stops_cleanly(tmp_path):
    path = _write(ttf, tmp_path, [("m", 1.0, 0, 1.0), ("m", 2.0, 1, 2.0)])
    raw = bytearray(open(path, "rb").read())
    raw[14] ^= 0xFF  # flip a payload byte in the first record
    open(path, "wb").write(bytes(raw))
    assert ttf.parse_tfevent_file(path) == []
    assert list(ttf.read_tfrecords(path, verify_crc=False)) == list(
        jtf.read_tfrecords(path, verify_crc=False))


@pytest.mark.parametrize("dtype", ["float_val", "double_val", "tensor_content_f32",
                                   "tensor_content_f64"])
def test_tf2_tensor_scalar_summary(tmp_path, dtype):
    """An Event whose Summary.Value carries a TensorProto instead of
    simple_value (the TF2 ``tf.summary.scalar`` encoding)."""
    f, v = ttf._field, ttf._varint
    if dtype == "float_val":
        tensor = f(1, 0) + v(1) + f(5, 2) + v(4) + struct.pack("<f", 0.625)
    elif dtype == "double_val":
        tensor = f(1, 0) + v(2) + f(6, 2) + v(8) + struct.pack("<d", 0.1)
    elif dtype == "tensor_content_f32":
        tensor = f(1, 0) + v(1) + f(4, 2) + v(4) + struct.pack("<f", 0.625)
    else:
        tensor = f(1, 0) + v(2) + f(4, 2) + v(8) + struct.pack("<d", 0.1)
    tag = b"acc"
    value = f(1, 2) + v(len(tag)) + tag + f(8, 2) + v(len(tensor)) + tensor
    summary = f(1, 2) + v(len(value)) + value
    event = (f(1, 1) + struct.pack("<d", 5.0) + f(2, 0) + v(7)
             + f(5, 2) + v(len(summary)) + summary)
    path = tmp_path / "events.out.tfevents.123.host"
    with open(path, "wb") as fh:
        header = struct.pack("<Q", len(event))
        fh.write(header + struct.pack("<I", ttf._masked_crc(header)))
        fh.write(event + struct.pack("<I", ttf._masked_crc(event)))
    read = {pkg: _logs(mod.parse_tfevent_file(str(path))) for pkg, mod in PKGS.items()}
    assert read["torch"] == read["jax"]
    assert [(m, s) for m, _, s, _ in read["torch"]] == [("acc", 7)]
    want = 0.625 if dtype.endswith(("f32", "float_val")) else 0.1
    assert read["torch"][0][1] == pytest.approx(want, rel=0, abs=0)
