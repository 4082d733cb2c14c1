"""TensorFlow event-file metrics collector — no TensorFlow dependency.

Parity with the reference's TFEvent metrics-collector sidecar
(``cmd/metricscollector/v1beta1/tfevent-metricscollector/main.py:47-79`` +
``tfevent_loader.py``), which tails a trial's summary directory with TF's
EventAccumulator and reports scalar metrics once the trial exits.  Here the
TFRecord framing (u64 length + masked crc32c, payload + masked crc32c) and
the Event/Summary protobuf wire format are decoded directly, so white-box trials
and arbitrary black-box trainers that emit TensorBoard event files work
without TF installed.

Scalars are read from both summary encodings:
- TF1 ``Summary.Value.simple_value`` (field 2, float)
- TF2 ``Summary.Value.tensor`` (field 8) carrying a scalar DT_FLOAT/DT_DOUBLE
  TensorProto (``float_val``/``double_val`` or packed ``tensor_content``)

A minimal writer is included (valid framing + simple_value summaries) so the
framework can export its own metrics for TensorBoard and so tests can
fabricate real files — the reference generates fixtures by running a real TF
trainer (``Makefile:172-175``); we synthesize them instead.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Sequence

from katib_tpu_torch.core.types import MetricLog

# -- crc32c (Castagnoli), table-driven --------------------------------------

_CRC_TABLE: tuple[int, ...] | None = None


def _crc_table() -> tuple[int, ...]:
    # built as a local and published in one assignment: concurrent trial
    # threads either see None (and rebuild identically) or the full table —
    # never a partially filled one
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table.append(crc)
        _CRC_TABLE = tuple(table)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# -- protobuf wire-format primitives ----------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        result |= (b & 0x7F) << shift
        pos += 1
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[tuple[int, int, bytes | int]]:
    """Yield (field_number, wire_type, value) skipping unknown types."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            value, pos = _read_varint(buf, pos)
        elif wire == 1:  # fixed64
            value = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            value = buf[pos : pos + length]
            pos += length
        elif wire == 5:  # fixed32
            value = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


# TensorProto dtype codes (tensorflow/core/framework/types.proto)
_DT_FLOAT, _DT_DOUBLE = 1, 2


def _tensor_scalar(buf: bytes) -> float | None:
    """Extract a scalar float from a TensorProto (TF2 scalar summaries)."""
    dtype = None
    content = b""
    float_val: float | None = None
    for field, wire, value in _iter_fields(buf):
        if field == 1 and wire == 0:  # dtype
            dtype = value
        elif field == 4 and wire == 2:  # tensor_content
            content = value
        elif field == 5:  # float_val (packed or single fixed32)
            raw = value
            if isinstance(raw, bytes) and len(raw) >= 4:
                float_val = struct.unpack("<f", raw[:4])[0]
        elif field == 6:  # double_val
            raw = value
            if isinstance(raw, bytes) and len(raw) >= 8:
                float_val = struct.unpack("<d", raw[:8])[0]
    if float_val is not None:
        return float(float_val)
    if dtype == _DT_FLOAT and len(content) >= 4:
        return float(struct.unpack("<f", content[:4])[0])
    if dtype == _DT_DOUBLE and len(content) >= 8:
        return float(struct.unpack("<d", content[:8])[0])
    return None


def _parse_summary(buf: bytes, wall_time: float, step: int) -> list[MetricLog]:
    out: list[MetricLog] = []
    for field, wire, value in _iter_fields(buf):
        if field != 1 or wire != 2:  # repeated Summary.Value
            continue
        tag: str | None = None
        scalar: float | None = None
        for vfield, vwire, vvalue in _iter_fields(value):
            if vfield == 1 and vwire == 2:  # tag
                tag = vvalue.decode(errors="replace")
            elif vfield == 2 and vwire == 5:  # simple_value
                scalar = float(struct.unpack("<f", vvalue)[0])
            elif vfield == 8 and vwire == 2:  # tensor
                got = _tensor_scalar(vvalue)
                if got is not None:
                    scalar = got
        if tag is not None and scalar is not None:
            out.append(
                MetricLog(metric_name=tag, value=scalar, timestamp=wall_time, step=step)
            )
    return out


def _parse_event(buf: bytes) -> list[MetricLog]:
    wall_time = 0.0
    step = -1
    summaries: list[bytes] = []
    for field, wire, value in _iter_fields(buf):
        if field == 1 and wire == 1:  # wall_time double
            wall_time = struct.unpack("<d", value)[0]
        elif field == 2 and wire == 0:  # step
            step = value
        elif field == 5 and wire == 2:  # summary
            summaries.append(value)
    out: list[MetricLog] = []
    for s in summaries:
        out.extend(_parse_summary(s, wall_time, step))
    return out


# -- tfrecord framing --------------------------------------------------------


def read_tfrecords(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    """Yield raw record payloads; stops cleanly at a truncated tail (a live
    trial may still be appending)."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:])
            if verify_crc and _masked_crc(header[:8]) != len_crc:
                return  # corrupt frame: stop rather than misparse
            data = f.read(length)
            footer = f.read(4)
            if len(data) < length or len(footer) < 4:
                return
            (data_crc,) = struct.unpack("<I", footer)
            if verify_crc and _masked_crc(data) != data_crc:
                return
            yield data


def parse_tfevent_file(path: str, metric_names: Sequence[str] | None = None) -> list[MetricLog]:
    tracked = set(metric_names) if metric_names is not None else None
    out: list[MetricLog] = []
    for record in read_tfrecords(path):
        try:
            logs = _parse_event(record)
        except (ValueError, IndexError, struct.error):
            continue  # skip undecodable events, keep scanning
        for log in logs:
            if tracked is None or log.metric_name in tracked:
                out.append(log)
    return out


def parse_tfevent_dir(path: str, metric_names: Sequence[str] | None = None) -> list[MetricLog]:
    """Scan a summary directory tree for ``*tfevents*`` files (the reference
    loader walks the whole dir, ``tfevent_loader.py`` MetricsCollector) and
    merge their scalars in (wall_time, step) order."""
    out: list[MetricLog] = []
    for root, _, files in os.walk(path):
        for name in sorted(files):
            if "tfevents" not in name:
                continue
            out.extend(parse_tfevent_file(os.path.join(root, name), metric_names))
    out.sort(key=lambda l: (l.timestamp, l.step))
    return out


# -- writer ------------------------------------------------------------------


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


class TFEventWriter:
    """Append scalar summaries to a TensorBoard-compatible event file."""

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        import time as _time

        name = f"events.out.tfevents.{int(_time.time())}.katib{filename_suffix}"
        self._path = os.path.join(logdir, name)
        self._f = open(self._path, "ab")

    @property
    def path(self) -> str:
        return self._path

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int, wall_time: float) -> None:
        tag_b = tag.encode()
        summary_value = (
            _field(1, 2) + _varint(len(tag_b)) + tag_b
            + _field(2, 5) + struct.pack("<f", value)
        )
        summary = _field(1, 2) + _varint(len(summary_value)) + summary_value
        event = (
            _field(1, 1) + struct.pack("<d", wall_time)
            + _field(2, 0) + _varint(step if step >= 0 else 0)
            + _field(5, 2) + _varint(len(summary)) + summary
        )
        self._write_record(event)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()
