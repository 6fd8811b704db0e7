"""Durable scalar logging: TensorBoard event files + CSV, no TF dependency (a
copy of ``iseg_tpu/utils/summary.py``).

The reference streams scalars through the Keras TensorBoard callback
(``core_train.py:121-126``); here :class:`SummaryWriter` writes the same
``events.out.tfevents.*`` format directly — TFRecord framing with masked
CRC32C checksums around hand-encoded ``Event`` protos (the wire format is
three fixed fields: wall_time/step/summary) — so losses, LR and eval mIoU
land next to the ``torch.profiler`` traces in one TensorBoard logdir.
:class:`ScalarLogger` pairs it with a CSV for grep-ability on long pod runs.
"""

from __future__ import annotations

import csv
import os
import socket
import struct
import time

_WRITER_SEQ = 0  # per-process writer counter (filename uniqueness)
from typing import Mapping, Optional

# -- CRC32C (Castagnoli), table-driven --------------------------------------

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for n in range(256):
        crc = n
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """TFRecord's masked CRC: rotate right by 15 and add a constant."""
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# -- minimal protobuf wire encoding -----------------------------------------


def _varint(n: int) -> bytes:
    if n < 0:
        # protobuf encodes negative int64 as two's complement (10 bytes);
        # Python's arithmetic shift would loop forever on a negative n
        n &= (1 << 64) - 1
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field_double(num: int, value: float) -> bytes:
    return _varint(num << 3 | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint(num << 3 | 5) + struct.pack("<f", value)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3 | 0) + _varint(value)


def _field_bytes(num: int, value: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(value)) + value


def encode_scalar_event(tag: str, value: float, step: int,
                        wall_time: Optional[float] = None) -> bytes:
    """``Event{wall_time=1, step=2, summary=5{value=1{tag=1,
    simple_value=2}}}`` (tensorboard's event.proto / summary.proto)."""
    sv = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    summary = _field_bytes(1, sv)
    return (
        _field_double(1, wall_time if wall_time is not None else time.time())
        + _field_varint(2, int(step))
        + _field_bytes(5, summary)
    )


def encode_file_version_event(wall_time: Optional[float] = None) -> bytes:
    """The ``file_version: "brain.Event:2"`` header record."""
    return (
        _field_double(1, wall_time if wall_time is not None else time.time())
        + _field_bytes(3, b"brain.Event:2")
    )


def _tfrecord(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + data
        + struct.pack("<I", _masked_crc(data))
    )


class SummaryWriter:
    """Append-only TensorBoard event-file writer.

    ``add_scalar`` flushes through to disk by default — a killed pod job
    loses at most the current record, and TensorBoard tails the file live.
    """

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        # pid + a process-wide counter disambiguate writers created in the
        # same second on one host (e.g. train + eval loggers on one
        # logdir) — two handles on one file would interleave and corrupt
        # the TFRecord framing
        global _WRITER_SEQ
        _WRITER_SEQ += 1
        name = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}.{_WRITER_SEQ}"
            f"{filename_suffix}"
        )
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._f.write(_tfrecord(encode_file_version_event()))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int,
                   flush: bool = True):
        self._f.write(_tfrecord(encode_scalar_event(tag, value, step)))
        if flush:
            self._f.flush()

    def add_scalars(self, scalars: Mapping[str, float], step: int):
        for tag, value in scalars.items():
            self.add_scalar(tag, float(value), step, flush=False)
        self._f.flush()

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_event_scalars(path: str) -> list[tuple[int, str, float]]:
    """Parse an event file back into ``(step, tag, value)`` rows.

    Used by tests and offline tooling; verifies framing CRCs."""
    rows = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != _masked_crc(header):  # not assert: -O must not skip
                raise ValueError(f"corrupt record header in {path}")
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            if dcrc != _masked_crc(data):
                raise ValueError(f"corrupt record payload in {path}")
            rows.extend(_parse_event(data))
    return rows


def _parse_event(data: bytes) -> list[tuple[int, str, float]]:
    step = 0
    out = []
    i = 0
    fields = {}
    while i < len(data):
        key, i = _read_varint(data, i)
        num, wt = key >> 3, key & 7
        if wt == 0:
            val, i = _read_varint(data, i)
        elif wt == 1:
            val = struct.unpack_from("<d", data, i)[0]
            i += 8
        elif wt == 5:
            val = struct.unpack_from("<f", data, i)[0]
            i += 4
        elif wt == 2:
            ln, i = _read_varint(data, i)
            val = data[i : i + ln]
            i += ln
        else:  # pragma: no cover
            raise ValueError(f"wire type {wt}")
        fields[num] = val
    step = int(fields.get(2, 0))
    summary = fields.get(5)
    if isinstance(summary, bytes):
        j = 0
        while j < len(summary):
            key, j = _read_varint(summary, j)
            if key >> 3 == 1 and key & 7 == 2:
                ln, j = _read_varint(summary, j)
                out.append((step, *_parse_value(summary[j : j + ln])))
                j += ln
            else:  # pragma: no cover
                raise ValueError("unexpected summary field")
    return out


def _parse_value(data: bytes) -> tuple[str, float]:
    tag, value = "", 0.0
    i = 0
    while i < len(data):
        key, i = _read_varint(data, i)
        if key >> 3 == 1:
            ln, i = _read_varint(data, i)
            tag = data[i : i + ln].decode()
            i += ln
        elif key >> 3 == 2:
            value = struct.unpack_from("<f", data, i)[0]
            i += 4
        else:  # pragma: no cover
            raise ValueError("unexpected value field")
    return tag, value


def _read_varint(data: bytes, i: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


class ScalarLogger:
    """TensorBoard events + CSV side-by-side (``log_dir/scalars.csv``)."""

    def __init__(self, log_dir: str):
        self.writer = SummaryWriter(log_dir)
        self.csv_path = os.path.join(log_dir, "scalars.csv")
        new = not os.path.exists(self.csv_path)
        self._csv_f = open(self.csv_path, "a", newline="")
        self._csv = csv.writer(self._csv_f)
        if new:
            self._csv.writerow(["step", "tag", "value", "wall_time"])

    def log(self, scalars: Mapping[str, float], step: int):
        now = time.time()
        for tag, value in scalars.items():
            self.writer.add_scalar(tag, float(value), step, flush=False)
            self._csv.writerow([step, tag, float(value), now])
        self.writer.flush()
        self._csv_f.flush()

    def close(self):
        self.writer.close()
        if not self._csv_f.closed:
            self._csv_f.close()
