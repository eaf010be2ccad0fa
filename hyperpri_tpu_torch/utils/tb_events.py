"""Dependency-free TensorBoard event-file writer (the port's copy of
hyperpri_tpu/utils/tb_events.py). The wire format is produced directly:

  events file = sequence of TFRecords, each framing a serialized
  tensorflow.Event protobuf. TFRecord framing is
      uint64 length | uint32 masked_crc32c(length) |
      bytes  data   | uint32 masked_crc32c(data)
  and the Event messages used here need only four proto fields:
      Event.wall_time    = field 1, double
      Event.step         = field 2, varint
      Event.file_version = field 3, string ("brain.Event:2", first record)
      Event.summary      = field 5, message Summary
      Summary.value      = field 1, repeated Value
      Value.tag          = field 1, string
      Value.simple_value = field 2, float (fixed32)

Hand-encoding nine wire bytes of protobuf beats depending on protoc for a
scalar logger; TensorBoard loads these files unmodified.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

# -- crc32c (Castagnoli), table-driven, with the TFRecord mask ---------------

_CRC_TABLE = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    rotated = ((crc >> 15) | (crc << 17)) & 0xFFFFFFFF
    return (rotated + 0xA282EAD8) & 0xFFFFFFFF


# -- protobuf wire helpers ----------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_double(num: int, v: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", v)


def _field_float(num: int, v: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", v)


def _field_varint(num: int, v: int) -> bytes:
    return _varint((num << 3) | 0) + _varint(v)


def _event(wall_time: float, step: Optional[int] = None,
           file_version: Optional[str] = None,
           scalars: Optional[Dict[str, float]] = None) -> bytes:
    msg = _field_double(1, wall_time)
    if step is not None:
        msg += _field_varint(2, step)
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _field_bytes(
                1, _field_bytes(1, tag.encode()) + _field_float(2, float(v))
            )
            for tag, v in scalars.items()
        )
        msg += _field_bytes(5, summary)
    return msg


class TBEventWriter:
    """Append-only scalar event writer, one file per run directory."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s" % (time.time(), socket.gethostname())
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._write_record(_event(time.time(), file_version="brain.Event:2"))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", masked_crc32c(data)))
        self._f.flush()

    def add_scalars(self, scalars: Dict[str, float], step: int) -> None:
        clean = {}
        for k, v in scalars.items():
            try:
                clean[k] = float(v)
            except (TypeError, ValueError):
                continue
        if clean:
            self._write_record(_event(time.time(), step=step, scalars=clean))

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()
