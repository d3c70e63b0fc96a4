"""A TensorBoard scalar writer without TensorFlow or the tensorboard
package (port of df3d/utils/tb_writer.py).

The reference trainers log scalars through torch.utils.tensorboard; this
writes the same file format (TFRecord-framed Event protos carrying
Summary.simple_value, crc32c checksums, protobuf varints) by hand, so any
TensorBoard reads the port's run directories and the card's machine needs
no tensorboard install. Scalars only, as the reference writes.
"""

from __future__ import annotations

import pathlib
import socket
import struct
import time

# --- crc32c (Castagnoli), table-based, as required by TFRecord framing ---
_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- tiny protobuf encoders (wire format only, fields we need) ---
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


def _event(wall_time: float, step: int | None = None,
           file_version: str | None = None,
           summary: bytes | None = None) -> bytes:
    # Event proto: 1=wall_time double, 2=step int64, 3=file_version string,
    # 5=summary message
    out = bytearray(b"\x09" + struct.pack("<d", wall_time))
    if step is not None:
        out += b"\x10" + _varint(step)
    if file_version is not None:
        out += _field_bytes(3, file_version.encode())
    if summary is not None:
        out += _field_bytes(5, summary)
    return bytes(out)


def _scalar_summary(tag: str, value: float) -> bytes:
    # Summary.Value: 1=tag string, 2=simple_value float; Summary: 1=value
    val = _field_bytes(1, tag.encode()) + b"\x15" + struct.pack("<f", value)
    return _field_bytes(1, val)


class ScalarWriter:
    """Append-only TensorBoard events file: add_scalar(tag, value, step)."""

    def __init__(self, log_dir):
        d = pathlib.Path(log_dir)
        d.mkdir(parents=True, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._f = open(d / name, "ab")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, record: bytes) -> None:
        hdr = struct.pack("<Q", len(record))
        self._f.write(hdr + struct.pack("<I", _masked_crc(hdr)))
        self._f.write(record + struct.pack("<I", _masked_crc(record)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), step=step,
                           summary=_scalar_summary(tag, float(value))))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()
