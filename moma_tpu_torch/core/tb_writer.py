"""Dependency-free TensorBoard scalar event writer.

The port's own copy of moma_tpu/core/tb_writer.py (pure Python, same
names): moma_tpu_torch imports nothing of the JAX package.  It writes
standard TensorBoard `events.out.tfevents.*` files readable by
TensorBoard / tensorboardX, without importing TensorFlow or tensorboard
into the training process.

Format: each record is a TFRecord frame
    uint64 length | uint32 masked_crc32c(length) | bytes data |
    uint32 masked_crc32c(data)
holding a serialized `tensorflow.Event` protobuf.  Only the fields
needed for scalars are hand-encoded (wall_time=1 double, step=2 int64,
file_version=3 string, summary=5 message{value=1 message{tag=1 string,
simple_value=2 float}}).
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ---------------------------------------------------------------- crc32c

_CRC_TABLE = []
_POLY = 0x82F63B78  # Castagnoli, reflected


def _make_table():
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ------------------------------------------------------------- protobuf

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _scalar_event(wall_time: float, step: int, tag: str, value: float) -> bytes:
    sv = _len_delim(1, tag.encode()) + _float(2, float(value))
    summary = _len_delim(1, sv)
    return _double(1, wall_time) + _int64(2, step) + _len_delim(5, summary)


def _version_event(wall_time: float) -> bytes:
    return _double(1, wall_time) + _len_delim(3, b"brain.Event:2")


# --------------------------------------------------------------- writer

class TBWriter:
    """Minimal SummaryWriter: `scalar(tag, value, step)` + flush/close."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s.%d.v2" % (
            int(time.time()), socket.gethostname(), os.getpid())
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._record(_version_event(time.time()))
        self.flush()

    def _record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int):
        self._record(_scalar_event(time.time(), int(step), tag, float(value)))

    def scalars(self, step: int, **values):
        for tag, v in values.items():
            self.scalar(tag, v, step)

    def flush(self):
        self._f.flush()

    def close(self):
        self.flush()
        self._f.close()
