"""TensorBoard scalar events without TensorFlow or the tensorboard package.

The JAX package logs its scalars through `torch.utils.tensorboard`, which
needs the tensorboard package (and imports TensorFlow where it is
installed).  Neither is on the GPU machine, so this writer produces the
same event files itself: the TFRecord framing (little-endian length, the
masked CRC-32C of the length, the serialized `Event`, its masked CRC-32C)
around protobuf `Event{wall_time, step, file_version | summary}` messages,
`Summary{value: [{tag, simple_value}]}`.  TensorBoard reads them as it
reads SummaryWriter's.
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict

_POLY = 0x82F63B78          # CRC-32C (Castagnoli), reflected


def _crc_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _bytes_field(num: int, data: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(data)) + data


def _event(step: int, body: bytes) -> bytes:
    """Event{wall_time: 1 (double), step: 2 (int64), body}."""
    return (_varint((1 << 3) | 1) + struct.pack("<d", time.time())
            + _varint((2 << 3) | 0) + _varint(step & (2 ** 64 - 1)) + body)


class EventWriter:
    """Appends scalar summaries to `<log_dir>/events.out.tfevents.<time>.
    <host>.<pid>`, flushed after every record."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(time.time())}."
                     f"{socket.gethostname()}.{os.getpid()}")
        self._f = open(self.path, "ab")
        self._write(_event(0, _bytes_field(3, b"brain.Event:2")))

    def _write(self, event: bytes):
        header = struct.pack("<Q", len(event))
        self._f.write(header + struct.pack("<I", _masked_crc(header)) + event
                      + struct.pack("<I", _masked_crc(event)))
        self._f.flush()

    def add_scalars(self, values: Dict[str, float], step: int):
        """One event holding a simple_value per tag."""
        summary = b"".join(
            _bytes_field(1, _bytes_field(1, tag.encode())
                         + _varint((2 << 3) | 5) + struct.pack("<f", value))
            for tag, value in values.items())
        self._write(_event(step, _bytes_field(5, summary)))

    def close(self):
        self._f.close()
