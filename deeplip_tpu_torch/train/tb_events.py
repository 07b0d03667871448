"""Minimal TensorBoard event-file writer (no TensorFlow, no tensorboard).

A copy of ``deeplip_tpu/train/tb_events.py``, so both packages write the
same bytes: TFRecord framing (a length and its masked CRC32C, the payload
and its masked CRC32C) around hand-encoded ``Event`` protos, with only the
``wall_time``, ``step`` and ``summary.value{tag, simple_value}`` fields that
scalars need. ``tensorboard --logdir exp/`` reads the files; the card's
machine has no ``tensorboard`` package, and none is needed to write them.
"""

from __future__ import annotations

import os
import socket
import struct
import time


def _crc32c_table():
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _crc32c_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


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


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _len_delimited(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _scalar_value(tag: str, value: float) -> bytes:
    # Summary.Value: tag = field 1 (string), simple_value = field 2 (float)
    body = _len_delimited(1, tag.encode()) + _field(2, 5) + struct.pack(
        "<f", float(value)
    )
    return _len_delimited(1, body)  # Summary.value is repeated field 1


def _event(wall_time: float, step: int | None = None,
           file_version: str | None = None,
           scalars: dict[str, float] | None = None) -> bytes:
    # Event: wall_time = field 1 (double), step = field 2 (int64),
    #        file_version = field 3 (string), summary = field 5 (message)
    out = _field(1, 1) + struct.pack("<d", wall_time)
    if step is not None:
        out += _field(2, 0) + _varint(int(step) & 0xFFFFFFFFFFFFFFFF)
    if file_version is not None:
        out += _len_delimited(3, file_version.encode())
    if scalars:
        summary = b"".join(_scalar_value(t, v) for t, v in scalars.items())
        out += _len_delimited(5, summary)
    return out


class TBEventWriter:
    """Append-only scalar event writer: one ``events.out.tfevents.*`` file."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        host = socket.gethostname() or "localhost"
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(now)}.{host}"
        )
        self._file = open(self.path, "ab")
        self._write_record(_event(now, file_version="brain.Event:2"))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._file.write(header)
        self._file.write(struct.pack("<I", _masked_crc(header)))
        self._file.write(data)
        self._file.write(struct.pack("<I", _masked_crc(data)))
        self._file.flush()

    def add_scalars(self, step: int, scalars: dict[str, float],
                    wall_time: float | None = None) -> None:
        if not scalars:
            return
        self._write_record(
            _event(wall_time if wall_time is not None else time.time(),
                   step=step, scalars=scalars)
        )

    def close(self) -> None:
        if not self._file.closed:
            self._file.close()
