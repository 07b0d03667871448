"""Kaldi ark/scp tables, read and written directly (no kaldiio).

A copy of ``deeplip_tpu/interop/kaldi.py`` (numpy only), so the two
packages write the same bytes and read each other's files. The Kaldi
binary table format, in the subset the reference uses (float matrices for
features, float vectors for x-vectors):

- an ``ark`` record is ``<utt_id> \\x00B<type-token><dims><data>`` where the
  type token is ``FM `` (float32 matrix) or ``FV `` (float32 vector) and
  each dimension is ``\\x04`` + little-endian int32;
- an ``scp`` line is ``<utt_id> <ark_path>:<byte_offset>`` with the offset
  pointing at the ``\\x00B`` marker.
"""

from __future__ import annotations

import struct
from typing import Iterator, Mapping

import numpy as np


def _write_record(f, utt_id: str, array: np.ndarray) -> int:
    """Append one binary record; returns the scp offset."""
    f.write(utt_id.encode() + b" ")
    offset = f.tell()
    f.write(b"\x00B")
    array = np.asarray(array, np.float32)
    if array.ndim == 1:
        f.write(b"FV ")
        f.write(b"\x04" + struct.pack("<i", array.shape[0]))
    elif array.ndim == 2:
        f.write(b"FM ")
        f.write(b"\x04" + struct.pack("<i", array.shape[0]))
        f.write(b"\x04" + struct.pack("<i", array.shape[1]))
    else:
        raise ValueError("only 1-D/2-D float arrays supported")
    f.write(array.astype("<f4").tobytes())
    return offset


def write_ark_scp(
    utt2array: Mapping[str, np.ndarray], ark_path: str, scp_path: str | None = None
) -> None:
    """Write a binary ark (+ optional scp index) from an ordered mapping."""
    offsets = {}
    with open(ark_path, "wb") as f:
        for utt, arr in utt2array.items():
            offsets[utt] = _write_record(f, utt, arr)
    if scp_path:
        with open(scp_path, "w") as f:
            for utt, off in offsets.items():
                f.write(f"{utt} {ark_path}:{off}\n")


def _expect(f, want: bytes, what: str) -> None:
    # an explicit check, not an assert: asserts are compiled out under
    # python -O, and these reads must consume the stream's bytes either way
    got = f.read(len(want))
    if got != want:
        raise ValueError(f"bad kaldi {what}: expected {want!r}, got {got!r}")


def _read_entry_body(f) -> np.ndarray:
    """Read one record body from an open handle positioned at '\x00B'."""
    _expect(f, b"\x00B", "binary marker")
    token = f.read(3)
    if token == b"FV ":
        _expect(f, b"\x04", "size marker")
        (dim,) = struct.unpack("<i", f.read(4))
        return np.frombuffer(f.read(4 * dim), "<f4").copy()
    if token == b"FM ":
        _expect(f, b"\x04", "size marker")
        (rows,) = struct.unpack("<i", f.read(4))
        _expect(f, b"\x04", "size marker")
        (cols,) = struct.unpack("<i", f.read(4))
        data = np.frombuffer(f.read(4 * rows * cols), "<f4")
        return data.reshape(rows, cols).copy()
    raise ValueError(f"unsupported kaldi type token {token!r}")


def read_ark_entry(ark_path: str, offset: int) -> np.ndarray:
    """Read one record given its scp byte offset."""
    with open(ark_path, "rb") as f:
        f.seek(offset)
        return _read_entry_body(f)


def read_scp(scp_path: str) -> Iterator[tuple[str, np.ndarray]]:
    """Iterate ``(utt_id, array)`` over an scp index."""
    with open(scp_path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            utt, loc = line.split(" ", 1)
            path, off = loc.rsplit(":", 1)
            yield utt, read_ark_entry(path, int(off))


def read_ark(ark_path: str) -> Iterator[tuple[str, np.ndarray]]:
    """Iterate all records of a binary ark in ONE sequential pass."""
    with open(ark_path, "rb") as f:
        while True:
            utt = bytearray()
            ch = f.read(1)
            if not ch:
                return
            while ch != b" ":
                utt += ch
                ch = f.read(1)
                if not ch:
                    return
            yield utt.decode(), _read_entry_body(f)


class KaldiHelper:
    """The reference's ``KaldiHelper`` interface: read and write features
    and speaker embeddings."""

    def read_feat(self, scp_path: str):
        for utt, arr in read_scp(scp_path):
            yield arr, utt

    def write_feat(self, utt2feat: Mapping[str, np.ndarray], ark_path: str,
                   scp_path: str | None = None) -> None:
        write_ark_scp(utt2feat, ark_path, scp_path)

    def read_speaker_embedding(self, scp_path: str):
        for utt, arr in read_scp(scp_path):
            yield arr.reshape(-1), utt

    def write_speaker_embedding(self, utt2xv: Mapping[str, np.ndarray],
                                ark_path: str, scp_path: str | None = None) -> None:
        write_ark_scp({u: np.asarray(v).reshape(-1) for u, v in utt2xv.items()},
                      ark_path, scp_path)
