"""ctypes bindings for the port's native IO library (``wavio.cpp``).

Counterpart of ``deeplip_tpu/native/__init__.py``, with the same API and
argument types, over the port's own copy of the C++ source. The library is
built at first call, never at import:

    g++ -O3 -fPIC -shared -std=c++17 -pthread -o libdeeplip_native.so wavio.cpp -lz

into ``deeplip_tpu_torch/_build/<hash of the source and flags>/``, so an
edited source builds anew and an unchanged one is reused. As in
``ops/cuda/build.py``, each build writes a temporary file of its own and
renames it into place, and one lock makes threads that reach the first call
together build once. On a host that cannot compile it, :func:`available` is
False and callers keep the stdlib readers (``data.audio_io``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "wavio.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")
LIBS = ("-lz",)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libdeeplip_native.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path. Raises
    ``RuntimeError`` with the compiler's output when it cannot."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++ not on PATH, $CXX unset)")
    out.parent.mkdir(parents=True, exist_ok=True)
    # a name of this call's own: two processes that build the same library
    # never write the same file
    fd, tmp = tempfile.mkstemp(prefix="libdeeplip_native.", suffix=".tmp", dir=out.parent)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE), *LIBS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {SOURCE.name} failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.dl_read_wav.restype = ctypes.c_long
    lib.dl_read_wav.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.dl_wav_info.restype = ctypes.c_int
    lib.dl_wav_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long),
    ]
    lib.dl_read_wav_batch.restype = None
    lib.dl_read_wav_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int,
    ]
    lib.dl_read_npy.restype = ctypes.c_long
    lib.dl_read_npy.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_long, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
    ]
    lib.dl_read_npy_batch.restype = None
    lib.dl_read_npy_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_char), ctypes.c_int, ctypes.c_int,
    ]
    lib.dl_read_wav_batch_i16.restype = None
    lib.dl_read_wav_batch_i16.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int,
    ]
    return lib


def _load() -> ctypes.CDLL:
    """The loaded library, built first if needed. A failed build is
    remembered, so later calls raise at once instead of compiling again."""
    global _lib, _error
    if _lib is None:
        with _lock:
            if _lib is None:
                if _error is not None:
                    raise RuntimeError(_error)
                try:
                    _lib = _declare(ctypes.CDLL(str(build())))
                except (RuntimeError, OSError) as exc:
                    _error = str(exc)
                    raise RuntimeError(_error) from exc
    return _lib


def available() -> bool:
    """True when the library is built (building it on the first call)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def npy_available() -> bool:
    """True when the npy/npz entry points are there: the port's library
    always has them, so this is :func:`available`."""
    return available()


def wav_info(path: str) -> tuple[int, int, int]:
    """(rate, channels, n_frames)"""
    lib = _load()
    rate = ctypes.c_int()
    ch = ctypes.c_int()
    n = ctypes.c_long()
    rc = lib.dl_wav_info(path.encode(), ctypes.byref(rate), ctypes.byref(ch), ctypes.byref(n))
    if rc != 0:
        raise IOError(f"dl_wav_info({path}) failed: {rc}")
    return rate.value, ch.value, n.value


def read_wav(path: str, start: int = 0, stop: int | None = None, mono: bool = True):
    """Native drop-in for ``data.audio_io.read_wav`` (channel-0 float32)."""
    lib = _load()
    rate, _, n_frames = wav_info(path)
    stop = n_frames if stop is None else min(stop, n_frames)
    start = min(start, stop)
    cap = max(stop - start, 0)
    out = np.empty((cap,), np.float32)
    got = lib.dl_read_wav(
        path.encode(), start, stop,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap, None)
    if got < 0:
        raise IOError(f"dl_read_wav({path}) failed: {got}")
    return out[:got], rate


def _as_long(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_long))


def _read_batch(fn, dtype, ctype, paths, starts, stops, capacities, n_threads):
    n = len(paths)
    offsets = np.zeros((n,), np.int64)
    if n > 1:
        np.cumsum(capacities[:-1], out=offsets[1:])
    flat = np.zeros((int(offsets[-1] + capacities[-1]) if n else 0,), dtype)
    wrote = np.zeros((n,), np.int64)
    rates = np.zeros((n,), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    # keep the int64 copies alive across the call
    starts, stops, caps = (np.ascontiguousarray(np.asarray(a), np.int64)
                           for a in (starts, stops, capacities))
    fn(c_paths, _as_long(starts), _as_long(stops),
       flat.ctypes.data_as(ctypes.POINTER(ctype)), _as_long(offsets), _as_long(caps),
       _as_long(wrote), rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n, n_threads)
    return flat, offsets, wrote, rates


def read_wav_batch(paths: list[str], starts: list[int], stops: list[int],
                   capacities: list[int], n_threads: int = 4):
    """Threaded batch decode into one flat float32 buffer.

    Returns ``(flat, offsets, wrote, rates)`` where file i occupies
    ``flat[offsets[i] : offsets[i] + wrote[i]]``; a file that fails to
    decode reports ``wrote[i] < 0`` and the others still decode.
    """
    return _read_batch(_load().dl_read_wav_batch, np.float32, ctypes.c_float,
                       paths, starts, stops, capacities, n_threads)


def read_wav_batch_i16(paths: list[str], starts: list[int], stops: list[int],
                       capacities: list[int], n_threads: int = 4):
    """Threaded batch decode into one flat int16 buffer: PCM16 payloads are
    copied with no float round trip. Returns what :func:`read_wav_batch`
    returns."""
    return _read_batch(_load().dl_read_wav_batch_i16, np.int16, ctypes.c_int16,
                       paths, starts, stops, capacities, n_threads)


def _probe_npy(paths: list[str], key: str, n_threads: int):
    """Pass 1: payload byte counts, shapes, ranks and dtype descriptors."""
    lib = _load()
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_key = key.encode()
    shapes = np.zeros((n, 8), np.int64)
    ndims = np.zeros((n,), np.int32)
    descrs = ctypes.create_string_buffer(n * 8)
    wrote = np.zeros((n,), np.int64)
    zeros = np.zeros((n,), np.int64)
    lib.dl_read_npy_batch(
        c_paths, c_key, None, _as_long(zeros), _as_long(zeros), _as_long(wrote),
        _as_long(shapes), ndims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        descrs, n, n_threads)
    bad = np.nonzero(wrote < 0)[0]
    if bad.size:
        raise IOError(f"dl_read_npy({paths[bad[0]]!r}) failed: {wrote[bad[0]]}")
    return c_paths, c_key, shapes, ndims, descrs, wrote


def _descr(descrs, i: int) -> np.dtype:
    return np.dtype(descrs.raw[i * 8:(i + 1) * 8].split(b"\0", 1)[0].decode())


def probe_npy_shapes(paths: list[str], key: str = "data",
                     n_threads: int = 4) -> list[tuple[tuple, np.dtype]]:
    """Threaded header probe: ``(shape, dtype)`` per npy/npz file without
    reading the payloads (the zip directory and the npy header only;
    deflated members inflate at most their first 4 KB)."""
    if not paths:
        return []
    _, _, shapes, ndims, descrs, _ = _probe_npy(list(paths), key, n_threads)
    return [(tuple(shapes[i, :ndims[i]]), _descr(descrs, i)) for i in range(len(paths))]


def read_npy_batch(paths: list[str], key: str = "data",
                   n_threads: int = 4) -> list[np.ndarray]:
    """Threaded batch read of npy/npz arrays (zip walk, inflate and header
    parse in C++, without the GIL). ``key`` names the npz member (plain
    ``.npy`` files ignore it). Returns one array per path."""
    n = len(paths)
    if n == 0:
        return []
    lib = _load()
    c_paths, c_key, shapes, ndims, descrs, wrote = _probe_npy(list(paths), key, n_threads)
    offsets = np.zeros((n,), np.int64)
    np.cumsum(wrote[:-1], out=offsets[1:])
    flat = np.empty((int(offsets[-1] + wrote[-1]),), np.uint8)
    # pass 2: the payloads
    sizes = wrote.copy()
    lib.dl_read_npy_batch(
        c_paths, c_key, flat.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        _as_long(offsets), _as_long(sizes), _as_long(wrote), _as_long(shapes),
        ndims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), descrs, n, n_threads)
    out = []
    for i in range(n):
        if wrote[i] < 0:
            raise IOError(f"dl_read_npy({paths[i]!r}) failed: {wrote[i]}")
        arr = flat[int(offsets[i]):int(offsets[i] + wrote[i])].view(_descr(descrs, i))
        out.append(arr.reshape(tuple(shapes[i, :ndims[i]])))
    return out
