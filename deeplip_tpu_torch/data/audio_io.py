"""Host-side audio IO: WAV decode/encode and resampling (numpy).

Counterpart of ``deeplip_tpu/data/audio_io.py``: the stdlib/RIFF readers
(the C++ batch decoder is ``deeplip_tpu_torch.native``). Conventions of the
reference's soundfile reads: float32 in [-1, 1), channel 0 of multi-channel
files, ``start``/``stop`` sample offsets. Resampling is resampy's
``kaiser_best`` windowed sinc (what the reference's ``librosa.resample``
resolves to), host-side, for offline preparation.
"""

from __future__ import annotations

import struct
import wave

import numpy as np


def read_wav(
    path: str, start: int = 0, stop: int | None = None, mono: bool = True
) -> tuple[np.ndarray, int]:
    """Read a WAV file to float32; returns ``(samples, rate)``. IEEE-float32
    and WAVE_FORMAT_EXTENSIBLE files, which the stdlib ``wave`` module
    rejects, go through a small RIFF parser."""
    try:
        return _read_wav_stdlib(path, start, stop, mono)
    except wave.Error:
        return _read_wav_riff(path, start, stop, mono)


def _read_wav_stdlib(path, start, stop, mono):
    with wave.open(path, "rb") as w:
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        rate = w.getframerate()
        n_frames = w.getnframes()
        stop = n_frames if stop is None else min(stop, n_frames)
        start = min(start, stop)
        w.setpos(start)
        raw = w.readframes(stop - start)

    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        ints = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        data = ints.astype(np.float32) / 8388608.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {sampwidth}")

    if n_channels > 1:
        data = data.reshape(-1, n_channels)
        if mono:
            data = data[:, 0]
    return data, rate


def read_wav_int16(
    path: str, start: int = 0, stop: int | None = None, mono: bool = True
) -> tuple[np.ndarray, int]:
    """Raw PCM16 samples with no float conversion; returns ``(int16, rate)``.

    For integer-PCM16 WAVs the values equal ``round(read_wav(...)[0] *
    32768)`` exactly. Other sample widths raise.
    """
    with wave.open(path, "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError(f"{path}: not PCM16 (use read_wav)")
        n_channels = w.getnchannels()
        rate = w.getframerate()
        n_frames = w.getnframes()
        stop = n_frames if stop is None else min(stop, n_frames)
        start = min(start, stop)
        w.setpos(start)
        raw = w.readframes(stop - start)
    data = np.frombuffer(raw, dtype="<i2")
    if n_channels > 1:
        data = data.reshape(-1, n_channels)
        if mono:
            data = data[:, 0]
    return data, rate


def _read_wav_riff(path, start, stop, mono):
    """Minimal RIFF walk for formats stdlib wave rejects (IEEE float32,
    WAVE_FORMAT_EXTENSIBLE)."""
    with open(path, "rb") as f:
        if f.read(4) != b"RIFF":
            raise ValueError(f"{path}: not a RIFF file")
        f.read(4)
        if f.read(4) != b"WAVE":
            raise ValueError(f"{path}: not a WAVE file")
        fmt = channels = rate = bits = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise ValueError(f"{path}: no data chunk")
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                buf = f.read(size)
                if len(buf) < 16:
                    raise ValueError(f"{path}: truncated fmt chunk")
                fmt, channels, rate = struct.unpack("<HHI", buf[:8])
                bits = struct.unpack("<H", buf[14:16])[0]
                if fmt == 0xFFFE and size >= 40:  # EXTENSIBLE: subformat tag
                    fmt = struct.unpack("<H", buf[24:26])[0]
                if channels < 1 or bits not in (8, 16, 24, 32):
                    raise ValueError(
                        f"{path}: bad wav format ({channels} ch, {bits}-bit)")
            elif cid == b"data":
                if fmt is None:
                    raise ValueError(f"{path}: data before fmt chunk")
                frame_bytes = (bits // 8) * channels
                n_frames = size // frame_bytes
                stop2 = n_frames if stop is None else min(stop, n_frames)
                start2 = min(start, stop2)
                f.seek(start2 * frame_bytes, 1)
                raw = f.read((stop2 - start2) * frame_bytes)
                if fmt == 3 and bits == 32:
                    data = np.frombuffer(raw, dtype="<f4").astype(np.float32)
                elif fmt == 1 and bits == 16:
                    data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
                elif fmt == 1 and bits == 32:
                    data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
                else:
                    raise ValueError(
                        f"{path}: unsupported wav format {fmt}/{bits}-bit")
                if channels > 1:
                    data = data.reshape(-1, channels)
                    if mono:
                        data = data[:, 0]
                return data, rate
            else:
                f.seek(size + (size & 1), 1)


def wav_format(path: str) -> tuple[int, int, int] | None:
    """Header-only probe: ``(fmt_tag, bits_per_sample, rate)`` or ``None``.

    ``fmt_tag`` is the RIFF format code (1 = integer PCM, 3 = IEEE float;
    WAVE_FORMAT_EXTENSIBLE resolves to its subformat). Returns ``None`` for
    anything that does not parse as RIFF/WAVE.
    """
    try:
        with open(path, "rb") as f:
            if f.read(4) != b"RIFF":
                return None
            f.read(4)
            if f.read(4) != b"WAVE":
                return None
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    return None
                cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
                if cid == b"fmt ":
                    buf = f.read(size)
                    if len(buf) < 16:
                        return None
                    fmt, _ch, rate = struct.unpack("<HHI", buf[:8])
                    bits = struct.unpack("<H", buf[14:16])[0]
                    if fmt == 0xFFFE and size >= 40:
                        fmt = struct.unpack("<H", buf[24:26])[0]
                    return fmt, bits, rate
                f.seek(size + (size & 1), 1)
    except OSError:
        return None


def write_wav(path: str, data: np.ndarray, rate: int) -> None:
    """Write float32 [-1, 1] mono/stereo data as PCM16 WAV."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    pcm = np.clip(data * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(data.shape[1])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def resample(data: np.ndarray, orig_rate: int, target_rate: int,
             method: str = "kaiser_best") -> np.ndarray:
    """Resample 1-D audio. ``kaiser_best`` (the default, the reference's
    librosa/resampy filter) gives exactly :func:`resampled_length` samples,
    as librosa fixes them; ``polyphase`` is scipy's ``resample_poly`` by the
    reduced rate ratio (another FIR design)."""
    if orig_rate == target_rate:
        return data
    if method == "polyphase":
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(orig_rate, target_rate)
        return resample_poly(data, target_rate // g, orig_rate // g).astype(np.float32)
    if method != "kaiser_best":
        raise ValueError(f"unknown resample method {method!r}")
    y = _resample_sinc(np.asarray(data, np.float64), orig_rate, target_rate)
    n_out = resampled_length(len(data), orig_rate, target_rate)
    if len(y) > n_out:
        y = y[:n_out]
    elif len(y) < n_out:
        y = np.pad(y, (0, n_out - len(y)))
    return y.astype(np.float32)


def resampled_length(n_samples: int, orig_rate: int, target_rate: int) -> int:
    """Output length of :func:`resample`: ``ceil(n * target/orig)``."""
    if orig_rate == target_rate:
        return int(n_samples)
    from math import gcd

    g = gcd(orig_rate, target_rate)
    return -(-int(n_samples) * (target_rate // g) // (orig_rate // g))


# resampy's kaiser_best filter-design constants: a windowed-sinc lowpass
# sampled at 2**precision points per zero crossing, 64 zero crossings per
# wing, Kaiser taper, passband rolloff just below Nyquist.
_KAISER_BEST = dict(
    num_zeros=64,
    precision=9,
    beta=14.769656459379492,
    rolloff=0.9475937167399596,
)


def _sinc_window(num_zeros: int, precision: int, beta: float,
                 rolloff: float) -> np.ndarray:
    """Right half (including the center tap) of the windowed-sinc filter,
    resampy ``filters.sinc_window``."""
    from scipy.signal.windows import kaiser

    n = (2 ** precision) * num_zeros
    sinc_win = rolloff * np.sinc(
        rolloff * np.linspace(0, num_zeros, num=n + 1, endpoint=True))
    taper = kaiser(2 * n + 1, beta)[n:]
    return sinc_win * taper


def _resample_sinc(x: np.ndarray, sr_orig: int, sr_new: int,
                   block: int = 8192) -> np.ndarray:
    """Vectorized evaluation of resampy's ``resample_f`` kernel: for each
    output time, accumulate left/right filter wings over the input, with
    the filter table linearly interpolated. Output samples are processed in
    blocks of ``block`` to bound the (t × taps) intermediate."""
    p = _KAISER_BEST
    num_table = 2 ** p["precision"]
    ratio = float(sr_new) / sr_orig
    interp_win = _sinc_window(**p)
    if ratio < 1.0:
        interp_win = interp_win * ratio
    interp_delta = np.zeros_like(interp_win)
    interp_delta[:-1] = np.diff(interp_win)
    nwin = interp_win.shape[0]
    scale = min(1.0, ratio)
    index_step = int(scale * num_table)
    time_increment = 1.0 / ratio

    n_orig = x.shape[0]
    n_out = int(np.ceil(n_orig * ratio))
    y = np.empty(n_out, np.float64)
    # resampy accumulates time_register += time_increment per sample;
    # cumsum reproduces that exact sequential f64 fold
    time_register = np.empty(n_out, np.float64)
    time_register[0] = 0.0
    np.cumsum(np.full(n_out - 1, time_increment), out=time_register[1:])

    max_taps = nwin // index_step + 1
    taps = np.arange(max_taps)[None, :]
    for lo in range(0, n_out, block):
        tr = time_register[lo: lo + block]
        n = tr.astype(np.int64)
        frac = scale * (tr - n)

        def wing(frac_w, x_idx, i_cap):
            index_frac = frac_w * num_table
            offset = index_frac.astype(np.int64)
            eta = (index_frac - offset)[:, None]
            i_max = np.minimum(i_cap, (nwin - offset) // index_step)
            valid = taps < i_max[:, None]
            widx = np.minimum(offset[:, None] + taps * index_step, nwin - 1)
            w = interp_win[widx] + eta * interp_delta[widx]
            xs = x[np.clip(x_idx, 0, n_orig - 1)]
            return np.einsum("ti,ti->t", np.where(valid, w, 0.0), xs)

        left = wing(frac, n[:, None] - taps, n + 1)
        right = wing(scale - frac, n[:, None] + taps + 1, n_orig - n - 1)
        y[lo: lo + block] = left + right
    return y
