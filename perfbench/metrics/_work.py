"""The yardstick's arithmetic: peaks, the operations and bytes of each
kernel's function, and the FLOP count of a step.

Frozen copies, so that later edits of the program or of its smoke script
cannot move them: the front-end's work (``front_end_work``, ``bound``), the
fused BN+PReLU's (``bn_bound_s``) and the max-pool's (``pool_bounds_s``)
from ``chip_smoke.py``, the FFT plan's operation count from
``ops/cuda/fbank.py: fft_flops``, and ``counted_flops`` from
``train/flops.py``. Bytes are counted from each operation's shapes: every
input byte read once and every output byte written once, whatever
implements it.

Times here are in seconds.
"""

from __future__ import annotations

import math
import re

import numpy as np

# NVIDIA's data-sheet peaks of the H100 parts, dense, at the full power
# limit: FP32 on the CUDA cores, TF32 and bf16 on the tensor cores, HBM B/s
H100_PEAKS = {
    "sxm": {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12, "hbm": 3.35e12},
    "pcie": {"fp32": 51e12, "tf32": 378e12, "bf16": 756e12, "hbm": 2.0e12},
    "nvl": {"fp32": 60e12, "tf32": 418e12, "bf16": 835e12, "hbm": 3.9e12},
}


def h100_part(device_name: str) -> str | None:
    """The H100 part a device name names, or None for another card."""
    if "H100" not in device_name:
        return None
    return "pcie" if "PCIe" in device_name else "nvl" if "NVL" in device_name else "sxm"


def peaks(device_name: str) -> dict | None:
    part = h100_part(device_name)
    return H100_PEAKS[part] if part else None


def kernel_seconds(kernels: dict, names) -> tuple[int, float]:
    """Launches and device seconds of the trace's kernels whose name is one
    of ``names`` (a demangled name matches at a word boundary before
    ``<`` or ``(``)."""
    pattern = re.compile(r"(?:^|[^A-Za-z0-9_])(?:" + "|".join(map(re.escape, names))
                         + r")\s*[<(]")
    launches, seconds = 0, 0.0
    for name, (n, t) in kernels.items():
        if pattern.search(name):
            launches += n
            seconds += t
    return launches, seconds


# ------------------------------------------------------------------ front-end
def round_half_up(x: float) -> int:
    return int(math.floor(x + 0.5))


def num_frames(n_samples: int, frame_len: int, frame_step: int) -> int:
    if n_samples <= frame_len:
        return 1
    return 1 + int(math.ceil((n_samples - frame_len) / frame_step))


def _hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def _mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


def mel_nonzeros(n_filt: int, n_fft: int, rate: int) -> int:
    """Nonzero weights of the triangular mel filterbank (python_speech_features
    corners ``floor((n_fft + 1) hz / rate)``)."""
    mel = np.linspace(_hz_to_mel(0.0), _hz_to_mel(rate / 2.0), n_filt + 2)
    bins = np.floor((n_fft + 1) * _mel_to_hz(mel) / rate).astype(np.int64)
    count = 0
    for j in range(n_filt):
        count += sum(1 for i in range(bins[j], bins[j + 1]) if i - bins[j] != 0)
        count += sum(1 for i in range(bins[j + 1], bins[j + 2]) if bins[j + 2] - i != 0)
    return count


def _butterfly_flops(radix: int) -> int:
    """Operations of a power-of-two ``radix``-point DFT done in registers by
    radix-4 then radix-2 steps: additions, and a product for every 16th
    root of unity that is not 1, -1, i or -i."""
    plan, ns = [], 1
    while ns < radix:
        p = 4 if radix // ns >= 4 else 2
        plan.append((p, ns))
        ns *= p
    total = 0
    for p, ns in plan:
        q = radix // p
        total += q * (16 if p == 4 else 4)
        total += 6 * sum((j % ns) * r * (16 // (ns * p)) % 16 % 4 != 0
                         for j in range(q) for r in range(p))
    return total


def fft_flops(n_fft: int) -> float:
    """The least of two counts for the complex ``n_fft/2``-point FFT inside a
    real ``n_fft``-point one (a power of two): radix 16 while four factors
    of 2 are left and one pass of the rest, with twiddle products after the
    first pass; or ``5 M log2 M``."""
    m = n_fft // 2
    twos = m.bit_length() - 1
    radices = [16] * (twos // 4) + ([1 << (twos % 4)] if twos % 4 else [])
    plan = sum((m // r) * (_butterfly_flops(r) + (6 * (r - 1) if i else 0))
               for i, r in enumerate(radices))
    return min(float(plan), 5.0 * m * math.log2(m))


def feature_settings(config: dict) -> dict:
    """The front-end settings of an audio configuration file, flat."""
    data = config["data"]["python_data_config"]
    return {**data[data["feat_type"]], "rate": data["rate"], "feat_type": data["feat_type"]}


def front_end_work(b: int, s: int, feat: dict) -> tuple[float, float]:
    """``(flops, bytes)`` of the front-end function for a ``(b, s)`` f32 PCM
    batch at the feature settings ``feat`` (``n_fft``, ``num_bin``,
    ``num_cep``, ``energy``, ``rate``, ``win_len``, ``win_shift``):
    pre-emphasis (2 a sample), one real FFT a frame, the untangle (12 a
    bin), the power (4 a bin), the mel sums, and for MFCC the energy sum,
    the DCT and the lifter. Bytes: PCM and lengths in, features out, the
    mel weights, DCT and lifter once."""
    rate = int(feat["rate"])
    frame_len = round_half_up(feat["win_len"] * rate)
    frame_step = round_half_up(feat["win_shift"] * rate)
    t = num_frames(s, frame_len, frame_step)
    n_fft, n_bin = int(feat["n_fft"]), int(feat["num_bin"])
    n = n_fft // 2
    weights = mel_nonzeros(n_bin, n_fft, rate)
    per_frame = fft_flops(n_fft) + 12 * (n - 1) + 2 + 4 * (n + 1) + 2 * weights
    consts, d = weights, n_bin
    if feat.get("feat_type", "mfcc") == "mfcc":
        n_cep, energy = int(feat["num_cep"]), bool(feat["energy"])
        dct_cols = n_cep - 1 if energy else n_cep
        per_frame += 2 * n_bin * dct_cols + n_cep + (n if energy else 0)
        consts += n_bin * n_cep + n_cep
        d = n_cep
    return (float(2 * b * s + b * t * per_frame), float(4 * (b * s + b + b * t * d + consts)))


def bound_s(work: tuple[float, float], peak: dict, ops_peak: str = "fp32") -> float:
    """The least time for ``(flops, bytes)`` at the card's peaks."""
    return max(work[0] / peak[ops_peak], work[1] / peak["hbm"])


# ------------------------------------------------------------------ BN + PReLU
BN_FLOPS = {"fwd": 9, "bwd": 22}   # per element: the sums, then the apply
BN_BYTES = {"fwd": 3, "bwd": 5}    # |x| multiples: x twice and y once; x, dy twice and dx


def bn_bound_s(n: int, itemsize: int, peak: dict, kind: str) -> float:
    """Least time of the fused train-mode BN+PReLU forward (``fwd``) or
    backward (``bwd``) over ``n`` elements of ``itemsize`` bytes."""
    return max(BN_BYTES[kind] * n * itemsize / peak["hbm"], BN_FLOPS[kind] * n / peak["fp32"])


def lipreading_bn_sites(b: int, t: int, crop: int = 88) -> list:
    """``(shape, sites)`` of the nine train-mode BN+PReLU sites of a
    Lipreading step (ResNet-18 trunk, 64 frontend channels): the frontend's
    at half the crop, then two ``bn1`` sites a trunk stage."""
    n, h = b * t, crop // 2
    sizes = [(h + 1) // 2]
    for _ in range(3):
        sizes.append((sizes[-1] + 1) // 2)
    return [((b, t, h, h, 64), 1)] + [((n, s, s, c), 2) for s, c in zip(sizes, (64, 128, 256, 512))]


def bn_step_bound_s(sites: list, itemsize: int, peak: dict) -> float:
    return sum(count * (bn_bound_s(math.prod(shape), itemsize, peak, "fwd")
                        + bn_bound_s(math.prod(shape), itemsize, peak, "bwd"))
               for shape, count in sites)


# ------------------------------------------------------------------ max-pool
def pooled_size(n: int) -> int:
    return (n - 1) // 2 + 1


def pool_bounds_s(shape, itemsize: int, peak: dict) -> dict:
    """Least times of the (1, 3, 3)/(1, 2, 2) frontend max-pool on a
    channels-last ``(N, T, H, W, C)`` input: forward x in and y out;
    backward dy and one byte of window position an output in, dx out. Nine
    compares an output never bound it."""
    n_in = math.prod(shape)
    n_out = n_in // (shape[2] * shape[3]) * pooled_size(shape[2]) * pooled_size(shape[3])
    bw = peak["hbm"]
    return {"fwd": (n_in + n_out) * itemsize / bw,
            "bwd": ((n_in + n_out) * itemsize + n_out) / bw}


# ------------------------------------------------------------------ FLOPs of a step
def counted_flops(fn, *args, **kwargs) -> float | None:
    """FLOPs of one eager call as ``FlopCounterMode`` counts them (matrix
    products and convolutions, forward and backward; the port's own kernels
    and elementwise passes are not counted). The call runs. None when
    nothing was counted."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    flops = float(counter.get_total_flops())
    return flops if flops > 0 else None
