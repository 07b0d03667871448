#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one card and check it end to end.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and the repository's
``deeplip_tpu_torch`` package beside this script; without a card, or
without the package, it exits non-zero and prints no result. Phases:

1. Device: the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions. Every number printed after it was taken on that card.
2. Build every kernel from ``deeplip_tpu_torch/csrc`` (one nvcc per source,
   started together) and print ptxas' register/spill report.
3. Each front-end kernel against its plain PyTorch version on the card,
   TF32 off, on raw PCM with and without ragged ``sample_lengths`` (whole,
   cut, short, empty rows): mfcc-24 (energy on and off), fbank-24 and
   logfbank-60 at 24/200/203/299/331 frames, and seven configs at other
   rates and FFT sizes (n_fft 64 to 4096, and 510), within atol 2e-4 /
   rtol 1e-3; the per-kernel counters show that each case went to the
   kernel the dispatch rule names (the FFT kernel for a power-of-two
   n_fft, the DFT kernel at 510); log-mel band 0 of the MFCC configs held
   alone; an empty row equal to the plain guarded zero; the FFT kernel's
   largest error named and held against the plain version in float64. At
   the 256 x 3 s batch: the FFT kernel, the DFT kernel forced at n_fft
   512, the plain version and the plain ``dft='fft'`` front-end (cuFFT) in
   turns, by CUDA events, beside the least time the card could take for
   the function and the time of each kernel's own operations;
   logfbank-60 on the FFT kernel, with its DC bin against float64 beside
   the plain versions'; n_fft 510 on the DFT kernel.
4. The main path through the user's entry points at the flagship E-TDNN
   width (seeded random weights, BN statistics calibrated on one batch
   and then perturbed): a ragged
   PCM16 wav corpus → ``EvalUtteranceSet`` (``eval_set_kwargs`` defaults,
   batch 64) → ``AudioExtractor.extract_embeddings`` → ``cosine_eer``. Launch
   counts are zeroed just before and read just after. Two batches are
   re-embedded with the plain front-end and must agree to 1e-4.
5. A first number for the lomgrid sweep shape: 3,541 x 3 s int16
   utterances staged on the card, batch 256, 20,000 gathered cosine trials,
   by CUDA events after a warm-up sweep; 14 FFT-kernel launches a sweep
   and none of the DFT kernel.
6. The fused train-mode BN+PReLU kernels (K3 forward, K4 backward) against
   their plain versions at the five activation shapes of a bs 128 x 29-frame
   Lipreading step, in f32 and bf16: y, mean, var and dx within atol/rtol
   1e-5 (f32; y and dx 2e-2 / 1e-2 in bf16), dscale, dbias and dalpha within
   1e-4 of the plain version's largest. Kernel, plain and library
   (``F.batch_norm`` + ``F.prelu``, two calls) times by CUDA events, beside
   the least time the card could take (3|x| bytes forward, 5|x| backward).
7. The video main path through the user's entry points at the flagship
   Lipreading width (``conf/video_config.json``, seeded random weights): a
   synthetic 32-speaker x 8-clip 96x96 uint8 ``.npz`` corpus of 21-29 frames
   → ``scan_clip_dir`` → ``VideoClipBatches`` (batch 128, bucket 8) →
   ``VideoTrainer.train`` (one epoch) → ``extract_clip_embeddings``. K3/K4
   launch counts are zeroed just before training and read just after: three
   launches per site and pass (partial, finalize, apply), nine sites, so 27
   forward and 27 backward per step. K3/K4 are then held against their
   plain versions, with the bars of phase 6, at every shape the training
   epoch gave them.
8. One bs 128 x 29 step through the kernels against one through the plain
   BN+PReLU (``plain_bn_prelu``) from the same state, FP32 and cuDNN
   deterministic: loss within 1e-5 relative; the batch mean and variance
   at every fused site within 1e-5 (the mean in sigmas, the variance
   relative); the gradients no further from the plain step's than 3x what
   a 1e-6 relative nudge of the input frames moves the plain step's own
   (their norm over the whole network); K4 alone, on bit-equal
   activations, within 1e-4 of that norm. Planted K3 faults (the batch
   variance off by 1e-6, 1e-5 and 1e-4 relative; the statistics held in
   bf16) run through the same bars, and the last two must fail one of
   them. Then ms per train step and clips/s after
   warm-up, the kernels' share of a step, and one profiled step's device
   time by kernel. The frontend max-pool runs its kernels in these steps
   too (one forward and one backward launch per step, counted in phase 7)
   and is swapped for its plain version in the plain steps.
9. The frontend max-pool kernels (``csrc/maxpool_kernel.cu``) against their
   plain version (``F.max_pool3d``) at the training step's shape
   (128, 29, 44, 44, 64), one serving chunk's (32, 32, 44, 44, 64), an
   odd-sized shape and a batch with tied pad frames, f32 and bf16: y
   bit-equal; dx within 1e-6 of the plain largest (f32), one bf16 step
   against the f32-computed plain gradient (bf16); NaN propagated. Kernel,
   plain and library times by CUDA events beside the byte bounds.
10. The audio-visual serving path through the user's entry points at the
   full width of ``conf/fusion_config.yaml`` (flagship E-TDNN and
   Lipreading, 2 clips x 32 frames, 88x88 crop; seeded weights with
   calibrated BN statistics, saved as checkpoints and loaded through the
   config's ``resume`` keys): a synthetic 32-speaker corpus of 1-3 s PCM16
   wavs with two 96x96 uint8 ``.npz`` clips each → ``AVSpeakerVerifier`` →
   ``calibrate`` on a written trial list → ``enroll`` 32 speakers x 2 items
   → ``verify`` and ``identify``, with the concat and with
   ``use_fusion_head``. The front-end and max-pool kernels launch once per
   extraction chunk (counts zeroed before, read after); two chunks are
   embedded again through the plain versions of both (parts within 1e-4).
   Then ``SpeakerVerifier`` with an AS-norm cohort behind a
   ``MicroBatcher``: concurrent ``verify`` requests from 16 threads against
   the same requests served directly (decisions equal; the largest
   difference between an embedding served alone and in a batch, bar 1e-5),
   and a batch-1 verify's latency with host and with device scoring.

11. Audio x-vector training at the full width of ``conf/audio_config.yaml``
   (flagship E-TDNN, MFCC-24, LMCL scale 30 / margin 0.2, SGD, bs 256, crops
   of 200-400 frames in 11 buckets, bf16): a synthetic 128-speaker x 8
   PCM16 wav corpus of 2-5 s (and 2 wavs a speaker held out) and its
   manifest (``write_manifest``) →
   ``cli/train_audio.py --mode train`` for 2 epochs (the config's recipe
   with its paths pointed at the corpus) → the average of the 2 epochs'
   checkpoints → extraction of a 256-utterance test set held out of training
   and its cosine EER.
   Front-end launch counts are zeroed just before and read just after: one
   FFT-kernel launch per train step and per extraction batch, none of the
   DFT kernel. K1 against its plain version on every batch of both epochs
   (CMVN after, atol 2e-4 / rtol 1e-3) with its time at each crop shape.
   One f32 step through K1 against one through the plain front-end from the
   same state (TF32 off, cuDNN deterministic) at bs 256 x 300: loss within
   1e-4 relative, gradients no further than 3x what a 1e-6 elementwise
   relative nudge of the PCM moves the plain step. A bf16 step within 1e-4
   of the f32 step's loss (and 2e-2 at most) and within 0.25 of its
   gradients' norm, its forward audited (bf16 conv blocks; BN statistics,
   pooling and the cosine logits against float64), and four planted bf16
   faults (BN statistics, pooling, cosines in bf16; cosines in TF32) each
   caught. Then ms per step and crops/s at bs 256 x
   200/300/400 in bf16 and f32 by CUDA events, K1's share of a step beside
   its bound, peak memory, and one profiled bf16 step's device time by kind.

The phases run in the order 1-5, 11, 6, 9, 7, 8, 10. The last line is
``{"ok": true, "device": {...}}``; the line before it is the ``kernels``
JSON record.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from deeplip_tpu_torch.cli import train_audio as train_audio_cli  # noqa: E402
from deeplip_tpu_torch.cli.common import utterances_from_trials  # noqa: E402
from deeplip_tpu_torch.cli.train_fusion import make_trainer  # noqa: E402
from deeplip_tpu_torch.core.config import (AUDIO_DATA_OPTS, ETDNN_MODEL_OPTS, Config,  # noqa: E402
                                           load_fusion_config)
from deeplip_tpu_torch.data.audio_io import read_wav, write_wav  # noqa: E402
from deeplip_tpu_torch.data.audio_pipeline import (EvalUtterance,  # noqa: E402
                                                   EvalUtteranceSet,
                                                   eval_set_kwargs)
from deeplip_tpu_torch.data.manifest import Utterance, write_manifest  # noqa: E402
from deeplip_tpu_torch.eval.scoring import cosine_scores  # noqa: E402
from deeplip_tpu_torch.losses import softmax as softmax_losses  # noqa: E402
from deeplip_tpu_torch.ops import features as F  # noqa: E402
from deeplip_tpu_torch.ops import spectral  # noqa: E402
from deeplip_tpu_torch.data.video_dataset import (VideoClipBatches, load_clip,  # noqa: E402
                                                   scan_clip_dir)
from deeplip_tpu_torch.ops import video as V  # noqa: E402
from deeplip_tpu_torch.ops.cuda import bn_prelu, build, fbank, maxpool  # noqa: E402
from deeplip_tpu_torch.ops.cuda.fbank import (audio_features,  # noqa: E402
                                              audio_features_reference)
from deeplip_tpu_torch.ops.framing import num_frames, samples_for_frames  # noqa: E402
from deeplip_tpu_torch.models.norm import TorchBatchNorm  # noqa: E402
from deeplip_tpu_torch.serve import AVSpeakerVerifier, MicroBatcher, SpeakerVerifier  # noqa: E402
from deeplip_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from deeplip_tpu_torch.train.audio import AudioExtractor, fp32_math, masked_cmvn  # noqa: E402
from deeplip_tpu_torch.train.fusion import embed_av_items  # noqa: E402
from deeplip_tpu_torch.train.video import VideoTrainer  # noqa: E402

ATOL, RTOL = 2e-4, 1e-3          # kernel vs plain (tests/test_pallas_features.py bar)
EMB_TOL = 1e-4                   # kernel-path vs plain-path embeddings
LOMGRID_UTTS, LOMGRID_TRIALS, BATCH, SECONDS, RATE = 3541, 20000, 256, 3.0, 16000

# Published dense peaks from NVIDIA's H100 data sheets (SXM, PCIe and NVL
# parts): FP32 on CUDA cores, TF32 on tensor cores, HBM bytes/s. They assume
# the part's full power limit.
PEAKS = {
    "sxm": (67e12, 495e12, 3.35e12),
    "pcie": (51e12, 378e12, 2.0e12),
    "nvl": (60e12, 418e12, 3.9e12),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str) -> tuple[str, tuple[float, float, float]]:
    part = "pcie" if "PCIe" in name else "nvl" if "NVL" in name else "sxm"
    return part, PEAKS[part]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > ATOL + RTOL * want.abs()
    check(not bool(bad.any()),
          f"{what}: {int(bad.sum())} elements outside atol {ATOL} / rtol {RTOL}, "
          f"max abs err {float(err.max()):.3e}")
    return float(err.max())


def fft_flops(n_fft: int) -> float:
    """Operations of the complex ``n_fft/2``-point FFT inside a real
    ``n_fft``-point one: the FFT kernel's radix plan where ``n_fft`` is a
    power of two, else the usual 5 M log2 M for M points."""
    if n_fft & (n_fft - 1) == 0:
        return float(fbank.fft_flops(n_fft))
    m = n_fft // 2
    return 5.0 * m * math.log2(m)


def front_end_work(b: int, s: int, cfg: F.FeatureConfig) -> tuple[float, float]:
    """``(flops, bytes)`` that the front-end function needs for a ``(b, s)``
    batch, whichever kernel computes it: pre-emphasis once a sample (2),
    one real FFT a frame (:func:`fft_flops`), the untangle (12 a bin, the
    two bins of a pair sharing their sums), the power (4 a bin), the mel
    sums over the filterbank's nonzero weights and, for MFCC, the energy
    sum, the DCT and the lifter. Bytes: PCM and lengths in, features out,
    the mel weights, DCT and lifter once."""
    t = num_frames(s, cfg.frame_len, cfg.frame_step)
    n = cfg.n_fft // 2
    _, weights = fbank.mel_csr(cfg.num_bin, cfg.n_fft, cfg.rate, cfg.low_freq, cfg.high_freq)
    per_frame = fft_flops(cfg.n_fft) + 12 * (n - 1) + 2 + 4 * (n + 1) + 2 * weights.size
    consts = weights.size
    d = cfg.num_bin
    if cfg.feat_type == "mfcc":
        dct_cols = cfg.num_cep - 1 if cfg.energy else cfg.num_cep
        per_frame += 2 * cfg.num_bin * dct_cols + cfg.num_cep + (n if cfg.energy else 0)
        consts += cfg.num_bin * cfg.num_cep + cfg.num_cep
        d = cfg.num_cep
    return (float(2 * b * s + b * t * per_frame),
            float(4 * (b * s + b + b * t * d + consts)))


def kernel_flops(b: int, s: int, cfg: F.FeatureConfig, kernel: str) -> float:
    """Operations that one kernel's own algorithm does for a ``(b, s)``
    batch, beyond what :func:`front_end_work` counts for the function.
    ``"fft"``: pre-emphasis of each frame's own samples (2 a sample), the
    DC bin's sum in sample order (3 a sample), the FFT, the untangle of
    both bins of every pair apart (20 a bin with the power), the mel sums,
    and for MFCC the energy, the DCT and the lifter. ``"dft"``: the dense
    product against the basis columns that are not zero (the sine columns
    at DC and at Nyquist are, up to rounding), the power (3 a bin), the mel
    sums, and for MFCC the energy, the DCT and the lifter."""
    t = num_frames(s, cfg.frame_len, cfg.frame_step)
    n = cfg.n_fft // 2
    _, weights = fbank.mel_csr(cfg.num_bin, cfg.n_fft, cfg.rate, cfg.low_freq, cfg.high_freq)
    if kernel == "fft":
        per_frame = 5 * cfg.frame_len + fft_flops(cfg.n_fft) + 20 * (n + 1)
    else:
        basis = spectral.rdft_fused_matrix(cfg.frame_len, cfg.n_fft)
        cols = int(np.count_nonzero(np.abs(basis).max(axis=0) > 1e-6))
        per_frame = 2 * cfg.frame_len * cols + 3 * (n + 1)
    per_frame += 2 * weights.size
    if cfg.feat_type == "mfcc":
        dct_cols = cfg.num_cep - 1 if cfg.energy else cfg.num_cep
        per_frame += 2 * cfg.num_bin * dct_cols + cfg.num_cep + (n + 1 if cfg.energy else 0)
    return float(b * t * per_frame)


def bound(work: tuple[float, float], peaks) -> tuple[float, str]:
    """The least time in ms for ``(flops, bytes)`` at the FP32 and HBM
    peaks, and which of the two sets it."""
    ops_ms, bytes_ms = work[0] / peaks[0] * 1e3, work[1] / peaks[2] * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


FBANK_KERNELS = {"fft": fbank.fft_audio_features, "dft": fbank.dft_audio_features}


def zero_fbank_counts() -> None:
    for kernel in FBANK_KERNELS.values():
        kernel.launches = 0


def fbank_counts() -> dict:
    """Front-end launches, each kernel's own."""
    return {k: kernel.launches for k, kernel in FBANK_KERNELS.items()}


@contextlib.contextmanager
def plain_front_end():
    """Route ``extract_features``' mel front-end through the kernels' plain
    version (on the same device) for an A/B check; launches nothing."""
    kernel = fbank.audio_features
    fbank.audio_features = audio_features_reference
    try:
        yield
    finally:
        fbank.audio_features = kernel


# ---------------------------------------------------------------- phase 1
def device_phase() -> dict:
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    log(smi.splitlines()[0] if smi else name)
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible")
    return {"name": name, "smi": smi.splitlines()[0] if smi else name}


# ---------------------------------------------------------------- phase 2
def build_phase() -> None:
    t0 = time.perf_counter()
    reports = build.build()
    log(f"build: {sorted(reports) or 'cached'} in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


# ---------------------------------------------------------------- phase 3
KERNEL_CONFIGS = [
    ("mfcc", {"num_bin": 26, "num_cep": 24, "energy": True}),
    ("mfcc", {"num_bin": 26, "num_cep": 24, "energy": False}),
    ("fbank", {"num_bin": 24}),
    ("logfbank", {"num_bin": 60}),
]
KERNEL_FRAMES = [24, 200, 203, 299, 331]
# other rates, hops and FFT sizes: a frame length and hop that are not
# multiples of 4 (22.05 kHz); the FFT kernel's two smallest sizes (64 and
# 128 points at 8 kHz: 128 and 64 frames a block) and 256 points; a
# 2048-point frame; its largest size (4096 points at 48 kHz, where the tile
# shrinks to fit shared memory); and a 510-point FFT, which is no power of
# two and goes to the DFT kernel
OTHER_CONFIGS = [
    ("mfcc", {"rate": 22050, "n_fft": 1024, "num_bin": 40, "num_cep": 13}),
    ("mfcc", {"rate": 8000, "n_fft": 64, "win_len": 0.008, "win_shift": 0.004,
              "num_bin": 16, "num_cep": 12}),
    ("logfbank", {"rate": 8000, "n_fft": 128, "win_len": 0.016, "win_shift": 0.008,
                  "num_bin": 20}),
    ("logfbank", {"rate": 8000, "n_fft": 256, "num_bin": 23}),
    ("fbank", {"n_fft": 2048, "num_bin": 40, "win_len": 0.128}),
    ("logfbank", {"rate": 48000, "n_fft": 4096, "win_len": 0.085, "num_bin": 80}),
    ("mfcc", {"n_fft": 510}),
]
OTHER_FRAMES = [24, 203]


def ragged_lengths(n: int) -> torch.Tensor:
    """Four rows: whole, cut inside a frame, short, and empty."""
    return torch.tensor([n, n - 1 - n // 3, n // 5 + 3, 0], dtype=torch.int32, device="cuda")


def launch_one(cfg: F.FeatureConfig, x: torch.Tensor, lengths, what: str) -> torch.Tensor:
    """``audio_features`` once, checking from the counters that it went to
    the kernel the dispatch rule names, and to it alone."""
    kind = "fft" if fbank.uses_fft_kernel(cfg) else "dft"
    before = fbank_counts()
    got = audio_features(x, cfg, lengths)
    after = fbank_counts()
    moved = {k: after[k] - before[k] for k in after}
    check(moved == {"fft": int(kind == "fft"), "dft": int(kind == "dft")},
          f"{what}: launches moved {moved}, not one of the {kind} kernel")
    return got


def f64_reference(x: torch.Tensor, cfg: F.FeatureConfig, lengths) -> torch.Tensor:
    """The plain version in float64 on the same f32 PCM, pre-emphasised by
    the f32-rounded coefficient that the kernels and the f32 plain version
    multiply by: the value both f32 versions approximate."""
    cfg64 = dataclasses.replace(cfg, preemph=float(np.float32(cfg.preemph)))
    return audio_features_reference(x.double(), cfg64, lengths)


def explain_worst(worst: dict) -> dict:
    """The FFT kernel's largest error against the f32 plain version, held
    against float64: the three values there, and in that frame the log-mel
    band furthest from float64 in the kernel, with the plain version's
    error in that band and the band's share of the frame's mel power."""
    cfg, x, lengths, (r, t, c) = worst["cfg"], worst["x"], worst["lengths"], worst["at"]
    ref = float(f64_reference(x, cfg, lengths)[r, t, c])
    lm = dataclasses.replace(cfg, feat_type="logfbank")
    k_lm = audio_features(x, lm, lengths)[r, t].double()
    p_lm = audio_features_reference(x, lm, lengths)[r, t].double()
    r_lm = f64_reference(x, lm, lengths)[r, t]
    band = int((k_lm - r_lm).abs().argmax())
    power = r_lm.exp()
    out = {"case": worst["what"], "row": r, "frame": t, "coef": c, "err": worst["err"],
           "kernel": worst["got"], "plain": worst["want"], "float64": ref,
           "band": band, "band_kernel_err": float(k_lm[band] - r_lm[band]),
           "band_plain_err": float(p_lm[band] - r_lm[band]),
           "band_power_share": float(power[band] / power.sum())}
    log(f"FFT kernel's largest error {out['err']:.3e}: {out['case']}, row {r}, frame {t}, "
        f"coefficient {c}: kernel {out['kernel']:.6f}, plain {out['plain']:.6f}, float64 "
        f"{ref:.6f} (kernel {out['kernel'] - ref:+.2e}, plain {out['plain'] - ref:+.2e} from "
        f"float64); in that frame log-mel band {band} is the kernel's furthest from float64 "
        f"({out['band_kernel_err']:+.2e}; plain {out['band_plain_err']:+.2e}), "
        f"{out['band_power_share']:.2e} of the frame's mel power")
    return out


def dc_witness(pcm: torch.Tensor, lengths, cfg: F.FeatureConfig, got: torch.Tensor) -> dict:
    """Log-mel band 0 of logfbank-60 holds the DC bin alone, so |X[0]| =
    sqrt(n_fft exp(band 0)). Its error against float64, over every frame of
    the batch, for the FFT kernel (X[0] summed in sample order), the plain
    version (cuBLAS) and the plain ``dft='fft'`` (cuFFT, a packed FFT); and
    how many of each one's band-0 logs miss the kernel bar against float64."""
    idx, _ = fbank.mel_csr(cfg.num_bin, cfg.n_fft, cfg.rate, cfg.low_freq, cfg.high_freq)
    check(idx[0, 0] == 0 and idx[1, 0] == 1, f"band 0 of {cfg.num_bin} is not the DC bin alone")
    ref = f64_reference(pcm, cfg, lengths)[..., 0]
    x0 = lambda band: (band.double().exp() * cfg.n_fft).sqrt()
    want = x0(ref)
    bands = {"fft_kernel": got[..., 0],
             "plain": audio_features_reference(pcm, cfg, lengths)[..., 0],
             "plain_cufft": audio_features_reference(
                 pcm, dataclasses.replace(cfg, dft="fft"), lengths)[..., 0]}
    out = {"x0_rms": float(want.square().mean().sqrt()), "x0_min": float(want.min())}
    for name, band in bands.items():
        err = (x0(band) - want).abs()
        log_err = (band.double() - ref).abs()
        out[name] = {"x0_rms_err": float(err.square().mean().sqrt()),
                     "x0_max_err": float(err.max()), "log_max_err": float(log_err.max()),
                     "log_misses": int((log_err > ATOL + RTOL * ref.abs()).sum())}
    log(f"DC bin against float64 over {ref.numel()} frames (|X[0]| rms {out['x0_rms']:.4f}, "
        f"least {out['x0_min']:.3e}): " + "; ".join(
            f"{name} |X[0]| err rms {o['x0_rms_err']:.3e} max {o['x0_max_err']:.3e}, log-mel "
            f"band 0 max {o['log_max_err']:.3e}, {o['log_misses']} outside the bar"
            for name, o in ((n, out[n]) for n in bands)))
    return out


def kernel_phase(peaks) -> dict:
    rng = np.random.default_rng(0)
    max_err = {"fft": 0.0, "dft": 0.0}
    worst = {"err": -1.0}
    band0_err = 0.0
    cases = ([(c, KERNEL_FRAMES) for c in KERNEL_CONFIGS]
             + [(c, OTHER_FRAMES) for c in OTHER_CONFIGS])
    n_cases = 0
    with fp32_math():
        for (feat_type, kw), frame_counts in cases:
            cfg = F.FeatureConfig(feat_type=feat_type, normalize=False, **kw)
            kind = "fft" if fbank.uses_fft_kernel(cfg) else "dft"
            for frames in frame_counts:
                n = samples_for_frames(frames, cfg.win_len, cfg.win_shift, cfg.rate)
                x = torch.from_numpy((rng.standard_normal((4, n)) * 0.1).astype(np.float32)).cuda()
                for lengths in (None, ragged_lengths(n)):
                    what = f"{feat_type} {kw} {frames} frames, lengths {lengths is not None}"
                    got = launch_one(cfg, x, lengths, what)
                    check(got.shape[1] == frames, f"{what}: {got.shape[1]} frames")
                    want = audio_features_reference(x, cfg, lengths)
                    err = compare(got, want, what)
                    max_err[kind] = max(max_err[kind], err)
                    if kind == "fft" and err > worst["err"]:
                        at = tuple(int(i) for i in np.unravel_index(
                            int((got - want).abs().argmax()), got.shape))
                        worst = {"err": err, "what": what, "cfg": cfg, "x": x,
                                 "lengths": lengths, "at": at,
                                 "got": float(got[at]), "want": float(want[at])}
                    n_cases += 1
                    if lengths is not None and feat_type != "mfcc":
                        # the empty row: every frame the guarded zero, eps or
                        # log(eps) = -36.04 (a residue of 1e-30 would give -69)
                        gap = float((got[3] - want[3]).abs().max())
                        check(gap <= 4e-6 and bool((want[3] == want[3][0, 0]).all()),
                              f"{what}: the empty row is {gap:.3e} from the guarded zero")
                    if feat_type == "mfcc" and cfg.n_fft == 512:
                        # mel band 0, where the sums cancel next to DC
                        lm = dataclasses.replace(cfg, feat_type="logfbank")
                        got0 = launch_one(lm, x, lengths, what + ", log-mel")[..., 0]
                        band0_err = max(band0_err, compare(
                            got0, audio_features_reference(x, lm, lengths)[..., 0],
                            what + ", log-mel band 0"))
        log(f"kernel vs plain: {n_cases} cases, max abs err FFT kernel {max_err['fft']:.3e}, "
            f"DFT kernel {max_err['dft']:.3e}; log-mel band 0 of the MFCC configs "
            f"{band0_err:.3e}")
        worst = explain_worst(worst)

        # the lomgrid batch, with the sweep's sample_lengths
        cfg = dataclasses.replace(F.FeatureConfig.from_config(AUDIO_DATA_OPTS),
                                  normalize=False)
        s = int(SECONDS * RATE)
        pcm = torch.from_numpy(rng.integers(-8000, 8000, (BATCH, s), dtype=np.int16))
        pcm = (pcm.cuda().float() / 32768.0).contiguous()
        lengths = torch.full((BATCH,), s, dtype=torch.int32, device="cuda")
        cfg_cufft = dataclasses.replace(cfg, dft="fft")
        fft_k = lambda: audio_features(pcm, cfg, lengths)
        dft_k = lambda: fbank.dft_audio_features(pcm, cfg, lengths)
        plain = lambda: audio_features_reference(pcm, cfg, lengths)
        cufft = lambda: audio_features_reference(pcm, cfg_cufft, lengths)
        check(fbank.uses_fft_kernel(cfg), "the lomgrid config does not go to the FFT kernel")
        want = plain()
        what = f"lomgrid batch {BATCH}x{s}"
        err = {"fft": compare(fft_k(), want, what + ", FFT kernel"),
               "dft": compare(dft_k(), want, what + ", DFT kernel at n_fft 512"),
               "cufft": compare(cufft(), want, what + ", plain dft='fft'")}
        max_err["fft"] = max(max_err["fft"], err["fft"])
        max_err["dft"] = max(max_err["dft"], err["dft"])
        torch.cuda.synchronize()
        order = [("plain", plain), ("fft", fft_k), ("dft", dft_k), ("cufft", cufft),
                 ("fft", fft_k), ("dft", dft_k), ("cufft", cufft), ("plain", plain)]
        runs = [(name, time_ms(fn)) for name, fn in order]
        ms = {name: sum(t for n, t in runs if n == name) / 2 for name in dict(order)}

        # the configs the TPU's v2 kernel refuses and its v1 kernel serves
        # (logfbank-60): the FFT kernel, held and timed at that batch, and
        # its DC bin held against float64
        cfg_v1 = F.FeatureConfig(feat_type="logfbank", num_bin=60, normalize=False)
        got_v1 = audio_features(pcm, cfg_v1, lengths)
        v1 = {"max_abs_err": compare(got_v1, audio_features_reference(pcm, cfg_v1, lengths),
                                     what + ", logfbank-60"),
              "plain_ms": time_ms(lambda: audio_features_reference(pcm, cfg_v1, lengths)),
              "kernel_ms": time_ms(lambda: audio_features(pcm, cfg_v1, lengths))}
        dc = dc_witness(pcm, lengths, cfg_v1, got_v1)
        del got_v1
        # the DFT kernel at an n_fft it alone takes (510), at that batch
        cfg510 = dataclasses.replace(cfg, n_fft=510)
        d510 = {"max_abs_err": compare(launch_one(cfg510, pcm, lengths, what + ", n_fft 510"),
                                       audio_features_reference(pcm, cfg510, lengths),
                                       what + ", n_fft 510"),
                "plain_ms": time_ms(lambda: audio_features_reference(pcm, cfg510, lengths)),
                "kernel_ms": time_ms(lambda: audio_features(pcm, cfg510, lengths))}
    flops, nbytes = front_end_work(BATCH, s, cfg)
    fn_bound, fn_by = bound((flops, nbytes), peaks)
    algo_ms = {k: kernel_flops(BATCH, s, cfg, k) / peaks[0] * 1e3 for k in ("fft", "dft")}
    log(f"{what}, mfcc-24 (plain, FFT, DFT at 512, plain dft='fft', FFT, DFT, dft='fft', "
        f"plain: {', '.join(f'{t:.4f}' for _, t in runs)} ms): FFT kernel {ms['fft']:.4f} ms, "
        f"DFT kernel {ms['dft']:.4f} ms, against the function's bound {fn_bound:.4f} ms "
        f"({fn_by}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB): {fn_bound / ms['fft']:.1%} "
        f"and {fn_bound / ms['dft']:.1%} of it; their own algorithms' operations alone take "
        f"{algo_ms['fft']:.4f} and {algo_ms['dft']:.4f} ms; plain {ms['plain']:.4f} ms; plain "
        f"dft='fft' (cuFFT + mel/DCT products) {ms['cufft']:.4f} ms; max abs err FFT "
        f"{err['fft']:.3e}, DFT {err['dft']:.3e}, dft='fft' {err['cufft']:.3e}")
    v1["bound_ms"], v1["bound_by"] = bound(front_end_work(BATCH, s, cfg_v1), peaks)
    v1["algorithm_ops_ms"] = kernel_flops(BATCH, s, cfg_v1, "fft") / peaks[0] * 1e3
    d510["bound_ms"], d510["bound_by"] = bound(front_end_work(BATCH, s, cfg510), peaks)
    d510["algorithm_ops_ms"] = kernel_flops(BATCH, s, cfg510, "dft") / peaks[0] * 1e3
    log(f"logfbank-60 at that batch: FFT kernel {v1['kernel_ms']:.4f} ms, plain "
        f"{v1['plain_ms']:.4f} ms, bound {v1['bound_ms']:.4f} ms ({v1['bound_by']}; the "
        f"kernel's own operations {v1['algorithm_ops_ms']:.4f} ms); n_fft 510: DFT kernel "
        f"{d510['kernel_ms']:.4f} ms, plain {d510['plain_ms']:.4f} ms, bound "
        f"{d510['bound_ms']:.4f} ms ({d510['bound_by']}; the kernel's own operations "
        f"{d510['algorithm_ops_ms']:.4f} ms)")
    return {"max_abs_err": max_err, "band0_err": band0_err, "err_lomgrid": err, "ms": ms,
            "runs_ms": runs, "bound_ms": fn_bound, "bound_by": fn_by, "algorithm_ops_ms": algo_ms,
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6, "v1": v1, "dft_510": d510,
            "worst": worst, "dc_witness": dc}


# ---------------------------------------------------------------- phase 4
def flagship_config(batch_size: int) -> Config:
    return Config({"data": {"python_data_config": AUDIO_DATA_OPTS},
                   "model": ETDNN_MODEL_OPTS,
                   "train": {"loss": "LMCL"},
                   "test": {"batch_size": batch_size}})


def seeded_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Random weights from a torch.Generator: He-scaled conv/linear weights
    and BN affine parameters near (1, 0). The running statistics keep their
    defaults until :func:`calibrate_bn` sets them."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in model.state_dict().items():
        if k.endswith(("num_batches_tracked", "running_mean", "running_var")):
            out[k] = v.clone()
            continue
        z = torch.randn(v.shape, generator=g)
        if ".bn." in k or k.startswith(("bn1.", "bn2.")):
            out[k] = (1.0 + 0.1 * z) if k.endswith("weight") else 0.1 * z
        elif k.endswith("weight"):
            out[k] = z * math.sqrt(2.0 / v[0].numel())
        else:
            out[k] = 0.01 * z
    return out


@torch.no_grad()
def calibrate_bn(extractor: AudioExtractor, batch: dict, seed: int) -> None:
    """Set each BN's running statistics near the batch statistics of its
    input on one real batch, each mean shifted by 0.1 sigma and each
    variance scaled by U(0.5, 2): activations stay on a unit scale through
    the ten blocks, so embeddings differ across utterances and the 1e-4
    kernel-vs-plain embedding check is a sensitive one."""
    g = torch.Generator().manual_seed(seed)
    model, dev = extractor.model, extractor.device
    pcm, lengths, slen = (torch.from_numpy(batch[k]).to(dev)
                          for k in ("pcm", "feat_lengths", "sample_lengths"))

    def set_stats(bn, y):
        flat = y.reshape(-1, y.shape[-1])
        mean, var = flat.mean(0), flat.var(0)
        z = torch.randn(mean.shape, generator=g).to(dev)
        u = torch.rand(mean.shape, generator=g).to(dev)
        bn.running_mean.copy_(mean + 0.1 * var.sqrt() * z)
        bn.running_var.copy_(var * (0.5 + 1.5 * u))

    with fp32_math():
        x = F.extract_features(pcm.float() / 32768.0, extractor.eval_feat_cfg,
                               sample_lengths=slen)
        x = masked_cmvn(x, lengths)
        for blk in model.tdnn:
            set_stats(blk.bn, blk.context_layer(x.transpose(1, 2)).transpose(1, 2))
            x = blk(x)
        x_a = model.fc1(model.pooling(x, lengths=model.valid_lengths(lengths)))
        set_stats(model.bn1, x_a)
        xv = model.fc2(torch.nn.functional.leaky_relu(model.bn1(x_a), 0.2))
        set_stats(model.bn2, xv)


def harmonic_wave(rng, f0: float, res: float, n: int) -> np.ndarray:
    """``n`` samples of a harmonic source near pitch ``f0`` through a
    resonance at ``res`` Hz, plus noise."""
    t = np.arange(n) / RATE
    f = f0 * (1.0 + 0.03 * rng.standard_normal())
    y = sum(np.sin(2 * np.pi * h * f * t) / h
            * np.exp(-((h * f - res) / 600.0) ** 2) for h in range(1, 20))
    y = 0.3 * y / np.abs(y).max() + 0.02 * rng.standard_normal(n)
    return y.astype(np.float32)


def speaker_wave(rng, spk: int) -> np.ndarray:
    """1-3 s of a harmonic source at the speaker's pitch through the
    speaker's resonance, plus noise."""
    n = int(rng.integers(RATE, 3 * RATE + 1))
    return harmonic_wave(rng, 90.0 + 12.0 * spk, 400.0 + 150.0 * spk, n)


def write_corpus(root: str, n_spk: int = 16, per_spk: int = 16,
                 n_trials: int = 4000, seed: int = 0) -> tuple[list[str], str]:
    """Ragged 1–3 s PCM16 wavs (:func:`speaker_wave`) and a half-target
    trial list over them."""
    rng = np.random.default_rng(seed)
    names = []
    for spk in range(n_spk):
        os.makedirs(os.path.join(root, f"s{spk:02d}"), exist_ok=True)
        for u in range(per_spk):
            name = f"s{spk:02d}/u{u:02d}.wav"
            write_wav(os.path.join(root, name), speaker_wave(rng, spk), RATE)
            names.append(name)
    trial_path = os.path.join(root, "trials.txt")
    with open(trial_path, "w") as fh:
        for i in range(n_trials):
            a = int(rng.integers(len(names)))
            if i % 2 == 0:
                same = [j for j in range(len(names))
                        if names[j][:3] == names[a][:3] and j != a]
                b = int(rng.choice(same))
            else:
                b = int(rng.integers(len(names)))
            label = int(names[a][:3] == names[b][:3])
            fh.write(f"{label} {names[a]} {names[b]}\n")
    return names, trial_path


def main_path_phase() -> dict:
    cfg = flagship_config(batch_size=64)
    extractor = AudioExtractor(cfg)
    extractor.load_state_dict(seeded_state_dict(extractor.model, seed=0))
    with tempfile.TemporaryDirectory() as root:
        names, trial_path = write_corpus(root)
        utts = [EvalUtterance(n, os.path.join(root, n)) for n in names]
        eval_set = EvalUtteranceSet(utts, **eval_set_kwargs(extractor.feat_cfg, cfg.test))
        host_batches = list(eval_set.batches())
        check(eval_set._resolved_transport == "int16", "PCM16 corpus did not resolve to int16")
        calibrate_bn(extractor, host_batches[len(host_batches) // 2], seed=1)

        zero_fbank_counts()
        t0 = time.perf_counter()
        store = extractor.extract_embeddings(eval_set)
        eer, threshold = extractor.evaluate(trial_path, store)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = fbank_counts()
        launches = {"fused_fbank": counts["fft"], "fused_fbank_dft": counts["dft"]}

    check(counts == {"fft": len(host_batches), "dft": 0},
          f"front-end launches {counts} for {len(host_batches)} batches")
    check(len(store) == len(names), f"{len(store)} embeddings for {len(names)} utterances")
    emb = store.matrix(names)
    check(emb.device.type == "cuda", f"embeddings live on {emb.device}, not cuda")
    check(bool(torch.isfinite(emb).all()), "non-finite embeddings")
    norms = torch.linalg.vector_norm(emb, dim=-1)
    check(float((norms - 1).abs().max()) < 1e-4, "embeddings are not unit-norm")
    check(math.isfinite(eer) and 0.0 <= eer <= 1.0, f"EER {eer} not finite in [0, 1]")
    log(f"main path: {len(names)} utts in {len(host_batches)} batches "
        f"(shapes {sorted({b['pcm'].shape for b in host_batches})}), "
        f"{launches['fused_fbank']} front-end launches, EER {eer:.4f} "
        f"(threshold {threshold:.4f}), {wall:.2f} s wall incl. header scan and decode")

    # the same batches through the plain front-end on the card
    emb_err = feat_err = 0.0
    for batch in (host_batches[0], host_batches[-1]):
        args = [torch.from_numpy(batch[k]).cuda()
                for k in ("pcm", "feat_lengths", "sample_lengths")]
        with plain_front_end():
            e_plain = extractor.embed(*args)
        e_kernel = torch.stack([store[n] for n in batch["names"]])
        emb_err = max(emb_err, float((e_plain - e_kernel).abs().max()))
        with fp32_math():
            pcm = args[0].float() / 32768.0
            f_kernel = F.extract_features(pcm, extractor.eval_feat_cfg, sample_lengths=args[2])
            with plain_front_end():
                f_plain = F.extract_features(pcm, extractor.eval_feat_cfg,
                                             sample_lengths=args[2])
        feat_err = max(feat_err, compare(f_kernel, f_plain, f"main-path batch {tuple(pcm.shape)}"))
    check(emb_err <= EMB_TOL, f"kernel-path embeddings {emb_err:.3e} from the plain path")
    log(f"plain front-end re-embed: max abs err {emb_err:.3e} (bar {EMB_TOL}); "
        f"features {feat_err:.3e}")
    return {"launches": launches, "emb_err": emb_err, "feat_err": feat_err,
            "eer": eer, "extractor": extractor}


# ---------------------------------------------------------------- phase 5
def tdnn_flops(model, batch: int, frames: int) -> float:
    """Multiply-adds x 2 of the E-TDNN's convolutions and FC head for one
    batch of ``frames``-frame inputs (VALID convs shrink T block by block)."""
    total, t = 0.0, frames
    for blk in model.tdnn:
        conv = blk.context_layer
        t -= (conv.kernel_size[0] - 1) * conv.dilation[0]
        total += 2.0 * batch * t * conv.in_channels * conv.out_channels * conv.kernel_size[0]
    for fc in (model.fc1, model.fc2):
        total += 2.0 * batch * fc.in_features * fc.out_features
    return total


def sweep_phase(extractor: AudioExtractor) -> dict:
    rng = np.random.default_rng(1)
    s = int(SECONDS * RATE)
    pcm = torch.from_numpy(
        rng.integers(-8000, 8000, (LOMGRID_UTTS, s), dtype=np.int16)).cuda()
    pairs = torch.from_numpy(rng.integers(0, LOMGRID_UTTS, (LOMGRID_TRIALS, 2))).cuda()
    cfg = extractor.eval_feat_cfg
    t = num_frames(s, cfg.frame_len, cfg.frame_step)
    feat_lengths = torch.full((BATCH,), t, dtype=torch.int32, device="cuda")
    sample_lengths = torch.full((BATCH,), s, dtype=torch.int32, device="cuda")

    def sweep():
        embs = []
        for i in range(0, LOMGRID_UTTS, BATCH):
            x = pcm[i:i + BATCH]
            n = x.shape[0]
            embs.append(extractor.embed(x, feat_lengths[:n], sample_lengths[:n]))
        return cosine_scores(torch.cat(embs), pairs, normalize=False)

    zero_fbank_counts()
    scores = sweep()
    launches = fbank_counts()
    n_batches = -(-LOMGRID_UTTS // BATCH)
    check(launches == {"fft": n_batches, "dft": 0},
          f"front-end launches {launches} for a sweep of {n_batches} batches")
    check(bool(torch.isfinite(scores).all()), "non-finite sweep scores")
    sweep_ms = sorted(time_ms(sweep, iters=1, warmup=0) for _ in range(3))
    ms = sweep_ms[1]

    # per-batch split at one full batch
    x = pcm[:BATCH]
    with torch.no_grad(), fp32_math():
        pcm_f = x.float() / 32768.0
        feats = F.extract_features(pcm_f, cfg, sample_lengths=sample_lengths)
        front_ms = time_ms(lambda: F.extract_features(pcm_f, cfg, sample_lengths=sample_lengths),
                           iters=10)
        normed = masked_cmvn(feats, feat_lengths)
        tdnn_ms = time_ms(lambda: extractor.model.extract_embedding(normed, lengths=feat_lengths),
                          iters=10)
    tps = LOMGRID_TRIALS / (ms / 1e3)
    flops = tdnn_flops(extractor.model, BATCH, t)
    log(f"TDNN per batch: {flops / 1e9:.1f} GFLOP in {tdnn_ms:.3f} ms = "
        f"{flops / tdnn_ms / 1e9:.2f} TFLOP/s (FP32, TF32 off)")
    log(f"lomgrid sweep: {LOMGRID_UTTS} x {SECONDS:g} s, batch {BATCH}, {LOMGRID_TRIALS} "
        f"trials: {ms:.1f} ms median of 3 ({', '.join(f'{v:.1f}' for v in sweep_ms)}), "
        f"{tps:.1f} trials/s; front-end launches per sweep {launches}; per batch: "
        f"front-end (the kernel, pre-emphasis and mask inside) {front_ms:.3f} ms, TDNN "
        f"{tdnn_ms:.3f} ms")
    return {"trials_per_sec": tps, "sweep_ms": ms, "front_ms": front_ms, "tdnn_ms": tdnn_ms,
            "tdnn_gflop": flops / 1e9, "launches": launches}


# ---------------------------------------------------------------- phase 11
# conf/audio_config.yaml as a dict (the card's machine reads no YAML);
# tests/test_torch_audio_train.py holds it to the file
_FEAT = {"n_fft": 512, "normalize": True, "delta": False, "win_len": 0.025, "win_shift": 0.01}
AUDIO_CONFIG = {
    "data": {
        "frames": [200, 400],
        "train_manifest": "data/manifest/train.csv",
        "finetune_manifest": "data/manifest/finetune.csv",
        "test_root": "data/test_wav",
        "trial_grid": "database/trial_grid_v1.txt",
        "trial_lomgrid": "database/trial_lomgrid_v1.txt",
        "data_format": "python",
        "python_data_config": {
            "rate": 16000, "feat_type": "mfcc",
            "fbank": {**_FEAT, "num_bin": 24, "energy": False},
            "logfbank": {**_FEAT, "num_bin": 60, "energy": False},
            "stft": dict(_FEAT),
            "mfcc": {**_FEAT, "num_bin": 26, "energy": True, "num_cep": 24},
        },
    },
    "model": {
        "arch": "etdnn",
        "tdnn": {"input_dim": 24, "hidden_dim": [512, 512, 512, 512, 1500],
                 "context": [[-2, -1, 0, 1, 2], [-2, 0, 2], [-3, 0, 3], [0], [0]],
                 "tdnn_layers": 5, "fc_layers": 3, "embedding_dim": 512,
                 "pooling": "statistic", "attention_hidden_size": 64, "bn_first": True},
        "etdnn": {**ETDNN_MODEL_OPTS["etdnn"], "fc_layers": 3},
        "resnet": {"input_dim": 1, "hidden_dim": [64, 128, 256],
                   "residual_block_layers": [3, 3, 3], "fc_layers": 1, "embedding_dim": 256,
                   "pooling": "average"},
    },
    "train": {
        "device": "tpu", "type": "sgd", "bs": 256, "lr_decay": 0.1, "lr_decay_step": [15, 25],
        "epoch": 30, "collate": "length_varied", "compute_dtype": "bf16", "loss": "LMCL",
        "scale": 30, "margin": [0.2, 0.2], "frame_buckets": 11, "steps_per_dispatch": 1,
        "loader_workers": 8, "log_every": 20,
        "sgd": {"init_lr": 0.01, "weight_decay": 1e-05, "momentum": 0.9},
        "adam": {"init_lr": 0.01, "weight_decay": 1e-05}, "resume": None, "train_type": "None",
    },
    "test": {"train_plda": False, "eval_lomgrid": False, "eval_grid": True, "use_cos": True,
             "use_plda": False, "bucket_frames": 100, "batch_size": 64},
}
TRAIN_SPEAKERS, TRAIN_UTTS, TRAIN_EPOCHS = 128, 8, 2
# per speaker: the utterances of the trial list, written beside the 8 of
# the manifest and held out of training
TRAIN_TEST_UTTS = (8, 9)
AUDIO_STEP_LOSS_RTOL = 1e-4       # a K1 step vs a plain-front-end step, f32
# A bf16 step against the f32 step from the same state. The loss within 2e-2
# relative at most, and within BF16_LOSS_BAR, set from the readings on an
# H100 (PERF.md): sound 6.07e-5; BN statistics in bf16 1.39e-4, pooling in
# bf16 2.87e-4; the cosines in bf16 or TF32 move the loss no more than sound
# does. The gradients within BF16_GRAD_BAR of the f32 step's norm (sound
# 0.171): every planted fault reads within 10 % of sound there, so it
# catches only gross faults. The recipe itself is audited in the bf16
# forward (bf16_audit) to the bars below, and every planted fault must be
# caught.
BF16_LOSS_RTOL = 2e-2
BF16_LOSS_BAR = 1e-4
BF16_GRAD_BAR = 0.25
BF16_STAT_RTOL = 1e-4   # a BN's batch mean (in sigmas) and variance vs float64
BF16_POOL_RTOL = 1e-4   # the pooled statistics vs float64 pooling of the same input
BF16_HEAD_ATOL = 2e-6   # the cosine logits vs float64
BF16_FAULTS = ("bn_stats_bf16", "pool_bf16", "head_bf16", "head_tf32")
STEP_FRAMES = (200, 300, 400)     # the timed crop lengths
# device kernels of an audio train step by kind, first match wins: the FFT
# and DFT front-end kernels, torch's SGD (foreach kernels), cuDNN/cuBLAS
# (the convolutions and the FC head), the rest of PyTorch's own
AUDIO_KINDS = [
    ("K1 (fbank_fft_kernel.cu)", re.compile(r"fbank_(fft|features)_kernel")),
    ("optimizer (SGD)", re.compile(r"multi_tensor_apply|sgd", re.I)),
    ("cuDNN/cuBLAS", re.compile(r"cudnn|xmma|cublas|gemm|cutlass|wgrad|dgrad|fprop|conv", re.I)),
    ("other PyTorch", re.compile(r"")),
]


def training_wave(rng, spk: int) -> np.ndarray:
    """2-5 s of :func:`harmonic_wave` at one of 128 pitches and resonances
    inside the band."""
    n = int(rng.integers(2 * RATE, 5 * RATE + 1))
    return harmonic_wave(rng, 90.0 + 1.5 * spk, 400.0 + 25.0 * spk, n)


def write_train_corpus(root: str, seed: int = 0) -> tuple[str, str]:
    """128 speakers x 10 PCM16 wavs of 2-5 s: the manifest over the first 8
    of each speaker (``write_manifest``), and a half-target trial list over
    the 2 held out (``TRAIN_TEST_UTTS``). Returns the manifest's and the
    trial list's paths."""
    def speaker(spk):
        rng = np.random.default_rng((seed, spk))
        os.makedirs(os.path.join(root, f"s{spk:03d}"), exist_ok=True)
        utts = []
        for u in range(TRAIN_UTTS + len(TRAIN_TEST_UTTS)):
            path = os.path.join(root, f"s{spk:03d}", f"u{u}.wav")
            y = training_wave(rng, spk)
            write_wav(path, y, RATE)
            utts.append(Utterance(path, len(y) / RATE, RATE))
        return utts[:TRAIN_UTTS]

    with ThreadPoolExecutor(8) as pool:
        speakers = list(pool.map(speaker, range(TRAIN_SPEAKERS)))
    manifest = os.path.join(root, "manifest.csv")
    write_manifest(manifest, speakers)
    names = [f"s{spk:03d}/u{u}.wav" for spk in range(TRAIN_SPEAKERS) for u in TRAIN_TEST_UTTS]
    rng = np.random.default_rng(seed)
    trials = os.path.join(root, "trials.txt")
    with open(trials, "w") as fh:
        for i in range(4000):
            a = int(rng.integers(len(names)))
            b = a ^ 1 if i % 2 == 0 else int(rng.integers(len(names)))
            fh.write(f"{int(names[a][:4] == names[b][:4])} {names[a]} {names[b]}\n")
    return manifest, trials


def audio_train_config(root: str, manifest: str, trials: str) -> str:
    """``conf/audio_config.yaml`` with its manifest and trial list in
    ``root`` and ``TRAIN_EPOCHS`` epochs, written as JSON; returns its path."""
    cfg = copy.deepcopy(AUDIO_CONFIG)
    cfg["data"].update(train_manifest=manifest, test_root=root, trial_grid=trials)
    cfg["train"]["epoch"] = TRAIN_EPOCHS
    path = os.path.join(root, "audio_config.json")
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    return path


def k1_training_shapes(trainer, peaks) -> list:
    """K1 against its plain version on the training epochs' own batches (raw
    f32 PCM, CMVN after both, as the train step applies it), and K1's time
    and bound at each crop shape."""
    cfg, rows = trainer.feat_cfg, {}
    # every batch assembled first: the pipeline's threads would compete with
    # the timed launches for the host
    batches = [b for e in range(1, TRAIN_EPOCHS + 1) for b in trainer.pipeline.epoch(e)]
    for batch in batches:
        x = torch.from_numpy(batch["pcm"]).to(trainer.device).float() / 32768.0
        with torch.no_grad(), fp32_math():
            got = F.cmvn(audio_features(x, cfg))
            want = F.cmvn(audio_features_reference(x, cfg))
            err = compare(got, want, f"K1 at training crop {tuple(x.shape)}")
            row = rows.get(x.shape[1])
            if row is None:
                ms = time_ms(lambda: audio_features(x, cfg), iters=20)
                b_ms, by = bound(front_end_work(*x.shape, cfg), peaks)
                row = rows[x.shape[1]] = {"shape": list(x.shape), "n_frames": batch["n_frames"],
                                          "batches": 0, "max_abs_err": 0.0, "ms": ms,
                                          "bound_ms": b_ms, "bound_by": by}
        row["batches"] += 1
        row["max_abs_err"] = max(row["max_abs_err"], err)
    return sorted(rows.values(), key=lambda r: r["n_frames"])


def _unit64(x: torch.Tensor) -> torch.Tensor:
    x = x.detach().double()
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


@contextlib.contextmanager
def bf16_audit(model, criterion, record: dict):
    """Hold a bf16 forward to the recipe, filling ``record`` with the worst
    reading of each rule: every conv block computes in bf16
    (``blocks_bf16``); every BN takes its batch statistics in >= f32
    (``stat_err``: against float64 statistics of its input, the mean in
    units of the standard deviation, the variance relative, both with the
    BN's eps); the pooled statistics are >= f32 (``pool_err``: against the
    same pooling in float64, relative to its largest value); the cosine
    logits are FP32 (``head_err``: against float64)."""
    record.update(blocks_bf16=True, stat_err=0.0, pool_err=0.0, head_err=0.0)
    inputs: dict = {}

    def block_out(mod, args, out):
        record["blocks_bf16"] &= out.dtype == torch.bfloat16

    def bn_in(mod, args):
        inputs[mod] = args[0].detach()

    def pool_out(mod, args, kwargs, out):
        want = type(mod).forward(mod, args[0].detach().double(), kwargs.get("lengths"))
        err = float((out.detach().double() - want).abs().max() / want.abs().max())
        record["pool_err"] = max(record["pool_err"], err)

    def head_out(mod, args, kwargs, out):
        emb = args[0] if args else kwargs["embeddings"]
        want = _unit64(emb) @ _unit64(mod.weights).T
        record["head_err"] = max(record["head_err"],
                                 float((out[1].detach().double() - want).abs().max()))

    update = TorchBatchNorm.update_running

    def audited_update(self, mean, var, n):
        x = inputs.pop(self).double()
        x = x.reshape(-1, x.shape[-1])
        m, v = x.mean(0), x.var(0, unbiased=False)
        sd = (v + self.eps).sqrt()
        err = max(float(((mean.detach().double() - m).abs() / sd).max()),
                  float(((var.detach().double() - v).abs() / sd ** 2).max()))
        record["stat_err"] = max(record["stat_err"], err)
        return update(self, mean, var, n)

    hooks = [blk.register_forward_hook(block_out) for blk in model.tdnn]
    hooks += [m.register_forward_pre_hook(bn_in) for m in model.modules()
              if isinstance(m, TorchBatchNorm)]
    hooks.append(model.pooling.register_forward_hook(pool_out, with_kwargs=True))
    hooks.append(criterion.register_forward_hook(head_out, with_kwargs=True))
    TorchBatchNorm.update_running = audited_update
    try:
        yield record
    finally:
        TorchBatchNorm.update_running = update
        for h in hooks:
            h.remove()


def bf16_audit_failures(record: dict) -> list:
    """The rules of :func:`bf16_audit` that ``record`` breaks."""
    return [name for name, hit in (
        ("blocks_bf16", not record["blocks_bf16"]),
        ("stat_err", record["stat_err"] > BF16_STAT_RTOL),
        ("pool_err", record["pool_err"] > BF16_POOL_RTOL),
        ("head_err", record["head_err"] > BF16_HEAD_ATOL)) if hit]


def _bn_stats_in_bf16(self, x):
    """TorchBatchNorm's forward with a bf16 input's statistics taken in bf16."""
    if not (self.training and x.dtype == torch.bfloat16):
        return _bn_forward(self, x)
    red = tuple(range(x.ndim - 1))
    mean = x.mean(red)
    var = ((x - mean) ** 2).mean(red)
    self.update_running(mean.float(), var.float(), x.numel() // x.shape[-1])
    y = (x - mean) * torch.rsqrt(var.float() + self.eps).to(x.dtype)
    return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)


_bn_forward = TorchBatchNorm.forward


@contextlib.contextmanager
def planted_bf16_fault(fault: str, model):
    """One way for the bf16 recipe to go wrong, for the bf16 bars to catch:
    BN statistics taken in bf16, statistics pooling in bf16, or the cosine
    logits in bf16 or in TF32."""
    cosines = softmax_losses._CosineHead.cosines

    def tf32_cosines(self, emb):
        matmul = torch.backends.cuda.matmul
        saved, matmul.allow_tf32 = matmul.allow_tf32, True
        try:
            return cosines(self, emb)
        finally:
            matmul.allow_tf32 = saved

    def bf16_cosines(self, emb):
        return torch.matmul(softmax_losses._unit(emb).bfloat16(),
                            softmax_losses._unit(self.weights).bfloat16().T).float()

    pool = model.pooling.forward
    if fault == "bn_stats_bf16":
        TorchBatchNorm.forward = _bn_stats_in_bf16
    elif fault == "pool_bf16":
        model.pooling.forward = lambda x, lengths=None: pool(x.bfloat16(), lengths).float()
    elif fault in ("head_bf16", "head_tf32"):
        softmax_losses._CosineHead.cosines = (bf16_cosines if fault == "head_bf16"
                                              else tf32_cosines)
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        TorchBatchNorm.forward = _bn_forward
        softmax_losses._CosineHead.cosines = cosines
        model.pooling.__dict__.pop("forward", None)


def audio_step_phase(trainer, smi: str, peaks) -> dict:
    """A K1 step against a plain-front-end step and a bf16 step from one
    state; then ms per step at bs 256 x ``STEP_FRAMES``, in bf16 and f32,
    K1's share, peak memory and one profiled bf16 step."""
    cfg, margin, dev = trainer.feat_cfg, trainer.init_margin, trainer.device
    configured = trainer.compute_dtype
    sids = next(trainer.pipeline.sampler.epoch(1))[0]
    batches = {n: trainer.pipeline._assemble(sids, n, (7, n)) for n in STEP_FRAMES}
    labels = torch.from_numpy(batches[300]["labels"]).to(dev)
    params = [(f"model.{n}", p) for n, p in trainer.model.named_parameters()] + [
        (f"criterion.{n}", p) for n, p in trainer.criterion.named_parameters()]
    state = (copy.deepcopy(trainer.model.state_dict()),
             copy.deepcopy(trainer.criterion.state_dict()),
             copy.deepcopy(trainer.optimizer.state_dict()), trainer.step)

    def restore():
        trainer.model.load_state_dict(state[0])
        trainer.criterion.load_state_dict(state[1])
        trainer.optimizer.load_state_dict(state[2])
        trainer.step = state[3]
        trainer.compute_dtype = configured

    def step(pcm, dtype):
        """One step from ``state``: its loss and gradients; the state is
        restored after it."""
        trainer.compute_dtype = dtype
        loss = float(trainer.train_step(pcm, labels, margin)["loss"])
        grads = {n: p.grad.detach().clone() for n, p in params}
        restore()
        return loss, grads

    pcm = torch.from_numpy(batches[300]["pcm"]).to(dev).float() / 32768.0
    # an elementwise relative nudge: a common scale of the PCM would vanish
    # in the log-mel's CMVN
    gen = torch.Generator(device=dev).manual_seed(3)
    nudged = pcm * (1.0 + NUDGE * torch.randn(pcm.shape, generator=gen, device=dev))
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        zero_fbank_counts()
        loss_k, grads_k = step(pcm, None)
        check(fbank_counts() == {"fft": 1, "dft": 0},
              f"a kernel step launched {fbank_counts()}: one FFT-kernel launch expected")
        with plain_front_end():
            loss_p, grads_p = step(pcm, None)
            loss_n, grads_n = step(nudged, None)
        check(fbank_counts() == {"fft": 1, "dft": 0}, "the plain steps launched a kernel")
        audit: dict = {}
        with bf16_audit(trainer.model, trainer.criterion, audit):
            loss_b, grads_b = step(pcm, torch.bfloat16)
        planted = {}
        for fault in BF16_FAULTS:
            record: dict = {}
            with planted_bf16_fault(fault, trainer.model), \
                    bf16_audit(trainer.model, trainer.criterion, record):
                loss_f, grads_f = step(pcm, torch.bfloat16)
            rel = abs(loss_f - loss_k) / abs(loss_k)
            planted[fault] = {"loss_rel": rel, "grad_distance": grad_distance(grads_f, grads_k),
                              "audit": record, "caught_by": bf16_audit_failures(record)
                              + (["loss"] if rel > BF16_LOSS_BAR else [])}
            del grads_f
    loss_rel, bf16_rel = abs(loss_k - loss_p) / abs(loss_p), abs(loss_b - loss_k) / abs(loss_k)
    d_kp, d_np = grad_distance(grads_k, grads_p), grad_distance(grads_n, grads_p)
    d_bf16 = grad_distance(grads_b, grads_k)
    worst = {k: worst_tensor(g, grads_p) for k, g in (("kernel", grads_k), ("nudge", grads_n))}
    del grads_k, grads_p, grads_n, grads_b
    log(f"audio step, K1 vs plain front-end at bs {BATCH} x 300 (f32, TF32 off, cuDNN "
        f"deterministic): loss {loss_k:.8f} vs {loss_p:.8f} ({loss_rel:.2e} relative, bar "
        f"{AUDIO_STEP_LOSS_RTOL}; nudged PCM {loss_n:.8f}); gradient distance from the plain "
        f"step: K1 {d_kp:.3e}, plain with the PCM nudged by {NUDGE} {d_np:.3e} (ratio "
        f"{d_kp / d_np:.2f}, bar {NUDGE_FACTOR}); worst tensor, of its plain largest: "
        + ", ".join(f"{k} {v:.2e} ({n})" for k, (v, n) in worst.items())
        + f"; bf16 step loss {loss_b:.6f}, {bf16_rel:.2e} from the f32 step (bars "
        f"{BF16_LOSS_BAR} and {BF16_LOSS_RTOL}), gradient distance {d_bf16:.3e} (bar "
        f"{BF16_GRAD_BAR}), audit "
        + json.dumps(audit))
    for fault, r in planted.items():
        log(f"  planted bf16 fault {fault}: loss {r['loss_rel']:.2e} from the f32 step, "
            f"gradient distance {r['grad_distance']:.3e}, audit {json.dumps(r['audit'])}; "
            f"caught by {r['caught_by']}")
    check(loss_rel <= AUDIO_STEP_LOSS_RTOL, f"K1-step loss {loss_k} vs plain {loss_p}: "
          f"{loss_rel:.3e} relative, bar {AUDIO_STEP_LOSS_RTOL}")
    check(d_kp <= NUDGE_FACTOR * d_np, f"K1-step gradients {d_kp:.3e} of the plain norm from "
          f"the plain step; a {NUDGE} nudge of the PCM moves them {d_np:.3e}; bar "
          f"{NUDGE_FACTOR} x that")
    check(bf16_rel <= min(BF16_LOSS_RTOL, BF16_LOSS_BAR), f"bf16 step loss {loss_b} vs f32 "
          f"{loss_k}: {bf16_rel:.3e} relative, bar {min(BF16_LOSS_RTOL, BF16_LOSS_BAR)}")
    check(d_bf16 <= BF16_GRAD_BAR, f"bf16 step gradients {d_bf16:.3e} of the f32 norm from "
          f"the f32 step, bar {BF16_GRAD_BAR}")
    check(not bf16_audit_failures(audit), f"the bf16 step breaks its recipe: {audit}")
    check(all(r["caught_by"] for r in planted.values()),
          "planted bf16 faults passed every bar: "
          + ", ".join(f for f, r in planted.items() if not r["caught_by"]))

    rows = []
    torch.cuda.reset_peak_memory_stats()
    for n in STEP_FRAMES:
        pcm16 = torch.from_numpy(batches[n]["pcm"]).to(dev)
        x = pcm16.float() / 32768.0
        k1_ms = time_ms(lambda: audio_features(x, cfg), iters=20)
        k1_bound, by = bound(front_end_work(*x.shape, cfg), peaks)
        for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
            trainer.compute_dtype = dtype
            ms = time_ms(lambda: trainer.train_step(pcm16, labels, margin), iters=5, warmup=2)
            rows.append({"n_frames": n, "dtype": name, "step_ms": ms,
                         "crops_per_sec": BATCH / ms * 1e3, "k1_ms": k1_ms,
                         "k1_share": k1_ms / ms, "k1_bound_ms": k1_bound, "k1_bound_by": by})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for r in rows:
        log(f"audio train step, bs {BATCH} x {r['n_frames']} {r['dtype']}: {r['step_ms']:.2f} "
            f"ms, {r['crops_per_sec']:.1f} crops/s; K1 {r['k1_ms']:.4f} ms = {r['k1_share']:.2%} "
            f"of the step (the function's bound {r['k1_bound_ms']:.4f} ms, {r['k1_bound_by']}) "
            f"[{smi}]")
    log(f"audio train steps: peak {peak_gb:.2f} GB allocated [{smi}]")

    trainer.compute_dtype = torch.bfloat16
    pcm16 = torch.from_numpy(batches[300]["pcm"]).to(dev)
    trainer.train_step(pcm16, labels, margin)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        trainer.train_step(pcm16, labels, margin)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    kernels, kinds = {}, {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us / 1e3
            kind = next(k for k, pat in AUDIO_KINDS if pat.search(ev.key))
            kinds[kind] = kinds.get(kind, 0.0) + dev_us / 1e3
    # the operators that launched them, by their own kernels' device time
    ops = sorted(((ev.self_device_time_total / 1e3, ev.key, ev.count)
                  for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CPU
                  and (getattr(ev, "self_device_time_total", 0) or 0) > 0),
                 key=lambda t: -t[0])[:12]
    busy = sum(kernels.values())
    restore()
    if busy > 0:
        log(f"profiled bf16 audio step at bs {BATCH} x 300: {prof_wall:.2f} ms wall, "
            f"{busy:.2f} ms of device kernels ({busy / prof_wall:.1%} busy, "
            f"{1 - busy / prof_wall:.1%} idle); by kind: " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]))
            + f" [{smi}]")
        log("  top kernels:")
        for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
            log(f"  {ms:9.3f} ms  {name[:150]}")
        log("  top operators (their own kernels' device time, calls):")
        for ms, name, count in ops:
            log(f"  {ms:9.3f} ms  {name} x{count}")
    else:
        log("profiled audio step: the profiler saw no device time (not measured)")
    return {"loss_rel": loss_rel, "grad_distance": d_kp, "nudge_distance": d_np,
            "bf16_loss_rel": bf16_rel, "bf16_grad_distance": d_bf16, "bf16_audit": audit,
            "bf16_planted": planted, "step_losses": {"kernel": loss_k, "plain": loss_p,
                                                       "nudged": loss_n, "bf16": loss_b},
            "worst_tensor": {k: list(v) for k, v in worst.items()}, "timings": rows,
            "peak_gb": peak_gb, "profiled_wall_ms": prof_wall, "profiled_busy_ms": busy,
            "profiled_by_kind_ms": kinds,
            "profiled_top_ops_ms": [[name, ms, count] for ms, name, count in ops]}


def audio_train_phase(smi: str, peaks) -> dict:
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        manifest, trials = write_train_corpus(root)
        corpus_s = time.perf_counter() - t0
        cfg_path = audio_train_config(root, manifest, trials)
        zero_fbank_counts()
        t0 = time.perf_counter()
        trainer, out = train_audio_cli.main(["--config", cfg_path, "--mode", "train",
                                             "--exp-root", os.path.join(root, "exp"),
                                             "--log-time", "run"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = fbank_counts()
        eval_set = EvalUtteranceSet(utterances_from_trials(trials, root),
                                    **eval_set_kwargs(trainer.feat_cfg, trainer.test_opts))
        n_eval = sum(1 for _ in eval_set.batches())
        steps, bpe = trainer.step, trainer.pipeline.batches_per_epoch()
        lengths = [n for e in range(1, TRAIN_EPOCHS + 1)
                   for _, n in trainer.pipeline.sampler.epoch(e)]
        check(trainer.compute_dtype == torch.bfloat16 and trainer.batch_size == BATCH
              and len(trainer.pipeline.sampler.buckets) == 11
              and trainer.pipeline._resolve_transport() == "int16",
              "the trainer did not take conf/audio_config.yaml's recipe")
        check(steps == TRAIN_EPOCHS * bpe, f"{steps} steps for {TRAIN_EPOCHS} x {bpe} batches")
        check(counts == {"fft": steps + n_eval, "dft": 0},
              f"front-end launches {counts} for {steps} train steps and {n_eval} extraction "
              "batches")
        losses = out["losses"]
        check(len(losses) == steps and all(math.isfinite(v) for v in losses),
              f"train losses {losses}")
        for tag in [f"net_{e}" for e in range(1, TRAIN_EPOCHS + 1)] + ["net_avg"]:
            check(os.path.exists(os.path.join(trainer.exp_dir, tag)), f"no {tag} written")
        check(math.isfinite(out["eer"]) and 0.0 <= out["eer"] <= 1.0, f"EER {out['eer']}")
        log(f"audio training through cli/train_audio.py (conf/audio_config.yaml: flagship "
            f"E-TDNN, LMCL, SGD, bf16, bs {BATCH}): {TRAIN_SPEAKERS} speakers x {TRAIN_UTTS} "
            f"training wavs (and {len(TRAIN_TEST_UTTS)} held out for the trial list) written "
            f"in {corpus_s:.1f} s; {TRAIN_EPOCHS} epochs x {bpe} steps, crop "
            f"lengths {lengths}, losses {', '.join(f'{v:.4f}' for v in losses)}; averaged "
            f"net_1..net_{TRAIN_EPOCHS} into net_avg; {n_eval} extraction batches; EER "
            f"{out['eer']:.4f} (held-out utterances); front-end launches {counts}; "
            f"{wall:.1f} s wall [{smi}]")
        shapes = k1_training_shapes(trainer, peaks)
        log("K1 at the training crop shapes (CMVN after, atol 2e-4 / rtol 1e-3): " + ", ".join(
            f"{r['shape']} x{r['batches']}: err {r['max_abs_err']:.2e}, {r['ms']:.4f} ms "
            f"(bound {r['bound_ms']:.4f}, {r['bound_by']})" for r in shapes) + f" [{smi}]")
        step = audio_step_phase(trainer, smi, peaks)
    return {"launches": counts, "steps": steps, "batches_per_epoch": bpe,
            "extraction_batches": n_eval, "crop_lengths": lengths, "losses": losses,
            "eer": out["eer"], "wall_s": wall, "k1_shapes": shapes, **step}


# ---------------------------------------------------------------- phase 6
def bn_site_shapes(b: int, t: int) -> list:
    """(shape, sites per train step) of the nine BN+PReLU sites of a
    Lipreading step on a (b, t)-frame batch at the 88x88 crop: the frontend,
    then two bn1 sites per trunk stage (time folded into the batch)."""
    n = b * t
    return [((b, t, 44, 44, 64), 1), ((n, 22, 22, 64), 2), ((n, 11, 11, 128), 2),
            ((n, 6, 6, 256), 2), ((n, 3, 3, 512), 2)]


BN_SHAPES = bn_site_shapes(128, 29)
BN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-2)}  # y, dx: atol, rtol
STAT_TOL = (1e-5, 1e-5)          # mean, var in both types: f32 statistics
PARAM_GRAD_RTOL = 1e-4           # dscale, dbias, dalpha vs the plain largest
# flops per element, counted from the kernels' arithmetic: forward 3 for the
# sums + 6 to apply; backward 11 for the sums + 11 to apply
BN_FLOPS = {"fwd": 9, "bwd": 22}
BN_BYTES = {"fwd": 3, "bwd": 5}  # |x| multiples: the least traffic for exact batch statistics


def compare_tol(got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float,
                what: str) -> float:
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite kernel output")
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} elements outside atol {atol} / "
          f"rtol {rtol}, max abs err {float(err.max()):.3e}")
    return float(err.max())


def bn_bound_ms(n: int, itemsize: int, peaks, kind: str) -> tuple[float, str]:
    fp32, _, bw = peaks
    bytes_ms = BN_BYTES[kind] * n * itemsize / bw * 1e3
    ops_ms = BN_FLOPS[kind] * n / fp32 * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def library_bn_prelu_ms(x, dy, scale, bias, alpha, eps) -> dict:
    """The library yardstick: ``F.batch_norm(training=True)`` then
    ``F.prelu`` (two calls; no single PyTorch call fuses them) on the
    channels-last activation, and their autograd backward."""
    lib_x = x.movedim(-1, 1).detach().requires_grad_(True)
    lib_p = [t.detach().clone().requires_grad_(True) for t in (scale, bias, alpha)]

    def fwd():
        z = torch.nn.functional.batch_norm(lib_x, None, None, lib_p[0], lib_p[1], True, 0.1, eps)
        return torch.nn.functional.prelu(z, lib_p[2])

    out, dy_nc = fwd(), dy.movedim(-1, 1)
    return {"fwd_library": time_ms(fwd),
            "bwd_library": time_ms(lambda: torch.autograd.grad(
                out, [lib_x, *lib_p], dy_nc, retain_graph=True))}


def bn_inputs(shape, dtype, seed: int):
    """Seeded ``(x, dy, scale, bias, alpha)`` on the card: conv outputs
    shifted by 1.5 sigma (the single-pass variance's cancellation case the
    JAX package guards), scale in [0.5, 1.5), alpha 0.25."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=g, device="cuda") + 1.5).to(dtype)
    dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
    scale = 0.5 + torch.rand(c, generator=g, device="cuda")
    bias = 0.3 * torch.randn(c, generator=g, device="cuda")
    return x, dy, scale, bias, torch.full((c,), 0.25, device="cuda")


def bn_prelu_check(x, dy, scale, bias, alpha, eps: float, what: str):
    """K3 and K4 against their plain versions on one input, and K3's
    statistics bit-equal on a rerun. Returns the errors and the forward's
    ``(mean, inv)``."""
    atol, rtol = BN_TOL[x.dtype]
    y, mean, var, inv = bn_prelu.bn_prelu_forward(x, scale, bias, alpha, eps)
    y_p, mean_p, var_p = bn_prelu.bn_prelu_reference(x, scale, bias, alpha, eps)
    err = {"y": compare_tol(y, y_p, atol, rtol, what + " y"),
           "mean": compare_tol(mean, mean_p, *STAT_TOL, what + " mean"),
           "var": compare_tol(var, var_p, *STAT_TOL, what + " var")}
    again = bn_prelu.bn_prelu_forward(x, scale, bias, alpha, eps)
    check(torch.equal(again[1], mean) and torch.equal(again[2], var)
          and torch.equal(again[0], y), f"{what}: statistics not bit-equal on a rerun")
    del y, y_p, again
    grads = bn_prelu.bn_prelu_backward(x, dy, mean, inv, scale, bias, alpha)
    grads_p = bn_prelu.bn_prelu_backward_reference(x, dy, mean, inv, scale, bias, alpha)
    err["dx"] = compare_tol(grads[0], grads_p[0], atol, rtol, what + " dx")
    for name, got, want in zip(("dscale", "dbias", "dalpha"), grads[1:], grads_p[1:]):
        big = float(want.abs().max())
        rel = float((got - want).abs().max()) / big
        check(rel <= PARAM_GRAD_RTOL, f"{what} {name}: {rel:.3e} of the plain "
              f"largest ({big:.3e}), bar {PARAM_GRAD_RTOL}")
        err[name] = rel
    return err, (mean, inv)


def bn_prelu_phase(peaks) -> dict:
    rows, eps = [], 1e-5
    with fp32_math():
        for i, (shape, sites) in enumerate(BN_SHAPES):
            for dtype in (torch.float32, torch.bfloat16):
                x, dy, scale, bias, alpha = bn_inputs(shape, dtype, 100 + i)
                what = f"bn_prelu {shape} {str(dtype)[6:]}"
                err, (mean, inv) = bn_prelu_check(x, dy, scale, bias, alpha, eps, what)

                times = {
                    "fwd": time_ms(lambda: bn_prelu.bn_prelu_forward(x, scale, bias, alpha, eps)),
                    "fwd_plain": time_ms(lambda: bn_prelu.bn_prelu_reference(
                        x, scale, bias, alpha, eps), iters=5),
                    "bwd": time_ms(lambda: bn_prelu.bn_prelu_backward(
                        x, dy, mean, inv, scale, bias, alpha)),
                    "bwd_plain": time_ms(lambda: bn_prelu.bn_prelu_backward_reference(
                        x, dy, mean, inv, scale, bias, alpha), iters=5),
                }
                if dtype == torch.float32:
                    times.update(library_bn_prelu_ms(x, dy, scale, bias, alpha, eps))
                del x, dy
                torch.cuda.empty_cache()
                n = math.prod(shape)
                for kind in ("fwd", "bwd"):
                    times[f"{kind}_bound"], times[f"{kind}_bound_by"] = bn_bound_ms(
                        n, dtype.itemsize, peaks, kind)
                row = {"shape": list(shape), "dtype": str(dtype)[6:], "sites": sites,
                       **{f"err_{k}": v for k, v in err.items()}, **times}
                rows.append(row)
                log(f"{what}: errs " + ", ".join(f"{k} {v:.2e}" for k, v in err.items())
                    + "; ms " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()
                                          if not k.endswith("_by")))
    f32 = [r for r in rows if r["dtype"] == "float32"]
    per_step = {k: sum(r["sites"] * r[k] for r in f32) for k in (
        "fwd", "fwd_plain", "fwd_library", "fwd_bound", "bwd", "bwd_plain", "bwd_library",
        "bwd_bound")}
    log("bn_prelu per bs 128 x 29 train step (9 sites, f32): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in per_step.items()))
    return {"rows": rows, "per_step": per_step}


# ---------------------------------------------------------------- max-pool
# (shape, what): the training step's frontend activation, one serving chunk
# (16 items x 2 clips x 32 frames), an odd-sized frame, and a batch whose
# pad frames are one constant per channel (every window of them ties)
POOL_SHAPES = [((128, 29, 44, 44, 64), "train step"), ((32, 32, 44, 44, 64), "serving chunk"),
               ((3, 5, 43, 45, 8), "odd sizes"), ((8, 29, 44, 44, 64), "tied pad frames")]
POOL_DX_RTOL = 1e-6                      # f32 dx, of the plain version's largest
POOL_DX_BF16 = (1e-6, 2.0 ** -7)         # bf16 dx: atol, rtol (one bf16 step)


def pool_inputs(shape, what: str, dtype, seed: int):
    """Seeded ``(x, dy)`` on the card: PReLU-like outputs centred below zero
    (so a zero-padded pool would be wrong), values rounded to a grid of 1/8
    so that windows hold repeated maxima; for the tied case, frames past
    each row's length are one constant per channel."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda") - 0.5
    x = torch.where(torch.rand(shape, generator=g, device="cuda") < 0.5,
                    torch.round(x * 8) / 8, x)
    if what == "tied pad frames":
        lengths = torch.randint(12, shape[1], (shape[0],), generator=g, device="cuda")
        pad = torch.arange(shape[1], device="cuda")[None, :] >= lengths[:, None]
        const = torch.randn(shape[-1], generator=g, device="cuda")
        x = torch.where(pad[:, :, None, None, None], const.expand(shape), x)
    n, t, h, w, c = shape
    dy = torch.randn((n, t, maxpool.pooled_size(h), maxpool.pooled_size(w), c),
                     generator=g, device="cuda")
    return x.to(dtype).contiguous(), dy.to(dtype)


def pool_plain_backward(x: torch.Tensor, dy: torch.Tensor):
    """The plain version's ``(y, dx)`` through autograd. For bf16 it works
    in f32 and rounds once, as the kernel does and as the other plain
    versions do: autograd in bf16 rounds after each of a pixel's up to four
    additions."""
    xr = x.detach().float().requires_grad_(True)
    y = maxpool.maxpool_frontend_reference(xr)
    (dx,) = torch.autograd.grad(y, xr, dy.float())
    return y.detach().to(x.dtype), dx.to(x.dtype)


def pool_check(x: torch.Tensor, dy: torch.Tensor, what: str) -> float:
    """Forward bit-equal (with and without the saved positions), backward
    within its bar, the autograd op equal to the two wrappers. Returns the
    backward's largest error."""
    y, pos = maxpool.maxpool_forward(x, with_pos=True)
    y_only, none = maxpool.maxpool_forward(x)
    y_p, dx_p = pool_plain_backward(x, dy)
    check(none is None and torch.equal(y, y_only), f"{what}: y differs with the positions saved")
    check(y.shape == y_p.shape and torch.equal(y, y_p), f"{what}: y is not bit-equal to "
          f"F.max_pool3d ({int((y != y_p).sum())} elements differ)")
    dx = maxpool.maxpool_backward(dy, pos, x.shape)
    if x.dtype == torch.float32:
        big = float(dx_p.abs().max())
        err = float((dx - dx_p).abs().max())
        check(err <= POOL_DX_RTOL * big, f"{what}: dx {err:.3e} from the plain version's, "
              f"bar {POOL_DX_RTOL} of its largest ({big:.3e})")
    else:
        err = compare_tol(dx, dx_p, *POOL_DX_BF16, what + " dx")
    xr = x.detach().clone().requires_grad_(True)
    y_op = maxpool.maxpool_frontend(xr)
    (dx_op,) = torch.autograd.grad(y_op, xr, dy)
    check(torch.equal(y_op, y) and torch.equal(dx_op, dx), f"{what}: the autograd op differs "
          "from its two kernels")
    return err


def pool_nan_check() -> None:
    """A NaN tap is the window's maximum, as in ``F.max_pool3d``."""
    x, dy = pool_inputs((2, 3, 12, 12, 8), "nan", torch.float32, 7)
    x[0, 1, 5, 5, 3] = float("nan")
    x[1, 2, 0, 11, 0] = float("nan")
    y, _ = maxpool.maxpool_forward(x)
    y_p = maxpool.maxpool_frontend_reference(x)
    check(int(torch.isnan(y_p).sum()) >= 3, "the plain pool dropped the planted NaN")
    check(torch.equal(torch.isnan(y), torch.isnan(y_p))
          and torch.equal(torch.nan_to_num(y), torch.nan_to_num(y_p)),
          "the max-pool kernel does not propagate NaN as F.max_pool3d does")


def pool_bounds_ms(shape, itemsize: int, peaks) -> dict:
    """Least times for the bytes each pass must move: forward x in and y
    out (plus one byte per output element when the positions are saved);
    backward dy and the positions in and dx out. Nine compares per output
    element never bound it."""
    fp32, _, bw = peaks
    n_in = math.prod(shape)
    n_out = n_in // (shape[2] * shape[3]) * maxpool.pooled_size(shape[2]) * maxpool.pooled_size(shape[3])
    ops_ms = 9 * n_out / fp32 * 1e3
    out = {"fwd_bound": (n_in + n_out) * itemsize / bw * 1e3,
           "fwd_pos_bound": ((n_in + n_out) * itemsize + n_out) / bw * 1e3,
           "bwd_bound": ((n_in + n_out) * itemsize + n_out) / bw * 1e3}
    check(all(v >= ops_ms for v in out.values()), "the max-pool bound is not the bytes'")
    return out


def maxpool_phase(peaks) -> dict:
    pool_nan_check()
    rows = []
    for i, (shape, what) in enumerate(POOL_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            x, dy = pool_inputs(shape, what, dtype, 300 + i)
            label = f"maxpool {shape} {str(dtype)[6:]} ({what})"
            err = pool_check(x, dy, label)
            times = {}
            if what in ("train step", "serving chunk"):
                _, pos = maxpool.maxpool_forward(x, with_pos=True)
                xr = x.detach().clone().requires_grad_(True)
                y_p = maxpool.maxpool_frontend_reference(xr)
                x_ncdhw = x.movedim(-1, 1).contiguous()
                pool = lambda t: torch.nn.functional.max_pool3d(t, (1, 3, 3), (1, 2, 2), (0, 1, 1))
                times = {
                    "fwd": time_ms(lambda: maxpool.maxpool_forward(x)),
                    "fwd_pos": time_ms(lambda: maxpool.maxpool_forward(x, with_pos=True)),
                    # the plain version is the library call on the channels-last view
                    "fwd_plain": time_ms(lambda: maxpool.maxpool_frontend_reference(x)),
                    "fwd_library_contiguous": time_ms(lambda: pool(x_ncdhw)),
                    "bwd": time_ms(lambda: maxpool.maxpool_backward(dy, pos, x.shape)),
                    "bwd_plain": time_ms(lambda: torch.autograd.grad(
                        y_p, xr, dy, retain_graph=True)),
                }
                del pos, xr, y_p, x_ncdhw
                times.update(pool_bounds_ms(shape, dtype.itemsize, peaks))
            del x, dy
            torch.cuda.empty_cache()
            rows.append({"shape": list(shape), "dtype": str(dtype)[6:], "what": what,
                         "err_dx": err, **times})
            log(f"{label}: y bit-equal, dx err {err:.2e}"
                + ("; ms " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()) if times else ""))
    return {"rows": rows}


# ---------------------------------------------------------------- phase 7
VIDEO_SPEAKERS, VIDEO_CLIPS, VIDEO_BATCH = 32, 8, 128


def video_config() -> dict:
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "conf", "video_config.json")) as fh:
        return json.load(fh)


def speaker_clip(rng, spk: int, t: int) -> np.ndarray:
    """``(t, 96, 96)`` uint8: a grating at the speaker's spatial frequency
    and orientation that drifts at the speaker's rate, plus noise."""
    yy, xx = np.mgrid[0:96, 0:96].astype(np.float32) / 96.0
    freq, theta, rate = 2.0 + 0.25 * spk, np.pi * spk / VIDEO_SPEAKERS, 0.05 + 0.01 * spk
    plane = freq * (np.cos(theta) * xx + np.sin(theta) * yy)
    phase = rate * np.arange(t, dtype=np.float32)[:, None, None] + rng.random()
    frames = 128 + 80 * np.sin(2 * np.pi * (plane[None] + phase))
    frames += rng.normal(0, 12, frames.shape)
    return np.clip(frames, 0, 255).astype(np.uint8)


def write_clip_corpus(root: str, seed: int = 0) -> None:
    """32 speakers x 8 clips of 21-29 frames (:func:`speaker_clip`)."""
    rng = np.random.default_rng(seed)
    for spk in range(VIDEO_SPEAKERS):
        os.makedirs(os.path.join(root, f"s{spk:02d}"), exist_ok=True)
        for c in range(VIDEO_CLIPS):
            np.savez(os.path.join(root, f"s{spk:02d}", f"c{c}.npz"),
                     data=speaker_clip(rng, spk, int(rng.integers(21, 30))))


def full_clip_batch(clips) -> dict:
    """One bs 128 x 29-frame batch of the corpus: four clips of each
    speaker, zero-padded to 29 frames, with their lengths and labels."""
    chosen = [c for c in clips if int(c.name[-1]) < VIDEO_BATCH // VIDEO_SPEAKERS]
    batch = {"clips": np.zeros((len(chosen), 29, 96, 96), np.uint8),
             "lengths": np.zeros(len(chosen), np.int32),
             "labels": np.array([c.label for c in chosen], np.int64)}
    for row, clip in enumerate(chosen):
        data = load_clip(clip.path)
        batch["clips"][row, :len(data)] = data
        batch["lengths"][row] = len(data)
    check(len(chosen) == VIDEO_BATCH, f"{len(chosen)} clips in the full batch")
    return batch


def zero_video_counts() -> None:
    for wrapper in (bn_prelu.bn_prelu_forward, bn_prelu.bn_prelu_backward,
                    maxpool.maxpool_forward, maxpool.maxpool_backward):
        wrapper.launches = 0


def video_counts() -> dict:
    return {"bn_prelu_fwd": bn_prelu.bn_prelu_forward.launches,
            "bn_prelu_bwd": bn_prelu.bn_prelu_backward.launches,
            "maxpool_fwd": maxpool.maxpool_forward.launches,
            "maxpool_bwd": maxpool.maxpool_backward.launches}


@contextlib.contextmanager
def recording_bn_calls(record: list):
    """Append ``(shape, dtype, mean, var)`` of every call of the fused
    BN+PReLU op (through K3 or whatever stands in for it) to ``record``."""
    inner = bn_prelu.bn_prelu_train

    def recorded(x, *args):
        y, mean, var = inner(x, *args)
        record.append((tuple(x.shape), x.dtype, mean.clone(), var.clone()))
        return y, mean, var

    bn_prelu.bn_prelu_train = recorded
    try:
        yield
    finally:
        bn_prelu.bn_prelu_train = inner


def bn_prelu_path_check(seen: set) -> dict:
    """K3/K4 against their plain versions at every shape the main path gave
    them (the bars of phase 6). Returns the largest y and dx errors."""
    worst = {"y": 0.0, "dx": 0.0}
    with fp32_math():
        for i, (shape, dtype) in enumerate(sorted(seen, key=str)):
            inputs = bn_inputs(shape, dtype, 200 + i)
            err, _ = bn_prelu_check(*inputs, 1e-5, f"bn_prelu main-path {shape} "
                                                   f"{str(dtype)[6:]}")
            worst = {k: max(v, err[k]) for k, v in worst.items()}
            del inputs
            torch.cuda.empty_cache()
    return worst


def video_main_path_phase() -> dict:
    with tempfile.TemporaryDirectory() as root:
        write_clip_corpus(os.path.join(root, "clips"))
        clips = scan_clip_dir(os.path.join(root, "clips"))
        check(len(clips) == VIDEO_SPEAKERS * VIDEO_CLIPS, f"{len(clips)} clips scanned")
        trainer = VideoTrainer(video_config(), num_classes=VIDEO_SPEAKERS,
                               exp_root=os.path.join(root, "exp"))
        batches = VideoClipBatches(clips, batch_size=VIDEO_BATCH, bucket_t=8, seed=0)
        shapes = [b["clips"].shape for b in batches.epoch(1)]

        calls: list = []
        with recording_bn_calls(calls):
            zero_video_counts()
            t0 = time.perf_counter()
            losses = trainer.train(batches, epochs=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = video_counts()

        check(len(losses) == len(shapes) == trainer.step, f"{len(losses)} losses for "
              f"{len(shapes)} batches, step {trainer.step}")
        check(all(math.isfinite(v) for v in losses), f"non-finite losses {losses}")
        per_step = 3 * 9  # partial, finalize, apply at each of the nine sites
        for name, n in launches.items():
            # the max-pool: one forward and one backward kernel per step
            want = per_step if name.startswith("bn_prelu") else 1
            check(n == want * len(losses), f"{name}: {n} launches for {len(losses)} "
                  f"steps, {want} expected per step")
        check(os.path.exists(os.path.join(trainer.exp_dir, "net_1")), "no net_1 checkpoint")
        # the kernels saw the sites' shapes of each bucketed batch, and hold
        # against their plain versions at every one of them
        check(len(calls) == 9 * len(losses), f"{len(calls)} fused BN+PReLU calls for "
              f"{len(losses)} steps")
        seen = {(shape, dtype) for shape, dtype, _, _ in calls}
        want = {(s, torch.float32) for b in shapes for s, _ in bn_site_shapes(b[0], b[1])}
        check(seen == want, f"the main path gave K3 the shapes {sorted(seen, key=str)}, "
              f"expected {sorted(want, key=str)}")
        path_err = bn_prelu_path_check(seen)

        full_batch = full_clip_batch(clips)
        eval_batches = VideoClipBatches(clips, batch_size=VIDEO_BATCH, bucket_t=8,
                                        shuffle=False, pre_crop=(88, 88))
        t0 = time.perf_counter()
        emb = trainer.extract_clip_embeddings(eval_batches)
        torch.cuda.synchronize()
        emb_wall = time.perf_counter() - t0
    check(len(emb) == len(clips), f"{len(emb)} embeddings for {len(clips)} clips")
    mat = torch.stack(list(emb.values()))
    check(mat.device.type == "cuda" and tuple(mat.shape[1:]) == (512,),
          f"embeddings {tuple(mat.shape)} on {mat.device}")
    check(bool(torch.isfinite(mat).all()), "non-finite clip embeddings")
    log(f"video main path: {len(clips)} clips, batches {shapes}, losses "
        f"{', '.join(f'{v:.4f}' for v in losses)}; launches {launches} "
        f"(BN+PReLU {per_step}, max-pool 1 per step and pass); train {wall:.2f} s wall incl. header scan, "
        f"decode and cuDNN's first calls; K3/K4 vs plain at its {len(seen)} site shapes: "
        f"max err y {path_err['y']:.2e}, dx {path_err['dx']:.2e}; {len(emb)} embeddings {tuple(mat.shape[1:])} in "
        f"{emb_wall:.2f} s")
    return {"trainer": trainer, "full_batch": full_batch, "launches": launches, "losses": losses,
            "path_err": path_err, "batches": [list(b) for b in shapes]}


# ---------------------------------------------------------------- phase 8
# device kernels by kind, first match wins: the six kernels of
# csrc/bn_prelu_kernel.cu and the two of csrc/maxpool_kernel.cu as the
# profiler names them, cuDNN/cuBLAS (the
# convolutions, the TCN and the classifier), Adam, the rest of PyTorch's own
KERNEL_KINDS = [
    ("K3/K4 (bn_prelu_kernel.cu)", re.compile(
        r"::(stats_partial|stats_finalize|apply|bwd_partial|bwd_finalize|bwd_apply)_kernel\b")),
    ("max-pool (maxpool_kernel.cu)", re.compile(r"::maxpool_(fwd|bwd)_kernel\b")),
    ("cuDNN/cuBLAS", re.compile(r"cudnn|xmma|cublas|gemm|wgrad|dgrad|fprop|fft", re.I)),
    ("Adam", re.compile(r"multi_tensor_apply|adam", re.I)),
    ("other PyTorch", re.compile(r"")),
]
def plain_bn_prelu_forward(x, scale, bias, alpha, eps):
    y, mean, var = bn_prelu.bn_prelu_reference(x, scale, bias, alpha, eps)
    return y, mean, var, torch.rsqrt(var + eps)


def faulty_bn_prelu_forward(fault):
    """A K3 with a planted fault, for the step bars to catch: the plain
    forward with the batch variance scaled by ``1 + fault``, or, for
    ``fault == "bf16"``, with the mean and variance held in bf16."""
    def forward(x, scale, bias, alpha, eps):
        _, mean, var = bn_prelu.bn_prelu_reference(x, scale, bias, alpha, eps)
        if fault == "bf16":
            mean, var = mean.bfloat16().float(), var.bfloat16().float()
        else:
            var = var * (1.0 + fault)
        inv = torch.rsqrt(var + eps)
        z = ((x - mean) * inv) * scale + bias
        return torch.where(z >= 0, z, alpha * z), mean, var, inv
    return forward


@contextlib.contextmanager
def plain_bn_prelu(forward=plain_bn_prelu_forward,
                   backward=bn_prelu.bn_prelu_backward_reference):
    """Route the fused BN+PReLU op's forward (K3) and backward (K4) through
    the given functions, by default their plain versions, on the same
    device and inside the same autograd op; ``None`` keeps that kernel."""
    kernels = bn_prelu.bn_prelu_forward, bn_prelu.bn_prelu_backward
    bn_prelu.bn_prelu_forward = forward or kernels[0]
    bn_prelu.bn_prelu_backward = backward or kernels[1]
    try:
        yield
    finally:
        bn_prelu.bn_prelu_forward, bn_prelu.bn_prelu_backward = kernels


@contextlib.contextmanager
def plain_maxpool():
    """Route the frontend max-pool through its plain version
    (``F.max_pool3d`` and its autograd) on the same device."""
    kernel = maxpool.maxpool_frontend
    maxpool.maxpool_frontend = maxpool.maxpool_frontend_reference
    try:
        yield
    finally:
        maxpool.maxpool_frontend = kernel


STEP_LOSS_RTOL = 1e-5
STEP_STAT_RTOL = 1e-5  # every site's batch mean (in sigmas) and variance (relative)
NUDGE = 1e-6           # relative nudge of the input frames: the plain path's own sensitivity
NUDGE_FACTOR = 3.0     # the kernel path may move the gradients this many times as far
K4_GRAD_RTOL = 1e-4    # K4 alone (same forward): gradient norm, relative
# planted K3 faults: the batch variance off by this much (relative), or the
# statistics held in bf16. 1e-5 equals the statistics bar of phase 6 and of
# the step, so it and 1e-6 are reported only; the others must be rejected
PLANTED_FAULTS = (1e-6, 1e-5, 1e-4, "bf16")
MUST_CATCH = (1e-4, "bf16")


def grad_distance(a: dict, b: dict) -> float:
    """``|a - b| / |b|`` over every gradient of the network at once."""
    num = sum(float(((a[n] - b[n]).double() ** 2).sum()) for n in b)
    return math.sqrt(num / sum(float((v.double() ** 2).sum()) for v in b.values()))


def stat_distance(a: list, b: list) -> tuple[float, int]:
    """The largest gap between two steps' batch statistics at the fused
    sites, in forward order: a mean's in units of ``b``'s standard
    deviation, a variance's relative to ``b``'s. Returns it and its site."""
    check(len(a) == len(b) == 9, f"{len(a)} and {len(b)} fused sites recorded, 9 expected")
    return max((max(float(((ma - mb).abs() / vb.sqrt()).max()),
                    float(((va - vb).abs() / vb).max())), site)
               for site, ((_, _, ma, va), (_, _, mb, vb)) in enumerate(zip(a, b)))


def worst_tensor(a: dict, b: dict) -> tuple[float, str]:
    """The largest ``max|a - b|`` of a tensor over its ``max|b|``, among the
    tensors whose gradient is not zero in exact arithmetic (the biases of
    the TCN convolutions feeding a train-mode BN hold rounding noise below
    1e-3 of the network's largest gradient)."""
    top = max(float(v.abs().max()) for v in b.values())
    return max((float((a[n] - b[n]).abs().max()) / float(b[n].abs().max()), n)
               for n in b if float(b[n].abs().max()) >= 1e-3 * top)


def video_step_phase(trainer: VideoTrainer, batch: dict, bn: dict) -> dict:
    clips, lengths, labels = (torch.from_numpy(batch[k]).cuda()
                              for k in ("clips", "lengths", "labels"))
    x = V.train_transform(clips, torch.Generator().manual_seed(1))[..., None]
    x = V.mask_pad_frames(x, lengths)
    state = (copy.deepcopy(trainer.model.state_dict()),
             copy.deepcopy(trainer.optimizer.state_dict()), trainer.step)

    def step(frames):
        """One step from ``state``: its loss, gradients and batch statistics
        at the fused sites; the state is restored after it."""
        torch.manual_seed(0)   # the same dropout masks in every run
        stats: list = []
        with recording_bn_calls(stats):
            loss = float(trainer.train_step_frames(frames, lengths, labels)["loss"])
        grads = {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()}
        trainer.model.load_state_dict(state[0])
        trainer.optimizer.load_state_dict(state[1])
        trainer.step = state[2]
        return loss, grads, stats

    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        zero_video_counts()
        loss_k, grads_k, stats_k = step(x)
        check(video_counts() == {"bn_prelu_fwd": 27, "bn_prelu_bwd": 27, "maxpool_fwd": 1,
                                 "maxpool_bwd": 1},
              f"kernel step launched {video_counts()}: 27 BN+PReLU and 1 max-pool kernel "
              "expected per pass")
        zero_video_counts()
        # every other step of this phase pools through the plain version, so
        # that its bars measure K3 and K4 alone; the pool's forward is exact
        # and its backward is held in phase 9
        with plain_maxpool():
            with plain_bn_prelu():
                loss_p, grads_p, stats_p = step(x)
                loss_n, grads_n, stats_n = step(x * (1.0 + NUDGE))
            check(not any(video_counts().values()), "the plain steps launched the kernels")
            # K4 alone: both runs of this comparison see bit-equal activations
            with plain_bn_prelu(backward=None):
                loss_h, grads_h, _ = step(x)
            # The step's gradients are sums that cancel: a 1e-6 relative nudge
            # of the input frames moves the plain path's own gradients by ~1e-3
            # of their norm. The kernel path's gradients are held to that
            # sensitivity, measured in this run; its forward, through the batch
            # statistics of every fused site (averages, which do not cancel), to
            # a fixed bar; K4 alone, on bit-equal activations, to a fixed bar.
            # Planted K3 faults show what the bars reject.
            d_np = grad_distance(grads_n, grads_p)
            planted = {}
            for fault in PLANTED_FAULTS:
                with plain_bn_prelu(forward=faulty_bn_prelu_forward(fault)):
                    loss_f, grads_f, stats_f = step(x)
                rel, dist = abs(loss_f - loss_p) / abs(loss_p), grad_distance(grads_f, grads_p)
                stat = stat_distance(stats_f, stats_p)[0]
                planted[str(fault)] = {
                    "loss_rel": rel, "grad_distance": dist, "nudge_ratio": dist / d_np,
                    "stat_distance": stat,
                    "caught_by": [name for name, hit in (
                        ("loss", rel > STEP_LOSS_RTOL), ("gradients", dist > NUDGE_FACTOR * d_np),
                        ("statistics", stat > STEP_STAT_RTOL)) if hit]}
                del grads_f
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    d_kp, d_hp = (grad_distance(g, grads_p) for g in (grads_k, grads_h))
    (s_kp, s_site), s_np = stat_distance(stats_k, stats_p), stat_distance(stats_n, stats_p)[0]
    worst = {k: worst_tensor(g, grads_p) for k, g in (("kernel", grads_k), ("nudge", grads_n),
                                                       ("k4", grads_h))}
    log(f"kernel vs plain step at bs {VIDEO_BATCH} x 29 (corpus clips, speaker labels): loss "
        f"{loss_k:.8f} vs {loss_p:.8f} ({loss_rel:.2e} relative; nudged input {loss_n:.8f}, "
        f"K4 alone {loss_h:.8f}); batch statistics of the fused sites: kernel path "
        f"{s_kp:.2e} from the plain path (site {s_site}; bar {STEP_STAT_RTOL}), nudged input "
        f"{s_np:.2e}; gradient distance from the plain path: kernel path "
        f"{d_kp:.3e}, plain path with the input nudged by {NUDGE} {d_np:.3e} (ratio "
        f"{d_kp / d_np:.2f}, bar {NUDGE_FACTOR}), K4 alone {d_hp:.3e} (bar {K4_GRAD_RTOL}); "
        "worst tensor, of its plain largest: " + ", ".join(
            f"{k} {v:.2e} ({n})" for k, (v, n) in worst.items()))
    log("planted K3 faults against the step bars (loss relative, statistics, gradient "
        "distance, its ratio to the nudge's): " + "; ".join(
            f"{k}: {v['loss_rel']:.2e}, {v['stat_distance']:.2e}, {v['grad_distance']:.3e}, "
            f"{v['nudge_ratio']:.2f} (caught by {', '.join(v['caught_by']) or 'none'})"
            for k, v in planted.items()))
    del grads_k, grads_p, grads_n, grads_h, x
    check(loss_rel <= STEP_LOSS_RTOL, f"kernel-path loss {loss_k} vs plain {loss_p}: "
          f"{loss_rel:.3e} relative, bar {STEP_LOSS_RTOL}")
    check(s_kp <= STEP_STAT_RTOL, f"kernel-path batch statistics {s_kp:.3e} from the plain "
          f"path's at site {s_site}, bar {STEP_STAT_RTOL}")
    check(d_kp <= NUDGE_FACTOR * d_np, f"kernel-path gradients {d_kp:.3e} of the plain norm "
          f"from the plain path; a {NUDGE} nudge of the input moves them {d_np:.3e}; bar "
          f"{NUDGE_FACTOR} x that")
    check(d_hp <= K4_GRAD_RTOL, f"K4 alone: gradients {d_hp:.3e} of the plain norm from "
          f"the plain path, bar {K4_GRAD_RTOL}")
    for fault in MUST_CATCH:
        check(planted[str(fault)]["caught_by"], f"a planted K3 fault ({fault}) passed the "
              "step bars")

    gen = torch.Generator().manual_seed(2)
    for _ in range(2):
        trainer.train_step(clips, lengths, labels, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        trainer.train_step(clips, lengths, labels, gen)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = sorted(walls)[2]
    kernel_ms = bn["per_step"]["fwd"] + bn["per_step"]["bwd"]
    log(f"video train step at bs {VIDEO_BATCH} x 29 (FP32): {step_ms:.1f} ms median of 5 "
        f"({', '.join(f'{w:.1f}' for w in walls)}), {VIDEO_BATCH / step_ms * 1e3:.1f} clips/s, "
        f"peak {peak_gb:.1f} GB; K3+K4 at their measured times {kernel_ms:.3f} ms = "
        f"{kernel_ms / step_ms:.1%} of the step")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        t0 = time.perf_counter()
        trainer.train_step(clips, lengths, labels, gen)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    kernels, layers = {}, {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us / 1e3
            kind = next(k for k, pat in KERNEL_KINDS if pat.search(ev.key))
            layers[kind] = layers.get(kind, 0.0) + dev_us / 1e3
    # device time of each convolution call, forward and backward, by shape
    convs = sorted(((getattr(ev, "device_time_total", 0) / 1e3, ev.key, ev.input_shapes[:2])
                    for ev in prof.key_averages(group_by_input_shape=True)
                    if ev.key in ("aten::cudnn_convolution", "aten::convolution_backward")),
                   key=lambda t: -t[0])[:8]
    busy = sum(kernels.values())
    ours = layers.get("K3/K4 (bn_prelu_kernel.cu)", 0.0)
    top_k = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    if busy > 0:
        log(f"profiled step: {prof_wall:.1f} ms wall, {busy:.1f} ms of device kernels "
            f"({busy / prof_wall:.1%} busy, {1 - busy / prof_wall:.1%} idle), K3+K4 {ours:.3f} ms "
            f"({ours / busy:.1%} of device time); by kind: " + ", ".join(
                f"{k} {v:.1f} ms" for k, v in sorted(layers.items(), key=lambda kv: -kv[1])))
        log("  top kernels:")
        for name, ms in top_k:
            log(f"  {ms:9.3f} ms  {name[:150]}")
        log("  top convolution calls (device time incl. their kernels; input shapes):")
        for ms, name, shapes in convs:
            log(f"  {ms:9.3f} ms  {name} {shapes}")
    else:
        log("profiled step: the profiler saw no device time (not measured)")
    return {"step_ms": step_ms, "step_walls": walls, "clips_per_sec": VIDEO_BATCH / step_ms * 1e3,
            "kernel_share": kernel_ms / step_ms, "peak_gb": peak_gb, "loss_rel": loss_rel,
            "stat_distance": s_kp, "grad_distance": d_kp, "nudge_distance": d_np,
            "k4_distance": d_hp,
            "planted_faults": planted, "worst_tensor": {k: list(v) for k, v in worst.items()}, "profiled_busy_ms": busy,
            "profiled_wall_ms": prof_wall, "profiled_bn_prelu_ms": ours,
            "profiled_by_kind_ms": layers}


# ---------------------------------------------------------------- phase 10
AV_SPEAKERS, AV_UTTS = 32, 4     # per speaker: utterances 0-1 enrol, 2-3 probe and calibrate
AV_PART_TOL = 1e-4               # kernel-path vs plain-path parts
BATCHED_TOL = 1e-5               # an embedding served alone vs in a micro-batch
# the model and test sections of conf/fusion_config.yaml (the card's
# machine reads no YAML); tests/test_torch_av_e2e.py holds them to the file
FUSION_MODEL = {
    "audio_config": ETDNN_MODEL_OPTS,
    "video_config": {"arch": "tcn", "tcn": {
        "extract_feats": True, "backbone_type": "resnet", "width_mult": 1.0,
        "relu_type": "prelu", "tcn_num_layers": 4, "tcn_kernel_size": [3, 5, 7],
        "tcn_dropout": 0.2, "tcn_dwpw": False, "tcn_width_mult": 1}},
}
FUSION_TEST = {"eval_lomgrid": True, "eval_grid": True, "use_cos": True, "use_plda": False,
               "use_fusion_head": False}


def write_av_corpus(root: str, seed: int = 0) -> dict:
    """32 speakers x 4 utterances: ``audio/sNN/uK.wav`` (1-3 s PCM16) and two
    clips ``video/sNN/uK_{0,1}.npz`` (96x96 uint8, 21-32 frames) each; a
    half-target trial list over the probe utterances (2 and 3 of each
    speaker). Returns ``{speaker: [(wav, [clip, clip]), ...]}``."""
    rng = np.random.default_rng(seed)
    items: dict = {}
    for spk in range(AV_SPEAKERS):
        name = f"s{spk:02d}"
        for sub in ("audio", "video"):
            os.makedirs(os.path.join(root, sub, name), exist_ok=True)
        for u in range(AV_UTTS):
            wav = os.path.join(root, "audio", name, f"u{u}.wav")
            write_wav(wav, speaker_wave(rng, spk), RATE)
            clips = []
            for c in range(2):
                clips.append(os.path.join(root, "video", name, f"u{u}_{c}.npz"))
                np.savez(clips[-1], data=speaker_clip(rng, spk, int(rng.integers(21, 33))))
            items.setdefault(name, []).append((wav, clips))
    probes = [f"s{spk:02d}/u{u}.wav" for spk in range(AV_SPEAKERS) for u in (2, 3)]
    with open(os.path.join(root, "trials.txt"), "w") as fh:
        for i in range(2000):
            a = int(rng.integers(len(probes)))
            b = a ^ 1 if i % 2 == 0 else int(rng.integers(len(probes)))
            fh.write(f"{int(probes[a][:3] == probes[b][:3])} {probes[a]} {probes[b]}\n")
    return items


def fusion_config(root: str, resume: dict, use_fusion_head: bool) -> str:
    """Write the fusion config as JSON and return its path."""
    cfg = {
        "data": {"video_root": os.path.join(root, "video"),
                 "test_root": os.path.join(root, "audio"),
                 "trial_grid": os.path.join(root, "trials.txt"),
                 "python_data_config": AUDIO_DATA_OPTS},
        "model": FUSION_MODEL,
        "train": {"max_clips": 2, "clip_frames": 32, "n_spk": AV_SPEAKERS,
                  "resume": resume.get("head", "None"),
                  "audio_config": {"resume": resume.get("audio", "None")},
                  "video_config": {"resume": resume.get("video", "None")}},
        "test": dict(FUSION_TEST, use_fusion_head=use_fusion_head, batch_size=64),
    }
    path = os.path.join(root, f"fusion_{'head' if use_fusion_head else 'concat'}_"
                              f"{'resumed' if resume else 'fresh'}.json")
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    return path


@torch.no_grad()
def calibrate_video_bn(model, clips_u8: torch.Tensor, lengths: torch.Tensor) -> None:
    """Set every BN of the frontend and trunk to the batch statistics of one
    real batch: a train-mode pass with the running averages' memory switched
    off. The model is left in eval mode."""
    bns = [m for m in model.modules() if isinstance(m, TorchBatchNorm)]
    saved = [bn.momentum for bn in bns]
    for bn in bns:
        bn.momentum = 0.0
    with fp32_math():
        x = V.mask_pad_frames(V.eval_transform(clips_u8, (88, 88))[..., None], lengths)
        model.train().frame_features(x)
    for bn, m in zip(bns, saved):
        bn.momentum = m
    model.eval()


def prepare_av_checkpoints(root: str, items: dict, device=None) -> dict:
    """Seeded encoders and head with calibrated BN statistics, saved as the
    checkpoints that the fusion config then names."""
    cfg = load_fusion_config(fusion_config(root, {}, False))
    trainer = make_trainer(cfg, os.path.join(root, "exp"), "prep", mode="av_test",
                           device=device)
    enrol = [it for its in items.values() for it in its[:2]]
    utts = [EvalUtterance(w, w) for w, _ in enrol]
    batch = next(iter(EvalUtteranceSet(utts, **eval_set_kwargs(
        trainer.feat_cfg, {"batch_size": 64, "n_buckets": 1})).batches()))
    calibrate_bn(types.SimpleNamespace(model=trainer.audio_model, device=trainer.device,
                                       eval_feat_cfg=trainer.raw_feat_cfg), batch, seed=1)
    loaded = [load_clip(c)[:29] for _, cs in enrol[:8] for c in cs]
    clips = np.zeros((len(loaded), 29, 96, 96), np.uint8)
    for i, d in enumerate(loaded):
        clips[i, :len(d)] = d
    calibrate_video_bn(trainer.video_model, torch.from_numpy(clips).to(trainer.device),
                       torch.tensor([len(d) for d in loaded], device=trainer.device))
    return {name: ckpt.save_checkpoint(os.path.join(root, "ckpt"), f"net_{name}",
                                       {"epoch": 0, "state_dict": module.state_dict()})
            for name, module in (("audio", trainer.audio_model), ("video", trainer.video_model),
                                 ("head", trainer.fusion_head))}


@contextlib.contextmanager
def counting_calls(obj, name: str, counter: list):
    """Count the calls of ``obj.name`` in ``counter[0]``."""
    inner = getattr(obj, name)

    def counted(*args, **kw):
        counter[0] += 1
        return inner(*args, **kw)

    setattr(obj, name, counted)
    try:
        yield
    finally:
        setattr(obj, name, inner)


def median(xs) -> float:
    return sorted(xs)[len(xs) // 2]


def timed(fn):
    """``(fn(), host ms)`` with the device's work waited for."""
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def av_verifier_run(cfg_path: str, root: str, items: dict, identify: bool,
                    device=None) -> dict:
    """One ``AVSpeakerVerifier`` through calibrate, enroll, verify and
    identify; returns what it measured and the verifier."""
    v = AVSpeakerVerifier(cfg_path, exp_root=os.path.join(root, "exp"), log_time="serve",
                          device=device)
    chunks = [0]
    with counting_calls(v.trainer, "extract_pair_embedding", chunks):
        (eer, thr), cal_ms = timed(lambda: v.calibrate(os.path.join(root, "trials.txt")))
        n_cal = chunks[0]
        for spk, its in items.items():
            profile = v.enroll(spk, its[:2])
        check(isinstance(profile, np.ndarray) and abs(np.linalg.norm(profile) - 1) < 1e-5,
              "a profile is not a unit numpy vector")
        speakers = list(items)
        # the same requests twice when asked to identify too: every probe's
        # audio length is a convolution shape of its own, new to cuDNN the
        # first time and known the second
        pass_ms = []
        for _ in range(2 if identify else 1):
            results, lat = [], []
            for i, spk in enumerate(speakers):
                for claimed, probe in ((spk, items[spk][2]),
                                       (speakers[(i + 1) % len(speakers)], items[spk][3])):
                    r, ms = timed(lambda: v.verify(claimed, probe))
                    check(math.isfinite(r.score) and r.accept == (r.score >= thr),
                          f"verify({claimed}) gave {r}")
                    results.append((claimed == spk, r.score, r.accept))
                    lat.append(ms)
            pass_ms.append(median(lat))
        ranks = []
        if identify:
            for spk in speakers[:16]:
                ranks.append(v.identify(items[spk][2], top_k=3)[0][0] == spk)
            # a single-utterance profile scores its own utterance 1.0
            v.enroll("probe_self", items[speakers[0]][3])
            self_score = v.score("probe_self", items[speakers[0]][3])
            check(abs(self_score - 1.0) < 1e-5, f"self score {self_score}")
            del v.profiles["probe_self"]
    check(math.isfinite(eer) and 0.0 <= eer <= 1.0 and math.isfinite(thr),
          f"calibrate gave EER {eer}, threshold {thr}")
    dim = len(next(iter(v.profiles.values())))
    target = [s for t, s, _ in results if t]
    impostor = [s for t, s, _ in results if not t]
    return {"verifier": v, "chunks": chunks[0], "calibration_chunks": n_cal, "eer": eer,
            "threshold": thr, "dim": dim, "calibration_ms": cal_ms,
            "pairs_per_sec": 2 * AV_SPEAKERS / cal_ms * 1e3,
            "verify_ms": pass_ms[0], "verify_again_ms": pass_ms[-1] if identify else None,
            "requests": len(results) * len(pass_ms) + len(ranks),
            "target_accepts": sum(a for t, _, a in results if t) / len(target),
            "impostor_accepts": sum(a for t, _, a in results if not t) / len(impostor),
            "target_mean": float(np.mean(target)), "impostor_mean": float(np.mean(impostor)),
            "identify_top1": float(np.mean(ranks)) if ranks else None}


def microbatch_run(root: str, items: dict, audio_ckpt: str, device=None) -> dict:
    """``SpeakerVerifier`` with an AS-norm cohort: requests served directly,
    then the same requests from 16 threads through a ``MicroBatcher``."""
    cfg = Config({"data": {"python_data_config": AUDIO_DATA_OPTS}, "model": ETDNN_MODEL_OPTS,
                  "train": {"loss": "LMCL"}, "test": {"batch_size": 64}})
    v = SpeakerVerifier(cfg, checkpoint=audio_ckpt, device=device)
    passes = [0]
    zero_fbank_counts()
    maxpool.maxpool_forward.launches = 0
    with counting_calls(v.extractor, "embed", passes):
        v.set_cohort_files([its[3][0] for its in items.values()], top_k=20)
        eer, thr = v.calibrate(os.path.join(root, "trials.txt"), os.path.join(root, "audio"))
        for spk, its in items.items():
            v.enroll(spk, [w for w, _ in its[:2]])
        speakers = list(items)
        requests = []
        for i, spk in enumerate(speakers):
            pcm = read_wav(items[spk][2][0])[0]
            requests += [(spk, pcm), (speakers[(i + 1) % len(speakers)], pcm)]
        direct = [v.verify(spk, pcm) for spk, pcm in requests]
        # batch-1 latency with host and with device scoring, on the same 16
        # requests (their shapes now known to cuDNN), in turns
        lat, dev_gap = {"host": [], "device": []}, 0.0
        for mode in ("host", "device", "device", "host"):
            v.host_score_macs = 0 if mode == "device" else type(v).host_score_macs
            for (spk, pcm), want in list(zip(requests, direct))[:16]:
                r, ms = timed(lambda: v.verify(spk, pcm))
                lat[mode].append(ms)
                if mode == "device":
                    dev_gap = max(dev_gap, abs(r.score - want.score))
        del v.host_score_macs           # back to the class default
        # each probe served alone, at the batcher's own bucketing
        alone = {i: v.embed_pcm({"_": pcm}, set_overrides={"n_buckets": 0})["_"].cpu().numpy()
                 for i, (_, pcm) in enumerate(requests[::2])}
        with MicroBatcher(v, max_batch=32, max_wait_ms=20.0) as mb:
            with ThreadPoolExecutor(max_workers=16) as pool:
                (batched, wall_ms) = timed(lambda: list(pool.map(
                    lambda sp: mb.verify(sp[0], sp[1]), requests)))
                embedded = list(pool.map(lambda sp: mb.embed(sp[1]), requests[::2]))
            counts = {"requests": mb.n_requests, "batches": mb.n_batches, "slots": mb.n_slots,
                      "pad_slots": mb.n_pad_slots, "mean_batch_slots": mb.mean_batch_slots}
        check(not mb._thread.is_alive(), "the collector thread outlived close()")
    fb = fbank_counts()
    check(fb == {"fft": passes[0], "dft": 0}
          and maxpool.maxpool_forward.launches == 0,
          f"front-end launches {fb} for {passes[0]} extraction passes")
    check(counts["batches"] < counts["requests"], f"no batch formed: {counts}")
    score_gap = max(abs(b.score - d.score) for b, d in zip(batched, direct))
    check(all(b.accept == d.accept for b, d in zip(batched, direct)),
          "a micro-batched decision differs from the direct one")
    emb_gap = max(float(np.abs(e - alone[i]).max()) for i, e in enumerate(embedded))
    check(emb_gap <= BATCHED_TOL, f"an embedding served in a batch is {emb_gap:.3e} from the "
          f"same request served alone, bar {BATCHED_TOL}")
    check(dev_gap <= 1e-4, f"device scoring {dev_gap:.3e} from host scoring")
    return {**counts, "launches": fb["fft"], "launches_dft": fb["dft"], "eer": eer, "threshold": thr,
            "alone_vs_batched": emb_gap, "score_gap": score_gap,
            "accepts": sum(d.accept for d in direct),
            "verify_host_ms": median(lat["host"]), "verify_device_ms": median(lat["device"]),
            "host_vs_device_score": dev_gap, "batched_wall_ms": wall_ms,
            "batched_requests_per_sec": len(requests) / wall_ms * 1e3}


def av_serving_phase(device=None) -> dict:
    """``device`` is for rehearsing the phase's control flow on the CPU at a
    small size; the card check passes none."""
    with tempfile.TemporaryDirectory() as root:
        items = write_av_corpus(root)
        resume = prepare_av_checkpoints(root, items, device)

        zero_fbank_counts()
        maxpool.maxpool_forward.launches = 0
        concat = av_verifier_run(fusion_config(root, resume, False), root, items, True, device)
        head = av_verifier_run(fusion_config(root, resume, True), root, items, False, device)
        fb = fbank_counts()
        launches = {"fused_fbank": fb["fft"], "fused_fbank_dft": fb["dft"],
                    "maxpool_fwd": maxpool.maxpool_forward.launches}
        chunks = concat["chunks"] + head["chunks"]
        check(fb == {"fft": chunks, "dft": 0} and launches["maxpool_fwd"] == chunks > 0,
              f"{launches} for {chunks} extraction chunks")
        check(concat["dim"] == 1024 and head["dim"] == 3 * 512,
              f"fused dims {concat['dim']} (concat) and {head['dim']} (head)")
        v = concat.pop("verifier")
        head.pop("verifier")
        # the loaded weights are the calibrated ones
        saved = torch.load(resume["video"], map_location=v.trainer.device,
                           weights_only=True)["state_dict"]
        check(all(torch.equal(t, saved[k]) for k, t in v.trainer.video_model.state_dict().items()),
              "the video checkpoint did not load")

        # two chunks again, through the plain versions of both kernels
        two = [(f"{spk}/{i}", w, c) for spk, its in list(items.items())[:8]
               for i, (w, c) in enumerate(its)]
        kw = dict(max_clips=2, clip_frames=32, return_parts=True)
        (k_audio, k_video), chunk_ms = timed(lambda: embed_av_items(v.trainer, two, **kw))
        with plain_front_end(), plain_maxpool():
            before = fbank_counts(), maxpool.maxpool_forward.launches
            p_audio, p_video = embed_av_items(v.trainer, two, **kw)
            check(before == (fbank_counts(), maxpool.maxpool_forward.launches),
                  "the plain path launched a kernel")
        part_err = {"audio": 0.0, "video": 0.0}
        for name, _, _ in two:
            for key, k, pl in (("audio", k_audio, p_audio), ("video", k_video, p_video)):
                check(bool(torch.isfinite(k[name]).all()), f"non-finite {key} part of {name}")
                part_err[key] = max(part_err[key], float((k[name] - pl[name]).abs().max()))
        check(max(part_err.values()) <= AV_PART_TOL, f"kernel-path parts {part_err} from the "
              f"plain path's, bar {AV_PART_TOL}")

        # where a full chunk's time goes (16 items x 2 clips x 32 frames)
        tr = v.trainer
        on = dict(device=tr.device)
        clips = torch.zeros((16, 2, 32, 88, 88), dtype=torch.uint8, **on).random_(0, 256)
        lengths = torch.full((16, 2), 32, dtype=torch.int32, **on)
        sizes = torch.full((16,), 2, dtype=torch.int32, **on)
        pcm = torch.randn((16, 3 * RATE), **on) * 0.1
        t_feat = num_frames(3 * RATE, tr.feat_cfg.frame_len, tr.feat_cfg.frame_step)
        flen = torch.full((16,), t_feat, dtype=torch.int32, **on)
        slen = torch.full((16,), 3 * RATE, dtype=torch.int32, **on)
        with torch.no_grad(), fp32_math():
            x = V.mask_pad_frames(V.eval_transform(clips.reshape(32, 32, 88, 88))[..., None],
                                  lengths.reshape(32))
            conv, bn, act = tr.video_model.frontend3D
            pre_pool = act(bn(conv(x.movedim(-1, 1)).movedim(1, -1)))
            check(pre_pool.is_contiguous() and tuple(pre_pool.shape) == (32, 32, 44, 44, 64),
                  f"the serving chunk hands the pool {tuple(pre_pool.shape)} "
                  f"strides {pre_pool.stride()}")
            split = {
                "whole chunk": time_ms(lambda: tr.extract_pair_embedding(
                    pcm, flen, clips, lengths, sizes, sample_lengths=slen), iters=5),
                "video encoder": time_ms(lambda: tr._video_group_embed(clips, lengths, sizes),
                                         iters=5),
                "frontend conv+BN+PReLU": time_ms(
                    lambda: act(bn(conv(x.movedim(-1, 1)).movedim(1, -1))), iters=5),
                "max-pool kernel": time_ms(lambda: maxpool.maxpool_frontend(pre_pool)),
                "audio front-end (K1)": time_ms(lambda: F.extract_features(
                    pcm, tr.raw_feat_cfg, sample_lengths=slen)),
            }
        del clips, x, pre_pool
        mb = microbatch_run(root, items, resume["audio"], device)
    log(f"AV serving path: {chunks} extraction chunks, launches {launches}; concat: EER "
        f"{concat['eer']:.4f}, threshold {concat['threshold']:.4f}, dim {concat['dim']}, "
        f"target/impostor accepts {concat['target_accepts']:.2f}/{concat['impostor_accepts']:.2f}"
        f" (mean scores {concat['target_mean']:.3f}/{concat['impostor_mean']:.3f}), identify "
        f"top-1 {concat['identify_top1']:.2f}, batch-1 verify {concat['verify_ms']:.2f} ms "
        f"median ({concat['verify_again_ms']:.2f} ms for the same requests again), calibration sweep {concat['pairs_per_sec']:.1f} utterance pairs/s "
        f"({concat['calibration_ms']:.0f} ms incl. decode); head: EER {head['eer']:.4f}, dim "
        f"{head['dim']}, accepts {head['target_accepts']:.2f}/{head['impostor_accepts']:.2f}, "
        f"verify {head['verify_ms']:.2f} ms; kernel-path parts from the plain path's: "
        f"audio {part_err['audio']:.2e}, video {part_err['video']:.2e} (bar {AV_PART_TOL}); "
        f"two chunks of 16 in {chunk_ms:.1f} ms incl. decode")
    log("one full chunk (16 items x 2 clips x 32 frames, 3 s audio), device ms: "
        + ", ".join(f"{k} {t:.3f}" for k, t in split.items()))
    log(f"micro-batching: {mb['requests']} requests in {mb['batches']} batches "
        f"({mb['mean_batch_slots']:.1f} real slots per batch, {mb['pad_slots']} pad slots), "
        f"{mb['launches']} front-end launches; decisions equal to the direct calls' "
        f"({mb['accepts']} accepts of {len(items) * 2}), largest AS-normed score gap "
        f"{mb['score_gap']:.2e}; served alone vs in a batch: {mb['alone_vs_batched']:.3e} (bar "
        f"{BATCHED_TOL}); batch-1 verify {mb['verify_host_ms']:.2f} ms with host scoring, "
        f"{mb['verify_device_ms']:.2f} ms with device scoring (scores {mb['host_vs_device_score']:.1e}"
        f" apart); {mb['batched_requests_per_sec']:.1f} requests/s from 16 threads")
    return {"launches": launches, "chunks": chunks, "concat": concat, "head": head,
            "part_err": part_err, "chunk_split_ms": split, "microbatch": mb}


BN_REPLACES = {"fwd": ("deeplip_tpu/ops/pallas/bn_prelu_kernel.py:56",
                       "deeplip_tpu/ops/pallas/bn_prelu_kernel.py:70"),
               "bwd": ("deeplip_tpu/ops/pallas/bn_prelu_kernel.py:80",
                       "deeplip_tpu/ops/pallas/bn_prelu_kernel.py:102")}


def bn_entry(name: str, kind: str, bn: dict, video: dict) -> dict:
    """A K3 or K4 line of the ``kernels`` record: times summed over the nine
    sites of one bs 128 x 29 train step in f32, with each shape beside."""
    err = "y" if kind == "fwd" else "dx"
    per_step = bn["per_step"]
    return {
        "name": name,
        "route": "cuda",
        "source": "deeplip_tpu_torch/csrc/bn_prelu_kernel.cu",
        "replaces": BN_REPLACES[kind][0],
        "also_replaces": BN_REPLACES[kind][1],
        "launches": video["launches"][name],
        "max_abs_err": max([r["err_" + err] for r in bn["rows"] if r["dtype"] == "float32"]
                           + [video["path_err"][err]]),
        "max_abs_err_bf16": max(r["err_" + err] for r in bn["rows"] if r["dtype"] == "bfloat16"),
        "ms": per_step[kind],
        "kernel_ms": per_step[kind],
        "plain_ms": per_step[f"{kind}_plain"],
        "bound_ms": per_step[f"{kind}_bound"],
        "bound_by": bn["rows"][0][f"{kind}_bound_by"],
        "library_ms": None,
        "library_two_calls_ms": per_step[f"{kind}_library"],
        "library_note": "no single PyTorch call computes it; library_two_calls_ms times "
                        "F.batch_norm(training=True) then F.prelu" + (
                            "" if kind == "fwd" else ", their autograd backward"),
        "per": "one bs 128 x 29 Lipreading train step: 9 sites, f32",
        "shapes": [{k: r[k] for k in ("shape", "dtype", "sites", kind, f"{kind}_plain",
                                      f"{kind}_bound") + ((f"{kind}_library",)
                                                          if f"{kind}_library" in r else ())}
                   for r in bn["rows"]],
    }


def pool_entry(pool: dict, av: dict, video: dict) -> dict:
    """The max-pool line of the ``kernels`` record: the forward at one
    serving chunk's shape in f32 (what the AV path launches), with the
    backward and every other timed shape beside it."""
    rows = [r for r in pool["rows"] if "fwd" in r]
    serve = next(r for r in rows if r["what"] == "serving chunk" and r["dtype"] == "float32")
    return {
        "name": "maxpool_frontend",
        "route": "cuda",
        "source": "deeplip_tpu_torch/csrc/maxpool_kernel.cu",
        "replaces": "benchmarks/pool_mosaic_probe.py:43",
        "launches": av["launches"]["maxpool_fwd"],
        "launches_video_train": {k: video["launches"][k] for k in ("maxpool_fwd", "maxpool_bwd")},
        "max_abs_err": 0.0,   # y is bit-equal at every shape, or the run has failed
        "max_abs_err_dx": max(r["err_dx"] for r in pool["rows"] if r["dtype"] == "float32"),
        "max_abs_err_dx_bf16": max(r["err_dx"] for r in pool["rows"]
                                   if r["dtype"] == "bfloat16"),
        "ms": serve["fwd"],
        "plain_ms": serve["fwd_plain"],
        "bound_ms": serve["fwd_bound"],
        "bound_by": "bytes",
        "library_ms": serve["fwd_plain"],
        "library_note": "F.max_pool3d on the channels-last view, which is also the plain "
                        "version; fwd_library_contiguous is the same call on a contiguous "
                        "NCDHW copy; bwd_plain is its autograd backward",
        "per": "one AV serving chunk: 16 items x 2 clips x 32 frames, f32, forward only",
        "shapes": rows,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    dev = device_phase()
    part, peaks = card_peaks(dev["name"])
    build_phase()
    kern = kernel_phase(peaks)
    main_path = main_path_phase()
    sweep = sweep_phase(main_path["extractor"])
    del main_path["extractor"]
    torch.cuda.empty_cache()
    audio_train = audio_train_phase(dev["smi"], peaks)
    torch.cuda.empty_cache()
    bn = bn_prelu_phase(peaks)
    pool = maxpool_phase(peaks)
    video = video_main_path_phase()
    step = video_step_phase(video.pop("trainer"), video.pop("full_batch"), bn)
    torch.cuda.empty_cache()
    av = av_serving_phase()
    launches = {
        "launches": main_path["launches"]["fused_fbank"],
        "launches_sweep": sweep["launches"]["fft"],
        "launches_av_serving": av["launches"]["fused_fbank"],
        "launches_microbatch": av["microbatch"]["launches"],
        "launches_audio_train": audio_train["launches"]["fft"],
    }
    dft_launches = {
        "launches": main_path["launches"]["fused_fbank_dft"],
        "launches_sweep": sweep["launches"]["dft"],
        "launches_av_serving": av["launches"]["fused_fbank_dft"],
        "launches_microbatch": av["microbatch"]["launches_dft"],
        "launches_audio_train": audio_train["launches"]["dft"],
    }
    fbank_common = {
        "route": "cuda",
        "bound_note": "bound_ms is the front-end function's own work (pre-emphasis, one "
                      "real FFT a frame, untangle, power, mel sums over nonzero weights, "
                      "DCT), whichever kernel runs it; algorithm_ops_ms is the time of the "
                      "operations this kernel's algorithm does, at the FP32 peak",
        "library_ms": None,
        "library_note": "no single PyTorch call computes framed rDFT power -> mel "
                        "-> log -> DCT; cufft_composite_ms is the plain front-end with "
                        "dft='fft' (torch.fft.rfft, then the mel and DCT products)",
        "shape": [BATCH, int(SECONDS * RATE)],
    }
    fft_source = {"source": "deeplip_tpu_torch/csrc/fbank_fft_kernel.cu", **fbank_common}
    kernels = {"kernels": [{
        "name": "fused_fbank",
        "replaces": "deeplip_tpu/ops/pallas/fbank_kernel.py:241",
        **launches,
        "max_abs_err": kern["max_abs_err"]["fft"],
        "max_abs_err_mel_band0": kern["band0_err"],
        "max_abs_err_audio_train": max(r["max_abs_err"] for r in audio_train["k1_shapes"]),
        "audio_train_note": "launches_audio_train: one a train step plus one an extraction "
                            "batch; audio_train_shapes: K1 at each crop shape of the epochs, "
                            "CMVN after, with its time and the function's bound",
        "audio_train_shapes": audio_train["k1_shapes"],
        "largest_error": kern["worst"],
        "dc_bin_vs_float64": kern["dc_witness"],
        "ms": kern["ms"]["fft"],
        "plain_ms": kern["ms"]["plain"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "algorithm_ops_ms": kern["algorithm_ops_ms"]["fft"],
        "cufft_composite_ms": kern["ms"]["cufft"],
        "dft_kernel_ms": kern["ms"]["dft"],
        "config": "mfcc-24, n_fft 512",
        **fft_source,
    }, {
        # the TPU's v1 kernel serves the configs its v2 kernel refuses; here
        # the FFT kernel serves both, so this entry is that kernel at a v1
        # config (logfbank-60), with the same launch counts
        "name": "fused_fbank_v1_configs",
        "replaces": "deeplip_tpu/ops/pallas/fbank_kernel.py:109",
        **launches,
        "max_abs_err": kern["v1"]["max_abs_err"],
        "ms": kern["v1"]["kernel_ms"],
        "plain_ms": kern["v1"]["plain_ms"],
        "bound_ms": kern["v1"]["bound_ms"],
        "bound_by": kern["v1"]["bound_by"],
        "algorithm_ops_ms": kern["v1"]["algorithm_ops_ms"],
        "config": "logfbank, 60 filters",
        **fft_source,
    }, {
        # both TPU kernels at an n_fft that is not a power of two: the DFT
        # kernel, which no main path launches
        "name": "fused_fbank_dft",
        "replaces": "deeplip_tpu/ops/pallas/fbank_kernel.py:241",
        "also_replaces": "deeplip_tpu/ops/pallas/fbank_kernel.py:109",
        **dft_launches,
        "max_abs_err": kern["max_abs_err"]["dft"],
        "ms": kern["dft_510"]["kernel_ms"],
        "plain_ms": kern["dft_510"]["plain_ms"],
        "bound_ms": kern["dft_510"]["bound_ms"],
        "bound_by": kern["dft_510"]["bound_by"],
        "algorithm_ops_ms": kern["dft_510"]["algorithm_ops_ms"],
        "ms_n_fft_512": kern["ms"]["dft"],
        "bound_ms_n_fft_512": kern["bound_ms"],
        "algorithm_ops_ms_n_fft_512": kern["algorithm_ops_ms"]["dft"],
        "config": "mfcc-24, n_fft 510",
        "source": "deeplip_tpu_torch/csrc/fbank_kernel.cu",
        **fbank_common,
    }, bn_entry("bn_prelu_fwd", "fwd", bn, video), bn_entry("bn_prelu_bwd", "bwd", bn, video),
        pool_entry(pool, av, video)]}
    summary = {
        "card": dev["smi"],
        "peaks_part": part,
        "main_path_emb_err": main_path["emb_err"],
        "main_path_eer": main_path["eer"],
        "lomgrid_trials_per_sec": sweep["trials_per_sec"],
        "lomgrid_sweep_ms": sweep["sweep_ms"],
        "lomgrid_front_end_ms": sweep["front_ms"],
        "lomgrid_front_end_launches": sweep["launches"],
        "lomgrid_tdnn_ms": sweep["tdnn_ms"],
        "lomgrid_tdnn_gflop": sweep["tdnn_gflop"],
        "video_losses": video["losses"],
        "video_batches": video["batches"],
        "video_path_bn_prelu_err": video["path_err"],
        "video_step_ms": step["step_ms"],
        "video_step_walls_ms": step["step_walls"],
        "video_clips_per_sec": step["clips_per_sec"],
        "video_peak_gb": step["peak_gb"],
        "video_bn_prelu_share": step["kernel_share"],
        "video_kernel_vs_plain_loss_rel": step["loss_rel"],
        "video_kernel_vs_plain_stat_distance": step["stat_distance"],
        "video_kernel_vs_plain_grad_distance": step["grad_distance"],
        "video_nudged_plain_grad_distance": step["nudge_distance"],
        "video_k4_alone_grad_distance": step["k4_distance"],
        "video_planted_k3_faults": step["planted_faults"],
        "video_worst_tensor": step["worst_tensor"],
        "video_profiled_wall_ms": step["profiled_wall_ms"],
        "video_profiled_busy_ms": step["profiled_busy_ms"],
        "video_profiled_bn_prelu_ms": step["profiled_bn_prelu_ms"],
        "video_profiled_by_kind_ms": step["profiled_by_kind_ms"],
        "video_launches": video["launches"],
        "av_chunks": av["chunks"],
        "av_launches": av["launches"],
        "av_concat": av["concat"],
        "av_head": av["head"],
        "av_kernel_vs_plain_parts": av["part_err"],
        "av_chunk_split_ms": av["chunk_split_ms"],
        "microbatch": av["microbatch"],
        "audio_train": {k: v for k, v in audio_train.items() if k != "k1_shapes"},
    }
    print(json.dumps(summary), flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
