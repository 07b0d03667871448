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
3. Each kernel against its plain PyTorch version on the card, TF32 off:
   the fused front-end at mfcc-24 (energy on and off), fbank-24 and
   logfbank-60, 24/200/203/299/331 frames, four configs at other rates and
   FFT sizes, and one 256 x 3 s batch, within
   atol 2e-4 / rtol 1e-3. Kernel and plain times by CUDA events at that
   batch, beside the least time the card could take, and the kernel's time
   at 257 bins against 256 (a 510-point FFT) at that batch.
4. The main path through the user's entry points at the flagship E-TDNN
   width (seeded random weights, BN statistics calibrated on one batch
   and then perturbed): a ragged
   PCM16 wav corpus → ``EvalUtteranceSet`` (``eval_set_kwargs`` defaults,
   batch 64) → ``AudioExtractor.extract_embeddings`` → ``cosine_eer``. Launch
   counts are zeroed just before and read just after. Two batches are
   re-embedded with the plain front-end and must agree to 1e-4.
5. A first number for the lomgrid sweep shape: 3,541 x 3 s int16
   utterances staged on the card, batch 256, 20,000 gathered cosine trials,
   by CUDA events after a warm-up sweep.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the ``kernels`` JSON record.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from deeplip_tpu_torch.core.config import AUDIO_DATA_OPTS, ETDNN_MODEL_OPTS, Config  # noqa: E402
from deeplip_tpu_torch.data.audio_io import write_wav  # noqa: E402
from deeplip_tpu_torch.data.audio_pipeline import (EvalUtterance,  # noqa: E402
                                                   EvalUtteranceSet,
                                                   eval_set_kwargs)
from deeplip_tpu_torch.eval.scoring import cosine_scores  # noqa: E402
from deeplip_tpu_torch.ops import features as F  # noqa: E402
from deeplip_tpu_torch.ops import spectral  # noqa: E402
from deeplip_tpu_torch.ops.cuda import build, fbank  # noqa: E402
from deeplip_tpu_torch.ops.cuda.fbank import (audio_features,  # noqa: E402
                                              audio_features_reference)
from deeplip_tpu_torch.ops.framing import (num_frames, preemphasis,  # noqa: E402
                                           samples_for_frames)
from deeplip_tpu_torch.train.audio import AudioExtractor, fp32_math, masked_cmvn  # noqa: E402

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


def front_end_work(b: int, s: int, cfg: F.FeatureConfig) -> tuple[float, float]:
    """``(flops, bytes)`` the fused front-end needs for a ``(b, s)`` batch,
    counted from the config's own constants: the DFT against the basis
    columns that are not zero (the sine columns at DC and at Nyquist are,
    up to rounding), the power, the mel sums over the filterbank's nonzero
    weights (triangles: each bin sits in at most two filters) and, for
    MFCC, the energy sum, the DCT and the lifter. Bytes: PCM in, features
    out and the nonzero constants, each moved once."""
    t = num_frames(s, cfg.frame_len, cfg.frame_step)
    k = cfg.n_fft // 2 + 1
    basis = spectral.rdft_fused_matrix(cfg.frame_len, cfg.n_fft)
    cols = int(np.count_nonzero(np.abs(basis).max(axis=0) > 1e-6))
    mel_nnz = int(np.count_nonzero(spectral.mel_filterbank(
        cfg.num_bin, cfg.n_fft, cfg.rate, cfg.low_freq, cfg.high_freq)))
    per_frame = 2 * cfg.frame_len * cols + 3 * k + 2 * mel_nnz
    consts = cfg.frame_len * cols + mel_nnz
    d = cfg.num_bin
    if cfg.feat_type == "mfcc":
        per_frame += 2 * cfg.num_bin * cfg.num_cep + cfg.num_cep + (k if cfg.energy else 0)
        consts += cfg.num_bin * cfg.num_cep + cfg.num_cep
        d = cfg.num_cep
    return float(b * t * per_frame), float(4 * (b * s + b * t * d + consts))


@contextlib.contextmanager
def plain_front_end():
    """Route ``extract_features``' mel front-end through the kernel's plain
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
# multiples of 4 (22.05 kHz), a small FFT (8 kHz), a 2048-point frame whose
# shared memory takes the kernel's 8-frame tile, and a 510-point FFT whose
# 256 bins leave no leftover bin for the kernel's split pass
OTHER_CONFIGS = [
    ("mfcc", {"rate": 22050, "n_fft": 1024, "num_bin": 40, "num_cep": 13}),
    ("logfbank", {"rate": 8000, "n_fft": 256, "num_bin": 23}),
    ("fbank", {"n_fft": 2048, "num_bin": 40, "win_len": 0.128}),
    ("mfcc", {"n_fft": 510}),
]
OTHER_FRAMES = [24, 203]


def kernel_phase(peaks) -> dict:
    rng = np.random.default_rng(0)
    max_err = 0.0
    cases = ([(c, KERNEL_FRAMES) for c in KERNEL_CONFIGS]
             + [(c, OTHER_FRAMES) for c in OTHER_CONFIGS])
    with fp32_math():
        for (feat_type, kw), frame_counts in cases:
            cfg = F.FeatureConfig(feat_type=feat_type, normalize=False, **kw)
            for frames in frame_counts:
                n = samples_for_frames(frames, cfg.win_len, cfg.win_shift, cfg.rate)
                x = torch.from_numpy((rng.standard_normal((3, n)) * 0.1).astype(np.float32))
                emph = preemphasis(x.cuda(), cfg.preemph).contiguous()
                got = audio_features(emph, cfg)
                check(got.shape[1] == frames, f"{feat_type}: {got.shape[1]} != {frames} frames")
                err = compare(got, audio_features_reference(emph, cfg),
                              f"{feat_type} {kw} {frames} frames")
                max_err = max(max_err, err)
        log(f"kernel vs plain: {sum(len(f) for _, f in cases)} cases, "
            f"max abs err {max_err:.3e}")

        cfg = dataclasses.replace(F.FeatureConfig.from_config(AUDIO_DATA_OPTS),
                                  normalize=False)
        s = int(SECONDS * RATE)
        pcm = torch.from_numpy(rng.integers(-8000, 8000, (BATCH, s), dtype=np.int16))
        emph = preemphasis(pcm.cuda().float() / 32768.0, cfg.preemph).contiguous()
        got = audio_features(emph, cfg)
        want = audio_features_reference(emph, cfg)
        err = compare(got, want, f"lomgrid batch {BATCH}x{s}")
        max_err = max(max_err, err)
        torch.cuda.synchronize()
        kernel = lambda: audio_features(emph, cfg)
        plain = lambda: audio_features_reference(emph, cfg)
        times = [time_ms(plain), time_ms(kernel), time_ms(kernel), time_ms(plain)]
        # the cost of the 257th bin: the same batch at a 510-point FFT has
        # 256 bins, one per thread, and no leftover pass
        cfg256 = dataclasses.replace(cfg, n_fft=510)
        max_err = max(max_err, compare(audio_features(emph, cfg256),
                                       audio_features_reference(emph, cfg256),
                                       f"lomgrid batch {BATCH}x{s}, 256 bins"))
        k256 = lambda: audio_features(emph, cfg256)
        bins_ms = [time_ms(kernel), time_ms(k256), time_ms(k256), time_ms(kernel)]
    kernel_ms = (times[1] + times[2]) / 2
    plain_ms = (times[0] + times[3]) / 2
    ms257, ms256 = (bins_ms[0] + bins_ms[3]) / 2, (bins_ms[1] + bins_ms[2]) / 2
    log(f"257 bins vs 256 bins: {ms257:.4f} ms vs {ms256:.4f} ms "
        f"(257, 256, 256, 257: {', '.join(f'{t:.4f}' for t in bins_ms)}); "
        f"ratio {ms257 / ms256:.4f}, {257 / 256:.4f} for the work alone")
    flops, nbytes = front_end_work(BATCH, s, cfg)
    fp32, tf32, bw = peaks
    ops_ms, bytes_ms = flops / fp32 * 1e3, nbytes / bw * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    tf32_bound_ms = max(flops / tf32 * 1e3, bytes_ms)
    log(f"lomgrid batch {BATCH}x{s}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"(plain, kernel, kernel, plain: {', '.join(f'{t:.4f}' for t in times)}); "
        f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; bound {bound_ms:.4f} ms "
        f"FP32 ({tf32_bound_ms:.4f} ms TF32); kernel at "
        f"{flops / kernel_ms / 1e9:.2f} TFLOP/s, {bound_ms / kernel_ms:.1%} of the FP32 bound")
    return {"max_abs_err": max_err, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "tf32_bound_ms": tf32_bound_ms, "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            "ms_257_bins": ms257, "ms_256_bins": ms256}


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


def write_corpus(root: str, n_spk: int = 16, per_spk: int = 16,
                 n_trials: int = 4000, seed: int = 0) -> tuple[list[str], str]:
    """Ragged 1–3 s PCM16 wavs: each speaker a harmonic source at its own
    pitch through its own resonance, plus noise; and a half-target trial
    list over them."""
    rng = np.random.default_rng(seed)
    names = []
    for spk in range(n_spk):
        f0 = 90.0 + 12.0 * spk
        res = 400.0 + 150.0 * spk
        os.makedirs(os.path.join(root, f"s{spk:02d}"), exist_ok=True)
        for u in range(per_spk):
            n = int(rng.integers(RATE, 3 * RATE + 1))
            t = np.arange(n) / RATE
            f = f0 * (1.0 + 0.03 * rng.standard_normal())
            y = sum(np.sin(2 * np.pi * h * f * t) / h
                    * np.exp(-((h * f - res) / 600.0) ** 2) for h in range(1, 20))
            y = 0.3 * y / np.abs(y).max() + 0.02 * rng.standard_normal(n)
            name = f"s{spk:02d}/u{u:02d}.wav"
            write_wav(os.path.join(root, name), y.astype(np.float32), RATE)
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

        audio_features.launches = 0
        t0 = time.perf_counter()
        store = extractor.extract_embeddings(eval_set)
        eer, threshold = extractor.evaluate(trial_path, store)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fused_fbank": audio_features.launches}

    check(launches["fused_fbank"] == len(host_batches),
          f"front-end kernel launched {launches['fused_fbank']} times for "
          f"{len(host_batches)} batches")
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

    audio_features.launches = 0
    scores = sweep()
    launches = audio_features.launches
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
        f"{tps:.1f} trials/s; {launches} front-end launches per sweep; per batch: "
        f"front-end (pre-emphasis, mask, kernel) {front_ms:.3f} ms, TDNN {tdnn_ms:.3f} ms")
    return {"trials_per_sec": tps, "sweep_ms": ms, "front_ms": front_ms, "tdnn_ms": tdnn_ms,
            "tdnn_gflop": flops / 1e9}


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
    kernels = {"kernels": [{
        "name": "fused_fbank",
        "route": "cuda",
        "source": "deeplip_tpu_torch/csrc/fbank_kernel.cu",
        "replaces": "deeplip_tpu/ops/pallas/fbank_kernel.py:241",
        "also_replaces": "deeplip_tpu/ops/pallas/fbank_kernel.py:109",
        "launches": main_path["launches"]["fused_fbank"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["kernel_ms"],
        "kernel_ms": kern["kernel_ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "tf32_bound_ms": kern["tf32_bound_ms"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes framed rDFT power -> mel "
                        "-> log -> DCT; torch.stft needs a window, centring and a "
                        "separate mel/DCT",
        "shape": [BATCH, int(SECONDS * RATE)],
    }]}
    summary = {
        "card": dev["smi"],
        "peaks_part": part,
        "main_path_emb_err": main_path["emb_err"],
        "main_path_eer": main_path["eer"],
        "lomgrid_trials_per_sec": sweep["trials_per_sec"],
        "lomgrid_sweep_ms": sweep["sweep_ms"],
        "lomgrid_front_end_ms": sweep["front_ms"],
        "lomgrid_tdnn_ms": sweep["tdnn_ms"],
        "lomgrid_tdnn_gflop": sweep["tdnn_gflop"],
    }
    print(json.dumps(summary), flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
