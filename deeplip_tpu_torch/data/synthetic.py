"""Synthetic corpora for tests, demos and benchmarks.

A copy of ``deeplip_tpu/data/synthetic.py`` on the port's ``audio_io`` and
``manifest``, so both packages write the same files for the same seed:
speaker-discriminable audio (per-speaker formant-like tone stacks and
noise), a hard variant for convergence studies, mouth-ROI-like video clips
(per-speaker moving blobs) and GRID-style trial lists.
"""

from __future__ import annotations

import os

import numpy as np

from deeplip_tpu_torch.data.audio_io import write_wav
from deeplip_tpu_torch.data.manifest import SpeakerManifest, Utterance, write_manifest


def synth_utterance(
    rng: np.random.Generator, speaker_seed: int, duration: float, rate: int = 16000
) -> np.ndarray:
    """Speaker-colored audio: fixed per-speaker resonances + shaped noise."""
    srng = np.random.default_rng(speaker_seed)
    freqs = srng.uniform(200.0, 3500.0, size=4)
    amps = srng.uniform(0.5, 1.0, size=4)
    n = int(duration * rate)
    t = np.arange(n) / rate
    phase = rng.uniform(0, 2 * np.pi, size=4)
    vibrato = 1.0 + 0.02 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
    sig = sum(a * np.sin(2 * np.pi * f * t * vibrato + p) for f, a, p in zip(freqs, amps, phase))
    sig = sig + 0.3 * rng.standard_normal(n)
    sig = 0.3 * sig / np.max(np.abs(sig))
    return sig.astype(np.float32)


def make_audio_corpus(
    root: str,
    n_spk: int = 4,
    utts_per_spk: int = 3,
    duration: float = 3.0,
    rate: int = 16000,
    seed: int = 0,
) -> tuple[str, SpeakerManifest]:
    """Write wavs + manifest CSV under ``root``; returns (manifest_path, manifest)."""
    rng = np.random.default_rng(seed)
    speakers = []
    for s in range(n_spk):
        spk_dir = os.path.join(root, f"s{s:02d}")
        os.makedirs(spk_dir, exist_ok=True)
        utts = []
        for u in range(utts_per_spk):
            dur = duration * rng.uniform(0.8, 1.2)
            y = synth_utterance(rng, speaker_seed=1000 + s, duration=dur, rate=rate)
            path = os.path.join(spk_dir, f"u{u}.wav")
            write_wav(path, y, rate)
            utts.append(Utterance(path, len(y) / rate, rate))
        speakers.append(utts)
    manifest_path = os.path.join(root, "manifest.csv")
    write_manifest(manifest_path, speakers)
    return manifest_path, SpeakerManifest(speakers)


def make_trial_list(
    path: str,
    manifest: SpeakerManifest,
    n_trials: int = 200,
    seed: int = 0,
    balance: float | None = None,
) -> None:
    """GRID-style trial file ``<label> <spk/utt.wav> <spk/utt.wav>`` (the
    reference's ``database/trial_grid_v1.txt`` format).

    ``balance`` forces that fraction of trials to be target (same-speaker)
    pairs, matching the roughly balanced composition of the reference's
    released 20k-trial protocols; ``None`` samples pairs uniformly.
    """
    rng = np.random.default_rng(seed)
    utts = manifest.all_utterances()
    by_spk: dict[int, list] = {}
    for s, u in utts:
        by_spk.setdefault(s, []).append(u)

    def rel(u):
        return "/".join(u.path.split(os.sep)[-2:])

    with open(path, "w") as f:
        for i in range(n_trials):
            if balance is not None and rng.uniform() < balance:
                s = int(rng.integers(len(by_spk)))
                pool = by_spk[s]
                u1, u2 = pool[rng.integers(len(pool))], pool[rng.integers(len(pool))]
                f.write(f"1 {rel(u1)} {rel(u2)}\n")
            else:
                (s1, u1), (s2, u2) = (
                    utts[rng.integers(len(utts))],
                    utts[rng.integers(len(utts))],
                )
                f.write(f"{int(s1 == s2)} {rel(u1)} {rel(u2)}\n")


def synth_video_clip(
    rng: np.random.Generator, speaker_seed: int, t: int = 12, size: int = 96
) -> np.ndarray:
    """Speaker-distinct (T, H, W) uint8 clip: a moving gaussian 'mouth'."""
    srng = np.random.default_rng(speaker_seed)
    cx, cy = srng.uniform(0.35, 0.65, 2) * size
    sx, sy = srng.uniform(6, 14, 2)
    yy, xx = np.mgrid[0:size, 0:size]
    frames = np.empty((t, size, size), np.uint8)
    for i in range(t):
        wob = 2.0 * np.sin(2 * np.pi * i / t + rng.uniform(0, 2 * np.pi))
        blob = np.exp(
            -(((xx - cx - wob) / sx) ** 2 + ((yy - cy + wob) / sy) ** 2)
        )
        noise = 0.1 * rng.standard_normal((size, size))
        frames[i] = np.clip((blob + noise) * 255, 0, 255).astype(np.uint8)
    return frames


def make_video_corpus(
    root: str, n_spk: int = 3, clips_per_spk: int = 2, t: int = 12, size: int = 96, seed: int = 0
) -> list[tuple[str, int]]:
    """Write npz mouth-ROI clips in the reference's layout
    (``<root>/<speaker>/<clip>.npz`` with key 'data'); returns (path, label)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n_spk):
        spk_dir = os.path.join(root, f"spk{s:02d}")
        os.makedirs(spk_dir, exist_ok=True)
        for c in range(clips_per_spk):
            clip = synth_video_clip(rng, speaker_seed=2000 + s, t=t, size=size)
            path = os.path.join(spk_dir, f"clip{c}.npz")
            np.savez(path, data=clip)
            out.append((path, s))
    return out


def synth_hard_utterance(
    rng: np.random.Generator,
    speaker_seed: int,
    duration: float,
    rate: int = 16000,
    separation: float = 0.06,
    noise: float = 1.0,
) -> np.ndarray:
    """Deliberately HARD speaker-colored audio for convergence studies.

    All speakers share one global resonance stack; a speaker only perturbs
    the frequencies/amplitudes by ``separation`` (relative) and the noise
    floor is strong, so cosine EER lands in a meaningful single-digit to
    tens-of-percent band instead of the trivially separable 0% of
    :func:`synth_utterance` (a 0.00% EER proves nothing about training
    equivalence)."""
    grng = np.random.default_rng(777)  # shared across all speakers
    base_freqs = grng.uniform(200.0, 3500.0, size=6)
    base_amps = grng.uniform(0.5, 1.0, size=6)
    srng = np.random.default_rng(speaker_seed)
    freqs = base_freqs * (1.0 + separation * srng.standard_normal(6))
    amps = np.clip(base_amps * (1.0 + separation * srng.standard_normal(6)),
                   0.1, None)
    n = int(duration * rate)
    t = np.arange(n) / rate
    phase = rng.uniform(0, 2 * np.pi, size=6)
    vibrato = 1.0 + 0.02 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
    sig = sum(a * np.sin(2 * np.pi * f * t * vibrato + p)
              for f, a, p in zip(freqs, amps, phase))
    sig = sig + noise * rng.standard_normal(n)
    sig = 0.3 * sig / np.max(np.abs(sig))
    return sig.astype(np.float32)


def make_hard_audio_corpus(
    root: str,
    n_spk: int = 12,
    utts_per_spk: int = 8,
    duration: float = 2.5,
    rate: int = 16000,
    seed: int = 0,
    separation: float = 0.06,
    noise: float = 1.0,
) -> tuple[str, SpeakerManifest]:
    """Hard-corpus variant of :func:`make_audio_corpus` (same layout)."""
    rng = np.random.default_rng(seed)
    speakers = []
    for s in range(n_spk):
        spk_dir = os.path.join(root, f"s{s:02d}")
        os.makedirs(spk_dir, exist_ok=True)
        utts = []
        for u in range(utts_per_spk):
            dur = duration * rng.uniform(0.8, 1.2)
            y = synth_hard_utterance(rng, speaker_seed=1000 + s, duration=dur,
                                     rate=rate, separation=separation,
                                     noise=noise)
            path = os.path.join(spk_dir, f"u{u}.wav")
            write_wav(path, y, rate)
            utts.append(Utterance(path, len(y) / rate, rate))
        speakers.append(utts)
    manifest_path = os.path.join(root, "manifest.csv")
    write_manifest(manifest_path, speakers)
    return manifest_path, SpeakerManifest(speakers)
