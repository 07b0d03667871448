"""The one traffic generator: every cell's inputs, made on the device from
the run's seed and the parameters of ``traffic/<traffic>.json``.

Three kinds of traffic, one for each driver, each a function of its
parameters:

- for ``audio_score`` (a closed loop over trial lists): a pool of voiced PCM
  utterances (:func:`voiced_pcm`); each list draws ``utterances`` distinct
  ones from it, and every list is scored with the same ``trials`` pairs.
- for ``audio_train`` (back-to-back train steps): a pool of longer voiced
  utterances, each with a speaker label; step ``i`` crops ``batch`` rows of
  the ``i``-th length of a fixed cycle through the crop buckets, each row
  from a distinct utterance at a seeded offset.
- for ``video_train`` (back-to-back train steps): a pool of uint8 clips
  (:func:`clips_u8`) with labels; step ``i`` takes ``batch`` distinct ones.

Every seed gets the same sizes and lengths in the same order; the seed
changes only what the samples hold and which rows a step takes.
"""

from __future__ import annotations

import math

import torch

CHUNK = 256   # utterances or clips made per call


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def voiced_pcm(n: int, samples: int, voice: dict, gen: torch.Generator, device) -> torch.Tensor:
    """``(n, samples)`` int16 voiced sounds: per utterance a pitch drawn from
    ``f0``, ``harmonics`` partials of random amplitude (falling as 1/h) and
    phase, a syllable-rate envelope, white noise at ``noise`` of the
    signal's scale and a peak drawn from ``peak``."""
    rate = float(voice["rate"])
    h = int(voice["harmonics"])
    out = torch.empty((n, samples), dtype=torch.int16, device=device)
    t = torch.arange(samples, device=device, dtype=torch.float32) / rate
    harm = torch.arange(1, h + 1, device=device, dtype=torch.float32)
    for lo in range(0, n, CHUNK):
        m = min(CHUNK, n - lo)
        u = torch.rand((m, 2 * h + 5), generator=gen, device=device)
        f0 = voice["f0"][0] + (voice["f0"][1] - voice["f0"][0]) * u[:, :1]
        amp = u[:, 1:h + 1] / harm
        phase = 2 * math.pi * u[:, h + 1:2 * h + 1]
        syll = 2.0 + 4.0 * u[:, 2 * h + 1:2 * h + 2]
        psi = 2 * math.pi * u[:, 2 * h + 2:2 * h + 3]
        peak = voice["peak"][0] + (voice["peak"][1] - voice["peak"][0]) * u[:, 2 * h + 3:2 * h + 4]
        wave = torch.zeros((m, samples), device=device)
        for k in range(h):
            wave += amp[:, k:k + 1] * torch.sin(2 * math.pi * harm[k] * f0 * t + phase[:, k:k + 1])
        wave *= 0.6 + 0.4 * torch.sin(2 * math.pi * syll * t + psi)
        wave += float(voice["noise"]) * torch.randn((m, samples), generator=gen, device=device)
        wave *= peak / wave.abs().amax(dim=1, keepdim=True).clamp(min=1e-6)
        out[lo:lo + m] = wave.round().clamp(-32768, 32767).to(torch.int16)
    return out


def clips_u8(n: int, frames: int, height: int, width: int, gen: torch.Generator,
             device) -> torch.Tensor:
    """``(n, frames, height, width)`` uint8 clips: a coarse random image per
    clip that drifts over the frames, upsampled, with pixel noise."""
    out = torch.empty((n, frames, height, width), dtype=torch.uint8, device=device)
    coarse = (height // 8, width // 8)
    for lo in range(0, n, CHUNK):
        m = min(CHUNK, n - lo)
        base = torch.rand((m, 1) + coarse, generator=gen, device=device)
        drift = torch.rand((m, frames) + coarse, generator=gen, device=device)
        low = 0.8 * base + 0.2 * drift
        img = torch.nn.functional.interpolate(low, size=(height, width), mode="bilinear",
                                              align_corners=False)
        img += 0.05 * torch.randn((m, frames, height, width), generator=gen, device=device)
        out[lo:lo + m] = (img.clamp(0, 1) * 255).round().to(torch.uint8)
    return out


def distinct_rows(steps: int, batch: int, pool: int, gen: torch.Generator,
                  device) -> torch.Tensor:
    """``(steps, batch)`` int64: for each step ``batch`` distinct pool rows."""
    out = torch.empty((steps, batch), dtype=torch.int64, device=device)
    for lo in range(0, steps, CHUNK):
        m = min(CHUNK, steps - lo)
        keys = torch.rand((m, pool), generator=gen, device=device)
        out[lo:lo + m] = keys.argsort(dim=1)[:, :batch]
    return out


def frame_buckets(lo: int, hi: int, n_buckets: int) -> list[int]:
    """The crop lengths in frames: ``n_buckets`` evenly spaced over [lo, hi],
    rounded (the training sampler's grid)."""
    return sorted({int(round(lo + (hi - lo) * i / (n_buckets - 1))) for i in range(n_buckets)})


def samples_for_frames(n_frames: int, win_len: float, win_shift: float, rate: int) -> int:
    """PCM samples that give exactly ``n_frames`` frames."""
    return int(((n_frames - 1) * win_shift + win_len) * rate)


def crop_lengths(traffic: dict) -> list[int]:
    """The crop cycle: every bucket once, shortest first, as samples."""
    frames = frame_buckets(*traffic["frames"], traffic["buckets"])
    return [samples_for_frames(f, traffic["win_len"], traffic["win_shift"], traffic["rate"])
            for f in frames]


def crop_batch(pool: torch.Tensor, rows: torch.Tensor, offsets_u: torch.Tensor,
               samples: int) -> torch.Tensor:
    """Rows of ``pool`` cut to ``samples`` at offsets ``u * (L - samples)``
    (``u`` uniform in [0, 1)), one gather on the device."""
    span = pool.shape[1] - samples + 1
    start = (offsets_u * span).long().clamp(max=span - 1)
    cols = start[:, None] + torch.arange(samples, device=pool.device)
    return pool[rows[:, None], cols]
