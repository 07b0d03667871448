"""Batched on-device video transforms for mouth-ROI clips.

Counterpart of ``deeplip_tpu/ops/video.py`` on ``(B, T, H, W)`` uint8
batches: train = random crop (one offset per clip) → horizontal flip
(per clip, probability 0.5) → the two reference Normalize steps folded into
one affine; eval = centre crop → affine. Crop and flip run on the uint8
tensor and the affine comes last (the same values as normalising first,
with less traffic).

The random draws come from an explicit ``torch.Generator`` on the host;
:func:`train_transform_at` takes the offsets and flip flags themselves, on
the host or the device, so a test can hand both packages the same draws and
a grouped train step can read them from its buffers on the card.
"""

from __future__ import annotations

import torch

# statistics of the reference pipeline (dataloaders.py:14-16)
CLIP_MEAN = 0.421
CLIP_STD = 0.165


def rgb_to_gray(frames: torch.Tensor) -> torch.Tensor:
    """``(..., H, W, 3) -> (..., H, W)`` ITU-R BT.601 luma (cv2 RGB2GRAY)."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=frames.dtype, device=frames.device)
    return torch.tensordot(frames, w, dims=([-1], [0]))


def center_crop(clips: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``(..., H, W) -> (..., th, tw)`` centre crop (preprocess.py:74-92)."""
    h, w = clips.shape[-2], clips.shape[-1]
    th, tw = size
    dh = int(round((h - th)) / 2.0)
    dw = int(round((w - tw)) / 2.0)
    return clips[..., dh:dh + th, dw:dw + tw]


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.tensor(x)


def crop_at(clips: torch.Tensor, size: tuple[int, int], dh, dw) -> torch.Tensor:
    """Per-clip crop of ``(B, T, H, W)`` at offsets ``dh[b]``, ``dw[b]``: a
    gather, so offsets that lie on the card are read there (a train step
    captured in a CUDA graph takes them from its input buffers)."""
    th, tw = size
    dev = clips.device
    dh, dw = (_tensor(v).to(dev, non_blocking=True) for v in (dh, dw))
    b = torch.arange(clips.shape[0], device=dev)[:, None, None, None]
    t = torch.arange(clips.shape[1], device=dev)[None, :, None, None]
    rows = (dh[:, None] + torch.arange(th, device=dev))[:, None, :, None]
    cols = (dw[:, None] + torch.arange(tw, device=dev))[:, None, None, :]
    return clips[b, t, rows, cols]


def flip_at(clips: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of the clips where ``flip[b]`` is true."""
    flip = _tensor(flip).to(device=clips.device, dtype=torch.bool, non_blocking=True)
    return torch.where(flip[:, None, None, None], clips.flip(-1), clips)


def crop_offsets(clips: torch.Tensor, size: tuple[int, int],
                 generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """One uniform ``(dh, dw)`` crop offset per clip, drawn on the host."""
    b, _, h, w = clips.shape
    th, tw = size
    dh = torch.randint(0, h - th + 1, (b,), generator=generator)
    dw = torch.randint(0, w - tw + 1, (b,), generator=generator)
    return dh, dw


def flip_flags(b: int, generator: torch.Generator, ratio: float = 0.5) -> torch.Tensor:
    """Per-clip Bernoulli(``ratio``) flip decisions, drawn on the host."""
    return torch.rand((b,), generator=generator) < ratio


def random_crop(clips: torch.Tensor, size: tuple[int, int],
                generator: torch.Generator) -> torch.Tensor:
    """Per-clip random crop of ``(B, T, H, W)`` (preprocess.py:95-117)."""
    return crop_at(clips, size, *crop_offsets(clips, size, generator))


def horizontal_flip(clips: torch.Tensor, generator: torch.Generator,
                    ratio: float = 0.5) -> torch.Tensor:
    """Per-clip Bernoulli horizontal flip (preprocess.py:120-138)."""
    return flip_at(clips, flip_flags(clips.shape[0], generator, ratio))


def normalize_pixels(clips: torch.Tensor, mean: float = CLIP_MEAN,
                     std: float = CLIP_STD) -> torch.Tensor:
    """uint8 [0, 255] → ((x / 255) - mean) / std in f32."""
    x = clips.to(torch.float32) / 255.0
    return (x - mean) / std


def train_transform_at(clips: torch.Tensor, dh, dw, flip: torch.Tensor,
                       size: tuple[int, int] = (88, 88), mean: float = CLIP_MEAN,
                       std: float = CLIP_STD) -> torch.Tensor:
    """The train pipeline with given crop offsets and flip flags."""
    return normalize_pixels(flip_at(crop_at(clips, size, dh, dw), flip), mean, std)


def train_transform(clips: torch.Tensor, generator: torch.Generator,
                    size: tuple[int, int] = (88, 88), mean: float = CLIP_MEAN,
                    std: float = CLIP_STD) -> torch.Tensor:
    """Full train pipeline on a ``(B, T, H, W)`` uint8 batch → f32."""
    dh, dw = crop_offsets(clips, size, generator)
    flip = flip_flags(clips.shape[0], generator)
    return train_transform_at(clips, dh, dw, flip, size, mean, std)


def eval_transform(clips: torch.Tensor, size: tuple[int, int] = (88, 88),
                   mean: float = CLIP_MEAN, std: float = CLIP_STD) -> torch.Tensor:
    """Centre-crop eval pipeline; crop before the affine."""
    return normalize_pixels(center_crop(clips, size), mean, std)


def mask_pad_frames(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Zero transformed frames at positions ``>= length``.

    Bucketed batches pad clips with uint8 zeros before the affine, which
    would leave pad frames at ``(0/255 - mean)/std ≈ -2.55``; the reference
    pads with zeros after its transforms. Zeroing here restores that, and a
    zeroed pad frame contributes exactly what the frontend conv's own zero
    padding would. ``lengths == 0`` rows are left whole.
    """
    t = x.shape[1]
    eff = torch.where(lengths > 0, lengths, torch.full_like(lengths, t))
    mask = (torch.arange(t, device=x.device)[None, :] < eff[:, None]).to(x.dtype)
    return x * mask.reshape(mask.shape + (1,) * (x.ndim - 2))


def add_noise_snr(signal: torch.Tensor, noise: torch.Tensor, snr_db: float) -> torch.Tensor:
    """SNR-targeted additive noise for raw audio (the reference's
    ``preprocess.py:150-179``, defined there but unused)."""
    sig_power = (signal ** 2).mean(dim=-1, keepdim=True)
    noise_power = torch.clamp((noise ** 2).mean(dim=-1, keepdim=True), min=1e-12)
    factor = (sig_power / noise_power) / (10.0 ** (snr_db / 10.0))
    return signal + noise * torch.sqrt(factor)


def normalize_utterance(signal: torch.Tensor) -> torch.Tensor:
    """Per-utterance audio z-norm (population std; a silent row keeps std 1)."""
    std = signal.std(dim=-1, keepdim=True, unbiased=False)
    std = torch.where(std == 0, torch.ones_like(std), std)
    return (signal - signal.mean(dim=-1, keepdim=True)) / std
