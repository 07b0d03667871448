"""Plain PyTorch reference of the ``deeplip-av-lowfer`` configuration.

DeepLip's audio-visual system (Liu et al., "DeepLip: A Benchmark for Deep
Learning-Based Audio-Visual Lip Biometrics", ASRU 2021) as its
``conf/fusion_config.yaml`` trains it, written from the description and
independent of the program:

- audio: the MFCC-24 front-end of ``etdnn_vox12.py``, CMVN over the whole
  crop, and the E-TDNN x-vector in eval mode (batch norms on their running
  statistics): ten TDNN blocks, mean and std pooling, fc1 → BN →
  LeakyReLU(0.2) → fc2;
- video, per clip slot: the centre crop, ``(x / 255 − 0.421) / 0.165``,
  frames at or past the clip's length zeroed; the Lipreading frame path of
  ``lipreading_resnet18_tcn.py`` in eval mode (the frontend Conv3d → BN →
  PReLU → max-pool, the ResNet-18 trunk, the spatial mean per frame); the
  mean over each clip's real frames, then over each item's real clips (an
  item with no clip gives zeros);
- LowFER (Amin et al., "LowFER: Low-rank Bilinear Pooling for Link
  Prediction", ICML 2020) as DeepLip's ``models/fusion_models/LBP.py``
  computes it: the low-rank bilinear vector is computed and then
  overwritten, so the output is ``[e1, σ(e2), σ(e2) ⊙ e1]`` (1,536 wide for
  512-wide inputs) and ``U``, ``V`` never reach it. A departure from the
  published LowFER, kept because it is what the system ships; ``U`` and
  ``V`` stay in the state dict;
- a linear classifier, cross-entropy over the rows with at least one clip
  (the sum over them divided by their count);
- SGD with momentum 0.9 and coupled weight decay (``g + wd·p`` into the
  buffer, ``p -= lr · buf``) over the classifier: the encoders are frozen,
  and at equal widths no LowFER parameter has a gradient.

Every float32 product runs without TF32; ``precision="tf32"`` runs them in
TF32, the control one precision down. The video tower runs in blocks of
clips. It imports nothing of the program. Tensor names follow the
program's (``audio_model.``, ``video_model.``, ``fusion_head.``,
``criterion.``), so the benchmark loads both with one set of weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference import etdnn_vox12 as RA
from perfbench.reference import lipreading_resnet18_tcn as RV

BLOCK = 32   # clips a block of the video tower


class AudioEncoder(RA.ETDNN):
    """The E-TDNN without a margin criterion (fusion trains its own)."""

    def __init__(self, model: dict, input_dim: int):
        super().__init__(model, input_dim, 1)
        del self.criterion


class LowFER(nn.Module):
    def __init__(self, d1: int, d2: int, k: int, o: int):
        super().__init__()
        self.U = nn.Parameter(torch.zeros(d1, k * o))
        self.V = nn.Parameter(torch.zeros(d2, k * o))

    def forward(self, e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
        gate = torch.sigmoid(e2)
        return torch.cat([e1, gate, gate * e1], dim=-1)


class AVSystem(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        model, classes = config["model"], int(config["num_classes"])
        audio = model["audio_config"]
        emb = int(audio[audio["arch"]]["embedding_dim"])
        feat = RA.feature_settings(config)
        self.audio_model = AudioEncoder(audio, int(feat["num_cep"]))
        self.video_model = RV.Lipreading(model["video_config"]["tcn"], classes,
                                         int(config["video_hidden_dim"]))
        video = 512
        self.fusion_head = LowFER(emb, video, int(config["lowfer_k"]), emb)
        self.criterion = nn.Module()
        self.criterion.fc = nn.Linear(3 * emb, classes)


def build(config: dict) -> AVSystem:
    return AVSystem(config)


# ------------------------------------------------------------------ eval mode
def bn_eval(bn: RA.BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Batch norm over the last axis on its running statistics."""
    return (x - bn.running_mean) * torch.rsqrt(bn.running_var + 1e-5) * bn.weight + bn.bias


def block_eval(blk: RV.BasicBlock, x: torch.Tensor) -> torch.Tensor:
    out = blk.relu1(bn_eval(blk.bn1, blk.conv1(x, False)))
    out = bn_eval(blk.bn2, blk.conv2(out, False))
    res = x
    if blk.downsample is not None:
        res = bn_eval(blk.downsample[1], blk.downsample[0](x, False))
    return blk.relu2(out + res)


def frame_features(video: RV.Lipreading, x: torch.Tensor) -> torch.Tensor:
    """``(N, T, H, W)`` frames → ``(N, T, 512)`` per-frame embeddings."""
    n, t = x.shape[:2]
    conv, bn, act = video.frontend3D
    y = act(bn_eval(bn, conv(x[..., None], False)))
    y = F.max_pool3d(y.movedim(-1, 1), (1, 3, 3), (1, 2, 2), (0, 1, 1)).movedim(1, -1)
    y = y.reshape((n * t,) + y.shape[2:])
    for stage in range(1, 5):
        for blk in getattr(video.trunk, f"layer{stage}"):
            y = block_eval(blk, y)
    return y.mean(dim=(1, 2)).reshape(n, t, -1)


def eval_frames(clips_u8: torch.Tensor, lengths: torch.Tensor, crop: int) -> torch.Tensor:
    """``(N, T, H, W)`` uint8 → centre-cropped, normalised float32 frames,
    those at or past each clip's length zeroed."""
    h, w = clips_u8.shape[-2:]
    dh, dw = (h - crop) // 2, (w - crop) // 2
    x = (clips_u8[..., dh:dh + crop, dw:dw + crop].float() / 255.0 - RV.MEAN) / RV.STD
    real = torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None]
    return x * real[:, :, None, None].to(x.dtype)


def masked_mean(x: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """``(B, L, D)`` → the mean over each row's first ``counts`` entries;
    zeros for a row of none."""
    real = (torch.arange(x.shape[1], device=x.device)[None, :] < counts[:, None]).to(x.dtype)
    return (x * real[..., None]).sum(1) / real.sum(1, keepdim=True).clamp(min=1.0)


@torch.no_grad()
def embed(system: AVSystem, pcm: torch.Tensor, clips_u8: torch.Tensor,
          clip_lengths: torch.Tensor, group_sizes: torch.Tensor, config: dict):
    """Audio x-vectors ``(B, 512)`` of float PCM crops and video group means
    ``(B, 512)`` of ``(B, G, T, H, W)`` uint8 clip groups, in the caller's
    arithmetic."""
    feats = RA.cmvn(RA.mfcc(pcm, RA.feature_settings(config)))
    xv = system.audio_model.xvector(feats, train=False)
    b, g, t = clips_u8.shape[:3]
    clips = clips_u8.reshape((b * g, t) + clips_u8.shape[3:])
    lengths = clip_lengths.reshape(b * g)
    dtype = system.criterion.fc.weight.dtype
    per_clip = []
    for lo in range(0, b * g, BLOCK):
        x = eval_frames(clips[lo:lo + BLOCK], lengths[lo:lo + BLOCK], int(config["crop"]))
        feats_v = frame_features(system.video_model, x.to(dtype))
        per_clip.append(masked_mean(feats_v, lengths[lo:lo + BLOCK]))
    em = masked_mean(torch.cat(per_clip).reshape(b, g, -1), group_sizes)
    return xv, em


def loss_of(system: AVSystem, xv, em, group_sizes, labels) -> torch.Tensor:
    """LowFER, the classifier and the cross-entropy over the rows with clips."""
    logits = system.criterion.fc(system.fusion_head(xv, em))
    per = F.cross_entropy(logits, labels.long(), reduction="none")
    valid = (group_sizes > 0).to(per.dtype)
    return (per * valid).sum() / valid.sum().clamp(min=1.0)


def train_steps(system: AVSystem, batches, config: dict, precision: str,
                keep: int | None = None) -> dict:
    """SGD steps of the recipe over ``batches`` (``(float PCM, uint8 clips,
    clip lengths, group sizes, labels)``); returns each step's loss, the
    first gradient as the optimizer took it (``g + wd·p`` of step 1) and
    each classifier leaf's change, and the first batch's embeddings
    (``audio_emb``, ``video_emb``). With ``keep``, each step takes only its
    first ``keep`` rows (the half-batch fault)."""
    sgd = config["train"]["sgd"]
    lr, mom, wd = float(sgd["init_lr"]), float(sgd["momentum"]), float(sgd["weight_decay"])
    params = {f"criterion.{n}": p for n, p in system.criterion.named_parameters()}
    start = {n: p.detach().clone() for n, p in params.items()}
    bufs = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, first, kept = [], None, None
    with RA.arithmetic(precision):
        for batch in batches:
            pcm, clips, lengths, groups, labels = (a[:keep] for a in batch)
            xv, em = embed(system, pcm, clips, lengths, groups, config)
            if kept is None:
                kept = (xv, em)
            loss = loss_of(system, xv, em, groups, labels)
            grads = torch.autograd.grad(loss, list(params.values()))
            with torch.no_grad():
                for (n, p), g in zip(params.items(), grads):
                    bufs[n].mul_(mom).add_(g + wd * p)
                    p.sub_(lr * bufs[n])
            losses.append(float(loss.detach()))
            if first is None:
                first = {n: float(b.double().norm()) for n, b in bufs.items()}
    change = {n: float((p.detach() - start[n]).double().norm()) for n, p in params.items()}
    return {"losses": losses, "first_grad": first, "change": change,
            "audio_emb": kept[0], "video_emb": kept[1]}
