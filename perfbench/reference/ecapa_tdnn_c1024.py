"""Plain PyTorch reference of the ``ecapa-tdnn-c1024`` configuration.

ECAPA-TDNN of Desplanques, Thienpondt and Demuynck (Interspeech 2020,
arXiv:2005.07143, Fig. 2 and §3–4), C = 1024, written from the paper and
independent of the program, on ``(B, C, T)`` tensors with ``nn.Conv1d`` and
``F.batch_norm``:

- front-end: ``etdnn_vox12.mfcc`` at the configuration's settings (80 mel
  bands, 80 cepstra, n_fft 512, no energy c0) and CMVN over each crop;
- TDNN(i→o, k, d) = Conv1d (bias, zero "same" padding) → ReLU → batch norm;
  layer 1 TDNN(80→1024, k 5); three SE-Res2Blocks of dilation 2, 3, 4:
  TDNN(k 1), eight 128-wide groups chained as ``y_1 = a_1``, ``y_2 =
  K(a_2)``, ``y_i = K(a_i + y_{i−1})`` with ``K = TDNN(k 3, d)``, TDNN(k 1),
  the squeeze-excitation gate over the time mean (1024 → 128 → 1024, ReLU,
  sigmoid), the residual;
- aggregation: ReLU(Conv1d(3072→1536)) of the three blocks' outputs;
- attentive statistics pooling with global context: the frames with the
  mean and std over time, ``Conv1d(128→1536)(tanh(TDNN(4608→128)))``,
  softmax over time per channel, the weighted mean and std (each std
  ``sqrt(clamp(E[h²] − μ², 1e-12))``), batch norm over 3,072;
- head: Linear(3072→192) → batch norm, the embedding;
- AAM-softmax: ``s · cos(θ + m)`` on the target class, ``s · cos θ``
  elsewhere, the cosine clipped to ±(1 − 1e-7) and ``cos θ − m sin m``
  past ``θ = π − m``; cross-entropy;
- Adam (β 0.9 / 0.999, ε 1e-8) with coupled weight decay, at a constant
  rate.

Departures from the paper: the attention's tanh after its TDNN (the paper
names no non-linearity; SpeechBrain's ``ECAPA_TDNN`` has it); zero padding
at the edges (SpeechBrain reflects); CMVN where the paper subtracts the
mean alone; Adam held at the peak, 1e-3, of the paper's cyclical rate.

``precision``: ``"f32"``, every float32 product without TF32, and the
control ``"tf32"``, the next precision down. It imports nothing of the
program. Tensor names follow the program's state dict, so the benchmark
loads both with one set of weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.etdnn_vox12 import arithmetic, as_samples, cmvn, feature_settings, mfcc

PRECISIONS = ("f32", "tf32")
STD_FLOOR = 1e-12
BN_EPS = 1e-5


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm1d, train: bool) -> torch.Tensor:
    """Over channels (axis 1): batch statistics in training, the running
    ones in evaluation; the running statistics are not updated."""
    if train:
        return F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, BN_EPS)
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                        BN_EPS)


def std(sq: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(sq - mean * mean, min=STD_FLOOR))


class TDNN(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int = 1, d: int = 1):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, k, dilation=d, padding=d * (k - 1) // 2)
        self.bn = nn.BatchNorm1d(c_out)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return batch_norm(F.relu(self.conv(x)), self.bn, train)


class Res2Net(nn.Module):
    def __init__(self, channels: int, scale: int, d: int):
        super().__init__()
        self.scale = scale
        self.convs = nn.ModuleList(TDNN(channels // scale, channels // scale, 3, d)
                                   for _ in range(scale - 1))

    def forward(self, a: torch.Tensor, train: bool) -> torch.Tensor:
        groups = torch.split(a, a.shape[1] // self.scale, dim=1)
        ys = [groups[0]]
        for i in range(1, self.scale):
            inp = groups[i] if i == 1 else groups[i] + ys[-1]
            ys.append(self.convs[i - 1](inp, train))
        return torch.cat(ys, dim=1)


class SE(nn.Module):
    def __init__(self, channels: int, bottleneck: int):
        super().__init__()
        self.conv1 = nn.Conv1d(channels, bottleneck, 1)
        self.conv2 = nn.Conv1d(bottleneck, channels, 1)

    def forward(self, b: torch.Tensor) -> torch.Tensor:
        s = b.mean(dim=2, keepdim=True)
        return b * torch.sigmoid(self.conv2(F.relu(self.conv1(s))))


class Block(nn.Module):
    def __init__(self, channels: int, scale: int, bottleneck: int, d: int):
        super().__init__()
        self.tdnn1 = TDNN(channels, channels)
        self.res2net = Res2Net(channels, scale, d)
        self.tdnn2 = TDNN(channels, channels)
        self.se = SE(channels, bottleneck)

    def forward(self, u: torch.Tensor, train: bool) -> torch.Tensor:
        b = self.tdnn2(self.res2net(self.tdnn1(u, train), train), train)
        return self.se(b) + u


class Pooling(nn.Module):
    def __init__(self, channels: int, attention: int):
        super().__init__()
        self.tdnn = TDNN(3 * channels, attention)
        self.conv = nn.Conv1d(attention, channels, 1)

    def forward(self, h: torch.Tensor, train: bool) -> torch.Tensor:
        t = h.shape[2]
        mean = h.mean(dim=2, keepdim=True)
        sd = std((h * h).mean(dim=2, keepdim=True), mean)
        g = torch.cat([h, mean.repeat(1, 1, t), sd.repeat(1, 1, t)], dim=1)
        alpha = torch.softmax(self.conv(torch.tanh(self.tdnn(g, train))), dim=2)
        mu = (alpha * h).sum(dim=2)
        return torch.cat([mu, std((alpha * h * h).sum(dim=2), mu)], dim=1)


class ECAPA(nn.Module):
    """The network and, as ``criterion``, the AAM-softmax class weights."""

    def __init__(self, opts: dict, input_dim: int, num_classes: int):
        super().__init__()
        c, m = int(opts["channels"]), int(opts["mfa_channels"])
        emb = int(opts["embedding_dim"])
        self.layer1 = TDNN(input_dim, c, 5)
        self.blocks = nn.ModuleList(Block(c, int(opts["scale"]), int(opts["se_channels"]), d)
                                    for d in (2, 3, 4))
        self.mfa = nn.Conv1d(3 * c, m, 1)
        self.pooling = Pooling(m, int(opts["attention_channels"]))
        self.pool_bn = nn.BatchNorm1d(2 * m)
        self.fc2 = nn.Linear(2 * m, emb)
        self.bn2 = nn.BatchNorm1d(emb)
        self.criterion = nn.Module()
        self.criterion.weights = nn.Parameter(torch.zeros(num_classes, emb))

    def embedding(self, feats: torch.Tensor, train: bool) -> tuple[torch.Tensor, torch.Tensor]:
        """``(B, T, D)`` features → ``(embedding, Linear output)``."""
        u = self.layer1(feats.transpose(1, 2), train)
        outs = []
        for blk in self.blocks:
            u = blk(u, train)
            outs.append(u)
        h = F.relu(self.mfa(torch.cat(outs, dim=1)))
        x_a = self.fc2(batch_norm(self.pooling(h, train), self.pool_bn, train))
        return batch_norm(x_a, self.bn2, train), x_a

    def aam(self, feats, labels, scale: float, margin: float) -> torch.Tensor:
        emb, _ = self.embedding(feats, True)
        e = emb / emb.norm(dim=1, keepdim=True).clamp(min=1e-12)
        w = self.criterion.weights
        cos = e @ (w / w.norm(dim=1, keepdim=True).clamp(min=1e-12)).T
        cos = cos.clamp(-1.0 + 1e-7, 1.0 - 1e-7)
        sin = torch.sqrt(1.0 - cos * cos)
        phi = cos * math.cos(margin) - sin * math.sin(margin)
        phi = torch.where(cos > math.cos(math.pi - margin), phi, cos - margin * math.sin(margin))
        target = F.one_hot(labels.long(), w.shape[0]).bool()
        return F.cross_entropy(scale * torch.where(target, phi, cos), labels.long())


def build(config: dict, num_classes: int) -> ECAPA:
    model = config["model"]
    return ECAPA(model[model["arch"]], int(feature_settings(config)["num_cep"]), num_classes)


def train_steps(model: ECAPA, batches, config: dict, precision: str) -> dict:
    """Adam steps of the recipe over ``batches`` (``(int16 PCM, labels)``);
    readings as ``etdnn_vox12.train_steps``: each step's loss, the first
    gradient as Adam took it (``g + wd·p`` of step 1) and each leaf's
    change over the steps. Its own state: the model's parameters."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: the configuration is f32, its control tf32")
    train = config["train"]
    adam = train["adam"]
    lr, wd = float(adam["init_lr"]), float(adam["weight_decay"])
    b1, b2, eps = 0.9, 0.999, 1e-8
    scale, margin = float(train["scale"]), float(train["margin"][0])
    feat = feature_settings(config)
    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, first = [], None
    with arithmetic(precision):
        for step, (pcm, labels) in enumerate(batches):
            feats = cmvn(mfcc(as_samples(pcm), feat))
            loss = model.aam(feats, labels, scale, margin)
            grads = torch.autograd.grad(loss, list(params.values()))
            with torch.no_grad():
                for (n, p), g in zip(params.items(), grads):
                    g = g + wd * p
                    m[n].mul_(b1).add_((1 - b1) * g)
                    v[n].mul_(b2).add_((1 - b2) * g * g)
                    denom = (v[n] / (1 - b2 ** (step + 1))).sqrt() + eps
                    p.sub_(lr * (m[n] / (1 - b1 ** (step + 1))) / denom)
            losses.append(float(loss.detach()))
            if first is None:
                first = {n: float((mi / (1 - b1)).double().norm()) for n, mi in m.items()}
    change = {n: float((p.detach() - start[n]).double().norm()) for n, p in params.items()}
    return {"losses": losses, "first_grad": first, "change": change}
