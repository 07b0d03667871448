"""Plain PyTorch reference of the ``etdnn-vox12`` configuration.

The E-TDNN x-vector system of Snyder et al. (ICASSP 2019) as DeepLip's
``conf/audio_config.yaml`` ships it, written from the description and
independent of the program:

- front-end (python_speech_features conventions): pre-emphasis 0.97,
  frames of ``round(win_len · rate)`` samples every ``round(win_shift ·
  rate)``, zero-padded to cover the signal; ``|rfft(frame, n_fft)|² /
  n_fft``; a triangular mel filterbank with corners ``floor((n_fft + 1) hz /
  rate)``; log; orthonormal DCT-II to ``num_cep``; the lifter ``1 + 11
  sin(π n / 22)``; c0 replaced by the log frame energy. A zero energy or mel
  sum becomes float64's eps before the log;
- CMVN over each utterance's frames (population std, ``+ 2e-12``);
- ten dilated VALID Conv1d → batch norm → LeakyReLU(0.2) blocks, mean and
  unbiased std pooling (``sqrt(var + 1e-12)``), fc1 → BN → LeakyReLU →
  fc2 (the embedding); in training BN → LeakyReLU after fc2 as well;
- LMCL: cosines of the unit embedding and the unit class weights, the
  margin subtracted on the target, scale 30, cross-entropy, plus ``1e-5
  ||W||_1``;
- SGD with momentum 0.9 and coupled weight decay: ``g + wd·p`` into the
  buffer, ``p -= lr · buf``.

The bf16 recipe (``compute_dtype: bf16``) convolves bf16 activations with
bf16 casts of the weights and biases, takes every batch norm's statistics
in float32 and normalises in bf16; pooling, the head and the criterion are
float32. Every float32 product runs without TF32.

``precision`` selects the arithmetic: ``"f32"`` and ``"bf16"`` are the
recipes; ``"tf32"`` (float32 products in TF32) and ``"fp8"`` (the bf16
convolutions' operands rounded to float8 e4m3 with a scale per tensor) are
the next precision down, the controls that must fail the check.

It imports nothing of the program. Tensor names follow the program's state
dict, so the benchmark can load both with one set of weights.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

EPS64 = float(np.finfo(np.float64).eps)
SLOPE = 0.2
FP8_MAX = 448.0


# ------------------------------------------------------------------ precision
@contextlib.contextmanager
def arithmetic(precision: str):
    """TF32 only for ``"tf32"``; restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in its type."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


# ------------------------------------------------------------------ front-end
def _hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def _mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_filt: int, n_fft: int, rate: int) -> np.ndarray:
    """``(n_fft // 2 + 1, n_filt)`` triangular filters."""
    mel = np.linspace(_hz_to_mel(0.0), _hz_to_mel(rate / 2.0), n_filt + 2)
    bins = np.floor((n_fft + 1) * _mel_to_hz(mel) / rate).astype(np.int64)
    fb = np.zeros((n_filt, n_fft // 2 + 1))
    for j in range(n_filt):
        for i in range(bins[j], bins[j + 1]):
            fb[j, i] = (i - bins[j]) / (bins[j + 1] - bins[j])
        for i in range(bins[j + 1], bins[j + 2]):
            fb[j, i] = (bins[j + 2] - i) / (bins[j + 2] - bins[j + 1])
    return fb.T


def dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II, ``(n_in, n_out)``."""
    n = np.arange(n_in)[:, None]
    k = np.arange(n_out)[None, :]
    mat = 2.0 * np.cos(np.pi * k * (2.0 * n + 1) / (2.0 * n_in))
    scale = np.full((1, n_out), np.sqrt(1.0 / (2.0 * n_in)))
    scale[0, 0] = np.sqrt(1.0 / (4.0 * n_in))
    return mat * scale


def lifter(n_cep: int, size: int = 22) -> np.ndarray:
    return 1.0 + (size / 2.0) * np.sin(np.pi * np.arange(n_cep) / size)


def frame_count(samples: int, frame_len: int, step: int) -> int:
    return 1 if samples <= frame_len else 1 + math.ceil((samples - frame_len) / step)


def as_samples(pcm: torch.Tensor) -> torch.Tensor:
    """int16 PCM as float32 samples in [-1, 1); float PCM as it is."""
    return pcm.to(torch.float32) / 32768.0 if pcm.dtype == torch.int16 else pcm


def mfcc(pcm: torch.Tensor, feat: dict) -> torch.Tensor:
    """``(B, S)`` PCM → ``(B, T, num_cep)`` MFCC in the PCM's type."""
    rate = int(feat["rate"])
    frame_len = int(math.floor(feat["win_len"] * rate + 0.5))
    step = int(math.floor(feat["win_shift"] * rate + 0.5))
    n_fft, n_bin, n_cep = int(feat["n_fft"]), int(feat["num_bin"]), int(feat["num_cep"])
    emph = torch.cat([pcm[:, :1], pcm[:, 1:] - 0.97 * pcm[:, :-1]], dim=1)
    t = frame_count(pcm.shape[1], frame_len, step)
    need = (t - 1) * step + frame_len
    emph = F.pad(emph, (0, max(need - emph.shape[1], 0)))[:, :need]
    frames = emph.unfold(1, frame_len, step)
    spec = torch.fft.rfft(frames, n=n_fft)
    power = (spec.real ** 2 + spec.imag ** 2) / n_fft
    dev = pcm.device
    fb = torch.tensor(mel_filterbank(n_bin, n_fft, rate), dtype=pcm.dtype, device=dev)
    dct = torch.tensor(dct_matrix(n_cep, n_bin), dtype=pcm.dtype, device=dev)
    lift = torch.tensor(lifter(n_cep), dtype=pcm.dtype, device=dev)
    energy = power.sum(-1)
    energy = torch.where(energy == 0, EPS64, energy)
    mel = power @ fb
    mel = torch.where(mel == 0, EPS64, mel)
    cep = (torch.log(mel) @ dct) * lift
    if feat.get("energy", True):
        cep = torch.cat([torch.log(energy)[..., None], cep[..., 1:]], dim=-1)
    return cep


def cmvn(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=1, keepdim=True)
    std = ((x - mean) ** 2).mean(dim=1, keepdim=True).sqrt()
    return (x - mean) / (std + 2e-12)


# ------------------------------------------------------------------ model
def widened(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or float64 if it is."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _leaky(x):
    return F.leaky_relu(x, SLOPE)


class BatchNorm(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """Over every axis but the last; statistics in float32, applied in
        ``x``'s type."""
        if train:
            axes = tuple(range(x.ndim - 1))
            xf = widened(x)
            mean = xf.mean(axes)
            var = ((xf - mean) ** 2).mean(axes)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + 1e-5)
        t = x.dtype
        return (x - mean.to(t)) * inv.to(t) * self.weight.to(t) + self.bias.to(t)


class Block(nn.Module):
    def __init__(self, c_in: int, c_out: int, context):
        super().__init__()
        k = len(context)
        self.dilation = (context[-1] - context[0]) // (k - 1) if k > 1 else 1
        self.context_layer = nn.Conv1d(c_in, c_out, k, dilation=self.dilation)
        self.bn = BatchNorm(c_out)

    def forward(self, x: torch.Tensor, train: bool, fp8: bool) -> torch.Tensor:
        w = self.context_layer.weight.to(x.dtype)
        b = self.context_layer.bias.to(x.dtype)
        inp = x.transpose(1, 2)
        if fp8:
            inp, w = fp8_round(inp), fp8_round(w)
        y = F.conv1d(inp, w, b, dilation=self.dilation).transpose(1, 2)
        return _leaky(self.bn(y, train))


class ETDNN(nn.Module):
    """The x-vector network and, as ``criterion``, the LMCL class weights."""

    def __init__(self, model: dict, input_dim: int, num_classes: int):
        super().__init__()
        opts = model[model["arch"]]
        n = int(opts["tdnn_layers"])
        dims = [input_dim, *opts["hidden_dim"][:n]]
        self.tdnn = nn.ModuleList(Block(dims[i], dims[i + 1], ctx)
                                  for i, ctx in enumerate(opts["context"][:n]))
        self.fc1 = nn.Linear(2 * dims[-1], opts["embedding_dim"])
        self.bn1 = BatchNorm(opts["embedding_dim"])
        self.fc2 = nn.Linear(opts["embedding_dim"], opts["embedding_dim"])
        self.bn2 = BatchNorm(opts["embedding_dim"])
        self.criterion = nn.Module()
        self.criterion.weights = nn.Parameter(torch.zeros(num_classes, opts["embedding_dim"]))

    def xvector(self, x: torch.Tensor, train: bool, dtype=None, fp8: bool = False):
        if dtype is not None:
            x = x.to(dtype)
        for blk in self.tdnn:
            x = blk(x, train, fp8)
        x = widened(x)
        n = x.shape[1]
        mean = x.mean(dim=1)
        var = ((x * x).sum(dim=1) - n * mean * mean).clamp(min=0.0) / (n - 1)
        pooled = torch.cat([mean, torch.sqrt(var + 1e-12)], dim=-1)
        return self.fc2(_leaky(self.bn1(self.fc1(pooled), train)))

    def embed(self, feats: torch.Tensor) -> torch.Tensor:
        """Eval mode: the unit x-vector."""
        xv = self.xvector(feats, train=False)
        return xv / xv.norm(dim=-1, keepdim=True).clamp(min=1e-12)

    def lmcl(self, feats, labels, scale: float, margin: float, dtype, fp8: bool):
        emb = _leaky(self.bn2(self.xvector(feats, True, dtype, fp8), True))
        e = emb / emb.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        w = self.criterion.weights
        cos = e @ (w / w.norm(dim=-1, keepdim=True).clamp(min=1e-12)).T
        target = F.one_hot(labels.long(), w.shape[0]).to(cos.dtype)
        z = scale * (cos - margin * target)
        return F.cross_entropy(z, labels.long()) + 1e-5 * w.abs().sum()


def build(config: dict, num_classes: int) -> ETDNN:
    feat = config["data"]["python_data_config"]
    n_cep = feat[feat["feat_type"]]["num_cep"]
    return ETDNN(config["model"], n_cep, num_classes)


def feature_settings(config: dict) -> dict:
    data = config["data"]["python_data_config"]
    return {**data[data["feat_type"]], "rate": data["rate"]}


# ------------------------------------------------------------------ the two paths
@torch.no_grad()
def embed_rows(model: ETDNN, pcm_i16: torch.Tensor, feat: dict, precision: str,
               batch: int) -> torch.Tensor:
    """Unit embeddings of int16 utterances, ``batch`` rows at a time."""
    out = []
    with arithmetic(precision):
        for lo in range(0, pcm_i16.shape[0], batch):
            x = as_samples(pcm_i16[lo:lo + batch])
            out.append(model.embed(cmvn(mfcc(x, feat))))
    return torch.cat(out)


def cosine(emb: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    return (emb[pairs[:, 0]] * emb[pairs[:, 1]]).sum(-1)


def train_steps(model: ETDNN, batches, config: dict, precision: str) -> dict:
    """SGD steps of the recipe over ``batches`` (``(int16 PCM, labels)``);
    returns each step's loss, the first gradient as the optimizer took it
    (``g + wd·p`` of step 1) per leaf, and each leaf's change over the
    steps. Its own state: the model's parameters."""
    train = config["train"]
    sgd = train["sgd"]
    lr, mom, wd = float(sgd["init_lr"]), float(sgd["momentum"]), float(sgd["weight_decay"])
    dtype = torch.bfloat16 if precision in ("bf16", "fp8") else None
    feat = feature_settings(config)
    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    bufs = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, first = [], None
    with arithmetic(precision):
        for pcm, labels in batches:
            feats = cmvn(mfcc(as_samples(pcm), feat))
            loss = model.lmcl(feats, labels, float(train["scale"]), float(train["margin"][0]),
                              dtype, precision == "fp8")
            grads = torch.autograd.grad(loss, list(params.values()))
            with torch.no_grad():
                for (n, p), g in zip(params.items(), grads):
                    bufs[n].mul_(mom).add_(g + wd * p)
                    p.sub_(lr * bufs[n])
            losses.append(float(loss.detach()))
            if first is None:
                first = {n: float(b.double().norm()) for n, b in bufs.items()}
    change = {n: float((p.detach() - start[n]).double().norm()) for n, p in params.items()}
    return {"losses": losses, "first_grad": first, "change": change}
