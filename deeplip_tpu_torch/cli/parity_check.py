"""End-to-end parity harness: the reference recipe's torch pipeline against
the port.

Counterpart of ``scripts/parity_check.py``, with the same modes, defaults
and exit codes. The yardstick is the reference recipe as plain torch code
that does not touch the port: the NumPy MFCC (python_speech_features'
math, :func:`numpy_mfcc`) and the torch replicas of the reference's
E-TDNN, LMCL and CrossEntropy criteria, Lipreading network and LowFER head
(:func:`build_torch_net` and the other ``build_torch_*``). The reference
side runs on the CPU, per utterance, in float32 (float64 where a mode
asks); the port runs batched on ``--device`` (the card unless ``--device
cpu``), so there its front-end is the FFT kernel.

Modes (``python -m deeplip_tpu_torch.cli.parity_check ...``):

- ``--selftest``: a synthetic corpus and a seeded reference-layout
  E-TDNN checkpoint through both pipelines; embeddings within 1e-4.
- ``--full``: the 20,000-trial protocol: 20 speakers x 20 utterances of
  1.5 s, a balanced trial list, the reference net pre-trained for 60 steps
  on ``--device`` (an untrained net collapses every embedding into a ~1e-6
  cosine band),
  the E-TDNN at full width (hidden 512 x 9 and 1500, embedding 512);
  embeddings within 1e-4 and the two EERs bit-equal. ``--n-spk``,
  ``--utts-per-spk``, ``--n-trials`` and ``--train-steps`` shrink it.
- ``--ckpt/--wav-root/--trials``: a reference ``net_*.pth``, a wav tree and
  a trial list.
- ``--train-parity``: 12 steps of the reference audio recipe (train-mode
  BN, LMCL or CrossEntropy, SGD with momentum and coupled weight decay, the
  margin switching mid-run) from one init on the same feature batches:
  CrossEntropy in float32 and LMCL in float64, each to a final parameter
  drift of 1e-5; LMCL in float32 is reported, not held (its scale-30
  softmax amplifies f32 summation noise about 4x a step).
- ``--train-parity-video``: 10 steps of the video recipe (Lipreading with
  train-mode BN, CrossEntropy, Adam with coupled L2, the cosine rate
  stepped per iteration).
- ``--train-parity-fusion``: 10 steps of the fusion recipe from raw PCM and
  uint8 clips (frozen eval-mode encoders, the clip-group mean, items
  without clips dropped, LowFER's gated concat, CrossEntropy, SGD over the
  head and the criterion, the rate decayed at steps 4 and 8).

The two last modes run in float64 on the CPU (``--device cpu``) to a final
parameter drift of 1e-5. On the card they run in float32, since the CUDA
kernels take float32 and bfloat16, and are held to the f32 step rule,
against three runs of the replica on its input nudged elementwise by 1e-6
relative:

- the first step's loss (the forward at the shared init) within 1e-5
  relative of the replica's;
- every step's loss within 1e-5 relative, or within 3x the median nudged
  run's largest relative loss deviation where the recipe itself moves
  that far (the video recipe does: Adam's per-element normalisation turns
  each gradient that a nudge tips across zero into a full step of the
  other sign, BN biases whose gradients nearly cancel among them, and ten
  steps of a few random frames amplify that by about 3x a step);
- the video recipe's first-step gradients no further from the replica's
  (``|a - b| / |b|`` over all of them) than 3x the median nudged run's:
  Adam would hide a gradient's scale, and the gradient is smooth in the
  input where no unit sits at its kink (the card's input is seeded with
  :data:`VIDEO_F32_SEED` for that);
- the final parameters no further from the reference's than 3x the
  median nudged run's.

Each mode prints a JSON report (``--report`` writes it too) with the
port's kernel launches and its seconds. Exit codes: 1 the embedding bar
missed, 2 the EER not bit-equal under ``--full``, 3 a train-parity bar
missed.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from deeplip_tpu_torch.core.config import Config
from deeplip_tpu_torch.data.audio_io import read_wav
from deeplip_tpu_torch.data.audio_pipeline import EvalUtterance, EvalUtteranceSet
from deeplip_tpu_torch.data.manifest import SpeakerManifest
from deeplip_tpu_torch.data.synthetic import make_audio_corpus, make_trial_list
from deeplip_tpu_torch.eval.scoring import (EmbeddingStore, TrialList, cosine_eer,
                                            cosine_scores_np)
from deeplip_tpu_torch.interop.torch_import import (import_criterion_state_dict,
                                                    import_lipreading_state_dict,
                                                    import_lmcl_state_dict,
                                                    import_speaker_embnet_state_dict,
                                                    read_checkpoint)
from deeplip_tpu_torch.ops.cuda import launch_counts
from deeplip_tpu_torch.train.audio import AudioExtractor, AudioTrainer
from deeplip_tpu_torch.train.fusion import FusionTrainer
from deeplip_tpu_torch.train.video import VideoTrainer

EMB_BAR = 1e-4            # embeddings, the reference's bar
DRIFT_BAR = 1e-5          # final parameter drift of a train-parity run
STEP_LOSS_RTOL = 1e-5     # f32 step rule: each step's loss, relative
NUDGE = 1e-6              # f32 step rule: relative nudge of the reference's input
NUDGE_FACTOR = 3.0        # f32 step rule: the port may drift this many times as far
NUDGES = 3                # f32 step rule: nudged runs of the replica (the median is read)
# the video recipe's input on the card: at seed 0 a unit of the replica sits
# so near its kink that two of the three nudged runs move the first-step
# gradients by ~3e-3; at seed 2 all three move them by 5e-6 to 8e-6
VIDEO_F32_SEED = 2
RATE = 16000

ARCHS = {
    "tdnn": {
        "hidden_dim": [512, 512, 512, 512, 1500],
        "context": [[-2, -1, 0, 1, 2], [-2, 0, 2], [-3, 0, 3], [0], [0]],
    },
    "etdnn": {
        "hidden_dim": [512, 512, 512, 512, 512, 512, 512, 512, 512, 1500],
        "context": [[-2, -1, 0, 1, 2], [0], [-2, 0, 2], [0], [-3, 0, 3], [0],
                    [-4, 0, 4], [0], [0], [0]],
    },
}
MFCC = {"n_fft": 512, "num_bin": 26, "num_cep": 24, "energy": True, "normalize": True,
        "delta": False, "win_len": 0.025, "win_shift": 0.01}
AUDIO_DATA = {"rate": RATE, "feat_type": "mfcc", "mfcc": MFCC}


# ---------------------------------------------------------------------------
# the reference recipe: plain numpy and torch, independent of the port

def numpy_mfcc(sig):
    """python_speech_features-equivalent MFCC-24 with CMVN, in float64."""
    sig = np.append(sig[0], sig[1:] - 0.97 * sig[:-1])
    frame_len, step, nfft, nfilt, numcep = 400, 160, 512, 26, 24
    n = 1 + int(np.ceil((len(sig) - frame_len) / step)) if len(sig) > frame_len else 1
    padded = np.concatenate([sig, np.zeros((n - 1) * step + frame_len - len(sig))])
    idx = np.arange(n)[:, None] * step + np.arange(frame_len)[None, :]
    frames = padded[idx]
    ps = (np.abs(np.fft.rfft(frames, nfft)) ** 2) / nfft
    energy = np.maximum(ps.sum(1), np.finfo(float).eps)
    mel = lambda hz: 2595 * np.log10(1 + hz / 700)  # noqa: E731
    imel = lambda m: 700 * (10 ** (m / 2595) - 1)  # noqa: E731
    pts = np.floor((nfft + 1) * imel(np.linspace(mel(0), mel(RATE / 2), nfilt + 2))
                   / RATE).astype(int)
    fb = np.zeros((nfilt, nfft // 2 + 1))
    for j in range(nfilt):
        fb[j, pts[j]:pts[j + 1]] = ((np.arange(pts[j], pts[j + 1]) - pts[j])
                                    / max(pts[j + 1] - pts[j], 1))
        fb[j, pts[j + 1]:pts[j + 2]] = ((pts[j + 2] - np.arange(pts[j + 1], pts[j + 2]))
                                        / max(pts[j + 2] - pts[j + 1], 1))
    feat = np.log(np.maximum(ps @ fb.T, np.finfo(float).eps))
    from scipy.fftpack import dct

    cep = dct(feat, type=2, axis=1, norm="ortho")[:, :numcep]
    lift = 1 + 11 * np.sin(np.pi * np.arange(numcep) / 22)
    cep = cep * lift
    cep[:, 0] = np.log(energy)
    return (cep - cep.mean(0)) / (cep.std(0) + 2e-12)


def build_torch_net(torch, contexts, dims, emb_dim):
    """torch net with the reference SpeakerEmbNet state_dict layout."""
    nn = torch.nn

    class Block(nn.Module):
        def __init__(self, cin, cout, ctx):
            super().__init__()
            k = len(ctx)
            d = (ctx[-1] - ctx[0]) // (k - 1) if k > 1 else 1
            self.context_layer = nn.Conv1d(cin, cout, k, dilation=d)
            self.bn = nn.BatchNorm1d(cout)
            self.act = nn.LeakyReLU(0.2)

        def forward(self, x):
            return self.act(self.bn(self.context_layer(x)))

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            blocks, cin = [], dims[0]
            for ctx, cout in zip(contexts, dims[1:]):
                blocks.append(Block(cin, cout, ctx))
                cin = cout
            self.tdnn = nn.Sequential(*blocks)
            self.fc1 = nn.Linear(dims[-1] * 2, emb_dim)
            self.bn1 = nn.BatchNorm1d(emb_dim)
            self.act = nn.LeakyReLU(0.2)
            self.fc2 = nn.Linear(emb_dim, emb_dim)
            self.bn2 = nn.BatchNorm1d(emb_dim)

        def extract(self, x):
            h = self.tdnn(x)
            stats = torch.cat([h.mean(2), h.std(2)], 1)
            xv = self.fc2(self.act(self.bn1(self.fc1(stats))))
            return torch.nn.functional.normalize(xv)

        def forward(self, x):
            # training forward = extract tap + bn2 + activation
            # (the reference's tdnn.py:103-111, bn_first path)
            h = self.tdnn(x)
            stats = torch.cat([h.mean(2), h.std(2)], 1)
            xv = self.fc2(self.act(self.bn1(self.fc1(stats))))
            return self.act(self.bn2(xv))

    return Net().eval()


def train_torch_net(torch, net, feats_by_utt, labels_by_utt, emb_dim, n_spk,
                    steps, crop=100, bs=32, seed=0, device="cpu"):
    """Spread the random net's embeddings with a short cosine-CE fit.

    Mirrors the reference's LMCL recipe minus the margin (scale-30 cosine
    logits, the reference's models/audio_models/loss.py): just enough
    training that same/different-speaker cosines separate and the EER
    comparison is well-conditioned. BN running stats update in train mode,
    exactly as the reference trainer would leave them. The fit runs on
    ``device`` and leaves the net on the CPU: it only makes the checkpoint
    that both pipelines load.
    """
    rng = np.random.default_rng(seed)
    names = sorted(feats_by_utt)
    net.to(device)
    w = torch.nn.Parameter((torch.randn(n_spk, emb_dim) * 0.1).to(device))
    opt = torch.optim.Adam(list(net.parameters()) + [w], lr=1e-3)
    net.train()
    for step in range(steps):
        picks = rng.choice(len(names), size=bs)
        batch, labels = [], []
        for i in picks:
            f = feats_by_utt[names[i]]
            start = rng.integers(max(len(f) - crop, 0) + 1)
            chunk = f[start:start + crop]
            if len(chunk) < crop:
                chunk = np.pad(chunk, ((0, crop - len(chunk)), (0, 0)))
            batch.append(chunk.T)
            labels.append(labels_by_utt[names[i]])
        x = torch.tensor(np.stack(batch), dtype=torch.float32).to(device)
        y = torch.tensor(labels).to(device)
        emb = net.extract(x)
        logits = 30.0 * emb @ torch.nn.functional.normalize(w).T
        loss = torch.nn.functional.cross_entropy(logits, y)
        opt.zero_grad()
        loss.backward()
        opt.step()
        if step % 10 == 0 or step == steps - 1:
            print(f"  torch pre-train step {step}: loss {loss.item():.4f}",
                  file=sys.stderr)
    net.cpu().eval()


def build_torch_lmcl(torch, emb_dim, n_spk, scale):
    """Torch LMCL replica (the reference's loss.py:33-51): cosine logits,
    additive margin scatter on the target class, scale s, CE(+1e-8), plus
    1e-5·||W||₁. ``margin`` is a plain attribute so the schedule
    (train_audio.py:141-145) can reassign it between epochs."""
    nn, F = torch.nn, torch.nn.functional

    class TorchLMCL(nn.Module):
        def __init__(self):
            super().__init__()
            self.margin = 0.2
            self.weights = nn.Parameter(torch.Tensor(n_spk, emb_dim))
            nn.init.kaiming_normal_(self.weights)

        def forward(self, emb, labels):
            logits = F.linear(F.normalize(emb), F.normalize(self.weights))
            margin = torch.zeros_like(logits)
            margin.scatter_(1, labels.view(-1, 1), self.margin)
            loss = F.cross_entropy(scale * (logits - margin) + 1e-8, labels)
            return loss + 1e-5 * torch.norm(self.weights, 1), logits

    return TorchLMCL()


def build_torch_ce(torch, emb_dim, n_spk):
    """Torch CrossEntropy criterion replica (the reference's loss.py:6-16)."""
    nn, F = torch.nn, torch.nn.functional

    class TorchCE(nn.Module):
        def __init__(self):
            super().__init__()
            self.margin = 0.0  # unused; uniform interface
            self.fc = nn.Linear(emb_dim, n_spk)

        def forward(self, emb, labels):
            logits = self.fc(emb)
            return F.cross_entropy(logits + 1e-8, labels), logits

    return TorchCE()


def build_torch_lipreading(torch, num_classes, hidden_dim=8, tcn_layers=2,
                           layers=(1, 1, 1, 1), dropout=0.0):
    """Independent torch Lipreading mirror with the reference state_dict
    layout: frontend3D (the reference's model.py:81-85), stemless ResNet
    trunk (resnet.py:45-111), single-branch TCN with pad+symm-chomp convs
    (tcn.py:145-244) and the _average_batch consensus + tcn_output Linear
    (model.py:14-17,40-58). PReLU everywhere."""
    nn = torch.nn

    class Chomp(nn.Module):  # tcn.py:12-25, symmetric
        def __init__(self, size):
            super().__init__()
            self.size = size

        def forward(self, x):
            if self.size == 0:
                return x
            return x[:, :, self.size // 2:-(self.size // 2)].contiguous()

    class Block(nn.Module):  # resnet.py BasicBlock, 1x1-conv downsample
        def __init__(self, cin, planes, stride=1):
            super().__init__()
            self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(planes)
            self.relu1 = nn.PReLU(planes)
            self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(planes)
            self.relu2 = nn.PReLU(planes)
            self.downsample = None
            if stride != 1 or cin != planes:
                self.downsample = nn.Sequential(
                    nn.Conv2d(cin, planes, 1, stride, bias=False),
                    nn.BatchNorm2d(planes))

        def forward(self, x):
            r = x if self.downsample is None else self.downsample(x)
            h = self.relu1(self.bn1(self.conv1(x)))
            h = self.bn2(self.conv2(h))
            return self.relu2(h + r)

    class Trunk(nn.Module):
        def __init__(self):
            super().__init__()
            cin = 64
            for stage, (planes, n) in enumerate(
                    zip((64, 128, 256, 512), layers), 1):
                blocks = []
                for i in range(n):
                    blocks.append(Block(
                        cin, planes, 2 if (i == 0 and stage > 1) else 1))
                    cin = planes
                setattr(self, f"layer{stage}", nn.Sequential(*blocks))

        def forward(self, x):
            for stage in range(1, 5):
                x = getattr(self, f"layer{stage}")(x)
            return torch.nn.functional.adaptive_avg_pool2d(x, 1).flatten(1)

    class TemporalBlock(nn.Module):  # tcn.py:145-224, symm_chomp
        def __init__(self, cin, cout, k, dilation):
            super().__init__()
            pad = (k - 1) * dilation
            self.conv1 = nn.Conv1d(cin, cout, k, padding=pad,
                                   dilation=dilation)
            self.batchnorm1 = nn.BatchNorm1d(cout)
            self.chomp1 = Chomp(pad)
            self.relu1 = nn.PReLU(cout)
            self.dropout1 = nn.Dropout(dropout)
            self.conv2 = nn.Conv1d(cout, cout, k, padding=pad,
                                   dilation=dilation)
            self.batchnorm2 = nn.BatchNorm1d(cout)
            self.chomp2 = Chomp(pad)
            self.relu2 = nn.PReLU(cout)
            self.dropout2 = nn.Dropout(dropout)
            self.downsample = nn.Conv1d(cin, cout, 1) if cin != cout else None
            self.relu = nn.PReLU(cout)

        def forward(self, x):
            out = self.dropout1(self.relu1(self.chomp1(
                self.batchnorm1(self.conv1(x)))))
            out = self.dropout2(self.relu2(self.chomp2(
                self.batchnorm2(self.conv2(out)))))
            res = x if self.downsample is None else self.downsample(x)
            return self.relu(out + res)

    class TcnTrunk(nn.Module):  # tcn.py:227-244
        def __init__(self):
            super().__init__()
            net = []
            cin = 512
            for i in range(tcn_layers):
                net.append(TemporalBlock(cin, hidden_dim, 3, 2 ** i))
                cin = hidden_dim
            self.network = nn.Sequential(*net)

        def forward(self, x):
            return self.network(x)

    class TCNHead(nn.Module):  # model.py:40-58 (TCN wrapper)
        def __init__(self):
            super().__init__()
            self.tcn_trunk = TcnTrunk()
            self.tcn_output = nn.Linear(hidden_dim, num_classes)

        def forward(self, x, lengths):  # x: (B, T, C)
            x = self.tcn_trunk(x.transpose(1, 2))
            # _average_batch (model.py:16-17): per-sample mean over the
            # first `l` frames
            x = torch.stack(
                [torch.mean(x[i][:, :l], 1) for i, l in enumerate(lengths)], 0)
            return self.tcn_output(x)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.frontend3D = nn.Sequential(
                nn.Conv3d(1, 64, (5, 7, 7), (1, 2, 2), (2, 3, 3), bias=False),
                nn.BatchNorm3d(64),
                nn.PReLU(64),
                nn.MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1)))
            self.trunk = Trunk()
            self.tcn = TCNHead()

        def forward(self, x, lengths):  # x: (B, 1, T, H, W)
            b = x.shape[0]
            h = self.frontend3D(x)
            t = h.shape[2]
            h = h.transpose(1, 2).reshape(
                b * t, h.shape[1], h.shape[3], h.shape[4])
            f = self.trunk(h).reshape(b, t, -1)
            return self.tcn(f, lengths)

    return Net()


def build_torch_lowfer(torch, d, o=512, k=30, seed=0):
    """Torch LowFER replica (the reference's LBP.py:8-54, minus the cuda
    pinning): U/V uniform(-1, 1), MFB branch computed then OVERWRITTEN by
    the gated concat; the reference's live output is ``[e1, σ(e2),
    σ(e2)⊙e1]`` (LBP.py:48-51), leaving U/V with no gradient."""
    nn = torch.nn
    rng = np.random.default_rng(seed)

    class TLowFER(nn.Module):
        def __init__(self):
            super().__init__()
            self.U = nn.Parameter(torch.tensor(
                rng.uniform(-1, 1, (d, k * o)), dtype=torch.float64))
            self.V = nn.Parameter(torch.tensor(
                rng.uniform(-1, 1, (d, k * o)), dtype=torch.float64))
            self.k, self.o = k, o

        def forward(self, e1, e2):
            x = torch.mm(e1, self.U) * torch.mm(e2, self.V)
            x = x.view(-1, self.o, self.k).mean(-1)
            x = nn.functional.normalize(x, p=2, dim=-1)
            e2 = torch.sigmoid(e2)
            x = e2 * e1  # MFB result overwritten (LBP.py:49)
            return torch.cat([e1, e2, x], dim=1)

    return TLowFER()


# ---------------------------------------------------------------------------
# comparisons

def max_drift(got: dict, want: dict, keys=None) -> float:
    """The largest ``|got - want|`` over the tensors named in ``keys``
    (default: every floating tensor of ``want``)."""
    keys = [k for k in want if want[k].is_floating_point()] if keys is None else keys
    return max(float((got[k].detach().cpu().double() - want[k].detach().cpu().double())
                     .abs().max()) for k in keys)


def distance(got: dict, want: dict, keys) -> float:
    """``|got - want| / |want|`` over the tensors named in ``keys`` at once."""
    num = sum(float(((got[k].detach().cpu().double() - want[k].detach().cpu().double())
                     ** 2).sum()) for k in keys)
    den = sum(float((want[k].detach().cpu().double() ** 2).sum()) for k in keys)
    return math.sqrt(num / den)


def _stat_key(key: str) -> bool:
    return key.endswith(("running_mean", "running_var"))


def _param_keys(sd: dict) -> list[str]:
    return [k for k, v in sd.items() if v.is_floating_point() and not _stat_key(k)]


def _loss_rel(want: list, got: list) -> float:
    return max(abs(a - b) / abs(a) for a, b in zip(want, got))


def _step_rule(torch_losses: list, ours_losses: list, dist: float, nudged: list,
               grad_dist: float | None = None) -> dict:
    """The f32 step rule's numbers and verdict (the module docstring gives
    the rule). ``nudged`` holds, for each of :data:`NUDGES` nudged runs of
    the replica, its losses, its distance from the replica's final
    parameters and, where ``grad_dist`` (the port's) is given, its distance
    from the replica's first-step gradients."""
    nudge_losses = [_loss_rel(torch_losses, n[0]) for n in nudged]
    nudge_dists = [n[1] for n in nudged]
    first = _loss_rel(torch_losses[:1], ours_losses[:1])
    rel = _loss_rel(torch_losses, ours_losses)
    loss_bar = max(STEP_LOSS_RTOL, NUDGE_FACTOR * float(np.median(nudge_losses)))
    dist_bar = NUDGE_FACTOR * float(np.median(nudge_dists))
    out = {"first_loss_rel_diff": first, "max_loss_rel_diff": rel, "loss_rel_bar": loss_bar,
           "nudge_max_loss_rel_diffs": nudge_losses, "final_param_distance": dist,
           "nudge_param_distances": nudge_dists, "param_distance_bar": dist_bar}
    held = first <= STEP_LOSS_RTOL and rel <= loss_bar and dist <= dist_bar
    if grad_dist is not None:
        nudge_grads = [n[2] for n in nudged]
        grad_bar = NUDGE_FACTOR * float(np.median(nudge_grads))
        out.update(first_grad_distance=grad_dist, nudge_grad_distances=nudge_grads,
                   grad_distance_bar=grad_bar)
        held = held and grad_dist <= grad_bar
    out["f32_step_rule"] = bool(held)
    return out


def _require_f64_on_cpu(dtype: str, device: torch.device, what: str) -> None:
    if dtype == "float64" and device.type != "cpu":
        raise ValueError(f"{what} in float64 runs on the CPU: the CUDA kernels take "
                         "float32 and bfloat16")


def _np_dtype(dtype: str):
    if dtype not in ("float32", "float64"):
        raise ValueError(f"dtype must be float32 or float64, not {dtype!r}")
    return np.float64 if dtype == "float64" else np.float32


# ---------------------------------------------------------------------------
# train-step parity

def run_train_parity(loss_name="LMCL", steps=12, bs=16, t_frames=120,
                     n_spk=12, emb_dim=32, lr=0.01, momentum=0.9,
                     weight_decay=1e-5, seed=0, dtype="float32", device="cpu"):
    """Train-STEP parity: N optimizer updates of the reference audio recipe
    (the reference's train_audio.py:158-214: the full train-mode forward
    with BN batch statistics, the LMCL or CrossEntropy criterion, SGD with
    momentum and coupled weight decay, the margin schedule) from the same
    init on the same feature batches, the torch replica on the CPU and the
    port's ``AudioTrainer.train_step_feats`` on ``device``. Features reach
    both sides as they are (the forward harness covers the front-end).
    Returns each step's losses and the final parameter and BN-statistics
    drift.

    ``dtype='float64'`` runs both sides in double precision: LMCL's scale-30
    softmax on a random init amplifies f32 summation-order noise about 4x a
    step, so no f32 pair holds a 1e-5 bound over 10+ steps; the smooth
    CrossEntropy recipe does in f32."""
    np_dtype = _np_dtype(dtype)
    tdt = torch.float64 if dtype == "float64" else torch.float32
    dev = torch.device(device)

    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)
    contexts = [[-2, -1, 0, 1, 2], [-2, 0, 2], [0]]
    hidden = [32, 32, 64]
    dims = [24] + hidden

    tnet = build_torch_net(torch, contexts, dims, emb_dim)
    if loss_name == "LMCL":
        tcrit = build_torch_lmcl(torch, emb_dim, n_spk, scale=30.0)
    else:
        tcrit = build_torch_ce(torch, emb_dim, n_spk)
    if dtype == "float64":
        tnet.double()
        tcrit.double()
    opt = torch.optim.SGD(
        [{"params": tnet.parameters()}, {"params": tcrit.parameters()}],
        lr=lr, momentum=momentum, weight_decay=weight_decay)

    # fixed batches + the reference margin schedule flipping mid-run
    feats = rng.standard_normal((steps, bs, t_frames, 24)).astype(np_dtype)
    labels = rng.integers(0, n_spk, (steps, bs)).astype(np.int64)
    margins = [0.2 if k < steps // 2 else 0.3 for k in range(steps)]

    # ---- the port's trainer with the identical recipe, the replica's init
    cfg = Config({
        "data": {"frames": [t_frames, t_frames], "python_data_config": AUDIO_DATA},
        "model": {"arch": "tdnn", "tdnn": {
            "input_dim": 24, "hidden_dim": hidden, "context": contexts,
            "tdnn_layers": len(contexts), "embedding_dim": emb_dim,
            "pooling": "statistic", "attention_hidden_size": 8,
            "bn_first": True}},
        "train": {"loss": loss_name, "scale": 30, "margin": [0.2, 0.3],
                  "type": "sgd", "bs": bs, "lr_decay": 0.1,
                  "lr_decay_step": [1000], "epoch": 1,
                  "sgd": {"init_lr": lr, "weight_decay": weight_decay,
                          "momentum": momentum}},
        "test": {},
    })
    with tempfile.TemporaryDirectory(prefix="parity_train_") as exp_root:
        trainer = AudioTrainer(cfg, device=dev, n_spk=n_spk, exp_root=exp_root)
    trainer.model.to(tdt)
    trainer.criterion.to(tdt)
    import_crit = import_lmcl_state_dict if loss_name == "LMCL" else import_criterion_state_dict
    trainer.model.load_state_dict(import_speaker_embnet_state_dict(
        tnet.state_dict(), n_blocks=len(contexts), float_dtype=np_dtype), strict=True)
    trainer.criterion.load_state_dict(import_crit(tcrit.state_dict(), float_dtype=np_dtype),
                                      strict=True)

    # ---- torch reference loop (the reference's train_audio.py:174-200)
    tnet.train()
    torch_losses = []
    for k in range(steps):
        tcrit.margin = margins[k]
        opt.zero_grad()
        x = torch.tensor(np.transpose(feats[k], (0, 2, 1)))
        out = tnet(x)
        loss, _logits = tcrit(out, torch.tensor(labels[k]))
        loss.backward()
        opt.step()
        torch_losses.append(float(loss.item()))

    # ---- the port's loop
    ours_losses = []
    for k in range(steps):
        metrics = trainer.train_step_feats(torch.tensor(feats[k]).to(dev),
                                           torch.tensor(labels[k]).to(dev), margins[k])
        ours_losses.append(float(metrics["loss"]))

    # ---- compare
    ref_model = import_speaker_embnet_state_dict(tnet.state_dict(), n_blocks=len(contexts),
                                                 float_dtype=np_dtype)
    ref_crit = import_crit(tcrit.state_dict(), float_dtype=np_dtype)
    ours_model = trainer.model.state_dict()
    param_drift = max(max_drift(ours_model, ref_model, _param_keys(ref_model)),
                      max_drift(trainer.criterion.state_dict(), ref_crit))
    stats_drift = max_drift(ours_model, ref_model, [k for k in ref_model if _stat_key(k)])
    loss_diffs = [abs(a - b) for a, b in zip(torch_losses, ours_losses)]
    return {
        "loss_name": loss_name,
        "dtype": dtype,
        "device": str(dev),
        "steps": steps,
        "torch_losses": torch_losses,
        "deeplip_losses": ours_losses,
        "max_loss_abs_diff": max(loss_diffs),
        "final_param_max_drift": param_drift,
        "final_batch_stats_max_drift": stats_drift,
        "param_drift_bar_1e-5": param_drift <= DRIFT_BAR,
    }


def _torch_video_run(tnet_init_sd, build, frames, labels, lengths, lr, weight_decay, steps,
                     dtype):
    """The reference video recipe's loop from ``tnet_init_sd``: torch Adam
    with coupled L2 and the cosine rate stepped per iteration. Returns the
    losses, the final state dict and the first step's gradients by
    parameter name."""
    tnet = build()
    if dtype == "float64":
        tnet.double()
    tnet.load_state_dict(tnet_init_sd)
    opt = torch.optim.Adam(tnet.parameters(), lr=lr, weight_decay=weight_decay)
    # the reference steps the cosine schedule once per ITERATION
    # (train_video.py quirk kept by VideoTrainer)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=steps)
    tnet.train()
    losses = []
    for k in range(steps):
        opt.zero_grad()
        out = tnet(torch.tensor(frames[k])[:, None], list(lengths))
        loss = torch.nn.functional.cross_entropy(out, torch.tensor(labels[k]))
        loss.backward()
        if k == 0:
            first_grads = {n: p.grad.detach().clone() for n, p in tnet.named_parameters()}
        opt.step()
        sched.step()
        losses.append(float(loss.item()))
    return losses, tnet.state_dict(), first_grads


def run_video_train_parity(steps=8, bs=3, t_frames=6, hw=48, n_classes=5,
                           lr=3e-4, weight_decay=1e-4, seed=0,
                           dtype="float64", device="cpu"):
    """Video train-STEP parity: N optimizer updates of the reference video
    recipe (the reference's train_video.py:119-167: the full train-mode
    Lipreading forward with BN batch statistics, CE, torch Adam with coupled
    L2 weight decay 1e-4, CosineAnnealingLR stepped per iteration) from the
    same init on the same transformed frames, the replica on the CPU and
    the port's ``VideoTrainer.train_step_frames`` on ``device`` (there
    through K3/K4 and the max-pool kernel). The network is the real
    Lipreading shrunk by the trainer's hidden_dim/trunk_layers knobs (hidden
    8, one block per stage); dropout 0 for determinism. float64 holds both
    sides' arithmetic below the 1e-5 bar; float32 is held to the f32 step
    rule (the module docstring) against runs of the replica on nudged
    frames, its first-step gradients included."""
    np_dtype = _np_dtype(dtype)
    dev = torch.device(device)
    _require_f64_on_cpu(dtype, dev, "the video train parity")
    layers = (1, 1, 1, 1)
    hidden = 8

    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)

    def build():
        return build_torch_lipreading(torch, n_classes, hidden_dim=hidden, tcn_layers=2,
                                      layers=layers)

    tnet = build()
    if dtype == "float64":
        tnet.double()
    tnet_init_sd = copy.deepcopy(tnet.state_dict())

    frames = rng.standard_normal((steps, bs, t_frames, hw, hw)).astype(np_dtype)
    labels = rng.integers(0, n_classes, (steps, bs)).astype(np.int64)
    lengths = rng.integers(t_frames // 2, t_frames + 1, (bs,)).astype(np.int32)

    torch_losses, ref_sd, ref_grads = _torch_video_run(tnet_init_sd, build, frames, labels,
                                                       lengths, lr, weight_decay, steps, dtype)

    cfg = Config({
        "backbone_type": "resnet", "relu_type": "prelu",
        "tcn_kernel_size": [3], "tcn_num_layers": 2, "tcn_dropout": 0.0,
        "tcn_dwpw": False, "tcn_width_mult": 1, "width_mult": 1.0,
    })
    with tempfile.TemporaryDirectory(prefix="parity_video_") as exp_root:
        trainer = VideoTrainer(cfg, n_classes, device=dev, lr=lr, weight_decay=weight_decay,
                               t_max=steps, crop_size=(hw, hw), exp_root=exp_root,
                               hidden_dim=hidden, trunk_layers=layers)
    trainer.model.to(torch.float64 if dtype == "float64" else torch.float32)
    # identical init: the replica's snapshot over the network's own state
    trainer.model.load_state_dict(
        {**trainer.model.state_dict(),
         **import_lipreading_state_dict(tnet_init_sd, layers=layers, float_dtype=np_dtype)},
        strict=True)
    lens = torch.tensor(lengths).to(dev)
    ours_losses = []
    for k in range(steps):
        metrics = trainer.train_step_frames(torch.tensor(frames[k])[..., None].to(dev), lens,
                                            torch.tensor(labels[k]).to(dev))
        ours_losses.append(float(metrics["loss"]))
        if k == 0:   # the trainer leaves the step's gradients in .grad
            ours_grads = {n: p.grad.detach().clone()
                          for n, p in trainer.model.named_parameters()}

    ref = import_lipreading_state_dict(ref_sd, layers=layers, float_dtype=np_dtype)
    ours = trainer.model.state_dict()
    params = _param_keys(ref)
    drift = max_drift(ours, ref, params)
    stats_drift = max_drift(ours, ref, [k for k in ref if _stat_key(k)])
    loss_diffs = [abs(a - b) for a, b in zip(torch_losses, ours_losses)]
    report = {
        "kind": "video",
        "dtype": dtype,
        "device": str(dev),
        "steps": steps,
        "torch_losses": torch_losses,
        "deeplip_losses": ours_losses,
        "max_loss_abs_diff": max(loss_diffs),
        "final_param_max_drift": drift,
        "final_batch_stats_max_drift": stats_drift,
        "param_drift_bar_1e-5": drift <= DRIFT_BAR,
    }
    if dtype == "float32":
        grads = lambda g: import_lipreading_state_dict(  # noqa: E731
            g, layers=layers, float_dtype=np_dtype)
        ref_g = grads(ref_grads)
        nudged = []
        for i in range(NUDGES):
            nudge = np.random.default_rng(seed + 1 + i).standard_normal(frames.shape)
            n_losses, n_sd, n_grads = _torch_video_run(
                tnet_init_sd, build, (frames * (1.0 + NUDGE * nudge)).astype(np_dtype), labels,
                lengths, lr, weight_decay, steps, dtype)
            n_ref = import_lipreading_state_dict(n_sd, layers=layers, float_dtype=np_dtype)
            nudged.append((n_losses, distance(n_ref, ref, params),
                           distance(grads(n_grads), ref_g, list(ref_g))))
        report.update(_step_rule(torch_losses, ours_losses, distance(ours, ref, params), nudged,
                                 distance(ours_grads, ref_g, list(ref_g))))
    return report


def _torch_fusion_run(models, inits, pcm, clips_u8, clip_lengths, group_sizes, labels,
                      steps, lr, momentum, weight_decay, crop, hw, np_dtype, frame_nudge=None):
    """The reference fusion recipe's loop (the reference's
    train_fusion.py:241-315): frozen eval-mode encoders, a batch-1 video
    embedding per clip with its time mean, then the group mean, bad pairs
    dropped, the LowFER head, CE, SGD over the head and the criterion,
    MultiStepLR [4, 8] stepped per iteration. ``frame_nudge(k, i, j, x)``
    nudges a transformed clip. Returns the losses and the head's and the
    criterion's final state dicts."""
    tnet_a, tnet_v, thead, tcrit = models
    thead.load_state_dict(inits[0])
    tcrit.load_state_dict(inits[1])
    opt = torch.optim.SGD(
        [{"params": thead.parameters()}, {"params": tcrit.parameters()}],
        lr=lr, momentum=momentum, weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.MultiStepLR(opt, milestones=[4, 8], gamma=0.1)
    mean, std = 0.421, 0.165
    off = (hw - crop) // 2
    tdt = torch.float64 if np_dtype == np.float64 else torch.float32
    d = tnet_a.fc2.out_features
    bs = pcm.shape[1]

    def transform(clip_u8):  # (T, hw, hw) u8 -> tensor, f32 math
        c = clip_u8[:, off:off + crop, off:off + crop]
        x = (c.astype(np.float32) / np.float32(255.0) - np.float32(mean)) / np.float32(std)
        return torch.tensor(x.astype(np_dtype))

    def vfeats(x):  # (1, 1, T, H, W) -> (T, 512) trunk frame features
        h = tnet_v.frontend3D(x)
        t = h.shape[2]
        h = h.transpose(1, 2).reshape(t, h.shape[1], h.shape[3], h.shape[4])
        return tnet_v.trunk(h)

    losses = []
    for k in range(steps):
        opt.zero_grad()
        with torch.no_grad():
            feats = np.stack([numpy_mfcc(pcm[k, i].astype(np.float64)) for i in range(bs)])
            x = torch.tensor(np.transpose(feats, (0, 2, 1)).astype(np_dtype))
            h = tnet_a.tdnn(x)
            stats = torch.cat([h.mean(2), h.std(2)], 1)
            xv_audio = tnet_a.fc2(tnet_a.act(tnet_a.bn1(tnet_a.fc1(stats))))
            em_video, mask = [], []
            for i in range(bs):
                if group_sizes[i] > 0:
                    em = 0
                    for j in range(group_sizes[i]):
                        v = transform(clips_u8[k, i, j, :clip_lengths[i, j]])
                        if frame_nudge is not None:
                            v = frame_nudge(k, i, j, v)
                        em = em + vfeats(v[None, None]).mean(0)
                    em_video.append(em / int(group_sizes[i]))
                    mask.append(True)
                else:  # bad pair: dropped before the loss
                    em_video.append(torch.zeros(d, dtype=tdt))
                    mask.append(False)
            em_video = torch.stack(em_video)
        keep = torch.tensor(mask)
        out = thead(xv_audio[keep], em_video[keep])
        loss, _ = tcrit(out, torch.tensor(labels[k])[keep])
        loss.backward()
        opt.step()
        sched.step()
        losses.append(float(loss.item()))
    return losses, thead.state_dict(), tcrit.state_dict()


def run_fusion_train_parity(steps=10, bs=4, g=2, t_clip=5, hw=48,
                            crop=44, n_spk=6, lr=0.5, momentum=0.9,
                            weight_decay=1e-5, seed=0, dtype="float64", device="cpu"):
    """Fusion train-STEP parity: N optimizer updates of the reference fusion
    recipe from the same init on the same raw inputs (PCM and uint8 clips),
    the replica on the CPU and the port's ``FusionTrainer.train_step`` on
    ``device``: the full step, the port's front-end (on the card the FFT
    kernel) and its dense padded clip-group embedding (the max-pool kernel)
    included. LowFER's U/V receive no gradient (the MFB branch is
    overwritten), so torch's SGD leaves them alone, and so must the port.
    The video transform is float32 on both sides (the reference casts at its
    FloatTensor step), then fed to the encoders in ``dtype``."""
    np_dtype = _np_dtype(dtype)
    dev = torch.device(device)
    _require_f64_on_cpu(dtype, dev, "the fusion train parity")
    tdt = torch.float64 if dtype == "float64" else torch.float32
    d = 512  # audio emb dim == video backend_out (LowFER gate needs d1==d2)
    contexts = [[-2, -1, 0, 1, 2], [-2, 0, 2], [0]]
    hidden = [32, 32, 64]
    layers = (1, 1, 1, 1)
    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)

    # ---- torch side: frozen encoders + trainable head/criterion
    tnet_a = build_torch_net(torch, contexts, [24] + hidden, d).to(tdt).eval()
    tnet_v = build_torch_lipreading(torch, n_spk, hidden_dim=8, tcn_layers=2, layers=layers)
    tnet_v = tnet_v.to(tdt).eval()
    thead = build_torch_lowfer(torch, d, o=d, k=30, seed=seed + 1).to(tdt)
    tcrit = build_torch_ce(torch, 3 * d, n_spk).to(tdt)
    inits = (copy.deepcopy(thead.state_dict()), copy.deepcopy(tcrit.state_dict()))

    # ---- shared raw inputs
    n_samples = 16000
    pcm = (0.1 * rng.standard_normal((steps, bs, n_samples))).astype(np_dtype)
    clips_u8 = rng.integers(0, 256, (steps, bs, g, t_clip, hw, hw), np.uint8)
    clip_lengths = np.array([[5, 3], [4, 0], [0, 0], [5, 5]], np.int32)[:bs]
    group_sizes = np.array([2, 1, 0, 2], np.int32)[:bs]
    labels = rng.integers(0, n_spk, (steps, bs)).astype(np.int64)

    run_args = (clips_u8, clip_lengths, group_sizes, labels, steps, lr, momentum,
                weight_decay, crop, hw, np_dtype)
    models = (tnet_a, tnet_v, thead, tcrit)
    torch_losses, ref_head, ref_crit = _torch_fusion_run(models, inits, pcm, *run_args)

    # ---- the port's FusionTrainer with the identical recipe
    audio_model_opts = {"arch": "tdnn", "tdnn": {
        "input_dim": 24, "hidden_dim": hidden, "context": contexts,
        "tdnn_layers": len(contexts), "embedding_dim": d,
        "pooling": "statistic", "attention_hidden_size": 8,
        "bn_first": True}}
    video_cfg = Config({
        "backbone_type": "resnet", "relu_type": "prelu",
        "tcn_kernel_size": [3], "tcn_num_layers": 2, "tcn_dropout": 0.0,
        "tcn_dwpw": False, "tcn_width_mult": 1, "width_mult": 1.0})
    with tempfile.TemporaryDirectory(prefix="parity_fusion_") as exp_root:
        trainer = FusionTrainer(
            audio_model_opts, video_cfg, n_spk=n_spk, audio_data_opts=AUDIO_DATA,
            device=dev, lr=lr, momentum=momentum, weight_decay=weight_decay,
            lr_decay_step=(4, 8), steps_per_epoch=1, crop_size=(crop, crop),
            video_hidden_dim=8, video_trunk_layers=layers, loss="CrossEntropy",
            exp_root=exp_root)
    for module in (trainer.audio_model, trainer.video_model, trainer.fusion_head,
                   trainer.criterion):
        module.to(tdt)
    trainer.load_state_dicts(
        audio=import_speaker_embnet_state_dict(tnet_a.state_dict(), n_blocks=len(contexts),
                                               float_dtype=np_dtype),
        video={**trainer.video_model.state_dict(),
               **import_lipreading_state_dict(tnet_v.state_dict(), layers=layers,
                                              float_dtype=np_dtype)},
        head={**trainer.fusion_head.state_dict(),
              **{k: v.to(tdt) for k, v in inits[0].items()}},
        criterion=import_criterion_state_dict(inits[1], float_dtype=np_dtype))
    trainer.build_optimizer()
    to_dev = lambda a: torch.tensor(a).to(dev)  # noqa: E731
    ours_losses = []
    for k in range(steps):
        metrics = trainer.train_step(to_dev(pcm[k]), to_dev(clips_u8[k]), to_dev(clip_lengths),
                                     to_dev(group_sizes), to_dev(labels[k]))
        ours_losses.append(float(metrics["loss"]))

    ours = {**{f"fusion.{k}": v for k, v in trainer.fusion_head.state_dict().items()},
            **{f"criterion.{k}": v for k, v in trainer.criterion.state_dict().items()}}
    ref = {**{f"fusion.{k}": v for k, v in ref_head.items()},
           **{f"criterion.{k}": v for k, v in
              import_criterion_state_dict(ref_crit, float_dtype=np_dtype).items()}}
    keys = [k for k in ref if ref[k].is_floating_point()]
    drift = max_drift(ours, ref, keys)
    dead_drift = max_drift(ours, ref, ["fusion.U", "fusion.V"])
    loss_diffs = [abs(a - b) for a, b in zip(torch_losses, ours_losses)]
    report = {
        "kind": "fusion",
        "dtype": dtype,
        "device": str(dev),
        "steps": steps,
        "torch_losses": torch_losses,
        "deeplip_losses": ours_losses,
        "max_loss_abs_diff": max(loss_diffs),
        "final_param_max_drift": drift,
        "dead_param_max_drift": dead_drift,
        "param_drift_bar_1e-5": drift <= DRIFT_BAR,
    }
    if dtype == "float32":
        nudged = []
        for i in range(NUDGES):
            nrng = np.random.default_rng(seed + 1 + i)
            nudged_pcm = (pcm * (1.0 + NUDGE * nrng.standard_normal(pcm.shape))
                          ).astype(np_dtype)
            gen = torch.Generator().manual_seed(seed + 1 + i)

            def frame_nudge(k, i, j, x):
                return x * (1.0 + NUDGE * torch.randn(x.shape, generator=gen, dtype=x.dtype))

            n_losses, n_head, n_crit = _torch_fusion_run(models, inits, nudged_pcm, *run_args,
                                                         frame_nudge=frame_nudge)
            n_ref = {**{f"fusion.{k}": v for k, v in n_head.items()},
                     **{f"criterion.{k}": v for k, v in
                        import_criterion_state_dict(n_crit, float_dtype=np_dtype).items()}}
            nudged.append((n_losses, distance(n_ref, ref, keys)))
        report.update(_step_rule(torch_losses, ours_losses, distance(ours, ref, keys), nudged))
    return report


# ---------------------------------------------------------------------------
# the forward protocol

def order_flips(labels: np.ndarray, s_ref: np.ndarray, s_ours: np.ndarray,
                limit: int = 20) -> dict:
    """The (target, non-target) trial pairs whose order differs between the
    two score lists, the only pairs an EER can tell apart. A flip needs the
    two reference scores within the sum of their two score differences, so
    only non-targets that close to each target are looked at. Returns their
    count and the first ``limit`` with both sides' gaps."""
    diff = np.abs(s_ours - s_ref)
    window = 2.0 * float(diff.max())
    tgt = np.flatnonzero(labels == 1)
    non = np.flatnonzero(labels == 0)
    order = np.argsort(s_ref[non], kind="stable")
    non_sorted, s_non = non[order], s_ref[non][order]
    flips = []
    for t in tgt:
        lo, hi = np.searchsorted(s_non, [s_ref[t] - window, s_ref[t] + window])
        for n in non_sorted[lo:hi]:
            ref_gap, ours_gap = s_ref[t] - s_ref[n], s_ours[t] - s_ours[n]
            if (ref_gap > 0) != (ours_gap > 0) or (ref_gap == 0) != (ours_gap == 0):
                flips.append({"target": int(t), "nontarget": int(n),
                              "ref_gap": float(ref_gap), "ours_gap": float(ours_gap)})
    return {"count": len(flips), "window": window, "first": flips[:limit]}


def _extraction_config(arch: str, emb_dim: int) -> Config:
    spec = ARCHS[arch]
    return Config({
        "data": {"frames": [200, 400], "python_data_config": AUDIO_DATA},
        "model": {"arch": arch, arch: {
            "input_dim": 24, "hidden_dim": spec["hidden_dim"],
            "context": spec["context"], "tdnn_layers": len(spec["context"]),
            "embedding_dim": emb_dim, "pooling": "statistic",
            "attention_hidden_size": 64, "bn_first": True}},
        "train": {"loss": "LMCL"},
        "test": {},
    })


def run_protocol(args, device: torch.device) -> dict:
    """The forward harness: the reference pipeline per utterance on the
    CPU, the port's extractor batched on ``device``, then embeddings,
    scores and both EERs compared. ``--selftest``/``--full`` synthesize
    their corpus and checkpoint in a directory removed at the end."""
    if not args.selftest:
        return _protocol(args, device, None)
    with tempfile.TemporaryDirectory(prefix="parity_") as work:
        return _protocol(args, device, work)


def _protocol(args, device: torch.device, work: str | None) -> dict:
    spec = ARCHS[args.arch]
    contexts = spec["context"]
    dims = [24] + spec["hidden_dim"]
    full = args.full
    n_spk = args.n_spk or (20 if full else 3)
    utts_per_spk = args.utts_per_spk or (20 if full else 3)
    n_trials = args.n_trials or (20000 if full else 100)
    train_steps = args.train_steps if args.train_steps is not None else (60 if full else 0)
    feats = {}   # the reference's float32 features by utterance, computed once

    if work is not None:
        make_audio_corpus(work, n_spk=n_spk, utts_per_spk=utts_per_spk, duration=1.5)
        manifest = SpeakerManifest.load(os.path.join(work, "manifest.csv"))
        trials_path = os.path.join(work, "trials.txt")
        make_trial_list(trials_path, manifest, n_trials=n_trials,
                        balance=0.5 if full else None)
        # the reference net from a seed: torch seeds its generator afresh in
        # every process, which would make each run score another network
        torch.manual_seed(0)
        tnet = build_torch_net(torch, contexts, dims, args.emb_dim)
        with torch.no_grad():
            for m in tnet.modules():
                if isinstance(m, torch.nn.BatchNorm1d):
                    m.running_mean.normal_(0, 0.3)
                    m.running_var.uniform_(0.5, 2.0)
        if train_steps:
            labels = {}
            for s, u in manifest.all_utterances():
                name = "/".join(u.path.split(os.sep)[-2:])
                y, _ = read_wav(u.path)
                feats[name] = numpy_mfcc(y.astype(np.float64)).astype(np.float32)
                labels[name] = s
            # on the card the fit runs there (FP32, deterministic); the
            # reference pipeline below runs on the CPU either way
            with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                            allow_tf32=False):
                train_torch_net(torch, tnet, feats, labels, args.emb_dim, n_spk=n_spk,
                                steps=train_steps, device=device)
        ckpt_path = os.path.join(work, "net_ref.pth")
        torch.save({"epoch": 0, "state_dict": tnet.state_dict()}, ckpt_path)
        wav_root = work
    else:
        if not (args.ckpt and args.wav_root and args.trials):
            raise SystemExit("need --ckpt --wav-root --trials (or --selftest)")
        ckpt_path, wav_root, trials_path = args.ckpt, args.wav_root, args.trials
        tnet = build_torch_net(torch, contexts, dims, args.emb_dim)
        sd = torch.load(ckpt_path, map_location="cpu", weights_only=False)
        sd = sd.get("state_dict", sd)
        tnet.load_state_dict({k.replace("module.", ""): v for k, v in sd.items()
                              if not k.startswith(("fc3", "module.fc3"))})

    trials = TrialList.load(trials_path)
    utts = [EvalUtterance(n, os.path.join(wav_root, n)) for n in trials.unique_utts]

    # ---- torch reference pipeline (per utterance, numpy MFCC, CPU f32)
    torch_store = EmbeddingStore()
    with torch.no_grad():
        for u in utts:
            if u.name not in feats:
                y, _ = read_wav(u.path)
                feats[u.name] = numpy_mfcc(y.astype(np.float64)).astype(np.float32)
            xv = tnet.extract(torch.from_numpy(np.ascontiguousarray(feats[u.name].T[None])))
            torch_store[u.name] = xv.numpy()[0]

    # ---- the port (batched on the device)
    extractor = AudioExtractor(_extraction_config(args.arch, args.emb_dim), device=device)
    tree = read_checkpoint(ckpt_path)
    extractor.load_state_dict(import_speaker_embnet_state_dict(
        tree.get("state_dict", tree), n_blocks=len(contexts)))
    ours_store = extractor.extract_embeddings(
        EvalUtteranceSet(utts, batch_size=32 if full else 8, bucket_frames=50,
                         num_workers=4 if full else 2))

    # ---- compare, both EERs scored the same way on the CPU
    ours_cpu = EmbeddingStore()
    for name in trials.unique_utts:
        ours_cpu[name] = ours_store[name].detach().cpu()
    diffs = [float((ours_cpu[u.name] - torch_store[u.name]).abs().max()) for u in utts]
    order = np.argsort(diffs)[::-1]
    print("  worst utterances:", file=sys.stderr)
    for i in order[:5]:
        print(f"    {utts[i].name}: {diffs[i]:.3e}", file=sys.stderr)
    print(f"  diff percentiles p50={np.percentile(diffs, 50):.3e} "
          f"p90={np.percentile(diffs, 90):.3e} max={max(diffs):.3e}", file=sys.stderr)
    index = {u: i for i, u in enumerate(trials.unique_utts)}
    pairs = trials.index_pairs(index)
    s_ref = cosine_scores_np(torch_store.matrix(trials.unique_utts).numpy(), pairs)
    s_ours = cosine_scores_np(ours_cpu.matrix(trials.unique_utts).numpy(), pairs)
    eer_ref, _ = cosine_eer(trials, torch_store, device="cpu")
    eer_ours, _ = cosine_eer(trials, ours_cpu, device="cpu")
    return {
        "n_utterances": len(utts),
        "n_trials": len(trials),
        "max_embedding_abs_diff": max(diffs),
        "max_trial_score_abs_diff": float(np.abs(s_ref - s_ours).max()),
        "eer_reference_torch": eer_ref,
        "eer_deeplip_tpu": eer_ours,
        "eer_bit_equal": eer_ref == eer_ours,
        "embedding_parity_bar_1e-4": max(diffs) <= EMB_BAR,
        "order_flips": order_flips(np.asarray(trials.labels), s_ref, s_ours),
        "device": str(device),
    }


def _finish(report: dict, args, t0: float) -> None:
    report["launches"] = launch_counts()
    report["seconds"] = time.perf_counter() - t0
    print(json.dumps(report, indent=2), flush=True)
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", default=None, help="reference net_*.pth (torch)")
    p.add_argument("--wav-root", default=None)
    p.add_argument("--trials", default=None)
    p.add_argument("--arch", default="etdnn", choices=list(ARCHS))
    p.add_argument("--emb-dim", type=int, default=512)
    p.add_argument("--selftest", action="store_true",
                   help="synthesize checkpoint + corpus + trials")
    p.add_argument("--full", action="store_true",
                   help="complete 20k-trial GRID protocol on a synthetic corpus; asserts "
                        "bit-equal EER")
    p.add_argument("--train-parity", action="store_true",
                   help="N-step optimizer-update parity vs torch (LMCL + CrossEntropy "
                        "recipes); asserts final param drift <= 1e-5")
    p.add_argument("--train-parity-video", action="store_true",
                   help="N-step video-recipe parity vs torch (Lipreading + CE + torch Adam + "
                        "per-iteration cosine)")
    p.add_argument("--train-parity-fusion", action="store_true",
                   help="N-step fusion-recipe parity vs torch (frozen encoders + LowFER + CE + "
                        "SGD over head/criterion only, bad-pair masking, the full step from "
                        "raw PCM + uint8 clips)")
    p.add_argument("--n-spk", type=int, default=None)
    p.add_argument("--utts-per-spk", type=int, default=None)
    p.add_argument("--n-trials", type=int, default=None)
    p.add_argument("--train-steps", type=int, default=None,
                   help="torch pre-training steps before the comparison (train-parity "
                        "modes: the steps compared)")
    p.add_argument("--report", default=None, help="also write the JSON here")
    p.add_argument("--device", default=None, choices=[None, "cpu"],
                   help="run the port on the CPU (default: the card)")
    args = p.parse_args(argv)
    t0 = time.perf_counter()

    from deeplip_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)
    if args.full:
        args.selftest = True

    if args.train_parity:
        steps = args.train_steps if args.train_steps is not None else 12
        reports = {}
        failed = False
        # CE is smooth enough to hold the 1e-5 bar in f32; LMCL's scale-30
        # softmax is chaotically sensitive (x~4 noise amplification per
        # step), so its pass/fail run is f64 and an informational f32 run
        # documents the amplification
        for loss_name, dt, enforce in (("CrossEntropy", "float32", True),
                                       ("LMCL", "float64", True),
                                       ("LMCL", "float32", False)):
            r = run_train_parity(loss_name=loss_name, steps=steps, dtype=dt, device=device)
            r["enforced"] = enforce
            reports[f"{loss_name}_{dt}"] = r
            if enforce:
                failed |= not r["param_drift_bar_1e-5"]
        _finish(reports, args, t0)
        if failed:
            raise SystemExit(3)
        return reports

    if args.train_parity_video or args.train_parity_fusion:
        steps = args.train_steps if args.train_steps is not None else 10
        run = run_video_train_parity if args.train_parity_video else run_fusion_train_parity
        # the CUDA kernels take float32: the card is held to the f32 step rule
        dtype = "float64" if device.type == "cpu" else "float32"
        seed = VIDEO_F32_SEED if args.train_parity_video and dtype == "float32" else 0
        r = run(steps=steps, dtype=dtype, device=device, seed=seed)
        _finish(r, args, t0)
        held = r["f32_step_rule"] if dtype == "float32" else r["param_drift_bar_1e-5"]
        if not held:
            raise SystemExit(3)
        return r

    report = run_protocol(args, device)
    _finish(report, args, t0)
    if not report["embedding_parity_bar_1e-4"]:
        raise SystemExit(1)
    if args.full and not report["eer_bit_equal"]:
        raise SystemExit(2)
    return report


if __name__ == "__main__":
    main()
