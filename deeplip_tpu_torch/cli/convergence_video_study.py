"""Epoch-scale video convergence study: the reference recipe's torch
replica against the port's ``VideoTrainer``.

Counterpart of ``scripts/convergence_video_study.py``, with the same corpus,
batch stream, trial pairs, recipe and report: the per-iteration cosine
schedule and the BN running statistics over hundreds of optimizer steps,
ending in held-out accuracy and EER.

Protocol:

- one deliberately hard synthetic lip-clip corpus: every speaker's "mouth"
  blob is drawn from a tight shared parameter band (center +-4 %, width
  +-15 %) under strong pixel noise, so speakers are separable but not
  trivially;
- one shared batch stream from seed 42: speaker-balanced sampling and the
  reference train transforms (Normalize(0, 255), RandomCrop(44),
  HorizontalFlip(0.5), Normalize(0.421, 0.165); the reference's
  models/video_models/dataloaders.py:13-17) applied in shared numpy, so both
  sides see the same frames;
- one shared init: the replica's, loaded by the port;
- the reference video recipe on both sides (the reference's
  train_video.py:108-169): Adam 3e-4 with coupled weight decay 1e-4, CE,
  CosineAnnealingLR(T_max=5) stepped per iteration; dropout 0.

The port steps with ``VideoTrainer.train_step_frames``, where on the card
the fused BN+PReLU kernels (K3 forward, K4 backward) and the frontend
max-pool's forward and backward kernels run in every step; its eval (the
max-pool forward again) gives the logits and the time-mean trunk features.
Each epoch both sides report the mean train loss, the held-out accuracy and
the cosine EER over time-mean trunk-feature embeddings (the fusion
back-ends' video embedding) on 1,500 trial pairs from seed 7.

Where this differs from the JAX script, and why: as
``cli/convergence_study.py`` says (both sides on ``--device``, the replica
in FP32 with TF32 off and cuDNN deterministic on the card, ``--nudges``
nudging the replica's frames, the report's keys and the default ``--out``).
``--arch study`` keeps the JAX script's widths (TCN width 8, one BasicBlock
a trunk stage, 2 TCN layers); ``--arch flagship`` takes ``VideoTrainer``'s
trunk (hidden 256, two blocks a stage: K3/K4 and the max-pool at 64 to 512
channels) with a single-branch kernel-3 TCN of 4 layers, the one form the
replica (``parity_check.build_torch_lipreading``) has.

Run: ``python -m deeplip_tpu_torch.cli.convergence_video_study [--device
cpu] [--arch flagship] [--nudges 3] [--epochs 14] [--out PREFIX]``.
"""

from __future__ import annotations

import copy
import sys
import tempfile
import time

import numpy as np
import torch

from deeplip_tpu_torch.cli import parity_check as PC
from deeplip_tpu_torch.cli.parity_check import (epoch_loss_gap, finish_study, nudge_array,
                                               nudge_rng, nudged_entry, replica_math,
                                               study_parser)
from deeplip_tpu_torch.core.config import Config
from deeplip_tpu_torch.core.device import fp32_math, resolve_device
from deeplip_tpu_torch.eval.eer import eer_from_scores
from deeplip_tpu_torch.interop.torch_import import import_lipreading_state_dict
from deeplip_tpu_torch.train.video import VideoTrainer

N_SPK = 10
CLIPS_PER_SPK = 12  # 8 train / 4 eval
T_FRAMES = 10
RAW = 48
CROP = 44
EPOCHS = 8
STEPS_PER_EPOCH = 20
BS = 8
LR, WD, T_MAX = 3e-4, 1e-4, 5
MEAN, STD = 0.421, 0.165
WIDTHS = {
    "study": {"hidden_dim": 8, "trunk_layers": (1, 1, 1, 1), "tcn_layers": 2},
    "flagship": {"hidden_dim": 256, "trunk_layers": (2, 2, 2, 2), "tcn_layers": 4},
}


def make_hard_clip(rng, srng_params, t, size, noise=0.35):
    """(T, size, size) uint8: near-identical mouth blobs across speakers.

    ``noise`` scales the per-frame Gaussian noise floor: the fusion study's
    non-saturating variant raises it so speaker identity stays partially
    ambiguous at the eval horizon."""
    cx, cy, sx, sy = srng_params
    yy, xx = np.mgrid[0:size, 0:size]
    frames = np.empty((t, size, size), np.uint8)
    phase = rng.uniform(0, 2 * np.pi)
    for i in range(t):
        wob = 1.5 * np.sin(2 * np.pi * i / t + phase)
        blob = np.exp(-(((xx - cx - wob) / sx) ** 2 + ((yy - cy + wob) / sy) ** 2))
        frames[i] = np.clip(
            (blob + noise * rng.standard_normal((size, size))) * 200,
            0, 255).astype(np.uint8)
    return frames


def make_corpus(seed=0):
    """The study's clips ``(N_SPK * CLIPS_PER_SPK, T, RAW, RAW)`` uint8 and
    their speaker labels."""
    rng = np.random.default_rng(seed)
    clips, labels = [], []
    for s in range(N_SPK):
        srng = np.random.default_rng(1000 + s)
        params = (
            RAW * (0.5 + srng.uniform(-0.04, 0.04)),
            RAW * (0.5 + srng.uniform(-0.04, 0.04)),
            10.0 * (1 + srng.uniform(-0.15, 0.15)),
            10.0 * (1 + srng.uniform(-0.15, 0.15)),
        )
        for _ in range(CLIPS_PER_SPK):
            clips.append(make_hard_clip(rng, params, T_FRAMES, RAW))
            labels.append(s)
    return np.stack(clips), np.asarray(labels)


def train_transform(rng, clip_u8):
    """The reference train pipeline in shared numpy (dataloaders.py:13-17),
    float32 math as ``ops/video.py``."""
    x = clip_u8.astype(np.float32) / np.float32(255.0)
    oy = int(rng.integers(0, RAW - CROP + 1))
    ox = int(rng.integers(0, RAW - CROP + 1))
    x = x[:, oy:oy + CROP, ox:ox + CROP]
    if rng.uniform() < 0.5:
        x = x[:, :, ::-1]
    return ((x - np.float32(MEAN)) / np.float32(STD)).astype(np.float32)


def eval_transform(clip_u8):
    off = (RAW - CROP) // 2
    x = clip_u8.astype(np.float32) / np.float32(255.0)
    x = x[:, off:off + CROP, off:off + CROP]
    return ((x - np.float32(MEAN)) / np.float32(STD)).astype(np.float32)


def shared_data(epochs: int) -> dict:
    """The corpus split, the train batch stream (seed 42), the eval frames
    and the trial pairs (seed 7), as the JAX script draws them."""
    clips, labels = make_corpus()
    train_idx = [i for i in range(len(clips)) if i % CLIPS_PER_SPK < 8]
    eval_idx = [i for i in range(len(clips)) if i % CLIPS_PER_SPK >= 8]
    rng = np.random.default_rng(42)
    by_spk = {}
    for i in train_idx:
        by_spk.setdefault(int(labels[i]), []).append(i)
    batches = []
    for step in range(epochs * STEPS_PER_EPOCH):
        f, y = [], []
        for b in range(BS):
            spk = (step * BS + b) % N_SPK  # idx % n_spk balance
            ci = by_spk[spk][int(rng.integers(len(by_spk[spk])))]
            f.append(train_transform(rng, clips[ci]))
            y.append(spk)
        batches.append((np.stack(f), np.asarray(y, np.int64)))
    eval_labels = labels[eval_idx]
    trng = np.random.default_rng(7)
    pairs = trng.integers(0, len(eval_idx), (1500, 2))
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    trial_labels = (eval_labels[pairs[:, 0]] == eval_labels[pairs[:, 1]]).astype(np.int8)
    return {"batches": batches,
            "eval_frames": np.stack([eval_transform(clips[i]) for i in eval_idx]),
            "eval_labels": eval_labels, "pairs": pairs, "trial_labels": trial_labels}


def train_replica(tnet, data: dict, evaluate, epochs: int, device,
                  rng: np.random.Generator | None = None) -> dict:
    """The reference video recipe's loop with the cosine rate stepped per
    iteration (the reference's train_video.py:140-143); ``rng`` nudges each
    batch's frames."""
    opt = torch.optim.Adam(tnet.parameters(), lr=LR, weight_decay=WD)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=T_MAX)
    lengths = [T_FRAMES] * BS
    curve = {"loss": [], "acc": [], "eer": []}
    tnet.train()
    for e in range(epochs):
        ep_loss = []
        for k in range(STEPS_PER_EPOCH):
            f, y = data["batches"][e * STEPS_PER_EPOCH + k]
            if rng is not None:
                f = nudge_array(f, rng)
            opt.zero_grad()
            out = tnet(torch.tensor(f)[:, None].to(device), lengths)
            loss = torch.nn.functional.cross_entropy(out, torch.tensor(y).to(device))
            loss.backward()
            opt.step()
            sched.step()  # per ITERATION (train_video.py:140-143 quirk)
            ep_loss.append(loss.detach())
        acc, eer = evaluate(tnet)
        curve["loss"].append(float(np.mean([float(v) for v in ep_loss])))
        curve["acc"].append(acc)
        curve["eer"].append(eer)
        print(f"[torch] epoch {e+1}: loss={curve['loss'][-1]:.4f} "
              f"acc={acc*100:.1f}% eer={eer*100:.2f}%", file=sys.stderr)
    return curve


def main(argv=None) -> dict:
    args = study_parser(__doc__, EPOCHS, "video").parse_args(argv)
    t0 = time.perf_counter()
    device = resolve_device(args.device)
    width = WIDTHS[args.arch]
    layers, hidden = width["trunk_layers"], width["hidden_dim"]
    epochs = args.epochs
    data = shared_data(epochs)
    eval_labels, pairs = data["eval_labels"], data["pairs"]
    n_eval = len(eval_labels)
    t_data = time.perf_counter() - t0

    def eer_from_embs(embs):
        e = embs / np.linalg.norm(embs, axis=-1, keepdims=True).clip(1e-12)
        scores = np.sum(e[pairs[:, 0]] * e[pairs[:, 1]], -1)
        return float(eer_from_scores(data["trial_labels"], scores)[0])

    def replica_eval(tnet):
        tnet.eval()
        with torch.no_grad():
            x = torch.tensor(data["eval_frames"])[:, None].to(device)
            logits = tnet(x, [T_FRAMES] * n_eval)
            acc = float((logits.argmax(-1).cpu().numpy() == eval_labels).mean())
            h = tnet.frontend3D(x)   # (B, 1, T, H, W) -> (B, T, 512) trunk features
            b, t = h.shape[0], h.shape[2]
            h = h.transpose(1, 2).reshape(b * t, h.shape[1], h.shape[3], h.shape[4])
            embs = tnet.trunk(h).reshape(b, t, -1).mean(1).cpu().numpy()
        tnet.train()
        return acc, eer_from_embs(embs)

    def build():
        return PC.build_torch_lipreading(torch, N_SPK, hidden_dim=hidden,
                                         tcn_layers=width["tcn_layers"], layers=layers)

    # ---- the torch replica, then its nudged runs from the same init
    torch.manual_seed(0)
    tnet = build()
    tnet_init_sd = copy.deepcopy(tnet.state_dict())
    print("[torch] training...", file=sys.stderr)
    with replica_math():
        torch_curve = train_replica(tnet.to(device), data, replica_eval, epochs, device)
    t_replica = time.perf_counter() - t0 - t_data
    runs = []
    for i in range(args.nudges):
        with torch.random.fork_rng(devices=[]):
            n_net = build()
        n_net.load_state_dict(tnet_init_sd)
        print(f"[torch] nudged run {i + 1}...", file=sys.stderr)
        with replica_math():
            run = train_replica(n_net.to(device), data, replica_eval, epochs, device,
                                rng=nudge_rng(i))
        runs.append(nudged_entry(torch_curve, run, {"final_acc_abs_gap": "acc",
                                                    "final_eer_abs_gap": "eer"}))
    t_nudged = time.perf_counter() - t0 - t_data - t_replica

    # ---- the port, from the replica's init
    cfg = Config({
        "backbone_type": "resnet", "relu_type": "prelu",
        "tcn_kernel_size": [3], "tcn_num_layers": width["tcn_layers"], "tcn_dropout": 0.0,
        "tcn_dwpw": False, "tcn_width_mult": 1, "width_mult": 1.0,
    })
    with tempfile.TemporaryDirectory(prefix="converge_video_") as exp_root:
        trainer = VideoTrainer(cfg, N_SPK, device=device, lr=LR, weight_decay=WD, t_max=T_MAX,
                               crop_size=(CROP, CROP), hidden_dim=hidden, trunk_layers=layers,
                               exp_root=exp_root)
    trainer.model.load_state_dict(
        {**trainer.model.state_dict(),
         **import_lipreading_state_dict(tnet_init_sd, layers=layers)}, strict=True)
    model = trainer.model
    ex = torch.from_numpy(data["eval_frames"])[..., None].to(device)
    elens = torch.full((n_eval,), T_FRAMES, dtype=torch.int32, device=device)
    lens = torch.full((BS,), T_FRAMES, dtype=torch.int32, device=device)
    ours_curve = {"loss": [], "acc": [], "eer": []}
    print("[port] training...", file=sys.stderr)
    for e in range(epochs):
        ep_loss = []
        for k in range(STEPS_PER_EPOCH):
            f, y = data["batches"][e * STEPS_PER_EPOCH + k]
            metrics = trainer.train_step_frames(torch.from_numpy(f)[..., None].to(device), lens,
                                                torch.from_numpy(y).to(device))
            ep_loss.append(metrics["loss"])
        model.eval()
        with torch.no_grad(), fp32_math():
            logits = model(ex, lengths=elens)
            embs = model.frame_features(ex).mean(dim=1)
        acc = float((logits.argmax(-1).cpu().numpy() == eval_labels).mean())
        eer = eer_from_embs(embs.cpu().numpy())
        ours_curve["loss"].append(float(np.mean([float(v) for v in ep_loss])))
        ours_curve["acc"].append(acc)
        ours_curve["eer"].append(eer)
        print(f"[port] epoch {e+1}: loss={ours_curve['loss'][-1]:.4f} "
              f"acc={acc*100:.1f}% eer={eer*100:.2f}%", file=sys.stderr)
    t_port = time.perf_counter() - t0 - t_data - t_replica - t_nudged

    # ---- report
    gap = epoch_loss_gap(torch_curve, ours_curve)
    n_target = int(data["trial_labels"].sum())
    quanta = {"final_acc_abs_gap": 1.0 / n_eval,
              "final_eer_abs_gap": 1.0 / min(n_target, len(pairs) - n_target)}
    gaps = {"final_acc_abs_gap": abs(torch_curve["acc"][-1] - ours_curve["acc"][-1]),
            "final_eer_abs_gap": abs(torch_curve["eer"][-1] - ours_curve["eer"][-1])}
    report = {
        "recipe": {"loss": "CrossEntropy", "optimizer": f"Adam lr={LR} coupled_wd={WD}",
                   "schedule": f"CosineAnnealingLR(T_max={T_MAX}) per iteration",
                   "bs": BS, "epochs": epochs, "steps_per_epoch": STEPS_PER_EPOCH,
                   "arch": {"name": args.arch, "trunk_layers": list(layers),
                            "tcn_width": hidden, "tcn_layers": width["tcn_layers"],
                            "kernel": [3], "dropout": 0.0},
                   "data": {"n_spk": N_SPK, "t_frames": T_FRAMES, "crop": CROP}},
        "torch": torch_curve,
        "deeplip_tpu_torch": ours_curve,
        "max_epoch_loss_gap": gap,
        "final_acc_torch": torch_curve["acc"][-1],
        "final_acc_deeplip": ours_curve["acc"][-1],
        "final_eer_torch": torch_curve["eer"][-1],
        "final_eer_deeplip": ours_curve["eer"][-1],
        **gaps,
        "seconds_parts": {"data": t_data, "replica": t_replica, "nudged": t_nudged,
                          "port": t_port},
    }
    if runs:
        report["nudged"] = runs
    lines = [
        "# Video convergence study: the reference recipe's torch replica against the "
        "PyTorch port",
        "",
        "One hard synthetic lip-clip corpus (speaker blobs in a tight shared parameter band",
        "under strong noise), one shared speaker-balanced batch stream with the reference",
        "train transforms applied in shared numpy, one shared init (the replica's), and the",
        "reference video recipe on both sides (Adam 3e-4 with coupled weight decay 1e-4, CE,",
        f"CosineAnnealingLR(T_max={T_MAX}) stepped per iteration). Widths `{args.arch}`: TCN",
        f"width {hidden}, {width['tcn_layers']} TCN layers, trunk layers {list(layers)},",
        f"dropout 0; bs {BS}, {epochs} epochs x {STEPS_PER_EPOCH} steps.",
        "",
        "| epoch | torch loss | port loss | torch acc | port acc | torch EER | port EER |",
        "|---|---|---|---|---|---|---|",
    ]
    for e in range(epochs):
        lines.append(
            f"| {e+1} | {torch_curve['loss'][e]:.4f} | "
            f"{ours_curve['loss'][e]:.4f} | {torch_curve['acc'][e]*100:.1f}% "
            f"| {ours_curve['acc'][e]*100:.1f}% "
            f"| {torch_curve['eer'][e]*100:.2f}% "
            f"| {ours_curve['eer'][e]*100:.2f}% |")
    lines += [
        "",
        f"Max per-epoch mean-loss gap: **{gap:.4f}**; final accuracy "
        f"torch **{torch_curve['acc'][-1]*100:.1f}%** vs port "
        f"**{ours_curve['acc'][-1]*100:.1f}%**; final EER torch "
        f"**{torch_curve['eer'][-1]*100:.2f}%** vs port "
        f"**{ours_curve['eer'][-1]*100:.2f}%**.",
        "",
        "Identical init, batches and recipe. BN batch statistics and Adam's rsqrt",
        "accumulate f32 noise over hundreds of steps, so the curves track epoch by epoch",
        "and are not expected to be bit-equal.",
    ]
    reaches = {"final_acc_abs_gap": PC.metric_reach(torch_curve["acc"][-1], 1.0),
               "final_eer_abs_gap": PC.metric_reach(torch_curve["eer"][-1], 0.5)}
    return finish_study(report, args, device, t0, gaps, quanta, reaches, lines,
                        {"max_epoch_loss_gap": gap,
                         "final_acc_torch": torch_curve["acc"][-1],
                         "final_acc_deeplip": ours_curve["acc"][-1],
                         "final_eer_torch": torch_curve["eer"][-1],
                         "final_eer_deeplip": ours_curve["eer"][-1]})


if __name__ == "__main__":
    main()
