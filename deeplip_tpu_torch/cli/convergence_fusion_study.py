"""Epoch-scale AV-fusion convergence study: the reference recipe's torch
replica against the port's ``FusionTrainer``.

Counterpart of ``scripts/convergence_fusion_study.py``, with the same
corpus, flags, batch stream, recipe and report: the frozen-encoder LowFER
recipe over many optimizer steps with per-epoch MultiStepLR decays, ending
in held-out accuracy.

Protocol:

- one shared synthetic AV corpus: hard audio (shared resonances under
  strong noise, ``data/synthetic.py:make_hard_audio_corpus``) paired with
  hard lip clips (``cli/convergence_video_study.py:make_hard_clip``),
  ``--n-spk`` speakers, held-out utterance/clip pairs for eval;
- one shared batch stream of raw inputs (1 s PCM crops and uint8 clips), so
  both sides run their full pipelines: the replica its host MFCC and a
  batch-1 video embedding per clip (the reference's
  train_fusion.py:241-315), the port its ``FusionTrainer.train_step`` from
  PCM and clips, where on the card the front-end kernel K1 and the frontend
  max-pool's forward kernel run in every step and in eval;
- the encoders are pre-trained on the replica's side only (60 audio and 80
  video steps, scaled with ``--n-spk``; the reference freezes pre-trained
  nets, train_fusion.py:191-201), and their snapshots are the shared init;
  both sides keep them frozen in eval mode;
- the reference fusion recipe: LowFER's gated concat (the live path of
  LBP.py:38-51) and a CrossEntropy criterion, SGD 0.5 with momentum 0.9
  and coupled weight decay 1e-5 over the head and the criterion only,
  MultiStepLR [4, 8] per epoch (conf/fusion_config.yaml).

The r05 corpus of the JAX script, which keeps accuracy below saturation:
``--n-spk 24 --separation 0.03 --video-band 0.4 --video-noise 0.5``.

Where this differs from the JAX script, and why: as
``cli/convergence_study.py`` says (both sides on ``--device``, the replica
and its pre-training in FP32 with TF32 off and cuDNN deterministic on the
card, ``--nudges`` nudging the replica's PCM and transformed frames, the
report's keys and the default ``--out``). ``--arch flagship`` takes both
shipped encoders, the E-TDNN of conf/audio_config.yaml and the trunk of
``cli/convergence_video_study.py --arch flagship``; D stays 512.

Run: ``python -m deeplip_tpu_torch.cli.convergence_fusion_study [--device
cpu] [--arch flagship] [--nudges 3] [--epochs 16] [r05 flags] [--out
PREFIX]``.
"""

from __future__ import annotations

import copy
import os
import sys
import tempfile
import time

import numpy as np
import torch

from deeplip_tpu_torch.cli import parity_check as PC
from deeplip_tpu_torch.cli.convergence_study import ARCHES
from deeplip_tpu_torch.cli.convergence_video_study import WIDTHS, make_hard_clip
from deeplip_tpu_torch.cli.parity_check import (epoch_loss_gap, finish_study, nudge_array,
                                               nudge_rng, nudged_entry, replica_math,
                                               study_parser)
from deeplip_tpu_torch.core.config import Config
from deeplip_tpu_torch.core.device import fp32_math, resolve_device
from deeplip_tpu_torch.data.audio_io import read_wav
from deeplip_tpu_torch.data.manifest import SpeakerManifest
from deeplip_tpu_torch.data.synthetic import make_hard_audio_corpus
from deeplip_tpu_torch.interop.torch_import import (import_criterion_state_dict,
                                                    import_lipreading_state_dict,
                                                    import_speaker_embnet_state_dict)
from deeplip_tpu_torch.train.fusion import FusionTrainer

N_SPK = 10
UTTS_PER_SPK = 10  # 8 train / 2 eval
CLIPS_PER_SPK = 10  # 8 train / 2 eval
T_CLIP = 10
RAW, CROP = 48, 44
EPOCHS = 10
STEPS_PER_EPOCH = 15
BS = 8
D = 512
LR, MOMENTUM, WD = 0.5, 0.9, 1e-5
MILESTONES = [4, 8]  # epochs (reference conf/fusion_config.yaml)
N_SAMPLES = 16000  # 1 s PCM crop per item
MEAN, STD = 0.421, 0.165
AUDIO_ARCHES = {"study": {"arch": "tdnn", "context": [[-2, -1, 0, 1, 2], [-2, 0, 2], [0]],
                          "hidden_dim": [32, 32, 64]},
                "flagship": {k: ARCHES["flagship"][k] for k in ("arch", "context",
                                                                "hidden_dim")}}


def parser():
    p = study_parser(__doc__, EPOCHS, "fusion")
    p.add_argument("--n-spk", type=int, default=N_SPK)
    p.add_argument("--separation", type=float, default=0.06,
                   help="audio speaker-resonance separation "
                   "(make_hard_audio_corpus; smaller = closer classes)")
    p.add_argument("--video-band", type=float, default=1.0,
                   help="scale on the per-speaker blob-parameter bands "
                   "(smaller = closer classes)")
    p.add_argument("--video-noise", type=float, default=0.35,
                   help="per-frame Gaussian noise floor in the clips")
    return p


def shared_data(work: str, args) -> dict:
    """The corpus under ``work`` and the shared raw streams as the JAX
    script draws them: every utterance's PCM and every speaker's clips, the
    train PCM crops, clips and labels (seed 42), and the held-out pairs."""
    n_spk = args.n_spk
    make_hard_audio_corpus(work, n_spk=n_spk, utts_per_spk=UTTS_PER_SPK,
                           duration=2.0, separation=args.separation)
    manifest = SpeakerManifest.load(os.path.join(work, "manifest.csv"))
    pcm_by_spk = [[read_wav(u.path)[0] for u in spk] for spk in manifest.speakers]
    crng = np.random.default_rng(5)
    band = args.video_band
    clips_by_spk = []
    for s in range(n_spk):
        srng = np.random.default_rng(1000 + s)
        params = (
            RAW * (0.5 + srng.uniform(-0.04 * band, 0.04 * band)),
            RAW * (0.5 + srng.uniform(-0.04 * band, 0.04 * band)),
            10.0 * (1 + srng.uniform(-0.15 * band, 0.15 * band)),
            10.0 * (1 + srng.uniform(-0.15 * band, 0.15 * band)),
        )
        clips_by_spk.append(
            [make_hard_clip(crng, params, T_CLIP, RAW, noise=args.video_noise)
             for _ in range(CLIPS_PER_SPK)])

    rng = np.random.default_rng(42)
    steps = args.epochs * STEPS_PER_EPOCH
    pcm = np.zeros((steps, BS, N_SAMPLES), np.float32)
    clips_u8 = np.zeros((steps, BS, 1, T_CLIP, RAW, RAW), np.uint8)
    labels = np.zeros((steps, BS), np.int64)
    for k in range(steps):
        for i in range(BS):
            spk = (k * BS + i) % n_spk  # idx % n_spk balance
            y = pcm_by_spk[spk][int(rng.integers(8))]  # train utts 0-7
            start = int(rng.integers(0, len(y) - N_SAMPLES + 1))
            pcm[k, i] = y[start:start + N_SAMPLES]
            clips_u8[k, i, 0] = clips_by_spk[spk][int(rng.integers(8))]
            labels[k, i] = spk

    # held-out eval pairs: utts/clips 8-9 of each speaker
    eval_pcm, eval_clips, eval_labels = [], [], []
    for s in range(n_spk):
        for j in (8, 9):
            y = pcm_by_spk[s][j][:N_SAMPLES]
            eval_pcm.append(np.pad(y, (0, N_SAMPLES - len(y))))
            eval_clips.append(clips_by_spk[s][j][None])
            eval_labels.append(s)
    return {"pcm_by_spk": pcm_by_spk, "clips_by_spk": clips_by_spk, "pcm": pcm,
            "clips_u8": clips_u8, "labels": labels,
            "eval_pcm": np.stack(eval_pcm).astype(np.float32),
            "eval_clips": np.stack(eval_clips), "eval_labels": np.asarray(eval_labels)}


def pretrain_encoders(tnet_a, tnet_v, data: dict, n_spk: int, device) -> None:
    """The encoders' pre-training on the replica's side (the JAX script's):
    a short cosine-CE fit of the audio net, then Adam CE steps of the video
    net on center-cropped clips. Both are left in eval mode."""
    print("[pretrain] audio encoder...", file=sys.stderr)
    feats_by_utt, labels_by_utt = {}, {}
    for s in range(n_spk):
        for j in range(8):
            name = f"s{s}_u{j}"
            feats_by_utt[name] = PC.numpy_mfcc(
                data["pcm_by_spk"][s][j].astype(np.float64)).astype(np.float32)
            labels_by_utt[name] = s
    PC.train_torch_net(torch, tnet_a, feats_by_utt, labels_by_utt, D, n_spk,
                       steps=60 * max(1, n_spk // N_SPK), bs=16, device=device)

    print("[pretrain] video encoder...", file=sys.stderr)
    prng = np.random.default_rng(9)
    tnet_v.to(device)
    vopt = torch.optim.Adam(tnet_v.parameters(), lr=1e-3)
    tnet_v.train()
    v_pretrain_steps = 80 * max(1, n_spk // N_SPK)
    off = (RAW - CROP) // 2
    for step in range(v_pretrain_steps):
        xs, ys = [], []
        for i in range(8):
            spk = (step * 8 + i) % n_spk
            c = data["clips_by_spk"][spk][int(prng.integers(8))]
            x = (c[:, off:off + CROP, off:off + CROP].astype(np.float32)
                 / np.float32(255.0) - np.float32(MEAN)) / np.float32(STD)
            xs.append(x)
            ys.append(spk)
        out = tnet_v(torch.tensor(np.stack(xs))[:, None].to(device), [T_CLIP] * 8)
        loss = torch.nn.functional.cross_entropy(out, torch.tensor(ys).to(device))
        vopt.zero_grad()
        loss.backward()
        vopt.step()
        if step % 20 == 0 or step == v_pretrain_steps - 1:
            print(f"  torch video pre-train step {step}: "
                  f"loss {loss.item():.4f}", file=sys.stderr)
    tnet_a.to(device).eval()
    tnet_v.eval()


def make_embed(tnet_a, tnet_v, device):
    """The replica's frozen embedding of a raw batch: the host MFCC and the
    audio net's x-vector tap, and each clip's batch-1 time-mean trunk
    features; ``frames(i, x)`` may nudge clip ``i``'s transformed frames."""
    off = (RAW - CROP) // 2

    def transform(clip_u8):  # center crop + normalize, f32 math
        c = clip_u8[:, off:off + CROP, off:off + CROP]
        return torch.tensor(
            (c.astype(np.float32) / np.float32(255.0) - np.float32(MEAN))
            / np.float32(STD))

    def vfeats(x):  # (1, 1, T, H, W) -> (T, 512)
        h = tnet_v.frontend3D(x)
        t = h.shape[2]
        h = h.transpose(1, 2).reshape(t, h.shape[1], h.shape[3], h.shape[4])
        return tnet_v.trunk(h)

    def embed(pcm_batch, clips_batch, frames=None):
        with torch.no_grad():
            feats = np.stack([PC.numpy_mfcc(pcm_batch[i].astype(np.float64))
                              .astype(np.float32)
                              for i in range(len(pcm_batch))])
            x = torch.tensor(np.transpose(feats, (0, 2, 1))).to(device)
            h = tnet_a.tdnn(x)
            stats = torch.cat([h.mean(2), h.std(2)], 1)
            xv_audio = tnet_a.fc2(tnet_a.act(tnet_a.bn1(tnet_a.fc1(stats))))
            em = []
            for i in range(len(clips_batch)):
                v = transform(clips_batch[i, 0])
                if frames is not None:
                    v = frames(v)
                em.append(vfeats(v[None, None].to(device)).mean(0))
        return xv_audio, torch.stack(em)

    return embed


def nudge_frames(i: int):
    """The ``i``-th nudged run's nudge of transformed frames: elementwise by
    ``parity_check.NUDGE`` relative, from a torch generator seeded by it."""
    gen = torch.Generator().manual_seed(1 + i)

    def nudge(x):
        return x * (1.0 + PC.NUDGE * torch.randn(x.shape, generator=gen, dtype=x.dtype))

    return nudge


def train_replica(thead, tcrit, embed, data: dict, evaluate, epochs: int, device,
                  i: int | None = None) -> dict:
    """The reference fusion recipe's loop with its MultiStepLR stepped per
    epoch; ``i`` names a nudged run, whose PCM and transformed frames are
    nudged from generators seeded by it."""
    opt = torch.optim.SGD(
        [{"params": thead.parameters()}, {"params": tcrit.parameters()}],
        lr=LR, momentum=MOMENTUM, weight_decay=WD)
    sched = torch.optim.lr_scheduler.MultiStepLR(opt, MILESTONES, gamma=0.1)
    rng, frames = (None, None) if i is None else (nudge_rng(i), nudge_frames(i))
    curve = {"loss": [], "acc": []}
    for e in range(epochs):
        ep_loss = []
        for k in range(STEPS_PER_EPOCH):
            step = e * STEPS_PER_EPOCH + k
            pcm = data["pcm"][step] if rng is None else nudge_array(data["pcm"][step], rng)
            opt.zero_grad()
            e1, e2 = embed(pcm, data["clips_u8"][step], frames)
            loss, _ = tcrit(thead(e1, e2), torch.tensor(data["labels"][step]).to(device))
            loss.backward()
            opt.step()
            ep_loss.append(loss.detach())
        sched.step()  # per EPOCH (reference MultiStepLR semantics)
        curve["loss"].append(float(np.mean([float(v) for v in ep_loss])))
        curve["acc"].append(evaluate(thead, tcrit))
        print(f"[torch] epoch {e+1}: loss={curve['loss'][-1]:.4f} "
              f"acc={curve['acc'][-1]*100:.1f}%", file=sys.stderr)
    return curve


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    t0 = time.perf_counter()
    device = resolve_device(args.device)
    epochs, n_spk = args.epochs, args.n_spk
    audio = AUDIO_ARCHES[args.arch]
    video = WIDTHS[args.arch]
    layers = video["trunk_layers"]

    with tempfile.TemporaryDirectory(prefix="converge_fusion_") as work:
        print(f"[corpus] {work}", file=sys.stderr)
        data = shared_data(work, args)
        eval_labels = data["eval_labels"]
        n_eval = len(eval_labels)
        t_data = time.perf_counter() - t0

        # ---- the torch replica: encoders pre-trained, then frozen
        torch.manual_seed(0)
        tnet_a = PC.build_torch_net(torch, audio["context"], [24] + audio["hidden_dim"],
                                    D).eval()
        tnet_v = PC.build_torch_lipreading(torch, n_spk, hidden_dim=video["hidden_dim"],
                                           tcn_layers=video["tcn_layers"],
                                           layers=layers).eval()
        thead = PC.build_torch_lowfer(torch, D, o=D, k=30, seed=1).float()
        tcrit = PC.build_torch_ce(torch, 3 * D, n_spk)
        with replica_math():
            pretrain_encoders(tnet_a, tnet_v, data, n_spk, device)
        tnet_a_init = copy.deepcopy(tnet_a.state_dict())
        tnet_v_init = copy.deepcopy(tnet_v.state_dict())
        thead_init = copy.deepcopy(thead.state_dict())
        tcrit_init = copy.deepcopy(tcrit.state_dict())
        t_pretrain = time.perf_counter() - t0 - t_data
        embed = make_embed(tnet_a, tnet_v, device)
        # the encoders are frozen, so the held-out embeddings are the same
        # every epoch of every run (the JAX script computes them each epoch)
        with replica_math():
            eval_e1, eval_e2 = embed(data["eval_pcm"], data["eval_clips"])

        def replica_eval(thead, tcrit):
            thead.eval(), tcrit.eval()
            with torch.no_grad():
                _, logits = tcrit(thead(eval_e1, eval_e2),
                                  torch.tensor(eval_labels).to(device))
                acc = float((logits.argmax(-1).cpu().numpy() == eval_labels).mean())
            thead.train(), tcrit.train()
            return acc

        print("[torch] training...", file=sys.stderr)
        with replica_math():
            torch_curve = train_replica(thead.to(device), tcrit.to(device), embed, data,
                                        replica_eval, epochs, device)
        t_replica = time.perf_counter() - t0 - t_data - t_pretrain
        runs = []
        for i in range(args.nudges):
            with torch.random.fork_rng(devices=[]):
                n_head = PC.build_torch_lowfer(torch, D, o=D, k=30, seed=1).float()
                n_crit = PC.build_torch_ce(torch, 3 * D, n_spk)
            n_head.load_state_dict(thead_init)
            n_crit.load_state_dict(tcrit_init)
            print(f"[torch] nudged run {i + 1}...", file=sys.stderr)
            with replica_math():
                run = train_replica(n_head.to(device), n_crit.to(device), embed, data,
                                    replica_eval, epochs, device, i=i)
            runs.append(nudged_entry(torch_curve, run, {"final_acc_abs_gap": "acc"}))
        t_nudged = time.perf_counter() - t0 - t_data - t_pretrain - t_replica

        # ---- the port's FusionTrainer, from the replica's snapshots
        audio_model_opts = {"arch": audio["arch"], audio["arch"]: {
            "input_dim": 24, "hidden_dim": audio["hidden_dim"], "context": audio["context"],
            "tdnn_layers": len(audio["context"]), "embedding_dim": D,
            "pooling": "statistic", "attention_hidden_size": 8,
            "bn_first": True}}
        video_cfg = Config({
            "backbone_type": "resnet", "relu_type": "prelu",
            "tcn_kernel_size": [3], "tcn_num_layers": video["tcn_layers"], "tcn_dropout": 0.0,
            "tcn_dwpw": False, "tcn_width_mult": 1, "width_mult": 1.0})
        trainer = FusionTrainer(
            audio_model_opts, video_cfg, n_spk=n_spk, audio_data_opts=PC.AUDIO_DATA,
            device=device, lr=LR, momentum=MOMENTUM, weight_decay=WD,
            lr_decay_step=tuple(MILESTONES), steps_per_epoch=STEPS_PER_EPOCH,
            crop_size=(CROP, CROP), video_hidden_dim=video["hidden_dim"],
            video_trunk_layers=layers, loss="CrossEntropy",
            exp_root=os.path.join(work, "exp"))
        trainer.load_state_dicts(
            audio=import_speaker_embnet_state_dict(tnet_a_init, n_blocks=len(audio["context"])),
            video={**trainer.video_model.state_dict(),
                   **import_lipreading_state_dict(tnet_v_init, layers=layers)},
            head={**trainer.fusion_head.state_dict(),
                  **{k: v.float() for k, v in thead_init.items()}},
            criterion=import_criterion_state_dict(tcrit_init))
        trainer.build_optimizer()

        def to_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        clip_lengths = to_dev(np.full((BS, 1), T_CLIP, np.int32))
        group_sizes = to_dev(np.ones((BS,), np.int32))
        ev = {"pcm": to_dev(data["eval_pcm"]), "clips": to_dev(data["eval_clips"]),
              "lens": to_dev(np.full((n_eval, 1), T_CLIP, np.int32)),
              "sizes": to_dev(np.ones((n_eval,), np.int32)), "labels": to_dev(eval_labels)}
        ours_curve = {"loss": [], "acc": []}
        print("[port] training...", file=sys.stderr)
        for e in range(epochs):
            ep_loss = []
            for k in range(STEPS_PER_EPOCH):
                step = e * STEPS_PER_EPOCH + k
                metrics = trainer.train_step(to_dev(data["pcm"][step]),
                                             to_dev(data["clips_u8"][step]), clip_lengths,
                                             group_sizes, to_dev(data["labels"][step]))
                ep_loss.append(metrics["loss"])
            with torch.no_grad(), fp32_math():
                e1 = trainer._audio_embed(ev["pcm"])
                e2 = trainer._video_group_embed(ev["clips"], ev["lens"], ev["sizes"])
                _, logits = trainer.criterion(trainer._head_apply(e1, e2), ev["labels"],
                                              reduction="none")
            acc = float((logits.argmax(-1).cpu().numpy() == eval_labels).mean())
            ours_curve["loss"].append(float(np.mean([float(v) for v in ep_loss])))
            ours_curve["acc"].append(acc)
            print(f"[port] epoch {e+1}: loss={ours_curve['loss'][-1]:.4f} "
                  f"acc={acc*100:.1f}%", file=sys.stderr)
        t_port = time.perf_counter() - t0 - t_data - t_pretrain - t_replica - t_nudged

    # ---- report
    gap = epoch_loss_gap(torch_curve, ours_curve)
    gaps = {"final_acc_abs_gap": abs(torch_curve["acc"][-1] - ours_curve["acc"][-1])}
    report = {
        "recipe": {"head": "LowFER gated-concat (live path)",
                   "loss": "CrossEntropy",
                   "optimizer": f"SGD lr={LR} momentum={MOMENTUM} wd={WD} "
                                "(head+criterion only, encoders frozen)",
                   "milestones_epochs": MILESTONES, "bs": BS,
                   "epochs": epochs, "steps_per_epoch": STEPS_PER_EPOCH,
                   "arch": {"name": args.arch, "audio": audio, "video": {
                       **video, "trunk_layers": list(layers)}, "d": D},
                   "data": {"n_spk": n_spk, "t_clip": T_CLIP, "crop": CROP,
                            "pcm_samples": N_SAMPLES,
                            "separation": args.separation,
                            "video_band": args.video_band,
                            "video_noise": args.video_noise}},
        "torch": torch_curve,
        "deeplip_tpu_torch": ours_curve,
        "max_epoch_loss_gap": gap,
        "final_acc_torch": torch_curve["acc"][-1],
        "final_acc_deeplip": ours_curve["acc"][-1],
        **gaps,
        "seconds_parts": {"data": t_data, "pretrain": t_pretrain, "replica": t_replica,
                          "nudged": t_nudged, "port": t_port},
    }
    if runs:
        report["nudged"] = runs
    lines = [
        "# AV-fusion convergence study: the reference recipe's torch replica against the "
        "PyTorch port",
        "",
        f"One shared synthetic AV corpus (hard audio and hard lip clips, {n_spk} speakers,",
        f"separation {args.separation}, video band {args.video_band}, video noise "
        f"{args.video_noise}), encoders pre-trained on the replica's side and",
        "snapshotted as the shared init (the reference freezes pre-trained nets), one shared",
        "raw batch stream (PCM crops and uint8 clips: the replica runs its per-clip batch-1",
        "loops, the port its batched step), frozen eval-mode encoders, and the reference",
        f"fusion recipe (LowFER gated concat, CE, SGD {LR}/momentum {MOMENTUM}/wd {WD} over",
        f"the head and the criterion, MultiStepLR {MILESTONES} per epoch). Widths "
        f"`{args.arch}`; D {D}; bs {BS}, {epochs} epochs x {STEPS_PER_EPOCH} steps.",
        "",
        "| epoch | torch loss | port loss | torch acc | port acc |",
        "|---|---|---|---|---|",
    ]
    for e in range(epochs):
        lines.append(
            f"| {e+1} | {torch_curve['loss'][e]:.4f} | "
            f"{ours_curve['loss'][e]:.4f} | {torch_curve['acc'][e]*100:.1f}% "
            f"| {ours_curve['acc'][e]*100:.1f}% |")
    acc_gap_items = abs(round(torch_curve["acc"][-1] * n_eval)
                        - round(ours_curve["acc"][-1] * n_eval))
    lines += [
        "",
        f"Max per-epoch mean-loss gap: **{gap:.4f}**; final held-out accuracy torch "
        f"**{torch_curve['acc'][-1]*100:.1f}%** vs port **{ours_curve['acc'][-1]*100:.1f}%**: "
        f"{acc_gap_items} of {n_eval} clips (2 held out per speaker) apart.",
        "",
        "Identical init, raw batches and recipe; the SGD-0.5 head amplifies f32 noise over",
        "the steps, so the curves track epoch by epoch and are not expected to be bit-equal.",
    ]
    return finish_study(report, args, device, t0, gaps, {"final_acc_abs_gap": 1.0 / n_eval},
                        {"final_acc_abs_gap": PC.metric_reach(torch_curve["acc"][-1], 1.0)},
                        lines,
                        {"max_epoch_loss_gap": gap, "final_acc_torch": torch_curve["acc"][-1],
                         "final_acc_deeplip": ours_curve["acc"][-1]})


if __name__ == "__main__":
    main()
