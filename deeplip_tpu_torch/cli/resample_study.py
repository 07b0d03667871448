"""The embedding-level cost of the GRID leg's resampler, through the port.

Counterpart of ``scripts/resample_study.py``, with the same protocol,
seeds and report keys. The reference resamples GRID's 44.1 kHz stereo audio
with ``librosa.resample``, i.e. resampy's ``kaiser_best``
(the reference's models/audio_models/datasets.py:462);
``data.audio_io.resample`` implements that filter and scipy's
``resample_poly`` (``'polyphase'``) beside it. This study measures what the
polyphase filter costs at the embedding level through briefly trained
flagship E-TDNN weights: random-init embeddings collapse, and trained
weights are the regime the 1e-4 parity bar is defined on.

Protocol: train conf/audio_config.yaml's E-TDNN for ``--steps`` PCM steps
(``AudioTrainer.train_step``: on the card the front-end kernel K1 runs in
each) on a synthetic 16 kHz corpus, synthesize GRID-style 44.1 kHz stereo
wavs from seed 11, extract embeddings through the bucketed path twice
(K1 again), once with ``resample(method='kaiser_best')`` and once with
``'polyphase'``, and compare the embeddings and the trial cosines. The
PCM-level difference is host arithmetic on the same seeds as the JAX
script's, so it equals that script's.

Whether the weights learned is read on a fixed probe, not on the steps'
losses: one batch's LMCL loss spreads over several nats from crop to crop,
so the mean of ten steps moves by about one nat whether the net learns or
not. The probe is one epoch of the training pipeline at an epoch index the
training never draws (the same crops before and after), run forward in
train mode (batch statistics, the running ones kept) without gradients;
its mean LMCL loss at the training margin is read before the first step
and after the last, as ``probe_loss_before_after``, and ``learned`` holds
when the second is at most :data:`LEARNED_RATIO` of the first.

The report adds ``losses`` (every step's), ``probe_loss_before_after``,
``probe_ratio_bar``, ``learned``, ``probe_batches``, ``eval_batches`` (one
extraction's bucketed batches), ``device``, ``card``, ``launches`` and
``seconds`` to the JAX script's keys. It runs on the card unless ``--device cpu``; there its
training runs with cuDNN deterministic, so that a run repeats itself.

Run: ``python -m deeplip_tpu_torch.cli.resample_study [--device cpu]
[--steps 30] [--n-utts 24] [--out REPORT.json]``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from deeplip_tpu_torch.cli.parity_check import card_of
from deeplip_tpu_torch.core.config import AUDIO_DATA_OPTS, ETDNN_MODEL_OPTS, Config
from deeplip_tpu_torch.core.device import fp32_math, resolve_device
from deeplip_tpu_torch.data.audio_io import read_wav, resample, write_wav
from deeplip_tpu_torch.data.audio_pipeline import EvalUtterance, EvalUtteranceSet
from deeplip_tpu_torch.data.synthetic import make_audio_corpus, synth_utterance
from deeplip_tpu_torch.ops import features as F
from deeplip_tpu_torch.ops.cuda import launch_counts
from deeplip_tpu_torch.train.audio import AudioTrainer

MARGIN = 0.2
PROBE_EPOCH = 1_000_000   # an epoch index of the pipeline that training never reaches
# the weights learned when the probe's loss falls to this share of its loss
# at init or below. CPU runs of the 30 steps: the JAX trainer's 0.477
# (8.408 -> 4.010); the port's 0.408 on one thread and 0.536 on several;
# from torch's default dense and convolution init, which does not learn, 0.84
LEARNED_RATIO = 0.7


def train_config(n_frames_lo=60, n_frames_hi=80, bs=8) -> Config:
    """The flagship E-TDNN's short-crop LMCL training config
    (``__graft_entry__.py: _train_config``)."""
    return Config(
        {
            "data": {"frames": [n_frames_lo, n_frames_hi],
                     "python_data_config": AUDIO_DATA_OPTS},
            "model": ETDNN_MODEL_OPTS,
            "train": {
                "type": "sgd",
                "bs": bs,
                "lr_decay": 0.1,
                "lr_decay_step": [15, 25],
                "epoch": 1,
                "loss": "LMCL",
                "scale": 30,
                "margin": [0.2, 0.2],
                "sgd": {"init_lr": 0.01, "weight_decay": 1e-5, "momentum": 0.9},
            },
            "test": {},
        }
    )


def probe_loss(trainer: AudioTrainer, probe: list, device: torch.device) -> float:
    """The mean LMCL loss over the ``probe`` batches at :data:`MARGIN`, each
    forward in train mode without gradients; the BN running statistics are
    restored after it."""
    model = trainer.model
    kept = [b.clone() for b in model.buffers()]
    was_training = model.training
    model.train()
    losses = []
    with torch.no_grad(), fp32_math():
        for b in probe:
            pcm = torch.from_numpy(b["pcm"]).to(device)
            if pcm.dtype == torch.int16:
                pcm = pcm.to(torch.float32) / 32768.0
            emb = model(F.extract_features(pcm, trainer.feat_cfg))
            loss, _ = trainer.criterion(emb, torch.from_numpy(b["labels"]).to(device), MARGIN)
            losses.append(float(loss))
        for buf, k in zip(model.buffers(), kept):
            buf.copy_(k)
    model.train(was_training)
    return float(np.mean(losses))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="write the JSON report here")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--n-utts", type=int, default=24)
    ap.add_argument("--device", default=None, choices=[None, "cpu"],
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    device = resolve_device(args.device)

    with tempfile.TemporaryDirectory(prefix="resample_study_") as tmp:
        # --- briefly-trained flagship weights ----------------------------
        train_root = os.path.join(tmp, "train")
        make_audio_corpus(train_root, n_spk=8, utts_per_spk=4, duration=2.0)
        cfg = train_config(bs=8)
        cfg.data["train_manifest"] = os.path.join(train_root, "manifest.csv")
        trainer = AudioTrainer(cfg, device=device, exp_root=os.path.join(tmp, "exp"))
        probe = list(trainer.pipeline.epoch(PROBE_EPOCH))
        probe_before = probe_loss(trainer, probe, device)
        losses = []
        batches = iter(trainer.pipeline.epoch(0))
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True):
            for step in range(args.steps):
                try:
                    b = next(batches)
                except StopIteration:
                    batches = iter(trainer.pipeline.epoch(step))
                    b = next(batches)
                m = trainer.train_step(torch.from_numpy(b["pcm"]).to(device),
                                       torch.from_numpy(b["labels"]).to(device), MARGIN)
                losses.append(m["loss"])
        losses = [float(v) for v in losses]
        first, last = losses[0], losses[-1]
        probe_after = probe_loss(trainer, probe, device)
        print(f"trained {args.steps} steps: loss {first:.3f} -> {last:.3f}, probe "
              f"{probe_before:.3f} -> {probe_after:.3f}", file=sys.stderr)

        # --- GRID-style eval wavs: 44.1 kHz stereo -----------------------
        rng = np.random.default_rng(11)
        utts = []
        for i in range(args.n_utts):
            y = synth_utterance(rng, speaker_seed=2000 + i % 8,
                                duration=float(rng.uniform(1.5, 3.0)), rate=44100)
            stereo = np.stack([y, 0.92 * y + 0.002 * rng.standard_normal(len(y))
                               .astype(np.float32)], axis=1)
            p = os.path.join(tmp, f"g{i:03d}.wav")
            write_wav(p, stereo, 44100)
            utts.append(EvalUtterance(name=f"g{i:03d}", path=p))

        def extract(method: str):
            def reader(path):
                y, sr = read_wav(path)  # channel 0, the reference's y[:, 0]
                return resample(y, sr, 16000, method=method), 16000

            es = EvalUtteranceSet(utts, rate=16000, batch_size=8,
                                  bucket_frames=50, num_workers=2, reader=reader)
            return trainer.extract_embeddings(es), es.n_batches

        store_k, eval_batches = extract("kaiser_best")
        store_p, _ = extract("polyphase")

        names = [u.name for u in utts]
        ek = np.stack([store_k[n].cpu().numpy() for n in names])
        ep = np.stack([store_p[n].cpu().numpy() for n in names])
        emb_delta = np.abs(ek - ep).max(axis=1)

        # trial cosines over all pairs (the LMCL path L2-normalises embeddings)
        sk = ek @ ek.T
        sp = ep @ ep.T
        iu = np.triu_indices(len(names), k=1)
        score_delta = np.abs(sk[iu] - sp[iu])

        # PCM-level difference for scale
        pcm_delta = []
        for u in utts[:8]:
            y, sr = read_wav(u.path)
            pcm_delta.append(float(np.abs(
                resample(y, sr, 16000, method="kaiser_best")
                - resample(y, sr, 16000, method="polyphase")).max()))

    report = {
        "steps_trained": args.steps,
        "loss_first_last": [first, last],
        "losses": losses,
        "probe_loss_before_after": [probe_before, probe_after],
        "probe_ratio_bar": LEARNED_RATIO,
        "learned": probe_after <= LEARNED_RATIO * probe_before,
        "probe_batches": len(probe),
        "n_utts": len(names),
        "pcm_max_abs_delta": max(pcm_delta),
        "embedding_max_abs_delta": float(emb_delta.max()),
        "embedding_p50_abs_delta": float(np.median(emb_delta)),
        "trial_score_max_abs_delta": float(score_delta.max()),
        "trial_score_p50_abs_delta": float(np.median(score_delta)),
        "parity_bar": 1e-4,
        "polyphase_exceeds_bar": bool(emb_delta.max() > 1e-4),
        "eval_batches": eval_batches,
        "device": str(device),
        "card": card_of(device),
        "launches": launch_counts(),
        "seconds": time.perf_counter() - t0,
    }
    print(json.dumps(report, indent=2), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
