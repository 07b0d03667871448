"""Full-framework walkthrough on a synthetic corpus.

Counterpart of ``examples/full_pipeline_demo.py``: every production path end
to end, no external data needed:

1. synthesize a paired audio+video corpus and a GRID-style trial list;
2. train the audio x-vector system (E-TDNN recipe, tiny dims) and average
   its last two epochs into ``net_avg``;
3. train the video lipreading classifier; extract per-clip embeddings;
4. train the fusion head on the encoders the two trainers just saved
   (``net_avg``, ``net_2``), frozen, from batched clip groups;
5. score every back-end: audio cosine, video cosine, score fusion,
   feature fusion, PLDA.

Each stage is a function whose defaults are the demo's sizes. The last
line printed is a JSON summary: the five EERs, each stage's seconds and
the CUDA kernels' launches (all 0 on the CPU).

Run: ``python -m deeplip_tpu_torch.examples.full_pipeline_demo [--device cpu]
[--workdir DIR]`` (the card unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from deeplip_tpu_torch.core.config import Config
from deeplip_tpu_torch.data.audio_pipeline import EvalUtterance, EvalUtteranceSet
from deeplip_tpu_torch.data.fusion_pipeline import AVTrainPipeline
from deeplip_tpu_torch.data.manifest import SpeakerManifest
from deeplip_tpu_torch.data.synthetic import make_audio_corpus, make_trial_list, synth_video_clip
from deeplip_tpu_torch.data.video_dataset import VideoClip, VideoClipBatches
from deeplip_tpu_torch.eval.plda import PLDA, plda_eer
from deeplip_tpu_torch.eval.scoring import (TrialList, cosine_eer, feature_fusion_eer,
                                            score_fusion_eer)
from deeplip_tpu_torch.ops.cuda import launch_counts
from deeplip_tpu_torch.train import checkpoint as ckpt
from deeplip_tpu_torch.train.audio import AudioTrainer
from deeplip_tpu_torch.train.fusion import FusionTrainer
from deeplip_tpu_torch.train.video import VideoTrainer

VIDEO_CFG = {"backbone_type": "resnet", "relu_type": "prelu", "tcn_dropout": 0.2,
             "tcn_dwpw": False, "tcn_kernel_size": [3, 5, 7], "tcn_num_layers": 2,
             "tcn_width_mult": 1, "width_mult": 1.0}


def make_corpus(work: str, n_spk: int = 4, utts_per_spk: int = 6, duration: float = 2.5,
                n_trials: int = 400, clip_frames: int = 10, clip_size: int = 96) -> dict:
    """Stage 1: wavs, a manifest and a trial list under ``work/corpus``,
    and one clip of each utterance (``videos/<spk>/<stem>.npz``)."""
    corpus = os.path.join(work, "corpus")
    make_audio_corpus(corpus, n_spk=n_spk, utts_per_spk=utts_per_spk, duration=duration)
    manifest = SpeakerManifest.load(os.path.join(corpus, "manifest.csv"))
    trial_path = os.path.join(corpus, "trials.txt")
    make_trial_list(trial_path, manifest, n_trials=n_trials)

    rng = np.random.default_rng(0)
    clips, video_map = [], {}
    for s, spk in enumerate(manifest.speakers):
        vdir = os.path.join(corpus, "videos", f"s{s:02d}")
        os.makedirs(vdir, exist_ok=True)
        for utt in spk:
            stem = os.path.splitext(os.path.basename(utt.path))[0]
            data = synth_video_clip(rng, speaker_seed=2000 + s, t=clip_frames, size=clip_size)
            path = os.path.join(vdir, stem + ".npz")
            np.savez(path, data=data)
            clips.append(VideoClip(path, s, f"s{s:02d}/{stem}"))
            video_map[utt.path] = [path]
    return {"root": corpus, "manifest": manifest, "trial_path": trial_path,
            "trials": TrialList.load(trial_path), "clips": clips, "video_map": video_map}


def audio_config(corpus: dict, hidden_dim=(64, 64, 128), embedding_dim: int = 32,
                 epochs: int = 3, batch_size: int = 16) -> Config:
    """The demo's audio recipe: a 3-block TDNN, LMCL, SGD."""
    return Config({
        "data": {
            "frames": [60, 100],
            "train_manifest": os.path.join(corpus["root"], "manifest.csv"),
            "python_data_config": {
                "rate": 16000, "feat_type": "mfcc",
                "mfcc": {"n_fft": 512, "num_bin": 26, "num_cep": 24, "energy": True,
                         "normalize": True, "delta": False, "win_len": 0.025,
                         "win_shift": 0.01}},
        },
        "model": {
            "arch": "tdnn",
            "tdnn": {"input_dim": 24, "hidden_dim": list(hidden_dim),
                     "context": [[-2, -1, 0, 1, 2], [-2, 0, 2], [0]],
                     "tdnn_layers": 3, "embedding_dim": embedding_dim,
                     "pooling": "statistic", "attention_hidden_size": 16, "bn_first": True},
        },
        "train": {"type": "sgd", "bs": batch_size, "lr_decay": 0.1, "lr_decay_step": [100],
                  "epoch": epochs, "loss": "LMCL", "scale": 30, "margin": [0.1, 0.2],
                  "frame_buckets": 3, "loader_workers": 4, "log_every": 0,
                  "sgd": {"init_lr": 0.05, "weight_decay": 1e-5, "momentum": 0.9}},
        "test": {},
    })


def train_audio(work: str, corpus: dict, cfg: Config, device=None, avg_num: int = 2):
    """Stage 2: train, average the last ``avg_num`` epochs into ``net_avg``,
    embed every utterance. Returns the trainer, the store and the EER."""
    audio = AudioTrainer(cfg, device=device, exp_root=os.path.join(work, "exp"),
                         log_time="audio")
    audio.train()
    audio.model_average(avg_num=avg_num)
    utts = [EvalUtterance("/".join(u.path.split(os.sep)[-2:]), u.path)
            for _, u in corpus["manifest"].all_utterances()]
    store = audio.extract_embeddings(
        EvalUtteranceSet(utts, batch_size=16, bucket_frames=100, num_workers=4))
    eer, _ = cosine_eer(corpus["trials"], store, device=audio.device)
    return audio, store, eer


def train_video(work: str, corpus: dict, device=None, hidden_dim: int = 24, epochs: int = 2,
                batch_size: int = 16):
    """Stage 3: train the Lipreading classifier over the speakers, then
    embed every clip. Returns the trainer, the store and the EER."""
    video = VideoTrainer(VIDEO_CFG, num_classes=corpus["manifest"].n_spk, device=device,
                         hidden_dim=hidden_dim, exp_root=os.path.join(work, "exp"),
                         log_time="video")
    video.train(VideoClipBatches(corpus["clips"], batch_size=batch_size, bucket_t=5,
                                 num_workers=4), epochs=epochs)
    store = video.embedding_store(
        VideoClipBatches(corpus["clips"], batch_size=batch_size, bucket_t=5, shuffle=False,
                         num_workers=4),
        name_map=lambda n: n + ".wav")
    eer, _ = cosine_eer(corpus["trials"], store, device=video.device)
    return video, store, eer


def train_fusion(work: str, corpus: dict, cfg: Config, audio_exp: str, video_exp: str,
                 device=None, hidden_dim: int = 24, epochs: int = 2, batch_size: int = 16,
                 clip_frames: int = 10) -> FusionTrainer:
    """Stage 4: the fusion head on the saved encoders (``net_avg`` of the
    audio run, ``net_<epochs>`` of the video run), frozen."""
    fusion = FusionTrainer(
        cfg.model, VIDEO_CFG, n_spk=corpus["manifest"].n_spk,
        audio_data_opts=cfg.data.python_data_config, device=device, lr=0.05,
        steps_per_epoch=8, video_hidden_dim=hidden_dim, exp_root=os.path.join(work, "exp"),
        log_time="fusion")
    fusion.load_encoders(ckpt.checkpoint_path(audio_exp, "avg"),
                         ckpt.checkpoint_path(video_exp, epochs))
    fusion.train(AVTrainPipeline(corpus["manifest"], corpus["video_map"],
                                 batch_size=batch_size, frame_range=(60, 80), n_buckets=2,
                                 max_clips=1, clip_frames=clip_frames, num_workers=4),
                 epochs=epochs)
    fusion.model_average(avg_num=2)
    return fusion


def score_back_ends(trials: TrialList, astore, vstore, device=None,
                    n_principal_components: int = 16) -> dict:
    """Stage 5: score fusion, feature fusion and PLDA EERs."""
    eer_sf, _ = score_fusion_eer(trials, astore, vstore, device=device)
    eer_ff, _ = feature_fusion_eer(trials, astore, vstore, device=device)
    names = list(astore.table)
    x = np.stack([astore[u].detach().cpu().numpy() for u in names])
    labels = np.asarray([int(u.split("/")[0][1:]) for u in names])
    plda = PLDA().fit(x, labels, n_principal_components=n_principal_components)
    eer_p, _ = plda_eer(trials, astore, plda)
    return {"score_fusion": eer_sf, "feature_fusion": eer_ff, "audio_plda": eer_p}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None, choices=[None, "cpu"],
                   help="run on the CPU (default: the card)")
    p.add_argument("--workdir", default=None)
    args = p.parse_args(argv)

    work = args.workdir or tempfile.mkdtemp(prefix="deeplip_demo_")
    print(f"[demo] workdir: {work}")
    seconds = {}

    def stage(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        seconds[name] = time.perf_counter() - t0
        return out

    corpus = stage("corpus", make_corpus, work)
    cfg = audio_config(corpus)
    print("[demo] training audio system ...")
    audio, astore, eer_a = stage("audio", train_audio, work, corpus, cfg, args.device)
    print(f"[demo] audio cosine EER: {eer_a * 100:.2f}%")
    print("[demo] training video system ...")
    video, vstore, eer_v = stage("video", train_video, work, corpus, args.device)
    print(f"[demo] video cosine EER: {eer_v * 100:.2f}%")
    print("[demo] training fusion head (frozen encoders) ...")
    stage("fusion", train_fusion, work, corpus, cfg, audio.exp_dir, video.exp_dir,
          args.device)
    back = stage("score", score_back_ends, corpus["trials"], astore, vstore, audio.device)
    eers = {"audio_cosine": eer_a, "video_cosine": eer_v, **back}

    print("[demo] ---- results ----")
    print(f"[demo] audio cosine    EER: {eer_a * 100:6.2f}%")
    print(f"[demo] video cosine    EER: {eer_v * 100:6.2f}%")
    print(f"[demo] score fusion    EER: {back['score_fusion'] * 100:6.2f}%")
    print(f"[demo] feature fusion  EER: {back['feature_fusion'] * 100:6.2f}%")
    print(f"[demo] audio PLDA      EER: {back['audio_plda'] * 100:6.2f}%")
    summary = {"eers": eers, "seconds": seconds, "launches": launch_counts(), "workdir": work}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
