"""Audio system entry point: train, test and the audio-visual eval modes.

Counterpart of ``deeplip_tpu/cli/train_audio.py``, with its flags and
modes, plus ``--device``:

- ``train``: train → average the last 4 epochs → extract the test set →
  cosine EER;
- ``test``: extract the test set → cosine EER;
- ``av_test``: optional PLDA fit on a dev list; per list, extract and the
  cosine and PLDA EERs;
- ``av_fusion``: feature- or score-fusion EER from stored audio and video
  embeddings.

Usage::

    python -m deeplip_tpu_torch.cli.train_audio --config conf/audio_config.yaml \\
        --mode train [--exp-root exp] [--resume exp/<t>/net_avg] [--device cpu]

It runs on the card unless ``--device`` names another device. The config's
``train.steps_per_dispatch: K > 1`` trains K same-shape steps as one
captured CUDA graph on the card (``train/dispatch.py``). Under ``torchrun
--nproc_per_node N`` it trains data-parallel over the N processes (one per
card; ``train.bs`` is the global batch), extracts with each batch split over
them, and rank 0 writes the checkpoints, logs and stored embeddings.
"""

from __future__ import annotations

import argparse
import builtins
import os
import sys

import numpy as np

from deeplip_tpu_torch.cli.common import (labels_from_speaker_prefix, launcher_mesh,
                                          utterances_from_names, utterances_from_trials)
from deeplip_tpu_torch.core.config import load_audio_config
from deeplip_tpu_torch.data.audio_pipeline import EvalUtteranceSet, eval_set_kwargs
from deeplip_tpu_torch.eval.plda import PLDA, plda_eer
from deeplip_tpu_torch.eval.scoring import (EmbeddingStore, TrialList, cosine_eer,
                                            feature_fusion_eer, score_fusion_eer)
from deeplip_tpu_torch.train.audio import AudioTrainer

_LISTS = (("eval_lomgrid", "trial_lomgrid", "test_xv_lomgrid"),
          ("eval_grid", "trial_grid", "test_xv_grid"))


def _eval_set(trainer: AudioTrainer, utts) -> EvalUtteranceSet:
    return EvalUtteranceSet(utts, **eval_set_kwargs(trainer.feat_cfg, trainer.test_opts))


def _extract_and_save(trainer: AudioTrainer, trial_path: str, root: str,
                      out_dir: str | None) -> EmbeddingStore:
    store = trainer.extract_embeddings(_eval_set(trainer, utterances_from_trials(trial_path,
                                                                               root)))
    if out_dir and trainer.mesh.is_main:
        store.save_npy_tree(out_dir)
    return store


def run_mode(trainer: AudioTrainer, cfg, mode: str) -> dict:
    """Run one mode; returns what it computed (``losses``, ``eer``, and per
    list ``<trial_key>_cosine_eer`` / ``_plda_eer`` / ``_fusion_eer``)."""
    data, test = cfg.data, cfg.get("test") or {}
    out: dict = {}
    # under torchrun every rank computes the same results; rank 0 reports them
    print = builtins.print if trainer.mesh.is_main else (lambda *a, **k: None)
    if mode in ("test", "av_test") and not trainer.loaded_checkpoint:
        print(f"WARNING: mode '{mode}' is evaluating RANDOMLY INITIALIZED weights (no "
              "train.resume / --resume checkpoint was loaded); the reported EER is "
              "meaningless for a real system", file=sys.stderr)
    if mode == "train":
        out["losses"] = trainer.train()
        trainer.model_average(avg_num=4)
    if mode in ("train", "test"):
        trial = data.get("trial_grid", "database/trial_grid_v1.txt")
        store = _extract_and_save(trainer, trial, data.get("test_root", "."),
                                  os.path.join(trainer.exp_dir, "test_xv"))
        out["eer"], out["threshold"] = trainer.evaluate(trial, store)
        print(f"EER: {out['eer'] * 100:.6f}%")
        return out

    if mode == "av_test":
        plda_model = None
        if test.get("train_plda") and data.get("plda_dev_list"):
            dev_names = [line.strip() for line in open(data["plda_dev_list"]) if line.strip()]
            dev_store = trainer.extract_embeddings(
                _eval_set(trainer, utterances_from_names(dev_names, data.get("dev_root", "."))))
            x = np.stack([dev_store[n].detach().cpu().numpy() for n in dev_names])
            labels = np.asarray(labels_from_speaker_prefix(dev_names))
            plda_model = PLDA().fit(x, labels, n_principal_components=20)
            if trainer.mesh.is_main:
                plda_model.save(os.path.join(trainer.exp_dir, "plda.npz"))
        for list_name, trial_key, tag in _LISTS:
            if not test.get(list_name):
                continue
            trial = data[trial_key]
            store = _extract_and_save(trainer, trial, data.get("test_root", "."),
                                      os.path.join(trainer.exp_dir, tag))
            if test.get("use_cos", True):
                eer, _ = cosine_eer(TrialList.load(trial), store, device=trainer.device)
                out[f"{trial_key}_cosine_eer"] = eer
                print(f"[{trial_key}] cosine EER: {eer * 100:.6f}%")
            if test.get("use_plda") and plda_model is not None:
                eer, _ = plda_eer(TrialList.load(trial), store, plda_model)
                out[f"{trial_key}_plda_eer"] = eer
                print(f"[{trial_key}] PLDA EER: {eer * 100:.6f}%")
        return out

    if mode == "av_fusion":
        # training-free fusion of stored audio and video embeddings:
        # feature level (z-norm + concat) or score level by test.fusion_type
        fusion_type = test.get("fusion_type", "feature")
        for list_name, trial_key, tag in _LISTS:
            if not test.get(list_name):
                continue
            trial = TrialList.load(data[trial_key])
            audio_store = EmbeddingStore.load_npy_tree(
                os.path.join(trainer.exp_dir, tag), trial.unique_utts)
            video_store = EmbeddingStore.load_npy_tree(
                data.get("video_embedding_root", os.path.join(trainer.exp_dir, "video_em")),
                trial.unique_utts)
            if fusion_type == "score":
                eer, _ = score_fusion_eer(
                    trial, audio_store, video_store,
                    audio_weight=float(test.get("audio_weight", 0.5)),
                    video_weight=float(test.get("video_weight", 0.5)), device=trainer.device)
            else:
                eer, _ = feature_fusion_eer(trial, audio_store, video_store,
                                            device=trainer.device)
            out[f"{trial_key}_fusion_eer"] = eer
            print(f"[{trial_key}] {fusion_type}-fusion EER: {eer * 100:.6f}%")
        return out

    raise SystemExit(f"unknown mode {mode!r}")


def main(argv=None) -> tuple[AudioTrainer, dict]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="conf/audio_config.yaml")
    p.add_argument("--mode", default="train",
                   choices=["train", "test", "av_test", "av_fusion"])
    p.add_argument("--exp-root", default="exp")
    p.add_argument("--resume", default=None)
    p.add_argument("--log-time", default=None)
    p.add_argument("--device", default=None, help="default: the card")
    args = p.parse_args(argv)

    cfg = load_audio_config(args.config)
    if args.resume:
        cfg.train["resume"] = args.resume
    trainer = AudioTrainer(cfg, device=args.device, exp_root=args.exp_root,
                           log_time=args.log_time, mesh=launcher_mesh(args.device))
    return trainer, run_mode(trainer, cfg, args.mode)


if __name__ == "__main__":
    main()
