"""Audio-visual fusion entry point: train the fusion head, and the eval modes.

Counterpart of ``deeplip_tpu/cli/train_fusion.py``, with its flags and
modes, plus ``--device``:

- ``train``: load the frozen encoders, train the fusion head on paired
  batches (``data.train_manifest`` and the clip groups under
  ``data.video_root``), average the last 2 epochs, then extract the trial
  lists' utterances and score the fused embeddings by cosine;
- ``test`` / ``av_test``: paired extraction over the configured trial lists
  (z-norm audio ++ z-norm video, or the head's output with
  ``test.use_fusion_head``) and the cosine EER; ``av_test`` adds PLDA
  (fitted on ``data.plda_dev_list`` with ``test.train_plda``, scored with
  ``test.use_plda``);
- ``av_fusion``: score-level fusion of separate audio and video cosines
  (``test.audio_weight``/``video_weight``), and the same PLDA branch.

Besides the JAX CLI's keys, ``train.fusion_head`` (``lowfer``, ``linear``,
``cbp``) and ``train.loss`` pick the head and the criterion (the JAX CLI
keeps LowFER and CrossEntropy, the shipped config's values).

Usage::

    python -m deeplip_tpu_torch.cli.train_fusion --config conf/fusion_config.yaml \\
        --mode train [--exp-root exp] [--device cpu]

It runs on the card unless ``--device`` names another device. Under
``torchrun --nproc_per_node N`` the train mode trains the head data-parallel
over the N processes (``train.bs`` is the global batch); rank 0 writes the
checkpoints and the logs and runs the evaluation.
"""

from __future__ import annotations

import argparse
import copy
import glob
import os

import numpy as np
import torch

from deeplip_tpu_torch.cli.common import labels_from_speaker_prefix, launcher_mesh
from deeplip_tpu_torch.core.config import load_fusion_config
from deeplip_tpu_torch.data.fusion_pipeline import AVTrainPipeline
from deeplip_tpu_torch.data.manifest import SpeakerManifest
from deeplip_tpu_torch.eval.plda import PLDA, plda_eer
from deeplip_tpu_torch.eval.scoring import (EmbeddingStore, TrialList, cosine_eer,
                                            score_fusion_eer)
from deeplip_tpu_torch.train.fusion import FusionTrainer, embed_av_items

_LISTS = (("eval_lomgrid", "trial_lomgrid"), ("eval_grid", "trial_grid"))


def _znorm_np(x) -> np.ndarray:
    """Host z-norm of one vector (population std, f32), as
    ``train.fusion._znorm`` computes it on the device."""
    x = np.asarray(x, np.float32)
    return (x - x.mean()) / x.std()


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def build_video_map(manifest: SpeakerManifest, video_root: str) -> dict:
    """Utterance wav path -> its clip group: the ``<stem>*.npz`` files in
    the speaker's directory under ``video_root``, sorted."""
    video_map = {}
    for spk in manifest.speakers:
        for utt in spk:
            stem = os.path.splitext(os.path.basename(utt.path))[0]
            spk_dir = os.path.basename(os.path.dirname(utt.path))
            matches = sorted(glob.glob(os.path.join(video_root, spk_dir, stem + "*.npz")))
            if matches:
                video_map[utt.path] = matches
    return video_map


def _resolve(resume, which: str) -> str | None:
    """A ``resume`` key's path, or None for the yaml spellings of unset. A
    path that does not exist raises: frozen random encoders would give
    plausible but meaningless EERs."""
    if resume in (None, "", "None", "null", "~"):
        return None
    if not os.path.exists(str(resume)):
        raise FileNotFoundError(f"{which} checkpoint not found: {resume}")
    return str(resume)


def _is_pth(path: str | None) -> bool:
    return path is not None and path.endswith(".pth")


def make_trainer(cfg, exp_root: str, log_time: str | None, mode: str = "train",
                 device: str | torch.device | None = None, mesh=None) -> FusionTrainer:
    """The fusion config's trainer with its encoders loaded from the
    ``resume`` keys and, in the eval modes, the fusion head from
    ``train.resume``; each key names the port's ``net_<tag>`` or a
    reference DeepLip ``.pth``. With a train manifest, the speaker count and the steps
    per epoch come from it (``trainer.manifest``); the MultiStep milestones
    ``train.lr_decay_step`` are epochs."""
    model_opts, train_opts = cfg.model, cfg.train
    video_tcn = dict(model_opts.video_config.tcn)
    video_cfg = {
        "backbone_type": video_tcn.get("backbone_type", "resnet"),
        "relu_type": video_tcn.get("relu_type", "prelu"),
        "tcn_kernel_size": video_tcn.get("tcn_kernel_size", [3, 5, 7]),
        "tcn_num_layers": video_tcn.get("tcn_num_layers", 4),
        "tcn_dropout": video_tcn.get("tcn_dropout", 0.2),
        "tcn_dwpw": video_tcn.get("tcn_dwpw", False),
        "tcn_width_mult": video_tcn.get("tcn_width_mult", 1),
    }
    data_opts = cfg.data.get("python_data_config") or {}
    manifest, n_spk, steps_per_epoch = None, int(train_opts.get("n_spk", 0)), 1
    if cfg.data.get("train_manifest") and os.path.exists(str(cfg.data["train_manifest"])):
        manifest = SpeakerManifest.load(str(cfg.data["train_manifest"]))
        n_spk = manifest.n_spk
        mfcc = data_opts.get("mfcc") or {}
        epoch_len = manifest.epoch_length(float(np.mean(cfg.data.get("frames", (200, 400)))),
                                          mfcc.get("win_len", 0.025),
                                          mfcc.get("win_shift", 0.01))
        steps_per_epoch = max(epoch_len // int(train_opts.get("bs", 60)), 1)
    sgd = train_opts.get("sgd") or {}
    trainer = FusionTrainer(
        model_opts.audio_config, video_cfg, n_spk=n_spk, audio_data_opts=data_opts,
        device=device, lr=float(sgd.get("init_lr", 0.5)),
        weight_decay=float(sgd.get("weight_decay", 1e-5)),
        momentum=float(sgd.get("momentum", 0.9)),
        lr_decay_step=train_opts.get("lr_decay_step", [4, 8]),
        lr_decay=float(train_opts.get("lr_decay", 0.1)), steps_per_epoch=steps_per_epoch,
        fusion_head=str(train_opts.get("fusion_head", "lowfer")),
        loss=str(train_opts.get("loss", "CrossEntropy")), exp_root=exp_root,
        log_time=log_time, compute_dtype=str(train_opts.get("compute_dtype", "float32")),
        mesh=mesh)
    trainer.manifest = manifest
    audio_resume = _resolve((train_opts.get("audio_config") or {}).get("resume"),
                            "audio encoder")
    video_resume = _resolve((train_opts.get("video_config") or {}).get("resume"),
                            "video encoder")
    # a reference DeepLip checkpoint is a .pth; the port's are net_<tag>
    # files: dispatch by suffix, as the JAX package does
    trainer.load_torch_encoders(*(p if _is_pth(p) else None
                                  for p in (audio_resume, video_resume)))
    trainer.load_encoders(*(None if _is_pth(p) else p for p in (audio_resume, video_resume)))
    if mode != "train":
        fusion_resume = _resolve(train_opts.get("resume"), "fusion head")
        if _is_pth(fusion_resume):
            trainer.load_torch_fusion_head(fusion_resume)
        elif fusion_resume is not None:
            trainer.load_head_checkpoint(fusion_resume)
    return trainer


def extract_pairs(trainer: FusionTrainer, cfg, names, return_parts: bool = False):
    """Paired per-utterance extraction over a list of utterance names
    (usually a trial list's unique utterances).

    Each name resolves to its wav under ``data.test_root`` and its clip
    group under ``data.video_root`` (the ``<spk>/<stem>*.npz`` glob);
    :func:`deeplip_tpu_torch.train.fusion.embed_av_items` buffers and
    batches them. Returns one fused ``EmbeddingStore``, or with
    ``return_parts`` the ``(audio_store, video_store)`` pair.
    """
    data = cfg.data
    video_root = data.get("video_root", ".")
    test_root = data.get("test_root", ".")
    max_clips = int(cfg.train.get("max_clips", 2))

    def clip_glob(name):
        stem = os.path.splitext(os.path.basename(name))[0]
        return sorted(glob.glob(os.path.join(
            video_root, os.path.dirname(name), stem + "*.npz")))[:max_clips]

    items = [(name, os.path.join(test_root, name), clip_glob(name)) for name in names]
    return embed_av_items(
        trainer, items, max_clips=max_clips,
        clip_frames=int(cfg.train.get("clip_frames", 32)),
        use_fusion_head=bool((cfg.get("test") or {}).get("use_fusion_head", False)),
        return_parts=return_parts)


def _fit_plda(trainer: FusionTrainer, cfg) -> PLDA | None:
    """PLDA fitted on the fused embeddings of ``data.plda_dev_list`` (under
    ``data.dev_root`` where set) when ``test.train_plda`` asks for it;
    saved as ``plda.npz`` in the exp dir."""
    data, test = cfg.data, cfg.get("test") or {}
    if not (test.get("train_plda") and data.get("plda_dev_list")):
        return None
    with open(data["plda_dev_list"]) as fh:
        dev_names = [line.strip() for line in fh if line.strip()]
    dev_cfg = cfg
    if data.get("dev_root"):
        dev_cfg = copy.deepcopy(cfg)
        dev_cfg.data["test_root"] = data["dev_root"]
    dev_store = extract_pairs(trainer, dev_cfg, dev_names)
    x = np.stack([_host(dev_store[n]) for n in dev_names])
    labels = np.asarray(labels_from_speaker_prefix(dev_names))
    model = PLDA().fit(x, labels, n_principal_components=int(test.get("plda_components", 20)))
    os.makedirs(trainer.exp_dir, exist_ok=True)
    model.save(os.path.join(trainer.exp_dir, "plda.npz"))
    return model


def run_eval_lists(trainer: FusionTrainer, cfg, mode: str) -> dict:
    """The eval modes over the configured trial lists; returns per list
    ``<trial_key>_cosine_eer``, ``_score_fusion_eer`` and ``_plda_eer``."""
    test = cfg.get("test") or {}
    out: dict = {}
    plda_model = _fit_plda(trainer, cfg) if mode in ("av_test", "av_fusion") else None
    for list_key, trial_key in _LISTS:
        if not test.get(list_key):
            continue
        trials = TrialList.load(cfg.data[trial_key])
        if mode == "av_fusion":
            audio_store, video_store = extract_pairs(trainer, cfg, trials.unique_utts,
                                                     return_parts=True)
            audio_store.save_npy_tree(os.path.join(trainer.exp_dir, f"test_xv_{trial_key}"))
            video_store.save_npy_tree(os.path.join(trainer.exp_dir,
                                                   f"test_em_video_{trial_key}"))
            if test.get("use_cos", True):
                eer, _ = score_fusion_eer(
                    trials, audio_store, video_store,
                    audio_weight=float(test.get("audio_weight", 0.5)),
                    video_weight=float(test.get("video_weight", 0.5)), device=trainer.device)
                out[f"{trial_key}_score_fusion_eer"] = eer
                print(f"[{trial_key}] score-fusion EER: {eer * 100:.6f}%")
            if test.get("use_plda") and plda_model is not None:
                if test.get("use_fusion_head", False):
                    # the head's output is not derivable from the parts
                    fused = extract_pairs(trainer, cfg, trials.unique_utts)
                else:
                    # z-norm + concat of the parts already extracted
                    fused = EmbeddingStore()
                    for n in trials.unique_utts:
                        fused[n] = np.concatenate([_znorm_np(_host(audio_store[n])),
                                                   _znorm_np(_host(video_store[n]))])
                eer, _ = plda_eer(trials, fused, plda_model)
                out[f"{trial_key}_plda_eer"] = eer
                print(f"[{trial_key}] PLDA EER: {eer * 100:.6f}%")
            continue
        store = extract_pairs(trainer, cfg, trials.unique_utts)
        store.save_npy_tree(os.path.join(trainer.exp_dir, f"test_em_{trial_key}"))
        if test.get("use_cos", True):
            eer, _ = cosine_eer(trials, store, device=trainer.device)
            out[f"{trial_key}_cosine_eer"] = eer
            print(f"[{trial_key}] fusion EER: {eer * 100:.6f}%")
        if mode == "av_test" and test.get("use_plda") and plda_model is not None:
            eer, _ = plda_eer(trials, store, plda_model)
            out[f"{trial_key}_plda_eer"] = eer
            print(f"[{trial_key}] PLDA EER: {eer * 100:.6f}%")
    return out


def main(argv=None) -> tuple[FusionTrainer, dict]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="conf/fusion_config.yaml")
    p.add_argument("--mode", default="train", choices=["train", "test", "av_test", "av_fusion"])
    p.add_argument("--exp-root", default="exp")
    p.add_argument("--log-time", default=None)
    p.add_argument("--device", default=None, help="default: the card")
    args = p.parse_args(argv)

    cfg = load_fusion_config(args.config)
    trainer = make_trainer(cfg, args.exp_root, args.log_time, mode=args.mode,
                           device=args.device,
                           mesh=launcher_mesh(args.device) if args.mode == "train" else None)
    if args.mode != "train":
        return trainer, run_eval_lists(trainer, cfg, args.mode)
    if trainer.manifest is None:
        raise SystemExit("train mode needs data.train_manifest")
    pipeline = AVTrainPipeline(
        trainer.manifest, build_video_map(trainer.manifest, cfg.data.get("video_root", ".")),
        batch_size=int(cfg.train.get("bs", 60)),
        frame_range=tuple(cfg.data.get("frames", (200, 400))),
        max_clips=int(cfg.train.get("max_clips", 2)),
        clip_frames=int(cfg.train.get("clip_frames", 32)))
    losses = trainer.train(pipeline, epochs=int(cfg.train.get("epoch", 15)))
    trainer.model_average(avg_num=2)
    # the reference's train mode evaluates after training (rank 0 alone)
    evals = run_eval_lists(trainer, cfg, "test") if trainer.mesh.is_main else {}
    return trainer, {"losses": losses, **evals}


if __name__ == "__main__":
    main()
