"""Audio-visual fusion: trainer wiring and paired extraction for the eval
modes.

Counterpart of ``deeplip_tpu/cli/train_fusion.py``: :func:`make_trainer`
builds the :class:`FusionTrainer` of a fusion config and loads the frozen
encoders and, in the eval modes, the fusion head from the config's
``resume`` keys; :func:`extract_pairs` resolves utterance names to their
wav and clip group and embeds them. The train mode, the PLDA branch and the
command line itself come with fusion training.
"""

from __future__ import annotations

import glob
import os

import torch

from deeplip_tpu_torch.train.fusion import FusionTrainer, embed_av_items


def make_trainer(cfg, exp_root: str, log_time: str | None, mode: str = "train",
                 device: str | torch.device | None = None) -> FusionTrainer:
    """The fusion config's trainer for an eval mode (``test``, ``av_test``,
    ``av_fusion``), with its checkpoints loaded. A ``resume`` path that does
    not exist raises: frozen random encoders would give plausible but
    meaningless EERs."""
    if mode == "train":
        raise NotImplementedError("fusion training is not ported yet")
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
    trainer = FusionTrainer(
        model_opts.audio_config, video_cfg, n_spk=int(train_opts.get("n_spk", 0)),
        audio_data_opts=cfg.data.get("python_data_config", {}), device=device,
        exp_root=exp_root, log_time=log_time)

    def resolve(resume, which):
        if resume in (None, "", "None", "null", "~"):
            return None
        if not os.path.exists(str(resume)):
            raise FileNotFoundError(f"{which} checkpoint not found: {resume}")
        return str(resume)

    trainer.load_encoders(
        resolve((train_opts.get("audio_config") or {}).get("resume"), "audio encoder"),
        resolve((train_opts.get("video_config") or {}).get("resume"), "video encoder"))
    fusion_resume = resolve(train_opts.get("resume"), "fusion head")
    if fusion_resume is not None:
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
