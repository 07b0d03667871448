"""Audio-visual verification service: paired (speech, lip-ROI clips) inputs.

Counterpart of ``deeplip_tpu/serve/av.py``: the AV analogue of
:class:`deeplip_tpu_torch.serve.verifier.SpeakerVerifier` over the fusion
stack's paired extraction, z-norm(audio x-vector) ++ z-norm(clip-group-mean
video embedding), or the LowFER head's output with ``use_fusion_head``.
Enrollment and verify items are ``(wav, clips)`` pairs: a wav path or
float32 PCM, plus a sequence of mouth-ROI clips (``.npz``/``.npy`` paths or
``(T, H, W)`` uint8 arrays). Clips batch through
:func:`deeplip_tpu_torch.train.fusion.embed_av_items`, one pass per chunk.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from deeplip_tpu_torch.cli.train_fusion import extract_pairs, make_trainer
from deeplip_tpu_torch.core.config import Config, load_fusion_config
from deeplip_tpu_torch.eval.scoring import EmbeddingStore, TrialList
from deeplip_tpu_torch.serve.verifier import ProfileVerifier, _host
from deeplip_tpu_torch.train.fusion import embed_av_items


class AVSpeakerVerifier(ProfileVerifier):
    """Enroll, verify and identify from paired audio + lip-video utterances.

    Args:
        config: fusion config path or loaded :class:`Config`; encoder and
            head checkpoints load from its
            ``train.{audio_config,video_config}.resume`` and ``train.resume``
            keys.
        threshold: accept threshold; usually from :meth:`calibrate`.
        use_fusion_head: score with the fusion head's output instead of the
            z-norm concat (default: ``test.use_fusion_head``).
        device: ``None`` runs on the card and raises where there is none.
    """

    def __init__(self, config: str | Config, threshold: float | None = None,
                 exp_root: str = "exp", log_time: str | None = None,
                 use_fusion_head: bool | None = None,
                 device: str | torch.device | None = None):
        super().__init__(threshold, device)
        cfg = load_fusion_config(config) if isinstance(config, str) else config
        self.cfg = cfg
        # serving is an eval mode of the fusion CLI's trainer wiring
        self.trainer = make_trainer(cfg, exp_root, log_time, mode="av_test", device=device)
        self.use_fusion_head = (bool((cfg.get("test") or {}).get("use_fusion_head", False))
                                if use_fusion_head is None else bool(use_fusion_head))
        self.max_clips = int(cfg.train.get("max_clips", 2))
        self.clip_frames = int(cfg.train.get("clip_frames", 32))

    # -- embedding -------------------------------------------------------
    def embed_items(self, named_items: Mapping[str, tuple]) -> EmbeddingStore:
        """Batched fused embeddings for ``{name: (wav, clips)}``."""
        items = [(n, wav, clips) for n, (wav, clips) in named_items.items()]
        return embed_av_items(self.trainer, items, max_clips=self.max_clips,
                              clip_frames=self.clip_frames,
                              use_fusion_head=self.use_fusion_head)

    def _is_single_item(self, x) -> bool:
        return isinstance(x, tuple) and len(x) == 2

    def _embed_one(self, item) -> np.ndarray:
        return _host(self.embed_items({"_": item})["_"])

    # -- calibration -----------------------------------------------------
    def calibrate(self, trial_path: str) -> tuple[float, float]:
        """Score a trial list with the config's ``data.test_root`` wavs and
        ``data.video_root`` clip groups and adopt the EER threshold.
        Returns ``(eer, threshold)``. As in the JAX package, the extraction
        follows the config's ``test.use_fusion_head``, not the constructor's
        override."""
        trials = TrialList.load(trial_path)
        store = extract_pairs(self.trainer, self.cfg, trials.unique_utts)
        eer, thr = self._trial_eer(trials, store)
        self.threshold = float(thr)
        return float(eer), float(thr)
