"""Audio x-vector extraction and scoring: the extraction side of the JAX
package's ``AudioTrainer`` (``deeplip_tpu/train/audio.py``).

:class:`AudioExtractor` embeds bucketed PCM batches as ``_embed_fn`` does:
int16 → f32 rescale on the device, the front-end with pre-emphasis masked at
each row's true length, masked CMVN, the E-TDNN, and L2 normalisation (or
the fc1 pre-activation for CrossEntropy systems). It stages the next
batch's host→device copy on a side stream while the current batch computes.

Embedding math is pinned to FP32: cuDNN runs float32 convolutions in TF32
by default, which keeps about three digits and misses the 1e-4 embedding
bar. Training comes in a later slice.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from deeplip_tpu_torch.core.config import Config
from deeplip_tpu_torch.core.device import resolve_device
from deeplip_tpu_torch.data.audio_pipeline import EvalUtteranceSet
from deeplip_tpu_torch.eval.scoring import EmbeddingStore, TrialList, cosine_eer
from deeplip_tpu_torch.models.tdnn import SpeakerEmbNet
from deeplip_tpu_torch.ops import features as F
from deeplip_tpu_torch.ops.masked import length_mask


def masked_cmvn(feat: torch.Tensor, lengths: torch.Tensor,
                eps: float = 2e-12) -> torch.Tensor:
    """Per-utterance CMVN over only the valid frames of a padded batch."""
    mask = length_mask(lengths, feat.shape[1], dtype=feat.dtype)[..., None]
    count = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
    mean = (feat * mask).sum(dim=1, keepdim=True) / count
    var = (((feat - mean) ** 2) * mask).sum(dim=1, keepdim=True) / count
    return (feat - mean) / (torch.sqrt(var) + eps)


@contextlib.contextmanager
def fp32_math():
    """Full-FP32 matmuls and cuDNN convolutions (no TF32) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class AudioExtractor:
    """Config-driven embedding extraction for the E-TDNN audio system.

    ``device=None`` runs on the card and raises where there is none. The
    config's ``python_data_config.backend`` (``xla|pallas``) is accepted,
    but the tensors' device picks the front-end.
    """

    def __init__(self, config: Config, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = Config(config)
        data_opts = self.cfg.get("data") or Config()
        feat_opts = data_opts.get("python_data_config") or Config()
        backend = feat_opts.get("backend", "xla")
        if backend not in ("xla", "pallas"):
            raise ValueError(f"unknown feature backend {backend!r}")
        self.feat_cfg = F.FeatureConfig.from_config(feat_opts)
        self.eval_feat_cfg = dataclasses.replace(
            self.feat_cfg, normalize=False, delta=False)
        model_opts = self.cfg.model
        arch = model_opts.get("arch", "etdnn")
        if arch not in ("tdnn", "etdnn"):
            raise NotImplementedError(f"audio arch {arch!r} is not ported yet")
        self.model = SpeakerEmbNet.from_config(
            model_opts, input_dim=F.feature_dim(self.feat_cfg))
        self.model.to(self.device).eval()
        self.loss_name = (self.cfg.get("train") or Config()).get("loss", "LMCL")
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    def load_state_dict(self, state_dict) -> None:
        """Load reference-layout weights (``strict=True``)."""
        self.model.load_state_dict(state_dict, strict=True)

    @torch.no_grad()
    def embed(self, pcm: torch.Tensor, feat_lengths: torch.Tensor,
              sample_lengths: torch.Tensor) -> torch.Tensor:
        """One padded batch on ``self.device`` -> ``(B, E)`` embeddings."""
        with fp32_math():
            if pcm.dtype == torch.int16:
                # exact power-of-two rescale: PCM16 sources give the same
                # float32 samples as the float32 transport
                pcm = pcm.to(torch.float32) / 32768.0
            feats = F.extract_features(pcm, self.eval_feat_cfg,
                                       sample_lengths=sample_lengths)
            if self.feat_cfg.normalize:
                feats = masked_cmvn(feats, feat_lengths)
            if self.feat_cfg.delta:
                feats = F.add_deltas(feats, order=2)
            xv, x_a = self.model.extract_embedding(feats, lengths=feat_lengths)
            if self.loss_name == "CrossEntropy":
                # CE systems embed with the fc1 pre-activation
                return x_a
            return xv / torch.linalg.vector_norm(
                xv, dim=-1, keepdim=True).clamp(min=1e-12)

    def _stage(self, batch: dict):
        """Start the host→device copies of one batch; on the card they run
        on a side stream and the returned event marks their end."""
        host = [torch.from_numpy(batch[k])
                for k in ("pcm", "feat_lengths", "sample_lengths")]
        if self._copy_stream is None:
            return batch["names"], [h.to(self.device) for h in host], None
        with torch.cuda.stream(self._copy_stream):
            dev = [h.pin_memory().to(self.device, non_blocking=True) for h in host]
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return batch["names"], dev, done

    def _embed_staged(self, staged, store: EmbeddingStore) -> None:
        names, args, done = staged
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in args:
                t.record_stream(stream)
        out = self.embed(*args)
        for i, name in enumerate(names):
            store[name] = out[i]

    def extract_embeddings(self, utterances: EvalUtteranceSet) -> EmbeddingStore:
        """Embed every utterance; the store keeps the tensors on the device.
        The next batch's copy is staged before the current batch computes."""
        store = EmbeddingStore()
        pending = None
        for batch in utterances.batches():
            staged = self._stage(batch)
            if pending is not None:
                self._embed_staged(pending, store)
            pending = staged
        if pending is not None:
            self._embed_staged(pending, store)
        return store

    def evaluate(self, trial_path: str, store: EmbeddingStore) -> tuple[float, float]:
        return cosine_eer(TrialList.load(trial_path), store, device=self.device)
