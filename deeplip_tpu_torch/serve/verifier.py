"""Speaker verification and identification service over an audio model.

Counterpart of ``deeplip_tpu/serve/verifier.py``. Built from the port's
extraction path (:class:`deeplip_tpu_torch.train.audio.AudioExtractor`:
DSP, network and L2 norm on the device, length-bucketed batches) and the
reference-formula EER back-end (``eval/eer.py``), so a verify decision is
consistent with the offline trial protocol.

Semantics (shared with :class:`deeplip_tpu_torch.serve.av.AVSpeakerVerifier`):

- **enroll**: the speaker profile is the L2-normalised mean of the
  utterance embeddings; with one utterance it is that utterance's
  embedding, so verify equals the trial protocol's cosine.
- **verify**: cosine(profile, utterance) >= threshold. The threshold comes
  from :meth:`calibrate`, the EER operating point of a trial list scored
  with this model, or is set directly.
- **identify**: ranked cosine against all enrolled profiles.
- **score normalisation**: with an impostor cohort set
  (:meth:`ProfileVerifier.set_cohort`) every score, the calibrated
  threshold included, is AS-normed (:mod:`deeplip_tpu_torch.eval.snorm`).

Profiles, thresholds and scores are host numpy at this class's edges, as in
the JAX package. Scoring jobs below ``host_score_macs`` run on numpy f32
twins of the tensor scoring ops and agree with them to f32 roundoff.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Mapping, Sequence

import numpy as np
import torch

from deeplip_tpu_torch.core.config import Config, load_audio_config
from deeplip_tpu_torch.core.device import resolve_device
from deeplip_tpu_torch.data.audio_pipeline import (EvalUtterance, EvalUtteranceSet,
                                                   eval_set_kwargs)
from deeplip_tpu_torch.eval.eer import eer_from_scores
from deeplip_tpu_torch.eval.scoring import (EmbeddingStore, TrialList, cosine_scores,
                                            cosine_scores_np, trial_matrix_pairs)
from deeplip_tpu_torch.eval.snorm import (asnorm_trial_scores, asnorm_trial_scores_np,
                                          cohort_matrix)
from deeplip_tpu_torch.train.audio import AudioExtractor


@dataclasses.dataclass
class VerifyResult:
    speaker: str
    score: float
    threshold: float
    accept: bool


def _l2(v: np.ndarray) -> np.ndarray:
    return v / max(float(np.linalg.norm(v)), 1e-12)


def _host(v) -> np.ndarray:
    """An embedding or matrix as host numpy (a device tensor is copied, and
    the copy waits for the work that produced it)."""
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def cohort_fingerprint(cohort: np.ndarray | None, top_k: int = 200) -> str | None:
    """Stable identity of an AS-norm scoring scale: a short hash of the
    cohort matrix bytes, its shape and ``top_k`` (``None``: raw cosine).
    A threshold is valid only on the scale it was calibrated on, so
    persisted thresholds carry this fingerprint."""
    if cohort is None:
        return None
    m = np.ascontiguousarray(np.asarray(cohort, np.float32))
    h = hashlib.sha256(m.tobytes())
    h.update(str(m.shape).encode())
    h.update(str(int(top_k)).encode())
    return h.hexdigest()[:16]


class ProfileVerifier:
    """Enrollment-profile store and cosine decisions over any embedder.

    Subclasses provide ``_embed_one(item) -> np.ndarray`` (any norm; it is
    normalised here) and ``_is_single_item(x)``. ``device`` is where the
    larger scoring jobs run (``None``: the card).
    """

    #: scoring work below this many multiply-accumulates runs on the host
    #: (numpy f32 twins of the tensor scoring ops) instead of the device: a
    #: batch-1 verify or identify is a handful of dot products behind
    #: several kernel launches and a copy back. Large sweeps (calibrate, a
    #: big identify x cohort) stay on the device. Set to 0 to force every
    #: score onto the device back-end.
    host_score_macs: int = 8_000_000

    def __init__(self, threshold: float | None = None,
                 device: str | torch.device | None = None):
        self.threshold = threshold
        self.device = device
        self.profiles: dict[str, np.ndarray] = {}
        self.cohort: np.ndarray | None = None
        self.cohort_top_k = 200

    def _embed_one(self, item) -> np.ndarray:
        raise NotImplementedError

    def _is_single_item(self, x) -> bool:
        raise NotImplementedError

    # -- enrollment ------------------------------------------------------
    def enroll(self, speaker: str, items) -> np.ndarray:
        """Enroll ``speaker`` from one or more utterances: the profile is
        the L2-normalised mean of unit-normalised utterance embeddings.
        Re-enrolling replaces the profile."""
        if self._is_single_item(items):
            items = [items]
        embs = [_l2(_host(self._embed_one(it)).reshape(-1)) for it in items]
        self.profiles[speaker] = _l2(np.mean(embs, axis=0))
        return self.profiles[speaker]

    # -- score normalization ----------------------------------------------
    def set_cohort(self, cohort, top_k: int = 200) -> None:
        """Switch on AS-norm against ``cohort``: a ``(C, D)`` matrix, an
        ``EmbeddingStore`` or a ``{name: vec}`` mapping of impostor
        embeddings extracted with this model; ``None`` returns to raw
        cosine. A change of cohort changes the scoring scale, so the
        operating threshold is reset to ``None`` and :meth:`verify` refuses
        to decide until :meth:`calibrate` runs again or a threshold of the
        new scale is set."""
        if cohort is None:
            if self.cohort is not None:
                self.threshold = None
            self.cohort = None
            return
        self.cohort = cohort_matrix(cohort)
        self.cohort_top_k = int(top_k)
        self.threshold = None

    def _pair_scores(self, emb, pairs) -> np.ndarray:
        """Raw or AS-normed cosines for index ``pairs`` into ``emb`` rows
        (numpy, or a tensor on any device), as host numpy. Jobs under
        ``host_score_macs`` multiply-accumulates run on the host twins, the
        rest on ``self.device``."""
        pairs = np.asarray(pairs, np.int64)
        n, d = emb.shape
        macs = (n + len(pairs)) * d
        if self.cohort is not None:
            macs += n * self.cohort.shape[0] * d
        if macs < self.host_score_macs:
            e = _host(emb).astype(np.float32, copy=False)
            if self.cohort is None:
                return cosine_scores_np(e, pairs)
            return asnorm_trial_scores_np(e, pairs, self.cohort, self.cohort_top_k)
        dev = resolve_device(self.device)
        if self.cohort is None:
            return cosine_scores(torch.as_tensor(emb).to(dev, torch.float32),
                                 torch.from_numpy(pairs).to(dev)).cpu().numpy()
        return asnorm_trial_scores(emb, pairs, self.cohort, self.cohort_top_k, device=dev)

    def _trial_eer(self, trials: TrialList, store: EmbeddingStore) -> tuple[float, float]:
        """Trial-list (eer, threshold) under the active scoring back-end, so
        the calibrated threshold and the serving scores live on one scale."""
        emb, pairs = trial_matrix_pairs(trials, store)
        return eer_from_scores(trials.labels, self._pair_scores(emb, pairs))

    # -- decisions -------------------------------------------------------
    # Each decision is embed, then score on the embedding; the *_embedding
    # methods take an embedding already computed, so a batching front-end
    # (serve.microbatch.MicroBatcher) can coalesce the embedding work of
    # concurrent requests and finish each with the code direct calls use.
    def _need_threshold(self) -> None:
        if self.threshold is None:
            raise ValueError("no operating threshold: call calibrate(...) or construct "
                             "with threshold=")

    def score_embedding(self, speaker: str, e: np.ndarray) -> float:
        if speaker not in self.profiles:
            raise KeyError(f"speaker {speaker!r} is not enrolled")
        emb = np.stack([self.profiles[speaker], _l2(_host(e).reshape(-1))])
        return float(self._pair_scores(emb, np.asarray([[0, 1]]))[0])

    def verify_embedding(self, speaker: str, e: np.ndarray) -> VerifyResult:
        self._need_threshold()
        s = self.score_embedding(speaker, e)
        return VerifyResult(speaker=speaker, score=s, threshold=self.threshold,
                            accept=bool(s >= self.threshold))

    def score(self, speaker: str, item) -> float:
        """Similarity between the speaker's profile and ``item``: cosine, or
        its AS-normed value when a cohort is set."""
        if speaker not in self.profiles:
            raise KeyError(f"speaker {speaker!r} is not enrolled")
        return self.score_embedding(speaker, self._embed_one(item))

    def verify(self, speaker: str, item) -> VerifyResult:
        self._need_threshold()
        s = self.score(speaker, item)
        return VerifyResult(speaker=speaker, score=s, threshold=self.threshold,
                            accept=bool(s >= self.threshold))

    def identify_embedding(self, e: np.ndarray, top_k: int = 1) -> list[tuple[str, float]]:
        if not self.profiles:
            raise ValueError("no speakers enrolled")
        e = _l2(_host(e).reshape(-1))
        names = list(self.profiles)
        emb = np.stack([self.profiles[n] for n in names] + [e])
        pairs = np.stack([np.arange(len(names)), np.full(len(names), len(names))], axis=1)
        scores = self._pair_scores(emb, pairs)
        order = np.argsort(-scores)[:top_k]
        return [(names[i], float(scores[i])) for i in order]

    def identify(self, item, top_k: int = 1) -> list[tuple[str, float]]:
        """Ranked ``(speaker, score)`` over all enrolled profiles, scored as
        :meth:`score` scores (profile-side cohort statistics differ per
        speaker, so normalisation can change the ranking)."""
        if not self.profiles:
            raise ValueError("no speakers enrolled")
        return self.identify_embedding(self._embed_one(item), top_k=top_k)

    # -- persistence -----------------------------------------------------
    def save_profiles(self, out_dir: str) -> None:
        store = EmbeddingStore()
        for name, emb in self.profiles.items():
            store[name] = emb
        store.save_npy_tree(out_dir)

    def load_profiles(self, out_dir: str) -> None:
        for dirpath, _dirs, files in os.walk(out_dir):
            for f in files:
                if f.endswith(".npy"):
                    rel = os.path.relpath(os.path.join(dirpath, f), out_dir)
                    self.profiles[rel[:-len(".npy")]] = _l2(
                        np.load(os.path.join(dirpath, f)).reshape(-1))


class SpeakerVerifier(ProfileVerifier):
    """Enroll, verify and identify on top of an audio embedding model.

    Args:
        config: an audio config path or loaded :class:`Config` (only the
            ``data.python_data_config``, ``model``, ``train.loss`` and
            ``test`` sections matter for serving).
        checkpoint: optional checkpoint file (``AudioExtractor.load_checkpoint``):
            the port's ``net_<tag>``, or a reference DeepLip ``.pth``
            (dispatch by suffix, as the train CLIs do).
        threshold: accept threshold for :meth:`verify`; usually left unset
            and obtained from :meth:`calibrate`.
        device: ``None`` runs on the card and raises where there is none.
    """

    def __init__(self, config: str | Config, checkpoint: str | None = None,
                 threshold: float | None = None,
                 device: str | torch.device | None = None):
        super().__init__(threshold, device)
        cfg = load_audio_config(config) if isinstance(config, str) else config
        self.extractor = AudioExtractor(cfg, device=device)
        if checkpoint:
            self.extractor.load_checkpoint(str(checkpoint))

    # -- embedding -------------------------------------------------------
    def _utt_set(self, utts: Sequence[EvalUtterance], reader=None,
                 set_overrides: Mapping | None = None) -> EvalUtteranceSet:
        test_opts = dict(self.extractor.test_opts)
        if set_overrides:
            test_opts.update(set_overrides)
        kw = eval_set_kwargs(self.extractor.feat_cfg, test_opts)
        if reader is not None:
            kw["reader"] = reader
        return EvalUtteranceSet(utts, **kw)

    def embed_files(self, named_paths: Mapping[str, str]) -> EmbeddingStore:
        """Batched embeddings for ``{name: wav_path}``."""
        utts = [EvalUtterance(n, p) for n, p in named_paths.items()]
        return self.extractor.extract_embeddings(self._utt_set(utts))

    def embed_pcm(self, named_pcm: Mapping[str, np.ndarray], rate: int | None = None,
                  set_overrides: Mapping | None = None) -> EmbeddingStore:
        """Batched embeddings for in-memory PCM ``{name: float32 samples}``.
        ``set_overrides`` overlays ``test_opts`` for this call only (the
        micro-batching front-end pins ``n_buckets: 0``)."""
        sr = int(rate or self.extractor.feat_cfg.rate)
        table = {n: np.asarray(p, np.float32) for n, p in named_pcm.items()}
        utts = [EvalUtterance(n, n) for n in table]
        return self.extractor.extract_embeddings(self._utt_set(
            utts, reader=lambda key: (table[key], sr), set_overrides=set_overrides))

    def _is_single_item(self, x) -> bool:
        return isinstance(x, (str, np.ndarray))

    def _embed_one(self, wav: str | np.ndarray) -> np.ndarray:
        store = self.embed_files({"_": wav}) if isinstance(wav, str) else self.embed_pcm({"_": wav})
        return _host(store["_"])

    # -- calibration -----------------------------------------------------
    def calibrate(self, trial_path: str, root: str = ".") -> tuple[float, float]:
        """Extract every utterance of a trial list with this model, compute
        the reference-formula EER and adopt its threshold as the operating
        point. Returns ``(eer, threshold)``."""
        trials = TrialList.load(trial_path)
        store = self.embed_files({u: os.path.join(root, u) for u in trials.unique_utts})
        eer, thr = self._trial_eer(trials, store)
        self.threshold = float(thr)
        return float(eer), float(thr)

    def set_cohort_files(self, wav_paths: Sequence[str], top_k: int = 200) -> None:
        """Build the AS-norm cohort by embedding ``wav_paths`` (held-out
        impostor utterances) with this model, then :meth:`set_cohort`."""
        self.set_cohort(self.embed_files({p: p for p in wav_paths}), top_k=top_k)
