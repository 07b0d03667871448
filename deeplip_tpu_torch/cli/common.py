"""Shared CLI helpers: test sets from trial lists, speaker labels from
names.

Counterpart of ``deeplip_tpu/cli/common.py``.
"""

from __future__ import annotations

import os

from deeplip_tpu_torch.data.audio_pipeline import EvalUtterance
from deeplip_tpu_torch.eval.scoring import TrialList


def utterances_from_names(names, root: str) -> list[EvalUtterance]:
    """Utterance names resolved against a wav root directory."""
    return [EvalUtterance(n, os.path.join(root, n)) for n in names]


def utterances_from_trials(trial_path: str, root: str) -> list[EvalUtterance]:
    """The unique utterances of a trial list, resolved against ``root``."""
    return utterances_from_names(TrialList.load(trial_path).unique_utts, root)


def labels_from_speaker_prefix(names: list[str]) -> list[int]:
    """LOMGRID-style labels: the ``s<NN>_...`` file name prefix → int(NN)."""
    return [int(os.path.basename(n).split("_")[0].replace("s", "")) for n in names]
