"""Shared CLI helpers: test sets from trial lists, speaker labels from
names, and the process mesh under ``torchrun``.

Counterpart of ``deeplip_tpu/cli/common.py``.
"""

from __future__ import annotations

import os

from deeplip_tpu_torch.core.distributed import initialize, make_multihost_mesh
from deeplip_tpu_torch.core.mesh import Mesh

from deeplip_tpu_torch.data.audio_pipeline import EvalUtterance
from deeplip_tpu_torch.eval.scoring import TrialList


def utterances_from_trials_list(names, root: str) -> list[EvalUtterance]:
    """Utterance names resolved against a wav root directory."""
    return [EvalUtterance(n, os.path.join(root, n)) for n in names]


def utterances_from_trials(trial_path: str, root: str) -> list[EvalUtterance]:
    """The unique utterances of a trial list, resolved against ``root``."""
    return utterances_from_trials_list(TrialList.load(trial_path).unique_utts, root)


def labels_from_speaker_prefix(names: list[str]) -> list[int]:
    """LOMGRID-style labels: the ``s<NN>_...`` file name prefix → int(NN)."""
    return [int(os.path.basename(n).split("_")[0].replace("s", "")) for n in names]


def launcher_mesh(device=None) -> Mesh | None:
    """Under a launcher of more than one process (``torchrun
    --nproc_per_node N``: ``WORLD_SIZE > 1``), join the process group (NCCL
    on the card, gloo with ``--device cpu``) and return the ``(dcn, data)``
    mesh over it; None for one process, which runs as it always has."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    initialize(device=device)
    return make_multihost_mesh()
