"""Per-epoch checkpoints in the reference's ``.pth`` container.

Counterpart of ``deeplip_tpu/train/checkpoint.py`` (which stores Orbax
trees): ``exp/<log_time>/net_<epoch>`` holds ``torch.save({"epoch",
"state_dict", ...})``, the layout the reference's trainers read back (the
audio trainer adds ``"criterion"`` and ``"optimizer"``).
:func:`average_checkpoints` writes the mean of the last epochs' weights as
``net_avg``.
"""

from __future__ import annotations

import os
import re
from typing import Any

import torch


def checkpoint_path(exp_dir: str, tag: str | int) -> str:
    name = tag if isinstance(tag, str) and tag.startswith("net") else f"net_{tag}"
    return os.path.join(os.path.abspath(exp_dir), name)


def save_checkpoint(exp_dir: str, tag: str | int, tree: dict[str, Any]) -> str:
    """Write ``net_<tag>`` (through a temporary file, so a reader never sees
    half of one)."""
    path = checkpoint_path(exp_dir, tag)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(exp_dir: str, tag: str | int,
                    map_location: str | torch.device | None = None) -> dict[str, Any]:
    return torch.load(checkpoint_path(exp_dir, tag), map_location=map_location,
                      weights_only=True)


def average_checkpoints(exp_dir: str, epochs: list[int],
                        out_tag: str = "avg") -> dict[str, Any]:
    """Elementwise mean of the saved ``state_dict`` and ``criterion`` over
    ``epochs``, taken in float64 and cast back; integer leaves
    (``num_batches_tracked``) come from the first checkpoint, and so does
    everything else in the tree.
    Writes ``net_<out_tag>`` and returns the averaged tree."""
    trees = [load_checkpoint(exp_dir, e, map_location="cpu") for e in epochs]

    def mean(*leaves):
        if not leaves[0].is_floating_point():
            return leaves[0]
        total = sum(t.to(torch.float64) for t in leaves)
        return (total / len(leaves)).to(leaves[0].dtype)

    avg = dict(trees[0])
    for key in ("state_dict", "criterion"):
        if avg.get(key) is not None:
            avg[key] = {name: mean(*(t[key][name] for t in trees)) for name in avg[key]}
    save_checkpoint(exp_dir, out_tag, avg)
    return avg


def latest_checkpoint(exp_dir: str) -> int | None:
    """Highest numeric ``net_<epoch>`` present in ``exp_dir``."""
    if not os.path.isdir(exp_dir):
        return None
    epochs = [int(m.group(1)) for name in os.listdir(exp_dir)
              if (m := re.fullmatch(r"net_(\d+)", name))]
    return max(epochs) if epochs else None
