"""Per-epoch checkpoints in the reference's ``.pth`` container.

Counterpart of ``deeplip_tpu/train/checkpoint.py`` (which stores Orbax
trees): ``exp/<log_time>/net_<epoch>`` holds ``torch.save({"epoch",
"state_dict"})``, the layout the reference's trainers read back. Checkpoint
averaging comes with audio training.
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


def latest_checkpoint(exp_dir: str) -> int | None:
    """Highest numeric ``net_<epoch>`` present in ``exp_dir``."""
    if not os.path.isdir(exp_dir):
        return None
    epochs = [int(m.group(1)) for name in os.listdir(exp_dir)
              if (m := re.fullmatch(r"net_(\d+)", name))]
    return max(epochs) if epochs else None
