"""Carry weights from the JAX package's parameter trees into the port.

The JAX ``SpeakerEmbNet`` keeps Flax trees: ``params`` with ``tdnn_{i}``
blocks (``conv: kernel (K, I, O), bias``; ``bn: scale, bias``), ``fc1`` and
``fc2`` (``kernel (I, O), bias``) and ``bn1``/``bn2``; ``batch_stats`` with
the BN ``mean``/``var``. :func:`speaker_embnet_state_dict` maps them onto
the reference torch layout the port's modules use. It computes the same dict
as ``deeplip_tpu.interop.torch_export.export_speaker_embnet_state_dict``, as
tensors, without importing the JAX package: callers hand in nested dicts of
numpy arrays.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _bn(out: dict, prefix: str, p: Mapping[str, Any], s: Mapping[str, Any]) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])
    out[f"{prefix}.running_mean"] = _t(s["mean"])
    out[f"{prefix}.running_var"] = _t(s["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _dense(out: dict, prefix: str, p: Mapping[str, Any]) -> None:
    # Flax Dense (I, O) -> torch Linear (O, I)
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{prefix}.bias"] = _t(p["bias"])


def _conv1d(out: dict, prefix: str, p: Mapping[str, Any]) -> None:
    # Flax Conv (K, I, O) -> torch Conv1d (O, I, K)
    out[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (2, 1, 0)))
    out[f"{prefix}.bias"] = _t(p["bias"])


def speaker_embnet_state_dict(params: Mapping[str, Any],
                              batch_stats: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``SpeakerEmbNet`` params + batch_stats -> the port's state dict."""
    n_blocks = sum(1 for k in params if k.startswith("tdnn_"))
    if n_blocks == 0:
        raise ValueError("not a SpeakerEmbNet param tree: no tdnn_{i} blocks")
    if "pool" in params:
        raise NotImplementedError("attentive poolings are not ported yet")
    out: dict[str, torch.Tensor] = {}
    for i in range(n_blocks):
        blk = params[f"tdnn_{i}"]
        _conv1d(out, f"tdnn.{i}.context_layer", blk["conv"])
        _bn(out, f"tdnn.{i}.bn", blk["bn"], batch_stats[f"tdnn_{i}"]["bn"])
    for name in ("fc1", "fc2"):
        _dense(out, name, params[name])
    for name in ("bn1", "bn2"):
        _bn(out, name, params[name], batch_stats[name])
    return out
