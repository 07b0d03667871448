"""Write the port's weights as reference DeepLip ``.pth`` checkpoints.

Counterpart of ``deeplip_tpu/interop/torch_export.py``, and the inverse of
:mod:`deeplip_tpu_torch.interop.torch_import`. The port's state dicts are
already in the reference layouts, so only the containers are built, as the
reference's savers write them:

- audio: ``{"epoch", "state_dict", "optimizer": {}, "criterion_state_dict"}``.
  The reference pickles its live criterion module under ``criterion``; the
  port writes the criterion's weights as a plain tensor dict instead, which
  the reference's loader ignores as it ignores the module;
- video: the bare Lipreading state dict;
- fusion: the audio container around LowFER's ``U`` and ``V``.

``data_parallel_prefix`` puts ``module.`` before every key, as a
DataParallel-wrapped reference trainer saves and loads them. The tensors are
written as copies on the CPU.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch


def _cpu(sd: Mapping[str, torch.Tensor], data_parallel_prefix: bool = False) -> dict:
    prefix = "module." if data_parallel_prefix else ""
    return {prefix + k: v.detach().to("cpu", copy=True) for k, v in sd.items()}


def _container(state_dict: dict, epoch: int, criterion_state_dict) -> dict[str, Any]:
    tree: dict[str, Any] = {"epoch": int(epoch), "state_dict": state_dict, "optimizer": {}}
    if criterion_state_dict:
        tree["criterion_state_dict"] = _cpu(criterion_state_dict)
    return tree


def save_reference_audio_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor],
                                    epoch: int = 0,
                                    criterion_state_dict: Mapping | None = None,
                                    data_parallel_prefix: bool = False) -> None:
    """Write an E-TDNN state dict as a reference audio ``net_<epoch>.pth``."""
    torch.save(_container(_cpu(state_dict, data_parallel_prefix), epoch,
                          criterion_state_dict), path)


def save_reference_video_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor],
                                    data_parallel_prefix: bool = False) -> None:
    """Write a Lipreading state dict as the reference's bare video
    checkpoint."""
    torch.save(_cpu(state_dict, data_parallel_prefix), path)


def save_reference_fusion_checkpoint(path: str, head_state_dict: Mapping[str, torch.Tensor],
                                     epoch: int = 0,
                                     criterion_state_dict: Mapping | None = None,
                                     data_parallel_prefix: bool = False) -> None:
    """Write a LowFER head (``U``, ``V``) as a reference fusion
    ``net_<epoch>.pth``; another head raises."""
    missing = [k for k in ("U", "V") if k not in head_state_dict]
    if missing:
        raise ValueError(f"a reference fusion checkpoint holds LowFER U/V; this head has "
                         f"{sorted(head_state_dict)}")
    head = {k: head_state_dict[k] for k in ("U", "V")}
    torch.save(_container(_cpu(head, data_parallel_prefix), epoch, criterion_state_dict),
               path)
