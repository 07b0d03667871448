"""Write the port's weights as reference DeepLip ``.pth`` checkpoints.

Counterpart of ``deeplip_tpu/interop/torch_export.py``, and the inverse of
:mod:`deeplip_tpu_torch.interop.torch_import`. The port's state dicts are
already in the reference layouts, so only the containers are built, as the
reference's savers write them:

- audio: ``{"epoch", "state_dict", "optimizer": {}, "criterion_state_dict"}``.
  The reference pickles its live criterion module under ``criterion``; the
  port writes the criterion's weights as a plain tensor dict instead, which
  the reference's loader ignores as it ignores the module. Only the TDNN
  family exports, as in the JAX package: the reference has no layout for
  the spectrogram ResNet. ``pooling`` names the reference layout of an
  attentive pooling's ``pooling.{W,b,v,k}``: ``attentive_statistic``
  stores them as they are, ``mono_head_attention`` adds the reference's
  leading broadcast axes; the multi-head pooling has no reference layout;
- video: the bare Lipreading state dict (ResNet or ShuffleNetV2 trunk; a
  depthwise-separable TCN keeps the port's names, for which the reference
  has no layout);
- fusion: the audio container around LowFER's ``U`` and ``V``.

``data_parallel_prefix`` puts ``module.`` before every key, as a
DataParallel-wrapped reference trainer saves and loads them. The tensors are
written as copies on the CPU.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from deeplip_tpu_torch.interop.torch_import import shufflenet_last


def _cpu(sd: Mapping[str, torch.Tensor], data_parallel_prefix: bool = False) -> dict:
    prefix = "module." if data_parallel_prefix else ""
    return {prefix + k: v.detach().to("cpu", copy=True) for k, v in sd.items()}


def _container(state_dict: dict, epoch: int, criterion_state_dict) -> dict[str, Any]:
    tree: dict[str, Any] = {"epoch": int(epoch), "state_dict": state_dict, "optimizer": {}}
    if criterion_state_dict:
        tree["criterion_state_dict"] = _cpu(criterion_state_dict)
    return tree


POOLING_LAYOUTS = ("attentive_statistic", "mono_head_attention")


def pooling_to_reference(state_dict: Mapping[str, torch.Tensor],
                         pooling: str | None) -> dict[str, torch.Tensor]:
    """``state_dict`` with its attentive pooling in the reference ``pooling``
    layout; as it is where ``pooling`` is None or the model has none."""
    sd = dict(state_dict)
    if pooling is None or "pooling.W" not in sd:
        return sd
    if pooling not in POOLING_LAYOUTS:
        raise ValueError(f"pooling layout {pooling!r}: the reference has {POOLING_LAYOUTS}")
    w, b = sd["pooling.W"], sd["pooling.b"]
    if w.ndim != 2:
        raise ValueError(f"a pooling W of shape {tuple(w.shape)} (multi-head) has no "
                         "reference layout")
    hidden = w.shape[0]
    want_b = (hidden, 1) if pooling == "mono_head_attention" else (1, hidden)
    if tuple(b.shape) != want_b:
        raise ValueError(f"--pooling {pooling}: the model's pooling b has shape "
                         f"{tuple(b.shape)}, that layout's is {want_b}")
    if pooling == "mono_head_attention":
        shapes = {"W": (1, hidden, -1), "b": (1, hidden, 1), "v": (1, 1, hidden),
                  "k": (1, 1, 1)}
        sd.update({f"pooling.{n}": sd[f"pooling.{n}"].reshape(s) for n, s in shapes.items()})
    return sd


def save_reference_audio_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor],
                                    epoch: int = 0,
                                    criterion_state_dict: Mapping | None = None,
                                    data_parallel_prefix: bool = False,
                                    pooling: str | None = None) -> None:
    """Write an E-TDNN state dict as a reference audio ``net_<epoch>.pth``,
    an attentive pooling in the ``pooling`` layout; another model raises."""
    if not any(k.startswith("tdnn.") for k in state_dict):
        raise ValueError("not a TDNN/E-TDNN state dict: the reference defines no checkpoint "
                         "layout for the other audio archs")
    torch.save(_container(_cpu(pooling_to_reference(state_dict, pooling),
                               data_parallel_prefix), epoch, criterion_state_dict), path)


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


# ---------------------------------------------------------------------------
# per-module converters: a port module's state dict -> the reference layout
# (the JAX exporters' names and arguments), as CPU copies


def export_speaker_embnet_state_dict(state_dict: Mapping[str, torch.Tensor],
                                     pooling: str | None = "attentive_statistic",
                                     data_parallel_prefix: bool = False) -> dict:
    """A port ``SpeakerEmbNet`` state dict in the reference layout, an
    attentive pooling in the ``pooling`` layout."""
    if not any(k.startswith("tdnn.") for k in state_dict):
        raise ValueError("not a TDNN/E-TDNN state dict: the reference defines no checkpoint "
                         "layout for the other audio archs")
    return _cpu(pooling_to_reference(state_dict, pooling), data_parallel_prefix)


def export_lmcl_state_dict(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The LMCL criterion's ``weights``."""
    return _cpu({"weights": state_dict["weights"]})


def export_criterion_state_dict(state_dict: Mapping[str, torch.Tensor]) -> dict | None:
    """A criterion's weights in the reference layout: CrossEntropy's
    ``fc.weight``/``fc.bias`` or LMCL's ``weights``; None for another."""
    if "fc.weight" in state_dict:
        return _cpu({k: state_dict[k] for k in ("fc.weight", "fc.bias") if k in state_dict})
    if "weights" in state_dict:
        return export_lmcl_state_dict(state_dict)
    return None


def export_lowfer_state_dict(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """LowFER's ``U`` and ``V``."""
    return _cpu({k: state_dict[k] for k in ("U", "V")})


def export_shufflenet_trunk_state_dict(state_dict: Mapping[str, torch.Tensor],
                                       prefix: str = "trunk.0.") -> dict:
    """A port ``ShuffleNetV2Trunk`` state dict (``0.*`` the units, ``1.*``
    the last conv) under the reference's names: the units under ``prefix``,
    the last conv under its ``conv_last``."""
    last = shufflenet_last(prefix)
    out = {}
    for key, value in state_dict.items():
        part, rest = key.split(".", 1)
        out[(prefix if part == "0" else last) + rest] = value
    return _cpu(out)


def export_lipreading_state_dict(state_dict: Mapping[str, torch.Tensor],
                                 data_parallel_prefix: bool = False) -> dict:
    """A port ``Lipreading`` state dict in the reference layout, which is
    its own."""
    return _cpu(state_dict, data_parallel_prefix)
