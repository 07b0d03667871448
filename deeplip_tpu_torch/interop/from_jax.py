"""Carry weights from the JAX package's parameter trees into the port.

The JAX models keep Flax trees: ``params`` (conv ``kernel`` in ``(..., I,
O)`` order, Dense ``kernel (I, O)``, BN ``scale``/``bias``, PReLU
``alpha``) and ``batch_stats`` (BN ``mean``/``var``). The functions here map
them onto the reference torch layouts the port's modules use, as tensors,
without importing the JAX package: callers hand in nested dicts of numpy
arrays.

- :func:`speaker_embnet_state_dict` computes the same dict as
  ``deeplip_tpu.interop.torch_export.export_speaker_embnet_state_dict``;
- :func:`criterion_state_dict` the same dict as
  ``export_criterion_state_dict`` (LMCL/AAM/A-Softmax ``weights``;
  CrossEntropy ``fc.weight``/``fc.bias``);
- :func:`lipreading_state_dict` the same dict as
  ``export_lipreading_state_dict`` (ResNet trunk; multi- or single-branch
  TCN);
- :func:`lowfer_state_dict` the same dict as ``export_lowfer_state_dict``
  (``U``, ``V``), plus ``gate_proj`` where the head has one;
- :func:`linear_fusion_state_dict` the ``fc1``/``bn1``/``fc2`` layout of the
  port's ``LinearFusion``.
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


def _conv(out: dict, prefix: str, p: Mapping[str, Any]) -> None:
    # Flax Conv (*K, I, O) -> torch Conv{1,2,3}d (O, I, *K); Dense (I, O) ->
    # Linear (O, I) is the same move with no spatial axes
    k = np.asarray(p["kernel"])
    out[f"{prefix}.weight"] = _t(np.transpose(k, (k.ndim - 1, k.ndim - 2)
                                              + tuple(range(k.ndim - 2))))
    if "bias" in p:
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
        _conv(out, f"tdnn.{i}.context_layer", blk["conv"])
        _bn(out, f"tdnn.{i}.bn", blk["bn"], batch_stats[f"tdnn_{i}"]["bn"])
    for name in ("fc1", "fc2"):
        _conv(out, name, params[name])
    for name in ("bn1", "bn2"):
        _bn(out, name, params[name], batch_stats[name])
    return out


def criterion_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX criterion params -> the port's criterion state dict."""
    out: dict[str, torch.Tensor] = {}
    if "fc" in params:
        _conv(out, "fc", params["fc"])
    elif "weights" in params:
        out["weights"] = _t(params["weights"])
    else:
        raise ValueError(f"not a criterion param tree: keys {sorted(params)}")
    return out


def _alpha(out: dict, key: str, p: Mapping[str, Any], name: str) -> None:
    if name in p:
        out[key] = _t(p[name]["alpha"])


def _tcn(out: dict, params: Mapping[str, Any], stats: Mapping[str, Any]) -> None:
    """Multi-branch ``tcn.mb_ms_tcn.network.*`` or single-branch
    ``tcn.tcn_trunk.network.*``."""
    blocks = sorted((k for k in params if k.startswith("block")),
                    key=lambda k: int(k[len("block"):]))
    if not blocks:
        return
    multibranch = any(k.startswith("cbcr") for k in params[blocks[0]])
    net = "tcn.mb_ms_tcn.network" if multibranch else "tcn.tcn_trunk.network"
    for bname in blocks:
        bp, bs = params[bname], stats.get(bname, {})
        ref = f"{net}.{int(bname[len('block'):])}"
        if multibranch:
            for cname in sorted(k for k in bp if k.startswith("cbcr")):
                cp = bp[cname]
                _conv(out, f"{ref}.{cname}.conv", cp["conv"])
                _bn(out, f"{ref}.{cname}.batchnorm", cp["bn"], bs[cname]["bn"])
                _alpha(out, f"{ref}.{cname}.non_lin.weight", cp, "act")
            if "downsample" in bp:
                _conv(out, f"{ref}.downsample", bp["downsample"])
            _alpha(out, f"{ref}.relu_final.weight", bp, "relu_final")
        else:
            for i in (1, 2):
                cp = bp[f"conv{i}"]
                _conv(out, f"{ref}.conv{i}", cp["conv"])
                _bn(out, f"{ref}.batchnorm{i}", cp["bn"], bs[f"conv{i}"]["bn"])
                _alpha(out, f"{ref}.relu{i}.weight", cp, "act")
            if "downsample" in bp:
                _conv(out, f"{ref}.downsample", bp["downsample"])
            _alpha(out, f"{ref}.relu.weight", bp, "relu")


def lipreading_state_dict(params: Mapping[str, Any],
                          batch_stats: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``Lipreading`` params + batch_stats (ResNet trunk) -> the port's
    state dict: ``frontend3D.{0,1,2}``, ``trunk.layer{s}.{i}.*``,
    ``tcn.*`` and ``tcn.tcn_output``."""
    out: dict[str, torch.Tensor] = {}
    _conv(out, "frontend3D.0", params["frontend_conv"])
    _bn(out, "frontend3D.1", params["frontend_bn"], batch_stats["frontend_bn"])
    _alpha(out, "frontend3D.2.weight", params, "frontend_prelu")
    trunk_p = params.get("trunk", {})
    trunk_s = batch_stats.get("trunk", {})
    for name, bp in trunk_p.items():
        if name.startswith(("stage", "conv_last")):
            raise NotImplementedError("the ShuffleNetV2 trunk is not ported yet")
        if not name.startswith("layer"):
            raise ValueError(f"unsupported trunk entry {name!r}: expected "
                             "the ResNet layout (layer{s}_block{i})")
        stage, block = name.split("_block")
        ref = f"trunk.{stage}.{int(block)}"
        bs = trunk_s.get(name, {})
        for conv, bn in (("conv1", "bn1"), ("conv2", "bn2")):
            _conv(out, f"{ref}.{conv}", bp[conv])
            _bn(out, f"{ref}.{bn}", bp[bn], bs[bn])
        for relu in ("relu1", "relu2"):
            _alpha(out, f"{ref}.{relu}.weight", bp, relu)
        if "down_conv" in bp:
            _conv(out, f"{ref}.downsample.0", bp["down_conv"])
            _bn(out, f"{ref}.downsample.1", bp["down_bn"], bs["down_bn"])
    if "tcn" in params:
        _tcn(out, params["tcn"], batch_stats.get("tcn", {}))
    if "tcn_output" in params:
        _conv(out, "tcn.tcn_output", params["tcn_output"])
    return out


def lowfer_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``LowFER`` params -> the port's state dict: ``U`` and ``V`` as
    they are, and the ``gate_proj`` Dense of an unequal-dims head."""
    out = {"U": _t(params["U"]), "V": _t(params["V"])}
    if "gate_proj" in params:
        _conv(out, "gate_proj", params["gate_proj"])
    return out


def linear_fusion_state_dict(params: Mapping[str, Any],
                             batch_stats: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``LinearFusion`` params + batch_stats -> the port's state dict
    (``fc2`` exists under ``extract_feats`` too: it runs and is dropped)."""
    out: dict[str, torch.Tensor] = {}
    for name in ("fc1", "fc2"):
        _conv(out, name, params[name])
    _bn(out, "bn1", params["bn1"], batch_stats["bn1"])
    return out
