"""Read reference DeepLip ``.pth`` checkpoints into the port's state dicts.

Counterpart of ``deeplip_tpu/interop/torch_import.py``. The port's modules
already use the reference's state-dict layouts, so an import is container
handling, not a layout change:

- only a leading ``module.`` (the DataParallel prefix) is stripped, never a
  submodule named ``module`` inside a key;
- ``fc3*`` keys (the reference's unused third layer) are dropped;
- floating tensors become float32, the port's parameter type;
- every BatchNorm (a ``.running_mean`` key) gets a ``num_batches_tracked``
  counter, 0 where the file has none, because ``TorchBatchNorm`` carries
  one and the port's loaders are strict;
- an audio file's mono-head attention pooling, which the reference stores
  with leading broadcast axes (``W (1, H, C)``, ``b (1, H, 1)``, ``v (1, 1,
  H)``, ``k (1, 1, 1)``), is read into the port's ``(H, C)``, ``(H, 1)``,
  ``(1, H)``, ``(1, 1)``; the attentive-statistics layout is the port's.

A ShuffleNetV2 Lipreading file needs nothing more: the port's trunk has the
reference's ``trunk.0.*`` / ``trunk.1.*`` names.

A file is read with ``weights_only=True`` first. A reference fusion
checkpoint also pickles its live criterion module, whose class lives in the
reference package; for such a ``.pth``, and only for a file the caller
names, :func:`read_checkpoint` falls back to an unpickler that rebuilds
torch's tensors and turns every other class into an inert stub, so the
criterion's parameters are still recovered (:func:`criterion_state_from_object`)
and no code of the file's choosing is imported.
"""

from __future__ import annotations

import pickle
import types
from typing import Any, Mapping

import numpy as np
import torch

# the tensor machinery a checkpoint pickle needs; everything else is stubbed
_SAFE_GLOBALS = {("collections", "OrderedDict"), ("copyreg", "_reconstructor"),
                 ("builtins", "object"), ("torch", "Size"), ("torch", "device")}
CLASSIFIER_PREFIX = "tcn.tcn_output."


def float_type(float_dtype) -> torch.dtype:
    """A torch float type from a torch or numpy one (``np.float64`` as the
    JAX converters take it)."""
    if isinstance(float_dtype, torch.dtype):
        return float_dtype
    return torch.from_numpy(np.zeros(0, np.dtype(float_dtype))).dtype


def clean_state_dict(state_dict: Mapping[str, Any],
                     float_dtype=torch.float32) -> dict[str, torch.Tensor]:
    """A reference state dict in the port's terms: ``module.`` stripped,
    ``fc3*`` dropped, floats as ``float_dtype`` (float32, the port's
    parameter type, unless asked), a ``num_batches_tracked`` for every
    BatchNorm. The tensors are copies."""
    dtype = float_type(float_dtype)
    out = {}
    for key, value in state_dict.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if key.startswith("fc3"):
            continue
        value = (value.detach().cpu() if torch.is_tensor(value)
                 else torch.from_numpy(np.array(value)))
        out[key] = value.to(dtype, copy=True) if value.is_floating_point() else value.clone()
    for key in [k for k in out if k.endswith(".running_mean")]:
        counter = key[:-len("running_mean")] + "num_batches_tracked"
        out.setdefault(counter, torch.tensor(0, dtype=torch.long))
    return out


class _Stub:
    """Stands in for a class the checkpoint names and the port does not
    import; keeps whatever state the pickle hands it."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        safe = ((module, name) in _SAFE_GLOBALS
                or (module == "torch._utils" and name.startswith("_rebuild_"))
                or (module == "torch" and (name.endswith("Storage")
                                           or isinstance(getattr(torch, name, None),
                                                         torch.dtype))))
        if safe:
            return super().find_class(module, name)
        return type(name, (_Stub,), {"__module__": module})


_TOLERANT = types.ModuleType("deeplip_tolerant_pickle")
_TOLERANT.Unpickler = _TolerantUnpickler
_TOLERANT.Pickler = pickle.Pickler
_TOLERANT.load = pickle.load


def read_checkpoint(path: str) -> Any:
    """``torch.load`` a checkpoint onto the CPU with ``weights_only=True``;
    a ``.pth`` that this refuses (a pickled module inside) is read again
    with the tolerant unpickler. Any other file that holds more than
    tensors raises."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        if not str(path).endswith(".pth"):
            raise
    return torch.load(path, map_location="cpu", weights_only=False, pickle_module=_TOLERANT)


def _state_dict_of(tree: Any) -> Mapping[str, Any]:
    return tree["state_dict"] if isinstance(tree, Mapping) and "state_dict" in tree else tree


def criterion_state_from_object(obj) -> dict[str, torch.Tensor]:
    """The parameters of a pickled criterion module, real or stubbed, by
    name (``weights``; ``fc.weight``, ``fc.bias``). Running statistics are
    left out, as the reference criteria have none worth keeping."""
    if isinstance(obj, torch.nn.Module):
        return dict(obj.state_dict())
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix=""):
        d = getattr(node, "__dict__", {})
        for k, v in (d.get("_parameters") or {}).items():
            if v is not None:
                out[prefix + k] = v
        for k, v in (d.get("_buffers") or {}).items():
            if v is not None and "running" not in k:
                out[prefix + k] = v
        for k, v in (d.get("_modules") or {}).items():
            if v is not None:
                walk(v, prefix + k + ".")

    walk(obj)
    return out


def pooling_from_reference(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``sd`` with a mono-head pooling's broadcast axes taken off (a 3-D
    ``pooling.b`` marks that layout); any other state dict as it is."""
    b = sd.get("pooling.b")
    if b is None or b.ndim != 3:
        return dict(sd)
    shapes = {"W": (b.shape[1], -1), "b": (-1, 1), "v": (1, -1), "k": (1, 1)}
    return {**sd, **{f"pooling.{n}": sd[f"pooling.{n}"].reshape(shape)
                     for n, shape in shapes.items()}}


def load_reference_audio_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """The E-TDNN state dict of a reference audio ``net_*.pth``
    (``{"epoch", "state_dict", ...}`` or a bare state dict), with an
    attentive pooling in the port's shapes."""
    return pooling_from_reference(clean_state_dict(_state_dict_of(read_checkpoint(path))))


def load_reference_video_checkpoint(path: str, initial: Mapping[str, torch.Tensor]
                                    ) -> dict[str, torch.Tensor]:
    """A reference Lipreading checkpoint merged over ``initial`` (the
    receiving network's own state dict), as the JAX package's
    ``load_torch_encoders`` merges it. Only the classifier
    (``tcn.tcn_output.*``) may be missing, or of another size; any other
    missing or unexpected key raises."""
    loaded = clean_state_dict(_state_dict_of(read_checkpoint(path)))
    unexpected = sorted(set(loaded) - set(initial))
    missing = sorted(k for k in set(initial) - set(loaded)
                     if not (k.startswith(CLASSIFIER_PREFIX)
                             or k.endswith(".num_batches_tracked")))
    if unexpected or missing:
        raise KeyError(f"{path}: not a Lipreading checkpoint of this network "
                       f"(unexpected keys {unexpected[:5]}, missing keys {missing[:5]})")
    return {**{k: v.detach().cpu() for k, v in initial.items()}, **loaded}


def load_reference_fusion_checkpoint(path: str, float_dtype=torch.float32
                                     ) -> tuple[dict, dict | None]:
    """``(head, criterion)`` of a reference fusion ``net_*.pth``: LowFER's
    ``U`` and ``V``, and the criterion's parameters from the file's
    ``criterion_state_dict`` (as the exporters write it) or from its
    pickled ``criterion`` module, or None where neither is there (or the
    module's weights are of no criterion the port knows). Floats come as
    ``float_dtype``."""
    tree = read_checkpoint(path)
    head = import_lowfer_state_dict(_state_dict_of(tree), float_dtype)
    if not isinstance(tree, Mapping):
        return head, None
    if tree.get("criterion_state_dict") is not None:
        return head, import_criterion_state_dict(tree["criterion_state_dict"], float_dtype)
    if tree.get("criterion") is not None:
        crit = criterion_state_from_object(tree["criterion"])
        return head, import_criterion_state_dict(crit, float_dtype) if crit else None
    return head, None


# ---------------------------------------------------------------------------
# per-module converters: a reference state dict -> the state dict the port's
# module loads with strict=True (the JAX converters' names and arguments)

_EMBNET_HEAD = ("fc1.", "fc2.", "bn1.", "bn2.", "pooling.")


def import_speaker_embnet_state_dict(state_dict: Mapping[str, Any], n_blocks: int | None = None,
                                     float_dtype=torch.float32) -> dict[str, torch.Tensor]:
    """A reference ``SpeakerEmbNet`` state dict for the port's
    ``SpeakerEmbNet``: its first ``n_blocks`` TDNN blocks (all where None),
    ``fc1``/``bn1``/``fc2``/``bn2`` and an attentive pooling in the port's
    shapes; other keys are left out, as the JAX converter leaves them."""
    sd = clean_state_dict(state_dict, float_dtype)

    def kept(key: str) -> bool:
        if key.startswith("tdnn."):
            return n_blocks is None or int(key.split(".")[1]) < n_blocks
        return key.startswith(_EMBNET_HEAD)

    return pooling_from_reference({k: v for k, v in sd.items() if kept(k)})


def import_lmcl_state_dict(state_dict: Mapping[str, Any],
                           float_dtype=torch.float32) -> dict[str, torch.Tensor]:
    """The LMCL criterion's ``weights``."""
    return {"weights": clean_state_dict(state_dict, float_dtype)["weights"]}


def import_lipreading_state_dict(state_dict: Mapping[str, Any], layers=(2, 2, 2, 2),
                                 float_dtype=torch.float32) -> dict[str, torch.Tensor]:
    """A reference ResNet ``Lipreading`` state dict, as far as the JAX
    converter reads it: the frontend, the trunk's first ``layers[s]``
    blocks of each stage and the TCN head (with the classifier where the
    file has it). Merge it over the receiving network's state dict
    (:func:`load_reference_video_checkpoint`) for the keys it lacks."""
    sd = clean_state_dict(state_dict, float_dtype)

    def kept(key: str) -> bool:
        if key.startswith("trunk.layer"):
            stage, block = key.split(".")[1:3]
            return int(block) < layers[int(stage[len("layer"):]) - 1]
        return key.startswith(("frontend3D.", "tcn."))

    return {k: v for k, v in sd.items() if kept(k)}


def shufflenet_last(prefix: str) -> str:
    """The reference's ``conv_last`` prefix beside the units' ``prefix``."""
    return prefix.rsplit(".", 2)[0] + ".1." if prefix.endswith("0.") else "conv_last."


def import_shufflenet_trunk_state_dict(sd_or_raw: Mapping[str, Any], prefix: str = "trunk.0.",
                                       float_dtype=torch.float32) -> dict[str, torch.Tensor]:
    """The reference ShuffleNetV2 trunk (units under ``prefix``, the last
    1x1 conv + BN under its ``conv_last``) as the state dict of the port's
    ``ShuffleNetV2Trunk`` (``0.*`` the units, ``1.*`` the last conv)."""
    sd = clean_state_dict(sd_or_raw, float_dtype)
    last = shufflenet_last(prefix)
    out = {}
    for key, value in sd.items():
        if key.startswith(prefix):
            out["0." + key[len(prefix):]] = value
        elif key.startswith(last):
            out["1." + key[len(last):]] = value
    return out


def import_lowfer_state_dict(state_dict: Mapping[str, Any],
                             float_dtype=torch.float32) -> dict[str, torch.Tensor]:
    """LowFER's ``U`` and ``V``."""
    sd = clean_state_dict(state_dict, float_dtype)
    missing = [k for k in ("U", "V") if k not in sd]
    if missing:
        raise KeyError(f"no LowFER {missing} in the state dict")
    return {"U": sd["U"], "V": sd["V"]}


def import_criterion_state_dict(state_dict: Mapping[str, Any], float_dtype=torch.float32
                                ) -> dict[str, torch.Tensor] | None:
    """A reference criterion's weights: CrossEntropy's ``fc.weight`` (and
    ``fc.bias``) or LMCL's ``weights``; None for any other state dict."""
    sd = clean_state_dict(state_dict, float_dtype)
    if "fc.weight" in sd:
        return {k: sd[k] for k in ("fc.weight", "fc.bias") if k in sd}
    if "weights" in sd:
        return {"weights": sd["weights"]}
    return None
