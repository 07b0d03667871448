"""Configuration tree: attribute access over nested YAML/JSON dicts.

Counterpart of ``deeplip_tpu/core/config.py``. YAML files are read by the
port's own reader of the subset the shipped configs use
(:mod:`deeplip_tpu_torch.core.yaml_subset`), on every host: it gives what
``yaml.safe_load`` gives, and needs no pyyaml.
"""

from __future__ import annotations

import copy
import json
from collections import OrderedDict
from typing import Any, Mapping

from deeplip_tpu_torch.core.yaml_subset import load_yaml


class Config(dict):
    """A dict with attribute access, recursive wrapping, and flattening.

    >>> c = Config({"model": {"arch": "etdnn"}})
    >>> c.model.arch
    'etdnn'
    """

    def __init__(self, data: Mapping[str, Any] | None = None, **kw: Any):
        super().__init__()
        merged = dict(data or {})
        merged.update(kw)
        for k, v in merged.items():
            self[k] = v

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, Mapping):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return type(value)(Config._wrap(v) for v in value)
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, Config._wrap(value))

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def flatten(self) -> "OrderedDict[str, Any]":
        """Flatten one level of selected-subsection indirection: scalar
        entries are kept; if the value of some entry names a sibling key
        (``feat_type: mfcc`` next to an ``mfcc:`` sub-dict), that sub-dict's
        entries are hoisted to the top level."""
        out: "OrderedDict[str, Any]" = OrderedDict()
        values = list(self.values())
        for key, val in self.items():
            if key in values and isinstance(self.get(key), Mapping):
                for k, v in self[key].items():
                    out[k] = v
            if not isinstance(val, Mapping):
                out[key] = val
        return out

    def to_dict(self) -> dict:
        def unwrap(v: Any) -> Any:
            if isinstance(v, Mapping):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [unwrap(x) for x in v]
            return v

        return unwrap(self)

    def merged(self, other: Mapping[str, Any]) -> "Config":
        """Deep merge ``other`` over ``self`` and return a new Config."""
        out = copy.deepcopy(self)

        def rec(dst: Config, src: Mapping[str, Any]) -> None:
            for k, v in src.items():
                if isinstance(v, Mapping) and isinstance(dst.get(k), Mapping):
                    rec(dst[k], v)
                else:
                    dst[k] = v

        rec(out, other)
        return out


def load_config(path: str) -> Config:
    """Load a JSON (.json) config file, or any other as YAML of the subset
    :func:`deeplip_tpu_torch.core.yaml_subset.load_yaml` reads."""
    if path.endswith(".json"):
        with open(path, "r") as f:
            return Config(json.load(f))
    return Config(load_yaml(path))


def load_audio_config(path: str) -> Config:
    """Load the audio config: nested ``{data, model, train, test}``.

    Missing sections, and empty ones (a bare ``test:`` header reads as
    None), become empty Configs.
    """
    cfg = load_config(path)
    _ensure_sections(cfg)
    return cfg


def _ensure_sections(cfg: Config) -> None:
    for section in ("data", "model", "train", "test"):
        if cfg.get(section) is None:
            cfg[section] = Config()


def load_fusion_config(path: str) -> Config:
    """Load the fusion config: nested ``{data, model, train, test}`` with the
    audio and video sub-configs under ``model`` (``conf/fusion_config.yaml``)."""
    cfg = load_config(path)
    _ensure_sections(cfg)
    return cfg


# The flagship configuration: the E-TDNN x-vector system and its MFCC-24
# front-end (the JAX package's ``__graft_entry__`` defaults).
ETDNN_MODEL_OPTS = {
    "arch": "etdnn",
    "etdnn": {
        "input_dim": 24,
        "hidden_dim": [512, 512, 512, 512, 512, 512, 512, 512, 512, 1500],
        "context": [[-2, -1, 0, 1, 2], [0], [-2, 0, 2], [0], [-3, 0, 3], [0],
                    [-4, 0, 4], [0], [0], [0]],
        "tdnn_layers": 10,
        "embedding_dim": 512,
        "pooling": "statistic",
        "attention_hidden_size": 64,
        "bn_first": True,
    },
}

AUDIO_DATA_OPTS = {
    "rate": 16000,
    "feat_type": "mfcc",
    "mfcc": {
        "n_fft": 512,
        "num_bin": 26,
        "num_cep": 24,
        "energy": True,
        "normalize": True,
        "delta": False,
        "win_len": 0.025,
        "win_shift": 0.01,
    },
}
