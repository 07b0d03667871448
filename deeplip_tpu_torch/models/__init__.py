"""The audio and video networks and the fusion heads.

Counterpart of ``deeplip_tpu/models/__init__.py``: the same public names
(``__all__``), each imported from its module at first use, so importing the
package imports, builds and starts nothing.
"""

from importlib import import_module

_EXPORTS = {
    "MeanStdPooling": "pooling",
    "AttentiveStatPooling": "pooling",
    "MonoHeadAttention": "pooling",
    "MultiHeadAttentivePooling": "pooling",
    "TDNNBlock": "tdnn",
    "SpeakerEmbNet": "tdnn",
    "ECAPATDNN": "ecapa",
    "ResNetTrunk": "resnet",
    "BasicBlock": "resnet",
    "TemporalConvNet": "tcn",
    "MultibranchTemporalConvNet": "tcn",
    "Lipreading": "lipreading",
    "LowFER": "fusion",
    "LinearFusion": "fusion",
    "CompactBilinearPooling": "fusion",
    "ShuffleNetV2Trunk": "shufflenetv2",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        return getattr(import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
