"""Framing, spectral matrices, features and masked reductions.

Counterpart of ``deeplip_tpu/ops/__init__.py``: the same public names
(``__all__``), each imported from its module at first use, so importing the
package imports, builds and starts nothing.
"""

from importlib import import_module

_EXPORTS = {
    "preemphasis": "framing",
    "num_frames": "framing",
    "frame_signal": "framing",
    "pad_for_frames": "framing",
    "rdft_matrices": "spectral",
    "hann_window": "spectral",
    "mel_filterbank": "spectral",
    "dct_matrix": "spectral",
    "cepstral_lifter": "spectral",
    "FeatureConfig": "features",
    "feature_dim": "features",
    "extract_features": "features",
    "mfcc": "features",
    "fbank": "features",
    "logfbank": "features",
    "stft_features": "features",
    "cmvn": "features",
    "add_deltas": "features",
    "masked_mean": "masked",
    "masked_std": "masked",
    "masked_mean_std": "masked",
    "length_mask": "masked",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        return getattr(import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
