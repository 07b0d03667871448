"""Kaldi tables and reference DeepLip checkpoints.

Counterpart of ``deeplip_tpu/interop/__init__.py``: the same public names
(``__all__``), each imported from its module at first use, so importing the
package imports, builds and starts nothing.

The JAX ``import_speaker_embnet_state_dict`` turns a reference state dict
into Flax parameters; the port's modules take the reference layout itself,
so the port's converter of that name cleans the container (the DataParallel
prefix and ``fc3*`` taken off, as ``clean_state_dict`` does) and keeps the
keys the JAX converter reads.
"""

from importlib import import_module

_EXPORTS = {
    "read_ark_entry": "kaldi",
    "read_scp": "kaldi",
    "write_ark_scp": "kaldi",
    "KaldiHelper": "kaldi",
    "clean_state_dict": "torch_import",
    "import_speaker_embnet_state_dict": "torch_import",
    "load_reference_audio_checkpoint": "torch_import",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        return getattr(import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
