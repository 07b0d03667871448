"""Manifests, wav I/O, samplers and the train and test pipelines.

Counterpart of ``deeplip_tpu/data/__init__.py``: the same public names
(``__all__``), each imported from its module at first use, so importing the
package imports, builds and starts nothing.
"""

from importlib import import_module

_EXPORTS = {
    "SpeakerManifest": "manifest",
    "write_manifest": "manifest",
    "read_wav": "audio_io",
    "write_wav": "audio_io",
    "resample": "audio_io",
    "SpeakerBatchSampler": "sampler",
    "frame_buckets": "sampler",
    "AudioTrainPipeline": "audio_pipeline",
    "EvalUtteranceSet": "audio_pipeline",
    "ThreadedPrefetcher": "prefetch",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        return getattr(import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
