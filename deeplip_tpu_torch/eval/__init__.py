"""EER, cosine scoring, fusion scoring and PLDA.

Counterpart of ``deeplip_tpu/eval/__init__.py``: the same public names
(``__all__``), each imported from its module at first use, so importing the
package imports, builds and starts nothing.
"""

from importlib import import_module

_EXPORTS = {
    "eer_from_scores": "eer",
    "eer_sweep": "eer",
    "TrialList": "scoring",
    "EmbeddingStore": "scoring",
    "cosine_scores": "scoring",
    "cosine_eer": "scoring",
    "score_fusion_eer": "scoring",
    "feature_fusion_eer": "scoring",
    "feature_normalize": "scoring",
    "PLDA": "plda",
    "plda_eer": "plda",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        return getattr(import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
