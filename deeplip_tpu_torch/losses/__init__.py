"""Speaker-classification criteria and online triplet losses.

Counterpart of ``deeplip_tpu/losses/__init__.py``: the same public names
(``__all__``), each imported from its module at first use, so importing the
package imports, builds and starts nothing.
"""

from importlib import import_module

_EXPORTS = {
    "CrossEntropyHead": "softmax",
    "LMCL": "softmax",
    "AAMSoftmax": "softmax",
    "ASoftmax": "softmax",
    "build_criterion": "softmax",
    "OnlineTripletLoss": "triplet",
    "batch_all_triplet_loss": "triplet",
    "batch_hard_triplet_loss": "triplet",
    "semihard_triplet_loss": "triplet",
    "contrastive_loss": "triplet",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        return getattr(import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
