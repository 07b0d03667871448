"""Configuration, and the process mesh of data-parallel training (``core.mesh``,
``core.distributed``).

Counterpart of ``deeplip_tpu/core/__init__.py``: the same public names
(``__all__``), each imported from its module at first use, so importing the
package imports, builds and starts nothing.

``force_host_devices`` has no counterpart: the port's tests start gloo
processes where the JAX tests emulate devices.
"""

from importlib import import_module

_EXPORTS = {
    "Config": "config",
    "load_config": "config",
    "load_audio_config": "config",
    "load_video_config": "config",
    "load_fusion_config": "config",
    "make_mesh": "mesh",
    "data_sharding": "mesh",
    "replicated_sharding": "mesh",
    "Mesh": "mesh",
    "DATA_AXIS": "mesh",
    "MODEL_AXIS": "mesh",
    "DCN_AXIS": "mesh",
    "param_sharding": "mesh",
    "stacked_data_sharding": "mesh",
    "replicate": "mesh",
    "pad_to_multiple": "mesh",
    "initialize": "distributed",
    "make_multihost_mesh": "distributed",
    "dp_spec": "distributed",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        return getattr(import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
