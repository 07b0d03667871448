"""Multi-process initialisation and the multi-node mesh.

Counterpart of ``deeplip_tpu/core/distributed.py``. The JAX package starts
one process per host (``jax.distributed.initialize``) and builds a ``(dcn,
data)`` mesh with the hosts on the outer axis. The port starts one process
per GPU, as ``torchrun --nproc_per_node N`` launches them:

- :func:`initialize` creates the default process group: NCCL when the
  device is ``cuda`` (and it sets the rank's card from ``LOCAL_RANK``),
  gloo on the CPU. With no arguments it reads the launcher's ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, and
  it is a no-op for one process started without a launcher;
- :func:`make_multihost_mesh` lays the processes out as ``(dcn, data)``:
  nodes on the outer axis, the GPUs of a node on the inner one;
- :func:`dp_spec` is this rank's rows of a batch over both axes.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from deeplip_tpu_torch.core.device import resolve_device
from deeplip_tpu_torch.core.mesh import (DATA_AXIS, DCN_AXIS, Mesh, RowSharding,
                                         data_sharding, make_mesh)

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE")


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None,
               device: str | torch.device | None = None) -> bool:
    """Create the default process group; returns whether one exists.

    ``coordinator_address`` is an init-method URL (``tcp://host:port``,
    ``file:///path``) or ``host:port``; without it the launcher's
    ``MASTER_ADDR:MASTER_PORT``. ``device=None`` means the card, as at every
    entry point (and raises where there is none); ``"cpu"`` takes gloo. A
    group that already exists is kept."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and num_processes is None and process_id is None:
        if not all(k in env for k in _LAUNCHER_ENV):
            return False          # one process, no launcher: nothing to join
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", dev.index or 0)))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return True


def make_multihost_mesh(data_axis: str = DATA_AXIS, dcn_axis: str = DCN_AXIS,
                        local_size: int | None = None) -> Mesh:
    """``(dcn, data)`` mesh: node index on the outer axis, that node's
    processes (one per GPU) on the inner. ``local_size`` is the processes a
    node runs (default: the launcher's ``LOCAL_WORLD_SIZE``, else all of
    them, one node). One process: a ``(1, 1)`` mesh."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = int(local_size or os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local:
        raise ValueError(f"{world} processes do not fill nodes of {local}")
    return make_mesh([(dcn_axis, world // local), (data_axis, local)])


def dp_spec(mesh: Mesh, ndim: int = 1) -> RowSharding:
    """This rank's rows of a batch over every data-parallel axis present
    (``dcn`` and ``data``)."""
    return data_sharding(mesh, ndim)
