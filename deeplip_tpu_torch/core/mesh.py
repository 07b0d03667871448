"""The process mesh and the row rule of data-parallel training.

Counterpart of ``deeplip_tpu/core/mesh.py``. The JAX package shards a batch
over the ``data`` axis of a ``jax.sharding.Mesh`` and lets XLA insert the
gradient all-reduce and the synchronised BN reductions under ``jit``. The
port runs one process per GPU and does those collectives itself
(``torch.distributed``: NCCL on the card, gloo on the CPU). A :class:`Mesh`
lays the processes out over named axes, as the JAX mesh lays out devices:
rank ``r`` sits at the row-major coordinates of ``r`` in the axis sizes
(``np.arange(world).reshape(sizes)``, the JAX ``make_mesh`` order).

The rules every trainer follows under a mesh:

- every rank sees the same global batch; rank ``r`` of the batch axes
  (``dcn`` × ``data``) takes rows ``[r·B/N, (r+1)·B/N)``
  (:func:`data_sharding`, the JAX ``data_sharding`` of the leading axis);
- a rank's loss is its rows' sum over the global count, so one sum of the
  gradients over the ranks (:meth:`Mesh.reduce_gradients`) is the
  global-mean gradient;
- BN statistics are global: the trainer runs its step inside
  :meth:`Mesh.batch_stats`, and ``models.norm.TorchBatchNorm`` and the fused
  K3/K4 (``ops.cuda.bn_prelu``) all-reduce their sums over the batch group;
- the classifier's rows may be split over ``model``
  (:func:`param_sharding`), Megatron style.

``force_host_devices`` has no meaning here: the JAX package emulates
devices inside one process, the port's tests start gloo processes instead.
Creating a mesh creates process groups, so every rank must build the same
meshes in the same order; importing this module starts nothing.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field
from typing import Iterable, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"
BATCH_AXES = (DCN_AXIS, DATA_AXIS)

_BATCH_GROUP: contextvars.ContextVar = contextvars.ContextVar("batch_group", default=None)


def batch_group():
    """The process group the BN statistics of the running step reduce
    over, or None outside :meth:`Mesh.batch_stats`."""
    return _BATCH_GROUP.get()


def group_size(group) -> int:
    """The processes of ``group``; 1 for None (no process group)."""
    return 1 if group is None else dist.get_world_size(group)


def global_rows(x: torch.Tensor, group=None) -> int:
    """The rows of the global batch that a channels-last ``x`` is this
    rank's part of. The row rule: every rank of ``group`` brings as many
    rows as this one."""
    return x.numel() // x.shape[-1] * group_size(group)


def rank_share(group) -> float:
    """This rank's rows' share of the global batch under the row rule."""
    return 1.0 / group_size(group)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over ``group``; as it is for None."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


@dataclass(frozen=True)
class RowSharding:
    """Rows ``[index·n/count, (index+1)·n/count)`` of an ``n``-row axis
    (``axis`` 0 for a batch, 1 for a ``(K, B, ...)`` stack of K batches)."""

    index: int = 0
    count: int = 1
    axis: int = 0

    def rows(self, n: int) -> slice:
        if n % self.count:
            raise ValueError(f"{n} rows do not split over {self.count} ranks; pad the batch "
                             "to a multiple first (pad_to_multiple)")
        per = n // self.count
        return slice(self.index * per, (self.index + 1) * per)

    def __call__(self, x):
        """This rank's rows of ``x`` (a tensor or a numpy array), a view."""
        index = (slice(None),) * self.axis + (self.rows(x.shape[self.axis]),)
        return x[index]


@dataclass
class Mesh:
    """Processes laid out over named axes. ``groups`` holds, for each axis
    name and for the batch axes together, the group of the ranks that share
    this rank's other coordinates (None without a process group)."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    rank: int = 0
    groups: dict = field(default_factory=dict)

    @property
    def coords(self) -> dict[str, int]:
        return dict(zip(self.axis_names, np.unravel_index(self.rank, self.shape)))

    def axis_size(self, name: str | Sequence[str]) -> int:
        names = (name,) if isinstance(name, str) else tuple(name)
        sizes = dict(zip(self.axis_names, self.shape))
        return int(np.prod([sizes.get(n, 1) for n in names]))

    def axis_index(self, name: str | Sequence[str]) -> int:
        """This rank's index along ``name`` (row-major over several axes)."""
        names = [n for n in ((name,) if isinstance(name, str) else name) if n in self.axis_names]
        coords, sizes = self.coords, dict(zip(self.axis_names, self.shape))
        index = 0
        for n in names:
            index = index * sizes[n] + int(coords[n])
        return index

    # the batch (data-parallel) axes and the model axis -----------------
    @property
    def data_size(self) -> int:
        return self.axis_size(BATCH_AXES)

    @property
    def data_index(self) -> int:
        return self.axis_index(BATCH_AXES)

    @property
    def model_size(self) -> int:
        return self.axis_size(MODEL_AXIS)

    @property
    def model_index(self) -> int:
        return self.axis_index(MODEL_AXIS)

    @property
    def data_group(self):
        return self.groups.get(BATCH_AXES)

    @property
    def model_group(self):
        return self.groups.get(MODEL_AXIS)

    @property
    def world_group(self):
        return self.groups.get("world")

    @property
    def is_main(self) -> bool:
        """Rank 0, which writes the checkpoints, the logs and the events."""
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of an ``n``-row global batch."""
        return data_sharding(self).rows(n)

    # collectives ------------------------------------------------------
    @contextlib.contextmanager
    def batch_stats(self):
        """BN statistics inside the block reduce over the batch group."""
        token = _BATCH_GROUP.set(self.data_group)
        try:
            yield
        finally:
            _BATCH_GROUP.reset(token)

    def local_share(self, t: torch.Tensor) -> torch.Tensor:
        """A mean over this rank's rows weighted by their share of the
        global batch (``1 / data_size``: every rank has as many rows), so
        that the ranks' values sum to the global mean; ``t`` itself without
        a process group."""
        return t if self.world_group is None else t * rank_share(self.data_group)

    def report(self, **metrics: torch.Tensor) -> dict[str, torch.Tensor]:
        """The ranks' 0-d metrics summed over every rank in one all-reduce
        (in float64), each back in its own type; as given without a group."""
        if self.world_group is None:
            return metrics
        flat = torch.stack([t.detach().to(torch.float64) for t in metrics.values()])
        dist.all_reduce(flat, group=self.world_group)
        return {n: flat[i].to(t.dtype) for i, (n, t) in enumerate(metrics.items())}

    def reduce_gradients(self, replicated: Iterable[torch.Tensor],
                         sharded: Iterable[torch.Tensor] = ()) -> None:
        """Sum the gradients over the ranks, once: the replicated
        parameters' over every rank, the ``model``-sharded ones' over the
        batch group. One flat buffer per group and type."""
        for params, group in ((replicated, self.world_group), (sharded, self.data_group)):
            grads = [p.grad for p in params if p.grad is not None]
            if group is None or not grads:
                continue
            for dtype in dict.fromkeys(g.dtype for g in grads):
                same = [g for g in grads if g.dtype == dtype]
                flat = torch.cat([g.reshape(-1) for g in same])
                dist.all_reduce(flat, group=group)
                offset = 0
                for g in same:
                    g.copy_(flat[offset:offset + g.numel()].view_as(g))
                    offset += g.numel()

    def broadcast(self, tensors: Iterable[torch.Tensor], group=None) -> None:
        """Overwrite ``tensors`` with the first rank's of ``group``
        (default: every rank), in place."""
        group = self.world_group if group is None else group
        if group is None:
            return
        src = dist.get_global_rank(group, 0)
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, src=src, group=group)

    def barrier(self) -> None:
        if self.world_group is not None:
            dist.barrier(group=self.world_group)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``x``, in rank order along the batch
        axes (rows not equal across ranks are not allowed). Its backward
        returns this rank's slice of the gradient, unsummed: every rank
        computes the same loss of the whole batch, and the one gradient
        sum counts each row once."""
        if self.data_group is None:
            return x
        return _GatherRows.apply(x, self.data_group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.index, ctx.rows = dist.get_rank(group), x.shape[0]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.index * ctx.rows:(ctx.index + 1) * ctx.rows], None


def local_mesh() -> Mesh:
    """The mesh of this process alone, with no process group: a trainer
    given no mesh runs no collective, as before meshes existed."""
    return Mesh((DATA_AXIS,), (1,))


def _axis_groups(shape: tuple[int, ...], axes: Sequence[int], backend) -> dict:
    """For every fixing of the coordinates outside ``axes``, the group of
    ranks that vary along ``axes``; returns ``{rank: group}`` for the
    groups this rank is in. Every rank creates every group, in one order."""
    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    others = [a for a in range(len(shape)) if a not in axes]
    grid = np.transpose(ranks, others + list(axes)).reshape(-1, int(np.prod(
        [shape[a] for a in axes])))
    world = dist.get_world_size()
    mine = {}
    for members in grid:
        members = [int(r) for r in members]
        group = (dist.group.WORLD if len(members) == world
                 else dist.new_group(members, backend=backend))
        for r in members:
            mine[r] = group
    return mine


def make_mesh(axes: Sequence[tuple[str, int]] | None = None) -> Mesh:
    """A mesh over the processes of the default group, or of this process
    alone where there is none (its groups then None: no collective runs).

    ``axes`` is a list of ``(name, size)`` pairs; a size of ``-1`` means
    "all remaining processes". Default: a 1-D ``data`` mesh over every
    process."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    axes = [(DATA_AXIS, world)] if axes is None else list(axes)
    names = tuple(a[0] for a in axes)
    sizes = [int(a[1]) for a in axes]
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1])) or 1
        sizes[sizes.index(-1)] = world // known
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {int(np.prod(sizes))} "
                         f"processes, have {world}")
    mesh = Mesh(names, tuple(sizes), rank)
    if not initialized:
        return mesh
    backend = dist.get_backend()
    shape = tuple(sizes)
    mesh.groups["world"] = dist.group.WORLD
    batch = [i for i, n in enumerate(names) if n in BATCH_AXES]
    layouts = [(BATCH_AXES, batch)] + [(n, [i]) for i, n in enumerate(names)]
    made: dict = {}
    for key, dims in layouts:
        if dims:
            if tuple(dims) not in made:
                made[tuple(dims)] = _axis_groups(shape, dims, backend)[rank]
            mesh.groups[key] = made[tuple(dims)]
    return mesh


def data_sharding(mesh: Mesh, ndim: int = 1, axis: str = DATA_AXIS) -> RowSharding:
    """This rank's rows of a batch: the leading axis split over the batch
    axes (``dcn`` and ``data`` together, as the JAX rule shards over both),
    or over ``axis`` alone when it is another. ``ndim`` is the JAX
    signature's and is not needed to slice."""
    if axis == DATA_AXIS:
        return RowSharding(mesh.data_index, mesh.data_size)
    return RowSharding(mesh.axis_index(axis), mesh.axis_size(axis))


def stacked_data_sharding(mesh: Mesh, ndim: int = 2) -> RowSharding:
    """Rows of a ``(K, B, ...)`` stack of K batches: dim 1 is the batch."""
    return RowSharding(mesh.data_index, mesh.data_size, axis=1)


def replicated_sharding(mesh: Mesh):
    """The replicated placement: a function that overwrites a tensor with
    rank 0's, in place, and returns it."""
    def put(t: torch.Tensor) -> torch.Tensor:
        mesh.broadcast([t])
        return t
    return put


def replicate(mesh: Mesh, tree) -> None:
    """Overwrite every tensor of ``tree`` (a module's parameters and
    buffers, a mapping or a sequence of tensors) with rank 0's, in place."""
    if isinstance(tree, torch.nn.Module):
        tensors = [*tree.parameters(), *tree.buffers()]
    elif isinstance(tree, Mapping):
        tensors = list(tree.values())
    else:
        tensors = list(tree)
    mesh.broadcast([t.data if isinstance(t, torch.nn.Parameter) else t for t in tensors])


def param_sharding(mesh: Mesh, tree: Mapping[str, torch.Tensor]) -> dict:
    """``{name: RowSharding or None}`` for a train state's named tensors: the
    classifier under ``criterion`` sharded by rows over ``model``, the rest
    replicated (None). As the JAX rule, a 2-D criterion leaf whose rows
    divide by ``model`` is sharded; here its 1-D siblings of that length
    (a linear head's bias) go with it, since each rank computes the logits
    of its own rows. On a mesh without ``model`` every entry is None."""
    model = mesh.model_size
    rows = {t.shape[0] for n, t in tree.items()
            if "criterion" in n.split(".") and t.ndim == 2}
    out = {}
    for name, t in tree.items():
        shard = (model > 1 and "criterion" in name.split(".") and t.ndim in (1, 2)
                 and t.shape[0] in rows and t.shape[0] % model == 0)
        out[name] = RowSharding(mesh.model_index, model) if shard else None
    return out


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n``."""
    return ((n + m - 1) // m) * m
