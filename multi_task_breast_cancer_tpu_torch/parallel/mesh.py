"""The device mesh over ``torch.distributed`` (twin of
``multi_task_breast_cancer_tpu/parallel/mesh.py``).

JAX builds a ``Mesh(('data',))`` or ``Mesh(('data', 'space'))`` over every
visible chip and lets GSPMD shard each batch and insert the collectives.
Here one process runs per device (a rank of the default process group,
:mod:`.multihost`) and the collectives are written out:

- a batch of ``B`` global rows is split into contiguous shards,
  ``ceil(B / n)`` rows each, the last ones shorter or empty (``DataMesh.shard``;
  XLA pads uneven shards the same way, so batch 2 runs on 8 devices);
- every rank computes its shard's forward and backward; its loss is its
  share of the global batch's loss, so the summed gradients
  (:meth:`DataMesh.all_reduce_sum`, one flat all-reduce per step) equal the
  gradient of the global batch for any split;
- parameters, buffers and optimizer state are replicated: rank 0's are
  broadcast once (:func:`replicate_to_mesh`) and every rank then takes
  identical steps.

A rank whose shard is empty still joins every collective.

:func:`data_space_mesh` with ``n_space > 1`` gives a :class:`DataMesh` with
a ``space`` group: the W ranks in JAX's row-major ``(W/n data × n space)``
grid, rank r at data index ``r // n`` and space index ``r % n``. The batch
shards over ``data``; each rank of a ``space`` group holds ``1/n`` of the
rows of every image (:mod:`.spatial`), and the gradient sum runs over every
rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from multi_task_breast_cancer_tpu_torch.device import resolve_device
from multi_task_breast_cancer_tpu_torch.parallel import multihost
from multi_task_breast_cancer_tpu_torch.parallel.spatial import Space


def device_count() -> int:
    """Devices the mesh can span: the ranks of the process group, or the
    visible GPUs of this one process when none is initialised."""
    if multihost.active():
        return multihost.process_count()
    return torch.cuda.device_count()


def shard_slice(n_global: int, world_size: int, rank: int) -> slice:
    """Rank ``rank``'s contiguous rows of a global batch of ``n_global``:
    ``ceil(n_global / world_size)`` per rank, the last shards shorter or
    empty."""
    per = -(-n_global // world_size)
    start = min(rank * per, n_global)
    return slice(start, min(start + per, n_global))


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The mesh as this rank sees it: ``world_size`` ranks, this one
    ``rank``, computing on ``device``, over the process ``group`` (``None``:
    the default group). A ``(data × space)`` mesh also holds this rank's
    ``space`` group and its ``data_axis``: the ranks of its space index, a
    1-D mesh of their own with this rank at its data index."""

    world_size: int
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    space: Optional[Space] = None
    data_axis: Optional["DataMesh"] = None

    @property
    def data(self) -> "DataMesh":
        """The ``data`` axis: ``data_axis``, or the mesh itself without a
        ``space`` group."""
        return self if self.data_axis is None else self.data_axis

    @property
    def shape(self) -> Tuple[int, int]:
        """The ranks along (``data``, ``space``)."""
        return self.data.world_size, 1 if self.space is None else self.space.size

    def shard(self, n_global: int) -> slice:
        """This rank's rows of a global batch of ``n_global``, its shard on
        the ``data`` axis (:func:`shard_slice`)."""
        return shard_slice(n_global, self.data.world_size, self.data.rank)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place; returns ``t``."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_reduce_sum_differentiable(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks as a new tensor whose backward
        sums the upstream gradients over the ranks (the sum is replicated,
        so each rank's ``t`` reaches every rank's loss)."""
        return _AllReduceSum.apply(t, self)

    def all_gather_rows(self, t: torch.Tensor, n_global: int) -> torch.Tensor:
        """Every ``data`` shard of a ``n_global``-row batch (this rank's is
        ``t``, ``len(self.shard(n_global))`` rows), concatenated in global
        row order on every rank."""
        data = self.data
        per = -(-n_global // data.world_size)
        padded = t.new_zeros((per,) + tuple(t.shape[1:]))
        padded[:t.shape[0]] = t
        parts = [torch.empty_like(padded) for _ in range(data.world_size)]
        dist.all_gather(parts, padded, group=data.group)
        shards = (shard_slice(n_global, data.world_size, r) for r in range(data.world_size))
        return torch.cat([p[:sl.stop - sl.start] for p, sl in zip(parts, shards)], dim=0)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` overwritten in place with rank ``src``'s; returns ``t``."""
        dist.broadcast(t, src=src, group=self.group)
        return t


class _AllReduceSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
        ctx.mesh = mesh
        return mesh.all_reduce_sum(t.clone())

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor):
        return ctx.mesh.all_reduce_sum(g.clone(memory_format=torch.contiguous_format)), None


def data_mesh(n_devices: Optional[int] = None,
              device: Optional[Union[str, torch.device]] = None) -> Optional[DataMesh]:
    """The 1-D data mesh over every rank of the default process group, this
    rank computing on ``device`` (default :func:`~..device.resolve_device`:
    ``cuda:{LOCAL_RANK}``). ``None`` when one rank runs, as JAX returns
    ``None`` for one device. ``n_devices`` must be the world size (or at
    most 1): a mesh over some of the ranks would leave the others out of
    its collectives."""
    world = multihost.process_count()
    n = world if n_devices is None else n_devices
    if n <= 1 or world <= 1:
        return None
    if n != world:
        raise ValueError(f"data_mesh({n_devices}): the mesh spans every rank of the "
                         f"process group ({world}); start {n} ranks instead")
    return DataMesh(world, multihost.process_index(), resolve_device(device))


def data_space_mesh(n_space: int = 1, n_devices: Optional[int] = None,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Optional[DataMesh]:
    """``n_space == 1``: :func:`data_mesh`. Else the 2-D ``(data ×
    space)`` mesh over every rank, JAX's row-major grid: rank r is data
    index ``r // n_space`` and space index ``r % n_space``. The ``data`` and
    ``space`` process groups are made on every rank in one order (all
    ``data`` groups, then all ``space`` groups), as ``new_group`` needs.
    ``n_space`` must divide the world size (``ValueError``, as in JAX)."""
    if n_space <= 1:
        return data_mesh(n_devices, device)
    world = multihost.process_count()
    n = world if n_devices is None else n_devices
    if world % n_space or n % n_space:
        raise ValueError(f"spatial_partitions={n_space} must divide the device count "
                         f"({n})")
    if n != world:
        raise ValueError(f"data_space_mesh: the mesh spans every rank of the process "
                         f"group ({world}), not {n}")
    rank, n_data = multihost.process_index(), world // n_space
    data_groups = [dist.new_group([d * n_space + s for d in range(n_data)])
                   for s in range(n_space)]
    space_ranks = [tuple(d * n_space + s for s in range(n_space)) for d in range(n_data)]
    space_groups = [dist.new_group(list(r)) for r in space_ranks]
    d, s = divmod(rank, n_space)
    dev = resolve_device(device)
    return DataMesh(world, rank, dev,
                    space=Space(n_space, s, space_ranks[d], space_groups[d],
                                dist.get_backend(space_groups[d])),
                    data_axis=DataMesh(n_data, d, dev, data_groups[s]))


def _module_tensors(module: torch.nn.Module) -> list:
    return [t.data for t in module.parameters()] + list(module.buffers())


def _optimizer_tensors(opt: torch.optim.Optimizer) -> list:
    return [v for group in opt.param_groups for p in group["params"]
            for _, v in sorted(opt.state.get(p, {}).items())
            if torch.is_tensor(v)]


def replicate_to_mesh(mesh: Optional[DataMesh], obj):
    """Rank 0's parameters, buffers and optimizer state on every rank, in
    place: ``obj`` is an ``nn.Module`` or a train state (``.model``,
    ``.optimizer``). Every rank must hold the same structure (the same
    model, an optimizer at the same step). Returns ``obj``; a ``None`` mesh
    leaves it as it is."""
    if mesh is None:
        return obj
    if isinstance(obj, torch.nn.Module):
        tensors = _module_tensors(obj)
    else:
        tensors = _module_tensors(obj.model)
        if obj.optimizer is not None:
            tensors += _optimizer_tensors(obj.optimizer)
    with torch.no_grad():
        for t in tensors:
            if t.device == mesh.device:
                mesh.broadcast(t)
            else:  # Adam's step count lives on the host; NCCL takes device tensors
                t.copy_(mesh.broadcast(t.to(mesh.device)))
    return obj
