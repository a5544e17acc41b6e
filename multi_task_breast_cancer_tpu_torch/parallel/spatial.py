"""Spatial partitioning's collectives: the ``space`` axis of
:func:`.mesh.data_space_mesh`, written by hand where JAX lets GSPMD insert
them (``multi_task_breast_cancer_tpu/parallel/mesh.py:46-76``).

Under a ``space`` group of n ranks every image-shaped tensor holds only this
rank's rows (rank i of the group rows ``[i·H/n, (i+1)·H/n)``). The models
find the group through :func:`current`, set for a forward by
:func:`partitioned` (as ``blocks.global_batch`` sets the data mesh), and
apply the row rules:

- a 3×3 convolution takes one row from each neighbour first
  (:func:`halo_exchange`; zero rows at the top and bottom of the image);
- the fused norm's statistics are the sums of every rank's partial sums
  (:meth:`Space.sum_partials`, the split-statistics entry points of
  ``ops/hopper_kernels.py``);
- a global mean over H·W is the summed partial sums (:func:`plane_mean`);
- a flatten into a dense layer sees all the rows (:func:`whole_rows`).

Each collective is differentiable with its exact adjoint as its backward:
the halo's gradient goes back to the owner and is added to its edge rows;
a sum's gradient is the sum of the ranks' upstream gradients; a gather's is
this rank's rows of the summed gradient. A tensor computed alike on every
rank of the group (the loss, the logits) then gets the same gradient sum as
in one process once each rank weighs its loss by 1/n and the gradients are
summed over every rank.

Sums over the group are an all-gather added in rank order, so every rank
gets the same bits. A group whose batch is empty (a ``data`` shard with no
rows: every member has none) skips its collectives alike.

``counts`` counts halo exchanges (forward and backward apart) and the other
collectives of the group, for the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

counts = {"halo_exchanges": 0, "halo_exchanges_backward": 0, "collectives": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


@dataclasses.dataclass(frozen=True)
class Space:
    """This rank's ``space`` group: ``size`` ranks (global ``ranks``, in
    row order), this one ``index``, over the process ``group`` of backend
    ``backend``. Gloo moves host memory: CUDA tensors go through the host
    for its point-to-point sends."""

    size: int
    index: int
    ranks: Tuple[int, ...]
    group: Optional[dist.ProcessGroup] = None
    backend: str = "gloo"

    def rows(self, n_rows: int) -> slice:
        """This rank's rows of ``n_rows`` (which ``size`` divides)."""
        if n_rows % self.size:
            raise ValueError(f"{n_rows} rows do not split over {self.size} space ranks")
        per = n_rows // self.size
        return slice(self.index * per, (self.index + 1) * per)

    def gather(self, t: torch.Tensor) -> list:
        """Every rank's ``t`` (one shape on all), in rank order."""
        counts["collectives"] += 1
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return parts

    def sum_partials(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, added in rank order: the same bits
        on every rank. Not differentiable (:func:`sum_over_space` is)."""
        parts = self.gather(t)
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        return total

    def swap(self, to_prev: torch.Tensor, to_next: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Send ``to_prev`` to the rank above and ``to_next`` to the rank
        below; returns what they sent here (``from_prev``, ``from_next``),
        zeros where there is no neighbour."""
        from_prev, from_next = torch.zeros_like(to_prev), torch.zeros_like(to_next)
        host = to_prev.is_cuda and self.backend == "gloo"

        def wire(t: torch.Tensor) -> torch.Tensor:
            return t.cpu() if host else t.contiguous()

        ops, recvs = [], []
        for peer, send, recv in ((self.index - 1, to_prev, from_prev),
                                 (self.index + 1, to_next, from_next)):
            if 0 <= peer < self.size:
                buf = torch.empty_like(wire(recv))
                ops += [dist.P2POp(dist.isend, wire(send), self.ranks[peer], self.group),
                        dist.P2POp(dist.irecv, buf, self.ranks[peer], self.group)]
                recvs.append((recv, buf))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for recv, buf in recvs:
            recv.copy_(buf)
        return from_prev, from_next


_active: Optional[Space] = None


def current() -> Optional[Space]:
    """The ``space`` group of the forward running now, or ``None``."""
    return _active


@contextlib.contextmanager
def partitioned(space: Optional[Space]) -> Iterator[None]:
    """Inside the block the models' forwards see ``space`` (``None``:
    nothing changes)."""
    global _active
    outer, _active = _active, space
    try:
        yield
    finally:
        _active = outer


def refuse(what: str) -> None:
    """Raise ``NotImplementedError`` when called under a ``space`` group:
    ``what`` has no row rule in the port."""
    if _active is not None:
        raise NotImplementedError(
            f"{what} under spatial partitioning (training.spatial_partitions="
            f"{_active.size}) is not ported: ROADMAP.md, Queue 1")


class _Halo(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x: torch.Tensor, space: Space, k: int) -> torch.Tensor:
        ctx.space, ctx.k = space, k
        counts["halo_exchanges"] += 1
        above, below = space.swap(x[:, :, :k], x[:, :, -k:])
        return torch.cat([above, x, below], dim=2)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor):
        k = ctx.k
        counts["halo_exchanges_backward"] += 1
        from_prev, from_next = ctx.space.swap(g[:, :, :k], g[:, :, -k:])
        dx = g[:, :, k:-k].clone(memory_format=torch.contiguous_format)
        dx[:, :, :k] += from_prev
        dx[:, :, -k:] += from_next
        return dx, None, None


def halo_exchange(x: torch.Tensor, space: Space, k: int = 1) -> torch.Tensor:
    """NCHW ``x`` (this rank's rows) with ``k`` rows of each neighbour
    above and below: (N, C, h + 2k, W), zero rows at the image's top and
    bottom. Backward: each halo's gradient is added to its owner's rows."""
    if x.shape[0] == 0:  # no collective; the graph stays joined for the backward
        return F.pad(x, (0, 0, k, k))
    if x.shape[2] < k:
        raise ValueError(f"halo of {k} rows over a shard of {x.shape[2]}")
    return _Halo.apply(x, space, k)


class _SpaceSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t: torch.Tensor, space: Space) -> torch.Tensor:
        ctx.space = space
        return space.sum_partials(t)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor):
        return ctx.space.sum_partials(g), None


def sum_over_space(t: torch.Tensor, space: Space) -> torch.Tensor:
    """The sum of every rank's ``t`` (:meth:`Space.sum_partials`), whose
    backward sums the ranks' upstream gradients."""
    return _SpaceSum.apply(t, space)


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x: torch.Tensor, space: Space) -> torch.Tensor:
        ctx.space = space
        return torch.cat(space.gather(x), dim=2)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor):
        space = ctx.space
        return space.sum_partials(g)[:, :, space.rows(g.shape[2])].contiguous(), None


def gather_rows(x: torch.Tensor, space: Space) -> torch.Tensor:
    """Every rank's rows of NCHW ``x``, in order: the whole (N, C, H, W) on
    every rank. Backward: this rank's rows of the summed gradient."""
    if x.shape[0] == 0:
        return torch.cat([x] * space.size, dim=2)
    return _GatherRows.apply(x, space)


def whole_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` with all its rows: gathered under a ``space`` group, else as it
    is."""
    space = current()
    return x if space is None else gather_rows(x, space)


def plane_mean(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) → (N, C): the mean over each whole plane; under a
    ``space`` group the rows' sums (in f32) summed over the group."""
    space = current()
    if space is None:
        return x.mean(dim=(2, 3))
    sums = x.float().sum(dim=(2, 3))
    if x.shape[0]:
        sums = sum_over_space(sums, space)
    return (sums / (x.shape[2] * space.size * x.shape[3])).to(x.dtype)


def row_multiple(model, name: Optional[str] = None) -> int:
    """The multiple of ``n_space`` that an image's height must be for
    ``model`` (a module or its class) under spatial partitioning: 2^pools,
    so every level's rows split evenly (``space_row_multiple``). A model
    without one has no row rules in the port: ``NotImplementedError``."""
    multiple = getattr(model, "space_row_multiple", None)
    if multiple is None:
        what = name or getattr(model, "__name__", type(model).__name__)
        raise NotImplementedError(
            f"{what}: spatial partitioning (training.spatial_partitions > 1) is ported "
            "for the nnU-Net and BTS families only; the rest of the zoo is ROADMAP.md, "
            "Queue 1")
    return multiple
