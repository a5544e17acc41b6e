"""Spatial partitioning's collectives: the ``space`` axis of
:func:`.mesh.data_space_mesh`, written by hand where JAX lets GSPMD insert
them (``multi_task_breast_cancer_tpu/parallel/mesh.py:46-76``).

Under a ``space`` group of n ranks every image-shaped tensor holds only this
rank's rows (rank i of the group rows ``[i·H/n, (i+1)·H/n)``). The models
find the group through :func:`current`, set for a forward by
:func:`partitioned` (as ``blocks.global_batch`` sets the data mesh), and
apply the row rules:

- a convolution whose kernel spans rows takes the rows its global padding
  reads from each neighbour first and pads the width only
  (:func:`halo_conv` over :func:`halo_exchange`; zero rows at the top and
  bottom of the image);
- the norms' statistics are the sums of every rank's partial sums
  (:meth:`Space.sum_partials`, the split-statistics entry points of
  ``ops/hopper_kernels.py``, :func:`sum_over_space`);
- a global mean over H·W is the summed partial sums (:func:`plane_mean`);
- a cyclic roll of the rows (Swin's shifted windows) moves rows between
  neighbours, the last rank's next being the first (:func:`cyclic_row_shift`);
- a layer that needs every row (a flatten into a dense layer, Adityan's
  pool over its classification map, a Swin stage whose window spans more
  rows than a rank holds, a criterion other than DICE) sees the gathered
  rows (:func:`whole_rows`, :func:`gather_rows`).

Each collective is differentiable with its exact adjoint as its backward:
the halo's gradient goes back to the owner and is added to its edge rows;
a shift's is the opposite shift; a sum's gradient is the sum of the ranks'
upstream gradients; a gather's is this rank's rows of the summed gradient.
A tensor computed alike on every rank of the group (the loss, the logits)
then gets the same gradient sum as in one process once each rank weighs its
loss by 1/n and the gradients are summed over every rank.

Sums over the group are an all-gather added in rank order, so every rank
gets the same bits. A group whose batch is empty (a ``data`` shard with no
rows: every member has none) skips its collectives alike.

``counts`` counts halo exchanges, cyclic shifts and row gathers (forward
and backward apart) and the other collectives of the group, for the tests
and ``chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

counts = {"halo_exchanges": 0, "halo_exchanges_backward": 0, "cyclic_shifts": 0,
          "cyclic_shifts_backward": 0, "row_gathers": 0, "collectives": 0}


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

    def swap(self, to_prev: Optional[torch.Tensor], to_next: Optional[torch.Tensor],
             cyclic: bool = False) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """Send ``to_prev`` to the rank above and ``to_next`` to the rank
        below; returns what they sent here (``from_prev``, ``from_next``),
        zeros where there is no neighbour. ``cyclic``: the first rank's
        neighbour above is the last, and the last's below is the first. A
        ``None`` (on every rank alike) sends nothing that way, and nothing
        comes back from the other side: its result is ``None``. The ops go
        in the order of their direction, so two ranks that are each other's
        neighbour both ways (two cyclic ranks) match them."""
        n, i = self.size, self.index

        def peer(j: int) -> Optional[int]:
            return j % n if cyclic else (j if 0 <= j < n else None)

        like = to_prev if to_prev is not None else to_next
        host = like.is_cuda and self.backend == "gloo"

        def wire(t: torch.Tensor) -> torch.Tensor:  # the backends send contiguous tensors
            return t.contiguous().cpu() if host else t.contiguous()

        ops, recvs, got = [], [], [None, None]
        # (what goes, to whom, from whom it comes, which result it fills)
        for tag, (send, to, frm, slot) in enumerate(((to_prev, peer(i - 1), peer(i + 1), 1),
                                                     (to_next, peer(i + 1), peer(i - 1), 0))):
            if send is None:
                continue
            got[slot] = torch.zeros_like(send)
            if to is not None:
                ops.append(dist.P2POp(dist.isend, wire(send), self.ranks[to], self.group,
                                      tag=tag))
            if frm is not None:
                buf = torch.empty_like(wire(send))
                ops.append(dist.P2POp(dist.irecv, buf, self.ranks[frm], self.group, tag=tag))
                recvs.append((got[slot], buf))
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()
        for recv, buf in recvs:
            recv.copy_(buf)
        return got[0], got[1]


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


def halo_conv(x: torch.Tensor, space: Space, weight: torch.Tensor,
              bias: Optional[torch.Tensor], rows: Tuple[int, int], stride: int = 1,
              cols: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """This rank's output rows of the whole image's 2-D convolution of NCHW
    ``x`` (this rank's rows) with ``weight`` at ``stride``, whose global
    padding is ``rows`` = (top, bottom) rows and ``cols`` = (left, right)
    columns. ``max(top, bottom)`` halo rows are exchanged; ``top`` of them
    are kept above and ``bottom`` below, and the convolution runs with row
    padding 0. Needs the shard's rows a multiple of ``stride`` and the
    global padding that gives ``H/stride`` output rows (the unsharded
    layer's): for a 3×3 kernel, (1, 1) at stride 1 or 2, or flax ``SAME``'s
    (0, 1) at stride 2 on an even side."""
    top, bottom = rows
    h, k = x.shape[2], weight.shape[2]
    if h % stride or (top + h + bottom - k) // stride + 1 != h // stride:
        raise ValueError(f"a {k}-row kernel at stride {stride} with row padding {rows} "
                         f"does not give {h} // {stride} rows of a {h}-row shard")
    halo = max(top, bottom)
    if halo:
        x = halo_exchange(x, space, halo)
        x = x[:, :, halo - top:x.shape[2] - (halo - bottom)]
    if cols != (0, 0):
        x = F.pad(x, (cols[0], cols[1], 0, 0))
    return F.conv2d(x, weight, bias, stride=stride)


def _roll_rows(x: torch.Tensor, space: Space, shift: int, dim: int) -> torch.Tensor:
    """``torch.roll(·, shift, dim)`` of the whole image, on this rank's rows:
    ``|shift|`` rows come from the next rank (a roll up) or the previous
    one (a roll down), cyclically."""
    k, h = abs(shift), x.shape[dim]
    if k > h:
        raise ValueError(f"a cyclic shift of {k} rows over a shard of {h}")
    if shift < 0:
        _, from_next = space.swap(x.narrow(dim, 0, k), None, cyclic=True)
        return torch.cat([x.narrow(dim, k, h - k), from_next], dim=dim)
    from_prev, _ = space.swap(None, x.narrow(dim, h - k, k), cyclic=True)
    return torch.cat([from_prev, x.narrow(dim, 0, h - k)], dim=dim)


class _CyclicShift(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x: torch.Tensor, space: Space, shift: int, dim: int) -> torch.Tensor:
        ctx.space, ctx.shift, ctx.dim = space, shift, dim
        counts["cyclic_shifts"] += 1
        return _roll_rows(x, space, shift, dim)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor):
        counts["cyclic_shifts_backward"] += 1
        return _roll_rows(g, ctx.space, -ctx.shift, ctx.dim), None, None, None


def cyclic_row_shift(x: torch.Tensor, space: Space, shift: int, dim: int = 2) -> torch.Tensor:
    """``torch.roll(x, shift, dim)`` of the whole image (rows on ``dim``),
    on this rank's rows: for a roll of −s each rank sends its first s rows
    to rank (i − 1) mod n and appends the s rows that rank (i + 1) mod n
    sends. Backward: the opposite shift."""
    if x.shape[0] == 0:
        return x.clone()
    return _CyclicShift.apply(x, space, shift, dim)


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
    def forward(ctx, x: torch.Tensor, space: Space, dim: int) -> torch.Tensor:
        ctx.space, ctx.dim = space, dim
        counts["row_gathers"] += 1
        return torch.cat(space.gather(x), dim=dim)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor):
        space, dim = ctx.space, ctx.dim
        mine = space.rows(g.shape[dim])
        return (space.sum_partials(g).narrow(dim, mine.start, mine.stop - mine.start)
                .contiguous(), None, None)


def gather_rows(x: torch.Tensor, space: Space, dim: int = 2) -> torch.Tensor:
    """Every rank's rows of ``x`` (rows on ``dim``: NCHW by default), in
    order: the whole image on every rank. Backward: this rank's rows of the
    summed gradient."""
    if x.shape[0] == 0:
        return torch.cat([x] * space.size, dim=dim)
    return _GatherRows.apply(x, space, dim)


def whole_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` with all its rows: gathered under a ``space`` group, else as it
    is."""
    space = current()
    return x if space is None else gather_rows(x, space)


def plane_mean(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) → (N, C): the mean over each whole plane; under a
    ``space`` group the rows' sums (in f32 at least) summed over the group."""
    space = current()
    if space is None:
        return x.mean(dim=(2, 3))
    sums = x.to(torch.promote_types(x.dtype, torch.float32)).sum(dim=(2, 3))
    if x.shape[0]:
        sums = sum_over_space(sums, space)
    return (sums / (x.shape[2] * space.size * x.shape[3])).to(x.dtype)


def row_multiple(model, name: Optional[str] = None) -> int:
    """The multiple of ``n_space`` that an image's height must be for
    ``model`` (a module or its class) under spatial partitioning: 2^halvings,
    so every level's rows split evenly (``space_row_multiple``). Every
    architecture of the registry has one; a model class without one is a
    model whose row rules were never written: ``NotImplementedError``."""
    multiple = getattr(model, "space_row_multiple", None)
    if multiple is None:
        what = name or getattr(model, "__name__", type(model).__name__)
        raise NotImplementedError(
            f"{what} has no space_row_multiple: spatial partitioning "
            "(training.spatial_partitions > 1) needs the multiple of n_space its image "
            "height must be, and every layer of it with a row rule")
    return multiple
