"""The affine InstanceNorm of SwinUNETR's UNETR blocks, with its epilogue
(an optional residual add, then an optional LeakyReLU), as one hand-written
CUDA kernel forward and two backward, beside its plain PyTorch twin.

The function (:func:`instance_norm_affine_reference`): per (n, c) plane of
NCHW ``x``, :class:`~..models.blocks.InstanceNorm`'s arithmetic (statistics
in f32, f64 staying f64; the centred two-pass variance; eps 1e-5; the
normalised value cast back to ``x``'s dtype), then ``· scale + bias``, then
``+ residual`` where one is given, then ``F.leaky_relu(·, slope)`` where a
slope is given. SwinUNETR runs it at 26 sites a forward
(``models/swin_unetr.py::UnetrBasicBlock``: ``norm1`` with the activation,
``norm2`` with the residual and the activation, ``norm_skip`` with
neither); in plain torch each site is about forty kernels a training step.

Dispatch is by what the input shows and nothing else, as
:mod:`.layer_norm`'s: a tensor off the card, an f64 tensor, or a call while
``torch.compile`` or ``torch.export`` traces takes the plain twin, so an
exported program keeps its plain nodes; a CUDA tensor in f32 or bf16
launches the kernel or raises. There is no fallback from a failed launch.
Calls that need a gradient go through a ``torch.autograd.Function``. Under
a ``space`` group the block keeps the module's split statistics and calls
none of this.

Launches, each counted where it launches (:mod:`.launches`): the forward
(:func:`instance_norm_affine`, one a site, which also saves each plane's
mean and rstd), the backward's plane kernel (dx, the residual's gradient
and each plane's sums; :func:`instance_norm_affine_backward`) and the
parameter gradients from those sums
(:func:`instance_norm_affine_param_grad`): 26, 26 and 26 a SwinUNETR
training step, 26 forwards a validation batch. The CUDA source is
``csrc/instance_norm_affine.cu``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from multi_task_breast_cancer_tpu_torch.ops import _build
from multi_task_breast_cancer_tpu_torch.ops.flax_norm import stats_dtype
from multi_task_breast_cancer_tpu_torch.ops.launches import counted

_SOURCE = "instance_norm_affine"


def instance_norm_affine_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                                   eps: float = 1e-5, residual: Optional[torch.Tensor] = None,
                                   slope: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch twin of the forward kernel: ``InstanceNorm(affine=True)``
    (``models/blocks.py``, outside a ``space`` group) on NCHW ``x``, then
    ``+ residual``, then ``F.leaky_relu(·, slope)``, each where given;
    autograd's gradient through it."""
    xf = x.to(stats_dtype(x))
    centered = xf - xf.mean(dim=(2, 3), keepdim=True)
    var = (centered * centered).mean(dim=(2, 3), keepdim=True)
    y = (centered * torch.rsqrt(var + eps)).to(x.dtype)
    y = y * scale[:, None, None] + bias[:, None, None]
    if residual is not None:
        y = y + residual
    return y if slope is None else F.leaky_relu(y, slope)


def instance_norm_affine_statistics_reference(x: torch.Tensor,
                                              eps: float = 1e-5) -> torch.Tensor:
    """Plain twin of what the forward kernel saves: per (n, c) plane the mean
    and rsqrt(var + eps), shape (N, C, 2) in :func:`~.flax_norm.stats_dtype`."""
    xf = x.to(stats_dtype(x))
    mean = xf.mean(dim=(2, 3))
    centered = xf - mean[..., None, None]
    rstd = torch.rsqrt((centered * centered).mean(dim=(2, 3)) + eps)
    return torch.stack([mean, rstd], dim=-1)


def instance_norm_affine_backward_reference(
        x: torch.Tensor, y: Optional[torch.Tensor], dy: torch.Tensor, scale: torch.Tensor,
        stats: torch.Tensor, slope: Optional[float] = None,
        residual: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor,
                                         torch.Tensor]:
    """Plain twin of the backward kernels, (dx, dresidual, dscale, dbias):
    ``dpre = dy`` where ``y > 0`` or there is no activation, else ``dy·slope``
    (in ``x``'s dtype, as autograd of the twin rounds it); ``g = dpre·scale``
    (in ``x``'s dtype); with ``xhat = (x − mean)·rstd`` from the saved
    ``stats``, ``dx = rstd·(g − mean(g) − xhat·mean(g·xhat))`` over each
    plane; ``dresidual = dpre`` (None without a residual); ``dscale = Σ
    dpre·T(xhat)`` (each product in ``x``'s dtype) and ``dbias = Σ dpre`` over
    the batch and the plane. In the statistics' dtype, each result cast to
    its input's dtype."""
    dt = stats.dtype
    mean, rstd = stats[..., 0, None, None], stats[..., 1, None, None]
    xhat = (x.to(dt) - mean) * rstd
    dpre = dy if slope is None else torch.where(y > 0, dy, dy * slope)
    g = (dpre * scale[:, None, None]).to(dt)
    m1 = g.mean(dim=(2, 3), keepdim=True)
    m2 = (g * xhat).mean(dim=(2, 3), keepdim=True)
    dx = (rstd * (g - m1 - xhat * m2)).to(x.dtype)
    dscale = (dpre * xhat.to(x.dtype)).to(dt).sum(dim=(0, 2, 3))
    dbias = dpre.to(dt).sum(dim=(0, 2, 3))
    return (dx, dpre if residual else None, dscale.to(scale.dtype), dbias.to(scale.dtype))


def _plain(x: torch.Tensor) -> bool:
    """Whether a call on ``x`` takes the plain twin: off the card, f64, or
    inside a trace."""
    return (x.device.type != "cuda" or x.dtype == torch.float64
            or torch.compiler.is_compiling() or torch.compiler.is_exporting())


# ---------------------------------------------------------------------------
# launch plans
# ---------------------------------------------------------------------------


class InstanceNormPlan(NamedTuple):
    """How a launch covers its planes (see ``csrc/instance_norm_affine.cu``)."""

    variant: str    # "group": a group of lanes a plane; "cluster": k blocks a plane
    cluster: int    # blocks a plane (cluster variant; 1 for the group variant)
    threads: int    # threads per block
    vectors: int    # 16-byte vectors a thread holds (1, 2 or 4; at most 2 in a group)
    group: int      # lanes a plane (group variant; 1 for the cluster variant)
    blocks: int     # the grid


_VARIANT_CODES = {"group": 0, "cluster": 1}
_MAX_THREADS = 256
_MIN_THREADS = 64
_GROUP_MAX_HW = 256          # planes up to 16²: a group of lanes each
_CLUSTER_VECTORS = 4         # a cluster thread's vectors, fewer where blocks would shrink
_MAX_CLUSTER = 8             # the portable cluster size


def _pow2_at_least(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _plan(planes: int, hw: int, dtype: torch.dtype,
          sms: int = _build.H100_SMS) -> InstanceNormPlan:
    """The launch plan for ``planes`` planes of ``hw`` elements of ``dtype``.

    Planes load in 16-byte vectors (4 f32 or 8 bf16). A plane of at most
    256 elements (SwinUNETR's 16² to 4² sites) goes to the smallest
    power-of-two group of at most 32 lanes that gives each lane one vector,
    or two at 16² in f32; blocks of 256 threads, fewer (down to 64) where the
    grid would not reach two blocks per SM (``sms``). A larger plane goes to
    a cluster of k blocks: k doubles, up to 8, while one block of 256
    threads at 4 vectors each cannot hold its share, then while the planes
    give fewer than two blocks per SM; a thread holds 4 vectors where that
    leaves its block 64 threads or more, else 2 or 1. A plane that 8 blocks
    cannot hold is walked in tiles. Raises ``ValueError`` for planes that
    are not whole vectors."""
    width = 16 // dtype.itemsize
    if hw % width:
        raise ValueError(f"instance_norm_affine: planes of {hw} {dtype} elements are not "
                         f"whole 16-byte vectors ({width} elements)")
    nvec = hw // width
    if hw <= _GROUP_MAX_HW:
        group = min(32, _pow2_at_least(nvec))
        vectors = -(-nvec // group)
        threads = _MAX_THREADS
        while threads > _MIN_THREADS and -(-planes * group // threads) < 2 * sms:
            threads //= 2
        return InstanceNormPlan("group", 1, threads, vectors, group,
                                -(-planes * group // threads))
    per_block = _MAX_THREADS * _CLUSTER_VECTORS
    k = 1
    while k < _MAX_CLUSTER and nvec > k * per_block:
        k *= 2
    while k < _MAX_CLUSTER and planes * k < 2 * sms:
        k *= 2
    vectors = _CLUSTER_VECTORS
    while vectors > 1 and -(-nvec // (k * vectors)) < _MIN_THREADS:
        vectors //= 2
    threads = min(_MAX_THREADS, _round_up(-(-nvec // (k * vectors)), 32))
    return InstanceNormPlan("cluster", k, threads, vectors, 1, planes * k)


def plan_for(x: torch.Tensor, *others: Optional[torch.Tensor]) -> InstanceNormPlan:
    """The plan a launch over NCHW-contiguous CUDA ``x`` takes, SMs read
    from its card; raises ``ValueError`` where ``x`` or one of the launch's
    other planes (``None`` skipped) does not start on a 16-byte boundary."""
    if any(t is not None and t.data_ptr() % 16 for t in (x, *others)):
        raise ValueError("instance_norm_affine: every plane tensor of a launch must start "
                         "on a 16-byte boundary")
    n, c, h, w = x.shape
    return _plan(n * c, h * w, x.dtype, _build.sm_count(x.device.index or 0))


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------


def _check_cuda(what: str, x: torch.Tensor, params: Tuple[torch.Tensor, ...],
                *planes: Optional[torch.Tensor]) -> None:
    if x.dtype not in _build.DTYPE_SUFFIXES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported on the card (float32, "
                        "bfloat16; float64 takes the plain twin)")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what}: expected an NCHW-contiguous tensor, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    for t in planes:
        if t is not None and (t.shape != x.shape or t.dtype != x.dtype or t.device != x.device
                              or not t.is_contiguous()):
            raise ValueError(f"{what}: {tuple(t.shape)} {t.dtype} {t.device} does not match "
                             f"the input {tuple(x.shape)} {x.dtype} {x.device}, or is not "
                             "NCHW-contiguous")
    for p in params:
        if (p.dtype != x.dtype or p.device != x.device or p.shape != x.shape[1:2]
                or not p.is_contiguous()):
            raise ValueError(f"{what}: per-channel parameter {tuple(p.shape)} {p.dtype} "
                             f"{p.device} does not match {x.shape[1]} channels of {x.dtype} "
                             f"on {x.device}")


def _sample_stride(t: torch.Tensor) -> Optional[int]:
    """The elements between ``t``'s samples where each sample's (C, H, W) is
    contiguous and the samples lie a whole number of 16-byte vectors apart,
    without overlap (a contiguous tensor, or a channel slice of one); else
    None."""
    if not t[0].is_contiguous():
        return None
    stride = t.stride(0) if t.shape[0] > 1 else t[0].numel()
    width = 16 // t.element_size()
    return stride if stride % width == 0 and stride >= t[0].numel() else None


def _launch_plan(plan: InstanceNormPlan) -> tuple:
    return (_VARIANT_CODES[plan.variant], plan.cluster, plan.threads, plan.vectors, plan.group)


def _forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
             residual: Optional[torch.Tensor],
             slope: Optional[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, stats) on ``x``'s device: the plain twins by :func:`_plain`, else
    one launch of the forward kernel (``x`` and ``residual`` NCHW-contiguous)
    under :func:`plan_for`'s plan."""
    if _plain(x):
        return (instance_norm_affine_reference(x, scale, bias, eps, residual, slope),
                instance_norm_affine_statistics_reference(x, eps))
    _check_cuda("instance_norm_affine", x, (scale, bias), residual)
    y = torch.empty_like(x)
    n, c, h, w = x.shape
    stats = torch.empty((n, c, 2), dtype=torch.float32, device=x.device)
    if x.numel():
        plan = plan_for(x, residual, y)
        _build.launch(_SOURCE, "instance_norm_affine_forward", x.device, x, scale, bias,
                      residual, y, stats, n * c, c, h * w, float(eps),
                      float(slope or 0.0), int(slope is not None), _build.STREAM,
                      *_launch_plan(plan), dtype=x.dtype, counter=instance_norm_affine,
                      plan=plan)
    return y, stats


@counted
def instance_norm_affine_param_grad(partials: torch.Tensor, channels: int,
                                    dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dscale, dbias) in ``dtype`` from the plane kernel's sums ``(2, N·C)``
    f32 on the card, each channel's N planes added in order; counted in
    ``instance_norm_affine_param_grad.launches``."""
    batch = partials.shape[1] // channels
    dscale = partials.new_empty(channels, dtype=dtype)
    dbias = partials.new_empty(channels, dtype=dtype)
    _build.launch(_SOURCE, "instance_norm_affine_param_grad", partials.device, partials,
                  dscale, dbias, batch, channels, _build.STREAM, dtype=dtype,
                  counter=instance_norm_affine_param_grad)
    return dscale, dbias


@counted
def instance_norm_affine_backward(
        x: torch.Tensor, y: Optional[torch.Tensor], dy: torch.Tensor, scale: torch.Tensor,
        stats: torch.Tensor, slope: Optional[float] = None, residual: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """(dx, dresidual, dscale, dbias) of :func:`instance_norm_affine` from its
    input ``x``, its output ``y`` (read only with an activation, ``slope``
    not None), the output's gradient ``dy``, ``scale`` and the saved
    ``stats``; ``dresidual`` only where ``residual``, else None.

    By :func:`_plain`, :func:`instance_norm_affine_backward_reference`. On
    the card, one launch of the plane kernel (counted in
    ``instance_norm_affine_backward.launches``) under :func:`plan_for`'s
    plan, then :func:`instance_norm_affine_param_grad`. ``dy``
    may arrive with any strides: the kernel reads a channel slice of a
    larger NCHW-contiguous tensor as it is (what ``torch.cat``'s backward
    hands a block whose output was concatenated), and any other layout is
    copied once."""
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"instance_norm_affine_backward: gradient {tuple(dy.shape)} "
                         f"{dy.dtype} {dy.device} does not match input {tuple(x.shape)} "
                         f"{x.dtype} {x.device}")
    if _plain(x):
        return instance_norm_affine_backward_reference(x, y, dy, scale, stats, slope, residual)
    y = y if slope is not None else None
    _check_cuda("instance_norm_affine_backward", x, (scale,), y)
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if residual else None
    n, c, h, w = x.shape
    if not x.numel():
        return dx, dres, torch.zeros_like(scale), torch.zeros_like(scale)
    dy_stride = _sample_stride(dy)
    if dy_stride is None:
        dy = dy.contiguous()
        dy_stride = c * h * w
    plan = plan_for(x, y, dy, dx, dres)
    partials = torch.empty((2, n * c), dtype=torch.float32, device=x.device)
    _build.launch(_SOURCE, "instance_norm_affine_backward", x.device, x, y, dy, scale, stats,
                  dx, dres, partials, n * c, c, h * w, dy_stride, float(slope or 0.0),
                  int(slope is not None), _build.STREAM, *_launch_plan(plan), dtype=x.dtype,
                  counter=instance_norm_affine_backward, plan=plan)
    return (dx, dres, *instance_norm_affine_param_grad(partials, c, x.dtype))


class _InstanceNormAffine(torch.autograd.Function):
    """The forward kernel, saving ``x``, ``scale``, each plane's (mean, rstd)
    and, with an activation, the output; the backward kernels on them."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                residual: Optional[torch.Tensor], eps: float,
                slope: Optional[float]) -> torch.Tensor:
        x = x.contiguous()
        if residual is not None:
            residual = residual.contiguous()
        y, stats = _forward(x, scale, bias, eps, residual, slope)
        ctx.save_for_backward(x, None if slope is None else y, scale, stats)
        ctx.slope, ctx.residual = slope, residual is not None
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy: torch.Tensor):
        x, y, scale, stats = ctx.saved_tensors
        dx, dres, dscale, dbias = instance_norm_affine_backward(
            x, y, dy, scale, stats, ctx.slope, ctx.residual and ctx.needs_input_grad[3])
        return dx, dscale, dbias, dres, None, None


@counted
def instance_norm_affine(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         eps: float = 1e-5, residual: Optional[torch.Tensor] = None,
                         slope: Optional[float] = None) -> torch.Tensor:
    """Affine InstanceNorm of NCHW ``x`` with per-channel ``scale`` and
    ``bias``, then ``+ residual`` (same shape) and ``F.leaky_relu(·,
    slope)``, each where given.

    Off the card, in f64 or inside a trace:
    :func:`instance_norm_affine_reference`. A CUDA tensor in f32 or bf16
    (parameters and residual of its dtype): the forward kernel, counted in
    ``instance_norm_affine.launches``, through a ``torch.autograd.Function``
    when a gradient is needed. A non-contiguous ``x`` or residual is copied
    once."""
    if _plain(x):
        return instance_norm_affine_reference(x, scale, bias, eps, residual, slope)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, scale, bias, residual)):
        return _InstanceNormAffine.apply(x, scale, bias, residual, eps, slope)
    return _forward(x.contiguous(), scale, bias, eps,
                    None if residual is None else residual.contiguous(), slope)[0]
