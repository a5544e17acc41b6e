"""flax's LayerNorm over the last axis as one hand-written CUDA kernel each
way, beside its plain PyTorch twin.

The norm (eps 1e-6 in :class:`~..models.blocks.LayerNorm`): statistics in
f32 (f64 stays f64), flax's fast variance ``E[x²] − E[x]²`` clamped at 0,
``y = (x − mean)·(rsqrt(var + eps)·scale) + bias`` in f32, cast back to
``x``'s dtype. SwinUNETR runs it at 20 sites a forward (two in each of its 8
``SwinBlock``s, one in each of its 4 ``PatchMerging``s); in plain torch each
site is about forty launch-floor kernels a training step.

Dispatch is by what the input shows and nothing else: a tensor off the card,
an f64 tensor, or a call while ``torch.compile`` or ``torch.export`` traces
takes the plain twin (:func:`layer_norm_reference`); a CUDA tensor in f32 or
bf16 launches the kernel or raises. There is no fallback from a failed
launch. Under ``torch.export`` the call is the custom operator
``mtbc_torch::layer_norm`` (CPU implementation the plain twin, CUDA the
kernel, a fake implementation for tracing, the backward kernels as its
autograd formula), which an exported program keeps as one node. Eager and
graphed calls that need a gradient go through a ``torch.autograd.Function``.

Launches, each counted where it launches (:mod:`.launches`): the forward
(:func:`layer_norm`, one a site, which also saves each row's mean and
signed rstd), the backward's input gradient with per-block column sums
(:func:`layer_norm_backward`) and the parameter gradients from those sums
(:func:`layer_norm_param_grad`): 20, 20 and 20 a SwinUNETR training step,
20 forwards a validation batch. The CUDA source is ``csrc/layer_norm.cu``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from multi_task_breast_cancer_tpu_torch.ops import _build
from multi_task_breast_cancer_tpu_torch.ops.flax_norm import (
    f32_normalize,
    fast_moments,
    fast_stats,
    stats_dtype,
)
from multi_task_breast_cancer_tpu_torch.ops.launches import counted

_SOURCE = "layer_norm"


def layer_norm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch twin of the forward kernel: flax's LayerNorm over the
    last axis of ``x``, autograd's gradient through it."""
    mean, var = fast_stats(x.to(stats_dtype(x)), (-1,))
    return f32_normalize(x, mean, var, scale, bias, eps, channels_last=True)


def layer_norm_statistics_reference(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain twin of what the forward kernel saves: per row of ``x`` the
    mean and rsqrt(var + eps), the latter negated where the clamp was
    active (E[x²] − E[x]² < 0), from :func:`~.flax_norm.fast_moments`;
    shape ``x.shape[:-1] + (2,)`` in :func:`~.flax_norm.stats_dtype`."""
    mean, raw = fast_moments(x.to(stats_dtype(x)), (-1,))
    rstd = torch.rsqrt(raw.clamp(min=0.0) + eps)
    return torch.cat([mean, torch.where(raw < 0, -rstd, rstd)], dim=-1)


def layer_norm_backward_reference(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                                  stats: torch.Tensor) -> tuple:
    """Plain twin of the backward kernels: with ``g = dy·scale`` and ``xhat
    = (x − mean)·rstd`` from the saved ``stats``, ``dx = rstd·(g − mean(g)
    − xhat·mean(g·xhat))``, the last term dropped on rows where the clamp
    was active; ``dscale = Σ dy·xhat`` and ``dbias = Σ dy`` over the rows.
    In the statistics' dtype, each result cast to its input's dtype."""
    dt = stats.dtype
    mean, signed = stats[..., :1], stats[..., 1:]
    rstd = signed.abs()
    xhat = (x.to(dt) - mean) * rstd
    dyf = dy.to(dt)
    g = dyf * scale.to(dt)
    m1 = g.mean(dim=-1, keepdim=True)
    m2 = torch.where(signed > 0, (g * xhat).mean(dim=-1, keepdim=True), 0.0)
    dx = rstd * (g - m1 - xhat * m2)
    c = x.shape[-1]
    dscale = (dyf * xhat).reshape(-1, c).sum(dim=0)
    dbias = dyf.reshape(-1, c).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype)


def _plain(x: torch.Tensor) -> bool:
    """Whether a call on ``x`` takes the plain twin: off the card, f64, or
    inside a trace."""
    return (x.device.type != "cuda" or x.dtype == torch.float64
            or torch.compiler.is_compiling())


# ---------------------------------------------------------------------------
# launch plans
# ---------------------------------------------------------------------------


class LayerNormPlan(NamedTuple):
    """How a launch covers its rows (see ``csrc/layer_norm.cu``)."""

    group: int      # lanes per row (a power of two, at most 32)
    vectors: int    # 16-byte chunks per lane (1, 2, 4 or 8), held in registers
    threads: int    # threads per block
    blocks: int     # the forward's grid: one group per row
    parts: int      # the backward's grid: its column partials per channel


_MAX_THREADS = 256
_MIN_THREADS = 64
_MAX_VECTORS = 8
_MAX_SHARED = 48 * 1024      # the backward's column buffer per block
_PARTS_PER_SM = 8            # the backward's blocks at most; more rows loop


def _pow2_at_least(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _plan(rows: int, c: int, dtype: torch.dtype,
          sms: int = _build.H100_SMS) -> LayerNormPlan:
    """The launch plan for ``rows`` rows of ``c`` elements of ``dtype``.

    Rows load in 16-byte chunks (4 f32 or 8 bf16). A row goes to the
    smallest power-of-two group of at most 32 lanes that gives each lane
    one chunk, and to 32 lanes holding up to 8 chunks each beyond that
    (SwinUNETR in f32: 8 lanes at C = 24, 16 at 48, 32 from 96 on, with 2,
    4 and 8 chunks at 192, 384 and 768). Blocks of 256 threads, fewer (down
    to 64) where the grid would not reach two blocks per SM (``sms``) or
    the backward's column buffer (groups × C floats) would pass 48 KB. The
    backward takes at most 8 blocks per SM, each looping over its share of
    the rows. Raises ``ValueError`` for rows that are not whole chunks or
    are wider than 32 lanes × 8 chunks."""
    width = 16 // dtype.itemsize
    if c % width:
        raise ValueError(f"layer_norm: rows of {c} {dtype} elements are not whole 16-byte "
                         f"chunks ({width} elements)")
    chunks = c // width
    group = min(32, _pow2_at_least(chunks))
    vectors = _pow2_at_least(-(-chunks // group))
    if vectors > _MAX_VECTORS:
        raise ValueError(f"layer_norm: rows of {c} {dtype} elements are wider than the "
                         f"kernel holds in registers ({32 * _MAX_VECTORS * width})")
    threads = _MAX_THREADS
    while threads > _MIN_THREADS and (-(-rows * group // threads) < 2 * sms
                                      or threads // group * c * 4 > _MAX_SHARED):
        threads //= 2
    blocks = -(-rows * group // threads)
    return LayerNormPlan(group, vectors, threads, blocks, min(blocks, _PARTS_PER_SM * sms))


def plan_for(x: torch.Tensor, *others: torch.Tensor) -> LayerNormPlan:
    """The plan a launch over contiguous CUDA ``x`` takes, SMs read from its
    card; raises ``ValueError`` where ``x`` or one of the launch's
    ``others`` does not start on a 16-byte boundary."""
    if any(t.data_ptr() % 16 for t in (x, *others)):
        raise ValueError("layer_norm: every tensor of a launch must start on a 16-byte "
                         "boundary")
    return _plan(x.numel() // x.shape[-1], x.shape[-1], x.dtype,
                 _build.sm_count(x.device.index or 0))


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------


def _check_cuda(what: str, x: torch.Tensor, *params: torch.Tensor) -> None:
    if x.dtype not in _build.DTYPE_SUFFIXES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported on the card (float32, "
                        "bfloat16; float64 takes the plain twin)")
    if x.dim() == 0 or not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor of rows, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    for p in params:
        if (p.dtype != x.dtype or p.device != x.device or p.shape != x.shape[-1:]
                or not p.is_contiguous()):
            raise ValueError(f"{what}: per-channel parameter {tuple(p.shape)} {p.dtype} "
                             f"{p.device} does not match rows of {x.shape[-1]} {x.dtype} "
                             f"on {x.device}")


def _forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, stats) on ``x``'s device: the plain twins by :func:`_plain`,
    else one launch of the forward kernel (``x`` contiguous)."""
    if _plain(x):
        return (layer_norm_reference(x, scale, bias, eps),
                layer_norm_statistics_reference(x, eps))
    _check_cuda("layer_norm", x, scale, bias)
    y = torch.empty_like(x)
    stats = torch.empty(x.shape[:-1] + (2,), dtype=torch.float32, device=x.device)
    if x.numel():
        plan = plan_for(x, scale, bias, y)
        _build.launch(_SOURCE, "layer_norm_forward", x.device, x, scale, bias, y, stats,
                      x.numel() // x.shape[-1], x.shape[-1], float(eps), _build.STREAM,
                      plan.group, plan.vectors, plan.threads, plan.blocks, dtype=x.dtype,
                      counter=layer_norm, plan=plan)
    return y, stats


@counted
def layer_norm_param_grad(partials: torch.Tensor,
                          dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dscale, dbias) in ``dtype`` from the backward's column partials
    ``(2, C, parts)`` f32 on the card, the parts added in order; counted
    in ``layer_norm_param_grad.launches``."""
    _, c, parts = partials.shape
    dscale = partials.new_empty(c, dtype=dtype)
    dbias = partials.new_empty(c, dtype=dtype)
    _build.launch(_SOURCE, "layer_norm_param_grad", partials.device, partials, dscale, dbias,
                  parts, c, _build.STREAM, dtype=dtype, counter=layer_norm_param_grad)
    return dscale, dbias


@counted
def layer_norm_backward(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                        stats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dscale, dbias) of :func:`layer_norm` from its input ``x``, the
    output's gradient ``dy``, ``scale`` and the saved ``stats``.

    By :func:`_plain`, :func:`layer_norm_backward_reference`. On the card,
    one launch for dx and the column partials (counted in
    ``layer_norm_backward.launches``), then :func:`layer_norm_param_grad`.
    ``dy`` may arrive with any strides: it is made contiguous here, a copy
    only where its layout differs."""
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"layer_norm_backward: gradient {tuple(dy.shape)} {dy.dtype} "
                         f"{dy.device} does not match input {tuple(x.shape)} {x.dtype} "
                         f"{x.device}")
    if _plain(x):
        return layer_norm_backward_reference(x, dy, scale, stats)
    dy = dy.contiguous()
    _check_cuda("layer_norm_backward", x, scale)
    dx = torch.empty_like(x)
    c = x.shape[-1]
    if not x.numel():
        return dx, torch.zeros_like(scale), torch.zeros_like(scale)
    plan = plan_for(x, dy, scale, dx)
    partials = torch.empty((2, c, plan.parts), dtype=torch.float32, device=x.device)
    _build.launch(_SOURCE, "layer_norm_backward", x.device, x, dy, scale, stats, dx, partials,
                  x.numel() // c, c, _build.STREAM, plan.group, plan.vectors, plan.threads,
                  plan.parts, dtype=x.dtype, counter=layer_norm_backward, plan=plan)
    return (dx, *layer_norm_param_grad(partials, x.dtype))


class _LayerNorm(torch.autograd.Function):
    """The forward kernel, saving ``x``, ``scale`` and each row's (mean,
    signed rstd); the backward kernels on them."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
        x = x.contiguous()  # e.g. the patch embedding's NCHW output seen as NHWC
        y, stats = _forward(x, scale, bias, eps)
        ctx.save_for_backward(x, scale, stats)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy: torch.Tensor):
        x, scale, stats = ctx.saved_tensors
        return (*layer_norm_backward(x, dy, scale, stats), None)


@torch.library.custom_op("mtbc_torch::layer_norm", mutates_args=(),
                         device_types=("cpu", "cuda"))
def layer_norm_op(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward as a custom operator, (y, stats) of :func:`_forward`: on
    the card the kernel, on the CPU the plain twins."""
    return _forward(x.contiguous(), scale, bias, eps)


@layer_norm_op.register_fake
def _(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
      eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
            x.new_empty(x.shape[:-1] + (2,), dtype=stats_dtype(x)))


def _op_setup_context(ctx, inputs, output) -> None:
    x, scale, _, _ = inputs
    ctx.save_for_backward(x.contiguous(), scale, output[1])


def _op_backward(ctx, dy: torch.Tensor, _dstats):
    x, scale, stats = ctx.saved_tensors
    return (*layer_norm_backward(x, dy, scale, stats), None)


layer_norm_op.register_autograd(_op_backward, setup_context=_op_setup_context)


@counted
def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """flax's LayerNorm over the last axis of ``x`` with per-channel
    ``scale`` and ``bias``.

    Off the card, in f64 or inside a trace: :func:`layer_norm_reference`.
    Under ``torch.export``: the custom operator :func:`layer_norm_op`. A
    CUDA tensor in f32 or bf16 (parameters of its dtype): the forward
    kernel, counted in ``layer_norm.launches``, through a
    ``torch.autograd.Function`` when a gradient is needed. A
    non-contiguous ``x`` is copied once."""
    if torch.compiler.is_exporting():
        return layer_norm_op(x, scale, bias, eps)[0]
    if _plain(x):
        return layer_norm_reference(x, scale, bias, eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, scale, bias, eps)
    return _forward(x.contiguous(), scale, bias, eps)[0]
