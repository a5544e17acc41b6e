"""Building blocks of the model zoo (PyTorch, NCHW).

Twins of ``multi_task_breast_cancer_tpu/models/blocks.py``: the BTS and
nnU-Net families' ``ConvInNormLeReLU`` stack (the fused norm kernel), and the
MONAI-equivalent ``MonaiConv`` / ``TwoConv`` / ``Down`` / ``UpCat`` of the
UNet++ family (biased conv → affine InstanceNorm → LeakyReLU(0.1), plain
PyTorch, as JAX runs them without a kernel). Module and
parameter names follow the JAX parameter tree (``conv``, ``block1``,
``deconv_kernel``, …) so :mod:`.jax_weights` maps one onto the other by path.
Initialisation follows the JAX initialisers (:func:`init_weights`), drawn
from an explicit ``torch.Generator``.

The flax layers the rest of the zoo uses, with flax's semantics where they
differ from torch's: :class:`BatchNorm` (flax ``nn.BatchNorm``: the biased
batch variance in the running update), :class:`GroupNorm` and
:class:`LayerNorm` (eps 1e-6; on the card the hand-written kernels of
:mod:`..ops.layer_norm`), :class:`PReLU` (one 0-d slope),
:class:`Dropout` (draws from an explicit generator, :func:`dropout_draws`),
and the ``padding="SAME"`` convolutions :class:`SameConv2d` and
:class:`SameConvTranspose2d`. Flax's ``nn.gelu`` is ``F.gelu(x,
approximate="tanh")``.

Spatial partitioning (:mod:`..parallel.spatial`): under a ``space`` group a
tensor holds this rank's rows, and each layer keeps its one-process answer
by a row rule:

- :class:`Conv3x3` (stride 1 or 2, padding 1) and :class:`SameConv2d` (the
  ``SAME`` pads of the *global* height) take their halo rows through
  :func:`~..parallel.spatial.halo_conv`; :class:`SameConvTranspose2d`
  takes one row from above and crops;
- :class:`ConvInNormLeReLU` runs the norm kernel's split-statistics entry
  points; the plain :class:`InstanceNorm` sums Σx, then Σ(x − mean)², over
  the group; :class:`GroupNorm` sums Σx and Σx² over it (flax's fast
  variance); :class:`BatchNorm` sums them over every rank of the mesh and
  divides by n_global · H_global · W;
- :class:`Dropout` draws the global batch's mask at the global height and
  keeps this rank's data shard and rows;
- :class:`MLPHead` flattens the gathered rows, :func:`global_avg_pool` sums
  its planes over the group;
- :class:`LayerNorm` (over the channels of a token), :class:`PReLU`, the
  1×1 and kernel-equals-stride convolutions, :class:`DeconvHead`, the 2×2
  max pool and the nearest upsample are row-local as they are;
- :func:`avg_pool` is row-local where its window divides the shard's rows
  and raises ``NotImplementedError`` where a window would cross a shard's
  edge (Adityan pools its gathered map instead).

Every convolution module of the zoo derives from :class:`CountedConv2d` or
:class:`CountedConvTranspose2d` (:class:`DeconvHead` calls the same
:func:`note_conv_problem`), which counts ``conv.problems_measured``: the
problems cuDNN times its engines for.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multi_task_breast_cancer_tpu_torch.ops.hopper_kernels import instance_norm_leaky_relu
from multi_task_breast_cancer_tpu_torch.ops.flax_norm import f32_normalize, fast_stats, stats_dtype
from multi_task_breast_cancer_tpu_torch.ops.layer_norm import layer_norm
from multi_task_breast_cancer_tpu_torch.parallel import spatial
from multi_task_breast_cancer_tpu_torch.utils import profiling


def _cudnn_times(x: torch.Tensor) -> bool:
    """Whether cuDNN times its engines for a convolution of ``x`` run now:
    the switch on, a CUDA input, and no trace (``torch.export``) running."""
    return (torch.backends.cudnn.benchmark and x.is_cuda
            and not torch.compiler.is_compiling())


def note_conv_problem(op: str, x: torch.Tensor, weight: torch.Tensor,
                      stride: Tuple[int, ...], padding: Tuple[int, ...]) -> None:
    """Count ``conv.problems_measured`` the first time this thread runs a
    convolution problem while cuDNN times its engines
    (``cudnn.benchmark``, set by :func:`~..device.set_float32_policy`): a
    CUDA input, and the switch on. The problem is what cuDNN keys its
    choice by: the op (``conv``, ``transposed``, ``halo``), the input's and
    the weight's shapes, the dtype, stride, padding, the input's layout, the
    device, ``cudnn.deterministic`` and the thread (PyTorch keeps the
    choices per thread). Two modules with the same problem share one search
    and count once; each count is a forward search, and the backward's
    searches of the same problem follow it. The port's convolution modules
    all call this from their forward, so a replay, which runs no Python,
    never counts, nor does a trace (``torch.export``) or what it exported."""
    if not _cudnn_times(x):
        return
    profiling.count_once("conv.problems_measured", (
        op, tuple(x.shape), tuple(weight.shape), x.dtype, tuple(stride), tuple(padding),
        x.is_contiguous(), x.device, torch.backends.cudnn.deterministic,
        threading.get_ident()))


class CountedConv2d(nn.Conv2d):
    """``nn.Conv2d`` that notes its problem (:func:`note_conv_problem`);
    the base of the port's convolutions."""

    def _conv_forward(self, x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor]) -> torch.Tensor:
        note_conv_problem("conv", x, weight, self.stride, self.padding)
        return super()._conv_forward(x, weight, bias)


class CountedConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that notes its problem
    (:func:`note_conv_problem`); the base of the port's transposed
    convolutions."""

    def forward(self, x: torch.Tensor, output_size=None) -> torch.Tensor:
        note_conv_problem("transposed", x, self.weight, self.stride, self.padding)
        return super().forward(x, output_size)


class Conv3x3(CountedConv2d):
    """3×3 conv, symmetric padding 1 (stride 1 keeps the spatial size,
    stride 2 halves an even one). Under a ``space`` group it exchanges one
    halo row with each neighbour and pads the width only
    (:func:`~..parallel.spatial.halo_conv`), so this rank's output rows are
    those of the whole image's convolution."""

    def __init__(self, in_features: int, features: int, bias: bool = False,
                 stride: int = 1):
        super().__init__(in_features, features, 3, stride=stride, padding=1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        space = spatial.current()
        if space is None:
            return super().forward(x)
        note_conv_problem("halo", x, self.weight, self.stride, self.padding)
        return spatial.halo_conv(x, space, self.weight, self.bias, (1, 1), self.stride[0],
                                 (1, 1))


def conv3x3(in_features: int, features: int, *, use_bias: bool = False) -> Conv3x3:
    """3×3 conv, padding preserves spatial size (bias off, as in JAX)."""
    return Conv3x3(in_features, features, bias=use_bias)


def conv1x1(in_features: int, features: int, *, use_bias: bool = True) -> CountedConv2d:
    """1×1 conv (bias on, zero-initialised)."""
    return CountedConv2d(in_features, features, 1, bias=use_bias)


def deconv(in_features: int, features: int, kernel: int) -> CountedConvTranspose2d:
    """ConvTranspose with kernel == stride (exact k× upsampling, no overlap)."""
    return CountedConvTranspose2d(in_features, features, kernel, stride=kernel)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2)


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k×k average pool at stride k. Under a ``space`` group a window must
    not cross a shard's edge: the shard's rows a multiple of k."""
    space = spatial.current()
    if space is not None and x.shape[2] % k:
        raise NotImplementedError(
            f"a {k}×{k} average pool over a shard of {x.shape[2]} rows crosses the "
            f"edge between ranks of the space group ({space.size} ranks): pool the "
            "gathered rows (parallel.spatial.whole_rows)")
    return F.avg_pool2d(x, k, stride=k)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, C), over the whole plane
    (:func:`..parallel.spatial.plane_mean`)."""
    return spatial.plane_mean(x)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Exact 2× nearest-neighbour upsample (each pixel repeated on H and W)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, H·W·C) in the (h, w, c) order of the JAX models'
    NHWC flatten, so a dense layer after it keeps JAX's weight layout
    (transposed)."""
    return x.permute(0, 2, 3, 1).flatten(1)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalisation over H, W (eps=1e-5).
    Statistics in f32 even for bf16 input (f64 stays f64,
    :func:`~..ops.flax_norm.stats_dtype`); the result is cast back to the
    input's dtype before the affine and any activation, as the JAX module
    does.
    ``affine=True`` (the UNet++ family's MONAI norm) adds the per-channel
    ``scale`` and ``bias`` of ``features`` channels."""

    def __init__(self, features: int = 0, affine: bool = False, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        if affine:
            if features <= 0:
                raise ValueError("InstanceNorm(affine=True) needs its channel count")
            self.scale = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.scale = self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(stats_dtype(x))
        space = spatial.current()
        if space is None:
            centered = xf - xf.mean(dim=(2, 3), keepdim=True)
            var = (centered * centered).mean(dim=(2, 3), keepdim=True)
        else:  # two passes over the group: Σx → mean, then Σ(x − mean)² → var
            count = x.shape[2] * space.size * x.shape[3]
            centered = xf - _space_sums(xf, space) / count
            var = _space_sums(centered * centered, space) / count
        y = (centered * torch.rsqrt(var + self.eps)).to(x.dtype)
        if self.scale is None:
            return y
        return y * self.scale[:, None, None] + self.bias[:, None, None]


def _space_sums(xf: torch.Tensor, space) -> torch.Tensor:
    """Σ over each (n, c) plane's rows on every rank of ``space``, kept
    dims; differentiable (no collective for an empty batch, whose group has
    none on any rank)."""
    sums = xf.sum(dim=(2, 3), keepdim=True)
    return spatial.sum_over_space(sums, space) if xf.shape[0] else sums


class ConvInNormLeReLU(nn.Module):
    """conv3x3(bias=False) → InstanceNorm → LeakyReLU(0.01).

    The norm and activation run as one fused kernel
    (:func:`~..ops.hopper_kernels.instance_norm_leaky_relu`). Setting
    ``norm`` to an :class:`InstanceNorm` selects it + ``F.leaky_relu``
    instead, the twin of the JAX default path; ``chip_smoke.plain_twin``
    does so to give a reference on the same device.

    Under a ``space`` group the norm takes the group
    (:func:`~..ops.hopper_kernels.split_forward`).

    bf16: both compute the statistics in f32. The JAX module and
    :class:`InstanceNorm` round the normalised value to bf16 before the
    LeakyReLU; the kernel applies the LeakyReLU in f32 and rounds once,
    after it. On a negative value the two can differ by one bf16 ulp, which
    the port-vs-JAX bf16 tolerance (``tests/test_torch_bf16.py``) covers."""

    def __init__(self, in_features: int, features: int, negative_slope: float = 0.01):
        super().__init__()
        self.conv = conv3x3(in_features, features)
        self.negative_slope = negative_slope
        self.norm = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            return F.leaky_relu(self.norm(x), self.negative_slope)
        return instance_norm_leaky_relu(x, 1e-5, self.negative_slope, space=spatial.current())


class LevelBlock(nn.Module):
    """Two stacked ConvInNormLeReLU blocks."""

    def __init__(self, in_features: int, mid_features: int, out_features: int):
        super().__init__()
        self.block1 = ConvInNormLeReLU(in_features, mid_features)
        self.block2 = ConvInNormLeReLU(mid_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block2(self.block1(x))


class DeconvHead(nn.Module):
    """Deep-supervision head ``ConvTranspose(k=s, C→C) → conv1x1(C→R)``
    computed as ONE transposed conv with the fused kernel
    ``W[i,r,a,b] = Σ_c Wd[i,c,a,b]·W1[r,c]`` and bias ``W1·bd + b1``.

    Keeps the JAX head's four parameters, in PyTorch layouts:
    ``deconv_kernel`` (C, C, k, k) as ``ConvTranspose2d`` weights,
    ``conv1x1_kernel`` (R, C, 1, 1) as ``Conv2d`` weights."""

    def __init__(self, mid_features: int, regions: int, kernel: int):
        super().__init__()
        c, k, r = mid_features, kernel, regions
        self.kernel = k
        self.deconv_kernel = nn.Parameter(torch.empty(c, c, k, k))
        self.deconv_bias = nn.Parameter(torch.zeros(c))
        self.conv1x1_kernel = nn.Parameter(torch.empty(r, c, 1, 1))
        self.conv1x1_bias = nn.Parameter(torch.zeros(r))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w1 = self.conv1x1_kernel[:, :, 0, 0]  # (R, C)
        fused_w = torch.einsum("icab,rc->irab", self.deconv_kernel, w1)
        fused_b = w1 @ self.deconv_bias + self.conv1x1_bias
        note_conv_problem("transposed", x, fused_w, (self.kernel,) * 2, (0, 0))
        return F.conv_transpose2d(x, fused_w.to(x.dtype), fused_b.to(x.dtype),
                                  stride=self.kernel)


class MLPHead(nn.Module):
    """Flatten (in JAX's (h, w, c) order) → Linear(hidden) → ReLU →
    Linear(n_out). ``in_features`` is C·H·W of the tensor it flattens; under
    a ``space`` group it flattens the gathered rows."""

    def __init__(self, in_features: int, hidden: int, n_out: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, n_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(flatten_hwc(spatial.whole_rows(x)))))


# ---------------------------------------------------------------------------
# MONAI basic_unet-equivalent blocks (UNet++ family)
# ---------------------------------------------------------------------------


class MonaiConv(nn.Module):
    """conv3x3(bias=True) → InstanceNorm(affine=True) → dropout →
    LeakyReLU(0.1)."""

    def __init__(self, in_features: int, features: int, dropout: float = 0.0,
                 negative_slope: float = 0.1):
        super().__init__()
        self.conv = conv3x3(in_features, features, use_bias=True)
        self.norm = InstanceNorm(features, affine=True)
        self.dropout = Dropout(dropout)
        self.negative_slope = negative_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.dropout(self.norm(self.conv(x))), self.negative_slope)


class TwoConv(nn.Module):
    """Two MonaiConv blocks."""

    def __init__(self, in_features: int, features: int, dropout: float = 0.0):
        super().__init__()
        self.conv_0 = MonaiConv(in_features, features, dropout)
        self.conv_1 = MonaiConv(features, features, dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_1(self.conv_0(x))


class Down(nn.Module):
    """MaxPool(2) → TwoConv."""

    def __init__(self, in_features: int, features: int, dropout: float = 0.0):
        super().__init__()
        self.convs = TwoConv(in_features, features, dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convs(max_pool_2x2(x))


class UpCat(nn.Module):
    """Deconv 2× upsample of ``x`` (``in_features`` channels, halved when
    ``halves``) → concat ``[skip, up]`` → TwoConv."""

    def __init__(self, in_features: int, skip_features: int, out_features: int,
                 halves: bool = True, dropout: float = 0.0):
        super().__init__()
        up_features = in_features // 2 if halves else in_features
        self.upsample = deconv(in_features, up_features, 2)
        self.convs = TwoConv(skip_features + up_features, out_features, dropout)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.convs(torch.cat([skip, self.upsample(x)], dim=1))


# ---------------------------------------------------------------------------
# flax layers of the MONAI twins, ResidualUNet and SwinUNETR
# ---------------------------------------------------------------------------


class LecunConv2d(CountedConv2d):
    """A ``Conv2d`` that :func:`init_weights` draws LeCun normal: a flax
    ``nn.Conv`` left at its default ``kernel_init``."""


def _same_pads(size: int, kernel: int, stride: int) -> tuple:
    """flax/XLA ``padding="SAME"`` on one axis: (low, high), the extra pixel
    on the high side."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(CountedConv2d):
    """flax ``nn.Conv(padding="SAME")``: pads (low, high) per axis as XLA
    does. A stride-2 3×3 conv on an even side pads (0, 1), where
    ``Conv2d(padding=1)`` would pad (1, 1)."""

    def __init__(self, in_features: int, features: int, kernel: int, stride: int = 1,
                 bias: bool = True):
        super().__init__(in_features, features, kernel, stride=stride, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (k, _), (s, _) = self.kernel_size, self.stride
        space = spatial.current()
        left, right = _same_pads(x.shape[3], k, s)
        if space is not None:  # the pads of the whole image's height
            note_conv_problem("halo", x, self.weight, self.stride, self.padding)
            return spatial.halo_conv(x, space, self.weight, self.bias,
                                     _same_pads(x.shape[2] * space.size, k, s), s,
                                     (left, right))
        top, bottom = _same_pads(x.shape[2], k, s)
        return super().forward(F.pad(x, (left, right, top, bottom)))


class SameConvTranspose2d(CountedConvTranspose2d):
    """flax ``nn.ConvTranspose(padding="SAME")``: the output side is
    ``stride`` × the input's, the transposed conv without padding cropped at
    its high end. Weights as :func:`deconv`'s (taps flipped against the JAX
    kernel, :mod:`.jax_weights`).

    Under a ``space`` group (kernel ``stride + 1``, the 3×3 stride 2 of the
    MONAI UNet): this rank's input rows start at global row i₀ and their
    outputs at s·i₀, which the row i₀ − 1 reaches too. So one halo row
    comes from above; the unpadded transposed conv of the h + 1 rows gives
    s·h + k − 1 output rows from global row s·(i₀ − 1), of which rows
    [s, s·(h + 1)) are this rank's of the cropped whole."""

    def __init__(self, in_features: int, features: int, kernel: int, stride: int):
        super().__init__(in_features, features, kernel, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, h, w = self.stride[0], x.shape[2], x.shape[3]
        space = spatial.current()
        if space is None:
            return super().forward(x)[:, :, :s * h, :s * w]
        if self.kernel_size[0] != s + 1:
            raise NotImplementedError(
                f"a SAME transposed convolution of kernel {self.kernel_size[0]} at stride "
                f"{s} under a space group: the row rule takes kernel stride + 1")
        x = spatial.halo_exchange(x, space, 1)[:, :, :h + 1]
        return super().forward(x)[:, :, s:s * (h + 1), :s * w]


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over N, H, W of NCHW
    input: parameters ``scale``, ``bias``; buffers ``mean``, ``var`` (the
    JAX ``batch_stats``, always f32). In training the batch statistics are
    taken in f32 (E[x²] − E[x]², clipped at 0) and the buffers move to
    ``0.9·old + 0.1·batch``, the *biased* batch variance (``BatchNorm2d``
    keeps the unbiased one); in eval the buffers normalise.

    Under a data mesh (:func:`global_batch`) the statistics are those of
    the global batch, as GSPMD computes them on the JAX mesh: every rank
    sums Σx and Σx² over its rows, the sums are all-reduced (in the
    backward too) and divided by the global count; a rank with no rows
    still joins. Under a ``space`` group too, over every rank of the mesh
    (data and space), each rank holding H/n_space rows."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.shard = None  # (mesh, global rows), set by global_batch

    def _global_stats(self, xf: torch.Tensor, space) -> tuple:
        """Σx and Σx² over every rank (of the mesh, or of the ``space``
        group alone without one), divided by the global count n_global ·
        H_global · W."""
        n, c, h, w = xf.shape
        sums = torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))])
        if self.shard is not None:
            mesh, n_global = self.shard
            sums = mesh.all_reduce_sum_differentiable(sums)
        else:
            n_global = n
            sums = spatial.sum_over_space(sums, space) if n else sums
        rows = h * (space.size if space is not None else 1)
        moments = (sums / (n_global * rows * w)).reshape(2, 1, c, 1, 1)
        mean = moments[0]
        return mean, (moments[1] - mean * mean).clamp(min=0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = x.to(stats_dtype(x))
            space = spatial.current()
            mean, var = (fast_stats(xf, (0, 2, 3)) if self.shard is None and space is None
                         else self._global_stats(xf, space))
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean.flatten().to(self.mean.dtype))
                self.var.copy_(m * self.var + (1 - m) * var.flatten().to(self.var.dtype))
        else:
            mean, var = self.mean[:, None, None], self.var[:, None, None]
        return f32_normalize(x, mean, var, self.scale, self.bias, self.eps)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` (eps 1e-6) over NCHW input, ``groups`` groups of
    consecutive channels; parameters ``scale``, ``bias``."""

    def __init__(self, groups: int, features: int, eps: float = 1e-6):
        super().__init__()
        if features % groups:
            raise ValueError(f"{groups} groups do not divide {features} channels")
        self.groups, self.eps = groups, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        xg = x.to(stats_dtype(x)).reshape(n, self.groups, -1)
        space = spatial.current()
        if space is None:
            mean, var = fast_stats(xg, (2,))
        else:  # flax's fast variance from Σx and Σx² summed over the group
            sums = torch.stack([xg.sum(dim=2), (xg * xg).sum(dim=2)])
            if n:
                sums = spatial.sum_over_space(sums, space)
            moments = (sums / (xg.shape[2] * space.size))[..., None]
            mean = moments[0]
            var = (moments[1] - mean * mean).clamp(min=0.0)
        per = c // self.groups
        mean = mean.repeat_interleave(per, dim=1).reshape(n, c, 1, 1)
        var = var.repeat_interleave(per, dim=1).reshape(n, c, 1, 1)
        return f32_normalize(x, mean, var, self.scale, self.bias, self.eps)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (eps 1e-6) over the last axis; parameters
    ``scale``, ``bias``. :func:`~..ops.layer_norm.layer_norm`: on a CUDA
    tensor in f32 or bf16 the hand-written kernels, else its plain twin."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.eps)


class PReLU(nn.Module):
    """One learnable slope ``alpha``, a 0-d parameter (0.25), shared by every
    channel: ``x`` where ``x ≥ 0``, else ``alpha·x``."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.tensor(0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha * x)


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``: in training each element is kept with
    probability ``1 − rate`` and scaled by ``1/(1 − rate)``, the mask drawn
    from :attr:`generator` (set for an epoch by :func:`dropout_draws`; on
    the input's device), never from the global RNG; identity in eval and at
    rate 0. Under a data mesh (:func:`global_batch`) every rank draws the
    mask of the whole global batch and keeps its own rows, so the masks are
    the single-device run's. Under a ``space`` group the mask is drawn at
    the global height and each rank keeps its rows too."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None
        self.shard = None  # (mesh, global rows), set by global_batch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in training draws from an explicit generator: "
                               "run the step inside blocks.dropout_draws(model, generator)")
        keep = 1.0 - self.rate
        space = spatial.current()
        mesh, n_global = self.shard if self.shard is not None else (None, x.shape[0])
        shape = [n_global, *x.shape[1:]]
        if space is not None:  # NCHW rows
            shape[2] *= space.size
        draw = torch.rand(shape, generator=self.generator, device=x.device)
        if mesh is not None:
            draw = draw[mesh.shard(n_global)]
        if space is not None:
            draw = draw[:, :, space.rows(shape[2])]
        return torch.where(draw < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def has_dropout(model: nn.Module) -> bool:
    """Whether ``model`` draws dropout masks in training (a rate above 0)."""
    return any(isinstance(m, Dropout) and m.rate > 0 for m in model.modules())


@contextlib.contextmanager
def dropout_draws(model: nn.Module, generator: Optional[torch.Generator]) -> Iterator[None]:
    """Every :class:`Dropout` of ``model`` draws from ``generator`` inside
    the block."""
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    for m in drops:
        m.generator = generator
    try:
        yield
    finally:
        for m in drops:
            m.generator = None


# the layers whose training forward calls a collective under a data mesh
# (global_batch): a step of a model holding one is not split at its gradient
# all-reduce alone, so it runs eagerly there (graphs.enabled)
FORWARD_COLLECTIVES = (BatchNorm,)


def has_forward_collective(model: nn.Module) -> bool:
    """Whether ``model``'s training forward under a data mesh calls a
    collective (a layer of :data:`FORWARD_COLLECTIVES`)."""
    return any(isinstance(m, FORWARD_COLLECTIVES) for m in model.modules())


@contextlib.contextmanager
def global_batch(model: nn.Module, mesh, n_global: int) -> Iterator[None]:
    """Inside the block, this rank's rows of an ``n_global``-row batch
    (``mesh.shard(n_global)``) go through ``model`` as part of the global
    batch: its :class:`BatchNorm` layers take global statistics and its
    :class:`Dropout` layers the global masks. ``mesh=None`` changes
    nothing."""
    mods = [m for m in model.modules() if isinstance(m, (BatchNorm, Dropout))]
    if mesh is not None:
        for m in mods:
            m.shard = (mesh, n_global)
    try:
        yield
    finally:
        for m in mods:
            m.shard = None


def _kaiming_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """He normal, JAX ``variance_scaling(2.0, "fan_in", "normal")``."""
    w.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """JAX ``lecun_normal``: a normal truncated at ±2σ, σ rescaled so that the
    variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    _truncated_normal_(w, std, generator)


def _truncated_normal_(w: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """A normal of scale ``std`` truncated at ±2·``std`` (JAX
    ``truncated_normal(std)``, whose variance is below ``std²``)."""
    lo = math.erf(-2.0 / math.sqrt(2.0))
    w.uniform_(lo, -lo, generator=generator).erfinv_().mul_(std * math.sqrt(2.0))
    w.clamp_(-2.0 * std, 2.0 * std)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter as the JAX initialisers do (fan_in counted over
    the kernel taps and input channels, as JAX counts it): convs He normal,
    :class:`LecunConv2d`, transposed convs and dense layers LeCun normal,
    biases zero, a norm's scale one, a PReLU's slope 0.25, a window
    attention's ``rel_pos_bias`` truncated normal 0.02; batch statistics
    start at mean 0, variance 1."""
    for m in model.modules():
        if isinstance(m, (BatchNorm, GroupNorm, LayerNorm)) or (
                isinstance(m, InstanceNorm) and m.scale is not None):
            m.scale.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, BatchNorm):
                m.mean.zero_()
                m.var.fill_(1.0)
        elif isinstance(m, PReLU):
            m.alpha.fill_(0.25)
        elif hasattr(m, "rel_pos_bias"):
            _truncated_normal_(m.rel_pos_bias, 0.02, generator)
        elif isinstance(m, DeconvHead):
            c, _, k, _ = m.deconv_kernel.shape
            _lecun_normal_(m.deconv_kernel, k * k * c, generator)
            _kaiming_normal_(m.conv1x1_kernel, c, generator)
            m.deconv_bias.zero_()
            m.conv1x1_bias.zero_()
        elif isinstance(m, nn.ConvTranspose2d):
            i, _, kh, kw = m.weight.shape
            _lecun_normal_(m.weight, i * kh * kw, generator)
        elif isinstance(m, nn.Conv2d):
            _, i, kh, kw = m.weight.shape
            draw = _lecun_normal_ if isinstance(m, LecunConv2d) else _kaiming_normal_
            draw(m.weight, i * kh * kw, generator)
        elif isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, m.in_features, generator)
        if isinstance(m, (nn.ConvTranspose2d, nn.Conv2d, nn.Linear)) and m.bias is not None:
            m.bias.zero_()
    return model
