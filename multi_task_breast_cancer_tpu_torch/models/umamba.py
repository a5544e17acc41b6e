"""U-Mamba_Enc, 2-D (PyTorch): an nnU-Net with residual stages and a Mamba
layer after every encoder stage (Ma, Li & Wang 2024, arXiv:2401.04722;
``nnunetv2/nets/UMambaEnc_2d.py``, class ``UMambaEnc`` and its
``MambaLayer``). It has no twin in the JAX package: the port alone runs it.

Layer equations (x NCHW; IN an affine InstanceNorm, eps 1e-5; σ LeakyReLU
0.01; every convolution with a bias, nnU-Net's ``conv_bias``):

- ``BasicResBlock(ci→co, stride s)``:
  ``σ(IN₂(conv3x3(σ(IN₁(conv3x3_s(x))))) + conv1x1_s(x))``, the 1×1 path
  not normalised;
- ``BasicBlockD(c)``: ``σ(IN₂(conv3x3(σ(IN₁(conv3x3(x))))) + x)``;
- ``MambaLayer``: its output replaces x (no residual around it). Patch
  tokens where H·W > C: ``t = LN(flatten(x)ᵀ)`` ∈ (B, L = H·W, d = C), the
  output ``Mamba(t)ᵀ`` reshaped to (B, C, H, W). Channel tokens where
  H·W ≤ C (U-Mamba's ``do_channel_token``): the sequence runs over the C
  channels, d = H·W, LN over each flattened plane. LN eps 1e-5;
- ``Mamba(t)`` (``mamba_ssm``'s ``modules/mamba_simple.py::Mamba``) with
  d_inner = 2d, N = 16, R = ⌈d/16⌉, d_conv = 4: ``[u, z] = t·W_in`` (no
  bias); ``u = SiLU(causal depthwise conv1d₄(u) + b)`` along L;
  ``[δ̂, B, C] = u·W_x`` (no bias; widths R, N, N);
  ``δ = softplus(δ̂·W_dt + b_dt)``, ``A = −exp(A_log)``;
  ``h_l = exp(δ_l ⊙ A) ⊙ h_{l−1} + (δ_l ⊙ u_l) ⊗ B_l``,
  ``y_l = h_l·C_l + D ⊙ u_l``; ``out = (y ⊙ SiLU(z))·W_out`` (no bias).

Network: a stem ``[BasicResBlock(in→w₀), BasicBlockD(w₀)]``; encoder stage
s ``[BasicResBlock(w_{s−1}→w_s, stride_s), BasicBlockD(w_s)]`` then
``MambaLayer_s``, whose output is skip s; a decoder from the bottom up:
``ConvTranspose2x2/2(w_below→w_skip)``, concatenation with the skip,
``BasicResBlock(2·w_skip→w_skip)`` and ``BasicBlockD(w_skip)``; a 1×1 head
to the regions. The plan is nnU-Net v2's 2-D planner's for a 128² one-channel
patch: widths 32, 64, 128, 256, 512, 512 and strides 1, 2, 2, 2, 2, 2 (two
blocks a stage). Stages 0-2 then take patch tokens (d = 32, 64, 128 over
16,384, 4,096 and 1,024 tokens) and stages 3-5 channel tokens (d = 256,
64, 16 over 256, 512 and 512). Departures from U-Mamba: no deep
supervision (one head), one sigmoid region.

Kernels: every affine InstanceNorm, with the residual add and the
LeakyReLU after it, is one call of
:func:`~..ops.instance_norm_affine.instance_norm_affine` (48 sites a
forward); the LayerNorms are :mod:`..ops.layer_norm`'s (6 sites); the scan
is :func:`~..ops.selective_scan.selective_scan` (6 a forward); the
convolutions run through SwinUNETR's deterministic path
(:func:`~.swin_unetr._conv`), so a graphed step equals an eager one bit for
bit and two processes agree. The causal conv1d is four shifted
multiply-adds in plain torch.

A scan runs along the whole flattened image, which no row partition of a
``space`` group can split: the model has no ``space_row_multiple`` (asking
for one raises ``NotImplementedError``) and its Mamba layers refuse a
``space`` group.

Spans (:mod:`..utils.profiling`): ``umamba.mamba`` (each
:class:`MambaLayer`, 6 a forward), ``umamba.scan`` (the scan inside it) and
``umamba.decoder``. The counter ``umamba.scan_elements`` adds B·d_inner·L·N
of each scan: 32,768,000 an image a forward at 128². The counter
``umamba.scan_segments`` adds the independent chains the scan's forward
kernel runs (:func:`~..ops.selective_scan.scan_plan`'s ``chains``: B ·
d_inner/32 · segments along L): 2,368 a forward at 128² and batch 2. A
captured step counts once, at its capture; a replay runs no Python.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multi_task_breast_cancer_tpu_torch.models.blocks import (
    Conv3x3,
    CountedConv2d,
    InstanceNorm,
    LayerNorm,
    deconv,
)
from multi_task_breast_cancer_tpu_torch.models.swin_unetr import _conv, _norm_epilogue
from multi_task_breast_cancer_tpu_torch.ops.selective_scan import (
    D_STATE,
    scan_plan,
    selective_scan,
)
from multi_task_breast_cancer_tpu_torch.parallel import spatial
from multi_task_breast_cancer_tpu_torch.utils import profiling

WIDTHS = (32, 64, 128, 256, 512, 512)  # the 2-D planner's plan for a 128² patch
SLOPE = 0.01
D_CONV = 4
EXPAND = 2
_NO_SPACE = ("UMambaEnc under a space group: a Mamba layer scans the whole flattened image "
             "in one sequence, which a partition of its rows cannot split; train it without "
             "training.spatial_partitions")


class BasicResBlock(nn.Module):
    """``σ(IN₂(conv3x3(σ(IN₁(conv3x3_s(x))))) + conv1x1_s(x))``."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv3x3(cin, cout, bias=True, stride=stride)
        self.norm1 = InstanceNorm(cout, affine=True)
        self.conv2 = Conv3x3(cout, cout, bias=True)
        self.norm2 = InstanceNorm(cout, affine=True)
        self.conv3 = CountedConv2d(cin, cout, 1, stride=stride, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _norm_epilogue(self.norm1, _conv(self.conv1, x), slope=SLOPE)
        return _norm_epilogue(self.norm2, _conv(self.conv2, y), residual=_conv(self.conv3, x),
                              slope=SLOPE)


class BasicBlockD(nn.Module):
    """``σ(IN₂(conv3x3(σ(IN₁(conv3x3(x))))) + x)``."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = Conv3x3(c, c, bias=True)
        self.norm1 = InstanceNorm(c, affine=True)
        self.conv2 = Conv3x3(c, c, bias=True)
        self.norm2 = InstanceNorm(c, affine=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _norm_epilogue(self.norm1, _conv(self.conv1, x), slope=SLOPE)
        return _norm_epilogue(self.norm2, _conv(self.conv2, y), residual=x, slope=SLOPE)


def _stage(cin: int, cout: int, stride: int = 1) -> nn.Sequential:
    return nn.Sequential(BasicResBlock(cin, cout, stride), BasicBlockD(cout))


class CausalConv1d(nn.Module):
    """Mamba's depthwise ``nn.Conv1d(d, d, k, groups=d, padding=k−1)`` cut to
    its first L outputs, on channels-last (B, L, d) rows: ``bias + Σ_j
    weight[:, 0, j] · x[l + j − (k − 1)]``, zeros before the first token.
    Parameters ``weight`` (d, 1, k) and ``bias`` (d,), as the module's."""

    def __init__(self, channels: int, kernel: int = D_CONV):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, 1, kernel))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, steps = self.weight.shape[-1], x.shape[1]
        padded = F.pad(x, (0, 0, k - 1, 0))
        w = self.weight[:, 0, :]
        out = torch.addcmul(self.bias, padded[:, :steps], w[:, 0])
        for j in range(1, k):
            out = torch.addcmul(out, padded[:, j:j + steps], w[:, j])
        return out


class Mamba(nn.Module):
    """``mamba_ssm``'s Mamba block (its parameter names) on (B, L, d)
    tokens; the scan in f32 (:func:`~..ops.selective_scan.selective_scan`)
    whatever the tokens' dtype, as U-Mamba's layer runs it."""

    def __init__(self, d_model: int):
        super().__init__()
        self.d_inner = EXPAND * d_model
        self.dt_rank = math.ceil(d_model / 16)
        self.in_proj = nn.Linear(d_model, 2 * self.d_inner, bias=False)
        self.conv1d = CausalConv1d(self.d_inner)
        self.x_proj = nn.Linear(self.d_inner, self.dt_rank + 2 * D_STATE, bias=False)
        self.dt_proj = nn.Linear(self.dt_rank, self.d_inner, bias=True)
        self.A_log = nn.Parameter(torch.empty(self.d_inner, D_STATE))
        self.D = nn.Parameter(torch.ones(self.d_inner))
        self.out_proj = nn.Linear(self.d_inner, d_model, bias=False)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        u, z = self.in_proj(t).split(self.d_inner, dim=-1)
        u = F.silu(self.conv1d(u))
        low, B, C = self.x_proj(u).split([self.dt_rank, D_STATE, D_STATE], dim=-1)
        delta = F.linear(low, self.dt_proj.weight)  # the bias is the scan's
        f32 = torch.promote_types(t.dtype, torch.float32)
        batch, steps = t.shape[:2]
        profiling.count("umamba.scan_elements", batch * self.d_inner * steps * D_STATE)
        profiling.count("umamba.scan_segments", scan_plan(batch, self.d_inner, steps).chains)
        with profiling.span("umamba.scan"):
            y = selective_scan(u.to(f32), delta.to(f32), -torch.exp(self.A_log.to(f32)),
                               B.to(f32), C.to(f32), self.D.to(f32), z.to(f32),
                               self.dt_proj.bias.to(f32))
        return self.out_proj(y.to(t.dtype))


class MambaLayer(nn.Module):
    """LayerNorm (eps 1e-5) and :class:`Mamba` over patch tokens (one a
    pixel, d = C) or, with ``channel_token``, channel tokens (one a
    channel, d = H·W); the output replaces the input, NCHW-contiguous."""

    def __init__(self, dim: int, channel_token: bool):
        super().__init__()
        self.channel_token = channel_token
        self.norm = LayerNorm(dim, eps=1e-5)
        self.mamba = Mamba(dim)

    @profiling.spanned("umamba.mamba")
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if spatial.current() is not None:
            raise NotImplementedError(_NO_SPACE)
        b, c, h, w = x.shape
        tokens = x.reshape(b, c, h * w)
        if self.channel_token:
            return self.mamba(self.norm(tokens)).reshape(b, c, h, w)
        out = self.mamba(self.norm(tokens.transpose(1, 2)))
        return out.transpose(1, 2).contiguous().view(b, c, h, w)


def channel_tokens(widths: Sequence[int] = WIDTHS, size: int = 128) -> list:
    """Whether each stage's Mamba layer takes channel tokens: H·W ≤ C at
    the stage's side (the first stage at stride 1, each later one halving)."""
    return [(size >> s) ** 2 <= w for s, w in enumerate(widths)]


class _Encoder(nn.Module):
    def __init__(self, sequences: int, widths: Sequence[int], size: int):
        super().__init__()
        self.stem = _stage(sequences, widths[0])
        ins = (widths[0], *widths[:-1])
        self.stages = nn.ModuleList(_stage(cin, w, 1 if s == 0 else 2)
                                    for s, (cin, w) in enumerate(zip(ins, widths)))
        self.mamba_layers = nn.ModuleList(
            MambaLayer((size >> s) ** 2 if channel else w, channel)
            for s, (w, channel) in enumerate(zip(widths, channel_tokens(widths, size))))


class _Decoder(nn.Module):
    def __init__(self, widths: Sequence[int], regions: int):
        super().__init__()
        below = list(widths[::-1])
        self.transpconvs = nn.ModuleList(deconv(hi, lo, 2) for hi, lo in zip(below, below[1:]))
        self.stages = nn.ModuleList(nn.Sequential(BasicResBlock(2 * lo, lo), BasicBlockD(lo))
                                    for lo in below[1:])
        self.seg_layer = CountedConv2d(widths[0], regions, 1, bias=True)


class UMambaEnc(nn.Module):
    """U-Mamba_Enc for ``size``² inputs: ``widths`` one per stage (the
    first at stride 1, every later one halving the side). The token layout
    of each Mamba layer, and so its parameter shapes, follow the side: the
    model is built for ``size`` and refuses other sides."""

    name_str = "U-Mamba_Enc"

    def __init__(self, sequences: int = 1, regions: int = 1,
                 widths: Sequence[int] = WIDTHS, size: int = 128):
        super().__init__()
        widths = tuple(int(w) for w in widths)
        if len(widths) < 2 or size % 2 ** (len(widths) - 1):
            raise ValueError(f"UMambaEnc: {len(widths)} stages need a side divisible by "
                             f"{2 ** (len(widths) - 1)}, got {size}")
        self.size, self.widths = size, widths
        self.encoder = _Encoder(sequences, widths, size)
        self.decoder = _Decoder(widths, regions)

    @property
    def space_row_multiple(self) -> int:
        raise NotImplementedError(_NO_SPACE)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[2:] != (self.size, self.size):
            raise ValueError(f"this UMambaEnc was built for {self.size}² inputs (its Mamba "
                             f"layers' widths follow the side), not {tuple(x.shape[2:])}")
        enc = self.encoder
        x = enc.stem(x)
        skips = []
        for stage, layer in zip(enc.stages, enc.mamba_layers):
            x = layer(stage(x))
            skips.append(x)
        dec = self.decoder
        with profiling.span("umamba.decoder"):
            x = skips[-1]
            for up, stage, skip in zip(dec.transpconvs, dec.stages, skips[-2::-1]):
                x = stage(torch.cat([_conv(up, x), skip], dim=1))
            return _conv(dec.seg_layer, x)


@torch.no_grad()
def init_ssm(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Mamba's own initialisation of what :func:`~.blocks.init_weights`
    leaves to it: ``A_log = log(1..N)`` on every channel, ``D = 1``, the
    step's bias the inverse softplus of a step drawn log-uniform in [1e-3,
    0.1], ``dt_proj.weight`` uniform in ±R^−½, the conv1d as
    ``nn.Conv1d``'s default (uniform in ±k^−½)."""
    for m in model.modules():
        if isinstance(m, Mamba):
            n = m.A_log.shape[1]
            m.A_log.copy_(torch.log(torch.arange(1, n + 1, dtype=m.A_log.dtype)).expand_as(
                m.A_log))
            m.D.fill_(1.0)
            m.dt_proj.weight.uniform_(-m.dt_rank ** -0.5, m.dt_rank ** -0.5, generator=generator)
            dt = torch.exp(torch.rand(m.d_inner, generator=generator)
                           * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
            m.dt_proj.bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        elif isinstance(m, CausalConv1d):
            bound = m.weight.shape[-1] ** -0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
    return model

