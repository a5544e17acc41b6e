"""Plain PyTorch reference of U-Mamba_Enc (Ma, Li & Wang 2024,
arXiv:2401.04722; ``nnunetv2/nets/UMambaEnc_2d.py``, class ``UMambaEnc`` and
its ``MambaLayer``), with the Mamba block of Gu & Dao 2023 (arXiv:2312.00752;
``mamba_ssm``'s ``modules/mamba_simple.py::Mamba``) and its scan as
Algorithm 2's recurrence, one step at a time. Float32, no kernel of the
port, no CUDA graph, no fusion; it imports nothing of the port. Its
parameter names and shapes are the port's (``models/umamba.py``), so one
seeded state dict loads into both.

Layer equations (x NCHW; IN an affine InstanceNorm, eps 1e-5; σ LeakyReLU
0.01; every convolution with a bias):

- ``BasicResBlock(ci→co, stride s)``:
  ``σ(IN₂(conv3x3(σ(IN₁(conv3x3_s(x))))) + conv1x1_s(x))``;
- ``BasicBlockD(c)``: ``σ(IN₂(conv3x3(σ(IN₁(conv3x3(x))))) + x)``;
- ``MambaLayer``, whose output replaces x: patch tokens where H·W > C
  (``t = LN(flatten(x)ᵀ)``, d = C, L = H·W), channel tokens where H·W ≤ C
  (the sequence over the channels, d = H·W, LN over each plane); torch's
  LayerNorm, eps 1e-5;
- ``Mamba(t)`` with d_inner = 2d, N = 16, R = ⌈d/16⌉, d_conv = 4:
  ``[u, z] = t·W_in``; ``u = SiLU(conv1d(u, groups=d_inner, padding 3)[:L])``;
  ``[δ̂, B, C] = u·W_x``; ``δ = softplus(δ̂·W_dt + b_dt)``; ``A = −exp(A_log)``;
  ``h_l = exp(δ_l A) ⊙ h_{l−1} + δ_l u_l B_l``; ``y_l = h_l·C_l + D u_l``;
  ``out = (y ⊙ SiLU(z))·W_out``.

Network: stem ``[BasicResBlock(1→w₀), BasicBlockD(w₀)]``; stage s
``[BasicResBlock(w_{s−1}→w_s, stride_s), BasicBlockD(w_s)]`` then
``MambaLayer_s`` (skip s); decoder from the bottom up: transposed conv 2×2/2,
concatenation with the skip, ``BasicResBlock(2w→w)``, ``BasicBlockD(w)``;
1×1 head.

Departures from U-Mamba: no deep supervision; one sigmoid region trained
with the configuration's DICE, not nnU-Net's softmax Dice + CE; weights
drawn from the benchmark's seed, not Mamba's initialisation; the stage plan
is nnU-Net v2's 2-D planner's for a 128² one-channel patch (widths 32-512,
strides 1, 2, 2, 2, 2, 2), not a published file. The port's LayerNorm keeps
its E[x²] − E[x]² statistics; this reference takes torch's two-pass form.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.models import AffineInstanceNorm

WIDTHS = (32, 64, 128, 256, 512, 512)
D_STATE = 16
D_CONV = 4
EXPAND = 2
SLOPE = 0.01


class BasicResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1)
        self.norm1 = AffineInstanceNorm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.norm2 = AffineInstanceNorm(cout)
        self.conv3 = nn.Conv2d(cin, cout, 1, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(self.norm1(self.conv1(x)), SLOPE)
        return F.leaky_relu(self.norm2(self.conv2(y)) + self.conv3(x), SLOPE)


class BasicBlockD(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1)
        self.norm1 = AffineInstanceNorm(c)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1)
        self.norm2 = AffineInstanceNorm(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(self.norm1(self.conv1(x)), SLOPE)
        return F.leaky_relu(self.norm2(self.conv2(y)) + x, SLOPE)


def _stage(cin: int, cout: int, stride: int = 1) -> nn.Sequential:
    return nn.Sequential(BasicResBlock(cin, cout, stride), BasicBlockD(cout))


class LayerNorm(nn.Module):
    """torch's LayerNorm (two-pass, eps 1e-5) with its weight named
    ``scale``, the port's name."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.scale, self.bias, 1e-5)


def selective_scan(u, delta, A, B, C, D, z, delta_bias) -> torch.Tensor:
    """Algorithm 2 (``selective_scan_ref`` with ``delta_softplus``): u, δ̂, z
    (batch, d_inner, L), B and C (batch, N, L); the recurrence one step at a
    time; the gated output (batch, d_inner, L). On meta tensors (the
    benchmark's counts) the steps' contractions of the states with C run as
    one, of the same shapes and operations."""
    delta = F.softplus(delta + delta_bias[:, None])
    decay = torch.exp(torch.einsum("bdl,dn->bdln", delta, A))
    push = torch.einsum("bdl,bnl,bdl->bdln", delta, B, u)
    if u.is_meta:  # shapes and counted operations only: the steps' contractions as one
        y = torch.einsum("bdln,bnl->bdl", push, C)
    else:
        h = u.new_zeros(u.shape[0], u.shape[1], A.shape[1])
        ys = []
        for a, p, c in zip(decay.unbind(2), push.unbind(2), C.unbind(2)):
            h = a * h + p
            ys.append(torch.einsum("bdn,bn->bd", h, c))
        y = torch.stack(ys, dim=2)
    y = y + u * D[:, None]
    return y * F.silu(z)


class Mamba(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.d_inner = EXPAND * d_model
        self.dt_rank = math.ceil(d_model / 16)
        self.in_proj = nn.Linear(d_model, 2 * self.d_inner, bias=False)
        self.conv1d = nn.Conv1d(self.d_inner, self.d_inner, D_CONV, groups=self.d_inner,
                                padding=D_CONV - 1)
        self.x_proj = nn.Linear(self.d_inner, self.dt_rank + 2 * D_STATE, bias=False)
        self.dt_proj = nn.Linear(self.dt_rank, self.d_inner)
        self.A_log = nn.Parameter(torch.zeros(self.d_inner, D_STATE))
        self.D = nn.Parameter(torch.ones(self.d_inner))
        self.out_proj = nn.Linear(self.d_inner, d_model, bias=False)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        steps = t.shape[1]
        xz = self.in_proj(t).transpose(1, 2)  # (batch, 2·d_inner, L)
        u, z = xz.chunk(2, dim=1)
        u = F.silu(self.conv1d(u)[..., :steps])
        x_dbl = self.x_proj(u.transpose(1, 2))
        low, B, C = x_dbl.split([self.dt_rank, D_STATE, D_STATE], dim=-1)
        delta = (low @ self.dt_proj.weight.t()).transpose(1, 2)
        y = selective_scan(u, delta, -torch.exp(self.A_log), B.transpose(1, 2),
                           C.transpose(1, 2), self.D, z, self.dt_proj.bias)
        return self.out_proj(y.transpose(1, 2))


class MambaLayer(nn.Module):
    """Hooks that count the scan sites (``benchmark/umamba_counts.py``) read
    ``mamba``'s input: (batch, L, d)."""

    def __init__(self, dim: int, channel_token: bool):
        super().__init__()
        self.channel_token = channel_token
        self.norm = LayerNorm(dim)
        self.mamba = Mamba(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        if self.channel_token:
            return self.mamba(self.norm(x.reshape(b, c, h * w))).reshape(b, c, h, w)
        out = self.mamba(self.norm(x.reshape(b, c, h * w).transpose(1, 2)))
        return out.transpose(1, 2).contiguous().view(b, c, h, w)


class _Encoder(nn.Module):
    def __init__(self, cin: int, widths: Sequence[int], size: int):
        super().__init__()
        self.stem = _stage(cin, widths[0])
        stages, layers = [], []
        side, prev = size, widths[0]
        for s, w in enumerate(widths):
            stride = 1 if s == 0 else 2
            side //= stride
            stages.append(_stage(prev, w, stride))
            channel_token = side * side <= w
            layers.append(MambaLayer(side * side if channel_token else w, channel_token))
            prev = w
        self.stages = nn.ModuleList(stages)
        self.mamba_layers = nn.ModuleList(layers)


class _Decoder(nn.Module):
    def __init__(self, widths: Sequence[int], regions: int):
        super().__init__()
        below = list(widths[::-1])
        self.transpconvs = nn.ModuleList(nn.ConvTranspose2d(hi, lo, 2, stride=2)
                                         for hi, lo in zip(below, below[1:]))
        self.stages = nn.ModuleList(_stage(2 * lo, lo) for lo in below[1:])
        self.seg_layer = nn.Conv2d(widths[0], regions, 1)


class UMambaEnc(nn.Module):
    """Returns the seg logits (B, R, H, W) of a ``size``² input."""

    def __init__(self, in_channels: int = 1, regions: int = 1,
                 widths: Sequence[int] = WIDTHS, size: int = 128):
        super().__init__()
        self.encoder = _Encoder(in_channels, tuple(widths), size)
        self.decoder = _Decoder(tuple(widths), regions)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        enc, dec = self.encoder, self.decoder
        x = enc.stem(x)
        skips = []
        for stage, layer in zip(enc.stages, enc.mamba_layers):
            x = layer(stage(x))
            skips.append(x)
        x = skips[-1]
        for up, stage, skip in zip(dec.transpconvs, dec.stages, skips[-2::-1]):
            x = stage(torch.cat([up(x), skip], dim=1))
        return dec.seg_layer(x)
