"""Plain PyTorch references of the benchmark's two models, written from their
published descriptions, in float32 with no kernel of the port, no CUDA graph
and no fusion. They import nothing of the port; their parameter names are
the port's, so that one seeded state dict loads into both.

- :class:`MTnnUNet`: the multi-task nnU-Net of Aumente-Maestro et al.
  (github.com/caumente/multi_task_breast_cancer, ``nnUNet.py``): five levels
  of two (3×3 conv, no bias → InstanceNorm → LeakyReLU 0.01) blocks, widths
  (32, 64, 128, 256, 320), a bottleneck, transposed-conv upsampling, four
  deep-supervision heads (a transposed conv of kernel = stride, then a 1×1
  conv; coarse to fine) and a classification head over
  cat(conv(e5), up5, conv(d5)) → conv block (512) → global mean → MLP(256).
- :class:`SwinUNETR`: the 2-D Swin-UNETR of Hatamizadeh et al. 2022
  (arXiv:2201.01266) as MONAI builds it: a 2× patch embedding, four stages
  of shifted-window attention (window 8, cyclic shift 4 on odd blocks where
  the grid exceeds the window, −1e9 across rolled regions, a learned
  relative-position bias), patch merging, and UNETR residual conv blocks
  (affine InstanceNorm) as decoders over five skips.

Departures from the published code, each an exact identity or a convention
the configuration states: LayerNorm is flax's (eps 1e-6, the variance as
E[x²] − E[x]²), which the repository's models are specified by; the
activations are NCHW except inside the transformer stages, which run on
(B, H, W, C) tokens.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NNUNET_WIDTHS = (32, 64, 128, 256, 320)


def instance_norm(y: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel normalisation over H and W, biased variance."""
    mean = y.mean(dim=(2, 3), keepdim=True)
    centered = y - mean
    var = (centered * centered).mean(dim=(2, 3), keepdim=True)
    return centered / torch.sqrt(var + eps)


class ConvNormAct(nn.Module):
    """3×3 conv (no bias) → InstanceNorm → LeakyReLU(0.01): one fused-norm
    site of the port. ``site`` records the conv output's (C, H, W) when a
    list is set on the class (the benchmark's byte counters read it)."""

    sites = None

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if ConvNormAct.sites is not None:
            ConvNormAct.sites.append(tuple(y.shape[1:]))
        return F.leaky_relu(instance_norm(y), 0.01)


class Level(nn.Module):
    def __init__(self, cin: int, mid: int, cout: int):
        super().__init__()
        self.block1 = ConvNormAct(cin, mid)
        self.block2 = ConvNormAct(mid, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block2(self.block1(x))


class DeconvHead(nn.Module):
    """Transposed conv (kernel = stride = k, C → C) then a 1×1 conv (C → R).
    ``fused`` computes the same map as one transposed conv whose kernel is
    the product of the two (the form the repository runs; used to count
    the model's operations)."""

    fused = False

    def __init__(self, c: int, regions: int, k: int):
        super().__init__()
        self.k = k
        self.deconv_kernel = nn.Parameter(torch.empty(c, c, k, k))
        self.deconv_bias = nn.Parameter(torch.zeros(c))
        self.conv1x1_kernel = nn.Parameter(torch.empty(regions, c, 1, 1))
        self.conv1x1_bias = nn.Parameter(torch.zeros(regions))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if DeconvHead.fused:
            w1 = self.conv1x1_kernel[:, :, 0, 0]
            w = torch.einsum("icab,rc->irab", self.deconv_kernel, w1)
            return F.conv_transpose2d(x, w, w1 @ self.deconv_bias + self.conv1x1_bias,
                                      stride=self.k)
        y = F.conv_transpose2d(x, self.deconv_kernel, self.deconv_bias, stride=self.k)
        return F.conv2d(y, self.conv1x1_kernel, self.conv1x1_bias)


class Backbone(nn.Module):
    def __init__(self, cin: int, w: Sequence[int]):
        super().__init__()
        self.encoder1 = Level(cin, w[0], w[0])
        self.encoder2 = Level(w[0], w[1], w[1])
        self.encoder3 = Level(w[1], w[2], w[2])
        self.encoder4 = Level(w[2], w[3], w[3])
        self.encoder5 = Level(w[3], w[4], w[4])
        self.bottleneck = Level(w[4], w[4], w[4])
        self.upsample5 = nn.ConvTranspose2d(w[4], w[4], 2, stride=2)
        self.decoder5 = Level(2 * w[4], w[3], w[3])
        self.upsample4 = nn.ConvTranspose2d(w[3], w[3], 2, stride=2)
        self.decoder4 = Level(2 * w[3], w[2], w[2])
        self.upsample3 = nn.ConvTranspose2d(w[2], w[2], 2, stride=2)
        self.decoder3 = Level(2 * w[2], w[1], w[1])
        self.upsample2 = nn.ConvTranspose2d(w[1], w[1], 2, stride=2)
        self.decoder2 = Level(2 * w[1], w[0], w[0])
        self.upsample1 = nn.ConvTranspose2d(w[0], w[0], 2, stride=2)
        self.decoder1 = Level(2 * w[0], w[0], w[0] // 2)


class Heads(nn.Module):
    def __init__(self, regions: int, w: Sequence[int]):
        super().__init__()
        self.output4 = DeconvHead(w[2], regions, 8)
        self.output3 = DeconvHead(w[1], regions, 4)
        self.output2 = DeconvHead(w[0], regions, 2)
        self.output1 = nn.Conv2d(w[0] // 2, regions, 1)


class ClsHead(nn.Module):
    def __init__(self, n_out: int, w: Sequence[int]):
        super().__init__()
        self.process_encoder_5 = ConvNormAct(w[4], w[4])
        self.process_decoder_5 = ConvNormAct(w[3], w[4])
        self.cls_conv = ConvNormAct(3 * w[4], 512)
        self.fc1 = nn.Linear(512, 256)
        self.fc2 = nn.Linear(256, n_out)


class MTnnUNet(nn.Module):
    """Returns (class logits (B, n_out), [seg logits (B, R, H, W) of the four
    heads, coarse to fine])."""

    def __init__(self, in_channels: int = 1, regions: int = 1, n_classes: int = 3,
                 widths: Sequence[int] = NNUNET_WIDTHS):
        super().__init__()
        w = tuple(widths)
        self.backbone = Backbone(in_channels, w)
        self.heads = Heads(regions, w)
        self.cls_head = ClsHead(1 if n_classes == 2 else n_classes, w)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        b = self.backbone
        pool = lambda t: F.max_pool2d(t, 2)  # noqa: E731
        e1 = b.encoder1(x)
        e2 = b.encoder2(pool(e1))
        e3 = b.encoder3(pool(e2))
        e4 = b.encoder4(pool(e3))
        e5 = b.encoder5(pool(e4))
        bottom = b.bottleneck(pool(e5))
        up5 = b.upsample5(bottom)
        d5 = b.decoder5(torch.cat([e5, up5], dim=1))
        d4 = b.decoder4(torch.cat([e4, b.upsample4(d5)], dim=1))
        d3 = b.decoder3(torch.cat([e3, b.upsample3(d4)], dim=1))
        d2 = b.decoder2(torch.cat([e2, b.upsample2(d3)], dim=1))
        d1 = b.decoder1(torch.cat([e1, b.upsample1(d2)], dim=1))
        h = self.heads
        seg = [h.output4(d4), h.output3(d3), h.output2(d2), h.output1(d1)]
        c = self.cls_head
        feats = torch.cat([c.process_encoder_5(e5), up5, c.process_decoder_5(d5)], dim=1)
        pooled = c.cls_conv(feats).mean(dim=(2, 3))
        return c.fc2(F.relu(c.fc1(pooled))), seg


# ---------------------------------------------------------------------------
# SwinUNETR
# ---------------------------------------------------------------------------

WINDOW = 8


class AffineInstanceNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return instance_norm(y) * self.scale[:, None, None] + self.bias[:, None, None]


class LayerNorm(nn.Module):
    """flax's LayerNorm over the last axis: eps 1e-6 and its variance
    E[x²] − E[x]² (clipped at 0), the configuration's statement of the norm."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp(min=0.0)
        return (x - mean) * torch.rsqrt(var + 1e-6) * self.scale + self.bias


class UnetrBasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.norm1 = AffineInstanceNorm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.norm2 = AffineInstanceNorm(cout)
        self.conv_skip = self.norm_skip = None
        if cin != cout:
            self.conv_skip = nn.Conv2d(cin, cout, 1, bias=False)
            self.norm_skip = AffineInstanceNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(self.norm1(self.conv1(x)), 0.01)
        y = self.norm2(self.conv2(y))
        skip = x if self.conv_skip is None else self.norm_skip(self.conv_skip(x))
        return F.leaky_relu(y + skip, 0.01)


class UnetrUpBlock(nn.Module):
    def __init__(self, cin: int, skip: int, cout: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(cin, cout, 2, stride=2, bias=False)
        self.block = UnetrBasicBlock(cout + skip, cout)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.block(torch.cat([self.up(x), skip], dim=1))


def relative_position_index(win: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(win), torch.arange(win), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0) + (win - 1)
    return rel[..., 0] * (2 * win - 1) + rel[..., 1]


def shift_mask(h: int, w: int, win: int, shift: int) -> torch.Tensor:
    """(windows, win², win²): −1e9 between cells that came from different
    regions of the rolled grid, 0 elsewhere."""
    region = np.zeros((h, w), np.float32)
    label = 0
    for rows in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for cols in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            region[rows, cols] = label
            label += 1
    cells = torch.from_numpy(region).reshape(h // win, win, w // win, win)
    cells = cells.permute(0, 2, 1, 3).reshape(-1, win * win)
    return torch.where(cells[:, None, :] != cells[:, :, None], -1e9, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, win: int):
        super().__init__()
        self.dim, self.heads, self.win = dim, heads, win
        self.qkv = nn.Linear(dim, 3 * dim)
        self.rel_pos_bias = nn.Parameter(torch.zeros((2 * win - 1) ** 2, heads))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        nw, n, _ = x.shape
        hd = self.dim // self.heads
        q, k, v = self.qkv(x).reshape(nw, n, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        logits = q @ k.transpose(-2, -1) / math.sqrt(hd)
        idx = relative_position_index(self.win).to(x.device)
        logits = logits + self.rel_pos_bias[idx].permute(2, 0, 1)[None]
        if mask is not None:
            logits = (logits.reshape(-1, mask.shape[0], self.heads, n, n)
                      + mask[None, :, None]).reshape(nw, self.heads, n, n)
        out = torch.softmax(logits, dim=-1) @ v
        return self.proj(out.permute(0, 2, 1, 3).reshape(nw, n, self.dim))


def windows(x: torch.Tensor, win: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h // win, win, w // win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, win * win, c)


def unwindows(x: torch.Tensor, win: int, h: int, w: int) -> torch.Tensor:
    b = x.shape[0] // ((h // win) * (w // win))
    x = x.reshape(b, h // win, w // win, win, win, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, shift: int, win: int):
        super().__init__()
        self.shift, self.win = shift, win
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, win)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = nn.Linear(dim, 4 * dim)
        self.mlp_fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        s, win = self.shift, self.win
        y = self.norm1(x)
        mask = None
        if s:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
            mask = shift_mask(h, w, win, s).to(x.device)
        y = unwindows(self.attn(windows(y, win), mask), win, h, w)
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + y
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)), approximate="tanh"))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, out_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        return self.reduction(self.norm(x.reshape(b, h // 2, w // 2, 4 * c)))


class SwinUNETR(nn.Module):
    """Returns the seg logits (B, R, H, W) of a ``size``² input."""

    def __init__(self, in_channels: int = 1, regions: int = 1, feature_size: int = 24,
                 depths: Sequence[int] = (2, 2, 2, 2), heads: Sequence[int] = (3, 6, 12, 24),
                 size: int = 128):
        super().__init__()
        f = feature_size
        dims = [f, 2 * f, 4 * f, 8 * f, 16 * f]
        self.depths = tuple(depths)
        self.encoder0 = UnetrBasicBlock(in_channels, f)
        self.patch_embed = nn.Conv2d(in_channels, f, 2, stride=2)
        grid = size // 2
        for stage in range(4):
            win = WINDOW if grid >= WINDOW else grid
            for blk in range(self.depths[stage]):
                shift = WINDOW // 2 if blk % 2 and grid > win else 0
                setattr(self, f"stage{stage}_block{blk}",
                        SwinBlock(dims[stage], heads[stage], shift, win))
            setattr(self, f"merge{stage}", PatchMerging(dims[stage], dims[stage + 1]))
            grid //= 2
        self.encoder1 = UnetrBasicBlock(f, f)
        self.encoder2 = UnetrBasicBlock(2 * f, 2 * f)
        self.encoder3 = UnetrBasicBlock(4 * f, 4 * f)
        self.encoder10 = UnetrBasicBlock(16 * f, 16 * f)
        self.decoder5 = UnetrUpBlock(16 * f, 8 * f, 8 * f)
        self.decoder4 = UnetrUpBlock(8 * f, 4 * f, 4 * f)
        self.decoder3 = UnetrUpBlock(4 * f, 2 * f, 2 * f)
        self.decoder2 = UnetrUpBlock(2 * f, f, f)
        self.decoder1 = UnetrUpBlock(f, f, f)
        self.out = nn.Conv2d(f, regions, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
        enc0 = self.encoder0(x)
        h = self.patch_embed(x).permute(0, 2, 3, 1)
        hidden = [h]
        for stage in range(4):
            for blk in range(self.depths[stage]):
                h = getattr(self, f"stage{stage}_block{blk}")(h)
            h = getattr(self, f"merge{stage}")(h)
            hidden.append(h)
        enc1 = self.encoder1(nchw(hidden[0]))
        enc2 = self.encoder2(nchw(hidden[1]))
        enc3 = self.encoder3(nchw(hidden[2]))
        dec4 = self.encoder10(nchw(hidden[4]))
        d3 = self.decoder5(dec4, nchw(hidden[3]))
        d2 = self.decoder4(d3, enc3)
        d1 = self.decoder3(d2, enc2)
        d0 = self.decoder2(d1, enc1)
        return self.out(self.decoder1(d0, enc0))


MODELS = {"MTnnUNet": MTnnUNet, "SwinUNETR": SwinUNETR}


def build(name: str, **kwargs) -> nn.Module:
    """The reference model ``name`` with the configuration's arguments."""
    return MODELS[name](**kwargs)
