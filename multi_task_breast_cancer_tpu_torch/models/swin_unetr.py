"""Swin-UNETR, 2-D (PyTorch), twin of
``multi_task_breast_cancer_tpu/models/swin_unetr.py``: a shifted-window
transformer encoder (patch embedding 2×, four stages of depths (2, 2, 2, 2)
and heads (3, 6, 12, 24), window 8, cyclic roll with a −1e9 shift mask) and
UNETR-style residual conv decoders over five skip levels.

The transformer stages run on channels-last tokens (B, H, W, C), as in JAX,
so window partitions, the relative-position index and PatchMerging's
(dh, dw, c) concatenation are the JAX reshapes; the conv blocks are NCHW.
Attention is plain ``torch.matmul`` and softmax (JAX computes it outside any
Pallas kernel): logits in f32, the softmax cast back to the input's dtype.
A stage whose grid is smaller than the window takes the grid as its window,
so the parameter shapes depend on the input side: the model is built for
``size`` and refuses other sides, as JAX refuses sides it cannot window.

Under a ``space`` group (:mod:`..parallel.spatial`) the token grids hold this
rank's rows. A stage whose window divides the local rows keeps its windows
local: a shifted block rolls its rows through
:func:`~..parallel.spatial.cyclic_row_shift` (its columns with
``torch.roll``) and takes its own row of windows of the whole grid's shift
mask. A stage whose window spans more rows than a rank holds gathers its
rows (:func:`~..parallel.spatial.gather_rows`), runs replicated on the whole
grid and keeps this rank's rows after its ``PatchMerging``; its grid is at
most 1/16 of the input's side. The convolutions take their halo rows
(:class:`~.blocks.Conv3x3`).

Spans (:mod:`..utils.profiling`): ``swin.attention`` (each
:class:`WindowAttention` call), ``swin.mlp`` (a block's fc1 → GELU → fc2),
``swin.merge`` (each :class:`PatchMerging`) and ``swin.decoder`` (the UNETR
conv blocks: ``encoder0``, then the other encoders, the decoders and the
head). The counter ``swin.attention_windows`` adds the window × head pairs
each :class:`WindowAttention` call attends: 720 per 128² image per forward.
A captured step counts once, at its capture; a replay runs no Python.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multi_task_breast_cancer_tpu_torch.models.blocks import (
    Conv3x3,
    InstanceNorm,
    LayerNorm,
    LecunConv2d,
    deconv,
)
from multi_task_breast_cancer_tpu_torch.parallel import spatial
from multi_task_breast_cancer_tpu_torch.utils import profiling

WINDOW = 8


def check_size(hh: int, ww: int) -> None:
    """JAX's input check: every windowed stage grid even and divisible by
    the window once at least the window."""
    stage_grids = [hh // 2 // 2 ** s for s in range(4)]
    if (hh != ww or hh % 32
            or any(g >= WINDOW and g % WINDOW for g in stage_grids)
            or any(g % 2 for g in stage_grids)):
        raise ValueError(
            f"SwinUNETR input {hh}x{ww}: every windowed stage grid "
            f"{stage_grids} must be even and window({WINDOW})-divisible "
            f"once >= the window — use a power-of-two size >= 32 or a "
            f"multiple of 256")


def _window_partition(x: torch.Tensor, win: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nH·nW, win·win, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // win, win, w // win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, win * win, c)


def _window_merge(x: torch.Tensor, win: int, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`_window_partition`."""
    b = x.shape[0] // ((h // win) * (w // win))
    x = x.reshape(b, h // win, w // win, win, win, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


@functools.lru_cache(maxsize=None)
def _relative_position_index(win: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(win), np.arange(win), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (win - 1)
    return (rel[..., 0] * (2 * win - 1) + rel[..., 1]).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _shift_attention_mask(h: int, w: int, win: int, shift: int) -> np.ndarray:
    """The Swin mask: −1e9 between cells of a window that came from
    different regions of the rolled grid. (nWindows, win², win²)."""
    img_mask = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img_mask[hs, ws] = cnt
            cnt += 1
    windows = img_mask.reshape(h // win, win, w // win, win).transpose(0, 2, 1, 3)
    windows = windows.reshape(-1, win * win)
    attn_mask = windows[:, None, :] - windows[:, :, None]
    return np.where(attn_mask != 0, -1e9, 0.0).astype(np.float32)


_CONSTANTS: dict = {}


def _on(device: torch.device, name: str, fn, *args) -> torch.Tensor:
    """A numpy constant as a tensor on ``device``, made once per device, and
    made real even when first asked for inside a trace (``torch.export``
    lifts it into the program as a constant) or under inference mode
    (autograd may save it later)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    key = (str(device), name, args)
    if key not in _CONSTANTS:
        with unset_fake_temporarily(), torch.inference_mode(False):
            _CONSTANTS[key] = torch.from_numpy(fn(*args)).to(device)
    return _CONSTANTS[key]


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, win: int = WINDOW):
        super().__init__()
        self.dim, self.num_heads, self.win = dim, num_heads, win
        self.qkv = nn.Linear(dim, 3 * dim)
        self.rel_pos_bias = nn.Parameter(torch.zeros((2 * win - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)

    @profiling.spanned("swin.attention")
    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        nw, L, _ = x.shape
        heads, head_dim = self.num_heads, self.dim // self.num_heads
        profiling.count("swin.attention_windows", nw * heads)
        qkv = self.qkv(x).reshape(nw, L, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        # f32 logits from the input's products (JAX: preferred_element_type
        # f32); f64 stays f64
        dt = torch.promote_types(x.dtype, torch.float32)
        attn = torch.matmul(q.to(dt), k.to(dt).transpose(-2, -1)) / math.sqrt(head_dim)
        idx = _on(x.device, "index", _relative_position_index, self.win)
        attn = attn + self.rel_pos_bias[idx].permute(2, 0, 1)[None]
        if mask is not None:
            attn = attn.reshape(-1, mask.shape[0], heads, L, L) + mask[None, :, None]
            attn = attn.reshape(nw, heads, L, L)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).permute(0, 2, 1, 3).reshape(nw, L, self.dim)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, shift: int = 0, mlp_ratio: float = 4.0,
                 win: int = WINDOW):
        super().__init__()
        self.shift, self.win = shift, win
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, win)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        s, win = self.shift, self.win
        space = spatial.current()
        y = self.norm1(x)
        mask = None
        if s:
            y = _roll(y, -s, space)
            if space is None:
                mask = _on(x.device, "mask", _shift_attention_mask, h, w, win, s)
            else:  # this rank's rows of windows of the whole grid's mask
                mask = _on(x.device, "mask", _shift_attention_mask, h * space.size, w, win, s)
                per = (h // win) * (w // win)
                mask = mask[space.index * per:(space.index + 1) * per]
        y = _window_merge(self.attn(_window_partition(y, win), mask), win, h, w)
        if s:
            y = _roll(y, s, space)
        x = x + y
        y = self.norm2(x)
        with profiling.span("swin.mlp"):
            y = self.mlp_fc2(F.gelu(self.mlp_fc1(y), approximate="tanh"))
        return x + y


def _roll(y: torch.Tensor, shift: int, space) -> torch.Tensor:
    """``torch.roll(y, (shift, shift), dims=(1, 2))`` of the whole (B, H, W,
    C) grid; under a ``space`` group the rows' part is a cyclic shift over
    the group."""
    if space is None:
        return torch.roll(y, (shift, shift), dims=(1, 2))
    return torch.roll(spatial.cyclic_row_shift(y, space, shift, dim=1), shift, dims=2)


class PatchMerging(nn.Module):
    """2× downsample: the 2×2 neighbourhood concatenated in (dh, dw, c)
    order (4C) → LayerNorm → Dense(out_dim), no bias."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, out_dim, bias=False)

    @profiling.spanned("swin.merge")
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        return self.reduction(self.norm(x.reshape(b, h // 2, w // 2, 4 * c)))


_CUDNN_SWITCHES = threading.Lock()  # cuDNN's switches are the process's, not a thread's


@contextlib.contextmanager
def _deterministic_cudnn() -> Iterator[None]:
    """Inside, cuDNN runs the engine its heuristics choose among its
    deterministic ones (``cudnn.deterministic`` on, ``cudnn.benchmark``
    off): the same engine in every process, where timing the engines could
    pick another in each. The switches are the process's: one thread at a
    time sets and puts them back, and a convolution another thread launches
    meanwhile runs under them too."""
    cudnn = torch.backends.cudnn
    with _CUDNN_SWITCHES:
        before = cudnn.deterministic, cudnn.benchmark
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            yield
        finally:
            cudnn.deterministic, cudnn.benchmark = before


class _DeterministicConv(torch.autograd.Function):
    """``torch.ops.aten.convolution`` (dilation 1, one group, no output
    padding) whose forward and backward both run under
    :func:`_deterministic_cudnn`. Autograd runs a backward outside the
    forward's context, so a switch set around the forward alone would
    leave the backward's weight and data gradients to cuDNN's
    nondeterministic engines (``wgrad_alg0_engine`` and others), which
    accumulate with atomics in an order that changes from run to run."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                stride: Tuple[int, int], padding: Tuple[int, int], transposed: bool
                ) -> torch.Tensor:
        ctx.save_for_backward(x, weight)
        ctx.conv = (stride, padding, transposed, None if bias is None else list(bias.shape))
        with _deterministic_cudnn():
            return torch.ops.aten.convolution(x, weight, bias, stride, padding, (1, 1),
                                              transposed, (0, 0), 1)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        x, weight = ctx.saved_tensors
        stride, padding, transposed, bias_sizes = ctx.conv
        needs = ctx.needs_input_grad
        with _deterministic_cudnn():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, bias_sizes, stride, padding, (1, 1), transposed, (0, 0), 1,
                [needs[0], needs[1], bias_sizes is not None and needs[2]])
        return gx, gw, gb, None, None, None


def _conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` for the model's convolutions and transposed
    convolutions. On a CUDA device, outside a ``space`` group and a trace,
    through :class:`_DeterministicConv`: two runs of a step on the same
    inputs give the same gradients bit for bit, in one process or two,
    while every other model keeps the engines ``cudnn.benchmark`` times for
    it. No engine is timed here, so no problem counts as measured
    (``conv.problems_measured``). Elsewhere ``conv(x)`` itself."""
    if not x.is_cuda or spatial.current() is not None or torch.compiler.is_compiling():
        return conv(x)
    return _DeterministicConv.apply(x, conv.weight, conv.bias, tuple(conv.stride),
                                    tuple(conv.padding), isinstance(conv, nn.ConvTranspose2d))


class UnetrBasicBlock(nn.Module):
    """(3×3 conv → affine InstanceNorm → LeakyReLU) twice, with a projected
    skip (1×1 conv → affine InstanceNorm) when the channels change."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv1 = Conv3x3(in_features, features)
        self.norm1 = InstanceNorm(features, affine=True)
        self.conv2 = Conv3x3(features, features)
        self.norm2 = InstanceNorm(features, affine=True)
        self.conv_skip = self.norm_skip = None
        if in_features != features:
            self.conv_skip = LecunConv2d(in_features, features, 1, bias=False)
            self.norm_skip = InstanceNorm(features, affine=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(self.norm1(_conv(self.conv1, x)), 0.01)
        y = self.norm2(_conv(self.conv2, y))
        skip = x if self.conv_skip is None else self.norm_skip(_conv(self.conv_skip, x))
        return F.leaky_relu(y + skip, 0.01)


class UnetrUpBlock(nn.Module):
    def __init__(self, in_features: int, skip_features: int, features: int):
        super().__init__()
        self.up = deconv(in_features, features, 2)
        self.up.bias = None  # JAX: use_bias=False
        self.block = UnetrBasicBlock(features + skip_features, features)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.block(torch.cat([_conv(self.up, x), skip], dim=1))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


class SwinUNETR(nn.Module):
    """2-D Swin-UNETR for ``size``² inputs: any power of two ≥ 32 (the
    reference's 128) or multiple of 256 (:func:`check_size`)."""

    name_str = "Swin UNETR"
    space_row_multiple = 32  # the patch embedding's halving and four merges

    def __init__(self, sequences: int = 1, regions: int = 1, feature_size: int = 24,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), size: int = 128):
        super().__init__()
        check_size(size, size)
        self.size = size
        f = feature_size
        dims = [f, 2 * f, 4 * f, 8 * f, 16 * f]
        self.depths = tuple(depths)
        self.encoder0 = UnetrBasicBlock(sequences, f)
        self.patch_embed = LecunConv2d(sequences, f, 2, stride=2)
        grid = size // 2
        for stage in range(4):
            win = WINDOW if grid >= WINDOW else grid
            for blk in range(self.depths[stage]):
                shift = WINDOW // 2 if blk % 2 and grid > win else 0
                setattr(self, f"stage{stage}_block{blk}",
                        SwinBlock(dims[stage], num_heads[stage], shift=shift, win=win))
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
        self.out = LecunConv2d(f, regions, 1)

    def _stage(self, stage: int, h: torch.Tensor) -> torch.Tensor:
        """Stage ``stage``'s blocks and its merge on the (B, H, W, C) grid
        ``h``. Under a ``space`` group whose shard holds fewer rows than a
        multiple of the window: on the gathered grid, replicated, then this
        rank's rows of the merged one."""
        blocks = [getattr(self, f"stage{stage}_block{b}") for b in range(self.depths[stage])]
        merge = getattr(self, f"merge{stage}")
        space = spatial.current()
        if space is not None and h.shape[1] % blocks[0].win:
            whole = spatial.gather_rows(h, space, dim=1)
            with spatial.partitioned(None):
                for block in blocks:
                    whole = block(whole)
                whole = merge(whole)
            mine = space.rows(whole.shape[1])
            return whole[:, mine]
        for block in blocks:
            h = block(h)
        return merge(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        space = spatial.current()
        rows = x.shape[2] * (space.size if space is not None else 1)
        check_size(rows, x.shape[3])
        if rows != self.size:
            raise ValueError(f"this SwinUNETR was built for {self.size}² inputs "
                             f"(its window sizes follow the side), not {rows}²")
        with profiling.span("swin.decoder"):
            enc0 = self.encoder0(x)
        h = _conv(self.patch_embed, x).permute(0, 2, 3, 1)
        hidden = [h]
        for stage in range(4):
            h = self._stage(stage, h)
            hidden.append(h)
        with profiling.span("swin.decoder"):
            enc1 = self.encoder1(_nchw(hidden[0]))
            enc2 = self.encoder2(_nchw(hidden[1]))
            enc3 = self.encoder3(_nchw(hidden[2]))
            dec4 = self.encoder10(_nchw(hidden[4]))
            d3 = self.decoder5(dec4, _nchw(hidden[3]))
            d2 = self.decoder4(d3, enc3)
            d1 = self.decoder3(d2, enc2)
            d0 = self.decoder2(d1, enc1)
            return _conv(self.out, self.decoder1(d0, enc0))
