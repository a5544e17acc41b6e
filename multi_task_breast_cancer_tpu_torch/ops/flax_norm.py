"""flax's normalisation arithmetic in plain PyTorch, shared by the port's
BatchNorm, GroupNorm and LayerNorm (:mod:`..models.blocks`) and by the
LayerNorm kernels' plain twin (:mod:`.layer_norm`): statistics at least in
f32 (``force_float32_reductions``), the fast variance ``E[x²] − E[x]²``
(``use_fast_variance``) and ``_normalize``."""

from __future__ import annotations

import torch


def stats_dtype(x: torch.Tensor) -> torch.dtype:
    """flax's ``force_float32_reductions``: at least f32 (f64 stays f64)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def fast_moments(xf: torch.Tensor, dims) -> tuple:
    """E[x] and the fast variance E[x²] − E[x]² before its clamp (negative
    where rounding makes it so), kept dims, of ``xf`` (in
    :func:`stats_dtype`)."""
    mean = xf.mean(dim=dims, keepdim=True)
    return mean, (xf * xf).mean(dim=dims, keepdim=True) - mean * mean


def fast_stats(xf: torch.Tensor, dims) -> tuple:
    """flax's ``use_fast_variance`` statistics: :func:`fast_moments` with
    the variance clipped at 0."""
    mean, var = fast_moments(xf, dims)
    return mean, var.clamp(min=0.0)


def f32_normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                  scale: torch.Tensor, bias: torch.Tensor, eps: float,
                  channels_last: bool = False) -> torch.Tensor:
    """flax ``_normalize``: ``(x − mean)·(rsqrt(var + eps)·scale) + bias`` in
    f32, cast back to ``x``'s dtype. ``mean``/``var`` broadcast against
    ``x``; ``scale``/``bias`` are per channel of NCHW ``x`` or, with
    ``channels_last``, of its last axis."""
    shape = (-1,) if channels_last else (-1, 1, 1)
    dt = stats_dtype(x)
    mul = torch.rsqrt(var + eps) * scale.to(dt).reshape(shape)
    return ((x.to(dt) - mean) * mul + bias.to(dt).reshape(shape)).to(x.dtype)
