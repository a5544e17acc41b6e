"""Exact joint geometric augmentation: random h/v flips + nearest rotation
(twin of ``multi_task_breast_cancer_tpu/data/augment.py``).

The reference applies torchvision's HFlip(p) → VFlip(p) →
RandomRotation(max_angle) (nearest, fill 0) to the ``cat([mask, image])``
stack per sample. Here the three compose into one inverse affine map per
sample and the batch is ONE gather, ``out(p) = img(F(R⁻¹ p))``, so mask and
image stay aligned. Plain PyTorch: this is the path the Engine takes when
``fast_augmentation`` is off (the ``EngineConfig`` default), not a kernel.

Draws ``(fh, fv, angle)`` are passed in (``ops.fast_augment.draw_flips_and_angles``
draws them from a ``torch.Generator``). The angle's cosine and sine are taken
on the draws' device and the coordinate arithmetic is plain f32 multiply and
add, so the card and the CPU give the same pixels for the same draws.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def rotation_cos_sin(angle_deg: torch.Tensor) -> torch.Tensor:
    """(..., 2): the f32 cosine and sine of each angle (degrees), on the
    angles' device; all the coordinates need of an angle. The Engine takes
    them on the host once an epoch, so that a step captured in a CUDA graph
    reads them from the device, with the bits the CPU gives."""
    theta = angle_deg.to(torch.float32) * (math.pi / 180.0)
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def _inverse_rotation_coords(angle_deg: torch.Tensor, h: int, w: int,
                             device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float source coordinates of the inverse rotation about the image
    centre (torchvision convention), (B, H, W) each for (B,) angles, or for
    their (B, 2) :func:`rotation_cos_sin`."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cs = (angle_deg if angle_deg.dim() == 2 else rotation_cos_sin(angle_deg)).to(device)
    cos, sin = cs[:, 0, None, None], cs[:, 1, None, None]
    yy = (torch.arange(h, dtype=torch.float32, device=device) - cy)[:, None]
    xx = (torch.arange(w, dtype=torch.float32, device=device) - cx)[None, :]
    return cos * yy + sin * xx + cy, -sin * yy + cos * xx + cx


def _round_clip_coords(ys: torch.Tensor, xs: torch.Tensor, h: int, w: int):
    """Nearest rounding (half to even) + bounds: (y_clipped, x_clipped, valid)."""
    yr = torch.round(ys).to(torch.int64)
    xr = torch.round(xs).to(torch.int64)
    valid = (yr >= 0) & (yr < h) & (xr >= 0) & (xr < w)
    return yr.clamp(0, h - 1), xr.clamp(0, w - 1), valid


def rotate_nearest(img: torch.Tensor, angle_deg) -> torch.Tensor:
    """Rotate (H, W, C) by ``angle_deg`` about the image centre, nearest
    interpolation, zero fill (torchvision ``rotate``, expand=False)."""
    h, w = img.shape[0], img.shape[1]
    angle = torch.as_tensor(angle_deg, dtype=torch.float32).reshape(1)
    ys, xs = _inverse_rotation_coords(angle, h, w, img.device)
    yc, xc, valid = _round_clip_coords(ys[0], xs[0], h, w)
    out = img[yc, xc, :]
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def joint_coords(fh: torch.Tensor, fv: torch.Tensor, angle: torch.Tensor, h: int,
                 w: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample inverse map of hflip → vflip → rotate: (flat index (B, H·W)
    int64, valid (B, H, W)) on ``device``; ``angle`` (B,) degrees or their
    (B, 2) :func:`rotation_cos_sin`."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys, xs = _inverse_rotation_coords(angle, h, w, device)
    # flip about the centre in source space: q' = s·q + (1-s)·(S-1)/2
    sy = torch.where(fv, -1.0, 1.0).to(device)[:, None, None]
    sx = torch.where(fh, -1.0, 1.0).to(device)[:, None, None]
    ys = sy * ys + (1.0 - sy) * cy
    xs = sx * xs + (1.0 - sx) * cx
    yc, xc, valid = _round_clip_coords(ys, xs, h, w)
    return (yc * w + xc).reshape(-1, h * w), valid


def joint_transform_stack_batch(stack: torch.Tensor, fh: torch.Tensor,
                                fv: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Joint transform of a (B, C, H, W) stack (NCHW; channel 0 the mask), each
    sample with its own ``(fh, fv, angle)`` (``angle`` as :func:`joint_coords`
    takes it), as one gather over the batch."""
    b, c, h, w = stack.shape
    idx, valid = joint_coords(fh, fv, angle, h, w, stack.device)
    out = stack.reshape(b, c, h * w).gather(2, idx[:, None, :].expand(b, c, h * w))
    out = out.reshape(b, c, h, w)
    return torch.where(valid[:, None], out, torch.zeros_like(out))
