"""The Dice loss with a hand-written backward (twin of
``multi_task_breast_cancer_tpu/ops/fused_loss.py``), the Engine's DICE
criterion.

Autograd of :func:`..losses.dice_loss` keeps the sigmoid activations and
three per-plane reductions for the backward; this ``torch.autograd.Function``
saves the logits, the target and two scalars per (batch, channel) plane, and
evaluates the analytic gradient in one elementwise pass:

    ∂L/∂p_i = −[2·g_i·(D + s_dr) − (2·I + s_nr)·2·p_i·sq] / (D + s_dr)²
    ∂L/∂x_i = ∂L/∂p_i · p_i(1 − p_i)                    (sigmoid chain)

(``sq`` = 1 for squared_pred), recomputing ``p`` from the logits. Plain
PyTorch, not a kernel: it is not a Pallas kernel on the JAX side either.
NCHW in, scalar (mean over B, C) out.

Under a ``space`` group (:mod:`..parallel.spatial`) the logits and target
hold this rank's rows: the plane sums are summed over the group before the
ratio (so the loss is the whole image's, alike on every rank), and the
backward sums the ranks' upstream gradients first, the adjoint of that sum.
"""

from __future__ import annotations

import torch

from multi_task_breast_cancer_tpu_torch.parallel import spatial

_SPATIAL = (2, 3)


def _plane_stats(p: torch.Tensor, target: torch.Tensor, squared_pred: bool):
    intersection = (p * target).sum(dim=_SPATIAL)
    if squared_pred:
        denominator = (target * target).sum(dim=_SPATIAL) + (p * p).sum(dim=_SPATIAL)
    else:
        denominator = target.sum(dim=_SPATIAL) + p.sum(dim=_SPATIAL)
    return intersection, denominator


class _FusedDice(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, target, smooth_nr: float, smooth_dr: float,
                squared_pred: bool, space=None):
        p = torch.sigmoid(logits)
        intersection, denominator = _plane_stats(p, target, squared_pred)
        if space is not None:
            intersection, denominator = space.sum_partials(
                torch.stack([intersection, denominator])).unbind(0)
        ctx.space = space
        f = 1.0 - (2.0 * intersection + smooth_nr) / (denominator + smooth_dr)
        ctx.save_for_backward(logits, target, intersection, denominator)
        ctx.smooth = (smooth_nr, smooth_dr, squared_pred)
        return f.mean()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        logits, target, intersection, denominator = ctx.saved_tensors
        smooth_nr, smooth_dr, squared_pred = ctx.smooth
        if ctx.space is not None:
            g = ctx.space.sum_partials(g)
        p = torch.sigmoid(logits)
        n_planes = intersection.numel()
        denom = (denominator + smooth_dr)[:, :, None, None]
        numer = (2.0 * intersection + smooth_nr)[:, :, None, None]
        dlogits = dtarget = None
        if ctx.needs_input_grad[0]:
            dp_sq = 2.0 * p if squared_pred else 1.0
            dldp = -(2.0 * target * denom - numer * dp_sq) / (denom * denom)
            dlogits = (g * dldp * p * (1.0 - p) / n_planes).to(logits.dtype)
        if ctx.needs_input_grad[1]:
            # soft or learnable targets get their gradient too
            dt_sq = 2.0 * target if squared_pred else 1.0
            dldt = -(2.0 * p * denom - numer * dt_sq) / (denom * denom)
            dtarget = (g * dldt / n_planes).to(target.dtype)
        return dlogits, dtarget, None, None, None, None


def fused_dice_loss(logits: torch.Tensor, target: torch.Tensor, smooth_nr: float = 1.0,
                    smooth_dr: float = 1.0, squared_pred: bool = True) -> torch.Tensor:
    """MONAI ``DiceLoss(sigmoid=True, smooth_nr/dr, squared_pred)`` with the
    analytic single-pass backward; over the whole image under a ``space``
    group."""
    space = spatial.current() if logits.shape[0] else None
    return _FusedDice.apply(logits, target, smooth_nr, smooth_dr, squared_pred, space)


def fused_dice_criterion(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Drop-in for the default 'DICE' criterion (smooth 1/1, squared_pred)."""
    return fused_dice_loss(logits, target, 1.0, 1.0, True)
