"""Plain references of one training step: the augmentation of a batch from
its draws, the deep-supervised losses, autograd and Adam, in float32.

The augmentation is the repository's fast path (joint flips, then a
rotation by three shears, each shear resampled to the nearest pixel), its
integer arithmetic written out again here from the draws: a flip and a
quadrant rotation fold into each shear's gather, and three row gathers with
transposes between them give the augmented planes, zero outside the plane.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# draws and the augmentation
# ---------------------------------------------------------------------------

def draws(generator: torch.Generator, steps: int, batch: int, p_hflip: float = 0.5,
          p_vflip: float = 0.5, max_angle: float = 360.0):
    """Each step's (hflip, vflip, angle) per sample from ``generator``: three
    uniforms per sample, (steps, batch) each."""
    u = torch.rand(steps, batch, 3, generator=generator)
    return u[..., 0] < p_hflip, u[..., 1] < p_vflip, (2.0 * u[..., 2] - 1.0) * max_angle


def _gather_indices(fh: torch.Tensor, fv: torch.Tensor, angle: torch.Tensor, w: int):
    """The three stages' gather indices (B, 3, W, W) and whether the last
    transpose applies (B,): flips before the shears, quadrants after."""
    angle = angle.to(torch.float32)
    mid = (w - 1) / 2.0
    ang = torch.remainder(angle + 180.0, 360.0) - 180.0
    quadrants = torch.round(ang / 90.0)
    phi = ang - 90.0 * quadrants
    q = torch.remainder(quadrants.to(torch.int32), 4)
    y = torch.arange(w, dtype=torch.float32) - mid
    shear_a = -torch.round(torch.tan(torch.deg2rad(phi) / 2.0)[:, None] * y).to(torch.int32)
    shear_b = -torch.round(-torch.sin(torch.deg2rad(phi))[:, None] * y).to(torch.int32)
    b = angle.shape[0]
    slope = torch.ones(b, 3, dtype=torch.int32)
    offset = torch.zeros(b, 3, dtype=torch.int32)
    shift = torch.stack([shear_a, shear_b, shear_a], dim=1)  # (B, 3, W)

    def reflect_input(k, cond):  # x → w−1−x on the stage's input
        slope[:, k] = torch.where(cond, -slope[:, k], slope[:, k])
        offset[:, k] = torch.where(cond, w - 1 - offset[:, k], offset[:, k])
        shift[:, k] = torch.where(cond[:, None], -shift[:, k], shift[:, k])

    def reflect_output(k, cond):  # the stage's output read from w−1−x
        offset[:, k] = torch.where(cond, offset[:, k] + slope[:, k] * (w - 1), offset[:, k])
        slope[:, k] = torch.where(cond, -slope[:, k], slope[:, k])

    def reverse_rows(k, cond):
        shift[:, k] = torch.where(cond[:, None], shift[:, k].flip(-1), shift[:, k])

    reflect_input(0, fh)
    reverse_rows(0, fv)
    reflect_input(1, fv)
    reflect_output(2, q >= 1)
    reverse_rows(2, q >= 2)
    reflect_output(1, q >= 2)
    reflect_output(2, q >= 3)
    x = torch.arange(w, dtype=torch.int32)
    idx = slope[..., None, None] * x + offset[..., None, None] + shift[..., None]
    return idx, torch.remainder(q, 2) > 0


def _gather(planes: torch.Tensor, idx: torch.Tensor, w: int) -> torch.Tensor:
    inside = (idx >= 0) & (idx < w)
    out = torch.gather(planes, -1, idx.clamp(0, w - 1).long())
    return torch.where(inside, out, torch.zeros_like(out))


def augment(planes: torch.Tensor, fh, fv, angle) -> torch.Tensor:
    """(B, C, W, W) planes flipped and rotated with one sample's draws each,
    every channel of a sample alike."""
    w = planes.shape[-1]
    idx, transpose = _gather_indices(fh.cpu(), fv.cpu(), angle.cpu(), w)
    idx = idx.to(planes.device)[:, :, None]  # (B, 3, 1, W, W): every channel alike
    x = _gather(planes, idx[:, 0].expand_as(planes), w).transpose(-1, -2)
    x = _gather(x, idx[:, 1].expand_as(planes), w).transpose(-1, -2)
    x = _gather(x, idx[:, 2].expand_as(planes), w)
    return torch.where(transpose.to(planes.device)[:, None, None, None],
                       x.transpose(-1, -2), x)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def dice(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MONAI DiceLoss(sigmoid, squared_pred, smooth 1/1), mean over (B, C)."""
    p = torch.sigmoid(logits)
    inter = (p * target).sum(dim=(2, 3))
    denom = (target * target).sum(dim=(2, 3)) + (p * p).sum(dim=(2, 3))
    return (1.0 - (2.0 * inter + 1.0) / (denom + 1.0)).mean()


def deep_supervised_dice(heads: Sequence[torch.Tensor], target: torch.Tensor) -> torch.Tensor:
    """Heads given coarse to fine; the finest weighs 1, the j-th finest 1/(j+1)."""
    return sum(dice(h, target) / (j + 1) for j, h in enumerate(reversed(list(heads))))


def focal(logits: torch.Tensor, onehot: torch.Tensor, gamma: float = 2.0) -> torch.Tensor:
    """The paper's focal loss: ce, pt = exp(−ce), mean((1 − pt)^γ · ce)."""
    ce = -(onehot * F.log_softmax(logits, dim=-1)).sum(dim=-1)
    return ((1.0 - torch.exp(-ce)) ** gamma * ce).mean()


def loss(task: str, out, masks: torch.Tensor, labels: torch.Tensor, n_classes: int,
         alpha: float) -> torch.Tensor:
    """The cell's training loss: multitask α·DICE + (1 − α)·Focal, or the
    segmentation model's DICE."""
    if task == "segmentation":
        return dice(out, masks)
    cls, seg = out
    onehot = F.one_hot(labels.long(), n_classes).to(cls.dtype)
    return alpha * deep_supervised_dice(seg, masks) + (1 - alpha) * focal(cls, onehot)


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------

class Adam:
    """Adam (Kingma & Ba) with ε added to √v̂, as optax and torch do."""

    def __init__(self, params: List[torch.Tensor], lr: float, eps: float,
                 betas: Tuple[float, float] = (0.9, 0.999)):
        self.params, self.lr, self.eps, self.betas = params, lr, eps, betas
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = m / (1 - b1 ** self.t)
            v_hat = v / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))


def leaf_norms(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The float64 norm of each tensor."""
    return torch.stack([t.detach().double().norm() for t in tensors]).cpu()


def _leaf_gaps(program: torch.Tensor, reference: torch.Tensor,
               keep: torch.Tensor = None) -> torch.Tensor:
    """Each leaf's gap between the program's and the reference's norm, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger; over the leaves ``keep`` marks."""
    if keep is None:
        keep = torch.ones_like(reference, dtype=torch.bool)
    ref, prog = reference[keep], program[keep]
    return (prog - ref).abs() / torch.clamp(ref, min=float(ref.median()))


def worst_leaf_gap(program: torch.Tensor, reference: torch.Tensor,
                   keep: torch.Tensor = None) -> float:
    return float(_leaf_gaps(program, reference, keep).max())


def median_leaf_gap(program: torch.Tensor, reference: torch.Tensor,
                    keep: torch.Tensor = None) -> float:
    return float(_leaf_gaps(program, reference, keep).median())


def step_loss_gap(program: Sequence[float], reference: Sequence[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-12) for p, r in zip(program, reference))


def cuda_f32(enabled_tf32: bool = False) -> None:
    """Float32 matmuls and convolutions in float32 (``enabled_tf32`` False)
    or TF32 (the control's precision)."""
    torch.backends.cuda.matmul.allow_tf32 = enabled_tf32
    torch.backends.cudnn.allow_tf32 = enabled_tf32
