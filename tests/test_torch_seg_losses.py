"""The port's segmentation criteria against the JAX package's.

Every name of ``SEG_CRITERIA`` through both factories, on the same numpy
logits and masks (NHWC for JAX, NCHW for the port), f32 on the CPU: losses
to 1e-5 relative, gradients with respect to the logits to 1e-5 of their
scale, on a batch with a lesion, an empty mask ('normal' images) and an
all-ones mask. The Hausdorff distance fields must be equal exactly: both
sides take the same integer column distances and the same f32 row minima.
The Engine takes the fused Dice for ``DICE`` and the factory's function for
every other name, as the JAX Engine does.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu.ops import losses as JL
from multi_task_breast_cancer_tpu_torch.ops import losses as L
from multi_task_breast_cancer_tpu_torch.ops.fused_loss import fused_dice_criterion
from multi_task_breast_cancer_tpu_torch.train.loop import Engine, EngineConfig
from test_torch_driver import one_torch_thread  # noqa: F401  (a fixture)

TOL = 1e-5
SIZE = 32


def _batch(seed: int = 0):
    """Logits (4, 32, 32, 2) NHWC and masks: a blob, an empty mask, an
    all-ones mask and scattered pixels, on two channels."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((4, SIZE, SIZE, 2)) * 3).astype(np.float32)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    masks = np.zeros_like(logits)
    masks[0, ..., 0] = (yy - 12) ** 2 + (xx - 20) ** 2 <= 36
    masks[2] = 1.0
    masks[3] = rng.random((SIZE, SIZE, 2)) > 0.8
    masks[0, ..., 1] = masks[3, ..., 0]
    return logits, masks


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("mask_case", ["lesion", "empty", "all_ones", "scattered"])
def test_distance_fields_equal_jax_exactly(mask_case):
    """``edt_field`` equals JAX's bit for bit: zero on an empty mask, the
    diagonal clamp on the all-nonzero half of an all-ones mask."""
    _, masks = _batch()
    m = masks[{"lesion": 0, "empty": 1, "all_ones": 2, "scattered": 3}[mask_case]][None]
    want = np.asarray(JL.edt_field(jnp.asarray(m))).transpose(0, 3, 1, 2)
    got = L.edt_field(_nchw(m)).numpy()
    np.testing.assert_array_equal(got, want)
    if mask_case == "empty":
        assert not got.any()
    if mask_case == "all_ones":  # edt(m) clamped to the diagonal, edt(~m) zero
        np.testing.assert_array_equal(got, np.sqrt(np.float32(2 * SIZE * SIZE)))


def test_distance_field_chunks_agree():
    """The row pass in chunks of output columns equals it in one piece."""
    _, masks = _batch(1)
    m = _nchw(masks) > 0.5
    whole = L._edt_binary(m)
    block = L._EDT_BLOCK
    try:
        L._EDT_BLOCK = m.numel() * 3  # three columns a chunk
        torch.testing.assert_close(L._edt_binary(m), whole, rtol=0, atol=0)
    finally:
        L._EDT_BLOCK = block


@pytest.mark.parametrize("name", L.SEG_CRITERIA)
def test_criterion_matches_jax(name):
    """Loss and its gradient on the logits, port against JAX."""
    logits, masks = _batch()
    jfn = JL.init_criterion_segmentation(name)
    jloss, jgrad = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(masks)))(jnp.asarray(logits))
    x = _nchw(logits).requires_grad_(True)
    loss = L.init_criterion_segmentation(name)(x, _nchw(masks))
    loss.backward()
    assert np.isfinite(loss.item())
    assert abs(loss.item() - float(jloss)) <= TOL * abs(float(jloss))
    want = np.asarray(jgrad).transpose(0, 3, 1, 2)
    assert np.abs(x.grad.numpy() - want).max() <= TOL * np.abs(want).max()


def test_hausdorff_fields_carry_no_gradient():
    """The distance fields are constants: the gradient is that of
    ``mean((σ(x) − g)²·d)`` with ``d`` held fixed."""
    logits, masks = _batch(2)
    x = _nchw(logits).requires_grad_(True)
    g = _nchw(masks)
    L.hausdorff_dt_loss(x, g).backward()
    p = torch.sigmoid(x.detach())
    d = L.edt_field(p) ** 2 + L.edt_field(g) ** 2
    want = 2 * (p - g) * d * p * (1 - p) / p.numel()
    torch.testing.assert_close(x.grad, want, rtol=1e-5, atol=1e-7 * want.abs().max().item())


def test_unknown_criterion_raises():
    with pytest.raises(ValueError, match="Select a loss function"):
        L.init_criterion_segmentation("Tversky")


@pytest.mark.parametrize("name", L.SEG_CRITERIA)
def test_engine_takes_the_factory_but_for_dice(name):
    """The Engine's segmentation criterion: the fused Dice for ``DICE``, the
    factory's function otherwise, as the JAX Engine picks it."""
    from multi_task_breast_cancer_tpu.train import loop as JLoop
    from multi_task_breast_cancer_tpu.train.optim import init_optimizer

    from multi_task_breast_cancer_tpu_torch.models.blocks import conv1x1

    cfg = dict(task="segmentation", seg_criterion=name, use_transforms=False)
    engine = Engine(conv1x1(1, 1), EngineConfig(**cfg), device="cpu")
    jengine = JLoop.Engine(None, init_optimizer("Adam", 1e-4), JLoop.EngineConfig(**cfg))
    if name == "DICE":
        assert engine._seg_crit is fused_dice_criterion
        assert jengine._seg_crit.__name__ == "fused_dice_criterion"
        return
    logits, masks = _batch(3)
    got = float(engine._seg_crit(_nchw(logits), _nchw(masks)))
    want = float(jengine._seg_crit(jnp.asarray(logits), jnp.asarray(masks)))
    assert abs(got - want) <= TOL * abs(want)
