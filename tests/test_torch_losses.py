"""Losses, the fused Dice and the device metrics of the port against the JAX
package, on the same numpy inputs (NHWC on the JAX side, NCHW in the port).

Tolerances: values 1e-6 absolute (f32, the same formulas summed in another
order); the fused Dice's analytic gradient 1e-6 against both JAX's custom
VJP and torch autograd of the plain Dice; metrics exactly (counts) or 1e-6.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu_torch.ops import fused_loss as FL
from multi_task_breast_cancer_tpu_torch.ops import losses as L
from multi_task_breast_cancer_tpu_torch.ops import metrics as M

TOL = 1e-6


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _seg(seed, shape=(3, 16, 16, 2), empty_sample=True):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(shape) * 3).astype(np.float32)
    target = (rng.random(shape) > 0.7).astype(np.float32)
    if empty_sample:
        target[0] = 0.0  # a 'normal' image: empty mask
    return logits, target


@pytest.mark.parametrize("kw", [
    {},
    {"squared_pred": False, "smooth_nr": 1e-5, "smooth_dr": 1e-5},
    {"jaccard": True, "squared_pred": False, "reduction": "sum"},
])
def test_dice_loss_matches_jax(kw):
    import jax.numpy as jnp

    from multi_task_breast_cancer_tpu.ops import losses as JL

    logits, target = _seg(1)
    want = float(JL.dice_loss(jnp.asarray(logits), jnp.asarray(target), **kw))
    got = float(L.dice_loss(_nchw(logits), _nchw(target), **kw))
    assert abs(got - want) <= TOL


def test_classification_losses_match_jax():
    import jax.numpy as jnp

    from multi_task_breast_cancer_tpu.ops import losses as JL

    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((6, 3)) * 2).astype(np.float32)
    onehot = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    weight = [0.2, 0.5, 0.3]
    jw = JL.inverse_frequency_weights(weight)
    tw = L.inverse_frequency_weights(weight)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=TOL)
    pairs = [
        (JL.focal_loss(jnp.asarray(logits), jnp.asarray(onehot)),
         L.focal_loss(torch.from_numpy(logits), torch.from_numpy(onehot))),
        (JL.focal_loss(jnp.asarray(logits), jnp.asarray(onehot), weight=jw),
         L.focal_loss(torch.from_numpy(logits), torch.from_numpy(onehot), weight=tw)),
        (JL.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(onehot), jw),
         L.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(onehot), tw)),
        (JL.bce_with_logits(jnp.asarray(logits[:, :1]), jnp.asarray(onehot[:, :1])),
         L.bce_with_logits(torch.from_numpy(logits[:, :1]), torch.from_numpy(onehot[:, :1]))),
    ]
    for want, got in pairs:
        assert abs(float(got) - float(want)) <= TOL


def test_multitask_criterion_deep_supervision_weights_match_jax():
    """Four seg heads (coarsest first, as the model returns them) with
    inverse 1/(j+1) weights over the reversed order, and a cls head list that
    is summed unweighted."""
    import jax.numpy as jnp

    from multi_task_breast_cancer_tpu.ops import fused_loss as JFL
    from multi_task_breast_cancer_tpu.ops import losses as JL

    rng = np.random.default_rng(3)
    heads = [(rng.standard_normal((2, 16, 16, 1)) * 2).astype(np.float32) for _ in range(4)]
    target = (rng.random((2, 16, 16, 1)) > 0.6).astype(np.float32)
    cls = [(rng.standard_normal((2, 3))).astype(np.float32) for _ in range(2)]
    onehot = np.eye(3, dtype=np.float32)[[0, 2]]
    for weighted in (True, False):
        j_seg, j_cls = JL.apply_criterion_multitask(
            JFL.fused_dice_criterion, jnp.asarray(target), tuple(map(jnp.asarray, heads)),
            JL.init_criterion_classification(3, None, "Focal"), jnp.asarray(onehot),
            tuple(map(jnp.asarray, cls)), weighted)
        t_seg, t_cls = L.apply_criterion_multitask(
            FL.fused_dice_criterion, _nchw(target), tuple(map(_nchw, heads)),
            L.init_criterion_classification(3, None, "Focal"), torch.from_numpy(onehot),
            tuple(map(torch.from_numpy, cls)), weighted)
        assert abs(float(t_seg) - float(j_seg)) <= TOL
        assert abs(float(t_cls) - float(j_cls)) <= TOL
    assert float(L.init_criterion_classification(2)(torch.zeros(2, 1), torch.ones(2, 1))) \
        == pytest.approx(np.log(2.0), abs=TOL)


def test_fused_dice_value_and_gradients():
    """Value and both gradients of the analytic backward against JAX's custom
    VJP and against torch autograd of the plain Dice."""
    import jax
    import jax.numpy as jnp

    from multi_task_breast_cancer_tpu.ops import fused_loss as JFL

    logits, target = _seg(4)
    target = target * 0.8 + 0.1  # soft targets: the target gradient is live
    jv, (jgl, jgt) = jax.value_and_grad(JFL.fused_dice_criterion, argnums=(0, 1))(
        jnp.asarray(logits), jnp.asarray(target))

    lt, tt = _nchw(logits).requires_grad_(), _nchw(target).requires_grad_()
    value = FL.fused_dice_criterion(lt, tt)
    value.backward()
    value = value.detach()
    lp, tp = _nchw(logits).requires_grad_(), _nchw(target).requires_grad_()
    L.dice_loss(lp, tp).backward()

    assert abs(float(value) - float(jv)) <= TOL
    for got, jax_grad, autograd in ((lt.grad, jgl, lp.grad), (tt.grad, jgt, tp.grad)):
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(jax_grad),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(got.numpy(), autograd.numpy(), rtol=0, atol=TOL)


def test_fused_dice_skips_the_target_gradient_when_not_needed():
    logits, target = _seg(5)
    lt = _nchw(logits).requires_grad_()
    FL.fused_dice_criterion(lt, _nchw(target)).backward()
    assert lt.grad is not None and torch.isfinite(lt.grad).all()


def test_unported_segmentation_criteria_raise():
    """Every criterion of the factory builds (the six besides DICE and BCE
    are held against JAX in ``tests/test_torch_seg_losses.py``); an unknown
    name raises, and so does a non-finite loss."""
    for name in ("Hausdorff", "GeneralizedDICE", "CrossentropyDICE", "FocalDICE",
                 "Jaccard", "FocalLoss"):
        assert callable(L.init_criterion_segmentation(name))
    with pytest.raises(ValueError, match="allowed"):
        L.init_criterion_segmentation("NoSuchLoss")
    with pytest.raises(FloatingPointError):
        L.check_finite_loss(float("nan"))


def test_device_metrics_match_jax():
    import jax.numpy as jnp

    from multi_task_breast_cancer_tpu.ops import metrics as JM

    logits, target = _seg(6, shape=(4, 16, 16, 1), empty_sample=False)
    cases = [(target, logits), (np.zeros_like(target), logits),
             (np.zeros_like(target), -np.abs(logits) - 1), (target, -np.abs(logits) - 1)]
    for gt, lg in cases:
        want = float(JM.dice_from_logits_batch(jnp.asarray(gt), jnp.asarray(lg)))
        got = float(M.dice_from_logits_batch(_nchw(gt), _nchw(lg)))
        assert abs(got - want) <= TOL

    rng = np.random.default_rng(7)
    gt_l, pred_l = rng.integers(0, 3, 20), rng.integers(0, 3, 20)
    jcm = JM.confusion_matrix_update(jnp.zeros((3, 3)), jnp.asarray(gt_l), jnp.asarray(pred_l), 3)
    tcm = M.confusion_matrix_update(torch.zeros(3, 3), torch.from_numpy(gt_l),
                                    torch.from_numpy(pred_l), 3)
    np.testing.assert_array_equal(tcm.numpy(), np.asarray(jcm))
    assert abs(float(M.accuracy_from_cm(tcm)) - float(JM.accuracy_from_cm(jcm))) <= TOL
    assert abs(float(M.f1_weighted_from_cm(tcm)) - float(JM.f1_weighted_from_cm(jcm))) <= TOL
    empty_row = tcm.clone()
    empty_row[2] = 0
    assert abs(float(M.f1_weighted_from_cm(empty_row))
               - float(JM.f1_weighted_from_cm(jnp.asarray(empty_row.numpy())))) <= TOL

    lg3 = rng.standard_normal((5, 3)).astype(np.float32)
    lg1 = rng.standard_normal((5, 1)).astype(np.float32)
    for lg, n in ((lg3, 3), (lg1, 2)):
        np.testing.assert_array_equal(
            M.predicted_labels_from_logits(torch.from_numpy(lg), n).numpy(),
            np.asarray(JM.predicted_labels_from_logits(jnp.asarray(lg), n)))
