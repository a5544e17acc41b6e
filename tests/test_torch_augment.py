"""The exact joint augmentation (``data/augment.py``) against the JAX package,
bit for bit: the same injected angles and flips give the same pixels.

``rotate_nearest`` takes the angle directly on both sides. The batched joint
transform of JAX draws its flips and angles from keys (``_joint_coords``);
the test reproduces those draws from the same keys and hands them to the
port. Both packages compute the same f32 sine and cosine to within one ulp
on the CPU; the inputs here are fixed by their seeds.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu_torch.data import augment as A

ANGLES = [0.0, 90.0, -90.0, 180.0, -180.0, 45.0, -135.0, 270.0, 12.5, -301.7, 359.0]


@pytest.mark.parametrize("hw", [(32, 32), (24, 40)])
def test_rotate_nearest_bit_equal_to_jax(hw):
    import jax.numpy as jnp

    from multi_task_breast_cancer_tpu.data import augment as JA

    rng = np.random.default_rng(hw[1])
    img = rng.standard_normal((*hw, 2)).astype(np.float32)
    for angle in ANGLES + list(rng.uniform(-360, 360, 20)):
        want = np.asarray(JA.rotate_nearest(jnp.asarray(img), jnp.float32(angle)))
        got = A.rotate_nearest(torch.from_numpy(img), float(np.float32(angle)))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"angle {angle}")


def test_joint_transform_bit_equal_to_jax_with_its_draws():
    import jax
    import jax.numpy as jnp

    from multi_task_breast_cancer_tpu.data import augment as JA

    b, h, w = 16, 32, 32
    rng = np.random.default_rng(4)
    stack = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(21), b)
    want = np.asarray(JA.joint_transform_stack_batch(jnp.asarray(stack), keys,
                                                     p_hflip=0.5, p_vflip=0.5,
                                                     max_angle=360.0))

    def draws(k):  # the draws of JA._joint_coords
        kh, kv, kr = jax.random.split(k, 3)
        return (jax.random.uniform(kh) < 0.5, jax.random.uniform(kv) < 0.5,
                jax.random.uniform(kr, minval=-360.0, maxval=360.0))

    fh, fv, angle = (torch.from_numpy(np.array(d)) for d in jax.vmap(draws)(keys))
    assert 0 < int(fh.sum()) < b and 0 < int(fv.sum()) < b
    got = A.joint_transform_stack_batch(
        torch.from_numpy(np.ascontiguousarray(stack.transpose(0, 3, 1, 2))), fh, fv, angle)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1), want)


def test_joint_transform_keeps_mask_and_image_together():
    """An image that is 255·mask stays so through flips and rotation."""
    yy, xx = np.mgrid[0:40, 0:40]
    mask = ((yy - 15) ** 2 / 60 + (xx - 22) ** 2 / 120 <= 1).astype(np.float32)
    stack = torch.from_numpy(np.stack([mask, 255 * mask])[None].repeat(8, 0))
    g = torch.Generator().manual_seed(0)
    u = torch.rand(8, 3, generator=g)
    out = A.joint_transform_stack_batch(stack, u[:, 0] < 0.5, u[:, 1] < 0.5,
                                        720 * u[:, 2] - 360)
    torch.testing.assert_close(out[:, 1], 255 * out[:, 0], rtol=0, atol=0)
    assert out[:, 0].sum() > 0
