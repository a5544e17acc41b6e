"""The fast augmentation (kernel #3's host side and plain twin) against the
JAX package.

Bit-exact throughout: packing is a bitcast, the pipeline parameters are the
same f32 arithmetic on the same injected draws, and the executors are integer
indexing. The JAX Pallas kernel runs in interpret mode, as
``tests/test_fast_augment.py`` runs it. The kernel's own index arithmetic
(one composed gather per output pixel) is emulated here on the CPU and held
against the staged executor; the ``cuda`` tests run the kernel itself and
skip without a GPU.

The draws for the JAX side come from its own key-split scheme
(``build_pipeline_params``), reproduced here, and go to the port as tensors:
JAX's PRNG cannot be reproduced with a ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu_torch.ops import fast_augment as FA

BOUNDARY_ANGLES = [-360.0, -270.0, -225.0, -180.0, -135.0, -90.0, -45.0, 0.0,
                   45.0, 90.0, 135.0, 180.0, 225.0, 270.0, 359.99, -179.99,
                   89.99, 90.01, -0.001]


def _jax_draws(key, b, p_hflip=0.5, p_vflip=0.5, max_angle=360.0):
    """The draws JAX's ``build_pipeline_params(key, b, ...)`` takes."""
    import jax

    keys = jax.random.split(key, b)

    def draws(k):
        kh, kv, kr = jax.random.split(k, 3)
        return (jax.random.uniform(kh) < p_hflip, jax.random.uniform(kv) < p_vflip,
                jax.random.uniform(kr, minval=-max_angle, maxval=max_angle))

    fh, fv, ang = jax.vmap(draws)(keys)
    return np.array(fh), np.array(fv), np.array(ang)


def _draws(n, seed):
    rng = np.random.default_rng(seed)
    angle = np.concatenate([rng.uniform(-360, 360, n - len(BOUNDARY_ANGLES)),
                            BOUNDARY_ANGLES]).astype(np.float32)
    return rng.random(n) < 0.5, rng.random(n) < 0.5, angle


@pytest.mark.parametrize("dtype,c,hw", [("float32", 2, (32, 32)), ("float32", 3, (31, 24)),
                                        ("bfloat16", 2, (32, 32)), ("bfloat16", 5, (20, 33))])
def test_pack_unpack_bit_equal_to_jax(dtype, c, hw):
    import jax.numpy as jnp

    from multi_task_breast_cancer_tpu.ops import fast_augment as JFA

    rng = np.random.default_rng(c + hw[0])
    stack = (rng.standard_normal((3, *hw, c)) * 50).astype(np.float32)
    want, jfmt = JFA.pack_channels(jnp.asarray(stack), dtype)
    got, fmt = FA.pack_channels(torch.from_numpy(stack), dtype)
    assert tuple(fmt) == tuple(jfmt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = FA.unpack_channels(got, fmt).float().numpy()
    np.testing.assert_array_equal(back, np.asarray(JFA.unpack_channels(want, jfmt), np.float32))
    if dtype == "float32":
        np.testing.assert_array_equal(back, stack)


def test_pack_bf16x2_covers_every_bit_pattern():
    """Every 16-bit pattern in both halves (signs, infinities, NaNs):
    ``(u16(ch0) << 16) | u16(ch1)`` as int32, and back."""
    bits = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    pairs = np.stack([bits, bits[::-1]], axis=-1)
    got = FA.pack_bf16x2(torch.from_numpy(pairs).view(torch.bfloat16))
    expected = (pairs[:, 0].astype(np.int64) & 0xFFFF) << 16 | (pairs[:, 1].astype(np.int64) & 0xFFFF)
    np.testing.assert_array_equal(got.numpy(), expected.astype(np.uint32).view(np.int32))
    np.testing.assert_array_equal(FA.unpack_bf16x2(got).view(torch.int16).numpy(), pairs)


def test_plan_canvas_matches_jax():
    from multi_task_breast_cancer_tpu.ops import fast_augment as JFA

    for h, w in [(2, 2), (64, 96), (100, 60), (128, 128), (192, 192), (256, 130), (130, 8)]:
        assert FA.plan_canvas(h, w) == JFA.plan_canvas(h, w)


@pytest.mark.parametrize("w", [8, 33, 64, 128])
def test_pipeline_params_equal_jax(w):
    """≥ 256 injected draws per width, the boundary angles included (±180°,
    multiples of 90°, just either side of them)."""
    import jax.numpy as jnp

    from multi_task_breast_cancer_tpu.ops import fast_augment as JFA

    fh, fv, angle = _draws(288, w)
    want_idx, want_t1 = JFA.pipeline_params_from_draws(
        jnp.asarray(fh), jnp.asarray(fv), jnp.asarray(angle), w)
    idx, t1 = FA.pipeline_params_from_draws(torch.from_numpy(fh), torch.from_numpy(fv),
                                            torch.from_numpy(angle), w)
    assert idx.dtype == torch.int32 and t1.dtype == torch.int32
    np.testing.assert_array_equal(t1.numpy(), np.asarray(want_t1))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


@pytest.mark.parametrize("s", [8, 16, 32])
@pytest.mark.parametrize("p", [1, 2, 3])
def test_plain_executor_bit_equal_to_pallas_interpret(s, p):
    import jax
    import jax.numpy as jnp

    from multi_task_breast_cancer_tpu.ops import fast_augment as JFA

    rng = np.random.default_rng(s * 10 + p)
    packed = rng.integers(-2 ** 31, 2 ** 31, (5, p, s, s), dtype=np.int64).astype(np.int32)
    bidx = rng.integers(0, 5, 6).astype(np.int32)
    fh, fv, ang = _jax_draws(jax.random.PRNGKey(s + p), 6)
    idx, t1 = JFA.pipeline_params_from_draws(jnp.asarray(fh), jnp.asarray(fv),
                                             jnp.asarray(ang), s)
    want = JFA.pallas_pipeline(jnp.asarray(packed), jnp.asarray(bidx), idx, t1,
                               interpret=True)
    got = FA.fast_augment(torch.from_numpy(packed), torch.from_numpy(bidx),
                          torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(t1)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _composed_gather(packed, batch_idx, idx, t1):
    """The CUDA kernel's index arithmetic, emulated: one gather per output
    pixel traced back through the three stages (csrc/fast_augment.cu)."""
    n, p, s, _ = packed.shape
    out = np.zeros((len(batch_idx), p, s, s), np.int32)
    for i, row in enumerate(batch_idx):
        for y in range(s):
            for x in range(s):
                r, c = (x, y) if t1[i] > 0 else (y, x)
                j = idx[i, 2, r, c]
                if not 0 <= j < s:
                    continue
                k = idx[i, 1, j, r]
                if not 0 <= k < s:
                    continue
                m = idx[i, 0, k, j]
                if 0 <= m < s:
                    out[i, :, y, x] = packed[row, :, k, m]
    return out


def test_kernel_composed_gather_equals_staged_executor():
    """The single-gather composition the kernel uses is bit-identical to the
    three staged gathers, over draws that cover every flip and quadrant."""
    s = 16
    rng = np.random.default_rng(3)
    packed = rng.integers(-2 ** 31, 2 ** 31, (4, 2, s, s), dtype=np.int64).astype(np.int32)
    fh = np.array([0, 1, 0, 1, 0, 1, 0, 1, 1, 0, 0, 1], bool)
    fv = np.array([0, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 0], bool)
    angle = np.array([0, 90, 180, -90, 37.5, -141, 265, -180, 13, 359, -44.9, 121],
                     np.float32)
    idx, t1 = FA.pipeline_params_from_draws(torch.from_numpy(fh), torch.from_numpy(fv),
                                            torch.from_numpy(angle), s)
    bidx = rng.integers(0, 4, len(angle)).astype(np.int32)
    want = FA.fast_augment(torch.from_numpy(packed), torch.from_numpy(bidx), idx, t1)
    got = _composed_gather(packed, bidx, idx.numpy(), t1.numpy())
    np.testing.assert_array_equal(got, want.numpy())


def test_fast_joint_transform_equals_jax_and_keeps_mask_on_image():
    """Same draws, same packed fold → the same (B, H, W, C) batch as JAX; and
    an image that is 255·mask before the augmentation is so after it."""
    import jax
    import jax.numpy as jnp

    from multi_task_breast_cancer_tpu.ops import fast_augment as JFA

    h = w = 32
    yy, xx = np.mgrid[0:h, 0:w]
    masks = np.stack([((yy - 12 - i) ** 2 / 40 + (xx - 18) ** 2 / 90 <= 1)
                      for i in range(5)]).astype(np.float32)[..., None]
    stack = np.concatenate([masks, 255 * masks], axis=-1)
    bidx = np.array([4, 0, 2, 2, 1, 3], np.int32)
    key = jax.random.PRNGKey(9)
    jplanes, jfmt = JFA.pack_channels(jnp.asarray(stack), "float32")
    want = JFA.fast_joint_transform(jplanes, jnp.asarray(bidx), key, use_pallas=False,
                                    fmt=jfmt)
    planes, fmt = FA.pack_channels(torch.from_numpy(stack), "float32")
    draws = tuple(torch.from_numpy(d) for d in _jax_draws(key, len(bidx)))
    got = FA.fast_joint_transform(planes, torch.from_numpy(bidx), draws, fmt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    out = got.numpy()
    np.testing.assert_array_equal(out[..., 1], 255 * out[..., 0])
    assert set(np.unique(out[..., 0])) <= {0.0, 1.0} and out[..., 0].sum() > 0


def test_draws_follow_the_generator_and_probabilities():
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a = FA.draw_flips_and_angles(g1, (400, 2), p_hflip=0.5, p_vflip=0.2, max_angle=30.0)
    b = FA.draw_flips_and_angles(g2, (400, 2), p_hflip=0.5, p_vflip=0.2, max_angle=30.0)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    fh, fv, angle = a
    assert 0.4 < fh.float().mean().item() < 0.6 and 0.12 < fv.float().mean().item() < 0.28
    assert angle.abs().max().item() <= 30.0 and angle.shape == (400, 2)
    # build_pipeline_params = the same draws folded by pipeline_params_from_draws
    idx, t1 = FA.build_pipeline_params(torch.Generator().manual_seed(6), 9, 16, p_hflip=0.5,
                                       p_vflip=0.5, max_angle=360.0)
    draws = FA.draw_flips_and_angles(torch.Generator().manual_seed(6), 9, p_hflip=0.5,
                                     p_vflip=0.5, max_angle=360.0)
    want_idx, want_t1 = FA.pipeline_params_from_draws(*draws, 16)
    assert torch.equal(idx, want_idx) and torch.equal(t1, want_t1)


def test_wrapper_rejects_bad_shapes():
    packed = torch.zeros(3, 2, 8, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="do not match"):
        FA.fast_augment(packed, torch.zeros(2, dtype=torch.int32),
                        torch.zeros(2, 3, 8, 4, dtype=torch.int32),
                        torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(N, P, S, S\)"):
        FA.fast_augment(packed[0], torch.zeros(2, dtype=torch.int32),
                        torch.zeros(2, 3, 8, 8, dtype=torch.int32),
                        torch.zeros(2, dtype=torch.int32))


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a); the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("s,p,b", [(8, 1, 3), (128, 2, 2), (256, 3, 4)])
def test_cuda_kernel_bit_equal_to_plain(s, p, b):
    _cuda_or_skip()
    gen = torch.Generator().manual_seed(s)
    packed = torch.randint(-2 ** 31, 2 ** 31 - 1, (5, p, s, s), generator=gen,
                           dtype=torch.int32)
    bidx = torch.randint(0, 5, (b,), generator=gen, dtype=torch.int32)
    fh, fv, angle = FA.draw_flips_and_angles(gen, b, p_hflip=0.5, p_vflip=0.5,
                                             max_angle=360.0)
    angle[:2] = torch.tensor([90.0, -180.0])[:min(b, 2)]
    idx, t1 = FA.pipeline_params_from_draws(fh, fv, angle, s)
    want = FA.fast_augment(packed, bidx, idx, t1)
    before = FA.fast_augment.launches
    got = FA.fast_augment(packed.cuda(), bidx.cuda(), idx.cuda(), t1.cuda())
    torch.cuda.synchronize()
    assert FA.fast_augment.launches == before + 1
    assert torch.equal(got.cpu(), want)
