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
    # the Engine's unpacking reads the int32 planes as bf16 pairs in memory:
    # the same bits as the arithmetic inverse, for every pattern
    fmt = FA.AugFormat(n_channels=2, n_planes=1, dtype="bfloat16", height=256, width=256,
                       canvas=256)
    planes = FA.unpack_channels_nchw(got.reshape(1, 1, 256, 256), fmt)
    np.testing.assert_array_equal(planes.reshape(2, -1).T.contiguous().view(torch.int16).numpy(),
                                  pairs)


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
    factors = FA.pipeline_factors_from_draws(*(torch.from_numpy(d) for d in (fh, fv, ang)), s)
    got = FA.fast_augment(torch.from_numpy(packed), torch.from_numpy(bidx), factors)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _kernel_emulation(packed, rows, factors, plan):
    """The CUDA kernel's work, emulated in numpy (csrc/fast_augment.cu): per
    block (plane, part) of the plan, the plane it stages (staged) at a pitch
    of S + 4 words, its share of the row segments (up to 128 pixels) over
    its warps, lane l computing and storing pixels x0 + l + 32q
    with the row's terms hoisted. Returns the (P, B, S, S) output and how
    often each pixel was written."""
    n, p, s, _ = packed.shape
    d, c, sv, t1 = (np.asarray(f, np.int64) for f in factors)
    b = len(rows)
    pitch, segs = s + 4, -(-s // 128)
    units = s * segs
    out = np.full((p, b, s, s), 12345, np.int64)
    writes = np.zeros((p, b, s, s), np.int64)
    warps = plan.threads // 32
    lanes = np.arange(32)[:, None] + 32 * np.arange(4)[None, :]      # (lane, q)
    for blk in range(plan.blocks):
        part, t = blk % plan.split, blk // plan.split
        i, q_plane = t % b, t // b
        row = rows[i]
        valid = 0 <= row < n
        staged = np.zeros((s, pitch), np.int64)
        if valid and plan.variant == "staged":
            staged[:, :s] = packed[row, q_plane]
        (d0, d1, d2), (c0, c1, c2), (s0, s1, s2) = d[i], c[i], sv[i]
        tr = t1[i] > 0
        dj, dk = (0, d1) if tr else (d2, 0)
        lo, hi = units * part // plan.split, units * (part + 1) // plan.split
        for w in range(warps):
            for u in range(lo + w, hi, warps):
                y, x0 = u // segs, (u % segs) * 128
                length = min(128, s - x0)
                aj = d2 * y + c2 if tr else c2 + s2[y]
                bk = c1 if tr else d1 * y + c1
                live = valid & (lanes < length)
                x = np.where(live, x0 + lanes, 0)
                j = dj * x + aj + (s2[x] if tr else 0)
                ok = live & (j >= 0) & (j < s)
                j = np.where(ok, j, 0)
                k = dk * x + bk + s1[j]
                ok &= (k >= 0) & (k < s)
                k = np.where(ok, k, 0)
                m = d0 * j + c0 + s0[k]
                ok &= (m >= 0) & (m < s)
                m = np.where(ok, m, 0)
                if plan.variant == "direct":
                    v = packed[row, q_plane][k, m] if valid else np.zeros_like(k)
                else:
                    v = staged[k, m]
                stored = lanes < length                 # 32 consecutive pixels per store
                out[q_plane, i, y, (x0 + lanes)[stored]] = np.where(ok, v, 0)[stored]
                writes[q_plane, i, y, (x0 + lanes)[stored]] += 1
    return out.astype(np.int32), writes


def _boundary_draws():
    """The 16 boundary angles of ``chip_smoke._special_draws`` under each of
    the four flip pairs (64 samples)."""
    special = np.array([180.0, -180.0, 90.0, -90.0, 0.0, 270.0, -270.0, 360.0, -360.0,
                        45.0, 135.0, -135.0, 89.99, 90.01, -179.99, 179.99], np.float32)
    pairs = [(h, v) for h in (False, True) for v in (False, True)]
    fh = np.repeat([h for h, _ in pairs], len(special))
    fv = np.repeat([v for _, v in pairs], len(special))
    return fh, fv, np.tile(special, len(pairs))


@pytest.mark.parametrize("s", [8, 16, 128, 256])
def test_factors_expand_to_the_jax_index_planes(s):
    """``pipeline_factors_from_draws`` expanded (``d·iota + c + s``, written
    out here in numpy) equals the JAX package's index planes bit for bit,
    over the boundary draws under all four flip pairs and random draws."""
    import jax.numpy as jnp

    from multi_task_breast_cancer_tpu.ops import fast_augment as JFA

    bf = _boundary_draws()
    rf = _draws(40 + len(BOUNDARY_ANGLES), s + 1)
    fh, fv, angle = (np.concatenate([a, b]) for a, b in zip(bf, rf))
    want_idx, want_t1 = JFA.pipeline_params_from_draws(
        jnp.asarray(fh), jnp.asarray(fv), jnp.asarray(angle), s)
    factors = FA.pipeline_factors_from_draws(torch.from_numpy(fh), torch.from_numpy(fv),
                                             torch.from_numpy(angle), s)
    b = len(angle)
    assert [tuple(f.shape) for f in factors] == [(b, 3), (b, 3), (b, 3, s), (b,)]
    assert all(f.dtype == torch.int32 for f in factors)
    d, c, sv, t1 = (f.numpy() for f in factors)
    idx = d[:, :, None, None] * np.arange(s)[None, None, None, :] + c[:, :, None, None] \
        + sv[:, :, :, None]
    np.testing.assert_array_equal(idx, np.asarray(want_idx))
    np.testing.assert_array_equal(t1, np.asarray(want_t1))
    got_idx, got_t1 = FA.pipeline_params_from_draws(torch.from_numpy(fh), torch.from_numpy(fv),
                                                    torch.from_numpy(angle), s)
    np.testing.assert_array_equal(got_idx.numpy(), idx)
    assert torch.equal(got_t1, factors.t1)


def test_kernel_composed_gather_equals_staged_executor():
    """The single-gather composition the kernel computes from the factors,
    under the launch plan, is bit-identical to the three staged gathers over
    draws that cover every flip and quadrant."""
    s = 16
    rng = np.random.default_rng(3)
    packed = rng.integers(-2 ** 31, 2 ** 31, (4, 2, s, s), dtype=np.int64).astype(np.int32)
    fh = np.array([0, 1, 0, 1, 0, 1, 0, 1, 1, 0, 0, 1], bool)
    fv = np.array([0, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 0], bool)
    angle = np.array([0, 90, 180, -90, 37.5, -141, 265, -180, 13, 359, -44.9, 121],
                     np.float32)
    factors = FA.pipeline_factors_from_draws(torch.from_numpy(fh), torch.from_numpy(fv),
                                             torch.from_numpy(angle), s)
    bidx = rng.integers(0, 4, len(angle)).astype(np.int32)
    want = FA.fast_augment(torch.from_numpy(packed), torch.from_numpy(bidx), factors)
    got, writes = _kernel_emulation(packed, bidx, factors, FA._plan(len(angle), 2, s))
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, want.transpose(0, 1).numpy())


@pytest.mark.parametrize("s,p,b,variant,split", [
    (16, 2, 12, "staged", 1), (16, 2, 12, "staged", 2), (16, 1, 12, "direct", 2),
    (24, 1, 12, "staged", 5),      # 24 rows over 5 blocks: uneven shares
    (8, 1, 12, "direct", 1), (32, 2, 12, "direct", 32), (128, 1, 12, "staged", 1),
    (128, 1, 4, "staged", 8), (256, 1, 4, "direct", 4),    # two segments per row
    (384, 1, 2, "direct", 3)])                             # three, 384 rows over 3
def test_kernel_plans_equal_staged_executor(s, p, b, variant, split):
    """The kernel's composed gather from factors, under the plan's split of
    the output over blocks and warps, writes
    every output pixel exactly once and equals the staged executor bit for
    bit, over draws that cover every flip and quadrant; a row outside the
    fold gives zeros."""
    rng = np.random.default_rng(s + b + split)
    packed = rng.integers(-2 ** 31, 2 ** 31, (4, p, s, s), dtype=np.int64).astype(np.int32)
    fh, fv, angle = (a[:b] for a in _boundary_draws())
    fh, fv = fh.copy(), fv.copy()
    fh[::2], fv[1::3] = True, True
    angle = angle.copy()
    n_random = min(3, b - 1)
    angle[b - n_random:] = rng.uniform(-360, 360, n_random)
    factors = FA.pipeline_factors_from_draws(torch.from_numpy(fh), torch.from_numpy(fv),
                                             torch.from_numpy(angle), s)
    rows = rng.integers(0, 4, b).astype(np.int32)
    want = FA.fast_augment(torch.from_numpy(packed), torch.from_numpy(rows), factors)
    plan = FA.make_plan(variant, split, b, p, s)
    rows_out = rows.copy()
    rows_out[1] = 7                                     # outside the fold: zeros
    got, writes = _kernel_emulation(packed, rows_out, factors, plan)
    assert (writes == 1).all()
    want_pb = want.transpose(0, 1).numpy().copy()
    want_pb[:, 1] = 0
    np.testing.assert_array_equal(got, want_pb)


def test_output_is_plane_major_and_its_channels_are_nchw():
    """The plain twin returns what the kernel does: a (B, P, S, S) view of
    (P, B, S, S) storage; at 128² f32 each channel of the unpacked batch has
    exact NCHW strides without a copy."""
    from multi_task_breast_cancer_tpu_torch.train.loop import Engine

    s, b = 128, 3
    rng = np.random.default_rng(0)
    stack = rng.standard_normal((5, s, s, 2)).astype(np.float32)
    packed, fmt = FA.pack_channels(torch.from_numpy(stack), "float32")
    factors = FA.pipeline_factors_from_draws(
        *(torch.from_numpy(a[:b]) for a in _boundary_draws()), s)
    out = FA.fast_augment(packed, torch.tensor([4, 0, 2], dtype=torch.int32), factors)
    assert out.shape == (b, 2, s, s) and out.transpose(0, 1).is_contiguous()
    unpacked = FA.unpack_channels_nchw(out, fmt)
    for ch in (unpacked[:, :1], unpacked[:, 1:]):
        view = Engine._nchw(ch)
        assert view.stride() == (s * s, s * s, s, 1)
        assert view.untyped_storage().data_ptr() == out.untyped_storage().data_ptr()
        assert torch.equal(view, ch)


def test_plan_per_shape():
    """Staged in one block's shared memory up to 128², direct gathers
    beyond; planes split over blocks while SMs would idle; shared memory
    within the card's 227 KB."""
    main64, main2 = FA._plan(64, 2, 128), FA._plan(2, 2, 128)
    assert (main64.variant, main64.split, main64.threads, main64.blocks) == ("staged", 1, 1024, 128)
    assert (main2.variant, main2.split, main2.threads, main2.blocks) == ("staged", 8, 512, 32)
    big = FA._plan(16, 3, 256)
    assert (big.variant, big.split, big.threads, big.blocks) == ("direct", 16, 256, 768)
    assert FA._plan(2, 1, 384).variant == "direct"
    assert FA._plan(8, 2, 16).split == 2 and FA._plan(8, 2, 16).threads == 256
    for s in (8, 16, 24, 64, 128, 256, 384, 512):
        for b, p in ((1, 1), (2, 2), (64, 2), (16, 3)):
            plan = FA._plan(b, p, s)
            assert plan.smem <= FA._MAX_SMEM and 32 <= plan.threads <= 1024
            assert plan.split <= FA._units(s)          # a row segment per block at least
            assert plan in FA.candidate_plans(b, p, s)
    assert main64.smem == 4 * (128 * 132 + 3 * 128)


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
    good = FA.pipeline_factors_from_draws(torch.zeros(2, dtype=torch.bool),
                                          torch.zeros(2, dtype=torch.bool), torch.zeros(2), 8)
    with pytest.raises(ValueError, match="do not match"):
        FA.fast_augment(packed, torch.zeros(2, dtype=torch.int32),
                        good._replace(s=torch.zeros(2, 3, 4, dtype=torch.int32)))
    with pytest.raises(ValueError, match="do not match"):
        FA.fast_augment(packed, torch.zeros(3, dtype=torch.int32), good)
    with pytest.raises(ValueError, match=r"\(N, P, S, S\)"):
        FA.fast_augment(packed[0], torch.zeros(2, dtype=torch.int32), good)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a); the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("s,p,b", [(8, 1, 3), (128, 2, 2), (128, 2, 64), (256, 3, 4)])
def test_cuda_kernel_bit_equal_to_plain(s, p, b):
    _cuda_or_skip()
    gen = torch.Generator().manual_seed(s)
    packed = torch.randint(-2 ** 31, 2 ** 31 - 1, (5, p, s, s), generator=gen,
                           dtype=torch.int32)
    bidx = torch.randint(0, 5, (b,), generator=gen, dtype=torch.int32)
    fh, fv, angle = FA.draw_flips_and_angles(gen, b, p_hflip=0.5, p_vflip=0.5,
                                             max_angle=360.0)
    angle[:2] = torch.tensor([90.0, -180.0])[:min(b, 2)]
    factors = FA.pipeline_factors_from_draws(fh, fv, angle, s)
    want = FA.fast_augment(packed, bidx, factors)
    dev = [t.cuda() for t in (packed, bidx)]
    dev_factors = FA.PipelineFactors(*(f.cuda() for f in factors))
    before = FA.fast_augment.launches
    got = FA.fast_augment(*dev, dev_factors)
    torch.cuda.synchronize()
    assert FA.fast_augment.launches == before + 1
    assert got.shape == (b, p, s, s) and got.transpose(0, 1).is_contiguous()
    assert torch.equal(got.cpu(), want)
    plans = FA.candidate_plans(b, p, s)
    assert FA.plan_for(dev[0], b) in plans
    for plan in plans:
        out = FA.fast_augment(*dev, dev_factors, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), want), plan


@pytest.mark.cuda
def test_cuda_refused_plan_raises():
    _cuda_or_skip()
    s, b, p = 256, 2, 1
    packed = torch.zeros(3, p, s, s, dtype=torch.int32, device="cuda")
    factors = FA.PipelineFactors(*(f.cuda() for f in FA.pipeline_factors_from_draws(
        torch.zeros(b, dtype=torch.bool), torch.zeros(b, dtype=torch.bool), torch.zeros(b), s)))
    rows = torch.zeros(b, dtype=torch.int32, device="cuda")
    before = FA.fast_augment.launches
    for plan in (FA.make_plan("staged", 1, b, p, s),          # 256² does not fit one block
                 FA.make_plan("direct", 1, b, p, s)._replace(threads=48),
                 FA.make_plan("direct", 1, b, p, s)._replace(threads=2048),
                 FA.make_plan("direct", 2 * FA._units(s), b, p, s)):   # a block with no row
        with pytest.raises(RuntimeError):
            FA.fast_augment(packed, rows, factors, plan=plan)
    assert FA.fast_augment.launches == before
