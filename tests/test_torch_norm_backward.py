"""The norm's backward (kernel #2's plain twin) against the JAX package.

The JAX side differentiates its fused norm through the custom VJP, whose
backward is the Pallas ``_bwd_kernel`` (run in interpret mode here), and its
plain reference through autodiff. The port's backward is
``instance_norm_leaky_relu_backward`` (on the CPU: its plain twin) behind a
``torch.autograd.Function``. Same numpy inputs, NHWC on the JAX side and NCHW
in the port. Tolerances: 1e-5 absolute against JAX (f32, summed in another
order); 1e-10 for the formula against float64 autograd of the plain forward.

The ``cuda`` tests hold the CUDA kernel against the plain version on a GPU
and skip without one (``python -m pytest tests/test_torch_norm_backward.py
-m cuda --noconftest`` on the card).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3 + 5).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, g


@pytest.mark.parametrize("shape,slope", [
    ((2, 4, 4, 8), 0.01),     # 16-element planes: the flagship's 4×4 bottleneck
    ((2, 32, 32, 4), 0.01),
    ((1, 8, 8, 16), 0.2),
])
def test_backward_matches_jax_pallas_vjp_and_autodiff(shape, slope):
    import jax
    import jax.numpy as jnp

    from multi_task_breast_cancer_tpu.ops import pallas_kernels as pk

    x, g = _inputs(shape, sum(shape))
    xj, gj = jnp.asarray(x), jnp.asarray(g)
    pallas = np.asarray(jax.grad(
        lambda a: jnp.sum(pk.instance_norm_leaky_relu(a, 1e-5, slope, True) * gj))(xj))
    ref = np.asarray(jax.grad(
        lambda a: jnp.sum(pk.instance_norm_leaky_relu_reference(a, slope=slope) * gj))(xj))

    xt = _nchw(x).requires_grad_()
    y = hk.instance_norm_leaky_relu(xt, 1e-5, slope)
    y.backward(_nchw(g))
    got = xt.grad.numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    direct = hk.instance_norm_leaky_relu_backward(_nchw(x), _nchw(g), 1e-5, slope)
    np.testing.assert_array_equal(direct.numpy().transpose(0, 2, 3, 1), got)


@pytest.mark.parametrize("slope", [0.01, 0.3])
def test_backward_formula_matches_float64_autograd(slope):
    """The kernel's formula against autograd of the plain forward, both in
    float64: they must agree to rounding."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((3, 5, 6, 7)) * 2 + 1).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((3, 5, 6, 7)))
    y = hk.instance_norm_leaky_relu_reference(x, 1e-5, slope)
    (want,) = torch.autograd.grad(y, x, g)
    got = hk.instance_norm_leaky_relu_backward_reference(x.detach(), g, 1e-5, slope)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=0, atol=1e-10)


def test_gradient_branch_is_xhat_ge_zero():
    """At xhat == 0 exactly the gradient takes the positive branch (``>= 0``,
    as the Pallas kernel; torch's own leaky_relu backward uses ``> 0``)."""
    x = torch.tensor([[[[-1.0, 0.0, 1.0]]]])  # mean 0: the middle xhat is 0
    g = torch.ones_like(x)
    slope = 0.25
    got = hk.instance_norm_leaky_relu_backward(x, g, 0.0, slope)
    xhat = x * torch.rsqrt((x * x).mean())
    dxhat = torch.tensor([[[[slope, 1.0, 1.0]]]])
    m1, m2 = dxhat.mean(), (dxhat * xhat).mean()
    want = torch.rsqrt((x * x).mean()) * (dxhat - m1 - xhat * m2)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_channels_last_gradient():
    """A gradient with channels-last strides (as cuDNN's conv backward may
    hand over) gives the same dx as the contiguous one."""
    x, g = _inputs((2, 8, 8, 6), 5)
    want = hk.instance_norm_leaky_relu_backward(_nchw(x), _nchw(g))
    g_cl = _nchw(g).to(memory_format=torch.channels_last)
    assert not g_cl.is_contiguous()
    got = hk.instance_norm_leaky_relu_backward(_nchw(x), g_cl)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # and through autograd, with a channels-last consumer downstream
    xt = _nchw(x).requires_grad_()
    y = hk.instance_norm_leaky_relu(xt)
    (y.to(memory_format=torch.channels_last) * g_cl).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_backward_rejects_mismatched_gradient():
    x = torch.randn(1, 2, 4, 4)
    with pytest.raises(ValueError, match="does not match"):
        hk.instance_norm_leaky_relu_backward(x, torch.randn(1, 2, 4, 5))
    with pytest.raises(ValueError, match="does not match"):
        hk.instance_norm_leaky_relu_backward(x, torch.randn(1, 2, 4, 4).double())


def test_cpu_path_counts_no_launches():
    before = (hk.instance_norm_leaky_relu.launches,
              hk.instance_norm_leaky_relu_backward.launches)
    x = torch.randn(2, 3, 4, 4, requires_grad=True)
    hk.instance_norm_leaky_relu(x).sum().backward()
    assert x.grad is not None
    assert (hk.instance_norm_leaky_relu.launches,
            hk.instance_norm_leaky_relu_backward.launches) == before


def _kink_free(shape, gen):
    """Planes of 5 ± 2·(|N(0,1)| + 0.1) in ± pairs: every normalised value
    stays ~0.05 from the kink, where the gradient jumps by (1 − slope)·g and
    two f32 evaluations summed in different orders may pick different
    branches for an element within ~1e-7 of it. An odd plane gets one more
    element at 5 + 3, which moves the mean by at most 3/H·W."""
    n, c, h, w = shape
    a = torch.randn(n, c, h * w // 2, device="cuda", generator=gen).abs() + 0.1
    z = torch.cat([a, -a] + [torch.full((n, c, h * w % 2), 1.5, device="cuda")], dim=2)
    order = torch.rand(n, c, h * w, device="cuda", generator=gen).argsort(dim=2)
    return (5.0 + 2.0 * z.gather(2, order)).reshape(shape)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a); the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,hw", [(320, 4), (16, 128), (512, 8)])
def test_cuda_backward_matches_plain(dtype, c, hw):
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(c)
    x = _kink_free((2, c, hw, hw), gen).to(dtype)
    g = torch.randn(2, c, hw, hw, device="cuda", generator=gen).to(dtype)
    before = hk.instance_norm_leaky_relu_backward.launches
    got = hk.instance_norm_leaky_relu_backward(x, g)
    want = hk.instance_norm_leaky_relu_backward_reference(x, g)
    torch.cuda.synchronize()
    assert hk.instance_norm_leaky_relu_backward.launches == before + 1
    err = (got.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5 * scale
    else:  # one bf16 ulp of the value, plus the f32 tolerance near zero
        assert bool((err <= 2.0 ** -7 * want.float().abs() + 1e-5 * scale).all())


@pytest.mark.cuda
def test_cuda_autograd_through_both_kernels():
    _cuda_or_skip()
    x = _kink_free((2, 8, 16, 16), torch.Generator(device="cuda").manual_seed(0))
    x.requires_grad_()
    g = torch.randn(2, 8, 16, 16, device="cuda").to(memory_format=torch.channels_last)
    f0 = hk.instance_norm_leaky_relu.launches
    b0 = hk.instance_norm_leaky_relu_backward.launches
    hk.instance_norm_leaky_relu(x).backward(g)
    torch.cuda.synchronize()
    assert hk.instance_norm_leaky_relu.launches == f0 + 1
    assert hk.instance_norm_leaky_relu_backward.launches == b0 + 1
    want = hk.instance_norm_leaky_relu_backward_reference(x.detach(), g)
    assert (x.grad - want).abs().max().item() <= 1e-5


# One shape per variant and cluster size, as in tests/test_torch_kernels.py.
PLAN_SHAPES = [(2, 320, 4, 4), (2, 320, 8, 8), (2, 256, 16, 16), (2, 32, 128, 128),
               (64, 32, 128, 128), (2, 128, 32, 32), (64, 64, 64, 64),
               (2, 4, 256, 256), (2, 8, 7, 9)]


def _assert_close_to_plain(got, x, g):
    want = hk.instance_norm_leaky_relu_backward_reference(x, g)
    err = (got.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    if x.dtype == torch.float32:
        assert err.max().item() <= 1e-5 * scale
    else:  # one bf16 ulp of the value, plus the f32 tolerance near zero
        assert bool((err <= 2.0 ** -7 * want.float().abs() + 1e-5 * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_backward_every_plan_matches_plain_and_repeats(dtype, shape):
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = _kink_free(shape, gen).to(dtype)
    g = torch.randn(*shape, device="cuda", generator=gen).to(dtype)
    before = hk.instance_norm_leaky_relu_backward.launches
    got = hk.instance_norm_leaky_relu_backward(x, g)
    again = hk.instance_norm_leaky_relu_backward(x, g)
    torch.cuda.synchronize()
    assert hk.instance_norm_leaky_relu_backward.launches == before + 2
    assert torch.equal(got, again)  # fixed summation order: bit for bit
    _assert_close_to_plain(got, x, g)
    n, c, h, w = shape
    forced = hk._backward(x, g, 1e-5, 0.01, plan=hk.streaming_plan(n * c, h * w))
    _assert_close_to_plain(forced, x, g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_misaligned_view(dtype):
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(9)
    shape = (2, 16, 32, 32)
    buf = torch.empty(1 + 2 * 16 * 32 * 32, device="cuda", dtype=dtype)
    x = buf[1:].view(shape)  # contiguous, one element past an aligned start
    x.copy_(_kink_free(shape, gen))
    g = torch.randn(*shape, device="cuda", generator=gen).to(dtype)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert hk.plan_for(x, g, torch.empty_like(x)).variant == "streaming"
    _assert_close_to_plain(hk.instance_norm_leaky_relu_backward(x, g), x, g)
