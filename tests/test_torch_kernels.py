"""The PyTorch port's fused InstanceNorm+LeakyReLU against the JAX Pallas kernel.

On the CPU the wrapper takes its plain PyTorch version (the CUDA kernel runs
only on the card). The same numpy inputs go through JAX's Pallas kernel in
interpret mode, JAX's plain reference, and the port; JAX is NHWC, the port
NCHW, so the inputs are transposed explicitly. Tolerance 1e-5 absolute: the
same f32 arithmetic, summed in another order.

Tests marked ``cuda`` hold the CUDA kernel against the plain version on a GPU
and skip without one. JAX is imported inside the tests that use it, so on a
GPU machine without JAX they run as
``python -m pytest tests/test_torch_kernels.py -m cuda --noconftest``.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk

ROOT = Path(__file__).resolve().parent.parent


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("shape,slope", [
    ((2, 4, 4, 8), 0.01),     # H·W = 16: the flagship's 4×4 bottleneck
    ((2, 64, 64, 4), 0.01),   # H·W = 4096
    ((3, 8, 8, 16), 0.01),
    ((1, 16, 16, 3), 0.2),    # the slope is passed through
])
def test_plain_matches_jax_pallas_and_reference(shape, slope):
    import jax.numpy as jnp

    from multi_task_breast_cancer_tpu.ops import pallas_kernels

    rng = np.random.default_rng(sum(shape))
    # an offset per plane: the variance must come from the centred values
    x = (rng.standard_normal(shape) * 3 + 5).astype(np.float32)
    pallas = np.asarray(pallas_kernels.instance_norm_leaky_relu(jnp.asarray(x), 1e-5, slope, True))
    ref = np.asarray(pallas_kernels.instance_norm_leaky_relu_reference(jnp.asarray(x), slope=slope))
    got = hk.instance_norm_leaky_relu(_nchw(x), 1e-5, slope)
    assert got.dtype == torch.float32
    got = got.numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert (got < 0).any()


def test_bf16_statistics_in_f32():
    """bf16 input: statistics and activation in f32, one rounding at the end,
    so the result is the f32 result on the same (bf16) values, rounded."""
    x = torch.from_numpy((np.random.default_rng(7).standard_normal((2, 3, 8, 8)) * 4 + 100)
                         .astype(np.float32)).to(torch.bfloat16)
    got = hk.instance_norm_leaky_relu(x)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, hk.instance_norm_leaky_relu(x.float()).to(torch.bfloat16))


def test_unsupported_device_raises():
    with pytest.raises(ValueError, match="unsupported device"):
        hk.instance_norm_leaky_relu(torch.empty(1, 2, 4, 4, device="meta"))


def test_import_builds_nothing_and_needs_no_nvcc():
    """Importing the kernel module (and running it on a CPU tensor) must not
    compile anything: the CPU tests run where there is no nvcc."""
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.path.dirname(sys.executable)
    code = (
        "import torch\n"
        "from multi_task_breast_cancer_tpu_torch.ops import _build, hopper_kernels as hk\n"
        "hk.instance_norm_leaky_relu(torch.randn(1, 2, 4, 4))\n"
        "assert not _build._libraries and hk.instance_norm_leaky_relu.launches == 0\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a); the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,hw", [(320, 4), (16, 128), (512, 8)])
def test_cuda_kernel_matches_plain(dtype, c, hw):
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(c)
    x = (torch.randn(4, c, hw, hw, device="cuda", generator=g) * 2 + 5).to(dtype)
    before = hk.instance_norm_leaky_relu.launches
    got = hk.instance_norm_leaky_relu(x)
    want = hk.instance_norm_leaky_relu_reference(x)
    torch.cuda.synchronize()
    assert hk.instance_norm_leaky_relu.launches == before + 1
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:  # one bf16 ulp: the two sum in different orders
        assert bool((err <= 2.0 ** -7 * want.float().abs() + 1e-6).all())


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    _cuda_or_skip()
    x = torch.randn(2, 8, 4, 4, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        hk.instance_norm_leaky_relu(x.to(memory_format=torch.channels_last))
    with pytest.raises(TypeError, match="dtype"):
        hk.instance_norm_leaky_relu(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        hk.instance_norm_leaky_relu(x.to(memory_format=torch.channels_last).requires_grad_())
    # a gradient is no longer refused: the backward kernel takes it
    assert hk.instance_norm_leaky_relu(x.requires_grad_()).grad_fn is not None


# One shape per variant and cluster size: subwarp groups of 2-32 lanes
# (4×4, 8×8, 16×16); one resident block per plane (32², 64²); clusters of 8
# (128², batch 2), 4 (f32 128², batch 64) and 2 (bf16 128², batch 64);
# streaming for 256² f32 (256 KB planes; bf16 stays resident in a cluster of
# 8) and 7×9 (not whole 16-byte vectors).
PLAN_SHAPES = [(2, 320, 4, 4), (2, 320, 8, 8), (2, 256, 16, 16), (2, 32, 128, 128),
               (64, 32, 128, 128), (2, 128, 32, 32), (64, 64, 64, 64),
               (2, 4, 256, 256), (2, 8, 7, 9)]


def _assert_close_to_plain(got, x):
    want = hk.instance_norm_leaky_relu_reference(x)
    err = (got.float() - want.float()).abs()
    if x.dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:  # one bf16 ulp: the two sum in different orders
        assert bool((err <= 2.0 ** -7 * want.float().abs() + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_every_plan_matches_plain_and_repeats(dtype, shape):
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = (torch.randn(*shape, device="cuda", generator=g) * 2 + 5).to(dtype)
    before = hk.instance_norm_leaky_relu.launches
    got = hk.instance_norm_leaky_relu(x)
    again = hk.instance_norm_leaky_relu(x)
    torch.cuda.synchronize()
    assert hk.instance_norm_leaky_relu.launches == before + 2  # one launch per call
    assert torch.equal(got, again)  # fixed summation order: bit for bit
    _assert_close_to_plain(got, x)
    n, c, h, w = shape
    forced = hk._forward(x, 1e-5, 0.01, plan=hk.streaming_plan(n * c, h * w))
    _assert_close_to_plain(forced, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_misaligned_view_takes_the_streaming_design(dtype):
    _cuda_or_skip()
    buf = (torch.randn(1 + 2 * 16 * 32 * 32, device="cuda") * 2 + 5).to(dtype)
    x = buf[1:].view(2, 16, 32, 32)  # contiguous, one element past an aligned start
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert hk.plan_for(x, torch.empty_like(x)).variant == "streaming"
    _assert_close_to_plain(hk.instance_norm_leaky_relu(x), x)


@pytest.mark.cuda
def test_cuda_refuses_a_plan_the_kernel_does_not_take():
    """A plan is never quietly replaced: a bad one raises."""
    _cuda_or_skip()
    x = torch.randn(2, 8, 32, 32, device="cuda")
    bad = hk.NormPlan("resident", 2, 32, 1, 64, 4, 32)  # 2·32·4 < 1024 elements
    with pytest.raises(RuntimeError, match="launch failed"):
        hk._forward(x, 1e-5, 0.01, plan=bad)
