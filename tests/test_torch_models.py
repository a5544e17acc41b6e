"""The PyTorch port's nnU-Net family against the JAX models.

Same weights (JAX ``init`` → numpy → ``params_from_jax``), same numpy inputs,
both forwards on the CPU in f32. The port's norm takes its plain path here (a
CPU tensor); the JAX side runs its default ``InstanceNorm`` path, which
computes the same function. Tolerance 1e-4 absolute: f32 convolutions of two
frameworks summed in different orders through 25 normalisations.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu.models import blocks as jblocks
from multi_task_breast_cancer_tpu.models.multitask import MTnnUNet as JaxMTnnUNet
from multi_task_breast_cancer_tpu.models.nnunet import NNUNet2021 as JaxNNUNet2021
from multi_task_breast_cancer_tpu.serve.export import _flatten_variables
from multi_task_breast_cancer_tpu_torch.models import blocks, registry
from multi_task_breast_cancer_tpu_torch.models.jax_weights import (
    params_from_jax,
    params_to_jax,
    size_knobs_from_params,
)

WIDTHS = (4, 8, 8, 16, 16)
SIZE = 64
TOL = 1e-4


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _images(n: int = 2, seed: int = 0) -> np.ndarray:
    # raw 0-255 intensities, as the serving path feeds them
    return (np.random.default_rng(seed).random((n, SIZE, SIZE, 1)) * 255).astype(np.float32)


@pytest.fixture(scope="module")
def jax_mt():
    model = JaxMTnnUNet(widths=WIDTHS)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 1)))
    x = _images()
    (cls,), seg = model.apply(variables, jnp.asarray(x))
    return variables, x, np.asarray(cls), [np.asarray(s) for s in seg]


@pytest.mark.parametrize("layout", ["nested", "flat"])
def test_mtnnunet_forward_matches_jax(jax_mt, layout):
    """All 4 seg heads and the cls logits agree with the JAX forward; the
    weights go in as the nested tree or as a ``weights.npz``-style flat dict."""
    variables, x, want_cls, want_seg = jax_mt
    params = (jax.tree_util.tree_map(np.asarray, variables["params"]) if layout == "nested"
              else _flatten_variables(variables))
    model = registry.init_multitask_model("MTnnUNet", **size_knobs_from_params(params))
    model.load_state_dict(params_from_jax(params, model), strict=True)
    with torch.inference_mode():
        (cls,), seg = model(_nchw(x))
    assert len(seg) == 4
    np.testing.assert_allclose(cls.numpy(), want_cls, rtol=0, atol=TOL)
    for got, want in zip(seg, want_seg):
        assert got.shape == (2, 1, SIZE, SIZE)
        np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=TOL)


def test_nnunet_segmentation_forward_matches_jax():
    """The segmentation nnU-Net with a 3-region (semantic) head."""
    jmodel = JaxNNUNet2021(regions=3, widths=WIDTHS)
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, SIZE, SIZE, 1)))
    x = _images(seed=1)
    want = jmodel.apply(variables, jnp.asarray(x))
    model = registry.init_segmentation_model("nnUNet", regions=3, nnunet_widths=WIDTHS)
    model.load_state_dict(params_from_jax(variables["params"], model), strict=True)
    with torch.inference_mode():
        got = model(_nchw(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=0, atol=TOL)


@pytest.mark.parametrize("kernel", [2, 4, 8])
def test_deconv_and_deconv_head_tap_flip(kernel):
    """Transposed-conv kernels must flip their taps on the way to PyTorch:
    ``lax.conv_transpose`` applies tap (k-1-a, k-1-b) where
    ``ConvTranspose2d`` applies (a, b). Checked for a plain ``upsample``
    deconv and for the fused ``DeconvHead`` (four params, one deconv)."""
    rng = np.random.default_rng(kernel)
    x = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)

    jdeconv = jblocks.deconv(4, kernel)
    dv = jdeconv.init(jax.random.PRNGKey(kernel), jnp.asarray(x))
    want = np.asarray(jdeconv.apply(dv, jnp.asarray(x)))
    deconv = blocks.deconv(3, 4, kernel)
    sd = params_from_jax({"upsample1": dv["params"]}, {"upsample1"})
    deconv.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    with torch.inference_mode():
        np.testing.assert_allclose(_nhwc(deconv(_nchw(x))), want, rtol=0, atol=1e-5)

    jhead = jblocks.DeconvHead(3, 2, kernel)
    hv = jhead.init(jax.random.PRNGKey(kernel + 10), jnp.asarray(x))
    hv = jax.tree_util.tree_map(  # non-zero biases, so the fused bias is tested
        lambda a: a + 0.1 if a.ndim == 1 else a, hv)
    want = np.asarray(jhead.apply(hv, jnp.asarray(x)))
    head = blocks.DeconvHead(3, 2, kernel)
    sd = params_from_jax({"output": hv["params"]}, ())
    head.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    with torch.inference_mode():
        got = head(_nchw(x))
    assert got.shape == (2, 2, 5 * kernel, 6 * kernel)
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-5)

    # an unflipped kernel must NOT pass: the test has teeth
    bad = {k.split(".", 1)[1]: v for k, v in sd.items()}
    bad["deconv_kernel"] = bad["deconv_kernel"].flip(2, 3)
    head.load_state_dict(bad)
    with torch.inference_mode():
        assert np.abs(_nhwc(head(_nchw(x))) - want).max() > 1e-3


@pytest.mark.parametrize("tree", ["MTnnUNet", "DeconvHead"])
def test_params_to_jax_inverts_params_from_jax(jax_mt, tree):
    """``params_to_jax`` gives back the JAX tree exactly, leaf for leaf: convs,
    dense layers and ``upsample*`` deconvs (MTnnUNet), and the fused head's
    ``deconv_kernel`` and ``conv1x1_kernel``."""
    if tree == "MTnnUNet":
        params = jax.tree_util.tree_map(np.asarray, jax_mt[0]["params"])
        model = registry.init_multitask_model("MTnnUNet", **size_knobs_from_params(params))
    else:
        x = jnp.zeros((1, 5, 6, 3))
        params = {"output": jax.tree_util.tree_map(
            np.asarray, jblocks.DeconvHead(3, 2, 4).init(jax.random.PRNGKey(3), x)["params"])}
        model = torch.nn.Module()
        model.output = blocks.DeconvHead(3, 2, 4)
    back = params_to_jax(params_from_jax(params, model), model)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def test_full_width_parameter_count_and_layout():
    """The flagship at full width has exactly 15,819,799 parameters, and its
    state_dict matches, name for name and shape for shape, what
    ``params_from_jax`` makes of the JAX tree (shapes only; no forward)."""
    model = registry.init_multitask_model("MTnnUNet")
    assert registry.count_parameters(model) == 15_819_799
    shapes = jax.eval_shape(JaxMTnnUNet().init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 128, 128, 1), jnp.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    converted = params_from_jax(zeros, model)
    assert {k: tuple(v.shape) for k, v in converted.items()} == \
           {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert size_knobs_from_params(zeros) == {"nnunet_widths": (32, 64, 128, 256, 320)}


def test_init_is_seeded_and_matches_jax_scales():
    """Same generator seed → same weights; the He / LeCun scales follow the
    JAX initialisers (std within 5% on the widest layers)."""
    a = registry.init_multitask_model("MTnnUNet", generator=torch.Generator().manual_seed(3))
    b = registry.init_multitask_model("MTnnUNet", generator=torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    conv = a.backbone.encoder5.block2.conv.weight  # fan_in 9*320
    assert abs(conv.std().item() / np.sqrt(2 / (9 * 320)) - 1) < 0.05
    up = a.backbone.upsample5.weight  # fan_in 4*320, truncated normal
    assert abs(up.std().item() / np.sqrt(1 / (4 * 320)) - 1) < 0.05
    assert up.abs().max().item() <= 2 * np.sqrt(1 / (4 * 320)) / 0.87962566103423978 + 1e-6
    assert all(m.bias.abs().sum() == 0 for m in a.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)) and m.bias is not None)


@pytest.mark.parametrize("factory,arch", [
    (registry.init_segmentation_model, "ResidualUNet"),
    (registry.init_segmentation_model, "UNet"),
    (registry.init_segmentation_model, "SegResNet"),
    (registry.init_segmentation_model, "SwinUNETR"),
])
def test_unported_architectures_raise(factory, arch):
    """These architectures build and answer a 32² batch with one full-size
    map (held against JAX in ``tests/test_torch_seg_zoo.py``)."""
    model = factory(arch, width=4, size=32).eval()
    with torch.inference_mode():
        assert model(torch.zeros(1, 1, 32, 32)).shape == (1, 1, 32, 32)


def test_unknown_architecture_and_bad_widths_raise():
    with pytest.raises(ValueError, match="Unknown"):
        registry.init_multitask_model("NoSuchNet")
    with pytest.raises(ValueError, match="5 level widths"):
        registry.init_multitask_model("MTnnUNet", nnunet_widths=[4, 8])
