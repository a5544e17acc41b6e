"""The port's importer of the reference's PyTorch checkpoints
(``models/torch_import.py``) against the JAX importer, for the nnU-Net
family, the BTS family, ResidualUNet (parameters and running statistics) and
Adityan; and the weight bridge's batch statistics and transposed kernels.

The nnU-Net family's reference ``state_dict`` is built here from the
reference's layer names and shapes at narrow widths, with seeded tensors (no
reference checkpoint is in the repository); nnUNetClassifier's carries the
dead decoders 4..1 that the importers drop. The BTS family's and Adityan's
take the reference names the port's mappers read and the port model's
shapes (a reference layer and the port's share its layout): a name the JAX
importer reads that the port's omits fails the JAX conversion, a name only
the port reads fails the comparison. Held: ``params_from_jax`` of the JAX conversion equals the
port's conversion tensor for tensor, exactly (both only rename and re-lay
copies); the result loads strictly into the port's model built by the
registry (so the shapes here are the models'); the CLI's checkpoint gives
exactly the forward of the model with the converted tensors set directly
(same CPU code, same input).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu.models import torch_import as jax_import
from multi_task_breast_cancer_tpu_torch.config import Config, ModelConfig, config_to_yaml
from multi_task_breast_cancer_tpu_torch.models import registry, torch_import
from multi_task_breast_cancer_tpu_torch.models.jax_weights import params_from_jax
from multi_task_breast_cancer_tpu_torch.train.checkpoint import load_pretrained_model
from multi_task_breast_cancer_tpu_torch.train.state import create_train_state

WIDTHS = (4, 8, 8, 16, 16)


def reference_state_dict(arch: str, widths=WIDTHS, n_out: int = 3, seed: int = 0) -> dict:
    """A reference-named ``state_dict`` of seeded tensors: ``LevelBlock``s of
    two ``ConvInNormLRelu`` (bias-free 3×3 convs), stride-2
    ``ConvTranspose2d`` upsamplers, ``Sequential(ConvTranspose2d, Conv2d
    1×1)`` deep-supervision heads and the ``classifier`` Sequential."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    w = widths

    def rnd(*shape):
        return torch.randn(*shape, generator=gen)

    def level(name, cin, mid, cout):
        sd[f"{name}.ConvInNormLRelu1.Conv.weight"] = rnd(mid, cin, 3, 3)
        sd[f"{name}.ConvInNormLRelu2.Conv.weight"] = rnd(cout, mid, 3, 3)

    def layer(name, weight_shape, bias):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = rnd(*weight_shape), rnd(bias)

    ins = (1, w[0], w[1], w[2], w[3])
    for i in range(5):
        level(f"encoder{i + 1}", ins[i], w[i], w[i])
    level("bottleneck", w[4], w[4], w[4])
    for i in range(4, -1, -1):
        out = w[i - 1] if i else w[0] // 2
        level(f"decoder{i + 1}", 2 * w[i], w[i - 1] if i else w[0], out)
        layer(f"upsample{i + 1}", (w[i], w[i], 2, 2), w[i])
    if arch in ("nnUNet", "MTnnUNet"):
        for i, k in ((4, 8), (3, 4), (2, 2)):
            layer(f"output{i}.0", (w[i - 2], w[i - 2], k, k), w[i - 2])
            layer(f"output{i}.1", (1, w[i - 2], 1, 1), 1)
        layer("output1", (1, w[0] // 2, 1, 1), 1)
    if arch in ("MTnnUNet", "nnUNetClassifier"):
        sd["process_encoder_5.Conv.weight"] = rnd(w[4], w[4], 3, 3)
        sd["process_decoder_5.Conv.weight"] = rnd(w[4], w[3], 3, 3)
        sd["classifier.0.Conv.weight"] = rnd(512, 3 * w[4], 3, 3)
        layer("classifier.3", (256, 512), 256)
        layer("classifier.5", (n_out, 256), n_out)
    return sd


def _port_model(arch: str, deep_supervision: bool = False):
    if arch == "MTnnUNet":
        return registry.init_multitask_model(arch, nnunet_widths=WIDTHS,
                                             deep_supervision=deep_supervision)
    if arch == "nnUNet":
        return registry.init_segmentation_model(arch, nnunet_widths=WIDTHS,
                                                deep_supervision=deep_supervision)
    return registry.init_classification_model(arch, n_classes=3, nnunet_widths=WIDTHS)


@pytest.mark.parametrize("arch,deep_supervision", [
    ("MTnnUNet", False), ("MTnnUNet", True), ("nnUNet", False), ("nnUNet", True),
    ("nnUNetClassifier", False),
])
def test_convert_matches_the_jax_importer(arch, deep_supervision):
    sd = reference_state_dict(arch)
    params, stats = jax_import.convert_state_dict(arch, sd, deep_supervision=deep_supervision)
    assert stats == {}
    want = params_from_jax(params, _port_model(arch, deep_supervision))
    got = torch_import.convert_state_dict(arch, sd)
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    _port_model(arch, deep_supervision).load_state_dict(got, strict=True)
    if arch == "nnUNetClassifier":
        assert "decoder4.ConvInNormLRelu1.Conv.weight" in sd and not any(
            k.startswith(("decoder4", "upsample4")) for k in got)
    first = next(iter(got))
    got[first].add_(1.0)  # a copy: the reference's tensor stays as it was
    assert torch.equal(torch_import.convert_state_dict(arch, sd)[first], want[first])


@pytest.mark.parametrize("arch", ["ResidualUNet"])
def test_the_rest_of_the_zoo_waits_for_its_models(arch):
    """Nothing waits any more: the port maps every architecture the JAX
    importer maps, ResidualUNet included, and an empty ``state_dict`` is a
    missing key, not a missing model."""
    assert arch in jax_import._MAPPERS and set(torch_import._MAPPERS) == set(jax_import._MAPPERS)
    with pytest.raises(KeyError, match="not found while importing 'ResidualUNet'"):
        torch_import.convert_state_dict(arch, {})


ZOO_WIDTH, ZOO_SIZE = 4, 32


def _zoo_model(arch: str, deep_supervision: bool):
    if arch in registry.SEGMENTATION_ARCHS:
        return registry.init_segmentation_model(arch, width=ZOO_WIDTH,
                                                deep_supervision=deep_supervision)
    if arch in registry.CLASSIFICATION_ARCHS:
        return registry.init_classification_model(arch, width=ZOO_WIDTH, size=ZOO_SIZE)
    return registry.init_multitask_model(arch, width=ZOO_WIDTH, size=ZOO_SIZE,
                                         deep_supervision=deep_supervision)


def zoo_reference_state_dict(arch: str, deep_supervision: bool, seed: int = 0) -> dict:
    """Seeded tensors under the reference's names, in the port model's shapes."""
    shapes = {k: v.shape for k, v in _zoo_model(arch, deep_supervision).state_dict().items()}
    gen = torch.Generator().manual_seed(seed)
    return {ref: torch.randn(shapes[port], generator=gen) for port, ref, *_ in
            torch_import._MAPPERS[arch](deep_supervision=deep_supervision, width=ZOO_WIDTH)}


@pytest.mark.parametrize("arch,deep_supervision", [
    ("BTSUNet", False), ("BTSUNet", True), ("FSBBTSUNet", False), ("FSBBTSUNet", True),
    ("BTSUNetClassifier", False), ("Multi_BTSUNet", True), ("Multi_FSB_BTSUNet", False),
    ("Multi_FSB_BTSUNet", True), ("Adityan", False),
])
def test_zoo_convert_matches_the_jax_importer(arch, deep_supervision):
    """Tensor for tensor equal to ``params_from_jax`` of JAX's conversion,
    the flattened dense layers' (c, h, w) → (h, w, c) permutation (JAX's
    ``_dense_after_flatten``) included; loads strictly into the registry's
    model."""
    sd = zoo_reference_state_dict(arch, deep_supervision)
    params, stats = jax_import.convert_state_dict(arch, sd, deep_supervision=deep_supervision,
                                                  width=ZOO_WIDTH)
    assert stats == {}
    want = params_from_jax(params, _zoo_model(arch, deep_supervision))
    got = torch_import.convert_state_dict(arch, sd, deep_supervision=deep_supervision,
                                          width=ZOO_WIDTH)
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    _zoo_model(arch, deep_supervision).load_state_dict(got, strict=True)
    dense = [k for k in got if k.endswith("classifier.fc1.weight")]
    assert bool(dense) == arch.startswith(("BTSUNetClassifier", "Multi"))
    for k in dense:  # the permutation is not the identity
        assert not torch.equal(got[k], sd["classifier.1.weight"])


def test_unknown_architectures_and_missing_keys_raise():
    with pytest.raises(ValueError, match="supported architectures"):
        torch_import.convert_state_dict("UNet", {})
    sd = reference_state_dict("nnUNet")
    del sd["output1.bias"]
    with pytest.raises(KeyError, match="output1.bias"):
        torch_import.convert_state_dict("nnUNet", sd)


@pytest.mark.parametrize("wrapped", [True, False])
def test_cli_writes_a_checkpoint_of_the_port(tmp_path, monkeypatch, wrapped):
    """``main`` on the reference's ``torch.save`` dict (or a bare
    ``state_dict``): the written checkpoint is the converted weights; a
    config of other widths is refused; without a GPU it raises unless asked
    for the CPU."""
    sd = reference_state_dict("MTnnUNet")
    ref = tmp_path / "ref_fold_0"
    torch.save({"epoch": 7, "val_loss": 0.5, "model_state_dict": sd} if wrapped else sd, ref)
    cfg = tmp_path / "config.yaml"
    cfg.write_text(config_to_yaml(Config(model=ModelConfig(architecture="MTnnUNet",
                                                           nnunet_widths=list(WIDTHS)))))
    out = tmp_path / "model_fold_0"
    argv = ["--config", str(cfg), "--torch-checkpoint", str(ref), "--out", str(out)]
    torch_import.main(argv + ["--device", "cpu"])
    # --size, as the JAX tool's: MTnnUNet takes any size (a flatten head does not)
    torch_import.main(argv[:-1] + [str(tmp_path / "at_256"), "--device", "cpu",
                                   "--size", "256"])

    model = _port_model("MTnnUNet")
    model.load_state_dict(torch_import.convert_state_dict("MTnnUNet", sd))
    loaded = load_pretrained_model(create_train_state(_port_model("MTnnUNet"), "Adam", 1e-3),
                                   str(out)).model
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 255, (2, 1, 32, 32))
                         .astype(np.float32))
    with torch.inference_mode():
        (want,), want_seg = model.eval()(x)
        (got,), got_seg = loaded.eval()(x)
    assert torch.equal(got, want) and all(torch.equal(a, b) for a, b in zip(got_seg, want_seg))
    payload = torch.load(out, weights_only=True)
    assert (payload["epoch"], payload["val_loss"]) == ((7, 0.5) if wrapped else (0, float("inf")))

    cfg.write_text(config_to_yaml(Config(model=ModelConfig(architecture="MTnnUNet",
                                                           nnunet_widths=[4, 8, 8, 16, 32]))))
    with pytest.raises(ValueError, match="shape mismatch"):
        torch_import.main(argv + ["--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_import.main(argv)


def test_cli_imports_a_flatten_head_at_its_size(tmp_path):
    """BTSUNetClassifier's dense layer fixes the input side: ``--size 32``
    imports a 32² reference checkpoint, the default 128 is refused."""
    sd = zoo_reference_state_dict("BTSUNetClassifier", False)
    ref = tmp_path / "ref_fold_0"
    torch.save(sd, ref)
    cfg = tmp_path / "config.yaml"
    cfg.write_text(config_to_yaml(Config(model=ModelConfig(architecture="BTSUNetClassifier",
                                                           width=ZOO_WIDTH))))
    argv = ["--config", str(cfg), "--task", "classification", "--torch-checkpoint", str(ref),
            "--device", "cpu"]
    torch_import.main(argv + ["--out", str(tmp_path / "out"), "--size", str(ZOO_SIZE)])
    loaded = load_pretrained_model(
        create_train_state(_zoo_model("BTSUNetClassifier", False), "Adam", 1e-3),
        str(tmp_path / "out")).model
    want = torch_import.convert_state_dict("BTSUNetClassifier", sd, width=ZOO_WIDTH)
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in want.items())
    with pytest.raises(ValueError, match="shape mismatch"):
        torch_import.main(argv + ["--out", str(tmp_path / "out128")])


def test_residual_unet_convert_matches_the_jax_importer(tmp_path):
    """Parameters and running statistics, tensor for tensor equal to
    ``params_from_jax`` of JAX's ``(params, batch_stats)``; the reference's
    ``num_batches_tracked`` and dead ``decoder.conv1-3`` dropped as JAX drops
    them; the CLI's checkpoint carries the running statistics."""
    sd = zoo_reference_state_dict("ResidualUNet", False)
    sd = {k: v.abs() + 0.5 if k.endswith("running_var") else v for k, v in sd.items()}
    for k in [k for k in sd if k.endswith("running_mean")]:
        sd[k.replace("running_mean", "num_batches_tracked")] = torch.tensor(12)
    for i in (1, 2, 3):
        sd[f"decoder.conv{i}.weight"] = torch.ones(1, 1, 3, 3)
    params, stats = jax_import.convert_state_dict("ResidualUNet", sd, width=ZOO_WIDTH)
    model = _zoo_model("ResidualUNet", False)
    want = params_from_jax({"params": params, "batch_stats": stats}, model)
    got = torch_import.convert_state_dict("ResidualUNet", sd, width=ZOO_WIDTH)
    assert sorted(got) == sorted(want) == sorted(model.state_dict())
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert torch.equal(got["up_block1.bn2.bn.var"], sd["decoder.up_block1.bn2.running_var"])
    assert torch.equal(got["in_block.bn1.bn.scale"], sd["in_block.bn1.weight"])

    ref = tmp_path / "ref_fold_0"
    torch.save({"epoch": 3, "val_loss": 0.25, "model_state_dict": sd}, ref)
    cfg = tmp_path / "config.yaml"
    cfg.write_text(config_to_yaml(Config(model=ModelConfig(architecture="ResidualUNet",
                                                           width=ZOO_WIDTH))))
    torch_import.main(["--config", str(cfg), "--task", "segmentation", "--torch-checkpoint",
                       str(ref), "--out", str(tmp_path / "out"), "--device", "cpu"])
    loaded = load_pretrained_model(create_train_state(_zoo_model("ResidualUNet", False),
                                                      "Adam", 1e-3), str(tmp_path / "out")).model
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in got.items())


def test_batch_stats_bridge_both_ways():
    """``batch_stats/<path>/mean|var`` (nested, or flat as a JAX artifact's
    ``weights.npz`` writes it) ↔ the buffers ``<path>.mean|var``; a
    ``flat_jax_weights`` dump lists them under ``batch_stats/``."""
    from multi_task_breast_cancer_tpu_torch.models.jax_weights import (
        flat_jax_weights,
        variables_to_jax,
    )

    model = registry.init_segmentation_model("ResidualUNet", width=ZOO_WIDTH,
                                             generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    for buf in model.buffers():
        buf.copy_(torch.rand(buf.shape, generator=gen))
    flat = flat_jax_weights(model.state_dict(), model)
    stats = {k for k in flat if k.startswith("batch_stats/")}
    assert "batch_stats/in_block/bn1/bn/var" in stats
    assert len(stats) == len(list(model.buffers())) == 2 * 20
    assert all(k.startswith("params/") for k in set(flat) - stats)
    variables = variables_to_jax(model.state_dict(), model)
    assert set(variables) == {"params", "batch_stats"}
    for tree in (flat, variables):
        back = params_from_jax(tree, model)
        assert sorted(back) == sorted(model.state_dict())
        assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())


def test_transposed_kernels_found_by_type_not_name():
    """Which 4-D kernel is a transposed conv is read from the model's
    modules: UNet's ``up1.conv``, AttentionUNet's ``up1`` and SwinUNETR's
    ``decoder1.up`` are transposed; a plain conv named ``upsample`` is not."""
    from torch import nn

    from multi_task_breast_cancer_tpu_torch.models.jax_weights import (
        transposed_convs,
        variables_to_jax,
    )

    assert {"up1.conv", "up2.conv", "up3.conv"} <= transposed_convs(
        registry.init_segmentation_model("UNet", width=ZOO_WIDTH))
    assert "up1" in transposed_convs(registry.init_segmentation_model("AttentionUNet",
                                                                      width=ZOO_WIDTH))
    assert "decoder1.up" in transposed_convs(registry.init_segmentation_model(
        "SwinUNETR", size=ZOO_SIZE))
    holder = nn.Module()
    holder.upsample = nn.Conv2d(2, 3, 2)
    holder.up = nn.ConvTranspose2d(2, 3, 2, stride=2)
    assert transposed_convs(holder) == {"up"}
    params = variables_to_jax(holder.state_dict(), holder)["params"]
    hwio = np.asarray(holder.upsample.weight.detach()).transpose(2, 3, 1, 0)
    np.testing.assert_array_equal(params["upsample"]["kernel"], hwio)  # a conv's layout
    flipped = np.asarray(holder.up.weight.detach()).transpose(2, 3, 0, 1)[::-1, ::-1]
    np.testing.assert_array_equal(params["up"]["kernel"], flipped)
    back = params_from_jax(params, holder)
    assert all(torch.equal(back[k], v) for k, v in holder.state_dict().items())
