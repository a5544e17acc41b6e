"""The plain reference against the port's plain path at narrow widths on the
CPU: both forwards, the augmentation bit for bit, one training step, and
the served answer; the control at a size a test run holds, on the card."""

import numpy as np
import pytest
import torch

from benchmark import data, harness
from benchmark.reference import models, serve as S, train as R
from benchmark.tests import tiny


def _pair(config: dict, seed: int = 3):
    from multi_task_breast_cancer_tpu_torch.models import registry
    build = {"multitask": registry.init_multitask_model,
             "segmentation": registry.init_segmentation_model}[config["task"]]
    port = build(config["architecture"], **config["port_kwargs"])
    ref = models.build(config["reference_model"], **config["reference_kwargs"])
    shapes = {n: tuple(t.shape) for n, t in port.state_dict().items()}
    assert shapes == {n: tuple(t.shape) for n, t in ref.state_dict().items()}
    state = data.seeded_state(torch, shapes, seed, "cpu")
    port.load_state_dict(state)
    ref.load_state_dict(state)
    return port, ref


def _scans(n: int, size: int, seed: int = 0):
    images, masks, labels = data.scans(np.random.default_rng(seed),
                                       {"benign": n, "malignant": n, "normal": n}, size)
    return torch.from_numpy(images[:, None]).float(), torch.from_numpy(masks[:, None]).float(), \
        torch.from_numpy(labels)


@pytest.mark.parametrize("name", ["mtnnunet", "swinunetr"])
def test_forward_matches_the_port(tiny_root, name):
    config = harness.config(name, tiny_root)
    port, ref = _pair(config)
    x, _, _ = _scans(1, tiny.SIZE)
    with torch.no_grad():
        got, want = port(x), ref(x)
    if config["task"] == "multitask":
        (got_cls,), got_seg = got
        want_cls, want_seg = want
        torch.testing.assert_close(got_cls, want_cls, rtol=1e-4, atol=1e-5)
        got, want = got_seg[-1], want_seg[-1]
        assert len(got_seg) == len(want_seg) == 4
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_augmentation_matches_the_port_bit_for_bit():
    from multi_task_breast_cancer_tpu_torch.ops import fast_augment as FA
    planes = torch.randn(6, 2, 32, 32)
    packed, fmt = FA.pack_channels(planes.permute(0, 2, 3, 1), "float32")
    rows = torch.tensor([4, 0, 5, 2, 2, 1], dtype=torch.int32)
    gen = torch.Generator().manual_seed(11)
    fh, fv, angle = FA.draw_flips_and_angles(gen, (1, 6), p_hflip=0.5, p_vflip=0.5,
                                             max_angle=360.0)
    factors = FA.pipeline_factors_from_draws(fh.reshape(-1), fv.reshape(-1),
                                             angle.reshape(-1), 32)
    port = FA.unpack_channels_nchw(FA.fast_augment(packed, rows, factors), fmt)
    gen = torch.Generator().manual_seed(11)
    a, b, c = R.draws(gen, 1, 6)
    assert torch.equal(R.augment(planes[rows.long()], a[0], b[0], c[0]), port)


@pytest.mark.parametrize("cell", ["mtnnunet.train.b2", "swinunetr.train.b2"])
def test_a_training_step_matches_the_port(tiny_root, cell):
    import time
    from benchmark.run import Context
    drv = harness.traffic_driver("engine_epochs", tiny_root)
    w = harness.workload(cell, tiny_root)
    ctx = Context(cell, w, harness.config(w["config"], tiny_root), 5, 0.0, False, "cpu",
                  time.perf_counter())
    fold = drv.Fold(5, w["params"], ctx.config)
    *_, prog = drv.program_steps(torch, ctx, fold)
    gaps = drv.readings_gaps(prog, drv.reference_steps(torch, ctx, fold))
    assert gaps["loss_gap"] < 1e-5 and gaps["val_loss_gap"] < 1e-5
    assert gaps["grad_gap"] < 2e-3 and gaps["change_gap"] < 2e-3


def test_the_served_answer_matches_the_reference(tiny_root):
    from multi_task_breast_cancer_tpu_torch.serve.post import postprocess
    port, ref = _pair(harness.config("mtnnunet", tiny_root))
    x, _, _ = _scans(2, tiny.SIZE)
    with torch.no_grad():
        (cls,), seg = port.eval()(x)
    out = ((cls.numpy(),), tuple(s.permute(0, 2, 3, 1).numpy() for s in seg))
    pred = postprocess(out, "multitask", 3, True)
    served = [{"probs": pred.probs[i], "mask": pred.masks[i],
               "predicted_class": pred.pred_class[i]} for i in range(len(x))]
    ref_cls, ref_seg = S.logits(ref, x[:, 0].numpy().astype(np.uint8), "cpu")
    gaps = S.answer_gaps(served, ref_cls, ref_seg)
    assert gaps["answer_gap"] < 1e-5 and gaps["mask_gap"] < 1e-4
    served[0]["predicted_class"] = "malignant" if served[0]["predicted_class"] != "malignant" \
        else "benign"
    assert S.answer_gaps(served, ref_cls, ref_seg)["answer_gap"] > 1e-3


@pytest.mark.cuda
def test_the_control_reads_above_the_program_on_the_card(tmp_path):
    """The control (the reference in TF32 in the program's place) against
    sound runs of the program, at a size a test run holds: MTnnUNet's
    widths at 64², where the convolutions take the tensor cores (at the
    CPU tests' narrow widths TF32 changes nothing). The readings at the
    cells' sizes come from ``benchmark/calibrate.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import calibrate
    root = tiny.tiny_root(tmp_path, narrow=False, size=64)
    rows = list(calibrate.training("mtnnunet.train.b2", [1, 2, 3], 3, 0, root, "cuda"))
    prog = [r for r in rows if r["kind"] == "program"]
    ctrl = [r for r in rows if r["kind"] == "control_tf32"]
    for name in ("loss1_gap", "grad_median_gap"):
        assert max(r[name] for r in prog) < min(r[name] for r in ctrl), name
