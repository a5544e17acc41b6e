"""The U-Mamba_Enc cell: a run through the harness at a CPU cut of its own,
the scan sites read from the plain reference, the scan's bounds, and
``selective_scan_roofline``'s reader on made-up records."""

import json
import shutil

import pytest
import torch

from benchmark import counters, harness, run, umamba_counts
from benchmark.tests import tiny

CELL = "umamba_enc.train.b2"
NARROW = [4, 8, 16, 32, 32]  # stages 0-2 patch tokens, 3-4 channel tokens at 32²
FWD = "(anonymous namespace)::selective_scan_forward_kernel(ScanInputs, ForwardOutputs)"
BWD = "(anonymous namespace)::selective_scan_backward_kernel(ScanInputs, BackwardArgs)"
RED = "(anonymous namespace)::selective_scan_reduce_kernel(float const*, float const*)"


@pytest.fixture(scope="module")
def umamba_root(tmp_path_factory):
    """The CPU-size folder with U-Mamba_Enc cut to five narrow stages at
    32² (the shared cut keeps its widths)."""
    root = tmp_path_factory.mktemp("umamba") / "benchmark"
    shutil.copytree(tiny.tiny_root(root.parent / "base"), root)
    path = root / "configs" / "umamba_enc.json"
    config = json.loads(path.read_text())
    config["port_kwargs"].update(size=tiny.SIZE, nnunet_widths=NARROW)
    config["reference_kwargs"].update(size=tiny.SIZE, widths=NARROW)
    path.write_text(json.dumps(config))
    return root


def test_the_cell_runs_correct_at_cpu_size(umamba_root):
    res = run.run(tiny.args(CELL, seconds=0.5), device="cpu", root=umamba_root)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"train_images_per_s", "setup_s"}
    assert res["attempted"] > 0 and res["failed"] == 0


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(umamba_root, monkeypatch):
    """No first moment and no change: the median leaf's gaps read 1."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    res = run.run(tiny.args(CELL, seconds=0.1), device="cpu", root=umamba_root)
    assert not res["correct"]
    for name in ("grad_median_gap", "change_median_gap"):
        assert res["checks"][name]["value"] == pytest.approx(1.0)


def test_scan_sites_of_the_cell_are_pixel_then_channel_tokens():
    sites = umamba_counts.scan_sites(torch, harness.config("umamba_enc"))
    assert sites == [(64, 16384, 16), (128, 4096, 16), (256, 1024, 16), (512, 256, 16),
                     (128, 512, 16), (32, 512, 16)]
    # B·d_inner·L·N at batch 2: the port's umamba.scan_elements of a forward
    assert sum(2 * dn * steps * n for dn, steps, n in sites) == 65_536_000


def test_scan_bounds_are_a_hand_count():
    """Stage 0 at batch 2: 2·16,384·64 rows of u, δ̂, z read and y written,
    2·16,384 rows of 16 B and 16 C read, A, D and the bias read; the bytes
    bound it (7 operations an element at 67 TFLOP/s lie below). The
    backward reads dy too and writes every gradient."""
    site = [(64, 16384, 16)]
    rows, bc = 2 * 16384 * 64, 2 * 16384 * 16
    fwd = 4 * (4 * rows + 2 * bc + 64 * 16 + 2 * 64)
    bwd = 4 * (7 * rows + 4 * bc + 2 * 64 * 16 + 4 * 64)
    assert umamba_counts.scan_forward_bound_s(site, 2) == pytest.approx(fwd / 3.35e12)
    assert umamba_counts.scan_backward_bound_s(site, 2) == pytest.approx(bwd / 3.35e12)
    assert fwd / 3.35e12 > 7 * rows * 16 / counters.PEAK_FLOPS["float32"]


def _record(steps=10, fwd=None, bwd=None, red=None, **kw):
    rec = {"kind": "train", "window_s": 2.0, "busy_s": 1.5, "steps": steps, "batch": 2,
           "images_trained": 2 * steps, "images_validated": 68, "canvas": 128,
           "norm_sites": [], "kernels": {
               FWD: (0.004, 6 * (steps + 1) if fwd is None else fwd),
               BWD: (0.010, 6 * steps if bwd is None else bwd),
               RED: (0.001, 6 * steps if red is None else red),
               "sm80_xmma_fprop_implicit_gemm": (1.0, 100)}}
    rec.update(kw)
    return rec


def test_reader_divides_the_bound_of_every_launch_by_their_device_time():
    read = harness.metric_reader("selective_scan_roofline")
    sites = umamba_counts.scan_sites(torch, harness.config("umamba_enc"))
    bound = (10 * (umamba_counts.scan_forward_bound_s(sites, 2)
                   + umamba_counts.scan_backward_bound_s(sites, 2))
             + umamba_counts.scan_forward_bound_s(sites, 68))
    assert read(_record()) == pytest.approx(100 * bound / 0.015)


@pytest.mark.parametrize("counts", [{"fwd": 6 * 10}, {"bwd": 6 * 11}, {"red": 0},
                                    {"steps": 9, "fwd": 6 * 11, "bwd": 6 * 10, "red": 60},
                                    {"kernels": {"conv": (1.0, 5)}}, {"kind": "serve"}])
def test_reader_refuses_launch_counts_that_do_not_match_the_steps(counts):
    """Forward launches other than 6 a step and 6 for the validation, or
    backward or reduction launches other than 6 a step, or none: nothing
    to read."""
    assert harness.metric_reader("selective_scan_roofline")(_record(**counts)) is None
