"""A run with its timed path broken underneath comes out not correct: the
look for a card skipped, the rest of the run driven at CPU size, once for
each fault a cell can have. (The exchange between chips has no fault to
plant: every cell runs on one chip.)"""

import pytest
import torch

from benchmark import calibrate, harness, run
from benchmark.tests import tiny


@pytest.mark.parametrize("cell", ["mtnnunet.train.b2", "swinunetr.train.b2",
                                  "mtnnunet.train.b64"])
def test_a_step_that_leaves_its_state_unchanged(tiny_root, cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    res = run.run(tiny.args(cell, seconds=0.1), device="cpu", root=tiny_root,
                  bench=tiny.with_left_out(harness.spec()))
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["mtnnunet.train.b2", "swinunetr.train.b2",
                                  "mtnnunet.train.b64"])
def test_half_of_the_batch_left_out(tiny_root, cell):
    res = run.run(tiny.args(cell, seconds=0.1), device="cpu", root=tiny_root,
                  bench=tiny.with_left_out(harness.spec()), engine_hook=calibrate.half_batch)
    assert not res["correct"]


def _altered(backend):
    post = backend.postprocess

    def postprocess(out):
        pred = post(out)
        pred.masks ^= 1  # every mask inverted
        return pred

    backend.postprocess = postprocess


def test_an_answer_altered_where_it_is_produced(tiny_root):
    res = run.run(tiny.args(tiny.SERVING, seconds=1.0), device="cpu", root=tiny_root,
                  bench=tiny.with_left_out(harness.spec()), backend_hook=_altered)
    assert not res["correct"]
    assert res["checks"]["mask_gap"]["value"] > res["checks"]["mask_gap"]["limit"]
