"""Nothing the benchmark runs loads JAX, flax or the JAX package, and the
reference loads nothing of the port: checked in fresh interpreters, by each
loaded module's top-level name compared whole (the port's name begins with
the JAX package's)."""

import json
import subprocess
import sys

from benchmark import harness

PORT = "multi_task_breast_cancer_tpu_torch"


def _loaded(code: str) -> list:
    proc = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                           "print(json.dumps(sorted(sys.modules)))"],
                          cwd=harness.REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_names_are_compared_whole():
    assert harness.forbidden_modules(["jax", "jaxlib.xla", "flax.linen",
                                      "multi_task_breast_cancer_tpu.models", PORT,
                                      PORT + ".ops", "jaxtyping", "numpy"]) == [
        "flax.linen", "jax", "jaxlib.xla", "multi_task_breast_cancer_tpu.models"]


def test_the_harness_and_a_whole_run_load_no_jax(tmp_path):
    code = f"""
import sys, torch
sys.path.insert(0, '.')
torch.set_num_threads(2)
from pathlib import Path
from benchmark import calibrate, counters, data, harness, knee, run, trace
from benchmark.reference import models, serve, train
from benchmark.tests import tiny
root = tiny.tiny_root(Path({str(tmp_path)!r}))
for kind in ('engine_epochs', 'open_loop_http'):
    harness.traffic_driver(kind, root)
for path in (root / 'metrics').glob('*.py'):
    harness.metric_reader(path.stem, root)
bench = tiny.with_left_out(harness.spec())
for cell in ('mtnnunet.train.b2', tiny.SERVING):
    assert run.run(tiny.args(cell, seconds=0.5), device='cpu', root=root, bench=bench)['correct']
"""
    loaded = _loaded(code)
    assert harness.forbidden_modules(loaded) == []
    assert PORT in loaded  # the run did drive the port


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded("from benchmark.reference import models, serve, train")
    assert harness.forbidden_modules(loaded) == []
    assert not [m for m in loaded if m.split(".", 1)[0] == PORT]
