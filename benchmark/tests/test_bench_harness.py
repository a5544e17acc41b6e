"""The harness finds cells, configurations and per-layer metrics by name,
as new files alone; runs of every cell at CPU size; the result line."""

import hashlib
import json
import re
import shutil
import subprocess
import sys
import time

import pytest

from benchmark import harness, run, trace
from benchmark.tests import tiny


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_configuration_and_metric_are_new_files_only(tiny_root, tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(tiny_root, root)
    before = _digests(root)
    config = json.loads((root / "configs" / "mtnnunet.json").read_text())
    config["name"] = "throwaway"
    (root / "configs" / "throwaway.json").write_text(json.dumps(config))
    cell = json.loads((root / "workloads" / "mtnnunet.train.b2.json").read_text())
    cell["config"] = "throwaway"
    (root / "workloads" / "throwaway.train.b1.json").write_text(json.dumps(cell))
    (root / "metrics" / "throwaway_count.py").write_text(
        "def read(record):\n    return record.get('steps')\n")
    bench = harness.spec()
    bench["configs"].append({"name": "throwaway", "source": "x", "file": "x", "reduced": []})
    bench["workloads"].append({"name": "throwaway.train.b1", "config": "throwaway",
                               "traffic": cell["traffic"], "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "throwaway_count", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "train_images_per_s",
                               "workloads": ["throwaway.train.b1"]})
    bench["end_to_end"][0]["workloads"].append("throwaway.train.b1")

    res = run.run(tiny.args("throwaway.train.b1", seconds=0.2), device="cpu", root=root,
                  bench=bench)
    assert res["correct"] and set(res["metrics"]) == {"train_images_per_s", "setup_s"}
    assert harness.per_layer_values(bench, "throwaway.train.b1", {"steps": 5}, root) == {
        "throwaway_count": {"value": 5.0, "unit": "steps"}}
    after = _digests(root)
    assert {p: d for p, d in after.items() if p in before} == before


@pytest.mark.parametrize("cell", ["mtnnunet.train.b2", "swinunetr.train.b2",
                                  "mtnnunet.train.b64", tiny.SERVING])
def test_every_cell_runs_correct_at_cpu_size(tiny_root, cell):
    bench = tiny.with_left_out(harness.spec())
    res = run.run(tiny.args(cell, seconds=1.0), device="cpu", root=tiny_root, bench=bench)
    assert res["correct"], res["checks"]
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    wanted = {m["name"] for m in harness.cell_metrics(bench, cell, traced=False)}
    assert set(res["metrics"]) == wanted and "setup_s" in wanted
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["attempted"] > 0 and res["failed"] == 0


def _fake_window(torch, fn, attempts=2):
    """The profiled window on the CPU: the stretch runs, and its "device"
    activity is made up."""
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    return {"window_s": host, "busy_s": host / 2, "classes": {"elementwise, reductions": host / 2},
            "gaps": {"cudaGraphLaunch -> convolutions and GEMMs (cuDNN, cuBLAS)": host / 2},
            "kernels": {"conv": (host / 2, 10)}}


@pytest.mark.parametrize("cell", ["mtnnunet.train.b2", tiny.SERVING])
def test_a_traced_line_has_its_breakdown_and_per_layer_metrics(tiny_root, cell, monkeypatch):
    monkeypatch.setattr(trace, "window", _fake_window)
    res = run.run(tiny.args(cell, seconds=1.0, trace=1), device="cpu", root=tiny_root,
                  bench=tiny.with_left_out(harness.spec()))
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert res["correct"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0
    names = set(res["metrics"])
    if cell == tiny.SERVING:
        assert names == {"handler_p95_ms.serve", "images_per_batch.serve", "device_idle_pct.serve"}
    else:  # no kernel of the port by name in the made-up activity: no roofline
        assert names == {"device_idle_pct.train", "train_mfu"}


def test_without_a_card_no_result_and_a_nonzero_exit(capsys):
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "mtnnunet.train.b2", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_a_folder_with_only_the_benchmark_gives_no_result(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path)
    code = ("import sys; sys.path.insert(0, '.'); from benchmark import run; "
            "r = run.run(run.parse(['--workload', 'mtnnunet.train.b2', '--seed', '1', "
            "'--seconds', '1']), device='cpu'); print(r)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "multi_task_breast_cancer_tpu_torch" in proc.stderr


def test_checks_are_printed_with_their_limits():
    assert harness.checks_text([("loss_gap", 1e-6, 1e-4)]) == ["check loss_gap 1e-06 limit 0.0001"]
    res = harness.result(True, 3, 0, {}, {}, [("a", 1.0, 2.0)])
    assert list(res)[-1] == "checks" and res["checks"] == {"a": {"value": 1.0, "limit": 2.0}}


_NAME = r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$"


def test_benchmark_json_keeps_to_its_form():
    bench = harness.spec()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs), "a pair of config and traffic given twice"
    metrics = bench["end_to_end"] + bench["per_layer"]
    for group in ("configs", "workloads"):
        names = [e["name"] for e in bench[group]]
        assert len(set(names)) == len(names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    configs = {c["name"] for c in bench["configs"]}
    assert configs == {w["config"] for w in bench["workloads"]}, "a configuration with no cell"
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert all(re.match(_NAME, w[k]) for k in ("name", "config", "traffic"))
        assert harness.workload(w["name"])["traffic"] == w["traffic"]
        harness.traffic_driver(harness.traffic_kind(w["traffic"]))
    for m in metrics:
        assert re.match(_NAME, m["name"]) and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
        assert "roofline" not in m["name"] or m["name"].endswith("_roofline")
    for m in bench["per_layer"]:
        harness.metric_reader(m["name"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_a_mix_is_driven_by_the_kind_its_name_begins_with():
    assert harness.traffic_kind("engine_epochs.b64") == "engine_epochs"
    assert harness.traffic_kind("open_loop_http") == "open_loop_http"
