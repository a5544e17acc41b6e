"""A copy of the benchmark's folder at CPU size, for the tests: the same
cells, traffic kinds, readers and reference, with narrow models, 32²
scans and a handful of rows."""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

from benchmark import harness

TINY_FOLD = {"train": {"benign": 4, "malignant": 3, "normal": 3},
             "oversampling": {"benign": 1, "malignant": 2, "normal": 1},
             "val": {"benign": 2, "malignant": 1, "normal": 1}}
SIZE = 32
NARROW = [4, 8, 8, 16, 16]


def _edit(path: Path, fn) -> None:
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data))


def tiny_root(tmp: Path, narrow: bool = True, size: int = SIZE) -> Path:
    """``tmp/benchmark``: the folder with every configuration and cell cut to
    CPU size (``narrow`` False keeps MTnnUNet's widths, for the card)."""
    root = tmp / "benchmark"
    shutil.copytree(harness.HERE, root, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache", "tests"))

    def config(c):
        c["size"] = size
        for kw in (c["port_kwargs"], c["reference_kwargs"]):
            kw.update({"size": size} if c["architecture"] == "SwinUNETR" else {})
        if c["architecture"] == "MTnnUNet" and narrow:
            c["port_kwargs"]["nnunet_widths"] = NARROW
            c["reference_kwargs"]["widths"] = NARROW

    for path in (root / "configs").glob("*.json"):
        _edit(path, config)

    def cell(w):
        p = w["params"]
        if "fold" in p:
            p["fold"] = dict(TINY_FOLD)
            p["batch"] = min(p["batch"], 3)
        if "pool" in p:
            p.update(pool=8, sample=6, rate=20.0, knee=25.0, warm_s=0.5)

    for path in (root / "workloads").glob("*.json"):
        _edit(path, cell)
    return root


SERVING = "mtnnunet.serve.poisson"
SWIN = "swinunetr.train.b2"


def with_left_out(bench: dict) -> dict:
    """``bench`` with the cells that ``BENCHMARK.json`` leaves out (PERF.md
    says why) entered as a later benchmark change would enter them: the
    SwinUNETR training cell with its configuration, and the serving cell
    with its end-to-end metric and its per-layer metrics."""
    bench = json.loads(json.dumps(bench))
    bench["configs"].append({"name": "swinunetr", "source": "x",
                             "file": "benchmark/configs/swinunetr.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": SWIN, "config": "swinunetr",
                               "traffic": "engine_epochs.b2", "chips": 1, "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] != "norm_roofline" and "workloads" in m:
            m["workloads"].append(SWIN)
    bench["workloads"].append({"name": SERVING, "config": "mtnnunet",
                               "traffic": "open_loop_http", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "serve_p95_ms", "unit": "ms", "better": "lower",
                                "bound": 0.25, "source": "host_clock", "workloads": [SERVING]})
    for name, unit in (("handler_p95_ms.serve", "ms"), ("images_per_batch.serve", "images"),
                       ("device_idle_pct.serve", "%")):
        bench["per_layer"].append({"name": name, "unit": unit, "better": "lower",
                                   "source": "device_trace", "layer": "x",
                                   "moves": "serve_p95_ms", "workloads": [SERVING]})
    return bench


def args(cell: str, seed: int = 7, seconds: float = 0.0, trace: int = 0):
    return argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace)
