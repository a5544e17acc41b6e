"""The harness's shared parts: cells, configurations, traffic drivers and
per-layer metric readers found by name under this folder; the run's
environment; the guard against JAX in the process; and the result line.

Everything of one cell, configuration, traffic kind or per-layer metric sits
in files of its own, found by the name ``BENCHMARK.json`` gives:

- ``workloads/<cell>.json``: the configuration, the traffic mix (named
  ``<kind>.<mix>``, as ``BENCHMARK.json`` names it) and its parameters,
  the limits of the correctness check, and ``why``;
- ``configs/<config>.json``: the model as it is run, with its source;
- ``traffic/<kind>.py``: the driver of that kind of traffic (``run(ctx)``);
- ``metrics/<metric>.py``: ``read(record)``, the metric from a traced run's
  record, or ``None`` where the record has nothing for it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, Iterable, List, Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "multi_task_breast_cancer_tpu")
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(repo: Path = REPO) -> dict:
    """``BENCHMARK.json``."""
    return load_json(repo / "BENCHMARK.json")


def workload(name: str, root: Path = HERE) -> dict:
    return load_json(root / "workloads" / f"{_checked(name)}.json")


def config(name: str, root: Path = HERE) -> dict:
    return load_json(root / "configs" / f"{_checked(name)}.json")


def _module(path: Path, label: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(path)
    mod_name = "benchmark_" + re.sub(r"\W", "_", label)
    loaded = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(loaded)
    loaded.loader.exec_module(module)
    return module


def traffic_kind(traffic: str) -> str:
    """The driver of a traffic mix: its name up to the first dot
    (``engine_epochs.b2`` is driven by ``traffic/engine_epochs.py``)."""
    return _checked(traffic).split(".", 1)[0]


def traffic_driver(kind: str, root: Path = HERE) -> ModuleType:
    """``traffic/<kind>.py``; its ``run(ctx)`` runs one cell once."""
    return _module(root / "traffic" / f"{_checked(kind)}.py", f"traffic_{kind}")


def metric_reader(name: str, root: Path = HERE) -> Callable[[dict], Optional[float]]:
    """``metrics/<name>.py``'s ``read``."""
    return _module(root / "metrics" / f"{_checked(name)}.py", f"metric_{name}").read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(bench: dict, cell: str, traced: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1``."""
    return [m for m in bench["per_layer" if traced else "end_to_end"] if _applies(m, cell)]


def per_layer_values(bench: dict, cell: str, record: dict, root: Path = HERE) -> Dict[str, dict]:
    """Each of the cell's per-layer metrics that its reader finds in
    ``record``; a reader that finds nothing leaves its metric out."""
    out = {}
    for m in cell_metrics(bench, cell, traced=True):
        value = metric_reader(m["name"], root)(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    flax's or the JAX package's, compared whole: the port's name begins with
    the JAX package's."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def cache_environment(repo: Path = REPO) -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds; a library that loads JAX by itself
    is told not to. The port builds its own kernels into ``build/`` of the
    checkout."""
    cache = repo / "benchmark" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def device_description(torch, chips: int, peak_bytes: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def checks_text(checks: List[tuple]) -> List[str]:
    """One line per compared number: its name, its reading and its limit."""
    return [f"check {name} {value!r} limit {limit!r}" for name, value, limit in checks]


def result(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
           checks: List[tuple], breakdown: Optional[dict] = None) -> dict:
    """The result line's object; the compared numbers come last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return out
