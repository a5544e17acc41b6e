"""Run one cell of the benchmark once:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout of the repository, on a machine with the cards
the cell asks for. The last line of standard output is the result object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``; the compared numbers under ``checks``,
last); the last lines of standard error give each compared number beside
its limit. Without the cards, or with JAX loaded once the window has closed,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Optional  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark import harness  # noqa: E402


@dataclasses.dataclass
class Context:
    """What a traffic driver gets: the cell, its configuration, the run's
    arguments, the device, and when the process started."""
    name: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    engine_hook: Optional[Callable] = None  # tests plant faults through it
    backend_hook: Optional[Callable] = None

    def log(self, text: str) -> None:
        print(text, file=sys.stderr, flush=True)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(args: argparse.Namespace, *, device: str = "cuda", root: Path = harness.HERE,
        bench: Optional[dict] = None, t_start: float = T_START, **hooks) -> Optional[dict]:
    """One run of a cell; the result object, or ``None`` (with the reason on
    standard error) where there is no result to give. ``device="cpu"``
    skips the look for a card (the tests drive a run that way)."""
    harness.cache_environment()
    bench = harness.spec() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"benchmark: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return None
    cell = harness.workload(args.workload, root)
    if cell["traffic"] != entry["traffic"]:
        print(f"benchmark: {args.workload!r} runs traffic {cell['traffic']!r}, "
              f"BENCHMARK.json names {entry['traffic']!r}", file=sys.stderr)
        return None
    import torch
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < entry["chips"]):
        print(f"benchmark: the cell needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return None
    ctx = Context(name=args.workload, workload=cell, config=harness.config(cell["config"], root),
                  seed=int(args.seed) % 2 ** 63, seconds=float(args.seconds),
                  trace=bool(args.trace), device=device, t_start=t_start, **hooks)
    out = harness.traffic_driver(harness.traffic_kind(cell["traffic"]), root).run(ctx)
    if device == "cuda":
        ctx.log(f"card: {harness.power_limit()}")
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: JAX or the JAX package is loaded: {', '.join(found)}",
              file=sys.stderr)
        return None
    if ctx.trace:
        if out["record"] is None:
            print("benchmark: the profiled window lost its markers", file=sys.stderr)
            return None
        metrics = harness.per_layer_values(bench, ctx.name, out["record"], root)
    else:
        values = dict(out["e2e"], setup_s=out["setup_s"])
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in harness.cell_metrics(bench, ctx.name, traced=False)}
    dev = (harness.device_description(torch, entry["chips"], out["peak_bytes"])
           if device == "cuda" else {"platform": "cpu", "kind": "cpu", "count": 1,
                                     "memory_peak_bytes": 0})
    breakdown = None
    if ctx.trace:
        from benchmark import trace
        dev["busy_s"] = out["traced"]["busy_s"]
        dev["window_s"] = out["traced"]["window_s"]
        breakdown = trace.breakdown(out["traced"])
    correct = out["failed"] == 0 and all(value <= limit for _, value, limit in out["checks"])
    return harness.result(correct, out["attempted"], out["failed"], metrics, dev,
                          out["checks"], breakdown)


def main(argv=None) -> int:
    args = parse(argv)
    res = run(args)
    if res is None:
        return 3
    for line in harness.checks_text([(k, v["value"], v["limit"])
                                     for k, v in res["checks"].items()]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
