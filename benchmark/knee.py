"""The knee of a serving cell: the highest offered rate its server sustains
without a growing backlog, by a sweep on the card, with one server:

    python benchmark/knee.py --workload <cell> --seed <n> --rates 200,400,... [--seconds 6]

For each rate (open-loop Poisson arrivals from the seed, as the cell's
runs offer them) it prints one JSON line: the rate offered, the answers
per second over the stretch from the first due time to the last answer,
the latency's median and 95th percentile from the due time, the median of
the last fifth of the requests over that of the first fifth (a backlog
that grows through the stretch shows as a ratio well above 1), failures,
and how late the client sent. The cell's workload file records the knee
this finds and the rate it serves at, as numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark import data, harness  # noqa: E402
from benchmark.run import Context  # noqa: E402


def sweep(ctx: Context, rates, seconds: float):
    import torch
    drv = harness.traffic_driver("open_loop_http", harness.HERE)
    params = ctx.workload["params"]
    pool = drv.schedule(ctx, params)[0]
    server = drv.start_server(torch, ctx, params)
    try:
        drv._warm(server.port, pool)
        for k, rate in enumerate(rates):
            due = data.arrivals(ctx.seed + k, rate, seconds)
            image = np.random.default_rng(ctx.seed + k).integers(0, len(pool), len(due))
            start = time.monotonic() + drv.LEAD_S
            with tempfile.TemporaryDirectory() as workdir:
                res = drv.offer(server.port, pool, due, image, [], start, workdir)
            lat = np.asarray([np.nan if v is None else v for v in res["latency_s"]]) * 1e3
            ok = ~np.isnan(lat)
            fifth = max(len(lat) // 5, 1)
            first, last = np.nanmedian(lat[:fifth]), np.nanmedian(lat[-fifth:])
            span = float(np.nanmax(due + lat / 1e3)) if ok.any() else float("nan")
            yield {"rate": rate, "requests": len(due), "failed": int((~ok).sum()),
                   "answered_per_s": float(ok.sum() / span),
                   "p50_ms": float(np.nanpercentile(lat, 50)),
                   "p95_ms": drv.tail_ms(res["latency_s"], res["wait_s"]),
                   "backlog_ratio": float(last / first),
                   "late_p99_ms": float(np.percentile(np.asarray(res["late_s"]) * 1e3, 99))}
    finally:
        server.__exit__(None, None, None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests/s")
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    harness.cache_environment()
    w = harness.workload(args.workload)
    ctx = Context(name=args.workload, workload=w, config=harness.config(w["config"]),
                  seed=args.seed, seconds=args.seconds, trace=False, device="cuda",
                  t_start=time.perf_counter())
    for row in sweep(ctx, [float(r) for r in args.rates.split(",")], args.seconds):
        print(json.dumps({"cell": args.workload, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
