"""Readings that the limits of the correctness check are set from, for one
cell, in one process on the card:

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,... [--control N] [--faults N]

For each seed, the numbers a sound run of the program gives (training: the
checked steps, no window; serving: a window of ``--seconds`` at the cell's
rate). For the first N seeds, the control's: the plain reference computed
in TF32, the precision below the configuration's float32, in the program's
place. For a training cell, the first N seeds also with the fault "half of
the batch left out, the mean taken over the rest" planted in the program.
A state left unchanged reads 1 on the change of the parameters and needs
no run. One JSON line per reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark import harness  # noqa: E402
from benchmark.run import Context  # noqa: E402


def half_batch(engine) -> None:
    """Plant the fault: each step trains on the first half of its rows, its
    loss the mean over them."""
    before, shares = engine._step_before_reduce, engine._loss_shares

    def step(model, data, rows, draws, k, shard, n_local):
        h = rows.shape[0] // 2
        return before(model, data, rows[:h], draws, k, slice(shard.start, shard.start + h), h)

    engine._step_before_reduce = step
    engine._loss_shares = lambda out, masks, targets, n_local, n_global: shares(
        out, masks, targets, n_local, n_local)


def _ctx(cell: str, seed: int, seconds: float, root: Path, device: str, **hooks) -> Context:
    w = harness.workload(cell, root)
    return Context(name=cell, workload=w, config=harness.config(w["config"], root),
                   seed=seed, seconds=seconds, trace=False, device=device,
                   t_start=time.perf_counter(), **hooks)


def training(cell: str, seeds, control: int, faults: int, root: Path, device: str):
    import torch
    drv = harness.traffic_driver("engine_epochs", root)
    for k, seed in enumerate(seeds):
        ctx = _ctx(cell, seed, 0.0, root, device)
        fold = drv.Fold(seed, ctx.workload["params"], ctx.config)
        engine, *_, prog = drv.program_steps(torch, ctx, fold)
        del engine, _
        _release(torch, device)
        ref = drv.reference_steps(torch, ctx, fold)
        yield {"seed": seed, "kind": "program", **drv.readings_gaps(prog, ref)}
        if k < control:
            tf32 = drv.reference_steps(torch, ctx, fold, tf32=True)
            yield {"seed": seed, "kind": "control_tf32", **drv.readings_gaps(tf32, ref)}
        if k < faults:
            engine, *_, bad = drv.program_steps(torch, ctx, fold, half_batch)
            del engine, _
            _release(torch, device)
            yield {"seed": seed, "kind": "fault_half_batch", **drv.readings_gaps(bad, ref)}
        _release(torch, device)


def _release(torch, device) -> None:
    """Free a finished Engine's graphs and memory now: a captured program
    freed later, by a collection that falls inside the next capture, would
    invalidate that capture."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def serving(cell: str, seeds, control: int, seconds: float, root: Path, device: str):
    import torch
    drv = harness.traffic_driver("open_loop_http", root)
    from benchmark.reference import serve as S
    for k, seed in enumerate(seeds):
        ctx = _ctx(cell, seed, seconds, root, device)
        out = drv.run(ctx)
        yield {"seed": seed, "kind": "program", "failed": out["failed"],
               "compared": out["readings"]["compared"], "serve_p95_ms": out["e2e"]["serve_p95_ms"],
               **out["readings"]["gaps"]}
        if k < control:
            pool, due, image, keep, _ = drv.schedule(ctx, ctx.workload["params"])
            images = pool[image[sorted(keep)]]
            ref_cls, ref_seg = drv.reference_logits(torch, ctx, images)
            c_cls, c_seg = drv.reference_logits(torch, ctx, images, tf32=True)
            yield {"seed": seed, "kind": "control_tf32", "compared": len(images),
                   **S.answer_gaps(S.reference_answers(c_cls, c_seg), ref_cls, ref_seg)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0, help="serving: the window")
    args = ap.parse_args(argv)
    harness.cache_environment()
    seeds = [int(s) for s in args.seeds.split(",")]
    kind = harness.traffic_kind(harness.workload(args.workload)["traffic"])
    if kind == "engine_epochs":
        rows = training(args.workload, seeds, args.control, args.faults, harness.HERE, "cuda")
    else:
        rows = serving(args.workload, seeds, args.control, args.seconds, harness.HERE, "cuda")
    for row in rows:
        print(json.dumps({"cell": args.workload, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
