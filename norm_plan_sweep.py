#!/usr/bin/env python3
"""Times every launch plan of the fused norm kernels at the flagship's shapes.

    python3 norm_plan_sweep.py [--batches 1 2 64] [--dtypes f32 bf16]

Run from the repository root with one CUDA card. For each (C, H·W) norm site
of MTnnUNet at 128² and each batch, every plan that
``csrc/instance_norm_leaky_relu.cu`` takes is launched on the same input:
the streaming design, and every subwarp plan (a group of 1-32 lanes per
plane, 1-2 vectors a lane, 64-256 threads a block) or resident plan (a
cluster of 1-8 blocks, 32-256 threads, 1-4 vectors a thread) that covers
the plane without an idle block. Forward and backward, each timed as
``chip_smoke.time_ms`` times the kernels (median of launches after an L2
flush). Prints one line per (site, batch, type, plan) and, per site, the
fastest plan beside the one ``hopper_kernels._plan`` picks, with the sums
over the 25 sites of one forward / one training step.
"""

from __future__ import annotations

import argparse
import sys


def candidates(planes: int, hw: int, width: int):
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk
    nvec = hw // width
    plans = [hk.streaming_plan(planes, hw)]
    if hw % width:
        return plans
    if hw <= 256:
        for group in (1, 2, 4, 8, 16, 32):
            vectors = -(-nvec // group)
            if vectors > 2 or group * (vectors - 1) >= nvec:
                continue
            for threads in (64, 128, 256):
                plans.append(hk.NormPlan("subwarp", 1, threads, vectors, group, vectors * width,
                                         -(-planes * group // threads)))
        return plans
    for k in (1, 2, 4, 8):
        for vectors in (1, 2, 4):
            per_thread = -(-nvec // (k * vectors))
            threads = (per_thread + 31) // 32 * 32
            if threads <= 256 and (k - 1) * threads * vectors < nvec:
                plans.append(hk.NormPlan("resident", k, threads, vectors, threads * k,
                                         vectors * width, planes * k))
    return plans


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 2, 64])
    ap.add_argument("--dtypes", nargs="+", default=["f32", "bf16"], choices=["f32", "bf16"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("norm_plan_sweep: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from multi_task_breast_cancer_tpu_torch.models.registry import init_multitask_model
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk

    model = init_multitask_model("MTnnUNet", generator=torch.Generator().manual_seed(0))
    shapes = cs.norm_shapes(model.to("cuda").eval(), "cuda")
    del model
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(5)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    for name in args.dtypes:
        dtype = dtypes[name]
        for batch in args.batches:
            sums = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}   # chosen, best
            for (c, h, w), sites in sorted(shapes.items(), key=lambda kv: -kv[0][1] * kv[0][2]):
                x = cs.kink_free((batch, c, h, w), gen).to(dtype)
                g = torch.randn(batch, c, h, w, device="cuda", generator=gen).to(dtype)
                chosen = hk.plan_for(x, g)
                rows = []
                for plan in candidates(batch * c, h * w, 16 // x.element_size()):
                    f_ms = cs.time_ms(lambda: hk._forward(x, 1e-5, 0.01, plan=plan), reps=10)
                    b_ms = cs.time_ms(lambda: hk._backward(x, g, 1e-5, 0.01, plan=plan), reps=10)
                    rows.append((plan, f_ms, b_ms))
                    mark = " <- plan" if plan == chosen else ""
                    print(f"{name} B={batch:2d} C={c:4d} {h:3d}x{w:<3d} {cs.plan_text(plan):28s} "
                          f"fwd {f_ms:.4f} ms  bwd {b_ms:.4f} ms{mark}", flush=True)
                for i, key in ((1, "fwd"), (2, "bwd")):
                    best = min(rows, key=lambda r: r[i])
                    mine = next(r for r in rows if r[0] == chosen)
                    sums[key][0] += sites * mine[i]
                    sums[key][1] += sites * best[i]
                    print(f"  best {key} {cs.plan_text(best[0]):28s} {best[i]:.4f} ms; "
                          f"plan {mine[i]:.4f} ms", flush=True)
            for key, (mine, best) in sums.items():
                print(f"{name} B={batch} {key} over the 25 sites: plan {mine:.4f} ms, "
                      f"best per site {best:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
