#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Run from the repository root, with one CUDA card visible. Without CUDA, or
without the repository beside it, it exits non-zero and prints no result.
Phases, in turn; any mismatch ends the run with a non-zero exit:

1. device: the card's name and power limit (``nvidia-smi``), the torch and
   CUDA versions, the seconds the kernel build took (``nvcc``, sm_90a; the
   augmentation kernel's index-plane design, kept in this file only to be
   timed, compiles beside the port's kernels), and ptxas's registers and
   spill bytes of every norm kernel variant (the register-resident and
   subwarp variants must spill nothing) and of the augmentation kernel's
   variants, with their static shared memory (none may spill);
2. kernel: ``instance_norm_leaky_relu`` against its plain PyTorch version at
   every (C, H·W) shape the flagship's forward gives it at 128², batches 1,
   2 and 64, in f32 and bf16, plus 256², 7×9 and a misaligned view; per
   shape the launch plan, the kernel's time and, in turns on the same input,
   the streaming design of the first port (forced), the plain version's and
   the library call's times (``F.instance_norm`` + ``F.leaky_relu``, timed
   here only), the bytes bound and the launch floor (an empty kernel of the
   same library); two calls must agree bit for bit;
3. model: the full-width MTnnUNet (widths 32…320, seeded weights), batch 64 at
   128², with the kernel against the same model with the plain norm on the
   card and against the plain model on the CPU at batch 2; exactly 25 kernel
   launches per forward; forward time and images/s;
4. serving, a main path: ``InferenceServer(CheckpointBackend(...))`` answers
   one raw plane on ``/predict`` and 64 raw planes on ``/predict_batch``; the
   records must equal the backend's direct answer; the kernel's launch count
   over these requests must be 25 per forward the server ran;
5. backward kernel: ``instance_norm_leaky_relu_backward`` against its plain
   version at every (C, H·W) shape of the flagship's 25 norm sites, batches 2
   (a training step's) and 64, f32 and bf16, plus 256², 7×9 and a
   misaligned view, with the plan, kernel, forced-streaming, plain and
   library times (autograd backward of ``F.leaky_relu(F.instance_norm(x))``,
   timed here only) and the bytes bound; two calls must agree bit for bit;
6. augmentation kernel: ``fast_augment`` against its plain version, bit for
   bit, under every launch plan it takes (staged, direct; 1-32 blocks per
   plane), at S=128 P=2 B∈{2, 64}, S=256 P=3 B=16 and S=16 P=2
   B=8, with draws that include ±180°, multiples of 90° and both flips;
   each plan's time, the default plan and the index-plane design (the
   first design: three (B, 3, S, S) index planes read from device memory)
   in turns, the plain version's time, the launch floor and the bound:
   selected source planes and output once, factors once (no single
   PyTorch call computes this function: no library time);
7. training, a main path: ``Config()`` defaults (MTnnUNet, batch 2, Adam 1e-4,
   fused DICE + Focal, fast augmentation on, f32), the full-width model from
   generator seed 0, on a seeded synthetic 128² fold (48 train, 12 val, two
   cross-fold padding steps): two epochs of ``Engine.train_and_eval_epoch``
   with the plateau scheduler, as the JAX driver runs them. Checks: finite
   losses; exactly 25 forward and 25 backward norm launches and one
   augmentation launch per real step (plus 25 forward launches per
   validation pass) and none on padding steps; padding steps leave the state
   bit-identical; three steps without augmentation on the card against the
   CPU from the same weights; step-0 gradients of the kernel model and of
   the plain-norm model against a float64 gradient on the card. Reports ms per step and images/s at
   batch 2 and 64, epoch seconds and a ``torch.profiler`` breakdown of one
   step; a second profile counts the launches from the augmentation to the
   model's first convolution: the kernel alone, no cast or copy;
8. a JSON line ``{"kernels": [...]}`` with each kernel's launches on the main
   paths, error, times and bound (``previous_ms``: the norm kernels' first,
   streaming design, and the augmentation's index-plane design, timed in the
   same run); then, last,
   ``{"ok": true, "device": ...}``.

Tolerances. f32 kernel vs plain: 1e-5 absolute (the same f32 arithmetic,
summed in another order). bf16 kernel vs plain: one bf16 ulp (2^-7 of the
value), because the two sum in different orders and an f32 result beside a
rounding boundary may round either way. Model outputs: 1e-4 of the output's
largest magnitude, f32 with TF32 off; the paths differ only in the order of
their f32 sums (norm statistics, cuDNN vs CPU convolutions), carried through
25 normalised layers. Backward kernel vs plain, f32: 1e-5 of the gradient's
largest magnitude; bf16: one bf16 ulp of the value plus that f32 tolerance
(values near zero may round either way from f32 results that differ in
their last digits). Augmentation: bit-exact (integer indexing). Training,
card vs CPU over three Adam steps, TF32 off and cuDNN deterministic: losses
1e-4 relative; parameters: no element beyond 2·lr per step (Adam moves a
parameter by at most about lr a step), and the difference of the two
updates at most 10 % of the update's L2 norm. The parameters cannot be held
tighter: Adam turns any gradient near zero into a step of up to lr whose
sign follows the last digits, and the LeakyReLU's kink flips gradients of
elements that sit within rounding of it, so the card's plain PyTorch model
(cuDNN, no kernel of the port) differs from the CPU by 5.5 % of the update
norm after three steps on an H100 80GB HBM3 at 700 W, where the kernel
model differs by 2.6 %. Step-0 gradients on the card, tensor by tensor: the kernel
model's distance to the float64 gradient (the plain-norm model in f64) at
most 1e-4 of the tensor's largest magnitude or twice the plain-norm f32
model's distance, whichever is larger. Kernel against plain norm directly
cannot be held to 1e-4: the plain f32 model itself is 14 % off the f64
gradient on one tensor (encoder5's first conv) where the kernel model is
2e-5 off, and both are ~1 % off on the input layers, whose weight gradients
cancel sums over raw 0-255 intensities.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import urllib.request
from collections import Counter

DEVICE = "cuda"
BATCH = 64
SIZE = 128
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM data sheet, f32 outside the tensor cores
FLOPS_PER_ELEMENT = 8       # sum; centre, square, sum; centre, scale, select
F32_TOL = 1e-5
BF16_REL_TOL = 2.0 ** -7
MODEL_REL_TOL = 1e-4
BWD_FLOPS_PER_ELEMENT = 17  # stats 4; xhat, select, two sums 6; dx 7
GRAD_REL_TOL = 1e-4
LOSS_REL_TOL = 1e-4
PARAM_REL_TOL = 0.1
TRAIN_N, VAL_N, PAD_STEPS = 48, 12, 2


def log(*args) -> None:
    print(*args, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        print(f"chip_smoke: FAIL: {what}", file=sys.stderr, flush=True)
        sys.exit(1)


def time_ms(fn, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` launches, each after the L2
    cache is flushed (a 256 MB write), so every launch reads its input cold.
    The card spins (``torch.cuda._sleep``) while the host queues every
    launch, and the spin is lengthened until it outlasts the queueing, so no
    delay of the host (Python, a busy shared CPU) falls inside a timed
    span."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.float32, device=DEVICE)
    fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    spin = 1 << 24  # cycles, ~8 ms at the H100's 1.98 GHz
    while True:
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        spun = torch.cuda.Event()
        spun.record()
        for s, e in zip(starts, ends):
            flush.zero_()
            s.record()
            fn()
            e.record()
        if not spun.query() or spin >= 1 << 30:  # still spinning: no gaps
            break
        spin *= 4
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound_ms(numel: int, itemsize: int, tensors: int = 2,
             flops_per_element: int = FLOPS_PER_ELEMENT) -> tuple:
    """Least time for one launch: each of ``tensors`` tensors of ``numel``
    elements read or written once over the memory rate, or the arithmetic
    over the f32 rate; the larger."""
    by_bytes = tensors * numel * itemsize / HBM_BYTES_PER_S * 1e3
    by_ops = flops_per_element * numel / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def norm_shapes(model, device) -> Counter:
    """(C, H, W) of every fused-norm site of one forward at SIZE², counted."""
    import torch
    from multi_task_breast_cancer_tpu_torch.models.blocks import ConvInNormLeReLU
    seen = Counter()
    hooks = [m.register_forward_hook(lambda _m, _i, out: seen.update([tuple(out.shape[1:])]))
             for m in model.modules() if isinstance(m, ConvInNormLeReLU)]
    with torch.inference_mode():
        model(torch.zeros(1, 1, SIZE, SIZE, device=device))
    for h in hooks:
        h.remove()
    return seen


def ptxas_report(log_text: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes, static shared
    memory bytes) of every entry function in an ``nvcc -Xptxas -v`` log,
    names demangled where a demangler is at hand."""
    rows, name, spills = [], None, (0, 0)
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append([name, int(m.group(1)), *spills, int(smem.group(1)) if smem else 0])
            name, spills = None, (0, 0)
    from multi_task_breast_cancer_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    tool = tool if os.path.exists(tool) else shutil.which("c++filt")
    if tool and rows:
        out = subprocess.run([tool], input="\n".join(r[0] for r in rows), text=True,
                             capture_output=True, timeout=60).stdout.splitlines()
        if len(out) == len(rows):
            for r, d in zip(rows, out):
                d = re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::", "", d)
                r[0] = d[:d.index(">(") + 1] if ">(" in d else d.split("(", 1)[0]
    return rows


def phase_device():
    """Returns the index-plane design's library (built beside the port's
    kernels, all compilers started together)."""
    import torch
    from multi_task_breast_cancer_tpu_torch.ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip())
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    proc, index_plane_lib = start_index_plane_build()
    log(f"kernel build: {_build.build():.2f} s ({', '.join(_build.sources())})")
    out, _ = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"index-plane design: nvcc exited {proc.returncode}\n{out}")
    rows = ptxas_report(_build.build_log("instance_norm_leaky_relu"))
    check(bool(rows), "no ptxas report for the norm kernels")
    log("norm kernels, ptxas -v (registers, spill store/load bytes):")
    for name, regs, st, ld, _ in sorted(rows):
        log(f"  {name[:90]:90s} {regs:3d} regs  spills {st}/{ld} B")
        if "resident" in name or "subwarp" in name:
            check(st == 0 and ld == 0, f"{name} spills {st}/{ld} bytes")
    rows = ptxas_report(_build.build_log("fast_augment"))
    check(bool(rows), "no ptxas report for the augmentation kernel")
    log("augmentation kernel, ptxas -v (registers, spill store/load bytes, static shared "
        "memory; the staged plane is dynamic shared memory):")
    for name, regs, st, ld, smem in sorted(rows):
        log(f"  {name[:90]:90s} {regs:3d} regs  spills {st}/{ld} B  smem {smem} B")
    check(all(r[2] == r[3] == 0 for r in rows),
          "the augmentation kernel spills:\n" + _build.build_log("fast_augment"))
    return index_plane_lib


def in_turns(fn_a, fn_b, reps: int = 10) -> tuple:
    """Times of ``fn_a`` and ``fn_b`` on one card, taken a, b, b, a and
    averaged per function, so a drift of the card's clock falls on both."""
    a1, b1 = time_ms(fn_a, reps), time_ms(fn_b, reps)
    b2, a2 = time_ms(fn_b, reps), time_ms(fn_a, reps)
    return (a1 + a2) / 2, (b1 + b2) / 2


def plan_text(plan) -> str:
    if plan.variant == "streaming":
        return f"streaming T={plan.threads}"
    text = f"{plan.variant} k={plan.cluster} T={plan.threads} V={plan.vectors}"
    return text + (f" G={plan.group}" if plan.variant == "subwarp" else "")


def launch_floor_ms() -> float:
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk
    floor = time_ms(lambda: hk.empty_launch(DEVICE))
    log(f"launch floor: an empty kernel of the same library {floor:.4f} ms per launch "
        f"({25 * floor:.4f} ms for 25), timed as the kernels are")
    return floor


def _forward_ok(got, want) -> tuple:
    """Within tolerance (f32: 1e-5 absolute; bf16: one bf16 ulp), and the
    largest absolute error."""
    import torch
    err = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        return err.max().item() <= F32_TOL, err.max().item()
    return bool((err <= BF16_REL_TOL * want.float().abs() + 1e-6).all()), err.max().item()


# shapes off the flagship's path, with whether to misalign the view: 256²
# (the streaming design's planes), 7×9 (not whole 16-byte vectors) and a
# view one element past a 16-byte boundary
EXTRA_SHAPES = (((2, 4, 256, 256), False), ((2, 8, 7, 9), False), ((2, 16, 32, 32), True))


def misaligned_copy(t):
    """A contiguous copy of ``t`` starting one element past a 16-byte boundary."""
    import torch
    buf = torch.empty(1 + t.numel(), device=t.device, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    check(out.is_contiguous() and out.data_ptr() % 16 != 0, "misaligned view")
    return out


def phase_kernel(shapes: Counter) -> dict:
    """Kernel #1 at every site's shape, batches 1, 2 and 64; returns batch
    64's totals over one forward's 25 launches (the serving path's shapes)."""
    import torch
    import torch.nn.functional as F
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk

    g = torch.Generator(device=DEVICE).manual_seed(0)
    floor = launch_floor_ms()
    result = {}
    for batch in (1, 2, BATCH):
        totals = {"ms": 0.0, "previous_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bound_ms": 0.0}
        bound_kinds, max_err = set(), 0.0
        log(f"kernel instance_norm_leaky_relu at batch {batch}: {len(shapes)} shapes, "
            f"{sum(shapes.values())} sites per forward; new plan vs the streaming "
            f"design in turns")
        for (c, h, w), sites in sorted(shapes.items(), key=lambda kv: -kv[0][1] * kv[0][2]):
            # offset planes: the two-pass variance must not lose the centred part
            x = torch.randn(batch, c, h, w, device=DEVICE, generator=g) * 2.0 + 5.0
            for dtype in (torch.float32, torch.bfloat16):
                xd = x.to(dtype)
                plan, old = hk.plan_for(xd), hk.streaming_plan(batch * c, h * w)
                got, again = hk.instance_norm_leaky_relu(xd), hk.instance_norm_leaky_relu(xd)
                prev = hk._forward(xd, 1e-5, 0.01, plan=old)
                want = hk.instance_norm_leaky_relu_reference(xd)
                torch.cuda.synchronize()
                check(torch.equal(got, again), f"two calls differ at B={batch} C={c} "
                                               f"HxW={h}x{w} {dtype}")
                for what, out in (("kernel", got), ("streaming", prev)):
                    ok, err = _forward_ok(out, want)
                    check(ok, f"{what} != plain at B={batch} C={c} HxW={h}x{w} {dtype}: "
                              f"max abs err {err:.3g}")
                ok, err = _forward_ok(got, want)
                k_ms, s_ms = in_turns(lambda: hk.instance_norm_leaky_relu(xd),
                                      lambda: hk._forward(xd, 1e-5, 0.01, plan=old))
                p_ms = time_ms(lambda: hk.instance_norm_leaky_relu_reference(xd))
                b_ms, kind = bound_ms(xd.numel(), xd.element_size())
                line = (f"  C={c:4d} HxW={h:3d}x{w:<3d} x{sites} {str(dtype)[6:]:8s} "
                        f"{plan_text(plan):28s} err {err:.3g}  kernel {k_ms:.4f} ms  "
                        f"streaming {s_ms:.4f} ms  plain {p_ms:.4f} ms  "
                        f"bound {b_ms:.4f} ms ({kind})")
                if dtype == torch.float32:
                    max_err = max(max_err, err)
                    l_ms = time_ms(lambda: F.leaky_relu(F.instance_norm(xd), 0.01))
                    line += f"  library {l_ms:.4f} ms"
                    for key, v in (("ms", k_ms), ("previous_ms", s_ms), ("plain_ms", p_ms),
                                   ("library_ms", l_ms), ("bound_ms", b_ms)):
                        totals[key] += sites * v
                    bound_kinds.add(kind)
                log(line)
        log(f"kernel totals over one f32 forward's {sum(shapes.values())} launches at "
            f"batch {batch}: " + ", ".join(f"{k} {v:.4f}" for k, v in totals.items())
            + f", launch floor {25 * floor:.4f}")
        result[batch] = {"max_abs_err": max_err, "bound_by": "bytes"
                         if bound_kinds == {"bytes"} else "operations", **totals}

    for shape, misaligned in EXTRA_SHAPES:
        x = torch.randn(*shape, device=DEVICE, generator=g) * 2.0 + 5.0
        for dtype in (torch.float32, torch.bfloat16):
            xd = misaligned_copy(x.to(dtype)) if misaligned else x.to(dtype)
            plan = hk.plan_for(xd, torch.empty_like(xd))
            got, again = hk.instance_norm_leaky_relu(xd), hk.instance_norm_leaky_relu(xd)
            ok, err = _forward_ok(got, hk.instance_norm_leaky_relu_reference(xd))
            check(ok and torch.equal(got, again),
                  f"kernel at {shape} {dtype}: max abs err {err:.3g} or calls differ")
            log(f"  {'misaligned ' * misaligned}{shape} {str(dtype)[6:]:8s} "
                f"{plan_text(plan):28s} err {err:.3g}  "
                f"kernel {time_ms(lambda: hk.instance_norm_leaky_relu(xd)):.4f} ms")
    return result[BATCH]


def _max_rel_err(got, want) -> float:
    import torch
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.float().cpu(), b.float().cpu()
        check(a.shape == b.shape and bool(torch.isfinite(a).all()),
              f"output shape/finiteness: {tuple(a.shape)} vs {tuple(b.shape)}")
        worst = max(worst, (a - b).abs().max().item() / max(1.0, b.abs().max().item()))
    return worst


def _flat(out):
    (cls,), seg = out
    return [cls, *seg]


def phase_model(model) -> None:
    import torch
    from multi_task_breast_cancer_tpu_torch.models.multitask import MTnnUNet
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk

    plain = MTnnUNet(plain_norm=True)
    plain.load_state_dict(model.state_dict())
    plain = plain.to(DEVICE).eval()
    g = torch.Generator().manual_seed(1)
    x = (torch.rand(BATCH, 1, SIZE, SIZE, generator=g) * 255).round().to(DEVICE)

    with torch.inference_mode():
        hk.instance_norm_leaky_relu.launches = 0
        out = model(x)
        torch.cuda.synchronize()
        launches = hk.instance_norm_leaky_relu.launches
        check(launches == 25, f"{launches} kernel launches in one forward, want 25")
        want = plain(x)
        shapes = [tuple(t.shape) for t in _flat(out)]
        check(shapes == [(BATCH, 3)] + [(BATCH, 1, SIZE, SIZE)] * 4, f"output shapes {shapes}")
        err = _max_rel_err(_flat(out), _flat(want))
        log(f"model: kernel vs plain norm on the card, batch {BATCH}: max err "
            f"{err:.3g} of the output scale (tol {MODEL_REL_TOL})")
        check(err <= MODEL_REL_TOL, "model outputs: kernel vs plain norm")

        cpu = MTnnUNet(plain_norm=True)
        cpu.load_state_dict(model.state_dict())
        err = _max_rel_err([t[:2] for t in _flat(out)], _flat(cpu.eval()(x[:2].cpu())))
        log(f"model: card vs CPU, batch 2: max err {err:.3g} of the output scale")
        check(err <= MODEL_REL_TOL, "model outputs: card vs CPU")

        fwd_ms = time_ms(lambda: model(x), reps=10)
        plain_ms = time_ms(lambda: plain(x), reps=10)
        log(f"model forward (batch {BATCH}, {SIZE}^2, f32, TF32 off): {fwd_ms:.3f} ms "
            f"= {BATCH / fwd_ms * 1e3:.1f} images/s; plain-norm model {plain_ms:.3f} ms")
        profile_forward(model, x)


def profile_forward(model, x) -> None:
    """Device time of one forward by kernel (torch.profiler), the largest
    first: where the forward's time goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model(x)
        torch.cuda.synchronize()
    rows = sorted(((getattr(e, "self_device_time_total", 0.0) / 1e3, e.count, e.key)
                   for e in prof.key_averages()), reverse=True)
    total = sum(r[0] for r in rows)
    if total <= 0:
        log("profile of one forward: the profiler saw no device time (not measured)")
        return
    log(f"profile of one forward: {total:.3f} ms device time in {sum(r[1] for r in rows)} "
        f"launches of {len(rows)} kernels; by kernel:")
    for ms, count, name in rows[:8]:
        log(f"  {ms:8.3f} ms {100 * ms / total:5.1f}%  x{count:<3d} {name[:100]}")


def _post(url: str, body: bytes, headers: dict) -> tuple:
    req = urllib.request.Request(url, data=body, method="POST", headers={
        "Content-Type": "application/octet-stream", **headers})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        payload = json.loads(resp.read())
    return payload, (time.perf_counter() - t0) * 1e3


def _check_records(recs, want, what: str) -> None:
    import numpy as np
    check(len(recs) == len(want.pred_class), f"{what}: {len(recs)} records")
    for i, rec in enumerate(recs):
        check(len(rec["probs"]) == 3 and abs(sum(rec["probs"]) - 1) < 1e-5
              and rec["predicted_class"] in ("benign", "malignant", "normal"),
              f"{what}: malformed record {rec}")
        direct = want.record(i)
        check(np.allclose(rec["probs"], direct["probs"], rtol=0, atol=1e-6)
              and rec["predicted_class"] == direct["predicted_class"]
              and rec["tumor_pixels"] == direct["tumor_pixels"],
              f"{what}: record {i} {rec} != direct answer {direct}")


def phase_serving() -> int:
    import numpy as np
    from multi_task_breast_cancer_tpu_torch.config import Config
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk
    from multi_task_breast_cancer_tpu_torch.serve.server import (
        CheckpointBackend, InferenceServer)

    backend = CheckpointBackend(Config(), "multitask", max_batch=BATCH, device=DEVICE)
    planes = np.random.default_rng(2).integers(0, 256, (BATCH, SIZE, SIZE), dtype=np.uint8)
    batch_hdr = {"X-Image-Count": str(BATCH)}
    with InferenceServer(backend, port=0, max_batch=BATCH) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        _post(base + "/predict_batch", planes.tobytes(), batch_hdr)  # warm-up
        batches0 = srv.batcher.stats["batches"]
        hk.instance_norm_leaky_relu.launches = 0
        one, one_ms = _post(base + "/predict", planes[0].tobytes(), {})
        many = [_post(base + "/predict_batch", planes.tobytes(), batch_hdr)
                for _ in range(5)]
        launches = hk.instance_norm_leaky_relu.launches
        forwards = srv.batcher.stats["batches"] - batches0
    check(launches > 0 and launches == 25 * forwards,
          f"{launches} kernel launches over {forwards} served forwards")

    _check_records([one], backend.postprocess(backend.predict(planes[:1, ..., None])),
                   "/predict")
    t0 = time.perf_counter()
    raw = backend.predict(planes[..., None])
    t1 = time.perf_counter()
    direct = backend.postprocess(raw)
    t2 = time.perf_counter()
    log(f"serving, direct backend calls for {BATCH} planes: predict (upload, forward, "
        f"download) {(t1 - t0) * 1e3:.1f} ms, postprocess {(t2 - t1) * 1e3:.1f} ms")
    for payload, _ in many:
        check(payload["count"] == BATCH, f"/predict_batch count {payload['count']}")
        _check_records(payload["predictions"], direct, "/predict_batch")
    batch_ms = statistics.median(ms for _, ms in many)
    log(f"serving: /predict 1 raw plane {one_ms:.1f} ms; /predict_batch {BATCH} "
        f"raw planes median {batch_ms:.1f} ms over {len(many)} requests = "
        f"{BATCH / batch_ms * 1e3:.1f} images/s; {launches} kernel launches "
        f"in {forwards} forwards")
    return launches


def kink_free(shape, gen):
    """Norm inputs whose normalised values all lie at least ~0.05 from the
    LeakyReLU's kink: each plane is 5 ± 2·(|N(0,1)| + 0.1) in ± pairs, so its
    mean is 5 and no element sits near it (an odd plane gets one more
    element at 5 + 3, which moves the mean by at most 3/H·W). At xhat = 0
    the gradient jumps by (1 − slope)·g, and two f32 evaluations whose
    statistics are summed in different orders can put an element within
    ~1e-7 of the kink on different sides (one such element at batch 64
    differed by 0.275 on an H100 with plain normal inputs): a branch choice,
    not an error of either version."""
    import torch
    batch, c, h, w = shape
    a = torch.randn(batch, c, h * w // 2, device=DEVICE, generator=gen).abs() + 0.1
    odd = torch.full((batch, c, h * w % 2), 1.5, device=DEVICE)
    z = torch.cat([a, -a, odd], dim=2)
    order = torch.rand(batch, c, h * w, device=DEVICE, generator=gen).argsort(dim=2)
    return (5.0 + 2.0 * z.gather(2, order)).reshape(batch, c, h, w)


def phase_backward_kernel(shapes: Counter) -> dict:
    """Kernel #2 against its plain version at every norm site's shape, at a
    training step's batch (2) and at 64, beside the streaming design in
    turns. Returns batch 2's totals over one step's 25 launches (the
    training path's shapes)."""
    import torch
    import torch.nn.functional as F
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk

    g = torch.Generator(device=DEVICE).manual_seed(3)

    def ok_err(got, want, dtype):
        err = (got.float() - want.float()).abs()
        scale = want.float().abs().max().item()
        if dtype == torch.float32:
            return err.max().item() <= F32_TOL * scale, err.max().item(), scale
        return (bool((err <= BF16_REL_TOL * want.float().abs() + F32_TOL * scale).all()),
                err.max().item(), scale)

    result = {}
    for batch in (2, BATCH):
        totals = {"ms": 0.0, "previous_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bound_ms": 0.0}
        kinds, max_err = set(), 0.0
        log(f"backward kernel instance_norm_leaky_relu_backward at batch {batch}; "
            f"new plan vs the streaming design in turns:")
        for (c, h, w), sites in sorted(shapes.items(), key=lambda kv: -kv[0][1] * kv[0][2]):
            x = kink_free((batch, c, h, w), g)
            gy = torch.randn(batch, c, h, w, device=DEVICE, generator=g)
            for dtype in (torch.float32, torch.bfloat16):
                xd, gd = x.to(dtype), gy.to(dtype)
                plan, old = hk.plan_for(xd, gd), hk.streaming_plan(batch * c, h * w)
                got = hk.instance_norm_leaky_relu_backward(xd, gd)
                again = hk.instance_norm_leaky_relu_backward(xd, gd)
                prev = hk._backward(xd, gd, 1e-5, 0.01, plan=old)
                want = hk.instance_norm_leaky_relu_backward_reference(xd, gd)
                torch.cuda.synchronize()
                check(torch.equal(got, again), f"two backward calls differ at B={batch} "
                                               f"C={c} HxW={h}x{w} {dtype}")
                for what, out in (("kernel", got), ("streaming", prev)):
                    ok, err, scale = ok_err(out, want, dtype)
                    check(ok, f"backward {what} != plain at B={batch} C={c} HxW={h}x{w} "
                              f"{dtype}: max abs err {err:.3g} (scale {scale:.3g})")
                ok, err, scale = ok_err(got, want, dtype)
                k_ms, s_ms = in_turns(lambda: hk.instance_norm_leaky_relu_backward(xd, gd),
                                      lambda: hk._backward(xd, gd, 1e-5, 0.01, plan=old))
                p_ms = time_ms(lambda: hk.instance_norm_leaky_relu_backward_reference(xd, gd))
                b_ms, kind = bound_ms(xd.numel(), xd.element_size(), 3, BWD_FLOPS_PER_ELEMENT)
                line = (f"  C={c:4d} HxW={h:3d}x{w:<3d} x{sites} {str(dtype)[6:]:8s} "
                        f"{plan_text(plan):28s} err {err:.3g}  kernel {k_ms:.4f} ms  "
                        f"streaming {s_ms:.4f} ms  plain {p_ms:.4f} ms  "
                        f"bound {b_ms:.4f} ms ({kind})")
                if dtype == torch.float32:
                    max_err = max(max_err, err)
                    xr = xd.detach().requires_grad_()
                    yr = F.leaky_relu(F.instance_norm(xr), 0.01)
                    l_ms = time_ms(lambda: torch.autograd.grad(yr, xr, gd, retain_graph=True))
                    del xr, yr
                    line += f"  library {l_ms:.4f} ms"
                    for key, v in (("ms", k_ms), ("previous_ms", s_ms), ("plain_ms", p_ms),
                                   ("library_ms", l_ms), ("bound_ms", b_ms)):
                        totals[key] += sites * v
                    kinds.add(kind)
                log(line)
        log(f"backward totals over one f32 step's {sum(shapes.values())} launches at "
            f"batch {batch}: " + ", ".join(f"{k} {v:.4f}" for k, v in totals.items()))
        result[batch] = {"max_abs_err": max_err, "bound_by": "bytes"
                         if kinds == {"bytes"} else "operations", **totals}

    for shape, misaligned in EXTRA_SHAPES:
        x = kink_free(shape, g)
        gy = torch.randn(*shape, device=DEVICE, generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            xd, gd = x.to(dtype), gy.to(dtype)
            xd = misaligned_copy(xd) if misaligned else xd
            plan = hk.plan_for(xd, gd, torch.empty_like(xd))
            got = hk.instance_norm_leaky_relu_backward(xd, gd)
            again = hk.instance_norm_leaky_relu_backward(xd, gd)
            ok, err, _ = ok_err(got, hk.instance_norm_leaky_relu_backward_reference(xd, gd), dtype)
            check(ok and torch.equal(got, again),
                  f"backward kernel at {shape} {dtype}: max abs err {err:.3g} or calls differ")
            k_ms = time_ms(lambda: hk.instance_norm_leaky_relu_backward(xd, gd))
            log(f"  {'misaligned ' * misaligned}{shape} {str(dtype)[6:]:8s} "
                f"{plan_text(plan):28s} err {err:.3g}  kernel {k_ms:.4f} ms")
    return result[2]


def _special_draws(b: int, gen):
    """Random flips and angles with the boundary cases first: ±180°, the
    multiples of 90°, 0°, just beside them, under all four flip pairs."""
    import torch
    from multi_task_breast_cancer_tpu_torch.ops import fast_augment as FA
    fh, fv, angle = FA.draw_flips_and_angles(gen, b, p_hflip=0.5, p_vflip=0.5,
                                             max_angle=360.0)
    special = torch.tensor([180.0, -180.0, 90.0, -90.0, 0.0, 270.0, -270.0, 360.0,
                            -360.0, 45.0, 135.0, -135.0, 89.99, 90.01, -179.99, 179.99])
    k = min(b, len(special))
    angle[:k] = special[:k]
    combos = torch.arange(k)
    fh[:k], fv[:k] = combos % 2 == 1, combos // 2 % 2 == 1
    return fh, fv, angle


# The index-plane design of the augmentation kernel, the first one the port
# had: one thread per output pixel, the three (B, 3, S, S) index planes read
# from device memory (two of them scattered), the source gathered from device
# memory. Kept here only to be timed beside the kernel in the same run.
INDEX_PLANE_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256)
index_plane_kernel(const int32_t* __restrict__ packed, const int32_t* __restrict__ rows,
                   const int32_t* __restrict__ idx, const int32_t* __restrict__ t1,
                   int32_t* __restrict__ out, int n, int planes, int s, int64_t total) {
  const int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= total) return;
  const int x = static_cast<int>(o % s);
  int64_t t = o / s;
  const int y = static_cast<int>(t % s);
  t /= s;
  const int p = static_cast<int>(t % planes);
  const int i = static_cast<int>(t / planes);
  const int64_t ss = static_cast<int64_t>(s) * s;
  const int32_t* id = idx + static_cast<int64_t>(i) * 3 * ss;
  const bool transpose = t1[i] > 0;
  const int r = transpose ? x : y, c = transpose ? y : x;
  const int row = rows[i];
  int32_t v = 0;
  const int j = id[2 * ss + static_cast<int64_t>(r) * s + c];
  if (row >= 0 && row < n && j >= 0 && j < s) {
    const int k = id[ss + static_cast<int64_t>(j) * s + r];
    if (k >= 0 && k < s) {
      const int m = id[static_cast<int64_t>(k) * s + j];
      if (m >= 0 && m < s)
        v = packed[(static_cast<int64_t>(row) * planes + p) * ss + static_cast<int64_t>(k) * s + m];
    }
  }
  out[o] = v;
}
extern "C" cudaError_t index_plane_augment_i32(const void* packed, const void* rows,
                                               const void* idx, const void* t1, void* out,
                                               int n, int b, int planes, int s,
                                               cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(b) * planes * s * s;
  index_plane_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      static_cast<const int32_t*>(packed), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(t1),
      static_cast<int32_t*>(out), n, planes, s, total);
  return cudaGetLastError();
}
"""


def start_index_plane_build():
    """Start ``nvcc`` on the index-plane design (same flags as the port's
    kernels) into a git-ignored directory; returns the running process and
    the library's path."""
    from multi_task_breast_cancer_tpu_torch.ops import _build
    where = _build.BUILD_DIR / "index_plane_design"
    where.mkdir(parents=True, exist_ok=True)
    src = where / "index_plane_augment.cu"
    src.write_text(INDEX_PLANE_CU)
    lib = where / "libindex_plane_augment.so"
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def index_plane_entry(lib):
    import ctypes
    fn = ctypes.CDLL(str(lib)).index_plane_augment_i32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def plan_label(plan) -> str:
    return f"{plan.variant} k={plan.split} T={plan.threads} smem={plan.smem} B"


AUG_INT_OPS_PER_PIXEL = 14  # three index products and sums, three range tests, the address


def augment_bound_ms(b: int, p: int, s: int) -> tuple:
    """Least time of the function: the selected source planes read and the
    output written once, the factors (3·(S+2) per sample) and the rows and
    t1 read once, int32, over the memory rate; or its integer arithmetic
    over the f32 rate; the larger."""
    by_bytes = (2 * b * p * s * s + 3 * b * (s + 2) + 2 * b) * 4 / HBM_BYTES_PER_S * 1e3
    by_ops = AUG_INT_OPS_PER_PIXEL * b * p * s * s / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def phase_augment_kernel(index_plane_lib) -> dict:
    """Kernel #3 against its plain version, bit for bit, under every plan it
    takes, at the training path's shape (S=128, P=2, B=2), batch 64, 256²
    (P=3, B=16) and 16²; each plan timed, the default plan and the
    index-plane design in turns on the same draws, the launch floor, the
    bound. Returns the training path's case."""
    import torch
    from multi_task_breast_cancer_tpu_torch.ops import fast_augment as FA

    entry = index_plane_entry(index_plane_lib)
    floor = launch_floor_ms()
    gen = torch.Generator().manual_seed(4)
    main = None
    log("augmentation kernel fast_augment (bit-exact against the plain pipeline); every "
        "plan, then the default plan vs the index-plane design in turns:")
    for s, p, b in ((SIZE, 2, 2), (SIZE, 2, BATCH), (256, 3, 16), (16, 2, 8)):
        n = b + 8
        packed = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, p, s, s), generator=gen,
                               dtype=torch.int32).to(DEVICE)
        rows = torch.randint(0, n, (b,), generator=gen, dtype=torch.int32).to(DEVICE)
        factors = FA.pipeline_factors_from_draws(*_special_draws(b, gen), s, DEVICE)
        idx, t1 = FA.expand_factors(factors)
        idx = idx.contiguous()
        want = FA.fast_augment_reference(packed, rows, factors)
        plan = FA.plan_for(packed, b)
        got = FA.fast_augment(packed, rows, factors)
        old = torch.empty((b, p, s, s), dtype=torch.int32, device=DEVICE)

        def index_plane_design():
            err = entry(packed.data_ptr(), rows.data_ptr(), idx.data_ptr(), t1.data_ptr(),
                        old.data_ptr(), n, b, p, s, torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"index-plane design: launch error {err}")

        index_plane_design()
        torch.cuda.synchronize()
        check(torch.equal(got, want) and torch.equal(old, want),
              f"augmentation kernel != plain at S={s} P={p} B={b}: "
              f"{int((got != want).sum())} pixels differ (index-plane design: "
              f"{int((old != want).sum())})")
        b_ms, kind = augment_bound_ms(b, p, s)
        log(f"  S={s:3d} P={p} B={b:2d}: bound {b_ms * 1e3:.2f} us ({kind}), launch floor "
            f"{floor * 1e3:.2f} us; default plan {plan_label(plan)}")
        for pl in FA.candidate_plans(b, p, s):
            out = FA.fast_augment(packed, rows, factors, plan=pl)
            torch.cuda.synchronize()
            check(torch.equal(out, want), f"plan {pl} != plain at S={s} P={p} B={b}")
            pl_ms = time_ms(lambda: FA.fast_augment(packed, rows, factors, plan=pl))
            log(f"    {plan_label(pl):40s} exact  {pl_ms * 1e3:8.2f} us")
        k_ms, o_ms = in_turns(lambda: FA.fast_augment(packed, rows, factors), index_plane_design)
        p_ms = time_ms(lambda: FA.fast_augment_reference(packed, rows, factors))
        # a yardstick, not the function: PyTorch's copy of as many bytes as
        # the kernel must read and write, timed as the kernels are
        flat = old.view(-1)
        copy_src = torch.empty_like(flat)
        c_ms = time_ms(lambda: flat.copy_(copy_src))
        log(f"  S={s:3d} P={p} B={b:2d}  exact ({got.numel()} pixels)  kernel {k_ms * 1e3:.2f} us "
            f"({100 * b_ms / k_ms:.0f} % of bound, {k_ms / floor:.2f}x the floor)  "
            f"index-plane design {o_ms * 1e3:.2f} us  plain {p_ms:.4f} ms  library none  "
            f"(copy_ of the same bytes {c_ms * 1e3:.2f} us)")
        if main is None:
            main = {"max_abs_err": 0.0, "ms": k_ms, "previous_ms": o_ms, "plain_ms": p_ms,
                    "bound_ms": b_ms, "bound_by": kind, "library_ms": None}
    return main


def synthetic_fold(n: int, seed: int):
    """A BUSI-like fold: uint8-valued 128² images with a brighter elliptic
    lesion, its binary mask, labels benign/malignant/normal in turn, and
    empty masks for 'normal'."""
    import numpy as np
    from multi_task_breast_cancer_tpu_torch.data.dataset import ArrayDataset
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    labels = (np.arange(n) % 3).astype(np.int32)
    masks = np.zeros((n, SIZE, SIZE, 1), np.float32)
    for i in np.flatnonzero(labels != 2):
        cy, cx = rng.integers(SIZE // 4, 3 * SIZE // 4, 2)
        ry, rx = rng.integers(SIZE // 12, SIZE // 5, 2)
        masks[i, ..., 0] = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
    images = np.clip(rng.normal(90, 30, masks.shape) + 70 * masks, 0, 255).round()
    return ArrayDataset(images=images.astype(np.float32), masks=masks, labels=labels,
                        patient_ids=np.arange(n), class_names=["benign"] * n,
                        tumor_pixels=masks.sum(axis=(1, 2, 3)).astype(np.int64))


def _engine_config(cfg, **overrides):
    """``EngineConfig`` from a ``Config``, as the JAX driver builds it."""
    from multi_task_breast_cancer_tpu_torch.train.loop import EngineConfig
    kw = dict(task="multitask", n_classes=len(cfg.data.classes),
              batch_size=cfg.data.batch_size, alpha=cfg.training.alpha,
              inversely_weighted=cfg.loss.inversely_weighted,
              seg_criterion=cfg.loss.function,
              cls_criterion=cfg.loss.classification_criterion,
              classes_weighted=cfg.data.classes_weighted, max_angle=360.0,
              p_hflip=cfg.data.transforms.horizontal_flip,
              p_vflip=cfg.data.transforms.vertical_flip,
              compute_dtype=cfg.training.compute_dtype,
              fast_augmentation=cfg.training.fast_augmentation)
    kw.update(overrides)
    return EngineConfig(**kw)


def _counts():
    from multi_task_breast_cancer_tpu_torch.ops import fast_augment as FA
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk
    return (hk.instance_norm_leaky_relu.launches,
            hk.instance_norm_leaky_relu_backward.launches, FA.fast_augment.launches)


def _reset_counts() -> None:
    from multi_task_breast_cancer_tpu_torch.ops import fast_augment as FA
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk
    hk.instance_norm_leaky_relu.launches = 0
    hk.instance_norm_leaky_relu_backward.launches = 0
    FA.fast_augment.launches = 0


def _snapshot(state):
    moments = [(s["exp_avg"].clone(), s["exp_avg_sq"].clone(), float(s["step"]))
               for s in (state.optimizer.state[p] for p in state.model.parameters())]
    return {k: v.clone() for k, v in state.model.state_dict().items()}, moments, state.step


def _same_state(a, b) -> bool:
    import torch
    return (a[2] == b[2]
            and all(torch.equal(a[0][k], b[0][k]) for k in a[0])
            and all(torch.equal(x[0], y[0]) and torch.equal(x[1], y[1]) and x[2] == y[2]
                    for x, y in zip(a[1], b[1])))


def phase_training() -> tuple:
    """The training main path; returns the launches of its two epochs
    (forward norm, backward norm, augmentation)."""
    import numpy as np
    import torch
    from multi_task_breast_cancer_tpu_torch.config import Config
    from multi_task_breast_cancer_tpu_torch.models.registry import init_multitask_model
    from multi_task_breast_cancer_tpu_torch.ops.losses import check_finite_loss
    from multi_task_breast_cancer_tpu_torch.train.loop import (
        Engine, plan_epoch_indices, step_valid_mask)
    from multi_task_breast_cancer_tpu_torch.train.optim import (
        CosineAnnealingScheduler, init_lr_scheduler, set_learning_rate)
    from multi_task_breast_cancer_tpu_torch.train.state import create_train_state

    cfg = Config()
    b = cfg.data.batch_size
    model = init_multitask_model(cfg.model.architecture, generator=torch.Generator().manual_seed(0))
    init_weights = {k: v.clone() for k, v in model.state_dict().items()}
    engine = Engine(model, _engine_config(cfg), device=DEVICE)
    state = create_train_state(engine.model, cfg.optimizer.opt, cfg.optimizer.lr)
    train_ds, val_ds = synthetic_fold(TRAIN_N, 10), synthetic_fold(VAL_N, 11)
    real_steps = -(-TRAIN_N // b)
    max_steps = real_steps + PAD_STEPS
    train = engine.device_data(train_ds, pad_to=TRAIN_N)
    val = engine.device_data(val_ds, for_training=False)
    step_valid = step_valid_mask(TRAIN_N, b, max_steps)
    scheduler = init_lr_scheduler(cfg.optimizer.scheduler, cfg.optimizer.lr,
                                  t_max=cfg.optimizer.t_max, factor=cfg.optimizer.decrease_factor,
                                  min_lr=cfg.optimizer.min_lr, patience=cfg.optimizer.patience)
    host_rng = np.random.default_rng(cfg.training.seed)
    gen = torch.Generator().manual_seed(cfg.training.seed)
    log(f"training: {cfg.model.architecture} full width, batch {b}, {cfg.optimizer.opt} "
        f"lr {cfg.optimizer.lr}, {cfg.loss.function}+{cfg.loss.classification_criterion}, "
        f"fast_augmentation={cfg.training.fast_augmentation}, {TRAIN_N} train / {VAL_N} val "
        f"at {SIZE}^2, {real_steps} real + {PAD_STEPS} padding steps per epoch")

    # the main path: two epochs as the JAX driver runs them
    torch.cuda.synchronize()
    _reset_counts()
    epoch_s = []
    for epoch in range(2):
        t0 = time.perf_counter()
        perm = plan_epoch_indices(TRAIN_N, b, host_rng, pad_to_steps=max_steps)
        state, tm, vm = engine.train_and_eval_epoch(state, train, val, perm, gen, step_valid)
        check_finite_loss(tm["loss"])
        check_finite_loss(vm["loss"])
        if isinstance(scheduler, CosineAnnealingScheduler):
            scheduler.step()
        else:
            scheduler.step(vm["loss"])
        set_learning_rate(state.optimizer, scheduler.lr)
        epoch_s.append(time.perf_counter() - t0)
        log(f"  epoch {epoch}: {epoch_s[-1]:.3f} s; train loss {tm['loss']:.5f} "
            f"(seg {tm['seg_loss']:.5f}, cls {tm['cls_loss']:.5f}, dice {tm['dice']:.4f}); "
            f"val loss {vm['loss']:.5f} acc {vm['acc']:.3f}; lr {scheduler.lr:g}")
    fwd, bwd, aug = launches = _counts()
    steps = 2 * real_steps
    log(f"  launches over the two epochs: {fwd} norm forward, {bwd} norm backward, "
        f"{aug} augmentation, for {steps} real steps and 2 validation passes")
    check(fwd == 25 * (steps + 2) and bwd == 25 * steps and aug == steps,
          f"launch counts {launches}, want ({25 * (steps + 2)}, {25 * steps}, {steps})")
    check(state.step == steps, f"state.step {state.step} after {steps} real steps")

    # padding steps are no-ops: an epoch of only padding steps
    before = _snapshot(state)
    _reset_counts()
    engine.train_epoch(state, train, plan_epoch_indices(TRAIN_N, b, host_rng)[:PAD_STEPS * b],
                       gen, np.zeros(PAD_STEPS, np.float32))
    check(_counts() == (0, 0, 0) and _same_state(before, _snapshot(state)),
          "padding steps changed the state or launched a kernel")
    log(f"  {PAD_STEPS} padding steps: no launch, parameters, Adam moments and step "
        f"count bit-identical")

    # speed: ms per step at batch 2 (all real steps), then batch 64
    perm = plan_epoch_indices(TRAIN_N, b, host_rng)
    engine.train_epoch(state, train, perm, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.train_epoch(state, train, perm, gen)
    step_ms = (time.perf_counter() - t0) * 1e3 / real_steps
    log(f"  batch {b}: {step_ms:.3f} ms per training step = {b / step_ms * 1e3:.1f} images/s "
        f"(host clock over {real_steps} steps and the epoch's one metric fetch); "
        f"epoch of {real_steps} steps + validation {epoch_s[1]:.3f} s")
    profile_step(engine, state, train, perm[:b], gen, step_ms)
    profile_augmentation_path(engine, state, train, perm[:b], gen)
    del engine, state, train, val
    torch.cuda.empty_cache()
    train_step_ms_64()

    comparisons(cfg, init_weights, train_ds)
    return launches


def train_step_ms_64() -> None:
    import numpy as np
    import torch
    from multi_task_breast_cancer_tpu_torch.config import Config
    from multi_task_breast_cancer_tpu_torch.models.registry import init_multitask_model
    from multi_task_breast_cancer_tpu_torch.train.loop import Engine, plan_epoch_indices
    from multi_task_breast_cancer_tpu_torch.train.state import create_train_state

    cfg, n = Config(), 4 * BATCH
    engine = Engine(init_multitask_model("MTnnUNet", generator=torch.Generator().manual_seed(0)),
                    _engine_config(cfg, batch_size=BATCH), device=DEVICE)
    state = create_train_state(engine.model, cfg.optimizer.opt, cfg.optimizer.lr)
    data = engine.device_data(synthetic_fold(n, 12))
    gen, rng = torch.Generator().manual_seed(1), np.random.default_rng(1)
    engine.train_epoch(state, data, plan_epoch_indices(n, BATCH, rng), gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, tm = engine.train_epoch(state, data, plan_epoch_indices(n, BATCH, rng), gen)
    epoch_s = time.perf_counter() - t0
    check(np.isfinite(tm["loss"]), f"batch {BATCH} training loss {tm['loss']}")
    log(f"  batch {BATCH}: epoch of {n // BATCH} steps {epoch_s:.3f} s = "
        f"{epoch_s * 1e3 / (n // BATCH):.3f} ms per step = {n / epoch_s:.1f} images/s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    del engine, state, data
    torch.cuda.empty_cache()


def profile_step(engine, state, data, perm, gen, step_ms: float) -> None:
    """Device time of one training step by kernel (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.train_epoch(state, data, perm, gen)
        torch.cuda.synchronize()
    rows = sorted(((getattr(e, "self_device_time_total", 0.0) / 1e3, e.count, e.key)
                   for e in prof.key_averages()), reverse=True)
    total = sum(r[0] for r in rows)
    if total <= 0:
        log("  profile of one step: the profiler saw no device time (not measured)")
        return
    ours = {name: (ms, count) for ms, count, name in rows
            if "instance_norm_leaky_relu" in name or "fast_augment" in name}
    log(f"  profile of one training step: {total:.3f} ms device time (host step "
        f"{step_ms:.3f} ms: device busy {100 * total / step_ms:.1f} %) in "
        f"{sum(r[1] for r in rows)} launches of {len(rows)} kernels; by kernel:")
    for ms, count, name in rows[:12]:
        log(f"    {ms:8.3f} ms {100 * ms / total:5.1f}%  x{count:<4d} {name[:100]}")
    for name, (ms, count) in ours.items():
        log(f"    port kernel {name[:60]}: {ms:.3f} ms x{count} ({100 * ms / total:.1f} %)")


def profile_augmentation_path(engine, state, data, perm, gen) -> None:
    """The launches of one training step from the augmentation to the
    model's first convolution, in the order the card ran them. Empty-kernel
    markers are launched just before and just after ``Engine._augmented_batch``
    and at the entry of the first convolution (a forward pre-hook); the
    profiler's device events between them are the augmentation path's
    launches and what runs between it and the convolution. At 128² f32 the
    path is one launch, the kernel (no cast, no copy), and nothing runs
    between it and the convolution."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk

    armed = []
    inner = engine._augmented_batch

    def augmented_batch(*args):
        hk.empty_launch(engine.device)
        out = inner(*args)
        hk.empty_launch(engine.device)
        armed.append(True)
        return out

    def first_conv(_module, _args):
        if armed:
            armed.clear()
            hk.empty_launch(engine.device)

    hooks = [m.register_forward_pre_hook(first_conv) for m in engine.model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    engine._augmented_batch = augmented_batch
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            engine.train_epoch(state, data, perm, gen)
            torch.cuda.synchronize()
    finally:
        del engine._augmented_batch
        for h in hooks:
            h.remove()
    names = [e.name for e in sorted((e for e in prof.events()
                                     if e.device_type == DeviceType.CUDA),
                                    key=lambda e: e.time_range.start)]
    check(bool(names), "augmentation path: the profiler saw no device events")
    marks = [k for k, name in enumerate(names) if "instance_norm_leaky_relu_empty" in name]
    check(len(marks) == 3, f"augmentation path profile: {len(marks)} markers, want 3")
    path, between = names[marks[0] + 1:marks[1]], names[marks[1] + 1:marks[2]]
    copies = [n for n in path + between if re.search(r"copy|cast|elementwise", n, re.I)]
    log(f"  augmentation path of one step (profile): {len(path)} launch(es) "
        f"{[n[:60] for n in path]}; {len(between)} launch(es) between it and the first "
        f"convolution; {len(copies)} copies or casts")
    check(len(path) == 1 and "fast_augment" in path[0] and not between and not copies,
          "the augmentation path at 128^2 f32 must be the kernel alone, with nothing "
          "before the first convolution")


def comparisons(cfg, init_weights, train_ds) -> None:
    """Card against CPU over three steps, and step-0 gradients of the kernel
    model against the plain-norm model; TF32 off, cuDNN deterministic."""
    import torch
    from multi_task_breast_cancer_tpu_torch.models.multitask import MTnnUNet
    from multi_task_breast_cancer_tpu_torch.train.loop import Engine
    from multi_task_breast_cancer_tpu_torch.train.state import create_train_state

    torch.backends.cudnn.deterministic = True
    runs = {}
    for name, device, plain in (("kernels on the card", DEVICE, False),
                                ("plain norm on the card", DEVICE, True),
                                ("CPU", "cpu", True)):
        model = MTnnUNet(plain_norm=plain)
        model.load_state_dict(init_weights)
        engine = Engine(model, _engine_config(cfg, use_transforms=False), device=device)
        state = create_train_state(engine.model, cfg.optimizer.opt, cfg.optimizer.lr)
        data = engine.device_data(train_ds)
        threads = torch.get_num_threads()
        if device == "cpu":
            torch.set_num_threads(1)  # one thread: the CPU's sums in one fixed order
        losses = [engine.train_epoch(state, data, [2 * k, 2 * k + 1])[1]["loss"]
                  for k in range(3)]
        torch.set_num_threads(threads)
        runs[name] = (losses, {k: v.cpu() for k, v in state.model.state_dict().items()})
    cpu_l, cpu_p = runs["CPU"]
    update = torch.cat([(cpu_p[k] - init_weights[k]).flatten() for k in cpu_p])
    rel = {}
    for name in ("kernels on the card", "plain norm on the card"):
        losses, params = runs[name]
        diff = torch.cat([(params[k] - cpu_p[k]).flatten() for k in cpu_p])
        rel[name] = (diff.norm() / update.norm()).item()
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_l))
        log(f"  {name} vs CPU, 3 steps without augmentation: losses {losses} vs {cpu_l}, "
            f"max rel err {loss_err:.3g} (tol {LOSS_REL_TOL}); parameters: max abs err "
            f"{diff.abs().max().item():.3g} (bound {3 * 2 * cfg.optimizer.lr:g}), "
            f"{int((diff.abs() > 1e-6).sum())} of {diff.numel()} beyond 1e-6, update "
            f"difference {rel[name]:.3g} of the update's L2 norm (tol {PARAM_REL_TOL})")
        check(loss_err <= LOSS_REL_TOL, f"{name} vs CPU: losses")
        check(diff.abs().max().item() <= 3 * 2 * cfg.optimizer.lr
              and rel[name] <= PARAM_REL_TOL, f"{name} vs CPU: parameters")

    engine = Engine(MTnnUNet(), _engine_config(cfg, use_transforms=False), device=DEVICE)
    data = engine.device_data(train_ds)
    rows = torch.arange(cfg.data.batch_size, device=DEVICE)
    batch = [data[k].index_select(0, rows).float() for k in ("images", "masks", "cls_targets")]
    grads = {}
    for name, plain, dtype in (("kernel", False, torch.float32), ("plain", True, torch.float32),
                               ("f64", True, torch.float64)):
        model = MTnnUNet(plain_norm=plain)
        model.load_state_dict(init_weights)
        model = model.to(DEVICE, dtype)
        x, m, t = (b.to(dtype) for b in batch)
        loss, _ = engine._losses(model(x), m, t)
        loss.backward()
        grads[name] = {k: p.grad.double() for k, p in model.named_parameters()}
    worst = {"kernel vs plain": 0.0, "kernel vs f64": 0.0, "plain vs f64": 0.0}
    bad = []
    for k, g64 in grads["f64"].items():
        scale = g64.abs().max().item()
        errs = {"kernel vs plain": grads["kernel"][k] - grads["plain"][k],
                "kernel vs f64": grads["kernel"][k] - g64, "plain vs f64": grads["plain"][k] - g64}
        errs = {n: e.abs().max().item() / scale for n, e in errs.items()}
        worst = {n: max(worst[n], errs[n]) for n in worst}
        if errs["kernel vs f64"] > max(GRAD_REL_TOL, 2 * errs["plain vs f64"]):
            bad.append((k, errs))
    log(f"  step-0 gradients on the card over {len(grads['f64'])} tensors, max error of "
        f"each tensor's scale: " + ", ".join(f"{n} {v:.3g}" for n, v in worst.items()))
    check(not bad, f"step-0 gradients: the kernel model is further from the f64 gradient "
                   f"than the plain-norm model: {bad[:3]}")
    torch.backends.cudnn.deterministic = False


DRIVER_COUNTS = {"benign": 222, "malignant": 164, "normal": 64}  # Curated BUSI
DRIVER_CV, DRIVER_EPOCHS = 2, 2          # cut from the config's 4 folds, 200 epochs
DRIVER_SMALL_PER_CLASS = 16              # the CLI and resume runs
DRIVER_NNUNET_WIDTHS = None              # None: the config's full widths
SERVE_REL_TOL = 1e-4


def _driver_config(root, cv: int, epochs: int, **training):
    """``Config()`` defaults (MTnnUNet, batch 2, Adam 1e-4, DICE + Focal,
    alpha 0.35, oversampling, fast augmentation, plateau) on ``root``, cut to
    ``cv`` folds and ``epochs`` epochs."""
    from multi_task_breast_cancer_tpu_torch.config import Config
    cfg = Config()
    cfg.data.input_img = str(root)
    cfg.model.nnunet_widths = DRIVER_NNUNET_WIDTHS
    cfg.training.CV, cfg.training.epochs = cv, epochs
    for k, v in training.items():
        setattr(cfg.training, k, v)
    return cfg


def _fold_sizes(run) -> list:
    """(train, val, test) of every fold, from the run's execution.log."""
    text = open(os.path.join(run, "execution.log")).read()
    return [tuple(int(v) for v in m) for m in
            re.findall(r"Fold \d+ sizes: train=(\d+) val=(\d+) test=(\d+)", text)]


def _metric_rows(run, fold: int) -> list:
    with open(os.path.join(run, f"fold_{fold}", "metrics.csv")) as f:
        return [ln.rstrip("\n") for ln in f if ln.strip()]


def _check_run_dir(run, task: str, mode: str, folds: int, epochs: int) -> None:
    """The JAX driver's run-dir layout and file contracts."""
    from multi_task_breast_cancer_tpu_torch.train.driver import METRIC_HEADERS
    for name in ("config.yaml", "execution.log", "model.txt",
                 "results_segmentation.xlsx", "classification_results.xlsx"):
        check(os.path.isfile(os.path.join(run, name)), f"run dir: no {name}")
    for n in range(folds):
        d = os.path.join(run, f"fold_{n}")
        rows = _metric_rows(run, n)
        check(rows[0] == METRIC_HEADERS[(task, mode)] and len(rows) == 1 + epochs,
              f"fold {n} metrics.csv: {rows}")
        values = [float(v) for r in rows[1:] for v in r.split(",")]
        check(all(math.isfinite(v) for v in values), f"fold {n}: a loss or metric is not finite")
        ckpts = [f for f in os.listdir(d) if f.startswith("model_") and f.endswith(f"_fold_{n}")]
        check(len(ckpts) == 1, f"fold {n}: checkpoints {ckpts}")
        for name in ("results_segmentation.csv", "results_classification.csv", ".fold_complete",
                     "loss_evolution.png"):
            check(os.path.isfile(os.path.join(d, name)), f"fold {n}: no {name}")
        for sub in ("segs", "features_map"):
            check(bool(os.listdir(os.path.join(d, sub))), f"fold {n}: {sub}/ is empty")
        check(os.path.isdir(os.path.join(d, "plots")), f"fold {n}: no plots/")


def phase_driver() -> tuple:
    """The experiment driver, as a user runs it; returns the launches of the
    full-width run (forward norm, backward norm, augmentation)."""
    import tempfile
    import numpy as np
    import torch
    from multi_task_breast_cancer_tpu_torch.data.loader import load_datasets
    from multi_task_breast_cancer_tpu_torch.data.synthetic import make_preprocessed_busi
    from multi_task_breast_cancer_tpu_torch.serve.server import CheckpointBackend
    from multi_task_breast_cancer_tpu_torch.train import driver as D
    from multi_task_breast_cancer_tpu_torch.train import loop as LP
    from multi_task_breast_cancer_tpu_torch.train.inference import to_host
    from multi_task_breast_cancer_tpu_torch.utils.profiling import StepTimer

    tmp = tempfile.mkdtemp(prefix="mtbc_driver_")
    try:
        t0 = time.perf_counter()
        root = make_preprocessed_busi(os.path.join(tmp, "busi"), size=SIZE, seed=0,
                                      class_counts=DRIVER_COUNTS)
        log(f"driver: synthetic Curated-BUSI tree, {sum(DRIVER_COUNTS.values())} PNGs at "
            f"{SIZE}^2 {DRIVER_COUNTS}, written in {time.perf_counter() - t0:.2f} s")
        cfg = _driver_config(root, DRIVER_CV, DRIVER_EPOCHS)
        log(f"driver: run_experiment(cfg, 'multitask', 'CV') at the Config() defaults "
            f"({cfg.model.architecture}, batch {cfg.data.batch_size}, {cfg.optimizer.opt} "
            f"{cfg.optimizer.lr}, {cfg.loss.function}+{cfg.loss.classification_criterion}, "
            f"alpha {cfg.training.alpha}, oversampling {cfg.data.oversampling}, fast "
            f"augmentation {cfg.training.fast_augmentation}, {cfg.optimizer.scheduler}); "
            f"cuts: CV 4 -> {DRIVER_CV}, epochs 200 -> {DRIVER_EPOCHS}")

        # the test phase's forward, and the run's bookkeeping, timed apart
        spans = Counter()
        predict, bookkeeping = LP.Engine.predict, {}

        def timed_predict(self, state, images, *args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = predict(self, state, images, *args, **kwargs)
            torch.cuda.synchronize()
            spans["forward_s"] += time.perf_counter() - t
            spans["forward_images"] += len(images)
            return out

        def timed(name):
            fn = getattr(D, name)
            bookkeeping[name] = fn

            def wrapper(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    spans["bookkeeping_s"] += time.perf_counter() - t
            setattr(D, name, wrapper)

        timer = StepTimer()
        LP.Engine.predict = timed_predict
        for name in ("write_metrics_file", "_log_epoch", "save_segmentation_results",
                     "save_classification_results", "_fold_plots"):
            timed(name)
        try:
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            run = D.run_experiment(cfg, "multitask", "CV", run_root=os.path.join(tmp, "runs"),
                                   device=DEVICE, timer=timer)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = fwd, bwd, aug = _counts()
        finally:
            LP.Engine.predict = predict
            for name, fn in bookkeeping.items():
                setattr(D, name, fn)

        _check_run_dir(run, "multitask", "CV", DRIVER_CV, DRIVER_EPOCHS)
        sizes = _fold_sizes(run)
        check(len(sizes) == DRIVER_CV, f"fold sizes in execution.log: {sizes}")
        b = cfg.data.batch_size
        steps = sum(DRIVER_EPOCHS * -(-tr // b) for tr, _, _ in sizes)
        passes = DRIVER_CV * (DRIVER_EPOCHS + 1)  # a validation pass per epoch, a test forward
        want = (25 * (steps + passes), 25 * steps, steps)
        log(f"  fold sizes (train, val, test): {sizes}; {steps} real steps over the run "
            f"(padding steps launch nothing)")
        log(f"  launches: {fwd} norm forward, {bwd} norm backward, {aug} augmentation; "
            f"the fold sizes predict {want}")
        check(launches == want, f"driver launch counts {launches}, want {want}")
        t = timer.summary()
        test_images = sum(te for _, _, te in sizes)
        test_s = timer.totals["test_phase"]
        host_s = test_s - spans["forward_s"]
        log(f"  wall time: run {run_s:.2f} s; per fold {t['fold']:.2f} s; per epoch "
            f"{t['epoch']:.3f} s, of which the Engine (train + validation) {t['engine']:.3f} s "
            f"({100 * t['engine'] / t['epoch']:.1f} %) = "
            f"{t['engine'] * 1e3 / (steps / (DRIVER_CV * DRIVER_EPOCHS)):.2f} ms per step; "
            f"checkpoint writes {timer.totals['checkpoint']:.3f} s in all")
        log(f"  test phase: {test_s:.3f} s for {test_images} images = "
            f"{test_s * 1e3 / test_images:.3f} ms per image: forward "
            f"{spans['forward_s'] * 1e3 / test_images:.3f} ms, host metrics, PNGs and CSVs "
            f"{host_s * 1e3 / test_images:.3f} ms per image")
        log(f"  execution.log, metrics.csv, plots and result sheets: "
            f"{spans['bookkeeping_s']:.3f} s in all")
        rows = {n: _metric_rows(run, n)[1:] for n in range(DRIVER_CV)}
        log(f"  metrics.csv rows: {rows}")

        # serving what training wrote
        fold0 = load_datasets(cfg.training, cfg.data, mode="CV")[0].test
        images = fold0.images[:8]
        ckpt = next(os.path.join(run, "fold_0", f) for f in os.listdir(os.path.join(run, "fold_0"))
                    if f.startswith("model_"))
        backend = CheckpointBackend(cfg, "multitask", checkpoint=ckpt, size=SIZE, max_batch=8,
                                    device=DEVICE)
        served = backend.predict(images.astype(np.uint8))
        state, _ = D.build_inference_state(cfg, "multitask", checkpoint=ckpt, device=DEVICE)
        engine = LP.Engine(state.model, D._engine_config(cfg, "multitask", 360.0), device=DEVICE)
        direct = to_host(engine.predict(state, images))
        pairs = list(zip(_flat(served), _flat(direct)))
        check(all(a.shape == b_.shape and np.isfinite(a).all() for a, b_ in pairs),
              "served outputs: shapes or finiteness")
        err = max(float(np.abs(a - b_).max() / max(np.abs(b_).max(), 1e-12)) for a, b_ in pairs)
        log(f"  CheckpointBackend on fold 0's checkpoint vs Engine.predict, fold 0's first "
            f"8 test images: max error {err:.3g} of the output scale (tol {SERVE_REL_TOL})")
        check(err <= SERVE_REL_TOL, "served answer differs from Engine.predict")
        del backend, engine, state
        torch.cuda.empty_cache()

        small = make_preprocessed_busi(os.path.join(tmp, "small"),
                                       n_per_class=DRIVER_SMALL_PER_CLASS, size=SIZE, seed=1)
        phase_driver_cli(tmp, small)
        phase_driver_resume(tmp, small)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_driver_cli(tmp, root) -> None:
    """``python -m ...training_multitask`` in a process of its own, at a
    small depth: it must run on the card without being told to."""
    import torch
    from multi_task_breast_cancer_tpu_torch.config import config_to_yaml
    cfg_path = os.path.join(tmp, "small.yaml")
    with open(cfg_path, "w") as f:
        f.write(config_to_yaml(_driver_config(root, 2, 1)))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "multi_task_breast_cancer_tpu_torch.training_multitask",
                           "--config", cfg_path, "--run-root", os.path.join(tmp, "cli")],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=600)
    check(proc.returncode == 0, f"training_multitask exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    (run,) = os.listdir(os.path.join(tmp, "cli"))
    run = os.path.join(tmp, "cli", run)
    text = open(os.path.join(run, "execution.log")).read()
    device_line = next((ln for ln in text.splitlines() if "Device: " in ln), "")
    check("cuda" in device_line and torch.cuda.get_device_name(0) in device_line,
          f"execution.log names no card: {device_line!r}")
    _check_run_dir(run, "multitask", "CV", 2, 1)
    log(f"driver CLI: python -m multi_task_breast_cancer_tpu_torch.training_multitask "
        f"({DRIVER_SMALL_PER_CLASS} images per class, CV 2, 1 epoch, full widths): exit 0 in "
        f"{time.perf_counter() - t0:.1f} s; {device_line.split('--- ')[-1]}")


def phase_driver_resume(tmp, root) -> None:
    """A run killed after fold 0's first epoch and resumed with
    ``resume_dir`` ends with the uninterrupted run's metrics.csv rows, bit for
    bit as text (cuDNN deterministic; the kernels sum in a fixed order)."""
    import torch
    from multi_task_breast_cancer_tpu_torch.train import driver as D
    cfg = lambda: _driver_config(root, 2, 2, checkpoint_every_epoch=True)  # noqa: E731
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    try:
        whole = D.run_experiment(cfg(), "multitask", "CV", run_root=os.path.join(tmp, "whole"),
                                 device=DEVICE)
        real_profile = D.maybe_profile

        def kill(epoch, fold):
            if (fold, epoch) == (0, 1):
                raise RuntimeError("simulated kill after fold 0's first epoch")
            return real_profile(epoch, fold)

        D.maybe_profile = kill
        try:
            D.run_experiment(cfg(), "multitask", "CV", run_root=os.path.join(tmp, "killed"),
                             device=DEVICE)
            check(False, "the simulated kill did not fire")
        except RuntimeError as e:
            check("simulated kill" in str(e), f"resume run failed: {e}")
        finally:
            D.maybe_profile = real_profile
        (killed,) = os.listdir(os.path.join(tmp, "killed"))
        killed = os.path.join(tmp, "killed", killed)
        check(len(_metric_rows(killed, 0)) == 2, "the killed run wrote more than epoch 0")
        resumed = D.run_experiment(cfg(), "multitask", "CV", resume_dir=killed, device=DEVICE)
    finally:
        torch.backends.cudnn.deterministic = False
    diff, same = 0.0, True
    for n in range(2):
        a, b = _metric_rows(whole, n), _metric_rows(resumed, n)
        same = same and a == b
        for ra, rb in zip(a[1:], b[1:]):
            diff = max([diff] + [abs(float(x) - float(y))
                                 for x, y in zip(ra.split(","), rb.split(","))])
    log(f"driver resume: killed after fold 0's first epoch, resumed in place: metrics.csv "
        f"rows of both folds {'identical' if same else 'DIFFER'} to the uninterrupted run's "
        f"(largest difference {diff:.3g}; tolerance: identical text); "
        f"three runs in {time.perf_counter() - t0:.1f} s")
    check(same, "resumed metrics.csv rows differ from the uninterrupted run's")


def main() -> int:
    import torch
    check(torch.cuda.is_available(), "CUDA is not available")
    from multi_task_breast_cancer_tpu_torch.models.registry import init_multitask_model

    index_plane_lib = phase_device()
    # float32 means float32: no TF32 in cuDNN convolutions or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = init_multitask_model("MTnnUNet", generator=torch.Generator().manual_seed(0))
    model = model.to(DEVICE).eval()
    shapes = norm_shapes(model, DEVICE)
    kernel = phase_kernel(shapes)
    phase_model(model)
    del model
    torch.cuda.empty_cache()
    serve_launches = phase_serving()
    backward = phase_backward_kernel(shapes)
    augment = phase_augment_kernel(index_plane_lib)
    fwd, bwd, aug = phase_training()
    d_fwd, d_bwd, d_aug = phase_driver()

    norm_src = "multi_task_breast_cancer_tpu_torch/csrc/instance_norm_leaky_relu.cu"
    log(json.dumps({"kernels": [
        {"name": "instance_norm_leaky_relu", "route": "cuda", "source": norm_src,
         "replaces": "multi_task_breast_cancer_tpu/ops/pallas_kernels.py:34",
         "launches": serve_launches + fwd + d_fwd, **kernel},
        {"name": "instance_norm_leaky_relu_backward", "route": "cuda", "source": norm_src,
         "replaces": "multi_task_breast_cancer_tpu/ops/pallas_kernels.py:45",
         "launches": bwd + d_bwd, **backward},
        {"name": "fast_augment", "route": "cuda",
         "source": "multi_task_breast_cancer_tpu_torch/csrc/fast_augment.cu",
         "replaces": "multi_task_breast_cancer_tpu/ops/fast_augment.py:307",
         "launches": aug + d_aug, **augment}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
