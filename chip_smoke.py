#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Run from the repository root, with one CUDA card visible. Without CUDA, or
without the repository beside it, it exits non-zero and prints no result.
Phases, in turn; any mismatch ends the run with a non-zero exit:

1. device: the card's name and power limit (``nvidia-smi``), the torch and
   CUDA versions, and the seconds the kernel build took (``nvcc``, sm_90a);
2. kernel: ``instance_norm_leaky_relu`` against its plain PyTorch version at
   every (C, H·W) shape the flagship's forward gives it at 128², batch 64,
   in f32 and bf16, with the kernel's, the plain version's and the library
   call's times (``F.instance_norm`` + ``F.leaky_relu``, timed here only) and
   the bytes bound;
3. model: the full-width MTnnUNet (widths 32…320, seeded weights), batch 64 at
   128², with the kernel against the same model with the plain norm on the
   card and against the plain model on the CPU at batch 2; exactly 25 kernel
   launches per forward; forward time and images/s;
4. serving, the main path: ``InferenceServer(CheckpointBackend(...))`` answers
   one raw plane on ``/predict`` and 64 raw planes on ``/predict_batch``; the
   records must equal the backend's direct answer; the kernel's launch count
   over these requests must be 25 per forward the server ran;
5. a JSON line ``{"kernels": [...]}`` with each kernel's launches on the main
   path, error, times and bound; then, last, ``{"ok": true, "device": ...}``.

Tolerances. f32 kernel vs plain: 1e-5 absolute (the same f32 arithmetic,
summed in another order). bf16 kernel vs plain: one bf16 ulp (2^-7 of the
value), because the two sum in different orders and an f32 result beside a
rounding boundary may round either way. Model outputs: 1e-4 of the output's
largest magnitude, f32 with TF32 off; the paths differ only in the order of
their f32 sums (norm statistics, cuDNN vs CPU convolutions), carried through
25 normalised layers.
"""

from __future__ import annotations

import json
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


def log(*args) -> None:
    print(*args, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        print(f"chip_smoke: FAIL: {what}", file=sys.stderr, flush=True)
        sys.exit(1)


def time_ms(fn, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` launches, each after the L2
    cache is flushed (a 256 MB write), so every launch reads its input cold."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.float32, device=DEVICE)
    fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound_ms(numel: int, itemsize: int) -> tuple:
    """Least time for one launch: every element read once and written once
    over the memory rate, or the arithmetic over the f32 rate; the larger."""
    by_bytes = 2 * numel * itemsize / HBM_BYTES_PER_S * 1e3
    by_ops = FLOPS_PER_ELEMENT * numel / F32_FLOPS_PER_S * 1e3
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


def phase_device() -> None:
    import torch
    from multi_task_breast_cancer_tpu_torch.ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip())
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    log(f"kernel build: {_build.build():.2f} s ({', '.join(_build.sources())})")


def phase_kernel(shapes: Counter) -> dict:
    import torch
    import torch.nn.functional as F
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk

    g = torch.Generator(device=DEVICE).manual_seed(0)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    bound_kinds, max_err = set(), 0.0
    log(f"kernel instance_norm_leaky_relu at batch {BATCH}: "
        f"{len(shapes)} shapes, {sum(shapes.values())} sites per forward")
    for (c, h, w), sites in sorted(shapes.items(), key=lambda kv: -kv[0][1] * kv[0][2]):
        # offset planes: the two-pass variance must not lose the centred part
        x = torch.randn(BATCH, c, h, w, device=DEVICE, generator=g) * 2.0 + 5.0
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            got, want = hk.instance_norm_leaky_relu(xd), hk.instance_norm_leaky_relu_reference(xd)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            if dtype == torch.float32:
                ok = err.max().item() <= F32_TOL
                max_err = max(max_err, err.max().item())
            else:
                ok = bool((err <= BF16_REL_TOL * want.float().abs() + 1e-6).all())
            check(ok, f"kernel != plain at C={c} HxW={h}x{w} {dtype}: "
                      f"max abs err {err.max().item():.3g}")
            k_ms = time_ms(lambda: hk.instance_norm_leaky_relu(xd))
            p_ms = time_ms(lambda: hk.instance_norm_leaky_relu_reference(xd))
            b_ms, kind = bound_ms(xd.numel(), xd.element_size())
            line = (f"  C={c:4d} HxW={h:3d}x{w:<3d} x{sites} {str(dtype)[6:]:8s} "
                    f"err {err.max().item():.3g}  kernel {k_ms:.4f} ms  "
                    f"plain {p_ms:.4f} ms  bound {b_ms:.4f} ms ({kind})")
            if dtype == torch.float32:
                l_ms = time_ms(lambda: F.leaky_relu(F.instance_norm(xd), 0.01))
                line += f"  library {l_ms:.4f} ms"
                for key, v in (("ms", k_ms), ("plain_ms", p_ms),
                               ("library_ms", l_ms), ("bound_ms", b_ms)):
                    totals[key] += sites * v
                bound_kinds.add(kind)
            log(line)
    log(f"kernel totals over one f32 forward's {sum(shapes.values())} launches: "
        + ", ".join(f"{k} {v:.4f}" for k, v in totals.items()))
    return {"max_abs_err": max_err, "bound_by": "bytes" if bound_kinds == {"bytes"}
            else "operations", **totals}


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


def main() -> int:
    import torch
    check(torch.cuda.is_available(), "CUDA is not available")
    from multi_task_breast_cancer_tpu_torch.models.registry import init_multitask_model

    phase_device()
    # float32 means float32: no TF32 in cuDNN convolutions or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = init_multitask_model("MTnnUNet", generator=torch.Generator().manual_seed(0))
    model = model.to(DEVICE).eval()
    kernel = phase_kernel(norm_shapes(model, DEVICE))
    phase_model(model)
    del model
    torch.cuda.empty_cache()
    launches = phase_serving()

    log(json.dumps({"kernels": [{
        "name": "instance_norm_leaky_relu", "route": "cuda",
        "source": "multi_task_breast_cancer_tpu_torch/csrc/instance_norm_leaky_relu.cu",
        "replaces": "multi_task_breast_cancer_tpu/ops/pallas_kernels.py:34",
        "launches": launches, **kernel}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
