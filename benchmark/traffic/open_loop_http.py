"""Serving traffic: open-loop Poisson arrivals of one-image
``POST /predict?mask=1`` requests (raw uint8 planes) into the port's
``InferenceServer`` over a ``CheckpointBackend``, with ``serve run``'s
defaults (max batch 64, batch wait 5 ms, one replica, graphed).

Set-up builds the backend (which captures its bucket's CUDA graph), swaps
in weights drawn from the seed, starts the server, warms the handler with a
few requests, and runs ``warm_s`` of the cell's own traffic before the
window opens. The client (``loadgen.py``) runs in a process of its
own and sends every request at its due time, on a schedule of the cell's
rate drawn from the seed; ``serve_p95_ms`` is the 95th percentile, over
every request due in the window, of the time from its due time to the last
byte of its answer, a request never answered counting above every answered
one. The client's lateness is logged on an earlier line.

Once every answer is in and the peak memory is read, the server is shut
and the plain reference (``benchmark/reference``) computes a sample of the
answered scans, drawn from the seed with the slowest answer in it; each
served probability, mask and class is held to it.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

import numpy as np

WARM_REQUESTS = 8
GRACE_S = 60.0
LEAD_S = 2.0  # the client's start-up before the first due time


def _port_config(cfg: dict):
    from multi_task_breast_cancer_tpu_torch.config import Config, DataConfig, ModelConfig
    cfg_model = ModelConfig(architecture=cfg["architecture"],
                            nnunet_widths=cfg["port_kwargs"].get("nnunet_widths"))
    return Config(model=cfg_model, data=DataConfig(classes=list(cfg["classes"])))


def start_server(torch, ctx, params: dict):
    """The backend with the seed's weights, and the server started on it."""
    from multi_task_breast_cancer_tpu_torch.serve.server import (CheckpointBackend,
                                                                 InferenceServer)
    from benchmark import data
    cfg = ctx.config
    backend = CheckpointBackend(_port_config(cfg), cfg["task"], size=cfg["size"],
                                max_batch=params["max_batch"], device=ctx.device,
                                data_parallel=False)
    shapes = {n: tuple(t.shape) for n, t in backend.model.state_dict().items()}
    backend.load_weights(data.seeded_state(torch, shapes, ctx.seed, ctx.device))
    if ctx.backend_hook is not None:
        ctx.backend_hook(backend)
    server = InferenceServer(backend, port=0, max_batch=params["max_batch"],
                             batch_wait_ms=params["batch_wait_ms"])
    return server.__enter__()


def _get_stats(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as r:
        return json.loads(r.read())


def _warm(port: int, pool: np.ndarray) -> None:
    for i in range(WARM_REQUESTS):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict?mask=1",
                                     data=pool[i % len(pool)].tobytes(),
                                     headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=120) as r:
            r.read()


def offer(port: int, pool: np.ndarray, due: np.ndarray, image: np.ndarray, keep,
          start: float, workdir: str, during=None) -> dict:
    """Run the client process over the schedule (``due`` s after ``start``,
    a monotonic time); ``during`` runs in this process meanwhile. Returns
    the client's results."""
    pool_path = os.path.join(workdir, "pool.npy")
    np.save(pool_path, pool)
    spec = {"host": "127.0.0.1", "port": port, "pool": pool_path, "start": start,
            "due": [float(d) for d in due], "image": [int(i) for i in image],
            "keep": [int(k) for k in keep], "grace_s": GRACE_S,
            "out": os.path.join(workdir, "results.json")}
    spec_path = os.path.join(workdir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    client = subprocess.Popen([sys.executable, str(Path(__file__).with_name("loadgen.py")),
                               spec_path])
    try:
        if during is not None:
            during()
        client.wait(timeout=start - time.monotonic() + float(due[-1]) + GRACE_S + 60)
    finally:
        if client.poll() is None:
            client.kill()
            client.wait()
    if client.returncode != 0:
        raise RuntimeError(f"the load generator exited with {client.returncode}")
    with open(spec["out"]) as f:
        return json.load(f)


def tail_ms(latency_s, wait_s: float, q: float = 95.0) -> float:
    """The ``q``-th percentile of the latencies (ms), each missing answer
    counted as the whole wait it was given, above every answered one."""
    values = np.asarray([wait_s if v is None else v for v in latency_s], np.float64)
    return float(np.percentile(values, q)) * 1e3


def _decode_mask(b64: str) -> np.ndarray:
    import base64
    import cv2
    png = np.frombuffer(base64.b64decode(b64), np.uint8)
    return (cv2.imdecode(png, cv2.IMREAD_GRAYSCALE) > 0).astype(np.uint8)


def served_answers(kept: dict) -> dict:
    out = {}
    for i, text in kept.items():
        rec = json.loads(text)
        out[int(i)] = {"probs": rec["probs"], "predicted_class": rec["predicted_class"],
                       "mask": _decode_mask(rec["mask_b64"])}
    return out


def reference_logits(torch, ctx, images: np.ndarray, tf32: bool = False):
    from benchmark.reference import models, serve as S, train as R
    cfg = ctx.config
    if torch.device(ctx.device).type == "cuda":
        R.cuda_f32(tf32)
    model = models.build(cfg["reference_model"], **cfg["reference_kwargs"]).to(ctx.device)
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    from benchmark import data
    model.load_state_dict(data.seeded_state(torch, shapes, ctx.seed, ctx.device))
    model.eval()
    out = S.logits(model, images, ctx.device)
    if torch.device(ctx.device).type == "cuda":
        R.cuda_f32(False)
    return out


def schedule(ctx, params: dict):
    """The pool of scans and the arrivals from the seed: due times (s from
    the window's start; the warm-up's ``warm_s`` of the same traffic comes
    first, at negative times), each request's scan, the sample of the
    window's requests compared, and how many requests the warm-up sends."""
    from benchmark import data
    rng = np.random.default_rng(ctx.seed)
    per_class = {c: params["pool"] // 3 + (k < params["pool"] % 3)
                 for k, c in enumerate(data.CLASSES)}
    pool, _, _ = data.scans(rng, per_class, ctx.config["size"])
    warm = data.arrivals(int(rng.integers(0, 2 ** 62)), params["rate"], params["warm_s"])
    due = data.arrivals(int(rng.integers(0, 2 ** 62)), params["rate"], ctx.seconds)
    due = np.concatenate([warm - params["warm_s"], due])
    image = rng.integers(0, len(pool), len(due))
    n_warm = len(warm)
    keep = n_warm + rng.choice(len(due) - n_warm, min(params["sample"], len(due) - n_warm),
                               replace=False)
    return pool, due, image, keep, n_warm


def run(ctx) -> dict:
    import torch
    from benchmark.reference import serve as S
    params = ctx.workload["params"]
    pool, due, image, keep, n_warm = schedule(ctx, params)
    ctx.log(f"set-up: scans at {time.perf_counter() - ctx.t_start:.3f} s")
    server = start_server(torch, ctx, params)
    ctx.log(f"set-up: server at {time.perf_counter() - ctx.t_start:.3f} s")
    cuda = torch.device(ctx.device).type == "cuda"
    traced = {}
    try:
        _warm(server.port, pool)
        before = _get_stats(server.port)
        start = time.monotonic() + LEAD_S + params["warm_s"]
        setup_s = time.perf_counter() - ctx.t_start + LEAD_S + params["warm_s"]

        def during():
            if not ctx.trace:
                return
            from benchmark import trace
            time.sleep(max(start + 0.3 * ctx.seconds - time.monotonic(), 0.0))
            found = trace.window(torch, lambda: time.sleep(params["traced_s"]))
            if found is not None:
                traced.update(found)

        with tempfile.TemporaryDirectory() as workdir:
            res = offer(server.port, pool, due, image, keep, start, workdir, during)
        after = _get_stats(server.port)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        server.__exit__(None, None, None)
    del server
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    late = np.asarray(res["late_s"], np.float64) * 1e3
    ctx.log(f"client: {len(due) - n_warm} requests at {params['rate']} /s after {n_warm} "
            f"of warm-up, sent late by "
            f"p50 {np.percentile(late, 50):.3f} ms, p99 {np.percentile(late, 99):.3f} ms, "
            f"max {late.max():.3f} ms")
    failed = sum(1 for s, v in zip(res["status"], res["latency_s"]) if s != 200 or v is None)
    answers = served_answers(res["kept"])
    idx = sorted(answers)
    ref_cls, ref_seg = reference_logits(torch, ctx, pool[image[idx]])
    gaps = S.answer_gaps([answers[i] for i in idx], ref_cls, ref_seg)
    limits = ctx.workload["limits"]
    out = {"setup_s": setup_s, "peak_bytes": peak, "attempted": len(due), "failed": failed,
           "checks": [(k, gaps[k], limits[k]) for k in limits],
           "e2e": {"serve_p95_ms": tail_ms(res["latency_s"][n_warm:], res["wait_s"])},
           "readings": {"gaps": gaps, "compared": len(idx)}, "record": None, "traced": None}
    if ctx.trace and traced:
        out["traced"] = traced
        out["record"] = {"kind": "serve", "window_s": traced["window_s"],
                         "busy_s": traced["busy_s"], "kernels": traced["kernels"],
                         "handler_ms": [h for h in res["handler_ms"][n_warm:] if h is not None],
                         "stats_before": before, "stats_after": after}
    return out
