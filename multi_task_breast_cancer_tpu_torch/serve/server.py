"""Online inference server with dynamic micro-batching (stdlib only), over
the PyTorch port's models.

Request threads decode + enqueue images; a single batcher thread coalesces
whatever is queued (up to ``max_batch``, waiting at most ``batch_wait_ms``
for stragglers) into ONE device execution, so exactly one thread talks to
the GPU while concurrent HTTP clients share each forward.

The HTTP layer (``MicroBatcher``, the handler, ``InferenceServer``, body
decoding) is a copy of ``multi_task_breast_cancer_tpu/serve/server.py`` and
keeps its wire contract: PNG / JSON-base64 / ``application/octet-stream``
uint8 bodies (``.npy`` or raw size² planes with ``X-Image-Count``), JSON
records, and 400/413/500/504 for client faults, oversized bodies, backend
faults and timeouts. See that module for the endpoints.

Backends run the port's ``nn.Module``s (NCHW inside; NHWC float32 numpy at
the boundary, so :mod:`.post` is the JAX package's postprocessing):

- :class:`CheckpointBackend`: a model from a config, with seeded weights, a
  training checkpoint the port's driver wrote, or the ``weights.npz`` of a
  JAX serving artifact;
- :class:`ArtifactBackend`: a JAX serving artifact directory, read from its
  ``manifest.json`` and ``weights.npz`` (the ``.jaxexport`` programs are not
  used).
"""

from __future__ import annotations

import base64
import json
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, Optional, Sequence
from urllib.parse import urlparse, parse_qs

import numpy as np
import torch

from multi_task_breast_cancer_tpu_torch.device import resolve_device, set_float32_policy
from multi_task_breast_cancer_tpu_torch.models.jax_weights import (
    params_from_jax,
    widths_from_params,
)
from multi_task_breast_cancer_tpu_torch.models.registry import (
    init_classification_model,
    init_multitask_model,
    init_segmentation_model,
)
from multi_task_breast_cancer_tpu_torch.ops.image_ops import build_augment_channels
from multi_task_breast_cancer_tpu_torch.serve.post import (
    model_applies_softmax,
    postprocess,
)
from multi_task_breast_cancer_tpu_torch.train.checkpoint import (
    is_torch_checkpoint,
    load_pretrained_model,
)
from multi_task_breast_cancer_tpu_torch.train.state import TrainState


def nearest_resize(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """cv2.INTER_NEAREST-semantics resize of a (H, W) uint8 image (the numpy
    branch of ``multi_task_breast_cancer_tpu/native.py``): index =
    int(y * (sh/dh)) with the scale computed first as a double."""
    src = np.ascontiguousarray(src, np.uint8)
    sh, sw = src.shape
    ys = np.minimum((np.arange(dh, dtype=np.float64) * (sh / dh))
                    .astype(np.int64), sh - 1)
    xs = np.minimum((np.arange(dw, dtype=np.float64) * (sw / dw))
                    .astype(np.int64), sw - 1)
    return src[np.ix_(ys, xs)]


def prepare_image(gray: np.ndarray, size: int, augmentations: Dict[str, bool]
                  ) -> np.ndarray:
    """Raw grayscale uint8 → the (H, W, C) channel stack the model was
    trained on: nearest-resize to ``size`` and the config's augment channels
    (CLAHE, Sobel, …), as the training data is built. With no augment channel
    the stack stays uint8 and is cast on the device; augment channels make it
    float32."""
    if gray.shape != (size, size):
        gray = nearest_resize(gray, size, size)
    if not any(augmentations.values()):
        return gray[..., None]
    return np.concatenate([gray.astype(np.float32)[..., None],
                           build_augment_channels(gray, augmentations)], axis=-1)


def _build_model(task: str, architecture: str, channels: int, n_classes: int,
                 regions: int, nnunet_widths, width=None, deep_supervision=None):
    if task == "multitask":
        return init_multitask_model(architecture, sequences=channels,
                                    n_classes=n_classes, width=width,
                                    deep_supervision=deep_supervision,
                                    nnunet_widths=nnunet_widths)
    if task == "segmentation":
        return init_segmentation_model(architecture, sequences=channels,
                                       regions=regions, width=width,
                                       deep_supervision=deep_supervision,
                                       nnunet_widths=nnunet_widths)
    if task == "classification":
        return init_classification_model(architecture, sequences=channels,
                                         n_classes=n_classes, width=width,
                                         nnunet_widths=nnunet_widths)
    raise ValueError(f"unknown task {task!r}")


def _load_npz(path) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _to_numpy(out):
    """Output tree of NCHW tensors → NHWC float32 numpy (one permute each)."""
    if isinstance(out, (tuple, list)):
        return type(out)(_to_numpy(o) for o in out)
    if out.dim() == 4:
        out = out.permute(0, 2, 3, 1)
    return out.float().cpu().numpy()


def _slice(out, k: int):
    if isinstance(out, (tuple, list)):
        return type(out)(_slice(o, k) for o in out)
    return out[:k]


def _concat(parts):
    if isinstance(parts[0], (tuple, list)):
        return type(parts[0])(_concat([p[i] for p in parts])
                              for i in range(len(parts[0])))
    return np.concatenate(parts, axis=0)


class _TorchBackend:
    """One model on one device. ``predict`` runs batches of a fixed size
    from ``buckets`` (the smallest that holds a chunk; chunks of the largest
    for bigger sets), wrap-padding a short batch by repeating its images, as
    the JAX ``Engine.predict`` does. Images are uint8 (or float) NHWC, moved
    to the device as they are and cast there, NOT scaled: the models take raw
    0-255 intensities."""

    def __init__(self, model: torch.nn.Module, device, compute_dtype: str,
                 buckets: Sequence[int]) -> None:
        if compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype {compute_dtype!r} is not ported to PyTorch yet "
                f"(ROADMAP.md, Queue 1, slice 3); float32 only")
        set_float32_policy(device, compute_dtype)
        self.device = device
        self.model = model.to(device).eval()
        self.buckets = sorted(int(b) for b in buckets)

    def _forward(self, images: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        # NHWC → NCHW with NCHW strides. With one channel the permuted view
        # already passes for contiguous, but its strides are channels-last ones,
        # and the convolutions would carry them into their outputs
        x = x.permute(0, 3, 1, 2).to(torch.float32, memory_format=torch.contiguous_format)
        with torch.inference_mode():
            return _to_numpy(self.model(x))

    def predict(self, images: np.ndarray):
        n = images.shape[0]
        if n == 0:
            raise ValueError("empty batch: images has 0 rows")
        top = self.buckets[-1]
        outs = []
        for i in range(0, n, top):
            part = images[i:i + top]
            k = part.shape[0]
            bucket = next(b for b in self.buckets if b >= k)
            if k < bucket:
                part = np.concatenate([part] * -(-bucket // k), axis=0)[:bucket]
            outs.append(_slice(self._forward(part), k))
        return outs[0] if len(outs) == 1 else _concat(outs)

    def postprocess(self, out):
        return postprocess(out, self.info["task"], self.info["n_classes"],
                           self.info["pipeline_refinement"],
                           self.info["softmax_in_forward"])


class CheckpointBackend(_TorchBackend):
    """A model built from ``cfg`` on ``device`` (default ``cuda``), serving
    batches padded to ``max_batch``.

    ``checkpoint=None`` draws seeded weights (generator seed 0), as the JAX
    ``build_inference_state(checkpoint=None)`` gives a fresh init. A
    checkpoint the port's driver wrote (``fold_<n>/model_<ts>_fold_<n>``,
    ``.tar`` for segmentation) loads through
    ``train/checkpoint.load_pretrained_model``; a ``weights.npz`` in the JAX
    serving-artifact layout loads those weights. The JAX driver's
    flax-msgpack checkpoints are not read."""

    def __init__(self, cfg, task: str, checkpoint: Optional[str] = None,
                 size: int = 128, max_batch: int = 64, device=None):
        device = resolve_device(device)
        channels = cfg.model.sequences + cfg.data.augmentation.n_active()
        n_classes = len(cfg.data.classes)
        regions = 3 if (task == "segmentation" and cfg.data.semantic_segmentation) else 1
        model = _build_model(task, cfg.model.architecture, channels, n_classes,
                             regions, cfg.model.nnunet_widths,
                             width=cfg.model.width,
                             deep_supervision=cfg.model.deep_supervision)
        if checkpoint is not None:
            if Path(checkpoint).suffix == ".npz":
                model.load_state_dict(params_from_jax(_load_npz(checkpoint)), strict=True)
            elif is_torch_checkpoint(checkpoint):
                load_pretrained_model(TrainState(model=model, optimizer=None), checkpoint)
            else:
                raise NotImplementedError(
                    f"{checkpoint}: not a checkpoint of the port (torch.save) nor a "
                    f"weights.npz; the JAX driver's flax-msgpack checkpoints are not "
                    f"read by the port (ROADMAP.md, Queue 1)")
        super().__init__(model, device, cfg.training.compute_dtype, [max_batch])
        self.info = {
            "task": task, "architecture": cfg.model.architecture,
            "n_classes": n_classes, "classes": list(cfg.data.classes),
            "size": size, "channels": channels, "buckets": [max_batch],
            "augmentation": cfg.data.augmentation.as_dict(),
            "pipeline_refinement": bool(cfg.training.overlap_class_based_on_seg),
            "softmax_in_forward": model_applies_softmax(
                task, cfg.model.architecture, n_classes),
            "backend": "checkpoint", "device": str(device),
        }


class ArtifactBackend(_TorchBackend):
    """A JAX serving artifact (``serve export``) run by the port: the model is
    rebuilt from ``manifest.json`` (widths read from ``weights.npz``) and the
    raw outputs are postprocessed on the host. That equals the artifact's
    device-postprocessed answer, which the JAX tests prove equal to the raw
    one; the ``.jaxexport`` programs are not used."""

    def __init__(self, path: str, device=None):
        device = resolve_device(device)
        path = Path(path)
        m = json.loads((path / "manifest.json").read_text())
        params = _load_npz(path / "weights.npz")
        regions = 3 if (m["task"] == "segmentation"
                        and m.get("semantic_segmentation", False)) else 1
        model = _build_model(m["task"], m["architecture"], m["channels"],
                             m["n_classes"], regions, widths_from_params(params))
        model.load_state_dict(params_from_jax(params), strict=True)
        super().__init__(model, device, m.get("compute_dtype", "float32"), m["buckets"])
        self.info = {k: m[k] for k in ("task", "architecture", "n_classes",
                                       "classes", "size", "channels", "buckets",
                                       "augmentation", "pipeline_refinement")}
        self.info["softmax_in_forward"] = bool(m.get("softmax_in_forward", False))
        self.info["device_postprocess"] = False  # raw outputs, host postprocessing
        self.info["backend"] = "artifact"
        self.info["device"] = str(device)


@dataclass
class _Pending:
    images: np.ndarray                 # (K, H, W, C) — K=1 for /predict
    event: threading.Event = field(default_factory=threading.Event)
    results: Optional[list] = None     # K records
    error: Optional[str] = None
    # set by the submitter on timeout: nobody will read the result, so the
    # batcher sheds the work instead of amplifying an overload
    abandoned: threading.Event = field(default_factory=threading.Event)

    @property
    def k(self) -> int:
        return self.images.shape[0]


class MicroBatcher:
    """Coalesce concurrently queued requests into single device batches.

    A request may carry K images (the ``/predict_batch`` endpoint); the
    batcher flattens all queued images into one device batch (bounded by
    ``max_batch`` TOTAL images) and slices each request's records back out."""

    def __init__(self, backend, max_batch: int = 64, batch_wait_ms: float = 5.0):
        self._backend = backend
        self._max_batch = max_batch
        self._wait_s = batch_wait_ms / 1e3
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._carry: Optional[_Pending] = None  # over-budget request held
        self._stop = threading.Event()
        self.stats = {"requests": 0, "batches": 0, "max_batch_seen": 0,
                      "batched_requests": 0, "images": 0, "shed_requests": 0}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mtbc-batcher")
        self._thread.start()

    def submit(self, image: np.ndarray, timeout_s: float = 120.0) -> dict:
        return self.submit_many(image[None], timeout_s)[0]

    def submit_many(self, images: np.ndarray, timeout_s: float = 120.0) -> list:
        if self._stop.is_set():
            raise RuntimeError("server shutting down")
        p = _Pending(images=images)
        self._queue.put(p)
        if not p.event.wait(timeout_s):
            p.abandoned.set()  # shed: the batcher will drop it if not started
            raise TimeoutError("inference timed out")
        if p.error is not None:
            raise RuntimeError(p.error)
        return p.results

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        if self._thread.is_alive():
            # Batcher is stuck inside a long device call (e.g. a first-batch
            # compile). Touching _carry/_queue now would race it; the loop's
            # own ``finally`` fails all leftovers when it exits.
            logging.warning("batcher thread still busy at close; pending "
                            "requests will be failed when it exits")
            return
        self._fail_leftovers()  # idempotent second sweep after the loop's own

    def _fail_leftovers(self):
        """Fail still-pending work (queued or carried between batches) so
        clients get an immediate error instead of waiting out their submit
        timeout. Called from the loop thread's ``finally`` on exit and
        (idempotently) from ``close()`` once that thread is known dead —
        never concurrently."""
        leftovers = [] if self._carry is None else [self._carry]
        self._carry = None
        while True:
            try:
                leftovers.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for p in leftovers:
            p.error = "server shutting down"
            p.event.set()

    def _collect(self) -> list:
        if self._carry is not None:
            first, self._carry = self._carry, None
        else:
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                return []
        if first.abandoned.is_set():
            self.stats["shed_requests"] += 1
            return []  # next loop iteration collects afresh
        # A single request larger than max_batch runs alone (backends chunk
        # internally); coalescing never pushes the flattened total past
        # max_batch — an over-budget request is carried to the next batch.
        batch = [first]
        total = first.k
        deadline = time.monotonic() + self._wait_s
        while total < self._max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt.abandoned.is_set():
                self.stats["shed_requests"] += 1
                continue
            if total + nxt.k > self._max_batch:
                self._carry = nxt
                break
            batch.append(nxt)
            total += nxt.k
        return batch

    def _loop(self):
        try:
            self._loop_body()
        finally:
            # whichever side wins the close() race, leftovers (queued or
            # carried) get failed promptly instead of waiting out their
            # submit timeout — close() only repeats this if it outlived us
            self._fail_leftovers()

    def _loop_body(self):
        info = self._backend.info
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            n_images = sum(p.k for p in batch)
            try:
                images = np.concatenate([p.images for p in batch], axis=0)
                out = self._backend.predict(images)
                pp = getattr(self._backend, "postprocess", None)
                pred = pp(out) if pp is not None else postprocess(
                    out, info["task"], info["n_classes"],
                    info["pipeline_refinement"],
                    info.get("softmax_in_forward", False))
                off = 0
                for p in batch:
                    recs = []
                    for i in range(off, off + p.k):
                        rec = pred.record(i)
                        if pred.masks is not None:
                            rec["_mask"] = pred.masks[i]
                            rec["_mask_scale"] = pred.mask_scale
                        recs.append(rec)
                    p.results = recs
                    off += p.k
            except Exception as e:  # surface to every waiting request
                logging.exception("batch inference failed")
                for p in batch:
                    p.error = f"{type(e).__name__}: {e}"
            finally:
                self.stats["requests"] += len(batch)
                self.stats["images"] += n_images
                self.stats["batches"] += 1
                self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"],
                                                   n_images)
                # cross-REQUEST coalescing only: a lone multi-image request
                # is device batching the client asked for, not coalescing
                if len(batch) > 1:
                    self.stats["batched_requests"] += len(batch)
                for p in batch:
                    p.event.set()


MAX_BODY_BYTES = 32 << 20  # largest accepted request body (base64 PNG ≲ 24 MB)


class _BodyTooLarge(ValueError):
    pass


def _read_body(handler: BaseHTTPRequestHandler) -> bytes:
    length = int(handler.headers.get("Content-Length", 0))
    if length > MAX_BODY_BYTES:
        raise _BodyTooLarge(f"request body {length} B exceeds {MAX_BODY_BYTES} B")
    return handler.rfile.read(length)


def _decode_png(data: bytes) -> np.ndarray:
    import cv2
    img = cv2.imdecode(np.frombuffer(data, np.uint8), 0)
    if img is None:
        raise ValueError("request body is not a decodable image")
    return img


_NPY_MAGIC = b"\x93NUMPY"


def _decode_raw(body: bytes, size: int, count: int | None) -> np.ndarray:
    """``application/octet-stream`` body → grayscale uint8 image plane(s).

    Two accepted layouts, neither touching cv2/base64 (PNG decode on this
    path costs more CPU than the whole device forward — the raw path exists
    so high-throughput clients skip it entirely):

    - a ``.npy`` array (magic-sniffed): uint8, shape ``(H, W)`` or
      ``(N, H, W)`` — resized server-side if H/W differ from the model;
    - raw bytes: ``N·size²`` uint8 pixels, row-major ``size×size`` planes.

    ``count`` is the client's ``X-Image-Count`` header. Bare-raw bodies are
    shapeless, so byte length alone cannot distinguish N model-sized planes
    from one wrong-resolution image (a single 256² scan posted to a 128
    model is byte-for-byte 4 valid planes — confident garbage with 200 OK).
    Bare raw therefore requires the header whenever it would decode to more
    than one plane; npy bodies carry their own shape and only cross-check.
    """
    if body[:6] == _NPY_MAGIC:
        import io
        arr = np.load(io.BytesIO(body), allow_pickle=False)
        if arr.dtype != np.uint8:
            raise ValueError(f"npy payload must be uint8, got {arr.dtype}")
        if arr.ndim == 2:
            arr = arr[None]
        if arr.ndim != 3:
            raise ValueError(f"npy payload must be (H, W) or (N, H, W), "
                             f"got shape {arr.shape}")
        if count is not None and arr.shape[0] != count:
            raise ValueError(f"X-Image-Count: {count} but npy payload holds "
                             f"{arr.shape[0]} image(s)")
        return arr
    n, rem = divmod(len(body), size * size)
    if rem or n == 0:
        raise ValueError(
            f"octet-stream body of {len(body)} B is neither .npy nor a "
            f"whole number of raw {size}x{size} uint8 planes")
    if count is None and n > 1:
        raise ValueError(
            f"bare-raw body decodes to {n} {size}x{size} planes but no "
            f"X-Image-Count header asserts that count — a single image at "
            f"the wrong resolution is indistinguishable from {n} planes; "
            f"send X-Image-Count: {n}, or an .npy body (self-describing)")
    if count is not None and n != count:
        raise ValueError(f"X-Image-Count: {count} but the body holds {n} "
                         f"raw {size}x{size} plane(s)")
    return np.frombuffer(body, np.uint8).reshape(n, size, size)


def _declared_count(handler: BaseHTTPRequestHandler) -> int | None:
    raw = handler.headers.get("X-Image-Count")
    if raw is None:
        return None
    try:
        count = int(raw)
    except ValueError:
        count = 0
    if count <= 0:
        raise ValueError(f"X-Image-Count: {raw!r} is not a positive integer")
    return count


def _content_type(handler: BaseHTTPRequestHandler) -> str:
    return (handler.headers.get("Content-Type") or "").split(";")[0].strip()


def _decode_body(handler: BaseHTTPRequestHandler, size: int) -> np.ndarray:
    body = _read_body(handler)
    ctype = _content_type(handler)
    if ctype == "application/octet-stream":
        planes = _decode_raw(body, size, _declared_count(handler))
        if planes.shape[0] != 1:
            raise ValueError(f"/predict takes ONE image; got {planes.shape[0]}"
                             " planes (use /predict_batch)")
        return planes[0]
    if ctype == "application/json":
        payload = json.loads(body)
        body = base64.b64decode(payload["image_b64"])
    return _decode_png(body)


MAX_BATCH_IMAGES = 1024  # largest accepted /predict_batch request


def _decode_batch_body(handler: BaseHTTPRequestHandler, size: int) -> list:
    """``/predict_batch`` body: JSON ``{"images_b64": [<base64 PNG>, ...]}``
    or ``application/octet-stream`` uint8 planes (see :func:`_decode_raw`)."""
    body = _read_body(handler)
    if _content_type(handler) == "application/octet-stream":
        planes = _decode_raw(body, size, _declared_count(handler))
        if planes.shape[0] > MAX_BATCH_IMAGES:
            raise ValueError(f"batch of {planes.shape[0]} exceeds "
                             f"{MAX_BATCH_IMAGES}")
        return list(planes)
    payload = json.loads(body)
    encoded = payload.get("images_b64")
    if not isinstance(encoded, list) or not encoded:
        raise ValueError('expected JSON {"images_b64": [<base64 PNG>, ...]} '
                         'or an application/octet-stream uint8 body')
    if len(encoded) > MAX_BATCH_IMAGES:
        raise ValueError(f"batch of {len(encoded)} exceeds {MAX_BATCH_IMAGES}")
    return [_decode_png(base64.b64decode(e)) for e in encoded]


def make_handler(batcher: MicroBatcher, info: dict):
    import cv2

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through logging, not stderr
            logging.debug("http: " + fmt, *args)

        def _json(self, code: int, obj: dict):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, {"status": "ok", "model": info})
            elif path == "/stats":
                self._json(200, dict(batcher.stats))
            else:
                self._json(404, {"error": "not found"})

        def _attach_mask(self, rec, want_mask):
            mask = rec.pop("_mask", None)
            scale = rec.pop("_mask_scale", 255)
            if mask is not None and want_mask:
                ok, png = cv2.imencode(".png", (mask * scale).astype(np.uint8))
                if ok:
                    rec["mask_b64"] = base64.b64encode(png.tobytes()).decode()
            return rec

        def do_POST(self):
            url = urlparse(self.path)
            if url.path not in ("/predict", "/predict_batch"):
                self._json(404, {"error": "not found"})
                return
            t0 = time.perf_counter()
            want_mask = parse_qs(url.query).get("mask", ["0"])[0] == "1"
            # client faults (bad payload) → 4xx; backend/infra faults → 5xx,
            # so retry policies and health alarms key on the right side
            try:
                if url.path == "/predict_batch":
                    grays = _decode_batch_body(self, info["size"])
                    images = np.stack([
                        prepare_image(g, info["size"], info["augmentation"])
                        for g in grays])
                else:
                    gray = _decode_body(self, info["size"])
                    images = prepare_image(gray, info["size"],
                                           info["augmentation"])[None]
            except _BodyTooLarge as e:
                self._json(413, {"error": str(e)})
                return
            except Exception as e:
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                recs = batcher.submit_many(images)
            except TimeoutError as e:
                self._json(504, {"error": f"{type(e).__name__}: {e}"})
                return
            except Exception as e:
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            recs = [self._attach_mask(r, want_mask) for r in recs]
            latency = round((time.perf_counter() - t0) * 1e3, 2)
            if url.path == "/predict_batch":
                self._json(200, {"predictions": recs, "count": len(recs),
                                 "latency_ms": latency})
            else:
                rec = recs[0]
                rec["latency_ms"] = latency
                self._json(200, rec)

    return Handler


class _HTTPServer(ThreadingHTTPServer):
    # A burst of clients connecting faster than the accept loop drains them
    # must queue in the kernel, not get RST; socketserver's default listen
    # backlog of 5 resets connections under modest concurrency (observed at
    # 32 simultaneous clients on a one-core host).
    request_queue_size = 128


class InferenceServer:
    """Owns the HTTP server + batcher; ``serve_forever`` or use as a context
    manager in tests (``with InferenceServer(...) as srv: srv.port``)."""

    def __init__(self, backend, host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 64, batch_wait_ms: float = 5.0):
        self.batcher = MicroBatcher(backend, max_batch=max_batch,
                                    batch_wait_ms=batch_wait_ms)
        self.httpd = _HTTPServer(
            (host, port), make_handler(self.batcher, backend.info))
        self.port = self.httpd.server_address[1]

    def __enter__(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="mtbc-http")
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()

    def serve_forever(self):
        logging.info("serving on port %d", self.port)
        with self:
            try:
                threading.Event().wait()
            except KeyboardInterrupt:
                logging.info("shutting down")
