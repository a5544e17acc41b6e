"""Serving artifacts of the port (counterpart of
``multi_task_breast_cancer_tpu/serve/export.py``): ``torch.export`` programs.

An artifact is a directory:

    manifest.json            the JAX manifest's keys (``torch_version`` in
                             place of ``jax_version``) and ``"format":
                             "torch.export"``
    weights.npz              flat ``path -> array`` dump of the weights in the
                             JAX layout (``params/backbone/.../kernel``, and
                             the batch statistics under ``batch_stats/``), so
                             a JAX tool reads it as it reads its own
    fwd_b{B}.{platform}.pt2  one exported forward per batch bucket B and
                             platform (``cpu``, ``cuda``)

Design points, as in the JAX package:

- **Fixed batch buckets**: one program per bucket; a request pads to the
  smallest bucket that fits, so serving never traces online.
- **Weights are an input, not a constant**: each program takes the flat
  weights and calls the model functionally on them. The model it traces
  holds its parameters on the ``meta`` device and is not a registered child
  of the traced module, so no program carries a weight (its ``state_dict``
  is empty): ``weights.npz`` can be swapped without exporting again, and N
  buckets hold no N copies.
- **One program per platform**: the trace records device assertions
  (``aten._assert_tensor_metadata``), so a program runs on the device it was
  traced for. Exporting ``cuda`` needs a card; it is never skipped.
- **The fused norm is one node** of each program, the custom operator
  ``mtbc_torch::instance_norm_leaky_relu`` (:mod:`..ops.hopper_kernels`): on
  the card it launches the kernel, 25 times per MTnnUNet forward; so is
  SwinUNETR's LayerNorm, ``mtbc_torch::layer_norm`` (:mod:`..ops.layer_norm`),
  20 times per forward. Loading an artifact imports those operator libraries
  and nothing of the model zoo.
- **bf16**: the program casts the f32 parameters and the input to bf16 and
  its outputs to f32, as JAX's does; the batch statistics, inputs like the
  weights, stay f32.
- The manifest also lists the model's transposed convolutions
  (``transposed_convs``), which tell the loader which 4-D kernels of
  ``weights.npz`` to read as transposed: loading builds no model.
- **Device-side postprocessing** (``device_postprocess=True``): the program
  emits the serving answer (:func:`_compact_outputs`): probabilities (f32),
  the mask as uint8 and the pixel counts the prediction-refinement rule
  needs. :class:`ExportedModel` bit-packs a binary mask on the device before
  the download (``np.unpackbits`` order).
- **A CUDA graph per (replica, bucket)** on the card (:mod:`..graphs`; eager
  on the CPU or with ``cuda_graphs=False``): :class:`ExportedModel` captures
  each program's execution with the device padding and the mask packing
  around it, on static inputs, the weights read in place; loading new
  weights (:meth:`ExportedModel.load_weights`) needs no capture.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multi_task_breast_cancer_tpu_torch import graphs
from multi_task_breast_cancer_tpu_torch.device import (
    COMPUTE_DTYPES,
    replica_devices,
    replica_streams,
    resolve_device,
    set_float32_policy,
    stream_context,
)
from multi_task_breast_cancer_tpu_torch.models.jax_weights import (
    flat_jax_weights,
    params_from_jax,
    transposed_convs,
)
from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels  # noqa: F401  (the operator library)
from multi_task_breast_cancer_tpu_torch.ops import layer_norm  # noqa: F401  (the operator library)
from multi_task_breast_cancer_tpu_torch.utils.trees import multitask_pair, tree_map

MANIFEST = "manifest.json"
WEIGHTS = "weights.npz"
FORMAT = "torch.export"


def _next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length() if n > 1 else 1


def program_name(bucket: int, platform: str) -> str:
    return f"fwd_b{bucket}.{platform}.pt2"


def _compact_outputs(out, task: str, n_classes: int,
                     softmax_in_forward: bool) -> Dict[str, torch.Tensor]:
    """Raw NHWC f32 outputs → the compact serving answer; a branch-for-branch
    twin of the JAX ``_compact_outputs``. Keys: ``probs`` f32 (B, n_classes)
    or (B, 1); ``mask`` uint8 (B, H, W), the binary mask or the per-pixel
    label map of a semantic head; ``tumor_pixels`` int32 (B,) for a binary
    mask; ``label_counts`` int32 (B, C) for a label map."""

    def cls_probs(cls_out):
        if isinstance(cls_out, (tuple, list)):  # mean over DS cls heads
            logits = torch.stack(list(cls_out), 0).mean(0)
        else:
            logits = cls_out
        if softmax_in_forward:  # forward already normalised (nnUNet quirk)
            return logits
        return torch.softmax(logits, -1) if n_classes > 2 else torch.sigmoid(logits)

    compact: Dict[str, torch.Tensor] = {}
    if task == "classification":
        compact["probs"] = cls_probs(out)
        return compact

    seg_out = out
    if task == "multitask":
        cls_out, seg_out = multitask_pair(out)
        compact["probs"] = cls_probs(cls_out)
    final = seg_out[-1] if isinstance(seg_out, (tuple, list)) else seg_out
    if final.shape[-1] > 1:  # semantic: per-pixel label map + pixel vote
        labels = final.argmax(-1).to(torch.uint8)
        compact["mask"] = labels
        one_hot = F.one_hot(labels.long(), final.shape[-1]).to(torch.int32)
        compact["label_counts"] = one_hot.sum(dim=(1, 2), dtype=torch.int32)
    else:  # binary: sigmoid(x) > 0.5  ⇔  x > 0
        mask = (final[..., 0] > 0).to(torch.uint8)
        compact["mask"] = mask
        compact["tumor_pixels"] = mask.to(torch.int32).sum(dim=(1, 2), dtype=torch.int32)
    return compact


class _Forward(nn.Module):
    """The exported function: (weights and buffers by ``state_dict`` name,
    NHWC f32 images) → the model's outputs as NHWC f32 (JAX's layout), or
    the compact answer. ``model`` is kept out of the registered children, so
    tracing lifts none of its tensors; its parameters may live on ``meta``.
    The parameters are cast to the compute dtype, the buffers are not."""

    def __init__(self, model: nn.Module, compute_dtype: str, compact=None):
        super().__init__()
        self.__dict__["_model"] = model
        self._params = frozenset(name for name, _ in model.named_parameters())
        self._dtype = COMPUTE_DTYPES[compute_dtype]
        self._compact = compact

    def forward(self, weights: Dict[str, torch.Tensor], images: torch.Tensor):
        x = images.permute(0, 3, 1, 2).to(self._dtype, memory_format=torch.contiguous_format)
        w = {k: v.to(self._dtype) if k in self._params else v for k, v in weights.items()}
        out = torch.func.functional_call(self._model, w, (x,))
        out = tree_map(lambda a: a.float().permute(0, 2, 3, 1) if a.dim() == 4 else a.float(),
                        out)
        return self._compact(out) if self._compact is not None else out


def export_inference(cfg, task: str, checkpoint, out_dir, buckets: Sequence[int] = (1, 8, 64),
                     size: int = 128, platforms: Sequence[str] = ("cpu", "cuda"),
                     device_postprocess: bool = False) -> Path:
    """Export a trained checkpoint (``None``: the seeded weights) into a
    serving artifact directory, one program per bucket and platform."""
    from multi_task_breast_cancer_tpu_torch.serve.post import model_applies_softmax
    from multi_task_breast_cancer_tpu_torch.train.driver import build_inference_state

    unknown = sorted(set(platforms) - {"cpu", "cuda"})
    if unknown:
        raise ValueError(f"export: unknown platforms {unknown} (cpu, cuda)")
    devices = {p: resolve_device("cuda" if p == "cuda" else "cpu") for p in platforms}
    compute_dtype = cfg.training.compute_dtype
    state, channels = build_inference_state(cfg, task, checkpoint=checkpoint, device="cpu",
                                            size=size)
    model = state.model.eval()
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    n_classes = len(cfg.data.classes)
    softmax_in_forward = model_applies_softmax(task, cfg.model.architecture, n_classes)
    compact = None
    if device_postprocess:
        def compact(out):
            return _compact_outputs(out, task, n_classes, softmax_in_forward)
    fwd = _Forward(model.to("meta"), compute_dtype, compact)

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    buckets = sorted(set(int(b) for b in buckets))
    for platform, device in devices.items():
        set_float32_policy(device, compute_dtype)
        on_device = {k: v.to(device) for k, v in weights.items()}
        for b in buckets:
            images = torch.zeros(b, size, size, channels, device=device)
            program = torch.export.export(fwd, (on_device, images))
            torch.export.save(program, out_dir / program_name(b, platform))
            logging.info("exported bucket B=%d for %s", b, platform)

    np.savez(out_dir / WEIGHTS, **flat_jax_weights(weights, model))
    manifest = {
        "task": task,
        "architecture": cfg.model.architecture,
        "n_classes": n_classes,
        "classes": list(cfg.data.classes),
        "size": size,
        "channels": channels,
        "buckets": buckets,
        "platforms": list(platforms),
        "compute_dtype": compute_dtype,
        "augmentation": cfg.data.augmentation.as_dict(),
        "pipeline_refinement": bool(cfg.training.overlap_class_based_on_seg),
        "softmax_in_forward": softmax_in_forward,
        "device_postprocess": bool(device_postprocess),
        "semantic_segmentation": bool(cfg.data.semantic_segmentation),
        "transposed_convs": sorted(transposed_convs(model)),
        "torch_version": torch.__version__,
        "checkpoint": str(checkpoint),
        "format": FORMAT,
    }
    (out_dir / MANIFEST).write_text(json.dumps(manifest, indent=2))
    logging.info("serving artifact written to %s", out_dir)
    return out_dir


def _pack_mask_bits(mask: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8 {0,1} → (B, H, W//8) uint8 in ``np.unpackbits`` order
    (big bit order): 8× fewer bytes for the mask's download."""
    b, h, w = mask.shape
    bits = mask.reshape(b, h, w // 8, 8).to(torch.int32)
    # 128, 64, ..., 1 made on the device: a graph capture allows no upload
    weights = 2 ** torch.arange(7, -1, -1, dtype=torch.int32, device=mask.device)
    return (bits * weights).sum(-1, dtype=torch.int32).to(torch.uint8)


class ExportedModel:
    """A loaded port artifact: bucketed, padded, chunked batch inference on
    one device (``cuda`` unless ``device="cpu"``), with the JAX
    ``ExportedModel``'s behaviour.

    ``predict`` takes any batch size: it pads up to the smallest bucket that
    fits, or chunks by the largest bucket with the tail in the smallest
    bucket that holds it (:meth:`_plan`). Padding rows never cross to the
    device: the host pads to the next power of two (repeating the last
    image) and the device the rest of the way to the bucket; outputs are
    sliced back to the next power of two on the device before the download.
    uint8 images are uploaded as uint8 and cast to f32 on the device (PNG
    intensities are exact either way). A device-postprocessed artifact's
    binary mask is bit-packed on the device and unpacked on the host.

    ``data_parallel=True`` (the JAX default) with ``device`` ``None`` or
    ``"cuda"`` uses every visible GPU (``devices`` names the replicas'
    devices instead; one may repeat): each device holds one copy of the
    weights, and a batch is sharded over the replicas only when that wins
    (:meth:`dp_shard`, JAX's rule); the shards' executions are started back
    to back, each replica on a stream of its own, and fetched together.

    Graphed (:func:`..graphs.enabled`, ``cuda_graphs``): one program per
    (replica, bucket), each captured when the model is built, after one
    eager run of it (as JAX compiles at startup). The host's rows are
    uploaded as they are and cast into the static (bucket, H, W, C) f32
    input, and their count written to a device scalar, outside the graph;
    the graph gathers the padding rows (the last row repeated, as the eager
    ``torch.cat``), runs the program on the weights where they live and
    packs the mask. Each execution's rows to download are copied off the
    static outputs, so a bucket may run again before the first answer is
    fetched."""

    def __init__(self, path, data_parallel: bool = True, device=None, devices=None,
                 cuda_graphs: bool = True):
        self.path = Path(path)
        self.manifest = json.loads((self.path / MANIFEST).read_text())
        if self.manifest.get("format") != FORMAT:
            raise ValueError(f"{self.path}: not a {FORMAT} artifact of the port")
        self.devices = replica_devices(device, data_parallel, devices)
        self.device = self.devices[0]
        self.platform = self.device.type
        if self.platform not in self.manifest["platforms"] or any(
                d.type != self.platform for d in self.devices):
            raise ValueError(f"{self.path}: no programs for every device of "
                             f"{[str(d) for d in self.devices]} (exported for "
                             f"{self.manifest['platforms']})")
        for d in self.devices:
            set_float32_policy(d, self.manifest["compute_dtype"])
        self._weights: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        self.load_weights(self.path / WEIGHTS)
        self._streams = replica_streams(self.devices)
        self.buckets = sorted(self.manifest["buckets"])
        self._fns: Dict[int, Any] = {}
        self.graphed = cuda_graphs and graphs.enabled(self.device)
        self._graphs: Dict[tuple, graphs.Program] = {}
        self._pools = [graphs.new_pool() for _ in self.devices] if self.graphed else []
        if self.graphed:
            self.preload()

    def load_weights(self, path) -> None:
        """The weights of a ``weights.npz`` (the artifact's layout) on each
        replica's device; once they are there, copied into the same tensors
        in place, so captured programs answer with the new weights."""
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        host = params_from_jax(flat, self.manifest["transposed_convs"])
        for d in set(self.devices):
            if d not in self._weights:
                self._weights[d] = {k: v.to(d) for k, v in host.items()}
                continue
            if set(host) != set(self._weights[d]):
                raise ValueError(f"{path}: other weights than the artifact's")
            for k, v in host.items():
                self._weights[d][k].copy_(v)

    def _fn(self, bucket: int):
        if bucket not in self._fns:
            program = torch.export.load(self.path / program_name(bucket, self.platform))
            self._fns[bucket] = program.module()
        return self._fns[bucket]

    def preload(self) -> None:
        """Load every bucket's program now instead of at its first use (and
        graphed, capture each (replica, bucket)): a server pays the
        deserialization at startup, not on a request."""
        for bucket in self.buckets:
            self._fn(bucket)
        for replica in range(len(self.devices) if self.graphed else 0):
            for bucket in self.buckets:
                self._graph(bucket, replica)

    def _run(self, bucket: int, device, x: torch.Tensor):
        """The program on ``x`` (rows already padded to ``bucket``), the
        binary mask of a compact answer bit-packed."""
        out = self._fn(bucket)(self._weights[device], x.to(torch.float32))
        if isinstance(out, dict) and "tumor_pixels" in out and out["mask"].shape[-1] % 8 == 0:
            out = dict(out)
            out["mask_packed"] = _pack_mask_bits(out.pop("mask"))
        return out

    def _graph(self, bucket: int, replica: int) -> graphs.Program:
        """The captured execution of ``bucket`` on ``replica``: static inputs
        (bucket, H, W, C) f32 and the real rows' count."""
        key = (replica, bucket)
        if key not in self._graphs:
            m, device = self.manifest, self.devices[replica]
            x = torch.zeros((bucket, m["size"], m["size"], m["channels"]), device=device)
            rows = torch.full((), bucket, dtype=torch.int64, device=device)

            def padded(x, rows):  # rows past the real ones repeat the last real one
                keep = torch.clamp(torch.arange(bucket, device=device), max=rows - 1)
                return self._run(bucket, device, x.index_select(0, keep))

            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side), torch.inference_mode():
                padded(x, rows)  # the eager warm-up
            with stream_context(self._streams[replica]), torch.inference_mode():
                self._graphs[key] = graphs.Program(padded, [x, rows], device, stream=side,
                                                   pool=self._pools[replica])
        return self._graphs[key]

    def _dispatch(self, images: np.ndarray, bucket: int, replica: int = 0):
        """Start one bucket execution on ``replica`` (asynchronous on the
        card); returns (device outputs, n, the replica's stream)."""
        n = images.shape[0]
        p = min(bucket, _next_pow2(n))
        if n < p:
            images = np.concatenate([images, np.repeat(images[-1:], p - n, axis=0)], axis=0)
        if images.dtype != np.uint8:
            images = images.astype(np.float32)
        device, stream = self.devices[replica], self._streams[replica]
        with stream_context(stream), torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(images)).to(device)
            if self.graphed:
                program = self._graph(bucket, replica)
                program.inputs[0][:p].copy_(x)
                program.inputs[1].fill_(p)
                return tree_map(lambda a: a[:p].clone(), program.replay()), n, stream
            if p < bucket:
                x = torch.cat([x, x[-1:].expand(bucket - p, *x.shape[1:])])
            out = self._run(bucket, device, x)
        return out, n, stream

    @staticmethod
    def _fetch(dispatched):
        def leaf(a, m):
            # the device-side slice to the next power of two before the
            # download: padded rows beyond it never leave the card
            return a[:min(_next_pow2(m), a.shape[0])].cpu().numpy()[:m]

        outs = []
        for out, n, stream in dispatched:
            with stream_context(stream):
                outs.append(tree_map(lambda a, m=n: leaf(a, m), out))
        merged = outs[0] if len(outs) == 1 else tree_map(
            lambda *parts: np.concatenate(parts, axis=0), *outs)
        if isinstance(merged, dict) and "mask_packed" in merged:
            merged = dict(merged)
            merged["mask"] = np.unpackbits(merged.pop("mask_packed"), axis=-1)
        return merged

    def _fit_bucket(self, size: int) -> int:
        """Smallest bucket that holds ``size`` images."""
        return next(b for b in self.buckets if b >= size)

    def _plan(self, n: int) -> list:
        """The buckets a run of ``n`` images executes: chunks of the largest
        bucket, the tail in the smallest bucket that holds it."""
        top, plan, i = self.buckets[-1], [], 0
        while i < n:
            take = min(n - i, top)
            plan.append(self._fit_bucket(take))
            i += take
        return plan

    def dp_shard(self, n: int) -> Optional[int]:
        """The rows per replica when ``n`` images are sharded over the
        replicas, or ``None`` when they run serially on the first: JAX's
        rule, data parallelism only when it wins. Each shard pads up to a
        bucket, so with sparse buckets a small shard can cost as much padded
        work as the whole batch; serial costs the sum of :meth:`_plan`, the
        sharded run the plan of one shard (the replicas run together)."""
        ndev, top = len(self.devices), self.buckets[-1]
        if ndev < 2 or n <= self.buckets[0]:
            return None
        shard = -(-n // ndev)
        if shard > top:  # chunk each replica's shard by the largest bucket
            shard = top * (-(-n // (top * ndev)))
        return shard if sum(self._plan(shard)) < sum(self._plan(n)) else None

    def predict(self, images: np.ndarray):
        """NHWC images (uint8 or float) → the program's outputs as numpy
        (raw NHWC f32 outputs, or the compact dict)."""
        n = images.shape[0]
        if n == 0:
            raise ValueError("empty batch: images has 0 rows")
        top = self.buckets[-1]
        shard = self.dp_shard(n)
        if shard is None:
            parts = [images[i:i + top] for i in range(0, n, top)]
            return self._fetch([self._dispatch(part, bucket)
                                for part, bucket in zip(parts, self._plan(n))])
        dispatched = []
        for i in range(0, n, shard):
            rows = images[i:i + shard]
            replica = (i // shard) % len(self.devices)
            for j in range(0, rows.shape[0], top):
                part = rows[j:j + top]
                dispatched.append(self._dispatch(part, self._fit_bucket(part.shape[0]),
                                                 replica))
        return self._fetch(dispatched)
