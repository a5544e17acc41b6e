"""The training Engine (twin of ``multi_task_breast_cancer_tpu/train/loop.py``).

The JAX Engine jits a whole epoch as one ``lax.scan``. Here the epoch is a
Python loop over steps that never waits for the device: the fold lives on the
device (``device_data``), each step gathers its rows there, augments them
(the 3-shear kernel, or the exact single gather), runs forward, backward and
the optimizer, and adds its loss, Dice and confusion matrix to sums that stay
on the device. The sums are fetched once per epoch, as one transfer.

Cross-fold padding steps (``step_valid == 0``) are skipped on the host, so
they leave the parameters, the optimizer's moments and the step count
untouched (the JAX scan selects the old state for them).

Tasks: 'segmentation' | 'classification' | 'multitask'. Layout NCHW; f32
only (``compute_dtype='bfloat16'`` and meshes raise ``NotImplementedError``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from multi_task_breast_cancer_tpu_torch.data.augment import joint_transform_stack_batch
from multi_task_breast_cancer_tpu_torch.data.dataset import ArrayDataset
from multi_task_breast_cancer_tpu_torch.device import resolve_device, set_float32_policy
from multi_task_breast_cancer_tpu_torch.ops import fast_augment as FA
from multi_task_breast_cancer_tpu_torch.ops import losses as L
from multi_task_breast_cancer_tpu_torch.ops import metrics as M
from multi_task_breast_cancer_tpu_torch.ops.fused_loss import fused_dice_criterion
from multi_task_breast_cancer_tpu_torch.train.state import TrainState


@dataclasses.dataclass
class EngineConfig:
    task: str                      # 'segmentation' | 'classification' | 'multitask'
    n_classes: int = 3
    batch_size: int = 2
    alpha: float = 0.35            # multitask loss weight: α·seg + (1-α)·cls
    inversely_weighted: bool = True
    seg_criterion: str = "DICE"
    cls_criterion: str = "Focal"
    classes_weighted: Optional[list] = None
    # joint geometric transforms (reference driver pipeline)
    use_transforms: bool = True
    p_hflip: float = 0.5
    p_vflip: float = 0.5
    max_angle: float = 360.0
    compute_dtype: str = "float32"
    # 3-shear augmentation kernel (PARITY D13). The user-facing default
    # (config.TrainingConfig.fast_augmentation) is True; the Engine's own
    # default stays False, as in the JAX package, so a directly built Engine
    # keeps the exact torchvision-parity rotation unless it opts in.
    fast_augmentation: bool = False


def make_cls_targets(labels: np.ndarray, n_classes: int,
                     task: str = "classification") -> np.ndarray:
    """Reference target encoding: multiclass → one-hot float; binary → (B, 1)
    float labels. Labels beyond ``n_classes`` fail (the reference's label map
    is fixed: benign=0, malignant=1, normal=2), except for segmentation,
    which never reads the targets."""
    if task != "segmentation" and np.max(labels, initial=0) >= max(n_classes, 2):
        raise ValueError(
            f"label values up to {int(np.max(labels))} exceed "
            f"n_classes={n_classes}: the reference label map is fixed "
            "(benign=0, malignant=1, normal=2) and class subsets are not "
            "remapped — a 2-class config must use "
            "classes: [benign, malignant]")
    if n_classes > 2:
        return np.eye(n_classes, dtype=np.float32)[labels]
    return labels.astype(np.float32)[:, None]


def plan_epoch_indices(n: int, batch_size: int, rng: np.random.Generator,
                       pad_to_steps: Optional[int] = None) -> np.ndarray:
    """Shuffled index array padded to steps·B by wrap-around; ``pad_to_steps``
    pads further to a cross-fold maximum (the extra steps are masked out by
    :func:`step_valid_mask`)."""
    perm = rng.permutation(n)
    steps = -(-n // batch_size)
    if pad_to_steps is not None:
        steps = max(steps, pad_to_steps)
    pad = steps * batch_size - n
    if pad:
        reps = -(-pad // n)
        perm = np.concatenate([perm] + [perm] * reps)[:steps * batch_size]
    return perm.astype(np.int32)


def step_valid_mask(n: int, batch_size: int, total_steps: int) -> np.ndarray:
    """1.0 for the real ``ceil(n/B)`` steps, 0.0 for cross-fold padding steps."""
    real = -(-n // batch_size)
    return (np.arange(total_steps) < real).astype(np.float32)


class Engine:
    """Epoch training, validation and prediction for one model + task
    configuration on one device (``cuda`` unless ``device='cpu'``)."""

    def __init__(self, model: nn.Module, cfg: EngineConfig,
                 device: Optional[Union[str, torch.device]] = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError("Engine: meshes (data/spatial parallelism) are "
                                      "not ported yet (ROADMAP.md, Queue 1, slice 4)")
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(f"Engine: compute_dtype {cfg.compute_dtype!r} is "
                                      "not ported yet; the port trains in float32")
        if cfg.task not in ("segmentation", "classification", "multitask"):
            raise ValueError(f"Engine: unknown task {cfg.task!r}")
        self.device = resolve_device(device)
        set_float32_policy(self.device, cfg.compute_dtype)
        self.model = model.to(self.device)
        self.cfg = cfg
        self._aug_fmt = None  # (AugFormat, n_mask) of the packed fold, set by device_data
        self._seg_crit = (fused_dice_criterion if cfg.seg_criterion == "DICE"
                          else L.init_criterion_segmentation(cfg.seg_criterion))
        self._cls_crit = L.init_criterion_classification(
            cfg.n_classes, cfg.classes_weighted, cfg.cls_criterion, device=self.device)

    # ------------------------------------------------------------------
    # forward + loss
    # ------------------------------------------------------------------

    def _losses(self, out, masks, cls_targets) -> Tuple[torch.Tensor, Dict[str, Any]]:
        cfg = self.cfg
        if cfg.task == "segmentation":
            loss = L.apply_criterion_binary_segmentation(
                self._seg_crit, masks, out, cfg.inversely_weighted)
            return loss, {"seg_out": out}
        if cfg.task == "classification":
            self._check_cls_head(out)
            return L.apply_criterion_classification(self._cls_crit, cls_targets, out), \
                {"cls_out": out}
        cls, seg = out
        self._check_cls_head(cls)
        seg_loss, cls_loss = L.apply_criterion_multitask(
            self._seg_crit, masks, seg, self._cls_crit, cls_targets, cls,
            cfg.inversely_weighted)
        loss = cfg.alpha * seg_loss + (1 - cfg.alpha) * cls_loss
        return loss, {"seg_out": seg, "cls_out": cls, "seg_loss": seg_loss,
                      "cls_loss": cls_loss}

    def _check_cls_head(self, cls_out) -> None:
        """A head whose logit count disagrees with ``n_classes`` would train
        silently wrong through broadcasting: fail instead."""
        head = cls_out[0] if isinstance(cls_out, (tuple, list)) else cls_out
        expected = self.cfg.n_classes if self.cfg.n_classes > 2 else 1
        if head.shape[-1] != expected:
            raise ValueError(
                f"classification head emits {head.shape[-1]} logits but "
                f"n_classes={self.cfg.n_classes} needs {expected} (binary "
                "collapses to 1 logit)")

    @staticmethod
    def _final_seg_head(seg_out):
        return seg_out[-1] if isinstance(seg_out, (tuple, list)) else seg_out

    @staticmethod
    def _mean_cls_head(cls_out):
        """Deep-supervised cls lists are averaged for prediction."""
        if isinstance(cls_out, (tuple, list)):
            return torch.stack(list(cls_out), dim=0).mean(dim=0)
        return cls_out

    def _step_metrics(self, aux, masks, labels_int, cm) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if "seg_out" in aux:
            out["dice"] = M.dice_from_logits_batch(
                masks, self._final_seg_head(aux["seg_out"]).detach())
        if "cls_out" in aux:
            logits = self._mean_cls_head(aux["cls_out"]).detach()
            preds = M.predicted_labels_from_logits(logits, self.cfg.n_classes)
            out["cm"] = M.confusion_matrix_update(cm, labels_int, preds,
                                                  max(self.cfg.n_classes, 2))
        return out

    def _epoch_metrics(self, sums: Dict[str, torch.Tensor], n_real: float
                       ) -> Dict[str, torch.Tensor]:
        cm = sums["cm"]
        return {
            "loss": sums["loss"] / n_real,
            "seg_loss": sums["seg_loss"] / n_real,
            "cls_loss": sums["cls_loss"] / n_real,
            "dice": sums["dice"] / n_real,
            "acc": M.accuracy_from_cm(cm),
            "f1": M.f1_weighted_from_cm(cm),
            # micro-F1 over a fixed label set equals accuracy; binary F1
            # takes class 1 as positive
            "f1_micro": M.accuracy_from_cm(cm),
            "f1_binary": 2 * cm[1, 1] / torch.clamp(2 * cm[1, 1] + cm[0, 1] + cm[1, 0],
                                                    min=1e-12),
        }

    @staticmethod
    def _fetch(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """All scalar metrics to the host in one transfer."""
        names = sorted(metrics)
        vec = torch.stack([metrics[k].reshape(()).float() for k in names]).cpu()
        return dict(zip(names, vec.double().tolist()))

    # ------------------------------------------------------------------
    # batches
    # ------------------------------------------------------------------

    def _augmented_batch(self, data, rows: torch.Tensor, draws, step: int):
        """Rows ``rows`` (int32) of the fold, augmented with step ``step``'s
        draws: (images, masks) as NCHW-contiguous f32 tensors. On the fast
        path at f32 with the canvas equal to the image, a one-channel image
        or mask is a view of the kernel's plane-major output: the kernel is
        the path's only launch."""
        cfg = self.cfg
        if cfg.use_transforms and cfg.fast_augmentation:
            fmt, n_mask = self._aug_fmt
            factors = FA.PipelineFactors(*(f[step] for f in draws["factors"]))
            out = FA.fast_augment(data["aug_packed"], rows, factors)
            stack = FA.unpack_channels_nchw(out, fmt)
            return self._nchw(stack[:, n_mask:]), self._nchw(stack[:, :n_mask])
        imgs = data["images"].index_select(0, rows).float()
        msks = data["masks"].index_select(0, rows).float()
        if cfg.use_transforms:
            n_mask = msks.shape[1]
            fh, fv, angle = (d[step] for d in draws["flips_angles"])
            stack = joint_transform_stack_batch(torch.cat([msks, imgs], dim=1),
                                                fh, fv, angle)
            msks, imgs = stack[:, :n_mask], stack[:, n_mask:]
        return self._nchw(imgs), self._nchw(msks)

    @staticmethod
    def _nchw(x: torch.Tensor) -> torch.Tensor:
        """``x`` with exactly the NCHW-contiguous strides. ``contiguous()``
        is not enough: a one-channel NHWC batch permuted to NCHW counts as
        contiguous while its strides look channels-last, and cuDNN then
        writes channels-last outputs that the norm kernel refuses. A
        one-channel ``x`` whose planes are contiguous is re-strided as a view
        (its bytes are already in NCHW order); anything else is copied."""
        n, c, h, w = x.shape
        if x.stride() == (c * h * w, h * w, w, 1):
            return x
        if c == 1 and x[:, 0].is_contiguous():
            return x[:, 0].unsqueeze(1)
        return x.clone(memory_format=torch.contiguous_format)

    def _epoch_draws(self, steps: int, generator: Optional[torch.Generator]):
        """Every step's augmentation draws for one epoch, drawn at once from
        ``generator`` (on the CPU) and, for the fast path, folded into the
        kernel's gather factors (``PipelineFactors`` with leading dims
        (steps, B), 3·(S+2)+1 integers per sample) on the device."""
        cfg = self.cfg
        if not cfg.use_transforms:
            return None
        if generator is None:
            raise ValueError("Engine: use_transforms needs a torch.Generator for "
                             "the augmentation draws")
        b = cfg.batch_size
        fh, fv, angle = FA.draw_flips_and_angles(
            generator, (steps, b), p_hflip=cfg.p_hflip, p_vflip=cfg.p_vflip,
            max_angle=cfg.max_angle)
        if not cfg.fast_augmentation:
            return {"flips_angles": (fh, fv, angle)}
        fmt, _ = self._aug_fmt
        factors = FA.pipeline_factors_from_draws(
            fh.reshape(-1), fv.reshape(-1), angle.reshape(-1), fmt.canvas, self.device)
        return {"factors": FA.PipelineFactors(
            *(f.reshape(steps, b, *f.shape[1:]) for f in factors))}

    # ------------------------------------------------------------------
    # epochs
    # ------------------------------------------------------------------

    def _check_state(self, state: TrainState) -> None:
        p = next(state.model.parameters())
        if p.device != self.device:
            raise ValueError(f"Engine on {self.device}: the state's model is on {p.device}")

    def _train_epoch_sums(self, state: TrainState, data: Dict[str, Any],
                          perm: np.ndarray, generator: Optional[torch.Generator],
                          step_valid: Optional[np.ndarray]):
        cfg = self.cfg
        self._check_state(state)
        if cfg.use_transforms and cfg.fast_augmentation and "aug_packed" not in data:
            raise ValueError("fast_augmentation needs data built by this Engine's "
                             "device_data(..., for_training=True)")
        b = cfg.batch_size
        perm = np.asarray(perm)
        if perm.size % b:
            raise ValueError(f"perm holds {perm.size} indices, not a multiple of "
                             f"batch_size {b}")
        n = data["images"].shape[0]
        if perm.size and (perm.min() < 0 or perm.max() >= n):
            raise ValueError(f"perm indexes outside the {n} rows of the fold")
        steps = perm.size // b
        valid = (np.ones(steps, np.float32) if step_valid is None
                 else np.asarray(step_valid, np.float32))
        if valid.shape != (steps,):
            raise ValueError(f"step_valid has shape {valid.shape}, want ({steps},)")
        rows_all = torch.as_tensor(perm, dtype=torch.int32).to(self.device).reshape(steps, b)
        draws = self._epoch_draws(steps, generator)

        n_cm = max(cfg.n_classes, 2)
        zero = torch.zeros((), device=self.device)
        sums = {"loss": zero, "seg_loss": zero, "cls_loss": zero, "dice": zero,
                "cm": torch.zeros((n_cm, n_cm), device=self.device)}
        model, opt = state.model, state.optimizer
        model.train()
        for k in range(steps):
            if valid[k] <= 0:
                continue  # cross-fold padding: a no-op, not a zero-gradient step
            rows = rows_all[k]
            ctgt = data["cls_targets"].index_select(0, rows)
            lint = data["labels_int"].index_select(0, rows)
            imgs, msks = self._augmented_batch(data, rows, draws, k)
            opt.zero_grad(set_to_none=True)
            out = model(imgs)
            loss, aux = self._losses(out, msks, ctgt)
            loss.backward()
            opt.step()
            state.step += 1
            sm = self._step_metrics(aux, msks, lint, sums["cm"])
            sums = {
                "loss": sums["loss"] + loss.detach(),
                "seg_loss": sums["seg_loss"] + aux["seg_loss"].detach()
                if "seg_loss" in aux else sums["seg_loss"],
                "cls_loss": sums["cls_loss"] + aux["cls_loss"].detach()
                if "cls_loss" in aux else sums["cls_loss"],
                "dice": sums["dice"] + sm["dice"] if "dice" in sm else sums["dice"],
                "cm": sm.get("cm", sums["cm"]),
            }
        return self._epoch_metrics(sums, max(float(valid.sum()), 1.0))

    @torch.no_grad()
    def _eval_metrics(self, state: TrainState, data: Dict[str, Any]
                      ) -> Dict[str, torch.Tensor]:
        """Validation: the whole split as one batch, as the JAX Engine does."""
        self._check_state(state)
        n_cm = max(self.cfg.n_classes, 2)
        model = state.model
        model.eval()
        images, masks = self._nchw(data["images"].float()), self._nchw(data["masks"].float())
        loss, aux = self._losses(model(images), masks, data["cls_targets"])
        sm = self._step_metrics(aux, masks, data["labels_int"],
                                torch.zeros((n_cm, n_cm), device=self.device))
        zero = torch.zeros((), device=self.device)
        metrics = {"loss": loss, "seg_loss": aux.get("seg_loss", zero),
                   "cls_loss": aux.get("cls_loss", zero), "dice": sm.get("dice", zero)}
        if "cm" in sm:
            cm_metrics = self._epoch_metrics({**metrics, "cm": sm["cm"]}, 1.0)
            metrics.update({k: cm_metrics[k] for k in ("acc", "f1", "f1_micro", "f1_binary")})
        else:
            metrics.update({k: zero for k in ("acc", "f1", "f1_micro", "f1_binary")})
        return metrics

    def train_epoch(self, state: TrainState, data: Dict[str, Any], perm: np.ndarray,
                    generator: Optional[torch.Generator] = None,
                    step_valid: Optional[np.ndarray] = None
                    ) -> Tuple[TrainState, Dict[str, float]]:
        """One epoch over ``perm`` (steps·B fold rows) in batches of B; the
        augmentation draws come from ``generator``. Returns the state (updated
        in place) and the epoch metrics (means over the real steps)."""
        return state, self._fetch(self._train_epoch_sums(state, data, perm, generator,
                                                         step_valid))

    def eval_epoch(self, state: TrainState, data: Dict[str, Any]) -> Dict[str, float]:
        return self._fetch(self._eval_metrics(state, data))

    def train_and_eval_epoch(self, state: TrainState, train_data: Dict[str, Any],
                             val_data: Dict[str, Any], perm: np.ndarray,
                             generator: Optional[torch.Generator] = None,
                             step_valid: Optional[np.ndarray] = None
                             ) -> Tuple[TrainState, Dict[str, float], Dict[str, float]]:
        """A training epoch and the validation pass, with one metric fetch."""
        tm = self._train_epoch_sums(state, train_data, perm, generator, step_valid)
        vm = self._eval_metrics(state, val_data)
        both = {f"t_{k}": v for k, v in tm.items()}
        both.update({f"v_{k}": v for k, v in vm.items()})
        fetched = self._fetch(both)
        return (state, {k[2:]: v for k, v in fetched.items() if k.startswith("t_")},
                {k[2:]: v for k, v in fetched.items() if k.startswith("v_")})

    @torch.no_grad()
    def predict(self, state: TrainState, images, max_batch: int = 1024,
                pad_to: Optional[int] = None):
        """Batched inference on NHWC images (numpy or tensor, as the JAX
        Engine takes them); sets larger than ``max_batch`` run in chunks.
        ``pad_to`` wrap-pads the batch and trims the outputs back. Returns the
        model's output structure, NCHW tensors on the Engine's device."""
        x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images)
        x = self._nchw(x.to(self.device).permute(0, 3, 1, 2).float())
        n = x.shape[0]
        if n == 0:
            raise ValueError("predict: empty batch (images has 0 rows)")
        if pad_to is not None and n < pad_to:
            x = x[torch.arange(pad_to, device=self.device) % n]
        model = state.model
        model.eval()
        outs = [model(x[i:i + max_batch]) for i in range(0, x.shape[0], max_batch)]
        return _tree_map(lambda *parts: torch.cat(parts, dim=0)[:n], *outs)

    # ------------------------------------------------------------------
    # data
    # ------------------------------------------------------------------

    @staticmethod
    def _storage_dtype(a: np.ndarray) -> torch.dtype:
        """uint8 when the data is integral in [0, 255] (PNG intensities,
        binary masks), else float32. The per-step row gather then moves a
        quarter of the bytes; the cast after it is exact."""
        if a.size and (np.issubdtype(a.dtype, np.integer) or np.all(a == np.rint(a))) \
                and 0 <= a.min() and a.max() <= 255:
            return torch.uint8
        return torch.float32

    def device_data(self, ds: ArrayDataset, pad_to: Optional[int] = None,
                    *, for_training: bool = True) -> Dict[str, Any]:
        """One split on the device, once per fold: images and masks NCHW
        (uint8 where integral), targets and labels, and for training with the
        fast augmentation the packed (N, P, S, S) int32 [masks | image] stack.
        ``pad_to`` wrap-pads the rows to a cross-fold maximum; padded rows are
        never gathered by an epoch plan."""
        def _pad(a: np.ndarray) -> np.ndarray:
            n = a.shape[0]
            if pad_to is None or n >= pad_to:
                return a
            if n == 0:
                raise ValueError(f"device_data: empty dataset cannot be wrap-padded "
                                 f"to {pad_to} rows")
            reps = -(-(pad_to - n) // n)
            return np.concatenate([a] + [a] * reps, axis=0)[:pad_to]

        def _nchw_tensor(a: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(np.ascontiguousarray(_pad(a).transpose(0, 3, 1, 2)))
            return self._nchw(t.to(self._storage_dtype(a))).to(self.device)

        data = {
            "images": _nchw_tensor(ds.images),
            "masks": _nchw_tensor(ds.masks),
            "cls_targets": torch.from_numpy(_pad(make_cls_targets(
                ds.labels, self.cfg.n_classes, self.cfg.task))).to(self.device),
            "labels_int": torch.from_numpy(_pad(np.asarray(ds.labels, np.int64))).to(self.device),
        }
        if for_training and self.cfg.use_transforms and self.cfg.fast_augmentation:
            stack = np.concatenate([_pad(ds.masks), _pad(ds.images)], axis=-1)
            planes, fmt = FA.pack_channels(torch.from_numpy(stack.astype(np.float32)),
                                           self.cfg.compute_dtype)
            n_mask = ds.masks.shape[-1]
            if self._aug_fmt is not None and self._aug_fmt != (fmt, n_mask):
                raise ValueError(
                    f"this Engine packs augmentation format {self._aug_fmt}; a new "
                    f"Engine is needed for {(fmt, n_mask)}")
            self._aug_fmt = (fmt, n_mask)
            data["aug_packed"] = planes.to(self.device)
        return data


def _tree_map(fn, *trees):
    """``fn`` over matching leaves of nested tuples/lists of tensors."""
    first = trees[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)
