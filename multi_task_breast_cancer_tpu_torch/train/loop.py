"""The training Engine (twin of ``multi_task_breast_cancer_tpu/train/loop.py``).

The JAX Engine jits a whole epoch as one ``lax.scan``. Here the epoch is a
Python loop over steps that never waits for the device: the fold lives on the
device (``device_data``), each step gathers its rows there, augments them
(the 3-shear kernel, or the exact single gather), runs forward, backward and
the optimizer, and adds its loss, Dice and confusion matrix to sums that stay
on the device. The sums are fetched once per epoch, as one transfer.

On the card (:func:`..graphs.enabled`, the one rule) the step is graphed,
the counterpart of JAX's compiled scan body: the first real step runs
eagerly on a side stream (it creates the optimizer's state, loads the
kernel libraries, lets cuDNN choose its algorithms, fills Swin's constant
cache), and from the next real step on the step body (:meth:`Engine._train_step`)
is captured once as a CUDA graph on static buffers and replayed. Before each
replay the step's rows and augmentation draws are copied into the static
buffers (the same shapes at every step, so one capture serves a fold
whatever its padding); the fold's data, the parameters, buffers and
optimizer state are read where they live. The loss shares and Dice counts a
replay writes are copied out after it, and the confusion matrix is a static
buffer the step adds to in place. Dropout draws from a generator registered
with the graph that takes the epoch generator's state for each replay, so a
graphed run is the eager run bit for bit: the same losses, parameters,
moments, buffers, masks and launch counts. The capture is kept while the
model, the optimizer and its state tensors, the fold's data tensors and the
mesh's shape, rank and shard stay the same; a new fold (new optimizer) or
new data captures anew, freeing the old programs first. An Engine built
with ``cuda_graphs=False`` runs eagerly on the card (to compare);
validation and ``predict`` run eagerly.

Under a data mesh the step's one collective is the flat gradient
all-reduce between the backward and the optimizer's step, so the step is
two halves (:meth:`Engine._step_before_reduce`, :meth:`Engine._step_after_reduce`)
that the eager loop runs around the all-reduce, and a graphed Engine
captures as two programs in one memory pool: it replays the first, runs the
all-reduce eagerly on the current stream, and replays the second. A rank
with an empty shard replays its two programs on zero rows and joins the
same all-reduce. A model whose forward calls a collective (``BatchNorm``'s
global statistics) and a ``(data × space)`` mesh run eagerly, by the rule.

Each epoch is a span (``utils/profiling.py``; kept only inside
``profiling.recording()`` or the operator's ``MTBC_PROFILE`` trace):
``engine.epoch`` holds ``engine.plan`` (the checks, the rows put on the
device, ``engine.draws``, ``engine.graph_key``), ``engine.steps`` with one
``engine.step`` per real step (``graph.replay``; ``engine.warmup_step``,
``graph.capture`` or ``engine.eager_step``), ``engine.sums``,
``engine.validation`` and ``engine.fetch``; ``engine.init`` and
``engine.device_data`` span set-up. The counters ``graph.captures``,
``graph.replays`` and ``engine.eager_steps`` always count.

Cross-fold padding steps (``step_valid == 0``) are skipped on the host, so
they leave the parameters, the buffers (batch statistics), the optimizer's
moments and the step count untouched (the JAX scan selects the old state for
them).

Training steps run the model in train mode: a ``BatchNorm`` normalises with
the batch's statistics and moves its running ``mean``/``var`` buffers in
place, and a ``Dropout`` draws its masks from the epoch's
``dropout_generator`` (on the Engine's device; JAX splits ``k_drop`` from
each step's key). Validation and ``predict`` run in eval mode: the running
statistics normalise and stay as they are, and dropout is the identity.

Tasks: 'segmentation' | 'classification' | 'multitask'. Layout NCHW.

``compute_dtype='bfloat16'`` is JAX's whole-model cast (``_apply``,
``_as_f32``): the master parameters stay float32 in ``torch.optim.Adam``, each
forward runs on bf16 copies of them (``torch.func.functional_call``), so the
gradients land on the f32 masters; the buffers are not cast (batch
statistics stay f32, as JAX's do) and their updates land on the module's own
buffers; inputs are cast to bf16 right after the row
gather (before the exact augmentation; the fast augmentation packs bf16
channel pairs); outputs are cast to f32 before the losses, the metrics and
``predict``'s result. Losses and metrics only ever see f32. No
``torch.autocast``: its per-op allow-list is not JAX's whole-model cast.

``mesh`` (a :class:`~..parallel.mesh.DataMesh`, one rank per device) is
the JAX Engine's data mesh. The fold stays whole on every rank; each step
takes this rank's contiguous rows of the global batch (``mesh.shard(B)``),
with the global batch's augmentation draws, dropout masks and batch
statistics (``blocks.global_batch``). Each rank's loss is its share of the
global batch's loss (a batch mean scaled by its rows over ``B``; the
Jaccard criterion, a batch sum, by 1), so one flat all-reduce of the
gradients per step gives the global batch's gradient for any split, uneven
and empty shards included; every rank then takes the same Adam step.
Per-step loss shares, Dice counts and the confusion matrix are all-reduced
once per epoch; validation and ``predict`` shard their rows the same way
(``predict`` all-gathers its outputs in order). Padding steps stay no-ops
on every rank.

A ``(data × space)`` mesh (a :class:`~..parallel.mesh.DataMesh` with a ``space`` group,
``training.spatial_partitions``) also splits the image rows: each step takes
its data shard of the batch (augmented on whole planes, as JAX augments on
the ``data`` axis), then this rank's rows of every image-shaped tensor;
vectors (labels, class targets) are sharded by ``data`` only. The forward
runs under :func:`~..parallel.spatial.partitioned` (halo exchanges, split
norm statistics, the Dice and pooling sums over the ``space`` group, every
layer's row rule: ``models/blocks.py``). The DICE criterion sums its plane
sums over the group; every other segmentation criterion runs on whole
planes: each seg head's rows are gathered (differentiably) with its mask's,
and the criterion is applied alike on every rank of the group. Every term
that the ranks of a ``space`` group compute alike (the Dice from summed
plane sums, a criterion on gathered planes, the classification loss on
replicated logits) is weighed by 1/n_space on top of the batch share, so
the one flat gradient all-reduce, now over every rank, gives the global
batch's gradient. The epoch's loss shares are summed over every rank, the
Dice counts (already summed over ``space``) and the confusion matrix over
``data``. Every architecture has row rules and every criterion runs; an
image height must be a multiple of n_space · 2^halvings
(``space_row_multiple``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from multi_task_breast_cancer_tpu_torch import graphs
from multi_task_breast_cancer_tpu_torch.data.augment import (
    joint_transform_stack_batch,
    rotation_cos_sin,
)
from multi_task_breast_cancer_tpu_torch.data.dataset import ArrayDataset
from multi_task_breast_cancer_tpu_torch.device import (
    COMPUTE_DTYPES,
    resolve_device,
    set_float32_policy,
)
from multi_task_breast_cancer_tpu_torch.models.blocks import (
    dropout_draws,
    global_batch,
    has_dropout,
)
from multi_task_breast_cancer_tpu_torch.ops import fast_augment as FA
from multi_task_breast_cancer_tpu_torch.ops import losses as L
from multi_task_breast_cancer_tpu_torch.ops import metrics as M
from multi_task_breast_cancer_tpu_torch.ops.fused_loss import fused_dice_criterion
from multi_task_breast_cancer_tpu_torch.parallel import spatial
from multi_task_breast_cancer_tpu_torch.parallel.mesh import DataMesh
from multi_task_breast_cancer_tpu_torch.train.state import TrainState
from multi_task_breast_cancer_tpu_torch.utils import profiling
from multi_task_breast_cancer_tpu_torch.utils.trees import multitask_pair, tree_map

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


def _on_whole_planes(criterion):
    """``criterion`` on whole planes: under a ``space`` group the logits'
    rows are gathered (their gradient goes back to each rank's rows) and the
    target's too, so every rank of the group computes the whole images'
    loss, as one process does; without one, ``criterion`` itself."""
    def on_whole_planes(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        space = spatial.current()
        if space is not None:
            logits, target = spatial.gather_rows(logits, space), spatial.gather_rows(target, space)
        return criterion(logits, target)

    return on_whole_planes


class Engine:
    """Epoch training, validation and prediction for one model + task
    configuration on one device (``cuda`` unless ``device='cpu'``), or on
    this rank's device of a data or ``(data × space)`` ``mesh``.
    :attr:`graphed` says whether its training steps replay a CUDA graph
    (:func:`..graphs.enabled`; ``cuda_graphs=False`` runs the card eagerly,
    to hold the two against each other)."""

    @profiling.spanned("engine.init")
    def __init__(self, model: nn.Module, cfg: EngineConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh: Optional[DataMesh] = None, cuda_graphs: bool = True):
        if mesh is not None and not isinstance(mesh, DataMesh):
            raise NotImplementedError(
                f"Engine: {type(mesh).__name__} is not a data mesh or a (data × space) "
                "mesh (parallel.data_space_mesh)")
        if cfg.task not in ("segmentation", "classification", "multitask"):
            raise ValueError(f"Engine: unknown task {cfg.task!r}")
        n_data = mesh.data.world_size if mesh is not None else 1
        if mesh is not None and cfg.use_transforms and cfg.fast_augmentation \
                and cfg.batch_size % n_data:
            raise ValueError(
                "fast_augmentation on a data-parallel mesh runs the kernel on each "
                f"rank's rows; batch_size ({cfg.batch_size}) must divide evenly over "
                f"the {n_data} ranks")
        self._space = mesh.space if mesh is not None else None
        if self._space is not None:
            self._row_multiple = spatial.row_multiple(model)
        self.device = resolve_device(device if device is not None or mesh is None
                                     else mesh.device)
        if mesh is not None and torch.device(mesh.device) != self.device:
            raise ValueError(f"Engine on {self.device}: the mesh's device is {mesh.device}")
        self.mesh = mesh
        set_float32_policy(self.device, cfg.compute_dtype)
        self.model = model.to(self.device)
        self.cfg = cfg
        self._dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        self._aug_fmt = None  # (AugFormat, n_mask) of the packed fold, set by device_data
        self._seg_crit = (fused_dice_criterion if cfg.seg_criterion == "DICE"
                          else _on_whole_planes(L.init_criterion_segmentation(
                              cfg.seg_criterion)))
        self._cls_crit = L.init_criterion_classification(
            cfg.n_classes, cfg.classes_weighted, cfg.cls_criterion, device=self.device)
        self.graphed = cuda_graphs and graphs.enabled(self.device, mesh, model)
        self._step_graph: Optional[_StepGraph] = None
        self._warm_key = None  # the step graph's key after its eager warm-up step
        self._side_stream = None  # the warm-up's and the capture's stream

    # ------------------------------------------------------------------
    # forward + loss
    # ------------------------------------------------------------------

    def _apply(self, model: nn.Module, x: torch.Tensor):
        """The model's forward on ``x`` (already in the compute dtype), its
        outputs in f32. bf16: the forward runs on bf16 copies of the f32
        parameters, through which the gradients reach the f32 masters."""
        if self._dtype == torch.float32:
            return model(x)
        params = {name: p.to(self._dtype) for name, p in model.named_parameters()}
        return tree_map(lambda a: a.float(), torch.func.functional_call(model, params, (x,)))

    def _losses(self, out, masks, cls_targets) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Losses of f32 outputs against f32 masks (a bf16 batch's masks,
        0/1, are cast exactly)."""
        cfg = self.cfg
        masks = masks.float()
        if cfg.task == "segmentation":
            loss = L.apply_criterion_binary_segmentation(
                self._seg_crit, masks, out, cfg.inversely_weighted)
            return loss, {"seg_out": out}
        if cfg.task == "classification":
            self._check_cls_head(out)
            return L.apply_criterion_classification(self._cls_crit, cls_targets, out), \
                {"cls_out": out}
        cls, seg = multitask_pair(out)
        self._check_cls_head(cls)
        seg_loss, cls_loss = L.apply_criterion_multitask(
            self._seg_crit, masks, seg, self._cls_crit, cls_targets, cls,
            cfg.inversely_weighted)
        loss = cfg.alpha * seg_loss + (1 - cfg.alpha) * cls_loss
        return loss, {"seg_out": seg, "cls_out": cls, "seg_loss": seg_loss,
                      "cls_loss": cls_loss}

    def _heads(self, out) -> Dict[str, Any]:
        """The outputs the losses read, by name."""
        if self.cfg.task == "segmentation":
            return {"seg_out": out}
        if self.cfg.task == "classification":
            return {"cls_out": out}
        cls, seg = multitask_pair(out)
        return {"seg_out": seg, "cls_out": cls}

    def _loss_shares(self, out, masks, cls_targets, n_local: int, n_global: int
                     ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """This rank's share of the global batch's loss, from its
        ``n_local`` rows: ``_losses`` scaled so that the shares of all ranks
        add up to the global batch's loss (batch means by ``n_local /
        n_global``; the Jaccard criterion, a batch sum, by 1; both by
        1/n_space more under a ``space`` group, whose ranks all compute the
        whole images' loss). ``aux``'s ``seg_loss``/``cls_loss`` are shares
        too. All the rows of one process: ``_losses`` itself. With no rows
        the share is zero, still joined to every output the loss reads, so
        that the backward runs (and joins the collectives of) the whole
        model."""
        n_space = self._space.size if self._space is not None else 1
        if n_local == n_global and n_space == 1:
            return self._losses(out, masks, cls_targets)
        if n_local == 0:
            heads = self._heads(out)
            leaves = []
            tree_map(leaves.append, heads)
            zero = sum(a.sum() for a in leaves) * 0.0
            return zero, {**heads, "seg_loss": zero.detach(), "cls_loss": zero.detach()}
        loss, aux = self._losses(out, masks, cls_targets)
        mean = n_local / n_global / n_space
        f_seg = 1.0 / n_space if self.cfg.seg_criterion == "Jaccard" else mean
        if self.cfg.task == "segmentation":
            return f_seg * loss, aux
        if self.cfg.task == "classification":
            return mean * loss, aux
        seg, cls = f_seg * aux["seg_loss"], mean * aux["cls_loss"]
        return (self.cfg.alpha * seg + (1 - self.cfg.alpha) * cls,
                {**aux, "seg_loss": seg, "cls_loss": cls})

    def _check_cls_head(self, cls_out) -> None:
        """A head whose logit count disagrees with ``n_classes`` would train
        silently wrong through broadcasting: fail instead. Multi_FSB_BTSUNet
        hard-codes one logit (with 3 classes its cross-entropy would be
        identically zero), Adityan three."""
        head = cls_out[0] if isinstance(cls_out, (tuple, list)) else cls_out
        expected = self.cfg.n_classes if self.cfg.n_classes > 2 else 1
        if head.shape[-1] != expected:
            raise ValueError(
                f"classification head emits {head.shape[-1]} logits but "
                f"n_classes={self.cfg.n_classes} needs {expected} (binary "
                "collapses to 1 logit — reference parity). Architectures "
                "with hard-coded heads (Multi_FSB_BTSUNet: 1, Adityan: 3) "
                "only support the matching class count.")

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
        """The batch's Dice counts (tp, fp, fn; ``M.dice_counts``) and the
        confusion matrix ``cm`` with the batch added, as the task has them."""
        out: Dict[str, torch.Tensor] = {}
        if "seg_out" in aux:
            out["dice_counts"] = M.dice_counts(
                masks.float(), self._final_seg_head(aux["seg_out"]).detach())
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
        with profiling.span("engine.fetch"):
            names = sorted(metrics)
            vec = torch.stack([metrics[k].reshape(()).float() for k in names]).cpu()
            return dict(zip(names, vec.double().tolist()))

    # ------------------------------------------------------------------
    # batches
    # ------------------------------------------------------------------

    def _augmented_batch(self, data, rows: torch.Tensor, draws, step: int,
                         shard: slice = slice(None)):
        """Rows ``rows`` (int32) of the fold, augmented with step ``step``'s
        draws (their ``shard`` of the global batch, this rank's): (images,
        masks) as NCHW-contiguous tensors in the compute dtype. On the fast
        path with the canvas equal to the image, a one-channel image or mask
        is a view of the kernel's plane-major output (f32) or of the one copy
        that unpacks its bf16 channel pairs."""
        cfg = self.cfg
        if cfg.use_transforms and cfg.fast_augmentation:
            fmt, n_mask = self._aug_fmt
            factors = FA.PipelineFactors(*(f[step][shard] for f in draws["factors"]))
            out = FA.fast_augment(data["aug_packed"], rows, factors)
            stack = FA.unpack_channels_nchw(out, fmt)
            return self._nchw(stack[:, n_mask:]), self._nchw(stack[:, :n_mask])
        # the cast right after the row gather, before the augmentation, as
        # the JAX Engine casts (exact for uint8 data)
        imgs = data["images"].index_select(0, rows).to(self._dtype)
        msks = data["masks"].index_select(0, rows).to(self._dtype)
        if cfg.use_transforms:
            n_mask = msks.shape[1]
            fh, fv, angle = (d[step][shard] for d in draws["flips_angles"])
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

    def _check_rows(self, height: int) -> None:
        """Under a ``space`` group every level's rows must split evenly:
        ``H % (n_space · 2^pools) == 0`` (JAX pads uneven shards instead)."""
        if self._space is None:
            return
        need = self._space.size * self._row_multiple
        if height % need:
            raise ValueError(
                f"spatial partitioning needs the image height to be a multiple of "
                f"n_space · 2^pools = {self._space.size} · {self._row_multiple} = {need} "
                f"(H % (n_space · 2^pools) == 0), got H={height}")

    def _space_rows(self, *tensors: torch.Tensor):
        """This rank's rows of each NCHW tensor under a ``space`` group
        (NCHW-contiguous copies); the tensors as they are without one."""
        if self._space is None:
            return tensors
        return tuple(self._nchw(t[:, :, self._space.rows(t.shape[2])]) for t in tensors)

    def _epoch_draws(self, steps: int, generator: Optional[torch.Generator]):
        """Every step's augmentation draws for one epoch, drawn at once from
        ``generator`` (on the CPU) and put on the device: for the exact path
        the flips and each angle's (cos, sin) (``flips_angles``, leading dims
        (steps, B)); for the fast path folded into the kernel's gather
        factors (``PipelineFactors`` with leading dims (steps, B),
        3·(S+2)+1 integers per sample)."""
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
            # the angles' cosines and sines taken here on the host (the CPU's
            # bits on every device), all of it moved to the device at once
            return {"flips_angles": tuple(t.to(self.device) for t in
                                          (fh, fv, rotation_cos_sin(angle)))}
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

    def _check_dropout_generator(self, model: nn.Module,
                                 generator: Optional[torch.Generator]) -> None:
        if not has_dropout(model):
            return
        if generator is None:
            raise ValueError("Engine: a model with dropout needs a dropout_generator "
                             "(a torch.Generator on the Engine's device) for its masks")
        if generator.device.type != self.device.type:
            raise ValueError(f"Engine on {self.device}: the dropout generator is on "
                             f"{generator.device}")

    def _train_epoch_sums(self, state: TrainState, data: Dict[str, Any],
                          perm: np.ndarray, generator: Optional[torch.Generator],
                          step_valid: Optional[np.ndarray],
                          dropout_generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        with profiling.span("engine.plan"):
            self._check_state(state)
            self._check_dropout_generator(state.model, dropout_generator)
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
            with profiling.span("engine.draws"):
                draws = self._epoch_draws(steps, generator)

            n_cm = max(cfg.n_classes, 2)
            with profiling.span("engine.graph_key"):
                graph = self._kept_step_graph(state, data) if self.graphed else None
            cm = (graph.cm.zero_() if graph is not None
                  else torch.zeros((n_cm, n_cm), device=self.device))
        mesh = self.mesh
        shard = mesh.shard(b) if mesh is not None else slice(0, b)
        n_local = shard.stop - shard.start
        shares, counts = [], []  # per real step: (loss, seg, cls) shares, Dice counts
        model, opt = state.model, state.optimizer
        model.train()
        with profiling.span("engine.steps"), dropout_draws(model, dropout_generator), \
                global_batch(model, mesh, b), spatial.partitioned(self._space):
            for k in range(steps):
                if valid[k] <= 0:
                    continue  # cross-fold padding: a no-op, not a zero-gradient step
                with profiling.span("engine.step"):
                    rows = rows_all[k, shard]
                    if self.graphed:
                        share, count = self._graphed_step(state, data, rows, draws, k, shard,
                                                          n_local, cm, dropout_generator)
                    else:
                        with profiling.span("engine.eager_step"):
                            opt.zero_grad(set_to_none=True)
                            share, count = self._train_step(model, opt, data, rows, draws, k,
                                                            shard, cm, n_local)
                        profiling.count("engine.eager_steps")
                    state.step += 1
                    shares.append(share)
                    if count is not None:
                        counts.append(count)
        with profiling.span("engine.sums"):
            zero = torch.zeros((), device=self.device)
            sums = {"loss": zero, "seg_loss": zero, "cls_loss": zero, "dice": zero, "cm": cm}
            return self._epoch_metrics(self._epoch_sums(sums, shares, counts),
                                       max(float(valid.sum()), 1.0))

    def _train_step(self, model: nn.Module, opt: torch.optim.Optimizer,
                    data: Dict[str, Any], rows: torch.Tensor, draws, k: int, shard: slice,
                    cm: torch.Tensor, n_local: int):
        """One training step on this rank's ``rows`` of the fold with step
        ``k``'s ``shard`` of ``draws``, its gradients cleared before:
        :meth:`_step_before_reduce`, under a mesh the one flat all-reduce of
        the gradients, :meth:`_step_after_reduce`. Returns the (loss, seg,
        cls) shares, (3,), and the Dice counts (``None`` without a
        segmentation head). The eager loop runs it; a graphed Engine captures
        it whole without a mesh, and its two halves around the all-reduce
        under one."""
        carry = self._step_before_reduce(model, data, rows, draws, k, shard, n_local)
        if self.mesh is not None:
            self.mesh.all_reduce_sum(carry["flat"])
        return self._step_after_reduce(model, opt, carry, cm)

    def _step_before_reduce(self, model: nn.Module, data: Dict[str, Any], rows: torch.Tensor,
                            draws, k: int, shard: slice, n_local: int) -> Dict[str, Any]:
        """The step up to its gradient all-reduce: the rows gathered and
        augmented, the forward, this rank's loss share and its backward.
        Returns what the rest of the step reads: the (loss, seg, cls) shares,
        the outputs and targets of the step's metrics (detached) and, under a
        mesh, ``flat``: every parameter's gradient in one buffer (zeros stand
        in for a gradient this rank has not got, so every rank sends the same
        sizes)."""
        ctgt = data["cls_targets"].index_select(0, rows)
        lint = data["labels_int"].index_select(0, rows)
        imgs, msks = self._space_rows(*self._augmented_batch(data, rows, draws, k, shard))
        out = self._apply(model, imgs)
        loss, aux = self._loss_shares(out, msks, ctgt, n_local, self.cfg.batch_size)
        loss.backward()
        zero = torch.zeros((), device=self.device)
        carry = {"share": torch.stack([loss.detach(), aux.get("seg_loss", zero).detach(),
                                       aux.get("cls_loss", zero).detach()]),
                 "masks": msks, "labels": lint, "heads": {}}
        if "seg_out" in aux:
            carry["heads"]["seg_out"] = self._final_seg_head(aux["seg_out"]).detach()
        if "cls_out" in aux:
            carry["heads"]["cls_out"] = self._mean_cls_head(aux["cls_out"]).detach()
        if self.mesh is not None:
            carry["flat"] = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                                       .reshape(-1) for p in self._trained(model)])
        return carry

    def _step_after_reduce(self, model: nn.Module, opt: torch.optim.Optimizer,
                           carry: Dict[str, Any], cm: torch.Tensor):
        """The step after its gradient all-reduce: under a mesh the summed
        ``flat`` copied back into the ``.grad`` tensors (a parameter without
        a gradient keeps none), the optimizer's step, the batch's Dice counts
        and the batch added to the confusion matrix ``cm`` in place. Returns
        the shares and the Dice counts, as :meth:`_train_step`."""
        if "flat" in carry:
            params = self._trained(model)
            for p, g in zip(params, carry["flat"].split([p.numel() for p in params])):
                if p.grad is not None:
                    p.grad.copy_(g.view_as(p))
        opt.step()
        sm = self._step_metrics(carry["heads"], carry["masks"], carry["labels"], cm)
        if "cm" in sm:
            cm.copy_(sm["cm"])
        return carry["share"], sm.get("dice_counts")

    @staticmethod
    def _trained(model: nn.Module) -> list:
        """The parameters the optimizer moves, in the flat buffer's order."""
        return [p for p in model.parameters() if p.requires_grad]

    # ------------------------------------------------------------------
    # the captured step (graphs.enabled: the card, no mesh or a data mesh)
    # ------------------------------------------------------------------

    @staticmethod
    def _step_draw_tensors(draws, k: int) -> list:
        """Step ``k``'s draws, each (1, B, ...): the static buffers' sources."""
        if draws is None:
            return []
        (parts,) = draws.values()
        return [t[k:k + 1] for t in parts]

    @staticmethod
    def _draws_of(draws, tensors: list):
        """``draws``' structure over ``tensors`` (one step's static buffers)."""
        if draws is None:
            return None
        ((name, parts),) = draws.items()
        return {name: parts._make(tensors) if hasattr(parts, "_make") else tuple(tensors)}

    def _graph_key(self, state: TrainState, data: Dict[str, Any]):
        """What a captured step reads where it lives: the model's parameters
        and buffers, the optimizer, its state tensors and rates, and the
        fold's data tensors, by identity and address; the Engine's
        configuration; and the mesh's shape, this rank and its shard of the
        batch. Returns (key, the tensors, which the key's holder keeps alive
        so that no identity is reused)."""
        model, opt = state.model, state.optimizer
        held = [*model.parameters(), *model.buffers()]
        for group in opt.param_groups:
            held += [group["lr"]] if torch.is_tensor(group["lr"]) else []
            for p in group["params"]:
                held += [v for _, v in sorted(opt.state.get(p, {}).items()) if torch.is_tensor(v)]
        held += [v for _, v in sorted(data.items()) if torch.is_tensor(v)]
        mesh = self.mesh
        where = (None if mesh is None else
                 (mesh.shape, mesh.rank, mesh.shard(self.cfg.batch_size)))
        key = (id(opt), dataclasses.astuple(self.cfg), where,
               tuple((id(t), t.data_ptr()) for t in held))
        return key, [opt, *held]

    def _kept_step_graph(self, state: TrainState, data: Dict[str, Any]):
        """The captured step, if it still reads this state and data; else
        the old one is released (its memory pool with it) and ``None``."""
        graph = self._step_graph
        if graph is not None and graph.key != self._graph_key(state, data)[0]:
            for program in graph.programs:
                program.close()
            self._step_graph = graph = self._warm_key = None
        return graph

    def _capture_stream(self) -> torch.cuda.Stream:
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        return self._side_stream

    def _graphed_step(self, state: TrainState, data: Dict[str, Any], rows: torch.Tensor,
                      draws, k: int, shard: slice, n_local: int, cm: torch.Tensor,
                      dropout_generator: Optional[torch.Generator]):
        """One real step on the card: the replay of the captured step, its
        outputs copied out; under a mesh the replay of the part before the
        gradient all-reduce, the all-reduce run eagerly on the current
        stream (the process group orders it after the first replay and the
        second after it), the replay of the part after. With no capture yet,
        the step runs eagerly on the capture's side stream (the warm-up: a
        real step, never an extra one, all-reduce included) and the next
        real step with the same key captures and replays."""
        model, opt = state.model, state.optimizer
        if self._step_graph is None:
            key, held = self._graph_key(state, data)
            if self._warm_key is None or key != self._warm_key[0]:
                with profiling.span("engine.warmup_step"):
                    side, main = self._capture_stream(), torch.cuda.current_stream(self.device)
                    side.wait_stream(main)
                    with torch.cuda.stream(side):
                        opt.zero_grad(set_to_none=True)
                        out = self._train_step(model, opt, data, rows, draws, k, shard, cm,
                                               n_local)
                    main.wait_stream(side)
                    self._warm_key = self._graph_key(state, data)
                profiling.count("engine.eager_steps")
                return out
            with profiling.span("graph.capture"):
                self._step_graph = self._capture_step(state, data, rows, draws, k, shard,
                                                      n_local, cm, key, held)
            profiling.count("graph.captures", len(self._step_graph.programs))
            self._warm_key = None
        first, *after = self._step_graph.programs
        with profiling.span("graph.replay"):
            out = first.replay(rows, *self._step_draw_tensors(draws, k),
                               generator=dropout_generator if first.generator is not None
                               else None)
        profiling.count("graph.replays")
        if after:
            self.mesh.all_reduce_sum(out["flat"])
            with profiling.span("graph.replay"):
                out = after[0].replay()
            profiling.count("graph.replays")
        share, count = out
        return share.clone(), (count.clone() if count is not None else None)

    def _capture_step(self, state: TrainState, data: Dict[str, Any], rows: torch.Tensor,
                      draws, k: int, shard: slice, n_local: int, cm: torch.Tensor,
                      key, held) -> "_StepGraph":
        """Capture the step on static copies of step ``k``'s rows and draws,
        the confusion matrix ``cm`` and, for a model with dropout, a
        generator of its own (:class:`..graphs.Program`): without a mesh
        :meth:`_train_step` as one program; under a mesh
        :meth:`_step_before_reduce` and then :meth:`_step_after_reduce`, which
        reads the first's outputs, as two programs in one memory pool, always
        replayed in that order."""
        model, opt = state.model, state.optimizer
        drop = torch.Generator(device=self.device) if has_dropout(model) else None
        side = self._capture_stream()

        def whole(rows, *draw_tensors):
            with dropout_draws(model, drop):
                return self._train_step(model, opt, data, rows, self._draws_of(draws, draw_tensors),
                                        0, shard, cm, n_local)

        def before(rows, *draw_tensors):
            with dropout_draws(model, drop):
                return self._step_before_reduce(model, data, rows,
                                                self._draws_of(draws, draw_tensors), 0, shard,
                                                n_local)

        opt.zero_grad(set_to_none=True)  # the backward in the capture makes the .grad tensors
        inputs = [rows.clone(), *(t.clone() for t in self._step_draw_tensors(draws, k))]
        if self.mesh is None:
            programs = (graphs.Program(whole, inputs, self.device, stream=side, generator=drop),)
        else:
            pool = graphs.new_pool()
            first = graphs.Program(before, inputs, self.device, stream=side, pool=pool,
                                   generator=drop)
            programs = (first, graphs.Program(
                lambda: self._step_after_reduce(model, opt, first.outputs, cm), [],
                self.device, stream=side, pool=pool))
        return _StepGraph(programs, key, held, cm)

    def _reduced(self, t: torch.Tensor, over_space: bool = True) -> torch.Tensor:
        """``t`` summed over every rank of the mesh, or (``over_space``
        False: a value every rank of a ``space`` group holds alike) over its
        ``data`` axis; ``t`` itself without a mesh."""
        if self.mesh is None:
            return t
        return (self.mesh if over_space else self.mesh.data).all_reduce_sum(t)

    def _epoch_sums(self, sums, shares: list, counts: list) -> Dict[str, torch.Tensor]:
        """The epoch sums from the per-step loss shares, Dice counts and the
        confusion matrix: under a mesh each all-reduced once (the shares over
        every rank, the counts and the matrix over ``data``); the steps then
        added one by one, in the order of the steps."""
        if shares:
            for loss, seg, cls in self._reduced(torch.stack(shares)):
                sums["loss"], sums["seg_loss"], sums["cls_loss"] = (
                    sums["loss"] + loss, sums["seg_loss"] + seg, sums["cls_loss"] + cls)
        if counts:
            for dice in M.dice_from_counts(self._reduced(torch.stack(counts), False)):
                sums["dice"] = sums["dice"] + dice
        sums["cm"] = self._reduced(sums["cm"], False)
        return sums

    @torch.no_grad()
    def _eval_metrics(self, state: TrainState, data: Dict[str, Any]
                      ) -> Dict[str, torch.Tensor]:
        """Validation: the whole split as one batch, as the JAX Engine does
        (under a mesh each rank takes its shard of the rows, and the loss
        shares, Dice counts and confusion matrix are all-reduced)."""
        self._check_state(state)
        n_cm = max(self.cfg.n_classes, 2)
        model = state.model
        model.eval()
        n = data["images"].shape[0]
        shard = self.mesh.shard(n) if self.mesh is not None else slice(0, n)
        n_local = shard.stop - shard.start
        images, masks = self._space_rows(self._nchw(data["images"][shard].to(self._dtype)),
                                         self._nchw(data["masks"][shard].float()))
        targets = data["cls_targets"][shard]
        with spatial.partitioned(self._space):
            loss, aux = self._loss_shares(self._apply(model, images), masks, targets,
                                          n_local, n)
            sm = self._step_metrics(aux, masks, data["labels_int"][shard],
                                    torch.zeros((n_cm, n_cm), device=self.device))
        zero = torch.zeros((), device=self.device)
        shares = self._reduced(torch.stack([loss, aux.get("seg_loss", zero),
                                            aux.get("cls_loss", zero)]))
        for k in ("dice_counts", "cm"):
            if k in sm:
                sm[k] = self._reduced(sm[k], False)
        metrics = dict(zip(("loss", "seg_loss", "cls_loss"), shares))
        metrics["dice"] = M.dice_from_counts(sm["dice_counts"]) if "dice_counts" in sm else zero
        if "cm" in sm:
            cm_metrics = self._epoch_metrics({**metrics, "cm": sm["cm"]}, 1.0)
            metrics.update({k: cm_metrics[k] for k in ("acc", "f1", "f1_micro", "f1_binary")})
        else:
            metrics.update({k: zero for k in ("acc", "f1", "f1_micro", "f1_binary")})
        return metrics

    def train_epoch(self, state: TrainState, data: Dict[str, Any], perm: np.ndarray,
                    generator: Optional[torch.Generator] = None,
                    step_valid: Optional[np.ndarray] = None,
                    dropout_generator: Optional[torch.Generator] = None
                    ) -> Tuple[TrainState, Dict[str, float]]:
        """One epoch over ``perm`` (steps·B fold rows) in batches of B; the
        augmentation draws come from ``generator`` (on the CPU), the dropout
        masks from ``dropout_generator`` (on the Engine's device; needed by a
        model with dropout). Returns the state (updated in place) and the
        epoch metrics (means over the real steps)."""
        with profiling.span("engine.epoch"):
            return state, self._fetch(self._train_epoch_sums(state, data, perm, generator,
                                                             step_valid, dropout_generator))

    def eval_epoch(self, state: TrainState, data: Dict[str, Any]) -> Dict[str, float]:
        with profiling.span("engine.epoch"):
            with profiling.span("engine.validation"):
                metrics = self._eval_metrics(state, data)
            return self._fetch(metrics)

    def train_and_eval_epoch(self, state: TrainState, train_data: Dict[str, Any],
                             val_data: Dict[str, Any], perm: np.ndarray,
                             generator: Optional[torch.Generator] = None,
                             step_valid: Optional[np.ndarray] = None,
                             dropout_generator: Optional[torch.Generator] = None
                             ) -> Tuple[TrainState, Dict[str, float], Dict[str, float]]:
        """A training epoch and the validation pass, with one metric fetch."""
        with profiling.span("engine.epoch"):
            tm = self._train_epoch_sums(state, train_data, perm, generator, step_valid,
                                        dropout_generator)
            with profiling.span("engine.validation"):
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
        model's output structure, NCHW f32 tensors on the Engine's device.
        Under a mesh each rank runs its shard of the (padded) rows and the
        outputs are all-gathered in order, so every rank returns them all;
        under a ``space`` group each rank runs its image rows and the
        image-shaped outputs' rows are gathered first."""
        x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images)
        x = self._nchw(x.to(self.device).permute(0, 3, 1, 2).to(self._dtype))
        n = x.shape[0]
        if n == 0:
            raise ValueError("predict: empty batch (images has 0 rows)")
        self._check_rows(x.shape[2])
        if pad_to is not None and n < pad_to:
            x = x[torch.arange(pad_to, device=self.device) % n]
        model = state.model
        model.eval()
        total = x.shape[0]
        if self.mesh is not None:
            x = x[self.mesh.shard(total)]
        (x,) = self._space_rows(x)
        with spatial.partitioned(self._space):
            outs = [self._apply(model, x[i:i + max_batch])
                    for i in range(0, max(x.shape[0], 1), max_batch)]
        out = tree_map(lambda *parts: torch.cat(parts, dim=0), *outs)
        if self._space is not None:
            out = tree_map(lambda a: spatial.gather_rows(a, self._space) if a.dim() == 4
                           else a, out)
        if self.mesh is not None:
            out = tree_map(lambda a: self.mesh.data.all_gather_rows(a, total), out)
        return tree_map(lambda a: a[:n], out)

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

    @profiling.spanned("engine.device_data")
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

        self._check_rows(ds.images.shape[1])
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


@dataclasses.dataclass
class _StepGraph:
    """The Engine's captured step: its programs (the whole step without a
    mesh; under a mesh the parts before and after the gradient all-reduce),
    the key it was captured under (with the tensors the key names, kept
    alive) and its static confusion matrix, zeroed at each epoch's start."""
    programs: Tuple[graphs.Program, ...]
    key: tuple
    held: list
    cm: torch.Tensor
