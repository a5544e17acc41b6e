"""Training traffic: whole ``Engine.train_and_eval_epoch`` calls of the port
on one fold, as the repository's cross-validation driver runs them.

Set-up makes the fold and the weights from the seed, builds the Engine and
its optimizer state, and drives that same state through the cell's first
``checked_steps`` steps, each one a one-step epoch through the window's own
call and feed (rows of distinct scans, the epoch's augmentation generator,
validation after it). The first step runs eagerly and the second captures
the step as a CUDA graph, so the window replays it from its first step on.
The window then runs whole epochs, each a fresh permutation of the fold,
until ``--seconds`` have passed; ``train_images_per_s`` is every training
row the window processed over the window's whole time, validation and the
per-epoch metric fetch included.

Once the window has closed and the peak memory is read, the plain
reference (``benchmark/reference``) follows the checked steps from the same
weights, rows and draws: the first step's loss, the first gradient as Adam got
it (its first moment after one step over 1 − β1), the parameters' change
over the checked steps (as the window's first step kept them) and the
validation loss after them are compared.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np

B1 = 0.9  # Adam's β1: the first moment after one step is (1 − β1)·g
SMALL_LEAF = 1e-3  # leaves whose reference gradient is under this share of the median's


def _port_model(torch, cfg: dict):
    from multi_task_breast_cancer_tpu_torch.models import registry
    build = {"multitask": registry.init_multitask_model,
             "segmentation": registry.init_segmentation_model}[cfg["task"]]
    return build(cfg["architecture"], **cfg["port_kwargs"])


def _dataset(images, masks, labels):
    from multi_task_breast_cancer_tpu_torch.data.dataset import ArrayDataset
    n = len(labels)
    names = np.asarray(["benign", "malignant", "normal"])[labels]
    return ArrayDataset(images=images[..., None].astype(np.float32),
                        masks=masks[..., None].astype(np.float32),
                        labels=labels.astype(np.int32), patient_ids=np.arange(n),
                        class_names=list(names), tumor_pixels=masks.reshape(n, -1).sum(1))


def _engine(torch, cfg: dict, model, batch: int, device):
    from multi_task_breast_cancer_tpu_torch.train.loop import Engine, EngineConfig
    return Engine(model, EngineConfig(
        task=cfg["task"], n_classes=len(cfg["classes"]), batch_size=batch,
        alpha=cfg["alpha"], inversely_weighted=cfg["inversely_weighted"],
        seg_criterion=cfg["loss"], cls_criterion=cfg["classification_criterion"],
        use_transforms=True, p_hflip=cfg["hflip"], p_vflip=cfg["vflip"],
        max_angle=cfg["max_angle"], compute_dtype=cfg["compute_dtype"],
        fast_augmentation=cfg["fast_augmentation"]), device=device)


def _sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Fold:
    """The cell's inputs from the seed: the fold, the checked steps' rows
    and augmentation seeds, the window's plan generator."""

    def __init__(self, seed: int, params: dict, cfg: dict):
        self.seed = seed
        (self.ti, self.tm, self.tl), (self.vi, self.vm, self.vl), base = \
            _data().training_fold(seed, params["fold"], cfg["size"])
        self.batch = int(params["batch"])
        self.checked = int(params["checked_steps"])
        self.rng = np.random.default_rng(seed)
        self.rows = _data().distinct_rows(self.rng.permutation(len(self.tl)), base,
                                          self.checked * self.batch)
        self.aug_seeds = [int(s) for s in self.rng.integers(0, 2 ** 62, self.checked)]

    def next_generator_seed(self) -> int:
        return int(self.rng.integers(0, 2 ** 62))


def _data():
    from benchmark import data
    return data


def program_steps(torch, ctx, fold: Fold, engine_hook=None):
    """Build the port's training state and drive it through the checked
    steps. Returns (engine, state, train data, val data, readings)."""
    from multi_task_breast_cancer_tpu_torch.train.state import create_train_state
    cfg = ctx.config
    model = _port_model(torch, cfg)
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    model.load_state_dict(_data().seeded_state(torch, shapes, fold.seed, ctx.device))
    ctx.log(f"set-up: model at {time.perf_counter() - ctx.t_start:.3f} s")
    engine = _engine(torch, cfg, model, fold.batch, ctx.device)
    if engine_hook is not None:
        engine_hook(engine)
    state = create_train_state(engine.model, cfg["optimizer"], cfg["lr"])
    train = engine.device_data(_dataset(fold.ti, fold.tm, fold.tl))
    val = engine.device_data(_dataset(fold.vi, fold.vm, fold.vl), for_training=False)
    ctx.log(f"set-up: engine and data at {time.perf_counter() - ctx.t_start:.3f} s")
    params = list(engine.model.parameters())
    start = [p.detach().clone() for p in params]
    losses, grad1, val_loss = [], None, None
    for k in range(fold.checked):
        rows = fold.rows[k * fold.batch:(k + 1) * fold.batch]
        gen = torch.Generator().manual_seed(fold.aug_seeds[k])
        state, tm, vm = engine.train_and_eval_epoch(state, train, val, rows, gen)
        losses.append(tm["loss"])
        val_loss = vm["loss"]
        ctx.log(f"set-up: checked step {k + 1} at {time.perf_counter() - ctx.t_start:.3f} s")
        if k == 0:
            opt_state = state.optimizer.state
            grad1 = _norms(torch, [opt_state[p]["exp_avg"] / (1 - B1) if p in opt_state
                                   else torch.zeros_like(p) for p in params])
    change = _norms(torch, [p.detach() - s for p, s in zip(params, start)])
    del start
    readings = {"losses": losses, "grad1": grad1, "change": change, "val_loss": val_loss}
    return engine, state, train, val, readings


def _norms(torch, tensors):
    return torch.stack([t.detach().double().norm() for t in tensors]).cpu()


def reference_steps(torch, ctx, fold: Fold, tf32: bool = False):
    """The plain reference through the checked steps from the same weights,
    rows and draws (float32, TF32 off; ``tf32`` computes in TF32, the
    control)."""
    from benchmark.reference import models, train as R
    cfg = ctx.config
    device = ctx.device
    if torch.device(device).type == "cuda":
        R.cuda_f32(tf32)
    model = models.build(cfg["reference_model"], **cfg["reference_kwargs"]).to(device)
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    model.load_state_dict(_data().seeded_state(torch, shapes, fold.seed, device))
    params = list(model.parameters())
    start = [p.detach().clone() for p in params]
    opt = R.Adam(params, cfg["lr"], cfg["adam_eps"])
    n_classes = len(cfg["classes"])
    losses, grad1 = [], None
    for k in range(fold.checked):
        rows = fold.rows[k * fold.batch:(k + 1) * fold.batch]
        gen = torch.Generator().manual_seed(fold.aug_seeds[k])
        fh, fv, angle = R.draws(gen, 1, fold.batch, cfg["hflip"], cfg["vflip"], cfg["max_angle"])
        planes = torch.from_numpy(np.stack([fold.tm[rows], fold.ti[rows]], axis=1)).float()
        aug = R.augment(planes.to(device), fh[0], fv[0], angle[0])
        labels = torch.from_numpy(fold.tl[rows]).to(device)
        loss = R.loss(cfg["task"], model(aug[:, 1:2]), aug[:, 0:1], labels, n_classes,
                      cfg["alpha"])
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(p) for g, p in zip(grads, params)]
        if k == 0:
            grad1 = R.leaf_norms(grads)
        opt.step(grads)
        losses.append(float(loss.detach()))
    change = R.leaf_norms([p.detach() - s for p, s in zip(params, start)])
    with torch.no_grad():
        vi = torch.from_numpy(fold.vi[:, None]).float().to(device)
        vm = torch.from_numpy(fold.vm[:, None]).float().to(device)
        vl = torch.from_numpy(fold.vl).to(device)
        val_loss = float(R.loss(cfg["task"], model(vi), vm, vl, n_classes, cfg["alpha"]))
    if torch.device(device).type == "cuda":
        R.cuda_f32(False)
    return {"losses": losses, "grad1": grad1, "change": change, "val_loss": val_loss}


def readings_gaps(program: dict, reference: dict) -> dict:
    """The numbers read: the relative gap of the first step's loss and the
    worst over the checked steps; of a leaf's first-gradient norm and of a
    leaf's change over the checked steps, each by the worst leaf and by the
    median leaf (leaves whose reference gradient is under a thousandth of
    the median leaf's left out of the change); and of the validation loss
    after the checked steps. The workload's ``limits`` name those compared:
    the worst step and the worst leaf carry the later steps' and one small
    leaf's amplified rounding (PERF.md)."""
    from benchmark.reference import train as R
    g_ref = reference["grad1"]
    moved = g_ref >= SMALL_LEAF * float(g_ref.median())
    return {"loss1_gap": R.step_loss_gap(program["losses"][:1], reference["losses"][:1]),
            "loss_gap": R.step_loss_gap(program["losses"], reference["losses"]),
            "grad_gap": R.worst_leaf_gap(program["grad1"], g_ref),
            "grad_median_gap": R.median_leaf_gap(program["grad1"], g_ref),
            "change_gap": R.worst_leaf_gap(program["change"], reference["change"], moved),
            "change_median_gap": R.median_leaf_gap(program["change"], reference["change"],
                                                   moved),
            "val_loss_gap": R.step_loss_gap([program["val_loss"]], [reference["val_loss"]])}


def _record(torch, ctx, fold: Fold, traced: dict, steps: int, n_val: int) -> dict:
    from benchmark import counters
    cfg = ctx.config
    kw = cfg["reference_kwargs"]
    sites = counters.norm_sites(torch, cfg["reference_model"], kw, cfg["size"], cfg["channels"])
    flops = counters.forward_flops(torch, cfg["reference_model"], kw, cfg["size"],
                                   cfg["channels"])
    return {"kind": "train", "window_s": traced["window_s"], "busy_s": traced["busy_s"],
            "kernels": traced["kernels"], "steps": steps, "batch": fold.batch,
            "images_trained": steps * fold.batch, "images_validated": n_val,
            "forward_flops": flops, "peak_flops": counters.PEAK_FLOPS[cfg["compute_dtype"]],
            "norm_sites": sites, "aug_planes": 2, "canvas": cfg["size"]}


def run(ctx) -> dict:
    import torch
    from multi_task_breast_cancer_tpu_torch.train.loop import plan_epoch_indices
    cfg, params = ctx.config, ctx.workload["params"]
    ctx.log(f"set-up: imports at {time.perf_counter() - ctx.t_start:.3f} s")
    fold = Fold(ctx.seed, params, cfg)
    ctx.log(f"set-up: fold at {time.perf_counter() - ctx.t_start:.3f} s")
    engine, state, train, val, prog = program_steps(torch, ctx, fold, ctx.engine_hook)
    n, n_val = len(fold.tl), len(fold.vl)

    def epoch():
        perm = plan_epoch_indices(n, fold.batch, fold.rng)
        gen = torch.Generator().manual_seed(fold.next_generator_seed())
        _, tm, _ = engine.train_and_eval_epoch(state, train, val, perm, gen)
        return len(perm) // fold.batch, math.isfinite(tm["loss"])

    _sync(torch, ctx.device)
    setup_s = time.perf_counter() - ctx.t_start
    out = {"setup_s": setup_s, "e2e": {}, "record": None, "traced": None}
    steps = failed = epochs = 0
    if ctx.trace:
        epoch()  # one whole epoch before the profiled one
        from benchmark import trace
        counted = []
        traced = trace.window(torch, lambda: counted.append(epoch()))
        if traced is not None:
            out["traced"] = traced
            out["record"] = _record(torch, ctx, fold, traced, counted[-1][0], n_val)
            for name, (seconds, count) in sorted(traced["kernels"].items()):
                if "instance_norm" in name or "fast_augment" in name:
                    ctx.log(f"traced: {count} launches, {seconds!r} s: {name}")
        steps = sum(s for s, _ in counted)
        failed = sum(s for s, ok in counted if not ok)
    elif ctx.seconds > 0:
        from multi_task_breast_cancer_tpu_torch.ops import launches
        before = launches.snapshot()
        t0 = time.perf_counter()
        while True:
            s, ok = epoch()
            steps, epochs = steps + s, epochs + 1
            failed += 0 if ok else s
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        window_s = time.perf_counter() - t0
        out["e2e"]["train_images_per_s"] = steps * fold.batch / window_s
        ctx.log(f"window: {epochs} epochs, {steps} steps of {fold.batch} in {window_s:.4f} s")
        ctx.log("window: kernel launches per step (validation's included): " + ", ".join(
            f"{fn.__name__} {n / steps:.3f}" for fn, n in launches.since(before).items()))
    out["peak_bytes"] = (torch.cuda.max_memory_allocated()
                         if torch.device(ctx.device).type == "cuda" else 0)
    del engine, state, train, val
    gc.collect()
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_steps(torch, ctx, fold)
    gaps = readings_gaps(prog, ref)
    limits = ctx.workload["limits"]
    out["checks"] = [(k, gaps[k], limits[k]) for k in limits]
    out["attempted"], out["failed"] = steps, failed
    out["readings"] = {"program": prog, "reference": ref, "gaps": gaps}
    return out
