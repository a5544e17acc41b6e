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
   launches per forward; forward time and images/s, f32 and bf16, and device
   time by kernel class;
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
5a. split statistics: the four split entry points of #1 and #2
   (``instance_norm_split_sums``, ``..._split_apply``,
   ``..._split_backward_sums``, ``..._split_backward_apply``) at every site
   shape of the flagship, batches 2 and 64, f32 and bf16: each plane's rows
   in two calls, their sums combined in part order on the device as two
   ``space`` ranks combine them; every call on every part against its own
   plain twin on the same inputs (the sums and the f32 gradient within 1e-5
   of their scale, the apply 1e-5 absolute, bf16 outputs one ulp), and the
   combined result against the fused kernel on the whole plane, forward and
   backward (``kink_free`` inputs; f32 1e-5, bf16 one ulp, as the fused
   kernel against its twin); each entry point's time on
   one part beside its plain twin's and its bytes bound (no library call
   computes a part's sums or the apply);
6. augmentation kernel: ``fast_augment`` against its plain version, bit for
   bit, under every launch plan it takes (staged, direct; 1-32 blocks per
   plane), at S=128 P=2 B∈{2, 64}, S=256 P=3 B=16 and S=16 P=2
   B=8, with draws that include ±180°, multiples of 90° and both flips;
   each plan's time, the default plan and the index-plane design (the
   first design: three (B, 3, S, S) index planes read from device memory)
   in turns, the plain version's time, the launch floor and the bound:
   selected source planes and output once, factors once (no single
   PyTorch call computes this function: no library time);
6a. LayerNorm kernels (``phase_layer_norm``; alone:
   ``phase_layer_norm_alone``): ``ops/layer_norm.py``'s forward, backward
   and parameter-gradient kernels at the 20 LayerNorm sites of a SwinUNETR
   step (batch 2, 128²), f32 and bf16: ptxas's registers and spills, the
   forward, statistics and three gradients against the plain twin (in f32
   on the same values, rounded once to the working type), two
   backward calls bit for bit, and per site the forward's and the
   backward's times beside their bytes bound, the plain twin's and
   ``F.layer_norm``'s (forward and autograd backward, timed here only);
6b. affine InstanceNorm kernels (``phase_instance_norm_affine``; alone:
   ``phase_instance_norm_affine_alone``): ``ops/instance_norm_affine.py``'s
   forward, backward and parameter-gradient kernels at the 26 UNETR norm
   sites of a SwinUNETR step (batch 2, 128²; ``norm1``, ``norm2`` with its
   residual, ``norm_skip``), f32 and bf16: ptxas's registers and spills,
   the output bit for bit against the module's epilogue on the kernel's
   saved statistics, the statistics against the plain twin, the gradients
   against the backward's plain reference on the same output and
   statistics (tolerances of ``tests/test_torch_instance_norm_affine.py``),
   two backward calls bit for bit, and per site the forward's and the
   backward's (two launches) times beside their bytes bound, the plain
   twin's (its forward, the autograd backward through it) and the library
   call's (``F.instance_norm`` with the affine, the add and
   ``F.leaky_relu``; forward and autograd backward, timed here only);
6c. selective scan kernels (``phase_selective_scan``; alone:
   ``phase_selective_scan_alone``): ``ops/selective_scan.py``'s forward,
   reverse scan and reduction at the six scans of a U-Mamba_Enc training
   step (batch 2, 128², read from the registry's model), f32: ptxas's
   registers and spills, the output and the eight gradients through the
   autograd Function against the plain twin in f64 on the same inputs (its
   gradients autograd's; 2e-5 of each one's largest magnitude, as
   ``tests/test_torch_umamba.py``), two runs bit for bit, one launch of
   each kernel a site, per site the launch plan along L (``scan_plan``) and
   what the card makes of it (blocks an SM, clusters at once), and per site
   the forward's and the backward's times beside their bound and the plain
   twin's (no library call computes the scan); then U-Mamba_Enc's step
   graphed against eager as 7f holds its
   cases (batch 2 f32, 8 steps, 7 real): bit for bit after every epoch,
   the scan 6/6/6 launches a real step, LayerNorm 6/6/6, affine
   InstanceNorm 48/48/48 both ways, a validation pass of 6, 6 and 48
   forwards graphed == eager, an epoch of padding steps launching nothing;
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
   model's first convolution: the kernel alone, no cast or copy; the
   batch-2 step with the norm dispatched through its
   ``torch.autograd.Function`` and through its custom operator, in turns;
   the trained state is saved as a checkpoint for 7b;
7a. training in bf16, a main path: the same with ``training.compute_dtype:
   bfloat16`` (bf16 copies of the f32 masters in each forward, channel pairs
   in one augmentation plane): the same counts and no-op checks, a step's
   profile that must show the bf16 builds of the norm kernels (25 + 25), the
   augmentation path (the kernel and one unpacking copy), ms per step at
   batch 2 and 64 beside 7's f32 and the peak memory; the step-0 loss
   against the f32 Engine's (5e-2 relative), and the bf16 forward at batch
   2 on the card against the CPU by the rule of ``tests/test_torch_bf16.py``;
7b. export, a main path: ``python -m ...serve export`` in a process of its
   own on 7's checkpoint writes an f32 raw artifact and a bf16
   ``--device-postprocess`` one, programs for the CPU and the card at
   buckets 1, 8, 64, each carrying no weight; ``ExportedModel`` runs 1, 5,
   64 and 100 images (25 norm launches per bucket execution; f32 equal to
   ``CheckpointBackend``'s direct answer to 1e-4 of the output scale); the
   card's programs against the CPU's; the compact answer against the host
   postprocessing of a raw bf16 program's outputs, exactly; ``serve run
   --artifact`` in a process of its own answers ``/predict`` and a raw
   ``/predict_batch`` of 64 as ``ArtifactBackend`` does directly; images/s
   and latency of artifact and live backends, f32 and bf16, and the download
   bytes per image;
7c. data parallelism, a main path (``phase_parallel``; ranks are processes
   of their own over ``torch.distributed``): ``training_multitask
   --coordinator --num-processes 1 --process-id 0`` (NCCL, one rank) beside
   the same run in this process without a process group, metrics rows
   bit-identical; MTnnUNet at full width, batch 4 over two ranks on the one
   card over Gloo (fast augmentation, 4 real steps and a padding step):
   #1/#2/#3 launched 25/25/1 per real step on each rank and none on the
   padding step, losses and parameters against one process (the first
   step's loss to 1e-5, the others to 1e-3; the parameters by phase 7's
   rule), the augmented rows byte-equal, parameters and buffers
   bit-identical across the ranks, the step-0 gradient after the all-reduce
   equal to one process's sum of the shards' shares and their f64 sum equal
   to the global batch's f64 gradient; ResidualUNet the same way (running
   statistics after the first step within 1e-5 of their scale, dropout
   masks the single-process rows bit for bit; eager by the rule: its
   ``BatchNorm`` all-reduces in the forward); MTnnUNet graphed
   on each rank (two programs around the eager gradient all-reduce) against
   the eager ranks from one seeded state, in f32 and bf16, bit for bit:
   losses, each step's all-reduced gradient and Adam's state, parameters
   and buffers, launches, augmented rows (the f32 graphed ranks also held
   to one process as above); rank 0's graphed epoch in profiled windows
   (#1/#2/#3 25/25/1 per replayed step); each rank's step without its
   all-reduce, graphed against eager in turns, and the all-reduce alone;
   batch 2 over three ranks with one empty shard, 3 steps, eager and
   graphed (no launch on it; graphed == eager bit for bit); NCCL over two
   cards when two are visible (else a line says why not); a one-rank NCCL
   ``DataMesh`` in this process: MTnnUNet batch 2, graphed == eager ==
   the graphed Engine without a mesh, bit for bit; ``CheckpointBackend`` with two
   replicas on the card (``max_batch`` rounded up, exactly one replica's
   answer, 25 launches per replica) and ``ExportedModel`` over 7b's f32
   artifact with two replicas (one replica's answer to 1e-4 of scale, its
   plan = JAX's rule, 25 launches per bucket execution); the gradient
   all-reduce's time under Gloo and NCCL (one rank) and the two-rank step
   beside the one-process step, with the card's name and power limit;
7d. spatial partitioning, a main path (``phase_spatial``): MTnnUNet at full
   width over a ``(1 data × 2 space)`` mesh, two ranks on the one card over
   Gloo, each holding half the rows of every image: three batch-2 steps at
   128² through the Engine (fast augmentation on) and an evaluation, with
   per step and rank no fused norm launch, the split entry points
   50/25/25/25, one augmentation launch, 25 halo exchanges forward and 24
   backward; every loss and the evaluation against one process replaying
   the ranks' weights before each step (1e-5 relative: the same weights, so
   no element crosses the LeakyReLU's kink between the two; the
   evaluation's thresholded Dice to two pixels); step 0's gradient after
   the all-reduce against one process's from the same weights, tensor by
   tensor (least-squares scale within 1e-2 of 1, distance within 5e-2 of
   the norm); parameters bit-identical across the ranks; each rank's peak
   memory over a batch-2 step at 256² (above what it held before the step:
   weights, gradients, Adam's moments) at most 0.6 of one process's, each
   process limited to 1.5 GiB so that cuDNN takes convolution algorithms
   whose workspace fits (the ranks and one process without the limit
   beside, printed); ``run_experiment`` with
   ``spatial_partitions: 2`` on both ranks (24 images, CV 2, 1 epoch):
   finite rows, the same on both ranks, the mesh's axes logged; its time;
7f. graphs against eager (``phase_graphs``; alone: ``phase_graphs_alone``):
   since this phase, every single-process Engine on the card replays its
   step as a CUDA graph and every serving backend one graph per (replica,
   bucket), so phases 4, 7, 7a, 7b, 8, 8a, 9, 9a and 9b run graphed (7c-7e
   run eagerly under their meshes; the checks of the step's Python, the
   augmentation path's markers and the norm's dispatch cost in 7, run on an
   eager twin of the Engine). Here, cuDNN deterministic: MTnnUNet (the
   config's full width), ResidualUNet (batch statistics, dropout) and
   SwinUNETR (its constant cache, its shift masks) at 128², each from one
   seeded state through a graphed and an eager Engine (``cuda_graphs=False``):
   8 batch-2 steps in f32 and in bf16 (3 real and a padding step, the
   learning rate halved, then 4 real) and 4 batch-64 f32 steps, Adam at the
   ``Config()`` defaults, fast augmentation: the epoch metrics, parameters,
   buffers, Adam's moments and step after every epoch and where the
   dropout generator ends, bit for bit, the #1/#2/#3 launches equal, and
   SwinUNETR's LayerNorm launches 20/20/20 and its affine InstanceNorm
   launches 26/26/26 a real step both ways, and 20 and 26 forwards a
   validation pass (the whole split, graphed == eager); an
   epoch of padding steps replaying nothing; the step after the lr change
   differing from a graphed run without it; UNet with the exact
   augmentation and the Hausdorff criterion the same way (4 steps); the
   live backend at buckets 1, 8, 64 and 7b's two artifacts (f32 raw, bf16
   compact), f32 and bf16, graphed against eager bit for bit with 25 norm
   launches per bucket execution and a weight swap answered with the new
   weights. Readings, each with the card's name and power limit: host ms
   per step graphed and eager (batch 2 f32/bf16, batch 64 f32), the device
   time and busy share of a step from one profiled epoch (MTnnUNet: the
   union of the card's activities over the host clock of the same window;
   #1/#2/#3 counted by name in the trace, graphed and eager, must be the
   launches the counters added, and graphed the program's launches per
   replay times the replays), the capture's seconds and memory, ms per
   bucket execution graphed and eager;
8. driver, a main path: ``run_experiment(cfg, "multitask", "CV")`` at the
   ``Config()`` defaults on a 450-image 128² synthetic BUSI tree (CV 2, 2
   epochs), the ``training_multitask`` CLI in a process of its own, a killed
   and resumed run, and ``CheckpointBackend`` on the run's checkpoint;
8a. driver in bf16: ``run_experiment`` with ``compute_dtype: bfloat16`` at
   full width (16 images per class, CV 2, 1 epoch): launches as the fold
   sizes predict, f32 checkpoints;
9. tools, the command-line tools at the ``Config()`` defaults on the card by
   default: (a) ``data.preprocessing.main`` on a raw BUSI-style tree of 450
   128² images (every PNG and mapping.csv row re-read as written); (b)
   ``data.ssim.find_duplicates`` on those images with BUSI's 5 quadruplets,
   22 triplets and 122 duplets planted as noisy copies (the groups found
   exactly, 64 pairs against a float64 numpy SSIM to 1e-4, pairs/s); (c)
   ``models.torch_import.main`` on a reference-named state_dict of seeded
   tensors (the checkpoint's forward equals the model's, tolerance 0); (d) a
   flax-msgpack checkpoint of the full-width weights and Adam's state,
   written by :func:`flax_msgpack_bytes` (the card has no flax) and decoded
   by the port (Adam's state as written, the forward equal to the
   ``weights.npz`` path's, tolerance 0); (e) ``predict.main`` over the 450
   PNGs with that checkpoint (predictions.json equal to ``Engine.predict`` +
   ``postprocess`` called directly, 25 norm launches, images/s); (f)
   ``evaluate.main`` over the tree as a UCLM-style set (ms per image, forward
   vs host); (g) ``data.holdout_check.main`` (its fold sizes are
   ``data/splits.py``'s);
9a. the zoo: the BTS family, the UNet++ family and Adityan at full width
   (width 24, deep supervision where the architecture has it, seeded
   weights, 128²): each model's parameter count against JAX's
   (``ZOO_PARAMETERS``), its norm launches per forward at batches 2 and 64
   and per batch-2 backward (``ZOO_NORMS``), its forward against the
   plain-norm model on the card
   (batch 64) and the plain model on the CPU (batch 2), and its device time
   at batch 64; kernels #1 and #2 against their twins at the BTS family's
   12 site shapes the flagship does not give them (batches 2 and 64, f32
   and bf16) and each BTS model's kernel time per forward and backward,
   summed over its sites, beside the bound; an epoch of Multi_BTSUNet and of MTUNetPlusPlus at the
   ``Config()`` defaults (launch counts exact, a padding step a no-op, step
   ms, step-0 gradients against f64); and a main path:
   ``training_multitask`` (the CLI's ``run_entry``) with Multi_BTSUNet on a
   96-image tree, 2 folds × 2 epochs (launches as the fold sizes predict),
   then ``CheckpointBackend`` over its checkpoint behind ``InferenceServer``
   answering ``/predict_batch`` as ``Engine.predict`` does;
9b. the seg zoo: ResidualUNet, UNet, AttentionUNet (width 24), SegResNet and
   SwinUNETR (fixed sizes) at 128², seeded weights: parameter and
   batch-statistic counts against JAX's (``SEG_ZOO_PARAMETERS``,
   ``SEG_ZOO_BATCH_STATS``), eval forwards at batches 2 and 64 with no
   norm-kernel launch (none of the five has the site), card against CPU at
   batch 2, forward ms at 64; four batch-2 steps and a padding step of each
   at the ``Config()`` defaults (the augmentation kernel once per real step
   and never on the padding step, ResidualUNet's batch statistics moved by
   the real steps and left by the padding step, a second run from the same
   generators bit-identical, ms per step); one step per segmentation
   criterion, card against CPU, and the Hausdorff distance fields equal on
   both; and a main path: ``training_segmentation`` (the CLI's
   ``run_entry``) with ResidualUNet and with SwinUNETR on a 96-image tree, 2
   folds × 2 epochs (launches as the fold sizes predict), a killed and
   resumed ResidualUNet run (rows and checkpoints identical), and
   ResidualUNet's checkpoint served over HTTP and through ``serve export`` /
   ``serve run --artifact`` (equal to the live backend to 1e-4 of scale);
10. a JSON line ``{"kernels": [...]}`` with each kernel's launches on the main
   paths, error, times and bound (``previous_ms``: the norm kernels' first,
   streaming design, and the augmentation's index-plane design, timed in the
   same run), f32, under ``bf16`` the bf16 builds' launches and rows
   (#1, #2 at batches 2 and 64; #3 at P = 1, B = 2 and 64), under ``zoo``
   the norm kernels' per-architecture launches counted on the card, sites,
   and times and bounds summed over the sites (``sites_*``, 9a), and under
   ``seg_zoo`` each kernel's launches per seg-zoo architecture (9b: 0 for
   #1 and #2; #3 per four steps, with the forward and step ms), under
   ``parallel`` 7c's launches per rank of each multi-rank run; the four
   split entry points with 7d's launches (both ranks) and 5a's totals over
   the sites at batch 64 f32 (one part of two; ``batch_2``, ``bf16``
   beside); the three LayerNorm entry points with their launches per step
   and per validation pass of 7f's graphed SwinUNETR Engine (each case)
   and 6a's totals over SwinUNETR's sites; the three affine InstanceNorm
   entry points likewise (6b); the three selective scan entry points with
   their launches per step and per validation pass of 6c's graphed
   U-Mamba_Enc Engine and 6c's totals over its sites; then, last, ``{"ok":
   true, "device": ...}``.

Tolerances. bf16 paths: see 7a and 7b, and ``tests/test_torch_bf16.py``
(two bf16 forwards round at other places, so each is held to its own f32
answer). f32 kernel vs plain: 1e-5 absolute (the same f32 arithmetic,
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

import gc
import json
import math
import os
import re
import shutil
import statistics
import struct
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
ZERO_GRAD_REL = 1e-6  # a gradient at most this share of the model's largest is zero
LOSS_REL_TOL = 1e-4
PARAM_REL_TOL = 0.1
TRAIN_N, VAL_N, PAD_STEPS = 48, 12, 2

# the zoo at full width (width 24, deep supervision on where the architecture
# has it, 128²): parameters as the JAX package counts them, and fused-norm
# launches per forward (tests/test_torch_zoo.py holds both on the CPU)
ZOO_PARAMETERS = {
    "BTSUNet": 1_636_107, "FSBBTSUNet": 2_009_960, "UnetPlusPlus": 2_410_180,
    "BTSUNetClassifier": 4_139_599, "UNetPlusPlusClassifier": 13_741_131,
    "Multi_BTSUNet": 15_381_262, "Multi_FSB_BTSUNet": 15_754_601,
    "MTUNetPlusPlus": 14_927_455, "Adityan": 3_353_629}
ZOO_NORMS = {"BTSUNet": 17, "FSBBTSUNet": 25, "UnetPlusPlus": 0, "BTSUNetClassifier": 10,
             "UNetPlusPlusClassifier": 0, "Multi_BTSUNet": 19, "Multi_FSB_BTSUNet": 27,
             "MTUNetPlusPlus": 0, "Adityan": 0}
# the rest of the segmentation zoo at full width (width 24; SegResNet and
# SwinUNETR at their fixed sizes; 128²): parameters and batch-statistic
# values as the JAX package counts them (tests/test_torch_seg_zoo.py holds
# them to jax.eval_shape on the CPU); none has a fused-norm site
SEG_ZOO_PARAMETERS = {"ResidualUNet": 1_304_449, "UNet": 363_967, "AttentionUNet": 1_095_544,
                      "SegResNet": 395_985, "SwinUNETR": 6_311_899}
SEG_ZOO_BATCH_STATS = {"ResidualUNet": 2_784}
# U-Mamba_Enc's scans at 128², (d_inner, L): patch tokens, then channel tokens
SCAN_SITES = ((64, 16384), (128, 4096), (256, 1024), (512, 256), (128, 512), (32, 512))
SCAN_REL_TOL = 2e-5  # the f32 chain of up to 16,384 steps against the f64 twin


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


def phase_kernel(shapes: Counter, batches: tuple = (1, 2, BATCH), extras: bool = True,
                 per_shape: dict = None) -> dict:
    """Kernel #1 at every site's shape and ``batches``; returns the totals
    over the sites' launches at each batch and type, and fills ``per_shape``
    (keyed by batch, type and (C, H, W)) with each shape's numbers.
    ``extras``: also the launch floor and the shapes off the model's path."""
    import torch
    import torch.nn.functional as F
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk

    g = torch.Generator(device=DEVICE).manual_seed(0)
    floor = launch_floor_ms() if extras else 0.0
    result = {}
    per_shape = {} if per_shape is None else per_shape
    for batch in batches:
        totals = {dt: {"ms": 0.0, "previous_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                       "bound_ms": 0.0} for dt in (torch.float32, torch.bfloat16)}
        bound_kinds, max_err = {dt: set() for dt in totals}, {dt: 0.0 for dt in totals}
        log(f"kernel instance_norm_leaky_relu at batch {batch}: {len(shapes)} shapes, "
            f"{sum(shapes.values())} sites; new plan vs the streaming design in turns")
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
                l_ms = time_ms(lambda: F.leaky_relu(F.instance_norm(xd), 0.01))
                log(f"  C={c:4d} HxW={h:3d}x{w:<3d} x{sites} {str(dtype)[6:]:8s} "
                    f"{plan_text(plan):28s} err {err:.3g}  kernel {k_ms:.4f} ms  "
                    f"streaming {s_ms:.4f} ms  plain {p_ms:.4f} ms  "
                    f"bound {b_ms:.4f} ms ({kind})  library {l_ms:.4f} ms")
                max_err[dtype] = max(max_err[dtype], err)
                numbers = {"ms": k_ms, "previous_ms": s_ms, "plain_ms": p_ms,
                           "library_ms": l_ms, "bound_ms": b_ms}
                per_shape[batch, dtype, (c, h, w)] = {**numbers, "bound_by": kind, "err": err,
                                                      "plan": plan_text(plan)}
                for key, v in numbers.items():
                    totals[dtype][key] += sites * v
                bound_kinds[dtype].add(kind)
        result[batch] = {}
        for dt, tot in totals.items():
            log(f"kernel totals over the {sum(shapes.values())} {str(dt)[6:]} launches of "
                f"these sites at batch {batch}: "
                + ", ".join(f"{k} {v:.4f}" for k, v in tot.items())
                + (f", launch floor {25 * floor:.4f}" if extras else ""))
            result[batch][dt] = {"max_abs_err": max_err[dt], "bound_by": "bytes"
                                 if bound_kinds[dt] == {"bytes"} else "operations", **tot}
    if not extras:
        return result

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
    return result


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


def plain_twin(model):
    """A copy of ``model`` whose ConvInNormLeReLU blocks take the plain norm
    (``InstanceNorm`` + ``F.leaky_relu``) instead of the kernel."""
    import copy
    from multi_task_breast_cancer_tpu_torch.models.blocks import ConvInNormLeReLU, InstanceNorm
    twin = copy.deepcopy(model)
    for m in twin.modules():
        if isinstance(m, ConvInNormLeReLU):
            m.norm = InstanceNorm()
    return twin


def phase_model(model) -> None:
    import torch
    from multi_task_breast_cancer_tpu_torch.models.multitask import MTnnUNet
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk

    plain = plain_twin(model).eval()
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

        cpu = plain_twin(model).cpu()
        err = _max_rel_err([t[:2] for t in _flat(out)], _flat(cpu(x[:2].cpu())))
        log(f"model: card vs CPU, batch 2: max err {err:.3g} of the output scale")
        check(err <= MODEL_REL_TOL, "model outputs: card vs CPU")

        fwd_ms = time_ms(lambda: model(x), reps=10)
        plain_ms = time_ms(lambda: plain(x), reps=10)
        log(f"model forward (batch {BATCH}, {SIZE}^2, f32, TF32 off): {fwd_ms:.3f} ms "
            f"= {BATCH / fwd_ms * 1e3:.1f} images/s; plain-norm model {plain_ms:.3f} ms")
        profile_forward(model, x)

        # bf16: the model and the input cast, outputs to f32 (the serving
        # backends' and the exported programs' bf16 forward)
        del plain
        m16 = MTnnUNet()
        m16.load_state_dict(model.state_dict())
        m16 = m16.to(DEVICE, torch.bfloat16).eval()
        x16 = x.to(torch.bfloat16)
        hk.instance_norm_leaky_relu.launches = 0
        out16 = m16(x16)
        torch.cuda.synchronize()
        launches = hk.instance_norm_leaky_relu.launches
        check(launches == 25, f"{launches} kernel launches in one bf16 forward, want 25")
        err = _max_rel_err(_flat(out16), _flat(out))
        log(f"model bf16 forward vs f32, batch {BATCH}: max err {err:.3g} of the output scale")
        bf16_ms = time_ms(lambda: m16(x16), reps=10)
        log(f"model forward (batch {BATCH}, {SIZE}^2, bf16): {bf16_ms:.3f} ms = "
            f"{BATCH / bf16_ms * 1e3:.1f} images/s; f32 {fwd_ms:.3f} ms "
            f"({fwd_ms / bf16_ms:.2f}x)")
        profile_forward(m16, x16)
        del m16


def profile_forward(model, x) -> None:
    """Device time of one forward by kernel (torch.profiler), the largest
    first: where the forward's time goes."""
    rows = trace_window(lambda: model(x))["rows"]
    total = sum(r[0] for r in rows)
    if total <= 0:
        log("profile of one forward: the profiler saw no device time (not measured)")
        return
    log(f"profile of one forward: {total:.3f} ms device time in {sum(r[1] for r in rows)} "
        f"device activities of {len(rows)} kernels; by kernel:")
    for ms, count, name in rows[:8]:
        log(f"  {ms:8.3f} ms {100 * ms / total:5.1f}%  x{count:<3d} {name[:100]}")
    log_classes(rows, total)


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


def phase_backward_kernel(shapes: Counter, extras: bool = True,
                          per_shape: dict = None) -> dict:
    """Kernel #2 against its plain version at every norm site's shape, at a
    training step's batch (2) and at 64, beside the streaming design in
    turns. Returns the totals over the sites' launches at each batch and
    type, and fills ``per_shape`` as :func:`phase_kernel` does. ``extras``:
    also the shapes off the model's path."""
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
    per_shape = {} if per_shape is None else per_shape
    for batch in (2, BATCH):
        totals = {dt: {"ms": 0.0, "previous_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                       "bound_ms": 0.0} for dt in (torch.float32, torch.bfloat16)}
        kinds, max_err = {dt: set() for dt in totals}, {dt: 0.0 for dt in totals}
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
                xr = xd.detach().requires_grad_()
                yr = F.leaky_relu(F.instance_norm(xr), 0.01)
                l_ms = time_ms(lambda: torch.autograd.grad(yr, xr, gd, retain_graph=True))
                del xr, yr
                log(f"  C={c:4d} HxW={h:3d}x{w:<3d} x{sites} {str(dtype)[6:]:8s} "
                    f"{plan_text(plan):28s} err {err:.3g}  kernel {k_ms:.4f} ms  "
                    f"streaming {s_ms:.4f} ms  plain {p_ms:.4f} ms  "
                    f"bound {b_ms:.4f} ms ({kind})  library {l_ms:.4f} ms")
                max_err[dtype] = max(max_err[dtype], err)
                numbers = {"ms": k_ms, "previous_ms": s_ms, "plain_ms": p_ms,
                           "library_ms": l_ms, "bound_ms": b_ms}
                per_shape[batch, dtype, (c, h, w)] = {**numbers, "bound_by": kind, "err": err,
                                                      "plan": plan_text(plan)}
                for key, v in numbers.items():
                    totals[dtype][key] += sites * v
                kinds[dtype].add(kind)
        result[batch] = {}
        for dt, tot in totals.items():
            log(f"backward totals over the {sum(shapes.values())} {str(dt)[6:]} launches of "
                f"these sites at batch {batch}: "
                + ", ".join(f"{k} {v:.4f}" for k, v in tot.items()))
            result[batch][dt] = {"max_abs_err": max_err[dt], "bound_by": "bytes"
                                 if kinds[dt] == {"bytes"} else "operations", **tot}
    if not extras:
        return result

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
    return result


# the split entry points' work per element of their part: (tensors read or
# written once, operations)
SPLIT_WORK = {"instance_norm_split_sums": (2, 4),           # x twice: Σx; centre, square, add
              "instance_norm_leaky_relu_split_apply": (2, 6),  # x, y; centre, scale, select
              "instance_norm_leaky_relu_split_backward_sums": (2, 7),
              "instance_norm_leaky_relu_split_backward_apply": (3, 10)}


def _split_entry_ok(got, want) -> tuple:
    """An entry point's f32 sums or input gradient against its plain twin's
    on the same inputs: within tolerance, and the largest absolute error.
    f32: within ``F32_TOL`` of the output's largest magnitude (sums over a
    part's elements in another order); a bf16 gradient within one bf16 ulp
    beside that (the apply's output goes by :func:`_forward_ok`)."""
    import torch
    err = (got.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    if want.dtype == torch.float32:
        return err.max().item() <= F32_TOL * scale, err.max().item()
    return (bool((err <= BF16_REL_TOL * want.float().abs() + F32_TOL * scale).all()),
            err.max().item())


def split_entry_calls(x, g, parts: int = 2):
    """Kernel #1 and #2's split entry points on ``parts`` row parts of
    ``x`` (and ``g``), each part's sums combined in part order on the
    device, as a ``space`` group of ``parts`` ranks combines them. Every
    call, on every part, is held against its plain twin on the same inputs
    (the combined sums the kernels produced): the apply by
    :func:`_forward_ok`, the others by :func:`_split_entry_ok`. Returns
    (y, dx) of the whole planes, each entry point's largest error against
    its twin over the parts, and the inputs of the first part's launches
    (part, gradient part, Σx, Σ(x − mean)², backward sums, total)."""
    import torch
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk
    h = x.shape[2]
    cuts = [i * h // parts for i in range(parts + 1)]
    xs = [x[:, :, a:b].contiguous() for a, b in zip(cuts, cuts[1:])]
    gs = [g[:, :, a:b].contiguous() for a, b in zip(cuts, cuts[1:])]
    total = h * x.shape[3]
    errs = dict.fromkeys(SPLIT_ENTRIES, 0.0)

    def call(name, *args):
        got = getattr(hk, name)(*args)
        want = getattr(hk, f"{name}_reference")(*args)
        ok, err = (_forward_ok if name == "instance_norm_leaky_relu_split_apply"
                   else _split_entry_ok)(got, want)
        check(ok, f"{name} != its plain twin on part {tuple(args[0].shape)} of "
                  f"{tuple(x.shape)} {x.dtype}: max abs err {err:.3g}")
        errs[name] = max(errs[name], err)
        return got

    def combined(parts_):
        out = parts_[0].clone()
        for p in parts_[1:]:
            out += p
        return out

    sums = combined([call("instance_norm_split_sums", p, total) for p in xs])
    sq = combined([call("instance_norm_split_sums", p, total, sums) for p in xs])
    y = torch.cat([call("instance_norm_leaky_relu_split_apply", p, sums, sq, total)
                   for p in xs], 2)
    gsums = combined([call("instance_norm_leaky_relu_split_backward_sums", p, q, sums, sq,
                           total) for p, q in zip(xs, gs)])
    dx = torch.cat([call("instance_norm_leaky_relu_split_backward_apply", p, q, sums, sq,
                         gsums, total) for p, q in zip(xs, gs)], 2)
    return y, dx, errs, (xs[0], gs[0], sums, sq, gsums, total)


def _split_times(first) -> dict:
    """Each split entry point's time on the first part (its two passes
    together for the sums), its plain twin's, and its bound."""
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk
    p, q, sums, sq, gsums, total = first
    calls = {
        "instance_norm_split_sums": (
            lambda: (hk.instance_norm_split_sums(p, total),
                     hk.instance_norm_split_sums(p, total, sums)),
            lambda: (hk.instance_norm_split_sums_reference(p, total),
                     hk.instance_norm_split_sums_reference(p, total, sums))),
        "instance_norm_leaky_relu_split_apply": (
            lambda: hk.instance_norm_leaky_relu_split_apply(p, sums, sq, total),
            lambda: hk.instance_norm_leaky_relu_split_apply_reference(p, sums, sq, total)),
        "instance_norm_leaky_relu_split_backward_sums": (
            lambda: hk.instance_norm_leaky_relu_split_backward_sums(p, q, sums, sq, total),
            lambda: hk.instance_norm_leaky_relu_split_backward_sums_reference(
                p, q, sums, sq, total)),
        "instance_norm_leaky_relu_split_backward_apply": (
            lambda: hk.instance_norm_leaky_relu_split_backward_apply(p, q, sums, sq, gsums,
                                                                     total),
            lambda: hk.instance_norm_leaky_relu_split_backward_apply_reference(
                p, q, sums, sq, gsums, total))}
    out = {}
    for name, (kernel, plain) in calls.items():
        tensors, ops = SPLIT_WORK[name]
        b_ms, kind = bound_ms(p.numel(), p.element_size(), tensors, ops)
        out[name] = {"ms": time_ms(kernel, 10), "plain_ms": time_ms(plain, 10),
                     "bound_ms": b_ms, "bound_by": kind}
    return out


def phase_split_kernel(shapes: Counter) -> dict:
    """5a. The split-statistics entry points of kernels #1 and #2 at every
    norm site's shape of the flagship, batches 2 and 64, f32 and bf16: each
    plane's rows split over two calls on the one card, the sums combined in
    part order on the device (as two ``space`` ranks combine them); each
    call on each part against its plain twin on the same inputs
    (:func:`split_entry_calls`), and the combined result against the fused
    kernel on the whole plane, forward and backward (``kink_free`` inputs),
    within the fused kernel's own tolerances against its twin; each entry
    point timed on one part against its plain twin and its bytes bound (no
    single library call computes a part's sums or the apply). Returns, per
    batch and type, each entry point's totals over the sites, its largest
    error against its twin (``max_abs_err``) and the combined result's
    against the fused kernel (``fused_max_abs_err``)."""
    import torch
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    result = {}
    for batch in (2, BATCH):
        result[batch] = {}
        for dtype in (torch.float32, torch.bfloat16):
            result[batch][dtype] = {name: {"max_abs_err": 0.0, "fused_max_abs_err": 0.0,
                                           "ms": 0.0, "plain_ms": 0.0,
                                           "bound_ms": 0.0, "bound_by": "bytes",
                                           "library_ms": None} for name in SPLIT_ENTRIES}
        log(f"split entry points of #1/#2 at batch {batch}: each plane's rows in two calls, "
            f"against the fused kernel on the whole plane; times of the first part's launch")
        for (c, h, w), sites in sorted(shapes.items(), key=lambda kv: -kv[0][1] * kv[0][2]):
            x = kink_free((batch, c, h, w), gen)
            gy = torch.randn(batch, c, h, w, device=DEVICE, generator=gen)
            for dtype in (torch.float32, torch.bfloat16):
                xd, gd = x.to(dtype), gy.to(dtype)
                y, dx, errs, first = split_entry_calls(xd, gd)
                y0 = hk.instance_norm_leaky_relu(xd)
                dx0 = hk.instance_norm_leaky_relu_backward(xd, gd)
                torch.cuda.synchronize()
                ok, f_err = _forward_ok(y, y0)
                check(ok, f"split forward != fused at B={batch} C={c} HxW={h}x{w} {dtype}: "
                          f"max abs err {f_err:.3g}")
                b_err = (dx.float() - dx0.float()).abs()
                scale = dx0.float().abs().max().item()
                tol = (F32_TOL * scale if dtype == torch.float32
                       else BF16_REL_TOL * dx0.float().abs() + F32_TOL * scale)
                check(bool((b_err <= tol).all()),
                      f"split backward != fused at B={batch} C={c} HxW={h}x{w} {dtype}: "
                      f"max abs err {b_err.max().item():.3g} (scale {scale:.3g})")
                times = _split_times(first)
                rows = result[batch][dtype]
                for name, t in times.items():
                    row = rows[name]
                    row["max_abs_err"] = max(row["max_abs_err"], errs[name])
                    fused = f_err if "backward" not in name else b_err.max().item()
                    row["fused_max_abs_err"] = max(row["fused_max_abs_err"], fused)
                    for key in ("ms", "plain_ms", "bound_ms"):
                        row[key] += sites * t[key]
                    if t["bound_by"] != "bytes":
                        row["bound_by"] = "operations"
                log(f"  C={c:4d} HxW={h:3d}x{w:<3d} x{sites} {str(dtype)[6:]:8s} "
                    f"err vs twin " + "/".join(f"{errs[n]:.3g}" for n in SPLIT_ENTRIES)
                    + f", vs fused fwd {f_err:.3g} bwd {b_err.max().item():.3g}  "
                    + "  ".join(f"{name.split('_split_')[-1].replace('instance_norm_', '')} "
                                f"{t['ms']:.4f}/{t['plain_ms']:.4f}/{t['bound_ms']:.4f}"
                                for name, t in times.items())
                    + " ms (kernel/plain/bound)")
        for dtype in (torch.float32, torch.bfloat16):
            for name, row in result[batch][dtype].items():
                log(f"split totals at batch {batch} {str(dtype)[6:]}, {name} over the "
                    f"{sum(shapes.values())} sites (one part): kernel {row['ms']:.4f} ms, "
                    f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                    f"({row['bound_by']}), max abs err {row['max_abs_err']:.3g} against its "
                    f"twin, {row['fused_max_abs_err']:.3g} of the combined result against "
                    f"the fused kernel")
    log(f"split kernel phase ({_card()}): {time.perf_counter() - t0:.1f} s")
    return result


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
    main, bf16 = None, {}
    log("augmentation kernel fast_augment (bit-exact against the plain pipeline); every "
        "plan, then the default plan vs the index-plane design in turns:")
    # P = 2: f32 [mask | image] planes; P = 1: bf16 channel pairs, one plane
    for s, p, b in ((SIZE, 2, 2), (SIZE, 2, BATCH), (SIZE, 1, 2), (SIZE, 1, BATCH),
                    (256, 3, 16), (16, 2, 8)):
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
        row = {"max_abs_err": 0.0, "ms": k_ms, "previous_ms": o_ms, "plain_ms": p_ms,
               "bound_ms": b_ms, "bound_by": kind, "library_ms": None}
        if main is None:
            main = row
        if s == SIZE and p == 1:
            bf16[b] = row
    return main, bf16


def synthetic_fold(n: int, seed: int, size: int = 0):
    """A BUSI-like fold: uint8-valued ``size``² images (default ``SIZE``)
    with a brighter elliptic lesion, its binary mask, labels
    benign/malignant/normal in turn, and empty masks for 'normal'."""
    import numpy as np
    from multi_task_breast_cancer_tpu_torch.data.dataset import ArrayDataset
    size = size or SIZE
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    labels = (np.arange(n) % 3).astype(np.int32)
    masks = np.zeros((n, size, size, 1), np.float32)
    for i in np.flatnonzero(labels != 2):
        cy, cx = rng.integers(size // 4, 3 * size // 4, 2)
        ry, rx = rng.integers(size // 12, size // 5, 2)
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


def _ln_counts():
    """The LayerNorm kernels' launches: forward, backward, parameter
    gradient."""
    from multi_task_breast_cancer_tpu_torch.ops import layer_norm as L
    return L.layer_norm.launches, L.layer_norm_backward.launches, L.layer_norm_param_grad.launches


def _ina_counts():
    """The affine InstanceNorm kernels' launches: forward, backward,
    parameter gradient."""
    from multi_task_breast_cancer_tpu_torch.ops import instance_norm_affine as A
    return (A.instance_norm_affine.launches, A.instance_norm_affine_backward.launches,
            A.instance_norm_affine_param_grad.launches)


def _ss_counts():
    """The selective scan kernels' launches: forward, reverse scan, fixed-order
    reduction."""
    from multi_task_breast_cancer_tpu_torch.ops import selective_scan as S
    return S.selective_scan.launches, S.selective_scan_backward.launches, \
        S.selective_scan_reduce.launches


def _reset_counts() -> None:
    from multi_task_breast_cancer_tpu_torch.ops import fast_augment as FA
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk
    from multi_task_breast_cancer_tpu_torch.ops import instance_norm_affine as A
    from multi_task_breast_cancer_tpu_torch.ops import layer_norm as L
    from multi_task_breast_cancer_tpu_torch.ops import selective_scan as S
    from multi_task_breast_cancer_tpu_torch.parallel import spatial
    hk.instance_norm_leaky_relu.launches = 0
    hk.instance_norm_leaky_relu_backward.launches = 0
    FA.fast_augment.launches = 0
    for fn in (L.layer_norm, L.layer_norm_backward, L.layer_norm_param_grad,
               A.instance_norm_affine, A.instance_norm_affine_backward,
               A.instance_norm_affine_param_grad, S.selective_scan,
               S.selective_scan_backward, S.selective_scan_reduce):
        fn.launches = 0
    for name in SPLIT_ENTRIES:
        getattr(hk, name).launches = 0
    spatial.reset_counts()


# the split-statistics entry points of kernels #1 (the first two) and #2
SPLIT_ENTRIES = ("instance_norm_split_sums", "instance_norm_leaky_relu_split_apply",
                 "instance_norm_leaky_relu_split_backward_sums",
                 "instance_norm_leaky_relu_split_backward_apply")


def _split_counts() -> dict:
    """The split entry points' launches and the ``space`` group's halo
    exchanges and collectives, by name."""
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk
    from multi_task_breast_cancer_tpu_torch.parallel import spatial
    return {**{name: getattr(hk, name).launches for name in SPLIT_ENTRIES}, **spatial.counts}


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


def phase_training(work: str) -> tuple:
    """The training main path; returns the launches of its two epochs
    (forward norm, backward norm, augmentation), its timings, and the
    checkpoint of its trained state written under ``work`` (the export
    phase's input)."""
    import numpy as np
    import torch
    from multi_task_breast_cancer_tpu_torch.config import Config
    from multi_task_breast_cancer_tpu_torch.models.registry import init_multitask_model
    from multi_task_breast_cancer_tpu_torch.ops.losses import check_finite_loss
    from multi_task_breast_cancer_tpu_torch.train.loop import (
        Engine, plan_epoch_indices, step_valid_mask)
    from multi_task_breast_cancer_tpu_torch.train.optim import (
        CosineAnnealingScheduler, init_lr_scheduler, set_learning_rate)
    from multi_task_breast_cancer_tpu_torch.train.checkpoint import save_checkpoint
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
    ckpt = os.path.join(work, "model_smoke_fold_0")
    save_checkpoint(ckpt, state, epoch=2, val_loss=vm["loss"])

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
    dispatch_cost(engine, state, train, perm, gen)
    del engine, state, train, val
    torch.cuda.empty_cache()
    ms_64 = train_step_ms_64(cfg)

    comparisons(cfg, init_weights, train_ds)
    return launches, {"step_ms": step_ms, "step_ms_64": ms_64}, ckpt


def _eager_twin(engine):
    """An Engine on ``engine``'s model, configuration and packed data
    format that runs its steps eagerly (``cuda_graphs=False``): what a check
    of the step's Python (a swapped norm entry, markers launched around the
    augmentation) runs on, since a replay runs no Python. The same state
    trains in both; the captured step of ``engine`` reads it where it lives."""
    from multi_task_breast_cancer_tpu_torch.train.loop import Engine
    twin = Engine(engine.model, engine.cfg, device=engine.device, cuda_graphs=False)
    twin._aug_fmt = engine._aug_fmt
    return twin


def dispatch_cost(engine, state, data, perm, gen) -> None:
    """The eager batch-2 step with the fused norm called through its
    ``torch.autograd.Function`` (the eager path) and through its custom
    operator (the path ``torch.export`` traces), epochs in turns (Function,
    operator, operator, Function, twice) on the host clock: what the
    operator's dispatch would cost the host-bound step, on an eager twin of
    ``engine`` (:func:`_eager_twin`)."""
    import torch
    from multi_task_breast_cancer_tpu_torch.models import blocks
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk

    engine = _eager_twin(engine)

    def via_op(x, eps=1e-5, slope=0.01, space=None):  # no space group in this phase
        return hk.instance_norm_leaky_relu_op(x, eps, slope)

    steps = len(perm) // engine.cfg.batch_size

    def epoch_ms(fn) -> float:
        blocks.instance_norm_leaky_relu = fn
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.train_epoch(state, data, perm, gen)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / steps
        finally:
            blocks.instance_norm_leaky_relu = hk.instance_norm_leaky_relu

    epoch_ms(via_op)  # warm-up of the operator's path
    times = {hk.instance_norm_leaky_relu: [], via_op: []}
    for fn in (hk.instance_norm_leaky_relu, via_op, via_op, hk.instance_norm_leaky_relu) * 2:
        times[fn].append(epoch_ms(fn))
    fn_ms = statistics.median(times[hk.instance_norm_leaky_relu])
    op_ms = statistics.median(times[via_op])
    log(f"  norm dispatch, batch-{engine.cfg.batch_size} step in turns ({steps} steps an "
        f"epoch, 4 epochs each, medians): torch.autograd.Function {fn_ms:.3f} ms, custom "
        f"operator {op_ms:.3f} ms ({100 * (op_ms / fn_ms - 1):+.1f} %); epochs "
        f"{[round(t, 3) for t in times[hk.instance_norm_leaky_relu]]} vs "
        f"{[round(t, 3) for t in times[via_op]]}")


def train_step_ms_64(cfg) -> float:
    """ms per training step at batch 64 in ``cfg``'s compute dtype, and the
    peak memory of that epoch."""
    import numpy as np
    import torch
    from multi_task_breast_cancer_tpu_torch.models.registry import init_multitask_model
    from multi_task_breast_cancer_tpu_torch.train.loop import Engine, plan_epoch_indices
    from multi_task_breast_cancer_tpu_torch.train.state import create_train_state

    n = 4 * BATCH
    engine = Engine(init_multitask_model("MTnnUNet", generator=torch.Generator().manual_seed(0)),
                    _engine_config(cfg, batch_size=BATCH), device=DEVICE)
    state = create_train_state(engine.model, cfg.optimizer.opt, cfg.optimizer.lr)
    data = engine.device_data(synthetic_fold(n, 12))
    gen, rng = torch.Generator().manual_seed(1), np.random.default_rng(1)
    engine.train_epoch(state, data, plan_epoch_indices(n, BATCH, rng), gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, tm = engine.train_epoch(state, data, plan_epoch_indices(n, BATCH, rng), gen)
    epoch_s = time.perf_counter() - t0
    check(np.isfinite(tm["loss"]), f"batch {BATCH} training loss {tm['loss']}")
    step_ms = epoch_s * 1e3 / (n // BATCH)
    log(f"  batch {BATCH}, {cfg.training.compute_dtype}: epoch of {n // BATCH} steps "
        f"{epoch_s:.3f} s = {step_ms:.3f} ms per step = {n / epoch_s:.1f} images/s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    rows = trace_window(lambda: engine.train_epoch(
        state, data, plan_epoch_indices(n, BATCH, rng)[:BATCH], gen))["rows"]
    total = sum(r[0] for r in rows)
    if total > 0:
        log(f"  profile of one batch-{BATCH} step: {total:.3f} ms device time in "
            f"{sum(r[1] for r in rows)} device activities")
        log_classes(rows, total, "    ")
    del engine, state, data
    torch.cuda.empty_cache()
    return step_ms


def kernel_class(name: str) -> str:
    """The class of a device kernel, by its name, for the breakdowns."""
    n = name.lower()
    if "nchwtonhwc" in n or "nhwctonchw" in n:
        return "cuDNN layout conversions"
    if "instance_norm_leaky_relu" in n:
        return "norm backward (#2)" if "backward" in n else "norm forward (#1)"
    if "fast_augment" in n:
        return "augmentation (#3)"
    if any(k in n for k in ("xmma", "cudnn", "conv", "fft", "dgrad", "wgrad", "winograd",
                            "gemm", "cutlass", "sgemm", "implicit")):
        return "convolutions and GEMMs (cuDNN, cuBLAS)"
    if any(k in n for k in ("adam", "multi_tensor", "foreach")):
        return "optimizer"
    return "elementwise, copies, reductions"


def log_classes(rows, total: float, indent: str = "  ") -> dict:
    """Device ms by kernel class over profiler rows (ms, count, name)."""
    classes = Counter()
    for ms, _, name in rows:
        classes[kernel_class(name)] += ms
    log(f"{indent}device ms by kernel class: " + "; ".join(
        f"{k} {v:.3f} ({100 * v / total:.1f} %)" for k, v in classes.most_common()))
    return dict(classes)


# device activities in a torch.profiler chrome trace, by category: kernels,
# copies and sets; host-side CUDA API calls (a launch, a graph launch)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
MARKER = "instance_norm_leaky_relu_empty"  # the empty kernel's name
LEAD_IN = 100  # spin kernels ahead of a profiled step, a millisecond apart
SPIN = "spin_kernel"  # torch.cuda._sleep's kernel


def trace_window(fn, lead_in=None) -> dict:
    """One profiled window (``torch.profiler``, CUDA activity): ``fn`` run
    with the card synchronised and the host clock read around it, inside the
    profile. Returns ``host_ms``; ``events``, the device activities (start
    and end in µs, category, name); ``busy_ms``, the union of their
    intervals (what overlaps counts once); ``span_ms``, first start to last
    end; ``runtime``, the count of host-side CUDA API calls; ``rows``, (device ms, count, name) by name over the device
    activities, the largest first.

    ``lead_in``: run first, inside the profile, and left out. The profiler
    has lost a window's first device activities (every one of an eager
    epoch's first step before its first convolution, in each of three
    windows in a row); the lead-in takes that place, and only what lies
    between two marker kernels, launched after it and after ``fn``, is
    kept (``events`` is ``None`` where the trace lost a marker)."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if lead_in is not None:
            lead_in()
            hk.empty_launch(torch.device(DEVICE))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        if lead_in is not None:
            hk.empty_launch(torch.device(DEVICE))
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    spans = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    events = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                     str(e.get("cat", "")).lower(), e.get("name", "")) for e in spans
                    if str(e.get("cat", "")).lower() in DEVICE_CATEGORIES)
    runtime = [float(e["ts"]) for e in spans
               if str(e.get("cat", "")).lower() in RUNTIME_CATEGORIES]
    if lead_in is not None:
        marks = [k for k, e in enumerate(events) if MARKER in e[3]]
        if len(marks) != 2:
            return {"host_ms": host_ms, "events": None, "marks": len(marks),
                    "n_events": len(events),
                    "before_marks": [port_kernel_launches(events[:k]) for k in marks]}
        # fn's host calls come after the first marker ran, before the second
        runtime = [ts for ts in runtime if events[marks[0]][1] <= ts <= events[marks[1]][0]]
        events = events[marks[0] + 1:marks[1]]
    busy, start, end = 0.0, None, None
    for a, b, _, _ in events:
        if end is None or a > end:
            busy += 0.0 if end is None else end - start
            start, end = a, b
        else:
            end = max(end, b)
    busy += 0.0 if end is None else end - start
    by_name = {}
    for a, b, _, name in events:
        ms, count = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (b - a) / 1e3, count + 1)
    return {"host_ms": host_ms, "events": events, "busy_ms": busy / 1e3,
            "span_ms": (events[-1][1] - events[0][0]) / 1e3 if events else 0.0,
            "runtime": len(runtime),
            "rows": sorted(((ms, c, n) for n, (ms, c) in by_name.items()), reverse=True)}


def port_kernel_launches(events) -> tuple:
    """Launches of the port's kernels #1, #2, #3 among a trace's device
    activities, by kernel name (one kernel per counted launch; the split
    entry points and the empty marker kernel not included)."""
    seen = [0, 0, 0]
    for _, _, _, name in events:
        if "fast_augment" in name:
            seen[2] += 1
        elif "instance_norm_leaky_relu_backward" in name:
            seen[1] += 1
        elif "instance_norm_leaky_relu" in name and MARKER not in name:
            seen[0] += 1
    return tuple(seen)


def profile_step(engine, state, data, perm, gen, step_ms: float, bf16: bool = False) -> None:
    """Device time of one training step by kernel and by class
    (torch.profiler), and the device's busy share of the profiled window
    (the union of its activities over the host clock of the same window;
    ``step_ms`` is the unprofiled step, for reference); ``bf16``: the norm
    kernels that ran must be their bf16 builds, 25 forward and 25
    backward."""
    t = trace_window(lambda: engine.train_epoch(state, data, perm, gen))
    rows = t["rows"]
    total = sum(r[0] for r in rows)
    if total <= 0:
        check(not bf16, "bf16 step profile: the profiler saw no device time")
        log("  profile of one step: the profiler saw no device time (not measured)")
        return
    ours = {name: (ms, count) for ms, count, name in rows
            if "instance_norm_leaky_relu" in name or "fast_augment" in name}
    log(f"  profile of one training step: {total:.3f} ms device time, busy {t['busy_ms']:.3f} "
        f"ms of the profiled window's {t['host_ms']:.3f} ms on the host clock "
        f"({100 * t['busy_ms'] / t['host_ms']:.1f} %; unprofiled step {step_ms:.3f} ms), in "
        f"{len(t['events'])} device activities of {len(rows)} kernels ({t['runtime']} host CUDA "
        f"API calls); by kernel:")
    for ms, count, name in rows[:12]:
        log(f"    {ms:8.3f} ms {100 * ms / total:5.1f}%  x{count:<4d} {name[:100]}")
    for name, (ms, count) in ours.items():
        log(f"    port kernel {name[:60]}: {ms:.3f} ms x{count} ({100 * ms / total:.1f} %)")
    log_classes(rows, total, "    ")
    if bf16:
        norm = [(n, c) for _, c, n in rows if "instance_norm_leaky_relu" in n]
        fwd = sum(c for n, c in norm if "backward" not in n and "bfloat16" in n)
        bwd = sum(c for n, c in norm if "backward" in n and "bfloat16" in n)
        log(f"    bf16 builds of the norm kernels in the step: {fwd} forward, {bwd} backward "
            f"launches (of {sum(c for _, c in norm)} norm launches)")
        check(fwd == 25 and bwd == 25 and sum(c for _, c in norm) == 50,
              f"bf16 step: norm kernels {norm}, want the bf16 builds 25 + 25")


def profile_augmentation_path(engine, state, data, perm, gen, unpack: int = 0,
                              casts: int = 0, attempts: int = 3) -> None:
    """The launches of one training step from the augmentation to the
    model's first convolution, in the order the card ran them. Empty-kernel
    markers are launched just before and just after ``Engine._augmented_batch``
    and at the entry of the first convolution (a forward pre-hook); the
    profiler's device events between them are the augmentation path's
    launches and what runs between it and the convolution. At 128² f32 the
    path is one launch, the kernel (no cast, no copy), and nothing runs
    between it and the convolution; at bf16 (``unpack=1``) the kernel and one
    copy that unpacks the channel pairs, and between it and the convolution
    only the ``casts`` casts of the f32 parameters to their bf16 copies.

    The profiler loses the device activities of a window's first
    milliseconds (as :func:`trace_window` says), by an amount that varies
    over a process's life: on an H100, a window of 300 spin kernels a
    millisecond apart lost 0-2 of them early in a whole smoke run and 12-15
    after phase 6c's two minutes, and at 12 ms the loss took this step's
    markers and kernel in every attempt. So each attempt first runs
    :data:`LEAD_IN` spin kernels a millisecond apart inside the profile,
    which take that loss, and logs how many of them the record kept. A
    record without the three markers
    cannot place the path, so the step is profiled again, up to
    ``attempts`` times, each miss logged with what the record held. The
    first record that holds the three markers is checked; none in
    ``attempts`` fails the run.

    The step runs on an eager twin of ``engine`` (:func:`_eager_twin`): a
    replay of the captured step runs no Python, so no marker can be
    launched inside it; the twin's step is the body the capture recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk

    engine = _eager_twin(engine)

    armed, launched = [], []
    inner = engine._augmented_batch

    def marker() -> None:
        hk.empty_launch(engine.device)
        launched.append(True)

    def augmented_batch(*args):
        marker()
        out = inner(*args)
        marker()
        armed.append(True)
        return out

    def first_conv(_module, _args):
        if armed:
            armed.clear()
            marker()

    def lead_in() -> None:
        for _ in range(LEAD_IN):
            torch.cuda._sleep(1000)
            time.sleep(1e-3)
        torch.cuda.synchronize()

    hooks = [m.register_forward_pre_hook(first_conv) for m in engine.model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    engine._augmented_batch = augmented_batch
    misses = []
    try:
        for attempt in range(attempts):
            armed.clear()
            launched.clear()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                lead_in()
                engine.train_epoch(state, data, perm, gen)
                torch.cuda.synchronize()
            check(len(launched) == 3, f"augmentation path: {len(launched)} markers launched, "
                  "want 3 (one step must call the augmentation and a convolution once)")
            names = [e.name for e in sorted((e for e in prof.events()
                                             if e.device_type == DeviceType.CUDA),
                                            key=lambda e: e.time_range.start)]
            check(bool(names), "augmentation path: the profiler saw no device events")
            marks = [k for k, name in enumerate(names)
                     if "instance_norm_leaky_relu_empty" in name]
            kept = sum(SPIN in name for name in names)
            if len(marks) == 3:
                break
            kernels = [n for n in names if not n.startswith(("Memcpy", "Memset"))]
            misses.append(f"attempt {attempt}: {len(marks)} of 3 markers in {len(names)} device "
                          f"events ({len(kernels)} kernels, "
                          f"{sum('fast_augment' in n for n in names)} fast_augment, "
                          f"{kept} of the lead-in's {LEAD_IN})")
            log(f"  augmentation path profile: the record lacks markers, {misses[-1]}")
    finally:
        del engine._augmented_batch
        for h in hooks:
            h.remove()
    check(len(marks) == 3, f"augmentation path profile: {len(marks)} markers, want 3 "
          f"({'; '.join(misses)})")
    path, between = names[marks[0] + 1:marks[1]], names[marks[1] + 1:marks[2]]
    copies = [n for n in path + between if re.search(r"copy|cast|elementwise", n, re.I)]
    log(f"  augmentation path of one step (profile, attempt {len(misses)}; the record kept "
        f"{kept} of the lead-in's {LEAD_IN} launches): {len(path)} "
        f"launch(es) {[n[:60] for n in path]}; {len(between)} launch(es) between it and the "
        f"first convolution; {len(copies)} copies or casts")
    check(len(path) == 1 + unpack and "fast_augment" in path[0] and len(between) == casts
          and len(copies) == unpack + casts,
          f"the augmentation path at 128^2 must be the kernel and {unpack} unpacking "
          f"copies, with {casts} parameter casts before the first convolution")


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
        model = MTnnUNet()
        model.load_state_dict(init_weights)
        model = plain_twin(model) if plain else model
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
        model = MTnnUNet()
        model.load_state_dict(init_weights)
        model = plain_twin(model) if plain else model
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


BF16_LOSS_REL_TOL = 5e-2
# one bf16 forward against another (card against CPU, or the port against
# JAX in tests/test_torch_bf16.py): 5e-2 of the output scale
BF16_CROSS_REL_TOL = 5e-2


def _bf16_config():
    from multi_task_breast_cancer_tpu_torch.config import Config
    cfg = Config()
    cfg.training.compute_dtype = "bfloat16"
    return cfg


def phase_training_bf16(f32: dict) -> tuple:
    """The training main path in bf16 (``training.compute_dtype:
    bfloat16``, else ``Config()`` defaults): two epochs on phase 7's fold,
    launch counts, padding no-ops, the bf16 builds in a step's profile, the
    augmentation path (the kernel and one unpacking copy), ms per step at
    batch 2 and 64 beside phase 7's f32 numbers, and the step-0 loss and the
    forward against f32 and against the CPU. Returns the launches of its two
    epochs."""
    import numpy as np
    import torch
    from multi_task_breast_cancer_tpu_torch.models.registry import init_multitask_model
    from multi_task_breast_cancer_tpu_torch.ops.losses import check_finite_loss
    from multi_task_breast_cancer_tpu_torch.train.loop import (
        Engine, plan_epoch_indices, step_valid_mask)
    from multi_task_breast_cancer_tpu_torch.train.state import create_train_state

    cfg = _bf16_config()
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
    check(train["aug_packed"].shape[1] == 1, "bf16: [mask | image] must pack into one plane")
    step_valid = step_valid_mask(TRAIN_N, b, max_steps)
    host_rng = np.random.default_rng(cfg.training.seed)
    gen = torch.Generator().manual_seed(cfg.training.seed)
    log(f"training, bf16: {cfg.model.architecture} full width, batch {b}, compute_dtype "
        f"{cfg.training.compute_dtype}, fast augmentation on channel pairs (P = 1), "
        f"{real_steps} real + {PAD_STEPS} padding steps per epoch")

    # the main path: two epochs
    torch.cuda.synchronize()
    _reset_counts()
    epoch_s = []
    for epoch in range(2):
        t0 = time.perf_counter()
        perm = plan_epoch_indices(TRAIN_N, b, host_rng, pad_to_steps=max_steps)
        state, tm, vm = engine.train_and_eval_epoch(state, train, val, perm, gen, step_valid)
        check_finite_loss(tm["loss"])
        check_finite_loss(vm["loss"])
        epoch_s.append(time.perf_counter() - t0)
        log(f"  epoch {epoch}: {epoch_s[-1]:.3f} s; train loss {tm['loss']:.5f} (seg "
            f"{tm['seg_loss']:.5f}, cls {tm['cls_loss']:.5f}, dice {tm['dice']:.4f}); val loss "
            f"{vm['loss']:.5f} acc {vm['acc']:.3f}")
    fwd, bwd, aug = launches = _counts()
    steps = 2 * real_steps
    log(f"  launches over the two epochs: {fwd} norm forward, {bwd} norm backward, "
        f"{aug} augmentation, for {steps} real steps and 2 validation passes")
    check(fwd == 25 * (steps + 2) and bwd == 25 * steps and aug == steps,
          f"bf16 launch counts {launches}, want ({25 * (steps + 2)}, {25 * steps}, {steps})")
    check(all(p.dtype == torch.float32 for p in state.model.parameters()),
          "bf16: the master parameters must stay f32")

    before = _snapshot(state)
    _reset_counts()
    engine.train_epoch(state, train, plan_epoch_indices(TRAIN_N, b, host_rng)[:PAD_STEPS * b],
                       gen, np.zeros(PAD_STEPS, np.float32))
    check(_counts() == (0, 0, 0) and _same_state(before, _snapshot(state)),
          "bf16: padding steps changed the state or launched a kernel")
    log(f"  {PAD_STEPS} padding steps: no launch, state bit-identical")

    perm = plan_epoch_indices(TRAIN_N, b, host_rng)
    engine.train_epoch(state, train, perm, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.train_epoch(state, train, perm, gen)
    step_ms = (time.perf_counter() - t0) * 1e3 / real_steps
    log(f"  batch {b}, bf16: {step_ms:.3f} ms per training step = {b / step_ms * 1e3:.1f} "
        f"images/s; f32 in phase 7 of this run {f32['step_ms']:.3f} ms")
    profile_step(engine, state, train, perm[:b], gen, step_ms, bf16=True)
    profile_augmentation_path(engine, state, train, perm[:b], gen, unpack=1,
                              casts=len(list(engine.model.parameters())))
    del engine, state, train, val
    torch.cuda.empty_cache()
    ms_64 = train_step_ms_64(cfg)
    log(f"  batch {BATCH}: bf16 {ms_64:.3f} ms per step, f32 in phase 7 of this run "
        f"{f32['step_ms_64']:.3f} ms ({f32['step_ms_64'] / ms_64:.2f}x)")
    bf16_against_f32(init_weights, train_ds)
    return launches


def bf16_against_f32(init_weights, train_ds) -> None:
    """Step-0 loss of the bf16 Engine against the f32 Engine's on the same
    weights and batch; the bf16 forward on the card against the port's bf16
    forward on the CPU at batch 2, by the rule of ``tests/test_torch_bf16.py``:
    each bf16 forward is measured against its own device's f32 forward, the
    card's distance at most twice the CPU's or 1e-2 of the output scale, and
    card against CPU within ``BF16_CROSS_REL_TOL`` of it."""
    from multi_task_breast_cancer_tpu_torch.models.multitask import MTnnUNet
    from multi_task_breast_cancer_tpu_torch.train.loop import Engine
    from multi_task_breast_cancer_tpu_torch.train.state import create_train_state

    losses, outs = {}, {}
    images = train_ds.images[:2]
    for device in (DEVICE, "cpu"):
        for dtype in ("float32", "bfloat16"):
            cfg = _bf16_config()
            cfg.training.compute_dtype = dtype
            model = MTnnUNet()
            model.load_state_dict(init_weights)
            engine = Engine(model, _engine_config(cfg, use_transforms=False), device=device)
            state = create_train_state(engine.model, cfg.optimizer.opt, cfg.optimizer.lr)
            outs[device, dtype] = [t.cpu() for t in _flat(engine.predict(state, images))]
            if device == DEVICE:
                data = engine.device_data(train_ds)
                losses[dtype] = engine.train_epoch(state, data, [0, 1])[1]["loss"]
    rel = abs(losses["bfloat16"] - losses["float32"]) / abs(losses["float32"])
    log(f"  step-0 loss on the card: bf16 {losses['bfloat16']:.6f}, f32 "
        f"{losses['float32']:.6f}: {rel:.3g} relative (tol {BF16_LOSS_REL_TOL})")
    check(rel <= BF16_LOSS_REL_TOL, "bf16 step-0 loss against f32")
    d_card = _max_rel_err(outs[DEVICE, "bfloat16"], outs[DEVICE, "float32"])
    d_cpu = _max_rel_err(outs["cpu", "bfloat16"], outs["cpu", "float32"])
    d_cross = _max_rel_err(outs[DEVICE, "bfloat16"], outs["cpu", "bfloat16"])
    log(f"  bf16 forward, batch 2, against f32 on the same device: card {d_card:.3g}, CPU "
        f"{d_cpu:.3g} of the output scale; card against CPU {d_cross:.3g}")
    check(d_card <= max(2 * d_cpu, 1e-2) and d_cross <= BF16_CROSS_REL_TOL,
          "bf16 forward: card against CPU")


def phase_driver_bf16() -> tuple:
    """A short bf16 ``run_experiment`` at full width (CV 2, 1 epoch, 16
    images per class); returns its launches."""
    import tempfile
    import torch
    from multi_task_breast_cancer_tpu_torch.data.synthetic import make_preprocessed_busi
    from multi_task_breast_cancer_tpu_torch.train import driver as D

    tmp = tempfile.mkdtemp(prefix="mtbc_bf16_driver_")
    try:
        root = make_preprocessed_busi(os.path.join(tmp, "small"),
                                      n_per_class=DRIVER_SMALL_PER_CLASS, size=SIZE, seed=1)
        cfg = _driver_config(root, 2, 1, compute_dtype="bfloat16")
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        run = D.run_experiment(cfg, "multitask", "CV", run_root=os.path.join(tmp, "runs"),
                               device=DEVICE)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = _counts()
        _check_run_dir(run, "multitask", "CV", 2, 1)
        steps = sum(-(-tr // cfg.data.batch_size) for tr, _, _ in _fold_sizes(run))
        want = (25 * (steps + 2 * 2), 25 * steps, steps)
        for n in range(2):
            d = os.path.join(run, "fold_0" if n == 0 else "fold_1")
            (ckpt,) = [f for f in os.listdir(d) if f.startswith("model_")]
            payload = torch.load(os.path.join(d, ckpt), map_location="cpu", weights_only=False)
            check(all(v.dtype == torch.float32 for v in payload["model_state_dict"].values()),
                  "bf16 driver: a checkpoint holds other than f32 masters")
        log(f"driver, bf16: run_experiment ({DRIVER_SMALL_PER_CLASS} images per class, CV 2, "
            f"1 epoch, full widths) {run_s:.2f} s; launches {launches}, the fold sizes predict "
            f"{want}; checkpoints hold f32; metrics.csv {[_metric_rows(run, n)[1:] for n in range(2)]}")
        check(launches == want, f"bf16 driver launch counts {launches}, want {want}")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


EXPORT_BUCKETS = (1, 8, 64)
EXPORT_PLATFORMS = ("cpu", "cuda")
EXPORT_COUNTS = (1, 5, 64, 100)   # one image, a padded bucket, a full one, chunks + tail
# the bf16 artifact's card program against its CPU program: cuDNN's bf16
# convolutions and the CPU's round at other places, so 1e-4 of the scale
# cannot hold; an H100 read probabilities 2.1e-4 to 8.6e-4 apart and 48 to
# 63 of 16,384 mask pixels flipped at the threshold over four runs (PERF.md)
BF16_PROBS_ATOL, BF16_MASK_SHARE = 3e-3, 0.01


def _export_clis(jobs, ckpt: str, work: str) -> float:
    """``python -m ...serve export`` for each ``(cfg, out, postprocess)`` of
    ``jobs``, each in a process of its own, all started together, on the
    card by default (both program platforms); returns the seconds until the
    last one ended."""
    from multi_task_breast_cancer_tpu_torch.config import config_to_yaml
    t0, procs = time.perf_counter(), []
    try:
        for k, (cfg, out, postprocess) in enumerate(jobs):
            cfg_path = os.path.join(work, f"export_{k}.yaml")
            with open(cfg_path, "w") as f:
                f.write(config_to_yaml(cfg))
            cmd = [sys.executable, "-m", "multi_task_breast_cancer_tpu_torch.serve", "export",
                   "--config", cfg_path, "--task", "multitask", "--checkpoint", ckpt,
                   "--output", out, "--buckets", ",".join(map(str, EXPORT_BUCKETS)),
                   "--size", str(SIZE), "--platforms", ",".join(EXPORT_PLATFORMS)]
            cmd += ["--device-postprocess"] if postprocess else []
            procs.append(subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                                          stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                          text=True))
        for proc in procs:
            _, err = proc.communicate(timeout=900)
            check(proc.returncode == 0, f"serve export exited {proc.returncode}:\n{err[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    want = sorted([f"fwd_b{b}.{p}.pt2" for b in EXPORT_BUCKETS for p in EXPORT_PLATFORMS]
                  + ["manifest.json", "weights.npz"])
    for _, out, _ in jobs:
        names = sorted(os.listdir(out))
        check(names == want, f"artifact files {names}, want {want}")
    return time.perf_counter() - t0


def _median_ms(fn, reps: int) -> float:
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _start_server(artifact: str):
    """``serve run --artifact`` in a process of its own on a free local
    port; returns (process, port, start time)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "multi_task_breast_cancer_tpu_torch.serve", "run", "--artifact",
         artifact, "--host", "127.0.0.1", "--port", str(port), "--max-batch", str(BATCH)]
        + _device_args(),
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    return proc, port, time.perf_counter()


def _query_server(proc, port: int, started: float, planes) -> tuple:
    """Wait for the server's ``/healthz``, then ``/predict`` one raw plane
    and ``/predict_batch`` all of ``planes``: (record, batch answer, ms, ms,
    seconds from the process's start to its first health answer)."""
    base = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + 300
    while True:
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=5) as resp:
                health = json.loads(resp.read())
            break
        except OSError:
            if proc.poll() is not None:
                check(False, f"serve run exited {proc.returncode}: {proc.stderr.read()[-3000:]}")
            check(time.monotonic() < deadline, "serve run did not come up in 300 s")
            time.sleep(0.2)
    up_s = time.perf_counter() - started
    check(health["model"]["backend"] == "artifact" and DEVICE in health["model"]["device"],
          f"serve run: {health['model']}")
    one, one_ms = _post(base + "/predict", planes[0].tobytes(), {})
    many, many_ms = _post(base + "/predict_batch", planes.tobytes(),
                          {"X-Image-Count": str(len(planes))})
    return one, many, one_ms, many_ms, up_s


def _stop(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


def phase_export(ckpt: str, work: str) -> tuple:
    """``serve export`` and ``serve run --artifact`` on phase 7's
    checkpoint: an f32 raw artifact and a bf16 device-postprocessed one, each
    with programs for the CPU and the card at buckets 1, 8, 64. Returns the
    norm launches of the phase's in-process executions on the card, all and
    those of the bf16 programs."""
    from multi_task_breast_cancer_tpu_torch.config import Config

    arts = {"f32": os.path.join(work, "artifact_f32"), "bf16": os.path.join(work, "artifact_bf16")}
    export_s = _export_clis([(Config(), arts["f32"], False), (_bf16_config(), arts["bf16"], True)],
                            ckpt, work)
    server = _start_server(arts["bf16"])  # comes up while the checks below run
    try:
        launches = _export_checks(ckpt, work, arts, export_s, server)
    finally:
        _stop(server[0])
    return launches


def _export_checks(ckpt: str, work: str, arts: dict, export_s: float, server) -> tuple:
    import numpy as np
    import torch
    from multi_task_breast_cancer_tpu_torch.config import Config
    from multi_task_breast_cancer_tpu_torch.serve import export as E
    from multi_task_breast_cancer_tpu_torch.serve.post import postprocess, postprocess_compact
    from multi_task_breast_cancer_tpu_torch.serve.server import ArtifactBackend, CheckpointBackend

    for name, art in arts.items():
        program = torch.export.load(os.path.join(art, E.program_name(BATCH, DEVICE)))
        nodes = sum("mtbc_torch" in str(n.target) for n in program.graph.nodes
                    if n.op == "call_function")
        check(len(program.state_dict) == 0 and len(program.constants) == 0 and nodes == 25,
              f"{name} artifact: the program carries weights or lacks the norm nodes ({nodes})")
    log(f"export: serve export, f32 raw and bf16 --device-postprocess, a process each, "
        f"started together (buckets {EXPORT_BUCKETS}, {' and '.join(EXPORT_PLATFORMS)} "
        f"programs): {export_s:.1f} s; every program's state_dict empty, 25 norm nodes")

    images = np.random.default_rng(21).integers(0, 256, (max(EXPORT_COUNTS), SIZE, SIZE, 1),
                                                dtype=np.uint8)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    m32 = E.ExportedModel(arts["f32"], device=DEVICE)
    m32.preload()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m32.predict(images[:1])
    log(f"  f32 artifact: loaded (weights, {len(m32.buckets)} programs) in {load_s:.2f} s; "
        f"first execution {time.perf_counter() - t0:.2f} s")
    live32 = CheckpointBackend(Config(), "multitask", checkpoint=ckpt, max_batch=BATCH,
                               device=DEVICE)
    for n in EXPORT_COUNTS:
        before = _counts()[0]
        got = m32.predict(images[:n])
        launches = _counts()[0] - before
        runs = m32._plan(n)
        want = live32.predict(images[:n])
        err = _max_rel_err([torch.from_numpy(a) for a in _flat(got)],
                           [torch.from_numpy(a) for a in _flat(want)])
        same = all(np.array_equal(a, b) for a, b in zip(_flat(got), _flat(want)))
        log(f"  f32 artifact, {n} images: buckets {runs}, {launches} norm launches; against "
            f"CheckpointBackend's direct answer max err {err:.3g} of the output scale "
            f"({'bit-equal' if same else 'not bit-equal'})")
        check(launches == 25 * len(runs), f"export: {launches} launches for buckets {runs}")
        check(err <= SERVE_REL_TOL, "f32 artifact against the live backend")

    # the card's programs against the CPU programs of the same artifacts
    cpu32 = E.ExportedModel(arts["f32"], device="cpu")
    card, cpu = _flat(m32.predict(images[:1])), _flat(cpu32.predict(images[:1]))
    err32 = _max_rel_err([torch.from_numpy(a) for a in card], [torch.from_numpy(a) for a in cpu])
    m16 = E.ExportedModel(arts["bf16"], device=DEVICE)
    p16 = E.ExportedModel(arts["bf16"], device="cpu").predict(images[:1])
    before = _counts()[0]
    c16 = m16.predict(images[:1])
    perr16 = float(np.abs(c16["probs"] - p16["probs"]).max())
    k16 = int((c16["mask"] != p16["mask"]).sum())
    log(f"  card program against CPU program, 1 image: f32 max err {err32:.3g} of the output "
        f"scale (tol {MODEL_REL_TOL}); bf16 compact: probabilities {perr16:.3g} apart (tol "
        f"{BF16_PROBS_ATOL}), {k16} mask pixels differ (tol {BF16_MASK_SHARE:.0%})")
    check(err32 <= MODEL_REL_TOL, "f32 artifact: card program against CPU program")
    check(perr16 <= BF16_PROBS_ATOL and k16 <= BF16_MASK_SHARE * SIZE * SIZE,
          "bf16 artifact: card program against CPU program")

    # the compact answer against the host postprocessing of the same
    # program's raw outputs (a bf16 raw program of the same weights)
    raw_dir = os.path.join(work, "artifact_bf16_raw")
    E.export_inference(_bf16_config(), "multitask", ckpt, raw_dir, buckets=(BATCH,),
                       size=SIZE, platforms=(DEVICE,))
    built = _counts()[0]
    raw_model = E.ExportedModel(raw_dir, device=DEVICE)  # graphed: its warm-up run launches
    warm = _counts()[0] - built
    raw16 = raw_model.predict(images[:BATCH])
    compact16 = m16.predict(images[:BATCH])
    bf16_launches = _counts()[0] - before - warm
    check(bf16_launches == 3 * 25, f"bf16 programs: {bf16_launches} norm launches in 3 "
                                   f"bucket executions on the card")
    host = postprocess(raw16, "multitask", 3, True, False)
    dev = postprocess_compact(compact16, "multitask", 3, True)
    same = (np.array_equal(dev.masks, host.masks) and dev.pred_class == host.pred_class
            and np.array_equal(compact16["tumor_pixels"], host.masks.sum(axis=(1, 2))))
    log(f"  bf16 compact answer of {BATCH} images against host postprocess of the raw "
        f"program's outputs: masks, classes and pixel counts "
        f"{'equal' if same else 'DIFFER'}; probabilities "
        f"{float(np.abs(dev.probs - host.probs).max()):.3g} apart")
    check(same and np.allclose(dev.probs, host.probs, rtol=0, atol=1e-6),
          "bf16 compact answer against host postprocess")
    launches = _counts()[0], bf16_launches

    # serve run --artifact in a process of its own
    planes = images[:BATCH, ..., 0]
    one, many, one_ms, many_ms, up_s = _query_server(*server, planes)
    direct = ArtifactBackend(arts["bf16"], device=DEVICE)
    want = direct.postprocess(direct.predict(planes[..., None]))
    _check_records([one], direct.postprocess(direct.predict(planes[:1, ..., None])),
                   "serve run --artifact /predict")
    check(many["count"] == BATCH, f"/predict_batch count {many['count']}")
    _check_records(many["predictions"], want, "serve run --artifact /predict_batch")
    log(f"  serve run --artifact (bf16, device postprocess) in its own process: up (programs "
        f"loaded) {up_s:.1f} s after its start; first /predict {one_ms:.1f} ms, "
        f"/predict_batch of {BATCH} raw planes {many_ms:.1f} ms; records equal "
        f"ArtifactBackend's direct answer")

    # artifact against live backend, f32 and bf16: images/s and latency of
    # the backend's answer (predict + postprocess), and download bytes
    x64, x1 = images[:BATCH], images[:1]
    cfg16 = _bf16_config()
    backends = {"f32 artifact": ArtifactBackend(arts["f32"], device=DEVICE),
                "f32 live": live32,
                "bf16 artifact (device postprocess)": direct,
                "bf16 live": CheckpointBackend(cfg16, "multitask", checkpoint=ckpt,
                                               max_batch=BATCH, device=DEVICE)}
    for name, be in backends.items():
        batch_ms = _median_ms(lambda: be.postprocess(be.predict(x64)), 5)
        one_ms = _median_ms(lambda: be.postprocess(be.predict(x1)), 10)
        log(f"  {name}: {BATCH} images {batch_ms:.2f} ms = {BATCH / batch_ms * 1e3:.1f} "
            f"images/s; 1 image {one_ms:.2f} ms (host clock, upload to postprocessed answer)")
    raw = m32.predict(x64)
    raw_b = sum(a.nbytes for a in _flat(raw)) / BATCH
    compact_b = sum(compact16[k].nbytes for k in ("probs", "mask", "tumor_pixels")) / BATCH
    packed_b = compact_b - compact16["mask"].nbytes / BATCH * 7 / 8
    log(f"  download bytes per image: raw {raw_b:.0f}, compact {compact_b:.0f}, compact with "
        f"the mask bit-packed {packed_b:.0f}")
    del backends, m32, m16, cpu32, live32, direct
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 7f: graphs against eager
# ---------------------------------------------------------------------------

GRAPH_ARCHS = ("MTnnUNet", "ResidualUNet", "SwinUNETR")
# the batch-2 epochs of a case: 3 real steps and a padding step; then, the
# learning rate halved (the plateau scheduler's factor, set as the driver
# sets it), the step after the change alone; then 3 more: 8 steps, 7 real
GRAPH_EPOCHS = ((1, 1, 0, 1), (1,), (1, 1, 1))
GRAPH_EPOCHS_64 = ((1, 1, 1, 1),)       # batch 64: 4 real steps
GRAPH_N = {2: 16, BATCH: 4 * BATCH}      # fold sizes; the timed epochs take every row
GRAPH_BUCKETS = (1, 8, 64)


def _tree_leaves(out) -> list:
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _tree_leaves(out[k])]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tree_leaves(o)]
    return [out]


def _graph_model(arch: str, init=None):
    import torch
    from multi_task_breast_cancer_tpu_torch.models.registry import (init_multitask_model,
                                                                     init_segmentation_model)
    if arch == "MTnnUNet":
        model = init_multitask_model(arch, generator=torch.Generator().manual_seed(0))
    elif arch == "UMambaEnc":  # the published widths, no width knob
        model = init_segmentation_model(arch, size=SIZE, generator=torch.Generator().manual_seed(0))
    else:
        model = seg_zoo_model(arch)
    if init is not None:
        model.load_state_dict(init)
    return model


def _graph_run(arch: str, dtype: str, b: int, graphed: bool, init: dict, ds, epochs,
               lr_change: bool = True, capture: dict = None, mesh=None, **overrides) -> dict:
    """One Engine (graphed, or eager with ``cuda_graphs=False``) from
    ``init`` through ``epochs`` (each a tuple of step-valid flags) on ``ds``,
    the Adam of ``Config()``, the fast augmentation and dropout draws from
    seeded generators; the state after each epoch, the metrics, the
    launches and where the dropout generator ended. ``capture`` collects
    the capture's seconds and memory; ``mesh`` goes to the Engine,
    ``overrides`` to the ``EngineConfig``."""
    import numpy as np
    import torch
    from multi_task_breast_cancer_tpu_torch.config import Config
    from multi_task_breast_cancer_tpu_torch.train.loop import Engine
    from multi_task_breast_cancer_tpu_torch.train.optim import set_learning_rate
    from multi_task_breast_cancer_tpu_torch.train.state import create_train_state

    cfg = Config()
    cfg.training.compute_dtype = dtype
    task = "multitask" if arch == "MTnnUNet" else "segmentation"
    engine = Engine(_graph_model(arch, init),
                    _engine_config(cfg, task=task, batch_size=b, **overrides),
                    device=DEVICE, mesh=mesh, cuda_graphs=graphed)
    check(engine.graphed is graphed, f"{arch}: Engine.graphed is {engine.graphed}")
    state = create_train_state(engine.model, cfg.optimizer.opt, cfg.optimizer.lr)
    data = engine.device_data(ds)
    if capture is not None:
        inner = engine._capture_step

        def timed(*args):
            del engine._capture_step  # once, and no reference cycle through the Engine
            torch.cuda.synchronize()
            alloc = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out = inner(*args)
            torch.cuda.synchronize()
            capture.update(s=time.perf_counter() - t0,
                           mib=(torch.cuda.memory_allocated() - alloc) / 2 ** 20,
                           pool_mib=_graph_pool_mib(out.programs[0].graph.pool()))
            return out
        engine._capture_step = timed
    drop = torch.Generator(device=DEVICE).manual_seed(1)
    rng = np.random.default_rng(5)
    torch.cuda.synchronize()
    _reset_counts()
    metrics, snaps = [], []
    for e, valid in enumerate(epochs):
        perm = rng.permutation(len(ds))[:len(valid) * b]
        _, tm = engine.train_epoch(state, data, perm, torch.Generator().manual_seed(e),
                                   np.asarray(valid, np.float32), drop)
        metrics.append(tm)
        snaps.append(_snapshot(state))
        if e == 0 and lr_change:
            set_learning_rate(state.optimizer, cfg.optimizer.lr * cfg.optimizer.decrease_factor)
    torch.cuda.synchronize()
    return {"engine": engine, "state": state, "data": data, "metrics": metrics, "snaps": snaps,
            "counts": _counts(), "ln_counts": _ln_counts(), "ina_counts": _ina_counts(),
            "ss_counts": _ss_counts(), "drop": drop,
            "drop_state": drop.get_state()}


def _graph_pool_mib(pool):
    """MiB of the card's memory in the segments of the memory pool ``pool``
    (a graph's), from the allocator's snapshot; ``None`` where it does not
    say."""
    import torch
    segments = torch.cuda.memory_snapshot()
    if not segments or "segment_pool_id" not in segments[0]:
        return None
    return sum(s["total_size"] for s in segments
               if tuple(s["segment_pool_id"]) == tuple(pool)) / 2 ** 20


def _graph_vs_eager(what: str, g: dict, e: dict, want: tuple,
                    want_ln: tuple = (0, 0, 0), want_ina: tuple = (0, 0, 0),
                    want_ss: tuple = (0, 0, 0)) -> None:
    import torch
    check(g["metrics"] == e["metrics"], f"{what}: epoch metrics graphed {g['metrics']} "
                                        f"vs eager {e['metrics']}")
    for k, (a, b) in enumerate(zip(g["snaps"], e["snaps"])):
        check(_same_state(a, b), f"{what}: parameters, buffers or Adam's state after "
                                 f"epoch {k} differ, graphed vs eager")
    check(g["counts"] == e["counts"] == want,
          f"{what}: launches graphed {g['counts']}, eager {e['counts']}, want {want}")
    check(g["ln_counts"] == e["ln_counts"] == want_ln,
          f"{what}: LayerNorm launches graphed {g['ln_counts']}, eager {e['ln_counts']}, "
          f"want {want_ln}")
    check(g.get("ina_counts", (0, 0, 0)) == e.get("ina_counts", (0, 0, 0)) == want_ina,
          f"{what}: affine InstanceNorm launches graphed {g.get('ina_counts')}, eager "
          f"{e.get('ina_counts')}, want {want_ina}")
    check(g.get("ss_counts", (0, 0, 0)) == e.get("ss_counts", (0, 0, 0)) == want_ss,
          f"{what}: selective scan launches graphed {g.get('ss_counts')}, eager "
          f"{e.get('ss_counts')}, want {want_ss}")
    check(torch.equal(g["drop_state"], e["drop_state"]),
          f"{what}: the dropout generator ended elsewhere, graphed vs eager")


def _step_ms_in_turns(runs: dict, b: int) -> dict:
    """Host-clock ms per step of an epoch over every row of the fold, the
    graphed and the eager Engine in turns (graphed, eager, eager, graphed;
    medians)."""
    import numpy as np
    import torch
    times = {True: [], False: []}
    for graphed in (True, False, False, True):
        r = runs[graphed]
        n = r["data"]["images"].shape[0]
        perm = np.random.default_rng(9).permutation(n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r["engine"].train_epoch(r["state"], r["data"], perm, torch.Generator().manual_seed(9),
                                None, r["drop"])
        times[graphed].append((time.perf_counter() - t0) * 1e3 / (n // b))
    return {g: statistics.median(t) for g, t in times.items()}


def _busy_share(what: str, run: dict, b: int, attempts: int = 3) -> dict:
    """One epoch over the fold (every step real) in one profiled window
    (:func:`trace_window`): per step, the device's busy ms (the union of its
    activities), the summed activity ms, the host ms of the same window,
    the busy share, device activities and host CUDA API calls. The port's
    kernels in the trace must be the launches the counters added in the
    window, and a graphed Engine's must be its program's launches per
    replay times the steps. The same epoch runs once before it in the
    window, left out (:func:`trace_window`'s ``lead_in``). A trace that
    misses them is taken again, up to ``attempts`` times, each miss logged;
    none holding them fails."""
    import numpy as np
    import torch
    from multi_task_breast_cancer_tpu_torch.ops import fast_augment as FA
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk
    engine = run["engine"]
    n = run["data"]["images"].shape[0]
    steps = n // b
    want = None
    if engine.graphed:
        (program,) = engine._step_graph.programs
        per_replay = program.launches
        entries = (hk.instance_norm_leaky_relu, hk.instance_norm_leaky_relu_backward,
                   FA.fast_augment)
        check(set(per_replay) <= set(entries),
              f"{what}: the captured step counts launches of {sorted(f.__name__ for f in per_replay)}")
        want = tuple(steps * per_replay.get(f, 0) for f in entries)
    def epoch(seed):
        engine.train_epoch(run["state"], run["data"], np.arange(n),
                           torch.Generator().manual_seed(seed), None, run["drop"])

    for attempt in range(attempts):
        counted = []

        def measured():
            before = _counts()
            epoch(20 + attempt)
            counted.extend(x - y for x, y in zip(_counts(), before))

        t = trace_window(measured, lead_in=lambda: epoch(10 + attempt))
        counted = tuple(counted)
        if t["events"] is None:
            log(f"  {what} profile, attempt {attempt + 1}: {t['marks']} of the 2 markers in "
                f"the trace of {t['n_events']} device activities, #1/#2/#3 before each "
                f"{t['before_marks']} (the lead-in's and the window's epoch each launch "
                f"{counted or 'what the counters add'})")
            continue
        seen = port_kernel_launches(t["events"])
        if seen == counted and (want is None or counted == want):
            break
        log(f"  {what} profile, attempt {attempt + 1}: #1/#2/#3 kernels in the trace {seen}, "
            f"the counters added {counted}, the program's launches x {steps} replays {want}; "
            f"{len(t['events'])} device activities, the first "
            f"{[e[3][:40] for e in t['events'][:4]]}, the last "
            f"{[e[3][:40] for e in t['events'][-3:]]}")
    else:
        check(False, f"{what}: no profile of {attempts} held the launches the counters added")
    kinds = Counter(c for _, _, c, _ in t["events"])
    return {"device_ms": t["busy_ms"] / steps, "kernel_ms": sum(r[0] for r in t["rows"]) / steps,
            "host_ms": t["host_ms"] / steps, "busy": t["busy_ms"] / t["host_ms"],
            "events": len(t["events"]) / steps, "runtime": t["runtime"] / steps,
            "kinds": {k: v / steps for k, v in kinds.items()}, "port": [x / steps for x in seen],
            "names": Counter({name: c / steps for _, c, name in t["rows"]})}


def graphs_training_case(arch: str, card: str) -> dict:
    """7f training for one architecture: batch 2 f32 (graphed, eager, and
    graphed without the lr change), batch 2 bf16 and batch 64 f32 (graphed,
    eager); the checks of the phase and the readings."""
    import numpy as np
    import torch
    init = {k: v.clone() for k, v in _graph_model(arch).state_dict().items()}
    n_norm = 25 if arch == "MTnnUNet" else 0
    n_ln = 20 if arch == "SwinUNETR" else 0   # its LayerNorm sites a forward
    n_ina = 26 if arch == "SwinUNETR" else 0  # its affine InstanceNorm sites a forward
    out = {}
    for dtype, b, epochs in (("float32", 2, GRAPH_EPOCHS), ("bfloat16", 2, GRAPH_EPOCHS),
                             ("float32", BATCH, GRAPH_EPOCHS_64)):
        what = f"{arch} batch {b} {dtype}"
        ds = synthetic_fold(GRAPH_N[b], 30 + b)
        capture = {}
        runs = {True: _graph_run(arch, dtype, b, True, init, ds, epochs, capture=capture),
                False: _graph_run(arch, dtype, b, False, init, ds, epochs)}
        real = sum(sum(v) for v in epochs)
        _graph_vs_eager(what, runs[True], runs[False], (n_norm * real, n_norm * real, real),
                        (n_ln * real,) * 3, (n_ina * real,) * 3)
        g = runs[True]
        line = (f"  {what}: {sum(map(len, epochs))} steps ({real} real) graphed == eager: "
                f"losses and metrics, parameters, buffers, Adam's moments and step bit for bit "
                f"after every epoch; launches {g['counts']} both, LayerNorm {g['ln_counts']}, "
                f"affine InstanceNorm {g['ina_counts']}")
        if n_ln:
            # validation: the whole split in one batch, one forward of the model
            val = {}
            for g_, r in runs.items():
                _reset_counts()
                val[g_] = (r["engine"].eval_epoch(r["state"], r["data"]), _ln_counts(),
                           _ina_counts())
            mg, me = val[True][0], val[False][0]
            same = mg.keys() == me.keys() and all(   # NaN equals NaN here
                mg[k] == me[k] or (mg[k] != mg[k] and me[k] != me[k]) for k in mg)
            check(same and val[True][1:] == val[False][1:] == ((n_ln, 0, 0), (n_ina, 0, 0)),
                  f"{what}: validation graphed {val[True]}, eager {val[False]}, want the same "
                  f"metrics, LayerNorm launches {(n_ln, 0, 0)} and affine InstanceNorm "
                  f"launches {(n_ina, 0, 0)}")
            out.setdefault("layer_norm", {})[f"{dtype}_b{b}"] = {
                "per_step": [x // real for x in g["ln_counts"]],
                "per_validation": list(val[True][1])}
            out.setdefault("instance_norm_affine", {})[f"{dtype}_b{b}"] = {
                "per_step": [x // real for x in g["ina_counts"]],
                "per_validation": list(val[True][2])}
            line += (f", {val[True][1]} and {val[True][2]} in a validation pass, graphed == "
                     "eager")
        if b == 2 and dtype == "float32":
            # padding steps: an epoch of them replays nothing and moves nothing
            before = _snapshot(g["state"])
            _reset_counts()
            g["engine"].train_epoch(g["state"], g["data"], np.arange(2 * b),
                                    torch.Generator().manual_seed(7), np.zeros(2, np.float32),
                                    g["drop"])
            check(_counts() == _ln_counts() == _ina_counts() == (0, 0, 0)
                  and _same_state(before, _snapshot(g["state"])),
                  f"{what}: graphed padding steps changed the state or launched a kernel")
            # the lr change takes effect in the replays
            same_lr = _graph_run(arch, dtype, b, True, init, ds, epochs[:2], lr_change=False)
            check(_same_state(same_lr["snaps"][0], g["snaps"][0])
                  and not _same_state(same_lr["snaps"][1], g["snaps"][1]),
                  f"{what}: the step after the lr change equals a step without it")
            del same_lr
            line += ("; an epoch of padding steps replays nothing and leaves the state as it "
                     "was; the step after the lr change differs from the same step without it")
        if arch == "MTnnUNet" or b == 2:
            ms = _step_ms_in_turns(runs, b)
            busy = {g_: _busy_share(f"{what} {'graphed' if g_ else 'eager'}", runs[g_], b)
                    for g_ in (True, False)} if arch == "MTnnUNet" else {}
            row = {"graphed_ms": ms[True], "eager_ms": ms[False],
                   "capture_s": capture.get("s"), "capture_mib": capture.get("mib"),
                   "pool_mib": capture.get("pool_mib")}
            pool = capture["pool_mib"]
            line += (f"; host ms per step graphed {ms[True]:.3f}, eager {ms[False]:.3f} "
                     f"({ms[False] / ms[True]:.2f}x); capture {capture['s']:.3f} s, "
                     f"+{capture['mib']:.1f} MiB allocated, its pool "
                     f"{'not measured' if pool is None else f'{pool:.1f} MiB'}")
            for g_, r in busy.items():
                name = "graphed" if g_ else "eager"
                row.update({f"{name}_device_ms": r["device_ms"], f"{name}_busy": r["busy"],
                            f"{name}_profiled_host_ms": r["host_ms"]})
                line += (f"; {name} profile, per step of one window: the card busy "
                         f"{r['device_ms']:.3f} ms (activities summed {r['kernel_ms']:.3f}) of "
                         f"{r['host_ms']:.3f} ms on the host clock, {100 * r['busy']:.1f} %, in "
                         f"{r['events']:.1f} device activities ("
                         + ", ".join(f"{k} {v:.1f}" for k, v in sorted(r["kinds"].items()))
                         + f") and {r['runtime']:.1f} host CUDA API calls; #1/#2/#3 "
                         f"{'/'.join(f'{x:g}' for x in r['port'])} per step in the trace")
            if busy:
                diff = busy[False]["names"].copy()
                diff.subtract(busy[True]["names"])
                moved = sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:6]
                line += ("; activities per step, eager minus graphed: "
                         + (", ".join(f"{v:+g} {k[:60]}" for k, v in moved if v) or "none"))
            out[f"{dtype}_b{b}"] = row
        log(line + f" [{card}]")
        del runs, g
        gc.collect()
        torch.cuda.empty_cache()
    return out


def graphs_exact_hausdorff(card: str) -> None:
    """The exact augmentation (its per-step cosines and sines copied into
    the step's static buffers) and the Hausdorff criterion (distance fields
    computed inside the step) under a capture: UNet, batch 2, 4 real steps,
    graphed == eager."""
    import torch
    init = {k: v.clone() for k, v in _graph_model("UNet").state_dict().items()}
    ds = synthetic_fold(GRAPH_N[2], 32)
    runs = [_graph_run("UNet", "float32", 2, g, init, ds, ((1, 1, 1, 1),),
                       fast_augmentation=False, seg_criterion="Hausdorff") for g in (True, False)]
    _graph_vs_eager("UNet, exact augmentation, Hausdorff", *runs, (0, 0, 0))
    log(f"  UNet batch 2, exact augmentation and the Hausdorff criterion: 4 real steps graphed "
        f"== eager bit for bit (the capture saw no host sync) [{card}]")
    del runs
    torch.cuda.empty_cache()


def graphs_serving(artifacts: dict, card: str) -> dict:
    """7f serving: the live backend (one program per bucket 1, 8, 64) and
    the port's artifacts (f32 raw, bf16 with device postprocessing), each
    graphed against eager: answers bit for bit, 25 norm launches per bucket
    execution, a weight swap taking effect in the graph; ms per bucket
    execution (host clock, upload to download)."""
    import copy
    import numpy as np
    import torch
    from multi_task_breast_cancer_tpu_torch.models.jax_weights import flat_jax_weights
    from multi_task_breast_cancer_tpu_torch.models.registry import init_multitask_model
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk
    from multi_task_breast_cancer_tpu_torch.serve.export import ExportedModel
    from multi_task_breast_cancer_tpu_torch.serve.server import _TorchBackend

    images = np.random.default_rng(31).integers(0, 256, (max(GRAPH_BUCKETS), SIZE, SIZE, 1),
                                                dtype=np.uint8)
    other = init_multitask_model("MTnnUNet", generator=torch.Generator().manual_seed(9))
    swap_npz = os.path.join(os.path.dirname(artifacts["f32"]), "graphs_swap_weights.npz")
    np.savez(swap_npz, **flat_jax_weights(other.state_dict(), other))
    model = init_multitask_model("MTnnUNet", generator=torch.Generator().manual_seed(0))
    rows = {}

    def compare(what, pair, swap):
        times = {}
        for b in GRAPH_BUCKETS:
            x = images[:b]
            torch.cuda.synchronize()
            before = hk.instance_norm_leaky_relu.launches
            got = pair[True].predict(x)
            torch.cuda.synchronize()
            launched = hk.instance_norm_leaky_relu.launches - before
            want = pair[False].predict(x)
            check(launched == 25, f"{what}, bucket {b}: {launched} norm launches, want 25")
            check(all(np.array_equal(a, c) for a, c in zip(_tree_leaves(got), _tree_leaves(want))),
                  f"{what}, bucket {b}: graphed answer differs from eager")
            times[b] = {g: _median_ms(lambda: pair[g].predict(x), 10) for g in (True, False)}
        first = [a.copy() for a in _tree_leaves(pair[True].predict(images))]
        for be in pair.values():
            swap(be)
        got, want = pair[True].predict(images), pair[False].predict(images)
        check(all(np.array_equal(a, c) for a, c in zip(_tree_leaves(got), _tree_leaves(want)))
              and not all(np.array_equal(a, c) for a, c in zip(_tree_leaves(got), first)),
              f"{what}: after a weight swap the graphed answer is not the new weights'")
        log(f"  {what}: buckets {GRAPH_BUCKETS} graphed == eager bit for bit, 25 norm launches "
            f"per bucket execution, a weight swap answered with the new weights without a "
            f"capture; ms per bucket execution (host clock, upload to download) "
            + ", ".join(f"B={b} graphed {t[True]:.3f} eager {t[False]:.3f}"
                        for b, t in times.items()) + f" [{card}]")
        return {str(b): {"graphed_ms": t[True], "eager_ms": t[False]} for b, t in times.items()}

    torch.backends.cudnn.deterministic = True
    try:
        for dtype in ("float32", "bfloat16"):
            live = {g: _TorchBackend(copy.deepcopy(model), [torch.device(DEVICE)], dtype,
                                     GRAPH_BUCKETS, (1, SIZE, SIZE), cuda_graphs=g)
                    for g in (True, False)}
            check(live[True].graphed and not live[False].graphed, "live backend: graph rule")
            rows[f"live_{dtype}"] = compare(f"live backend, {dtype}", live,
                                            lambda be: be.load_weights(other.state_dict()))
            del live
        for name, art in artifacts.items():
            exported = {g: ExportedModel(art, device=DEVICE, cuda_graphs=g) for g in (True, False)}
            check(exported[True].graphed and len(exported[True]._graphs) == len(GRAPH_BUCKETS),
                  f"{name} artifact: not one graph per bucket")
            rows[f"artifact_{name}"] = compare(f"{name} artifact", exported,
                                               lambda be: be.load_weights(swap_npz))
            del exported
    finally:
        torch.backends.cudnn.deterministic = False
        torch.cuda.empty_cache()
    return rows


def phase_graphs(artifacts: dict = None) -> dict:
    """7f: the single-process training step graphed against eager for
    MTnnUNet, ResidualUNet and SwinUNETR at full width, and the serving
    backends' bucket graphs against eager (``artifacts``: 7b's f32 and bf16
    artifacts, else exported here); cuDNN deterministic, so that two eager
    runs agree bit for bit too. Returns the readings."""
    import tempfile
    import torch
    card = _card()
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    try:
        rows = {arch: graphs_training_case(arch, card) for arch in GRAPH_ARCHS}
        graphs_exact_hausdorff(card)
    finally:
        torch.backends.cudnn.deterministic = False
    tmp = None
    try:
        if artifacts is None:
            tmp = tempfile.mkdtemp(prefix="mtbc_graphs_")
            artifacts = _graph_artifacts(tmp)
        rows["serving"] = graphs_serving(artifacts, card)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    log(f"graphs: phase {time.perf_counter() - t0:.1f} s [{card}]")
    return rows


def _graph_artifacts(tmp: str) -> dict:
    """An f32 raw and a bf16 device-postprocessed artifact of the seeded
    MTnnUNet weights, cuda programs at ``GRAPH_BUCKETS`` (7f alone)."""
    from multi_task_breast_cancer_tpu_torch.config import Config
    from multi_task_breast_cancer_tpu_torch.serve import export as E
    arts = {"f32": os.path.join(tmp, "artifact_f32"), "bf16": os.path.join(tmp, "artifact_bf16")}
    for (name, out), cfg, post in zip(arts.items(), (Config(), _bf16_config()), (False, True)):
        E.export_inference(cfg, "multitask", None, out, buckets=GRAPH_BUCKETS, size=SIZE,
                           platforms=(DEVICE,), device_postprocess=post)
    return arts


def phase_graphs_alone() -> None:
    """7f by itself: build the kernels and run the graphs phase.
    ``python3 -c "import chip_smoke; chip_smoke.phase_graphs_alone()"`` from
    the repository root."""
    import torch
    from multi_task_breast_cancer_tpu_torch.ops import _build

    check(torch.cuda.is_available(), "CUDA is not available")
    log(f"{_card()}; torch {torch.__version__}, CUDA {torch.version.cuda}; kernels built in "
        f"{_build.build():.1f} s")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(json.dumps({"graphs": phase_graphs()}))


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
    """The JAX driver's run-dir layout and file contracts (a segmentation run
    writes no classification results, its checkpoints end in ``.tar`` and
    its loss plot lies in ``plots/``)."""
    from multi_task_breast_cancer_tpu_torch.train.driver import METRIC_HEADERS
    seg = task == "segmentation"
    for name in ("config.yaml", "execution.log", "model.txt", "results_segmentation.xlsx",
                 *(() if seg else ("classification_results.xlsx",))):
        check(os.path.isfile(os.path.join(run, name)), f"run dir: no {name}")
    for n in range(folds):
        d = os.path.join(run, f"fold_{n}")
        rows = _metric_rows(run, n)
        check(rows[0] == METRIC_HEADERS[(task, mode)] and len(rows) == 1 + epochs,
              f"fold {n} metrics.csv: {rows}")
        values = [float(v) for r in rows[1:] for v in r.split(",")]
        check(all(math.isfinite(v) for v in values), f"fold {n}: a loss or metric is not finite")
        suffix = f"_fold_{n}" + (".tar" if seg else "")
        ckpts = [f for f in os.listdir(d) if f.startswith("model_") and f.endswith(suffix)]
        check(len(ckpts) == 1, f"fold {n}: checkpoints {ckpts}")
        for name in ("results_segmentation.csv", ".fold_complete") + (
                ("plots/loss_evolution.png",) if seg else
                ("results_classification.csv", "loss_evolution.png")):
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

        # the test phase's forward, the eager validation inside the Engine's
        # epochs, and the run's bookkeeping, timed apart (the card
        # synchronised around each forward, so its device time counts there)
        spans = Counter()
        predict, evaluate, bookkeeping = LP.Engine.predict, LP.Engine._eval_metrics, {}

        def timed_predict(self, state, images, *args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = predict(self, state, images, *args, **kwargs)
            torch.cuda.synchronize()
            spans["forward_s"] += time.perf_counter() - t
            spans["forward_images"] += len(images)
            return out

        def timed_validation(self, state, data):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = evaluate(self, state, data)
            torch.cuda.synchronize()
            spans["validation_s"] += time.perf_counter() - t
            spans["validations"] += 1
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
        LP.Engine.predict, LP.Engine._eval_metrics = timed_predict, timed_validation
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
            LP.Engine.predict, LP.Engine._eval_metrics = predict, evaluate
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
        epochs = DRIVER_CV * DRIVER_EPOCHS
        check(spans["validations"] == epochs, f"{spans['validations']} validation passes in "
                                              f"{epochs} epochs")
        val_s = spans["validation_s"] / epochs
        log(f"  eager forwards beside the graphed step ({_card()}): validation (one forward "
            f"of a fold's {min(v for _, v, _ in sizes)}-{max(v for _, v, _ in sizes)} "
            f"validation images) {val_s:.3f} s an epoch = "
            f"{100 * val_s / t['engine']:.1f} % of the Engine's {t['engine']:.3f} s and "
            f"{100 * val_s / t['epoch']:.1f} % of the epoch's {t['epoch']:.3f} s; the test "
            f"phase's forward {spans['forward_s'] / DRIVER_CV:.3f} s a fold = "
            f"{100 * spans['forward_s'] / timer.totals['fold']:.1f} % of a fold's "
            f"{t['fold']:.2f} s (the test phase {100 * test_s / timer.totals['fold']:.1f} %)")
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


def phase_driver_resume(tmp, root, task: str = "multitask", arch: str = "") -> None:
    """A run killed after fold 0's first epoch and resumed with
    ``resume_dir`` ends with the uninterrupted run's metrics.csv rows, bit for
    bit as text (cuDNN deterministic; the kernels sum in a fixed order), and,
    for ``arch`` (the config's default without), with its checkpoints' bytes."""
    import torch
    from multi_task_breast_cancer_tpu_torch.train import driver as D

    def cfg():
        c = _driver_config(root, 2, 2, checkpoint_every_epoch=True)
        c.model.architecture = arch or c.model.architecture
        return c

    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    try:
        whole = D.run_experiment(cfg(), task, "CV", run_root=os.path.join(tmp, "whole"),
                                 device=DEVICE)
        real_profile = D.maybe_profile

        def kill(epoch, fold):
            if (fold, epoch) == (0, 1):
                raise RuntimeError("simulated kill after fold 0's first epoch")
            return real_profile(epoch, fold)

        D.maybe_profile = kill
        try:
            D.run_experiment(cfg(), task, "CV", run_root=os.path.join(tmp, "killed"),
                             device=DEVICE)
            check(False, "the simulated kill did not fire")
        except RuntimeError as e:
            check("simulated kill" in str(e), f"resume run failed: {e}")
        finally:
            D.maybe_profile = real_profile
        (killed,) = os.listdir(os.path.join(tmp, "killed"))
        killed = os.path.join(tmp, "killed", killed)
        check(len(_metric_rows(killed, 0)) == 2, "the killed run wrote more than epoch 0")
        resumed = D.run_experiment(cfg(), task, "CV", resume_dir=killed, device=DEVICE)
    finally:
        torch.backends.cudnn.deterministic = False
    diff, same = 0.0, True
    for n in range(2):
        a, b = _metric_rows(whole, n), _metric_rows(resumed, n)
        same = same and a == b
        for ra, rb in zip(a[1:], b[1:]):
            diff = max([diff] + [abs(float(x) - float(y))
                                 for x, y in zip(ra.split(","), rb.split(","))])
    ckpts = ""
    if arch:
        def ckpt_bytes(run):
            return [open(os.path.join(run, f"fold_{n}", f), "rb").read() for n in range(2)
                    for f in sorted(os.listdir(os.path.join(run, f"fold_{n}")))
                    if f.startswith("model_")]
        same_ckpts = ckpt_bytes(whole) == ckpt_bytes(resumed)
        ckpts = f"; checkpoints {'byte-identical' if same_ckpts else 'DIFFER'}"
        check(same_ckpts, "resumed checkpoints differ from the uninterrupted run's")
    log(f"driver resume ({arch or cfg().model.architecture}, {task}): killed after fold 0's "
        f"first epoch, resumed in place: metrics.csv rows of both folds "
        f"{'identical' if same else 'DIFFER'} to the uninterrupted run's (largest difference "
        f"{diff:.3g}; tolerance: identical text){ckpts}; three runs in "
        f"{time.perf_counter() - t0:.1f} s")
    check(same, "resumed metrics.csv rows differ from the uninterrupted run's")


def _mp_header(out: bytearray, n: int, small: int, fix: int, codes: tuple) -> None:
    """A msgpack length header: ``fix | n`` below ``small``, else the first
    of ``codes`` (8-, 16-, 32-bit lengths; None where the format has none)
    that holds ``n``."""
    if n < small:
        out.append(fix | n)
        return
    for code, fmt in zip(codes, "BHI"):
        if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(">" + fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _mp_pack(x, out: bytearray) -> None:
    """``x`` in the msgpack bytes that ``msgpack.packb(x, use_bin_type=True,
    default=flax's ext packer, strict_types=True)`` writes, for the types a
    checkpoint holds."""
    import numpy as np
    if x is None:
        out.append(0xC0)
    elif isinstance(x, (np.ndarray, np.generic)):
        # before the bool/int/float branches, as strict_types packs only
        # the exact Python types (np.float64 subclasses float): flax's ext
        # types, 1 an ndarray, 3 a numpy scalar; the payload is msgpack of
        # (shape, dtype name, C-order buffer)
        arr = np.asarray(x)
        payload = bytearray()
        _mp_pack((arr.shape, arr.dtype.name, arr.tobytes("C")), payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(len(payload))
        if fixext is not None:
            out.append(fixext)
        else:
            _mp_header(out, len(payload), 0, 0, (0xC7, 0xC8, 0xC9))
        out.append(1 if isinstance(x, np.ndarray) else 3)
        out += payload
    elif isinstance(x, bool):
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, int):
        if 0 <= x <= 0x7F or -32 <= x < 0:
            out += struct.pack(">b" if x < 0 else ">B", x)
        else:
            for code, fmt, lo, hi in ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF),
                                      (0xCE, ">I", 0, 0xFFFFFFFF), (0xCF, ">Q", 0, 2 ** 64 - 1),
                                      (0xD0, ">b", -0x80, -1), (0xD1, ">h", -0x8000, -1),
                                      (0xD2, ">i", -2 ** 31, -1), (0xD3, ">q", -2 ** 63, -1)):
                if lo <= x <= hi:
                    out.append(code)
                    out += struct.pack(fmt, x)
                    break
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        data = x.encode()
        _mp_header(out, len(data), 32, 0xA0, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(x, bytes):
        _mp_header(out, len(x), 0, 0, (0xC4, 0xC5, 0xC6))
        out += x
    elif isinstance(x, (list, tuple)):
        _mp_header(out, len(x), 16, 0x90, (None, 0xDC, 0xDD))
        for v in x:
            _mp_pack(v, out)
    elif isinstance(x, dict):
        _mp_header(out, len(x), 16, 0x80, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _mp_pack(k, out)
            _mp_pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(x).__name__}")


def flax_msgpack_bytes(state_dict: dict) -> bytes:
    """What ``flax.serialization.to_bytes`` writes for a state dict (nested
    dicts with str keys, numpy arrays, ints, floats): the JAX package's
    checkpoint format, written here because the card has no flax. Arrays
    over 2**30 bytes, which flax splits into chunks, are not written."""
    out = bytearray()
    _mp_pack(state_dict, out)
    return bytes(out)


SSIM_TOL = 1e-4
SSIM_SAMPLES = 64
# the curation the reference reports for BUSI (README.md:29-37): 5
# quadruplets, 22 triplets and 122 duplets among its images
SSIM_PLANTED = ((4, 5), (3, 22), (2, 122))


def _device_args() -> list:
    """The tools' command lines name no device on the card (``cuda`` is
    their default); a CPU rehearsal asks for the CPU."""
    return [] if DEVICE == "cuda" else ["--device", DEVICE]


def _ssim64(a, b) -> float:
    """Mean SSIM of two images in float64 numpy: 11×11 Gaussian window, σ
    1.5, 'valid' windows, L 255 (Wang et al.), written apart from the port."""
    import numpy as np
    from numpy.lib.stride_tricks import sliding_window_view
    g = np.exp(-((np.arange(11) - 5.0) ** 2) / (2 * 1.5 ** 2))
    k = np.outer(g, g) / g.sum() ** 2
    a, b = a.astype(np.float64), b.astype(np.float64)

    def filt(x):
        return np.einsum("ijkl,kl->ij", sliding_window_view(x, (11, 11)), k)

    mu_a, mu_b = filt(a), filt(b)
    var_a, var_b = filt(a * a) - mu_a ** 2, filt(b * b) - mu_b ** 2
    cov = filt(a * b) - mu_a * mu_b
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    return float(np.mean((2 * mu_a * mu_b + c1) * (2 * cov + c2)
                         / ((mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))))


def _timed_predict(spans: Counter):
    """``Engine.predict`` wrapped to add its device-synchronised seconds and
    calls to ``spans``; returns the original, to put back."""
    import torch
    from multi_task_breast_cancer_tpu_torch.train import loop as LP
    predict = LP.Engine.predict

    def timed(self, state, images, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = predict(self, state, images, *args, **kwargs)
        torch.cuda.synchronize()
        spans["forward_s"] += time.perf_counter() - t
        spans["forwards"] += 1
        return out

    LP.Engine.predict = timed
    return predict


def tools_preprocessing(tmp) -> str:
    """(a) ``preprocessing.main`` on a raw BUSI-style tree; returns the
    preprocessed tree."""
    import cv2
    import numpy as np
    import pandas as pd
    from multi_task_breast_cancer_tpu_torch import native
    from multi_task_breast_cancer_tpu_torch.data import preprocessing
    from multi_task_breast_cancer_tpu_torch.data.synthetic import make_raw_busi

    raw = make_raw_busi(os.path.join(tmp, "raw"), size=SIZE, seed=0, class_counts=DRIVER_COUNTS)
    out = os.path.join(tmp, "busi")
    t0 = time.perf_counter()
    mapping = preprocessing.main(["--input", str(raw), "--output", out, "--size", str(SIZE)]
                                 + _device_args())
    took = time.perf_counter() - t0
    on_disk = pd.read_csv(os.path.join(out, "mapping.csv"))
    check(len(mapping) == sum(DRIVER_COUNTS.values()) and on_disk.equals(mapping),
          f"preprocessing: mapping.csv ({len(on_disk)} rows) is not what was written")
    for row in on_disk.itertuples():
        stem = os.path.join(str(raw), row[3], f"{row[3]} ({row[4]})")
        mask = cv2.imread(f"{stem}_mask.png", 0)
        if os.path.isfile(f"{stem}_mask_1.png"):
            mask = native.add_saturate(mask, cv2.imread(f"{stem}_mask_1.png", 0))
        img = native.nearest_resize(cv2.imread(f"{stem}.png", 0), SIZE, SIZE)
        check(np.array_equal(cv2.imread(row.img_path, 0), img)
              and np.array_equal(cv2.imread(row.mask_path, 0),
                                 native.nearest_resize(mask, SIZE, SIZE)),
              f"preprocessing: {row.img_path} or its mask re-reads other than written")
        check(row.tumor_pixels == int((cv2.imread(row.mask_path, 0) == 255).sum()),
              f"preprocessing: tumor_pixels of {row.img_path}")
    log(f"tools (a): preprocessing.main, raw BUSI-style tree of {len(mapping)} images at "
        f"{SIZE}^2 {DRIVER_COUNTS} (multi-mask ids merged): {took:.2f} s; every PNG and "
        f"mapping.csv row re-read equal to what was written")
    return out


def tools_ssim(root) -> None:
    """(b) ``ssim.find_duplicates`` on the tree's images with duplicates
    planted as BUSI's (noisy copies)."""
    import cv2
    import numpy as np
    from multi_task_breast_cancer_tpu_torch.data import ssim

    files = sorted(os.listdir(os.path.join(root, "images")))
    images = np.stack([cv2.imread(os.path.join(root, "images", f), 0) for f in files]
                      ).astype(np.float32)
    rng = np.random.default_rng(0)
    order = iter(rng.permutation(len(images)).tolist())
    planted = []
    for size, count in SSIM_PLANTED:
        for _ in range(count):
            group = sorted(next(order) for _ in range(size))
            for i in group[1:]:
                images[i] = np.clip(images[group[0]] + rng.normal(0, 2, images[i].shape), 0, 255)
            planted.append(group)
    planted.sort(key=lambda g: (-len(g), g[0]))
    n = len(images)
    n_pairs = n * (n - 1) // 2

    ssim.ssim_pairwise(images[:8], np.array([[0, 1]]), device=DEVICE)  # warm-up: cuDNN plans
    ii, jj = np.triu_indices(n, k=1)
    pairs = np.stack([ii, jj], axis=1)
    t0 = time.perf_counter()
    vals = ssim.ssim_pairwise(images, pairs, device=DEVICE)
    sweep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    report = ssim.find_duplicates(images, device=DEVICE)
    total_s = time.perf_counter() - t0
    check(report.groups == planted,
          f"ssim: groups {report.group_size_histogram()} are not the planted "
          f"{ {s: c for s, c in SSIM_PLANTED} }")
    check(np.array_equal(report.ssim_matrix_pairs[:, 2].astype(np.float32), vals),
          "ssim: find_duplicates' values differ from ssim_pairwise's")
    within = [(g[0], g[-1]) for g in planted[:SSIM_SAMPLES // 2]]
    others = [tuple(sorted(rng.choice(n, 2, replace=False).tolist()))
              for _ in range(SSIM_SAMPLES - len(within))]
    index = {(int(i), int(j)): v for i, j, v in zip(ii, jj, vals)}
    err = max(abs(index[p] - _ssim64(images[p[0]], images[p[1]])) for p in within + others)
    log(f"tools (b): ssim.find_duplicates, {n} images at {SIZE}^2, {n_pairs} pairs, "
        f"{len(planted)} planted groups {report.group_size_histogram()}: found exactly; "
        f"pair sweep (ssim_pairwise) {sweep_s:.3f} s = {n_pairs / sweep_s:.0f} pairs/s; "
        f"find_duplicates with union-find {total_s:.3f} s = {n_pairs / total_s:.0f} pairs/s; "
        f"{SSIM_SAMPLES} sampled pairs vs float64 numpy: max error {err:.3g} (tol {SSIM_TOL})")
    check(err <= SSIM_TOL, f"ssim: {err} from the float64 SSIM")


def _forward(model, x):
    import torch
    with torch.inference_mode():
        return [t.cpu() for t in _flat(model.eval()(x))]


def tools_torch_import(tmp, cfg_path, x) -> str:
    """(c) ``torch_import.main`` on a reference-named ``state_dict`` of
    seeded tensors; returns the written checkpoint."""
    import torch
    from multi_task_breast_cancer_tpu_torch.config import load_config
    from multi_task_breast_cancer_tpu_torch.models import torch_import
    from multi_task_breast_cancer_tpu_torch.models.registry import init_multitask_model
    from multi_task_breast_cancer_tpu_torch.train.driver import build_inference_state

    model = init_multitask_model("MTnnUNet", generator=torch.Generator().manual_seed(1))
    sd = model.state_dict()
    ref = {r: sd[p] for p, r in torch_import._MAPPERS["MTnnUNet"]()}
    ref_path, out = os.path.join(tmp, "reference_fold_0"), os.path.join(tmp, "imported_fold_0")
    torch.save({"epoch": 11, "val_loss": 0.25, "model_state_dict": ref}, ref_path)
    t0 = time.perf_counter()
    torch_import.main(["--config", cfg_path, "--torch-checkpoint", ref_path, "--out", out]
                      + _device_args())
    took = time.perf_counter() - t0
    state, _ = build_inference_state(load_config(cfg_path), "multitask", checkpoint=out,
                                     device=DEVICE)
    got, want = _forward(state.model, x), _forward(model.to(DEVICE), x)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    log(f"tools (c): torch_import.main, a reference-named MTnnUNet state_dict "
        f"({len(ref)} tensors, seeded): {took:.2f} s; the checkpoint's forward on "
        f"{x.shape[0]} images {'equals' if same else 'DIFFERS from'} the model with those "
        f"tensors set directly (tolerance 0: same card, same code)")
    check(same, "torch_import: the converted checkpoint's forward differs")
    return out


def tools_msgpack(tmp, cfg_path, x) -> str:
    """(d) A flax-msgpack checkpoint written by :func:`flax_msgpack_bytes`,
    with the full-width seeded weights and Adam state, decoded by the port;
    returns its path."""
    import numpy as np
    import torch
    from multi_task_breast_cancer_tpu_torch.config import load_config
    from multi_task_breast_cancer_tpu_torch.models.jax_weights import (
        params_from_jax, params_to_jax)
    from multi_task_breast_cancer_tpu_torch.models.registry import init_multitask_model
    from multi_task_breast_cancer_tpu_torch.train.checkpoint import restore_checkpoint
    from multi_task_breast_cancer_tpu_torch.train.driver import build_inference_state

    seeded = init_multitask_model("MTnnUNet", generator=torch.Generator().manual_seed(2))
    params = params_to_jax(seeded.state_dict(), seeded)
    rng = np.random.default_rng(2)

    def moments(tree, square):
        return {k: moments(v, square) if isinstance(v, dict) else
                (rng.standard_normal(v.shape).astype(np.float32) ** (2 if square else 1))
                for k, v in tree.items()}

    mu, nu = moments(params, False), moments(params, True)
    scalar = lambda v, dt: np.asarray(v, dt)  # noqa: E731
    opt = {"count": scalar(7, np.int32),
           "hyperparams": {k: scalar(v, np.float32) for k, v in
                           (("learning_rate", 1e-4), ("b1", 0.9), ("b2", 0.999),
                            ("eps", 1e-4), ("eps_root", 0.0))},
           "hyperparams_states": {},
           "inner_state": {"0": {"count": scalar(7, np.int32), "mu": mu, "nu": nu}, "1": {}}}
    resume = {"valid": 1.0, "sched_lr": 1e-4, "sched_best": 0.5, "sched_bad": 0.0,
              "sched_epoch": 0.0, "patience": 0.0, "best_val_loss": 0.5}
    payload = {"epoch": 6, "model_state_dict": {"params": params, "batch_stats": {}},
               "optimizer_state_dict": opt, "val_loss": 0.5, "step": scalar(7, np.int32),
               "resume_state": resume}
    path = os.path.join(tmp, "jax_fold_0")
    t0 = time.perf_counter()
    data = flax_msgpack_bytes(payload)
    with open(path, "wb") as f:
        f.write(data)
    write_s = time.perf_counter() - t0
    def flat(prefix, node):  # a serving artifact's weights.npz keys
        for k, v in node.items():
            yield from flat(f"{prefix}/{k}", v) if isinstance(v, dict) else [(f"{prefix}/{k}", v)]

    npz = os.path.join(tmp, "weights.npz")
    np.savez(npz, **dict(flat("params", params)))

    cfg = load_config(cfg_path)
    t0 = time.perf_counter()
    state, epoch, val_loss, rs = restore_checkpoint(
        build_inference_state(cfg, "multitask", device=DEVICE)[0], path)
    read_s = time.perf_counter() - t0
    want_mu = params_from_jax(mu, state.model)
    adam = [state.optimizer.state[p] for p in state.model.parameters()]
    names = [n for n, _ in state.model.named_parameters()]
    check((epoch, val_loss, state.step, rs) == (6, 0.5, 7, resume)
          and all(float(s["step"]) == 7 and torch.equal(s["exp_avg"].cpu(), want_mu[n])
                  for s, n in zip(adam, names))
          and state.optimizer.param_groups[0]["lr"] == float(np.float32(1e-4)),
          "msgpack: Adam's state, the counters or the epoch came back other than written")
    model, _ = build_inference_state(cfg, "multitask", checkpoint=path, device=DEVICE)
    npz_model = init_multitask_model("MTnnUNet")
    with np.load(npz) as z:
        npz_model.load_state_dict(params_from_jax({k: z[k] for k in z.files}, npz_model),
                                  strict=True)
    got, want = _forward(model.model, x), _forward(npz_model.to(DEVICE), x)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    import importlib.util
    msgpack = "present" if importlib.util.find_spec("msgpack") else "absent"
    log(f"tools (d): flax-msgpack checkpoint (this script's writer of flax's layout, the "
        f"full-width weights and Adam mu/nu/count; msgpack on this machine: {msgpack}, "
        f"unused): {len(data) / 2 ** 20:.1f} MiB written in "
        f"{write_s:.2f} s, restored with Adam's state in {read_s:.2f} s; forward on "
        f"{x.shape[0]} images {'equals' if same else 'DIFFERS from'} the weights.npz path "
        f"through params_from_jax (tolerance 0)")
    check(same, "msgpack: the decoded weights' forward differs from weights.npz's")
    return path


def tools_predict(tmp, cfg_path, root, ckpt) -> int:
    """(e) ``predict.main`` over the tree's 450 PNGs with the flax-msgpack
    checkpoint; returns its norm launches."""
    import numpy as np
    import torch
    from multi_task_breast_cancer_tpu_torch.config import load_config
    from multi_task_breast_cancer_tpu_torch import predict
    from multi_task_breast_cancer_tpu_torch.serve.post import model_applies_softmax, postprocess
    from multi_task_breast_cancer_tpu_torch.train.driver import build_inference_state
    from multi_task_breast_cancer_tpu_torch.train.inference import to_host
    from multi_task_breast_cancer_tpu_torch.train.loop import Engine, EngineConfig

    folder, out = os.path.join(root, "images"), os.path.join(tmp, "predictions")
    spans = Counter()
    real = _timed_predict(spans)
    try:
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        predict.main(["--config", cfg_path, "--checkpoint", ckpt, "--images", folder,
                      "--output", out, "--size", str(SIZE)] + _device_args())
        total_s = time.perf_counter() - t0
        fwd = _counts()[0]
    finally:
        from multi_task_breast_cancer_tpu_torch.train import loop as LP
        LP.Engine.predict = real
    with open(os.path.join(out, "predictions.json")) as f:
        records = json.load(f)
    n = len(records)
    check(fwd == 25 * spans["forwards"] == 25,
          f"predict: {fwd} norm launches in {spans['forwards']} forwards, want 25 in one")

    cfg = load_config(cfg_path)
    images, paths = predict.load_images(folder, SIZE)
    state, _ = build_inference_state(cfg, "multitask", checkpoint=ckpt, device=DEVICE)
    engine = Engine(state.model, EngineConfig(task="multitask", n_classes=3,
                                              batch_size=cfg.data.batch_size), device=DEVICE)
    pred = postprocess(to_host(engine.predict(state, images)), "multitask", 3,
                       cfg.training.overlap_class_based_on_seg,
                       model_applies_softmax("multitask", "MTnnUNet", 3))
    direct = json.loads(json.dumps([{"image": p.name, **pred.record(i)}
                                    for i, p in enumerate(paths)]))
    masks = len(os.listdir(os.path.join(out, "segs")))
    log(f"tools (e): predict.main, {n} raw {SIZE}^2 PNGs, the flax-msgpack checkpoint, "
        f"full width: {total_s:.3f} s in all = {n / total_s:.1f} images/s (PNG reads, forward, "
        f"postprocess, {masks} mask PNGs, JSON); the forward {spans['forward_s'] * 1e3:.2f} ms = "
        f"{n / spans['forward_s']:.1f} images/s; {fwd} norm launches; predictions.json "
        f"{'equals' if records == direct else 'DIFFERS from'} Engine.predict + postprocess "
        f"called directly")
    check(n == len(paths) == masks and records == direct and np.isfinite(
        [p for r in records for p in r["probs"]]).all(), "predict: predictions.json")
    return fwd


def tools_evaluate(tmp, cfg_path, root, ckpt) -> int:
    """(f) ``evaluate.main`` over the tree as a UCLM-style set, with the
    imported checkpoint; returns its norm launches."""
    import pandas as pd
    import torch
    from multi_task_breast_cancer_tpu_torch import evaluate

    out = os.path.join(tmp, "evaluation")
    spans = Counter()
    real = _timed_predict(spans)
    try:
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        evaluate.main(["--config", cfg_path, "--checkpoint", ckpt, "--data", root,
                       "--output", out] + _device_args())
        total_s = time.perf_counter() - t0
        fwd = _counts()[0]
    finally:
        from multi_task_breast_cancer_tpu_torch.train import loop as LP
        LP.Engine.predict = real
    seg = pd.read_csv(os.path.join(out, "results_segmentation.csv"))
    cls = pd.read_csv(os.path.join(out, "results_classification.csv"))
    n = sum(DRIVER_COUNTS.values())
    check(len(seg) == len(cls) == n == len(os.listdir(os.path.join(out, "segs")))
          and bool(os.listdir(os.path.join(out, "features_map"))),
          f"evaluate: {len(seg)} / {len(cls)} result rows, want {n}")
    check(fwd == 25 * spans["forwards"] > 0,
          f"evaluate: {fwd} norm launches in {spans['forwards']} forwards")
    host_s = total_s - spans["forward_s"]
    log(f"tools (f): evaluate.main, a UCLM-style set of {n} images at {SIZE}^2, the imported "
        f"checkpoint: {total_s:.3f} s = {total_s * 1e3 / n:.3f} ms per image: forward "
        f"{spans['forward_s'] * 1e3 / n:.3f} ms ({spans['forwards']} forward, {fwd} norm "
        f"launches), host (checkpoint reads, metrics, PNGs, CSVs) {host_s * 1e3 / n:.3f} ms "
        f"per image")
    return fwd


def tools_holdout(root) -> None:
    """(g) ``holdout_check.main`` on the tree's mapping.csv: the fold sizes
    it prints are ``data/splits.py``'s."""
    import contextlib
    import io
    import pandas as pd
    from multi_task_breast_cancer_tpu_torch.data import holdout_check
    from multi_task_breast_cancer_tpu_torch.data.splits import stratified_cv_splits

    mapping = os.path.join(root, "mapping.csv")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        holdout_check.main(["--mapping", mapping] + _device_args())
    sizes, fold = [], -1
    for line in buf.getvalue().splitlines():
        m = re.match(r"--- fold (\d+) ---", line)
        if m:
            fold = int(m.group(1))
        m = re.match(r"(train|val|test): n=(\d+) ", line)
        if m:
            sizes.append((fold, m.group(1), int(m.group(2))))
    want = [(n, name, len(df)) for n, f in enumerate(
        stratified_cv_splits(pd.read_csv(mapping), 1993, 4, oversampling=True))
        for name, df in f.items()]
    log(f"tools (g): holdout_check.main on the tree's mapping.csv (seed 1993, 4 folds): "
        f"(fold, split, size) {sizes}; data/splits.py gives "
        f"{'the same' if sizes == want else want}")
    check(sizes == want, "holdout_check: fold sizes differ from data/splits.py")


def phase_tools() -> int:
    """The command-line tools at the ``Config()`` defaults, on the card by
    default; returns the norm launches of ``predict`` and ``evaluate``."""
    import tempfile
    import torch
    from multi_task_breast_cancer_tpu_torch.config import Config, config_to_yaml

    tmp = tempfile.mkdtemp(prefix="mtbc_tools_")
    try:
        t0 = time.perf_counter()
        root = tools_preprocessing(tmp)
        tools_ssim(root)
        cfg = Config()
        cfg.data.input_img = root
        cfg_path = os.path.join(tmp, "config.yaml")
        with open(cfg_path, "w") as f:
            f.write(config_to_yaml(cfg))
        gen = torch.Generator().manual_seed(3)
        x = (torch.rand(8, 1, SIZE, SIZE, generator=gen) * 255).to(DEVICE)
        imported = tools_torch_import(tmp, cfg_path, x)
        jax_file = tools_msgpack(tmp, cfg_path, x)
        launches = tools_predict(tmp, cfg_path, root, jax_file)
        launches += tools_evaluate(tmp, cfg_path, root, imported)
        tools_holdout(root)
        log(f"tools: phase {time.perf_counter() - t0:.1f} s")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()

# ---------------------------------------------------------------------------
# the zoo: the BTS family, the UNet++ family and Adityan
# ---------------------------------------------------------------------------

ZOO_BATCHES = (2, BATCH)
ZOO_TRAINED = ("Multi_BTSUNet", "MTUNetPlusPlus")
ZOO_TRAIN_N, ZOO_VAL_N = 8, 4               # 4 real steps and 1 padding step at batch 2
ZOO_DRIVER_PER_CLASS, ZOO_DRIVER_EPOCHS = 32, 2


def _zoo_task(arch: str) -> str:
    from multi_task_breast_cancer_tpu_torch.models import registry as R
    return next(t for t, archs in (("segmentation", R.SEGMENTATION_ARCHS),
                                   ("classification", R.CLASSIFICATION_ARCHS),
                                   ("multitask", R.MULTITASK_ARCHS)) if arch in archs)


def zoo_model(arch: str):
    """The registry's model at full width (``model.width`` 24 and
    ``deep_supervision: True``, the config's defaults, where the architecture
    takes them; 128²), its weights drawn from generator seed 0, on the CPU."""
    import torch
    from multi_task_breast_cancer_tpu_torch.models import registry as R
    task = _zoo_task(arch)
    kw = {} if task == "classification" or arch == "Adityan" else {"deep_supervision": True}
    return getattr(R, f"init_{task}_model")(arch, width=24, generator=torch.Generator()
                                            .manual_seed(0), **kw)


def _leaves(out) -> list:
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    return [out]


def zoo_forwards() -> dict:
    """Each architecture at full width: its parameter count, the norm
    kernel's launches per forward at batches 2 and 64 and the backward
    kernel's per batch-2 backward, the forward against the plain-norm model
    on the card (batch 64) and the plain model on the CPU (batch 2), and its
    device time at batch 64. Returns the launches counted on the card:
    architecture → (per batch-64 forward, per batch-2 backward)."""
    import torch
    from multi_task_breast_cancer_tpu_torch.models.registry import count_parameters
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk

    g = torch.Generator().manual_seed(5)
    x = (torch.rand(BATCH, 1, SIZE, SIZE, generator=g) * 255).round()
    counted = {}
    for arch, params in ZOO_PARAMETERS.items():
        model = zoo_model(arch).eval()
        n = count_parameters(model)
        check(n == params, f"{arch}: {n} parameters, JAX counts {params}")
        with torch.inference_mode():
            cpu = _leaves(plain_twin(model)(x[:2]))
        # moved outside inference mode: the backward below needs its parameters
        model, xd = model.to(DEVICE), x.to(DEVICE)
        with torch.inference_mode():
            for b in ZOO_BATCHES:
                hk.instance_norm_leaky_relu.launches = 0
                out = _leaves(model(xd[:b]))
                torch.cuda.synchronize()
                launches = hk.instance_norm_leaky_relu.launches
                check(launches == ZOO_NORMS[arch],
                      f"{arch}: {launches} norm launches in a batch-{b} forward, "
                      f"want {ZOO_NORMS[arch]}")
            err_cpu = _max_rel_err([t[:2] for t in out], cpu)
            check(err_cpu <= MODEL_REL_TOL, f"{arch}: card vs CPU, max err {err_cpu:.3g}")
            fwd_ms = time_ms(lambda: model(xd), reps=5)
            plain_text = "no fused norm: the model is its plain twin"
            if ZOO_NORMS[arch]:
                plain = plain_twin(model)
                err = _max_rel_err(out, _leaves(plain(xd)))
                check(err <= MODEL_REL_TOL, f"{arch}: kernel vs plain norm, max err {err:.3g}")
                plain_text = (f"plain-norm model: err {err:.3g}, "
                              f"{time_ms(lambda: plain(xd), reps=5):.3f} ms")
                del plain
        hk.instance_norm_leaky_relu_backward.launches = 0
        sum(t.sum() for t in _leaves(model(xd[:2]))).backward()
        torch.cuda.synchronize()
        counted[arch] = (launches, hk.instance_norm_leaky_relu_backward.launches)
        check(counted[arch][1] == ZOO_NORMS[arch],
              f"{arch}: {counted[arch][1]} backward norm launches in a batch-2 backward, "
              f"want {ZOO_NORMS[arch]}")
        log(f"  {arch:22s} {n:>10,d} params, {ZOO_NORMS[arch]:2d} norm launches per forward "
            f"and per backward; card vs CPU err {err_cpu:.3g}; forward at {BATCH}: "
            f"{fwd_ms:.3f} ms = {BATCH / fwd_ms * 1e3:.1f} images/s; {plain_text}")
        del model, out
        torch.cuda.empty_cache()
    return counted


def zoo_kernels(counted: dict) -> dict:
    """Kernels #1 and #2 at every norm site shape of the BTS family that the
    flagship does not give them, batches 2 and 64, f32 and bf16; then each
    BTS architecture's row per forward (#1, batch 64) and per backward (#2,
    batch 2), f32: ``launches`` as ``zoo_forwards`` counted them on the card
    (``counted``), ``sites`` its norm sites, and ``sites_ms`` (with the
    bound's, the plain version's and the library call's) the sum over its
    sites of each site shape's time measured alone."""
    import torch
    from multi_task_breast_cancer_tpu_torch.models.registry import init_multitask_model

    flagship = norm_shapes(init_multitask_model("MTnnUNet"), "cpu")
    sites = {a: norm_shapes(zoo_model(a), "cpu") for a, n in ZOO_NORMS.items() if n}
    new = Counter()
    for counts in sites.values():
        new.update(s for s in counts if s not in flagship)
    new = Counter(dict.fromkeys(new, 1))
    log(f"zoo: {len(new)} norm site shapes the flagship does not give the kernels: "
        f"{sorted(new)}")
    fwd, bwd = {}, {}
    phase_kernel(new, batches=ZOO_BATCHES, extras=False, per_shape=fwd)
    phase_backward_kernel(new, extras=False, per_shape=bwd)
    rows = {}
    for arch, counts in sites.items():
        rows[arch] = {}
        for i, (name, table, b) in enumerate((("forward", fwd, BATCH), ("backward", bwd, 2))):
            tot = {f"sites_{k}": sum(n * table[b, torch.float32, s][k] for s, n in counts.items())
                   for k in ("ms", "bound_ms", "plain_ms", "library_ms")}
            rows[arch][name] = {"batch": b, "launches": counted[arch][i],
                                "sites": sum(counts.values()), **tot}
            log(f"  {arch:18s} #{i + 1} f32 at batch {b}, {counted[arch][i]} launches counted, "
                f"{sum(counts.values())} sites; summed over the sites: kernel "
                f"{tot['sites_ms']:.4f} ms, bound {tot['sites_bound_ms']:.4f} ms "
                f"({100 * tot['sites_bound_ms'] / tot['sites_ms']:.0f} %), plain "
                f"{tot['sites_plain_ms']:.4f} ms, library {tot['sites_library_ms']:.4f} ms")
    return rows


def step0_gradients(arch: str, cfg, init: dict, train_ds, runs) -> dict:
    """The step-0 loss's gradient of the model ``init`` on the first batch
    of ``train_ds``, for each ``(name, device, dtype, plain)`` of ``runs``:
    name → parameter name → the gradient in f64 on the host."""
    import torch
    from multi_task_breast_cancer_tpu_torch.train.loop import Engine

    grads = {}
    for name, device, dtype, plain in runs:
        model = zoo_model(arch)
        model.load_state_dict(init)
        model = (plain_twin(model) if plain else model).to(device, dtype)
        engine = Engine(model, _engine_config(cfg, use_transforms=False), device=device)
        data = engine.device_data(train_ds)
        rows = torch.arange(cfg.data.batch_size, device=device)
        x, m, t = (data[k].index_select(0, rows).to(dtype)
                   for k in ("images", "masks", "cls_targets"))
        loss, _ = engine._losses(model(engine._nchw(x)), m, t)
        loss.backward()
        grads[name] = {k: p.grad.double().cpu() for k, p in model.named_parameters()
                       if p.grad is not None}
        del model, engine, data
    return grads


def zoo_gradients(arch: str, cfg, init: dict, train_ds) -> None:
    """Step-0 gradients of the model on the card against a float64 gradient
    (the plain model in f64 on the card), tensor by tensor, each at its own
    scale, beside the CPU's f32 gradient; cuDNN deterministic, as in phase 7.
    A tensor whose f64 gradient is zero but for rounding (at most
    ``ZERO_GRAD_REL`` of the model's largest: a conv bias before an instance
    norm) has no scale to hold it to and is left out, by name in the log.
    With fused norms, phase 7's rule: at most 1e-4 of the tensor's scale or
    twice the plain-norm model's distance on the card (the same sums, so the
    kernels' share alone). Without (UNet++, Adityan), the card's
    convolutions and autograd are held to the CPU's: at most 1e-4 of the
    scale, twice the CPU's distance, or the card's own f32 rounding of sums
    of ``K = B·H·W`` terms, ``2^-24·sqrt(K)`` of the model's largest
    gradient. The CPU sums in other orders than the card, so its distance
    alone is no measure of the card's rounding: on an H100 about a third of
    MTUNetPlusPlus's tensors are further from f64 than twice the CPU's
    distance, all within that rounding."""
    import math
    import torch

    runs = [("card", DEVICE, torch.float32, False), ("f64", DEVICE, torch.float64, True),
            ("CPU", "cpu", torch.float32, True)]
    if ZOO_NORMS[arch]:
        runs.append(("plain norm on the card", DEVICE, torch.float32, True))
    torch.backends.cudnn.deterministic = True
    try:
        grads = step0_gradients(arch, cfg, init, train_ds, runs)
    finally:
        torch.backends.cudnn.deterministic = False
    largest = max(g.abs().max().item() for g in grads["f64"].values())
    zero = sorted(k for k, g in grads["f64"].items()
                  if g.abs().max().item() <= ZERO_GRAD_REL * largest)
    scale = {k: g.abs().max().item() for k, g in grads["f64"].items() if k not in zero}
    dist = {k: {n: (grads[n][k] - grads["f64"][k]).abs().max().item()
                for n, *_ in runs if n != "f64"} for k in scale}
    ref = runs[-1][0]  # the plain-norm model on the card, or the CPU
    rounding = 0.0 if ZOO_NORMS[arch] else (
        2.0 ** -24 * math.sqrt(cfg.data.batch_size * SIZE * SIZE) * largest)
    bad = [(k, d["card"] / scale[k], d[ref] / scale[k]) for k, d in dist.items()
           if d["card"] > max(GRAD_REL_TOL * scale[k], 2 * d[ref], rounding)]
    by_rounding = sum(max(GRAD_REL_TOL * scale[k], 2 * d[ref]) < d["card"] <= rounding
                      for k, d in dist.items())
    worst = {n: max(d[n] / scale[k] for k, d in dist.items()) for n in dist[next(iter(dist))]}
    log(f"  {arch} step-0 gradients over {len(dist)} tensors, max distance to the f64 "
        f"gradient of each tensor's scale: " + ", ".join(f"{n} {v:.3g}" for n, v in worst.items())
        + f"; held to: {ref}" + (f" or the card's rounding {rounding:.3g} ({by_rounding} "
                                 f"tensors by it alone; largest card distance "
                                 f"{max(d['card'] for d in dist.values()):.3g})"
                                 if rounding else "")
        + f"; {len(zero)} left out, their f64 gradient at most {ZERO_GRAD_REL:g} of the "
        f"largest ({largest:.3g}): {zero}")
    check(not bad, f"{arch} step-0 gradients: the card is further from f64 than the "
                   f"{ref} (tensor, card, {ref}, of its scale): {bad[:3]}")


def zoo_training(arch: str) -> tuple:
    """An epoch of batch-2 steps through the Engine at the ``Config()``
    defaults with ``arch`` (fast augmentation on, f32): launch counts exact,
    losses finite, a padding step a no-op, ms per step; step-0 gradients.
    Returns the launches of the epoch."""
    import numpy as np
    import torch
    from multi_task_breast_cancer_tpu_torch.config import Config
    from multi_task_breast_cancer_tpu_torch.ops.losses import check_finite_loss
    from multi_task_breast_cancer_tpu_torch.train.loop import (
        Engine, plan_epoch_indices, step_valid_mask)
    from multi_task_breast_cancer_tpu_torch.train.state import create_train_state

    cfg = Config()
    cfg.model.architecture = arch
    b = cfg.data.batch_size
    model = zoo_model(arch)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    engine = Engine(model, _engine_config(cfg), device=DEVICE)
    state = create_train_state(engine.model, cfg.optimizer.opt, cfg.optimizer.lr)
    train_ds, val_ds = synthetic_fold(ZOO_TRAIN_N, 20), synthetic_fold(ZOO_VAL_N, 21)
    real = ZOO_TRAIN_N // b
    train = engine.device_data(train_ds)
    val = engine.device_data(val_ds, for_training=False)
    rng, gen = np.random.default_rng(0), torch.Generator().manual_seed(0)
    perm = plan_epoch_indices(ZOO_TRAIN_N, b, rng, pad_to_steps=real + 1)

    torch.cuda.synchronize()
    _reset_counts()
    state, tm, vm = engine.train_and_eval_epoch(state, train, val, perm, gen,
                                                step_valid_mask(ZOO_TRAIN_N, b, real + 1))
    torch.cuda.synchronize()
    launches = _counts()
    n = ZOO_NORMS[arch]
    want = (n * (real + 1), n * real, real)
    check(launches == want, f"{arch}: launch counts {launches}, want {want}")
    check_finite_loss(tm["loss"])
    check_finite_loss(vm["loss"])
    before = _snapshot(state)
    _reset_counts()
    engine.train_epoch(state, train, perm[:b], gen, np.zeros(1, np.float32))
    check(_counts() == (0, 0, 0) and _same_state(before, _snapshot(state)),
          f"{arch}: a padding step changed the state or launched a kernel")
    perm = plan_epoch_indices(ZOO_TRAIN_N, b, rng)
    engine.train_epoch(state, train, perm, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.train_epoch(state, train, perm, gen)
    step_ms = (time.perf_counter() - t0) * 1e3 / real
    log(f"  {arch}: {real} steps + a padding step + validation: launches {launches} "
        f"(want {want}); train loss {tm['loss']:.5f} (seg {tm['seg_loss']:.5f}, cls "
        f"{tm['cls_loss']:.5f}), val loss {vm['loss']:.5f}; the padding step a no-op; "
        f"{step_ms:.3f} ms per batch-{b} step (host clock)")
    del engine, state, train, val
    torch.cuda.empty_cache()
    zoo_gradients(arch, cfg, init, train_ds)
    return launches


def zoo_driver() -> tuple:
    """``training_multitask`` (the CLI's ``run_entry``, on the card by
    default) with Multi_BTSUNet at width 24, deep supervision and fast
    augmentation on a synthetic 128² tree, 2 folds × ``ZOO_DRIVER_EPOCHS``;
    then ``CheckpointBackend`` over fold 0's checkpoint behind
    ``InferenceServer`` answering ``/predict_batch``. Returns the launches
    of the run and the requests."""
    import tempfile
    import numpy as np
    import torch
    from multi_task_breast_cancer_tpu_torch._entry import run_entry
    from multi_task_breast_cancer_tpu_torch.config import config_to_yaml
    from multi_task_breast_cancer_tpu_torch.data.loader import load_datasets
    from multi_task_breast_cancer_tpu_torch.data.synthetic import make_preprocessed_busi
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk
    from multi_task_breast_cancer_tpu_torch.serve.server import (
        CheckpointBackend, InferenceServer)
    from multi_task_breast_cancer_tpu_torch.train import driver as D
    from multi_task_breast_cancer_tpu_torch.train import loop as LP
    from multi_task_breast_cancer_tpu_torch.train.inference import to_host

    tmp = tempfile.mkdtemp(prefix="mtbc_zoo_")
    try:
        root = make_preprocessed_busi(os.path.join(tmp, "busi"), size=SIZE, seed=2,
                                      n_per_class=ZOO_DRIVER_PER_CLASS)
        cfg = _driver_config(root, DRIVER_CV, ZOO_DRIVER_EPOCHS)
        cfg.model.architecture = "Multi_BTSUNet"
        cfg_path = os.path.join(tmp, "config.yaml")
        with open(cfg_path, "w") as f:
            f.write(config_to_yaml(cfg))
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        run = run_entry("multitask", "CV", ["--config", cfg_path,
                                            "--run-root", os.path.join(tmp, "runs")])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = _counts()
        _check_run_dir(run, "multitask", "CV", DRIVER_CV, ZOO_DRIVER_EPOCHS)
        sizes = _fold_sizes(run)
        b, n = cfg.data.batch_size, ZOO_NORMS["Multi_BTSUNet"]
        steps = sum(ZOO_DRIVER_EPOCHS * -(-tr // b) for tr, _, _ in sizes)
        passes = DRIVER_CV * (ZOO_DRIVER_EPOCHS + 1)
        want = (n * (steps + passes), n * steps, steps)
        log(f"zoo driver: training_multitask, Multi_BTSUNet width 24 with deep supervision, "
            f"{3 * ZOO_DRIVER_PER_CLASS} images at {SIZE}^2, CV {DRIVER_CV}, "
            f"{ZOO_DRIVER_EPOCHS} epochs: {run_s:.1f} s; fold sizes {sizes}; launches "
            f"{launches}, the fold sizes predict {want}")
        check(launches == want, f"zoo driver launch counts {launches}, want {want}")

        images = load_datasets(cfg.training, cfg.data, mode="CV")[0].test.images[:8]
        fold0 = os.path.join(run, "fold_0")
        ckpt = next(os.path.join(fold0, f) for f in os.listdir(fold0) if f.startswith("model_"))
        backend = CheckpointBackend(cfg, "multitask", checkpoint=ckpt, size=SIZE, max_batch=8,
                                    device=DEVICE)
        planes = images[..., 0].astype(np.uint8)
        with InferenceServer(backend, port=0, max_batch=8) as srv:
            hk.instance_norm_leaky_relu.launches = 0
            payload, ms = _post(f"http://127.0.0.1:{srv.port}/predict_batch", planes.tobytes(),
                                {"X-Image-Count": str(len(planes))})
            served = hk.instance_norm_leaky_relu.launches
            forwards = srv.batcher.stats["batches"]
        check(served == n * forwards and forwards >= 1,
              f"{served} norm launches for {forwards} served forwards")
        raw = backend.predict(planes[..., None])
        _check_records(payload["predictions"], backend.postprocess(raw), "zoo /predict_batch")
        state, _ = D.build_inference_state(cfg, "multitask", checkpoint=ckpt, device=DEVICE)
        engine = LP.Engine(state.model, D._engine_config(cfg, "multitask", 360.0), device=DEVICE)
        direct = to_host(engine.predict(state, images))
        err = _max_rel_err([torch.from_numpy(a) for a in _leaves(raw)],
                           [torch.from_numpy(a) for a in _leaves(direct)])
        log(f"  /predict_batch of {len(planes)} raw planes on fold 0's checkpoint: {ms:.1f} ms, "
            f"{forwards} forward(s), {served} norm launches; records == the backend's direct "
            f"answer; backend vs Engine.predict max err {err:.3g} of the output scale "
            f"(tol {SERVE_REL_TOL})")
        check(err <= SERVE_REL_TOL, "zoo: served answer differs from Engine.predict")
        fwd, bwd, aug = launches
        return fwd + served, bwd, aug
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


def phase_zoo() -> tuple:
    """The zoo: forwards, the kernels at the BTS family's new shapes,
    training steps, and the slice's path (the driver, then serving). Returns
    the launches on its main paths and the kernels' per-architecture rows."""
    t0 = time.perf_counter()
    log("zoo: the nine architectures at full width (width 24, deep supervision where the "
        "config has it, seeded weights, 128^2)")
    rows = zoo_kernels(zoo_forwards())
    runs = [zoo_training(arch) for arch in ZOO_TRAINED] + [zoo_driver()]
    launches = tuple(sum(r[i] for r in runs) for i in range(3))
    log(f"zoo: phase {time.perf_counter() - t0:.1f} s; launches on its main paths {launches}")
    return launches, rows


SEG_ZOO_TRAIN_N = 8                              # 4 real steps and 1 padding step at batch 2
SEG_ZOO_DRIVER = ("ResidualUNet", "SwinUNETR")   # training_segmentation through the CLI
SEG_ZOO_DRIVER_PER_CLASS, SEG_ZOO_DRIVER_EPOCHS = 32, 2
SEG_ZOO_CRITERION_ARCH = "UNet"                  # the cheapest, for one step per criterion


def seg_zoo_model(arch: str):
    """The registry's segmentation model at full width (``model.width`` 24;
    SegResNet and SwinUNETR at their fixed sizes; 128²), its weights drawn
    from generator seed 0, on the CPU."""
    import torch
    from multi_task_breast_cancer_tpu_torch.models.registry import init_segmentation_model
    return init_segmentation_model(arch, width=24, size=SIZE,
                                   generator=torch.Generator().manual_seed(0))


def seg_zoo_forwards() -> dict:
    """Each model's parameter and batch-statistic counts, its eval forward on
    the card at batches 2 and 64 with no norm-kernel launch, card against
    CPU at batch 2, and its forward's device time at batch 64. Returns the
    norm launches counted per architecture, and the forward ms."""
    import torch
    from multi_task_breast_cancer_tpu_torch.models.registry import count_parameters
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk

    g = torch.Generator().manual_seed(6)
    x = (torch.rand(BATCH, 1, SIZE, SIZE, generator=g) * 255).round()
    counted, fwd = {}, {}
    for arch, params in SEG_ZOO_PARAMETERS.items():
        model = seg_zoo_model(arch).eval()
        n, stats = count_parameters(model), sum(b.numel() for b in model.buffers())
        check(n == params and stats == SEG_ZOO_BATCH_STATS.get(arch, 0),
              f"{arch}: {n} parameters and {stats} batch statistics, JAX counts {params} and "
              f"{SEG_ZOO_BATCH_STATS.get(arch, 0)}")
        with torch.inference_mode():
            cpu = model(x[:2])
        model, xd = model.to(DEVICE), x.to(DEVICE)
        with torch.inference_mode():
            hk.instance_norm_leaky_relu.launches = 0
            outs = [model(xd[:b]) for b in ZOO_BATCHES]
            torch.cuda.synchronize()
            counted[arch] = hk.instance_norm_leaky_relu.launches
            check(counted[arch] == 0, f"{arch}: {counted[arch]} norm launches, it has no site")
            check(all(o.shape == (b, 1, SIZE, SIZE) and bool(torch.isfinite(o).all())
                      for o, b in zip(outs, ZOO_BATCHES)), f"{arch}: outputs malformed")
            err = _max_rel_err([outs[0]], [cpu])
            check(err <= MODEL_REL_TOL, f"{arch}: card vs CPU, max err {err:.3g}")
            fwd[arch] = time_ms(lambda: model(xd), reps=5)
        log(f"  {arch:14s} {n:>9,d} params, {stats:>5,d} batch statistics, 0 norm launches per "
            f"forward; card vs CPU err {err:.3g} (tol {MODEL_REL_TOL}); forward at {BATCH}: "
            f"{fwd[arch]:.3f} ms = {BATCH / fwd[arch] * 1e3:.1f} images/s")
        del model, outs
        torch.cuda.empty_cache()
    return counted, fwd


def seg_zoo_training(arch: str, train_ds) -> tuple:
    """Four batch-2 steps and one cross-fold padding step through the Engine
    at the ``Config()`` defaults (fused DICE, fast augmentation, f32; the
    dropout masks from a generator on the card): the augmentation kernel
    once per real step and never on the padding step, no norm kernel; the
    batch statistics (ResidualUNet) move on the real steps and stay on the
    padding step, which leaves the whole state bit-identical; a second run
    from the same weights and generators ends bit-identical to the first
    (cuDNN deterministic); ms per step on the host clock. Returns the
    launches of the first run."""
    import numpy as np
    import torch
    from multi_task_breast_cancer_tpu_torch.config import Config
    from multi_task_breast_cancer_tpu_torch.ops.losses import check_finite_loss
    from multi_task_breast_cancer_tpu_torch.train.loop import (
        Engine, plan_epoch_indices, step_valid_mask)
    from multi_task_breast_cancer_tpu_torch.train.state import create_train_state

    cfg = Config()
    cfg.model.architecture = arch
    b = cfg.data.batch_size
    real = SEG_ZOO_TRAIN_N // b
    model = seg_zoo_model(arch)
    init, buffers = model.state_dict(), [k for k, _ in model.named_buffers()]

    def run():
        model = seg_zoo_model(arch)
        model.load_state_dict(init)
        engine = Engine(model, _engine_config(cfg, task="segmentation"), device=DEVICE)
        state = create_train_state(engine.model, cfg.optimizer.opt, cfg.optimizer.lr)
        train = engine.device_data(train_ds)
        gen = torch.Generator().manual_seed(0)
        drop = torch.Generator(device=DEVICE).manual_seed(1)
        perm = plan_epoch_indices(SEG_ZOO_TRAIN_N, b, np.random.default_rng(0),
                                  pad_to_steps=real + 1)
        torch.cuda.synchronize()
        _reset_counts()
        state, tm = engine.train_epoch(state, train, perm, gen,
                                       step_valid_mask(SEG_ZOO_TRAIN_N, b, real + 1), drop)
        torch.cuda.synchronize()
        return engine, state, train, tm, _counts(), drop

    torch.backends.cudnn.deterministic = True
    try:
        engine, state, train, tm, launches, drop = run()
        check(launches == (0, 0, real), f"{arch}: launch counts {launches}, want (0, 0, {real})")
        check_finite_loss(tm["loss"])
        after = _snapshot(state)
        moved = [k for k in buffers if not torch.equal(after[0][k].cpu(), init[k])]
        check(moved == buffers, f"{arch}: batch statistics left unmoved by the real steps: "
                                f"{sorted(set(buffers) - set(moved))[:3]}")
        _reset_counts()
        engine.train_epoch(state, train, np.arange(b, dtype=np.int32),
                           torch.Generator().manual_seed(3), np.zeros(1, np.float32), drop)
        check(_counts() == (0, 0, 0) and _same_state(after, _snapshot(state)),
              f"{arch}: a padding step changed the state or launched a kernel")
        again = _snapshot(run()[1])
        check(_same_state(after, again), f"{arch}: a second run from the same generators "
                                         f"ended elsewhere")
    finally:
        torch.backends.cudnn.deterministic = False
    perm = plan_epoch_indices(SEG_ZOO_TRAIN_N, b, np.random.default_rng(1))
    gen = torch.Generator().manual_seed(2)
    engine.train_epoch(state, train, perm, gen, None, drop)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.train_epoch(state, train, perm, gen, None, drop)
    step_ms = (time.perf_counter() - t0) * 1e3 / real
    log(f"  {arch}: {real} steps + a padding step: launches {launches}; train loss "
        f"{tm['loss']:.5f}, dice {tm['dice']:.4f}; {len(buffers)} batch-statistic tensors "
        f"moved by the real steps; the padding step a no-op; a second run bit-identical; "
        f"{step_ms:.3f} ms per batch-{b} step (host clock)")
    del engine, state, train
    torch.cuda.empty_cache()
    return launches, step_ms


def seg_zoo_criteria(train_ds) -> None:
    """One batch-2 step of ``SEG_ZOO_CRITERION_ARCH`` per segmentation
    criterion, card against CPU from the same weights (augmentation off):
    the step's loss and Dice to ``LOSS_REL_TOL``; the Hausdorff distance
    fields of the batch's masks and thresholded predictions equal on both
    devices, and its loss's time on the card."""
    import numpy as np
    import torch
    from multi_task_breast_cancer_tpu_torch.config import Config
    from multi_task_breast_cancer_tpu_torch.ops import losses as L
    from multi_task_breast_cancer_tpu_torch.train.loop import Engine
    from multi_task_breast_cancer_tpu_torch.train.state import create_train_state

    cfg = Config()
    init = seg_zoo_model(SEG_ZOO_CRITERION_ARCH).state_dict()
    perm = np.arange(cfg.data.batch_size, dtype=np.int32)
    rows = []
    for name in L.SEG_CRITERIA:
        cfg.loss.function = name
        metrics = {}
        for device in (DEVICE, "cpu"):
            model = seg_zoo_model(SEG_ZOO_CRITERION_ARCH)
            model.load_state_dict(init)
            engine = Engine(model, _engine_config(cfg, task="segmentation", use_transforms=False),
                            device=device)
            state = create_train_state(engine.model, cfg.optimizer.opt, cfg.optimizer.lr)
            metrics[device] = engine.train_epoch(state, engine.device_data(train_ds), perm)[1]
        err = max(abs(metrics[DEVICE][k] - metrics["cpu"][k]) / max(abs(metrics["cpu"][k]), 1e-6)
                  for k in ("loss", "dice"))
        rows.append(f"{name} {metrics[DEVICE]['loss']:.5f} (err {err:.2g})")
        check(math.isfinite(metrics[DEVICE]["loss"]) and err <= LOSS_REL_TOL,
              f"criterion {name}: card {metrics[DEVICE]} vs CPU {metrics['cpu']}")
    masks = torch.from_numpy(train_ds.masks[:16].transpose(0, 3, 1, 2).copy())
    g = torch.Generator().manual_seed(8)
    logits = torch.randn(masks.shape, generator=g) * 4
    fields = {dev: [L.edt_field(m.to(dev)).cpu() for m in (masks, torch.sigmoid(logits))]
              for dev in (DEVICE, "cpu")}
    check(all(torch.equal(a, b) for a, b in zip(fields[DEVICE], fields["cpu"])),
          "Hausdorff distance fields: card and CPU differ")
    ld, md = logits.to(DEVICE), masks.to(DEVICE)
    edt_ms = time_ms(lambda: L.hausdorff_dt_loss(ld, md), reps=5)
    log(f"  criteria, one step of {SEG_ZOO_CRITERION_ARCH} each, card vs CPU (loss, dice; tol "
        f"{LOSS_REL_TOL}): " + "; ".join(rows))
    log(f"  Hausdorff distance fields of {len(masks)} masks and predictions at {SIZE}^2: card == "
        f"CPU exactly; the Hausdorff loss at batch {len(masks)} {edt_ms:.3f} ms on the card")


def seg_zoo_export(cfg, ckpt: str, tmp: str):
    """``serve export`` of ResidualUNet's checkpoint in a process of its own
    (bucket 8, the card's programs), started and left running; returns
    (process, artifact directory, start time)."""
    from multi_task_breast_cancer_tpu_torch.config import config_to_yaml
    cfg_path, art = os.path.join(tmp, "residual.yaml"), os.path.join(tmp, "residual_artifact")
    with open(cfg_path, "w") as f:
        f.write(config_to_yaml(cfg))
    proc = subprocess.Popen(
        [sys.executable, "-m", "multi_task_breast_cancer_tpu_torch.serve", "export", "--config",
         cfg_path, "--task", "segmentation", "--checkpoint", ckpt, "--output", art, "--buckets",
         "8", "--size", str(SIZE), "--platforms", DEVICE],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    return proc, art, time.perf_counter()


def seg_zoo_serving(cfg, ckpt: str, images, export) -> int:
    """ResidualUNet's fold-0 checkpoint behind ``InferenceServer`` (records ==
    the backend's direct answer); then, from ``export`` (:func:`seg_zoo_export`),
    ``serve run --artifact`` in a process of its own: the exported program's
    raw outputs against the live backend's to 1e-4 of scale, the server's
    records against the live backend's. Returns the norm launches (none)."""
    import numpy as np
    import torch
    from multi_task_breast_cancer_tpu_torch.serve import export as E
    from multi_task_breast_cancer_tpu_torch.serve.server import (
        CheckpointBackend, InferenceServer)

    proc, art, started = export
    _, err = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"serve export exited {proc.returncode}:\n{err[-3000:]}")
    export_s = time.perf_counter() - started
    server = _start_server(art)  # comes up while the checks below run
    try:
        planes = images[..., 0].astype(np.uint8)
        backend = CheckpointBackend(cfg, "segmentation", checkpoint=ckpt, size=SIZE,
                                    max_batch=len(planes), device=DEVICE)
        live = backend.predict(planes[..., None])
        direct = backend.postprocess(live)
        with InferenceServer(backend, port=0, max_batch=len(planes)) as srv:
            _reset_counts()
            payload, ms = _post(f"http://127.0.0.1:{srv.port}/predict_batch", planes.tobytes(),
                                {"X-Image-Count": str(len(planes))})
            launches = _counts()[0]
        pixels = [direct.record(i)["tumor_pixels"] for i in range(len(planes))]
        check([r["tumor_pixels"] for r in payload["predictions"]] == pixels,
              "seg zoo /predict_batch records differ from the backend's direct answer")
        exported = E.ExportedModel(art, device=DEVICE).predict(planes[..., None])
        err = _max_rel_err([torch.from_numpy(exported)], [torch.from_numpy(live)])
        check(err <= SERVE_REL_TOL, f"ResidualUNet artifact vs the live backend: {err:.3g}")
        one, many, one_ms, many_ms, up_s = _query_server(*server, planes)
    finally:
        _stop(server[0])
    check(one["tumor_pixels"] == pixels[0]
          and [r["tumor_pixels"] for r in many["predictions"]] == pixels,
          "serve run --artifact answers differ from the live backend's")
    log(f"  ResidualUNet fold 0 served: /predict_batch of {len(planes)} planes {ms:.1f} ms, "
        f"records == the backend's direct answer, {launches} norm launches; serve export "
        f"(bucket 8, beside the runs above) done {export_s:.1f} s after its start; the exported "
        f"program vs the live backend max err {err:.3g} of the output scale (tol "
        f"{SERVE_REL_TOL}); serve run --artifact up in {up_s:.1f} s, /predict {one_ms:.1f} ms, "
        f"/predict_batch {many_ms:.1f} ms, answers == the live backend's")
    return launches


def seg_zoo_driver() -> tuple:
    """``training_segmentation`` (the CLI's ``run_entry``, on the card by
    default) with ResidualUNet and SwinUNETR on a synthetic 128² tree, 2
    folds × ``SEG_ZOO_DRIVER_EPOCHS``: launches as the fold sizes predict
    (the augmentation kernel once per step, no norm kernel); a killed and
    resumed ResidualUNet run on a smaller tree; ResidualUNet's checkpoint
    served and exported (the export runs beside the SwinUNETR and resume
    runs). Returns the launches of the runs and the serving."""
    import tempfile
    import torch
    from multi_task_breast_cancer_tpu_torch._entry import run_entry
    from multi_task_breast_cancer_tpu_torch.config import config_to_yaml
    from multi_task_breast_cancer_tpu_torch.data.loader import load_datasets
    from multi_task_breast_cancer_tpu_torch.data.synthetic import make_preprocessed_busi

    tmp = tempfile.mkdtemp(prefix="mtbc_seg_zoo_")
    total, export = (0, 0, 0), None
    try:
        root = make_preprocessed_busi(os.path.join(tmp, "busi"), size=SIZE, seed=4,
                                      n_per_class=SEG_ZOO_DRIVER_PER_CLASS)
        for arch in SEG_ZOO_DRIVER:
            cfg = _driver_config(root, DRIVER_CV, SEG_ZOO_DRIVER_EPOCHS)
            cfg.model.architecture = arch
            cfg_path = os.path.join(tmp, f"{arch}.yaml")
            with open(cfg_path, "w") as f:
                f.write(config_to_yaml(cfg))
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            run = run_entry("segmentation", "CV", ["--config", cfg_path, "--run-root",
                                                   os.path.join(tmp, f"runs_{arch}")])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = _counts()
            _check_run_dir(run, "segmentation", "CV", DRIVER_CV, SEG_ZOO_DRIVER_EPOCHS)
            sizes = _fold_sizes(run)
            b = cfg.data.batch_size
            steps = sum(SEG_ZOO_DRIVER_EPOCHS * -(-tr // b) for tr, _, _ in sizes)
            log(f"  training_segmentation, {arch}, {3 * SEG_ZOO_DRIVER_PER_CLASS} images at "
                f"{SIZE}^2, CV {DRIVER_CV}, {SEG_ZOO_DRIVER_EPOCHS} epochs: {run_s:.1f} s; fold "
                f"sizes {sizes}; launches {launches}, the fold sizes predict (0, 0, {steps})")
            check(launches == (0, 0, steps), f"{arch} driver launch counts {launches}")
            total = tuple(a + c for a, c in zip(total, launches))
            if arch == "ResidualUNet":
                fold0 = os.path.join(run, "fold_0")
                ckpt = next(os.path.join(fold0, f) for f in os.listdir(fold0)
                            if f.startswith("model_"))
                residual_cfg = cfg
                export = seg_zoo_export(cfg, ckpt, tmp)
        small = make_preprocessed_busi(os.path.join(tmp, "busi_small"), size=SIZE, seed=5,
                                       n_per_class=DRIVER_SMALL_PER_CLASS)
        phase_driver_resume(tmp, small, "segmentation", "ResidualUNet")
        images = load_datasets(residual_cfg.training, residual_cfg.data,
                               mode="CV")[0].test.images[:8]
        served = seg_zoo_serving(residual_cfg, ckpt, images, export)
        return total[0] + served, total[1], total[2]
    finally:
        if export is not None and export[0].poll() is None:
            export[0].kill()
            export[0].wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


def phase_seg_zoo() -> tuple:
    """The rest of the segmentation zoo: forwards of the five at full width,
    four training steps and a padding step each, every segmentation
    criterion, and the main path (``training_segmentation``, resume,
    serving and export). Returns the launches on its main paths and the
    per-architecture rows of the ``kernels`` line."""
    t0 = time.perf_counter()
    log("seg zoo: ResidualUNet, UNet, AttentionUNet, SegResNet, SwinUNETR at full width "
        "(width 24; SegResNet and SwinUNETR fixed), seeded weights, 128^2")
    counted, fwd = seg_zoo_forwards()
    train_ds = synthetic_fold(16, 22)
    steps = {arch: seg_zoo_training(arch, train_ds) for arch in SEG_ZOO_PARAMETERS}
    seg_zoo_criteria(train_ds)
    d_fwd, d_bwd, d_aug = seg_zoo_driver()
    launches = (d_fwd, d_bwd, d_aug + sum(a for (_, _, a), _ in steps.values()))
    rows = {arch: {"forward_launches_per_batch64": counted[arch], "step_launches":
                   list(steps[arch][0]), "forward_ms_64": round(fwd[arch], 4),
                   "step_ms_2": round(steps[arch][1], 3)} for arch in SEG_ZOO_PARAMETERS}
    log(f"seg zoo: phase {time.perf_counter() - t0:.1f} s; launches on its main paths "
        f"{launches}")
    return launches, rows


# --------------------------------------------------------------------------
# phase 9c: data parallelism
# --------------------------------------------------------------------------

PARALLEL_B, PARALLEL_STEPS = 4, 4           # batch 4 (2 rows a rank), 4 real steps
EMPTY_STEPS = 3                             # batch 2 over 3 ranks: a warm-up, 2 replays
PARALLEL_TREE_PER_CLASS = 8                 # the 1-rank NCCL CLI run: 24 images, CV 2, 1 epoch
MTNNUNET_PARAMETERS = 15_819_799            # a step's gradient all-reduce: 63.3 MB of f32
STATS_REL_TOL = 1e-5                        # running statistics, of their scale (as tests/test_torch_seg_zoo.py)
# losses of the ranks against one process: the first step's (equal weights;
# only the order of the sums differs) and the later ones' (the weights
# differ then by Adam's steps on gradients that differ in their last digits,
# up to lr a step for a gradient near zero); the weights after the steps by
# phase 7's rule (LR_STEPS_BOUND and PARAM_REL_TOL)
FIRST_LOSS_REL_TOL, LATER_LOSS_REL_TOL = 1e-5, 1e-3


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sync(device) -> None:
    """Wait for ``device`` (a CUDA device; nothing to wait for on the CPU)."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _digest(state_dict) -> str:
    """sha256 of every tensor's bytes, in key order."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for k in sorted(state_dict):
        h.update(k.encode())
        h.update(state_dict[k].detach().cpu().contiguous().view(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def _parallel_model(arch: str, mesh):
    """Full-width ``arch`` from generator seed 0 (the segmentation zoo as
    phase 9b builds it, the others as 9a); ranks other than 0 move their
    weights first, which ``replicate_to_mesh`` must undo."""
    import torch
    from multi_task_breast_cancer_tpu_torch.models.registry import init_multitask_model
    model = (init_multitask_model("MTnnUNet", generator=torch.Generator().manual_seed(0))
             if arch == "MTnnUNet" else seg_zoo_model(arch)
             if _zoo_task(arch) == "segmentation" else zoo_model(arch))
    if mesh is not None and mesh.rank:
        gen = torch.Generator().manual_seed(100 + mesh.rank)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.01 * torch.randn(p.shape, generator=gen))
    return model


def _parallel_run(arch: str, mesh, b: int = PARALLEL_B, steps: int = PARALLEL_STEPS,
                  fast: bool = True, graphed: bool = False, dtype: str = "float32",
                  live: dict = None) -> dict:
    """``steps`` real steps of batch ``b`` and a padding step through the
    Engine at the ``Config()`` defaults in ``dtype``, one process
    (``mesh=None``, on ``DEVICE``) or this rank of ``mesh``, eager
    (``cuda_graphs=False``) or, with ``graphed``, as the rule decides: per
    step the loss, the kernels' launches, the host-clock ms, and digests of
    the all-reduced gradient and of Adam's state; the augmented rows (copied
    by the step into buffers of their own, a copy a capture records too);
    the first step's gradient (after the all-reduce); dropout masks
    (bit-packed rows, eager only: a forward hook); the state's digest and
    running statistics; whether the Engine was graphed. ``live`` receives
    the Engine, its state, data and dropout generator."""
    import numpy as np
    import torch
    from multi_task_breast_cancer_tpu_torch.config import Config
    from multi_task_breast_cancer_tpu_torch.models.blocks import Dropout
    from multi_task_breast_cancer_tpu_torch.parallel.mesh import replicate_to_mesh
    from multi_task_breast_cancer_tpu_torch.train.loop import Engine, plan_epoch_indices
    from multi_task_breast_cancer_tpu_torch.train.state import create_train_state

    device = mesh.device if mesh is not None else torch.device(DEVICE)
    torch.backends.cudnn.deterministic = True  # as phase 7 compares runs; reset at the end
    cfg = Config()
    cfg.data.batch_size = b
    cfg.training.compute_dtype = dtype
    task = "multitask" if arch == "MTnnUNet" else "segmentation"
    engine = Engine(_parallel_model(arch, mesh),
                    _engine_config(cfg, task=task, fast_augmentation=fast),
                    device=device, mesh=mesh, cuda_graphs=graphed)
    state = replicate_to_mesh(mesh, create_train_state(engine.model, cfg.optimizer.opt,
                                                       cfg.optimizer.lr))
    n = b * steps
    fold = synthetic_fold(n, 40)
    train = engine.device_data(fold)
    rows, masks, grads, buffers = [], [], {}, []
    augmented = engine._augmented_batch

    def record_rows(*args, **kwargs):
        imgs, msks = augmented(*args, **kwargs)
        if not buffers:  # the first real step runs eagerly, graphed or not
            buffers.extend([torch.empty_like(imgs), torch.empty_like(msks)])
        buffers[0].copy_(imgs)
        buffers[1].copy_(msks)
        return imgs, msks

    engine._augmented_batch = record_rows
    for m in engine.model.modules():
        if isinstance(m, Dropout):
            m.register_forward_hook(lambda mod, i, o: masks.append(
                ((o == 0) & (i[0] != 0)).cpu()) if mod.training else None)
    named, opt_step = dict(engine.model.named_parameters()), state.optimizer.step

    def record_grads(*args, **kwargs):
        if not grads:
            grads.update({k: p.grad.detach().double().cpu() for k, p in named.items()
                          if p.grad is not None})
        return opt_step(*args, **kwargs)

    state.optimizer.step = record_grads
    perm = plan_epoch_indices(n, b, np.random.default_rng(0))
    gen = torch.Generator().manual_seed(0)
    drop = torch.Generator(device=device).manual_seed(1)
    losses, launches, step_ms, stats, grad_digests, moment_digests = [], [], [], [], [], []
    params = dict(engine.model.named_parameters())
    for k in range(steps):
        _sync(device)
        _reset_counts()
        t0 = time.perf_counter()
        state, tm = engine.train_epoch(state, train, perm[k * b:(k + 1) * b], gen,
                                       dropout_generator=drop)
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(_counts())
        losses.append(tm["loss"])
        stats.append({k: v.detach().cpu().clone() for k, v in engine.model.named_buffers()})
        rows.append(tuple(t.cpu().clone() for t in buffers))
        grad_digests.append(_digest({k: p.grad for k, p in params.items() if p.grad is not None}))
        moment_digests.append(_digest({f"{k}.{name}": v for k, p in params.items()
                                       for name, v in state.optimizer.state[p].items()}))
    before = _snapshot(state)
    _reset_counts()
    engine.train_epoch(state, train, perm[:b], gen, np.zeros(1, np.float32), drop)
    _sync(device)
    torch.backends.cudnn.deterministic = False
    if live is not None:
        live.update(engine=engine, state=state, data=train, drop=drop)
    return {"losses": losses, "launches": launches, "step_ms": step_ms, "graphed": engine.graphed,
            "grad_digests": grad_digests, "moment_digests": moment_digests,
            "pad": _counts(), "pad_noop": _same_state(before, _snapshot(state)),
            "rows": rows, "grads": grads if mesh is None or mesh.rank == 0 else None,
            "masks": [np.packbits(m.numpy()) for m in masks],
            "digest": _digest(state.model.state_dict()), "stats": stats,
            "params": ({k: p.detach().cpu().clone() for k, p in engine.model.named_parameters()}
                       if mesh is None or mesh.rank == 0 else None),
            "targets": fold.labels[perm[:b]], "perm0": perm[:b]}


def _allreduce_ms(mesh, reps: int = 5) -> float:
    """Median host-clock ms of one all-reduce of a step's gradient (the
    MTnnUNet's 15,819,799 f32) over ``mesh``, between synchronisations."""
    import torch
    flat = torch.ones(MTNNUNET_PARAMETERS, device=mesh.device)
    times = []
    for i in range(reps + 2):
        _sync(mesh.device)
        t0 = time.perf_counter()
        mesh.all_reduce_sum(flat)
        _sync(mesh.device)
        times.append((time.perf_counter() - t0) * 1e3)
    check(bool((flat == float(mesh.world_size) ** (reps + 2)).all()),
          f"the all-reduce over {mesh.world_size} ranks summed wrong")
    return statistics.median(times[2:])


def _mesh_step_ms(mesh, runs: dict, b: int) -> dict:
    """Host-clock ms per step of the graphed and the eager Engine (``runs``:
    ``_parallel_run``'s ``live`` of each, by ``graphed``) on this rank, in
    turns (graphed, eager, eager, graphed; medians), each an epoch over every
    row of the fold, cuDNN deterministic (the algorithms the capture
    recorded); every gradient all-reduce timed alone between
    synchronisations and taken out: each rank's step without its all-reduce
    (``graphed``, ``eager``: the replays of the two parts against the eager
    forward, backward and step, the card's time included) and the median
    all-reduce (``allreduce``). All ranks run it in step."""
    import numpy as np
    import torch
    spans, all_reduce = [], mesh.all_reduce_sum

    def timed(t):
        if t.numel() < MTNNUNET_PARAMETERS:  # the epoch's sums
            return all_reduce(t)
        _sync(mesh.device)
        t0 = time.perf_counter()
        all_reduce(t)
        _sync(mesh.device)
        spans.append((time.perf_counter() - t0) * 1e3)
        return t

    object.__setattr__(mesh, "all_reduce_sum", timed)  # a frozen dataclass
    torch.backends.cudnn.deterministic = True
    times = {True: [], False: [], "allreduce": []}
    try:
        for graphed in (True, False, False, True):
            r = runs[graphed]
            n = r["data"]["images"].shape[0]
            spans.clear()
            _sync(mesh.device)
            t0 = time.perf_counter()
            r["engine"].train_epoch(r["state"], r["data"], np.random.default_rng(9).permutation(n),
                                    torch.Generator().manual_seed(9), None, r["drop"])
            _sync(mesh.device)
            total = (time.perf_counter() - t0) * 1e3
            check(len(spans) == n // b, f"{len(spans)} gradient all-reduces in {n // b} steps")
            times[graphed].append((total - sum(spans)) / (n // b))
            times["allreduce"].extend(spans)
    finally:
        object.__delattr__(mesh, "all_reduce_sum")
        torch.backends.cudnn.deterministic = False
    return {"graphed": statistics.median(times[True]), "eager": statistics.median(times[False]),
            "allreduce": statistics.median(times["allreduce"])}


def _mesh_trace(mesh, run: dict, b: int, attempts: int = 2) -> dict:
    """The graphed Engine's epoch over the fold in profiled windows
    (:func:`trace_window`, an epoch's lead-in) on rank 0, the same epochs
    unprofiled on the others (every rank runs ``attempts`` windows, so the
    collectives stay in step): per window #1/#2/#3 in the trace, the
    launches the counters added and the programs' launches times the steps,
    the busy share and per-step ms. Rank 0's windows only."""
    import numpy as np
    import torch
    from multi_task_breast_cancer_tpu_torch.ops import fast_augment as FA
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk
    engine = run["engine"]
    n = run["data"]["images"].shape[0]
    steps = n // b
    per_replay = Counter()
    for program in engine._step_graph.programs:
        per_replay.update(program.launches)
    want = tuple(steps * per_replay[f] for f in (hk.instance_norm_leaky_relu,
                                                 hk.instance_norm_leaky_relu_backward,
                                                 FA.fast_augment))

    def epoch(seed):
        engine.train_epoch(run["state"], run["data"], np.arange(n),
                           torch.Generator().manual_seed(seed), None, run["drop"])

    windows = []
    for attempt in range(attempts):
        counted = []

        def measured():
            before = _counts()
            epoch(20 + attempt)
            counted.extend(x - y for x, y in zip(_counts(), before))

        if mesh.rank:
            epoch(10 + attempt)
            measured()
            continue
        t = trace_window(measured, lead_in=lambda: epoch(10 + attempt))
        seen = None if t["events"] is None else port_kernel_launches(t["events"])
        windows.append({"seen": seen, "counted": tuple(counted), "want": want, "steps": steps,
                        "busy": None if seen is None else t["busy_ms"] / t["host_ms"],
                        "device_ms": None if seen is None else t["busy_ms"] / steps,
                        "host_ms": t["host_ms"] / steps})
    return {"windows": windows}


def parallel_rank() -> None:
    """A rank of the phase's process group (started by :func:`_run_ranks`):
    ``python -c "import chip_smoke; chip_smoke.parallel_rank()" CASE RANK
    WORLD PORT OUT BACKEND DEVICE``."""
    import torch
    from multi_task_breast_cancer_tpu_torch.parallel import multihost
    from multi_task_breast_cancer_tpu_torch.parallel.mesh import data_mesh, data_space_mesh

    case, rank, world, port, out, backend, device = sys.argv[1:8]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.initialize(f"127.0.0.1:{port}", int(world), int(rank), backend=backend,
                         timeout_s=300)
    if case.startswith("spatial_ranks") or case in ("spatial", "spatial_zoo"):
        mesh = data_space_mesh(SPATIAL_N, device=device)
    else:
        mesh = data_mesh(device=device)
    if case == "spatial":
        result = spatial_case(mesh, out)
    elif case == "spatial_zoo":
        result = spatial_zoo_case(mesh, out)
    elif case == "spatial_ranks_peak":  # the ranks' step peak without the limit
        result = _spatial_peak(mesh, cap=False)
    elif case.startswith("spatial_peak"):  # one process, no mesh
        result = _spatial_peak(None, cap=case.endswith("capped"))
    elif case == "steps":
        # MTnnUNet eager and graphed (f32 and bf16) from one seeded state;
        # ResidualUNet asks to be graphed and runs eagerly by the rule
        live = {True: {}, False: {}}
        result = {"MTnnUNet": _parallel_run("MTnnUNet", mesh, live=live[False]),
                  "MTnnUNet graphed": _parallel_run("MTnnUNet", mesh, graphed=True,
                                                    live=live[True]),
                  "MTnnUNet bf16": _parallel_run("MTnnUNet", mesh, dtype="bfloat16"),
                  "MTnnUNet bf16 graphed": _parallel_run("MTnnUNet", mesh, graphed=True,
                                                         dtype="bfloat16"),
                  "ResidualUNet": _parallel_run("ResidualUNet", mesh, graphed=True)}
        result["allreduce_ms"] = _allreduce_ms(mesh)
        result["step_ms"] = _mesh_step_ms(mesh, live, PARALLEL_B)
        result["trace"] = _mesh_trace(mesh, live[True], PARALLEL_B)
    elif case == "steps_mtnnunet":
        result = {"MTnnUNet": _parallel_run("MTnnUNet", mesh),
                  "allreduce_ms": _allreduce_ms(mesh)}
    else:  # "empty": batch 2 over 3 ranks, eager and graphed
        result = {f"MTnnUNet{' graphed' * g}": _parallel_run(
            "MTnnUNet", mesh, b=2, steps=EMPTY_STEPS, fast=False, graphed=g) for g in (False, True)}
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _start_ranks(case: str, world: int, backend: str, devices: list, work: str):
    """Start ``case`` on ``world`` ranks, each a process of its own on its
    device of ``devices``; returns a function that waits for them and gives
    every rank's result, rank by rank. A rank that fails stops the others
    and fails the phase."""
    import torch
    out = os.path.join(work, f"{case}_{backend}_{world}")
    os.makedirs(out, exist_ok=True)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c",
                               "import chip_smoke; chip_smoke.parallel_rank()", case, str(r),
                               str(world), str(port), out, backend, devices[r]],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def wait() -> list:
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for r, (p, text) in enumerate(zip(procs, logs)):
            check(p.returncode == 0, f"{case}: rank {r} of {world} ({backend}) exited "
                                     f"{p.returncode}:\n{text[-3000:]}")
        return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]

    return wait


def _run_ranks(case: str, world: int, backend: str, devices: list, work: str) -> list:
    """:func:`_start_ranks` and wait for them."""
    return _start_ranks(case, world, backend, devices, work)()


def _parallel_grad_check(what: str, arch: str, single: dict, ranks_grads: dict, b: int,
                         world: int) -> None:
    """The ranks' step-0 gradient after the all-reduce. Computed here on the
    card from the same weights and rows (cuDNN deterministic): the sum of
    each shard's share with the kernels, as one process computes it at the
    ranks' shapes; the same with the plain norm; the same in f64; and a
    float64 gradient of the global batch (the plain-norm model in f64).
    Held: the ranks' gradient within 1e-4 of each tensor's scale of this
    process's sum of shares (the all-reduce adds them; so the ranks compute
    what one process computes for those rows), and the shares in f64 adding
    up to the global f64 gradient within 1e-9 of each tensor's scale (the
    split is the global batch's gradient). Logged, not held: each f32
    gradient's distance to f64, and the tensors where ``zoo_gradients``'
    rule (1e-4 of the scale or twice the plain-norm distance) fails. That
    rule does not hold on these rows for either f32 model: one element on
    the other side of the LeakyReLU's kink than in f64 moves the first
    layers' weight gradients, sums over raw 0-255 intensities that cancel,
    by ~1 % of their scale, and which model hits one depends on the batch
    (on an H100, the kernels' model at batch 2 sat 3e-5 from f64 where the
    plain norm's sat 8e-4; at batch 4 both 1.3 %; each norm site's kernels
    equal f64 to 2e-7 of the gradient's scale at batches 1, 2 and 4)."""
    import numpy as np
    import torch
    from multi_task_breast_cancer_tpu_torch.config import Config
    from multi_task_breast_cancer_tpu_torch.parallel.mesh import shard_slice
    from multi_task_breast_cancer_tpu_torch.train.loop import Engine, make_cls_targets

    cfg = Config()
    cfg.data.batch_size = b
    imgs, msks = single["rows"][0]
    targets = torch.from_numpy(make_cls_targets(np.asarray(single["targets"]), 3))

    def gradient(dtype, plain: bool, sharded: bool) -> dict:
        model = _parallel_model(arch, None)
        model = (plain_twin(model) if plain else model).to(DEVICE, dtype)
        engine = Engine(model, _engine_config(cfg, use_transforms=False), device=DEVICE)
        x, m, t = (a.to(DEVICE, dtype) for a in (imgs, msks, targets))
        if not sharded:  # the global batch's loss, as one process takes it
            engine._losses(model(x), m, t)[0].backward()
        for sl in ([shard_slice(b, world, r) for r in range(world)] if sharded else []):
            out = model(x[sl])
            loss, _ = engine._loss_shares(out, m[sl], t[sl], sl.stop - sl.start, b)
            loss.backward()
        return {k: p.grad.double().cpu() for k, p in model.named_parameters()
                if p.grad is not None}

    torch.backends.cudnn.deterministic = True
    try:
        g64 = gradient(torch.float64, True, False)
        shares64 = gradient(torch.float64, True, True)
        shares = gradient(torch.float32, False, True)
        plain_shares = gradient(torch.float32, True, True)
    finally:
        torch.backends.cudnn.deterministic = False
    largest = max(g.abs().max().item() for g in g64.values())
    live = {k: g for k, g in g64.items() if g.abs().max().item() > ZERO_GRAD_REL * largest}
    check(set(ranks_grads) == set(g64) == set(single["grads"]),
          f"{what}: the gradients cover other tensors")
    split = max((shares64[k] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                for k, g in live.items())
    check(split <= 1e-9, f"{what}: the shards' shares in f64 add up to {split:.3g} of a "
                         f"tensor's scale from the global batch's f64 gradient")
    worst = {"ranks vs this process's shares": 0.0, "ranks vs f64": 0.0,
             "plain-norm shares vs f64": 0.0, "one process's batch vs f64": 0.0}
    bad, zoo_rule = [], []
    for k, g in live.items():
        scale = g.abs().max().item()
        d_sum = (ranks_grads[k] - shares[k]).abs().max().item()
        d_ranks = (ranks_grads[k] - g).abs().max().item()
        d_plain = (plain_shares[k] - g).abs().max().item()
        d_batch = (single["grads"][k] - g).abs().max().item()
        for name, d in zip(worst, (d_sum, d_ranks, d_plain, d_batch)):
            worst[name] = max(worst[name], d / scale)
        if d_ranks > max(GRAD_REL_TOL * scale, 2 * d_plain):
            zoo_rule.append((k.replace("backbone.", "").replace(".conv.weight", ""),
                             *(f"{d / scale:.2g}" for d in (d_ranks, d_plain, d_batch))))
        if d_sum > GRAD_REL_TOL * scale:
            bad.append((k, d_sum / scale))
    log(f"  {what}: step-0 gradient after the all-reduce, {len(live)} tensors "
        f"({len(g64) - len(live)} with a zero f64 gradient left out); the shards' shares in "
        f"f64 add up to the batch's f64 gradient within {split:.3g} of each tensor's scale; "
        f"max distances of that scale: " + ", ".join(f"{n} {v:.3g}" for n, v in worst.items())
        + f"; zoo_gradients' rule fails on {len(zoo_rule)} tensors (the kernels' shares, the "
        f"plain-norm shares, one process's kernel batch, vs f64): {zoo_rule}")
    check(not bad, f"{what}: the all-reduced gradient is not the sum of the shards' shares "
                   f"(tensor, distance of its scale): {bad[:3]}")


def _check_ranks(what: str, arch: str, ranks: list, single: dict, b: int, world: int,
                 per_step: tuple) -> list:
    """The ranks against one process: launches as the shard sizes predict
    (``per_step`` on a rank with rows, none on an empty one), losses and
    parameters, the augmented rows, a bit-identical state across the ranks,
    the padding step a no-op. Returns each rank's launches over the real
    steps."""
    import torch
    from multi_task_breast_cancer_tpu_torch.config import Config
    from multi_task_breast_cancer_tpu_torch.parallel.mesh import shard_slice
    per_rank = []
    for r, res in enumerate(ranks):
        sl = shard_slice(b, world, r)
        rows = sl.stop - sl.start
        want = per_step if rows else (0, 0, 0)
        check(all(tuple(c) == want for c in res["launches"]),
              f"{what}: rank {r} ({rows} rows) launched {res['launches']}, want {want} a step")
        check(res["pad"] == (0, 0, 0) and res["pad_noop"],
              f"{what}: rank {r}'s padding step launched {res['pad']} or moved the state")
        for (imgs, msks), (want_i, want_m) in zip(res["rows"], single["rows"]):
            check(torch.equal(imgs, want_i[sl]) and torch.equal(msks, want_m[sl]),
                  f"{what}: rank {r}'s augmented rows differ from one process's")
        rel = [abs(a - w) / abs(w) for a, w in zip(res["losses"], single["losses"])]
        check(rel[0] <= FIRST_LOSS_REL_TOL and max(rel) <= LATER_LOSS_REL_TOL,
              f"{what}: rank {r}'s losses {res['losses']} vs {single['losses']} (rel {rel})")
        per_rank.append(tuple(sum(c[i] for c in res["launches"]) for i in range(3)))
    check(len({res["digest"] for res in ranks}) == 1,
          f"{what}: the ranks' parameters and buffers are not bit-identical")
    init = _parallel_model(arch, None).state_dict()
    got, want = ranks[0]["params"], single["params"]
    update = torch.cat([(want[k] - init[k]).flatten() for k in want])
    diff = torch.cat([(got[k] - want[k]).flatten() for k in want])
    steps, lr = len(single["losses"]), Config().optimizer.lr
    moved = (diff.norm() / update.norm()).item()
    check(diff.abs().max().item() <= steps * 2 * lr and moved <= PARAM_REL_TOL,
          f"{what}: parameters after {steps} steps {diff.abs().max().item():.3g} from one "
          f"process's (bound {steps * 2 * lr:g}), {moved:.3g} of the update's norm")
    rel = [abs(a - w) / abs(w) for a, w in zip(ranks[0]["losses"], single["losses"])]
    log(f"  {what}: launches per rank over {steps} real steps {per_rank} (#1, #2, #3), none on "
        f"the padding step; losses {[f'{v:.7f}' for v in ranks[0]['losses']]} vs one process "
        f"{[f'{v:.7f}' for v in single['losses']]}, rel {[f'{v:.2g}' for v in rel]} (tol "
        f"{FIRST_LOSS_REL_TOL:g} the first, {LATER_LOSS_REL_TOL:g} the others); parameters "
        f"{diff.abs().max().item():.3g} at most from one process's (bound {steps * 2 * lr:g}), "
        f"the update's difference {moved:.3g} of its L2 norm (tol {PARAM_REL_TOL}); augmented "
        f"rows byte-equal; parameters and buffers bit-identical across the {world} ranks")
    return per_rank


def _stats64(single: dict) -> dict:
    """ResidualUNet's running statistics after the first step in float64:
    the seeded weights in f64 on the card, one training-mode forward of the
    first step's rows with the first step's dropout masks (the same
    generator, seed 1, on the card)."""
    import torch
    from multi_task_breast_cancer_tpu_torch.models.blocks import dropout_draws
    model = seg_zoo_model("ResidualUNet").to(DEVICE, torch.float64).train()
    imgs, _ = single["rows"][0]
    with torch.no_grad(), dropout_draws(model, torch.Generator(device=DEVICE).manual_seed(1)):
        model(imgs.to(DEVICE, torch.float64))
    return {k: v.cpu() for k, v in model.named_buffers()}


def _check_stats_and_masks(ranks: list, single: dict, b: int, world: int) -> None:
    """ResidualUNet's running statistics after the first step (the same
    weights on both sides, so only the order of the global sums differs)
    by ``tests/test_torch_seg_zoo.py``'s rule: within ``STATS_REL_TOL`` of their scale of one
    process's, or no further from the float64 statistics than that and
    than one process is; after the last step, logged (the weights then
    differ by Adam's steps of gradients that differ in their last digits).
    Every dropout mask of a rank is its rows of the single-process mask, bit
    for bit."""
    import numpy as np
    from multi_task_breast_cancer_tpu_torch.parallel.mesh import shard_slice

    stats64, first, by64 = _stats64(single), 0.0, 0
    for res in ranks:
        for k, want in single["stats"][0].items():
            got, ref = res["stats"][0][k], stats64[k].float()
            scale = max(1.0, ref.abs().max().item())
            err = (got - want).abs().max().item() / scale
            first = max(first, err)
            if err > STATS_REL_TOL:
                d_ranks = (got.double() - stats64[k]).abs().max().item() / scale
                d_single = (want.double() - stats64[k]).abs().max().item() / scale
                check(d_ranks <= min(STATS_REL_TOL, d_single),
                      f"ResidualUNet: {k} after step 1 {err:.3g} of its scale from one "
                      f"process's, {d_ranks:.3g} from f64 (one process {d_single:.3g})")
                by64 += 1
    last = max((res["stats"][-1][k] - want).abs().max().item()
               / max(1.0, want.abs().max().item())
               for res in ranks for k, want in single["stats"][-1].items())
    n_masks = len(single["masks"])
    for r, res in enumerate(ranks):
        sl = shard_slice(b, world, r)
        check(len(res["masks"]) == n_masks > 0,
              f"ResidualUNet: rank {r} drew {len(res['masks'])} dropout masks, one process "
              f"{n_masks}")
        for got, want in zip(res["masks"], single["masks"]):
            full = np.unpackbits(want)  # (b, C, H, W) flattened: a row is contiguous
            per_row = full.size // b
            check(np.array_equal(np.unpackbits(got)[:per_row * (sl.stop - sl.start)],
                                 full[sl.start * per_row:sl.stop * per_row]),
                  f"ResidualUNet: rank {r}'s dropout masks are not its rows of the global ones")
    log(f"  ResidualUNet: running statistics {first:.3g} of their scale from one process's "
        f"after step 1 (tol {STATS_REL_TOL}; {by64} tensors held by their f64 distance "
        f"instead), {last:.3g} after step {PARALLEL_STEPS}; {n_masks} dropout masks per rank, "
        f"each its rows of the single-process masks, bit for bit")


def parallel_cli(work: str) -> tuple:
    """``training_multitask`` with ``--coordinator --num-processes 1
    --process-id 0`` (NCCL, one rank on the card) in a process of its own,
    and the same run in this process without a process group: the metrics
    rows of both folds bit-identical. Both runs take cuDNN's deterministic
    algorithms (the CLI through a one-line wrapper of its ``main``), so that
    the two processes sharing the card cannot reorder an atomic sum."""
    import torch
    from multi_task_breast_cancer_tpu_torch.config import config_to_yaml
    from multi_task_breast_cancer_tpu_torch.data.synthetic import make_preprocessed_busi
    from multi_task_breast_cancer_tpu_torch.train.driver import run_experiment

    root = make_preprocessed_busi(os.path.join(work, "busi_parallel"), size=SIZE, seed=3,
                                  n_per_class=PARALLEL_TREE_PER_CLASS)
    cfg = _driver_config(root, 2, 1)
    cfg_path = os.path.join(work, "parallel.yaml")
    with open(cfg_path, "w") as f:
        f.write(config_to_yaml(cfg))
    cli = ("import sys, torch; torch.backends.cudnn.deterministic = True; "
           "sys.argv[0] = 'training_multitask'; "
           "from multi_task_breast_cancer_tpu_torch import training_multitask as m; m.main()")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", cli, "--config", cfg_path, "--run-root",
         os.path.join(work, "nccl1"), "--coordinator", f"127.0.0.1:{_free_port()}",
         "--num-processes", "1", "--process-id", "0"],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    torch.backends.cudnn.deterministic = True
    try:
        local = run_experiment(cfg, "multitask", "CV", run_root=os.path.join(work, "local"))
    finally:
        torch.backends.cudnn.deterministic = False
    text = proc.communicate(timeout=600)[0]
    check(proc.returncode == 0, f"training_multitask over NCCL exited {proc.returncode}:\n"
                                f"{text[-3000:]}")
    cli_s = time.perf_counter() - t0
    check("Process group: rank 0 of 1 (nccl)" in text,
          "the CLI run did not join a one-rank NCCL process group")
    (run,) = os.listdir(os.path.join(work, "nccl1"))
    run = os.path.join(work, "nccl1", run)
    for fold in (0, 1):
        a, b = _metric_rows(run, fold), _metric_rows(local, fold)
        check(a == b, f"NCCL one-rank CLI run: fold {fold}'s rows {a} differ from the run "
                      f"without a process group {b}")
    log(f"  training_multitask --coordinator 127.0.0.1:PORT --num-processes 1 --process-id 0 "
        f"(NCCL, one rank, {3 * PARALLEL_TREE_PER_CLASS} images, CV 2, 1 epoch, full widths) "
        f"beside the same run in this process without a process group: metrics rows "
        f"bit-identical; {cli_s:.1f} s for both")


def _dp_rule(n: int, buckets: list, ndev: int):
    """JAX's ``ExportedModel.predict`` rule (``serve/export.py`` of the JAX
    package), transcribed: the rows per device when data parallelism wins,
    else None."""
    def plan(m):
        out, i = [], 0
        while i < m:
            take = min(m - i, buckets[-1])
            out.append(next(x for x in buckets if x >= take))
            i += take
        return out
    if ndev <= 1 or n <= buckets[0]:
        return None
    shard = -(-n // ndev)
    if shard > buckets[-1]:
        shard = buckets[-1] * (-(-n // (buckets[-1] * ndev)))
    return shard if sum(plan(shard)) < sum(plan(n)) else None


def parallel_serving(artifact: str) -> int:
    """Two replicas on the one card: ``CheckpointBackend`` (``max_batch``
    rounded up; exactly one replica's answer at the replica's batch; 25
    norm launches per replica per bucket execution) and ``ExportedModel``
    over phase 7b's f32 artifact (one replica's answer to 1e-4 of scale; the
    data-parallel plan = JAX's rule; 25 launches per bucket execution).
    Returns the norm launches."""
    import numpy as np
    import torch
    from multi_task_breast_cancer_tpu_torch.config import Config
    from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk
    from multi_task_breast_cancer_tpu_torch.serve.export import ExportedModel
    from multi_task_breast_cancer_tpu_torch.serve.server import CheckpointBackend

    images = (np.random.default_rng(8).random((100, SIZE, SIZE, 1)) * 255).astype(np.uint8)
    two = CheckpointBackend(Config(), "multitask", max_batch=63, devices=[DEVICE, DEVICE])
    check(two.buckets == [64] and len(two.replicas) == 2,
          f"CheckpointBackend: buckets {two.buckets} over {len(two.replicas)} replicas")
    one = CheckpointBackend(Config(), "multitask", max_batch=32, device=DEVICE)
    whole = CheckpointBackend(Config(), "multitask", max_batch=64, device=DEVICE)
    torch.cuda.synchronize()
    hk.instance_norm_leaky_relu.launches = 0
    got = two.predict(images[:64])
    torch.cuda.synchronize()
    served = hk.instance_norm_leaky_relu.launches
    check(served == 50, f"two replicas: {served} norm launches for one bucket, want 25 each")
    check(all(np.array_equal(g, w) for g, w in zip(_leaves(got),
                                                   _leaves(one.predict(images[:64])))),
          "two replicas on the card differ from one replica at the replica's batch")
    err = _max_rel_err([torch.from_numpy(a) for a in _leaves(got)],
                       [torch.from_numpy(a) for a in _leaves(whole.predict(images[:64]))])
    check(err <= SERVE_REL_TOL, f"two replicas vs one replica at 64: {err:.3g} of scale")
    ms = _median_ms(lambda: two.predict(images[:64]), 5)
    ms_one = _median_ms(lambda: whole.predict(images[:64]), 5)
    log(f"  CheckpointBackend, two replicas on {DEVICE} (own streams): max_batch 63 -> 64; "
        f"64 images = one replica at 32 exactly, {err:.3g} of scale from one replica at 64; "
        f"25 norm launches per replica; {ms:.3f} ms against one replica's {ms_one:.3f} ms "
        f"(host clock, to numpy)")
    del two, one, whole

    dp = ExportedModel(artifact, devices=[DEVICE, DEVICE])
    single = ExportedModel(artifact, device=DEVICE)
    check(len(dp._weights) == 1, "ExportedModel keeps more than one weight copy on one card")
    for n in (5, 16, 64, 100):
        shard = dp.dp_shard(n)
        check(shard == _dp_rule(n, dp.buckets, 2), f"ExportedModel.dp_shard({n}) = {shard}, "
                                                   f"JAX's rule {_dp_rule(n, dp.buckets, 2)}")
        executions = len(dp._plan(n)) if shard is None else sum(
            len(dp._plan(min(shard, n - i))) for i in range(0, n, shard))
        torch.cuda.synchronize()
        hk.instance_norm_leaky_relu.launches = 0
        got = dp.predict(images[:n])
        torch.cuda.synchronize()
        launched = hk.instance_norm_leaky_relu.launches
        served += launched
        check(launched == 25 * executions, f"ExportedModel over 2 replicas, {n} images: "
                                           f"{launched} launches, want 25 x {executions}")
        err = _max_rel_err([torch.from_numpy(a) for a in _leaves(got)],
                           [torch.from_numpy(a) for a in _leaves(single.predict(images[:n]))])
        check(err <= SERVE_REL_TOL, f"ExportedModel over 2 replicas, {n} images: {err:.3g}")
        log(f"  ExportedModel, 2 replicas, {n} images: "
            f"{'serial' if shard is None else f'{shard} rows a replica'} (= JAX's rule), "
            f"{executions} bucket execution(s), {launched} norm launches; {err:.3g} of scale "
            f"from one replica")
    return served


def _nccl_one_rank(card: str) -> tuple:
    """A process group of one rank over NCCL in this process: the all-reduce
    of a step's gradient is the identity; its device ms (CUDA events) and
    host ms, medians of 10. Then the graphed step around a real NCCL
    all-reduce: a one-rank ``DataMesh`` (built directly: ``data_mesh(1)``
    is ``None``), MTnnUNet at full width, 8 batch-2 f32 steps (7 real, an lr
    change), graphed == eager on that mesh == the graphed Engine without a
    mesh, bit for bit (cuDNN deterministic); the graphed step's host ms
    with and without the mesh in turns. Returns the two all-reduce times
    and the Engines' launches (#1, #2, #3)."""
    import torch
    import torch.distributed as dist
    from multi_task_breast_cancer_tpu_torch.device import resolve_device
    from multi_task_breast_cancer_tpu_torch.parallel.mesh import DataMesh
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        x = torch.randn(MTNNUNET_PARAMETERS, device=DEVICE,
                        generator=torch.Generator(DEVICE).manual_seed(0))
        y = x.clone()
        dist.all_reduce(y)
        check(torch.equal(x, y), "NCCL's all-reduce over one rank is not the identity")
        dev, host = [], []
        for _ in range(12):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.record()
            dist.all_reduce(y)
            e.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            dev.append(s.elapsed_time(e))
        del x, y

        mesh = DataMesh(1, 0, resolve_device(DEVICE))
        init = {k: v.clone() for k, v in _graph_model("MTnnUNet").state_dict().items()}
        ds = synthetic_fold(GRAPH_N[2], 32)
        torch.backends.cudnn.deterministic = True
        try:
            runs = {what: _graph_run("MTnnUNet", "float32", 2, g, init, ds, GRAPH_EPOCHS, mesh=m)
                    for what, g, m in (("graphed", True, mesh), ("eager", False, mesh),
                                       ("no mesh", True, None))}
            check(len(runs["graphed"]["engine"]._step_graph.programs) == 2
                  and len(runs["no mesh"]["engine"]._step_graph.programs) == 1,
                  "one-rank NCCL mesh: not two programs under the mesh and one without")
            real = sum(sum(v) for v in GRAPH_EPOCHS)
            want = (25 * real, 25 * real, real)
            _graph_vs_eager("one-rank NCCL mesh, graphed vs eager", runs["graphed"],
                            runs["eager"], want)
            _graph_vs_eager("one-rank NCCL mesh graphed vs graphed without a mesh",
                            runs["graphed"], runs["no mesh"], want)
            ms = _step_ms_in_turns({True: runs["graphed"], False: runs["no mesh"]}, 2)
        finally:
            torch.backends.cudnn.deterministic = False
        log(f"  one-rank NCCL DataMesh, MTnnUNet batch 2 f32, {real} real steps of "
            f"{sum(map(len, GRAPH_EPOCHS))} (a padding step, an lr change): the graphed Engine "
            f"replays its two parts around NCCL's all-reduce; == the eager Engine on the mesh "
            f"== the graphed Engine without a mesh, bit for bit (metrics, parameters, buffers, "
            f"Adam's state, launches {want}); host ms per step graphed on the mesh "
            f"{ms[True]:.3f}, without it {ms[False]:.3f} (in turns) [{card}]")
        launches = tuple(sum(r["counts"][i] for r in runs.values()) for i in range(3))
        del runs
        return statistics.median(dev[2:]), statistics.median(host[2:]), launches
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()


def _card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
    except OSError as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def _graphed_ranks_are_eager(what: str, ranks: list, key: str) -> None:
    """Every rank's graphed run (``key`` + " graphed") against its eager run
    ``key`` from the same seeded state: the Engine graphed by the rule, and
    bit for bit the losses, each step's all-reduced gradient and Adam's
    state, the parameters and buffers, the launches (per step and of the
    padding step) and the augmented rows."""
    import torch
    for r, res in enumerate(ranks):
        g, e = res[f"{key} graphed"], res[key]
        check(g["graphed"] and not e["graphed"],
              f"{what}: rank {r}'s Engines graphed {g['graphed']} and {e['graphed']}")
        same = {"losses": g["losses"] == e["losses"],
                "all-reduced gradients": g["grad_digests"] == e["grad_digests"],
                "Adam's state": g["moment_digests"] == e["moment_digests"],
                "parameters and buffers": g["digest"] == e["digest"],
                "launches": g["launches"] == e["launches"] and g["pad"] == e["pad"],
                "augmented rows": len(g["rows"]) == len(e["rows"]) and all(
                    torch.equal(a, b) for x, y in zip(g["rows"], e["rows"]) for a, b in zip(x, y))}
        check(all(same.values()), f"{what}: rank {r} graphed differs from eager in "
                                  f"{[k for k, ok in same.items() if not ok]}")


def _bf16_ranks(what: str, ranks: list, key: str, b: int, world: int, per_step: tuple) -> list:
    """bf16 ranks (no one-process rule for bf16 under a mesh): launches as
    the shards predict, none and no move on the padding step, finite
    losses, parameters and buffers bit-identical across the ranks. Returns
    each rank's launches over the real steps."""
    from multi_task_breast_cancer_tpu_torch.parallel.mesh import shard_slice
    per_rank = []
    for r, res in enumerate(ranks):
        res = res[key]
        sl = shard_slice(b, world, r)
        want = per_step if sl.stop > sl.start else (0, 0, 0)
        check(all(tuple(c) == want for c in res["launches"]) and res["pad"] == (0, 0, 0)
              and res["pad_noop"] and all(math.isfinite(v) for v in res["losses"]),
              f"{what}: rank {r} launched {res['launches']} (padding {res['pad']}), padding "
              f"no-op {res['pad_noop']}, losses {res['losses']}")
        per_rank.append(tuple(sum(c[i] for c in res["launches"]) for i in range(3)))
    check(len({res[key]["digest"] for res in ranks}) == 1,
          f"{what}: the ranks' parameters and buffers are not bit-identical")
    return per_rank


def _mesh_readings(ranks: list, card: str) -> dict:
    """The two-rank timings and rank 0's profiled windows of the graphed
    MTnnUNet step: #1/#2/#3 in one window's trace must be the launches the
    counters added and the programs' launches per replay times the steps
    (25/25/1 a step); logged with the busy share."""
    windows = ranks[0]["trace"]["windows"]
    held = [w for w in windows if w["seen"] is not None and w["seen"] == w["counted"] == w["want"]]
    for k, w in enumerate(windows):
        log(f"  graphed MTnnUNet rank 0, profiled window {k + 1}: #1/#2/#3 in the trace "
            f"{w['seen']}, the counters added {w['counted']}, the programs' launches x "
            f"{w['steps']} replays {w['want']}" + ("" if w["busy"] is None else
            f"; per step the card busy {w['device_ms']:.3f} ms of {w['host_ms']:.3f} ms on the "
            f"host clock ({100 * w['busy']:.1f} %, the all-reduce's host staging included)"))
    check(bool(held), f"graphed ranks: no profiled window of {len(windows)} held the launches")
    steps = [r["step_ms"] for r in ranks]
    log(f"parallel graphs ({card}): MTnnUNet batch 4 over 2 Gloo ranks on one card, f32, host "
        f"ms per step without its gradient all-reduce (medians, in turns; the card's time "
        f"included): " + "; ".join(f"rank {r} graphed {t['graphed']:.3f}, eager {t['eager']:.3f} "
                                   f"({t['eager'] / t['graphed']:.2f}x), the all-reduce alone "
                                   f"{t['allreduce']:.3f}" for r, t in enumerate(steps)))
    return {"step_ms": steps, "busy": held[0]["busy"], "trace_per_step": [
        x / held[0]["steps"] for x in held[0]["seen"]]}


def phase_parallel(artifact: str) -> tuple:
    """Data parallelism (9c): the NCCL one-rank CLI run against the run
    without a process group; two ranks on the card over Gloo (MTnnUNet at
    full width, eager and graphed in f32 and bf16, then ResidualUNet, eager
    by the rule) against one process and graphed against eager; batch 2
    over three ranks with one empty shard, eager and graphed; NCCL over two
    cards when two are visible; serving replicas; the gradient all-reduce's
    time; a one-rank NCCL mesh's graphed step. Returns the launches of its
    main paths (the ranks', the NCCL mesh's and this process's serving),
    each kernel's launches per rank and the graphed readings."""
    import tempfile
    import torch

    t0 = time.perf_counter()
    card = _card()
    log("parallel: data parallelism over torch.distributed, ranks as processes of their own")
    work = tempfile.mkdtemp(prefix="mtbc_parallel_")
    try:
        parallel_cli(work)
        b = PARALLEL_B
        single = {arch: _parallel_run(arch, None) for arch in ("MTnnUNet", "ResidualUNet")}
        ranks = _run_ranks("steps", 2, "gloo", [DEVICE, DEVICE], work)
        per_rank = {"MTnnUNet, 2 ranks (Gloo, one card)": _check_ranks(
            "MTnnUNet at full width, batch 4 over 2 ranks (Gloo, one card)", "MTnnUNet",
            [r["MTnnUNet"] for r in ranks], single["MTnnUNet"], b, 2, (25, 25, 1))}
        _parallel_grad_check("MTnnUNet, 2 ranks", "MTnnUNet", single["MTnnUNet"],
                             ranks[0]["MTnnUNet"]["grads"], b, 2)
        per_rank["MTnnUNet graphed, 2 ranks"] = _check_ranks(
            "MTnnUNet graphed, batch 4 over 2 ranks (Gloo, one card)", "MTnnUNet",
            [r["MTnnUNet graphed"] for r in ranks], single["MTnnUNet"], b, 2, (25, 25, 1))
        _graphed_ranks_are_eager("MTnnUNet f32, 2 ranks", ranks, "MTnnUNet")
        for key in ("MTnnUNet bf16", "MTnnUNet bf16 graphed"):
            per_rank[f"{key}, 2 ranks"] = _bf16_ranks(key, ranks, key, b, 2, (25, 25, 1))
        _graphed_ranks_are_eager("MTnnUNet bf16, 2 ranks", ranks, "MTnnUNet bf16")
        log(f"  MTnnUNet graphed on each of 2 ranks (two programs around the eager all-reduce) "
            f"== eager from one seeded state, f32 and bf16, bit for bit: losses, each step's "
            f"all-reduced gradient and Adam's state, parameters and buffers, launches 25/25/1 "
            f"a real step and none on the padding step, augmented rows; the graphed f32 ranks "
            f"against one process by the rules above [{card}]")
        check(not any(r["ResidualUNet"]["graphed"] for r in ranks),
              "ResidualUNet under a data mesh: graphed, but its BatchNorm all-reduces in the "
              "forward (the rule runs it eagerly)")
        per_rank["ResidualUNet, 2 ranks (Gloo, one card)"] = _check_ranks(
            "ResidualUNet at width 24, batch 4 over 2 ranks (Gloo, one card; eager by the "
            "rule: BatchNorm)", "ResidualUNet",
            [r["ResidualUNet"] for r in ranks], single["ResidualUNet"], b, 2, (0, 0, 1))
        _check_stats_and_masks([r["ResidualUNet"] for r in ranks], single["ResidualUNet"], b, 2)
        readings = _mesh_readings(ranks, card)

        single_2 = _parallel_run("MTnnUNet", None, b=2, steps=EMPTY_STEPS, fast=False)
        empty = _run_ranks("empty", 3, "gloo", [DEVICE] * 3, work)
        for g in ("", " graphed"):
            per_rank[f"MTnnUNet{g}, batch 2 over 3 ranks"] = _check_ranks(
                f"MTnnUNet{g}, batch 2 over 3 ranks (rows 1, 1, 0; exact augmentation)",
                "MTnnUNet", [r[f"MTnnUNet{g}"] for r in empty], single_2, 2, 3, (25, 25, 0))
        _graphed_ranks_are_eager("MTnnUNet, batch 2 over 3 ranks", empty, "MTnnUNet")
        log(f"  batch 2 over 3 ranks: graphed == eager bit for bit on every rank, the empty "
            f"rank replaying its two programs on zero rows with no launch [{card}]")
        _parallel_grad_check("batch 2 over 3 ranks", "MTnnUNet", single_2,
                             empty[0]["MTnnUNet"]["grads"], 2, 3)

        if torch.cuda.device_count() >= 2:
            nccl = _run_ranks("steps_mtnnunet", 2, "nccl", ["cuda:0", "cuda:1"], work)
            per_rank["MTnnUNet, 2 ranks (NCCL, two cards)"] = _check_ranks(
                "MTnnUNet, batch 4 over 2 ranks (NCCL, two cards)", "MTnnUNet",
                [r["MTnnUNet"] for r in nccl], single["MTnnUNet"], b, 2, (25, 25, 1))
            _parallel_grad_check("MTnnUNet, 2 ranks over NCCL", "MTnnUNet", single["MTnnUNet"],
                                 nccl[0]["MTnnUNet"]["grads"], b, 2)
            log(f"  NCCL over two cards: the gradient all-reduce {nccl[0]['allreduce_ms']:.3f} ms "
                f"(host clock)")
        else:
            log(f"  NCCL over two cards: not run: {torch.cuda.device_count()} GPU visible, two "
                f"ranks over NCCL need two cards (NCCL refuses two ranks on one GPU)")

        served = parallel_serving(artifact)
        nccl_dev_ms, nccl_host_ms, nccl_launches = _nccl_one_rank(card)
        per_rank["MTnnUNet on a one-rank NCCL mesh (graphed, eager, no mesh)"] = [nccl_launches]
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    step_2 = statistics.median(ranks[0]["MTnnUNet"]["step_ms"])
    step_1 = statistics.median(single["MTnnUNet"]["step_ms"])
    log(f"parallel ({card}): the gradient all-reduce of {MTNNUNET_PARAMETERS:,d} f32 (63.3 "
        f"MB): Gloo, 2 ranks on one card {ranks[0]['allreduce_ms']:.3f} ms (host clock); NCCL, "
        f"one rank {nccl_dev_ms:.4f} ms of device time, {nccl_host_ms:.3f} ms host clock. "
        f"MTnnUNet batch-4 step on the host clock, medians of {PARALLEL_STEPS}: 2 ranks "
        f"{step_2:.3f} ms, one process {step_1:.3f} ms")
    log(f"parallel: phase {time.perf_counter() - t0:.1f} s")
    totals = [sum(sum(r[i] for r in rows) for rows in per_rank.values()) for i in range(3)]
    totals[0] += served
    rows = {what: [list(r) for r in rows] for what, rows in per_rank.items()}
    return tuple(totals), rows, readings


def phase_parallel_alone() -> None:
    """Phase 7c by itself: build the kernels, export the f32 artifact it
    serves (``cuda`` programs at buckets 1, 8, 64, seeded weights), run it.
    ``python3 -c "import chip_smoke; chip_smoke.phase_parallel_alone()"``
    from the repository root."""
    import tempfile
    import torch
    from multi_task_breast_cancer_tpu_torch.config import Config
    from multi_task_breast_cancer_tpu_torch.ops import _build
    from multi_task_breast_cancer_tpu_torch.serve.export import export_inference

    check(torch.cuda.is_available(), "CUDA is not available")
    log(f"{_card()}; torch {torch.__version__}, CUDA {torch.version.cuda}; kernels built in "
        f"{_build.build():.1f} s")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    work = tempfile.mkdtemp(prefix="mtbc_parallel_alone_")
    try:
        artifact = export_inference(Config(), "multitask", None, os.path.join(work, "art"),
                                    buckets=(1, 8, 64), size=SIZE, platforms=("cuda",))
        launches, rows, readings = phase_parallel(str(artifact))
        log(json.dumps({"launches": launches, "per_rank": rows, "parallel_graphs": readings}))
    finally:
        shutil.rmtree(work, ignore_errors=True)


SPATIAL_N = 2                   # space ranks, on the one card over Gloo
SPATIAL_STEPS = 3               # real batch-2 steps, one train_epoch each
SPATIAL_MEMORY_SIZE = 256       # the peak-memory step's image side
SPATIAL_PEAK_RATIO = 0.6        # a rank's step peak against one process's
# the peak-memory steps run in processes limited to this much device memory
# (``torch.cuda.set_per_process_memory_fraction``): cuDNN then takes
# convolution algorithms whose workspace fits, as a process short of memory
# must; without the limit one convolution's backward alone takes a workspace
# of ~2 GiB at 256² (measured beside it, in a process of its own)
SPATIAL_MEMORY_CAP = 1.5 * 2 ** 30
SPATIAL_LOSS_REL_TOL = 1e-5     # from the same weights: only the order of the sums differs
# step 0's gradient per tensor against one process's: the least-squares scale
# within this of 1, and the distance within this of the tensor's norm. A
# gradient term lost or counted twice (a missing sum over the group, a halo's
# gradient not sent back, the 1/n_space weight) moves the scale by tens of
# percent; one element that the two sum orders put on different sides of the
# LeakyReLU's kink moves the first layers' gradients by ~1 % of their largest
# element (phase 7c's measurement), a few of their elements only
SPATIAL_GRAD_SCALE_TOL = 1e-2
SPATIAL_GRAD_DIST_TOL = 5e-2
SPATIAL_TREE_PER_CLASS = 8      # the driver run: 24 images, CV 2, 1 epoch
SPATIAL_BUDGET_S = 90.0
# 7e: the rest of the zoo on the two space ranks, two real steps each, and
# one driver run with a criterion other than DICE
SPATIAL_ZOO = ("UNet", "AttentionUNet", "SegResNet", "ResidualUNet", "SwinUNETR",
               "UnetPlusPlus", "UNetPlusPlusClassifier", "MTUNetPlusPlus", "Adityan")
SPATIAL_ZOO_STEPS = 2
SPATIAL_ZOO_DRIVER = ("ResidualUNet", "FocalDICE")
SPATIAL_ZOO_BUDGET_S = 90.0
# 7e's gradients that are zero or nearly so in exact arithmetic (a bias
# before a mean-removing norm: the MONAI twins', UNet++'s, Swin's decoder
# blocks'; SwinUNETR's encoder0.conv_skip, a 1×1 weight before an instance
# norm, 1.04e-5 of the model's largest in the CPU rehearsal, its ranks'
# gradient 0.94 of one process's) are f32 rounding on both sides: held
# against the f64 gradient of the same step instead (_spatial_grad_check),
# the ranks no further from it than this many times one process. The f64
# gradient must be f64 throughout: while InstanceNorm's statistics and
# Swin's attention logits were cast to f32 in it, one process shared their
# rounding, and the ranks' conv_skip gradient, 3.9 % of its norm from one
# process's, measured 4.61 times as far from it on an H100 80GB HBM3 at
# 700 W (7e logs both distances of the worst tensor). Two rounding noises of one small tensor can differ by any ratio, so a
# tensor that f32 cannot resolve in one process is held to the model's f32
# noise instead; a lost or doubled term puts the ranks thousands of times
# further from f64 than one process
SPATIAL_F64_RATIO = 4.0


def _spatial_engine(mesh, size: int = 0, arch: str = "MTnnUNet", steps: int = SPATIAL_STEPS):
    """``arch`` (MTnnUNet, or one of the zoo) at full width from generator
    seed 0 at the ``Config()`` defaults (batch 2, fast augmentation), its
    state replicated over ``mesh``, and its device data (``steps`` steps of
    ``size``²)."""
    import torch
    from multi_task_breast_cancer_tpu_torch.config import Config
    from multi_task_breast_cancer_tpu_torch.parallel.mesh import replicate_to_mesh
    from multi_task_breast_cancer_tpu_torch.train.loop import Engine
    from multi_task_breast_cancer_tpu_torch.train.state import create_train_state

    cfg = Config()
    device = mesh.device if mesh is not None else torch.device(DEVICE)
    task = "multitask" if arch == "MTnnUNet" else _zoo_task(arch)
    engine = Engine(_parallel_model(arch, mesh),
                    _engine_config(cfg, task=task, fast_augmentation=True),
                    device=device, mesh=mesh)
    state = replicate_to_mesh(mesh, create_train_state(engine.model, cfg.optimizer.opt,
                                                       cfg.optimizer.lr))
    b = cfg.data.batch_size
    fold = synthetic_fold(b * steps, 41, size)
    return engine, state, engine.device_data(fold), b


def _spatial_steps(mesh, replay=None, arch: str = "MTnnUNet",
                   steps: int = SPATIAL_STEPS, f64: bool = False) -> dict:
    """``steps`` real steps of ``arch`` at 128² through the Engine, then an
    evaluation of 4 images: per step the loss, the launches (#1, #2, #3 and
    the split entry points, halo exchanges, cyclic shifts, row gathers,
    collectives), the host-clock ms, and this rank's weights before it
    (rank 0 returns them); the first step's gradient as the optimizer gets
    it (after the all-reduce; rank 0 and one process); the state's digest;
    the evaluation. ``replay`` (one process): the ranks' weights, loaded
    before each step and before the evaluation, so its losses and first
    gradient come from the same weights as theirs. A model with dropout
    draws from a generator of seed 1 on the device (the ranks' and one
    process's masks are then the same draws). ``f64`` (with ``replay``):
    also the first step's gradient in float64 (:func:`_grads64`)."""
    import numpy as np
    import torch
    from multi_task_breast_cancer_tpu_torch.models.blocks import has_dropout
    from multi_task_breast_cancer_tpu_torch.train.loop import plan_epoch_indices

    engine, state, train, b = _spatial_engine(mesh, arch=arch, steps=steps)
    val = engine.device_data(synthetic_fold(4, 42), for_training=False)
    perm = plan_epoch_indices(b * steps, b, np.random.default_rng(0))
    gen = torch.Generator().manual_seed(0)
    drop = (torch.Generator(device=engine.device).manual_seed(1)
            if has_dropout(engine.model) else None)
    losses, launches, weights, grads, step_ms = [], [], [], {}, []
    keep = mesh is not None and mesh.rank == 0
    named, opt_step = dict(engine.model.named_parameters()), state.optimizer.step

    def record_grads(*args, **kwargs):
        if not grads:
            grads.update({n: p.grad.detach().cpu().clone() for n, p in named.items()
                          if p.grad is not None})
        return opt_step(*args, **kwargs)

    state.optimizer.step = record_grads
    batches, augmented = [], engine._augmented_batch

    def record_batch(*args, **kwargs):
        out = augmented(*args, **kwargs)
        if not batches:
            batches.append(tuple(t.detach().clone() for t in out))
        return out

    engine._augmented_batch = record_batch
    for k in range(steps):
        if replay is not None:
            state.model.load_state_dict(replay["weights"][k])
        if keep:
            weights.append({n: t.detach().cpu().clone() for n, t in
                            state.model.state_dict().items()})
        _sync(engine.device)
        _reset_counts()
        t0 = time.perf_counter()
        state, tm = engine.train_epoch(state, train, perm[k * b:(k + 1) * b], gen,
                                       dropout_generator=drop)
        _sync(engine.device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append({"#1": _counts()[0], "#2": _counts()[1], "#3": _counts()[2],
                         **_split_counts()})
        losses.append(tm["loss"])
    del state.optimizer.step  # the class's again: no cycle keeps the state alive
    del engine._augmented_batch
    grads64 = None
    if f64 and replay is not None:
        rows = torch.as_tensor(perm[:b], dtype=torch.long, device=engine.device)
        grads64 = _grads64(arch, engine, replay["weights"][0], batches[0],
                           train["cls_targets"].index_select(0, rows))
    if replay is not None:
        state.model.load_state_dict(replay["final"])
    _reset_counts()
    ev = engine.eval_epoch(state, val)
    eval_launches = {"#1": _counts()[0], **_split_counts()}
    return {"losses": losses, "launches": launches, "weights": weights, "step_ms": step_ms,
            "grads": grads if keep or mesh is None else None,
            "final": ({n: t.detach().cpu().clone() for n, t in state.model.state_dict().items()}
                      if keep else None),
            "digest": _digest(state.model.state_dict()), "eval": ev,
            "eval_launches": eval_launches, "grads64": grads64}


def _grads64(arch: str, engine, weights: dict, batch: tuple, targets) -> dict:
    """A step's gradient in float64 on ``engine``'s device: ``arch`` from
    ``weights`` in f64, in train mode, on the step's augmented ``batch``
    (images, masks) and class ``targets``, through the Engine's loss; its
    dropout from a fresh generator of seed 1, as the first step drew."""
    import torch
    from multi_task_breast_cancer_tpu_torch.models.blocks import dropout_draws

    model = _parallel_model(arch, None)
    model.load_state_dict(weights)
    model = model.double().to(engine.device).train()
    imgs, msks = (t.double() for t in batch)
    with dropout_draws(model, torch.Generator(device=engine.device).manual_seed(1)):
        loss, _ = engine._losses(model(imgs), msks, targets.double())
    loss.backward()
    return {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None}


def _spatial_peak(mesh, cap: bool = True) -> dict:
    """One batch-2 step at ``SPATIAL_MEMORY_SIZE``² after a warm-up step, in
    a process limited to ``SPATIAL_MEMORY_CAP`` (``cap``) or not: the bytes
    allocated before it (weights, gradients, Adam's moments, the fold) and
    the step's peak above them. Call it before any other step at this size
    in the process: cuDNN keeps the algorithms it chose."""
    import numpy as np
    import torch
    from multi_task_breast_cancer_tpu_torch.train.loop import plan_epoch_indices

    device = torch.device(mesh.device if mesh is not None else DEVICE)
    index = torch.cuda.current_device() if device.index is None else device.index
    torch.cuda.empty_cache()
    if cap:
        torch.cuda.set_per_process_memory_fraction(
            SPATIAL_MEMORY_CAP / torch.cuda.get_device_properties(index).total_memory, index)
    engine, state, train, b = _spatial_engine(mesh, SPATIAL_MEMORY_SIZE)
    perm = plan_epoch_indices(b * SPATIAL_STEPS, b, np.random.default_rng(0))
    gen = torch.Generator().manual_seed(0)
    engine.train_epoch(state, train, perm[:b], gen)
    _sync(engine.device)
    base = torch.cuda.memory_allocated(engine.device)
    torch.cuda.reset_peak_memory_stats(engine.device)
    engine.train_epoch(state, train, perm[b:2 * b], gen)
    _sync(engine.device)
    peak = torch.cuda.max_memory_allocated(engine.device)
    params = sum(p.numel() * p.element_size() for p in engine.model.parameters())
    del engine, state, train
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(1.0, index)
    return {"base": base, "peak": peak, "params": params, "cap": cap}


def _spatial_driver(mesh, tree: str, run_root: str, arch: str = "",
                    criterion: str = "") -> dict:
    """``run_experiment`` with ``spatial_partitions: 2`` as this rank
    (rank 0 under ``run_root``, the other in a scratch root), CV 2, one
    epoch at the ``Config()`` defaults (or ``arch`` and the segmentation
    ``criterion``, on its task): its metrics rows and launches."""
    from multi_task_breast_cancer_tpu_torch.parallel import multihost
    from multi_task_breast_cancer_tpu_torch.train.driver import run_experiment

    cfg = _driver_config(tree, 2, 1, spatial_partitions=SPATIAL_N)
    cfg.model.architecture = arch or cfg.model.architecture
    cfg.loss.function = criterion or cfg.loss.function
    _reset_counts()
    run = run_experiment(cfg, _zoo_task(arch) if arch else "multitask", "CV",
                         run_root=multihost.coordinator_run_root(run_root),
                         device=mesh.device)
    _sync(mesh.device)
    log_text = open(os.path.join(run, "execution.log")).read()
    return {"rows": [_metric_rows(run, f) for f in (0, 1)],
            "launches": {"#1": _counts()[0], "#2": _counts()[1], "#3": _counts()[2],
                         **_split_counts()},
            "mesh_logged": "mesh axes ('data', 'space'), shape (1, 2)" in log_text}


def _spatial_grad_check(ranks: dict, single: dict, f64=None) -> tuple:
    """Each tensor of the ranks' step-0 gradient (after the all-reduce)
    against one process's from the same weights and rows: its least-squares
    scale ``<a, b> / <b, b>`` within ``SPATIAL_GRAD_SCALE_TOL`` of 1 and
    ``|a − b| / |b|`` within ``SPATIAL_GRAD_DIST_TOL`` (a tensor whose
    gradient is zero in one process must be zero on the ranks). ``f64``:
    the same step's gradient in float64; a tensor outside that rule passes
    if the ranks' gradient is no further from it than
    ``SPATIAL_F64_RATIO`` times one process's (a term lost or counted twice
    puts the ranks far from f64 and one process near it), or, where one
    process's own f32 gradient is more than ``SPATIAL_GRAD_DIST_TOL`` of
    its norm from f64 (f32 cannot resolve it: a gradient zero or nearly so
    in exact arithmetic, as a bias before a norm that takes its mean out),
    if the ranks' largest error against f64 is within ``SPATIAL_F64_RATIO``
    times one process's largest f32 error over the whole model: two
    rounding noises of a few elements can differ by any ratio. Returns the
    largest scale error and distance under the first rule, each with its
    tensor's name, and the number of tensors held by f64 with, of the one
    with the largest ratio, the ratio, its name and one process's and the
    ranks' distances to f64 as shares of the f64 gradient's norm."""
    check(ranks.keys() == single.keys() and len(single) > 0,
          f"spatial: the ranks' gradient has {len(ranks)} tensors, one process's "
          f"{len(single)}")
    worst_scale, worst_dist, by_f64 = (0.0, ""), (0.0, ""), []
    noise = (max(float((t.double() - f64[n].double()).abs().max()) for n, t in single.items())
             if f64 is not None else 0.0)
    for name, b in single.items():
        a, b = ranks[name].double().flatten(), b.double().flatten()
        bb = float(b @ b)
        if bb == 0.0:
            check(float(a @ a) == 0.0, f"spatial: {name}'s gradient is not zero on the ranks")
            continue
        fit = float(a @ b) / bb
        dist = float((a - b).norm()) / bb ** 0.5
        if abs(fit - 1.0) <= SPATIAL_GRAD_SCALE_TOL and dist <= SPATIAL_GRAD_DIST_TOL:
            worst_scale = max(worst_scale, (abs(fit - 1.0), name))
            worst_dist = max(worst_dist, (dist, name))
            continue
        check(f64 is not None,
              f"spatial: step 0's gradient of {name}: scale {fit:.4g} or distance "
              f"{dist:.3g} of its norm from one process's")
        c = f64[name].double().flatten()
        ratio = float((a - c).norm()) / max(float((b - c).norm()), 1e-300)
        by_f64.append((ratio, name, float((b - c).norm()) / float(c.norm()),
                       float((a - c).norm()) / float(c.norm())))
        unresolved = float((b - c).norm()) > SPATIAL_GRAD_DIST_TOL * float(c.norm())
        check(ratio <= SPATIAL_F64_RATIO or (
            unresolved and float((a - c).abs().max()) <= SPATIAL_F64_RATIO * noise),
              f"spatial: step 0's gradient of {name}: scale {fit:.4g}, distance {dist:.3g} "
              f"of its norm from one process's, {ratio:.3g} times as far from the f64 "
              f"gradient as one process's, its largest error against f64 "
              f"{float((a - c).abs().max()):.3g} (one process's largest over the model "
              f"{noise:.3g})")
    return worst_scale, worst_dist, (len(by_f64), max(by_f64, default=(0.0, "", 0.0, 0.0)))


def spatial_case(mesh, out: str) -> dict:
    """The ranks' part of 7d (``parallel_rank``'s case ``spatial``)."""
    t0 = time.perf_counter()
    steps = _spatial_steps(mesh)
    peak = _spatial_peak(mesh)
    driver = _spatial_driver(mesh, os.path.join(os.path.dirname(out), "spatial_busi"),
                             os.path.join(os.path.dirname(out), "spatial_runs"))
    return {"steps": steps, "peak": peak, "driver": driver,
            "seconds": time.perf_counter() - t0}


def phase_spatial() -> dict:
    """7d. Spatial partitioning, a main path: MTnnUNet at full width over a
    ``(1 data × 2 space)`` mesh, two ranks on the one card over Gloo (one
    card: no NCCL across cards). Each rank holds half the rows of every
    image. Engine: ``SPATIAL_STEPS`` batch-2 steps at 128² (fast
    augmentation on) and an evaluation; per real step and rank 0 launches of
    #1/#2 (every norm site takes the split path), the split entry points
    50/25/25/25, one #3, 25 halo exchanges forward and 24 backward; each
    loss and the evaluation's against one process replaying the ranks'
    weights (1e-5 relative); step 0's gradient after the all-reduce against
    one process's from the same weights (:func:`_spatial_grad_check`);
    parameters bit-identical across the ranks. Peak memory: one batch-2 step
    at 256² on each rank against one process (a process of its own), each
    limited to ``SPATIAL_MEMORY_CAP``, above what each held before the step
    (weights, gradients, Adam's moments), at most ``SPATIAL_PEAK_RATIO``;
    the same without the limit beside, on the ranks and on one process,
    printed and not held. ``run_experiment`` with
    ``spatial_partitions: 2`` on both ranks (24 images, CV 2, one epoch):
    finite rows, equal on both ranks, the mesh logged. Returns every
    kernel's launches on these main paths, summed over the ranks."""
    import tempfile
    import torch
    from multi_task_breast_cancer_tpu_torch.data.synthetic import make_preprocessed_busi

    t0 = time.perf_counter()
    log(f"spatial: MTnnUNet over a (1 data x {SPATIAL_N} space) mesh, two ranks on one card "
        f"over Gloo")
    work = tempfile.mkdtemp(prefix="mtbc_spatial_")
    try:
        make_preprocessed_busi(os.path.join(work, "spatial_busi"), size=SIZE, seed=6,
                               n_per_class=SPATIAL_TREE_PER_CLASS)
        # the one-process peak steps run beside the ranks: each process
        # counts its own memory
        waits = [_start_ranks(case, n, "gloo", [DEVICE] * n, work) for case, n in
                 (("spatial", SPATIAL_N), ("spatial_peak_capped", 1), ("spatial_peak", 1),
                  ("spatial_ranks_peak", SPATIAL_N))]
        ranks, (single_peak,), (uncapped,), ranks_uncapped = (wait() for wait in waits)
        torch.backends.cudnn.deterministic = True
        replay = _spatial_steps(None, replay=ranks[0]["steps"])
        torch.backends.cudnn.deterministic = False
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()

    r0 = ranks[0]["steps"]
    # the evaluation's thresholded Dice may move by a pixel at the 0.5
    # threshold: two pixels' worth, 3/P each for P lesion pixels
    pixel = 3.0 / float(synthetic_fold(4, 42).masks.sum())
    for r, res in enumerate(ranks):
        st = res["steps"]
        check(st["digest"] == r0["digest"], f"spatial: rank {r}'s parameters differ from rank 0's")
        check(all(math.isfinite(v) for v in st["losses"]), f"spatial: rank {r} loss not finite")
        for k, got in enumerate(st["launches"]):
            want = {"#1": 0, "#2": 0, "#3": 1, "instance_norm_split_sums": 50,
                    "instance_norm_leaky_relu_split_apply": 25,
                    "instance_norm_leaky_relu_split_backward_sums": 25,
                    "instance_norm_leaky_relu_split_backward_apply": 25,
                    "halo_exchanges": 25, "halo_exchanges_backward": 24}
            check(all(got[key] == v for key, v in want.items()),
                  f"spatial: rank {r} step {k} launches {got}, want {want}")
        ev = st["eval_launches"]
        check(ev["#1"] == 0 and ev["instance_norm_split_sums"] == 50
              and ev["instance_norm_leaky_relu_split_apply"] == 25
              and ev["halo_exchanges"] == 25, f"spatial: rank {r} evaluation launches {ev}")
        for k, (got, want) in enumerate(zip(st["losses"], replay["losses"])):
            check(abs(got - want) <= SPATIAL_LOSS_REL_TOL * abs(want),
                  f"spatial: rank {r} step {k} loss {got!r} vs one process {want!r}")
        for key in ("loss", "seg_loss", "cls_loss", "dice"):
            got, want = st["eval"][key], replay["eval"][key]
            check(abs(got - want) <= SPATIAL_LOSS_REL_TOL * max(abs(want), 1e-6) or
                  (key == "dice" and abs(got - want) <= 2 * pixel),
                  f"spatial: rank {r} evaluation {key} {got!r} vs one process {want!r}")
        d = res["driver"]
        check(d["mesh_logged"], f"spatial: rank {r}'s run did not log the (data, space) mesh")
        check(d["rows"] == ranks[0]["driver"]["rows"],
              f"spatial: rank {r}'s metrics rows differ from rank 0's")
        check(d["launches"]["#1"] == 0 and d["launches"]["instance_norm_split_sums"] > 0,
              f"spatial: rank {r}'s driver run launches {d['launches']}")
    grad_scale, grad_dist, _ = _spatial_grad_check(r0["grads"], replay["grads"])
    for fold_rows in ranks[0]["driver"]["rows"]:
        for line in fold_rows[1:]:
            check("nan" not in line.lower(), f"spatial: a metrics row is not finite: {line}")
    step = ranks[0]["steps"]["launches"][0]
    log(f"  per real step and rank: #1 {step['#1']}, #2 {step['#2']}, #3 {step['#3']}; split "
        + ", ".join(f"{n} {step[n]}" for n in SPLIT_ENTRIES)
        + f"; halo exchanges {step['halo_exchanges']} forward, "
          f"{step['halo_exchanges_backward']} backward; collectives {step['collectives']}")
    log(f"  losses of {SPATIAL_STEPS} steps, rank 0: "
        + ", ".join(repr(v) for v in r0["losses"]) + "; one process from the same weights: "
        + ", ".join(repr(v) for v in replay["losses"]))
    log(f"  step 0's gradient after the all-reduce, rank 0, against one process's from "
        f"the same weights, over {len(r0['grads'])} tensors: least-squares scale within "
        f"{grad_scale[0]:.3g} of 1 (at most {SPATIAL_GRAD_SCALE_TOL}; {grad_scale[1]}), "
        f"distance {grad_dist[0]:.3g} of the tensor's norm (at most "
        f"{SPATIAL_GRAD_DIST_TOL}; {grad_dist[1]})")
    log(f"  evaluation, rank 0: " + ", ".join(f"{k} {r0['eval'][k]!r}" for k in
                                                 ("loss", "dice", "acc"))
        + "; one process: " + ", ".join(f"{k} {replay['eval'][k]!r}" for k in
                                         ("loss", "dice", "acc")))
    single_act = single_peak["peak"] - single_peak["base"]
    uncapped_act = uncapped["peak"] - uncapped["base"]
    log(f"  peak memory, batch-2 step at {SPATIAL_MEMORY_SIZE}², one process without a limit: "
        f"{uncapped_act / 2**20:.1f} MiB above the {uncapped['base'] / 2**20:.1f} MiB held "
        f"before the step; under the {SPATIAL_MEMORY_CAP / 2**30:.1f} GiB limit below")
    for r, p in enumerate(ranks_uncapped):
        act = p["peak"] - p["base"]
        log(f"  peak memory, batch-2 step at {SPATIAL_MEMORY_SIZE}² without a limit, rank {r}: "
            f"max_memory_allocated {p['peak'] / 2**20:.1f} MiB, held before the step "
            f"{p['base'] / 2**20:.1f} MiB, the step's {act / 2**20:.1f} MiB against one "
            f"process's {uncapped_act / 2**20:.1f} MiB without a limit: "
            f"{act / uncapped_act:.3f} (not held: cuDNN's workspace, which the partition "
            f"does not shrink, dominates it)")
    for r, res in enumerate(ranks):
        p = res["peak"]
        act = p["peak"] - p["base"]
        ratio = act / single_act
        log(f"  peak memory, batch-2 step at {SPATIAL_MEMORY_SIZE}² under the "
            f"{SPATIAL_MEMORY_CAP / 2**30:.1f} GiB limit, rank {r}: "
            f"max_memory_allocated {p['peak'] / 2**20:.1f} MiB, held before the step "
            f"{p['base'] / 2**20:.1f} MiB (parameters {p['params'] / 2**20:.1f} MiB), the "
            f"step's {act / 2**20:.1f} MiB against one process's {single_act / 2**20:.1f} MiB "
            f"({single_peak['peak'] / 2**20:.1f} - {single_peak['base'] / 2**20:.1f}): "
            f"{ratio:.3f}")
        check(ratio <= SPATIAL_PEAK_RATIO, f"spatial: rank {r}'s step peak is {ratio:.3f} of "
                                           f"one process's (at most {SPATIAL_PEAK_RATIO})")
    seconds = time.perf_counter() - t0
    log(f"spatial ({_card()}): ranks {max(r['seconds'] for r in ranks):.1f} s of work each; "
        f"phase {seconds:.1f} s (budget {SPATIAL_BUDGET_S:.0f} s)")
    totals = {}
    for res in ranks:
        for part in [*res["steps"]["launches"], res["steps"]["eval_launches"],
                     res["driver"]["launches"]]:
            for key, v in part.items():
                totals[key] = totals.get(key, 0) + v
    return totals


def spatial_zoo_case(mesh, out: str) -> dict:
    """The ranks' part of 7e (``parallel_rank``'s case ``spatial_zoo``):
    each of ``SPATIAL_ZOO`` in turn, then the driver run."""
    import torch

    t0 = time.perf_counter()
    runs = {}
    for arch in SPATIAL_ZOO:
        runs[arch] = _spatial_steps(mesh, arch=arch, steps=SPATIAL_ZOO_STEPS)
        torch.cuda.empty_cache()
    arch, criterion = SPATIAL_ZOO_DRIVER
    driver = _spatial_driver(mesh, os.path.join(os.path.dirname(out), "spatial_zoo_busi"),
                             os.path.join(os.path.dirname(out), "spatial_zoo_runs"),
                             arch, criterion)
    return {"runs": runs, "driver": driver, "seconds": time.perf_counter() - t0}


def phase_spatial_zoo() -> dict:
    """7e. The rest of the zoo under spatial partitioning, a main path: the
    nine architectures of ``SPATIAL_ZOO`` at full width (phases 9a/9b's:
    width 24 where it applies, deep supervision where the architecture
    takes it, ResidualUNet's dropout 0.2, SwinUNETR at feature size 24) on
    a ``(1 data × 2 space)`` mesh, the two ranks on the one card over Gloo,
    one model after another. Per model: ``SPATIAL_ZOO_STEPS`` batch-2 steps
    at 128² (fast augmentation on) and an evaluation of 4 images; each loss
    and the evaluation's against one process replaying the ranks' weights
    before each step (``SPATIAL_LOSS_REL_TOL``); step 0's all-reduced
    gradient by :func:`_spatial_grad_check` (a tensor outside 7d's rule,
    zero or nearly so in exact arithmetic, against the step's f64
    gradient); parameters and batch
    statistics bit-identical across the ranks; one launch of #3 per real
    step per rank and none of #1/#2 (no fused norm site); halo exchanges on
    every model, cyclic shifts in SwinUNETR, row gathers in SwinUNETR and
    Adityan. Printed: the exchanges, shifts and gathers per step and rank,
    and the step's host-clock time beside one process's (a correctness path
    through the host: no speed is expected). Then ``run_experiment`` with
    ``spatial_partitions: 2`` and a criterion other than DICE
    (``SPATIAL_ZOO_DRIVER``): finite rows, equal on both ranks. Returns
    #3's launches on these main paths, summed over the ranks, by model."""
    import tempfile
    import torch
    from multi_task_breast_cancer_tpu_torch.data.synthetic import make_preprocessed_busi

    t0 = time.perf_counter()
    log(f"spatial zoo: {len(SPATIAL_ZOO)} architectures over a (1 data x {SPATIAL_N} space) "
        f"mesh, two ranks on one card over Gloo")
    work = tempfile.mkdtemp(prefix="mtbc_spatial_zoo_")
    try:
        make_preprocessed_busi(os.path.join(work, "spatial_zoo_busi"), size=SIZE, seed=7,
                               n_per_class=SPATIAL_TREE_PER_CLASS)
        ranks = _run_ranks("spatial_zoo", SPATIAL_N, "gloo", [DEVICE] * SPATIAL_N, work)
        torch.backends.cudnn.deterministic = True
        replays = {}
        for arch in SPATIAL_ZOO:
            replays[arch] = _spatial_steps(None, replay=ranks[0]["runs"][arch], arch=arch,
                                           steps=SPATIAL_ZOO_STEPS, f64=True)
            torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic = False
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()

    pixel = 3.0 / float(synthetic_fold(4, 42).masks.sum())
    launches = {}
    for arch in SPATIAL_ZOO:
        replay, r0 = replays[arch], ranks[0]["runs"][arch]
        for r, res in enumerate(ranks):
            st = res["runs"][arch]
            check(st["digest"] == r0["digest"],
                  f"spatial zoo: {arch}: rank {r}'s parameters or buffers differ from rank 0's")
            for k, got in enumerate(st["launches"]):
                check(got["#3"] == 1 and got["#1"] == 0 and got["#2"] == 0
                      and got["halo_exchanges"] > 0,
                      f"spatial zoo: {arch}: rank {r} step {k} launches {got}")
                if arch == "SwinUNETR":
                    check(got["cyclic_shifts"] > 0 and got["row_gathers"] > 0,
                          f"spatial zoo: {arch}: rank {r} step {k} shifts and gathers {got}")
                if arch == "Adityan":
                    check(got["row_gathers"] > 0,
                          f"spatial zoo: {arch}: rank {r} step {k} gathers {got}")
            for k, (got, want) in enumerate(zip(st["losses"], replay["losses"])):
                check(math.isfinite(got) and abs(got - want) <= SPATIAL_LOSS_REL_TOL * abs(want),
                      f"spatial zoo: {arch}: rank {r} step {k} loss {got!r} vs one process "
                      f"{want!r}")
            for key in ("loss", "seg_loss", "cls_loss", "dice"):
                got, want = st["eval"][key], replay["eval"][key]
                check(abs(got - want) <= SPATIAL_LOSS_REL_TOL * max(abs(want), 1e-6) or
                      (key == "dice" and abs(got - want) <= 2 * pixel),
                      f"spatial zoo: {arch}: rank {r} evaluation {key} {got!r} vs one "
                      f"process {want!r}")
        scale, dist, (n64, worst64) = _spatial_grad_check(r0["grads"], replay["grads"],
                                                          replay["grads64"])
        step = r0["launches"][0]
        launches[arch] = sum(sum(k["#3"] for k in res["runs"][arch]["launches"])
                             for res in ranks)
        log(f"  {arch}: per step and rank: #3 {step['#3']}, halo exchanges "
            f"{step['halo_exchanges']} forward / {step['halo_exchanges_backward']} backward, "
            f"cyclic shifts {step['cyclic_shifts']} / {step['cyclic_shifts_backward']}, row "
            f"gathers {step['row_gathers']}, collectives {step['collectives']}; losses "
            + ", ".join(repr(v) for v in r0["losses"]) + " (one process from the same "
            "weights: " + ", ".join(repr(v) for v in replay["losses"]) + "); step 0's "
            f"gradient over {len(r0['grads'])} tensors: scale within {scale[0]:.3g} of 1 "
            f"({scale[1]}), distance {dist[0]:.3g} ({dist[1]}); {n64} held against f64 "
            f"instead, the ranks at most {worst64[0]:.3g} times as far from it as one "
            f"process ({worst64[1]}: {worst64[3]:.3g} and {worst64[2]:.3g} of its norm); "
            f"step host-clock ms, rank 0: "
            + ", ".join(f"{v:.1f}" for v in r0["step_ms"]) + "; one process: "
            + ", ".join(f"{v:.1f}" for v in replay["step_ms"]))
    for r, res in enumerate(ranks):
        d = res["driver"]
        check(d["mesh_logged"], f"spatial zoo: rank {r}'s run did not log the (data, space) mesh")
        check(d["rows"] == ranks[0]["driver"]["rows"],
              f"spatial zoo: rank {r}'s metrics rows differ from rank 0's")
        check(d["launches"]["#3"] > 0 and d["launches"]["halo_exchanges"] > 0
              and d["launches"]["row_gathers"] > 0,
              f"spatial zoo: rank {r}'s driver run launches {d['launches']}")
    for fold_rows in ranks[0]["driver"]["rows"]:
        for line in fold_rows[1:]:
            check("nan" not in line.lower(), f"spatial zoo: a metrics row is not finite: {line}")
    launches["driver"] = sum(res["driver"]["launches"]["#3"] for res in ranks)
    arch, criterion = SPATIAL_ZOO_DRIVER
    log(f"  run_experiment ({arch}, {criterion}, spatial_partitions {SPATIAL_N}, "
        f"{3 * SPATIAL_TREE_PER_CLASS} images, CV 2, 1 epoch): rows equal on both ranks, "
        f"finite; #3 launches {launches['driver']}, halo exchanges "
        f"{ranks[0]['driver']['launches']['halo_exchanges']}, row gathers "
        f"{ranks[0]['driver']['launches']['row_gathers']} on rank 0")
    log(f"spatial zoo ({_card()}): ranks {max(r['seconds'] for r in ranks):.1f} s of work "
        f"each; phase {time.perf_counter() - t0:.1f} s (budget {SPATIAL_ZOO_BUDGET_S:.0f} s)")
    return launches


def phase_spatial_alone() -> None:
    """5a and 7d by themselves: build the kernels, check and time the split
    entry points, run the spatial phase. ``python3 -c "import chip_smoke;
    chip_smoke.phase_spatial_alone()"`` from the repository root."""
    import torch
    from multi_task_breast_cancer_tpu_torch.models.registry import init_multitask_model
    from multi_task_breast_cancer_tpu_torch.ops import _build

    check(torch.cuda.is_available(), "CUDA is not available")
    log(f"{_card()}; torch {torch.__version__}, CUDA {torch.version.cuda}; kernels built in "
        f"{_build.build():.1f} s")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = init_multitask_model("MTnnUNet", generator=torch.Generator().manual_seed(0))
    shapes = norm_shapes(model.to(DEVICE).eval(), DEVICE)
    del model
    phase_split_kernel(shapes)
    log(json.dumps({"spatial_launches": phase_spatial()}))


def phase_spatial_zoo_alone() -> None:
    """7e by itself: build the kernels and run the spatial zoo phase.
    ``python3 -c "import chip_smoke; chip_smoke.phase_spatial_zoo_alone()"``
    from the repository root."""
    import torch
    from multi_task_breast_cancer_tpu_torch.ops import _build

    check(torch.cuda.is_available(), "CUDA is not available")
    log(f"{_card()}; torch {torch.__version__}, CUDA {torch.version.cuda}; kernels built in "
        f"{_build.build():.1f} s")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(json.dumps({"spatial_zoo_launches": phase_spatial_zoo()}))


def swin_layer_norm_sites(batch: int = 2) -> Counter:
    """(rows, C) of every LayerNorm site of one SwinUNETR forward at SIZE²
    and ``batch`` (the registry's model: feature 24, depths 2-2-2-2),
    counted."""
    import torch
    from multi_task_breast_cancer_tpu_torch.models import blocks, registry
    model = registry.init_segmentation_model("SwinUNETR", size=SIZE).to(DEVICE)
    seen = Counter()
    hooks = [m.register_forward_hook(
        lambda _m, inp, _o: seen.update([(inp[0].numel() // inp[0].shape[-1],
                                          inp[0].shape[-1])]))
        for m in model.modules() if isinstance(m, blocks.LayerNorm)]
    with torch.inference_mode():
        model(torch.zeros(batch, 1, SIZE, SIZE, device=DEVICE))
    for h in hooks:
        h.remove()
    return seen


def phase_layer_norm() -> dict:
    """The LayerNorm kernels (``ops/layer_norm.py``) at every site of a
    SwinUNETR training step (batch 2, 128²), f32 and bf16: the forward, the
    saved statistics and the three gradients against the plain twin on the
    card (tolerances of ``tests/test_torch_layer_norm.py``), two backward
    calls bit for bit; ptxas's registers and spills of every instantiation;
    per site the forward's and the backward's (two launches) times beside
    their bytes bound, the plain twin's (its forward, the autograd backward
    through it) and ``F.layer_norm``'s (forward, autograd backward; timed
    here only, never called by the port), and the totals over the sites.
    Returns the f32 and bf16 totals."""
    import torch
    import torch.nn.functional as F
    from multi_task_breast_cancer_tpu_torch.ops import _build
    from multi_task_breast_cancer_tpu_torch.ops import layer_norm as L

    _build.library("layer_norm")
    rows_ = ptxas_report(_build.build_log("layer_norm"))
    check(bool(rows_), "no ptxas report for the LayerNorm kernels")
    log("LayerNorm kernels, ptxas -v (registers, spill store/load bytes, static shared memory):")
    for name, regs, st, ld, smem in sorted(rows_):
        log(f"  {name[:90]:90s} {regs:3d} regs  spills {st}/{ld} B  smem {smem} B")
    sites = swin_layer_norm_sites()
    check(sum(sites.values()) == 20, f"SwinUNETR's LayerNorm sites: {dict(sites)}")
    floor = launch_floor_ms()
    g = torch.Generator(device=DEVICE).manual_seed(5)
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        keys = ("fwd_ms", "bwd_ms", "fwd_bound_ms", "bwd_bound_ms", "plain_fwd_ms",
                "plain_bwd_ms", "library_fwd_ms", "library_bwd_ms")
        totals = dict.fromkeys(keys, 0.0)
        log(f"LayerNorm at SwinUNETR's {sum(sites.values())} sites, batch 2, "
            f"{str(dtype)[6:]}:")
        for (rows, c), n in sorted(sites.items(), key=lambda kv: kv[0][1]):
            x = (torch.randn(rows, c, device=DEVICE, generator=g) * 2 + 5).to(dtype)
            scale = torch.randn(c, device=DEVICE, generator=g).to(dtype)
            bias = torch.randn(c, device=DEVICE, generator=g).to(dtype)
            dy = torch.randn(rows, c, device=DEVICE, generator=g).to(dtype)
            y, stats = L._forward(x, scale, bias, 1e-6)
            got = L.layer_norm_backward(x, dy, scale, stats)
            again = L.layer_norm_backward(x, dy, scale, stats)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"two LayerNorm backward calls differ at rows={rows} C={c} {dtype}")
            # the plain twin in f32 on the same values, each result rounded
            # once to the working type, as the kernels round
            leaves = [t.float().requires_grad_() for t in (x, scale, bias)]
            want_f32 = L.layer_norm_reference(*leaves)
            want = [w.to(dtype) for w in torch.autograd.grad(want_f32, leaves, dy.float())]
            want_y = want_f32.detach().to(dtype)
            want_stats = L.layer_norm_statistics_reference(x)
            xhat = (x.float() - want_stats[:, :1]) * want_stats[:, 1:].abs()
            scales = (max(1.0, want_y.float().abs().max().item()),
                      want[0].float().abs().max().item(),
                      (dy.float() * xhat).abs().sum(0).max().item(),
                      dy.float().abs().sum(0).max().item())
            errs = []
            for what, a, b, sc in zip(("y", "dx", "dscale", "dbias"), (y, *got),
                                      (want_y, *want), scales):
                err = (a.float() - b.float()).abs()
                bound = F32_TOL * sc + (BF16_REL_TOL * b.float().abs()
                                        if dtype == torch.bfloat16 else 0.0)
                check(bool((err <= bound).all()), f"LayerNorm {what} != plain at rows={rows} "
                      f"C={c} {dtype}: max abs err {err.max().item():.3g} (scale {sc:.3g})")
                errs.append(err.max().item() / sc)
            s = x.element_size()
            leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
            plain_y = L.layer_norm_reference(*leaves)
            numbers = {
                "fwd_ms": time_ms(lambda: L._forward(x, scale, bias, 1e-6)),
                "bwd_ms": time_ms(lambda: L.layer_norm_backward(x, dy, scale, stats)),
                # x read, y written, (mean, rstd) written, scale and bias read
                "fwd_bound_ms": (2 * x.numel() * s + 8 * rows + 2 * c * s)
                / HBM_BYTES_PER_S * 1e3,
                # x, dy read, dx written, the statistics read, scale read,
                # dscale and dbias written
                "bwd_bound_ms": (3 * x.numel() * s + 8 * rows + 3 * c * s)
                / HBM_BYTES_PER_S * 1e3,
                "plain_fwd_ms": time_ms(lambda: L.layer_norm_reference(x, scale, bias)),
                "plain_bwd_ms": time_ms(lambda: torch.autograd.grad(
                    plain_y, leaves, dy, retain_graph=True)),
                "library_fwd_ms": time_ms(lambda: F.layer_norm(x, (c,), scale, bias, 1e-6)),
            }
            lib_y = F.layer_norm(leaves[0], (c,), leaves[1], leaves[2], 1e-6)
            numbers["library_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                lib_y, leaves, dy, retain_graph=True))
            del lib_y, plain_y, leaves
            plan = L.plan_for(x, scale, bias, y)
            log(f"  rows={rows:5d} C={c:4d} x{n} G={plan.group} V={plan.vectors} "
                f"T={plan.threads} blocks {plan.blocks}/{plan.parts}  rel err "
                + " ".join(f"{e:.2g}" for e in errs) + "  "
                + "  ".join(f"{k} {v:.4f}" for k, v in numbers.items()))
            for k, v in numbers.items():
                totals[k] += n * v
        log(f"LayerNorm totals over the 20 sites, {str(dtype)[6:]}: "
            + ", ".join(f"{k} {v:.4f}" for k, v in totals.items())
            + f"; launch floor x60 {60 * floor:.4f}")
        result[str(dtype)[6:]] = totals
    return result


def phase_layer_norm_alone() -> None:
    """The LayerNorm phase by itself.
    ``python3 -c "import chip_smoke; chip_smoke.phase_layer_norm_alone()"``
    from the repository root."""
    import torch
    from multi_task_breast_cancer_tpu_torch.ops import _build

    check(torch.cuda.is_available(), "CUDA is not available")
    log(f"{_card()}; torch {torch.__version__}, CUDA {torch.version.cuda}; kernels built in "
        f"{_build.build():.1f} s")
    log(json.dumps({"layer_norm": phase_layer_norm()}))


def swin_instance_norm_sites(batch: int = 2) -> Counter:
    """(C, H, residual, activation) of every affine InstanceNorm site of one
    SwinUNETR forward at SIZE² and ``batch`` (the registry's model: feature
    24), counted: the calls of ``instance_norm_affine`` it makes."""
    import torch
    from multi_task_breast_cancer_tpu_torch.models import registry, swin_unetr
    model = registry.init_segmentation_model("SwinUNETR", size=SIZE).to(DEVICE)
    seen = Counter()
    op = swin_unetr.instance_norm_affine

    def recorded(x, scale, bias, eps, residual=None, slope=None):
        seen[(x.shape[1], x.shape[2], residual is not None, slope is not None)] += 1
        return op(x, scale, bias, eps, residual, slope)

    swin_unetr.instance_norm_affine = recorded
    try:
        with torch.inference_mode():
            model(torch.zeros(batch, 1, SIZE, SIZE, device=DEVICE))
    finally:
        swin_unetr.instance_norm_affine = op
    return seen


def phase_instance_norm_affine() -> dict:
    """6b: the affine InstanceNorm kernels (``ops/instance_norm_affine.py``)
    at every UNETR norm site of a SwinUNETR training step (batch 2, 128²),
    f32 and bf16: the output bit for bit against the module's epilogue on
    the kernel's saved statistics, the statistics against the plain twin,
    the four gradients against the backward's plain reference on the same
    output and statistics, two backward calls bit for bit; ptxas's
    registers and spills; per site the forward's and the backward's (two
    launches) times beside their bytes bound, the plain twin's (its
    forward, the autograd backward through it) and the library call's
    (``F.instance_norm`` with the affine, the add, ``F.leaky_relu``; timed
    here only, never called by the port), and the totals over the sites.
    Returns the f32 and bf16 totals."""
    import torch
    import torch.nn.functional as F
    from multi_task_breast_cancer_tpu_torch.ops import _build
    from multi_task_breast_cancer_tpu_torch.ops import instance_norm_affine as A

    _build.library("instance_norm_affine")
    rows_ = ptxas_report(_build.build_log("instance_norm_affine"))
    check(bool(rows_), "no ptxas report for the affine InstanceNorm kernels")
    log("affine InstanceNorm kernels, ptxas -v (registers, spill store/load bytes, static "
        "shared memory):")
    for name, regs, st, ld, smem in sorted(rows_):
        log(f"  {name[:90]:90s} {regs:3d} regs  spills {st}/{ld} B  smem {smem} B")
        check(st == ld == 0, f"{name}: spills {st}/{ld} B")
    sites = swin_instance_norm_sites()
    check(sum(sites.values()) == 26, f"SwinUNETR's affine InstanceNorm sites: {dict(sites)}")
    floor = launch_floor_ms()
    g = torch.Generator(device=DEVICE).manual_seed(6)
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        keys = ("fwd_ms", "bwd_ms", "fwd_bound_ms", "bwd_bound_ms", "plain_fwd_ms",
                "plain_bwd_ms", "library_fwd_ms", "library_bwd_ms")
        totals = dict.fromkeys(keys, 0.0)
        log(f"affine InstanceNorm at SwinUNETR's {sum(sites.values())} UNETR sites, batch 2, "
            f"{str(dtype)[6:]}:")
        for (c, side, has_res, act), n in sorted(sites.items()):
            shape = (2, c, side, side)
            x = (torch.randn(shape, device=DEVICE, generator=g) * 2 + 5).to(dtype)
            scale = torch.randn(c, device=DEVICE, generator=g).to(dtype)
            bias = torch.randn(c, device=DEVICE, generator=g).to(dtype)
            res = torch.randn(shape, device=DEVICE, generator=g).to(dtype) if has_res else None
            dy = torch.randn(shape, device=DEVICE, generator=g).to(dtype)
            slope = 0.01 if act else None
            y, stats = A._forward(x, scale, bias, 1e-5, res, slope)
            got = A.instance_norm_affine_backward(x, y, dy, scale, stats, slope, has_res)
            again = A.instance_norm_affine_backward(x, y, dy, scale, stats, slope, has_res)
            check(all(a is b is None or torch.equal(a, b) for a, b in zip(got, again)),
                  f"two affine InstanceNorm backward calls differ at C={c} {side}² {dtype}")
            xhat = ((x.float() - stats[..., :1, None]) * stats[..., 1:, None]).to(dtype)
            epi = xhat * scale[:, None, None] + bias[:, None, None]
            epi = epi if res is None else epi + res
            epi = epi if slope is None else F.leaky_relu(epi, slope)
            check(torch.equal(y, epi), f"affine InstanceNorm output != the module's epilogue "
                  f"on its statistics at C={c} {side}² {dtype}")
            want_stats = A.instance_norm_affine_statistics_reference(x)
            err_stats = ((stats - want_stats).abs().amax(dim=(0, 1))
                         / want_stats.abs().amax(dim=(0, 1))).max().item()
            check(err_stats <= F32_TOL, f"affine InstanceNorm statistics at C={c} {side}² "
                  f"{dtype}: relative error {err_stats:.3g}")
            want = A.instance_norm_affine_backward_reference(x, y, dy, scale, stats, slope,
                                                             has_res)
            check(has_res is False or torch.equal(got[1], want[1]),
                  f"affine InstanceNorm dresidual != dpre at C={c} {side}² {dtype}")
            errs = [err_stats]
            dpre = dy if slope is None else torch.where(y > 0, dy, dy * slope)
            # dx: its largest magnitude; dscale, dbias: the channel's sum of
            # absolute terms (the same f32 arithmetic summed in another order)
            scales = (want[0].float().abs().max().item(),
                      (dpre * xhat).float().abs().sum(dim=(0, 2, 3)).max().item(),
                      dpre.float().abs().sum(dim=(0, 2, 3)).max().item())
            for what, a, b, sc in zip(("dx", "dscale", "dbias"), (got[0], *got[2:]),
                                      (want[0], *want[2:]), scales):
                err = (a.float() - b.float()).abs()
                sc = max(sc, 1e-30)
                bound = F32_TOL * sc + (BF16_REL_TOL * b.float().abs()
                                        if dtype == torch.bfloat16 else 0.0)
                check(bool((err <= bound).all()), f"affine InstanceNorm {what} != its reference "
                      f"at C={c} {side}² {dtype}: max abs err {err.max().item():.3g}")
                errs.append(err.max().item() / sc)
            s_ = x.element_size()
            planes = (2 if res is not None else 1) + 1   # x (and residual) read, y written
            leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
            plain_y = A.instance_norm_affine_reference(*leaves, 1e-5, res, slope)

            def library(x_, w, b_):
                out = F.instance_norm(x_, weight=w, bias=b_, eps=1e-5)
                out = out if res is None else out + res
                return out if slope is None else F.leaky_relu(out, slope)

            numbers = {
                "fwd_ms": time_ms(lambda: A._forward(x, scale, bias, 1e-5, res, slope)),
                "bwd_ms": time_ms(lambda: A.instance_norm_affine_backward(
                    x, y, dy, scale, stats, slope, has_res)),
                # x (and the residual) read, y written, the statistics written
                "fwd_bound_ms": (planes * x.numel() * s_ + 8 * 2 * c + 2 * c * s_)
                / HBM_BYTES_PER_S * 1e3,
                # x, y (with the activation) and dy read, dx (and dresidual)
                # written, the statistics read, dscale and dbias written
                "bwd_bound_ms": ((3 + (slope is not None) + has_res) * x.numel() * s_
                                 + 8 * 2 * c + 3 * c * s_) / HBM_BYTES_PER_S * 1e3,
                "plain_fwd_ms": time_ms(lambda: A.instance_norm_affine_reference(
                    x, scale, bias, 1e-5, res, slope)),
                "plain_bwd_ms": time_ms(lambda: torch.autograd.grad(
                    plain_y, leaves, dy, retain_graph=True)),
                "library_fwd_ms": time_ms(lambda: library(x, scale, bias)),
            }
            lib_y = library(*leaves)
            numbers["library_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                lib_y, leaves, dy, retain_graph=True))
            del lib_y, plain_y, leaves
            plan = A.plan_for(x)
            log(f"  C={c:3d} {side:3d}² residual={int(has_res)} act={int(act)} x{n} "
                f"{plan.variant} k={plan.cluster} T={plan.threads} V={plan.vectors} "
                f"G={plan.group}  rel err " + " ".join(f"{e:.2g}" for e in errs) + "  "
                + "  ".join(f"{k} {v:.4f}" for k, v in numbers.items()))
            for k, v in numbers.items():
                totals[k] += n * v
        log(f"affine InstanceNorm totals over the 26 sites, {str(dtype)[6:]}: "
            + ", ".join(f"{k} {v:.4f}" for k, v in totals.items())
            + f"; launch floor x78 {78 * floor:.4f}")
        result[str(dtype)[6:]] = totals
    return result


def phase_instance_norm_affine_alone() -> None:
    """6b by itself.
    ``python3 -c "import chip_smoke; chip_smoke.phase_instance_norm_affine_alone()"``
    from the repository root."""
    import torch
    from multi_task_breast_cancer_tpu_torch.ops import _build

    check(torch.cuda.is_available(), "CUDA is not available")
    log(f"{_card()}; torch {torch.__version__}, CUDA {torch.version.cuda}; kernels built in "
        f"{_build.build():.1f} s")
    log(json.dumps({"instance_norm_affine": phase_instance_norm_affine()}))


def umamba_scan_sites(batch: int = 2) -> Counter:
    """(d_inner, L) of every selective scan of one U-Mamba_Enc forward at
    SIZE² and ``batch`` (the registry's model, the published widths),
    counted: the calls of ``selective_scan`` it makes."""
    import torch
    from multi_task_breast_cancer_tpu_torch.models import registry, umamba
    model = registry.init_segmentation_model("UMambaEnc", size=SIZE).to(DEVICE)
    seen = Counter()
    op = umamba.selective_scan

    def recorded(u, *args):
        seen[(u.shape[2], u.shape[1])] += 1
        return op(u, *args)

    umamba.selective_scan = recorded
    try:
        with torch.inference_mode():
            model(torch.zeros(batch, 1, SIZE, SIZE, device=DEVICE))
    finally:
        umamba.selective_scan = op
    return seen


def _scan_site_inputs(b: int, steps: int, dn: int, g) -> dict:
    """A scan's inputs as the Mamba layer hands them over: ``z`` a slice of
    the input projection's rows, ``B`` and ``C`` neighbouring slices of
    x_proj's (read in place by the kernel), f32 on the card."""
    import torch
    import torch.nn.functional as F
    from multi_task_breast_cancer_tpu_torch.ops import selective_scan as S
    rank, n = -(-dn // 32), S.D_STATE  # dt_rank ⌈d_model/16⌉, d_inner = 2·d_model

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=DEVICE) * scale

    xz = rnd(b, steps, 2 * dn, scale=1.5)
    xd = rnd(b, steps, rank + 2 * n, scale=1.5)
    return dict(u=F.silu(xz[..., :dn]).contiguous(), delta=rnd(b, steps, dn, scale=1.5),
                A=-torch.exp(rnd(dn, n, scale=0.35)), B=xd[..., rank:rank + n],
                C=xd[..., rank + n:], D=rnd(dn, scale=0.5), z=xz[..., dn:],
                delta_bias=rnd(dn, scale=0.5))


def graphs_umamba(card: str) -> dict:
    """U-Mamba_Enc's training step graphed against eager, 7f's way (cuDNN
    deterministic, batch 2 f32, ``GRAPH_EPOCHS``: 7 real steps and a
    padding step, the learning rate halved after the first epoch): the
    epoch metrics, parameters, buffers and Adam's state after every epoch
    bit for bit; the selective scan 6/6/6 launches a real step both ways,
    the LayerNorm 6/6/6, the affine InstanceNorm 48/48/48, the augmentation
    one; a validation pass graphed == eager with 6 scan, 6 LayerNorm and 48
    affine InstanceNorm forwards; an epoch of padding steps launching
    nothing. Returns the scan's launches per step and per validation pass."""
    import numpy as np
    import torch
    init = {k: v.clone() for k, v in _graph_model("UMambaEnc").state_dict().items()}
    ds = synthetic_fold(GRAPH_N[2], 32)
    real = sum(sum(v) for v in GRAPH_EPOCHS)
    torch.backends.cudnn.deterministic = True
    try:
        runs = {g: _graph_run("UMambaEnc", "float32", 2, g, init, ds, GRAPH_EPOCHS)
                for g in (True, False)}
        _graph_vs_eager("UMambaEnc batch 2 float32", runs[True], runs[False], (0, 0, real),
                        (6 * real,) * 3, (48 * real,) * 3, (6 * real,) * 3)
        val = {}
        for g, r in runs.items():
            _reset_counts()
            val[g] = (r["engine"].eval_epoch(r["state"], r["data"]), _ln_counts(),
                      _ina_counts(), _ss_counts())
        mg, me = val[True][0], val[False][0]
        same = mg.keys() == me.keys() and all(
            mg[k] == me[k] or (mg[k] != mg[k] and me[k] != me[k]) for k in mg)
        want = ((6, 0, 0), (48, 0, 0), (6, 0, 0))
        check(same and val[True][1:] == val[False][1:] == want,
              f"UMambaEnc: validation graphed {val[True]}, eager {val[False]}, want the same "
              f"metrics and launches {want}")
        g = runs[True]
        before = _snapshot(g["state"])
        _reset_counts()
        g["engine"].train_epoch(g["state"], g["data"], np.arange(4),
                                torch.Generator().manual_seed(7), np.zeros(2, np.float32),
                                g["drop"])
        check(_counts() == _ln_counts() == _ina_counts() == _ss_counts() == (0, 0, 0)
              and _same_state(before, _snapshot(g["state"])),
              "UMambaEnc: graphed padding steps changed the state or launched a kernel")
        per_step = [x // real for x in g["ss_counts"]]
        log(f"  UMambaEnc batch 2 float32: {sum(map(len, GRAPH_EPOCHS))} steps ({real} real) "
            f"graphed == eager: losses and metrics, parameters, buffers, Adam's moments and "
            f"step bit for bit after every epoch; selective scan {g['ss_counts']} both "
            f"({'/'.join(map(str, per_step))} a step), LayerNorm {g['ln_counts']}, affine "
            f"InstanceNorm {g['ina_counts']}, #3 {g['counts'][2]}; a validation pass "
            f"{val[True][3]} scan, {val[True][1]} LayerNorm, {val[True][2]} affine "
            f"InstanceNorm launches, graphed == eager; an epoch of padding steps launches "
            f"nothing and leaves the state as it was [{card}]")
        return {"per_step": per_step, "per_validation": list(val[True][3])}
    finally:
        torch.backends.cudnn.deterministic = False
        runs = None
        gc.collect()
        torch.cuda.empty_cache()


def phase_selective_scan() -> dict:
    """6c: the selective scan kernels (``ops/selective_scan.py``) at the six
    scans of a U-Mamba_Enc training step (batch 2, 128², read from the
    registry's model), f32: ptxas's registers and spills; per site the
    launch plan along L and the card's occupancy of it (every site's
    clusters must fit on the card at once, no second wave; the plan's blocks
    run on as many SMs where an SM holds one block); per site the
    output and the eight gradients of the kernels (through the autograd
    Function, as the model calls them) against the plain twin in f64 on
    the same inputs, its gradients autograd's, each within 2e-5 of its
    largest magnitude (``tests/test_torch_umamba.py``'s tolerance), and two
    runs bit for bit; per site the forward's (as a training step saves its
    states) and the backward's (the reverse scan and the reduction) times
    beside their bound (``benchmark/umamba_counts.py``: the algorithm's own
    bytes at 3.35 TB/s or its f32 arithmetic, the larger) and the plain
    twin's (its forward in f32, the autograd backward through it; no
    library call computes the scan), and the totals over the sites; then
    :func:`graphs_umamba`. Returns the totals and the graphed path's
    launches."""
    import torch
    from benchmark import umamba_counts
    from multi_task_breast_cancer_tpu_torch.ops import _build
    from multi_task_breast_cancer_tpu_torch.ops import selective_scan as S

    card = _card()
    _build.library("selective_scan")
    rows_ = ptxas_report(_build.build_log("selective_scan"))
    check(bool(rows_), "no ptxas report for the selective scan kernels")
    log("selective scan kernels, ptxas -v (registers, spill store/load bytes, static shared "
        "memory):")
    for name, regs, st, ld, smem in sorted(rows_):
        log(f"  {name[:90]:90s} {regs:3d} regs  spills {st}/{ld} B  smem {smem} B")
        check(st == ld == 0, f"{name}: spills {st}/{ld} B")
    sites = umamba_scan_sites()
    check(sorted(sites) == sorted(SCAN_SITES) and set(sites.values()) == {1},
          f"U-Mamba_Enc's scan sites: {dict(sites)}, want {SCAN_SITES}")
    names = ("u", "delta", "A", "B", "C", "D", "z", "delta_bias")
    g = torch.Generator(device=DEVICE).manual_seed(8)
    keys = ("fwd_ms", "bwd_ms", "fwd_bound_ms", "bwd_bound_ms", "plain_fwd_ms", "plain_bwd_ms")
    totals = dict.fromkeys(keys, 0.0)
    log(f"selective scan at U-Mamba_Enc's 6 sites, batch 2, float32 [{card}]:")
    n = S.D_STATE
    plans = {}
    for dn, steps in SCAN_SITES:
        plan = S.scan_plan(2, dn, steps)
        occ = S.occupancy(plan, torch.device(DEVICE))
        groups = plan.blocks // plan.cluster
        one_wave = all(o["clusters"] >= groups for o in occ.values())
        sms = (plan.blocks if one_wave and all(o["blocks_per_sm"] == 1 for o in occ.values())
               else None)
        plans[f"{dn}x{steps}"] = {**plan._asdict(), **occ, "sms": sms}
        log(f"  plan d_inner={dn:3d} L={steps:5d}: {plan.cluster} blocks a cluster x {groups} "
            f"chain groups, {plan.warps} warps a block, {plan.steps} steps a segment, "
            f"{plan.chains} chains; {occ}; SMs {sms}")
        check(one_wave, f"the plan at d_inner {dn}, L {steps} runs {groups} clusters of "
              f"{plan.cluster} blocks, more than the card holds at once: {occ}")
    check(plans["64x16384"]["sms"] is not None and plans["64x16384"]["sms"] >= 64,
          f"the first site's plan runs on fewer than 64 SMs: {plans['64x16384']}")
    for dn, steps in SCAN_SITES:
        ins = _scan_site_inputs(2, steps, dn, g)
        dout = torch.randn(2, steps, dn, device=DEVICE, generator=g)

        def kernels():
            # B and C neighbouring slices of one leaf, z a slice of another, as
            # the layer's projections hand them over
            u, delta, A, D, bias = (ins[k].detach().clone().requires_grad_()
                                    for k in ("u", "delta", "A", "D", "delta_bias"))
            bc = torch.cat([ins["B"], ins["C"]], dim=-1).requires_grad_()
            xz = torch.cat([ins["u"], ins["z"]], dim=-1).requires_grad_()
            out = S.selective_scan(u, delta, A, bc[..., :n], bc[..., n:], D, xz[..., dn:], bias)
            du, dd, dA, dbc, dD, dxz, db = torch.autograd.grad(
                out, [u, delta, A, bc, D, xz, bias], dout)
            return out.detach(), du, dd, dA, dbc[..., :n], dbc[..., n:], dD, dxz[..., dn:], db

        _reset_counts()
        got = kernels()
        check(_ss_counts() == (1, 1, 1), f"selective scan at d_inner={dn} L={steps}: "
                                         f"launches {_ss_counts()}, want (1, 1, 1)")
        again = kernels()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"two selective scan runs differ at d_inner={dn} L={steps}")
        d64 = [ins[k].detach().double().requires_grad_() for k in names]
        want_out = S.selective_scan_reference(*d64)
        want = (want_out.detach(), *torch.autograd.grad(want_out, d64, dout.double()))
        errs = []
        for what, a, w in zip(("out",) + names, got, want):
            err = (a.double() - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
            check(err <= SCAN_REL_TOL, f"selective scan {what} != the f64 twin at d_inner={dn} "
                                       f"L={steps}: {err:.3g} of its largest magnitude")
            errs.append(err)
        del d64, want_out, want, got, again
        x = [ins[k] for k in names]
        y, states = S._forward(*x, save=True)
        leaves = [t.detach().clone().requires_grad_() for t in x]
        plain_y = S.selective_scan_reference(*leaves)
        site = [(dn, steps, n)]
        fwd_bound = umamba_counts.scan_forward_bound_s(site, 2) * 1e3
        bwd_bound = umamba_counts.scan_backward_bound_s(site, 2) * 1e3
        numbers = {
            "fwd_ms": time_ms(lambda: S._forward(*x, save=True)),
            "bwd_ms": time_ms(lambda: S.selective_scan_backward(*x, states, dout)),
            "fwd_bound_ms": fwd_bound, "bwd_bound_ms": bwd_bound,
            # ~6 launches a step: the host's queueing is part of the plain path's time
            "plain_fwd_ms": time_ms(lambda: S.selective_scan_reference(*x), reps=3),
            "plain_bwd_ms": time_ms(lambda: torch.autograd.grad(
                plain_y, leaves, dout, retain_graph=True), reps=3),
        }
        del y, states, plain_y, leaves
        log(f"  d_inner={dn:3d} L={steps:5d}  rel err "
            + " ".join(f"{e:.2g}" for e in errs) + "  "
            + "  ".join(f"{k} {v:.4f}" for k, v in numbers.items()))
        for k, v in numbers.items():
            totals[k] += v
    log(f"selective scan totals over the 6 sites, float32: "
        + ", ".join(f"{k} {v:.4f}" for k, v in totals.items()) + f" [{card}]")
    torch.cuda.empty_cache()
    return {"float32": totals, "plans": plans, "graphed_training": graphs_umamba(card)}


def phase_selective_scan_alone() -> None:
    """6c by itself.
    ``python3 -c "import chip_smoke; chip_smoke.phase_selective_scan_alone()"``
    from the repository root."""
    import torch
    from multi_task_breast_cancer_tpu_torch.ops import _build

    check(torch.cuda.is_available(), "CUDA is not available")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"{_card()}; torch {torch.__version__}, CUDA {torch.version.cuda}; kernels built in "
        f"{_build.build():.1f} s")
    log(json.dumps({"selective_scan": phase_selective_scan()}))


def main() -> int:
    import tempfile
    import torch
    check(torch.cuda.is_available(), "CUDA is not available")
    F32, BF16 = torch.float32, torch.bfloat16
    from multi_task_breast_cancer_tpu_torch.models.registry import init_multitask_model

    index_plane_lib = phase_device()
    # float32 means float32: no TF32 in cuDNN convolutions or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = init_multitask_model("MTnnUNet", generator=torch.Generator().manual_seed(0))
    model = model.to(DEVICE).eval()
    shapes = norm_shapes(model, DEVICE)
    totals = phase_kernel(shapes)
    kernel, kernel_bf16 = totals[BATCH][F32], {b: totals[b][BF16] for b in (2, BATCH)}
    phase_model(model)
    del model
    torch.cuda.empty_cache()
    serve_launches = phase_serving()
    totals = phase_backward_kernel(shapes)
    backward, backward_bf16 = totals[2][F32], {b: totals[b][BF16] for b in (2, BATCH)}
    split = phase_split_kernel(shapes)
    augment, augment_bf16 = phase_augment_kernel(index_plane_lib)
    layer_norm_totals = phase_layer_norm()
    instance_norm_affine_totals = phase_instance_norm_affine()
    scan = phase_selective_scan()
    work = tempfile.mkdtemp(prefix="mtbc_smoke_")
    try:
        (fwd, bwd, aug), f32_times, ckpt = phase_training(work)
        h_fwd, h_bwd, h_aug = phase_training_bf16(f32_times)
        e_fwd, e16_fwd = phase_export(ckpt, work)
        graphs = phase_graphs({"f32": os.path.join(work, "artifact_f32"),
                               "bf16": os.path.join(work, "artifact_bf16")})
        log(json.dumps({"graphs": graphs}))
        (p_fwd, p_bwd, p_aug), parallel_rows, parallel_graphs = phase_parallel(
            os.path.join(work, "artifact_f32"))
        log(json.dumps({"parallel_graphs": parallel_graphs}))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    spatial_launches = phase_spatial()
    spatial_zoo = phase_spatial_zoo()
    d_fwd, d_bwd, d_aug = phase_driver()
    b_fwd, b_bwd, b_aug = phase_driver_bf16()
    t_fwd = phase_tools()
    (z_fwd, z_bwd, z_aug), zoo_rows = phase_zoo()
    (s_fwd, s_bwd, s_aug), seg_zoo_rows = phase_seg_zoo()

    def bf16_rows(rows, key):
        return {f"{key}_{b}": row for b, row in sorted(rows.items())}

    def per_rank(i):
        return {"launches": (p_fwd, p_bwd, p_aug)[i],
                "launches_per_rank": {what: [r[i] for r in rows]
                                      for what, rows in parallel_rows.items()}}

    ln_path = graphs["SwinUNETR"]["layer_norm"]
    ina_path = graphs["SwinUNETR"]["instance_norm_affine"]
    norm_src = "multi_task_breast_cancer_tpu_torch/csrc/instance_norm_leaky_relu.cu"
    log(json.dumps({"kernels": [
        {"name": "instance_norm_leaky_relu", "route": "cuda", "source": norm_src,
         "replaces": "multi_task_breast_cancer_tpu/ops/pallas_kernels.py:34",
         "launches": (serve_launches + fwd + h_fwd + e_fwd + d_fwd + b_fwd + t_fwd + z_fwd + s_fwd
                      + p_fwd),
         **kernel, "bf16": {"launches": h_fwd + e16_fwd + b_fwd, **bf16_rows(kernel_bf16, "batch")},
         "zoo": {a: r["forward"] for a, r in zoo_rows.items()},
         "seg_zoo": {a: {"launches_per_forward": r["forward_launches_per_batch64"]}
                     for a, r in seg_zoo_rows.items()},
         "parallel": per_rank(0)},
        {"name": "instance_norm_leaky_relu_backward", "route": "cuda", "source": norm_src,
         "replaces": "multi_task_breast_cancer_tpu/ops/pallas_kernels.py:45",
         "launches": bwd + h_bwd + d_bwd + b_bwd + z_bwd + s_bwd + p_bwd, **backward,
         "bf16": {"launches": h_bwd + b_bwd, **bf16_rows(backward_bf16, "batch")},
         "zoo": {a: r["backward"] for a, r in zoo_rows.items()},
         "seg_zoo": {a: {"launches_per_step": r["step_launches"][1]}
                     for a, r in seg_zoo_rows.items()},
         "parallel": per_rank(1)},
        {"name": "fast_augment", "route": "cuda",
         "source": "multi_task_breast_cancer_tpu_torch/csrc/fast_augment.cu",
         "replaces": "multi_task_breast_cancer_tpu/ops/fast_augment.py:307",
         "launches": (aug + h_aug + d_aug + b_aug + z_aug + s_aug + p_aug
                      + spatial_launches["#3"] + sum(spatial_zoo.values())), **augment,
         "bf16": {"launches": h_aug + b_aug, **bf16_rows(augment_bf16, "P1_B")},
         "seg_zoo": {"launches": s_aug, **{a: {"launches_in_4_steps": r["step_launches"][2],
                                              "forward_ms_64": r["forward_ms_64"],
                                              "step_ms_2": r["step_ms_2"]}
                                          for a, r in seg_zoo_rows.items()}},
         "parallel": per_rank(2),
         "spatial": {"launches": spatial_launches["#3"]},
         "spatial_zoo": {"launches": sum(spatial_zoo.values()), **spatial_zoo}},
        *({"name": name, "route": "cuda", "source": norm_src,
           "replaces": ("multi_task_breast_cancer_tpu/ops/pallas_kernels.py:45" if "backward" in name
                        else "multi_task_breast_cancer_tpu/ops/pallas_kernels.py:34"),
           "launches": spatial_launches[name], **split[BATCH][F32][name],
           "parts": 2, "batch_2": split[2][F32][name],
           "bf16": {f"batch_{b}": split[b][BF16][name] for b in (2, BATCH)}}
          for name in SPLIT_ENTRIES),
        *({"name": name, "route": "cuda",
           "source": "multi_task_breast_cancer_tpu_torch/csrc/layer_norm.cu", "replaces": None,
           "swinunetr_graphed_training": {
               case: {"per_step": r["per_step"][i], "per_validation": r["per_validation"][i]}
               for case, r in ln_path.items()},
           "swinunetr_sites_batch_2": layer_norm_totals}
          for i, name in enumerate(("layer_norm", "layer_norm_backward",
                                    "layer_norm_param_grad"))),
        *({"name": name, "route": "cuda",
           "source": "multi_task_breast_cancer_tpu_torch/csrc/instance_norm_affine.cu",
           "replaces": None,
           "swinunetr_graphed_training": {
               case: {"per_step": r["per_step"][i], "per_validation": r["per_validation"][i]}
               for case, r in ina_path.items()},
           "swinunetr_sites_batch_2": instance_norm_affine_totals}
          for i, name in enumerate(("instance_norm_affine", "instance_norm_affine_backward",
                                    "instance_norm_affine_param_grad"))),
        *({"name": name, "route": "cuda",
           "source": "multi_task_breast_cancer_tpu_torch/csrc/selective_scan.cu",
           "replaces": None,
           "umamba_graphed_training": {
               "float32_b2": {"per_step": scan["graphed_training"]["per_step"][i],
                              "per_validation": scan["graphed_training"]["per_validation"][i]}},
           "umamba_sites_batch_2": scan["float32"]}
          for i, name in enumerate(("selective_scan", "selective_scan_backward",
                                    "selective_scan_reduce")))]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
