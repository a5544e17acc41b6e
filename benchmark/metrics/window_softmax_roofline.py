"""The window attention's softmax (``models/swin_unetr.py::WindowAttention``,
torch's softmax kernels) of the profiled epoch: the least time of every
launch, from the bytes it must move at the SwinUNETR configuration's
attention sites (:mod:`benchmark.swin_counts`), over the device time of the
softmax kernels by name. Each training step launches the forward and the
backward at every site at the batch, validation the forward at every site
over the whole split; a trace with other counts gives nothing."""

from benchmark import harness, swin_counts

CONFIG = "swinunetr"


def read(record):
    if record.get("kind") != "train":
        return None
    fwd_s = fwd_n = bwd_s = bwd_n = 0
    for name, (seconds, count) in record["kernels"].items():
        n = name.lower()
        if "softmax" not in n:
            continue
        if "backward" in n:
            bwd_s, bwd_n = bwd_s + seconds, bwd_n + count
        else:
            fwd_s, fwd_n = fwd_s + seconds, fwd_n + count
    if not fwd_n:
        return None
    import torch
    sites = swin_counts.attention_sites(torch, harness.config(CONFIG), record["canvas"])
    steps, per = record["steps"], len(sites)
    if not per or fwd_n != per * (steps + 1) or bwd_n != per * steps or not fwd_s + bwd_s:
        return None
    bound = (steps * (swin_counts.softmax_forward_bound_s(sites, record["batch"])
                      + swin_counts.softmax_backward_bound_s(sites, record["batch"]))
             + swin_counts.softmax_forward_bound_s(sites, record["images_validated"]))
    return 100.0 * bound / (fwd_s + bwd_s)
