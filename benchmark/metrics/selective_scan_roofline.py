"""The selective scan (``csrc/selective_scan.cu`` via
``ops/selective_scan.py``) of the profiled epoch: the least time of every
launch, from the bytes it must move at the U-Mamba_Enc configuration's scan
sites (:mod:`benchmark.umamba_counts`), over the device time of the kernels
whose names hold ``selective_scan``. Each training step launches the
forward and the backward (with its reduction of the partials) at every
site at the batch, validation the forward at every site over the whole
split; a trace with other counts gives nothing."""

from benchmark import harness, umamba_counts

CONFIG = "umamba_enc"
FORWARD, BACKWARD, REDUCE = ("selective_scan_forward", "selective_scan_backward",
                             "selective_scan_reduce")


def read(record):
    if record.get("kind") != "train":
        return None
    seconds, counts = 0.0, {FORWARD: 0, BACKWARD: 0, REDUCE: 0}
    for name, (s, n) in record["kernels"].items():
        if "selective_scan" not in name:
            continue
        seconds += s
        for part in counts:
            if part in name:
                counts[part] += n
    if not counts[FORWARD]:
        return None
    import torch
    sites = umamba_counts.scan_sites(torch, harness.config(CONFIG), record["canvas"])
    steps, per = record["steps"], len(sites)
    if (not per or counts[FORWARD] != per * (steps + 1) or counts[BACKWARD] != per * steps
            or counts[REDUCE] != per * steps or not seconds):
        return None
    bound = (steps * (umamba_counts.scan_forward_bound_s(sites, record["batch"])
                      + umamba_counts.scan_backward_bound_s(sites, record["batch"]))
             + umamba_counts.scan_forward_bound_s(sites, record["images_validated"]))
    return 100.0 * bound / seconds
