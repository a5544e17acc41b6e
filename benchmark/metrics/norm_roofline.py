"""Kernels #1 and #2 (InstanceNorm + LeakyReLU forward and backward) of the
profiled epoch: the least time of every launch, from the bytes it must move
at the reference model's site shapes, over the device time of those kernels
by name. Each training step launches #1 and #2 at every site at the batch,
validation #1 at every site over the whole split; a trace with other counts
gives nothing."""

from benchmark import counters

FORWARD, BACKWARD, MARK = "instance_norm_leaky_relu", "instance_norm_leaky_relu_backward", "empty"


def read(record):
    sites = record.get("norm_sites")
    if record.get("kind") != "train" or not sites:
        return None
    fwd_s = fwd_n = bwd_s = bwd_n = 0
    for name, (seconds, count) in record["kernels"].items():
        if BACKWARD in name:
            bwd_s, bwd_n = bwd_s + seconds, bwd_n + count
        elif FORWARD in name and MARK not in name:
            fwd_s, fwd_n = fwd_s + seconds, fwd_n + count
    steps, per = record["steps"], len(sites)
    if fwd_n != per * (steps + 1) or bwd_n != per * steps or not fwd_s + bwd_s:
        return None
    bound = (steps * (counters.norm_forward_bound_s(sites, record["batch"])
                      + counters.norm_backward_bound_s(sites, record["batch"]))
             + counters.norm_forward_bound_s(sites, record["images_validated"]))
    return 100.0 * bound / (fwd_s + bwd_s)
