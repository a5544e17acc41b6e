"""Kernel #3 (batch gather, flips and 3-shear rotation) of the profiled
epoch: the least time of its launches, one per step, from the bytes each
must move, over their device time by name."""

from benchmark import counters


def read(record):
    if record.get("kind") != "train":
        return None
    seconds = count = 0
    for name, (s, n) in record["kernels"].items():
        if "fast_augment" in name:
            seconds, count = seconds + s, count + n
    if count != record["steps"] or not seconds:
        return None
    bound = count * counters.augment_bound_s(record["batch"], record["aug_planes"],
                                             record["canvas"])
    return 100.0 * bound / seconds
