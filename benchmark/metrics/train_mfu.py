"""Useful model operations of the profiled epoch over its seconds and the
card's peak in the cell's compute dtype: three forwards per trained image
(forward, and a backward of twice its operations) and one per validated
image, the forward counted on the plain reference."""


def read(record):
    if record.get("kind") != "train" or not record.get("window_s"):
        return None
    flops = record["forward_flops"] * (3 * record["images_trained"]
                                       + record["images_validated"])
    return 100.0 * flops / record["window_s"] / record["peak_flops"]
