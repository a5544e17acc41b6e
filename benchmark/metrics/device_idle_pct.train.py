"""Share of the profiled training epoch (host clock, synchronised) in which
no activity ran on the card: the epoch loop's and the captured step's host
work that the device waits for."""


def read(record):
    if record.get("kind") != "train" or not record.get("window_s"):
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
