"""Share of a profiled stretch of the serving window (host clock) in which no
activity ran on the card: what the HTTP layer, the batcher's wait and the
backend's host work leave it idle."""


def read(record):
    if record.get("kind") != "serve" or not record.get("window_s"):
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
