"""Images per device batch of the micro-batcher over the window: the growth
of its ``images`` counter over the growth of its ``batches`` counter."""


def read(record):
    if record.get("kind") != "serve":
        return None
    before, after = record["stats_before"], record["stats_after"]
    batches = after["batches"] - before["batches"]
    return (after["images"] - before["images"]) / batches if batches else None
