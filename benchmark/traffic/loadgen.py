"""The open-loop client: a process of its own that sends one-image
``POST /predict?mask=1`` requests at their due times, whether or not
earlier ones have been answered, each on a connection of its own.

    python benchmark/traffic/loadgen.py <spec.json>

The spec names the server's port, the start (``time.monotonic()``, which
every process of the machine shares), the due times (s after the start),
each request's image in a pool (``.npy``, uint8 (N, S, S)), the requests
whose answers are kept whole, and where to write the results. After the
last due time it waits up to ``grace_s`` for the answers still out; a
request then unanswered counts as missing. Standard library and numpy only.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time

import numpy as np


async def _request(host: str, port: int, body: bytes):
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(b"POST /predict?mask=1 HTTP/1.1\r\nHost: %s\r\n"
                     b"Content-Type: application/octet-stream\r\nContent-Length: %d\r\n"
                     b"Connection: close\r\n\r\n" % (host.encode(), len(body)) + body)
        await writer.drain()
        data = await reader.read()
    finally:
        writer.close()
    head, _, payload = data.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1]) if head.startswith(b"HTTP/") else 0
    return status, payload


async def offer(spec: dict) -> dict:
    pool = np.load(spec["pool"])
    bodies = [np.ascontiguousarray(p).tobytes() for p in pool]
    due = spec["due"]
    which = spec["image"]
    t0 = spec["start"]
    n = len(due)
    sent, done, status = [None] * n, [None] * n, [0] * n
    payload = [b""] * n

    async def one(i: int) -> None:
        sent[i] = time.monotonic()
        try:
            status[i], payload[i] = await _request(spec["host"], spec["port"],
                                                   bodies[which[i]])
            done[i] = time.monotonic()
        except Exception as e:  # a failed request is recorded, the stream goes on
            payload[i] = repr(e).encode()

    tasks = []
    for i in range(n):
        wait = t0 + due[i] - time.monotonic()
        if wait > 0:
            await asyncio.sleep(wait)
        tasks.append(asyncio.create_task(one(i)))
    end = t0 + due[-1] + spec["grace_s"]
    pending = [t for t in tasks if not t.done()]
    if pending:
        _, pending = await asyncio.wait(pending, timeout=max(end - time.monotonic(), 0.0))
    for t in pending:
        t.cancel()
    await asyncio.gather(*pending, return_exceptions=True)
    latency = [None if d is None else d - (t0 + u) for d, u in zip(done, due)]
    keep = set(spec["keep"])
    answered = [i for i in range(n) if status[i] == 200 and latency[i] is not None]
    if answered:
        keep.add(max(answered, key=lambda i: latency[i]))  # the slowest answer too
    handler = [None] * n  # the server's own latency_ms of each answer
    for i in answered:
        try:
            handler[i] = json.loads(payload[i])["latency_ms"]
        except (ValueError, KeyError):
            pass
    late = [s - (t0 + u) for s, u in zip(sent, due) if s is not None]
    return {"latency_s": latency, "status": status, "handler_ms": handler,
            "late_s": late, "wait_s": end - t0,
            "kept": {str(i): payload[i].decode(errors="replace") for i in sorted(keep)
                     if status[i] == 200}}


def main(path: str) -> int:
    with open(path) as f:
        spec = json.load(f)
    out = asyncio.run(offer(spec))
    with open(spec["out"], "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
