"""The open-loop client: its schedule is fixed by the seed, and latency is
timed from the due time, also against a server that stalls."""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from benchmark import data, harness


def test_the_poisson_schedule_is_fixed_by_the_seed():
    a, b = data.arrivals(5, 200.0, 10.0), data.arrivals(5, 200.0, 10.0)
    assert np.array_equal(a, b) and len(a) == 2000 and a[0] == 0.0
    c = data.arrivals(6, 200.0, 10.0)
    assert not np.array_equal(a, c)
    # every seed offers the same gaps, in another order, over the same span
    shared = np.intersect1d(np.round(np.diff(a), 12), np.round(np.diff(c), 12))
    assert len(shared) >= len(a) - 2  # each drops its own first gap
    assert abs(a[-1] - c[-1]) < 0.2 and 9.0 < a[-1] < 10.0
    gaps = np.diff(a)
    assert abs(gaps.mean() * 200 - 1) < 0.01 and abs(gaps.std() / gaps.mean() - 1) < 0.05


class _Stalling(BaseHTTPRequestHandler):
    """Answers ``{"latency_ms": 1}``; the first request holds every later
    one behind it for ``STALL_S`` (one lock)."""

    STALL_S = 0.5
    lock = threading.Lock()
    first = True

    def log_message(self, *args):
        pass

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        with _Stalling.lock:
            if _Stalling.first:
                _Stalling.first = False
                time.sleep(self.STALL_S)
        body = json.dumps({"latency_ms": 1.0}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def test_latency_counts_from_the_due_time_against_a_server_that_stalls(tmp_path):
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Stalling)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        drv = harness.traffic_driver("open_loop_http")
        due = np.arange(20) * 0.02  # 20 requests over 0.38 s, all due inside the stall
        pool = np.zeros((2, 8, 8), np.uint8)
        start = time.monotonic() + 1.0
        res = drv.offer(server.server_address[1], pool, due, np.zeros(20, int), [0], start,
                        str(tmp_path))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    lat = np.asarray(res["latency_s"])
    assert all(s == 200 for s in res["status"])
    # open loop: sent on time while the server stalled
    assert max(res["late_s"]) < 0.1
    # each waited from its due time to the end of the stall
    stall_end = _Stalling.STALL_S
    assert np.all(lat >= stall_end - due - 0.02)
    assert lat[0] >= stall_end and lat[-1] < lat[0]
    assert drv.tail_ms(res["latency_s"], res["wait_s"]) >= (stall_end - due[-1]) * 1e3
    assert "0" in res["kept"]


def test_a_missing_answer_counts_above_every_answered_one():
    drv = harness.traffic_driver("open_loop_http")
    latency = [0.01] * 18 + [None, None]
    assert drv.tail_ms(latency, 61.0) == 61.0 * 1e3
    assert drv.tail_ms([0.01] * 20, 61.0) == 10.0
