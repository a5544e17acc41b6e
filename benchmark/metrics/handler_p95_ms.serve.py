"""95th percentile of the HTTP handler's own ``latency_ms`` field (decode to
response body, as the server measures it) over every answered request of
the window."""

import numpy as np


def read(record):
    values = record.get("handler_ms") if record.get("kind") == "serve" else None
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), 95))
