"""``call_p95_s``: the 95th percentile of one call's latency over every
call of the window (host clock): entry to images for a synchronous call,
the stream's pull of a unit to its yield for a stream. None with fewer
than 20 calls, where no call lies beyond the percentile."""

import numpy as np


def read(view: dict):
    lat = view["run"].latencies
    if len(lat) < 20:
        return None
    return float(np.percentile(np.asarray(lat, np.float64), 95))
