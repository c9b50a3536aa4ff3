"""``create_image_stream`` over a generator of fresh units, at the mix's
``depth`` and with its ``reorder`` (the cost-feedback reorder, off unless
the mix sets it): the stream keeps ``depth`` calls dispatched, so the
host's preparation of one unit overlaps the device's work on the one
before. A unit's latency runs from the stream's pull of it to its yield;
the generator stops at the deadline and the stream drains."""

from __future__ import annotations

import time
from collections import deque


def _stream(run, units):
    from raytrace_tpu_torch.models.ray_tracer import create_image_stream

    return create_image_stream(units, run.method, None, run.dtype, 0.5,
                               "auto", int(run.traffic["depth"]),
                               run.failed_ray_path, None,
                               bool(run.traffic.get("reorder", False)),
                               device=run.devices[0])


def warm_up(run, calls: int) -> None:
    """A whole stream of ``calls`` units (at least depth + 1, so that
    every graph of the depth is captured and replayed)."""
    n = max(calls, int(run.traffic["depth"]) + 1)
    for _ in _stream(run, (run.next_unit()[2] for _ in range(n))):
        pass


def window(run, deadline: float) -> None:
    from raytrace_tpu_torch.utils.errors import RayTraceError

    pulled = deque()

    def units():
        while time.perf_counter() < deadline:
            with run.span("table_step"):
                idx, f, p = run.next_unit()
            pulled.append((idx, f, time.perf_counter()))
            yield p

    stream = _stream(run, units())
    while True:
        try:
            with run.span("stream_next"):
                out = next(stream)
        except StopIteration:
            return
        except RayTraceError:
            idx, f, t0 = pulled.popleft()
            run.done(idx, f, t0, time.perf_counter(), None)
            stream.close()
            return
        idx, f, t0 = pulled.popleft()
        run.done(idx, f, t0, time.perf_counter(), out)
