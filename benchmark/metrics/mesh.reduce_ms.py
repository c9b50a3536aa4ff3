"""``mesh.reduce_ms``: the cross-card reduction's device time per sharded
call (the peer copies and adds on the first card, between the call's own
reduction events), the mean over the window of the program's
``mesh.reduce`` value (``utils.timer.profiler``), in ms; None off the
card, where a call records no events."""

from benchmark.spans import span_ms_reader

read = span_ms_reader("mesh.reduce")
