"""``wait.host_ms``: the host blocked on a call's readback event, the mean
over the window of the program's ``wait`` span (``utils.timer.profiler``),
in ms. In a stream the wait is on the oldest call in flight."""

from benchmark.spans import span_ms_reader

read = span_ms_reader("wait")
