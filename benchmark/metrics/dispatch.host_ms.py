"""``dispatch.host_ms``: the host's enqueue of one call, the mean over the
window of the program's ``dispatch`` span (``utils.timer.profiler``), in
ms: the copy of the tables into the graph's staging buffer and the
graph's replay (on a mesh every card's replay in turn, the reduction's and
the readback's enqueue), a graph's capture where one is built."""

from benchmark.spans import span_ms_reader

read = span_ms_reader("dispatch")
