"""``graph.captures``: the CUDA graphs the program built in the window (the
count of its ``capture`` span, ``utils.timer.profiler``): 0 where every
config's graphs were built in the warm-up. None where no ``dispatch``
span ran: a program without the spans, or an empty window."""


def read(view: dict):
    counts = view["timer"]["counts"]
    if counts.get("dispatch", 0) <= 0:
        return None
    return counts.get("capture", 0)
