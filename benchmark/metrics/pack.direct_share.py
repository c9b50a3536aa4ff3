"""``pack.direct_share``: the share of the window's calls whose tables the
host packed straight into the page-locked staging buffer of the CUDA graph
that replays the call, with no fresh buffer and no staging copy, in %: the
program's ``pack.direct`` value (``utils.timer.profiler``, 1 for such a
pack and 0 for any other, one a pack), its total over its count. 0 on a
mesh, whose tables are packed once for every card and copied to each.
None where the program recorded no ``pack.direct``."""


def read(view: dict):
    n = view["timer"]["counts"].get("pack.direct", 0)
    if n <= 0:
        return None
    return 100.0 * view["timer"]["totals"]["pack.direct"] / n
