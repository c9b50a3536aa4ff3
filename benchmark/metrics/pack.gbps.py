"""``pack.gbps``: the rate at which the host writes a call's tables, in GB/s:
the total of the program's ``pack.bytes`` value (``utils.timer.profiler``:
the bytes of the tables one pack wrote, padding included, one value a pack)
over the total of its ``pack`` span, in the window. None where the program
recorded no ``pack.bytes`` or no ``pack`` time."""


def read(view: dict):
    totals = view["timer"]["totals"]
    seconds = totals.get("pack", 0.0)
    if view["timer"]["counts"].get("pack.bytes", 0) <= 0 or seconds <= 0:
        return None
    return totals["pack.bytes"] / seconds / 1e9
