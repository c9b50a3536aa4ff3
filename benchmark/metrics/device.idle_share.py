"""``device.idle_share``: over the traced stretch, one minus the share of
its wall time in which some kernel, copy or memset ran, in %; on a mesh
the mean over its cards."""


def read(view: dict):
    tr = view.get("trace")
    if tr is None or tr["window_s"] <= 0 or not tr["busy_s"]:
        return None
    busy = sum(tr["busy_s"]) / len(tr["busy_s"])
    return 100.0 * (1.0 - busy / tr["window_s"])
