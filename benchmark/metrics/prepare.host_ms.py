"""``prepare.host_ms``: the host's ``prepare_pipeline`` per synchronous
call (validation, table packing, the pipeline cache's lookup), from the
program's own ``utils.timer.profiler`` over the traced run's window: the
``create_image`` region's total less its method region's
(``propagate_*-<method>``), over the calls. Both regions close after a
device synchronise."""


def read(view: dict):
    totals, counts = view["timer"]["totals"], view["timer"]["counts"]
    calls = counts.get("create_image", 0)
    inner = [k for k in totals if k.startswith("propagate_")]
    if calls <= 0 or not inner:
        return None
    host = totals["create_image"] - sum(totals[k] for k in inner)
    return 1e3 * host / calls
