"""``amplify_f32.kernels``: the amplify layer's kernel launches per traced
call, on the device trace: the kernels of the traced stretch that are
neither B1 nor B2 (``amplify_f32_roofline``'s selection), counted by their
start inside the stretch, over the traced calls. The f32 amplify runs
inside the call's one CUDA graph, so no host span wraps it on replay; the
count shows the layer's structure (a chain of elementwise kernels, or one
kernel a chunk). None without a trace, where the configuration's spectrum
is not f32, or where no such kernel ran."""

from benchmark.devtrace import kernel_base, short_name

NOT_AMPLIFY = ("trace_kernel", "bin_deposit_kernel", "bin_deposit_f32_kernel")


def launches(data: dict) -> int | None:
    """Kernels that start inside the ``bench.stretch`` annotation of the
    Chrome trace ``data`` and are neither B1 nor B2; None without the
    stretch."""
    events = data.get("traceEvents", [])
    stretch = [e for e in events if e.get("ph") == "X"
               and e.get("cat") == "user_annotation"
               and e.get("name") == "bench.stretch"]
    if not stretch:
        return None
    lo = float(stretch[0]["ts"])
    hi = lo + float(stretch[0]["dur"])
    return sum(1 for e in events
               if e.get("ph") == "X" and e.get("cat") == "kernel"
               and lo <= float(e["ts"]) < hi
               and kernel_base(short_name(str(e.get("name", ""))))
               not in NOT_AMPLIFY)


def read(view: dict):
    run = view["run"]
    calls = view.get("traced_calls") or 0
    data = getattr(run.capture, "data", None)
    if (run.config["spectrum_dtype"] != "float32" or calls <= 0
            or data is None):
        return None
    n = launches(data)
    return n / calls if n else None
