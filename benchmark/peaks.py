"""The published peaks of one NVIDIA H100 (SXM part, NVIDIA's data sheet,
dense rates at the full 700 W power limit), and the roofline bound of a
piece of work on them (as ``chip_smoke.bound`` takes it)."""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "F32_OPS_PER_S", "F64_OPS_PER_S", "bound_s",
           "device_s", "share"]

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12


def bound_s(nbytes: float, f32_ops: float = 0.0, f64_ops: float = 0.0):
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over their peak rates (the f32 and
    f64 times added), in seconds."""
    return max(nbytes / HBM_BYTES_PER_S,
               f32_ops / F32_OPS_PER_S + f64_ops / F64_OPS_PER_S)


def device_s(view: dict, select) -> float | None:
    """Device seconds per traced call of the kernels whose own name
    (``devtrace.kernel_base``) ``select`` accepts; None without a trace or
    without such a kernel."""
    from benchmark.devtrace import kernel_base

    tr, calls = view.get("trace"), view.get("traced_calls") or 0
    if tr is None or calls <= 0:
        return None
    total = sum(s for n, s in tr["kernel_s"].items() if select(kernel_base(n)))
    return total / calls if total > 0 else None


def share(bound: float, seconds: float | None) -> float | None:
    """A roofline share in %: the bound over the time taken."""
    return None if not seconds else 100.0 * bound / seconds
