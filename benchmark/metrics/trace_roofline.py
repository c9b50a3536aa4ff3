"""``trace_roofline``: kernel B1 (``trace_kernel``, ``csrc/trace.cu``)'s
roofline bound per call over its device time per call, in %.

The operations depend on the data: per ``propagate`` micro-step 81 f32
operations, per cell entry 28 f64 and 36 f32 (48 with emissivity), as
counted from the kernel's source (``chip_smoke.B1_OPS``). The micro-steps
and cell entries of one call are the plain reference's own counts for the
cell's unit (every call of a cell walks the same paths: the gain factors
move no trajectory). The bytes: the rays' coordinates in, the gain tables
read once, the path integrals and the exit ray out. The bound is the
larger of the bytes at 3.35 TB/s and the operations at 67 TFLOP/s f32
plus 34 TFLOP/s f64."""

from benchmark import peaks

STEP_F32, CELL_F32, CELL_F32_EMIS, CELL_F64 = 81, 36, 48, 28


def table_bytes(unit) -> int:
    """The gain tables B1 reads, in the padded layout: per segment the f64
    grids, the f32 cell widths, n, g0, E0 and edge gradients, the extents
    and the true sizes."""
    nx = max(len(g.x) for g in unit.gain)
    ny = max(len(g.y) for g in unit.gain)
    per_seg = (8 * (nx + ny) + 4 * (nx - 1 + ny - 1) + 3 * 4 * nx * ny
               + 4 * ((nx - 1) * ny + nx * (ny - 1)) + 16 + 1 + 8)
    return len(unit.gain) * per_seg


def call_bytes(unit, rays: int) -> int:
    """Rays in (4 f32), tables once, per ray and sub-length ``gvl``, ``evl``
    and ``ivl`` out, the exit ray (4 f32) and two flags out."""
    T = 3 * max(unit.N - 1, 0)
    return rays * 16 + table_bytes(unit) + rays * (12 * T + 16 + 2)


def call_ops(unit, steps: int, cells: int):
    """``(f32, f64)`` operations of one call with ``steps`` micro-steps and
    ``cells`` cell entries."""
    emis = unit.seed is None
    f32 = steps * STEP_F32 + cells * (CELL_F32_EMIS if emis else CELL_F32)
    return f32, cells * CELL_F64


def read(view: dict):
    counts = view.get("counts") or {}
    if not counts.get("steps"):
        return None
    run = view["run"]
    f32, f64 = call_ops(run.base, counts["steps"], counts["cells"])
    bound = peaks.bound_s(call_bytes(run.base, run.rays), f32, f64)
    return peaks.share(bound, peaks.device_s(
        view, lambda n: n == "trace_kernel"))
