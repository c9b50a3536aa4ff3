"""Trace wrapper: kernel B1 (``csrc/trace.cu``) and its plain twin.

Counterpart of the Pallas TPU kernel
``raytrace_tpu/ops/pallas_kernel.py::_stepper_kernel`` (launched by
``trace_tiles``). The CUDA kernel runs one thread per ray through the whole
multi-segment trace and computes what
:func:`raytrace_tpu_torch.ops.stepper.trace_batch_plain` computes per lane;
see ``csrc/trace.cu`` for its design and precision placement.

:func:`trace_batch` dispatches on the tensors' device: CPU tensors take the
plain twin, CUDA tensors launch the kernel (C entry :data:`ENTRY`, booked in
``cuda_lib``'s launch ledger) or raise, on their own card. With
``counts=True`` both also return each ray's
number of propagate micro-steps (the counts variant the stream's reorder
sorts by; the Pallas kernel's ``trace_tiles(counts=True)``).
"""

from __future__ import annotations

import contextlib

import torch

from raytrace_tpu_torch.models.problem import DeviceGain
from raytrace_tpu_torch.ops import cuda_lib
from raytrace_tpu_torch.ops.stepper import N_SUB, TraceResult, \
    trace_batch_plain

__all__ = ["trace_batch", "trace_batch_plain", "ENTRY"]

#: the kernel's C entry
ENTRY = "rt_trace"

_GAIN_DTYPES = {"x": torch.float64, "y": torch.float64, "cdx": torch.float32,
                "cdy": torch.float32, "n4": torch.float32,
                "g0": torch.float32, "E0": torch.float32,
                "Gx": torch.float32, "Gy": torch.float32,
                "range4": torch.float32, "nx": torch.int32,
                "ny": torch.int32}


def _check_inputs(rays: dict, gain: DeviceGain, N: int) -> int:
    B = rays["x"].shape[0]
    dev = rays["x"].device
    for k in "xyab":
        t = rays[k]
        if (t.dtype != torch.float32 or t.shape != (B,) or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"ray '{k}' must be a contiguous float32 [B] "
                             f"tensor on {dev}")
    Nseg, nx_pad = gain.x.shape
    ny_pad = gain.y.shape[1]
    if Nseg != N:
        raise ValueError(f"gain tables hold {Nseg} segments, N = {N}")
    cells = nx_pad * ny_pad
    shapes = {"x": (N, nx_pad), "y": (N, ny_pad), "cdx": (N, nx_pad - 1),
              "cdy": (N, ny_pad - 1), "n4": (N, cells), "g0": (N, cells),
              "E0": (N, cells), "Gx": (N, (nx_pad - 1) * ny_pad),
              "Gy": (N, nx_pad * (ny_pad - 1)), "range4": (N, 4),
              "nx": (N,), "ny": (N,)}
    for k, shape in shapes.items():
        t = getattr(gain, k)
        if (t.dtype != _GAIN_DTYPES[k] or tuple(t.shape) != shape
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"gain.{k} must be a contiguous "
                             f"{_GAIN_DTYPES[k]} {shape} tensor on {dev}")
    return B


def trace_batch(rays: dict, N: int, dz0: float, gain: DeviceGain,
                method: int, c: float = 0.5, use_emis: bool = True,
                counts: bool = False):
    """Trace a batch of rays: kernel B1 for CUDA tensors, the plain twin for
    CPU tensors. Arguments and result as
    :func:`~raytrace_tpu_torch.ops.stepper.trace_batch_plain`."""
    dev = rays["x"].device
    if dev.type == "cpu":
        return trace_batch_plain(rays, N, dz0, gain, method, c, use_emis,
                                 counts)
    if dev.type != "cuda":
        raise ValueError(f"trace_batch: unsupported device {dev}")
    B = _check_inputs(rays, gain, N)
    stream = torch.cuda.current_stream(dev).cuda_stream
    return _launch(cuda_lib.load_library(), rays, B, N, dz0, gain, method, c,
                   use_emis, stream, counts)


#: the refill's two counters per (device, stream): zero between launches,
#: since each launch's last thread zeroes them
_counters: dict = {}
#: the pair that launches use in place of their stream's, inside
#: :func:`own_counters`
_own = None


@contextlib.contextmanager
def own_counters(pair: torch.Tensor):
    """Every launch inside uses ``pair`` (two int64 zeros on its device) as
    the refill's counters in place of its stream's. A captured CUDA
    graph bakes in the pair it was captured with, so each graph keeps a
    pair of its own: two graphs that shared one and ran at once (two
    stream slots, two mesh entries of one card) would take each other's
    rays."""
    global _own
    old, _own = _own, pair
    try:
        yield
    finally:
        _own = old


def _counter(dev: torch.device, stream) -> torch.Tensor:
    if _own is not None:
        return _own
    key = (str(dev), stream)
    ctr = _counters.get(key)
    if ctr is None:
        # setdefault: threads that race here all get the same pair
        ctr = _counters.setdefault(
            key, torch.zeros(2, dtype=torch.int64, device=dev))
    return ctr


def _launch(lib, rays, B, N, dz0, gain, method, c, use_emis, stream,
            counts=False, census=False):
    """Allocate the outputs and launch :data:`ENTRY` of ``lib`` on
    ``stream`` (none for a batch of no rays); inputs already checked.
    Returns the TraceResult; with ``counts`` also the micro-step counts,
    and with ``census`` also each ray's number of cell entries and the
    micro-step iterations the launch's warps issued (``(res, steps, cells,
    warp_steps)``, ``warp_steps`` one int64: for the operation count of the
    kernel's bound and the micro-step lane fill, ``steps.sum() / (32 *
    warp_steps)``)."""
    dev = rays["x"].device
    nseg = max(N - 1, 0)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    gvl = torch.empty((B, nseg, N_SUB), **f32)
    evl = torch.empty((B, nseg, N_SUB), **f32)
    ivl = torch.empty((B, nseg, N_SUB), **i32)
    ex, ey, ea, eb = (torch.empty(B, **f32) for _ in range(4))
    esc = torch.empty(B, dtype=torch.uint8, device=dev)
    perp = torch.empty(B, dtype=torch.uint8, device=dev)
    steps = torch.empty(B, **i32) if counts or census else None
    cells = torch.empty(B, **i32) if census else None
    warp_steps = torch.zeros(1, dtype=torch.int64, device=dev) \
        if census else None
    if B > 0:
        absy = gain.abs_y.to(torch.int32)
        cuda_lib.launch(
            lib, ENTRY, dev,
            rays["x"].data_ptr(), rays["y"].data_ptr(),
            rays["a"].data_ptr(), rays["b"].data_ptr(), B,
            gain.x.data_ptr(), gain.y.data_ptr(), gain.cdx.data_ptr(),
            gain.cdy.data_ptr(), gain.n4.data_ptr(), gain.g0.data_ptr(),
            gain.E0.data_ptr(), gain.Gx.data_ptr(), gain.Gy.data_ptr(),
            gain.range4.data_ptr(), absy.data_ptr(), gain.nx.data_ptr(),
            gain.ny.data_ptr(), gain.x.shape[1], gain.y.shape[1], N,
            float(dz0), float(c), int(method), int(bool(use_emis)),
            gvl.data_ptr(), evl.data_ptr(), ivl.data_ptr(),
            ex.data_ptr(), ey.data_ptr(), ea.data_ptr(), eb.data_ptr(),
            esc.data_ptr(), perp.data_ptr(),
            None if steps is None else steps.data_ptr(),
            None if cells is None else cells.data_ptr(),
            None if warp_steps is None else warp_steps.data_ptr(),
            _counter(dev, stream).data_ptr(), stream)
    res = TraceResult(gvl=gvl, evl=evl, ivl=ivl, exit_x=ex, exit_y=ey,
                      exit_a=ea, exit_b=eb, escaped=esc.view(torch.bool),
                      perp=perp.view(torch.bool))
    if census:
        return res, steps, cells, warp_steps
    return (res, steps) if counts else res


def find_index_launch(lib, X: torch.Tensor, y: torch.Tensor,
                      stream) -> torch.Tensor:
    """The kernel's interval search (``rt_find_index`` of ``lib``) over the
    f64 queries ``y`` on the f64 grid ``X`` (at least 2 points): the first
    i in [1, n-1] with X[i] >= y, or n-1, as int32."""
    if X.dtype != torch.float64 or X.dim() != 1 or X.shape[0] < 2:
        raise ValueError("find_index_launch: X must be a float64 grid of at "
                         "least 2 points")
    X, y = X.contiguous(), y.to(torch.float64).contiguous()
    out = torch.empty(y.shape, dtype=torch.int32, device=y.device)
    cuda_lib.launch(lib, "rt_find_index", y.device, X.data_ptr(), X.shape[0],
                    y.data_ptr(), y.numel(), out.data_ptr(), stream)
    return out
