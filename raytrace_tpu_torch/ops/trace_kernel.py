"""Trace wrapper: kernel B1 (``csrc/trace.cu``) and its plain twin.

Counterpart of the Pallas TPU kernel
``raytrace_tpu/ops/pallas_kernel.py::_stepper_kernel`` (launched by
``trace_tiles``). The CUDA kernel runs one thread per ray through the whole
multi-segment trace and computes what
:func:`raytrace_tpu_torch.ops.stepper.trace_batch_plain` computes per lane;
see ``csrc/trace.cu`` for its design and precision placement.

:func:`trace_batch` dispatches on the tensors' device: CPU tensors take the
plain twin, CUDA tensors launch the kernel (or raise). ``launch_count``
counts kernel launches.
"""

from __future__ import annotations

import torch

from raytrace_tpu_torch.models.problem import DeviceGain
from raytrace_tpu_torch.ops import cuda_lib
from raytrace_tpu_torch.ops.stepper import N_SUB, TraceResult, \
    trace_batch_plain

__all__ = ["trace_batch", "trace_batch_plain", "launch_count"]

#: kernel launches since import (or since a caller last reset it)
launch_count = 0

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
                method: int, c: float = 0.5,
                use_emis: bool = True) -> TraceResult:
    """Trace a batch of rays: kernel B1 for CUDA tensors, the plain twin for
    CPU tensors. Arguments and result as
    :func:`~raytrace_tpu_torch.ops.stepper.trace_batch_plain`."""
    dev = rays["x"].device
    if dev.type == "cpu":
        return trace_batch_plain(rays, N, dz0, gain, method, c, use_emis)
    if dev.type != "cuda":
        raise ValueError(f"trace_batch: unsupported device {dev}")
    B = _check_inputs(rays, gain, N)
    nseg = max(N - 1, 0)
    if nseg == 0 or B == 0:
        # nothing to trace: the exit ray is the entry ray
        return trace_batch_plain(rays, N, dz0, gain, method, c, use_emis)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = _launch(cuda_lib.load_library(), rays, B, N, dz0, gain, method, c,
                  use_emis, stream)
    global launch_count
    launch_count += 1
    return out


def _launch(lib, rays, B, N, dz0, gain, method, c, use_emis,
            stream) -> TraceResult:
    """Allocate the outputs and launch ``rt_trace`` of ``lib`` on
    ``stream``; inputs already checked."""
    dev = rays["x"].device
    nseg = N - 1
    f32 = dict(dtype=torch.float32, device=dev)
    gvl = torch.empty((B, nseg, N_SUB), **f32)
    evl = torch.empty((B, nseg, N_SUB), **f32)
    ivl = torch.empty((B, nseg, N_SUB), dtype=torch.int32, device=dev)
    ex, ey, ea, eb = (torch.empty(B, **f32) for _ in range(4))
    esc = torch.empty(B, dtype=torch.uint8, device=dev)
    perp = torch.empty(B, dtype=torch.uint8, device=dev)
    absy = gain.abs_y.to(torch.int32)
    rc = lib.rt_trace(
        rays["x"].data_ptr(), rays["y"].data_ptr(), rays["a"].data_ptr(),
        rays["b"].data_ptr(), B,
        gain.x.data_ptr(), gain.y.data_ptr(), gain.cdx.data_ptr(),
        gain.cdy.data_ptr(), gain.n4.data_ptr(), gain.g0.data_ptr(),
        gain.E0.data_ptr(), gain.Gx.data_ptr(), gain.Gy.data_ptr(),
        gain.range4.data_ptr(), absy.data_ptr(), gain.nx.data_ptr(),
        gain.ny.data_ptr(), gain.x.shape[1], gain.y.shape[1], N,
        float(dz0), float(c), int(method), int(bool(use_emis)),
        gvl.data_ptr(), evl.data_ptr(), ivl.data_ptr(), ex.data_ptr(),
        ey.data_ptr(), ea.data_ptr(), eb.data_ptr(), esc.data_ptr(),
        perp.data_ptr(), stream)
    cuda_lib.check(rc, "rt_trace")
    return TraceResult(gvl=gvl, evl=evl, ivl=ivl, exit_x=ex, exit_y=ey,
                       exit_a=ea, exit_b=eb, escaped=esc.view(torch.bool),
                       perp=perp.view(torch.bool))
