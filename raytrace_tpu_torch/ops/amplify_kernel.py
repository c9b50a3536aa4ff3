"""Gain-only amplify wrapper: kernel B3 (``csrc/amplify.cu``) and its plain
twin.

Counterpart of the Pallas TPU kernel
``raytrace_tpu/ops/pallas_amplify.py::_loggain_kernel`` (launched by
``log_gain_fused``) and of the ``Iv0 * exp`` that follows it
(``raytrace_tpu/ops/spectrum.py:194``): the seeded path's amplification
(RayTraceImageHelper.h:569-581)

    Iv[b, k] = Iv0[b, k] * exp(sum over (seg, sub) of
                               gvl[b, seg, sub] * gv[seg][ivl[b, seg, sub], k])

with the log-gain summed in f64, segments outer and sub-lengths inner.

The TPU kernel carries the sum as a two-float f32 pair and fetches the rows
through a one-hot matmul over a bf16 triple of the tables
(``pallas_amplify.pack_gv``), because a TPU emulates f64 and has no per-lane
gather. Hopper has both, so the port sums in f64 and reads the f32 rows
directly; ``pack_gv`` has no counterpart here.

:func:`amplify_gain` dispatches on the tensors' device: CPU tensors take the
plain twin :func:`amplify_gain_plain`, CUDA tensors launch the kernel (or
raise). ``launch_count`` counts kernel launches.
"""

from __future__ import annotations

import torch

from raytrace_tpu_torch.ops import cuda_lib

__all__ = ["amplify_gain", "amplify_gain_plain", "log_gain_plain",
           "launch_count"]

#: kernel launches since import (or since a caller last reset it)
launch_count = 0


def log_gain_plain(ivl: torch.Tensor, gvl: torch.Tensor,
                   gv: torch.Tensor) -> torch.Tensor:
    """Total log-gain [B, K] f64: ``sum gvl[:, i, s] * gv[i][ivl[:, i, s]]``
    over segments i (outer) and sub-lengths s (inner), each product and sum
    rounded in f64."""
    B, nseg, nsub = ivl.shape
    gl = torch.zeros((B, gv.shape[2]), dtype=torch.float64, device=ivl.device)
    gvl64 = gvl.to(torch.float64)
    for i in range(nseg):
        for isub in range(nsub):
            gv_row = gv[i][ivl[:, i, isub].long()].to(torch.float64)
            gl = gl + gvl64[:, i, isub, None] * gv_row
    return gl


def amplify_gain_plain(Iv0: torch.Tensor, ivl: torch.Tensor,
                       gvl: torch.Tensor, gv: torch.Tensor) -> torch.Tensor:
    """Plain twin of kernel B3: ``Iv0 * exp(log_gain_plain(...))``;
    ``Iv0`` itself when there are no segments."""
    Iv = Iv0.to(torch.float64)
    if ivl.shape[1] == 0:
        return Iv
    return Iv * torch.exp(log_gain_plain(ivl, gvl, gv))


def _check(Iv0, ivl, gvl, gv):
    dev = Iv0.device
    if Iv0.dtype != torch.float64 or Iv0.dim() != 2 \
            or not Iv0.is_contiguous():
        raise ValueError("amplify_gain: Iv0 must be a contiguous float64 "
                         "[B, K] tensor")
    B, K = Iv0.shape
    if ivl.dim() != 3 or ivl.shape[0] != B:
        raise ValueError(f"amplify_gain: ivl must be [{B}, nseg, nsub]")
    nseg, nsub = ivl.shape[1], ivl.shape[2]
    for name, t, dtype in (("ivl", ivl, torch.int32),
                           ("gvl", gvl, torch.float32)):
        if (t.dtype != dtype or tuple(t.shape) != (B, nseg, nsub)
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"amplify_gain: {name} must be a contiguous "
                             f"{dtype} [{B}, {nseg}, {nsub}] tensor on {dev}")
    if (gv.dtype != torch.float32 or gv.dim() != 3 or gv.shape[0] != nseg
            or gv.shape[2] != K or gv.device != dev
            or not gv.is_contiguous()):
        raise ValueError(f"amplify_gain: gv must be a contiguous float32 "
                         f"[{nseg}, cells, {K}] tensor on {dev}")
    return B, K, nseg, nsub


def amplify_gain(Iv0: torch.Tensor, ivl: torch.Tensor, gvl: torch.Tensor,
                 gv: torch.Tensor) -> torch.Tensor:
    """Gain-only amplification [B, K] f64: kernel B3 for CUDA tensors, the
    plain twin for CPU tensors.

    ``Iv0`` [B, K] f64 entry spectra; ``ivl`` [B, nseg, nsub] i32 and
    ``gvl`` [B, nseg, nsub] f32 from the trace; ``gv`` [nseg, cells, K] f32
    lineshape tables of segments 1..N-1 in the cell layout ``ivl`` indexes
    (every id must lie in [0, cells), as the trace writes them). With no
    segments the result is ``Iv0`` and nothing is launched.
    """
    B, K, nseg, nsub = _check(Iv0, ivl, gvl, gv)
    if Iv0.device.type == "cpu":
        return amplify_gain_plain(Iv0, ivl, gvl, gv)
    if Iv0.device.type != "cuda":
        raise ValueError(f"amplify_gain: unsupported device {Iv0.device}")
    if nseg == 0 or B == 0:
        return Iv0
    stream = torch.cuda.current_stream(Iv0.device).cuda_stream
    Iv, _ = _launch(cuda_lib.load_library(), Iv0, ivl, gvl, gv, stream)
    global launch_count
    launch_count += 1
    return Iv


def _launch(lib, Iv0, ivl, gvl, gv, stream, log_gain=False):
    """Launch ``rt_amplify_gain`` of ``lib`` on ``stream``; inputs already
    checked. Returns ``(Iv, log-gain or None)``."""
    B, K = Iv0.shape
    _, nseg, nsub = ivl.shape
    Iv = torch.empty_like(Iv0)
    gl = torch.empty_like(Iv0) if log_gain else None
    rc = lib.rt_amplify_gain(Iv0.data_ptr(), ivl.data_ptr(), gvl.data_ptr(),
                             gv.data_ptr(), B, nseg * nsub, nsub, gv.shape[1],
                             K, Iv.data_ptr(),
                             None if gl is None else gl.data_ptr(), stream)
    cuda_lib.check(rc, "rt_amplify_gain")
    return Iv, gl
