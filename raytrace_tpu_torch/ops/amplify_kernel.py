"""Seeded amplify wrapper: kernel B3 (``csrc/amplify.cu``) and its plain
twin.

Counterpart of the Pallas TPU kernel
``raytrace_tpu/ops/pallas_amplify.py::_loggain_kernel`` (launched by
``log_gain_fused``) and of the ``Iv0 * exp`` that follows it
(``raytrace_tpu/ops/spectrum.py:194``): the seeded path's amplification
(RayTraceImageHelper.h:569-581)

    Iv[b, k] = Iv0[b, k] * exp(sum over (seg, sub) of
                               gvl[b, seg, sub] * gv[seg][ivl[b, seg, sub], k])

with the log-gain summed in f64, segments outer and sub-lengths inner. The
entry spectrum is the separable seed ``Iv0[b, k] = f[b] * fv[k]``, zero for
a ray that escaped (``ops/seed.py``); it is formed inside the kernel and
never stored. Beside ``Iv`` the kernel returns one flag byte per ray (bit 0:
some ``Iv[b, k] < 0``, bit 1: some ``Iv[b, k]`` is NaN), from which the
call builds the failure codes -2 and -3.

The TPU kernel carries the sum as a two-float f32 pair and fetches the rows
through a one-hot matmul over a bf16 triple of the tables
(``pallas_amplify.pack_gv``), because a TPU emulates f64 and has no per-lane
gather. Hopper has both, so the port sums in f64 and reads the f32 rows
directly; ``pack_gv`` has no counterpart here.

:func:`amplify_gain` dispatches on the tensors' device: CPU tensors take the
plain twin :func:`amplify_gain_plain`, CUDA tensors launch the kernel (or
raise) on their own card. ``launch_count`` counts kernel launches,
``device_launches`` them per device.
"""

from __future__ import annotations

import torch

from raytrace_tpu_torch.ops import cuda_lib

__all__ = ["amplify_gain", "amplify_gain_plain", "log_gain_plain",
           "iv_flags", "FLAG_NEG", "FLAG_NAN", "launch_count",
           "device_launches"]

#: flag bits per ray: some Iv < 0 (failure code -2), some Iv NaN (code -3)
FLAG_NEG, FLAG_NAN = 1, 2

#: the kernel's widest spectrum (one thread per frequency or pair)
_K_MAX = 256

#: kernel launches since import (or since a caller last reset it)
launch_count = 0
#: the same launches per device
device_launches: dict = {}


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


def iv_flags(Iv: torch.Tensor) -> torch.Tensor:
    """Per-ray flag bytes [B] u8 of spectra [B, K]: :data:`FLAG_NEG` where
    some entry is negative, :data:`FLAG_NAN` where some entry is NaN."""
    neg = torch.any(Iv < 0.0, dim=1).to(torch.uint8)
    nan = torch.any(Iv != Iv, dim=1).to(torch.uint8)
    return neg * FLAG_NEG | nan * FLAG_NAN


def amplify_gain_plain(f: torch.Tensor, fv: torch.Tensor,
                       escaped: torch.Tensor, ivl: torch.Tensor,
                       gvl: torch.Tensor, gv: torch.Tensor):
    """Plain twin of kernel B3: ``(Iv, flags)`` with ``Iv = where(escaped,
    0, f * fv) * exp(log_gain_plain(...))`` and ``flags = iv_flags(Iv)``."""
    Iv0 = f[:, None] * fv[None, :]
    Iv0 = torch.where(escaped[:, None], 0.0, Iv0)
    Iv = Iv0 * torch.exp(log_gain_plain(ivl, gvl, gv))
    return Iv, iv_flags(Iv)


def _check(f, fv, escaped, ivl, gvl, gv):
    dev = f.device
    B, K = f.shape[0], fv.shape[0]
    for name, t, dtype, shape in (("f", f, torch.float64, (B,)),
                                  ("fv", fv, torch.float64, (K,)),
                                  ("escaped", escaped, torch.bool, (B,))):
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"amplify_gain: {name} must be a contiguous "
                             f"{dtype} {list(shape)} tensor on {dev}")
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


def amplify_gain(f: torch.Tensor, fv: torch.Tensor, escaped: torch.Tensor,
                 ivl: torch.Tensor, gvl: torch.Tensor, gv: torch.Tensor):
    """Seeded gain-only amplification: ``(Iv [B, K] f64, flags [B] u8)``,
    kernel B3 for CUDA tensors, the plain twin for CPU tensors.

    ``f`` [B] f64 seed factor per ray (zeros for a call without a seed);
    ``fv`` [K] f64 frequency profile; ``escaped`` [B] bool from the trace;
    ``ivl`` [B, nseg, nsub] i32 and ``gvl`` [B, nseg, nsub] f32 from the
    trace; ``gv`` [nseg, cells, K] f32 lineshape tables of segments 1..N-1
    in the cell layout ``ivl`` indexes (every id must lie in [0, cells), as
    the trace writes them). With no segments ``Iv`` is the masked entry
    spectrum.
    """
    B, K, nseg, nsub = _check(f, fv, escaped, ivl, gvl, gv)
    if f.device.type == "cpu":
        return amplify_gain_plain(f, fv, escaped, ivl, gvl, gv)
    if f.device.type != "cuda":
        raise ValueError(f"amplify_gain: unsupported device {f.device}")
    if K > _K_MAX:
        raise ValueError(f"amplify_gain: the kernel takes K <= {_K_MAX}, "
                         f"got {K}")
    if B == 0:
        return (torch.empty((0, K), dtype=torch.float64, device=f.device),
                torch.empty(0, dtype=torch.uint8, device=f.device))
    stream = torch.cuda.current_stream(f.device).cuda_stream
    Iv, flags, _ = _launch(cuda_lib.load_library(), f, fv, escaped, ivl, gvl,
                           gv, stream)
    global launch_count
    launch_count += 1
    cuda_lib.count_launch(device_launches, f.device)
    return Iv, flags


def _launch(lib, f, fv, escaped, ivl, gvl, gv, stream, log_gain=False):
    """Launch ``rt_amplify_seeded`` of ``lib`` on ``stream``; inputs already
    checked. Returns ``(Iv, flags, log-gain or None)``."""
    B, K = f.shape[0], fv.shape[0]
    _, nseg, nsub = ivl.shape
    dev = f.device
    Iv = torch.empty((B, K), dtype=torch.float64, device=dev)
    # whole 32-bit words: the kernel sets a ray's byte with a word atomicOr
    flags = torch.empty(-(-max(B, 1) // 4) * 4, dtype=torch.uint8,
                        device=dev)
    gl = torch.empty_like(Iv) if log_gain else None
    pairs = K % 2 == 0 and gv.data_ptr() % 8 == 0
    with cuda_lib.device_guard(dev):
        rc = lib.rt_amplify_seeded(
            f.data_ptr(), fv.data_ptr(), escaped.data_ptr(), ivl.data_ptr(),
            gvl.data_ptr(), gv.data_ptr(), B, nseg, nsub, gv.shape[1], K,
            int(pairs), Iv.data_ptr(), flags.data_ptr(),
            None if gl is None else gl.data_ptr(), stream)
    cuda_lib.check(rc, "rt_amplify_seeded")
    return Iv, flags[:B], gl
