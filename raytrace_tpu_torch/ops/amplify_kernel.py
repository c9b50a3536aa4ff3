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
gather. Hopper has both, so by default the port sums in f64 and reads the
f32 rows directly; ``pack_gv`` has no counterpart here. ``dtype=
torch.float32`` runs the TPU kernel's own arithmetic, ``raytrace_tpu``'s
default spectrum (``spectrum.py:186-193``): the log-gain as a two-float
pair summed with error-free products and sums (``ops/twofloat.py``), then
``Iv = f32(where(escaped, 0, f * fv)) * exp_fast2(hi, lo)``, the seed
product formed in f64 and rounded once, as ``raytrace_tpu`` rounds its f64
entry seed; the flags are taken on the f32 spectrum. The twin forms each
product's error by Dekker's split product, as ``raytrace_tpu`` does; the
kernel by one fused multiply-add, which gives the same bits wherever the
product is an exact zero or finite with magnitude at least 2^-100
(``csrc/amplify.cu``).

:func:`amplify_gain` dispatches on the tensors' device: CPU tensors take the
plain twin :func:`amplify_gain_plain`, CUDA tensors launch the kernel (or
raise) on their own card. ``launch_count`` counts kernel launches of both
instantiations, ``device_launches`` them per device, and :data:`F32` the
f32 instantiation's alone.
"""

from __future__ import annotations

import torch

from raytrace_tpu_torch.ops import cuda_lib
from raytrace_tpu_torch.ops import twofloat as tf

__all__ = ["amplify_gain", "amplify_gain_plain", "log_gain_plain",
           "log_gain2_plain", "iv_flags", "FLAG_NEG", "FLAG_NAN",
           "launch_count", "device_launches", "F32"]

#: flag bits per ray: some Iv < 0 (failure code -2), some Iv NaN (code -3)
FLAG_NEG, FLAG_NAN = 1, 2

#: the kernel's widest spectrum (one thread per frequency or pair)
_K_MAX = 256

#: kernel launches since import (or since a caller last reset it)
launch_count = 0
#: the same launches per device
device_launches: dict = {}
#: the launches of the f32 instantiation (also counted above)
F32 = cuda_lib.Launches()

_DTYPES = (torch.float64, torch.float32)


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


def log_gain2_plain(ivl: torch.Tensor, gvl: torch.Tensor,
                    gv: torch.Tensor):
    """Total log-gain as a two-float f32 pair ``(hi, lo)`` [B, K]: each
    term ``gvl[:, i, s] * gv[i][ivl[:, i, s]]`` an error-free product
    ``(p, pe)``, ``hi, e = two_sum(hi, p)`` and ``lo += e + pe``, over
    segments i (outer) and sub-lengths s (inner), as
    ``raytrace_tpu/ops/spectrum.py:186-192``."""
    B, nseg, nsub = ivl.shape
    hi = torch.zeros((B, gv.shape[2]), dtype=torch.float32,
                     device=ivl.device)
    lo = torch.zeros_like(hi)
    for i in range(nseg):
        for isub in range(nsub):
            gv_row = gv[i][ivl[:, i, isub].long()]
            p, pe = tf.split_prod(gvl[:, i, isub, None], gv_row)
            hi, e = tf.two_sum(hi, p)
            lo = lo + (e + pe)
    return hi, lo


def iv_flags(Iv: torch.Tensor) -> torch.Tensor:
    """Per-ray flag bytes [B] u8 of spectra [B, K]: :data:`FLAG_NEG` where
    some entry is negative, :data:`FLAG_NAN` where some entry is NaN."""
    neg = torch.any(Iv < 0.0, dim=1).to(torch.uint8)
    nan = torch.any(Iv != Iv, dim=1).to(torch.uint8)
    return neg * FLAG_NEG | nan * FLAG_NAN


def amplify_gain_plain(f: torch.Tensor, fv: torch.Tensor,
                       escaped: torch.Tensor, ivl: torch.Tensor,
                       gvl: torch.Tensor, gv: torch.Tensor,
                       dtype: torch.dtype = torch.float64):
    """Plain twin of kernel B3: ``(Iv, flags)`` with ``Iv = where(escaped,
    0, f * fv) * exp(log_gain_plain(...))`` in f64, or for ``dtype``
    f32 ``Iv = f32(where(escaped, 0, f * fv)) * exp_fast2(*log_gain2_plain(
    ...))``; ``flags = iv_flags(Iv)``."""
    Iv0 = f[:, None] * fv[None, :]
    Iv0 = torch.where(escaped[:, None], 0.0, Iv0)
    if dtype == torch.float32:
        Iv = Iv0.to(torch.float32) * tf.exp_fast2(
            *log_gain2_plain(ivl, gvl, gv))
    else:
        Iv = Iv0 * torch.exp(log_gain_plain(ivl, gvl, gv))
    return Iv, iv_flags(Iv)


def _check(f, fv, escaped, ivl, gvl, gv, out_dtype=torch.float64):
    if out_dtype not in _DTYPES:
        raise ValueError(f"amplify_gain: the spectrum is float64 or "
                         f"float32, got {out_dtype}")
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
                 ivl: torch.Tensor, gvl: torch.Tensor, gv: torch.Tensor,
                 dtype: torch.dtype = torch.float64):
    """Seeded gain-only amplification: ``(Iv [B, K] of dtype, flags [B]
    u8)``, kernel B3 for CUDA tensors, the plain twin for CPU tensors;
    ``dtype`` f64 (default) or f32, the two-float instantiation.

    ``f`` [B] f64 seed factor per ray (zeros for a call without a seed);
    ``fv`` [K] f64 frequency profile; ``escaped`` [B] bool from the trace;
    ``ivl`` [B, nseg, nsub] i32 and ``gvl`` [B, nseg, nsub] f32 from the
    trace; ``gv`` [nseg, cells, K] f32 lineshape tables of segments 1..N-1
    in the cell layout ``ivl`` indexes (every id must lie in [0, cells), as
    the trace writes them). With no segments ``Iv`` is the masked entry
    spectrum.
    """
    B, K, nseg, nsub = _check(f, fv, escaped, ivl, gvl, gv, dtype)
    if f.device.type == "cpu":
        return amplify_gain_plain(f, fv, escaped, ivl, gvl, gv, dtype)
    if f.device.type != "cuda":
        raise ValueError(f"amplify_gain: unsupported device {f.device}")
    if K > _K_MAX:
        raise ValueError(f"amplify_gain: the kernel takes K <= {_K_MAX}, "
                         f"got {K}")
    if B == 0:
        return (torch.empty((0, K), dtype=dtype, device=f.device),
                torch.empty(0, dtype=torch.uint8, device=f.device))
    stream = torch.cuda.current_stream(f.device).cuda_stream
    Iv, flags, _ = _launch(cuda_lib.load_library(), f, fv, escaped, ivl, gvl,
                           gv, stream, dtype=dtype)
    global launch_count
    launch_count += 1
    cuda_lib.count_launch(device_launches, f.device)
    if dtype == torch.float32:
        F32.count(f.device)
    return Iv, flags


def _launch(lib, f, fv, escaped, ivl, gvl, gv, stream, log_gain=False,
            dtype=torch.float64):
    """Launch ``rt_amplify_seeded`` (``rt_amplify_seeded_f32`` for
    ``dtype`` f32) of ``lib`` on ``stream``; inputs already checked.
    Returns ``(Iv, flags, log-gain or None)``: the f64 log-gain [B, K], or
    the f32 pair's hi and lo as [2, B, K]."""
    B, K = f.shape[0], fv.shape[0]
    _, nseg, nsub = ivl.shape
    dev = f.device
    Iv = torch.empty((B, K), dtype=dtype, device=dev)
    # whole 32-bit words: the kernel sets a ray's byte with a word atomicOr
    flags = torch.empty(-(-max(B, 1) // 4) * 4, dtype=torch.uint8,
                        device=dev)
    f32 = dtype == torch.float32
    gl = None
    if log_gain:
        gl = torch.empty(((2, B, K) if f32 else (B, K)), dtype=dtype,
                         device=dev)
    pairs = K % 2 == 0 and gv.data_ptr() % 8 == 0
    name = "rt_amplify_seeded_f32" if f32 else "rt_amplify_seeded"
    with cuda_lib.device_guard(dev):
        rc = getattr(lib, name)(
            f.data_ptr(), fv.data_ptr(), escaped.data_ptr(), ivl.data_ptr(),
            gvl.data_ptr(), gv.data_ptr(), B, nseg, nsub, gv.shape[1], K,
            int(pairs), Iv.data_ptr(), flags.data_ptr(),
            None if gl is None else gl.data_ptr(), stream)
    cuda_lib.check(rc, name)
    return Iv, flags[:B], gl
