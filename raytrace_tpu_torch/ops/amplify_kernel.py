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
plain twin :func:`amplify_gain_plain`, CUDA tensors launch the kernel of
their dtype (C entry :func:`entry`, booked in ``cuda_lib``'s launch
ledger) or raise, on their own card.

The ASE path's amplification with gain and emissivity from a zero entry
spectrum is kernel B4 (``csrc/emissivity.cu``) in f64 and kernel B4-f32
(the same file, ``rt_amplify_emis_f32``) in f32, each with its failure
flags fused in as B3's: :func:`amplify_emis` dispatches as
:func:`amplify_gain` does, to the plain twin :func:`amplify_emis_plain`
(``ops/spectrum.amplify`` on a zero entry spectrum, then :func:`iv_flags`)
for CPU tensors. B4-f32 computes the twin's f32 arithmetic operation by
operation (the two-float helpers of ``csrc/twofloat.cuh``, shared with
B3-f32), so it is bitwise equal to it. Neither replaces a Pallas kernel:
``raytrace_tpu`` computes the step in XLA
(``raytrace_tpu/ops/spectrum.py:156-183``).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from raytrace_tpu_torch.ops import cuda_lib, spectrum
from raytrace_tpu_torch.ops import twofloat as tf

__all__ = ["amplify_gain", "amplify_gain_plain", "log_gain_plain",
           "log_gain2_plain", "iv_flags", "FLAG_NEG", "FLAG_NAN",
           "amplify_emis", "amplify_emis_plain", "entry"]

#: flag bits per ray: some Iv < 0 (failure code -2), some Iv NaN (code -3)
FLAG_NEG, FLAG_NAN = 1, 2

#: the kernel's widest spectrum (one thread per frequency or pair)
_K_MAX = 256

_DTYPES = (torch.float64, torch.float32)


def entry(dtype: torch.dtype, emis: bool = False) -> str:
    """The C entry that amplifies into a spectrum of ``dtype``: the seeded
    amplify (B3), or with ``emis`` the emissivity amplify (B4)."""
    name = "rt_amplify_emis" if emis else "rt_amplify_seeded"
    return name + "_f32" if dtype == torch.float32 else name


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
    return Iv, flags


def _launch(lib, f, fv, escaped, ivl, gvl, gv, stream, log_gain=False,
            dtype=torch.float64):
    """Launch :func:`entry` of ``dtype`` of ``lib`` on ``stream``; inputs
    already checked.
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
    cuda_lib.launch(
        lib, entry(dtype), dev,
        f.data_ptr(), fv.data_ptr(), escaped.data_ptr(), ivl.data_ptr(),
        gvl.data_ptr(), gv.data_ptr(), B, nseg, nsub, gv.shape[1], K,
        int(pairs), Iv.data_ptr(), flags.data_ptr(),
        None if gl is None else gl.data_ptr(), stream)
    return Iv, flags[:B], gl


def amplify_emis_plain(ivl: torch.Tensor, gvl: torch.Tensor,
                       evl: torch.Tensor, gv: torch.Tensor,
                       dtype: torch.dtype = torch.float64):
    """Plain twin of kernel B4 (of B4-f32 for ``dtype`` f32): ``(Iv,
    flags)`` with ``Iv`` the emissivity amplify (``spectrum.amplify``) of a
    zero entry spectrum along the path ``ivl``, ``gvl``, ``evl`` through
    the tables ``gv``, and ``flags = iv_flags(Iv)``."""
    B, nseg = ivl.shape[0], ivl.shape[1]
    path = SimpleNamespace(ivl=ivl, gvl=gvl, evl=evl)
    Iv0 = torch.zeros((B, gv.shape[2]), dtype=dtype, device=ivl.device)
    Iv = spectrum.amplify(path, Iv0, gv, nseg + 1, dtype=dtype)
    return Iv, iv_flags(Iv)


def _check_emis(ivl, gvl, evl, gv, out_dtype=torch.float64):
    if out_dtype not in _DTYPES:
        raise ValueError(f"amplify_emis: the spectrum is float64 or "
                         f"float32, got {out_dtype}")
    if ivl.dim() != 3:
        raise ValueError("amplify_emis: ivl must be [B, nseg, nsub]")
    B, nseg, nsub = ivl.shape
    dev = ivl.device
    for name, t, tdtype in (("ivl", ivl, torch.int32),
                            ("gvl", gvl, torch.float32),
                            ("evl", evl, torch.float32)):
        if (t.dtype != tdtype or tuple(t.shape) != (B, nseg, nsub)
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"amplify_emis: {name} must be a contiguous "
                             f"{tdtype} [{B}, {nseg}, {nsub}] tensor on "
                             f"{dev}")
    if (gv.dtype != torch.float32 or gv.dim() != 3 or gv.shape[0] != nseg
            or gv.device != dev or not gv.is_contiguous()):
        raise ValueError(f"amplify_emis: gv must be a contiguous float32 "
                         f"[{nseg}, cells, K] tensor on {dev}")
    return B, gv.shape[2]


def amplify_emis(ivl: torch.Tensor, gvl: torch.Tensor, evl: torch.Tensor,
                 gv: torch.Tensor, dtype: torch.dtype = torch.float64):
    """The emissivity amplify from a zero entry spectrum: ``(Iv [B, K] of
    dtype, flags [B] u8)``, kernel B4 (``dtype`` f64, the default) or
    B4-f32 (``dtype`` f32) for CUDA tensors, the plain twin for CPU
    tensors.

    ``ivl`` [B, nseg, nsub] i32, ``gvl`` and ``evl`` [B, nseg, nsub] f32
    from the trace; ``gv`` [nseg, cells, K] f32 lineshape tables of
    segments 1..N-1 in the cell layout ``ivl`` indexes (every id must lie
    in [0, cells), as the trace writes them). With no segments ``Iv`` is
    0. Any K.
    """
    B, K = _check_emis(ivl, gvl, evl, gv, dtype)
    if ivl.device.type == "cpu":
        return amplify_emis_plain(ivl, gvl, evl, gv, dtype)
    if ivl.device.type != "cuda":
        raise ValueError(f"amplify_emis: unsupported device {ivl.device}")
    if B == 0:
        return (torch.empty((0, K), dtype=dtype, device=ivl.device),
                torch.empty(0, dtype=torch.uint8, device=ivl.device))
    stream = torch.cuda.current_stream(ivl.device).cuda_stream
    return _launch_emis(cuda_lib.load_library(), ivl, gvl, evl, gv, stream,
                        dtype)


def _launch_emis(lib, ivl, gvl, evl, gv, stream, dtype=torch.float64):
    """Launch :func:`entry` of ``dtype`` with ``emis`` of ``lib`` on
    ``stream``; inputs already checked. Returns ``(Iv, flags)``."""
    B, nseg, nsub = ivl.shape
    K = gv.shape[2]
    dev = ivl.device
    Iv = torch.empty((B, K), dtype=dtype, device=dev)
    # whole 32-bit words: the kernel sets a ray's byte with a word atomicOr
    flags = torch.empty(-(-max(B, 1) // 4) * 4, dtype=torch.uint8,
                        device=dev)
    pairs = K % 2 == 0 and gv.data_ptr() % 8 == 0
    cuda_lib.launch(
        lib, entry(dtype, emis=True), dev,
        ivl.data_ptr(), gvl.data_ptr(), evl.data_ptr(), gv.data_ptr(), B,
        nseg, nsub, gv.shape[1], K, int(pairs), Iv.data_ptr(),
        flags.data_ptr(), stream)
    return Iv, flags[:B]
