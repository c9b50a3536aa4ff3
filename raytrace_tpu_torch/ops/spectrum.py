"""Spectral amplification: closed-form integration of dI/dz = j + g I, in
f64 or f32 (the per-ray spectrum loops of ``RayTrace_calc_ray``,
src/common/RayTraceImageHelper.h:534-581).

* emissivity path (ASE): per (segment, sub-length) the lineshape row
  ``gv[cell]`` scales the path-integrated gain and emissivity, and
  ``I = j/g (e^g - 1) + I e^g`` with a second-order Taylor branch for
  |g| < 1e-3;
* gain-only path (seeded): the total log-gain is summed first and one
  ``exp`` applied to the entry seed (RayTraceImageHelper.h:569-581). This
  is kernel B3 (``ops/amplify_kernel.amplify_gain``) on CUDA tensors and
  its plain twin on CPU tensors, with the seed product and the per-ray
  failure flags fused in; the port runs it on every gain-only call
  (``raytrace_tpu`` gates its Pallas counterpart behind
  ``RAYTRACE_FUSED_AMPLIFY``, where it lost to XLA's gathers on the TPU).
  This module holds the emissivity path.

The reference computes this in double, and so does the port by default:
Hopper has native f64. ``dtype=torch.float32`` is ``raytrace_tpu``'s
default spectrum (``spectrum_dtype=jnp.float32``), which the TPU needs
because it emulates f64: the log-gain of each (segment, sub-length) is an
error-free two-float product (``ops/twofloat.py``) and ``exp`` and
``expm1`` take the pair, all in f32, line for line with
``raytrace_tpu/ops/spectrum.py:160-176``. The emissivity path is plain
PyTorch here in both dtypes, as it is plain XLA in ``raytrace_tpu``. From a
zero entry spectrum the main path runs it on a card as kernel B4 in f64
and kernel B4-f32 in f32 (``ops/amplify_kernel.amplify_emis``), whose
plain twin is this code; the CPU and the twins' methods (``lax``,
``lax-exact``) run this code.
"""

from __future__ import annotations

import torch

from raytrace_tpu_torch.ops import twofloat as tf
from raytrace_tpu_torch.ops.stepper import TraceResult

__all__ = ["amplify"]


#: the f32 branch's constants, rounded to f32 as the JAX package's weak
#: Python constants are in f32 arithmetic
_SMALL_F32 = tf.f32c(1e-3)
_THIRD_F32 = tf.f32c(0.3333333333)


def amplify(res: TraceResult, Iv0: torch.Tensor, gv: torch.Tensor,
            N: int, dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Amplify each ray's spectrum along its recorded path with gain and
    emissivity (the ASE path).

    ``Iv0``: [B, K] entry intensity. ``gv``: [N-1, cells, K] f32 lineshape
    tables of segments 1..N-1 in the padded cell layout that ``res.ivl``
    indexes. ``dtype``: the spectrum's, f64 (the reference's arithmetic)
    or f32 (``raytrace_tpu``'s two-float form). Returns [B, K] of
    ``dtype``.
    """
    nseg = max(N - 1, 0)
    Iv = Iv0.to(dtype)
    if nseg == 0:
        return Iv
    if dtype == torch.float32:
        return _amplify_f32(res, Iv, gv, nseg)
    gvl = res.gvl.to(torch.float64)
    evl = res.evl.to(torch.float64)
    for i in range(nseg):
        for isub in range(res.gvl.shape[2]):
            gv_row = gv[i][res.ivl[:, i, isub].long()].to(torch.float64)
            el = evl[:, i, isub, None] * gv_row
            gl = gvl[:, i, isub, None] * gv_row
            small = torch.abs(gl) < 1e-3
            exp_gl = torch.exp(torch.where(small, 0.0, gl))
            em1 = exp_gl - 1.0
            gl_safe = torch.where(small, 1.0, gl)
            big = el / gl_safe * em1 + Iv * exp_gl
            taylor = (el * (1.0 + 0.5 * gl * (1.0 + 0.3333333333 * gl))
                      + Iv * (1.0 + gl * (1.0 + 0.5 * gl)))
            Iv = torch.where(small, taylor, big)
    return Iv


def _amplify_f32(res: TraceResult, Iv: torch.Tensor, gv: torch.Tensor,
                 nseg: int) -> torch.Tensor:
    """The emissivity amplify in f32 (``raytrace_tpu/ops/spectrum.py:
    160-176``): the log-gain ``gvl * gv`` as an exact two-float product,
    ``exp`` and ``expm1`` of the pair, the closed form and the Taylor
    branch in f32."""
    for i in range(nseg):
        for isub in range(res.gvl.shape[2]):
            gv_row = gv[i][res.ivl[:, i, isub].long()]
            el = res.evl[:, i, isub, None] * gv_row
            gl, gl_lo = tf.split_prod(res.gvl[:, i, isub, None], gv_row)
            small = torch.abs(gl) < _SMALL_F32
            zero = torch.zeros_like(gl)
            glz = torch.where(small, zero, gl)
            glz_lo = torch.where(small, zero, gl_lo)
            exp_gl = tf.exp_fast2(glz, glz_lo)
            em1 = tf.expm1_from_exp(exp_gl, glz, glz_lo)
            gl_safe = torch.where(small, torch.ones_like(gl), gl)
            big = el / gl_safe * em1 + Iv * exp_gl
            taylor = (el * (1.0 + 0.5 * gl * (1.0 + _THIRD_F32 * gl))
                      + Iv * (1.0 + gl * (1.0 + 0.5 * gl)))
            Iv = torch.where(small, taylor, big)
    return Iv
