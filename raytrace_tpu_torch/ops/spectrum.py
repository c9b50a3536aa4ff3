"""Spectral amplification: closed-form integration of dI/dz = j + g I, in
f64 (the per-ray spectrum loops of ``RayTrace_calc_ray``,
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

The reference computes this in double, and so does the port: Hopper has
native f64. (``raytrace_tpu`` keeps a two-float f32 form because a TPU
emulates f64.) The emissivity path stays plain PyTorch, as it is plain XLA
in ``raytrace_tpu``.
"""

from __future__ import annotations

import torch

from raytrace_tpu_torch.ops.stepper import TraceResult

__all__ = ["amplify"]


def amplify(res: TraceResult, Iv0: torch.Tensor, gv: torch.Tensor,
            N: int) -> torch.Tensor:
    """Amplify each ray's spectrum along its recorded path with gain and
    emissivity (the ASE path).

    ``Iv0``: [B, K] f64 entry intensity. ``gv``: [N-1, cells, K] f32
    lineshape tables of segments 1..N-1 in the padded cell layout that
    ``res.ivl`` indexes. Returns [B, K] f64.
    """
    nseg = max(N - 1, 0)
    Iv = Iv0.to(torch.float64)
    if nseg == 0:
        return Iv
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

