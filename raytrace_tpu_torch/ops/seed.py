"""Seed-beam intensity at the ray entry points (``calc_seed_inline``,
src/common/RayTraceImageHelper.h:230-247).

The seed profile is separable: ``I(x,y,a,b,v) = f0 fx(x) fy(y) fa(a) fb(b)
fv(v)``, each factor pchip-interpolated on its own grid. Forward (method 2)
rays are seeded at their entry coordinates (RayTraceImageHelper.h:530-533),
which are the seed-beam grid points rounded to f32, so each factor is
evaluated once per grid value per call (``raytrace_tpu`` does the same in
``ray_tracer._entry_seed_host``) and a ray's seed is a product of four
table lookups. The seeded path keeps it in factor form: the per-ray factor
:func:`seed_factor` and the frequency profile ``fv``, whose outer product
kernel B3 forms in registers (``ops/amplify_kernel.py``);
:func:`calc_seed_entry` is that product as a [B, K] tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytrace_tpu_torch.models.problem import DeviceSeed
from raytrace_tpu_torch.ops.interp import pchip_eval

__all__ = ["EntrySeedTables", "make_entry_seed_tables", "seed_factor",
           "calc_seed_entry"]


class EntrySeedTables(NamedTuple):
    """Per-axis seed factors at the seed-beam grid points (zero outside
    the seed table's box, which zeroes the product)."""

    tx: torch.Tensor  # [src_nx] f64
    ty: torch.Tensor
    ta: torch.Tensor
    tb: torch.Tensor
    fv: torch.Tensor  # [K] f64
    f0: float


def make_entry_seed_tables(seed: DeviceSeed, src_grids,
                           K: int) -> EntrySeedTables:
    """Factors at the grid points ``src_grids`` (per axis x, y, a, b: the
    f32 ray coordinates the trace receives, f32 casts of the f64 grids, as
    tensors on the seed's device), evaluated in f64."""
    tabs = []
    for axis, grid in enumerate(src_grids):
        pts = grid.to(torch.float64)
        vals = pchip_eval(seed.xs[axis], seed.fs[axis], seed.g1s[axis],
                          seed.g2s[axis], pts)
        inside = (pts >= seed.lo[axis]) & (pts <= seed.hi[axis])
        tabs.append(torch.where(inside, vals, torch.zeros_like(vals)))
    return EntrySeedTables(tx=tabs[0], ty=tabs[1], ta=tabs[2], tb=tabs[3],
                           fv=seed.fv[:K], f0=seed.f0)


def seed_factor(tables: EntrySeedTables, i, j, k, m) -> torch.Tensor:
    """Per-ray seed factor [B] f64 ``max(f0 fx fy fa fb, 0)`` of the rays
    with grid indices (i, j, k, m)."""
    f = tables.f0 * tables.tx[i] * tables.ty[j] * tables.ta[k] * tables.tb[m]
    return torch.clamp_min(f, 0.0)


def calc_seed_entry(tables: EntrySeedTables, i, j, k, m, K: int):
    """Seed spectrum [B, K] f64 of the rays with grid indices (i, j, k, m):
    ``seed_factor(...)[:, None] * fv[None, :K]``."""
    return seed_factor(tables, i, j, k, m)[:, None] * tables.fv[None, :K]
