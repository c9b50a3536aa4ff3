"""Device-side problem representation: stacked, padded tensors.

The reference hands its kernel an array-of-structs with raw pointers
(``ray_gain_struct*``, src/RayTraceStructures.h:218-272) and deep-copies it
to the device per call (src/RayTraceImageCuda.cu:225-289). The port builds
the struct-of-arrays layout of ``raytrace_tpu.models.problem`` on the host
in numpy and copies it to the requested device once per call:

* per-segment gain tables stacked to ``[N, ...]`` and padded to the largest
  (Nx, Ny), with flat cell index ``i + j*Nx`` like the reference;
* x/y grids stay **float64** (``findindex`` and the cell edges compare in
  f64, RayTraceStructures.h:215-217); n, g0, E0 are f32; the edge gradients
  Gx/Gy are computed from f64 differences and stored f32; cdx/cdy are the
  f32 casts of f64 differences;
* the separable seed factors with their pchip gradients.

Every function takes an explicit ``device``; nothing here keeps global
device state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytrace_tpu_torch.ops import interp
from raytrace_tpu_torch.structures import RayGain, RaySeed

__all__ = ["DeviceGain", "DeviceSeed", "DeviceBeam", "gain_arrays",
           "gain_to_device", "prepare_gain", "prepare_seed", "prepare_beam"]


class DeviceGain(NamedTuple):
    """Stacked per-segment gain tables (leading dim = segment 0..N-1)."""

    x: torch.Tensor        # [N, Nx]  f64 grid
    y: torch.Tensor        # [N, Ny]  f64
    cdx: torch.Tensor      # [N, Nx-1] f32 cell widths (f32 of f64 difference)
    cdy: torch.Tensor      # [N, Ny-1] f32
    n4: torch.Tensor       # [N, Nx*Ny] f32 index of refraction
    g0: torch.Tensor       # [N, Nx*Ny] f32 gain at line centre
    E0: torch.Tensor       # [N, Nx*Ny] f32 emissivity (zeros if absent)
    Gx: torch.Tensor       # [N, (Nx-1)*Ny] f32 dn/dx per x-edge, f64-accurate
    Gy: torch.Tensor       # [N, Nx*(Ny-1)] f32 dn/dy per y-edge
    gv: torch.Tensor       # [N, Nx*Ny, K] f32 lineshape (cell-major rows)
    gv0: torch.Tensor      # [N, Nx*Ny] f32 lineshape at line centre
    range4: torch.Tensor   # [N, 4] f32 plasma extents (x0, x1, y0_mirrored, y1)
    abs_y: torch.Tensor    # [N] bool half-plane mirror flag
    nx: torch.Tensor       # [N] i32 true Nx per segment (<= padded)
    ny: torch.Tensor       # [N] i32


class DeviceSeed(NamedTuple):
    """Separable seed tables with pchip gradients (ray_seed_struct)."""

    xs: tuple              # 4x [dim_i] f64 grids (x, y, a, b)
    fs: tuple              # 4x [dim_i] f64 factors
    g1s: tuple             # 4x [dim_i - 1] f64 gradients at interval starts
    g2s: tuple             # 4x [dim_i - 1] f64 gradients at interval ends
    fv: torch.Tensor       # [K] f64 frequency profile f[4]
    f0: float
    lo: tuple              # 4 grid lower bounds
    hi: tuple              # 4 grid upper bounds


class DeviceBeam(NamedTuple):
    """EUV output-beam grids needed on the device for binning."""

    x: torch.Tensor   # [nx] f64
    y: torch.Tensor   # [ny] f64
    a: torch.Tensor   # [na] f64
    b: torch.Tensor   # [nb] f64
    dv: torch.Tensor  # [nv] f64
    dx: float
    dy: float
    da: float
    db: float
    y0_nonneg: bool   # beam.y[0] >= 0: the mirror rule for binning


def gain_arrays(gains: list[RayGain]) -> dict:
    """Host numpy arrays of the DeviceGain layout, field by field the same
    values ``raytrace_tpu.models.problem.prepare_gain`` builds."""
    nx_max = max(g.Nx for g in gains)
    ny_max = max(g.Ny for g in gains)
    K = gains[0].Nv
    cols = {name: [] for name in DeviceGain._fields}
    for g in gains:
        Nx, Ny = g.Nx, g.Ny
        x64 = np.asarray(g.x, dtype=np.float64)
        y64 = np.asarray(g.y, dtype=np.float64)
        n64 = np.asarray(g.n, dtype=np.float64).reshape(Ny, Nx)  # [j, i]
        # plasma extents: a half-plane grid (y[0] >= 0) mirrors y
        r0, r1 = np.float32(x64[0]), np.float32(x64[-1])
        r2, r3 = np.float32(y64[0]), np.float32(y64[-1])
        abs_y = bool(r2 >= 0)
        if abs_y:
            r2 = np.float32(-r3)
        cols["range4"].append(np.array([r0, r1, r2, r3], dtype=np.float32))
        cols["abs_y"].append(abs_y)
        cols["nx"].append(Nx)
        cols["ny"].append(Ny)

        def grow(arr, n_to):
            # padded grid points keep increasing; the physics stays on the
            # true grid through range4 and the nx/ny clamps
            if len(arr) == n_to:
                return arr
            step = arr[-1] - arr[-2] if len(arr) > 1 else 1.0
            return np.concatenate(
                [arr, arr[-1] + step * np.arange(1, n_to - len(arr) + 1)])

        xp = grow(x64, nx_max)
        yp = grow(y64, ny_max)
        cols["x"].append(xp)
        cols["y"].append(yp)
        cols["cdx"].append(np.diff(xp).astype(np.float32))
        cols["cdy"].append(np.diff(yp).astype(np.float32))

        Gx = (n64[:, 1:] - n64[:, :-1]) / (x64[None, 1:] - x64[None, :-1])
        Gy = (n64[1:, :] - n64[:-1, :]) / (y64[1:, None] - y64[:-1, None])

        def pad2(t, ny_t, nx_t):
            out = np.zeros((ny_t, nx_t), dtype=np.float32)
            out[: t.shape[0], : t.shape[1]] = t
            return out.reshape(-1)

        def cell2(arr):
            return pad2(np.asarray(arr, np.float32).reshape(Ny, Nx),
                        ny_max, nx_max)

        cols["n4"].append(pad2(n64.astype(np.float32), ny_max, nx_max))
        cols["g0"].append(cell2(g.g0))
        cols["E0"].append(cell2(g.E0 if g.E0 is not None
                                else np.zeros(Nx * Ny, np.float32)))
        cols["Gx"].append(pad2(Gx.astype(np.float32), ny_max, nx_max - 1))
        cols["Gy"].append(pad2(Gy.astype(np.float32), ny_max - 1, nx_max))
        gvp = np.zeros((ny_max, nx_max, K), dtype=np.float32)
        gvp[:Ny, :Nx] = np.asarray(g.gv, np.float32).reshape(Ny, Nx, K)
        cols["gv"].append(gvp.reshape(-1, K))
        cols["gv0"].append(cell2(g.gv0))
    out = {k: np.stack(v) for k, v in cols.items()
           if k not in ("abs_y", "nx", "ny")}
    out["abs_y"] = np.asarray(cols["abs_y"], bool)
    out["nx"] = np.asarray(cols["nx"], np.int32)
    out["ny"] = np.asarray(cols["ny"], np.int32)
    return out


def gain_to_device(arrays, device) -> DeviceGain:
    """DeviceGain from host arrays (a mapping or an object with the
    DeviceGain field names), each copied to ``device`` unchanged."""
    get = (arrays.__getitem__ if isinstance(arrays, dict)
           else lambda k: getattr(arrays, k))
    return DeviceGain(**{
        k: torch.from_numpy(np.ascontiguousarray(np.asarray(get(k))))
        .to(device) for k in DeviceGain._fields})


def prepare_gain(gains: list[RayGain], device="cpu") -> DeviceGain:
    """Stacked gain tables of ``gains`` on ``device``."""
    return gain_to_device(gain_arrays(gains), device)


def prepare_seed(seed: RaySeed, device="cpu") -> DeviceSeed:
    """Seed tables with host-precomputed pchip gradients on ``device``."""
    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    xs, fs, g1s, g2s = [], [], [], []
    for axis in range(4):
        xi = np.asarray(seed.x[axis], np.float64)
        fi = np.asarray(seed.f[axis], np.float64)
        g1, g2 = interp.pchip_coefficients(xi, fi)
        xs.append(dev(xi))
        fs.append(dev(fi))
        g1s.append(dev(g1))
        g2s.append(dev(g2))
    return DeviceSeed(
        xs=tuple(xs), fs=tuple(fs), g1s=tuple(g1s), g2s=tuple(g2s),
        fv=dev(seed.f[4]), f0=float(seed.f0),
        lo=tuple(float(seed.x[i][0]) for i in range(4)),
        hi=tuple(float(seed.x[i][-1]) for i in range(4)))


def prepare_beam(beam, device="cpu") -> DeviceBeam:
    """The EUV beam's grids on ``device``."""
    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    return DeviceBeam(
        x=dev(beam.x), y=dev(beam.y), a=dev(beam.a), b=dev(beam.b),
        dv=dev(beam.dv), dx=float(beam.dx), dy=float(beam.dy),
        da=float(beam.da), db=float(beam.db),
        y0_nonneg=bool(beam.y[0] >= 0.0))
