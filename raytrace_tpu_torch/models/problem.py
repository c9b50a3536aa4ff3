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

A call builds its tables as host numpy arrays (``*_arrays``), packs them
into one host buffer (:func:`pack_arrays`, pinned for a CUDA device) and
copies that buffer to the device at once; :func:`unpack_arrays` cuts the
device copy back into tensors (views of the one buffer), and the
``*_from_tensors`` functions assemble the device structures from them.

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
           "gain_to_device", "prepare_gain", "seed_arrays", "seed_scalars",
           "seed_from_tensors", "beam_arrays", "beam_scalars",
           "beam_from_tensors", "prepare_beam",
           "pack_arrays", "unpack_arrays"]


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


def seed_arrays(seed: RaySeed) -> dict:
    """Host f64 arrays of the DeviceSeed layout, with the pchip gradients
    computed here: ``x<a>``, ``f<a>``, ``g1_<a>``, ``g2_<a>`` per axis a of
    (x, y, a, b), and the frequency profile ``fv``."""
    out = {}
    for axis in range(4):
        xi = np.asarray(seed.x[axis], np.float64)
        fi = np.asarray(seed.f[axis], np.float64)
        g1, g2 = interp.pchip_coefficients(xi, fi)
        out.update({f"x{axis}": xi, f"f{axis}": fi, f"g1_{axis}": g1,
                    f"g2_{axis}": g2})
    out["fv"] = np.asarray(seed.f[4], np.float64)
    return out


def seed_scalars(seed: RaySeed) -> tuple:
    """The DeviceSeed fields that are host scalars: ``(f0, lo, hi)``."""
    return (float(seed.f0), tuple(float(seed.x[i][0]) for i in range(4)),
            tuple(float(seed.x[i][-1]) for i in range(4)))


def seed_from_tensors(t: dict, scalars: tuple) -> DeviceSeed:
    """DeviceSeed from the tensors of :func:`seed_arrays` and the
    :func:`seed_scalars` of its seed."""
    f0, lo, hi = scalars
    return DeviceSeed(
        xs=tuple(t[f"x{a}"] for a in range(4)),
        fs=tuple(t[f"f{a}"] for a in range(4)),
        g1s=tuple(t[f"g1_{a}"] for a in range(4)),
        g2s=tuple(t[f"g2_{a}"] for a in range(4)),
        fv=t["fv"], f0=f0, lo=lo, hi=hi)


def beam_arrays(beam) -> dict:
    """Host f64 arrays of the DeviceBeam grids."""
    return {k: np.asarray(getattr(beam, k), np.float64)
            for k in ("x", "y", "a", "b", "dv")}


def beam_scalars(beam) -> tuple:
    """The DeviceBeam fields that are host scalars: ``(dx, dy, da, db,
    y0_nonneg)``."""
    return (float(beam.dx), float(beam.dy), float(beam.da), float(beam.db),
            bool(beam.y[0] >= 0.0))


def beam_from_tensors(t: dict, scalars: tuple) -> DeviceBeam:
    """DeviceBeam from the tensors of :func:`beam_arrays` and the
    :func:`beam_scalars` of its beam."""
    dx, dy, da, db, y0_nonneg = scalars
    return DeviceBeam(x=t["x"], y=t["y"], a=t["a"], b=t["b"], dv=t["dv"],
                      dx=dx, dy=dy, da=da, db=db, y0_nonneg=y0_nonneg)


def prepare_beam(beam, device="cpu") -> DeviceBeam:
    """The EUV beam's grids on ``device``."""
    return beam_from_tensors({k: torch.as_tensor(v, device=device)
                              for k, v in beam_arrays(beam).items()},
                             beam_scalars(beam))


#: byte alignment of each array in a packed buffer (>= every itemsize, so
#: every view of the buffer is aligned for its dtype)
_ALIGN = 16


def pack_arrays(arrays: dict, pin: bool = False):
    """Pack named host arrays into one uint8 tensor (page-locked with
    ``pin``, so that a copy to a CUDA device can run asynchronously).
    Returns ``(buffer, layout)`` for :func:`unpack_arrays`."""
    layout, off = [], 0
    for name, a in arrays.items():
        a = np.asarray(a)
        layout.append((name, off, a.dtype, a.shape))
        off += -(-a.nbytes // _ALIGN) * _ALIGN
    buf = torch.empty(max(off, _ALIGN), dtype=torch.uint8, pin_memory=pin)
    view = buf.numpy()
    for (_name, o, _dtype, _shape), a in zip(layout, arrays.values()):
        a = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        view[o:o + a.size] = a
    return buf, layout


def unpack_arrays(buf: torch.Tensor, layout) -> dict:
    """Tensors of a packed buffer (on whatever device ``buf`` lies), views
    of it by the ``layout`` of :func:`pack_arrays`."""
    out = {}
    for name, off, dtype, shape in layout:
        tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        out[name] = buf[off:off + nbytes].view(tdtype).reshape(shape)
    return out
