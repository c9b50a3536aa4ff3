"""Image binning: deposit per-ray spectra into the near-field image and the
far-field angular image (the scatter-add of ``RayTraceImageCPULoop``,
src/RayTraceImageCPU.cpp:37-68).

* backward (ASE, method 1) rays bin at their *entry* coordinates;
* forward (seeded, method 2) rays bin at their *exit* coordinates, angles
  negated and y mirrored onto a half-plane beam grid;
* ``getIndex`` = half-cell-shifted first-greater search in f64, -1 outside
  the half-cell-padded extent (src/RayTraceImageCPU.cpp:11-16);
* ``image[nv*(i1 + i2*nx) + iv] += Iv*scale``,
  ``I_ang[i3 + i4*na] += sum_v 2 dv Iv``.

Both deposits go through one deposit function (kernel B2 or its plain twin)
straight into the call's f64 accumulators; rays that failed or bin outside
the grid go to the trash bin.
"""

from __future__ import annotations

import torch

from raytrace_tpu_torch.models.problem import DeviceBeam
from raytrace_tpu_torch.ops.interp import find_first_single

__all__ = ["get_index", "bin_coords", "bin_images"]


def get_index(grid: torch.Tensor, d: float, y: torch.Tensor) -> torch.Tensor:
    """Vectorised ``getIndex`` (RayTraceImageCPU.cpp:11-16) in f64:
    findfirstsingle(grid, y - d/2), or -1 outside the padded extent."""
    y = y.to(torch.float64)
    n = grid.shape[0]
    idx = find_first_single(grid, y - 0.5 * d)
    bad = (y < grid[0] - 0.5 * d) | (y > grid[n - 1] + 0.5 * d)
    return torch.where(bad, torch.full_like(idx, -1), idx)


def bin_coords(res, rays: dict, beam: DeviceBeam, method: int):
    """The (x, y, a, b) each ray bins at: entry coordinates for method 1;
    exit coordinates with negated angles and the half-plane y mirror for
    method 2."""
    if method == 1:
        return rays["x"], rays["y"], rays["a"], rays["b"]
    by = res.exit_y
    if beam.y0_nonneg:
        by = torch.where(by < 0, -by, by)
    return res.exit_x, by, -res.exit_a, -res.exit_b


def bin_images(Iv, res, rays: dict, beam: DeviceBeam, method: int,
               scale: float, valid, image_acc, iang_acc, deposit) -> None:
    """Deposit a batch of spectra into the call's accumulators, in place.

    ``Iv``: [B, K] f64; ``valid``: [B] bool (failed rays are left out, as
    the reference ``continue``s on error); ``image_acc``: [nx*ny, K] f64
    in cell-major reference layout; ``iang_acc``: [na*nb, 1] f64;
    ``deposit(out, contrib, bins)``: kernel B2's wrapper or its twin.
    """
    nx, ny = beam.x.shape[0], beam.y.shape[0]
    na, nb = beam.a.shape[0], beam.b.shape[0]
    bx, by, ba, bb = bin_coords(res, rays, beam, method)
    i1 = get_index(beam.x, beam.dx, bx)
    i2 = get_index(beam.y, beam.dy, by)
    i3 = get_index(beam.a, beam.da, ba)
    i4 = get_index(beam.b, beam.db, bb)

    img_ok = valid & (i1 >= 0) & (i2 >= 0)
    img_bin = torch.where(img_ok, i1 + i2 * nx, nx * ny).to(torch.int32)
    deposit(image_acc, (Iv * scale).contiguous(), img_bin)

    ang_ok = valid & (i3 >= 0) & (i4 >= 0)
    ang_bin = torch.where(ang_ok, i3 + i4 * na, na * nb).to(torch.int32)
    tmp = Iv @ (2.0 * beam.dv)
    deposit(iang_acc, tmp[:, None].contiguous(), ang_bin)
