"""Snapshot file loading + problem scaling.

Mirrors the miniapp's ``loadInput`` (src/CreateImage.cpp:26-58): a ``.dat``
file is ``uint64 N_bytes`` followed by a packed ``create_image_struct`` blob.
The embedded golden ``image``/``I_ang`` (if present) are split off and
returned separately, exactly like the reference hands them to ``check_ans``.

``scale_problem`` resamples each beam grid by ``scale**0.25`` per axis while
preserving the grid extents (src/CreateImageHelpers.cpp:104-150) so the ray
count scales ~linearly with ``scale``.
"""

from __future__ import annotations

import os
import struct
from typing import Optional, Tuple

import numpy as np

from raytrace_tpu_torch.structures import CreateImageProblem
from raytrace_tpu_torch.io import serialization as ser

__all__ = ["load_input", "save_input", "scale_problem"]


def load_input(
    filename: str | os.PathLike,
    scale: float = 1.0,
    keep_golden: bool = True,
) -> Tuple[CreateImageProblem, Optional[np.ndarray], Optional[np.ndarray]]:
    """Load a ``.dat`` snapshot; returns (problem, golden_image, golden_I_ang).

    The golden arrays are detached from the problem (problem.image/I_ang are
    reset to None, matching loadInput's hand-off).
    """
    with open(filename, "rb") as fid:
        (n_bytes,) = struct.unpack("<Q", fid.read(8))
        data = fid.read(n_bytes)
    if len(data) != n_bytes:
        raise IOError(f"Failed to read desired count from {filename}")
    problem = ser.unpack_create_image(data)
    image0 = problem.image if keep_golden else None
    i_ang0 = problem.I_ang if keep_golden else None
    problem.image = None
    problem.I_ang = None
    if scale != 1.0:
        scale_problem(problem, scale)
    return problem, image0, i_ang0


def save_input(filename: str | os.PathLike, problem: CreateImageProblem,
               compression: int = 0) -> None:
    """Write a ``.dat`` snapshot readable by both this framework and the
    reference binary."""
    blob = ser.pack_create_image(problem, compression)
    with open(filename, "wb") as fid:
        fid.write(struct.pack("<Q", len(blob)))
        fid.write(blob)


def _scale_beam(beam, scale: float) -> None:
    """Resample the (x, y, a, b) grids of a beam in place, keeping extents.

    Mirrors ``scale_beam`` (src/CreateImageHelpers.cpp:104-143): the cell-edge
    extents [x0 - dx/2, xN + dx/2] are preserved and re-divided into
    ``int(n * scale)`` uniform cells with points at cell centers.
    """
    for name, dname in (("x", "dx"), ("y", "dy"), ("a", "da"), ("b", "db")):
        grid = getattr(beam, name)
        d = getattr(beam, dname)
        lo = grid[0] - 0.5 * d
        hi = grid[-1] + 0.5 * d
        n_new = int(len(grid) * scale)
        d_new = (hi - lo) / n_new
        setattr(beam, name, lo + (0.5 + np.arange(n_new)) * d_new)
        setattr(beam, dname, d_new)


def scale_problem(problem: CreateImageProblem, scale: float) -> None:
    """Scale the ray-count of the problem by ~``scale``
    (scale_problem, src/CreateImageHelpers.cpp:144-150)."""
    _scale_beam(problem.euv_beam, scale ** 0.25)
    if problem.seed_beam is not None:
        _scale_beam(problem.seed_beam, scale ** 0.25)
