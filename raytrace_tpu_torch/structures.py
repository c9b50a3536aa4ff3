"""Host-side data structures of the work unit (numpy containers).

Field-for-field copies of ``raytrace_tpu.structures``, mirroring the
*semantics* (not the layout) of the reference structs in
``src/RayTraceStructures.h``:

* :class:`EUVBeam`        <- ``EUV_beam_struct``        (RayTraceStructures.h:26-96)
* :class:`SeedBeamShape`  <- ``seed_beam_shape_struct`` (RayTraceStructures.h:100-138)
* :class:`SeedBeam`       <- ``seed_beam_struct``       (RayTraceStructures.h:142-211)
* :class:`RayGain`        <- ``ray_gain_struct``        (RayTraceStructures.h:218-272)
* :class:`RaySeed`        <- ``ray_seed_struct``        (RayTraceStructures.h:276-318)
* :class:`CreateImageProblem` <- ``create_image_struct`` (RayTraceStructures.h:323-357)

The containers stay numpy; :mod:`raytrace_tpu_torch.models.problem` turns
them into stacked tensors on a device at the compute boundary.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

__all__ = [
    "EUVBeam",
    "SeedBeamShape",
    "SeedBeam",
    "RayGain",
    "RaySeed",
    "CreateImageProblem",
    "approx_equal",
]


def approx_equal(x, y, tol: float = 1e-6) -> bool:
    """Tolerance comparison used by all struct ``==`` operators.

    Mirrors ``approx_equal`` in RayTraceStructures.cpp:74-88:
    ``2|x-y|/|x+y| < tol  or  x+y == 0``.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    s = x + y
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = 2.0 * np.abs(x - y) / np.abs(s)
    return bool(np.all((rel < tol) | (s == 0.0)))


def _no_nan(*arrays) -> bool:
    for a in arrays:
        if a is not None and np.any(np.asarray(a) != np.asarray(a)):
            return False
    return True


@dataclass
class EUVBeam:
    """Output-beam discretization + physics flags (EUV_beam_struct)."""

    run_ASE: bool = True
    run_sat: bool = True
    run_refract: bool = True
    R_scale: float = -1.0
    G_scale: float = -1.0
    lam: float = 0.0  # laser wavelength "lambda" (cm)
    A: float = 0.0  # A coefficient (1/s)
    Nc: float = 0.0  # critical density (cm^-3)
    x: Optional[np.ndarray] = None  # (nx,) cm
    y: Optional[np.ndarray] = None  # (ny,) cm
    a: Optional[np.ndarray] = None  # (na,) mrad
    b: Optional[np.ndarray] = None  # (nb,) mrad
    z: Optional[np.ndarray] = None  # (nz,) cm
    v: Optional[np.ndarray] = None  # (nv,) frequency grid
    dv: Optional[np.ndarray] = None  # (nv,) frequency spacings
    dx: float = 0.0
    dy: float = 0.0
    da: float = 0.0
    db: float = 0.0
    dz: float = 0.0
    v0: float = 0.0

    @property
    def nx(self) -> int:
        return 0 if self.x is None else len(self.x)

    @property
    def ny(self) -> int:
        return 0 if self.y is None else len(self.y)

    @property
    def nz(self) -> int:
        return 0 if self.z is None else len(self.z)

    @property
    def na(self) -> int:
        return 0 if self.a is None else len(self.a)

    @property
    def nb(self) -> int:
        return 0 if self.b is None else len(self.b)

    @property
    def nv(self) -> int:
        return 0 if self.v is None else len(self.v)

    def initialize(self, nx, ny, nz, na, nb, nv) -> "EUVBeam":
        """Allocate zeroed grids (EUV_beam_struct::initialize)."""
        self.x = np.zeros(nx)
        self.y = np.zeros(ny)
        self.z = np.zeros(nz)
        self.a = np.zeros(na)
        self.b = np.zeros(nb)
        self.v = np.zeros(nv)
        self.dv = np.zeros(nv)
        return self

    def valid(self) -> bool:
        """NaN scan (EUV_beam_struct::valid, RayTraceStructures.cpp:372-411)."""
        return _no_nan(self.x, self.y, self.z, self.a, self.b, self.v, self.dv)

    def __eq__(self, rhs) -> bool:
        if not isinstance(rhs, EUVBeam):
            return NotImplemented
        if (self.nx, self.ny, self.nz, self.na, self.nb, self.nv) != (
            rhs.nx, rhs.ny, rhs.nz, rhs.na, rhs.nb, rhs.nv,
        ):
            return False
        if (self.run_ASE, self.run_sat, self.run_refract) != (
            rhs.run_ASE, rhs.run_sat, rhs.run_refract,
        ):
            return False
        # deliberately omits db, dz and the z grid: the reference's
        # operator== (RayTraceStructures.cpp:412-434) compares dx TWICE
        # (an upstream typo where db/dz was clearly intended) and never
        # compares z -- this comparison surface is part of the parity
        # contract, quirk included
        for name in ("R_scale", "G_scale", "lam", "A", "Nc", "dx", "dy", "da", "v0"):
            if not approx_equal(getattr(self, name), getattr(rhs, name)):
                return False
        for name in ("x", "y", "a", "b", "v", "dv"):
            if not approx_equal(getattr(self, name), getattr(rhs, name)):
                return False
        return True


@dataclass
class SeedBeamShape:
    """Temporal/spectral shape of a seed beam (seed_beam_shape_struct)."""

    T: Optional[np.ndarray] = None  # (n,) temporal grid
    It: Optional[np.ndarray] = None  # (3*n,) intensity profile
    Ivt: Optional[np.ndarray] = None  # (3*n*nv,) intensity-frequency profile
    nv: int = 0

    @property
    def n(self) -> int:
        return 0 if self.T is None else len(self.T)

    def initialize(self, n, nv) -> "SeedBeamShape":
        self.T = np.zeros(n)
        self.It = np.zeros(3 * n)
        self.Ivt = np.zeros(3 * n * nv)
        self.nv = nv
        return self

    def valid(self) -> bool:
        return _no_nan(self.T, self.It, self.Ivt)

    def __eq__(self, rhs) -> bool:
        if not isinstance(rhs, SeedBeamShape):
            return NotImplemented
        if self.n != rhs.n or self.nv != rhs.nv:
            return False
        return (
            approx_equal(self.T, rhs.T)
            and approx_equal(self.It, rhs.It)
            and approx_equal(self.Ivt, rhs.Ivt)
        )


@dataclass
class SeedBeam:
    """Seed-laser injection description (seed_beam_struct)."""

    x: Optional[np.ndarray] = None
    y: Optional[np.ndarray] = None
    a: Optional[np.ndarray] = None
    b: Optional[np.ndarray] = None
    dx: float = 0.0
    dy: float = 0.0
    da: float = 0.0
    db: float = 0.0
    Wx: float = 0.0
    Wy: float = 0.0
    Wa: float = 0.0
    Wb: float = 0.0
    Wv: float = 0.0
    Wt: float = 0.0
    x0: float = 0.0
    y0: float = 0.0
    a0: float = 0.0
    b0: float = 0.0
    t0: float = 0.0
    E: float = 0.0
    target: float = 0.0
    chirp: float = 0.0
    seed_shape: List[SeedBeamShape] = field(default_factory=list)
    tau: List[float] = field(default_factory=list)
    use_transform: List[bool] = field(default_factory=list)

    @property
    def nx(self) -> int:
        return 0 if self.x is None else len(self.x)

    @property
    def ny(self) -> int:
        return 0 if self.y is None else len(self.y)

    @property
    def na(self) -> int:
        return 0 if self.a is None else len(self.a)

    @property
    def nb(self) -> int:
        return 0 if self.b is None else len(self.b)

    def valid(self) -> bool:
        if not _no_nan(self.x, self.y, self.a, self.b):
            return False
        for s, t in zip(self.seed_shape, self.tau):
            if not s.valid() or t != t:
                return False
        return True

    def __eq__(self, rhs) -> bool:
        if not isinstance(rhs, SeedBeam):
            return NotImplemented
        if (self.nx, self.ny, self.na, self.nb) != (rhs.nx, rhs.ny, rhs.na, rhs.nb):
            return False
        for name in ("dx", "dy", "da", "db", "Wx", "Wy", "Wa", "Wb", "Wv", "Wt",
                     "x0", "y0", "a0", "b0", "t0", "E", "target", "chirp"):
            if not approx_equal(getattr(self, name), getattr(rhs, name)):
                return False
        for name in ("x", "y", "a", "b"):
            if not approx_equal(getattr(self, name), getattr(rhs, name)):
                return False
        if not approx_equal(np.asarray(self.tau), np.asarray(rhs.tau)):
            return False
        return True


@dataclass
class RayGain:
    """Per-length-segment gain tables (ray_gain_struct).

    ``x``/``y``/``n`` stay float64 (gradients need the precision,
    RayTraceStructures.h:215-217); ``g0``/``E0``/``gv``/``gv0`` are float32.
    ``gv`` is stored here shaped ``(Nx*Ny, Nv)`` row-major like the reference's
    flat ``K x Nx x Ny`` layout (index ``k + cell*K``).
    """

    x: Optional[np.ndarray] = None  # (Nx,) f64
    y: Optional[np.ndarray] = None  # (Ny,) f64
    n: Optional[np.ndarray] = None  # (Nx*Ny,) f64, index i + j*Nx
    g0: Optional[np.ndarray] = None  # (Nx*Ny,) f32
    E0: Optional[np.ndarray] = None  # (Nx*Ny,) f32 or None
    gv: Optional[np.ndarray] = None  # (Nx*Ny*Nv,) f32, index k + cell*Nv
    gv0: Optional[np.ndarray] = None  # (Nx*Ny,) f32

    @property
    def Nx(self) -> int:
        return 0 if self.x is None else len(self.x)

    @property
    def Ny(self) -> int:
        return 0 if self.y is None else len(self.y)

    @property
    def Nv(self) -> int:
        if self.gv is None or self.Nx == 0 or self.Ny == 0:
            return 0
        return self.gv.size // (self.Nx * self.Ny)

    def initialize(self, Nx, Ny, Nv, use_emis: bool) -> "RayGain":
        self.x = np.zeros(Nx)
        self.y = np.zeros(Ny)
        self.n = np.zeros(Nx * Ny)
        self.g0 = np.zeros(Nx * Ny, dtype=np.float32)
        self.gv = np.zeros(Nx * Ny * Nv, dtype=np.float32)
        self.gv0 = np.zeros(Nx * Ny, dtype=np.float32)
        self.E0 = np.zeros(Nx * Ny, dtype=np.float32) if use_emis else None
        return self


@dataclass
class RaySeed:
    """Separable 5-D seed table f0*fx(x)*fy(y)*fa(a)*fb(b)*fv(v) (ray_seed_struct)."""

    dim: Optional[np.ndarray] = None  # (5,) int32
    x: List[np.ndarray] = field(default_factory=list)  # 5 grids (x,y,a,b,v)
    f: List[np.ndarray] = field(default_factory=list)  # 5 factor tables
    f0: float = 0.0

    def initialize(self, dim) -> "RaySeed":
        self.dim = np.asarray(dim, dtype=np.int32)
        self.x = [np.zeros(d) for d in dim]
        self.f = [np.zeros(d) for d in dim]
        return self

    def is_zero(self, euv_beam: EUVBeam) -> bool:
        """Prefilter: does the seed vanish on the euv grid?

        Mirrors ray_seed_struct::is_zero (RayTraceStructures.cpp:1357-1392):
        linear-interp each separable factor onto the corresponding euv grid
        and check the max.
        """
        if self.f0 < 1e-100:
            return True
        for grids, axis in zip((euv_beam.x, euv_beam.y, euv_beam.a, euv_beam.b), range(4)):
            xi, fi = self.x[axis], self.f[axis]
            inside = (grids >= xi[0]) & (grids <= xi[-1])
            if not np.any(inside):
                return True
            vals = np.interp(grids[inside], xi, fi)
            if np.max(vals) < 1e-100:
                return True
        return False


@dataclass
class CreateImageProblem:
    """Top-level work unit (create_image_struct).

    ``N_start``/``N_parallel`` carry the reference's stride-decomposition
    contract (RayTraceStructures.h:325-328): worker k of P processes rays
    k, k+P, k+2P, ...
    """

    N: int = 0
    N_start: int = 0
    N_parallel: int = 1
    euv_beam: Optional[EUVBeam] = None
    seed_beam: Optional[SeedBeam] = None
    gain: List[RayGain] = field(default_factory=list)
    seed: Optional[RaySeed] = None
    image: Optional[np.ndarray] = None  # (nx*ny*nv,) f64, index iv + nv*(i1 + i2*nx)
    I_ang: Optional[np.ndarray] = None  # (na*nb,) f64, index i3 + i4*na
