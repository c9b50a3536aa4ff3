"""Byte-exact (de)serialization of the RayTrace ``.dat`` snapshot format.

The reference persists production state as length-prefixed, versioned byte
blobs (src/RayTraceStructures.cpp). This module reads and writes that exact
little-endian wire format from Python/numpy:

* 16-byte ``byte_array_header``: magic id=237, int/double sizes, version,
  type tag (2 euv_beam, 3 seed_beam, 6 seed_beam_shape), 5-byte N_bytes
  (<= 1 TB), 4 flag bytes (flags[0] = compression)
  (RayTraceStructures.h:470-490, .cpp:118-192)
* ``EUV_beam_struct``  pack/unpack   (.cpp:441-573)
* ``seed_beam_shape_struct``         (.cpp:671-844, incl. compression 0/1/2)
* ``seed_beam_struct``               (.cpp:1028-1318, incl. legacy v1 format)
* ``ray_gain_struct``  (headerless)  (.cpp:1987-2047)
* ``ray_seed_struct``  (headerless)  (.cpp:1393-1431)
* ``create_image_struct`` (concatenated length-prefixed sub-blobs +
  optional golden image/I_ang)       (.cpp:2159-2292)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from raytrace_tpu_torch.structures import (
    CreateImageProblem,
    EUVBeam,
    RayGain,
    RaySeed,
    SeedBeam,
    SeedBeamShape,
)
from raytrace_tpu_torch.io import compression as zcomp

__all__ = [
    "ByteArrayHeader",
    "HEADER_SIZE",
    "MAGIC_ID",
    "unpack_euv_beam", "pack_euv_beam",
    "unpack_seed_beam_shape", "pack_seed_beam_shape",
    "unpack_seed_beam", "pack_seed_beam",
    "unpack_ray_gain", "pack_ray_gain",
    "unpack_ray_seed", "pack_ray_seed",
    "unpack_create_image", "pack_create_image",
]

HEADER_SIZE = 16
MAGIC_ID = 237

# type tags (RayTraceStructures.h:476-477)
TYPE_UNKNOWN, TYPE_PLASMA, TYPE_EUV_BEAM, TYPE_SEED_BEAM = 0, 1, 2, 3
TYPE_GAIN, TYPE_INTENSITY, TYPE_SEED_BEAM_SHAPE = 4, 5, 6


class _Cursor:
    """Sequential little-endian reader over a bytes-like object."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def _read(self, fmt: str):
        size = struct.calcsize(fmt)
        vals = struct.unpack_from(fmt, self.data, self.pos)
        self.pos += size
        return vals

    def i32(self) -> int:
        return self._read("<i")[0]

    def u32(self) -> int:
        return self._read("<I")[0]

    def u64(self) -> int:
        return self._read("<Q")[0]

    def f64(self) -> float:
        return self._read("<d")[0]

    def boolean(self) -> bool:
        return self._read("<?")[0]

    def array(self, count: int, dtype) -> np.ndarray:
        dtype = np.dtype(dtype)
        out = np.frombuffer(self.data, dtype=dtype, count=count, offset=self.pos).copy()
        self.pos += count * dtype.itemsize
        return out

    def raw(self, nbytes: int) -> bytes:
        out = self.data[self.pos:self.pos + nbytes]
        self.pos += nbytes
        return out


class _Builder:
    """Sequential little-endian writer."""

    def __init__(self):
        self.parts: list[bytes] = []

    def i32(self, v: int):
        self.parts.append(struct.pack("<i", v))

    def u32(self, v: int):
        self.parts.append(struct.pack("<I", v))

    def u64(self, v: int):
        self.parts.append(struct.pack("<Q", v))

    def f64(self, v: float):
        self.parts.append(struct.pack("<d", v))

    def boolean(self, v: bool):
        self.parts.append(struct.pack("<?", v))

    def array(self, arr: np.ndarray, dtype):
        self.parts.append(np.ascontiguousarray(arr, dtype=dtype).tobytes())

    def raw(self, b: bytes):
        self.parts.append(b)

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


@dataclass
class ByteArrayHeader:
    """The 16-byte container header (byte_array_header)."""

    version: int = 0
    type: int = 0
    n_bytes: int = 0
    flags: bytes = b"\x00\x00\x00\x00"

    @staticmethod
    def load(data: bytes, offset: int = 0) -> tuple["ByteArrayHeader", int]:
        """Read a header if present; return (header, payload_offset).

        Headerless (pre-v1) blobs are detected by the missing magic byte
        (load_byte_header, RayTraceStructures.cpp:133-150).
        """
        if len(data) - offset >= HEADER_SIZE and data[offset] == MAGIC_ID:
            (id_, size_int, size_double, version, type_, _u0, _u1) = struct.unpack_from(
                "<7B", data, offset
            )
            if size_int != 4 or size_double != 8:
                raise ValueError("Unsupported int/double sizes in byte header")
            hi = data[offset + 7]
            (lo,) = struct.unpack_from("<I", data, offset + 8)
            n_bytes = hi * 4294967296 + lo
            flags = bytes(data[offset + 12:offset + 16])
            return ByteArrayHeader(version, type_, n_bytes, flags), offset + HEADER_SIZE
        return ByteArrayHeader(version=0), offset

    def dump(self) -> bytes:
        assert self.n_bytes < 1099511627776
        hi = self.n_bytes // 4294967296
        lo = self.n_bytes % 4294967296
        return struct.pack(
            "<5B2B", MAGIC_ID, 4, 8, self.version, self.type, 0, 0
        ) + struct.pack("<B", hi) + struct.pack("<I", lo) + self.flags

    def check_n_bytes(self, consumed: int):
        """check_N_bytes semantics (RayTraceStructures.cpp:182-192)."""
        if self.version >= 2 and self.n_bytes not in (0, consumed):
            raise ValueError(
                f"byte count mismatch: read {consumed}, header says {self.n_bytes}"
            )


# ---------------------------------------------------------------------------
# EUV_beam_struct
# ---------------------------------------------------------------------------

def unpack_euv_beam(data: bytes) -> EUVBeam:
    head, off = ByteArrayHeader.load(data)
    if head.version > 0 and head.type != TYPE_EUV_BEAM:
        raise ValueError("byte array does not contain euv_beam data")
    c = _Cursor(data, off)
    beam = EUVBeam()
    beam.run_ASE = c.boolean()
    beam.run_sat = c.boolean()
    beam.run_refract = c.boolean()
    nx, ny, nz, na, nb, nv = (c.i32() for _ in range(6))
    c.i32()  # legacy nz_sub field
    if min(nx, ny, nz, na, nb, nv) < 1:
        raise ValueError("invalid euv_beam dimensions")
    beam.R_scale = c.f64()
    beam.G_scale = c.f64()
    beam.lam = c.f64()
    beam.Nc = c.f64()
    beam.dx = c.f64()
    beam.dy = c.f64()
    beam.dz = c.f64()
    beam.da = c.f64()
    beam.db = c.f64()
    beam.v0 = c.f64()
    beam.x = c.array(nx, np.float64)
    beam.y = c.array(ny, np.float64)
    beam.z = c.array(nz, np.float64)
    beam.a = c.array(na, np.float64)
    beam.b = c.array(nb, np.float64)
    beam.v = c.array(nv, np.float64)
    beam.dv = c.array(nv, np.float64)
    head.check_n_bytes(c.pos)
    return beam


def pack_euv_beam(beam: EUVBeam) -> bytes:
    b = _Builder()
    b.boolean(beam.run_ASE)
    b.boolean(beam.run_sat)
    b.boolean(beam.run_refract)
    for v in (beam.nx, beam.ny, beam.nz, beam.na, beam.nb, beam.nv, 0):
        b.i32(v)
    for v in (beam.R_scale, beam.G_scale, beam.lam, beam.Nc, beam.dx, beam.dy,
              beam.dz, beam.da, beam.db, beam.v0):
        b.f64(v)
    for arr in (beam.x, beam.y, beam.z, beam.a, beam.b, beam.v, beam.dv):
        b.array(arr, np.float64)
    payload = b.getvalue()
    head = ByteArrayHeader(version=2, type=TYPE_EUV_BEAM,
                           n_bytes=HEADER_SIZE + len(payload))
    return head.dump() + payload


# ---------------------------------------------------------------------------
# seed_beam_shape_struct
# ---------------------------------------------------------------------------

def unpack_seed_beam_shape(data: bytes) -> SeedBeamShape:
    head, off = ByteArrayHeader.load(data)
    if head.version > 0 and head.type != TYPE_SEED_BEAM_SHAPE:
        raise ValueError("byte array does not contain seed_beam_shape data")
    comp = head.flags[0]
    if head.n_bytes == 0 and comp != 0:
        raise ValueError("byte array header appears invalid")
    c = _Cursor(data, off)
    shape = SeedBeamShape()
    n = c.i32()
    nv = c.i32()
    shape.nv = nv
    size_T, size_It, size_Ivt = c.i32(), c.i32(), c.i32()
    if comp == 0:
        # raw doubles; the three "size" ints hold element counts here
        shape.T = c.array(n, np.float64)
        shape.It = c.array(3 * n, np.float64)
        shape.Ivt = c.array(3 * n * nv, np.float64)
    elif comp in (1, 2):
        dt = np.float64
        shape.T = zcomp.decompress_array(n, c.raw(size_T), comp, dt)
        shape.It = zcomp.decompress_array(3 * n, c.raw(size_It), comp, dt)
        shape.Ivt = zcomp.decompress_array(3 * n * nv, c.raw(size_Ivt), comp, dt)
    else:
        raise ValueError("Unsupported compression type")
    head.check_n_bytes(c.pos)
    return shape


def pack_seed_beam_shape(shape: SeedBeamShape, compression: int = 0) -> bytes:
    if shape.n <= 0 or shape.nv <= 0:
        raise ValueError("seed_beam_shape_struct is invalid (n==0 or nv==0)")
    b = _Builder()
    b.i32(shape.n)
    b.i32(shape.nv)
    if compression == 0:
        b.i32(shape.n)
        b.i32(3 * shape.n)
        b.i32(3 * shape.n * shape.nv)
        b.array(shape.T, np.float64)
        b.array(shape.It, np.float64)
        b.array(shape.Ivt, np.float64)
    elif compression in (1, 2):
        blobs = [
            zcomp.compress_array(np.asarray(arr, dtype=np.float64), compression)
            for arr in (shape.T, shape.It, shape.Ivt)
        ]
        for blob in blobs:
            b.i32(len(blob))
        for blob in blobs:
            b.raw(blob)
    else:
        raise ValueError("Unknown compression")
    payload = b.getvalue()
    head = ByteArrayHeader(version=2, type=TYPE_SEED_BEAM_SHAPE,
                           n_bytes=HEADER_SIZE + len(payload),
                           flags=bytes([compression, 0, 0, 0]))
    return head.dump() + payload


# ---------------------------------------------------------------------------
# seed_beam_struct
# ---------------------------------------------------------------------------

def unpack_seed_beam(data: bytes) -> SeedBeam:
    head, off = ByteArrayHeader.load(data)
    if head.version > 0 and head.type != TYPE_SEED_BEAM:
        raise ValueError("byte array does not contain seed_beam data")
    comp = head.flags[0]
    if head.n_bytes == 0 and comp != 0:
        raise ValueError("byte array header appears invalid")
    c = _Cursor(data, off)
    sb = SeedBeam()
    nx, ny, na, nb = c.i32(), c.i32(), c.i32(), c.i32()
    for name in ("dx", "dy", "da", "db", "Wx", "Wy", "Wa", "Wb", "Wv", "Wt",
                 "x0", "y0", "a0", "b0", "t0", "E", "target", "chirp"):
        setattr(sb, name, c.f64())
    sb.x = c.array(nx, np.float64)
    sb.y = c.array(ny, np.float64)
    sb.a = c.array(na, np.float64)
    sb.b = c.array(nb, np.float64)
    if head.version >= 2:
        n_shapes = c.i32()
        if n_shapes > 0:
            sb.tau = [c.f64() for _ in range(n_shapes)]
            sb.use_transform = [c.boolean() for _ in range(n_shapes)]
            for _ in range(n_shapes):
                nb_shape = c.i32()
                sb.seed_shape.append(
                    unpack_seed_beam_shape(c.raw(nb_shape))
                )
    elif head.version == 1:
        # legacy v1 layout (RayTraceStructures.cpp:1215-1237)
        n_shapes = c.i32()
        nv = c.i32()
        if n_shapes < 0:
            raise ValueError("seed_beam v1: N < 0")
        for _ in range(n_shapes):
            sb.use_transform.append(c.boolean())
            sb.tau.append(c.f64())
            sb.seed_shape.append(_read_old_seed_shape(c, nv, comp))
    else:
        raise ValueError("Unknown data format for seed beam")
    head.check_n_bytes(c.pos)
    return sb


def _read_old_seed_shape(c: _Cursor, nv: int, comp: int) -> SeedBeamShape:
    """Pre-v2 inline seed-shape layout (read_old_seed_shape_data,
    RayTraceStructures.cpp:1243-1318)."""
    n = c.i32()
    shape = SeedBeamShape()
    shape.nv = nv
    if comp == 0:
        shape.T = c.array(n, np.float64)
        shape.It = c.array(3 * n, np.float64)
        shape.Ivt = c.array(3 * n * nv, np.float64)
    elif comp in (1, 2):
        size_T, size_It, size_Ivt = c.i32(), c.i32(), c.i32()
        shape.T = zcomp.decompress_array(n, c.raw(size_T), comp, np.float64)
        shape.It = zcomp.decompress_array(3 * n, c.raw(size_It), comp, np.float64)
        shape.Ivt = zcomp.decompress_array(3 * n * nv, c.raw(size_Ivt), comp, np.float64)
    else:
        raise ValueError("Unsupported compression type")
    return shape


def pack_seed_beam(sb: SeedBeam, compression: int = 0) -> bytes:
    if compression not in (0, 1, 2):
        raise ValueError("Unknown or unsupported compression type")
    b = _Builder()
    b.i32(sb.nx)
    b.i32(sb.ny)
    b.i32(sb.na)
    b.i32(sb.nb)
    for name in ("dx", "dy", "da", "db", "Wx", "Wy", "Wa", "Wb", "Wv", "Wt",
                 "x0", "y0", "a0", "b0", "t0", "E", "target", "chirp"):
        b.f64(getattr(sb, name))
    for arr in (sb.x, sb.y, sb.a, sb.b):
        b.array(arr, np.float64)
    n_shapes = len(sb.seed_shape)
    b.i32(n_shapes)
    for t in sb.tau:
        b.f64(t)
    for u in sb.use_transform:
        b.boolean(u)
    for shape in sb.seed_shape:
        blob = pack_seed_beam_shape(shape, compression)
        b.i32(len(blob))
        b.raw(blob)
    payload = b.getvalue()
    head = ByteArrayHeader(version=2, type=TYPE_SEED_BEAM,
                           n_bytes=HEADER_SIZE + len(payload),
                           flags=bytes([compression, 0, 0, 0]))
    return head.dump() + payload


# ---------------------------------------------------------------------------
# ray_gain_struct (headerless)
# ---------------------------------------------------------------------------

def unpack_ray_gain(data: bytes) -> RayGain:
    c = _Cursor(data)
    g = RayGain()
    Nx, Ny, Nv = c.i32(), c.i32(), c.i32()
    g.x = c.array(Nx, np.float64)
    g.y = c.array(Ny, np.float64)
    g.n = c.array(Nx * Ny, np.float64)
    g.g0 = c.array(Nx * Ny, np.float32)
    g.E0 = c.array(Nx * Ny, np.float32)
    g.gv = c.array(Nx * Ny * Nv, np.float32)
    g.gv0 = c.array(Nx * Ny, np.float32)
    if c.pos != len(data):
        raise ValueError("ray_gain blob size mismatch")
    return g


def pack_ray_gain(g: RayGain) -> bytes:
    b = _Builder()
    b.i32(g.Nx)
    b.i32(g.Ny)
    b.i32(g.Nv)
    b.array(g.x, np.float64)
    b.array(g.y, np.float64)
    b.array(g.n, np.float64)
    b.array(g.g0, np.float32)
    # the reference always serializes E0 (pack, RayTraceStructures.cpp:2009)
    E0 = g.E0 if g.E0 is not None else np.zeros(g.Nx * g.Ny, dtype=np.float32)
    b.array(E0, np.float32)
    b.array(g.gv, np.float32)
    b.array(g.gv0, np.float32)
    return b.getvalue()


# ---------------------------------------------------------------------------
# ray_seed_struct (headerless)
# ---------------------------------------------------------------------------

def unpack_ray_seed(data: bytes) -> RaySeed:
    c = _Cursor(data)
    s = RaySeed()
    s.dim = c.array(5, np.int32)
    s.x, s.f = [], []
    for d in s.dim:
        s.x.append(c.array(int(d), np.float64))
        s.f.append(c.array(int(d), np.float64))
    s.f0 = c.f64()
    if c.pos != len(data):
        raise ValueError("ray_seed blob size mismatch")
    return s


def pack_ray_seed(s: RaySeed) -> bytes:
    b = _Builder()
    b.array(np.asarray(s.dim, dtype=np.int32), np.int32)
    for xi, fi in zip(s.x, s.f):
        b.array(xi, np.float64)
        b.array(fi, np.float64)
    b.f64(s.f0)
    return b.getvalue()


# ---------------------------------------------------------------------------
# create_image_struct (headerless concatenation of sub-blobs)
# ---------------------------------------------------------------------------

def unpack_create_image(data: bytes) -> CreateImageProblem:
    c = _Cursor(data)
    p = CreateImageProblem()
    p.N = c.i32()
    p.N_start = c.i32()
    p.N_parallel = c.i32()
    c.f64()  # dz, redundant with euv_beam.dz (unpack, RayTraceStructures.cpp:2237)
    nb_tmp = c.u32()
    p.euv_beam = unpack_euv_beam(c.raw(nb_tmp)) if nb_tmp > 0 else None
    nb_tmp = c.u32()
    p.seed_beam = unpack_seed_beam(c.raw(nb_tmp)) if nb_tmp > 0 else None
    p.gain = []
    for _ in range(p.N):
        nb_tmp = c.u32()
        p.gain.append(unpack_ray_gain(c.raw(nb_tmp)))
    nb_tmp = c.u32()
    p.seed = unpack_ray_seed(c.raw(nb_tmp)) if nb_tmp > 0 else None
    if c.boolean():
        beam = p.euv_beam
        p.image = c.array(beam.nx * beam.ny * beam.nv, np.float64)
    if c.boolean():
        beam = p.euv_beam
        p.I_ang = c.array(beam.na * beam.nb, np.float64)
    if c.pos != len(data):
        raise ValueError("create_image blob size mismatch")
    return p


def pack_create_image(p: CreateImageProblem, compression: int = 0) -> bytes:
    b = _Builder()
    b.i32(p.N)
    b.i32(p.N_start)
    b.i32(p.N_parallel)
    b.f64(p.euv_beam.dz if p.euv_beam is not None else 0.0)
    euv_blob = pack_euv_beam(p.euv_beam) if p.euv_beam is not None else b""
    b.u32(len(euv_blob))
    b.raw(euv_blob)
    sb_blob = pack_seed_beam(p.seed_beam, compression) if p.seed_beam is not None else b""
    b.u32(len(sb_blob))
    b.raw(sb_blob)
    for g in p.gain:
        blob = pack_ray_gain(g)
        b.u32(len(blob))
        b.raw(blob)
    seed_blob = pack_ray_seed(p.seed) if p.seed is not None else b""
    b.u32(len(seed_blob))
    b.raw(seed_blob)
    b.boolean(p.image is not None)
    if p.image is not None:
        b.array(p.image, np.float64)
    b.boolean(p.I_ang is not None)
    if p.I_ang is not None:
        b.array(p.I_ang, np.float64)
    return b.getvalue()
