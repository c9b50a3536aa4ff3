"""Failure taxonomy + failed-ray capture.

Rebuild of the reference's deterministic failure pipeline (SURVEY.md section 5):
per-ray error codes (-1 perpendicular ray, -2 negative intensity, -3 NaN,
src/common/RayTraceImageHelper.h:514-594) are folded into a bitmask
(``set_bit(-error)``, src/RayTraceImageCPU.cpp:34), failed rays are captured
(up to N_FAILED_MAX) and dumped with the full gain tables to
``Failed_RayTrace_rays.dat`` for offline repro (write_failures,
src/RayTraceImage.cpp:140-183), then the run aborts.

The dump uses the same simple named-variable format the reference's
file_utilities writes: ASCII header line ``name,type,size`` + raw payload.
"""

from __future__ import annotations

import numpy as np

__all__ = ["RayTraceError", "set_bit", "check_bit", "failure_messages",
           "write_failures", "N_FAILED_MAX"]

N_FAILED_MAX = 32  # RayTraceImageHelper.h:32

_MESSAGES = {
    1: "Invalid ray detected",          # error -1: ray perpendicular to z
    2: "Negitive intensity detected",   # error -2 (reference spelling)
    3: "NaNs detected in intensity",    # error -3
}


class RayTraceError(RuntimeError):
    """Raised when any ray fails (the analogue of RAY_ERROR aborts)."""


def set_bit(n: int, code: int = 0) -> int:
    return code | (1 << n)


def check_bit(n: int, code: int) -> bool:
    return (code & (1 << n)) != 0


def failure_messages(failure_code: int) -> list[str]:
    return [msg for bit, msg in _MESSAGES.items() if check_bit(bit, failure_code)]


def _write_variable(fid, name: str, data: np.ndarray, kind: str):
    fid.write(f"{name},{kind},{data.size}\n".encode())
    fid.write(np.ascontiguousarray(data).tobytes())


def write_failures(path, failure_code: int, failed_rays: np.ndarray,
                   method: int, N: int, dz: float, gains) -> None:
    """Dump failed rays + gain tables for repro (write_failures,
    src/RayTraceImage.cpp:140-183)."""
    failed_rays = np.asarray(failed_rays, dtype=np.float64).reshape(-1, 4)
    failed_rays = failed_rays[:N_FAILED_MAX]
    with open(path, "wb") as fid:
        _write_variable(fid, "rays", failed_rays.reshape(-1), "double")
        _write_variable(fid, "method", np.array([method], np.int32), "int")
        _write_variable(fid, "N", np.array([N], np.int32), "int")
        _write_variable(fid, "dz", np.array([dz], np.float64), "double")
        for i, g in enumerate(gains):
            prefix = f"gain[{i}]."
            _write_variable(fid, prefix + "Nx", np.array([g.Nx], np.int32), "int")
            _write_variable(fid, prefix + "Ny", np.array([g.Ny], np.int32), "int")
            _write_variable(fid, prefix + "Nv", np.array([g.Nv], np.int32), "int")
            _write_variable(fid, prefix + "x", np.asarray(g.x, np.float64), "double")
            _write_variable(fid, prefix + "y", np.asarray(g.y, np.float64), "double")
            _write_variable(fid, prefix + "n", np.asarray(g.n, np.float64), "double")
            _write_variable(fid, prefix + "g0", np.asarray(g.g0, np.float32), "float")
            if g.E0 is not None:
                _write_variable(fid, prefix + "E0", np.asarray(g.E0, np.float32), "float")
            _write_variable(fid, prefix + "gv", np.asarray(g.gv, np.float32), "float")
            _write_variable(fid, prefix + "gv0", np.asarray(g.gv0, np.float32), "float")


_KINDS = {"double": np.float64, "float": np.float32, "int": np.int32}


def read_failures(path):
    """Parse a ``Failed_RayTrace_rays.dat`` dump back into
    ``(failed_rays [n,4], method, N, dz, gains)`` -- the inverse of
    :func:`write_failures`, closing the failure-repro loop (the reference
    writes this file for offline analysis, src/RayTraceImage.cpp:140-183,
    but ships no reader; ``tools/replay_failed_rays.py`` re-traces the
    rays through the scalar oracle)."""
    from raytrace_tpu_torch.structures import RayGain

    variables = {}
    with open(path, "rb") as fid:
        while True:
            header = fid.readline()
            if not header:
                break
            name, kind, size = header.decode().strip().rsplit(",", 2)
            dt = _KINDS[kind]
            payload = fid.read(int(size) * np.dtype(dt).itemsize)
            variables[name] = np.frombuffer(payload, dtype=dt).copy()

    rays = variables["rays"].reshape(-1, 4)
    method = int(variables["method"][0])
    N = int(variables["N"][0])
    dz = float(variables["dz"][0])
    gains = []
    for i in range(N):
        p = f"gain[{i}]."
        if p + "Nx" not in variables:
            break
        g = RayGain(
            x=variables[p + "x"], y=variables[p + "y"], n=variables[p + "n"],
            g0=variables[p + "g0"],
            E0=variables.get(p + "E0"),
            gv=variables[p + "gv"], gv0=variables[p + "gv0"])
        gains.append(g)
    return rays, method, N, dz, gains
