"""Build and load the package's CUDA kernels.

At first use, ``nvcc`` compiles every ``.cu`` file under
``raytrace_tpu_torch/csrc/`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, under ``build/raytrace_tpu_torch/<hash>/``
at the root of the checkout (``build/`` is git-ignored). The directory name
is a hash of the sources and flags, so an edited kernel is rebuilt and an
unchanged one is loaded as it is. The library is loaded with ``ctypes``;
each C entry returns ``cudaGetLastError()`` of its launch.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load_library", "build_info", "check", "NVCC_FLAGS", "CSRC_DIR"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "raytrace_tpu_torch"

#: -fmad=false: every f32 product and sum rounds on its own, as in the plain
#: PyTorch twins (see csrc/trace.cu). -Xptxas -v records registers and
#: spills per kernel in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)

#: argtypes per C entry: pointers and the stream as c_void_p (a plain int
#: would be cut to 32 bits), sizes as c_int / c_int64, scalars as c_float
_SIGNATURES = {
    "rt_trace": [_P] * 4 + [_I64] + [_P] * 13 + [_I] * 3 + [_F] * 2
                + [_I] * 2 + [_P] * 9 + [_P],
    "rt_deposit": [_P, _P, _P, _I64, _I, _I, _P],
}

_lib = None
_info: dict = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "libraytrace_tpu_torch.so"
    if so.exists():
        _info.update(built=False, seconds=0.0, path=str(so))
    else:
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".tmp-{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(s) for s in _sources() if s.suffix == ".cu"]]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        (out_dir / "build.log").write_text(
            " ".join(cmd) + "\n" + r.stdout + r.stderr)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
        os.replace(tmp, so)
        _info.update(built=True, seconds=seconds, path=str(so),
                     log=r.stdout + r.stderr)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def build_info() -> dict:
    """What :func:`load_library` did: ``built`` (compiled in this process),
    ``seconds`` (nvcc wall time), ``path`` and the compiler ``log``."""
    return dict(_info)


def check(rc: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
