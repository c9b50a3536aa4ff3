"""Build and load the package's CUDA kernels.

At first use, ``nvcc`` compiles every ``.cu`` file under
``raytrace_tpu_torch/csrc/`` for Hopper (``sm_90a``), one process per file,
all started together, and links the objects into one shared library with a
plain C interface, under ``build/raytrace_tpu_torch/<hash>/`` at the root of
the checkout (``build/`` is git-ignored). The directory name
is a hash of the sources and flags, so an edited kernel is rebuilt and an
unchanged one is loaded as it is. The library is loaded with ``ctypes``;
each C entry returns ``cudaGetLastError()`` of its launch.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc``.

A C entry launches on the current device, and ``rt_trace`` sizes its grid
from that device's occupancy; the wrappers therefore launch under
:func:`device_guard` of their inputs, so that a kernel whose tensors lie on
``cuda:k`` runs on ``cuda:k`` whatever device the caller made current.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["load_library", "build_info", "check", "device_guard",
           "count_launch", "Launches", "graph_nodes", "NVCC_FLAGS",
           "CSRC_DIR"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "raytrace_tpu_torch"

#: -fmad=false: every product and sum rounds on its own, as in the plain
#: PyTorch twins (see csrc/trace.cu, csrc/amplify.cu). -Xptxas -v records
#: registers and spills per kernel in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

_P, _I, _I64, _F, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float, ctypes.c_double)

#: argtypes per C entry: pointers and the stream as c_void_p (a plain int
#: would be cut to 32 bits), sizes as c_int / c_int64, scalars as c_float
#: or c_double
_SIGNATURES = {
    "rt_trace": [_P] * 4 + [_I64] + [_P] * 13 + [_I] * 3 + [_F] * 2
                + [_I] * 2 + [_P] * 12 + [_P],
    "rt_find_index": [_P, _I, _P, _I64, _P, _P],
    "rt_bin_deposit": [_P] * 6 + [_I64, _I, _I] + [_P, _I, _D] * 4
                      + [_P, _D, _I, _I] + [_P] * 3 + [_P],
    "rt_bin_deposit_f32": [_P] * 6 + [_I64, _I, _I] + [_P, _I, _D] * 4
                          + [_P, _D, _I, _I] + [_P] * 3 + [_P],
    "rt_amplify_seeded": [_P] * 6 + [_I64] + [_I] * 5 + [_P] * 4,
    "rt_amplify_seeded_f32": [_P] * 6 + [_I64] + [_I] * 5 + [_P] * 4,
    "rt_gather_probe": [_P] * 3 + [_I64] + [_I] * 2 + [_P],
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
        t0 = time.perf_counter()
        log = _build(out_dir, so)
        _info.update(built=True, seconds=time.perf_counter() - t0,
                     path=str(so), log=log)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _build(out_dir: Path, so: Path) -> str:
    """Compile each source to an object (all nvcc processes at once), link
    them into ``so``; returns the compiler log (also in ``build.log``)."""
    nvcc = _nvcc()
    tag = f".tmp-{os.getpid()}"
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = out_dir / f"{tag}-{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _obj, proc in jobs:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    if not failed:
        tmp = out_dir / f"{tag}.so"
        cmd = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
               *[str(obj) for _cmd, obj, _proc in jobs]]
        r = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + r.stdout + r.stderr)
        if r.returncode != 0:
            failed.append(r.stderr)
        else:
            os.replace(tmp, so)
    for _cmd, obj, _proc in jobs:
        obj.unlink(missing_ok=True)
    text = "\n".join(log)
    (out_dir / "build.log").write_text(text)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return text


def build_info() -> dict:
    """What :func:`load_library` did: ``built`` (compiled in this process),
    ``seconds`` (nvcc wall time), ``path`` and the compiler ``log``."""
    return dict(_info)


def device_guard(dev):
    """``torch.cuda.device(dev)`` for a CUDA device: work enqueued inside
    runs on ``dev`` and its current stream. A null context for the CPU
    (the host-compiled library of the source tests, the plain twins)."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def count_launch(counts: dict, dev) -> None:
    """Add one launch on ``dev`` to a wrapper's per-device counts (beside
    its total ``launch_count``)."""
    dev = torch.device(dev)
    counts[dev] = counts.get(dev, 0) + 1


class Launches:
    """The launches of one instantiation of a kernel: ``launch_count`` in
    all and ``device_launches`` per device, beside its wrapper's totals
    (the same two names, so a counter of either kind reads alike)."""

    def __init__(self):
        self.launch_count = 0
        self.device_launches: dict = {}

    def count(self, dev) -> None:
        """One launch on ``dev``."""
        self.launch_count += 1
        count_launch(self.device_launches, dev)


def check(rc: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


#: ``CUgraphNodeType`` values (cuda.h) that :func:`graph_nodes` names
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}


def graph_nodes(graph: int) -> dict:
    """The nodes of a captured CUDA graph (a ``cudaGraph_t``, as
    ``torch.cuda.CUDAGraph.raw_cuda_graph()`` gives it) by type:
    ``kernel``, ``memcpy``, ``memset`` and ``other``, read through
    ``libcuda``'s graph calls."""
    drv = ctypes.CDLL("libcuda.so.1")
    for fn in (drv.cuGraphGetNodes, drv.cuGraphNodeGetType):
        fn.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    check(drv.cuGraphGetNodes(ctypes.c_void_p(graph), None, ctypes.byref(n)),
          "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(drv.cuGraphGetNodes(ctypes.c_void_p(graph), nodes,
                              ctypes.byref(n)), "cuGraphGetNodes")
    out = dict(kernel=0, memcpy=0, memset=0, other=0)
    kind = ctypes.c_int(0)
    for node in nodes:
        check(drv.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)),
              "cuGraphNodeGetType")
        out[_NODE_TYPES.get(kind.value, "other")] += 1
    return out
