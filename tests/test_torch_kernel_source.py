"""The CUDA kernels' source compiled for the host CPU, against the plain
twins.

There is no nvcc here, but the kernels are plain C++ inside
``__global__`` functions. This test compiles ``csrc/*.cu`` with the host
C++ compiler behind a small header that maps the CUDA spellings onto host
C++ (``__ldg`` -> a load, ``atomicAdd`` -> an add, the ``<<<>>>`` launch ->
a loop over blocks and threads), with contraction off as nvcc's
``-fmad=false``. The result must equal the plain twin bitwise: it checks
that the kernel computes what the twin computes, in the same order of
rounding. The kernels' behaviour on the card (compiled by nvcc) is checked
by tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from raytrace_tpu_torch.models.problem import prepare_gain
from raytrace_tpu_torch.ops import cuda_lib, deposit_kernel, trace_kernel
from raytrace_tpu_torch.ops.stepper import trace_batch_plain
from raytrace_tpu_torch.testing import synthetic_problem

torch.set_num_threads(2)

_SHIM = r"""
#pragma once
#include <cmath>
#include <cstdint>
using std::tan; using std::atan;
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
template <class T> inline T __ldg(const T* p) { return *p; }
struct HostDim { unsigned x = 0; };
static HostDim blockIdx, threadIdx, blockDim;
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
inline double atomicAdd(double* p, double v) { double o = *p; *p = o + v; return o; }
"""

_LAUNCH = re.compile(r"(\w+)<<<\(unsigned\)blocks, threads, 0, "
                     r"\(cudaStream_t\)stream>>>\((.*?)\);", re.S)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    d = tmp_path_factory.mktemp("host_kernels")
    (d / "cuda_runtime.h").write_text(_SHIM)
    srcs = []
    for cu in sorted(cuda_lib.CSRC_DIR.glob("*.cu")):
        text = cu.read_text()
        m = _LAUNCH.search(text)
        assert m is not None, f"{cu.name}: launch statement not found"
        loop = ("for (int64_t bb = 0; bb < blocks; ++bb) "
                "for (int tt = 0; tt < threads; ++tt) { "
                "blockIdx.x = (unsigned)bb; threadIdx.x = (unsigned)tt; "
                f"blockDim.x = threads; {m.group(1)}({m.group(2)}); }}")
        out = d / (cu.stem + "_host.cpp")
        out.write_text(text[:m.start()] + loop + text[m.end():])
        srcs.append(str(out))
    so = d / "libhost_kernels.so"
    r = subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off",
                        "-fno-fast-math", "-shared", "-fPIC", "-I", str(d),
                        "-o", str(so), *srcs], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    for name, argtypes in cuda_lib._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _rays(p, n, seed):
    rng = np.random.default_rng(seed)
    b = p.seed_beam if p.seed is not None else p.euv_beam
    return {k: torch.from_numpy(g[rng.integers(0, len(g), n)]
                                .astype(np.float32))
            for k, g in zip("xyab", (b.x, b.y, b.a, b.b))}


@pytest.mark.parametrize("method", [1, 2])
@pytest.mark.parametrize("kwargs", [
    dict(refraction_free=True), dict(), dict(non_uniform_gain=0.8),
    dict(full_plane=True),
    dict(nx=60, ny=25, na=19, nb=14, nv=52, gain_nx=106, gain_ny=26),
], ids=["straight", "refracting", "warped-grid", "full-plane",
        "shipped-widths"])
def test_trace_source_equals_twin(host_lib, method, kwargs):
    p = synthetic_problem(seeded=method == 2, **kwargs)
    rays = _rays(p, 512, 1)
    gain = prepare_gain(p.gain)
    use_emis = method == 1
    want = trace_batch_plain(rays, p.N, p.euv_beam.dz, gain, method,
                             use_emis=use_emis)
    B = trace_kernel._check_inputs(rays, gain, p.N)
    got = trace_kernel._launch(host_lib, rays, B, p.N, p.euv_beam.dz, gain,
                               method, 0.5, use_emis, None)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("method", [1, 2])
def test_trace_source_ragged_grids(host_lib, method):
    """Segments with different grid sizes (padded tables, per-segment
    bisection bounds)."""
    from test_torch_create_image import regrid

    p = synthetic_problem(N=4, seeded=method == 2)
    regrid(p, 1, 35, 14)
    regrid(p, 2, 22, 9)
    rays = _rays(p, 512, 3)
    gain = prepare_gain(p.gain)
    want = trace_batch_plain(rays, p.N, p.euv_beam.dz, gain, method,
                             use_emis=method == 1)
    B = trace_kernel._check_inputs(rays, gain, p.N)
    got = trace_kernel._launch(host_lib, rays, B, p.N, p.euv_beam.dz, gain,
                               method, 0.5, method == 1, None)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_deposit_source_equals_twin(host_lib):
    rng = np.random.default_rng(2)
    B, K, C = 3000, 7, 40
    contrib = torch.from_numpy(rng.standard_normal((B, K)))
    bins = torch.from_numpy(rng.integers(0, C + 1, B).astype(np.int32))
    want = deposit_kernel.deposit_plain(
        torch.zeros((C, K), dtype=torch.float64), contrib, bins)
    got = torch.zeros((C, K), dtype=torch.float64)
    deposit_kernel._launch(host_lib, got, contrib, bins, B, K, C, None)
    torch.testing.assert_close(got, want, rtol=1e-14, atol=1e-14)
