"""The CUDA kernels' source compiled for the host CPU, against the plain
twins.

There is no nvcc here, but the kernels are plain C++ inside
``__global__`` functions. This test compiles ``csrc/*.cu`` with the host
C++ compiler behind a small header that maps the CUDA spellings onto host
C++ (``__ldg`` -> a load, ``atomicAdd`` -> an add, the ``<<<>>>`` launch ->
a loop over blocks and threads), with contraction off as nvcc's
``-fmad=false``. The result must equal the plain twin bitwise: it checks
that the kernel computes what the twin computes, in the same order of
rounding (for B3's ``exp`` the host's libm stands in for CUDA's, so only
the log-gain is held bitwise and the spectrum to 1e-14). The header maps
a warp onto one lane and the launch onto loops over blocks and over the
block's threads, y outer and x inner, one thread after another. The kernels'
behaviour on the card (compiled by nvcc) is checked by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import ctypes
import math
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from raytrace_tpu_torch.models.problem import prepare_gain
from raytrace_tpu_torch.ops import (amplify_kernel, cuda_lib, deposit_kernel,
                                    spectrum, trace_kernel)
from raytrace_tpu_torch.ops.stepper import trace_batch_plain
from raytrace_tpu_torch.testing import (amplify_inputs, emis_inputs,
                                        same_bits, synthetic_problem)

torch.set_num_threads(2)

_SHIM = r"""
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
using std::tan; using std::atan; using std::exp;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
// shared memory: one block at a time, so a static array per declaration
#define __shared__ static
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static dim3 blockIdx, threadIdx, blockDim, gridDim;
struct float2 { float x, y; };
struct double2 { double x, y; };
inline double2 make_double2(double x, double y) { return {x, y}; }
inline float2 make_float2(float x, float y) { return {x, y}; }
inline unsigned __float_as_uint(float v) { unsigned u; std::memcpy(&u, &v, 4); return u; }
inline float __uint_as_float(unsigned u) { float v; std::memcpy(&v, &u, 4); return v; }
inline float __int_as_float(int i) { float v; std::memcpy(&v, &i, 4); return v; }
inline int __float_as_int(float v) { int i; std::memcpy(&i, &v, 4); return i; }
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline void __stcs(T* p, T v) { *p = v; }
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
constexpr int cudaErrorInvalidValue = 1;
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n); return 0;
}
template <class T> inline T atomicAdd(T* p, T v) { T o = *p; *p = o + v; return o; }
template <class T> inline T atomicOr(T* p, T v) { T o = *p; *p = o | v; return o; }
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 1; return 0; }
template <class F>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1; return 0;
}
// a warp of one lane: the threads of a block run one after another
static const unsigned warpSize = 1;
inline int __ffs(int v) { return __builtin_ffs(v); }
inline unsigned __activemask() { return 1u; }
inline unsigned __ballot_sync(unsigned, int p) { return p ? 1u : 0u; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
template <class T> inline T __shfl_sync(unsigned, T v, int, int = 32) { return v; }
template <class T> inline T __shfl_xor_sync(unsigned, T v, int, int = 32) { return v; }
inline unsigned __match_any_sync(unsigned, unsigned long long) { return 1u; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
// a block that shares memory runs as one thread (its loops are strided by
// blockDim.x), so a barrier has nothing to wait for
inline void __syncthreads() {}
#define __align__(n) alignas(n)
alignas(16) static unsigned char rt_dynamic_shared[1 << 20];
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> inline int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
"""

#: a launch ``kernel<...><<<grid, block, 0, stream>>>(args);`` with the
#: configuration in plain names or casts (no commas inside them)
_LAUNCH = re.compile(r"([A-Za-z_]\w*(?:<[^<>;]*>)?)\s*<<<([^<>]*?)>>>"
                     r"\((.*?)\);", re.S)


def _host_launch(m):
    """The launch as loops over blocks and over the block's threads (y
    outer, x inner), one thread after another. A launch with dynamic shared
    memory is a block whose threads share it across barriers: it runs as
    one thread, which its loops (strided by blockDim.x) carry through the
    whole block's work, barriers and all."""
    config = [x.strip() for x in m.group(2).split(",")]
    grid, block = config[:2]
    if len(config) > 2 and config[2] != "0":
        block = "1"
    return ("{ const dim3 g_(" + grid + "), b_(" + block + "); "
            "gridDim = g_; blockDim = b_; "
            "for (unsigned bx = 0; bx < g_.x; ++bx) "
            "for (unsigned ty = 0; ty < b_.y; ++ty) "
            "for (unsigned tx = 0; tx < b_.x; ++tx) { "
            "blockIdx.x = bx; threadIdx.x = tx; threadIdx.y = ty; "
            f"{m.group(1)}({m.group(3)}); }} }}")


#: a block's dynamic shared memory, onto the shim's one host buffer
_DYNAMIC_SHARED = re.compile(
    r"extern __shared__ __align__\(16\) unsigned char (\w+)\[\];")


def _host_build(d, sources, defines=()):
    """Compile ``sources`` for the host behind the shim into a library in
    ``d``; returns it with the entries' argument types set."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    (d / "cuda_runtime.h").write_text(_SHIM)
    srcs = []
    for cu in sources:
        text, n = _LAUNCH.subn(_host_launch, cu.read_text())
        text = _DYNAMIC_SHARED.sub(r"unsigned char* \1 = rt_dynamic_shared;",
                                   text)
        assert n > 0, f"{cu.name}: launch statement not found"
        out = d / (cu.stem + "_host.cpp")
        out.write_text(text)
        srcs.append(str(out))
    so = d / "libhost_kernels.so"
    r = subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off",
                        "-fno-fast-math", "-shared", "-fPIC", "-I", str(d),
                        "-I", str(cuda_lib.CSRC_DIR), *defines, "-o",
                        str(so), *srcs], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    for name, argtypes in cuda_lib._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _host_build(tmp_path_factory.mktemp("host_kernels"),
                       sorted(cuda_lib.CSRC_DIR.glob("*.cu")))


def _rays(p, n, seed):
    rng = np.random.default_rng(seed)
    b = p.seed_beam if p.seed is not None else p.euv_beam
    return {k: torch.from_numpy(g[rng.integers(0, len(g), n)]
                                .astype(np.float32))
            for k, g in zip("xyab", (b.x, b.y, b.a, b.b))}


#: the shipped ASE widths
_SHIPPED = dict(nx=60, ny=25, na=19, nb=14, nv=52, gain_nx=106, gain_ny=26)


@pytest.mark.parametrize("method", [1, 2])
@pytest.mark.parametrize("kwargs,n_rays", [
    (dict(refraction_free=True), 512), (dict(), 512),
    (dict(non_uniform_gain=0.8), 512), (dict(full_plane=True), 512),
    (_SHIPPED, 512), (dict(_SHIPPED, N=6), 512), (dict(), 3 * 128 + 37),
], ids=["straight", "refracting", "warped-grid", "full-plane",
        "shipped-widths", "n6-widths", "refill-rounds"])
def test_trace_source_equals_twin(host_lib, method, kwargs, n_rays):
    """The census launch: every output, the per-ray micro-step counts and
    cell entries equal the twin's; at N 6 rays leave the grid mid-path;
    more rays than the launch's threads (128 on the host), so that rays
    start where others ended, inside the walk's loop."""
    p = synthetic_problem(seeded=method == 2, **kwargs)
    rays = _rays(p, n_rays, 1)
    gain = prepare_gain(p.gain)
    use_emis = method == 1
    want, want_steps, want_cells = trace_batch_plain(
        rays, p.N, p.euv_beam.dz, gain, method, use_emis=use_emis,
        census=True)
    B = trace_kernel._check_inputs(rays, gain, p.N)
    got, steps, cells, _ = trace_kernel._launch(
        host_lib, rays, B, p.N, p.euv_beam.dz, gain, method, 0.5, use_emis,
        None, census=True)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(steps, want_steps)
    assert torch.equal(cells, want_cells)
    assert steps.min().item() >= 1 and cells.min().item() >= 1
    if p.N == 6:
        walked = (want.gvl != 0).any(dim=2).sum(dim=1)
        assert (want.escaped & (walked > 0) & (walked < p.N - 1)).any()
    # the launch's last thread zeroed the refill's counters again
    assert not trace_kernel._counter(torch.device("cpu"), None).any()


@pytest.mark.parametrize("method", [1, 2])
def test_trace_source_warp_steps(host_lib, method):
    """The census launch counts the micro-step iterations its warps issue:
    on the host's one-lane warps exactly the rays' micro-steps (on the card
    at least a 32nd of them); the counts launch and the plain launch return
    no such count, and each launch's outputs equal the others'."""
    p = synthetic_problem(seeded=method == 2, **_SHIPPED)
    rays = _rays(p, 300, 2)
    gain = prepare_gain(p.gain)
    B = trace_kernel._check_inputs(rays, gain, p.N)
    args = (host_lib, rays, B, p.N, p.euv_beam.dz, gain, method, 0.5,
            method == 1, None)
    res, steps, cells, warp_steps = trace_kernel._launch(*args, census=True)
    assert warp_steps.shape == (1,) and warp_steps.dtype == torch.int64
    assert warp_steps.item() == int(steps.sum()) > 0
    assert warp_steps.item() * 32 >= int(steps.sum())
    counted = trace_kernel._launch(*args, counts=True)
    plain = trace_kernel._launch(*args)
    assert len(counted) == 2 and torch.equal(counted[1], steps)
    assert isinstance(plain, type(res))
    for f in res._fields:
        assert torch.equal(getattr(plain, f), getattr(res, f)), f
        assert torch.equal(getattr(counted[0], f), getattr(res, f)), f


@pytest.mark.parametrize("method", [1, 2])
def test_trace_source_one_segment(host_lib, method):
    """N = 1: no segment to walk; the kernel still turns each entry ray
    into its exit ray as the twin does, with no micro-steps."""
    from raytrace_tpu_torch.testing import source_rays

    p = synthetic_problem(N=1, seeded=method == 2)
    rays = source_rays(p, 300, "cpu")
    gain = prepare_gain(p.gain)
    want, want_steps = trace_batch_plain(rays, p.N, p.euv_beam.dz, gain,
                                         method, use_emis=method == 1,
                                         counts=True)
    B = trace_kernel._check_inputs(rays, gain, p.N)
    got, steps = trace_kernel._launch(host_lib, rays, B, p.N, p.euv_beam.dz,
                                      gain, method, 0.5, method == 1, None,
                                      counts=True)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(steps, want_steps) and not steps.any()


def test_trace_launch_empty_batch():
    """A batch of no rays launches nothing (no library is needed) and
    gives the twin's empty result."""
    p = synthetic_problem()
    rays = {k: torch.empty(0, dtype=torch.float32) for k in "xyab"}
    gain = prepare_gain(p.gain)
    want, want_steps = trace_batch_plain(rays, p.N, p.euv_beam.dz, gain, 1,
                                         counts=True)
    got, steps = trace_kernel._launch(None, rays, 0, p.N, p.euv_beam.dz,
                                      gain, 1, 0.5, True, None, counts=True)
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert g.shape == w.shape and g.dtype == w.dtype, f
    assert steps.shape == want_steps.shape == (0,)


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


def _deposit_case(shape, method, B, seed):
    """B2's inputs on CPU tensors at ``shape``'s beam widths: coordinates
    over the padded grids and beyond, runs of equal bins, rays that are not
    ok with NaN or negative spectra (``testing.deposit_inputs``)."""
    from raytrace_tpu_torch.models.problem import prepare_beam
    from raytrace_tpu_torch.testing import deposit_inputs

    p = synthetic_problem(**shape)
    Iv, coords, ok = deposit_inputs(p.euv_beam, B, seed)
    beam = prepare_beam(p.euv_beam)
    args = (torch.from_numpy(Iv), tuple(torch.from_numpy(c) for c in coords),
            torch.from_numpy(ok), beam, method, 0.37)
    return args, beam


def _accumulators(beam, K, fill=0.0):
    return (torch.full((beam.x.shape[0] * beam.y.shape[0], K), fill,
                       dtype=torch.float64),
            torch.full((beam.a.shape[0] * beam.b.shape[0], 1), fill,
                       dtype=torch.float64))


@pytest.mark.parametrize("method", [1, 2])
@pytest.mark.parametrize("shape", [
    dict(nx=60, ny=25, na=19, nb=14, nv=52),
    dict(nx=118, ny=25, na=50, nb=50, nv=82, seeded=True),
    dict(nx=9, ny=6, na=7, nb=5, nv=7, full_plane=True),
], ids=["ase-widths", "seeded-widths", "odd-K-full-plane"])
def test_deposit_source_equals_twin(host_lib, method, shape):
    """B2's source: the bins bitwise equal to the twin's get_index, the
    image and I_ang within 1e-14 of the twin's (the kernel sums I_ang per
    frequency pair and merges runs of equal image bins, the twin adds each
    ray through index_add_ and a gemv), added in place on top of what the
    accumulators held; no NaN from the rays that are not ok."""
    from raytrace_tpu_torch.ops.binning import bin_indices

    args, beam = _deposit_case(shape, method, 3000, 5)
    Iv, coords, ok = args[:3]
    K = Iv.shape[1]
    deposit_kernel._check(*args[:4], *_accumulators(beam, K))
    got = _accumulators(beam, K, 1.0)
    bins = deposit_kernel._launch(host_lib, *args, *got, None, bins=True)
    want = _accumulators(beam, K, 1.0)
    deposit_kernel.bin_deposit_plain(*args, *want)
    assert torch.equal(bins, bin_indices(coords, ok, beam, method))
    assert (bins[:, 0] >= 0).sum() > 500 and (bins[:, 1] >= 0).sum() > 500
    for g, w in zip(got, want):
        assert not g.isnan().any()
        torch.testing.assert_close(g, w, rtol=1e-14, atol=0)


def test_deposit_source_skips_trash_in_place(host_lib):
    """Rays that are not ok, or land outside the grid, deposit nothing,
    even with NaN spectra; with no ray ok the accumulators stay as they
    were."""
    args, beam = _deposit_case(dict(nx=9, ny=6, na=7, nb=5, nv=6), 2, 500,
                               6)
    Iv, coords, ok = args[:3]
    none = torch.zeros_like(ok)
    got = _accumulators(beam, Iv.shape[1], 2.5)
    bins = deposit_kernel._launch(host_lib, Iv, coords, none, *args[3:],
                                  *got, None, bins=True)
    assert torch.equal(bins, torch.full_like(bins, -1))
    for g in got:
        assert torch.equal(g, torch.full_like(g, 2.5))


def _seeded_inputs(B, nseg, spread, K=82, seed=4):
    """B3's inputs at the seeded shipped widths (cells 2756, K 82): the
    trace-shaped ivl/gvl/gv, a seed factor per ray (a few zero), the
    frequency profile and escape flags (about one ray in eight)."""
    ivl, gvl, gv = (torch.from_numpy(a) for a in
                    amplify_inputs(B=B, nseg=nseg, K=K, spread=spread))
    rng = np.random.default_rng(seed)
    f = torch.from_numpy(rng.random(B) * (rng.random(B) > 0.05))
    fv = torch.from_numpy(rng.uniform(0.1, 2.0, K))
    escaped = torch.from_numpy(rng.random(B) < 0.125)
    return f, fv, escaped, ivl, gvl, gv


@pytest.mark.parametrize("nseg,spread,K", [
    (2, None, 82), (2, 40, 82), (1, None, 82), (2, None, 7), (3, None, 10),
    (0, None, 82)],
    ids=["shipped", "coherent", "one-segment", "odd-K", "generic-pairs",
         "no-segments"])
def test_amplify_source_equals_twin(host_lib, nseg, spread, K):
    """B3 (the shipped 2 x 3 instantiation and the generic ones, pairs and
    single frequencies): the log-gain equals the twin's bitwise, the
    spectrum within 1e-14 (the host's libm exp stands in for CUDA's), the
    flags identical."""
    args = _seeded_inputs(1024, nseg, spread, K)
    amplify_kernel._check(*args)
    got, flags, got_gl = amplify_kernel._launch(host_lib, *args, None,
                                                log_gain=True)
    assert torch.equal(got_gl, amplify_kernel.log_gain_plain(*args[3:]))
    want, want_flags = amplify_kernel.amplify_gain_plain(*args)
    torch.testing.assert_close(got, want, rtol=1e-14, atol=0)
    assert torch.equal(flags, want_flags) and not flags.any()
    assert torch.equal(got[args[2]], torch.zeros_like(got[args[2]]))


@pytest.mark.parametrize("B", [1027, 5])
def test_amplify_source_flags(host_lib, B):
    """Both flag bits: a negative fv entry (bit 0 on rays that did not
    escape and have a positive factor), a NaN fv entry (bit 1 on every ray
    that did not escape: 0 * NaN is NaN), a factor of inf (NaN where the
    profile is 0); escaped rays stay 0 with no flag. B not a multiple of 4
    checks the byte packing of the flag words."""
    f, fv, escaped, ivl, gvl, gv = _seeded_inputs(B, 2, None)
    fv[5] = -0.5
    fv[11] = float("nan")
    f[3 % B] = float("inf")
    fv[12] = 0.0
    got, flags, _ = amplify_kernel._launch(host_lib, f, fv, escaped, ivl,
                                           gvl, gv, None)
    want, want_flags = amplify_kernel.amplify_gain_plain(f, fv, escaped, ivl,
                                                         gvl, gv)
    assert flags.shape == (B,) and torch.equal(flags, want_flags)
    live = ~escaped
    assert torch.equal(flags[escaped], torch.zeros_like(flags[escaped]))
    assert torch.all(flags[live] & amplify_kernel.FLAG_NAN)
    assert torch.equal((flags[live] & amplify_kernel.FLAG_NEG) != 0,
                       f[live] > 0)
    assert torch.equal(got.isnan(), want.isnan())
    ok = ~want.isnan()
    torch.testing.assert_close(got[ok], want[ok], rtol=1e-14, atol=0)


@pytest.mark.parametrize("nseg,spread,K,scale", [
    (2, None, 82, 1.0), (2, 40, 82, 30.0), (1, None, 82, 1.0),
    (2, None, 7, 1.0), (3, None, 10, 300.0), (0, None, 82, 1.0)],
    ids=["shipped", "coherent-large-gain", "one-segment", "odd-K",
         "generic-pairs-overflow", "no-segments"])
def test_amplify_f32_source_equals_twin(host_lib, nseg, spread, K, scale):
    """B3's f32 instantiation (two-float log-gain, the range-reduced exp,
    the seed product rounded once from f64): the pair ``(hi, lo)``, the
    spectrum and the flags equal the twin's bitwise, infinities of a
    log-gain past f32's exp range included (``scale`` 300)."""
    f, fv, escaped, ivl, gvl, gv = _seeded_inputs(1024, nseg, spread, K)
    args = (f, fv, escaped, ivl, (gvl * scale).to(torch.float32), gv)
    amplify_kernel._check(*args, torch.float32)
    got, flags, pair = amplify_kernel._launch(host_lib, *args, None,
                                              log_gain=True,
                                              dtype=torch.float32)
    hi, lo = amplify_kernel.log_gain2_plain(*args[3:])
    assert torch.equal(pair[0], hi) and torch.equal(pair[1], lo)
    want, want_flags = amplify_kernel.amplify_gain_plain(
        *args, dtype=torch.float32)
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(flags, want_flags)
    if scale == 300.0:
        assert got.isinf().any()


def test_amplify_f32_source_flags(host_lib):
    """Both flag bits on the f32 values (a negative and a NaN fv entry),
    with B not a multiple of 4."""
    f, fv, escaped, ivl, gvl, gv = _seeded_inputs(1027, 2, None)
    fv[5] = -0.5
    fv[11] = float("nan")
    args = (f, fv, escaped, ivl, gvl, gv)
    got, flags, _ = amplify_kernel._launch(host_lib, *args, None,
                                           dtype=torch.float32)
    want, want_flags = amplify_kernel.amplify_gain_plain(
        *args, dtype=torch.float32)
    assert torch.equal(flags, want_flags)
    assert torch.all(flags[~escaped] & amplify_kernel.FLAG_NAN)
    assert torch.equal(got.isnan(), want.isnan())
    ok = ~want.isnan()
    assert torch.equal(got[ok], want[ok])


#: the host's libm exp, elementwise: what the host-compiled kernels call
_LIBM_EXP = np.frompyfunc(math.exp, 1, 1)


def _libm_exp(t):
    return torch.from_numpy(_LIBM_EXP(t.numpy()).astype(np.float64))


def _emis_case(case):
    """B4's inputs on CPU tensors for one named case (``emis_inputs`` at
    the ASE widths unless the case says otherwise)."""
    kw = dict(B=1024, nseg=2, nsub=3, cells=400, K=52)
    kw.update({"ragged-B": dict(B=1027), "odd-K": dict(K=7),
               "wide-K": dict(K=600, B=61), "wide-odd-K": dict(K=301, B=37),
               "generic": dict(nseg=3, nsub=2), "generic-pairs-one-sub":
               dict(nseg=1, nsub=1), "no-segments": dict(nseg=0)}
              .get(case, {}))
    ivl, gvl, evl, gv = (torch.from_numpy(a) for a in emis_inputs(**kw))
    if case == "negative-gain":
        gvl = -(gvl.abs() * 20.0)
    elif case == "planted":
        evl[3] = -evl[3]            # a negative spectrum
        evl[5, 0, 1] = float("nan")  # NaN at every frequency
        gv[0, 7, 4] = float("nan")   # NaN at one frequency of one ray
        ivl[9, 0, 0] = 7
        evl[11, 1, 2] = -30.0       # negative at some frequencies
    return ivl, gvl, evl, gv


@pytest.mark.parametrize("case", [
    "shipped", "negative-gain", "planted", "ragged-B", "odd-K", "wide-K",
    "wide-odd-K", "generic", "generic-pairs-one-sub", "no-segments"])
def test_amplify_emis_source_equals_twin(host_lib, monkeypatch, case):
    """B4 (the shipped 2 x 3 instantiation and the generic ones, pairs and
    single frequencies, K wider than a block): the spectrum and the flags
    bitwise equal to the twin's with the twin's exp the host's libm exp,
    which the host-compiled kernel calls in place of CUDA's; ``|gvl gv|``
    straddles the Taylor branch's bound 1e-3 on both sides in every case.
    (PyTorch's CPU exp is an ulp off libm's for about one argument in
    twenty, and an ulp of ``e^gl`` is a relative 2.2e-16 / |gl| of
    ``e^gl - 1``: 2.2e-13 next to the bound.)"""
    args = _emis_case(case)
    amplify_kernel._check_emis(*args)
    got, flags = amplify_kernel._launch_emis(host_lib, *args, None)
    monkeypatch.setattr(torch, "exp", _libm_exp)
    want, want_flags = amplify_kernel.amplify_emis_plain(*args)
    assert flags.shape == want_flags.shape == (args[0].shape[0],)
    assert torch.equal(flags, want_flags)
    ok = ~want.isnan()
    assert torch.equal(got.isnan(), ~ok) and torch.equal(got[ok], want[ok])
    g = args[3][torch.arange(args[0].shape[1])[None, :, None], args[0].long()]
    gl = (args[1].double()[..., None] * g.double()).abs()
    if case == "planted":
        assert (flags & amplify_kernel.FLAG_NEG)[[3, 11]].all()
        assert (flags & amplify_kernel.FLAG_NAN)[[5, 9]].all()
        assert got[9].isnan().sum() == 1 and got[5].isnan().all()
    else:
        assert not flags.any()
    if case == "no-segments":
        assert torch.equal(got, torch.zeros_like(got))
    else:
        assert (gl[..., 0] < 1e-3).any() and (gl[..., 0] > 1e-3).any()


def test_amplify_emis_source_on_traced_rays(host_lib, monkeypatch):
    """B4 on the twin trace's path of ASE-shaped rays (the cell layout,
    the gains and emissivities the trace writes): the spectrum bitwise
    equal to the twin's with the host's libm exp in both, the flags
    identical, no flag set."""
    p = synthetic_problem(nx=60, ny=25, na=19, nb=14, nv=52, gain_nx=106,
                          gain_ny=26)
    gain = prepare_gain(p.gain)
    res = trace_batch_plain(_rays(p, 2000, 7), p.N, p.euv_beam.dz, gain, 1)
    args = (res.ivl, res.gvl, res.evl, gain.gv[1:])
    amplify_kernel._check_emis(*args)
    got, flags = amplify_kernel._launch_emis(host_lib, *args, None)
    monkeypatch.setattr(torch, "exp", _libm_exp)
    want, want_flags = amplify_kernel.amplify_emis_plain(*args)
    assert torch.equal(got, want)
    assert torch.equal(flags, want_flags) and not flags.any()
    assert got.abs().max() > 0


def _emis_f32(lib, args):
    """B4-f32 through ``lib`` and its twin: ``(got, flags, want,
    want_flags)``."""
    f32 = torch.float32
    amplify_kernel._check_emis(*args, f32)
    got, flags = amplify_kernel._launch_emis(lib, *args, None, f32)
    want, want_flags = amplify_kernel.amplify_emis_plain(*args, dtype=f32)
    return got, flags, want, want_flags


@pytest.mark.parametrize("case", [
    "shipped", "negative-gain", "planted", "ragged-B", "odd-K", "wide-K",
    "wide-odd-K", "generic", "generic-pairs-one-sub", "no-segments"])
def test_amplify_emis_f32_source_equals_twin(host_lib, case):
    """B4-f32 (the shipped 2 x 3 instantiation and the generic ones, pairs
    and single frequencies, K wider than a block) on B4's cases: the f32
    spectrum and the flags bitwise equal to the twin's
    (``amplify_emis_plain`` in f32), with no libm stand-in: every step is
    a deterministic f32 operation. ``|gvl gv|`` straddles the Taylor
    branch's bound in every case with segments."""
    args = _emis_case(case)
    got, flags, want, want_flags = _emis_f32(host_lib, args)
    assert flags.shape == want_flags.shape == (args[0].shape[0],)
    assert torch.equal(flags, want_flags)
    assert same_bits(got, want)
    g = args[3][torch.arange(args[0].shape[1])[None, :, None], args[0].long()]
    gl = (args[1][..., None] * g).abs()
    if case == "planted":
        assert (flags & amplify_kernel.FLAG_NEG)[[3, 11]].all()
        assert (flags & amplify_kernel.FLAG_NAN)[[5, 9]].all()
        assert got[9].isnan().sum() == 1 and got[5].isnan().all()
    else:
        assert not flags.any()
    if case == "no-segments":
        assert torch.equal(got, torch.zeros_like(got))
    else:
        small = gl < spectrum._SMALL_F32
        assert small.any() and (~small).any()


def test_amplify_emis_f32_source_on_traced_rays(host_lib):
    """B4-f32 on the twin trace's path of ASE-shaped rays: the f32
    spectrum and the flags bitwise the twin's, no flag set."""
    p = synthetic_problem(nx=60, ny=25, na=19, nb=14, nv=52, gain_nx=106,
                          gain_ny=26)
    gain = prepare_gain(p.gain)
    res = trace_batch_plain(_rays(p, 2000, 7), p.N, p.euv_beam.dz, gain, 1)
    got, flags, want, want_flags = _emis_f32(
        host_lib, (res.ivl, res.gvl, res.evl, gain.gv[1:]))
    assert same_bits(got, want)
    assert torch.equal(flags, want_flags) and not flags.any()
    assert got.abs().max() > 0


def _neighbours(x, n=3):
    """The f32 value ``x`` and its ``n`` nearest f32 neighbours on each
    side, both signs."""
    x = np.float32(x)
    out = [x]
    lo = hi = x
    for _ in range(n):
        lo = np.nextafter(lo, np.float32(0.0))
        hi = np.nextafter(hi, np.float32(np.inf))
        out += [lo, hi]
    out = np.array(out, dtype=np.float32)
    return np.concatenate([out, -out])


def test_amplify_emis_f32_source_branch_bounds(host_lib):
    """Log-gains on both sides of both branch bounds, to the ulp: ``|gl|``
    at and around the Taylor branch's f32(1e-3), and ``|hi|`` at and around
    the direct polynomial's f32(ln2 / 2) in ``expm1_from_exp`` (and a few
    far from both). Each ray repeats its path gain at every step over
    tables of ones and twos, so ``gl`` is the path gain or twice it,
    exactly: spectrum and flags bitwise the twin's."""
    from raytrace_tpu_torch.ops import twofloat as tf

    gains = np.concatenate([
        _neighbours(spectrum._SMALL_F32), _neighbours(spectrum._SMALL_F32 / 2),
        _neighbours(tf.HALF_LN2), _neighbours(tf.HALF_LN2 / 2),
        np.array([0.0, -0.0, 1e-6, 0.05, 0.5, 1.0, 3.0, -2.5],
                 dtype=np.float32)])
    B, nseg, nsub, K = len(gains), 2, 3, 6
    rng = np.random.default_rng(11)
    ivl = torch.from_numpy(rng.integers(0, 2, (B, nseg, nsub))
                           .astype(np.int32))
    gvl = torch.from_numpy(np.repeat(gains, nseg * nsub)
                           .reshape(B, nseg, nsub))
    evl = torch.from_numpy(rng.uniform(0.1, 2.0, (B, nseg, nsub))
                           .astype(np.float32))
    gv = torch.ones((nseg, 2, K), dtype=torch.float32)
    gv[:, 1] = 2.0
    got, flags, want, want_flags = _emis_f32(host_lib, (ivl, gvl, evl, gv))
    assert same_bits(got, want)
    assert torch.equal(flags, want_flags)
    gl = (gvl * torch.where(ivl == 1, 2.0, 1.0)).abs()
    for bound in (spectrum._SMALL_F32, tf.HALF_LN2):
        assert (gl < bound).any() and (gl == bound).any()
        assert (gl > bound).any()


def test_amplify_emis_f32_source_overflow(host_lib):
    """A log-gain past f32's range: ``exp_fast2`` gives inf, the spectrum
    NaN (``el / gl * inf + 0 * inf``: the entry 0 times inf), with the NaN
    flag set, bitwise as the twin, on the rays whose gains were scaled up;
    the others untouched."""
    ivl, gvl, evl, gv = (torch.from_numpy(a) for a in emis_inputs(
        B=257, nseg=2, nsub=3, cells=300, K=10, seed=5))
    big = torch.zeros(257, dtype=torch.bool)
    big[[0, 7, 100, 256]] = True
    gvl[big] = 200.0
    got, flags, want, want_flags = _emis_f32(host_lib, (ivl, gvl, evl, gv))
    assert same_bits(got, want)
    assert torch.equal(flags, want_flags)
    assert torch.all(flags[big] & amplify_kernel.FLAG_NAN)
    assert got[big].isnan().any(dim=1).all()
    assert not flags[~big].any() and not got[~big].isnan().any()


def test_amplify_emis_f32_source_in_the_call(host_lib, monkeypatch,
                                             tmp_path):
    """An f32 ASE call of the ``cuda`` configuration (its tensors on the
    CPU) with B4-f32 compiled for the host in place of the wrapper: image
    and I_ang bitwise those of the CPU call, the kernel once a chunk."""
    from raytrace_tpu_torch import create_image
    from raytrace_tpu_torch.models import ray_tracer

    calls = []

    def host_emis(ivl, gvl, evl, gv, dtype=torch.float64):
        calls.append(dtype)
        return amplify_kernel._launch_emis(host_lib, ivl, gvl, evl, gv, None,
                                           dtype)

    monkeypatch.setattr(amplify_kernel, "amplify_emis", host_emis)
    p = synthetic_problem(nx=12, ny=6, na=5, nb=4, nv=10)
    f32 = torch.float32
    prep = ray_tracer._prepare(p, "cuda", "cpu", chunk_size=400, eager=True,
                               spectrum_dtype=f32)
    got = ray_tracer._finalize_call(p, prep, prep.pipeline(*prep.operands),
                                    str(tmp_path / "failed.dat"))
    want = create_image(p, "cpu", chunk_size=400, spectrum_dtype=f32)
    assert prep.cfg["n_chunks"] > 1
    assert calls == [f32] * prep.cfg["n_chunks"]
    assert np.abs(want[0]).max() > 0
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_amplify_emis_f32_source_wrapper_on_cpu_is_the_twin():
    """On CPU tensors ``amplify_emis(..., dtype=float32)`` is the twin and
    books no launch."""
    args = _emis_case("shipped")
    before = cuda_lib.launches()
    got, flags = amplify_kernel.amplify_emis(*args, dtype=torch.float32)
    want, want_flags = amplify_kernel.amplify_emis_plain(
        *args, dtype=torch.float32)
    assert not cuda_lib.since(before)
    assert same_bits(got, want) and torch.equal(flags, want_flags)


@pytest.mark.parametrize("method", [1, 2])
@pytest.mark.parametrize("shape", [
    dict(nx=60, ny=25, na=19, nb=14, nv=52),
    dict(nx=118, ny=25, na=50, nb=50, nv=82, seeded=True),
    dict(nx=9, ny=6, na=7, nb=5, nv=7, full_plane=True),
], ids=["ase-widths", "seeded-widths", "odd-K-full-plane"])
def test_deposit_f32_source_equals_twin(host_lib, method, shape):
    """B2's f32 instantiation: the bins bitwise, the image and I_ang (f32
    products, f64 sums) within 1e-14 of the twin's, in place on top of
    what the accumulators held; no NaN from the rays that are not ok."""
    from raytrace_tpu_torch.ops.binning import bin_indices

    args, beam = _deposit_case(shape, method, 3000, 5)
    args = (args[0].to(torch.float32),) + args[1:]
    Iv, coords, ok = args[:3]
    K = Iv.shape[1]
    deposit_kernel._check(*args[:4], *_accumulators(beam, K))
    got = _accumulators(beam, K, 1.0)
    bins = deposit_kernel._launch(host_lib, *args, *got, None, bins=True)
    want = _accumulators(beam, K, 1.0)
    deposit_kernel.bin_deposit_plain(*args, *want)
    assert torch.equal(bins, bin_indices(coords, ok, beam, method))
    for g, w in zip(got, want):
        assert not g.isnan().any()
        torch.testing.assert_close(g, w, rtol=1e-14, atol=0)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("K,B", [(82, 300), (52, 261), (7, 129), (400, 70)])
def test_deposit_f32_source_views(host_lib, offset, K, B):
    """B2-f32's staged copy on a spectrum that is a view at ``offset``
    floats into its storage (every 16-byte phase: a ragged head of single
    floats, 16-byte copies, a ragged tail), with a ragged last tile, and
    at a K whose tile needs more than 48 KB of shared memory (several
    passes of frequency slots): bins bitwise, image and I_ang within 1e-14
    of the twin's."""
    from raytrace_tpu_torch.ops.binning import bin_indices

    args, beam = _deposit_case(dict(nx=31, ny=9, na=11, nb=10, nv=K), 2, B,
                               offset)
    store = torch.zeros(B * K + 4, dtype=torch.float32)
    view = store[offset:offset + B * K].view(B, K)
    view.copy_(args[0])
    args = (view,) + args[1:]
    assert view.data_ptr() % 16 == 4 * offset
    got = _accumulators(beam, K)
    bins = deposit_kernel._launch(host_lib, *args, *got, None, bins=True)
    want = _accumulators(beam, K)
    deposit_kernel.bin_deposit_plain(*args, *want)
    assert torch.equal(bins, bin_indices(*args[1:3], beam, 2))
    for g, w in zip(got, want):
        assert not g.isnan().any()
        torch.testing.assert_close(g, w, rtol=1e-14, atol=0)


def _bisect(X, n, y):
    """The reference's findindex (RayTraceImageHelper.h:131-143)."""
    lower, upper = 0, n - 1
    while upper - lower != 1:
        mid = (upper + lower) >> 1
        if X[mid] >= y:
            upper = mid
        else:
            lower = mid
    return upper


def _grids():
    rng = np.random.default_rng(9)
    uni = np.linspace(-3e-3, 9e-3, 106)
    warped = np.sort(rng.uniform(-1.0, 1.0, 26)) ** 3
    return {
        "uniform": uni,
        "warped": warped,
        "two-point": np.array([0.0, 1.0]),
        "ties": np.array([0.0, 1.0, 1.0, 1.0, 2.0, 3.0, 3.0]),
        "flat": np.zeros(5),
        "tiny-span": np.array([1.0, 1.0 + 2e-16, 1.0 + 4e-16]),
        # the warp of synthetic_problem(non_uniform_gain=0.8) at 106 points,
        # where the end-point guess is cells off, and a geometric grid,
        # where it is off by most of the grid
        "power-1.8": -3e-3 + 1.2e-2 * np.linspace(0.0, 1.0, 106) ** 1.8,
        "geometric": np.geomspace(1e-6, 1.0, 106),
    }


@pytest.mark.parametrize("grid", list(_grids()))
def test_find_index_source_equals_bisection(host_lib, grid):
    """The kernel's guess-and-gallop interval search returns the bisection's
    index on nondecreasing grids: below, at and above both ends, exactly on
    every grid line, one ulp either side of it, between lines, NaN and the
    infinities; and equals the twin's clamped searchsorted."""
    from raytrace_tpu_torch.ops.interp import find_index

    X = _grids()[grid]
    n = len(X)
    rng = np.random.default_rng(1)
    y = np.concatenate([
        X, np.nextafter(X, -np.inf), np.nextafter(X, np.inf),
        (X[:-1] + X[1:]) / 2,
        rng.uniform(X[0] - 1e-3, X[-1] + 1e-3, 200),
        [X[0] - 1.0, X[-1] + 1.0, np.nan, np.inf, -np.inf, -0.0, 0.0]])
    got = trace_kernel.find_index_launch(host_lib, torch.from_numpy(X),
                                         torch.from_numpy(y), None).numpy()
    want = np.array([_bisect(X, n, v) for v in y])
    np.testing.assert_array_equal(got, want)
    twin = find_index(torch.from_numpy(X), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, twin)


def test_gather_probe_source_equals_twin(host_lib):
    """P1: K dependent gathers per thread equal the twin bitwise."""
    from raytrace_tpu_torch.tools import gather_probe

    tab, idx = gather_probe.probe_inputs(rows=8, seed=1)
    got = gather_probe._launch(host_lib, tab, idx, 37, None)
    assert torch.equal(got, gather_probe.gather_probe_plain(tab, idx, 37))


def test_launch_is_booked_under_its_entry_and_device(host_lib):
    """One launch through the host-compiled library is booked once in
    ``cuda_lib``'s launch ledger, under its C entry and device."""
    from raytrace_tpu_torch.tools import gather_probe

    tab, idx = gather_probe.probe_inputs(rows=1, seed=2)
    before = cuda_lib.launches()
    gather_probe._launch(host_lib, tab, idx, 3, None)
    assert cuda_lib.since(before) == {
        ("rt_gather_probe", torch.device("cpu")): 1}
