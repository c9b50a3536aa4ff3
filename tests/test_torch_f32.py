"""The f32 spectrum (``spectrum_dtype=float32``, ``raytrace_tpu``'s default)
on the CPU, against the JAX package on the same inputs.

* the two-float helpers (``ops/twofloat.py``) against
  ``raytrace_tpu.ops.spectrum``'s: the error-free sum and product bitwise,
  ``exp`` of a pair within 1 ulp and ``expm1`` within 2 (XLA's CPU
  compiler fuses some of the polynomials' products and sums into one
  rounding, the port does not; both stay within 4 ulp of the exact
  ``expm1``), also near ``|hi| = ln2 / 2`` and at both ends of f32's exp
  range;
* kernel B3's f32 twin: its pair against the Pallas kernel
  (``pallas_amplify.log_gain_fused``, interpret mode) within 2 ulp of the
  represented value, its spectrum against ``spectrum.amplify(...,
  dtype=float32)`` within 1e-6 relative;
* the f32 emissivity amplify against JAX's within 1e-6 relative;
* kernel B2's twin on f32 spectra against ``binning.bin_images`` within a
  relative L2 of 1e-6;
* ``create_image`` in f32 against ``raytrace_tpu.create_image`` in f32
  (relative L2 1e-5, ``tests/test_golden.py``'s bound), both fixtures'
  goldens through ``check_ans``, and the stream and the sharded call in
  f32 against the synchronous f32 call within 1e-12;
* the call surface: ``raytrace_tpu``'s positional order, ``spectrum_dtype``
  given as a torch, numpy or JAX dtype, the four ``deposit`` names and the
  unknown-name error, the method names ``pallas``, ``lax`` and
  ``lax-exact``, ``-spectrum=f32`` in the CLI, and the f32 and f64 calls of
  one problem as two cached pipelines.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu
from raytrace_tpu.ops import binning as jax_binning
from raytrace_tpu.ops import pallas_amplify
from raytrace_tpu.ops import spectrum as jax_spectrum
from raytrace_tpu.ops.stepper import TraceResult as JaxTraceResult
from raytrace_tpu.testing import synthetic_problem as jax_synthetic

from raytrace_tpu_torch import create_image, create_image_stream, load_input
from raytrace_tpu_torch.convert import problem_from_jax
from raytrace_tpu_torch.models import ray_tracer
from raytrace_tpu_torch.models.problem import prepare_beam
from raytrace_tpu_torch.ops import (amplify_kernel, deposit_kernel, spectrum,
                                    twofloat)
from raytrace_tpu_torch.ops.stepper import TraceResult
from raytrace_tpu_torch.parallel.sharding import create_image_sharded
from raytrace_tpu_torch.testing import (amplify_inputs, deposit_inputs,
                                        synthetic_problem)
from raytrace_tpu_torch.utils.errors import RayTraceError
from raytrace_tpu_torch.utils.stats import check_ans

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
SMALL = dict(nx=8, ny=6, na=5, nb=4, nv=6)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _ulps(a, b):
    """Per-element distance in f32 units in the last place (same-sign
    values; both arrays f32)."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _pairs(n, seed):
    """f32 operand pairs over 16 decades, both signs."""
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 8, n))
                 .astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("name", ["two_sum", "split_prod"])
def test_error_free_transforms_bitwise(name):
    a, b = _pairs(50000, 1)
    want = jax.jit(getattr(jax_spectrum, "_" + name))(a, b)
    got = getattr(twofloat, name)(torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(np.int32),
                              np.asarray(w).view(np.int32))


def _exact_error(a, b, p):
    """``f32(f64(a) f64(b) - f64(p))``: the product's exact error rounded
    once, what one fused multiply-add ``fma(a, b, -p)`` gives (B3-f32's
    error term, ``csrc/amplify.cu``). The f64 product of two f32 values and
    its difference from ``p`` are exact."""
    return (a.double() * b.double() - p.double()).float()


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("span", [20, 60, 120])
def test_split_prod_error_is_the_fused_error(span):
    """Dekker's error (``twofloat.split_prod``, the twin's and the JAX
    package's) equals the fused multiply-add's bitwise on the domain that
    ``csrc/amplify.cu`` states: ``p`` finite with ``|p| >= 2^-100``, and
    ``p`` an exact zero (a zero factor, either sign). Seeded pairs with
    exponents over +-``span``."""
    rng = np.random.default_rng(span)
    n = 1_000_000

    def operand():
        x = (rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(-span, span, n)
             * rng.choice([-1.0, 1.0], n)).astype(np.float32)
        x[rng.random(n) < 0.001] = 0.0
        x[rng.random(n) < 0.001] = -0.0
        return torch.from_numpy(x)

    a, b = operand(), operand()
    p, err = twofloat.split_prod(a, b)
    zero = (a == 0) | (b == 0)
    domain = (torch.isfinite(p) & (p.abs() >= 2.0 ** -100)) | zero
    assert zero.sum() > 1000 and domain.sum() > 0.4 * n
    assert torch.equal(_bits(err[domain]),
                       _bits(_exact_error(a, b, p)[domain]))


#: pairs whose product lies near f32's underflow, where Dekker's error (its
#: partial products underflow) and the fused error differ: (a, b, Dekker's,
#: the fused)
_UNDERFLOW_PAIRS = (
    (float.fromhex("0x1.6f22acp-57"), float.fromhex("0x1.45a266p-59"),
     float.fromhex("0x1.2ap-141"), float.fromhex("0x1.29p-141")),
    (float.fromhex("-0x1.a209bap-113"), float.fromhex("0x1.635eeep-20"),
     float.fromhex("0x1p-149"), 0.0),
)


@pytest.mark.parametrize("a,b,dekker,fused", _UNDERFLOW_PAIRS)
def test_split_prod_error_differs_near_underflow(a, b, dekker, fused):
    """Below the stated domain the two errors can differ: the listed pairs
    (``|p|`` about 2^-115 and 2^-132) pin where it ends."""
    a, b = (torch.tensor([x], dtype=torch.float32) for x in (a, b))
    p, err = twofloat.split_prod(a, b)
    assert p.abs().item() < 2.0 ** -100
    assert err.item() == dekker and _exact_error(a, b, p).item() == fused
    assert err.item() != _exact_error(a, b, p).item()


def _hi_lo(case, n=20000, seed=2):
    """Log-gain pairs: ``lo`` within the rounding of ``hi``."""
    rng = np.random.default_rng(seed)
    half = np.float32(0.5 * np.log(2.0))
    hi = {"small": rng.uniform(-0.3, 0.3, n),
          "half-ln2": half + rng.uniform(-1e-4, 1e-4, n),
          "wide": rng.uniform(-80.0, 80.0, n),
          "overflow-edge": rng.uniform(87.0, 89.5, n),
          "underflow-edge": rng.uniform(-87.3, -80.0, n)}[case]
    hi = hi.astype(np.float32)
    lo = (hi * rng.uniform(-6e-8, 6e-8, n)).astype(np.float32)
    return hi, lo


@pytest.mark.parametrize("case", ["small", "half-ln2", "wide",
                                  "overflow-edge", "underflow-edge"])
def test_exp_fast2_and_expm1_within_one_ulp(case):
    """``exp`` of a pair within 1 ulp of JAX's, ``expm1`` within 2 (XLA
    fuses a product and a sum of the polynomial here and there) and within
    4 of the exact value; past f32's range both give inf. (Below 2^-126
    XLA's CPU flushes to zero where the port keeps gradual underflow:
    ``underflow-edge`` stops above.)"""
    hi, lo = _hi_lo(case)
    want = np.asarray(jax.jit(jax_spectrum._exp_fast2)(hi, lo))
    th, tl = torch.from_numpy(hi), torch.from_numpy(lo)
    got = twofloat.exp_fast2(th, tl).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert _ulps(got[fin], want[fin]).max() <= 1
    if case == "overflow-edge":
        assert np.isinf(got).any() and np.isfinite(got).any()
    want_m1 = np.asarray(jax.jit(jax_spectrum._expm1_from_exp)(want, hi,
                                                                lo))
    got_m1 = twofloat.expm1_from_exp(torch.from_numpy(want.copy()), th,
                                     tl).numpy()
    fin = np.isfinite(want_m1)
    assert np.array_equal(np.isfinite(got_m1), fin)
    assert _ulps(got_m1[fin], want_m1[fin]).max() <= 2
    exact = np.expm1(hi.astype(np.float64) + lo)[fin]
    assert np.all(np.abs(got_m1[fin] - exact)
                  <= 4 * np.spacing(np.abs(got_m1[fin])))


def test_ldexp_rounds_once():
    """The scaling by 2^n overflows to inf and underflows gradually, with
    one rounding, as IEEE ``ldexp`` (numpy's) does."""
    x = np.array([0.75, 1.4, 0.7, 1.0, 1.3, 0.9, 1.1, 1.0], np.float32)
    n = np.array([128, 128, -149, -150, -140, 300, -300, 0], np.float32)
    got = twofloat.ldexp_f32(torch.from_numpy(x), torch.from_numpy(n))
    with np.errstate(over="ignore"):
        want = np.ldexp(x, n.astype(np.int32))
    assert np.array_equal(got.numpy(), want)


def _gain_only_inputs(B=1024, K=82, seed=0, scale=1.0):
    """Trace-shaped ``ivl, gvl, gv`` at the seeded widths, the seed factor
    and profile of kernel B3, and the escape flags."""
    ivl, gvl, gv = amplify_inputs(B=B, K=K, seed=seed)
    rng = np.random.default_rng(seed + 1)
    gvl = (gvl * scale).astype(np.float32)
    f = rng.random(B) * (rng.random(B) > 0.05)
    fv = rng.uniform(0.1, 2.0, K)
    escaped = rng.random(B) < 0.125
    return ivl, gvl, gv, f, fv, escaped


def _jax_result(ivl, gvl, evl=None):
    fields = dict.fromkeys(JaxTraceResult._fields)
    fields.update(ivl=jnp.asarray(ivl), gvl=jnp.asarray(gvl),
                  evl=None if evl is None else jnp.asarray(evl))
    return JaxTraceResult(**fields)


@pytest.mark.parametrize("spread", [None, 40])
def test_b3_f32_pair_against_pallas_kernel(spread):
    """The twin's ``hi + lo`` against the Pallas kernel's (run in interpret
    mode, as tests/test_pallas_amplify.py runs it): within 2 ulp of the f32
    scale of the sum, the ulp of ``sum |term|`` (the kernel's own gate is
    about 1 ulp of that). Each compiler rounds the split product's error
    term in its own way, so ``hi`` and ``lo`` need not agree bitwise; the
    twin's pair tracks the f64 sum to 1e-12."""
    ivl, gvl, gv = amplify_inputs(B=1024, K=82, seed=3, spread=spread)
    hi_j, lo_j = pallas_amplify.log_gain_fused(
        jnp.asarray(ivl), jnp.asarray(gvl),
        pallas_amplify.pack_gv(jnp.asarray(gv)), ivl.shape[2])
    hi, lo = amplify_kernel.log_gain2_plain(
        torch.from_numpy(ivl), torch.from_numpy(gvl), torch.from_numpy(gv))
    got = hi.double().numpy() + lo.double().numpy()
    want = np.asarray(hi_j, np.float64) + np.asarray(lo_j, np.float64)
    exact = np.zeros_like(want)
    mag = np.zeros_like(want)
    for i in range(ivl.shape[1]):
        for s in range(ivl.shape[2]):
            term = (gvl[:, i, s, None].astype(np.float64)
                    * gv[i][ivl[:, i, s]].astype(np.float64))
            exact += term
            mag += np.abs(term)
    ulp = np.spacing(mag.astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(got - want) <= 2 * ulp)
    assert np.abs(got - exact).max() <= 1e-12


@pytest.mark.parametrize("scale", [1.0, 40.0])
def test_b3_f32_spectrum_against_jax(scale):
    """The twin's f32 spectrum against ``spectrum.amplify(...,
    dtype=float32)`` on ``Iv0 = f32(where(escaped, 0, f fv))``: max
    relative error 1e-6 (``scale`` 40 drives log-gains to tens)."""
    ivl, gvl, gv, f, fv, escaped = _gain_only_inputs(scale=scale)
    iv0 = np.where(escaped[:, None], 0.0, f[:, None] * fv[None, :])
    want = np.asarray(jax_spectrum.amplify(
        _jax_result(ivl, gvl), jnp.asarray(iv0.astype(np.float32)),
        jnp.asarray(gv), gv.shape[0] + 1, False, dtype=jnp.float32))
    got, flags = amplify_kernel.amplify_gain_plain(
        *(torch.from_numpy(a) for a in (f, fv, escaped, ivl, gvl, gv)),
        dtype=torch.float32)
    assert got.dtype == torch.float32 and not flags.any()
    got = got.numpy()
    nz = want != 0
    assert np.array_equal(got == 0, ~nz)
    assert np.max(np.abs(got[nz] / want[nz] - 1.0)) <= 1e-6
    # the seed product rounds once from f64, not from f32 factors
    assert np.array_equal(got[~escaped][:, 0] == 0, f[~escaped] == 0)


def test_b3_f32_flags_and_shapes():
    """The wrapper on CPU tensors takes the f32 twin; the flags come from
    the f32 values; a dtype other than f32 or f64 is refused."""
    ivl, gvl, gv, f, fv, escaped = _gain_only_inputs(B=64, K=10)
    fv[3], fv[5] = -1.0, np.nan
    args = [torch.from_numpy(a) for a in (f, fv, escaped, ivl, gvl, gv)]
    Iv, flags = amplify_kernel.amplify_gain(*args, dtype=torch.float32)
    want, want_flags = amplify_kernel.amplify_gain_plain(
        *args, dtype=torch.float32)
    assert Iv.dtype == torch.float32 and torch.equal(flags, want_flags)
    assert torch.equal(flags, amplify_kernel.iv_flags(want))
    live = ~args[2]
    assert torch.all(flags[live] & amplify_kernel.FLAG_NAN)
    with pytest.raises(ValueError):
        amplify_kernel.amplify_gain(*args, dtype=torch.float16)


@pytest.mark.parametrize("scale", [1.0, 20.0])
def test_f32_emissivity_against_jax(scale):
    """The f32 ASE amplify against ``spectrum.amplify(..., dtype=float32,
    use_emis=True)``: max relative error 1e-6, both branches (the Taylor
    branch where |g| < 1e-3)."""
    ivl, gvl, gv = amplify_inputs(B=2048, K=52, cells=500, seed=5)
    rng = np.random.default_rng(6)
    gvl = (gvl * scale).astype(np.float32)
    gvl[::7] *= np.float32(1e-4)
    evl = (rng.random(gvl.shape) * 3).astype(np.float32)
    iv0 = np.zeros((gvl.shape[0], 52), np.float32)
    want = np.asarray(jax_spectrum.amplify(
        _jax_result(ivl, gvl, evl), jnp.asarray(iv0), jnp.asarray(gv),
        gv.shape[0] + 1, True, dtype=jnp.float32))
    fields = dict.fromkeys(TraceResult._fields)
    fields.update(ivl=torch.from_numpy(ivl), gvl=torch.from_numpy(gvl),
                  evl=torch.from_numpy(evl))
    got = spectrum.amplify(TraceResult(**fields), torch.from_numpy(iv0),
                           torch.from_numpy(gv), gv.shape[0] + 1,
                           dtype=torch.float32)
    assert got.dtype == torch.float32
    got = got.numpy()
    assert np.max(np.abs(got / want - 1.0)) <= 1e-6


@pytest.mark.parametrize("method", [1, 2])
def test_b2_f32_against_bin_images(method):
    """B2's twin on f32 spectra (products in f32, sums in f64) against
    ``raytrace_tpu.ops.binning.bin_images`` on the same f32 spectra:
    relative L2 of 1e-6 on the image and on I_ang."""
    p = synthetic_problem(nx=9, ny=6, na=7, nb=5, nv=12)
    # no NaN coordinates: raytrace_tpu bins them in the first interval,
    # the port (as the reference) in the last
    Iv, coords, ok = deposit_inputs(p.euv_beam, 3000, seed=7, nan_share=0.0)
    Iv = np.where(ok[:, None], Iv, 0.0).astype(np.float32)
    scale = 0.37
    beam = prepare_beam(p.euv_beam)
    C, A = p.euv_beam.nx * p.euv_beam.ny, p.euv_beam.na * p.euv_beam.nb
    image = torch.zeros((C, Iv.shape[1]), dtype=torch.float64)
    i_ang = torch.zeros((A, 1), dtype=torch.float64)
    deposit_kernel.bin_deposit(
        torch.from_numpy(Iv), tuple(torch.from_numpy(c) for c in coords),
        torch.from_numpy(ok), beam, method, scale, image, i_ang)
    jbeam = raytrace_tpu.models.problem.prepare_beam(p.euv_beam)
    # the same coordinates as entry rays (method 1) and as exit rays
    # (method 2: bin_images negates and mirrors them, as B2 does)
    jc = [jnp.asarray(c) for c in coords]
    res = dict.fromkeys(JaxTraceResult._fields)
    res.update(zip(("exit_x", "exit_y", "exit_a", "exit_b"), jc))
    rays = dict(zip("xyab", jc))
    want_img, want_ang = jax_binning.bin_images(
        jnp.asarray(Iv), JaxTraceResult(**res), rays, jbeam, method,
        np.float32(scale), jnp.asarray(ok))
    assert _rel(image.numpy(), np.asarray(want_img)) <= 1e-6
    assert _rel(i_ang.numpy()[:, 0], np.asarray(want_ang)) <= 1e-6


@pytest.mark.parametrize("seeded", [False, True])
def test_create_image_f32_against_jax(seeded):
    """The whole call in f32 against ``raytrace_tpu.create_image`` in f32
    (its default) on the same synthetic problem: relative L2 1e-5; and
    against the port's own f64 call likewise."""
    pj = jax_synthetic(seeded=seeded)
    img, ang = create_image(problem_from_jax(pj), "cpu",
                            spectrum_dtype=torch.float32)
    img_j, ang_j = raytrace_tpu.create_image(pj, "lax-exact",
                                             spectrum_dtype=jnp.float32)
    assert _rel(img, img_j) <= 1e-5 and _rel(ang, ang_j) <= 1e-5
    img64, ang64 = create_image(problem_from_jax(pj), "cpu")
    assert _rel(img, img64) <= 1e-5 and _rel(ang, ang64) <= 1e-5
    assert img.dtype == np.float64


@pytest.mark.parametrize("fixture", ["golden_ase.dat", "golden_seed.dat"])
def test_fixture_goldens_f32(fixture):
    p, image0, i_ang0 = load_input(os.path.join(FIXTURES, fixture))
    image, i_ang = create_image(p, "cpu", spectrum_dtype=np.float32)
    assert check_ans(image0, i_ang0, image, i_ang)
    assert _rel(image, image0) < 1e-5 and _rel(i_ang, i_ang0) < 1e-5


def _mixed(i):
    return synthetic_problem(seeded=i % 2 == 1, rng=i, **SMALL)


def test_stream_and_sharded_f32_against_sync():
    """An f32 stream (with and without the reorder, on a device and on a
    mesh) and an f32 sharded call against the synchronous f32 call on one
    device: within 1e-12."""
    f32 = dict(spectrum_dtype=torch.float32)
    want = [create_image(_mixed(i), "cpu", chunk_size=40, **f32)
            for i in range(4)]
    runs = {
        "stream": create_image_stream([_mixed(i) for i in range(4)], "cpu",
                                      40, torch.float32, depth=2),
        "stream+reorder": create_image_stream(
            [_mixed(i) for i in range(4)], "cpu", 40, torch.float32,
            reorder=True),
        "mesh stream": create_image_stream(
            [_mixed(i) for i in range(4)], "cpu", 40, torch.float32,
            mesh=("cpu",) * 3),
        "sharded": (create_image_sharded(_mixed(i), ("cpu",) * 3, "cpu", 40,
                                         torch.float32) for i in range(4)),
    }
    for what, got in runs.items():
        got = list(got)
        assert len(got) == 4, what
        for (gi, ga), (wi, wa) in zip(got, want):
            assert _rel(gi, wi) <= 1e-12 and _rel(ga, wa) <= 1e-12, what


def test_sharded_f32_against_jax():
    """``create_image_sharded`` in f32 against the JAX package's sharded
    call in f32, in its positional order."""
    from raytrace_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from raytrace_tpu.parallel.sharding import (
        create_image_sharded as jax_sharded)

    pj = jax_synthetic(seeded=True, **SMALL)
    img, ang = create_image_sharded(problem_from_jax(pj), ("cpu",) * 2,
                                    "lax", None, jnp.float32)
    img_j, ang_j = jax_sharded(pj, jax_make_mesh(2), "lax", None,
                               jnp.float32)
    assert _rel(img, img_j) <= 1e-5 and _rel(ang, ang_j) <= 1e-5


def test_positional_order_of_raytrace_tpu():
    """A call written for ``raytrace_tpu`` runs with the same meaning:
    ``(problem, compute_method, chunk_size, spectrum_dtype, c, deposit,
    failed_ray_path)``; the device is keyword-only."""
    p = synthetic_problem(**SMALL)
    want = create_image(synthetic_problem(**SMALL), "cpu", chunk_size=50,
                        spectrum_dtype=torch.float32, c=0.5,
                        deposit="scatter")
    got = create_image(p, "lax-exact", 50, jnp.float32, 0.5, "scatter",
                       "unused.dat")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                              want[1])
    prep = ray_tracer.prepare_pipeline(p, "lax", 50, jnp.float32, 0.5,
                                       "auto", True)
    assert prep.cfg["chunk"] == 50 and prep.cfg["reorder"]
    assert prep.cfg["spectrum_dtype"] == torch.float32
    with pytest.raises(TypeError):
        create_image(p, "cpu", None, torch.float32, 0.5, "auto",
                     "unused.dat", "cpu")


@pytest.mark.parametrize("dtype,want", [
    (torch.float32, torch.float32), (torch.float64, torch.float64),
    (np.float32, torch.float32), (np.dtype("float64"), torch.float64),
    ("float32", torch.float32), (jnp.float32, torch.float32),
    (jnp.float64, torch.float64)])
def test_spectrum_dtype_spellings(dtype, want):
    assert ray_tracer.resolve_spectrum_dtype(dtype) == want


@pytest.mark.parametrize("dtype", [torch.float16, np.int32, "f16",
                                   jnp.bfloat16, "nonsense", torch.int64])
def test_spectrum_dtype_refused(dtype):
    with pytest.raises(RayTraceError, match="spectrum_dtype"):
        create_image(synthetic_problem(**SMALL), "cpu",
                     spectrum_dtype=dtype)


def test_deposit_names():
    """The four strategy names give the same images (each runs the one
    binning deposit); an unknown one raises the JAX package's message."""
    out = [create_image(synthetic_problem(seeded=True, **SMALL), "cpu",
                        deposit=d) for d in ray_tracer.DEPOSITS]
    for img, ang in out[1:]:
        assert np.array_equal(img, out[0][0]) and np.array_equal(
            ang, out[0][1])
    msg = "Unknown deposit strategy 'bogus'"
    for call in (
            lambda: create_image(synthetic_problem(**SMALL), "cpu",
                                 deposit="bogus"),
            lambda: list(create_image_stream([synthetic_problem(**SMALL)],
                                             "cpu", deposit="bogus")),
            lambda: create_image_sharded(synthetic_problem(**SMALL),
                                         ("cpu",) * 2, "cpu",
                                         deposit="bogus")):
        with pytest.raises(RayTraceError, match=msg):
            call()


@pytest.mark.parametrize("name,want", [("pallas", "cuda"), ("lax", "cpu"),
                                       ("lax-exact", "cpu")])
def test_jax_method_names(name, want):
    """``pallas`` names the kernels, ``lax`` and ``lax-exact`` the twins
    on the call's device."""
    if want == "cuda":
        with pytest.raises(RayTraceError, match="needs a CUDA device"):
            ray_tracer.resolve_method(name, "cpu")
        assert ray_tracer._METHOD_ALIASES[name] == "cuda"
    else:
        assert ray_tracer.resolve_method(name) == ("cpu",
                                                   torch.device("cpu"))
        img, _ = create_image(synthetic_problem(**SMALL), name)
        assert np.isfinite(img).all()


def test_f32_and_f64_are_two_cached_pipelines():
    """The spectrum dtype is part of the pipeline cache's key: an f32 and
    an f64 call of one problem are two configs; each is found again."""
    ray_tracer.clear_pipeline_cache()
    p = synthetic_problem(seeded=True, **SMALL)
    p64 = ray_tracer.prepare_pipeline(p, "cpu")
    p32 = ray_tracer.prepare_pipeline(p, "cpu", spectrum_dtype=np.float32)
    assert p64.pipeline is not p32.pipeline
    assert len(ray_tracer._PIPELINE_CACHE) == 2
    assert ray_tracer.prepare_pipeline(
        p, "cpu", spectrum_dtype="float64").pipeline is p64.pipeline
    assert ray_tracer.prepare_pipeline(
        p, "cpu", spectrum_dtype=torch.float32).pipeline is p32.pipeline
    assert p64.cfg["spectrum_dtype"] == torch.float64
    assert p32.cfg["launches"] == dict(trace=0, bin_deposit=0, amplify=0,
                                       bin_deposit_f32=0, amplify_f32=0)
    ray_tracer.clear_pipeline_cache()


def test_cli_spectrum_f32(capsys, monkeypatch):
    """``-spectrum=f32`` runs every call of the CLI in f32, and the golden
    check passes on a fixture; a bad value is refused."""
    from raytrace_tpu_torch.utils import cli

    path = os.path.join(FIXTURES, "golden_seed.dat")
    assert cli.Options(["-spectrum=f32", path]).spectrum_dtype \
        == torch.float32
    assert cli.Options([path]).spectrum_dtype == torch.float64
    seen = []
    real = ray_tracer._prepare

    def spy(*a, **kw):
        seen.append(kw.get("spectrum_dtype"))
        return real(*a, **kw)

    monkeypatch.setattr(ray_tracer, "_prepare", spy)
    cli.run_tests(path, cli.Options(["-spectrum=f32", "-methods=cpu",
                                     "-iterations=1", "-stream=2"]))
    out = capsys.readouterr().out
    assert "Running cpu on cpu, spectrum f32" in out
    assert "cpu+stream" in out and "Answers do not match" not in out
    # the warm-up, the timed call, the stream's units and its label
    assert len(seen) >= 4 and set(seen) == {torch.float32}
    with pytest.raises(SystemExit, match="f64 or f32"):
        cli.Options(["-spectrum=bf16", path])


def test_cli_nprocs_f32():
    """``-nprocs=2 -spectrum=f32``: each rank of the gloo group runs the
    f32 spectrum and passes the golden check; the exit code counts only
    the timing-stability gates."""
    import subprocess
    import sys

    from test_torch_distributed import ROOT, TIMEOUT, _env, _gate_errors

    r = subprocess.run(
        [sys.executable, "-m", "raytrace_tpu_torch.utils.cli",
         "-methods=cpu", "-iterations=1", "-nprocs=2", "-spectrum=f32",
         os.path.join(FIXTURES, "golden_seed.dat")],
        capture_output=True, text=True, timeout=TIMEOUT, cwd=ROOT,
        env=_env())
    out = r.stdout
    assert "Running cpu on cpu, spectrum f32" in out, out + r.stderr
    assert "Answers do not match" not in out, out + r.stderr
    assert r.returncode == _gate_errors(out), out + r.stderr
