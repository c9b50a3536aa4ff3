"""The port's seeded amplify (the plain twin of CUDA kernel B3) against the
JAX package.

* Its f64 log-gain against the Pallas kernel ``pallas_amplify.
  log_gain_fused`` in interpret mode, whose (hi, lo) f32 pair tracks the f64
  sum to ~1 ulp of the largest term: within 2e-7, the bound of
  tests/test_pallas_amplify.py.
* Its spectrum against ``raytrace_tpu.ops.spectrum.amplify`` in float64 on
  the masked entry seed ``where(escaped, 0, f * fv)`` (the same sum in the
  same order, then ``Iv0 * exp``): 1e-14 relative.
* The factor form of the entry seed (``seed_factor``, ``calc_seed_entry``)
  against ``raytrace_tpu.ops.seed.calc_seed_entry``: 1e-14 relative.
* The flags against the [B, K] reductions the failure codes used before
  they moved into B3.
* The wrapper takes the twin on CPU tensors and launches nothing; with no
  segments it returns the masked entry seed.
* The emissivity amplify's twin (of CUDA kernel B4) is ``spectrum.amplify``
  on a zero entry spectrum and ``iv_flags``, bitwise; its wrapper takes it
  on CPU tensors, launches nothing, and refuses what B4 does not take, in
  f64 and in f32 (B4-f32). A ``cuda`` call sends its emissivity amplify
  through the wrapper in the call's spectrum dtype; ``cpu``, ``lax`` and
  ``lax-exact`` run the twin.
"""

import numpy as np
import pytest
import torch

import raytrace_tpu  # noqa: F401  (JAX package: x64 + CPU config)
import jax.numpy as jnp
from raytrace_tpu.models.problem import prepare_seed as jax_prepare_seed
from raytrace_tpu.ops import pallas_amplify as pa
from raytrace_tpu.ops import seed as jax_seed
from raytrace_tpu.ops import spectrum as jax_spectrum
from raytrace_tpu.ops.stepper import TraceResult as JaxTraceResult
from raytrace_tpu.testing import synthetic_problem as jax_synthetic

from raytrace_tpu_torch.convert import problem_from_jax
from raytrace_tpu_torch.models.problem import (seed_arrays, seed_from_tensors,
                                               seed_scalars)
from raytrace_tpu_torch.models.problem import prepare_gain
from raytrace_tpu_torch.ops import (amplify_kernel, cuda_lib, seed as seed_ops,
                                    spectrum)
from raytrace_tpu_torch.ops.stepper import TraceResult, trace_batch_plain
from raytrace_tpu_torch.testing import (amplify_inputs, emis_inputs,
                                        source_rays, synthetic_problem)

torch.set_num_threads(2)


def _seeded(B, nseg=2, seed=3, K=82, spread=None):
    """(f, fv, escaped, ivl, gvl, gv) as numpy arrays: a seed factor per
    ray, the frequency profile and about one escaped ray in eight."""
    ivl, gvl, gv = amplify_inputs(B=B, nseg=nseg, K=K, seed=seed,
                                  spread=spread)
    rng = np.random.default_rng(seed + 10)
    return (rng.random(B), rng.uniform(0.1, 2.0, K), rng.random(B) < 0.125,
            ivl, gvl, gv)


@pytest.mark.parametrize("spread", [None, 40])
def test_log_gain_vs_pallas_interpret(spread):
    ivl, gvl, gv = amplify_inputs(spread=spread)
    nsub = ivl.shape[2]
    hi, lo = pa.log_gain_fused(jnp.asarray(ivl), jnp.asarray(gvl),
                               pa.pack_gv(jnp.asarray(gv)), nsub,
                               interpret=True)
    want = np.asarray(hi).astype(np.float64) + np.asarray(lo)
    got = amplify_kernel.log_gain_plain(
        *(torch.from_numpy(a) for a in (ivl, gvl, gv))).numpy()
    assert np.abs(got - want).max() < 2e-7


@pytest.mark.parametrize("nseg", [1, 2])
def test_amplify_vs_jax_f64(nseg):
    f, fv, esc, ivl, gvl, gv = _seeded(512, nseg=nseg)
    Iv0 = np.where(esc[:, None], 0.0, f[:, None] * fv[None, :])
    res = JaxTraceResult(gvl=jnp.asarray(gvl), evl=jnp.zeros(gvl.shape),
                         ivl=jnp.asarray(ivl), exit_x=None, exit_y=None,
                         exit_a=None, exit_b=None, escaped=None, perp=None)
    want = np.asarray(jax_spectrum.amplify(
        res, jnp.asarray(Iv0), jnp.asarray(gv), nseg + 1, False,
        dtype=jnp.float64))
    got, flags = amplify_kernel.amplify_gain_plain(
        *(torch.from_numpy(a) for a in (f, fv, esc, ivl, gvl, gv)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0)
    assert not flags.any()


def test_seed_factor_vs_jax_entry_seed():
    """The per-ray factor times fv is the JAX package's entry seed."""
    pj = jax_synthetic(seeded=True)
    p = problem_from_jax(pj)
    K, src = p.euv_beam.nv, p.seed_beam
    grids = [np.asarray(g, np.float64) for g in (src.x, src.y, src.a, src.b)]
    dseed = seed_from_tensors({k: torch.from_numpy(v) for k, v in
                               seed_arrays(p.seed).items()},
                              seed_scalars(p.seed))
    tabs = seed_ops.make_entry_seed_tables(
        dseed, [torch.from_numpy(g.astype(np.float32)) for g in grids], K)
    tabs_j = jax_seed.make_entry_seed_tables(
        jax_prepare_seed(pj.seed), [jnp.asarray(g) for g in grids], K)
    rng = np.random.default_rng(0)
    idx = [rng.integers(0, len(g), 2000) for g in grids]
    f = seed_ops.seed_factor(tabs, *(torch.from_numpy(i) for i in idx))
    got = seed_ops.calc_seed_entry(tabs, *(torch.from_numpy(i) for i in idx),
                                   K)
    assert torch.equal(got, f[:, None] * tabs.fv[None, :])
    want = np.asarray(jax_seed.calc_seed_entry(
        tabs_j, *(jnp.asarray(i) for i in idx), K))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0)
    assert (f > 0).any() and (f >= 0).all()


def test_flags_equal_the_reductions():
    """The twin's flag bits are the [B, K] any(Iv < 0) and any(Iv != Iv)
    reductions: a negative and a NaN fv entry reach every ray that did not
    escape; escaped rays are 0 and unflagged."""
    f, fv, esc, ivl, gvl, gv = (torch.from_numpy(a) for a in _seeded(300))
    fv[3], fv[7] = -1.0, float("nan")
    Iv, flags = amplify_kernel.amplify_gain_plain(f, fv, esc, ivl, gvl, gv)
    neg = torch.any(Iv < 0.0, dim=1)
    nan = torch.any(Iv != Iv, dim=1)
    assert torch.equal((flags & amplify_kernel.FLAG_NEG) != 0, neg)
    assert torch.equal((flags & amplify_kernel.FLAG_NAN) != 0, nan)
    assert torch.equal(nan, ~esc) and torch.equal(neg, ~esc & (f > 0))
    assert torch.equal(Iv[esc], torch.zeros_like(Iv[esc]))


def test_no_segments_returns_iv0():
    f, fv, esc, *_ = (torch.from_numpy(a) for a in _seeded(64, K=7))
    ivl = torch.zeros((64, 0, 3), dtype=torch.int32)
    gvl = torch.zeros((64, 0, 3), dtype=torch.float32)
    gv = torch.zeros((0, 10, 7), dtype=torch.float32)
    Iv, flags = amplify_kernel.amplify_gain(f, fv, esc, ivl, gvl, gv)
    assert torch.equal(Iv, torch.where(esc[:, None], 0.0,
                                       f[:, None] * fv[None, :]))
    assert not flags.any()


def test_spectrum_gain_only_goes_through_the_wrapper():
    """The seeded call's gain-only amplify is B3's wrapper
    (``ray_tracer._dispatch_steps``); on CPU tensors the wrapper is the twin
    and launches nothing."""
    f, fv, esc, ivl, gvl, gv = (torch.from_numpy(a)
                                for a in _seeded(256, seed=7))
    before = cuda_lib.launches()
    got, flags = amplify_kernel.amplify_gain(f, fv, esc, ivl, gvl, gv)
    assert not cuda_lib.since(before)
    want, want_flags = amplify_kernel.amplify_gain_plain(f, fv, esc, ivl,
                                                         gvl, gv)
    assert torch.equal(got, want) and torch.equal(flags, want_flags)


def test_wrapper_checks_its_inputs():
    f, fv, esc, ivl, gvl, gv = (torch.from_numpy(a)
                                for a in _seeded(256, seed=8))
    with pytest.raises(ValueError):
        amplify_kernel.amplify_gain(f.float(), fv, esc, ivl, gvl, gv)
    with pytest.raises(ValueError):
        amplify_kernel.amplify_gain(f, fv, esc, ivl.long(), gvl, gv)
    with pytest.raises(ValueError):
        amplify_kernel.amplify_gain(f, fv, esc, ivl, gvl, gv[:, :, :40])
    with pytest.raises(ValueError):
        amplify_kernel.amplify_gain(f, fv[:40], esc, ivl, gvl, gv)
    with pytest.raises(ValueError):
        amplify_kernel.amplify_gain(f, fv, esc.to(torch.uint8), ivl, gvl, gv)


def _traced_emis(n=1500):
    """The twin trace's result on the first ``n`` rays of an ASE-widths
    synthetic, and the lineshape tables of segments 1..N-1."""
    p = synthetic_problem(nx=60, ny=25, na=19, nb=14, nv=52, gain_nx=106,
                          gain_ny=26)
    gain = prepare_gain(p.gain)
    res = trace_batch_plain(source_rays(p, n), p.N, p.euv_beam.dz, gain, 1)
    return p, res, gain.gv[1:]


@pytest.mark.parametrize("inputs", ["traced", "emis_inputs", "no-segments"])
def test_emis_twin_is_spectrum_amplify_and_flags(inputs):
    """``amplify_emis_plain`` equals the emissivity branch the call ran
    before B4 (``spectrum.amplify`` of a zero [B, K] entry spectrum, then
    ``iv_flags``) bitwise, spectrum and flags, and the wrapper on CPU
    tensors equals the twin without counting a launch."""
    if inputs == "traced":
        p, res, gv = _traced_emis()
        N = p.N
    else:
        ivl, gvl, evl, gv = (torch.from_numpy(a) for a in emis_inputs(
            B=700, nseg=0 if inputs == "no-segments" else 2, cells=300))
        if inputs == "emis_inputs":
            evl[4, 0, 0] = float("nan")
        res = TraceResult(gvl=gvl, evl=evl, ivl=ivl, exit_x=None,
                          exit_y=None, exit_a=None, exit_b=None,
                          escaped=None, perp=None)
        N = ivl.shape[1] + 1
    B, K = res.ivl.shape[0], gv.shape[2]
    want = spectrum.amplify(res, torch.zeros((B, K), dtype=torch.float64),
                            gv, N)
    want_flags = amplify_kernel.iv_flags(want)
    got, flags = amplify_kernel.amplify_emis_plain(res.ivl, res.gvl, res.evl,
                                                   gv)
    assert got.dtype == torch.float64 and got.shape == (B, K)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    assert torch.equal(flags, want_flags)
    before = cuda_lib.launches()
    wrapped = amplify_kernel.amplify_emis(res.ivl, res.gvl, res.evl, gv)
    assert not cuda_lib.since(before)
    assert torch.equal(wrapped[0].view(torch.int64), got.view(torch.int64))
    assert torch.equal(wrapped[1], flags)
    if inputs == "emis_inputs":
        assert flags[4] == amplify_kernel.FLAG_NAN and flags.sum() == 2
    elif inputs == "traced":
        assert not flags.any() and got.abs().max() > 0


def _emis_refusals():
    """Good inputs of the emissivity amplify's wrapper, and changes to them
    that it must refuse: a wrong dtype, shape, layout or device of any
    input."""
    ivl, gvl, evl, gv = (torch.from_numpy(a)
                         for a in emis_inputs(B=64, cells=20, K=10))
    good = dict(ivl=ivl, gvl=gvl, evl=evl, gv=gv)
    bad = [dict(ivl=ivl.long()), dict(gvl=gvl.double()),
           dict(evl=evl.double()), dict(gv=gv.double()),
           dict(ivl=ivl[:, :, :2].contiguous()), dict(evl=evl[:32]),
           dict(gvl=gvl[:, :1].contiguous()), dict(gv=gv[:1].contiguous()),
           dict(gv=gv[0]), dict(ivl=ivl[:, 0]),
           dict(evl=evl.transpose(1, 2).contiguous().transpose(1, 2)),
           dict(gv=gv.transpose(1, 2)), dict(gv=gv.to("meta")),
           dict(ivl=ivl.to("meta"), gvl=gvl.to("meta"), evl=evl.to("meta"),
                gv=gv.to("meta"))]
    return good, bad


def test_emis_wrapper_refusals():
    """B4's wrapper refuses a wrong dtype, shape, layout or device of any
    input before it runs anything."""
    good, bad = _emis_refusals()
    for change in bad:
        with pytest.raises(ValueError, match="amplify_emis"):
            amplify_kernel.amplify_emis(**{**good, **change})
    Iv, flags = amplify_kernel.amplify_emis(**good)
    assert Iv.shape == (64, 10) and flags.shape == (64,)


def test_emis_f32_wrapper_refusals():
    """B4-f32's wrapper refuses what B4's does, before it runs anything,
    and any spectrum dtype but float64 and float32."""
    good, bad = _emis_refusals()
    for change in bad:
        with pytest.raises(ValueError, match="amplify_emis"):
            amplify_kernel.amplify_emis(**{**good, **change},
                                        dtype=torch.float32)
    for dtype in (torch.float16, torch.bfloat16, torch.int32):
        with pytest.raises(ValueError, match="amplify_emis"):
            amplify_kernel.amplify_emis(**good, dtype=dtype)
    Iv, flags = amplify_kernel.amplify_emis(**good, dtype=torch.float32)
    assert Iv.shape == (64, 10) and Iv.dtype == torch.float32
    assert flags.shape == (64,)


@pytest.mark.parametrize("method", ["cuda", "cpu", "lax", "lax-exact"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_emis_dispatch_follows_method_and_dtype(monkeypatch, method, dtype):
    """The ASE call's emissivity amplify: a ``cuda`` configuration (its
    tensors on the CPU here, so the wrapper takes the twin) calls
    ``amplify_emis`` once a chunk in the call's spectrum dtype, which picks
    B4 or B4-f32 on a card; ``cpu``, ``lax`` and ``lax-exact`` call the
    twin itself, in that dtype, and never the wrapper."""
    from raytrace_tpu_torch import create_image
    from raytrace_tpu_torch.models import ray_tracer
    from raytrace_tpu_torch.testing import synthetic_problem

    seen = {"amplify_emis": [], "amplify_emis_plain": []}
    for name in seen:
        real = getattr(amplify_kernel, name)

        def spy(*args, _name=name, _real=real, **kw):
            seen[_name].append(kw.get("dtype", args[4] if len(args) > 4
                                      else torch.float64))
            return _real(*args, **kw)

        monkeypatch.setattr(amplify_kernel, name, spy)
    p = synthetic_problem(nx=6, ny=4, na=4, nb=3, nv=5)
    if method == "cuda":
        prep = ray_tracer._prepare(p, "cuda", "cpu", chunk_size=50,
                                   eager=True, spectrum_dtype=dtype)
        n = prep.cfg["n_chunks"]
        prep.pipeline(*prep.operands)
        assert n > 2 and seen["amplify_emis"] == [dtype] * n
        assert seen["amplify_emis_plain"] == [dtype] * n
    else:
        assert ray_tracer.resolve_method(p, method) == "cpu"
        create_image(p, method, chunk_size=50, spectrum_dtype=dtype)
        n = -(-(6 * 4 * 4 * 3) // 50)
        assert seen["amplify_emis"] == []
        assert seen["amplify_emis_plain"] == [dtype] * n
