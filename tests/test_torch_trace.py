"""The port's plain trace (the twin of CUDA kernel B1) against the JAX
package: per ray, on tables fed through convert.gain_from_numpy so both
sides read bit-identical inputs.

* Lockstep tier (refraction-free, both methods): the cell ids ``ivl`` match
  the JAX exact stepper, the Pallas kernel (interpret mode) and the scalar
  oracle exactly, and ``gvl`` agrees to 1e-5 relative -- float32
  accumulation error only, since straight rays leave no trajectory chaos
  to hide an indexing bug. The one exception is the Pallas kernel's known
  grid-line tie class (it resolves cell edges from f32 coordinates): where
  its gvl differs, the port must agree with the oracle instead.
* Refracting tier (gently refracting, non-uniform grid, full plane): gvl
  and evl agree with ``stepper.trace_batch`` to 1e-5 in the median and the
  escape flags are identical.
"""

import numpy as np
import pytest
import torch

import raytrace_tpu  # noqa: F401  (JAX package: x64 + CPU config)
import jax
import jax.numpy as jnp
from raytrace_tpu.models.problem import prepare_gain as jax_prepare_gain
from raytrace_tpu.ops import oracle
from raytrace_tpu.ops import stepper as jax_stepper
from raytrace_tpu.testing import synthetic_problem

from raytrace_tpu_torch.convert import gain_from_numpy
from raytrace_tpu_torch.ops import trace_kernel
from raytrace_tpu_torch.ops.stepper import trace_batch_plain

torch.set_num_threads(2)

#: the JAX exact stepper compiled once per (method, batch size); eager
#: dispatch would compile every nested while loop anew per problem
_jax_trace = jax.jit(jax_stepper.trace_batch,
                     static_argnames=("N", "dz0", "method", "c", "use_emis"))


def _sample_rays(p, n, seed):
    """n rays on the source beam's grid points, as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    b = p.seed_beam if p.seed is not None else p.euv_beam
    return tuple(g[rng.integers(0, len(g), n)].astype(np.float32)
                 for g in (b.x, b.y, b.a, b.b))


def _both(p, rays, method):
    """(port result as numpy dict, JAX stepper result) on the same rays and
    bit-identical tables."""
    use_emis = method == 1
    tables = jax_prepare_gain(p.gain, as_numpy=True)
    got = trace_batch_plain({k: torch.from_numpy(v) for k, v in
                             zip("xyab", rays)}, p.N, p.euv_beam.dz,
                            gain_from_numpy(tables), method,
                            use_emis=use_emis)
    want = _jax_trace({k: jnp.asarray(v) for k, v in zip("xyab", rays)},
                      N=p.N, dz0=p.euv_beam.dz,
                      gain=jax_prepare_gain(p.gain), method=method,
                      use_emis=use_emis)
    got = {f: getattr(got, f).numpy() for f in got._fields}
    want = {f: np.asarray(getattr(want, f)) for f in want._fields}
    return got, want


def _rel(got, want):
    return np.abs(got - want) / np.maximum(np.abs(want), 1e-6)


@pytest.mark.parametrize("method", [1, 2])
def test_lockstep_vs_jax_stepper(method):
    p = synthetic_problem(refraction_free=True, seeded=method == 2)
    got, want = _both(p, _sample_rays(p, 256, 7), method)
    np.testing.assert_array_equal(got["ivl"], want["ivl"])
    np.testing.assert_array_equal(got["escaped"], want["escaped"])
    assert _rel(got["gvl"], want["gvl"]).max() < 1e-5
    assert _rel(got["evl"], want["evl"]).max() < 1e-5
    np.testing.assert_allclose(got["exit_x"], want["exit_x"], rtol=1e-5,
                               atol=1e-9)


@pytest.mark.parametrize("method", [1, 2])
def test_lockstep_vs_pallas_interpret(method):
    """One 2048-ray tile through the Pallas kernel in interpret mode, as
    tests/test_stepper.py runs it on the CPU."""
    from raytrace_tpu.ops import pallas_kernel as pk

    p = synthetic_problem(refraction_free=True, seeded=method == 2)
    n = 64
    rays = _sample_rays(p, n, 11)
    use_emis = method == 1
    tiled = {k: jnp.pad(jnp.asarray(v), (0, pk.TILE - n)).reshape(
        1, pk.TILE_ROWS, pk.TILE_LANES) for k, v in zip("xyab", rays)}
    pg = pk.pack_gain_tables(p.gain, use_emis=use_emis)
    gvl, _evl, ivl, *_ = pk.trace_tiles(tiled, p.N, p.euv_beam.dz, pg,
                                        method, interpret=True)
    nseg = p.N - 1
    want_gvl = np.asarray(gvl).transpose(0, 3, 4, 1, 2).reshape(
        pk.TILE, nseg, pk.N_SUB)[:n]
    want_ivl = np.asarray(ivl).transpose(0, 3, 4, 1, 2).reshape(
        pk.TILE, nseg, pk.N_SUB)[:n]
    got = trace_batch_plain(
        {k: torch.from_numpy(v) for k, v in zip("xyab", rays)}, p.N,
        p.euv_beam.dz, gain_from_numpy(jax_prepare_gain(p.gain,
                                                        as_numpy=True)),
        method, use_emis=use_emis)
    np.testing.assert_array_equal(got.ivl.numpy(), want_ivl)
    off = np.nonzero(_rel(got.gvl.numpy(), want_gvl).reshape(n, -1).max(1)
                     >= 1e-5)[0]
    assert len(off) <= n // 16, f"{len(off)} rays off the Pallas kernel"
    for t in off:  # grid-line ties: the oracle decides
        o = oracle.calc_ray(tuple(r[t] for r in rays), p.N, p.euv_beam.dz,
                            p.gain, None, p.euv_beam.nv, method)
        assert _rel(got.gvl[t].numpy(), o.gvl[: p.N - 1]).max() < 1e-5


@pytest.mark.parametrize("method", [1, 2])
def test_lockstep_vs_oracle(method):
    p = synthetic_problem(refraction_free=True, seeded=method == 2)
    b = p.euv_beam
    n = 32
    rays = _sample_rays(p, n, 3)
    got = trace_batch_plain(
        {k: torch.from_numpy(v) for k, v in zip("xyab", rays)}, p.N, b.dz,
        gain_from_numpy(jax_prepare_gain(p.gain, as_numpy=True)), method,
        use_emis=method == 1)
    for t in range(n):
        o = oracle.calc_ray(tuple(r[t] for r in rays), p.N, b.dz, p.gain,
                            None, b.nv, method)
        want = o.gvl[: p.N - 1]
        np.testing.assert_array_equal(got.ivl[t].numpy(), o.ivl[: p.N - 1])
        assert _rel(got.gvl[t].numpy(), want).max() < 1e-5, f"ray {t}"


@pytest.mark.parametrize("kwargs,method", [
    (dict(), 1),
    (dict(), 2),
    (dict(non_uniform_gain=True), 1),
    (dict(non_uniform_gain=0.8), 2),
    (dict(full_plane=True), 1),
    (dict(full_plane=True), 2),
], ids=["refracting-1", "refracting-2", "jitter-grid-1", "warped-grid-2",
        "full-plane-1", "full-plane-2"])
def test_refracting_vs_jax_stepper(kwargs, method):
    p = synthetic_problem(seeded=method == 2, **kwargs)
    got, want = _both(p, _sample_rays(p, 256, 5), method)
    np.testing.assert_array_equal(got["escaped"], want["escaped"])
    assert np.median(_rel(got["gvl"], want["gvl"])) < 1e-5
    assert np.median(_rel(got["evl"], want["evl"])) < 1e-5


def test_single_segment_is_empty():
    """N = 1: no segments, empty [B, 0, 3] path integrals, exit = entry."""
    p = synthetic_problem(N=1)
    rays = _sample_rays(p, 16, 0)
    res = trace_kernel.trace_batch(
        {k: torch.from_numpy(v) for k, v in zip("xyab", rays)}, p.N,
        p.euv_beam.dz, gain_from_numpy(jax_prepare_gain(p.gain,
                                                        as_numpy=True)), 1)
    assert res.gvl.shape == (16, 0, 3) and res.ivl.shape == (16, 0, 3)
    np.testing.assert_array_equal(res.exit_x.numpy(), rays[0])
    assert not res.escaped.any()


def test_wrapper_takes_the_twin_on_cpu():
    """On CPU tensors the wrapper is the plain twin and launches nothing."""
    p = synthetic_problem()
    rays = {k: torch.from_numpy(v) for k, v in
            zip("xyab", _sample_rays(p, 64, 1))}
    gain = gain_from_numpy(jax_prepare_gain(p.gain, as_numpy=True))
    before = trace_kernel.launch_count
    a = trace_kernel.trace_batch(rays, p.N, p.euv_beam.dz, gain, 1)
    b = trace_batch_plain(rays, p.N, p.euv_beam.dz, gain, 1)
    assert trace_kernel.launch_count == before
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
