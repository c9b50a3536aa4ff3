"""The port's single-ray API (``raytrace_tpu_torch.api``, exported from the
package): the checks of ``tests/test_create_image.py`` on ``calc_ray``,
``calc_seed`` and ``calc_ray_path``, and each output bitwise equal to
``raytrace_tpu.api``'s on the same inputs (both run the scalar oracle on
the host)."""

import numpy as np

import raytrace_tpu
from raytrace_tpu.testing import synthetic_problem as jax_synthetic

import raytrace_tpu_torch
from raytrace_tpu_torch import calc_ray, calc_ray_path, calc_seed
from raytrace_tpu_torch.convert import problem_from_jax
from raytrace_tpu_torch.io.loader import scale_problem


def _pair(**kw):
    pj = jax_synthetic(**kw)
    return pj, problem_from_jax(pj)


def test_calc_ray_api():
    pj, p = _pair()
    b = p.euv_beam
    ray = (b.x[2], b.y[1], b.a[1], b.b[1])
    err, Iv, ray_out = calc_ray(ray, p.N, b.dz, p.gain, None, b.nv, 1)
    assert err == 0 and Iv.shape == (b.nv,) and np.all(np.isfinite(Iv))
    assert np.all(np.isfinite(ray_out))
    err_j, Iv_j, ray_out_j = raytrace_tpu.calc_ray(ray, p.N, b.dz, pj.gain,
                                                   None, b.nv, 1)
    assert err == err_j
    assert np.array_equal(Iv, Iv_j) and np.array_equal(ray_out, ray_out_j)


def test_calc_ray_api_seeded_forward():
    pj, p = _pair(seeded=True)
    sb = p.seed_beam
    ray = (sb.x[3], sb.y[2], sb.a[2], sb.b[1])
    got = calc_ray(ray, p.N, p.euv_beam.dz, p.gain, p.seed, p.euv_beam.nv, 2)
    want = raytrace_tpu.calc_ray(ray, p.N, p.euv_beam.dz, pj.gain, pj.seed,
                                 p.euv_beam.nv, 2)
    assert got[0] == want[0] == 0 and got[1].max() > 0
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[2],
                                                              want[2])


def test_calc_seed_api():
    pj, p = _pair(seeded=True)
    Iv = calc_seed(p.seed, 2.5e-3, 1.0e-3, 0.0, 0.0)
    assert Iv.shape == (p.euv_beam.nv,)
    assert np.all(Iv >= 0) and Iv.max() > 0
    assert np.array_equal(Iv, raytrace_tpu.calc_seed(pj.seed, 2.5e-3, 1.0e-3,
                                                     0.0, 0.0))
    # outside the table box -> zero
    Iv0 = calc_seed(p.seed, 1.0, 0.0, 0.0, 0.0)
    assert np.all(Iv0 == 0)
    assert np.array_equal(Iv0, raytrace_tpu.calc_seed(pj.seed, 1.0, 0.0, 0.0,
                                                      0.0))


def test_calc_ray_path_api():
    pj, p = _pair()
    b = p.euv_beam
    n_err, xr, yr, ir = calc_ray_path(
        b.x[:2], b.y[:2], b.a[:1], b.b[:1], p.N, b.dz, p.gain, None,
        b.nv, b.dv, 1)
    n_st = 3 * (p.N - 1) + 1
    assert xr.shape == (2, 2, 1, 1, n_st)
    assert n_err == 0
    # stations should move: the trajectory is non-constant
    assert np.ptp(xr[0, 0, 0, 0]) > 0
    # running intensity is finite and non-negative at the last station
    assert np.all(np.isfinite(ir)) and ir[..., -1].min() >= 0
    want = raytrace_tpu.calc_ray_path(
        b.x[:2], b.y[:2], b.a[:1], b.b[:1], p.N, b.dz, pj.gain, None,
        b.nv, b.dv, 1)
    assert n_err == want[0]
    for got_a, want_a in zip((xr, yr, ir), want[1:]):
        assert got_a.dtype == want_a.dtype and np.array_equal(got_a, want_a)


def test_calc_ray_path_counts_failures():
    """Rays beyond 1.5 rad are perpendicular: each counts one error, as in
    the JAX package."""
    pj, p = _pair(nx=2, ny=2, na=2, nb=2, nv=2)
    b = p.euv_beam
    a = np.array([b.a[0], b.a[0] + 1500.0])
    got = calc_ray_path(b.x, b.y[:1], a, b.b[:1], p.N, b.dz, p.gain, None,
                        b.nv, b.dv, 1)
    want = raytrace_tpu.calc_ray_path(b.x, b.y[:1], a, b.b[:1], p.N, b.dz,
                                      pj.gain, None, b.nv, b.dv, 1)
    assert got[0] == want[0] == 2
    for got_a, want_a in zip(got[1:], want[1:]):
        assert np.array_equal(got_a, want_a)


def test_package_exports():
    for name in ("calc_ray", "calc_seed", "calc_ray_path", "scale_problem"):
        assert name in raytrace_tpu_torch.__all__
    assert raytrace_tpu_torch.scale_problem is scale_problem
    assert set(raytrace_tpu.__all__) <= set(raytrace_tpu_torch.__all__)
