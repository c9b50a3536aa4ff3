"""The port's scalar oracle (``raytrace_tpu_torch/ops/oracle.py``) against
``raytrace_tpu.ops.oracle``, bitwise (``np.array_equal``): ``calc_ray`` on
24 rays per case in both methods on the plain, seeded, full-plane, warped
and refraction-free synthetics (stats and the debug stations included),
the search and pchip helpers, ``calc_seed`` and ``testing.oracle_images``.
Then the port's tensor ``ops/interp`` against the port's oracle, as
``tests/test_interp.py`` holds the JAX package's (indices exact, pchip to
1e-12, interp_linear to 1e-15 relative)."""

import numpy as np
import pytest
import torch

import raytrace_tpu  # noqa: F401
from raytrace_tpu.ops import oracle as jax_oracle
from raytrace_tpu.testing import oracle_images as jax_oracle_images
from raytrace_tpu.testing import synthetic_problem as jax_synthetic

from raytrace_tpu_torch.convert import problem_from_jax
from raytrace_tpu_torch.ops import interp, mathlib, oracle
from raytrace_tpu_torch.testing import oracle_images

KINDS = {
    "plain": dict(),
    "seeded": dict(seeded=True),
    "full_plane": dict(full_plane=True, N=4),
    "warped": dict(non_uniform_gain=0.8),
    "refraction_free": dict(refraction_free=True, seeded=True),
}


def _pair(kind, rng=3):
    pj = jax_synthetic(rng=rng, **KINDS[kind])
    return pj, problem_from_jax(pj)


def _rays(p, method, n=24, seed=0):
    """``n`` rays of the source grid (the seed beam's for a seeded method
    2 call), some nudged off the grid points, as f32 tuples."""
    src = p.seed_beam if (method == 2 and p.seed is not None) else p.euv_beam
    rng = np.random.default_rng(seed)
    rays = []
    for t in range(n):
        r = [g[rng.integers(0, len(g))] for g in (src.x, src.y, src.a, src.b)]
        if t % 3 == 0:
            r = [v + 0.3 * d * rng.uniform(-1, 1)
                 for v, d in zip(r, (src.dx, src.dy, src.da, src.db))]
        rays.append(tuple(np.float32(v) for v in r))
    return rays


def _assert_same(got, want):
    for f in ("Iv", "ray_out", "gvl", "evl", "ivl", "debug"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b,
                                                         equal_nan=True), f
    assert got.error == want.error
    assert got.stats == want.stats


@pytest.mark.parametrize("method", [1, 2])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_calc_ray_bitwise(kind, method):
    pj, p = _pair(kind)
    b = p.euv_beam
    seed_j = pj.seed if method == 2 else None
    seed = p.seed if method == 2 else None
    steps = 0
    for ray in _rays(p, method):
        args = (ray, p.N, b.dz)
        got = oracle.calc_ray(*args, p.gain, seed, b.nv, method)
        want = jax_oracle.calc_ray(*args, pj.gain, seed_j, b.nv, method)
        _assert_same(got, want)
        got = oracle.calc_ray(*args, p.gain, seed, b.nv, method,
                              collect_stats=True, debug_dv=b.dv)
        want = jax_oracle.calc_ray(*args, pj.gain, seed_j, b.nv, method,
                                   collect_stats=True, debug_dv=b.dv)
        _assert_same(got, want)
        steps += got.stats["micro_steps"]
    assert steps > 0


def test_limits_and_result_type():
    for name in ("N_MAX", "K_MAX", "N_SUB", "N_FAILED_MAX"):
        assert getattr(oracle, name) == getattr(jax_oracle, name)
    assert [f for f in oracle.RayResult.__dataclass_fields__] == [
        f for f in jax_oracle.RayResult.__dataclass_fields__]


def test_search_helpers_bitwise():
    rng = np.random.default_rng(0)
    for n in (2, 3, 37, 106):
        grid = np.sort(rng.random(n))
        ys = np.concatenate([rng.random(64) * 1.2 - 0.1, grid,
                             [grid[0] - 1, grid[-1] + 1]])
        for y in ys:
            assert (oracle.find_first_single(grid, y)
                    == jax_oracle.find_first_single(grid, y))
            assert oracle.find_index(grid, y) == jax_oracle.find_index(grid, y)


def test_interp_pchip_bitwise():
    rng = np.random.default_rng(2)
    for n in (2, 3, 25):
        xi = np.sort(rng.random(n)) * 10
        yi = np.cumsum(rng.normal(size=n))  # mixed monotone/non-monotone
        for x in np.concatenate([rng.uniform(-1, 11, 100), xi]):
            got = oracle.interp_pchip(xi, yi, x)
            want = jax_oracle.interp_pchip(xi, yi, x)
            assert np.array_equal(got, want)


def test_calc_seed_bitwise():
    pj, p = _pair("seeded")
    rng = np.random.default_rng(4)
    for _ in range(40):
        pt = [rng.uniform(lo, hi) for lo, hi in
              ((-1e-3, 7e-3), (-3e-3, 3e-3), (-9.0, 9.0), (-9.0, 9.0))]
        got = oracle.calc_seed(p.seed, *pt)
        want = jax_oracle.calc_seed(pj.seed, *pt)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(nx=3, ny=2, na=2, nb=2, nv=3, N=4),
    dict(nx=3, ny=2, na=2, nb=2, nv=2, seeded=True, non_uniform_gain=0.8)])
def test_oracle_images_bitwise(kw):
    pj = jax_synthetic(rng=5, **kw)
    method = 2 if kw.get("seeded") else 1
    img, ang = oracle_images(problem_from_jax(pj), method)
    img_j, ang_j = jax_oracle_images(pj, method)
    assert np.array_equal(img, img_j) and np.array_equal(ang, ang_j)
    assert np.abs(img).sum() > 0


def test_oracle_images_failure_returns_none():
    pj = jax_synthetic(nx=2, ny=2, na=2, nb=2, nv=2)
    pj.euv_beam.a = pj.euv_beam.a + 1500.0  # perpendicular rays
    assert oracle_images(problem_from_jax(pj), 1) == (None, None)
    assert jax_oracle_images(pj, 1) == (None, None)


# -- the port's tensor interp against the port's oracle (tests/test_interp.py)

def test_find_first_single_matches_oracle():
    rng = np.random.default_rng(0)
    grid = np.sort(rng.random(37))
    ys = np.concatenate([rng.random(100), grid[[0, 5, 36]],
                         [grid[0] - 1, grid[-1] + 1]])
    got = interp.find_first_single(torch.as_tensor(grid), torch.as_tensor(ys))
    want = [oracle.find_first_single(grid, y) for y in ys]
    assert np.array_equal(got.numpy(), want)


def test_find_index_matches_oracle():
    rng = np.random.default_rng(1)
    grid = np.sort(rng.random(106))
    ys = np.concatenate([rng.random(200) * 1.2 - 0.1, grid[[0, 50, 105]]])
    got = interp.find_index(torch.as_tensor(grid), torch.as_tensor(ys))
    want = [oracle.find_index(grid, y) for y in ys]
    assert np.array_equal(got.numpy(), want)


def test_pchip_matches_oracle():
    rng = np.random.default_rng(2)
    xi = np.sort(rng.random(25)) * 10
    yi = np.cumsum(rng.normal(size=25))
    g1, g2 = interp.pchip_coefficients(xi, yi)
    xs = np.concatenate([rng.uniform(-1, 11, 300), xi])
    got = interp.pchip_eval(*(torch.as_tensor(v) for v in (xi, yi, g1, g2,
                                                           xs)))
    want = np.array([oracle.interp_pchip(xi, yi, x) for x in xs])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_interp_linear():
    xi = torch.tensor([0.0, 1.0, 3.0], dtype=torch.float64)
    yi = torch.tensor([0.0, 2.0, 4.0], dtype=torch.float64)
    got = interp.interp_linear(xi, yi, torch.tensor([0.5, 2.0, -1.0, 4.0],
                                                    dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), [1.0, 3.0, -2.0, 5.0])


def test_interp_linear_matches_mathlib():
    """The tensor version against the host one on random grids, queries
    beyond both ends included (1e-15 relative: the same operations)."""
    rng = np.random.default_rng(6)
    xi = np.sort(rng.random(19)) * 4
    yi = rng.normal(size=19)
    xs = np.concatenate([rng.uniform(-1, 5, 200), xi])
    got = interp.interp_linear(*(torch.as_tensor(v) for v in (xi, yi, xs)))
    np.testing.assert_allclose(got.numpy(), mathlib.interp_linear(xi, yi, xs),
                               rtol=1e-15, atol=1e-15)
