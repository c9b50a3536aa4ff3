"""The deposit (plain twin of CUDA kernel B2) and the binning index math
against the JAX package. JAX accumulates its deposits in f32, the port in
f64, hence 1e-6 relative; get_index is exact f64 math on both sides."""

import numpy as np
import pytest
import torch

import raytrace_tpu  # noqa: F401  (JAX package: x64 + CPU config)
import jax
import jax.numpy as jnp
from raytrace_tpu.ops import binning as jax_binning
from raytrace_tpu.ops.deposit_kernel import deposit_tiles
from raytrace_tpu.testing import synthetic_problem

from raytrace_tpu_torch.models.problem import prepare_beam
from raytrace_tpu_torch.ops import binning, deposit_kernel
from raytrace_tpu_torch.ops.deposit_kernel import deposit_plain

torch.set_num_threads(2)


def _inputs(B, K, C, seed):
    rng = np.random.default_rng(seed)
    contrib = rng.random((B, K)).astype(np.float32)
    bins = rng.integers(0, C + 1, B).astype(np.int32)  # C = trash bin
    return contrib, bins


def _plain(contrib, bins, C):
    out = torch.zeros((C, contrib.shape[1]), dtype=torch.float64)
    return deposit_plain(out, torch.from_numpy(contrib.astype(np.float64)),
                         torch.from_numpy(bins)).numpy()


@pytest.mark.parametrize("K,C", [(10, 50), (1, 37)])
def test_deposit_vs_pallas_interpret(K, C):
    contrib, bins = _inputs(2048, K, C, 0)
    want = np.asarray(deposit_tiles(jnp.asarray(contrib), jnp.asarray(bins),
                                    C + 1, interpret=True))[:C]
    got = _plain(contrib, bins, C)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("K,C", [(10, 50), (1, 37)])
def test_deposit_vs_segment_sum(K, C):
    contrib, bins = _inputs(3000, K, C, 1)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(contrib),
                                          jnp.asarray(bins),
                                          num_segments=C + 1))[:C]
    got = _plain(contrib, bins, C)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_deposit_adds_in_place_and_skips_trash():
    contrib, bins = _inputs(500, 4, 9, 2)
    out = torch.ones((9, 4), dtype=torch.float64)
    res = deposit_kernel.deposit(out, torch.from_numpy(
        contrib.astype(np.float64)), torch.from_numpy(bins))
    assert res is out
    want = 1.0 + np.stack([contrib[bins == c].astype(np.float64).sum(0)
                           for c in range(9)])
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-12)


def test_deposit_wrapper_checks_inputs():
    out = torch.zeros((4, 3), dtype=torch.float64)
    with pytest.raises(ValueError):
        deposit_kernel.deposit(out, torch.zeros((5, 3), dtype=torch.float32),
                               torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError):
        deposit_kernel.deposit(out, torch.zeros((5, 3), dtype=torch.float64),
                               torch.zeros(5, dtype=torch.int64))


@pytest.mark.parametrize("full_plane", [False, True])
def test_get_index_matches_jax(full_plane):
    p = synthetic_problem(nx=9, ny=6, na=7, nb=5, full_plane=full_plane)
    b = p.euv_beam
    jb = raytrace_tpu.models.problem.prepare_beam(b)
    tb = prepare_beam(b)
    rng = np.random.default_rng(4)
    for grid, d, jg, tg in ((b.x, b.dx, jb.x, tb.x), (b.y, b.dy, jb.y, tb.y),
                            (b.a, b.da, jb.a, tb.a), (b.b, b.db, jb.b, tb.b)):
        lo, hi = grid[0] - d, grid[-1] + d
        # random points, the grid points, the half-cell edges and beyond
        ys = np.concatenate([rng.uniform(lo, hi, 400), grid,
                             grid - 0.5 * d, grid + 0.5 * d, [lo, hi]])
        ys32 = ys.astype(np.float32)  # rays bin f32 coordinates
        want = np.asarray(jax_binning.get_index(jg, d, jnp.asarray(ys32)))
        got = binning.get_index(tg, d, torch.from_numpy(ys32)).numpy()
        np.testing.assert_array_equal(got, want)
