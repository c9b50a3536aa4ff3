"""The port's ``create_image_stream`` and cost-feedback reorder on the CPU
(the plain twins), mirroring tests/test_create_image.py's stream tests and
tests/test_reorder.py.

* The stream yields exactly the per-call results, in order; ``depth``
  bounds the dispatched-but-unread calls; a failure surfaces at its own
  yield position with the dump written.
* The reorder's permutations equal ``raytrace_tpu``'s on the same inputs;
  the dispatch visits each chunk's rays in that order and hands this call's
  counts on in natural order; all-zero feedback is the natural order,
  bitwise the synchronous call; reordered calls match the synchronous ones
  to 1e-12 (per-ray results do not depend on the order, only the f64
  deposit sums do).
* The stream against ``raytrace_tpu.create_image_stream`` (lax-exact):
  relative L2 below 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

import raytrace_tpu
import jax.numpy as jnp
from raytrace_tpu.models import ray_tracer as jax_rt
from raytrace_tpu.testing import synthetic_problem as jax_synthetic

from raytrace_tpu_torch import create_image, create_image_stream
from raytrace_tpu_torch.models import ray_tracer
from raytrace_tpu_torch.ops import stepper
from raytrace_tpu_torch.testing import (perturbed_problems, synthetic_problem,
                                        time_stream_detailed,
                                        time_stream_rounds)
from raytrace_tpu_torch.utils.errors import RayTraceError, read_failures

torch.set_num_threads(2)

SMALL = dict(nx=8, ny=5, na=5, nb=4, nv=6)

#: the reordered calls sum the same f64 deposits in another order
_REORDER_TOL = 1e-12


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _units(n, salt, **kw):
    """n same-shape units with distinct gain tables."""
    return perturbed_problems(functools.partial(synthetic_problem, **kw), n,
                              salt=salt)


def _mixed(i):
    return synthetic_problem(nx=5, ny=4, na=3, nb=3, nv=4,
                             seeded=i % 2 == 1, rng=100 + i)


def test_stream_matches_per_call():
    """Mixed ASE/seeded units with ragged chunks: the stream's yields equal
    create_image's results exactly, and are stored on each problem."""
    want = [create_image(_mixed(i), "cpu", chunk_size=70) for i in range(4)]
    probs = [_mixed(i) for i in range(4)]
    got = list(create_image_stream(probs, "cpu", chunk_size=70))
    assert len(got) == 4
    for i, ((gi, ga), (wi, wa)) in enumerate(zip(got, want)):
        assert np.array_equal(gi, wi) and np.array_equal(ga, wa), i
        assert probs[i].image is gi and probs[i].I_ang is ga


def test_stream_depth_one_empty_and_zero():
    assert list(create_image_stream([], "cpu")) == []
    want = create_image(_mixed(3), "cpu")
    (img, ang), = create_image_stream([_mixed(3)], "cpu", depth=1)
    assert np.array_equal(img, want[0]) and np.array_equal(ang, want[1])
    with pytest.raises(RayTraceError):
        list(create_image_stream([_mixed(3)], "cpu", depth=0))


def test_stream_failure_at_its_position(tmp_path):
    """A failing call raises at its own yield; the one before it is still
    delivered, and the dump names rays of the failing unit."""
    good = _mixed(0)
    bad = _mixed(2)
    bad.euv_beam.a = bad.euv_beam.a + 1500.0  # s_z^2 < 0.01 -> error -1
    dump = tmp_path / "failed.dat"
    gen = create_image_stream([good, bad], "cpu", failed_ray_path=str(dump))
    img, _ = next(gen)
    assert np.isfinite(img).all()
    with pytest.raises(RayTraceError):
        next(gen)
    rays, method, N, _dz, _gains = read_failures(str(dump))
    assert method == 1 and N == bad.N and 1 <= rays.shape[0] <= 32
    assert np.all(np.isin(rays[:, 2].astype(np.float32),
                          bad.euv_beam.a.astype(np.float32)))


def test_stream_depth_bounds_dispatch(monkeypatch):
    """With depth=2 the first yield comes after exactly 2 dispatches (each
    unit prepared once, as raytrace_tpu's stream prepares it)."""
    calls = []
    real = ray_tracer.prepare_pipeline

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ray_tracer, "prepare_pipeline", counting)
    probs = [synthetic_problem(nx=4, ny=3, na=2, nb=2, nv=3, rng=i)
             for i in range(4)]
    gen = create_image_stream(probs, "cpu", depth=2)
    next(gen)
    assert len(calls) == 2
    rest = list(gen)
    assert len(calls) == 4 and len(rest) == 3


def test_window_perm_matches_jax():
    rng = np.random.default_rng(3)
    for n, w in ((20, 8), (24, 8), (1000, 256), (7, 16)):
        costs = rng.integers(0, 50, size=n).astype(np.int32)
        want = np.asarray(jax_rt._window_perm(jnp.asarray(costs), w))
        got = ray_tracer._window_perm(torch.from_numpy(costs), w).numpy()
        assert np.array_equal(got, want)
    zeros = ray_tracer._window_perm(torch.zeros(24, dtype=torch.int32), 8)
    assert np.array_equal(zeros.numpy(), np.arange(24))


@pytest.mark.parametrize("full_plane", [False, True])
def test_reorder_perm_matches_jax(full_plane):
    """The (fetch row, cost) sort, its all-zero identity and the row-free
    fallback, on a real problem's row geometry and a ragged stride chunk."""
    p = synthetic_problem(full_plane=full_plane, **SMALL)
    pj = jax_synthetic(full_plane=full_plane, **SMALL)
    row = ray_tracer.reorder_row_geom(p)
    assert row == jax_rt.reorder_row_geom(pj)
    src = p.euv_beam
    dims = (src.nx, src.ny, src.na, src.nb)
    grid_y = np.asarray(src.y, np.float64).astype(np.float32)
    ijkm = np.arange(3, 800, 2)  # a stride worker's rays
    rng = np.random.default_rng(9)
    for costs in (rng.integers(1, 300, size=ijkm.size).astype(np.int32),
                  np.zeros(ijkm.size, np.int32)):
        for r in (row, None):
            cfg = dict(dims=dims, reorder_row=r)
            want = np.asarray(jax_rt.reorder_perm(
                cfg, jnp.asarray(costs), jnp.asarray(ijkm),
                (None, jnp.asarray(grid_y), None, None)))
            got = ray_tracer.reorder_perm(r, dims, torch.from_numpy(costs),
                                          torch.from_numpy(ijkm),
                                          torch.from_numpy(grid_y)).numpy()
            assert np.array_equal(got, want)
    assert np.array_equal(ray_tracer.reorder_perm(
        row, dims, torch.zeros(ijkm.size, dtype=torch.int32),
        torch.from_numpy(ijkm), torch.from_numpy(grid_y)).numpy(),
        np.arange(ijkm.size))


def test_reorder_dispatch_follows_feedback(monkeypatch):
    """Given feedback counts, each chunk's rays are traced in reorder_perm's
    order, and the feedback left behind is this call's counts in natural
    order (the twin's counts on the natural ray list)."""
    p = synthetic_problem(**SMALL)
    src = p.euv_beam
    dims = (src.nx, src.ny, src.na, src.nb)
    B, chunk = 800, 300
    rng = np.random.default_rng(11)
    prev = torch.from_numpy(rng.integers(0, 500, B).astype(np.int32))
    given = prev.clone()
    seen = []
    real = stepper.trace_batch_plain

    def recording(rays, *a, **kw):
        seen.append(rays["y"].clone())
        return real(rays, *a, **kw)

    monkeypatch.setattr(stepper, "trace_batch_plain", recording)
    prep = ray_tracer._prepare(p, "cpu", torch.device("cpu"), chunk, 0.5,
                               reorder=True, eager=True)
    call = prep.pipeline(*prep.operands, given)
    assert torch.equal(given, prev)
    grid_y = torch.from_numpy(np.asarray(src.y).astype(np.float32))
    row = ray_tracer.reorder_row_geom(p)
    for ci, start in enumerate(range(0, B, chunk)):
        n = min(chunk, B - start)
        nat = torch.arange(start, start + n)
        perm = ray_tracer.reorder_perm(row, dims, prev[start:start + n], nat,
                                       grid_y)
        j = ray_tracer._unflatten_rays(nat[perm], dims)[1]
        assert torch.equal(seen[ci], grid_y[j])
        assert not torch.equal(perm, torch.arange(n))
    monkeypatch.setattr(stepper, "trace_batch_plain", real)
    i, j, k, m = ray_tracer._unflatten_rays(torch.arange(B), dims)
    grids = [torch.from_numpy(np.asarray(g).astype(np.float32))
             for g in (src.x, src.y, src.a, src.b)]
    from raytrace_tpu_torch.models.problem import prepare_gain

    _, want = real({"x": grids[0][i], "y": grids[1][j], "a": grids[2][k],
                    "b": grids[3][m]}, p.N, src.dz, prepare_gain(p.gain), 1,
                   counts=True)
    assert torch.equal(call.counts, want) and want.min().item() >= 1


@pytest.mark.parametrize("seeded", [False, True])
def test_stream_reorder_matches_sync(seeded):
    """The first call (all-zero feedback) is the natural order, bitwise the
    synchronous call; later calls sort by real counts and agree to 1e-12."""
    kw = dict(SMALL, seeded=seeded)
    want = [create_image(p, "cpu", chunk_size=300) for p in _units(3, 1, **kw)]
    got = list(create_image_stream(_units(3, 1, **kw), "cpu", chunk_size=300,
                                   reorder=True))
    assert len(got) == 3
    assert np.array_equal(got[0][0], want[0][0])
    assert np.array_equal(got[0][1], want[0][1])
    for (gi, ga), (wi, wa) in zip(got, want):
        assert _rel(gi, wi) < _REORDER_TOL and _rel(ga, wa) < _REORDER_TOL


def test_stream_reorder_row_free_fallback(monkeypatch):
    """Without a readable row grid the reorder sorts by cost within windows
    and still reproduces the synchronous images."""
    monkeypatch.setattr(ray_tracer, "reorder_row_geom", lambda p: None)
    want = [create_image(p, "cpu") for p in _units(3, 21, **SMALL)]
    got = list(create_image_stream(_units(3, 21, **SMALL), "cpu",
                                   reorder=True))
    assert np.array_equal(got[0][0], want[0][0])
    for (gi, ga), (wi, wa) in zip(got, want):
        assert _rel(gi, wi) < _REORDER_TOL and _rel(ga, wa) < _REORDER_TOL


def test_reorder_stride_partition_sums_to_full():
    """Two N_start/N_parallel workers, each streaming two units with the
    reorder (the second sorted by real counts), sum to the full image."""
    full = create_image(synthetic_problem(**SMALL), "cpu")
    parts = []
    for k in range(2):
        units = []
        for _ in range(2):
            p = synthetic_problem(**SMALL)
            p.N_start, p.N_parallel = k, 2
            units.append(p)
        parts.append(list(create_image_stream(units, "cpu", chunk_size=150,
                                              reorder=True))[1])
    assert _rel(parts[0][0] + parts[1][0], full[0]) < 1e-12
    assert _rel(parts[0][1] + parts[1][1], full[1]) < 1e-12


def test_stream_vs_jax_stream():
    """Mixed units through both packages' streams: relative L2 1e-5."""
    kw = dict(nx=6, ny=4, na=4, nb=3, nv=5)
    seeded = (False, True)
    got = list(create_image_stream(
        [synthetic_problem(seeded=s, **kw) for s in seeded], "cpu"))
    want = list(raytrace_tpu.create_image_stream(
        [jax_synthetic(seeded=s, **kw) for s in seeded], "lax-exact"))
    for (gi, ga), (wi, wa) in zip(got, want):
        assert _rel(gi, wi) < 1e-5 and _rel(ga, wa) < 1e-5


def test_stream_timers():
    """time_stream_detailed/rounds over perturbed synthetic units; an empty
    stream raises ValueError (not IndexError)."""
    source = functools.partial(synthetic_problem, nx=4, ny=3, na=2, nb=2,
                               nv=3)
    per_call, detail = time_stream_detailed(
        source, 3, 2, lambda units: create_image_stream(units, "cpu"))
    assert len(per_call) == 2 and all(t > 0 for t in per_call)
    assert all(len(d["yield_s"]) == 2 and d["fill_s"] > 0 for d in detail)
    assert len(time_stream_rounds(source, 2, 1, lambda units: None)) == 1
    with pytest.raises(ValueError):
        time_stream_detailed(source, 2, 1, lambda units: iter(()))
    with pytest.raises(ValueError):
        time_stream_detailed(source, 0, 1, lambda units: iter(()))


def test_perturbed_problems_distinct_tables():
    units = _units(3, 0, **SMALL)
    base = synthetic_problem(**SMALL)
    f = [u.gain[1].g0[100] / base.gain[1].g0[100] for u in units]
    assert len(set(f)) == 3 and all(abs(x - 1) < 1e-4 for x in f)
