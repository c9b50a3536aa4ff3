"""The port's prepared whole-call pipeline on the CPU: ``prepare_pipeline``,
``PreparedCall`` and ``_finalize_call``, against ``create_image`` and
against the JAX package's own prepare/execute split.

On the CPU the pipeline is the chunk loop run from Python (the plain
twins), the form a CUDA graph captures on the card; the graphs themselves
are tested on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).

* prepare, pipeline, finalize: bitwise ``create_image``, ASE and seeded;
* the same path within a relative L2 of 1e-5 of
  ``raytrace_tpu.models.ray_tracer.prepare_pipeline(p, "lax")`` and its
  ``_finalize_call`` on the same inputs, and ``cfg`` agreeing on ``N``,
  ``K``, ``method``, ``use_emis`` and ``dims``;
* one cached pipeline per config over units of one shape with different
  tables, each unit bitwise its own ``create_image``; the cache's key
  follows the config, its size stays bounded; ``_evict`` holds the
  graphs' pools on a card to ``GRAPH_POOL_SHARE`` (on stand-in graphs);
* ``cfg["reorder"]`` says what ran; the failure path through a prepared
  call is ``create_image``'s; the stream prepares each unit once, as the
  JAX stream does (tests/test_create_image.py:712-730);
* a sharded call's ``PreparedShardedCall`` carries ``pipeline``,
  ``operands`` and ``cfg``.
"""

import functools

import numpy as np
import pytest
import torch

from raytrace_tpu.models import ray_tracer as jax_rt
from raytrace_tpu.testing import synthetic_problem as jax_synthetic

from raytrace_tpu_torch import create_image, create_image_stream
from raytrace_tpu_torch.convert import problem_from_jax
from raytrace_tpu_torch.models import ray_tracer
from raytrace_tpu_torch.models.ray_tracer import (PreparedCall,
                                                  prepare_pipeline)
from raytrace_tpu_torch.ops import stepper
from raytrace_tpu_torch.parallel import sharding
from raytrace_tpu_torch.testing import perturbed_problems, synthetic_problem
from raytrace_tpu_torch.utils.errors import RayTraceError, read_failures

torch.set_num_threads(2)

SMALL = dict(nx=6, ny=4, na=4, nb=3, nv=5)
#: against the JAX package (its f32 spectra), as the port's other tests
JAX_REL = 1e-5


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _run(p, **kw):
    prep = prepare_pipeline(p, "cpu", **kw)
    return ray_tracer._finalize_call(p, prep, prep.pipeline(*prep.operands),
                                     "unused.dat")


@pytest.mark.parametrize("seeded", [False, True])
def test_prepared_call_is_create_image(seeded):
    prep = prepare_pipeline(synthetic_problem(seeded=seeded), "cpu")
    assert isinstance(prep, PreparedCall)
    assert isinstance(prep.pipeline, ray_tracer._EagerPipeline)
    assert prep.timer_name == ("propagate_seed-cpu" if seeded
                               else "propagate_ASE-cpu")
    p = synthetic_problem(seeded=seeded)
    got = _run(p)
    want = create_image(synthetic_problem(seeded=seeded), "cpu")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert p.image is got[0] and p.I_ang is got[1]


@pytest.mark.parametrize("seeded", [False, True])
def test_prepared_call_vs_jax_prepared_call(seeded):
    pj = jax_synthetic(seeded=seeded, **SMALL)
    prep_j = jax_rt.prepare_pipeline(pj, "lax")
    want = jax_rt._finalize_call(pj, prep_j, prep_j.pipeline(*prep_j.operands),
                                 "unused.dat")
    p = problem_from_jax(jax_synthetic(seeded=seeded, **SMALL))
    prep = prepare_pipeline(p, "cpu")
    got = ray_tracer._finalize_call(p, prep, prep.pipeline(*prep.operands),
                                    "unused.dat")
    assert _rel(got[0], np.asarray(want[0])) < JAX_REL
    assert _rel(got[1], np.asarray(want[1])) < JAX_REL
    for k in ("N", "K", "method", "use_emis", "dims"):
        assert prep.cfg[k] == prep_j.cfg[k], k


@pytest.mark.parametrize("seeded", [False, True])
def test_one_pipeline_per_config(seeded):
    """Units of one shape with different tables share the cached pipeline
    and each gives its own create_image's answer."""
    source = functools.partial(synthetic_problem, seeded=seeded, **SMALL)
    units = perturbed_problems(source, 3, salt=5)
    want = [create_image(u, "cpu")
            for u in perturbed_problems(source, 3, salt=5)]
    preps = [prepare_pipeline(u, "cpu") for u in units]
    assert all(prep.pipeline is preps[0].pipeline for prep in preps)
    for u, prep, (wi, wa) in zip(units, preps, want):
        gi, ga = ray_tracer._finalize_call(u, prep,
                                           prep.pipeline(*prep.operands),
                                           "unused.dat")
        assert np.array_equal(gi, wi) and np.array_equal(ga, wa)
    assert not np.array_equal(want[0][0], want[1][0])


def test_config_changes_the_pipeline():
    """What the call bakes in keys the cache: the chunk, c, the stride,
    the grid shapes, the beam's spacing; the table contents do not."""
    base = prepare_pipeline(synthetic_problem(**SMALL), "cpu")
    same = synthetic_problem(**SMALL)
    same.gain[1].g0 = np.asarray(same.gain[1].g0) * 2.0
    assert prepare_pipeline(same, "cpu").pipeline is base.pipeline
    strided = synthetic_problem(**SMALL)
    strided.N_start, strided.N_parallel = 1, 2
    wider = synthetic_problem(**dict(SMALL, nv=6))
    others = [prepare_pipeline(synthetic_problem(**SMALL), "cpu",
                               chunk_size=7),
              prepare_pipeline(synthetic_problem(**SMALL), "cpu", c=0.25),
              prepare_pipeline(strided, "cpu"),
              prepare_pipeline(wider, "cpu")]
    assert all(o.pipeline is not base.pipeline for o in others)
    assert others[0].cfg["n_chunks"] == -(-others[0].cfg["B_total"] // 7)


def test_cache_stays_bounded(monkeypatch):
    monkeypatch.setattr(ray_tracer, "MAX_PIPELINES", 3)
    ray_tracer.clear_pipeline_cache()
    for chunk in range(5, 11):
        prepare_pipeline(synthetic_problem(**SMALL), "cpu", chunk_size=chunk)
    assert len(ray_tracer._PIPELINE_CACHE) == 3
    ray_tracer.clear_pipeline_cache()
    assert not ray_tracer._PIPELINE_CACHE


def _stand_in_cache(monkeypatch, pools):
    """The cache filled with graph pipelines of stand-in graphs:
    ``pools`` maps a key to (device index, [(pool bytes, in flight)]),
    least recently used first. Each card holds 1,000 bytes; every
    ``empty_cache`` is counted."""
    from types import SimpleNamespace

    cache = ray_tracer._PIPELINE_CACHE.__class__()
    for key, (index, graphs) in pools.items():
        pipe = ray_tracer._GraphPipeline({"device": torch.device("cuda",
                                                                 index)})
        pipe.graphs = [SimpleNamespace(pool_bytes=b, in_flight=f)
                       for b, f in graphs]
        cache[key] = pipe
    monkeypatch.setattr(ray_tracer, "_PIPELINE_CACHE", cache)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(total_memory=1000))
    emptied = []
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: emptied.append(True))
    return cache, emptied


@pytest.mark.parametrize("case", ["under", "lru", "in_flight", "keep"])
def test_evict_counts_graph_pools(monkeypatch, case):
    """``_evict`` on stand-in graphs: the held total is the sum of the
    card's graphs' pools (another card's do not count), the least recently
    used configs' idle graphs go first until it is at most a quarter of
    the card, graphs in flight stay, ``keep`` is never dropped, and the
    cache is returned to the card only when something was dropped."""
    pools = {
        "under": {"a": (0, [(100, False)]), "b": (0, [(150, False)]),
                  "other": (1, [(900, False)])},
        "lru": {"a": (0, [(100, False)]), "b": (0, [(100, False)]),
                "c": (0, [(100, False)])},
        "in_flight": {"a": (0, [(200, True), (100, False)]),
                      "b": (0, [(50, False)])},
        "keep": {"a": (0, [(400, False)]), "b": (0, [(100, False)])},
    }[case]
    cache, emptied = _stand_in_cache(monkeypatch, pools)
    dev = torch.device("cuda", 0)
    keep = cache["a" if case == "keep" else list(pools)[-1]]
    before = ray_tracer.graph_pool_bytes(dev)
    assert before == sum(b for i, gs in pools.values() if i == 0
                         for b, _ in gs)
    ray_tracer._evict(dev, keep)
    left = {k: [g.pool_bytes for g in p.graphs] for k, p in cache.items()}
    held = ray_tracer.graph_pool_bytes(dev)
    if case == "under":
        assert left == {"a": [100], "b": [150], "other": [900]}
        assert emptied == []
        assert ray_tracer.graph_pool_bytes("cuda:1") == 900
    elif case == "lru":
        assert left == {"a": [], "b": [100], "c": [100]}
        assert held == 200 and emptied == [True]
    elif case == "in_flight":
        assert left == {"a": [200], "b": [50]}
        assert [g.in_flight for g in cache["a"].graphs] == [True]
        assert held == 250 and emptied == [True]
    else:  # over the bound with ``keep`` alone: it stays all the same
        assert left == {"a": [400], "b": []}
        assert held == 400 and emptied == [True]
    assert keep.graphs


def test_launches_follow_the_config():
    """Per call on the kernels: one B1 and one B2 a chunk, and B3 a chunk
    unless the emissivity amplify runs; none for the plain twins."""
    prep = prepare_pipeline(synthetic_problem(**SMALL), "cpu", chunk_size=9)
    assert prep.cfg["launches"] == dict(trace=0, bin_deposit=0, amplify=0,
                                        bin_deposit_f32=0, amplify_f32=0)
    assert not prep.cfg["graph"]


@pytest.mark.parametrize("reorder", [False, True])
def test_cfg_reorder_says_what_ran(monkeypatch, reorder):
    """The counts variant of the trace runs exactly when cfg says the
    reorder was built; a call with no rays builds none."""
    seen = []
    real = stepper.trace_batch_plain

    def recording(*a, **kw):
        seen.append(kw.get("counts", False))
        return real(*a, **kw)

    monkeypatch.setattr(stepper, "trace_batch_plain", recording)
    units = list(create_image_stream(
        [synthetic_problem(**SMALL) for _ in range(2)], "cpu",
        chunk_size=50, reorder=reorder))
    prep = prepare_pipeline(synthetic_problem(**SMALL), "cpu", chunk_size=50,
                            reorder=reorder)
    assert prep.cfg["reorder"] == reorder
    assert seen and all(s == reorder for s in seen)
    assert len(units) == 2
    empty = synthetic_problem(**SMALL)
    empty.N_start = 10 ** 6
    prep = prepare_pipeline(empty, "cpu", reorder=True)
    assert not prep.cfg["reorder"] and prep.cfg["n_chunks"] == 0
    image, i_ang = ray_tracer._finalize_call(
        empty, prep, prep.pipeline(*prep.operands), "unused.dat")
    assert not image.any() and not i_ang.any()


def test_failure_through_prepared_call(tmp_path):
    """The prepared path writes create_image's dump and raises."""
    dumps = []
    for how in ("prepared", "create_image"):
        p = synthetic_problem(**SMALL)
        p.euv_beam.a = p.euv_beam.a + 1500.0
        dumps.append(str(tmp_path / f"{how}.dat"))
        with pytest.raises(RayTraceError):
            if how == "prepared":
                prep = prepare_pipeline(p, "cpu")
                ray_tracer._finalize_call(p, prep,
                                          prep.pipeline(*prep.operands),
                                          dumps[-1])
            else:
                create_image(p, "cpu", failed_ray_path=dumps[-1])
    got, want = read_failures(dumps[0]), read_failures(dumps[1])
    assert len(got[0]) > 0 and np.array_equal(got[0], want[0])
    assert got[1:3] == want[1:3]


def test_stream_prepares_each_unit_once(monkeypatch):
    """depth=2: the first yield after exactly 2 prepares, 4 in all for 4
    units (raytrace_tpu's test_stream_depth_bounds_dispatch)."""
    calls = []
    real = ray_tracer.prepare_pipeline

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ray_tracer, "prepare_pipeline", counting)
    probs = [synthetic_problem(nx=4, ny=3, na=2, nb=2, nv=3, rng=i)
             for i in range(4)]
    gen = create_image_stream(probs, "cpu", chunk_size=1024, depth=2)
    next(gen)
    assert len(calls) == 2
    rest = list(gen)
    assert len(calls) == 4 and len(rest) == 3


def test_prepared_sharded_call():
    """A PreparedShardedCall's pipeline, operands and cfg: an entry
    pipeline each, one packed buffer for all, the call's cfg and each
    entry's."""
    mesh = ("cpu",) * 3
    prep = sharding.prepare_sharded(synthetic_problem(seeded=True, **SMALL),
                                    mesh, "cpu", chunk_size=40, reorder=True)
    assert len(prep.pipeline) == 3 and len(prep.operands) == 1
    assert all(isinstance(p, ray_tracer._EagerPipeline)
               for p in prep.pipeline)
    entries = prep.cfg["entries"]
    assert [e["N_start"] for e in entries] == [0, 1, 2]
    assert all(e["N_parallel"] == 3 and not e["readback"] for e in entries)
    assert prep.cfg["method"] == 2 and prep.cfg["reorder"]
    assert prep.cfg["dims"] == entries[0]["dims"]
    assert sum(e["B_total"] for e in entries) == int(np.prod(prep.cfg["dims"]))
