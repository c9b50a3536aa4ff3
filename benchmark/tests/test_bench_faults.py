"""A run with the timed path broken underneath comes out not correct: the
harness is driven on the CPU (its look for a card skipped) through the
program's plain twins at a tiny size, with one fault planted in the
program's entry for each kind of fault the cell can have."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import harness

SEED = 2**31 + 77


def _stale(mp, module, name):
    """Every call returns the images of the process's first call (a state
    left unchanged: the tables of later calls never used)."""
    inner = getattr(module, name)
    first = []

    def call(*args, **kwargs):
        out = inner(*args, **kwargs)
        if not first:
            first.append(out)
        return first[0]
    mp.setattr(module, name, call)


def _stale_stream(mp, module, name):
    inner = getattr(module, name)
    first = []

    def stream(*args, **kwargs):
        for out in inner(*args, **kwargs):
            if not first:
                first.append(out)
            yield first[0]
    mp.setattr(module, name, stream)


def _altered_stream(mp, module, name):
    inner = getattr(module, name)

    def stream(*args, **kwargs):
        for image, i_ang in inner(*args, **kwargs):
            image = image.copy()
            image[np.argmax(image)] *= 1.0 + 1e-6
            yield image, i_ang
    mp.setattr(module, name, stream)


def _half(mp, module, name):
    """Half of the rays left out (every other one), the sums doubled to
    stand for the whole."""
    inner = getattr(module, name)

    def call(problem, *args, **kwargs):
        problem.N_parallel = 2 * problem.N_parallel
        image, i_ang = inner(problem, *args, **kwargs)
        return 2.0 * image, 2.0 * i_ang
    mp.setattr(module, name, call)


def _altered(mp, module, name):
    """One answer altered where it is produced: the brightest image element
    off by one part in a million."""
    inner = getattr(module, name)

    def call(*args, **kwargs):
        image, i_ang = inner(*args, **kwargs)
        image = image.copy()
        image[np.argmax(image)] *= 1.0 + 1e-6
        return image, i_ang
    mp.setattr(module, name, call)


def _exchange(mp, collectives):
    """The exchange between the cards left out: the first entry's partial
    stands for the sum."""
    mp.setattr(collectives, "sum_reduce", lambda parts: parts[0].clone())


def _plant(mp, name, fault):
    from raytrace_tpu_torch.models import ray_tracer
    from raytrace_tpu_torch.parallel import collectives, sharding

    if name == "seeded-small-stream":
        target = (ray_tracer, "create_image_stream")
        return {"stale": _stale_stream,
                "altered": _altered_stream}[fault](mp, *target)
    elif name == "ase-scale64-mesh4":
        target = (sharding, "create_image_sharded")
        if fault == "exchange":
            return _exchange(mp, collectives)
    else:
        target = (ray_tracer, "create_image")
    {"stale": _stale, "half": _half, "altered": _altered}[fault](mp, *target)


CASES = [("ase-small-sync", f) for f in ("stale", "half", "altered")] + \
    [("seeded-sync", f) for f in ("stale", "half", "altered")] + \
    [("ase-scale64-mesh4", f) for f in ("stale", "half", "exchange",
                                        "altered")] + \
    [("seeded-small-stream", f) for f in ("stale", "altered")]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault, tiny, monkeypatch):
    cell = tiny(name, check_calls=3)
    _plant(monkeypatch, name, fault)
    out = harness.run_cell(cell, SEED, 1.5, False, "cpu")
    assert out["attempted"] >= 2
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["ase-small-sync", "seeded-sync",
                                  "ase-scale64-mesh4",
                                  "seeded-small-stream"])
def test_unbroken_is_correct(name, tiny):
    out = harness.run_cell(tiny(name, check_calls=3), SEED, 1.5, False,
                           "cpu")
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["checks"]["image_rel_l2"]["value"] < 1e-13


def test_traced_run_leaves_the_program_as_it_was(tiny):
    from raytrace_tpu_torch.models import ray_tracer

    before = ray_tracer.prepare_pipeline
    out = harness.run_cell(tiny("ase-small-sync"), SEED, 0.4, True, "cpu")
    assert out["correct"] and "prepare.host_ms" in out["metrics"]
    assert ray_tracer.prepare_pipeline is before


def test_stream_with_the_reorder_is_correct(tiny):
    cell = tiny("seeded-small-stream", check_calls=3)
    cell["traffic_spec"]["reorder"] = True
    out = harness.run_cell(cell, SEED, 3.0, False, "cpu")
    assert out["correct"] and out["attempted"] >= 3, out["checks"]
