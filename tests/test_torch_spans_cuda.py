"""The program's spans on the card: the mesh's ``mesh.reduce`` read from
the call's own reduction marks (what ``sharding.timeline`` reads), no
device synchronise inside any span of a steady call (the readback's event
is waited on in ``wait`` alone), and no ``capture`` once a config's graph
is built.

Marked ``gpu``; each test skips without a CUDA device (decided inside the
test). This file imports no JAX. On a machine with the card:

    python -m pytest --noconftest tests/test_torch_spans_cuda.py -q
"""

import pytest
import torch

from raytrace_tpu_torch import create_image, create_image_stream
from raytrace_tpu_torch.models import ray_tracer
from raytrace_tpu_torch.parallel import sharding
from raytrace_tpu_torch.parallel.mesh import make_mesh
from raytrace_tpu_torch.testing import synthetic_problem
from raytrace_tpu_torch.utils.timer import profiler

pytestmark = pytest.mark.gpu

SPANS = ("prepare", "pack", "dispatch", "capture", "wait", "finalize")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs and events of a call")
    profiler.reset()
    yield torch.device("cuda", 0)
    profiler.reset()


def _mesh():
    """Two entries: the first two cards, or two entries on the one card."""
    return make_mesh(devices=("cuda:0", "cuda:1")
                     if torch.cuda.device_count() >= 2
                     else ("cuda:0", "cuda:0"))


def test_mesh_reduce_is_the_timeline(cuda, tmp_path):
    runner = sharding.MeshRunner(_mesh(), "cuda")
    for i in range(4):
        profiler.reset()
        call = runner.dispatch(synthetic_problem(rng=i))
        sharding._finalize_sharded(call, str(tmp_path / "failed.dat"))
        ms = sharding.timeline(call)["reduce_ms"]
        assert profiler.counts["mesh.reduce"] == 1
        assert 1e3 * profiler.totals["mesh.reduce"] == pytest.approx(
            ms, rel=1e-12)
        assert ms > 0.0


def _entries(mesh):
    """Each public entry once, on fresh units."""
    def single():
        create_image(synthetic_problem(rng=7), "cuda")

    def stream():
        list(create_image_stream(
            [synthetic_problem(rng=i) for i in range(3)], "cuda", depth=2))

    def sharded():
        sharding.create_image_sharded(synthetic_problem(rng=8), mesh, "cuda")

    return single, stream, sharded


def test_no_synchronise_inside_a_span(cuda, monkeypatch):
    """Steady calls (their graphs built by a first round): no
    ``torch.cuda.synchronize`` while a span is open, and every wait on a
    CUDA event inside ``wait``."""
    entries = _entries(_mesh())
    for run in entries:
        run()
    seen = []
    real_sync = torch.cuda.synchronize
    real_event = torch.cuda.Event.synchronize

    def sync(device=None):
        seen.append(("synchronize", frozenset(profiler._open)))
        real_sync(device)

    def event_sync(self):
        seen.append(("event", frozenset(profiler._open)))
        real_event(self)

    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", event_sync)
    profiler.reset()
    for run in entries:
        run()
    assert profiler.counts["capture"] == 0
    assert profiler.counts["wait"] == 5
    assert not [s for kind, s in seen
                if kind == "synchronize" and s & set(SPANS)]
    events = [s & set(SPANS) for kind, s in seen if kind == "event"]
    assert events and all(s == {"wait"} for s in events), events


def test_second_call_captures_nothing(cuda):
    ray_tracer.clear_pipeline_cache()
    create_image(synthetic_problem(rng=1), "cuda")
    assert profiler.counts["capture"] == 1
    create_image(synthetic_problem(rng=2), "cuda")
    assert profiler.counts["capture"] == 1
    assert profiler.counts["dispatch"] == 2 and profiler.counts["wait"] == 2
