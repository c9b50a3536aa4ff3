"""The program's host spans (``utils.timer.Profiler.span``) on the CPU,
through the plain twins: one of each boundary a call (``prepare``,
``pack``, ``dispatch``, ``wait``, ``finalize``), N of each in a stream of
N units, one of each in a sharded call, none left open by a call whose
rays fail; the spans as ``torch.profiler`` annotations while a profiler
records and no annotation without one; and no stop of the program's own
regions that passes a device (which would synchronise it)."""

import contextlib

import pytest
import torch

from raytrace_tpu_torch import create_image, create_image_stream
from raytrace_tpu_torch.parallel.mesh import make_mesh
from raytrace_tpu_torch.parallel.sharding import create_image_sharded
from raytrace_tpu_torch.testing import synthetic_problem
from raytrace_tpu_torch.utils import timer
from raytrace_tpu_torch.utils.errors import RayTraceError
from raytrace_tpu_torch.utils.timer import profiler

torch.set_num_threads(2)

SMALL = dict(nx=6, ny=4, na=4, nb=3, nv=5)
#: the spans every finalized call counts once, in the order a call runs them
CALL_SPANS = ("prepare", "pack", "dispatch", "wait", "finalize")
#: every span and value the program records
NAMES = CALL_SPANS + ("capture", "mesh.reduce")


def _counts():
    return {n: profiler.counts.get(n, 0) for n in NAMES}


def _want(n):
    return {**{s: n for s in CALL_SPANS}, "capture": 0, "mesh.reduce": 0}


@pytest.fixture(autouse=True)
def fresh_profiler():
    profiler.reset()
    yield
    profiler.reset()


def _single(p, **kw):
    return create_image(p, "cpu", **kw)


def _sharded(p, **kw):
    return create_image_sharded(p, make_mesh(devices=("cpu", "cpu")), "cpu",
                                **kw)


CALLS = {"single": _single, "sharded": _sharded}


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("entry", sorted(CALLS))
def test_one_of_each_a_call(entry, seeded):
    """One call, single or on a two-entry CPU mesh (whose tables are
    packed once), counts one of each span, no capture and, off the card,
    no ``mesh.reduce``."""
    CALLS[entry](synthetic_problem(seeded=seeded, **SMALL))
    assert _counts() == _want(1)
    assert not profiler._open


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("mesh", [None, ("cpu", "cpu")])
def test_n_of_each_a_stream(depth, mesh):
    n = 3
    units = [synthetic_problem(seeded=i % 2 == 1, rng=i, **SMALL)
             for i in range(n)]
    got = list(create_image_stream(
        units, "cpu", depth=depth,
        mesh=None if mesh is None else make_mesh(devices=mesh)))
    assert len(got) == n
    assert _counts() == _want(n)
    assert profiler.counts["create_image_stream"] == 1


def _failing(seeded):
    p = synthetic_problem(seeded=seeded, **SMALL)
    beam = p.seed_beam if seeded else p.euv_beam
    beam.a = beam.a + 1500.0  # tan(1.5 rad): s_z^2 < 0.01, error -1
    return p


@pytest.mark.parametrize("entry", sorted(CALLS))
def test_failed_rays_leave_no_span_open(entry, tmp_path):
    """A call whose rays fail raises from its ``finalize``; every span of
    it is closed and counted, and the next call counts one more of each."""
    dump = str(tmp_path / "failed.dat")
    with pytest.raises(RayTraceError):
        CALLS[entry](_failing(False), failed_ray_path=dump)
    assert not set(profiler._open) & set(NAMES)
    assert _counts() == _want(1)
    CALLS[entry](synthetic_problem(**SMALL), failed_ray_path=dump)
    assert not set(profiler._open) & set(NAMES)
    assert _counts() == _want(2)


def test_invalid_input_closes_prepare():
    """A problem that fails validation raises inside ``prepare``: the span
    is closed and counted, and no later span ran."""
    p = synthetic_problem(**SMALL)
    p.euv_beam.x = p.euv_beam.x ** 3 + 1.0  # not uniform
    with pytest.raises(RayTraceError):
        create_image(p, "cpu")
    assert not set(profiler._open) & set(NAMES)
    assert _counts() == {**_want(0), "prepare": 1}


def _intervals(events, name):
    return [(e.time_range.start, e.time_range.end) for e in events
            if e.name == name]


@pytest.mark.parametrize("entry", sorted(CALLS))
def test_annotations_while_a_profiler_records(entry):
    """Under a recording CPU ``torch.profiler`` each span of a call is one
    annotation of its name; ``pack`` lies inside ``prepare``; the four
    host boundaries follow one another without overlap."""
    p = synthetic_problem(**SMALL)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as tp:
        CALLS[entry](p)
    events = tp.events()
    spans = {n: _intervals(events, n) for n in CALL_SPANS}
    assert all(len(v) == 1 for v in spans.values()), spans
    (p0, p1), (k0, k1) = spans["prepare"][0], spans["pack"][0]
    assert p0 <= k0 <= k1 <= p1
    order = [spans[n][0] for n in ("prepare", "dispatch", "wait",
                                   "finalize")]
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))
    assert _counts() == _want(1)


def test_no_annotation_without_a_profiler(monkeypatch):
    """With no profiler recording, a span never opens ``record_function``
    (patched here to raise), and every span is still counted."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _single(synthetic_problem(**SMALL))
    list(create_image_stream([synthetic_problem(**SMALL)] * 2, "cpu"))
    _sharded(synthetic_problem(**SMALL))
    assert _counts() == _want(4)


def test_program_stops_pass_no_device(monkeypatch):
    """The program's own regions (``create_image``, its method region,
    ``create_image_stream``, ``create_image-sharded``) close after the
    call's own wait, and stop with no device: no synchronise."""
    seen = []
    real = profiler.stop

    def stop(name, device=None):
        seen.append((name, device))
        real(name)

    monkeypatch.setattr(profiler, "stop", stop)
    _single(synthetic_problem(**SMALL))
    list(create_image_stream([synthetic_problem(**SMALL)] * 2, "cpu"))
    _sharded(synthetic_problem(**SMALL))
    assert {n for n, _ in seen} == {"create_image", "propagate_ASE-cpu",
                                    "create_image_stream",
                                    "create_image-sharded"}
    assert [d for _, d in seen] == [None] * len(seen)


def test_span_records_a_body_that_raises():
    prof = timer.Profiler()
    with pytest.raises(ValueError):
        with prof.span("finalize"):
            raise ValueError
    assert prof.counts["finalize"] == 1 and not prof._open
    with prof.span("finalize"):
        assert "finalize" in prof._open
    assert prof.counts["finalize"] == 2 and prof.totals["finalize"] >= 0.0
    assert prof.span("finalize") is prof.span("finalize")


def test_span_never_synchronises(monkeypatch):
    def refuse(device=None):
        raise AssertionError("a span synchronised a device")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    prof = timer.Profiler()
    with prof.span("wait"):
        pass
    assert dict(prof.counts) == {"wait": 1}


def test_span_annotation_closes_when_the_body_raises():
    prof = timer.Profiler()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as tp:
        with contextlib.suppress(KeyError):
            with prof.span("dispatch"):
                raise KeyError
        with prof.span("wait"):
            torch.ones(8).sum()
    names = [e.name for e in tp.events()]
    assert names.count("dispatch") == 1 and names.count("wait") == 1
    assert dict(prof.counts) == {"dispatch": 1, "wait": 1}


def test_add_and_disabled():
    prof = timer.Profiler()
    prof.add("mesh.reduce", 0.25)
    prof.add("mesh.reduce", 0.5)
    assert prof.totals["mesh.reduce"] == 0.75
    assert prof.counts["mesh.reduce"] == 2
    prof.enabled = False
    prof.add("mesh.reduce", 1.0)
    with prof.span("prepare"):
        pass
    assert dict(prof.counts) == {"mesh.reduce": 2}
    # the summary lists the spans and values as it lists the scopes
    assert "mesh.reduce" in prof.summary()
