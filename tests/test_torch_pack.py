"""A call's tables written straight into their buffer, on the CPU.

* ``problem.write_tables`` writes, over every field of the layout, the bytes
  its plain twin ``pack_arrays(table_arrays(...))`` packs: on the
  benchmark's ASE and seeded units at their full widths, on a unit whose
  segments differ in Nx and Ny (padded), on one without emissivity, and
  into a buffer that holds other bytes first (0xFF, or another unit's
  tables), so that every padded cell's zero is written;
* ``problem.table_layout``, from the shapes alone, is the layout
  ``pack_arrays`` gives the same tables;
* the choice of a call's buffer (``ray_tracer._pack`` and
  ``_GraphPipeline``, on stand-in graphs: a graph needs a card): a pack
  goes straight into the staging buffer of a graph that is neither in
  flight nor held by a prepared call, and holds it as long as its buffer
  lives; else into a fresh buffer, which a graph captured for the call
  copies; a replay takes the graph that holds its buffer, else a free one,
  never a graph another call holds; one ``pack`` region a call, the layout
  in it. The graphs themselves are tested on the card
  (tests/test_torch_kernels_cuda.py).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import units
from raytrace_tpu_torch.models import problem as pr
from raytrace_tpu_torch.models import ray_tracer
from raytrace_tpu_torch.testing import perturbed_problems, synthetic_problem
from raytrace_tpu_torch.utils.timer import profiler

ROOT = Path(__file__).resolve().parents[1]
_GRAPH = ray_tracer._Graph


def _bench_unit(config):
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{config}.json")
                     .read_text())
    return units.to_program(units.base_unit(cfg))


def _cut(g, nx, ny):
    """Segment ``g`` cut to its first ``nx`` x ``ny`` grid cells."""
    Nx, Ny = g.Nx, g.Ny
    for k in ("n", "g0", "E0", "gv0"):
        a = getattr(g, k)
        if a is not None:
            setattr(g, k, np.asarray(a).reshape(Ny, Nx)[:ny, :nx].reshape(-1))
    g.gv = np.asarray(g.gv).reshape(Ny, Nx, -1)[:ny, :nx].reshape(-1)
    g.x, g.y = g.x[:nx], g.y[:ny]


def _ragged(seeded=False, rng=0):
    """A unit whose segments differ in Nx and in Ny."""
    p = synthetic_problem(seeded=seeded, rng=rng)
    _cut(p.gain[1], 20, 12)
    _cut(p.gain[2], 30, 7)
    return p


def _no_emissivity():
    p = _ragged()
    for g in p.gain:
        g.E0 = None
    return p


UNITS = {
    "ase": lambda: _bench_unit("ase"),
    "seeded": lambda: _bench_unit("seeded"),
    "ragged": _ragged,
    "no-emissivity": _no_emissivity,
}


def _tables(p):
    return (p.gain, p.euv_beam, ray_tracer._source_beam(p), p.seed)


def _assert_fields_equal(got, want, layout):
    g, w = np.asarray(got), np.asarray(want)
    for name, off, dtype, shape in layout:
        end = off + int(np.prod(shape)) * dtype.itemsize
        assert np.array_equal(g[off:end], w[off:end]), name


@pytest.mark.parametrize("unit,before", [
    ("ase", "zeros"), ("seeded", "zeros"), ("ragged", "zeros"),
    ("no-emissivity", "zeros"), ("ragged", "0xff"), ("ragged", "reused")])
def test_writer_bytes_are_the_twins(unit, before):
    """``write_tables`` against ``pack_arrays(table_arrays(...))`` over every
    field of the layout, into a zeroed buffer, one of 0xFF bytes, or one
    that holds another unit's tables of the same shapes."""
    p = UNITS[unit]()
    want, layout = pr.pack_arrays(pr.table_arrays(*_tables(p)))
    buf = torch.full((pr.layout_nbytes(layout),),
                     0xFF if before == "0xff" else 0, dtype=torch.uint8)
    if before == "reused":
        other, = perturbed_problems(_ragged, 1, salt=5)
        pr.write_tables(pr.table_views(buf, layout), *_tables(other))
        with pytest.raises(AssertionError, match="gain.g0"):
            _assert_fields_equal(buf, want, layout)
    pr.write_tables(pr.table_views(buf, layout), *_tables(p))
    _assert_fields_equal(buf, want, layout)


@pytest.mark.parametrize("case", list(UNITS))
def test_layout_from_shapes(case):
    """``table_layout`` reads shapes alone and gives the layout, and
    ``layout_nbytes`` the size, of the twin's packed buffer."""
    p = UNITS[case]()
    want, want_layout = pr.pack_arrays(pr.table_arrays(*_tables(p)))
    layout = pr.table_layout(*_tables(p))
    assert layout == want_layout
    assert pr.layout_nbytes(layout) == want.numel()


def _stand_in_graph(layout, in_flight=False, buf=None):
    """A ``_Graph`` with a staging buffer (a copy of ``buf``, else zeros)
    and its views, and no CUDA graph behind it."""
    g = object.__new__(_GRAPH)
    g.in_flight, g.claim = in_flight, None
    g.staging = torch.zeros(pr.layout_nbytes(layout), dtype=torch.uint8)
    if buf is not None:
        g.staging.copy_(buf)
    g.views = pr.table_views(g.staging, layout)
    return g


def _stand_in_pipeline(monkeypatch, *in_flight, unit=None):
    """A graph pipeline, for the tables of ``unit``, of stand-in graphs
    whose replays (the graph) and captures (``"capture"``) are recorded in
    ``pipe.log``."""
    layout = pr.table_layout(*_tables(unit or _ragged()))
    pipe = ray_tracer._GraphPipeline({"device": torch.device("cpu"),
                                      "pack_layout": layout})
    pipe.graphs = [_stand_in_graph(layout, f) for f in in_flight]
    pipe.log = []

    def replay(self, buf, prev=None):
        pipe.log.append(self)
        self.in_flight = True
        return self

    def capture(cfg, buf):
        pipe.log.append("capture")
        return _stand_in_graph(layout, buf=buf)

    monkeypatch.setattr(_GRAPH, "replay", replay)
    monkeypatch.setattr(ray_tracer, "_Graph", capture)
    monkeypatch.setattr(ray_tracer, "_evict", lambda dev, keep: None)
    return pipe


def test_claim_holds_a_free_graph_while_its_buffer_lives(monkeypatch):
    """A claim takes the staging buffer of a graph neither in flight nor
    claimed, as a new tensor over it; the graph stays claimed while that
    tensor lives, and is free again once it is dropped (a prepared call
    dropped undispatched keeps nothing)."""
    pipe = _stand_in_pipeline(monkeypatch, True, False)
    busy, idle = pipe.graphs
    buf, views = pipe.claim()
    assert buf is not idle.staging and idle.holds(buf)
    assert views is idle.views
    assert not idle.free() and pipe.claim() is None
    del buf
    assert idle.free() and not busy.free()
    assert idle.holds(pipe.claim()[0])


def test_replay_takes_its_own_graph_or_a_free_one(monkeypatch):
    """A call replays the graph that holds its buffer (no copy), and when
    that graph is in flight a free one; a buffer of no graph goes to a free
    graph, never to one that a live prepared call holds."""
    pipe = _stand_in_pipeline(monkeypatch, False, False, False)
    a, b, c = pipe.graphs
    held, _ = pipe.claim()
    assert a.holds(held)
    foreign = torch.ones_like(a.staging)
    assert pipe(foreign) is b
    assert pipe(held) is a
    assert pipe(held) is c      # its own graph is in flight
    assert pipe.log == [b, a, c]


def test_capture_copies_a_fresh_buffer(monkeypatch):
    """With every graph taken, a call's tables go to a fresh buffer
    (``pack.direct`` 0); the graph captured for the call copies them into a
    staging buffer of its own, which no call holds: once out of flight, the
    next call's tables go straight into it."""
    p, q = perturbed_problems(_ragged, 2, salt=7)
    layout = pr.table_layout(*_tables(p))
    pipe = _stand_in_pipeline(monkeypatch, True, unit=p)
    dev = torch.device("cpu")
    profiler.reset()
    buf = ray_tracer._write(p, ray_tracer._source_beam(p), dev, layout, pipe)
    g = pipe(buf)
    assert pipe.log == ["capture", g] and pipe.graphs[-1] is g
    assert not g.holds(buf) and torch.equal(g.staging, buf)
    g.in_flight = False
    assert g.free()
    held = ray_tracer._write(q, ray_tracer._source_beam(q), dev, layout, pipe)
    assert g.holds(held) and not g.free()
    assert profiler.totals["pack.direct"] == 1.0
    assert profiler.counts["pack.direct"] == 2


@pytest.mark.parametrize("where", ["mesh", "graph", "prepare"])
def test_pack_records_direct(monkeypatch, where):
    """The tables, the twin's bytes, of a mesh's ``_pack`` (a fresh buffer,
    ``pack.direct`` 0), of ``_write`` into a free graph's staging buffer
    (``pack.direct`` 1), and of ``prepare_pipeline`` on the CPU (a fresh
    buffer, one ``pack`` region a call, the layout worked out in it, and
    the layout in ``cfg``): one ``pack.direct`` a call, and one
    ``pack.bytes``, the size of the buffer the layout gives."""
    p, q = perturbed_problems(_ragged, 2, salt=3)
    layout = pr.table_layout(*_tables(p))
    dev = torch.device("cpu")
    pipe = None
    if where == "graph":
        pipe = _stand_in_pipeline(monkeypatch, False, unit=p)
    profiler.reset()
    for unit in (p, q):
        src = ray_tracer._source_beam(unit)
        if where == "mesh":
            buf, got = ray_tracer._pack(unit, src, dev)
            assert got == layout
        elif where == "graph":
            buf = ray_tracer._write(unit, src, dev, layout, pipe)
            assert pipe.graphs[0].holds(buf)
        else:
            prep = ray_tracer.prepare_pipeline(unit, "cpu", device=dev)
            assert prep.cfg["pack_layout"] == tuple(layout)
            buf, = prep.operands
        want, _ = pr.pack_arrays(pr.table_arrays(*_tables(unit)))
        _assert_fields_equal(buf, want, layout)
        del buf
    assert profiler.counts["pack.direct"] == 2
    assert profiler.totals["pack.direct"] == (2.0 if pipe else 0.0)
    assert profiler.counts["pack.bytes"] == 2
    assert profiler.totals["pack.bytes"] == 2 * pr.layout_nbytes(layout)
    assert profiler.counts["pack"] == (0 if pipe else 2)
