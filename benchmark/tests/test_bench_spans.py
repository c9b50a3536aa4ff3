"""The readers of the program's spans: ``spans.idle_under`` on a made-up
Chrome trace (partial overlaps, spans outside the stretch, two spans of
one name, two cards averaged), each new reader on made-up views with its
None cases, and a tiny traced run of each cell on the CPU."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness, spans

SEED = 2**31 + 91
HOST_MS = ("pack.host_ms", "dispatch.host_ms", "wait.host_ms")
IDLE = ("prepare.idle_share", "dispatch.idle_share", "wait.idle_share",
        "finalize.idle_share")


def _x(cat, name, ts, dur, dev=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if dev is not None:
        e["args"] = {"device": dev}
    return e


def _trace():
    """The stretch is [100, 1100] us. Card 0 is busy [200, 400],
    [600, 700] and [1050, 1100] (clipped), idle [100, 200], [400, 600] and
    [700, 1050]; card 1 busy [150, 900], idle [100, 150] and [900, 1100].
    ``prepare`` runs [50, 250] (clipped to [100, 250]), [500, 650] and
    [550, 800] (one union, [500, 800]) and [2000, 2100] (outside);
    ``dispatch`` [200, 400], under both cards' work."""
    return {"traceEvents": [
        _x("user_annotation", "bench.stretch", 100, 1000),
        _x("user_annotation", "bench.call", 120, 900),
        _x("user_annotation", "prepare", 50, 200),
        _x("user_annotation", "prepare", 500, 150),
        _x("user_annotation", "prepare", 550, 250),
        _x("user_annotation", "prepare", 2000, 100),
        _x("user_annotation", "dispatch", 200, 200),
        # the profiler's mirror of an annotation on the device timeline:
        # neither a host span nor device work
        _x("gpu_user_annotation", "prepare", 100, 1000, 0),
        _x("kernel", "trace_kernel(x)", 200, 200, 0),
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 600, 100, 0),
        _x("kernel", "bin_deposit_kernel(x)", 1050, 150, 0),
        _x("kernel", "trace_kernel(x)", 150, 750, 1),
        _x("kernel", "trace_kernel(x)", 100, 1000, 2),  # not a run's card
        _x("kernel", "trace_kernel(x)", 5000, 10, 0),   # after the stretch
    ]}


def test_idle_under_by_length():
    # card 0: 100 + 100 + 100 us idle under prepare; card 1: 50 us
    assert spans.idle_under(_trace(), [0, 1], "prepare") == \
        pytest.approx(100 * (300 + 50) / 2 / 1000)
    assert spans.idle_under(_trace(), [0], "prepare") == pytest.approx(30.0)
    assert spans.idle_under(_trace(), [1], "prepare") == pytest.approx(5.0)
    # two spans of one name that overlap inside one idle interval count
    # their union once: card 0 [700, 1000], card 1 [900, 1000]
    tr = _trace()
    tr["traceEvents"] += [_x("user_annotation", "finalize", 700, 200),
                          _x("user_annotation", "finalize", 750, 250)]
    assert spans.idle_under(tr, [0, 1], "finalize") == \
        pytest.approx(100 * (300 + 100) / 2 / 1000)


def test_idle_under_zero_and_none():
    # ran, and the card never idled under it: a real reading
    assert spans.idle_under(_trace(), [0, 1], "dispatch") == 0.0
    # no span of the name in the stretch
    assert spans.idle_under(_trace(), [0, 1], "wait") is None
    outside = _trace()
    outside["traceEvents"].append(_x("user_annotation", "wait", 3000, 10))
    assert spans.idle_under(outside, [0, 1], "wait") is None
    # no card, no device interval in the stretch (the CPU), no stretch
    assert spans.idle_under(_trace(), [], "prepare") is None
    assert spans.idle_under(_trace(), [3], "prepare") is None
    host_only = {"traceEvents": [e for e in _trace()["traceEvents"]
                                 if e["cat"] == "user_annotation"]}
    assert spans.idle_under(host_only, [0], "prepare") is None
    assert spans.idle_under({"traceEvents": []}, [0], "prepare") is None
    assert spans.idle_under(None, [0], "prepare") is None


def test_idle_under_adds_up_to_the_idle_share():
    """Spans that tile the stretch put all of a card's idle time down."""
    tr = _trace()
    tr["traceEvents"] += [_x("user_annotation", "wait", 100, 500),
                          _x("user_annotation", "wait", 600, 500)]
    assert spans.idle_under(tr, [0], "wait") == pytest.approx(65.0)
    assert spans.idle_under(tr, [1], "wait") == pytest.approx(25.0)


def _view(timer=None, data=None, on_card=True):
    run = SimpleNamespace(
        on_card=on_card, devices=[SimpleNamespace(index=0),
                                  SimpleNamespace(index=1)],
        capture=None if data is False else SimpleNamespace(data=data))
    return dict(run=run, timer=timer or dict(totals={}, counts={}))


@pytest.mark.parametrize("metric", HOST_MS + ("mesh.reduce_ms",))
def test_span_ms_readers(metric):
    name = metric.split(".host_ms")[0].replace("reduce_ms", "reduce")
    read = harness.load_reader(metric).read
    v = _view(dict(totals={name: 0.006, "other": 1.0},
                   counts={name: 3, "other": 1}))
    assert read(v) == pytest.approx(2.0)
    assert read(_view()) is None
    assert read(_view(dict(totals={"other": 1.0}, counts={"other": 1}))) \
        is None


def test_graph_captures_reader():
    read = harness.load_reader("graph.captures").read
    assert read(_view(dict(totals={"dispatch": 1.0},
                           counts={"dispatch": 5}))) == 0
    assert read(_view(dict(totals={}, counts={"dispatch": 5,
                                              "capture": 2}))) == 2
    # a program without the spans, or an empty window
    assert read(_view()) is None


@pytest.mark.parametrize("metric", IDLE)
def test_idle_readers(metric):
    read = harness.load_reader(metric).read
    name = metric.split(".")[0]
    tr = _trace()
    for sp in ("wait", "finalize"):
        tr["traceEvents"].append(_x("user_annotation", sp, 700, 100))
    want = {"prepare": 17.5, "dispatch": 0.0, "wait": 5.0, "finalize": 5.0}
    assert read(_view(data=tr)) == pytest.approx(want[name])
    assert read(_view(data=tr, on_card=False)) is None
    assert read(_view(data=None)) is None
    assert read(_view(data=False)) is None


@pytest.mark.parametrize("name", ["ase-small-sync", "ase-scale64-mesh4",
                                  "seeded-small-stream"])
def test_traced_cpu_run_reports_the_spans(name, tiny):
    """On the CPU a traced run reads the program's spans and no card: the
    host-ms readers report, ``graph.captures`` reads 0 (the twins build no
    graph), and the idle readers and ``mesh.reduce_ms`` report nothing."""
    out = harness.run_cell(tiny(name), SEED, 0.4, True, "cpu")
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for metric in HOST_MS:
        assert got[metric]["value"] > 0.0 and got[metric]["unit"] == "ms"
    assert got["graph.captures"] == {"value": 0, "unit": "count"}
    assert not set(got) & set(IDLE + ("mesh.reduce_ms",))
