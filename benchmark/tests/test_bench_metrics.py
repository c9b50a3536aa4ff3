"""Each metric file's operation and byte counts against a hand count on a
tiny unit, the trace reduction on a made-up trace, and the readers on
made-up views."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import devtrace, harness, peaks, units


def _reader(name):
    return harness.load_reader(name)


ASE = units.synthetic_unit()               # 8x5x5x4 rays, nv 6, 30x12 grid
SEEDED = units.synthetic_unit(seeded=True)  # 10x5x6x5 rays


def test_tiny_units():
    assert units.ray_count(ASE) == 800 and units.ray_count(SEEDED) == 1500


def test_trace_counts():
    tr = _reader("trace_roofline")
    # per segment: f64 grids 8*(30+12), f32 widths 4*(29+11), n/g0/E0
    # 3*4*360, gradients 4*(29*12+30*11), extents 16, flag 1, sizes 8
    assert tr.table_bytes(ASE) == 3 * (336 + 160 + 4320 + 2712 + 25)
    assert tr.call_bytes(ASE, 800) == 800 * 16 + 22659 + 800 * (72 + 16 + 2)
    assert tr.call_ops(ASE, 1000, 200) == (1000 * 81 + 200 * 48, 200 * 28)
    assert tr.call_ops(SEEDED, 1000, 200) == (1000 * 81 + 200 * 36, 200 * 28)


def test_deposit_bytes():
    dep = _reader("deposit_roofline")
    grids = 8 * (8 + 5 + 5 + 4 + 6)
    image = 8 * (8 * 5 * 6 + 5 * 4)
    assert dep.call_bytes(ASE, 800) == 800 * (8 * 6 + 17) + grids + image
    assert dep.call_bytes(SEEDED, 1500) == 1500 * 65 + grids + image


def test_amplify_counts():
    amp = _reader("amplify_roofline")
    # K 6, T 6, tables of segments 1..2: 2 * 360 cells of 6 f32
    assert amp.call_bytes(ASE, 800) == 800 * 6 * 12 + 4 * 720 * 6 + 800 * 48
    assert amp.call_f64_ops(ASE, 800) == 800 * 6 * 6 * 8
    b3 = 1500 * 48 + 1500 * 48 + 1500 * 10 + 48 + 4 * 720 * 6
    assert amp.call_bytes(SEEDED, 1500) == b3 + 1500 * 8
    assert amp.call_f64_ops(SEEDED, 1500) == 1500 * 6 * 15 + 1500 * 5


def test_bound():
    assert peaks.bound_s(3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(0, f32_ops=67e12, f64_ops=34e12) == \
        pytest.approx(2.0)
    assert peaks.share(1.0, 4.0) == 25.0 and peaks.share(1.0, None) is None


def _trace():
    def x(cat, name, ts, dur, dev=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if dev is not None:
            e["args"] = {"device": dev}
        return e

    return {"traceEvents": [
        x("user_annotation", "bench.stretch", 100, 1000),
        x("user_annotation", "bench.call", 120, 680),
        x("user_annotation", "bench.prepare", 400, 250),
        x("kernel", "(anonymous namespace)::trace_kernel("
                    "(anonymous namespace)::TraceArgs)", 150, 150, 0),
        x("kernel", "void (anonymous namespace)::bin_deposit_kernel("
                    "(anonymous namespace)::DepositArgs)", 250, 150, 0),
        x("kernel", "void at::native::vectorized_elementwise_kernel<4, "
                    "at::native::FillFunctor<float>>(int, float)", 600, 100,
          0),
        x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 900, 50, 0),
        x("kernel", "(anonymous namespace)::trace_kernel(x)", 50, 2000, 1),
        x("kernel", "(anonymous namespace)::trace_kernel(x)", 5000, 10, 0),
    ]}


def test_reduce_trace():
    tr = devtrace.reduce_trace(_trace(), [0, 1])
    assert tr["window_s"] == pytest.approx(1e-3)
    assert tr["busy_s"] == pytest.approx([400e-6, 1000e-6])
    assert tr["kernel_s"] == pytest.approx({
        "trace_kernel": 150e-6 + 1000e-6, "void bin_deposit_kernel": 150e-6,
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::FillFunctor<float>>": 100e-6})
    assert tr["copy_s"] == pytest.approx({"Memcpy HtoD ": 50e-6})
    gaps = [(n, round(s * 1e6)) for n, s in tr["gaps"]]
    assert gaps == [("call", 50), ("prepare", 200), ("call", 200),
                    ("outside", 150)]
    assert devtrace.reduce_trace({"traceEvents": []}, [0]) is None


def test_kernel_base():
    assert devtrace.kernel_base("void bin_deposit_kernel") == \
        "bin_deposit_kernel"
    assert devtrace.kernel_base(
        "void at::native::vectorized_elementwise_kernel<4, at::") == \
        "vectorized_elementwise_kernel"


def test_union_and_gaps():
    busy, gaps = devtrace.union_and_gaps([(5, 8), (0, 2), (1, 3)], 0, 10)
    assert busy == 6 and gaps == [(3, 5), (8, 10)]


def _view(**kw):
    run = SimpleNamespace(base=ASE, rays=800, attempted=10, failed=0,
                          latencies=[0.01 * (i + 1) for i in range(20)])
    view = dict(run=run, setup_s=5.0, window_s=2.0, peak_reserved_bytes=0,
                timer=dict(totals={}, counts={}), counts={}, trace=None,
                traced_calls=0)
    view.update(kw)
    return view


def test_end_to_end_readers():
    v = _view()
    assert _reader("rays_per_s").read(v) == 10 * 800 / 2.0
    assert _reader("call_p95_s").read(v) == pytest.approx(0.1905)
    v["run"].latencies = v["run"].latencies[:19]
    assert _reader("call_p95_s").read(v) is None
    assert _reader("setup_s").read(v) == 5.0
    assert _reader("peak_reserved_gib").read(v) is None
    assert _reader("peak_reserved_gib").read(
        _view(peak_reserved_bytes=3 << 30)) == 3.0


def test_prepare_reader():
    v = _view(timer=dict(totals={"create_image": 0.5,
                                 "propagate_ASE-cuda": 0.3},
                         counts={"create_image": 100,
                                 "propagate_ASE-cuda": 100}))
    assert _reader("prepare.host_ms").read(v) == pytest.approx(2.0)
    assert _reader("prepare.host_ms").read(_view()) is None


def test_device_readers():
    tr = devtrace.reduce_trace(_trace(), [0, 1])
    v = _view(trace=tr, traced_calls=2,
              counts=dict(steps=1000, cells=200, rays=800, failed=0))
    assert _reader("device.idle_share").read(v) == pytest.approx(30.0)
    trace = _reader("trace_roofline")
    f32, f64 = trace.call_ops(ASE, 1000, 200)
    want = peaks.bound_s(trace.call_bytes(ASE, 800), f32, f64)
    assert trace.read(v) == pytest.approx(100 * want / (1150e-6 / 2))
    dep = _reader("deposit_roofline")
    assert dep.read(v) == pytest.approx(
        100 * peaks.bound_s(dep.call_bytes(ASE, 800)) / (150e-6 / 2))
    amp = _reader("amplify_roofline")
    assert amp.read(v) == pytest.approx(100 * peaks.bound_s(
        amp.call_bytes(ASE, 800), f64_ops=amp.call_f64_ops(ASE, 800))
        / (100e-6 / 2))
    for name in ("trace_roofline", "deposit_roofline", "amplify_roofline",
                 "device.idle_share"):
        assert _reader(name).read(_view()) is None


def test_reservoir_deterministic():
    def draw(seed):
        r = harness.Reservoir(3, seed)
        for i in range(100):
            r.offer(i)
        return sorted(r.items)

    assert draw(2**31 + 3) == draw(2**31 + 3)
    assert len(set(draw(5))) == 3
    assert any(draw(s) != draw(5) for s in (6, 7, 8))
