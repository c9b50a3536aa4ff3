"""The f32-spectrum cell ``ase-f32-small-stream``: its readers' counts by
hand at the cell's shape and against the f32 amplify's own arithmetic, the
readers on made-up views and on the CPU, the bfloat16 control, and planted
faults at a tiny size."""

from __future__ import annotations

import collections
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import control_bf16, harness, peaks, units
from benchmark.tests.test_bench_faults import _stale_stream

CELL = "ase-f32-small-stream"
SEED = 2**31 + 91
NEW = ("amplify_f32_roofline", "deposit_f32_roofline", "amplify_f32.kernels")


def _reader(name):
    return harness.load_reader(name)


def _base():
    return units.base_unit(harness.load_cell(CELL)["config_spec"])


def test_cell_shape():
    cell = harness.load_cell(CELL)
    assert cell["config_spec"]["spectrum_dtype"] == "float32"
    assert cell["config_spec"]["shape"] == harness.load_cell(
        "ase-small-sync")["config_spec"]["shape"]
    assert units.ray_count(_base()) == 399000
    assert {m["name"] for m in cell["end_to_end"]} >= {
        "rays_per_s", "peak_reserved_gib", "setup_s"}
    per_layer = {m["name"] for m in cell["per_layer"]}
    assert set(NEW) <= per_layer
    assert not per_layer & {"amplify_roofline", "deposit_roofline"}


def test_amplify_f32_counts_at_the_cell():
    amp, base = _reader("amplify_f32_roofline"), _base()
    # K 52, T 6, tables of segments 1..2: 2 * 106 * 26 cells of 52 f32
    assert amp.call_bytes(base, 399000) == (399000 * 6 * 12
                                            + 4 * 5512 * 52
                                            + 399000 * 52 * 4)
    assert amp.call_bytes(base, 399000) == 112866496
    assert amp.call_f32_ops(base, 399000) == 399000 * 6 * (52 * 62 + 1)
    # the operations bound it: 0.1152 ms against 0.0337 ms of bytes
    assert peaks.bound_s(amp.call_bytes(base, 399000),
                         f32_ops=amp.call_f32_ops(base, 399000)) == \
        pytest.approx(7720650000 / 67e12)


def test_deposit_f32_bytes_at_the_cell():
    dep = _reader("deposit_f32_roofline")
    grids = 8 * (60 + 25 + 19 + 14 + 52)
    outputs = 8 * (60 * 25 * 52 + 19 * 14)
    assert dep.call_bytes(_base(), 399000) == \
        399000 * (4 * 52 + 17) + grids + outputs == 90402488
    # the f64 reader's count reads 8 bytes a spectrum element
    assert _reader("deposit_roofline").call_bytes(_base(), 399000) - \
        dep.call_bytes(_base(), 399000) == 399000 * 52 * 4


class _Count(torch.utils._python_dispatch.TorchDispatchMode):
    """Floating-point adds, subtractions, products, quotients and roundings
    by output shape."""

    ARITH = {"add", "sub", "rsub", "mul", "div", "round"}

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func.overloadpacket.__name__ in self.ARITH
                and out.dtype.is_floating_point):
            self.n[tuple(out.shape)] += 1
        return out


def test_amplify_f32_ops_are_the_stated_arithmetic():
    """The plain f32 amplify computes every branch on every element: the
    counted closed-form path (62), the Taylor branch (12) and expm1's other
    branch (1); and ``gvl``'s low part once a ray and sub-length."""
    from raytrace_tpu_torch.ops import spectrum
    from raytrace_tpu_torch.ops.stepper import TraceResult

    amp = _reader("amplify_f32_roofline")
    B, K = 7, 5
    g = torch.Generator().manual_seed(3)
    res = TraceResult(
        gvl=0.5 * torch.rand(B, 2, 3, generator=g),
        evl=torch.rand(B, 2, 3, generator=g),
        ivl=torch.randint(0, 4, (B, 2, 3), dtype=torch.int32, generator=g),
        exit_x=None, exit_y=None, exit_a=None, exit_b=None, escaped=None,
        perp=None)
    with _Count() as c:
        spectrum.amplify(res, torch.zeros(B, K), torch.rand(2, 4, K,
                                                            generator=g),
                         3, torch.float32)
    assert set(c.n) == {(B, K), (B, 1)}
    assert c.n[(B, K)] == 6 * (amp.OPS_ELEMENT + 12 + 1)
    assert c.n[(B, 1)] == 6 * amp.OPS_RAY_SUB


def _trace():
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {"device": 0}}

    ew = ("void at::native::vectorized_elementwise_kernel<4, "
          "at::native::MulFunctor<float>>(int, float)")
    return {"traceEvents": [
        x("user_annotation", "bench.stretch", 100, 1000),
        x("kernel", "(anonymous namespace)::trace_kernel(TraceArgs)", 110,
          100),
        x("kernel", ew, 300, 100), x("kernel", ew, 450, 50),
        x("kernel", "void at::native::index_elementwise_kernel<128, 4>(int)",
          520, 30),
        x("kernel", "void (anonymous namespace)::bin_deposit_f32_kernel<4>("
                    "DepositArgs, int)", 600, 40),
        x("kernel", ew, 50, 40), x("kernel", ew, 1150, 10),
    ]}


def _view(dtype="float32", trace=True):
    from benchmark import devtrace

    data = _trace()
    run = SimpleNamespace(base=units.synthetic_unit(), rays=800,
                          config={"spectrum_dtype": dtype},
                          capture=SimpleNamespace(data=data if trace
                                                  else None))
    return dict(run=run, trace=devtrace.reduce_trace(data, [0])
                if trace else None, traced_calls=2 if trace else 0)


def test_readers_on_a_made_up_trace():
    v = _view()
    amp = _reader("amplify_f32_roofline")
    unit = v["run"].base
    want = peaks.bound_s(amp.call_bytes(unit, 800),
                         f32_ops=amp.call_f32_ops(unit, 800))
    # the elementwise kernels inside the stretch: 100 + 50 + 30 us, the one
    # that starts before it clipped to 0 (it ends at 90)
    assert amp.read(v) == pytest.approx(100 * want / (180e-6 / 2))
    dep = _reader("deposit_f32_roofline")
    assert dep.read(v) == pytest.approx(
        100 * peaks.bound_s(dep.call_bytes(unit, 800)) / (40e-6 / 2))
    assert _reader("amplify_f32.kernels").read(v) == 3 / 2


@pytest.mark.parametrize("name", NEW)
def test_readers_return_none_without_an_f32_trace(name):
    reader = _reader(name)
    assert reader.read(_view(trace=False)) is None
    assert reader.read(_view(dtype="float64")) is None


def test_readers_return_none_on_the_cpu(tiny):
    out = harness.run_cell(tiny(CELL), SEED, 0.5, True, "cpu")
    assert out["correct"], out["checks"]
    assert not set(NEW) & set(out["metrics"])
    assert "pack.host_ms" in out["metrics"]


def test_bf16_rounding():
    x = np.array([1.0, 1.0 + 2.0**-9, 1.0 + 3 * 2.0**-9, -3.0e-30, 0.0])
    got = control_bf16.bf16(x)
    assert got.dtype == np.float64
    assert list(got[:3]) == [1.0, 1.0, 1.0 + 2.0**-7]
    assert abs(got[3] / x[3] - 1.0) <= 2.0**-9 and got[4] == 0.0


def test_control_fails_program_passes(tiny):
    cell = tiny(CELL)
    limits = cell["limits"]
    before = harness.Run.done
    sound = control_bf16.readings(cell, SEED, 0.3, False, device="cpu")
    assert sound["correct"] and sound["side"] == "program", sound
    assert all(sound[k] <= v / 10 for k, v in limits.items() if v)
    control = control_bf16.readings(cell, SEED + 1, 0.3, True, device="cpu")
    assert not control["correct"] and control["side"] == "control", control
    assert control["failed"] == 0
    assert all(control[k] > 10 * v for k, v in limits.items() if v)
    assert harness.Run.done is before


def _half_stream(mp, module, name):
    """Half of the rays of every unit left out (every other one), the sums
    doubled to stand for the whole."""
    inner = getattr(module, name)

    def stream(problems, *args, **kwargs):
        def halved():
            for p in problems:
                p.N_parallel = 2 * p.N_parallel
                yield p
        for image, i_ang in inner(halved(), *args, **kwargs):
            yield 2.0 * image, 2.0 * i_ang
    mp.setattr(module, name, stream)


@pytest.mark.parametrize("fault", ["stale", "half"])
def test_fault_is_not_correct(fault, tiny, monkeypatch):
    from raytrace_tpu_torch.models import ray_tracer

    {"stale": _stale_stream, "half": _half_stream}[fault](
        monkeypatch, ray_tracer, "create_image_stream")
    out = harness.run_cell(tiny(CELL, check_calls=3), SEED, 1.5, False,
                           "cpu")
    assert out["attempted"] >= 2
    assert not out["correct"], out["checks"]


@pytest.mark.gpu
def test_traced_run_on_the_card():
    """A short traced run of the cell on the card: correct, and the three
    readers read values, no share above 100%. Needs a CUDA device; it
    decides inside the test."""
    import json
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELL,
         "--seed", "2147483711", "--seconds", "2", "--trace", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert set(NEW) <= set(metrics)
    for name in ("amplify_f32_roofline", "deposit_f32_roofline"):
        assert 0 < metrics[name]["value"] <= 100
    assert metrics["amplify_f32.kernels"]["value"] >= 1
