"""The port's timer (``raytrace_tpu_torch/utils/timer.py``) against
``raytrace_tpu.utils.timer``: ``get_time``, and ``Profiler.scope`` over the
same scripted sequence of scopes (nested, annotated, bodies that raise)
giving the same totals keys, counts and summary lines; ``annotate=True``
recording a ``torch.profiler`` event named after the scope."""

import time
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import raytrace_tpu  # noqa: F401
from raytrace_tpu.utils import timer as jax_timer

from raytrace_tpu_torch.utils import timer as port_timer

NAMES = ("create_image", "propagate_ASE-cuda", "propagate_seed-cuda",
         "Sum reduce images")


def script(seed, n=12):
    """``n`` steps of (name, nested name or None, raises) from ``seed``;
    the middle and the last step raise inside their scopes."""
    rng = np.random.default_rng(seed)
    steps = []
    for i in range(n):
        outer = NAMES[int(rng.integers(len(NAMES)))]
        inner = (NAMES[int(rng.integers(len(NAMES)))]
                 if rng.random() < 0.5 else None)
        steps.append((outer, inner if inner != outer else None,
                      i in (n // 2, n - 1)))
    return steps


def drive(module, steps, annotate=False):
    """Run ``steps`` through a fresh ``module.Profiler``'s scopes."""
    prof = module.Profiler()
    for outer, inner, raises in steps:
        try:
            with prof.scope(outer, annotate=annotate):
                if inner is not None:
                    with prof.scope(inner):
                        pass
                if raises:
                    raise ValueError(outer)
        except ValueError:
            pass
    return prof


def summary_lines(prof):
    """The summary's header and each line's region and calls."""
    head, *rows = prof.summary().splitlines()
    return head, sorted((" ".join(r.split()[:-3]), int(r.split()[-3]))
                        for r in rows)


@contextmanager
def fake_clock():
    """``time.perf_counter`` as a clock that advances 1 ms a read."""
    real, ticks = time.perf_counter, iter(range(10 ** 6))
    time.perf_counter = lambda: next(ticks) * 1e-3
    try:
        yield
    finally:
        time.perf_counter = real


def test_all_lists_equal():
    assert port_timer.__all__ == jax_timer.__all__


def test_get_time_monotonic():
    got = [port_timer.get_time() for _ in range(1000)]
    assert got[0] >= 0.0
    assert all(b >= a for a, b in zip(got, got[1:]))
    # both count from their module's import, on one clock
    assert jax_timer.get_time() >= 0.0
    assert abs(port_timer._START - jax_timer._START) < 3600.0


@pytest.mark.parametrize("annotate", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scope_totals_and_counts(seed, annotate):
    """The same keys and counts, and the same open regions after a body
    that raised (left open and unrecorded, as the JAX scope leaves it)."""
    steps = script(seed)
    j, p = (drive(m, steps, annotate) for m in (jax_timer, port_timer))
    assert set(p.totals) == set(j.totals)
    assert dict(p.counts) == dict(j.counts)
    assert set(p._open) == set(j._open)
    assert steps[-1][0] in p._open
    assert summary_lines(p) == summary_lines(j)


@pytest.mark.parametrize("seed", [3, 4])
def test_scope_summary_equal_on_one_clock(seed):
    """Read on a clock that advances alike, the totals and the whole
    summary are equal."""
    steps = script(seed)
    got = []
    for m in (jax_timer, port_timer):
        with fake_clock():
            got.append(drive(m, steps))
    j, p = got
    assert dict(p.totals) == dict(j.totals)
    assert p.summary() == j.summary()


def test_scope_passes_device_to_stop(monkeypatch):
    prof = port_timer.Profiler()
    seen = []
    monkeypatch.setattr(prof, "stop",
                        lambda name, device=None: seen.append((name, device)))
    with prof.scope("create_image", device="cpu"):
        pass
    with prof.scope("create_image-annotated", annotate=True):
        pass
    assert seen == [("create_image", "cpu"), ("create_image-annotated", None)]


def test_annotate_records_profiler_event():
    """``annotate=True`` on the CPU: ``torch.profiler`` records an event
    named after the scope, around the body's work."""
    prof = port_timer.Profiler()
    x = torch.arange(4096, dtype=torch.float64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as tp:
        with prof.scope("create_image-annotated", annotate=True,
                        device="cpu"):
            (x * x).sum()
        with prof.scope("not-annotated"):
            (x + x).sum()
    names = [e.name for e in tp.events()]
    assert names.count("create_image-annotated") == 1
    assert "not-annotated" not in names
    assert prof.counts["create_image-annotated"] == 1


def test_annotate_nvtx_only_on_cuda(monkeypatch):
    """An NVTX range is opened for a CUDA device and for no other (no NVTX
    call on the CPU)."""
    opened = []

    @contextmanager
    def fake_range(msg):
        opened.append(msg)
        yield

    monkeypatch.setattr(torch.cuda.nvtx, "range", fake_range)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    prof = port_timer.Profiler()
    with prof.scope("on-cpu", annotate=True, device="cpu"):
        pass
    with prof.scope("no-device", annotate=True):
        pass
    assert opened == []
    with prof.scope("on-cuda", annotate=True, device="cuda:0"):
        pass
    with prof.scope("on-cuda-plain", device="cuda:0"):
        pass
    assert opened == ["on-cuda"]
    assert dict(prof.counts) == {"on-cpu": 1, "no-device": 1, "on-cuda": 1,
                                 "on-cuda-plain": 1}
