"""CreateImage benchmark CLI (``src/CreateImage.cpp``), single process.

Usage (the reference flags, Readme.txt:42-59 / CreateImageHelpers.h:50-96):

    python -m raytrace_tpu_torch.utils.cli [options] file1.dat [file2.dat ...]
      -methods=cuda,cpu    methods to benchmark (default: every method this
                           host runs -- cpu, plus cuda with a CUDA device).
                           cuda runs the CUDA kernels, cpu their plain
                           PyTorch twins on the CPU; the reference's method
                           names are accepted as aliases
      -iterations=N        timed calls per method (default 5)
      -scale=S             problem-size scale factor (default 1.0)
      -profile             trace the timed calls with torch.profiler and
                           print device time per kernel and the device's
                           busy share of the timed wall time
      -stream=N            also time serving mode: N work units with
                           distinct gain tables (perturbed copies of the
                           file, as production changes the tables every
                           iteration) through create_image_stream, two
                           rounds. Adds a "<method>+stream" row (round wall
                           / N, pipeline fill included) and a
                           "<method>+stream.steady" row (spacing of the
                           yields after the first, pipeline full); no golden
                           check (the tables are perturbed). The reference
                           has no such mode: its harness times synchronous
                           calls
      -reorder             with -stream: sort each call's rays by the
                           previous call's per-ray micro-step counts (the
                           cost-feedback reorder; rows "+stream+reorder")

Per file and method: a warmup call (it also builds the kernels; the
reference's GPU warmup fixture, CreateImage.cpp:118-132), ``iterations``
timed calls, the Avg/Min/Max/StdDev table, the golden check when
scale == 1, and the timing-stability gates. Exit code = number of errors.
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager

import numpy as np
import torch

from raytrace_tpu_torch.io.loader import load_input
from raytrace_tpu_torch.models.ray_tracer import (available_methods,
                                                  create_image,
                                                  create_image_stream,
                                                  resolve_method)
from raytrace_tpu_torch.testing import time_stream_detailed
from raytrace_tpu_torch.utils.stats import (TimingStats, check_ans,
                                            stability_errors)
from raytrace_tpu_torch.utils.timer import profiler

__all__ = ["main", "Options", "run_tests"]


class Options:
    """Command-line options (Options::read_cmd, CreateImageHelpers.h:56-95)."""

    def __init__(self, argv):
        self.methods: list[str] = []
        self.iterations = 5
        self.scale = 1.0
        self.profile = False
        self.stream = 0
        self.reorder = False
        self.files: list[str] = []
        for arg in argv:
            if arg.startswith("-methods="):
                self.methods = [m for m in arg.split("=", 1)[1].split(",")
                                if m]
            elif arg.startswith("-iterations="):
                self.iterations = int(arg.split("=", 1)[1])
            elif arg.startswith("-scale="):
                self.scale = float(arg.split("=", 1)[1])
            elif arg == "-profile":
                self.profile = True
            elif arg.startswith("-stream="):
                self.stream = int(arg.split("=", 1)[1])
            elif arg == "-reorder":
                self.reorder = True
            elif arg.startswith("-"):
                raise SystemExit(f"Unknown option: {arg}")
            else:
                self.files.append(arg)
        if self.reorder and self.stream <= 0:
            raise SystemExit("-reorder requires -stream=N (it reorders the "
                             "serving stream's rays)")


@contextmanager
def _maybe_profile(enabled: bool, device):
    if not enabled:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


def _print_profile(prof, wall_s: float, calls: int, top: int = 12) -> None:
    """Time per kernel per call, and the device's busy share of the wall
    time. On a CUDA device the rows are the device kernels; on the CPU they
    are the operators' own CPU time."""
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if kernels:
        rows, key, what = kernels, "self_device_time_total", "device"
    else:
        rows, key, what = list(events), "self_cpu_time_total", "CPU"
    rows = sorted(rows, key=lambda e: getattr(e, key), reverse=True)
    total_us = sum(getattr(e, key) for e in rows)
    print(f"  profile: {what} time {total_us / 1e3 / calls:.3f} ms/call "
          f"of {wall_s * 1e3 / calls:.3f} ms/call wall (busy share "
          f"{total_us / 1e6 / wall_s:.3f})")
    for e in rows[:top]:
        print(f"    {getattr(e, key) / 1e3 / calls:10.3f} ms/call "
              f"{e.count / calls:7.1f}x  {e.key[:100]}")


def _stream_rows(filename, options, label, method, device, rows) -> int:
    """Time ``options.stream`` distinct-table units through
    create_image_stream (two rounds); append the per-call and steady rows.
    Returns the number of non-finite results."""
    n_bad = 0

    def make_stream(units):
        nonlocal n_bad
        for image, i_ang in create_image_stream(units, method, device,
                                                reorder=options.reorder):
            n_bad += not (np.isfinite(image).all()
                          and np.isfinite(i_ang).all())
            yield image, i_ang

    per_call, detail = time_stream_detailed(filename, options.stream, 2,
                                            make_stream, scale=options.scale)
    tag = "+stream+reorder" if options.reorder else "+stream"
    rows.append((f"{label}{tag}", TimingStats.of(per_call)))
    yields = [y for d in detail for y in d["yield_s"]]
    if yields:
        rows.append((f"{label}{tag}.steady", TimingStats.of(yields)))
    return n_bad


def run_tests(filename: str, options: Options) -> int:
    """Benchmark one input file (run_tests, CreateImage.cpp:84-190)."""
    print(f"\nRunning tests for {filename}\n")
    methods = options.methods or available_methods()
    n_errors = 0
    problem, image0, i_ang0 = load_input(filename, options.scale)
    rows = []
    for requested in methods:
        method, device = resolve_method(requested)
        label = requested if requested == method else f"{requested}->{method}"
        print(f"Running {label} on {device}")
        create_image(problem, method, device)  # warmup (builds the kernels)
        times = []
        with _maybe_profile(options.profile, device) as prof:
            for _ in range(options.iterations):
                t0 = time.perf_counter()
                image, i_ang = create_image(problem, method, device)
                times.append(time.perf_counter() - t0)
        if prof is not None:
            _print_profile(prof, sum(times), options.iterations)
        stats = TimingStats.of(times)
        rows.append((label, stats))
        if options.scale == 1.0 and image0 is not None:
            if not check_ans(image0, i_ang0, image, i_ang):
                n_errors += 1
        n_errors += stability_errors(stats)
        if options.stream > 0:
            n_errors += _stream_rows(filename, options, label, method,
                                     device, rows)

    w = max(14, max((len(r[0]) for r in rows), default=14))
    print(f"\n{'METHOD':>{w}s} {'Avg':>8s} {'Min':>8s} {'Max':>8s} "
          f"{'Std Dev':>9s}")
    for label, stats in rows:
        print(f"{label:>{w}s} {stats.avg:8.3f} {stats.min:8.3f}"
              f" {stats.max:8.3f} {stats.std:9.3f}")
    return n_errors


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    options = Options(argv)
    if not options.files:
        print(__doc__)
        return 1
    n_errors = 0
    for filename in options.files:
        n_errors += run_tests(filename, options)
    if n_errors == 0:
        print("\nAll tests passed")
    else:
        print(f"\nSome tests failed ({n_errors} errors)")
    print("\n" + profiler.summary())
    return min(n_errors, 255)


if __name__ == "__main__":
    raise SystemExit(main())
