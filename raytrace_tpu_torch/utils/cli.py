"""CreateImage benchmark CLI (``src/CreateImage.cpp``).

Usage (the reference flags, Readme.txt:42-59 / CreateImageHelpers.h:50-96):

    python -m raytrace_tpu_torch.utils.cli [options] file1.dat [file2.dat ...]
      -methods=cuda,cpu    methods to benchmark (default: every method this
                           host runs -- cpu, plus cuda with a CUDA device).
                           cuda runs the CUDA kernels, cpu their plain
                           PyTorch twins on the CPU; the reference's method
                           names are accepted as aliases
      -iterations=N        timed calls per method (default 5)
      -scale=S             problem-size scale factor (default 1.0)
      -spectrum=f64|f32    the spectrum's precision (default f64, the
                           reference's double arithmetic, native on the
                           card). f32 is raytrace_tpu's default (its CLI
                           defaults to -spectrum=f32, since a TPU emulates
                           f64): the two-float f32 spectrum, run by the f32
                           instantiations of the amplify and deposit
                           kernels; images still accumulate in f64
      -profile             trace the timed calls with torch.profiler and
                           print device time per kernel, kernel launches
                           per call and the device's busy share of the
                           timed wall time
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
      -multichip           also run create_image_sharded over every visible
                           CUDA device (rows "multichip[D]", and with
                           -stream the mesh's stream rows); on by default
                           without -methods when more than one card is
                           visible (the reference's Cuda-MultiGPU)
      -nprocs=P            spawn a local group of P processes (the
                           ``mpirun -np P`` analogue, Readme.txt:43). Each
                           rank runs the whole benchmark; timings are
                           all-gathered and errors summed across ranks, as
                           the reference's MPI protocol does, and rank 0
                           prints. Ranks run on the card
                           (cuda:(rank % device count), CUDA processes can
                           share one) unless -methods=cpu asks for the CPU.
                           With a card for every rank the group is
                           gloo and NCCL (a sharded call's image is summed
                           over the ranks on the cards), else gloo alone;
                           rank 0 prints which

Per file and method: a warmup call (it also builds the kernels; the
reference's GPU warmup fixture, CreateImage.cpp:118-132), ``iterations``
timed calls, the Avg/Min/Max/StdDev table over every rank's samples, the
golden check when scale == 1, and the timing-stability gates. Exit code =
number of errors, summed over the ranks.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch

from raytrace_tpu_torch.io.loader import load_input
from raytrace_tpu_torch.models.ray_tracer import (available_methods,
                                                  create_image,
                                                  create_image_stream,
                                                  prepare_pipeline,
                                                  resolve_method)
from raytrace_tpu_torch.parallel import collectives, distributed
from raytrace_tpu_torch.parallel.mesh import make_mesh
from raytrace_tpu_torch.parallel.sharding import (create_image_sharded,
                                                  prepare_sharded)
from raytrace_tpu_torch.testing import time_stream_detailed
from raytrace_tpu_torch.utils.pio import pout
from raytrace_tpu_torch.utils.stats import (TimingStats, check_ans,
                                            stability_errors)
from raytrace_tpu_torch.utils.timer import profiler

__all__ = ["main", "Options", "run_tests"]


#: -spectrum= values and the spectrum dtype each runs
_SPECTRUM = {"f64": torch.float64, "f32": torch.float32}


class Options:
    """Command-line options (Options::read_cmd, CreateImageHelpers.h:56-95)."""

    def __init__(self, argv):
        self.methods: list[str] = []
        self.iterations = 5
        self.scale = 1.0
        self.spectrum = "f64"
        self.profile = False
        self.stream = 0
        self.reorder = False
        self.multichip = False
        self.nprocs = 1
        self.files: list[str] = []
        for arg in argv:
            if arg.startswith("-methods="):
                self.methods = [m for m in arg.split("=", 1)[1].split(",")
                                if m]
            elif arg.startswith("-iterations="):
                self.iterations = int(arg.split("=", 1)[1])
            elif arg.startswith("-scale="):
                self.scale = float(arg.split("=", 1)[1])
            elif arg.startswith("-spectrum="):
                self.spectrum = arg.split("=", 1)[1]
                if self.spectrum not in _SPECTRUM:
                    raise SystemExit(f"-spectrum= takes f64 or f32, got "
                                     f"{self.spectrum!r}")
            elif arg == "-profile":
                self.profile = True
            elif arg.startswith("-stream="):
                self.stream = int(arg.split("=", 1)[1])
            elif arg == "-reorder":
                self.reorder = True
            elif arg == "-multichip":
                self.multichip = True
            elif arg.startswith("-nprocs="):
                self.nprocs = int(arg.split("=", 1)[1])
            elif arg.startswith("-"):
                raise SystemExit(f"Unknown option: {arg}")
            else:
                self.files.append(arg)
        if self.reorder and self.stream <= 0:
            raise SystemExit("-reorder requires -stream=N (it reorders the "
                             "serving stream's rays)")

    @property
    def spectrum_dtype(self) -> torch.dtype:
        """The dtype of ``-spectrum=``."""
        return _SPECTRUM[self.spectrum]


def _gather_times(times, label=None):
    """Every rank's timing samples, pooled (the gatherAll of per-iteration
    seconds, src/CreateImage.cpp:147-153 + src/MPI_helpers.h:34-38). With a
    ``label`` and more than one rank, each rank's samples are printed."""
    per_rank = collectives.gather_all(np.asarray(times, np.float64))
    if label is not None and len(per_rank) > 1:
        for r, row in enumerate(per_rank):
            pout.write(f"  {label} rank {r} s/call: "
                       f"{[float(t) for t in row]}\n")
    return per_rank.reshape(-1)


def _timed(call, iterations: int) -> list[float]:
    """Seconds of ``iterations`` calls. In a process group the ranks start
    each call together, so every rank's samples time the same sharing of
    the device."""
    times = []
    for _ in range(iterations):
        distributed.barrier()
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    return times


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
    launches = (f", {sum(e.count for e in kernels) / calls:.1f} kernel "
                f"launches/call" if kernels else "")
    pout.write(f"  profile: {what} time {total_us / 1e3 / calls:.3f} ms/call "
               f"of {wall_s * 1e3 / calls:.3f} ms/call wall (busy share "
               f"{total_us / 1e6 / wall_s:.3f}){launches}\n")
    for e in rows[:top]:
        pout.write(f"    {getattr(e, key) / 1e3 / calls:10.3f} ms/call "
                   f"{e.count / calls:7.1f}x  {e.key[:100]}\n")


def _stream_rows(filename, options, label, rows, problem, **stream_kw
                 ) -> int:
    """Time ``options.stream`` distinct-table units through
    create_image_stream (two rounds; ``stream_kw`` picks the method and
    device, or the mesh); append the per-call and steady rows, a
    ``-reorder`` row labelled by what ran (``cfg["reorder"]`` of
    ``problem``'s prepared call, as raytrace_tpu's CLI labels it). Returns
    the number of non-finite results."""
    n_bad = 0

    def make_stream(units):
        nonlocal n_bad
        for image, i_ang in create_image_stream(
                units, spectrum_dtype=options.spectrum_dtype,
                reorder=options.reorder, **stream_kw):
            n_bad += not (np.isfinite(image).all()
                          and np.isfinite(i_ang).all())
            yield image, i_ang

    distributed.barrier()
    per_call, detail = time_stream_detailed(filename, options.stream, 2,
                                            make_stream, scale=options.scale)
    sdtype = options.spectrum_dtype
    ran_reorder = options.reorder and (
        prepare_sharded(problem, stream_kw["mesh"], spectrum_dtype=sdtype,
                        reorder=True)
        if "mesh" in stream_kw else
        prepare_pipeline(problem, stream_kw["compute_method"],
                         spectrum_dtype=sdtype, reorder=True,
                         device=stream_kw["device"])).cfg["reorder"]
    tag = "+stream+reorder" if ran_reorder else "+stream"
    rows.append((f"{label}{tag}", TimingStats.of(_gather_times(per_call))))
    yields = [y for d in detail for y in d["yield_s"]]
    if yields:
        rows.append((f"{label}{tag}.steady",
                     TimingStats.of(_gather_times(yields))))
    return n_bad


def _check(image0, i_ang0, image, i_ang, stats, options) -> int:
    n = 0
    if options.scale == 1.0 and image0 is not None:
        n += not check_ans(image0, i_ang0, image, i_ang)
    return n + stability_errors(stats)


def run_tests(filename: str, options: Options) -> int:
    """Benchmark one input file (run_tests, CreateImage.cpp:84-190)."""
    pout.write(f"\nRunning tests for {filename}\n\n")
    methods = options.methods or available_methods()
    multichip = options.multichip or (not options.methods
                                      and torch.cuda.device_count() > 1)
    n_errors = 0
    problem, image0, i_ang0 = load_input(filename, options.scale)
    sdtype = options.spectrum_dtype
    rows = []
    out = {}
    for requested in methods:
        method, device = resolve_method(requested)
        device = distributed.rank_device(device.type != "cuda")
        label = requested if requested == method else f"{requested}->{method}"
        pout.write(f"Running {label} on {device}, spectrum "
                   f"{options.spectrum}\n")
        # warmup (builds the kernels)
        create_image(problem, method, spectrum_dtype=sdtype, device=device)
        with _maybe_profile(options.profile, device) as prof:
            times = _timed(lambda: out.update(
                r=create_image(problem, method, spectrum_dtype=sdtype,
                               device=device)), options.iterations)
        if prof is not None:
            _print_profile(prof, sum(times), options.iterations)
        stats = TimingStats.of(_gather_times(times, label))
        rows.append((label, stats))
        n_errors += _check(image0, i_ang0, *out["r"], stats, options)
        if options.stream > 0:
            n_errors += _stream_rows(filename, options, label, rows,
                                     problem, compute_method=method,
                                     device=device)

    if multichip:
        mesh = make_mesh()
        label = f"multichip[{len(mesh)}]"
        pout.write(f"Running {label} on {[str(d) for d in mesh]}, spectrum "
                   f"{options.spectrum}\n")
        create_image_sharded(problem, mesh, spectrum_dtype=sdtype)
        times = _timed(lambda: out.update(
            r=create_image_sharded(problem, mesh, spectrum_dtype=sdtype)),
            options.iterations)
        stats = TimingStats.of(_gather_times(times, label))
        rows.append((label, stats))
        n_errors += _check(image0, i_ang0, *out["r"], stats, options)
        if options.stream > 0:
            n_errors += _stream_rows(filename, options, label, rows,
                                     problem, mesh=mesh)

    w = max(14, max((len(r[0]) for r in rows), default=14))
    pout.write(f"\n{'METHOD':>{w}s} {'Avg':>8s} {'Min':>8s} {'Max':>8s} "
               f"{'Std Dev':>9s}\n")
    for label, stats in rows:
        pout.write(f"{label:>{w}s} {stats.avg:8.3f} {stats.min:8.3f}"
                   f" {stats.max:8.3f} {stats.std:9.3f}\n")
    return n_errors


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _accepts(port: int) -> bool:
    try:
        socket.create_connection(("localhost", port), timeout=0.2).close()
        return True
    except OSError:
        return False


def _wait_all(procs) -> int:
    """Wait for every rank; once one fails, stop the others (they would
    wait for it in a collective). Returns the largest exit code."""
    while any(p.poll() is None for p in procs):
        if any(p.returncode not in (None, 0) for p in procs):
            for p in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.05)
    return max(p.wait() for p in procs)


def _launch_process_group(argv, options: Options) -> int:
    """Spawn the local P-process group (the ``mpirun -np P`` analogue).

    Each rank re-runs this CLI with the same flags and the group's
    environment (``RAYTRACE_COORD``, ``RAYTRACE_NPROCS``,
    ``RAYTRACE_PROC_ID``); pio keeps the output to rank 0. The exit code is
    the largest of the ranks' (each already carries the cross-rank error
    sum); a rank that fails stops the others.

    Rank 0 hosts the rendezvous, so it is spawned alone and the launcher
    waits until its port accepts connections before it spawns the others.
    If another process took the port between the probe and the bind, rank
    0 dies with someone else listening there, and the launch retries on a
    fresh port; any other death of rank 0 is its exit code.

    The kernels are built here first when a method runs them, so that P
    ranks do not start P builds of the same sources."""
    methods = options.methods or available_methods()
    if any(resolve_method(m)[0] == "cuda" for m in methods):
        from raytrace_tpu_torch.ops import cuda_lib

        cuda_lib.load_library()

    def spawn(pid: int, port: int):
        env = dict(os.environ, RAYTRACE_COORD=f"localhost:{port}",
                   RAYTRACE_NPROCS=str(options.nprocs),
                   RAYTRACE_PROC_ID=str(pid))
        return subprocess.Popen(
            [sys.executable, "-m", "raytrace_tpu_torch.utils.cli", *argv],
            env=env)

    for _attempt in range(3):
        port = _free_port()
        p0 = spawn(0, port)
        deadline = time.perf_counter() + 120.0
        up = False
        while time.perf_counter() < deadline and p0.poll() is None:
            if _accepts(port):
                up = True
                break
            time.sleep(0.05)
        if not up:
            if p0.poll() is None:
                p0.kill()
                p0.wait()
                raise RuntimeError("process-group coordinator never came up")
            if _accepts(port):
                continue  # port taken by another process: a fresh port
            return p0.returncode
        procs = [p0] + [spawn(pid, port) for pid in range(1, options.nprocs)]
        return _wait_all(procs)
    raise RuntimeError(
        "could not start the process-group coordinator (port races)")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    options = Options(argv)
    if not options.files:
        print(__doc__)
        return 1
    if options.nprocs > 1 and "RAYTRACE_PROC_ID" not in os.environ:
        return _launch_process_group(argv, options)
    if "RAYTRACE_PROC_ID" in os.environ:
        # a rank of the launcher's group (the MPI_Init of
        # src/MPI_helpers.h:9-11); the ranks share the host's cores unless
        # OMP_NUM_THREADS says how many each takes
        methods = options.methods or available_methods()
        distributed.startup(cpu=all(resolve_method(m)[1].type != "cuda"
                                    for m in methods))
        if "OMP_NUM_THREADS" not in os.environ:
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // distributed.size()))
    try:
        n_errors = 0
        for filename in options.files:
            n_errors += run_tests(filename, options)
        # cross-rank error reduction (sumReduce, src/CreateImage.cpp:189)
        n_errors = int(collectives.sum_scalar(n_errors))
        if n_errors == 0:
            pout.write("\nAll tests passed\n")
        else:
            pout.write(f"\nSome tests failed ({n_errors} errors)\n")
        pout.write("\n" + profiler.summary() + "\n")
    finally:
        distributed.shutdown()
    return min(n_errors, 255)


if __name__ == "__main__":
    raise SystemExit(main())
