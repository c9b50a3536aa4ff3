#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (and, where a
host has several, on all of them).

    python3 chip_smoke.py              # phases 1-10, 12-14; 11 on 2+ cards
    python3 chip_smoke.py --multicard  # the build and phase 11 alone

Drives ``raytrace_tpu_torch``'s ``create_image`` main path, its
``create_image_stream`` serving path and its gather probe on the card, and
fails (non-zero exit, no result line) if any phase fails:

1. a CUDA device is present; print its name and power limit;
2. build the CUDA kernels from ``raytrace_tpu_torch/csrc`` (one nvcc per
   source, in parallel; build seconds, registers per kernel);
3. each kernel against its plain PyTorch twin on the card, at the paths'
   shapes, each timed beside its twin with CUDA events, with its bound
   (the larger of its bytes over 3.35 TB/s and its operations over 67
   TFLOP/s f32 plus 34 TFLOP/s f64, counted from this run's inputs):
   trace B1 on refraction-free rays in both methods and on 65,536 rays of
   the ASE-shaped synthetic (every output and the micro-step counts
   bitwise equal to the twin's), its counts variant timed beside the
   normal launch; B1 on a 2^20-ray chunk of the seeded shipped
   shape and on the whole ASE call: the census launch equal to the normal
   one, the warp efficiency E of the micro-step counts, a timing in count
   order beside launch order, the twin's time, and the operation bound
   from the counted
   micro-steps and cell entries; the same on a seeded chunk whose gain
   grid is warped (``non_uniform_gain=0.8``), there also bitwise equal to
   the twin, counts included; amplify B3 on that seeded chunk traced by
   B1 with its seed factors (log-gain bitwise, spectrum within 1e-13
   relative, flags identical, and both flag bits from an fv with a
   negative and a NaN entry); the binning deposit B2 on random
   coordinates at both image shapes and at the real inputs of both shapes
   (bins bitwise equal to get_index's, image and I_ang within 1e-12
   relative of the twin), timed in turns with ``index_add_`` of the image
   alone (its ``library_ms``), with the mean run of equal image bins and
   the atomics it issues; the f32 instantiations (the f32 spectrum,
   ``raytrace_tpu``'s default): B3-f32 on the seeded chunk (the pair
   ``(hi, lo)``, the spectrum and the flags bitwise equal to the twin's),
   its bound from its own operations beside the same arithmetic's with
   Dekker's split product (the twin's form), and B2-f32 at the real inputs
   of both shapes (B3-f32's spectra, the f32 emissivity amplify's), bins
   bitwise, image and I_ang within 1e-12, each timed with its twin and its
   bound, B2-f32 in turns with ``index_add_`` of the f32 image alone, with
   the f64 atomics it issues a chunk, the distinct image bins per 32-,
   256- and 1024-ray tile and the runs, and the ASE call's emissivity
   amplify in f64 and in f32; probe P1 at K 64 (bitwise);
4. with every launch count at 0: ``create_image`` on both golden fixtures
   (``check_ans`` at 5e-6 and a two-sided relative L2 below 1e-5 against
   the embedded golden), then the two shipped-shape synthetics (ASE
   60x25x19x14 = 399,000 rays, nv 52; seeded 120x25x51x51 = 7,803,000
   rays, nv 82; N 3, 106x26 gain grid) with one warmup (which captures
   the call's CUDA graph; its memory pool is printed) and three timed
   calls (graph replays) each, the launches of each kernel in one call
   counted; B1, B2 and B3 must have launched in this run;
5. with the counts at 0 again: ``create_image_stream`` at depth 2 over 4
   ASE and then 4 seeded shipped-shape units with distinct gain tables,
   without and with the reorder; every yield within 1e-12 relative L2 of
   the synchronous call on the same unit; fill, steady inter-yield seconds
   and s/call beside the synchronous s/call; B1, B2 and B3 must have
   launched;
6. with P1's count at 0: the probe tool's measurement
   (``raytrace_tpu_torch.tools.gather_probe.measure``), ns per dependent
   gather; P1 must have launched;
7. the shipped-shape calls once more through the plain twins on the card,
   in the kernels' 2^20-ray chunks: image and I_ang within a relative L2
   of 1e-5 of the kernels' result;
8. with the counts at 0 again, the multi-device and multi-rank path:
   ``create_image_sharded`` on a two-entry mesh of the one card
   (``("cuda:0", "cuda:0")``, each entry on a compute stream of its own)
   and on ``make_mesh()`` (every visible card): both fixtures against their
   goldens as in phase 4, both shipped shapes within 1e-12 relative L2 of
   the single-device call (one warmup, three timed calls in turns with the
   single call); ``create_image_stream(mesh=...)`` at depth 2 over 4
   perturbed units of each shape, every yield within 1e-12 of the
   synchronous sharded call. The single-device calls made beside them do
   not count, and each sharded call and stream must itself launch B1 and
   B2, and B3 on a seeded problem. Then, as subprocesses with their own
   time limits: the CLI with ``-methods=cuda -nprocs=2 -iterations=3``
   (on one card two ranks share it, joined by gloo; each rank's s/call) on both
   fixtures and on both shipped shapes, saved under ``build/`` with the
   single call's result as their golden: every golden check passed, and
   an exit code that is exactly the number of the reference's
   timing-stability gate errors the ranks printed (two ranks time-slicing
   the card trip them in about half the runs, on either kind of input);
   and ``raytrace_tpu_torch/tools/production_loop.py`` with 1 and with 2
   ranks, each rank on ``cuda:(rank % cards)`` (E_sum within 1e-10
   relative);
9. with the counts at 0 again, the fuzz path: the fuzz tool's ``run_case``
   (``raytrace_tpu_torch.tools.fuzz_oracle``) on the card with its sharded
   and stream arms, over its curated cases, 24 random ones from seed 0,
   the envelope's edges (N 20 and nv 99, each in both methods) and two
   cases at the shipped widths (nv 52 and 82, a 106x26 gain grid, 360 and
   720 rays): every case with 0 problems (kernels and twins against the
   scalar oracle's images, against each other within 1e-12, sharded and
   streamed within 1e-12); B1, B2 and B3 launched, and every B3
   instantiation (N 3 or not, K even or odd) and both B2 variants (K even
   or odd) ran, by a census from each case's N and K. Then a failing
   problem (angles beyond 1.5 rad): ``create_image`` on the kernels must
   raise and dump the same rays as the twins, and the replay tool
   (``python -m raytrace_tpu_torch.tools.replay_failed_rays``) must
   reproduce ``error -1`` for every dumped ray;
10. with the counts at 0 again, the medium-scale path through the
   benchmark (``raytrace_tpu_torch.tools.bench.run`` in this process): the
   ASE shape at ``-scale=16`` (6,384,000 rays, 7 chunks, 3 timed calls)
   with its stream (depth 2, 4 units, 1 round), the seeded shape at
   ``-scale=4`` (30,663,360 rays, 30 chunks, 3 calls) and the ASE shape at
   ``-scale=64`` (24,452,610 rays, 24 chunks, 2 calls); every gate of the
   bench passed: both fixtures against their goldens, ``scale16`` and
   ``seed_scale4`` against the plain twins on the card (``check_ans`` at
   5e-6 and a relative L2 below 1e-5), every stream yield within 1e-12 of
   its synchronous call, and ``scale64``'s peak of allocated device memory
   at most 1.10 times ``scale16``'s; each row's s/call, rays/s, peak GiB
   and launches per call, and the device time per kernel of one call of
   each medium shape under the profiler; B1, B2 and B3 must have
   launched;
11. with the counts at 0 again, on two or more cards, the multi-card path
   on ``make_mesh()`` (one entry a card; on one card the run prints one
   line saying so instead): every card's nvidia-smi line, peer access
   and ``nvidia-smi topo -m``; with ``cuda:0`` current, B1, B3 and B2's
   bins on 65,536 seeded rays on each other card bitwise equal to
   cuda:0's, and single calls on each card (both fixtures, both shipped
   shapes) within 1e-12 of cuda:0's (two calls on one card differ at about
   1e-16: B2's f64 atomics), cuda:0 still current; both fixtures sharded
   on the cards against their goldens; the bench's ``ase_small``,
   ``seed_small``, ``scale64`` and ``seed_scale4`` on one card and on the
   cards (``tools/bench.run`` with ``mesh``), once with every call run
   from Python (``eager``) and once through the graphs: every gate, each
   within 1e-12 of the 1-card call, the s/call and the ratio, the
   dispatch, the busy share, each entry's capture and kernel nodes, each
   card's peak and reserved memory, first and last marks and the
   reduction's device time; through the graphs, the bench's
   ``graph_memory_check`` on the 1-card row and on every card of the mesh
   row (what a card reserves beyond the pools of the graphs cached on it
   at most max(256 MiB, 0.10 x the row's peak allocated)); the
   mesh stream at depth 2 within 1e-12 of the sharded call; the device
   time per kernel of each shipped shape on one card and on the cards;
   then as subprocesses the CLI's ``-multichip``, its group of one rank per
   card (``-nprocs``, the backend ``distributed.backend_for`` gives, gloo
   and NCCL) on both fixtures and both shipped shapes, the rank harness
   ``tools/run_distributed.py`` and the production loop on one rank per
   card against one rank. Every card must launch B1 and B2, and B3 on a
   seeded call, by the wrappers' per-device counts;
12. with the counts at 0 again (run before phase 11), the prepared
   whole-call pipeline (``prepare_pipeline``: a CUDA graph of each call,
   captured once per config and replayed; a replay adds the launches it
   captured to the wrappers' counts): on ``ase_small``, ``seed_small``,
   ``scale16`` and ``seed_scale4``, from an empty cache, three units with
   different tables through ``create_image``, one capture and three
   replays, each within 1e-12 relative L2 of its eager call (the chunk
   loop from Python, ``eager=True``); both fixtures through a fresh graph
   against their goldens as in phase 4; the stream at depth 2 and 4, with
   and without the reorder, over 6 units with tables all different of each
   shipped shape, a graph per call in flight, every yield within 1e-12 of
   its unit's eager call; a failing problem through the graph of a good
   one's config: it raises, dumps the eager call's rays, and the graph's
   next replay is right; the mesh entries' graphs against the entries'
   eager turns (the dispatch before the graphs) on two entries of
   ``cuda:0`` and, on two or more cards, on ``make_mesh()``, within 1e-12;
   then the bench's four
   rows in this run eager and through the graphs (both fixtures' goldens,
   every gate, and through the graphs ``graph_memory_check`` on every
   row, as in phase 11): s/call, the dispatch, the device time and busy
   share, the warm-up call and the capture, kernel nodes, pool, peak and
   reserved memory. B1, B2 and B3 must have launched;
13. with the counts at 0 again (run before phase 11), the host surface:
   a ``seed_small`` ``create_image`` through its graph (captured by a
   call before) under ``profiler.scope("create_image-annotated",
   annotate=True, device=...)`` inside ``torch.profiler`` (CPU and CUDA):
   the range is in the trace once, the device events of B1, B2 and B3
   from the replay lie inside its wall window, the scope's recorded time
   is at least the device time the profiler summed for the call, and
   ``get_time()`` rises across the call; one line with the numbers,
   printed with the port's ``printp``. B1, B2 and B3 must have launched;
14. with the counts at 0 again (run before phase 11), the f32 path
   (``spectrum_dtype=float32``): both fixtures in f32 against their
   goldens as in phase 4; the bench's ``ase_small``, ``seed_small``,
   ``seed_scale4`` and ``scale16`` rows in f32 through their graphs (a
   warm-up that captures, then timed calls split into prep, dispatch and
   wait, in turns with the f64 call of the same problem, which does not
   count), each within 1e-5 relative L2 of the f64 call, the device time
   per kernel of each under the profiler, and on every row what the card
   reserves beyond the cached graphs' pools (the f32 and f64 graphs are
   two pools) at most max(256 MiB, 0.10 x the row's peak); an f32 stream
   at depth 2, an f32 mesh stream and f32 sharded calls on two entries of
   the card over 4 units with tables all different of each shipped shape,
   each within 1e-12 of the synchronous f32 call. B1, B2-f32 and B3-f32
   (the f32 instantiations' own counts) must have launched.

Prints one JSON line of per-kernel results, every card's line, and as its
last line ``{"ok": true, "device": {...}}``; ``--multicard`` prints no
kernel line. A longer record of every measurement goes to
``chiprun_out/chip_smoke.json`` (``chip_smoke_multicard.json``). Needs no
network; uses one card, or every card of the host for phase 11.
"""

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "tests", "fixtures")
OUT_DIR = os.path.join(HERE, "chiprun_out")
#: the device of the kernel phase's tensors
DEV = "cuda"
#: B2's random-coordinate checks on the beams of the main path's shapes
#: (phase_trace_shapes' name, binning method, rays)
RANDOM_COORD_RAYS = (("ase_call", 1, 399000), ("seed_chunk", 2, 1 << 20))

#: the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
#: B1's operations, counted from csrc/trace.cu: per propagate micro-step,
#: per cell entry in f32 (without and with emissivity) and in f64
B1_OPS = dict(step_f32=81, cell_f32=36, cell_f32_emis=48, cell_f64=28)

record: dict = {}
#: the kernels' wrapper modules by name (set in main) and each kernel's
#: launches in one synchronous call of each shipped shape
WRAPPERS: dict = {}
LAUNCHES_PER_CALL: dict = {}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events, after
    one warmup call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"nvidia-smi: {e}")
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def trace_pair(p, rays):
    """B1 and its twin on ``rays``, both with the micro-step counts; the
    counts variant's other outputs must equal the normal launch's."""
    from raytrace_tpu_torch.models.problem import prepare_gain
    from raytrace_tpu_torch.ops import trace_kernel

    g = prepare_gain(p.gain, DEV)
    method = 2 if p.seed is not None else 1
    use_emis = method == 1
    args = (rays, p.N, p.euv_beam.dz, g, method, 0.5, use_emis)
    got = trace_kernel.trace_batch(*args)
    got_c, steps = trace_kernel.trace_batch(*args, counts=True)
    want, want_steps = trace_kernel.trace_batch_plain(*args, counts=True)
    torch.cuda.synchronize()
    if not all(torch.equal(getattr(got, f), getattr(got_c, f))
               for f in got._fields):
        fail(f"trace method {method}: the counts variant's outputs differ "
             f"from the normal launch's")
    return got, want, args, steps, want_steps


def rel_err(got, want):
    return ((got - want).abs() / want.abs().clamp_min(1e-6)).flatten()


def bound(nbytes, f32_ops=0.0, f64_ops=0.0):
    """``(bound_ms, bound_by)``: the larger of the bytes over the HBM rate
    and the operations over their type's peak rate (f32 and f64 times
    added), in ms."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32_ops / F32_OPS_PER_S + f64_ops / F64_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def warp_efficiency(steps):
    """E = sum of the rays' micro-steps over sum over warps of 32 x the
    warp's largest, in launch order (a partial last warp pads with 0)."""
    s = steps.to(torch.int64)
    s = torch.cat([s, s.new_zeros((-s.shape[0]) % 32)]).view(-1, 32)
    return (s.sum() / (32 * s.max(dim=1).values).sum()).item()


def in_turns(fns: dict, iters: int, rounds: int = 2) -> dict:
    """Mean ms per call of each of ``fns``, timed in turns (a b b a ...);
    returns every reading per name."""
    names = list(fns)
    out = {n: [] for n in names}
    for r in range(2 * rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            out[n].append(cuda_ms(fns[n], iters))
    return out


def mean(xs):
    return sum(xs) / len(xs)


def phase_kernels(results):
    from raytrace_tpu_torch.ops import trace_kernel
    from raytrace_tpu_torch.testing import (ASE_SHAPE, source_rays,
                                            synthetic_problem)

    # B1, refraction-free lockstep: geometry-determined step sequences
    worst = 0.0
    for method in (1, 2):
        p = synthetic_problem(refraction_free=True, seeded=method == 2,
                              **{k: v for k, v in ASE_SHAPE.items()})
        got, want, _, steps, want_steps = trace_pair(
            p, source_rays(p, 65536, DEV))
        if not torch.equal(steps, want_steps):
            fail(f"trace method {method} refraction-free: micro-step counts "
                 f"differ")
        if not torch.equal(got.ivl, want.ivl):
            fail(f"trace method {method} refraction-free: ivl differs")
        if not torch.equal(got.escaped, want.escaped):
            fail(f"trace method {method} refraction-free: escaped differs")
        for f in ("gvl", "evl"):
            e = rel_err(getattr(got, f), getattr(want, f)).max().item()
            if e > 1e-5:
                fail(f"trace method {method} refraction-free: {f} max "
                     f"rel {e}")
        worst = max(worst, (got.gvl - want.gvl).abs().max().item())
        bitwise = all(torch.equal(getattr(got, f), getattr(want, f))
                      for f in got._fields)
        if not bitwise:
            fail(f"trace method {method} refraction-free: not bitwise equal "
                 f"to the twin")
        print(f"trace refraction-free method {method}: every output and the "
              f"counts bitwise equal to the twin's", flush=True)
        record[f"trace_straight_{method}"] = dict(bitwise=bitwise)

    # B1 on 65,536 rays of the ASE-shaped synthetic
    p = synthetic_problem(**ASE_SHAPE)
    got, want, args, steps, want_steps = trace_pair(
        p, source_rays(p, 65536, DEV))
    med_steps = (steps.float().median().item(),
                 want_steps.float().median().item())
    if med_steps[0] != med_steps[1]:
        fail(f"trace ASE-shaped: median micro-step count {med_steps}")
    med = max(rel_err(got.gvl, want.gvl).median().item(),
              rel_err(got.evl, want.evl).median().item())
    bitwise = (all(torch.equal(getattr(got, f), getattr(want, f))
                   for f in got._fields) and torch.equal(steps, want_steps))
    if med > 1e-5 or not bitwise:
        fail(f"trace ASE-shaped: median rel {med}, bitwise {bitwise}")
    worst = max(worst, (got.gvl - want.gvl).abs().max().item(),
                (got.evl - want.evl).abs().max().item())
    ms = cuda_ms(lambda: trace_kernel.trace_batch(*args), 20)
    ms_c = cuda_ms(lambda: trace_kernel.trace_batch(*args, counts=True), 20)
    plain_ms = cuda_ms(lambda: trace_kernel.trace_batch_plain(*args), 3)
    print(f"trace ASE-shaped 65536 rays: median rel {med:.3e}, bitwise "
          f"{bitwise}, median counts {med_steps}; kernel {ms:.4f} ms, "
          f"counts variant {ms_c:.4f} ms, plain {plain_ms:.3f} ms",
          flush=True)
    record["trace_65536"] = dict(median_rel=med, bitwise=bitwise, ms=ms,
                                 counts_ms=ms_c, plain_ms=plain_ms,
                                 median_steps=med_steps[0])

    shapes = phase_trace_shapes(results)
    results["trace"]["max_abs_err"] = worst
    phase_amplify(results, shapes["seed_chunk"])
    phase_deposit(results, shapes)
    phase_f32_kernels(results, shapes)
    phase_probe_kernel(results)


def phase_trace_shapes(results):
    """B1 at the main path's shapes (a 2^20-ray seeded chunk, the whole ASE
    call, a seeded chunk on a warped gain grid): time, the counts variant, the warp efficiency E of the
    micro-step counts in launch order and in count order (each timed), the
    cell-entry census and the operation bound. Returns each shape's
    problem, tables, rays and trace result."""
    from raytrace_tpu_torch.models.problem import prepare_gain
    from raytrace_tpu_torch.ops import cuda_lib, trace_kernel
    from raytrace_tpu_torch.testing import (ASE_SHAPE, SEED_SHAPE,
                                            source_rays, synthetic_problem)

    lib = cuda_lib.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    shapes = {}
    for name, shape, n in (
            ("seed_chunk", SEED_SHAPE, 1 << 20),
            ("ase_call", ASE_SHAPE, None),
            # the gain grid warped t -> t^1.8: the interval search's guess
            # from the grid's end points misses by up to ~20 cells
            ("seed_chunk_warped", dict(SEED_SHAPE, non_uniform_gain=0.8),
             1 << 20)):
        p = synthetic_problem(**shape)
        gain = prepare_gain(p.gain, DEV)
        method = 2 if p.seed is not None else 1
        use_emis = method == 1
        rays = source_rays(p, n, DEV)
        B = rays["x"].shape[0]
        args = (p.N, p.euv_beam.dz, gain, method, 0.5, use_emis)
        res = trace_kernel.trace_batch(rays, *args)
        res_c, steps, cells = trace_kernel._launch(
            lib, rays, B, *args, stream, census=True)
        torch.cuda.synchronize()
        if not all(torch.equal(getattr(res, f), getattr(res_c, f))
                   for f in res._fields):
            fail(f"trace {name}: the census launch's outputs differ")
        if name == "seed_chunk_warped":
            want, want_steps = trace_kernel.trace_batch_plain(
                rays, *args, counts=True)
            if not (all(torch.equal(getattr(res, f), getattr(want, f))
                        for f in res._fields)
                    and torch.equal(steps, want_steps)):
                fail(f"trace {name}: not bitwise equal to the twin")
        perm = torch.argsort(steps, stable=True)
        rays_sorted = {k: v[perm].contiguous() for k, v in rays.items()}
        eff = warp_efficiency(steps)
        eff_sorted = warp_efficiency(steps[perm])
        t = in_turns({"natural": lambda: trace_kernel.trace_batch(rays, *args),
                      "sorted": lambda: trace_kernel.trace_batch(
                          rays_sorted, *args)}, 10)
        ms_c = cuda_ms(lambda: trace_kernel.trace_batch(rays, *args,
                                                        counts=True), 10)
        plain_ms = cuda_ms(lambda: trace_kernel.trace_batch_plain(rays,
                                                                  *args), 1)
        n_steps, n_cells = int(steps.sum()), int(cells.sum())
        ops = B1_OPS
        f32 = (n_steps * ops["step_f32"] + n_cells *
               (ops["cell_f32_emis"] if use_emis else ops["cell_f32"]))
        f64 = n_cells * ops["cell_f64"]
        T = res.ivl.shape[1] * res.ivl.shape[2]
        tables = sum(getattr(gain, k).numel() * getattr(gain, k)
                     .element_size() for k in gain._fields
                     if k not in ("gv", "gv0"))
        nbytes = B * 16 + tables + B * (12 * T + 16 + 2)
        b_ms, b_by = bound(nbytes, f32, f64)
        ms = mean(t["natural"])
        print(f"trace {name} ({B} rays, method {method}): kernel "
              f"{t['natural']} ms, counts variant {ms_c:.4f} ms, plain twin "
              f"{plain_ms:.3f} ms; in count "
              f"order {t['sorted']} ms; E {eff:.4f} in launch order, "
              f"{eff_sorted:.4f} in count order; micro-steps {n_steps} "
              f"(median {steps.float().median().item()}), cell entries "
              f"{n_cells}; {f32:.4e} f32 + {f64:.4e} f64 operations, "
              f"{nbytes} bytes: bound {b_ms:.4f} ms by {b_by}, "
              f"{b_ms / ms:.3f} of it reached", flush=True)
        record[f"trace_{name}"] = dict(
            rays=B, ms_readings=t["natural"], ms=ms, counts_ms=ms_c,
            plain_ms=plain_ms, sorted_ms_readings=t["sorted"],
            sorted_ms=mean(t["sorted"]),
            warp_efficiency=eff, warp_efficiency_sorted=eff_sorted,
            micro_steps=n_steps, cell_entries=n_cells, f32_ops=f32,
            f64_ops=f64, bytes=nbytes, bound_ms=b_ms, bound_by=b_by)
        shapes[name] = dict(p=p, gain=gain, rays=rays, res=res,
                            method=method, ms=ms, bound=(b_ms, b_by))
    # the seeded chunk: 8 of a seeded call's 8 launches, the ASE call's 1
    seed = shapes["seed_chunk"]
    results["trace"] = dict(ms=seed["ms"],
                            plain_ms=record["trace_seed_chunk"]["plain_ms"],
                            bound_ms=seed["bound"][0],
                            bound_by=seed["bound"][1], library_ms=None)
    return shapes


def phase_amplify(results, cell):
    """B3 on the seeded chunk traced by B1, its seed factors from the work
    unit, against the twin (log-gain bitwise, spectrum within 1e-13
    relative, flags identical), then with a negative and a NaN entry in
    fv (both flag bits); both timed."""
    from raytrace_tpu_torch.ops import amplify_kernel, cuda_lib
    from raytrace_tpu_torch.testing import seed_factors

    p, res = cell["p"], cell["res"]
    B = res.ivl.shape[0]
    f, fv = seed_factors(p, B, DEV)
    gv = cell["gain"].gv[1:]
    K, T = fv.shape[0], res.ivl.shape[1] * res.ivl.shape[2]
    args = (f, fv, res.escaped, res.ivl, res.gvl, gv)
    got, flags = amplify_kernel.amplify_gain(*args)
    _, _, gl = amplify_kernel._launch(
        cuda_lib.load_library(), *args,
        torch.cuda.current_stream().cuda_stream, log_gain=True)
    want, want_flags = amplify_kernel.amplify_gain_plain(*args)
    gl_bitwise = torch.equal(gl, amplify_kernel.log_gain_plain(*args[3:]))
    nz = want != 0
    rel = ((got - want)[nz].abs() / want[nz].abs()).max().item()
    if (not gl_bitwise or rel > 1e-13 or not torch.equal(got == 0, ~nz)
            or not torch.equal(flags, want_flags)):
        fail(f"amplify: log-gain bitwise {gl_bitwise}, spectrum max rel "
             f"{rel}, flags equal {torch.equal(flags, want_flags)}")
    fv_bad = fv.clone()
    fv_bad[3], fv_bad[7] = -1.0, float("nan")
    bad = (f, fv_bad) + args[2:]
    _, flags_bad = amplify_kernel.amplify_gain(*bad)
    _, want_bad = amplify_kernel.amplify_gain_plain(*bad)
    both = [int(((flags_bad & bit) != 0).sum()) for bit in
            (amplify_kernel.FLAG_NEG, amplify_kernel.FLAG_NAN)]
    if not torch.equal(flags_bad, want_bad) or min(both) == 0:
        fail(f"amplify: flags with a negative and a NaN fv entry: equal "
             f"{torch.equal(flags_bad, want_bad)}, rays per bit {both}")
    ms = cuda_ms(lambda: amplify_kernel.amplify_gain(*args), 20)
    plain_ms = cuda_ms(lambda: amplify_kernel.amplify_gain_plain(*args), 5)
    nbytes = (B * K * 8 + B * T * 8 + B * (8 + 1 + 1) + K * 8
              + gv.numel() * 4)
    b_ms, b_by = bound(nbytes, f64_ops=B * K * (2 * T + 3))
    print(f"amplify seeded chunk B={B} K={K} T={T} cells={gv.shape[1]}: "
          f"log-gain bitwise, max rel {rel:.3e}, flags identical (escaped "
          f"{int(res.escaped.sum())}; with a negative and a NaN fv entry "
          f"{both} rays per bit, identical); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; {nbytes} bytes: bound {b_ms:.4f} ms by "
          f"{b_by}, {b_ms / ms:.3f} of it reached", flush=True)
    record["amplify_chunk"] = dict(B=B, K=K, max_rel=rel, ms=ms,
                                   plain_ms=plain_ms, bytes=nbytes,
                                   bound_ms=b_ms, bound_by=b_by,
                                   flag_rays=both)
    results["amplify"] = dict(max_abs_err=(got - want).abs().max().item(),
                              ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, library_ms=None)
    cell.update(Iv=got, flags=flags)


def run_stats(bins, K, tile=32):
    """``(mean run length, atomics)`` of B2 on ``bins`` ([B, 2] i32 from
    its bins output): the mean length of the runs of equal image bins
    among the deposited rays in launch order, and the f64 atomics the
    kernel issues, one per frequency for each run inside a warp's tile of
    ``tile`` rays plus one per ray deposited into I_ang."""
    img = bins[:, 0].long()
    idx = torch.nonzero(img >= 0).squeeze(1)
    v = img[idx]
    n = idx.numel()
    if n == 0:
        return 0.0, int((bins[:, 1] >= 0).sum())
    change = torch.ones(n, dtype=torch.bool, device=bins.device)
    change[1:] = v[1:] != v[:-1]
    in_tile = change.clone()
    t = idx // tile
    in_tile[1:] |= t[1:] != t[:-1]
    return (n / int(change.sum()),
            int(in_tile.sum()) * K + int((bins[:, 1] >= 0).sum()))


def deposit_check(name, args, beam, method, C, A):
    """B2 against its twin on the card on one set of inputs: the bins
    bitwise equal to get_index's (through the bins output), image and I_ang
    within 1e-12 relative. Returns the bins and the largest absolute and
    relative (to the largest cell) errors."""
    from raytrace_tpu_torch.ops import cuda_lib, deposit_kernel
    from raytrace_tpu_torch.ops.binning import bin_indices

    Iv, coords, ok, scale = args
    K = Iv.shape[1]
    f64 = dict(dtype=torch.float64, device=DEV)

    def acc():
        return (torch.zeros((C, K), **f64), torch.zeros((A, 1), **f64))

    got, want = acc(), acc()
    deposit_kernel.bin_deposit(Iv, coords, ok, beam, method, scale, *got)
    deposit_kernel.bin_deposit_plain(Iv, coords, ok, beam, method, scale,
                                     *want)
    bins = deposit_kernel._launch(
        cuda_lib.load_library(), Iv, coords, ok, beam, method, scale, *acc(),
        torch.cuda.current_stream().cuda_stream, bins=True)
    torch.cuda.synchronize()
    if not torch.equal(bins, bin_indices(coords, ok, beam, method)):
        fail(f"deposit {name}: bins differ from get_index's")
    worst = (0.0, 0.0)
    for what, g, w in zip(("image", "I_ang"), got, want):
        e = ((g - w).abs().max() / w.abs().max()).item()
        if not e <= 1e-12 or g.isnan().any():
            fail(f"deposit {name}: {what} max rel {e} against the twin")
        worst = (max(worst[0], (g - w).abs().max().item()),
                 max(worst[1], e))
    return bins, worst


def phase_deposit(results, shapes):
    """B2 (bins, scale, I_ang sum and run-merged f64 atomics in one
    kernel) against its twin on random coordinates at both image shapes,
    then at the real inputs of the seeded chunk (B1's exit rays, B3's
    spectra) and of the ASE call (entry rays, the plain emissivity
    amplify): bins bitwise, image and I_ang within 1e-12; each real input
    timed in turns with ``index_add_`` of the image alone into a [C + 1, K]
    buffer whose last row takes the trash, and the twin timed."""
    from raytrace_tpu_torch.models.problem import prepare_beam
    from raytrace_tpu_torch.models.ray_tracer import _validate
    from raytrace_tpu_torch.ops import (amplify_kernel, binning,
                                        deposit_kernel, spectrum)
    from raytrace_tpu_torch.testing import deposit_inputs

    dep_worst = (0.0, 0.0)
    for name, method, B in RANDOM_COORD_RAYS:
        p = shapes[name]["p"]
        beam = prepare_beam(p.euv_beam, DEV)
        Iv, coords, ok = deposit_inputs(p.euv_beam, B, seed=0)
        args = (torch.as_tensor(Iv, device=DEV),
                tuple(torch.as_tensor(c, device=DEV) for c in coords),
                torch.as_tensor(ok, device=DEV), 0.37)
        C, A = p.euv_beam.nx * p.euv_beam.ny, p.euv_beam.na * p.euv_beam.nb
        bins, e = deposit_check(f"random {name}", args, beam, method, C, A)
        dep_worst = tuple(map(max, dep_worst, e))
        print(f"deposit random coordinates {name} B={B} K={Iv.shape[1]} "
              f"method {method}: bins bitwise, image and I_ang within 1e-12 "
              f"(max rel {e[1]:.2e}); image rays "
              f"{int((bins[:, 0] >= 0).sum())}, I_ang rays "
              f"{int((bins[:, 1] >= 0).sum())}", flush=True)

    for name in ("seed_chunk", "ase_call"):
        cell = shapes[name]
        p, res, rays, method = (cell[k] for k in ("p", "res", "rays",
                                                  "method"))
        beam = prepare_beam(p.euv_beam, DEV)
        if method == 1:
            K = p.euv_beam.nv
            Iv = spectrum.amplify(res, torch.zeros(
                (res.ivl.shape[0], K), dtype=torch.float64, device=DEV),
                cell["gain"].gv[1:], p.N)
            flags = amplify_kernel.iv_flags(Iv)
        else:
            Iv, flags = cell["Iv"], cell["flags"]
        scale = _validate(p)[2]
        coords = binning.source_coords(res, rays, method)
        ok = ~res.perp & (flags == 0)
        B, K = Iv.shape
        C, A = beam.x.shape[0] * beam.y.shape[0], (beam.a.shape[0]
                                                   * beam.b.shape[0])
        bins, e = deposit_check(f"real {name}", (Iv, coords, ok, scale),
                                beam, method, C, A)
        dep_worst = tuple(map(max, dep_worst, e))
        image = torch.zeros((C, K), dtype=torch.float64, device=DEV)
        i_ang = torch.zeros((A, 1), dtype=torch.float64, device=DEV)
        lib_out = torch.zeros((C + 1, K), dtype=torch.float64, device=DEV)
        lib_bins = torch.where(bins[:, 0] >= 0, bins[:, 0], C).contiguous()
        contrib = (Iv * scale).contiguous()
        dep = (Iv, coords, ok, beam, method, scale, image, i_ang)
        t = in_turns({
            "kernel": lambda: deposit_kernel.bin_deposit(*dep),
            "library": lambda: lib_out.index_add_(0, lib_bins, contrib)},
            20)
        plain_ms = cuda_ms(lambda: deposit_kernel.bin_deposit_plain(*dep),
                           10)
        n_img = int((bins[:, 0] >= 0).sum())
        n_ang = int((bins[:, 1] >= 0).sum())
        n_read = int(((bins[:, 0] >= 0) | (bins[:, 1] >= 0)).sum())
        grids = sum(g.numel() * 8 for g in (beam.x, beam.y, beam.a, beam.b,
                                            beam.dv))
        nbytes = (n_read * K * 8 + B * 16 + B + 2 * (C * K + A) * 8
                  + grids)
        b_ms, b_by = bound(nbytes, f64_ops=2 * K * (n_img + n_ang))
        mean_run, atomics = run_stats(bins, K)
        ms, lib_ms = mean(t["kernel"]), mean(t["library"])
        print(f"deposit real inputs {name} B={B} K={K} C={C}: bins bitwise, "
              f"max rel {e[1]:.2e} against the twin; image rays {n_img}, "
              f"I_ang rays {n_ang}; mean image run {mean_run:.2f} rays in "
              f"launch "
              f"order, {atomics} atomics (one a ray and frequency: "
              f"{n_img * K + n_ang}); B2 {t['kernel']} ms, index_add_ of "
              f"the image alone {t['library']} ms (B2/index_add_ "
              f"{ms / lib_ms:.3f}), plain twin {plain_ms:.4f} ms; {nbytes} "
              f"bytes: bound {b_ms:.4f} ms by {b_by}, {b_ms / ms:.3f} of "
              f"it reached", flush=True)
        record[f"deposit_{name}"] = dict(
            B=B, K=K, C=C, image_rays=n_img, iang_rays=n_ang,
            mean_run=mean_run, atomics=atomics, ms_readings=t["kernel"],
            library_ms_readings=t["library"], ms=ms, library_ms=lib_ms,
            plain_ms=plain_ms, bytes=nbytes, bound_ms=b_ms, bound_by=b_by)
        if name == "seed_chunk":
            results["bin_deposit"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)
    results["bin_deposit"].update(max_abs_err=dep_worst[0],
                                  max_rel_err=dep_worst[1])


#: B3-f32's f32 operations, counted from csrc/amplify.cu: per element and
#: (segment, sub-length) term (the product 1, its error by one fused
#: multiply-add 2, the two-sum 6, the low part 2) and per element (the exp
#: 31, the seed product's rounding and mask 2, the product 1, the flags'
#: compare 1), beside one f64 product per element
B3_F32_OPS = dict(term=11, element=35)
#: the same arithmetic with the product's error by Dekker's split product
#: (13 operations, the twin's and the JAX package's form): the yardstick of
#: a kernel that issues no fused multiply-add
B3_F32_OPS_DEKKER = dict(term=21, element=37)


def phase_f32_kernels(results, shapes):
    """The f32 instantiations against their twins on the card at the main
    path's inputs, each timed beside its twin with its bound: B3-f32 on the
    seeded chunk traced by B1, with the chunk's seed factors (the pair
    ``(hi, lo)``, the spectrum and the flags bitwise); B2-f32 at the real
    inputs of both shapes (the seeded chunk's B3-f32 spectra; the ASE
    call's f32 emissivity amplify), bins bitwise, image and I_ang within
    1e-12, timed in turns with ``index_add_`` of the f32 image alone into
    an f32 buffer; and the ASE call's emissivity amplify in f32 and f64."""
    from raytrace_tpu_torch.models.problem import prepare_beam
    from raytrace_tpu_torch.models.ray_tracer import _validate
    from raytrace_tpu_torch.ops import (amplify_kernel, binning, cuda_lib,
                                        deposit_kernel, spectrum)
    from raytrace_tpu_torch.testing import seed_factors
    from raytrace_tpu_torch.tools.f32_ab import bin_stats

    f32 = torch.float32
    cell = shapes["seed_chunk"]
    p, res = cell["p"], cell["res"]
    B = res.ivl.shape[0]
    f, fv = seed_factors(p, B, DEV)
    gv = cell["gain"].gv[1:]
    K, T = fv.shape[0], res.ivl.shape[1] * res.ivl.shape[2]
    args = (f, fv, res.escaped, res.ivl, res.gvl, gv)
    got, flags = amplify_kernel.amplify_gain(*args, dtype=f32)
    _, _, pair = amplify_kernel._launch(
        cuda_lib.load_library(), *args,
        torch.cuda.current_stream().cuda_stream, log_gain=True, dtype=f32)
    want, want_flags = amplify_kernel.amplify_gain_plain(*args, dtype=f32)
    hi, lo = amplify_kernel.log_gain2_plain(*args[3:])
    torch.cuda.synchronize()
    same = dict(hi=torch.equal(pair[0], hi), lo=torch.equal(pair[1], lo),
                spectrum=torch.equal(got.view(torch.int32),
                                     want.view(torch.int32)),
                flags=torch.equal(flags, want_flags))
    if not all(same.values()):
        ulps = (got.view(torch.int32).long()
                - want.view(torch.int32).long()).abs().max().item()
        fail(f"amplify f32: bitwise {same}, spectrum max {ulps} ulp")
    ms = cuda_ms(lambda: amplify_kernel.amplify_gain(*args, dtype=f32), 20)
    plain_ms = cuda_ms(lambda: amplify_kernel.amplify_gain_plain(
        *args, dtype=f32), 3)
    nbytes = (B * K * 4 + B * T * 8 + B * (8 + 1 + 1) + K * 8
              + gv.numel() * 4)
    b_ms, b_by = bound(nbytes, f32_ops=B * K * (B3_F32_OPS["term"] * T
                                                + B3_F32_OPS["element"]),
                       f64_ops=B * K)
    d_ms, d_by = bound(nbytes, f32_ops=B * K * (
        B3_F32_OPS_DEKKER["term"] * T + B3_F32_OPS_DEKKER["element"]),
        f64_ops=B * K)
    # the terms' products: where the fused error equals Dekker's
    p_min = float("inf")
    for t in range(T):
        s_, u_ = divmod(t, res.ivl.shape[2])
        prod = (res.gvl[:, s_, u_, None]
                * gv[s_][res.ivl[:, s_, u_].long()]).abs()
        p_min = min(p_min, torch.where(prod > 0, prod, float("inf"))
                    .min().item())
    print(f"amplify f32 seeded chunk B={B} K={K} T={T}: pair, spectrum and "
          f"flags bitwise equal to the twin's (log-gains {hi.min().item():.3f}"
          f" to {hi.max().item():.3f}; smallest nonzero |gvl gv| "
          f"{p_min:.3e}, 2^-100 = {2.0 ** -100:.3e}); kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms; {nbytes} bytes: bound {b_ms:.4f} ms by "
          f"{b_by}, {b_ms / ms:.3f} of it reached; with Dekker's product "
          f"{d_ms:.4f} ms by {d_by}, {d_ms / ms:.3f} of it", flush=True)
    record["amplify_f32_chunk"] = dict(B=B, K=K, bitwise=same, ms=ms,
                                       plain_ms=plain_ms, bytes=nbytes,
                                       bound_ms=b_ms, bound_by=b_by,
                                       dekker_bound_ms=d_ms,
                                       dekker_bound_by=d_by,
                                       smallest_product=p_min)
    results["amplify_f32"] = dict(max_abs_err=(got - want).abs().max().item(),
                                  ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by, library_ms=None)

    worst = (0.0, 0.0)
    for name in ("seed_chunk", "ase_call"):
        c = shapes[name]
        p, res, rays, method = (c[k] for k in ("p", "res", "rays", "method"))
        beam = prepare_beam(p.euv_beam, DEV)
        if method == 1:
            K = p.euv_beam.nv
            z32 = torch.zeros((res.ivl.shape[0], K), dtype=f32, device=DEV)
            z64 = z32.double()
            gv_a = c["gain"].gv[1:]
            Iv = spectrum.amplify(res, z32, gv_a, p.N, dtype=f32)
            flags = amplify_kernel.iv_flags(Iv)
            emis = in_turns({
                "f64": lambda: spectrum.amplify(res, z64, gv_a, p.N),
                "f32": lambda: spectrum.amplify(res, z32, gv_a, p.N,
                                                dtype=f32)}, 2, rounds=1)
            record["emissivity_amplify_ase_call"] = emis
            print(f"emissivity amplify, whole ASE call ({res.ivl.shape[0]} "
                  f"rays, K {K}, plain PyTorch): f64 {emis['f64']} ms, f32 "
                  f"{emis['f32']} ms", flush=True)
        else:
            Iv, flags = got, want_flags
        scale = _validate(p)[2]
        coords = binning.source_coords(res, rays, method)
        ok = ~res.perp & (flags == 0)
        B, K = Iv.shape
        C = beam.x.shape[0] * beam.y.shape[0]
        A = beam.a.shape[0] * beam.b.shape[0]
        bins, e = deposit_check(f"f32 real {name}", (Iv, coords, ok, scale),
                                beam, method, C, A)
        worst = tuple(map(max, worst, e))
        stats = bin_stats(bins, K)
        f64 = dict(dtype=torch.float64, device=DEV)
        image, i_ang = torch.zeros((C, K), **f64), torch.zeros((A, 1), **f64)
        lib_out = torch.zeros((C + 1, K), dtype=f32, device=DEV)
        lib_bins = torch.where(bins[:, 0] >= 0, bins[:, 0], C).contiguous()
        contrib = (Iv * torch.full((), scale, dtype=f32,
                                   device=DEV)).contiguous()
        dep = (Iv, coords, ok, beam, method, scale, image, i_ang)
        t = in_turns({
            "kernel": lambda: deposit_kernel.bin_deposit(*dep),
            "library": lambda: lib_out.index_add_(0, lib_bins, contrib)}, 20)
        plain_ms = cuda_ms(lambda: deposit_kernel.bin_deposit_plain(*dep),
                           10)
        n_img = int((bins[:, 0] >= 0).sum())
        n_ang = int((bins[:, 1] >= 0).sum())
        n_read = int(((bins[:, 0] >= 0) | (bins[:, 1] >= 0)).sum())
        grids = sum(g.numel() * 8 for g in (beam.x, beam.y, beam.a, beam.b,
                                            beam.dv))
        nbytes = (n_read * K * 4 + B * 16 + B + 2 * (C * K + A) * 8
                  + grids)
        b_ms, b_by = bound(nbytes, f32_ops=K * (n_img + n_ang),
                           f64_ops=K * (n_img + n_ang))
        ms, lib_ms = mean(t["kernel"]), mean(t["library"])
        print(f"deposit f32 real inputs {name} B={B} K={K} C={C}: bins "
              f"bitwise, max rel {e[1]:.2e} against the twin; image rays "
              f"{n_img}, I_ang rays {n_ang}; f64 atomics "
              f"{stats['atomics']} (with each tile's bins merged: "
              f"{stats['atomics_merged']}); distinct image bins (runs) per "
              f"tile of 32 {stats['distinct_per_32']:.2f} "
              f"({stats['runs_per_32']:.2f}), 256 "
              f"{stats['distinct_per_256']:.2f} ({stats['runs_per_256']:.2f})"
              f", 1024 {stats['distinct_per_1024']:.2f} "
              f"({stats['runs_per_1024']:.2f}); mean run "
              f"{stats['mean_run']:.2f}; B2-f32 {t['kernel']} ms, "
              f"index_add_ of the f32 image alone {t['library']} ms, plain "
              f"twin {plain_ms:.4f} ms; {nbytes} bytes: bound {b_ms:.4f} ms "
              f"by {b_by}, {b_ms / ms:.3f} of it reached", flush=True)
        record[f"deposit_f32_{name}"] = dict(
            B=B, K=K, C=C, image_rays=n_img, iang_rays=n_ang, bins=stats,
            ms_readings=t["kernel"], library_ms_readings=t["library"], ms=ms,
            library_ms=lib_ms, plain_ms=plain_ms, bytes=nbytes,
            bound_ms=b_ms, bound_by=b_by)
        if name == "seed_chunk":
            results["bin_deposit_f32"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)
    results["bin_deposit_f32"].update(max_abs_err=worst[0],
                                      max_rel_err=worst[1])


def phase_probe_kernel(results):
    """P1 against its twin at K = 64, both timed there."""
    from raytrace_tpu_torch.tools import gather_probe

    tab, idx = (t.to(DEV) for t in gather_probe.probe_inputs())
    K = 64
    got = gather_probe.gather_probe(tab, idx, K)
    want = gather_probe.gather_probe_plain(tab, idx, K)
    if not torch.equal(got, want):
        fail("gather probe: kernel differs from its twin")
    ms = cuda_ms(lambda: gather_probe.gather_probe(tab, idx, K), 20)
    plain_ms = cuda_ms(lambda: gather_probe.gather_probe_plain(tab, idx, K),
                       5)
    # a latency probe: its bytes and adds bound nothing it measures
    b_ms, b_by = bound(tab.numel() * 4 + idx.numel() * 4 + got.numel() * 4,
                       f32_ops=K * tab.numel())
    print(f"gather probe K={K}: bitwise; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; bound {b_ms:.2e} ms by {b_by}", flush=True)
    results["gather_probe"] = dict(
        max_abs_err=(got - want).abs().max().item(), ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_output(image, i_ang, p):
    b = p.euv_beam
    if image.shape != (b.nx * b.ny * b.nv,) or i_ang.shape != (b.na * b.nb,):
        fail(f"output shapes {image.shape} {i_ang.shape}")
    if not (np.isfinite(image).all() and np.isfinite(i_ang).all()):
        fail("non-finite output")
    if not (np.abs(image).sum() > 0 and np.abs(i_ang).sum() > 0):
        fail("all-zero output")


def phase_main_path():
    from raytrace_tpu_torch import check_ans, create_image, load_input
    from raytrace_tpu_torch.models import ray_tracer
    from raytrace_tpu_torch.testing import (ASE_SHAPE, SEED_SHAPE,
                                            synthetic_problem)

    for name in ("golden_ase.dat", "golden_seed.dat"):
        p, image0, i_ang0 = load_input(os.path.join(FIXTURES, name))
        image, i_ang = create_image(p, "cuda", device="cuda")
        check_output(image, i_ang, p)
        r_img, r_ang = rel_l2(image, image0), rel_l2(i_ang, i_ang0)
        if not check_ans(image0, i_ang0, image, i_ang):
            fail(f"{name}: check_ans")
        if r_img >= 1e-5 or r_ang >= 1e-5:
            fail(f"{name}: rel L2 image {r_img} I_ang {r_ang}")
        print(f"{name}: check_ans ok, rel L2 image {r_img:.3e} I_ang "
              f"{r_ang:.3e}", flush=True)
        record[name] = dict(rel_image=r_img, rel_iang=r_ang)

    outs = {}
    for name, shape in (("ase", ASE_SHAPE), ("seed", SEED_SHAPE)):
        p = synthetic_problem(**shape)
        src = p.seed_beam if p.seed is not None else p.euv_beam
        rays = src.nx * src.ny * src.na * src.nb
        t0 = time.perf_counter()
        create_image(p, "cuda", device="cuda")
        warm = time.perf_counter() - t0
        times = []
        torch.cuda.reset_peak_memory_stats()
        for r in range(3):
            before = {n: w.launch_count for n, w in WRAPPERS.items()}
            t0 = time.perf_counter()
            image, i_ang = create_image(p, "cuda", device="cuda")
            times.append(time.perf_counter() - t0)
            if r == 0:
                LAUNCHES_PER_CALL[name] = {
                    n: w.launch_count - before[n]
                    for n, w in WRAPPERS.items()}
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        pool_gib = sum(g.pool_bytes for g in ray_tracer.prepare_pipeline(
            p, "cuda", device="cuda").pipeline.graphs) / 2 ** 30
        check_output(image, i_ang, p)
        best = min(times)
        print(f"{name} shipped shape ({rays} rays): warmup and capture "
              f"{warm:.4f} s, s/call {[round(t, 5) for t in times]}, best "
              f"{best:.5f} s, {rays / best:.4e} rays/s, the graph's memory "
              f"pool {pool_gib:.3f} GiB (allocated beside it by the replays "
              f"{peak_gib:.3f} GiB); launches per call "
              f"{LAUNCHES_PER_CALL[name]}", flush=True)
        record[f"{name}_call"] = dict(rays=rays, warmup_s=warm,
                                      times_s=times, rays_per_s=rays / best,
                                      peak_gib=peak_gib, pool_gib=pool_gib)
        outs[name] = (p, image, i_ang)
    return outs


def phase_stream():
    """create_image_stream over 4 distinct-table units of each shipped
    shape, without and with the reorder, against synchronous calls."""
    from raytrace_tpu_torch import create_image, create_image_stream
    from raytrace_tpu_torch.testing import (ASE_SHAPE, SEED_SHAPE,
                                            perturbed_problems,
                                            synthetic_problem)

    for name, shape in (("ase", ASE_SHAPE), ("seed", SEED_SHAPE)):
        source = functools.partial(synthetic_problem, **shape)
        sync, sync_s = [], []
        for p in perturbed_problems(source, 4, salt=1):
            t0 = time.perf_counter()
            sync.append(create_image(p, "cuda", device="cuda"))
            sync_s.append(time.perf_counter() - t0)
        for reorder in (False, True):
            units = perturbed_problems(source, 4, salt=1)
            t0 = time.perf_counter()
            marks, worst = [], 0.0
            for k, (image, i_ang) in enumerate(create_image_stream(
                    units, "cuda", device="cuda", depth=2, reorder=reorder)):
                marks.append(time.perf_counter())
                check_output(image, i_ang, units[k])
                worst = max(worst, rel_l2(image, sync[k][0]),
                            rel_l2(i_ang, sync[k][1]))
            if len(marks) != 4 or worst > 1e-12:
                fail(f"stream {name} reorder {reorder}: {len(marks)} yields, "
                     f"worst rel L2 against sync {worst}")
            fill = marks[0] - t0
            steady = [b - a for a, b in zip(marks, marks[1:])]
            per_call = (marks[-1] - t0) / 4
            print(f"stream {name} depth 2 reorder {reorder}: rel L2 vs sync "
                  f"<= {worst:.3e}; fill {fill:.5f} s, steady "
                  f"{[round(y, 5) for y in steady]} s, s/call {per_call:.5f} "
                  f"(sync s/call {[round(t, 5) for t in sync_s]})",
                  flush=True)
            record[f"stream_{name}_reorder{int(reorder)}"] = dict(
                worst_rel=worst, fill_s=fill, steady_s=steady,
                per_call_s=per_call, sync_s=sync_s)


def phase_probe_path():
    """The probe tool's entry point: ns per dependent gather."""
    from raytrace_tpu_torch.tools import gather_probe

    out = gather_probe.measure(reps=5)
    if not (0.0 < out["gather_ns"] < 1e4):
        fail(f"gather probe: {out}")
    print(f"gather probe: {out['gather_ns']:.4f} ns per dependent gather "
          f"(K {out['k']}, {out['threads']} threads, all "
          f"{[round(t, 4) for t in out['gather_ns_all']]})", flush=True)
    record["gather_probe"] = out


def phase_plain(outs):
    from raytrace_tpu_torch import create_image

    for name, (p, image, i_ang) in outs.items():
        t0 = time.perf_counter()
        # the kernels' chunk size: 8 seeded chunks in place of the CPU
        # default's 477 (the twins' launch count, not their arithmetic,
        # set the time), the same result to rounding
        image_p, i_ang_p = create_image(p, "cpu", device="cuda",
                                        chunk_size=1 << 20)
        dt = time.perf_counter() - t0
        r_img, r_ang = rel_l2(image, image_p), rel_l2(i_ang, i_ang_p)
        if r_img >= 1e-5 or r_ang >= 1e-5:
            fail(f"{name}: kernels vs plain twins rel L2 image {r_img} "
                 f"I_ang {r_ang}")
        print(f"{name} kernels vs plain twins on the card: rel L2 image "
              f"{r_img:.3e} I_ang {r_ang:.3e} (plain call {dt:.3f} s)",
              flush=True)
        record[f"{name}_vs_plain"] = dict(rel_image=r_img, rel_iang=r_ang,
                                          plain_s=dt)


def cli_gate_errors(out):
    """The timing-stability gate errors (CreateImage.cpp:174-181) that the
    CLI's ranks printed: each counts one error in the CLI's exit code."""
    return sum(out.count(msg) for msg in (
        "Standard deviation of run times is larger than 10%",
        "Maximum run time is more than 15% greater than the average"))


def run_children(argvs, timeout, what, gate_errors_ok=False):
    """Run each of ``argvs`` from the checkout's root, each in a session of
    its own, all at once; at the time limit every session (a launcher's
    ranks too) is killed. Fails the phase on a non-zero exit, except, with
    ``gate_errors_ok``, one that :func:`cli_gate_errors` accounts for
    exactly (the caller checks it); returns each ``(output, exit code)``."""
    import signal

    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv, cwd=HERE, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              start_new_session=True) for argv in argvs]
    outs = []
    for proc in procs:
        try:
            left = max(1.0, timeout - (time.perf_counter() - t0))
            outs.append(proc.communicate(timeout=left)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                if q.poll() is None:
                    os.killpg(q.pid, signal.SIGKILL)
            print(proc.communicate()[0][-4000:], flush=True)
            fail(f"{what}: no end within {timeout} s")
    for proc, out in zip(procs, outs):
        if proc.returncode != 0 and not (
                gate_errors_ok
                and proc.returncode == min(cli_gate_errors(out), 255)):
            print(out[-4000:], flush=True)
            fail(f"{what}: exit code {proc.returncode}")
    print(f"{what}: exit codes {[p.returncode for p in procs]} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return [(out, p.returncode) for out, p in zip(outs, procs)]


def free_port() -> str:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = str(s.getsockname()[1])
    s.close()
    return port


def rank_tool(tool, nprocs):
    """The argvs of ``nprocs`` ranks of a rank tool (``<pid> <nprocs>
    <port>``) under ``raytrace_tpu_torch/tools``."""
    path = os.path.join("raytrace_tpu_torch", "tools", tool)
    port = free_port()
    return [[sys.executable, path, str(pid), str(nprocs), port]
            for pid in range(nprocs)]


def production_loops(nprocs=2, extra=()):
    """E_sum per step of the production loop tool with 1 rank and, at the
    same time, with ``nprocs`` ranks on the cards (rank 0's lines), each
    rank on ``cuda:(rank % cards)``; ``extra`` argvs run beside them.
    Returns the E_sums and the ranks' outputs."""
    import re

    tool = os.path.join("raytrace_tpu_torch", "tools", "production_loop.py")
    outs = run_children([[sys.executable, tool]]
                        + rank_tool("production_loop.py", nprocs)
                        + list(extra), 300,
                        f"production loop, 1 rank and {nprocs} ranks")
    count = torch.cuda.device_count()
    esums = []
    for (out, _rc), ranks in zip(outs[:2], (1, nprocs)):
        esum = [float(m) for m in re.findall(r"E_sum=([0-9.e+-]+)", out)]
        if len(esum) != 2 or not all(np.isfinite(esum)) or min(esum) <= 0:
            fail(f"production loop: E_sum {esum}")
        # every rank on its card, and every step computed there
        cards = " ".join(f"cuda:{r % count}" for r in range(ranks))
        on_card = ("rank devices: " + cards in out
                   and out.count(f"(ranks={ranks}, cuda:0)") == 2)
        if not on_card:
            print(out[-4000:], flush=True)
            fail(f"production loop, {ranks} rank(s): not every rank on "
                 f"its card ({cards})")
        esums.append(esum)
    return esums, outs


#: the kernels' names in a profile (B2's f64 kernel is
#: ``bin_deposit_kernel<double, V>``, its f32 kernel
#: ``bin_deposit_f32_kernel<S>``)
PROFILE_TAGS = (("trace", "trace_kernel"),
                ("bin_deposit", "bin_deposit_kernel"),
                ("amplify", "amplify_seeded_kernel"),
                ("bin_deposit_f32", "bin_deposit_f32_kernel"),
                ("amplify_f32", "amplify_seeded_f32_kernel"))


def profile_calls(fn, n=3):
    """``(device ms, kernel launches, {kernel: device ms})`` per call of
    ``fn`` over ``n`` calls under torch.profiler, after one call outside it
    (a first call of a config captures its graph)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
    k = [e for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA]
    per = {name: sum(e.self_device_time_total for e in k if tag in e.key)
           / n / 1e3 for name, tag in PROFILE_TAGS}
    return (sum(e.self_device_time_total for e in k) / n / 1e3,
            sum(e.count for e in k) / n, per)


def uncounted(fn, *args, **kw):
    """``fn(*args, **kw)`` with every kernel's launch counts (the total and
    per device) left as they were: a call made as a reference or a
    yardstick does not count for the path being driven."""
    before = {n: (w.launch_count, dict(w.device_launches))
              for n, w in WRAPPERS.items()}
    try:
        return fn(*args, **kw)
    finally:
        for n, w in WRAPPERS.items():
            w.launch_count = before[n][0]
            w.device_launches.clear()
            w.device_launches.update(before[n][1])


def path_kernels_of(p):
    """The kernels one call of ``p`` must launch: B1 and B2, and B3 unless
    the emissivity amplify (ASE, no seed) takes its place."""
    emis = p.gain[0].E0 is not None and p.seed is None
    return ("trace", "bin_deposit") + (() if emis else ("amplify",))


def launched(what, names, fn, *args, **kw):
    """``fn(*args, **kw)``; fails unless it launched each of ``names``
    itself, so that the calls around it cannot stand in for it."""
    before = {n: WRAPPERS[n].launch_count for n in names}
    out = fn(*args, **kw)
    made = {n: WRAPPERS[n].launch_count - before[n] for n in names}
    if min(made.values()) <= 0:
        fail(f"{what}: launches {made}; each of {names} must launch")
    return out


def phase_sharded():
    """The multi-device path in this process: the sharded call and the
    sharded stream on a two-entry mesh of the card and on make_mesh().
    The single-device calls beside them (references, the timing in turns,
    the profile) do not count; every sharded call and stream must launch
    the kernels of its problem itself."""
    from raytrace_tpu_torch import (check_ans, create_image,
                                    create_image_stream, load_input)
    from raytrace_tpu_torch.parallel.mesh import make_mesh
    from raytrace_tpu_torch.parallel.sharding import create_image_sharded
    from raytrace_tpu_torch.testing import (ASE_SHAPE, SEED_SHAPE,
                                            perturbed_problems,
                                            synthetic_problem)

    meshes = {"2 entries on cuda:0": make_mesh(devices=("cuda:0", "cuda:0")),
              "make_mesh()": make_mesh()}
    for name in ("golden_ase.dat", "golden_seed.dat"):
        for what, mesh in meshes.items():
            p, image0, i_ang0 = load_input(os.path.join(FIXTURES, name))
            image, i_ang = launched(f"{name} sharded on {what}",
                                    path_kernels_of(p), create_image_sharded,
                                    p, mesh, "cuda")
            check_output(image, i_ang, p)
            r_img, r_ang = rel_l2(image, image0), rel_l2(i_ang, i_ang0)
            if (not check_ans(image0, i_ang0, image, i_ang) or r_img >= 1e-5
                    or r_ang >= 1e-5):
                fail(f"{name} sharded on {what}: check_ans or rel L2 image "
                     f"{r_img} I_ang {r_ang}")
            print(f"{name} sharded on {what} (D={len(mesh)}): check_ans ok, "
                  f"rel L2 image {r_img:.3e} I_ang {r_ang:.3e}", flush=True)
            record[f"{name}_sharded_D{len(mesh)}"] = dict(rel_image=r_img,
                                                          rel_iang=r_ang)

    mesh2 = meshes["2 entries on cuda:0"]
    for name, shape in (("ase", ASE_SHAPE), ("seed", SEED_SHAPE)):
        p = synthetic_problem(**shape)
        need = path_kernels_of(p)
        single = uncounted(create_image, p, "cuda", device="cuda")
        create_image_sharded(p, mesh2, "cuda")  # warmup
        t_single, t_sharded = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            uncounted(create_image, p, "cuda", device="cuda")
            t_single.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            sharded = launched(f"{name} sharded", need, create_image_sharded,
                               p, mesh2, "cuda")
            t_sharded.append(time.perf_counter() - t0)
        check_output(*sharded, p)
        worst = {}
        for what, mesh in meshes.items():
            got = (sharded if mesh is mesh2
                   else launched(f"{name} sharded on {what}", need,
                                 create_image_sharded, p, mesh, "cuda"))
            worst[what] = max(rel_l2(got[0], single[0]),
                              rel_l2(got[1], single[1]))
            if worst[what] > 1e-12:
                fail(f"{name} shipped shape sharded on {what}: rel L2 "
                     f"{worst[what]} against the single call")
        print(f"{name} shipped shape sharded: rel L2 against the single call "
              f"{worst}; s/call sharded on 2 entries "
              f"{[round(t, 5) for t in t_sharded]} (best "
              f"{min(t_sharded):.5f}), single {[round(t, 5) for t in t_single]}"
              f" (best {min(t_single):.5f})", flush=True)
        prof = {"single": uncounted(profile_calls,
                                    lambda: create_image(p, "cuda",
                                                         device="cuda")),
                "sharded": profile_calls(
                    lambda: create_image_sharded(p, mesh2, "cuda"))}
        for what, (dev_ms, n_launch, per) in prof.items():
            print(f"{name} shipped shape {what} under the profiler: device "
                  f"{dev_ms:.3f} ms/call, {n_launch:.1f} kernel launches/call,"
                  f" B1 {per['trace']:.3f}, B2 {per['bin_deposit']:.3f}, B3 "
                  f"{per['amplify']:.3f} ms/call", flush=True)
        record[f"{name}_sharded"] = dict(rel=worst, sharded_s=t_sharded,
                                         single_s=t_single, profile=prof)

        source = functools.partial(synthetic_problem, **shape)
        sync = [create_image_sharded(u, mesh2, "cuda")
                for u in perturbed_problems(source, 4, salt=3)]
        units = perturbed_problems(source, 4, salt=3)

        def stream():
            marks, worst = [], 0.0
            for k, (image, i_ang) in enumerate(create_image_stream(
                    units, "cuda", mesh=mesh2, depth=2)):
                marks.append(time.perf_counter())
                check_output(image, i_ang, units[k])
                worst = max(worst, rel_l2(image, sync[k][0]),
                            rel_l2(i_ang, sync[k][1]))
            return marks, worst

        t0 = time.perf_counter()
        marks, worst_s = launched(f"sharded stream {name}", need, stream)
        if len(marks) != 4 or worst_s > 1e-12:
            fail(f"sharded stream {name}: {len(marks)} yields, worst rel L2 "
                 f"against the sharded call {worst_s}")
        per_call = (marks[-1] - t0) / 4
        print(f"sharded stream {name} on 2 entries, depth 2: rel L2 vs sync "
              f"<= {worst_s:.3e}; fill {marks[0] - t0:.5f} s, s/call "
              f"{per_call:.5f}", flush=True)
        record[f"stream_{name}_sharded"] = dict(worst_rel=worst_s,
                                                fill_s=marks[0] - t0,
                                                per_call_s=per_call)


def shipped_cells():
    """Both shipped shapes as ``.dat`` snapshots under ``build/`` (git
    ignored), each with the single call's result on the card as its
    golden; their paths."""
    from raytrace_tpu_torch import create_image, save_input
    from raytrace_tpu_torch.testing import (ASE_SHAPE, SEED_SHAPE,
                                            synthetic_problem)

    cells = os.path.join(HERE, "build", "chip_smoke_cells")
    os.makedirs(cells, exist_ok=True)
    paths = []
    for name, shape in (("ase", ASE_SHAPE), ("seed", SEED_SHAPE)):
        p = synthetic_problem(**shape)
        uncounted(create_image, p, "cuda", device="cuda")
        paths.append(os.path.join(cells, f"{name}.dat"))
        save_input(paths[-1], p)
    return paths


def cli_ranks(what, files, nprocs=2, backend=None):
    """The CLI's group of ``nprocs`` ranks on the cards over ``files``:
    every golden check must pass, and the exit code must equal the
    timing-stability gate errors the ranks printed (two ranks time-slicing
    the card trip them in about half the runs); with ``backend``, rank 0
    must have joined that backend. Returns each rank's s/call line."""
    import re

    out, rc = run_children([[sys.executable, "-m",
                             "raytrace_tpu_torch.utils.cli", "-methods=cuda",
                             f"-nprocs={nprocs}", "-iterations=3", *files]],
                           300, what, gate_errors_ok=True)[0]
    joined = f"process group: {nprocs} ranks, backend {backend}"
    if backend is not None and joined not in out:
        print(out[-4000:], flush=True)
        fail(f"{what}: no line '{joined}'")
    gates = cli_gate_errors(out)
    if "Answers do not match" in out or rc != gates or (
            "All tests passed" if rc == 0
            else f"Some tests failed ({rc} errors)") not in out:
        print(out[-4000:], flush=True)
        fail(f"{what}: exit code {rc}, {gates} timing-gate errors printed")
    print(f"{what}: golden checks passed on every rank; exit code {rc}, "
          f"{gates} timing-stability gate errors", flush=True)
    # the ranks share one output pipe, so another rank's stray text may
    # precede a line of rank 0's
    ranks = re.findall(r"(\S+ rank \d+ s/call: \[[^\]\n]*\])", out)
    for line in ranks:
        print(f"  {line}", flush=True)
    if len(ranks) != nprocs * len(files):
        print(out[-6000:], flush=True)
        fail(f"{what}: {len(ranks)} per-rank timing lines, not "
             f"{nprocs * len(files)}")
    return dict(exit_code=rc, ranks=ranks)


def phase_ranks():
    """The multi-rank path as subprocesses: the CLI's two-rank group on the
    card over both fixtures and both shipped shapes, and the production
    loop with 1 and 2 ranks."""
    files = [os.path.join(FIXTURES, name)
             for name in ("golden_ase.dat", "golden_seed.dat")]
    record["nprocs2_cli"] = cli_ranks(
        "CLI -methods=cuda -nprocs=2 -iterations=3 on the fixtures and the "
        "shipped shapes", files + shipped_cells())
    (one, two), _ = production_loops()
    worst = max(abs(a - b) / a for a, b in zip(one, two))
    if worst > 1e-10:
        fail(f"production loop: E_sum 1 rank {one}, 2 ranks {two}")
    print(f"production loop on the card: E_sum 1 rank {one}, 2 ranks {two}, "
          f"rel {worst:.3e}", flush=True)
    record["production_loop"] = dict(one=one, two=two, rel=worst)


def phase_multi():
    phase_sharded()
    phase_ranks()


#: phase 9's random cases (``fuzz_oracle.random_config``, seed 0)
FUZZ_RANDOM = 24


def fuzz_cases():
    """Phase 9's cases: the fuzz tool's curated ones, ``FUZZ_RANDOM``
    random ones, the edges of the envelope and two at the shipped widths
    (``testing.ASE_SHAPE`` and ``SEED_SHAPE`` with 360 and 720 rays)."""
    from raytrace_tpu_torch.testing import ASE_SHAPE, SEED_SHAPE
    from raytrace_tpu_torch.tools import fuzz_oracle

    rng = np.random.default_rng(0)
    return (list(fuzz_oracle.CURATED)
            + [fuzz_oracle.random_config(rng) for _ in range(FUZZ_RANDOM)]
            + [dict(nx=3, ny=2, na=2, nb=2, nv=4, N=20),
               dict(nx=2, ny=2, na=2, nb=2, nv=5, N=20, seeded=True,
                    seed_dim=9),
               dict(nx=3, ny=2, na=2, nb=2, nv=99),
               dict(nx=2, ny=2, na=2, nb=2, nv=99, seeded=True),
               dict(ASE_SHAPE, nx=6, ny=5, na=4, nb=3),
               dict(SEED_SHAPE, nx=2, ny=5, na=5, nb=5)])


#: the kernel variants each fuzz case runs, from its N and K
#: (``csrc/amplify.cu`` ``launch<NSEG, NSUB, PAIRS>``, ``csrc/deposit.cu``
#: ``bin_deposit_kernel<PAIRS>``; pairs where K is even)
def b3_variant(N, K):
    return f"<{'2,3' if N == 3 else '0,0'},{2 if K % 2 == 0 else 1}>"


def b2_variant(K):
    return f"<{2 if K % 2 == 0 else 1}>"


def replay_check():
    """A failing problem (angles beyond 1.5 rad: every ray perpendicular)
    on the kernels must raise and dump the rays the twins' call dumps;
    the replay tool must reproduce error -1 for every dumped ray."""
    from raytrace_tpu_torch import create_image
    from raytrace_tpu_torch.testing import synthetic_problem
    from raytrace_tpu_torch.utils.errors import RayTraceError, read_failures

    cells = os.path.join(HERE, "build", "chip_smoke_cells")
    os.makedirs(cells, exist_ok=True)
    dumps = {}
    for backend in ("cuda", "cpu"):
        p = synthetic_problem()
        p.euv_beam.a = p.euv_beam.a + 1500.0
        dumps[backend] = os.path.join(cells, f"failed_{backend}.dat")
        try:
            create_image(p, backend, device=DEV,
                         failed_ray_path=dumps[backend])
        except RayTraceError:
            pass
        else:
            fail(f"failing problem on {backend}: create_image did not raise")
    rays = {m: read_failures(path)[0] for m, path in dumps.items()}
    if not (len(rays["cuda"]) > 0
            and np.array_equal(rays["cuda"], rays["cpu"])):
        fail(f"failure dumps: {len(rays['cuda'])} rays from the kernels, "
             f"{len(rays['cpu'])} from the twins, equal "
             f"{np.array_equal(rays['cuda'], rays['cpu'])}")
    (out, _rc), = run_children(
        [[sys.executable, "-m", "raytrace_tpu_torch.tools.replay_failed_rays",
          dumps["cuda"]]], 120, "replay of the kernels' failure dump")
    reproduced = out.count(": error -1 (")
    if reproduced != len(rays["cuda"]):
        print(out[-4000:], flush=True)
        fail(f"replay: error -1 on {reproduced} of {len(rays['cuda'])} rays")
    print(f"failure dump: {len(rays['cuda'])} rays from the kernels, the "
          f"twins' rays; the replay reproduces error -1 on each", flush=True)
    return len(rays["cuda"])


def phase_fuzz():
    """The fuzz tool's cases on the card with the sharded and stream arms;
    every case with 0 problems and every kernel variant run; then the
    replay check."""
    from raytrace_tpu_torch.testing import synthetic_problem
    from raytrace_tpu_torch.tools import fuzz_oracle

    t0 = time.perf_counter()
    cases = fuzz_cases()
    sweep = fuzz_oracle.Sweep(device=DEV, sharded=True, stream=True)
    b3 = {b3_variant(n, k): 0 for n in (3, 2) for k in (2, 1)}
    b2 = {b2_variant(k): 0 for k in (2, 1)}
    bad = 0
    for ci, kw in enumerate(cases):
        p = synthetic_problem(rng=ci, **kw)
        before = {n: WRAPPERS[n].launch_count for n in ("amplify",
                                                        "bin_deposit")}
        bad += fuzz_oracle.run_case(ci, kw, sweep)
        b3[b3_variant(p.N, p.euv_beam.nv)] += (
            WRAPPERS["amplify"].launch_count - before["amplify"])
        b2[b2_variant(p.euv_beam.nv)] += (
            WRAPPERS["bin_deposit"].launch_count - before["bin_deposit"])
    sweep.summary(len(cases), bad)
    print(f"fuzz census of launches: B3 {b3}, B2 {b2}", flush=True)
    if bad:
        fail(f"fuzz path: {bad} problems in {len(cases)} cases")
    if min(b3.values()) == 0 or min(b2.values()) == 0:
        fail(f"fuzz path: a kernel variant never ran: B3 {b3}, B2 {b2}")
    dumped = replay_check()
    dt = time.perf_counter() - t0
    w = sweep.worst
    print(f"fuzz path: {len(cases)} cases, 0 problems, {dt:.1f} s; largest "
          f"rel L2 against the oracle: image {w['image']:.3e}, I_ang "
          f"{w['i_ang']:.3e}; kernels against twins {w['xbackend']:.3e}, "
          f"stream {w['stream']:.3e}, reorder {w['reorder']:.3e}; chaos "
          f"gate engaged {len(sweep.chaos)} times", flush=True)
    record["fuzz"] = dict(cases=len(cases), seconds=dt, worst=w,
                          chaos_engagements=len(sweep.chaos),
                          chaos=sweep.chaos, census_b3=b3, census_b2=b2,
                          replayed_rays=dumped)


#: phase 10's bench rows: timed calls, stream rounds, the rows held
#: against the plain twins, and the gates that must have passed
MEDIUM_REPS = {"scale16": 3, "seed_scale4": 3, "scale64": 2}
MEDIUM_STREAM_ROUNDS = {"scale16_stream": 1}
MEDIUM_TWINS = ("scale16", "seed_scale4")
MEDIUM_GATES = ("golden_check", "scale16_cross_backend_check",
                "seed_scale4_cross_backend_check", "scale16_stream_sync_check",
                "scale_flat_check")


def phase_medium():
    """The benchmark's medium-scale rows on the card: every gate true,
    each row's s/call, rays/s, peak device memory and launches per call."""
    from raytrace_tpu_torch.tools import bench

    t0 = time.perf_counter()
    res = bench.run(device=DEV, reps=MEDIUM_REPS,
                    stream_rounds=MEDIUM_STREAM_ROUNDS, twins=MEDIUM_TWINS,
                    out_dir=OUT_DIR)
    dt = time.perf_counter() - t0
    rows = {}
    for name in ("scale16", "scale16_stream", "seed_scale4", "scale64"):
        p = name + "_"
        mem = res[f"mem_after_{name}"]
        rows[name] = dict(
            rays=res[p + "n_rays"],
            best_s=res[p + "best_seconds_per_call"],
            median_s=res[p + "median_seconds_per_call"],
            rays_per_s=res[p + "rays_per_sec"],
            peak_gib=mem["max_memory_allocated"] / 2 ** 30,
            launches_per_call=res[p + "launches_per_call"])
        times = [round(c["total_s"], 5) for c in res.get(p + "calls", [])]
        print(f"{name} ({rows[name]['rays']} rays): best "
              f"{rows[name]['best_s']:.5f} s/call"
              f"{f' (timed {times})' if times else ''}, "
              f"{rows[name]['rays_per_s']:.4e} rays/s, peak device memory "
              f"{rows[name]['peak_gib']:.3f} GiB, launches per call "
              f"{rows[name]['launches_per_call']}", flush=True)
    # device time per kernel at the two medium shapes, one call each
    from raytrace_tpu_torch import create_image
    from raytrace_tpu_torch.testing import fresh_problem, synthetic_problem

    for name, shape, scale in (("scale16", bench.SHAPES[0], bench.SCALES[0]),
                               ("seed_scale4", bench.SHAPES[1],
                                bench.SCALES[1])):
        p = fresh_problem(functools.partial(synthetic_problem, **shape),
                          scale)
        dev_ms, n_launch, per = profile_calls(
            lambda: create_image(p, "cuda", device="cuda"), n=2)
        print(f"{name} under the profiler: device {dev_ms:.3f} ms/call, "
              f"{n_launch:.1f} kernel launches/call, B1 {per['trace']:.3f}, "
              f"B2 {per['bin_deposit']:.3f}, B3 {per['amplify']:.3f} "
              f"ms/call", flush=True)
        rows[name].update(device_ms=dev_ms, kernel_launches=n_launch,
                          kernel_ms=per)
    twins = {n: res[f"{n}_twin"] for n in MEDIUM_TWINS}
    gates = {g: res["gates"].get(g) for g in MEDIUM_GATES}
    print(f"medium-scale gates {gates}; twins {twins}; stream against sync "
          f"{res['scale16_stream_max_rel_vs_sync']:.3e}; scale64/scale16 "
          f"peak {res['scale_flat_ratio']:.4f}; {dt:.1f} s", flush=True)
    record["medium"] = dict(rows=rows, gates=res["gates"], twins=twins,
                            seconds=dt, artifact=res)
    if not res["gates_ok"] or not all(v is True for v in gates.values()):
        fail(f"medium-scale path: gates {res['gates']}")


#: phase 12's bench rows, each timed eager and through its graph (calls)
PREPARED_REPS = {"ase_small": 3, "seed_small": 3, "scale16": 3,
                 "seed_scale4": 3}
#: a graph replay against the eager call on the same unit: B2's f64
#: atomics add in an order that changes from call to call
PREPARED_REL = 1e-12


def eager_call(p, device=DEV):
    """``p``'s call run from Python on the card, its launches uncounted:
    the reference a graph replay is held against."""
    from raytrace_tpu_torch.models import ray_tracer

    def call():
        prep = ray_tracer.prepare_pipeline(p, "cuda", device=device,
                                           eager=True)
        return ray_tracer._finalize_call(
            p, prep, prep.pipeline(*prep.operands),
            os.path.join(OUT_DIR, "eager_failed_rays.dat"))
    return uncounted(call)


def worst_rel(got, want):
    return max(max(rel_l2(g[0], w[0]), rel_l2(g[1], w[1]))
               for g, w in zip(got, want))


def row_source(name):
    """A bench row's source and ``-scale=``."""
    from raytrace_tpu_torch.testing import synthetic_problem
    from raytrace_tpu_torch.tools import bench

    seeded, si, _salt = bench._ROWS[name]
    return (functools.partial(synthetic_problem, **bench.SHAPES[seeded]),
            None if si is None else bench.SCALES[si])


def prepared_replays():
    """Per row: an empty cache, then three units of the row's shape with
    different tables through ``create_image``: one capture, three replays
    of that graph, each within ``PREPARED_REL`` of its eager call."""
    from raytrace_tpu_torch import create_image
    from raytrace_tpu_torch.models import ray_tracer
    from raytrace_tpu_torch.testing import perturbed_problems

    out = {}
    for name in PREPARED_REPS:
        source, scale = row_source(name)
        ray_tracer.clear_pipeline_cache()
        want = [eager_call(u) for u in perturbed_problems(source, 3, salt=61,
                                                          scale=scale)]
        units = perturbed_problems(source, 3, salt=61, scale=scale)
        got = [launched(f"{name} replay", path_kernels_of(u), create_image,
                        u, "cuda", device=DEV) for u in units]
        for u, (image, i_ang) in zip(units, got):
            check_output(image, i_ang, u)
        rel = worst_rel(got, want)
        pipe = ray_tracer.prepare_pipeline(units[0], "cuda",
                                           device=DEV).pipeline
        if (rel > PREPARED_REL or len(pipe.graphs) != 1
                or pipe.graphs[0].in_flight):
            fail(f"{name}: graph replays rel L2 {rel} against eager, "
                 f"{len(pipe.graphs)} graphs")
        g = pipe.graphs[0]
        print(f"{name} through its graph: 3 replays of one capture, rel L2 "
              f"against the eager calls <= {rel:.3e}; {g.nodes} nodes",
              flush=True)
        out[name] = dict(rel=rel, nodes=g.nodes)
    return out


def prepared_goldens():
    """Both fixtures through a fresh graph against their goldens."""
    from raytrace_tpu_torch import check_ans, create_image, load_input
    from raytrace_tpu_torch.models import ray_tracer

    out = {}
    for name in ("golden_ase.dat", "golden_seed.dat"):
        ray_tracer.clear_pipeline_cache()
        p, image0, i_ang0 = load_input(os.path.join(FIXTURES, name))
        image, i_ang = create_image(p, "cuda", device=DEV)
        pipe = ray_tracer.prepare_pipeline(p, "cuda", device=DEV).pipeline
        r_img, r_ang = rel_l2(image, image0), rel_l2(i_ang, i_ang0)
        if (not check_ans(image0, i_ang0, image, i_ang) or r_img >= 1e-5
                or r_ang >= 1e-5 or len(pipe.graphs) != 1):
            fail(f"{name} through its graph: rel L2 image {r_img} I_ang "
                 f"{r_ang}, {len(pipe.graphs)} graphs")
        print(f"{name} through its graph: check_ans ok, rel L2 image "
              f"{r_img:.3e} I_ang {r_ang:.3e}", flush=True)
        out[name] = dict(rel_image=r_img, rel_iang=r_ang)
    return out


def prepared_streams():
    """The stream at depth 2 and 4 over units with tables all different,
    a graph per call in flight, every yield within ``PREPARED_REL`` of its
    unit's eager call; with and without the reorder."""
    from raytrace_tpu_torch import create_image_stream
    from raytrace_tpu_torch.models import ray_tracer
    from raytrace_tpu_torch.testing import perturbed_problems

    out = {}
    for name in ("ase_small", "seed_small"):
        source, scale = row_source(name)
        for depth in (2, 4):
            for reorder in (False, True):
                ray_tracer.clear_pipeline_cache()
                salt = 70 + depth + 10 * reorder
                want = [eager_call(u) for u in perturbed_problems(
                    source, 6, salt=salt, scale=scale)]
                units = perturbed_problems(source, 6, salt=salt, scale=scale)
                t0 = time.perf_counter()
                got = launched(f"{name} stream", path_kernels_of(units[0]),
                               lambda: list(create_image_stream(
                                   units, "cuda", device=DEV, depth=depth,
                                   reorder=reorder)))
                dt = (time.perf_counter() - t0) / len(units)
                rel = worst_rel(got, want)
                pipe = ray_tracer.prepare_pipeline(
                    units[0], "cuda", reorder=reorder, device=DEV).pipeline
                if (len(got) != 6 or rel > PREPARED_REL
                        or len(pipe.graphs) != depth
                        or any(g.in_flight for g in pipe.graphs)):
                    fail(f"{name} stream depth {depth} reorder {reorder}: "
                         f"{len(got)} yields, rel L2 {rel}, "
                         f"{len(pipe.graphs)} graphs")
                print(f"{name} stream depth {depth} reorder {reorder}: "
                      f"{depth} graphs, 6 units, rel L2 against the eager "
                      f"calls <= {rel:.3e}; {dt:.5f} s/unit with the "
                      f"captures", flush=True)
                out[f"{name}_depth{depth}_reorder{int(reorder)}"] = dict(
                    rel=rel, s_per_unit=dt)
    return out


def prepared_failure():
    """A failing problem through the graph raises and dumps the eager
    call's rays; the graph is then free, and its next replay (a good
    problem of the same config) is right."""
    from raytrace_tpu_torch import create_image
    from raytrace_tpu_torch.models import ray_tracer
    from raytrace_tpu_torch.testing import synthetic_problem
    from raytrace_tpu_torch.utils.errors import RayTraceError, read_failures

    ray_tracer.clear_pipeline_cache()
    create_image(synthetic_problem(), "cuda", device=DEV)
    dumps = {}
    for how in ("graph", "eager"):
        # angles beyond 1.5 rad: every ray perpendicular (error -1); the
        # config, and so the graph, is the good problem's
        p = synthetic_problem()
        p.euv_beam.a = p.euv_beam.a + 1500.0
        dumps[how] = os.path.join(OUT_DIR, f"failed_{how}.dat")
        try:
            if how == "graph":
                create_image(p, "cuda", device=DEV,
                             failed_ray_path=dumps[how])
            else:
                prep = ray_tracer.prepare_pipeline(p, "cuda", device=DEV,
                                                   eager=True)
                ray_tracer._finalize_call(p, prep,
                                          prep.pipeline(*prep.operands),
                                          dumps[how])
        except RayTraceError:
            pass
        else:
            fail(f"failing problem ({how}): no RayTraceError")
    rays = {h: read_failures(path)[0] for h, path in dumps.items()}
    want = eager_call(synthetic_problem())
    got = create_image(synthetic_problem(), "cuda", device=DEV)
    pipe = ray_tracer.prepare_pipeline(synthetic_problem(), "cuda",
                                       device=DEV).pipeline
    rel = worst_rel([got], [want])
    if not (len(rays["graph"]) > 0
            and np.array_equal(rays["graph"], rays["eager"])
            and len(pipe.graphs) == 1 and rel <= PREPARED_REL):
        fail(f"failure through the graph: {len(rays['graph'])} rays dumped, "
             f"the eager call's {np.array_equal(rays['graph'], rays['eager'])}"
             f"; {len(pipe.graphs)} graphs; the next replay rel L2 {rel}")
    print(f"failing problem through the graph: raised, {len(rays['graph'])} "
          f"rays dumped, the eager call's; the graph's next replay within "
          f"{rel:.3e} of its eager call", flush=True)
    return dict(rays=len(rays["graph"]), next_rel=rel)


def prepared_meshes():
    """The mesh entries' graphs against the entries' chunk loops in turns
    (``MeshRunner(eager=True)``, the dispatch before the graphs): two
    entries on cuda:0, and every card on two or more; three units of each
    shipped shape, each within ``PREPARED_REL``."""
    from raytrace_tpu_torch.models import ray_tracer
    from raytrace_tpu_torch.parallel import sharding
    from raytrace_tpu_torch.parallel.mesh import make_mesh
    from raytrace_tpu_torch.testing import perturbed_problems

    meshes = {"2 entries on cuda:0": make_mesh(devices=("cuda:0", "cuda:0"))}
    if torch.cuda.device_count() >= 2:
        meshes["make_mesh()"] = make_mesh()
    out = {}
    for what, mesh in meshes.items():
        for name in ("ase_small", "seed_small"):
            source, scale = row_source(name)
            ray_tracer.clear_pipeline_cache()

            def run(eager, units):
                runner = sharding.MeshRunner(mesh, "cuda", eager=eager)
                return [sharding._finalize_sharded(runner.dispatch(u),
                                                   "unused.dat")
                        for u in units]
            want = uncounted(run, True, perturbed_problems(source, 3,
                                                           salt=83))
            units = perturbed_problems(source, 3, salt=83)
            got = launched(f"{name} mesh graphs on {what}",
                           path_kernels_of(units[0]), run, False, units)
            rel = worst_rel(got, want)
            prep = sharding.prepare_sharded(units[0], mesh, "cuda")
            n = [len(p.graphs) for p in prep.pipeline]
            if rel > PREPARED_REL or n != [1] * len(mesh):
                fail(f"{name} mesh graphs on {what}: rel L2 {rel} against "
                     f"the eager turns, graphs per entry {n}")
            print(f"{name} mesh graphs on {what}: a graph per entry, rel L2 "
                  f"against the eager turns <= {rel:.3e}", flush=True)
            out[f"{name} {what}"] = rel
    return out


def prepared_numbers():
    """The bench's rows of ``PREPARED_REPS``, eager and through graphs, in
    this run: s/call, the dispatch, the busy share, the capture, the nodes
    and the peak memory, printed row by row."""
    from raytrace_tpu_torch.tools import bench

    out = {}
    for eager in (True, False):
        res = bench.run(device=DEV, reps=PREPARED_REPS, stream_rounds={},
                        twins=(), out_dir=OUT_DIR, eager=eager)
        if not res["gates_ok"]:
            fail(f"bench rows eager {eager}: gates {res['gates']}")
        held = {n: res[f"{n}_graph_memory_check"] for n in PREPARED_REPS}
        if not eager and not (res["graph_memory_check"] is True
                              and all(v is True for v in held.values())):
            fail(f"bench rows through graphs: graph_memory_check {held}")
        out["eager" if eager else "graph"] = res
    for name in PREPARED_REPS:
        for how, res in out.items():
            p = name + "_"
            calls = res[p + "calls"]
            med = sorted(c["dispatch_s"] for c in calls)[len(calls) // 2]
            graph = (res[p + "graph"] or [{}])[0]
            mem = res[f"mem_after_{name}"]
            dev_ms = res[p + "device_s_per_call"] * 1e3
            print(f"{name} {how}: s/call best "
                  f"{res[p + 'best_seconds_per_call']:.5f} median "
                  f"{res[p + 'median_seconds_per_call']:.5f}; dispatch "
                  f"median {med:.5f} s; device {dev_ms:.3f} ms/call, busy "
                  f"{res[p + 'busy']:.3f}; warmup call "
                  f"{res[p + 'warmup_s']:.4f} s (capture "
                  f"{graph.get('capture_s', 0.0):.4f} s); nodes "
                  f"{graph.get('nodes')}; pool "
                  f"{graph.get('pool_bytes', 0) / 2 ** 30:.3f} GiB; peak "
                  f"{mem['max_memory_allocated'] / 2 ** 30:.3f} GiB, reserved "
                  f"{mem['memory_reserved'] / 2 ** 30:.3f} GiB, beyond the "
                  f"graphs' pools {res[p + 'reserved_over_pools_gib']:.3f} "
                  f"GiB (graph_memory_check "
                  f"{res[p + 'graph_memory_check']})", flush=True)
    return {how: {k: v for k, v in res.items()
                  if k.startswith(tuple(PREPARED_REPS))
                  or k.startswith("mem_after_")}
            for how, res in out.items()}


def phase_prepared():
    """Phase 12, the prepared whole-call pipeline on the card."""
    t0 = time.perf_counter()
    rec = dict(replays=prepared_replays(), goldens=prepared_goldens(),
               streams=prepared_streams(), failure=prepared_failure(),
               meshes=prepared_meshes(), numbers=prepared_numbers())
    rec["seconds"] = time.perf_counter() - t0
    print(f"prepared path: {rec['seconds']:.1f} s", flush=True)
    record["prepared"] = rec


#: phase 13's scope, and the kernels whose device events must lie in it
HOST_SCOPE = "create_image-annotated"
HOST_KERNELS = (("trace", "trace_kernel"),
                ("bin_deposit", "bin_deposit_kernel"),
                ("amplify", "amplify_seeded_kernel"))


def phase_host():
    """Phase 13, the host surface on the card: a ``seed_small`` call
    through its graph under ``profiler.scope(annotate=True)`` inside
    ``torch.profiler``; the range in the trace, the replay's B1, B2 and B3
    inside its wall window (as many as the graph captured), the scope's
    time at least the call's device time, ``get_time`` monotonic across
    the call."""
    from raytrace_tpu_torch import create_image
    from raytrace_tpu_torch.models import ray_tracer
    from raytrace_tpu_torch.utils.pio import printp
    from raytrace_tpu_torch.utils.timer import get_time, profiler

    dev = torch.device("cuda", torch.cuda.current_device())
    source, _scale = row_source("seed_small")
    ray_tracer.clear_pipeline_cache()
    create_image(source(), "cuda", device=dev)  # captures the graph
    p = source()
    before = profiler.totals[HOST_SCOPE], profiler.counts[HOST_SCOPE]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(dev)
    t0 = get_time()
    with torch.profiler.profile(activities=acts) as prof:
        with profiler.scope(HOST_SCOPE, annotate=True, device=dev):
            image, i_ang = create_image(p, "cuda", device=dev)
    t1 = get_time()
    check_output(image, i_ang, p)
    pipe = ray_tracer.prepare_pipeline(p, "cuda", device=dev).pipeline
    if len(pipe.graphs) != 1:
        fail(f"host surface: {len(pipe.graphs)} graphs of seed_small")
    # the range is a host event; the profiler mirrors it on the device
    # timeline as an annotation of the same name, which is no device work
    gpu = torch.autograd.DeviceType.CUDA
    events = prof.events()
    ranges = [e for e in events
              if e.name == HOST_SCOPE and e.device_type != gpu]
    mirrored = sum(e.name == HOST_SCOPE and e.device_type == gpu
                   for e in events)
    cuda = [e for e in events if e.device_type == gpu
            and e.name != HOST_SCOPE]
    if len(ranges) != 1:
        fail(f"host surface: {len(ranges)} host events named {HOST_SCOPE}")
    win = ranges[0].time_range
    kernels = {n: [e for e in cuda if tag in e.name]
               for n, tag in HOST_KERNELS}
    outside = {n: sum(not (win.start <= e.time_range.start
                           and e.time_range.end <= win.end) for e in ks)
               for n, ks in kernels.items()}
    device_s = sum(e.time_range.elapsed_us() for e in cuda) / 1e6
    scope_s = profiler.totals[HOST_SCOPE] - before[0]
    counts = {n: len(ks) for n, ks in kernels.items()}
    want = {n: pipe.cfg["launches"][n] for n in counts}
    rec = dict(window_ms=(win.end - win.start) / 1e3, scope_s=scope_s,
               device_s=device_s, device_events=len(cuda),
               mirrored=mirrored, get_time=[t0, t1], kernels=counts,
               outside=outside,
               scope_count=profiler.counts[HOST_SCOPE] - before[1])
    printp("host surface: seed_small through its graph under "
           "profiler.scope(%r, annotate=True): range %.3f ms in the trace "
           "(%d on the device timeline), kernels in it %s (outside %s) "
           "among %d device events, scope %.6f s >= device %.6f s; "
           "get_time %.6f -> %.6f s\n", HOST_SCOPE, rec["window_ms"],
           mirrored, counts, outside, len(cuda), scope_s, device_s, t0, t1)
    if (counts != want or min(counts.values()) <= 0 or any(outside.values())
            or rec["scope_count"] != 1 or not scope_s >= device_s > 0
            or not 0 <= t0 < t1 or t1 - t0 < scope_s):
        fail(f"host surface: {rec}")
    record["host"] = rec


#: phase 14's rows: the bench's source, ``-scale=`` and timed calls
F32_ROWS = {"ase_small": 3, "seed_small": 3, "seed_scale4": 3, "scale16": 2}
#: the f32 path's kernels: B1 and the f32 instantiations of B2 and B3
F32_KERNELS = ("trace", "bin_deposit_f32", "amplify_f32")
#: an f32 call against its f64 call (tests/test_golden.py's bound)
F32_REL = 1e-5


def f32_kernels_of(p):
    """The kernels an f32 call of ``p`` must launch: B1 and B2-f32, and
    B3-f32 unless the emissivity amplify (ASE) takes its place."""
    return tuple(n for n in F32_KERNELS
                 if n != "amplify_f32" or "amplify" in path_kernels_of(p))


def timed_split(p, **kw):
    """One synchronous call through the call path's stages: ``(result,
    {total_s, prep_s, dispatch_s, wait_s})``, as the bench splits it."""
    from raytrace_tpu_torch.models import ray_tracer

    t0 = time.perf_counter()
    prep = ray_tracer.prepare_pipeline(p, "cuda", device=DEV, **kw)
    t1 = time.perf_counter()
    outs = prep.pipeline(*prep.operands)
    t2 = time.perf_counter()
    out = ray_tracer._finalize_call(p, prep, outs, os.path.join(
        OUT_DIR, "f32_failed_rays.dat"))
    t3 = time.perf_counter()
    return out, dict(total_s=t3 - t0, prep_s=t1 - t0, dispatch_s=t2 - t1,
                     wait_s=t3 - t2)


def phase_f32():
    """Phase 14, the f32 spectrum (``spectrum_dtype=float32``,
    ``raytrace_tpu``'s default) on the card: both fixtures against their
    goldens; the bench's ``ase_small``, ``seed_small``, ``seed_scale4``
    and ``scale16`` rows through their f32 graphs (a warm-up that captures,
    then timed calls with the stage split, in turns with the f64 call of
    the same problem, which does not count), each f32 result within 1e-5
    of the f64 call, the device time per kernel under the profiler, and
    what the card reserves beyond the cached graphs' pools (the bench's
    ``graph_memory_check``: the f32 and f64 graphs of a row are two
    pools); an f32 stream at depth 2 and f32 sharded calls and a mesh
    stream on two entries of the card, each within 1e-12 of the
    synchronous f32 call. B1, B2-f32 and B3-f32 must have launched."""
    from raytrace_tpu_torch import (check_ans, create_image,
                                    create_image_stream, load_input)
    from raytrace_tpu_torch.models import ray_tracer
    from raytrace_tpu_torch.parallel.mesh import make_mesh
    from raytrace_tpu_torch.parallel.sharding import create_image_sharded
    from raytrace_tpu_torch.testing import (fresh_problem,
                                            perturbed_problems)

    F32 = torch.float32
    dev = torch.device("cuda", torch.cuda.current_device())
    for name in ("golden_ase.dat", "golden_seed.dat"):
        p, image0, i_ang0 = load_input(os.path.join(FIXTURES, name))
        image, i_ang = launched(f"{name} in f32", f32_kernels_of(p),
                                create_image, p, "cuda",
                                spectrum_dtype=F32, device=DEV)
        check_output(image, i_ang, p)
        r_img, r_ang = rel_l2(image, image0), rel_l2(i_ang, i_ang0)
        if not check_ans(image0, i_ang0, image, i_ang) or max(r_img,
                                                              r_ang) >= 1e-5:
            fail(f"{name} in f32: check_ans or rel L2 image {r_img} I_ang "
                 f"{r_ang}")
        print(f"{name} in f32: check_ans ok, rel L2 image {r_img:.3e} I_ang "
              f"{r_ang:.3e}", flush=True)
        record[f"{name}_f32"] = dict(rel_image=r_img, rel_iang=r_ang)

    ray_tracer.clear_pipeline_cache()
    for row, reps in F32_ROWS.items():
        source, scale = row_source(row)
        p = fresh_problem(source, scale)
        rays = p.seed_beam if p.seed is not None else p.euv_beam
        rays = rays.nx * rays.ny * rays.na * rays.nb
        torch.cuda.reset_peak_memory_stats(dev)
        want = uncounted(create_image, p, "cuda", device=DEV)
        t0 = time.perf_counter()
        create_image(p, "cuda", spectrum_dtype=F32, device=DEV)
        warm = time.perf_counter() - t0
        split32, split64 = [], []
        for r in range(reps):
            before = {n: w.launch_count for n, w in WRAPPERS.items()}
            got, sp = timed_split(p, spectrum_dtype=F32)
            split32.append(sp)
            if r == 0:
                LAUNCHES_PER_CALL[f"{row}_f32"] = {
                    n: w.launch_count - before[n]
                    for n, w in WRAPPERS.items()}
            split64.append(uncounted(timed_split, p)[1])
        check_output(*got, p)
        rel = max(rel_l2(got[0], want[0]), rel_l2(got[1], want[1]))
        if rel > F32_REL:
            fail(f"{row} in f32: rel L2 {rel} against the f64 call")
        peak = torch.cuda.max_memory_allocated(dev)
        reserved = torch.cuda.memory_reserved(dev)
        over = reserved - ray_tracer.graph_pool_bytes(dev)
        mem_ok = over <= max(256 * 2 ** 20, 0.10 * peak)
        if not mem_ok:
            fail(f"{row} in f32: the card reserves {over} bytes beyond the "
                 f"graphs' pools (peak {peak})")
        prof32 = profile_calls(lambda: create_image(
            p, "cuda", spectrum_dtype=F32, device=DEV), n=2)
        prof64 = uncounted(profile_calls, lambda: create_image(
            p, "cuda", device=DEV), n=2)
        best32 = min(x["total_s"] for x in split32)
        best64 = min(x["total_s"] for x in split64)
        med = {k: sorted(x[k] for x in split32)[reps // 2]
               for k in ("prep_s", "dispatch_s", "wait_s")}
        print(f"{row} in f32 ({rays} rays): warm-up and capture {warm:.4f} "
              f"s; s/call f32 {[round(x['total_s'], 5) for x in split32]} "
              f"(best {best32:.5f}), f64 in turns "
              f"{[round(x['total_s'], 5) for x in split64]} (best "
              f"{best64:.5f}); median split f32 {med}; rel L2 against f64 "
              f"{rel:.3e}; device ms/call f32 {prof32[0]:.3f} "
              f"({prof32[2]}), f64 {prof64[0]:.3f} ({prof64[2]}); "
              f"launches per call {LAUNCHES_PER_CALL[f'{row}_f32']}; peak "
              f"{peak / 2 ** 30:.3f} GiB, reserved {reserved / 2 ** 30:.3f} "
              f"GiB, beyond the pools {over / 2 ** 30:.3f} GiB",
              flush=True)
        record[f"{row}_f32"] = dict(
            rays=rays, warmup_s=warm, split_f32=split32, split_f64=split64,
            rel_vs_f64=rel, device_ms_f32=prof32[0],
            kernels_ms_f32=prof32[2], launches_f32=prof32[1],
            device_ms_f64=prof64[0], kernels_ms_f64=prof64[2],
            peak_gib=peak / 2 ** 30, reserved_gib=reserved / 2 ** 30,
            reserved_over_pools_gib=over / 2 ** 30, graph_memory_check=mem_ok)
        ray_tracer.clear_pipeline_cache()

    mesh2 = make_mesh(devices=("cuda:0", "cuda:0"))
    for row in ("ase_small", "seed_small"):
        source, _ = row_source(row)
        units = perturbed_problems(source, 4, salt=7)
        need = f32_kernels_of(units[0])
        sync = [uncounted(create_image, u, "cuda", spectrum_dtype=F32,
                          device=DEV)
                for u in perturbed_problems(source, 4, salt=7)]

        def stream(**kw):
            return list(create_image_stream(
                perturbed_problems(source, 4, salt=7), "cuda", None, F32,
                depth=2, **kw))

        got = {"stream": launched(f"{row} f32 stream", need, stream,
                                  device=DEV),
               "mesh stream": launched(f"{row} f32 mesh stream", need,
                                       stream, mesh=mesh2),
               "sharded": [launched(f"{row} f32 sharded", need,
                                    create_image_sharded, u, mesh2, "cuda",
                                    None, F32) for u in units]}
        worst = {k: worst_rel(v, sync) for k, v in got.items()}
        if max(worst.values()) > 1e-12 or any(len(v) != 4
                                              for v in got.values()):
            fail(f"{row} in f32: against the synchronous f32 call {worst}")
        print(f"{row} in f32, 4 units with tables all different: rel L2 "
              f"against the synchronous f32 call {worst}", flush=True)
        record[f"{row}_f32_stream_mesh"] = worst


#: phase 11's timed calls of each bench row, on one card and on the mesh
MULTI_REPS = {"ase_small": 3, "seed_small": 3, "scale64": 2,
              "seed_scale4": 3}
#: a call on another card, and a sharded call, against the call on cuda:0:
#: B2's f64 atomics add in an order that changes from call to call, so two
#: calls on one card already differ at about 1e-16
MULTI_REL = 1e-12


def card_lines():
    """Every card's name and power limit, as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()


def topology(cards):
    """Peer access between every two cards of ``cards`` (torch's
    ``can_device_access_peer``) and ``nvidia-smi topo -m`` as text (or what
    it printed when it failed)."""
    idx = [d.index for d in dict.fromkeys(cards)]
    peer = {f"{i}->{j}": torch.cuda.can_device_access_peer(i, j)
            for i in idx for j in idx if i != j}
    try:
        r = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                           text=True, timeout=60)
        topo = (r.stdout + r.stderr).strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        topo = f"nvidia-smi topo -m: {e}"
    return peer, topo


def launched_on(what, names, devices, fn, *args, **kw):
    """``fn(*args, **kw)``; fails unless each of ``names`` launched on each
    of ``devices`` in it (the wrappers' per-device counts). Returns the
    result and the launches per kernel and device."""
    devices = list(dict.fromkeys(torch.device(d) for d in devices))
    before = {n: dict(WRAPPERS[n].device_launches) for n in names}
    out = fn(*args, **kw)
    made = {n: {str(d): WRAPPERS[n].device_launches.get(d, 0)
                - before[n].get(d, 0) for d in devices} for n in names}
    if min(v for m in made.values() for v in m.values()) <= 0:
        fail(f"{what}: launches per card {made}; each of {names} must "
             f"launch on each of {[str(d) for d in devices]}")
    return out, made


def kernel_chain(dev):
    """B1, B3 and B2 (bins output) on 65,536 rays of the seeded shipped
    shape on ``dev``, through the wrappers, with ``cuda:0`` left current;
    every output on the host."""
    from raytrace_tpu_torch.models.problem import prepare_beam, prepare_gain
    from raytrace_tpu_torch.ops import (amplify_kernel, binning, cuda_lib,
                                        deposit_kernel, trace_kernel)
    from raytrace_tpu_torch.testing import (SEED_SHAPE, seed_factors,
                                            source_rays, synthetic_problem)

    p = synthetic_problem(**SEED_SHAPE)
    n = 65536
    gain = prepare_gain(p.gain, dev)
    rays = source_rays(p, n, dev)
    res = trace_kernel.trace_batch(rays, p.N, p.euv_beam.dz, gain, 2,
                                   use_emis=False)
    f, fv = seed_factors(p, n, dev)
    Iv, flags = amplify_kernel.amplify_gain(f, fv, res.escaped, res.ivl,
                                            res.gvl, gain.gv[1:])
    beam = prepare_beam(p.euv_beam, dev)
    coords = binning.source_coords(res, rays, 2)
    ok = ~(res.perp | (flags != 0))
    K = Iv.shape[1]
    acc = (torch.zeros((beam.x.shape[0] * beam.y.shape[0], K),
                       dtype=torch.float64, device=dev),
           torch.zeros((beam.a.shape[0] * beam.b.shape[0], 1),
                       dtype=torch.float64, device=dev))
    deposit_kernel.bin_deposit(Iv, coords, ok, beam, 2, 1.0, *acc)
    bins = deposit_kernel._launch(
        cuda_lib.load_library(), Iv, coords, ok, beam, 2, 1.0,
        *(torch.zeros_like(a) for a in acc),
        torch.cuda.current_stream(dev).cuda_stream, bins=True)
    torch.cuda.synchronize(dev)
    return dict({f: getattr(res, f).cpu() for f in res._fields},
                Iv=Iv.cpu(), flags=flags.cpu(), bins=bins.cpu(),
                image=acc[0].cpu(), i_ang=acc[1].cpu())


def multicard_single(cards):
    """Single calls on each card with ``cuda:0`` current: the kernels'
    per-ray outputs bitwise equal to cuda:0's, each call within
    ``MULTI_REL`` of cuda:0's (beside two calls on cuda:0 itself)."""
    from raytrace_tpu_torch import create_image, load_input
    from raytrace_tpu_torch.testing import (ASE_SHAPE, SEED_SHAPE,
                                            synthetic_problem)

    torch.cuda.set_device(0)
    home = torch.device("cuda:0")
    others = [d for d in dict.fromkeys(cards) if d != home]
    want = uncounted(kernel_chain, home)
    for dev in others:
        got, made = launched_on(f"kernels on {dev}",
                                ("trace", "amplify", "bin_deposit"), (dev,),
                                kernel_chain, dev)
        exact = [k for k in ("gvl", "evl", "ivl", "exit_x", "exit_y",
                             "exit_a", "exit_b", "escaped", "perp", "Iv",
                             "flags", "bins")
                 if not torch.equal(got[k], want[k])]
        rel = max(rel_l2(got[k].numpy(), want[k].numpy())
                  for k in ("image", "i_ang"))
        if exact or rel > MULTI_REL or torch.cuda.current_device() != 0:
            fail(f"kernels on {dev}: not bitwise equal to cuda:0's {exact}, "
                 f"deposit rel L2 {rel}, current device "
                 f"{torch.cuda.current_device()}")
        print(f"kernels on {dev} with cuda:0 current: B1, B3 and B2's bins "
              f"bitwise equal to cuda:0's, B2's image and I_ang within "
              f"{rel:.3e}; launches {made}", flush=True)
    cases = [(name, functools.partial(
        lambda path: load_input(path)[0], os.path.join(FIXTURES, name)))
        for name in ("golden_ase.dat", "golden_seed.dat")]
    cases += [(name, functools.partial(synthetic_problem, **shape))
              for name, shape in (("ase", ASE_SHAPE), ("seed", SEED_SHAPE))]
    out = {}
    for name, make in cases:
        p = make()
        base = uncounted(create_image, p, "cuda", device=home)
        again = uncounted(create_image, make(), "cuda", device=home)
        row = dict(repeat_cuda0=max(rel_l2(again[0], base[0]),
                                    rel_l2(again[1], base[1])),
                   repeat_bitwise=bool(np.array_equal(again[0], base[0])
                                       and np.array_equal(again[1], base[1])))
        for dev in others:
            got, _ = launched_on(f"{name} on {dev}", path_kernels_of(p),
                                 (dev,), create_image, make(), "cuda",
                                 device=dev)
            check_output(*got, p)
            rel = max(rel_l2(got[0], base[0]), rel_l2(got[1], base[1]))
            if rel > MULTI_REL or torch.cuda.current_device() != 0:
                fail(f"{name} on {dev}: rel L2 {rel} against cuda:0, current "
                     f"device {torch.cuda.current_device()}")
            row[str(dev)] = dict(rel=rel, bitwise=bool(
                np.array_equal(got[0], base[0])
                and np.array_equal(got[1], base[1])))
        print(f"{name} single calls with cuda:0 current: {row}", flush=True)
        out[name] = row
    return out


def multicard_sharded(cards):
    """Both fixtures through create_image_sharded on ``cards`` against their
    goldens, every card launching its kernels."""
    from raytrace_tpu_torch import check_ans, load_input
    from raytrace_tpu_torch.parallel.sharding import create_image_sharded

    out = {}
    for name in ("golden_ase.dat", "golden_seed.dat"):
        p, image0, i_ang0 = load_input(os.path.join(FIXTURES, name))
        (image, i_ang), made = launched_on(
            f"{name} sharded on {len(cards)} cards", path_kernels_of(p),
            cards, create_image_sharded, p, cards, "cuda")
        check_output(image, i_ang, p)
        r_img, r_ang = rel_l2(image, image0), rel_l2(i_ang, i_ang0)
        if (not check_ans(image0, i_ang0, image, i_ang) or r_img >= 1e-5
                or r_ang >= 1e-5):
            fail(f"{name} sharded on {len(cards)} cards: check_ans or rel L2 "
                 f"image {r_img} I_ang {r_ang}")
        print(f"{name} sharded on {[str(d) for d in cards]}: check_ans ok, "
              f"rel L2 image {r_img:.3e} I_ang {r_ang:.3e}; launches "
              f"{made}", flush=True)
        out[name] = dict(rel_image=r_img, rel_iang=r_ang, launches=made)
    return out


def _gib(x):
    """GiB to three places, also per card; None stays None."""
    if isinstance(x, dict):
        return {d: _gib(v) for d, v in x.items()}
    return None if x is None else round(x, 3)


def multicard_rows(cards):
    """The bench's rows on one card and on ``cards`` in one run
    (``tools/bench.run`` with ``mesh``), once with the calls run from
    Python (``eager``) and once through their graphs: every gate true,
    every card launching B1 and B2 (and B3 on the seeded rows) in each mesh
    row; the s/call beside the 1-card s/call, the dispatch, the busy
    share, each entry's capture and nodes, each card's peak memory, first
    and last marks and the reduction's time."""
    from raytrace_tpu_torch.tools import bench

    D = len(cards)
    t0 = time.perf_counter()
    out = {}
    for eager in (True, False):
        how = "eager" if eager else "graph"
        res = bench.run(device=cards[0], reps=MULTI_REPS, stream_rounds={},
                        twins=(), out_dir=OUT_DIR, mesh=D, eager=eager)
        if res["mesh_devices"] != [str(d) for d in cards]:
            fail(f"bench mesh {res['mesh_devices']}, not {cards}")
        rows = {}
        for name in MULTI_REPS:
            p = f"{name}_mesh{D}_"
            need = ("trace", "bin_deposit") + (
                ("amplify",) if name.startswith("seed") else ())
            per_card = res[p + "launches_per_card"]
            short = [(k, str(d)) for k in need for d in cards
                     if per_card[k].get(str(d), 0) <= 0]
            if short:
                fail(f"{p[:-1]} {how}: no launches of {short}: {per_card}")
            held = (res[f"{name}_graph_memory_check"],
                    res[p + "graph_memory_check"])
            if not eager and held != (True, True):
                fail(f"{p[:-1]}: graph_memory_check (1 card, mesh) {held}: "
                     f"beyond the graphs' pools "
                     f"{res[p + 'reserved_over_pools_gib']} GiB")
            calls = res[p + "calls"]
            best = min(calls, key=lambda c: c["total_s"])
            mem = res[f"mem_after_{name}_mesh{D}"]
            graphs = [g and g[0] for g in res[p + "graphs"] or []]
            rows[name] = dict(
                rays=res[p + "n_rays"],
                single_s=res[f"{name}_best_seconds_per_call"],
                mesh_s=res[p + "best_seconds_per_call"],
                mesh_median_s=res[p + "median_seconds_per_call"],
                speedup=res[p + "speedup"],
                rel=res[p + "rel_vs_single"], launches_per_card=per_card,
                dispatch_median_s=sorted(
                    c["dispatch_s"] for c in calls)[len(calls) // 2],
                busy=res[p + "busy"], single_busy=res[f"{name}_busy"],
                capture_s=[g and g["capture_s"] for g in graphs],
                nodes=[g and g["nodes"]["kernel"] for g in graphs],
                peak_gib={d: m["max_memory_allocated"] / 2 ** 30
                          for d, m in mem.items()},
                single_peak_gib=res[f"mem_after_{name}"][
                    "max_memory_allocated"] / 2 ** 30,
                reserved_gib=res[p + "reserved_gib"],
                over_pools_gib=res[p + "reserved_over_pools_gib"],
                single_reserved_gib=res[f"{name}_reserved_gib"],
                single_over_pools_gib=res[
                    f"{name}_reserved_over_pools_gib"],
                reduce_ms=[c["reduce_s"] * 1e3 for c in calls],
                best_call=best)
            r = rows[name]
            print(f"{name} ({r['rays']} rays) {how}: {D} cards "
                  f"{r['mesh_s']:.5f} s/call (timed "
                  f"{[round(c['total_s'], 5) for c in calls]}), 1 card "
                  f"{r['single_s']:.5f}, speedup {r['speedup']:.3f}; rel L2 "
                  f"against 1 card {r['rel']:.3e}; dispatch median "
                  f"{r['dispatch_median_s']:.5f} s; busy per card "
                  f"{r['busy']:.3f} (1 card {r['single_busy']:.3f}); "
                  f"capture per entry {r['capture_s']} s, kernel nodes "
                  f"{r['nodes']}; split of the best call: dispatch "
                  f"{best['dispatch_s']:.5f} s, wait {best['wait_s']:.5f} s, "
                  f"reduction {best['reduce_s'] * 1e3:.4f} ms on the device; "
                  f"peak GiB per card "
                  f"{ {d: round(v, 3) for d, v in r['peak_gib'].items()} } "
                  f"(1 card {r['single_peak_gib']:.3f}); reserved GiB per "
                  f"card {_gib(r['reserved_gib'])} (1 card "
                  f"{_gib(r['single_reserved_gib'])}), beyond the graphs' "
                  f"pools {_gib(r['over_pools_gib'])} (1 card "
                  f"{_gib(r['single_over_pools_gib'])}); launches per call "
                  f"per card {per_card}", flush=True)
            for e in best["cards"]:
                print(f"  {name} {how} {e['device']}: first mark "
                      f"{e['first']:.3f} ms, last {e['last']:.3f} ms after "
                      f"the card's start", flush=True)
        gates = res["gates"]
        print(f"multi-card bench gates ({how}) {gates}", flush=True)
        if not res["gates_ok"] or not all(v is True for k, v in gates.items()
                                          if "mesh" in k):
            fail(f"multi-card rows ({how}): gates {gates}")
        out[how] = dict(rows=rows, gates=gates, artifact=res)
    print(f"multi-card rows: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def multicard_profile(cards):
    """Device time per kernel of one call of each shipped shape on cuda:0
    and sharded on ``cards`` (summed over the cards), under the profiler:
    stride D shortens B2's runs of equal exit bins."""
    from raytrace_tpu_torch import create_image
    from raytrace_tpu_torch.parallel.sharding import create_image_sharded
    from raytrace_tpu_torch.testing import (ASE_SHAPE, SEED_SHAPE,
                                            synthetic_problem)

    out = {}
    for name, shape in (("ase", ASE_SHAPE), ("seed", SEED_SHAPE)):
        p = synthetic_problem(**shape)
        prof = {"1 card": uncounted(profile_calls, lambda: create_image(
                    p, "cuda", device="cuda:0")),
                f"{len(cards)} cards": profile_calls(
                    lambda: create_image_sharded(p, cards, "cuda"))}
        for what, (dev_ms, n_launch, per) in prof.items():
            print(f"{name} shipped shape on {what} under the profiler: "
                  f"device {dev_ms:.3f} ms/call (all cards), {n_launch:.1f} "
                  f"kernel launches/call, B1 {per['trace']:.3f}, B2 "
                  f"{per['bin_deposit']:.3f}, B3 {per['amplify']:.3f} "
                  f"ms/call", flush=True)
        out[name] = prof
    return out


def multicard_stream(cards):
    """create_image_stream(mesh=cards) at depth 2 over 4 perturbed units
    of each shipped shape: every yield within ``MULTI_REL`` of the
    synchronous sharded call, every card launching."""
    from raytrace_tpu_torch import create_image_stream
    from raytrace_tpu_torch.parallel.sharding import create_image_sharded
    from raytrace_tpu_torch.testing import (ASE_SHAPE, SEED_SHAPE,
                                            perturbed_problems,
                                            synthetic_problem)

    out = {}
    for name, shape in (("ase", ASE_SHAPE), ("seed", SEED_SHAPE)):
        source = functools.partial(synthetic_problem, **shape)
        sync = [uncounted(create_image_sharded, u, cards, "cuda")
                for u in perturbed_problems(source, 4, salt=5)]
        units = perturbed_problems(source, 4, salt=5)

        def stream():
            marks, worst = [], 0.0
            for k, (image, i_ang) in enumerate(create_image_stream(
                    units, "cuda", mesh=cards, depth=2)):
                marks.append(time.perf_counter())
                check_output(image, i_ang, units[k])
                worst = max(worst, rel_l2(image, sync[k][0]),
                            rel_l2(i_ang, sync[k][1]))
            return marks, worst

        t0 = time.perf_counter()
        (marks, worst), made = launched_on(f"mesh stream {name}",
                                           path_kernels_of(units[0]), cards,
                                           stream)
        if len(marks) != 4 or worst > MULTI_REL:
            fail(f"mesh stream {name}: {len(marks)} yields, worst rel L2 "
                 f"against the sharded call {worst}")
        per_call = (marks[-1] - t0) / 4
        print(f"mesh stream {name} on {len(cards)} cards, depth 2: rel L2 vs "
              f"sync <= {worst:.3e}; fill {marks[0] - t0:.5f} s, s/call "
              f"{per_call:.5f}; launches {made}", flush=True)
        out[name] = dict(worst_rel=worst, fill_s=marks[0] - t0,
                         per_call_s=per_call)
    return out


def multicard_processes(cards):
    """As subprocesses: the CLI's ``-multichip -methods=cuda`` on both
    fixtures; its group of one rank per card (``-nprocs``) on both fixtures
    and both shipped shapes, with the backend ``distributed.backend_for``
    gives; the rank harness (``tools/run_distributed.py``: gather_all,
    sum_scalar, host_sum_arrays, the stride partition and a sharded call
    summed over the ranks) and the production loop with one rank per card
    against one rank."""
    import re

    from raytrace_tpu_torch.parallel import distributed

    n = len(cards)
    backend = distributed.backend_for(n, torch.cuda.device_count(), False)
    files = [os.path.join(FIXTURES, name)
             for name in ("golden_ase.dat", "golden_seed.dat")]
    what = "CLI -methods=cuda -multichip -iterations=3 on the fixtures"
    (out, rc), = run_children([[sys.executable, "-m",
                                "raytrace_tpu_torch.utils.cli",
                                "-methods=cuda", "-multichip",
                                "-iterations=3", *files]], 300, what,
                              gate_errors_ok=True)
    label = f"multichip[{torch.cuda.device_count()}]"
    if ("Answers do not match" in out or rc != cli_gate_errors(out)
            or out.count(f"Running {label} on ") != 2):
        print(out[-4000:], flush=True)
        fail(f"{what}: exit code {rc}, two '{label}' rows expected")
    print(f"{what}: golden checks passed on the {label} rows; exit code {rc}",
          flush=True)
    res = dict(multichip_cli=dict(exit_code=rc))
    res["nprocs_cli"] = cli_ranks(
        f"CLI -methods=cuda -nprocs={n} -iterations=3 on the fixtures and "
        f"the shipped shapes", files + shipped_cells(), nprocs=n,
        backend=backend)
    harness = rank_tool("run_distributed.py", n)
    (one, many), outs = production_loops(n, extra=harness)
    worst = max(abs(a - b) / a for a, b in zip(one, many))
    if worst > 1e-10:
        fail(f"production loop: E_sum 1 rank {one}, {n} ranks {many}")
    joined = f"process group: {n} ranks, backend {backend}"
    for pid, (hout, _rc) in enumerate(outs[-n:]):
        checks = re.findall(rf"CHECK\[{pid}\] \S+: pass", hout)
        if f"RESULT[{pid}] ALL_PASS" not in hout or len(checks) != 10:
            print(hout[-4000:], flush=True)
            fail(f"rank harness, rank {pid}: {len(checks)} checks passed")
    if joined not in outs[-n][0] or joined not in outs[1][0]:
        fail(f"rank harness or production loop: no line '{joined}'")
    print(f"rank harness on {n} ranks ({backend}): every check passed on "
          f"every rank; production loop on {n} ranks: E_sum 1 rank {one}, "
          f"{n} ranks {many}, rel {worst:.3e}", flush=True)
    res.update(production_loop=dict(one=one, many=many, rel=worst),
               backend=backend)
    return res


def phase_multicard(cards=None):
    """Phase 11, the multi-card path: every card's line, peer access and
    the topology; single calls on each card with cuda:0 current; the
    sharded call on ``cards`` (``make_mesh()`` by default); the bench's rows
    on one card and on the mesh; the mesh stream; the CLI, the rank
    harness and the production loop on one rank per card."""
    from raytrace_tpu_torch.parallel.mesh import make_mesh

    cards = make_mesh(devices=cards)
    t0 = time.perf_counter()
    lines = card_lines()
    for line in lines:
        print(f"card: {line}", flush=True)
    peer, topo = topology(cards)
    print(f"peer access {peer}; nvidia-smi topo -m: {topo}", flush=True)
    rec = dict(cards=lines, peer=peer, topo=topo, mesh=[str(d) for d in cards])
    rec["single"] = multicard_single(cards)
    rec["sharded"] = multicard_sharded(cards)
    rec["rows"] = multicard_rows(cards)
    rec["stream"] = multicard_stream(cards)
    # the profiler last in this process: the timings above run without it
    rec["profile"] = multicard_profile(cards)
    rec["processes"] = multicard_processes(cards)
    rec["seconds"] = time.perf_counter() - t0
    print(f"multi-card path: {rec['seconds']:.1f} s", flush=True)
    record["multicard"] = rec


T_START = time.perf_counter()


#: the one line a run on fewer than two cards prints in place of phase 11
MULTICARD_NOTE = ("phase 11 (the multi-card path) needs two or more cards: "
                  "run python3 chip_smoke.py --multicard on a host with four")


def run_path(what, phase, names):
    """Drive one path with every count at 0 (the totals and the per-device
    counts); each kernel of the path must have launched."""
    for w in WRAPPERS.values():
        w.launch_count = 0
        w.device_launches.clear()
    out = phase()
    counts = {n: WRAPPERS[n].launch_count for n in names}
    print(f"launches on the {what}: {counts}", flush=True)
    for n, c in counts.items():
        if c <= 0:
            fail(f"kernel {n} was not launched on the {what}")
    return out, counts


def finish(name, extra_lines=()):
    """Write the record, print ``extra_lines``, every card's line and the
    result line."""
    record["seconds"] = time.perf_counter() - T_START
    print(f"chip_smoke: every phase passed in {record['seconds']:.1f} s",
          flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, name), "w") as f:
        json.dump(record, f, indent=1)
    for line in extra_lines:
        print(line, flush=True)
    print("\n".join(card_lines()), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main(argv) -> int:
    multicard = "--multicard" in argv
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    if multicard and torch.cuda.device_count() < 2:
        print(f"FAIL: --multicard: {torch.cuda.device_count()} card visible; "
              f"{MULTICARD_NOTE}", flush=True)
        return 1
    card = card_line()
    print(card, flush=True)
    from raytrace_tpu_torch.ops import (amplify_kernel, cuda_lib,
                                        deposit_kernel, trace_kernel)
    from raytrace_tpu_torch.tools import gather_probe

    t0 = time.perf_counter()
    cuda_lib.load_library()
    info = cuda_lib.build_info()
    print(f"kernels built in {info['seconds']:.2f} s (nvcc), loaded in "
          f"{time.perf_counter() - t0:.2f} s: {info['path']}", flush=True)
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)
    record.update(card=card, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=info["seconds"])
    WRAPPERS.update({"trace": trace_kernel, "bin_deposit": deposit_kernel,
                     "amplify": amplify_kernel,
                     "bin_deposit_f32": deposit_kernel.F32,
                     "amplify_f32": amplify_kernel.F32,
                     "gather_probe": gather_probe})
    path_kernels = ("trace", "bin_deposit", "amplify")

    if multicard:
        _, record["multicard_launches"] = run_path(
            "multi-card path", phase_multicard, path_kernels)
        finish("chip_smoke_multicard.json")
        return 0

    results = {}
    phase_kernels(results)

    outs, launches = run_path("main path", phase_main_path, path_kernels)
    _, stream_launches = run_path("stream path", phase_stream, path_kernels)
    _, probe_launches = run_path("probe path", phase_probe_path,
                                 ("gather_probe",))
    launches.update(probe_launches)
    record["stream_launches"] = stream_launches

    phase_plain(outs)
    _, record["multi_launches"] = run_path("multi-device path", phase_multi,
                                           path_kernels)
    _, record["fuzz_launches"] = run_path("fuzz path", phase_fuzz,
                                          path_kernels)
    _, record["medium_launches"] = run_path("medium-scale path",
                                            phase_medium, path_kernels)
    _, record["prepared_launches"] = run_path("prepared path",
                                              phase_prepared, path_kernels)
    _, record["host_launches"] = run_path("host surface", phase_host,
                                          path_kernels)
    _, f32_launches = run_path("f32 path", phase_f32, F32_KERNELS)
    launches.update({n: f32_launches[n] for n in F32_KERNELS
                     if n.endswith("_f32")})
    record["f32_launches"] = f32_launches
    if torch.cuda.device_count() >= 2:
        _, record["multicard_launches"] = run_path(
            "multi-card path", phase_multicard, path_kernels)
    else:
        print(MULTICARD_NOTE, flush=True)

    kernels = []
    for name, src, replaces in (
            ("trace", "trace.cu", "raytrace_tpu/ops/pallas_kernel.py:402"),
            ("bin_deposit", "deposit.cu",
             "raytrace_tpu/ops/deposit_kernel.py:76"),
            ("amplify", "amplify.cu",
             "raytrace_tpu/ops/pallas_amplify.py:123"),
            ("bin_deposit_f32", "deposit.cu",
             "raytrace_tpu/ops/deposit_kernel.py:76"),
            ("amplify_f32", "amplify.cu",
             "raytrace_tpu/ops/pallas_amplify.py:123"),
            ("gather_probe", "gather_probe.cu", "tools/vpu_probe.py:112")):
        # the f32 instantiations' launches on the f32 path's calls
        calls = ("seed_small_f32", "ase_small_f32") if "f32" in name \
            else ("seed", "ase")
        kernels.append(dict(
            name=name, route="cuda", source="raytrace_tpu_torch/csrc/" + src,
            replaces=replaces, launches=launches[name], **results[name],
            launches_per_call={
                "seeded": LAUNCHES_PER_CALL[calls[0]][name],
                "ase": LAUNCHES_PER_CALL[calls[1]][name]}))
    record["kernels"] = kernels
    finish("chip_smoke.json", [json.dumps({"kernels": kernels})])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
