#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

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
   the atomics it issues; probe P1 at K 64 (bitwise);
4. with every launch count at 0: ``create_image`` on both golden fixtures
   (``check_ans`` at 5e-6 and a two-sided relative L2 below 1e-5 against
   the embedded golden), then the two shipped-shape synthetics (ASE
   60x25x19x14 = 399,000 rays, nv 52; seeded 120x25x51x51 = 7,803,000
   rays, nv 82; N 3, 106x26 gain grid) with one warmup and three timed
   calls each, the launches of each kernel in one call counted; B1, B2
   and B3 must have launched in this run;
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
   (two ranks on the card, joined by gloo; each rank's s/call) on both
   fixtures and on both shipped shapes, saved under ``build/`` with the
   single call's result as their golden: every golden check passed, and
   an exit code that is exactly the number of the reference's
   timing-stability gate errors the ranks printed (two ranks time-slicing
   the card trip them in about half the runs, on either kind of input);
   and ``raytrace_tpu_torch/tools/production_loop.py`` with 1 and with 2
   ranks, every rank on cuda:0 (E_sum within 1e-10 relative);
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
   reproduce ``error -1`` for every dumped ray.

Prints one JSON line of per-kernel results, the card line, and as its last
line ``{"ok": true, "device": {...}}``. A longer record of every measurement
goes to ``chiprun_out/chip_smoke.json``. Needs no network; uses one card.
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
        check_output(image, i_ang, p)
        best = min(times)
        print(f"{name} shipped shape ({rays} rays): warmup {warm:.4f} s, "
              f"s/call {[round(t, 5) for t in times]}, best {best:.5f} s, "
              f"{rays / best:.4e} rays/s, peak device memory "
              f"{peak_gib:.3f} GiB; launches per call "
              f"{LAUNCHES_PER_CALL[name]}", flush=True)
        record[f"{name}_call"] = dict(rays=rays, warmup_s=warm,
                                      times_s=times, rays_per_s=rays / best,
                                      peak_gib=peak_gib)
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


def production_loops():
    """E_sum per step of the production loop tool with 1 rank and, at the
    same time, with 2 ranks on the card (rank 0's lines)."""
    import re
    import socket

    tool = os.path.join("raytrace_tpu_torch", "tools", "production_loop.py")
    s = socket.socket()
    s.bind(("localhost", 0))
    port = str(s.getsockname()[1])
    s.close()
    outs = run_children([[sys.executable, tool]]
                        + [[sys.executable, tool, str(pid), "2", port]
                           for pid in range(2)], 300,
                        "production loop, 1 rank and 2 ranks")
    esums = []
    for (out, _rc), ranks in zip(outs[:2], (1, 2)):
        esum = [float(m) for m in re.findall(r"E_sum=([0-9.e+-]+)", out)]
        if len(esum) != 2 or not all(np.isfinite(esum)) or min(esum) <= 0:
            fail(f"production loop: E_sum {esum}")
        # every rank on the card, and every step computed there
        on_card = ("rank devices: " + " ".join(["cuda:0"] * ranks) in out
                   and out.count(f"(ranks={ranks}, cuda:0)") == 2)
        if not on_card:
            print(out[-4000:], flush=True)
            fail(f"production loop, {ranks} rank(s): not every rank on "
                 f"cuda:0")
        esums.append(esum)
    return esums


def profile_calls(fn, n=3):
    """``(device ms, kernel launches, {kernel: device ms})`` per call of
    ``fn`` over ``n`` calls under torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
    k = [e for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA]
    per = {name: sum(e.self_device_time_total for e in k if tag in e.key)
           / n / 1e3 for name, tag in (("trace", "trace_kernel"),
                                       ("bin_deposit", "bin_deposit_kernel"),
                                       ("amplify", "amplify_seeded_kernel"))}
    return (sum(e.self_device_time_total for e in k) / n / 1e3,
            sum(e.count for e in k) / n, per)


def uncounted(fn, *args, **kw):
    """``fn(*args, **kw)`` with every kernel's launch count left as it was:
    a call made as a reference or a yardstick does not count for the path
    being driven."""
    before = {n: w.launch_count for n, w in WRAPPERS.items()}
    try:
        return fn(*args, **kw)
    finally:
        for n, w in WRAPPERS.items():
            w.launch_count = before[n]


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


def cli_two_ranks(what, files):
    """The CLI's two-rank group on the card over ``files``: every golden
    check must pass, and the exit code must equal the timing-stability gate
    errors the ranks printed (two ranks time-slicing the card trip them in
    about half the runs). Returns each rank's s/call line."""
    import re

    out, rc = run_children([[sys.executable, "-m",
                             "raytrace_tpu_torch.utils.cli", "-methods=cuda",
                             "-nprocs=2", "-iterations=3", *files]], 300,
                           what, gate_errors_ok=True)[0]
    gates = cli_gate_errors(out)
    if "Answers do not match" in out or rc != gates or (
            "All tests passed" if rc == 0
            else f"Some tests failed ({rc} errors)") not in out:
        print(out[-4000:], flush=True)
        fail(f"{what}: exit code {rc}, {gates} timing-gate errors printed")
    print(f"{what}: golden checks passed on both ranks; exit code {rc}, "
          f"{gates} timing-stability gate errors", flush=True)
    ranks = re.findall(r"^  (\S+ rank \d+ s/call: .*)$", out, re.M)
    for line in ranks:
        print(f"  {line}", flush=True)
    if len(ranks) != 2 * len(files):
        fail(f"{what}: {len(ranks)} per-rank timing lines, not "
             f"{2 * len(files)}")
    return dict(exit_code=rc, ranks=ranks)


def phase_ranks():
    """The multi-rank path as subprocesses: the CLI's two-rank group on the
    card over both fixtures and both shipped shapes, and the production
    loop with 1 and 2 ranks."""
    files = [os.path.join(FIXTURES, name)
             for name in ("golden_ase.dat", "golden_seed.dat")]
    record["nprocs2_cli"] = cli_two_ranks(
        "CLI -methods=cuda -nprocs=2 -iterations=3 on the fixtures and the "
        "shipped shapes", files + shipped_cells())
    one, two = production_loops()
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


T_START = time.perf_counter()


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
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

    results = {}
    phase_kernels(results)

    wrappers = {"trace": trace_kernel, "bin_deposit": deposit_kernel,
                "amplify": amplify_kernel, "gather_probe": gather_probe}
    WRAPPERS.update(wrappers)

    def run_path(what, phase, names):
        """Drive one path with every count at 0; each kernel of the path
        must have launched."""
        for w in wrappers.values():
            w.launch_count = 0
        out = phase()
        counts = {n: wrappers[n].launch_count for n in names}
        print(f"launches on the {what}: {counts}", flush=True)
        for n, c in counts.items():
            if c <= 0:
                fail(f"kernel {n} was not launched on the {what}")
        return out, counts

    path_kernels = ("trace", "bin_deposit", "amplify")
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

    kernels = []
    for name, src, replaces in (
            ("trace", "trace.cu", "raytrace_tpu/ops/pallas_kernel.py:402"),
            ("bin_deposit", "deposit.cu",
             "raytrace_tpu/ops/deposit_kernel.py:76"),
            ("amplify", "amplify.cu",
             "raytrace_tpu/ops/pallas_amplify.py:123"),
            ("gather_probe", "gather_probe.cu", "tools/vpu_probe.py:112")):
        kernels.append(dict(
            name=name, route="cuda", source="raytrace_tpu_torch/csrc/" + src,
            replaces=replaces, launches=launches[name], **results[name],
            launches_per_call={
                "seeded": LAUNCHES_PER_CALL["seed"][name],
                "ase": LAUNCHES_PER_CALL["ase"][name]}))
    record["kernels"] = kernels
    record["seconds"] = time.perf_counter() - T_START
    print(f"chip_smoke: every phase passed in {record['seconds']:.1f} s",
          flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
