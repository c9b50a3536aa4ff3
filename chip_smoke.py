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
   shapes, each timed beside its twin with CUDA events:
   trace B1 on refraction-free rays in both methods (cell ids, escape flags
   and micro-step counts identical, path integrals within 1e-5 relative)
   and on 65,536 rays of the ASE-shaped synthetic (median within 1e-5,
   escape flags identical, median count equal), its counts variant timed
   beside the normal launch; deposit B2 on seeded random bins (1e-12
   relative); amplify B3 on one 2^20-ray chunk of the seeded shipped shape
   traced by B1, K 82 (log-gain bitwise, spectrum within 1e-13 relative);
   probe P1 at K 64 (bitwise);
4. with every launch count at 0: ``create_image`` on both golden fixtures
   (``check_ans`` at 5e-6 and a two-sided relative L2 below 1e-5 against
   the embedded golden), then the two shipped-shape synthetics (ASE
   60x25x19x14 = 399,000 rays, nv 52; seeded 120x25x51x51 = 7,803,000
   rays, nv 82; N 3, 106x26 gain grid) with one warmup and three timed
   calls each; B1, B2 and B3 must have launched in this run;
5. with the counts at 0 again: ``create_image_stream`` at depth 2 over 4
   ASE and then 4 seeded shipped-shape units with distinct gain tables,
   without and with the reorder; every yield within 1e-12 relative L2 of
   the synchronous call on the same unit; fill, steady inter-yield seconds
   and s/call beside the synchronous s/call; B1, B2 and B3 must have
   launched;
6. with P1's count at 0: the probe tool's measurement
   (``raytrace_tpu_torch.tools.gather_probe.measure``), ns per dependent
   gather; P1 must have launched;
7. the shipped-shape calls once more through the plain twins on the card:
   image and I_ang within a relative L2 of 1e-5 of the kernels' result.

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

ASE_SHAPE = dict(nx=60, ny=25, na=19, nb=14, nv=52, N=3, gain_nx=106,
                 gain_ny=26)
SEED_SHAPE = dict(nx=118, ny=25, na=50, nb=50, nv=82, N=3, seeded=True,
                  seed_dim=251, gain_nx=106, gain_ny=26)

record: dict = {}


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


def source_rays(p, n=None):
    """The first ``n`` rays of the work unit in natural (b-fastest) order,
    as the port's chunks enumerate them, on the card."""
    from raytrace_tpu_torch.models.ray_tracer import _unflatten_rays

    src = p.seed_beam if p.seed is not None else p.euv_beam
    total = src.nx * src.ny * src.na * src.nb
    ijkm = torch.arange(min(n or total, total), device="cuda")
    i, j, k, m = _unflatten_rays(ijkm, (src.nx, src.ny, src.na, src.nb))
    grids = [torch.as_tensor(np.asarray(g, np.float64), device="cuda")
             .float() for g in (src.x, src.y, src.a, src.b)]
    return {"x": grids[0][i], "y": grids[1][j], "a": grids[2][k],
            "b": grids[3][m]}


def trace_pair(p, rays):
    """B1 and its twin on ``rays``, both with the micro-step counts; the
    counts variant's other outputs must equal the normal launch's."""
    from raytrace_tpu_torch.models.problem import prepare_gain
    from raytrace_tpu_torch.ops import trace_kernel

    g = prepare_gain(p.gain, "cuda")
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


def phase_kernels(results):
    from raytrace_tpu_torch.ops import deposit_kernel, trace_kernel
    from raytrace_tpu_torch.testing import synthetic_problem

    # B1, refraction-free lockstep: geometry-determined step sequences
    worst = 0.0
    for method in (1, 2):
        p = synthetic_problem(refraction_free=True, seeded=method == 2,
                              **{k: v for k, v in ASE_SHAPE.items()})
        got, want, _, steps, want_steps = trace_pair(p, source_rays(p, 65536))
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
        print(f"trace refraction-free method {method}: ivl/escaped/counts "
              f"identical, gvl/evl within 1e-5, bitwise {bitwise}",
              flush=True)
        record[f"trace_straight_{method}"] = dict(bitwise=bitwise)

    # B1 on 65,536 rays of the ASE-shaped synthetic
    p = synthetic_problem(**ASE_SHAPE)
    got, want, args, steps, want_steps = trace_pair(p, source_rays(p, 65536))
    med_steps = (steps.float().median().item(),
                 want_steps.float().median().item())
    if med_steps[0] != med_steps[1]:
        fail(f"trace ASE-shaped: median micro-step count {med_steps}")
    med = max(rel_err(got.gvl, want.gvl).median().item(),
              rel_err(got.evl, want.evl).median().item())
    bitwise = all(torch.equal(getattr(got, f), getattr(want, f))
                  for f in got._fields)
    if med > 1e-5 or not torch.equal(got.escaped, want.escaped):
        fail(f"trace ASE-shaped: median rel {med}, escaped equal "
             f"{torch.equal(got.escaped, want.escaped)}")
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

    # B1 over a whole call's rays: ASE is one chunk of 399,000 rays
    all_rays = source_rays(p)
    args_all = (all_rays,) + args[1:]
    ms_all = cuda_ms(lambda: trace_kernel.trace_batch(*args_all), 5)
    ms_all_c = cuda_ms(
        lambda: trace_kernel.trace_batch(*args_all, counts=True), 5)
    plain_all = cuda_ms(lambda: trace_kernel.trace_batch_plain(*args_all), 1)
    print(f"trace ASE-shaped whole call ({all_rays['x'].shape[0]} rays): "
          f"kernel {ms_all:.4f} ms, counts variant {ms_all_c:.4f} ms, plain "
          f"{plain_all:.3f} ms", flush=True)
    record["trace_ase_call"] = dict(rays=all_rays["x"].shape[0], ms=ms_all,
                                    counts_ms=ms_all_c, plain_ms=plain_all)
    results["trace"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms)

    # B2 on seeded random bins at the main path's image shapes
    rng = np.random.default_rng(0)
    dep_worst = 0.0
    for name, B, K, C in (("ase", 399000, 52, 60 * 25),
                          ("seed", 1 << 20, 82, 118 * 25)):
        contrib = torch.as_tensor(rng.standard_normal((B, K)), device="cuda")
        bins = torch.as_tensor(rng.integers(0, C + 1, B).astype(np.int32),
                               device="cuda")
        got = deposit_kernel.deposit(
            torch.zeros((C, K), dtype=torch.float64, device="cuda"),
            contrib, bins)
        want = deposit_kernel.deposit_plain(
            torch.zeros((C, K), dtype=torch.float64, device="cuda"),
            contrib, bins)
        e = ((got - want).abs().max() / want.abs().max()).item()
        if e > 1e-12:
            fail(f"deposit {name}: max rel {e}")
        dep_worst = max(dep_worst, (got - want).abs().max().item())
        out = torch.zeros((C, K), dtype=torch.float64, device="cuda")
        ms_d = cuda_ms(lambda: deposit_kernel.deposit(out, contrib, bins), 20)
        plain_d = cuda_ms(
            lambda: deposit_kernel.deposit_plain(out, contrib, bins), 20)
        print(f"deposit {name} B={B} K={K} C={C}: max rel {e:.2e}; kernel "
              f"{ms_d:.4f} ms, plain {plain_d:.4f} ms", flush=True)
        record[f"deposit_{name}"] = dict(B=B, K=K, C=C, max_rel=e, ms=ms_d,
                                         plain_ms=plain_d)
        if name == "ase":
            results["deposit"] = dict(ms=ms_d, plain_ms=plain_d)
    results["deposit"]["max_abs_err"] = dep_worst

    phase_amplify(results)
    phase_probe_kernel(results)


def phase_amplify(results):
    """B3 on one 2^20-ray chunk of the seeded shipped shape, its ivl/gvl
    traced by B1, against the twin; both timed."""
    from raytrace_tpu_torch.models.problem import prepare_gain
    from raytrace_tpu_torch.ops import amplify_kernel, cuda_lib, trace_kernel
    from raytrace_tpu_torch.testing import synthetic_problem

    p = synthetic_problem(**SEED_SHAPE)
    gain = prepare_gain(p.gain, "cuda")
    res = trace_kernel.trace_batch(source_rays(p, 1 << 20), p.N,
                                   p.euv_beam.dz, gain, 2, 0.5, False)
    gv = gain.gv[1:]
    B, K = res.ivl.shape[0], p.euv_beam.nv
    rng = np.random.default_rng(1)
    Iv0 = torch.as_tensor(rng.uniform(0.5, 1.5, (B, K)), device="cuda")
    args = (Iv0, res.ivl, res.gvl, gv)
    got = amplify_kernel.amplify_gain(*args)
    _, gl = amplify_kernel._launch(cuda_lib.load_library(), *args,
                                   torch.cuda.current_stream().cuda_stream,
                                   log_gain=True)
    want = amplify_kernel.amplify_gain_plain(*args)
    gl_bitwise = torch.equal(gl, amplify_kernel.log_gain_plain(*args[1:]))
    rel = ((got - want).abs() / want.abs()).max().item()
    if not gl_bitwise or rel > 1e-13:
        fail(f"amplify: log-gain bitwise {gl_bitwise}, spectrum max rel {rel}")
    ms = cuda_ms(lambda: amplify_kernel.amplify_gain(*args), 20)
    plain_ms = cuda_ms(lambda: amplify_kernel.amplify_gain_plain(*args), 5)
    print(f"amplify seeded chunk B={B} K={K} cells={gv.shape[1]}: log-gain "
          f"bitwise, max rel {rel:.3e}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms", flush=True)
    record["amplify_chunk"] = dict(B=B, K=K, max_rel=rel, ms=ms,
                                   plain_ms=plain_ms)
    results["amplify"] = dict(max_abs_err=(got - want).abs().max().item(),
                              ms=ms, plain_ms=plain_ms)


def phase_probe_kernel(results):
    """P1 against its twin at K = 64, both timed there."""
    from raytrace_tpu_torch.tools import gather_probe

    tab, idx = (t.cuda() for t in gather_probe.probe_inputs())
    K = 64
    got = gather_probe.gather_probe(tab, idx, K)
    want = gather_probe.gather_probe_plain(tab, idx, K)
    if not torch.equal(got, want):
        fail("gather probe: kernel differs from its twin")
    ms = cuda_ms(lambda: gather_probe.gather_probe(tab, idx, K), 20)
    plain_ms = cuda_ms(lambda: gather_probe.gather_probe_plain(tab, idx, K),
                       5)
    print(f"gather probe K={K}: bitwise; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms", flush=True)
    results["gather_probe"] = dict(
        max_abs_err=(got - want).abs().max().item(), ms=ms,
        plain_ms=plain_ms)


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
    from raytrace_tpu_torch.testing import synthetic_problem

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
        for _ in range(3):
            t0 = time.perf_counter()
            image, i_ang = create_image(p, "cuda", device="cuda")
            times.append(time.perf_counter() - t0)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        check_output(image, i_ang, p)
        best = min(times)
        print(f"{name} shipped shape ({rays} rays): warmup {warm:.4f} s, "
              f"s/call {[round(t, 5) for t in times]}, best {best:.5f} s, "
              f"{rays / best:.4e} rays/s, peak device memory "
              f"{peak_gib:.3f} GiB", flush=True)
        record[f"{name}_call"] = dict(rays=rays, warmup_s=warm,
                                      times_s=times, rays_per_s=rays / best,
                                      peak_gib=peak_gib)
        outs[name] = (p, image, i_ang)
    return outs


def phase_stream():
    """create_image_stream over 4 distinct-table units of each shipped
    shape, without and with the reorder, against synchronous calls."""
    from raytrace_tpu_torch import create_image, create_image_stream
    from raytrace_tpu_torch.testing import (perturbed_problems,
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
        image_p, i_ang_p = create_image(p, "cpu", device="cuda")
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

    wrappers = {"trace": trace_kernel, "deposit": deposit_kernel,
                "amplify": amplify_kernel, "gather_probe": gather_probe}

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

    path_kernels = ("trace", "deposit", "amplify")
    outs, launches = run_path("main path", phase_main_path, path_kernels)
    _, stream_launches = run_path("stream path", phase_stream, path_kernels)
    _, probe_launches = run_path("probe path", phase_probe_path,
                                 ("gather_probe",))
    launches.update(probe_launches)
    record["stream_launches"] = stream_launches

    phase_plain(outs)

    kernels = [
        dict(name="trace", route="cuda",
             source="raytrace_tpu_torch/csrc/trace.cu",
             replaces="raytrace_tpu/ops/pallas_kernel.py:402",
             launches=launches["trace"], **results["trace"]),
        dict(name="deposit", route="cuda",
             source="raytrace_tpu_torch/csrc/deposit.cu",
             replaces="raytrace_tpu/ops/deposit_kernel.py:76",
             launches=launches["deposit"], **results["deposit"]),
        dict(name="amplify", route="cuda",
             source="raytrace_tpu_torch/csrc/amplify.cu",
             replaces="raytrace_tpu/ops/pallas_amplify.py:123",
             launches=launches["amplify"], **results["amplify"]),
        dict(name="gather_probe", route="cuda",
             source="raytrace_tpu_torch/csrc/gather_probe.cu",
             replaces="tools/vpu_probe.py:112",
             launches=launches["gather_probe"], **results["gather_probe"]),
    ]
    record["kernels"] = kernels
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
