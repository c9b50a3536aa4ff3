"""The f32 kernels B3-f32 and B2-f32 against an earlier tree's and against
variants of their own, in turns on the card, in one process.

    python -m raytrace_tpu_torch.tools.f32_ab --parent DIR [--out PATH]
                                              [--iters N] [--rounds N]

``DIR`` is the root of an earlier tree of this repository (a ``git
archive`` of the parent commit unpacked under ``build/parent``, say). Each
variant is a copy of one kernel source with a few text edits and its C
entries renamed, all built with the package's nvcc flags into one library
under ``build/f32_ab/<hash>/`` (one nvcc per variant, all started
together), and launched through the package's own wrappers' ``_launch``:

* B3-f32 (``amplify.cu``): ``parent`` (``DIR``'s kernel), ``here`` (this
  tree's), ``units<U>`` (U float2 units a thread), ``rint-magic`` (the
  exp's rounding by the magic-number add below 2^22, ``rintf`` above),
  ``int-magic`` (the exp's exponent to int by the magic-number add);
* B2-f32 (``deposit.cu``): ``parent``, ``parent-no-image-atomics`` (the
  image's atomicAdds as plain stores into the scratch image: the time the
  atomics cost), ``parent-no-butterfly`` (the I_ang warp butterflies left
  out: the time they cost), ``here``, ``sorted`` (each tile's keys
  sorted by a bitonic network before the walk, so it issues one atomic per
  distinct bin and frequency), the ablations ``no-image-atomics``, ``no-ang``,
  ``no-walk`` and ``stage-bins`` (this tree's kernel with its image
  atomics as plain stores, without its I_ang sums, without its image walk,
  and with neither), and this tree's kernel at other tile shapes
  ``tile<R>x<threads>``.

Inputs are ``chip_smoke.py``'s phase-3 inputs: a 2^20-ray chunk of the
seeded shipped shape traced by B1 with the chunk's seed factors (B3-f32's
inputs; its spectra are B2-f32's), and the whole ASE call (B2-f32 on the
f32 emissivity amplify's spectra). Every B3 variant must equal the plain
twin bitwise (pair, spectrum, flags); every B2 variant but the two
ablations must give the twin's bins bitwise and its image and I_ang within
1e-12 relative. Then each kernel's variants are timed in turns (CUDA
events, ``--iters`` launches a reading, ``--rounds`` forward and backward
passes) and the chunk's bins are counted: the mean run of equal image bins,
the distinct image bins per 32-, 256- and 1024-ray tile, and the f64
atomics each B2 design issues. Prints one JSON object (also written to
``--out``) with the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import torch

from raytrace_tpu_torch.ops import cuda_lib

__all__ = ["VARIANTS", "variant_source", "bin_stats", "main"]

ROOT = Path(__file__).resolve().parents[2]
BUILD = ROOT / "build" / "f32_ab"
DEFAULT_OUT = ROOT / "chiprun_out" / "f32_ab.json"

#: B2's sums against the twin (f64 atomics add in a changing order)
REL = 1e-12

_B3_MAGIC_INT = (
    "  const int ni = (int)fminf(fmaxf(n, -kNMax), kNMax);",
    "  const int ni = __float_as_int(fminf(fmaxf(n, -kNMax), kNMax)"
    " + 0x1.8p23f) - 0x4B400000;")
_B3_RINT = ("  const float n = rintf(hi * kLog2e);",
            """  const float x = hi * kLog2e;
  const float n = fabsf(x) < 0x1p22f ? (x + 0x1.8p23f) - 0x1.8p23f
                                     : rintf(x);""")
_B2_IMAGE_ATOMIC = ("for (int j = 0; j < V; ++j) atomicAdd(dst + j, run[j]);",
                    "for (int j = 0; j < V; ++j) dst[j] = run[j];")
_B2_BUTTERFLY = ("""          for (int o = warpSize / 2; o > 0; o /= 2) {
            part = part + __shfl_xor_sync(kFull, part, o);
          }
""", "")
# this tree's f32 deposit: its phases left out (ablations), its sort left
# out (a walk of the tile's runs in launch order)
_NO_ANG = ("    for (int r = split ? lane : tid; r < n; r += step) {",
           "    for (int r = split ? lane : tid; r < 0; r += step) {")
_NO_WALK = ("  for (int j0 = 0; j0 * lanes < K; j0 += S) {",
            "  for (int j0 = 0; j0 * lanes < 0; j0 += S) {")
_IMAGE_ATOMIC = ("if (k < K) atomicAdd(A.image + (int64_t)last * K + k, run[j]);",
                 "if (k < K) A.image[(int64_t)last * K + k] = run[j];")
_WALK = "  // with two warps or more, the first sums I_ang and the others walk the"
_SORTED = (_WALK, """  // the keys sorted by a bitonic network: equal image bins become runs
  for (int size = 2; size <= R; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < R / 2; i += nt) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = keys[lo], b = keys[hi];
        if ((a > b) == ((lo & size) == 0)) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }

""" + _WALK)


def _units(u):
    return [("constexpr int kUnitsF32 = 3;", f"constexpr int kUnitsF32 = {u};")]


def _tile(rays, threads):
    return [("constexpr int kTileRays = 32;",
             f"constexpr int kTileRays = {rays};"),
            ("constexpr int kTileThreads = 64;",
             f"constexpr int kTileThreads = {threads};")]


#: (name, kernel, tree, edits): ``tree`` "parent" or "here"; each edit an
#: ``(old, new)`` pair that must occur in the source
VARIANTS = (
    ("parent", "amplify", "parent", []),
    ("here", "amplify", "here", []),
    ("units1", "amplify", "here", _units(1)),
    ("units2", "amplify", "here", _units(2)),
    ("units4", "amplify", "here", _units(4)),
    ("units5", "amplify", "here", _units(5)),
    ("rint-magic", "amplify", "here", [_B3_RINT]),
    ("int-magic", "amplify", "here", [_B3_MAGIC_INT]),
    ("parent", "deposit", "parent", []),
    ("parent-no-image-atomics", "deposit", "parent", [_B2_IMAGE_ATOMIC]),
    ("parent-no-butterfly", "deposit", "parent", [_B2_BUTTERFLY]),
    ("here", "deposit", "here", []),
    ("sorted", "deposit", "here", [_SORTED]),
    ("no-image-atomics", "deposit", "here", [_IMAGE_ATOMIC]),
    ("no-ang", "deposit", "here", [_NO_ANG]),
    ("no-walk", "deposit", "here", [_NO_WALK]),
    ("stage-bins", "deposit", "here", [_NO_ANG, _NO_WALK]),
    ("tile32x32", "deposit", "here", _tile(32, 32)),
    ("tile16x64", "deposit", "here", _tile(16, 64)),
    ("tile64x64", "deposit", "here", _tile(64, 64)),
    ("tile32x128", "deposit", "here", _tile(32, 128)),
    ("tile64x128", "deposit", "here", _tile(64, 128)),
    ("tile128x128", "deposit", "here", _tile(128, 128)),
)
#: the variants that compute something else than the kernel: timed only
ABLATIONS = ("parent-no-image-atomics", "parent-no-butterfly",
             "no-image-atomics", "no-ang", "no-walk", "stage-bins")
_ENTRY = {"amplify": "rt_amplify_seeded_f32", "deposit": "rt_bin_deposit_f32"}


def _prefix(kernel, name):
    return "ab_" + re.sub(r"\W", "_", f"{kernel}_{name}")


def variant_source(text: str, kernel: str, name: str, edits) -> str:
    """``text`` (a kernel source) with ``edits`` applied, every one of
    which must occur, and each C entry ``rt_*`` renamed with the variant's
    prefix."""
    for old, new in edits:
        if old not in text:
            raise ValueError(f"{kernel} {name}: edit not found: {old!r}")
        text = text.replace(old, new)
    return re.sub(r'extern "C" int (rt_\w+)',
                  rf'extern "C" int {_prefix(kernel, name)}_\1', text)


def _build(parent: Path):
    """The variants' library (built once per set of sources)."""
    texts = {}
    for name, kernel, tree, edits in VARIANTS:
        root = parent if tree == "parent" else ROOT
        src = root / "raytrace_tpu_torch" / "csrc" / f"{kernel}.cu"
        texts[(kernel, name)] = variant_source(src.read_text(), kernel, name,
                                               edits)
    h = hashlib.sha256(" ".join(cuda_lib.NVCC_FLAGS).encode())
    for k in sorted(texts):
        h.update(texts[k].encode())
    out = BUILD / h.hexdigest()[:16]
    so = out / "libf32_ab.so"
    log = ""
    if not so.exists():
        out.mkdir(parents=True, exist_ok=True)
        nvcc = cuda_lib._nvcc()
        jobs = []
        for (kernel, name), text in texts.items():
            cu = out / f"{_prefix(kernel, name)}.cu"
            cu.write_text(text)
            obj = cu.with_suffix(".o")
            jobs.append((obj, subprocess.Popen(
                [nvcc, *cuda_lib.NVCC_FLAGS, "-c", "-o", str(obj), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        for obj, proc in jobs:
            log += proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {obj.name}:\n{log}")
        r = subprocess.run([nvcc, "-shared", *cuda_lib.NVCC_FLAGS[:2], "-o",
                            str(so), *(str(o) for o, _ in jobs)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{r.stderr}")
        (out / "build.log").write_text(log)
    lib = ctypes.CDLL(str(so))
    libs = {}
    for name, kernel, _tree, _edits in VARIANTS:
        fn = getattr(lib, f"{_prefix(kernel, name)}_{_ENTRY[kernel]}")
        fn.argtypes = cuda_lib._SIGNATURES[_ENTRY[kernel]]
        fn.restype = ctypes.c_int
        libs[(kernel, name)] = types.SimpleNamespace(**{_ENTRY[kernel]: fn})
    return libs, (out / "build.log").read_text()


def _ms(fn, iters):
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


def _in_turns(fns: dict, iters: int, rounds: int) -> dict:
    names = list(fns)
    out = {n: [] for n in names}
    for r in range(2 * rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            out[n].append(_ms(fns[n], iters))
    return out


def bin_stats(bins: torch.Tensor, K: int, tiles=(32, 256, 1024),
              tile_rays: int | None = None,
              warps: int | None = None) -> dict:
    """What B2 does on ``bins`` ([B, 2] i32, -1 for none): the mean run of
    equal image bins among the deposited rays in launch order; per tile of
    each of ``tiles`` rays the mean distinct image bins and runs; and the
    f64 atomics of the f32 kernel on tiles of ``tile_rays`` rays walked by
    ``warps`` walking warps (by default its own): ``atomics``, one per frequency
    for each run of equal bins in launch order inside a warp's share of a
    tile, plus one per I_ang ray (the f64 kernel's count too, whose warp
    tiles are 32 rays), and ``atomics_merged``, the same with each tile's
    bins sorted first (one per distinct bin of a share)."""
    from raytrace_tpu_torch.ops import deposit_kernel

    if tile_rays is None:
        tile_rays = deposit_kernel.F32_TILE_RAYS
    if warps is None:
        # with two warps or more, all but the first walk the image
        warps = max(1, deposit_kernel.F32_TILE_THREADS // 32 - 1)
    img = bins[:, 0].long()
    n_ang = int((bins[:, 1] >= 0).sum())
    idx = torch.nonzero(img >= 0).squeeze(1)
    v = img[idx]
    out = {"rays": img.shape[0], "image_rays": v.numel(), "iang_rays": n_ang}

    def cuts(*keys):
        # rays that open a run: the first, and where any key changes
        start = torch.zeros_like(v, dtype=torch.bool)
        start[0] = True
        for key in keys:
            start[1:] |= key[1:] != key[:-1]
        return int(start.sum())

    def runs(tile, share):
        # in launch order; a share is a range of positions in the tile
        return cuts(v, idx // tile, (idx % tile) // share)

    def merged(tile, share):
        # each tile's bins sorted; a share is a range of the sorted ranks
        t = idx // tile
        order = torch.argsort(t * (int(v.max()) + 1) + v, stable=True)
        ts, vs = t[order], v[order]
        pos = torch.arange(vs.numel(), device=vs.device)
        first = torch.ones_like(vs, dtype=torch.bool)
        first[1:] = ts[1:] != ts[:-1]
        rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
        return cuts(vs, ts, rank // share)

    if not v.numel():
        return dict(out, mean_run=0.0, atomics=n_ang, atomics_merged=n_ang,
                    **{f"{w}_per_{R}": 0.0 for R in tiles
                       for w in ("distinct", "runs")})
    out["mean_run"] = v.numel() / runs(img.shape[0] + 1, img.shape[0] + 1)
    for R in tiles:
        n_tiles = -(-img.shape[0] // R)
        out[f"distinct_per_{R}"] = merged(R, R) / n_tiles
        out[f"runs_per_{R}"] = runs(R, R) / n_tiles
    share = -(-tile_rays // warps)
    out["atomics"] = runs(tile_rays, share) * K + n_ang
    out["atomics_merged"] = merged(tile_rays, share) * K + n_ang
    return out


def _inputs():
    """Phase 3's inputs: the seeded chunk (B1, seed factors, B3-f32's
    spectra and flags) and the ASE call (B1, the f32 emissivity amplify)."""
    from raytrace_tpu_torch.models.problem import prepare_beam, prepare_gain
    from raytrace_tpu_torch.models.ray_tracer import _validate
    from raytrace_tpu_torch.ops import (amplify_kernel, binning, spectrum,
                                        trace_kernel)
    from raytrace_tpu_torch.testing import (ASE_SHAPE, SEED_SHAPE,
                                            seed_factors, source_rays,
                                            synthetic_problem)

    f32 = torch.float32
    cells = {}
    for name, shape, n in (("seed_chunk", SEED_SHAPE, 1 << 20),
                           ("ase_call", ASE_SHAPE, None)):
        p = synthetic_problem(**shape)
        method = 2 if p.seed is not None else 1
        gain = prepare_gain(p.gain, "cuda")
        rays = source_rays(p, n, "cuda")
        res = trace_kernel.trace_batch(rays, p.N, p.euv_beam.dz, gain,
                                       method, 0.5, method == 1)
        gv = gain.gv[1:]
        B, K = res.ivl.shape[0], p.euv_beam.nv
        c = {}
        if method == 2:
            f, fv = seed_factors(p, B, "cuda")
            c["amplify"] = (f, fv, res.escaped, res.ivl, res.gvl, gv)
            Iv, flags = amplify_kernel.amplify_gain(*c["amplify"], dtype=f32)
        else:
            Iv = spectrum.amplify(res, torch.zeros((B, K), dtype=f32,
                                                   device="cuda"),
                                  gv, p.N, dtype=f32)
            flags = amplify_kernel.iv_flags(Iv)
        beam = prepare_beam(p.euv_beam, "cuda")
        coords = binning.source_coords(res, rays, method)
        ok = ~res.perp & (flags == 0)
        c["deposit"] = (Iv, coords, ok, beam, method, _validate(p)[2])
        c["C"] = beam.x.shape[0] * beam.y.shape[0]
        c["A"] = beam.a.shape[0] * beam.b.shape[0]
        cells[name] = c
    torch.cuda.synchronize()
    return cells


def _check_amplify(libs, args, stream):
    from raytrace_tpu_torch.ops import amplify_kernel

    f32 = torch.float32
    want, want_flags = amplify_kernel.amplify_gain_plain(*args, dtype=f32)
    hi, lo = amplify_kernel.log_gain2_plain(*args[3:])
    out = {}
    for (kernel, name), lib in libs.items():
        if kernel != "amplify":
            continue
        got, flags, pair = amplify_kernel._launch(lib, *args, stream,
                                                  log_gain=True, dtype=f32)
        torch.cuda.synchronize()
        same = (torch.equal(pair[0], hi) and torch.equal(pair[1], lo)
                and torch.equal(got.view(torch.int32), want.view(torch.int32))
                and torch.equal(flags, want_flags))
        if not same:
            raise SystemExit(f"f32_ab: B3-f32 {name} differs from the twin")
        out[name] = "bitwise"
    return out


def _check_deposit(libs, cell, stream):
    from raytrace_tpu_torch.ops import deposit_kernel
    from raytrace_tpu_torch.ops.binning import bin_indices

    Iv, coords, ok, beam, method, scale = cell["deposit"]
    K = Iv.shape[1]
    f64 = dict(dtype=torch.float64, device=Iv.device)

    def acc():
        return torch.zeros((cell["C"], K), **f64), torch.zeros((cell["A"], 1),
                                                               **f64)

    want = acc()
    deposit_kernel.bin_deposit_plain(*cell["deposit"], *want)
    want_bins = bin_indices(coords, ok, beam, method)
    out = {}
    for (kernel, name), lib in libs.items():
        if kernel != "deposit":
            continue
        got = acc()
        bins = deposit_kernel._launch(lib, *cell["deposit"], *got, stream,
                                      bins=True)
        torch.cuda.synchronize()
        if not torch.equal(bins, want_bins):
            raise SystemExit(f"f32_ab: B2-f32 {name}: bins differ")
        rel = max(((g - w).abs().max() / w.abs().max()).item()
                  for g, w in zip(got, want))
        if name not in ABLATIONS and not rel <= REL:
            raise SystemExit(f"f32_ab: B2-f32 {name}: max rel {rel}")
        out[name] = rel
    return out, want_bins


def _card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else None


def run(parent: Path, iters: int = 20, rounds: int = 2) -> dict:
    from raytrace_tpu_torch.ops import amplify_kernel, deposit_kernel

    if not torch.cuda.is_available():
        raise SystemExit("f32_ab: needs a CUDA device")
    t0 = time.perf_counter()
    cuda_lib.load_library()
    libs, log = _build(parent)
    res = {"card": _card_line(), "torch": torch.__version__,
           "build_s": time.perf_counter() - t0,
           "ptxas": [ln.strip() for ln in log.splitlines()
                     if "registers" in ln]}
    stream = torch.cuda.current_stream().cuda_stream
    cells = _inputs()
    seed = cells["seed_chunk"]
    f32 = torch.float32
    res["amplify_check"] = _check_amplify(libs, seed["amplify"], stream)
    res["amplify_ms"] = _in_turns(
        {name: (lambda lib=lib: amplify_kernel._launch(
            lib, *seed["amplify"], stream, dtype=f32))
         for (kernel, name), lib in libs.items() if kernel == "amplify"},
        iters, rounds)
    for cname, cell in cells.items():
        rel, bins = _check_deposit(libs, cell, stream)
        K = cell["deposit"][0].shape[1]
        f64 = dict(dtype=torch.float64, device="cuda")
        image = torch.zeros((cell["C"], K), **f64)
        i_ang = torch.zeros((cell["A"], 1), **f64)
        res[f"deposit_{cname}_max_rel"] = rel
        res[f"deposit_{cname}_ms"] = _in_turns(
            {name: (lambda lib=lib: deposit_kernel._launch(
                lib, *cell["deposit"], image, i_ang, stream))
             for (kernel, name), lib in libs.items() if kernel == "deposit"},
            iters, rounds)
        res[f"deposit_{cname}_bins"] = bin_stats(bins, K)
    for key in [k for k in res if k.endswith("_ms")]:
        res[key + "_mean"] = {n: sum(v) / len(v) for n, v in res[key].items()}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytrace_tpu_torch.tools.f32_ab",
        description="B3-f32 and B2-f32 against an earlier tree's and their "
        "own variants, in turns on the card.")
    ap.add_argument("--parent", required=True,
                    help="root of the earlier tree")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    res = run(Path(args.parent), args.iters, args.rounds)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
