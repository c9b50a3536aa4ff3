"""``tools/f32_ab``'s variants of the f32 kernels, on the CPU: every
variant's edits apply to the sources, this tree's variants compiled for
the host behind the kernel-source test's shim equal the plain twins (the
ablations aside), and the bin census counts what B2's designs issue. The
timing itself needs the card."""

import ctypes
import subprocess
import types

import numpy as np
import pytest
import torch

import test_torch_kernel_source as ks
from raytrace_tpu_torch.ops import amplify_kernel, cuda_lib, deposit_kernel
from raytrace_tpu_torch.ops.binning import bin_indices
from raytrace_tpu_torch.tools import f32_ab

torch.set_num_threads(2)


def _source(kernel):
    return f32_ab.kernel_source(f32_ab.ROOT, kernel)


@pytest.mark.parametrize("variant", f32_ab.VARIANTS,
                         ids=[f"{v[1]}-{v[0]}" for v in f32_ab.VARIANTS])
def test_variant_edits_apply(variant):
    """Each variant's edits occur in this tree's source (the parent
    variants' edits in the f64 walk, which the f32 kernel's parent shared),
    and its C entries are renamed apart."""
    name, kernel, tree, edits = variant
    text = f32_ab.variant_source(_source(kernel), kernel, name, edits)
    prefix = f32_ab._prefix(kernel, name)
    assert f'extern "C" int {prefix}_{f32_ab._ENTRY[kernel]}(' in text
    assert 'extern "C" int rt_' not in text
    with pytest.raises(ValueError):
        f32_ab.variant_source(text, kernel, name, [("no such line", "")])


@pytest.fixture(scope="module")
def variant_libs(tmp_path_factory):
    """This tree's variants built for the host behind the shim, each C
    entry bound as the wrappers' ``_launch`` calls it."""
    d = tmp_path_factory.mktemp("f32_ab_host")
    (d / "cuda_runtime.h").write_text(ks._SHIM)
    here = [v for v in f32_ab.VARIANTS if v[2] == "here"]
    srcs = []
    for name, kernel, _tree, edits in here:
        text = f32_ab.variant_source(_source(kernel), kernel, name, edits)
        text = ks._LAUNCH.sub(ks._host_launch, text)
        text = ks._DYNAMIC_SHARED.sub(
            r"unsigned char* \1 = rt_dynamic_shared;", text)
        out = d / f"{f32_ab._prefix(kernel, name)}.cpp"
        out.write_text(text)
        srcs.append(str(out))
    so = d / "libf32_ab_host.so"
    r = subprocess.run(["g++", "-O1", "-std=c++17", "-ffp-contract=off",
                        "-fno-fast-math", "-shared", "-fPIC", "-I", str(d),
                        "-o", str(so), *srcs], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    libs = {}
    for name, kernel, _tree, _edits in here:
        entry = f32_ab._ENTRY[kernel]
        fn = getattr(lib, f"{f32_ab._prefix(kernel, name)}_{entry}")
        fn.argtypes = cuda_lib._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        libs[(kernel, name)] = types.SimpleNamespace(**{entry: fn})
    return libs


def _names(kernel):
    return [v[0] for v in f32_ab.VARIANTS
            if v[1] == kernel and v[2] == "here"]


@pytest.mark.parametrize("name", _names("amplify"))
def test_amplify_variants_equal_the_twin(variant_libs, name):
    """Every B3-f32 variant: pair, spectrum and flags bitwise the twin's."""
    f32 = torch.float32
    args = ks._seeded_inputs(777, 2, None)
    got, flags, pair = amplify_kernel._launch(
        variant_libs[("amplify", name)], *args, None, log_gain=True,
        dtype=f32)
    want, want_flags = amplify_kernel.amplify_gain_plain(*args, dtype=f32)
    hi, lo = amplify_kernel.log_gain2_plain(*args[3:])
    assert torch.equal(pair[0], hi) and torch.equal(pair[1], lo)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(flags, want_flags)


@pytest.mark.parametrize("name", _names("deposit"))
def test_deposit_variants_against_the_twin(variant_libs, name):
    """Every B2-f32 variant gives the twin's bins; all but the ablations
    its image and I_ang within 1e-14 (the ablations leave a part out)."""
    args, beam = ks._deposit_case(
        dict(nx=118, ny=25, na=50, nb=50, nv=82, seeded=True), 2, 1500, 3)
    args = (args[0].to(torch.float32),) + args[1:]
    K = args[0].shape[1]
    got = ks._accumulators(beam, K)
    bins = deposit_kernel._launch(variant_libs[("deposit", name)], *args,
                                  *got, None, bins=True)
    want = ks._accumulators(beam, K)
    deposit_kernel.bin_deposit_plain(*args, *want)
    assert torch.equal(bins, bin_indices(*args[1:3], beam, 2))
    same = [torch.allclose(g, w, rtol=1e-14, atol=0)
            for g, w in zip(got, want)]
    assert all(same) == (name not in f32_ab.ABLATIONS)


def test_bin_stats_counts():
    """Runs in launch order skip the rays without a bin; merged, a tile's
    equal bins count once apart from each other; both cut at the warps'
    shares of a tile."""
    img = [5, 3, 5, 3, 7, 7, -1, 7] + [2] * 8
    ang = [0] * 8 + [-1] * 8
    bins = torch.tensor(np.stack([img, ang], 1), dtype=torch.int32)
    s = f32_ab.bin_stats(bins, K=10, tiles=(8, 16), tile_rays=8, warps=2)
    assert s["image_rays"] == 15 and s["iang_rays"] == 8
    # launch order: 5 | 3 | 5 | 3 | 7 (the -1 does not end the run of 7s)
    # | 2
    assert s["runs_per_8"] == (5 + 1) / 2 and s["runs_per_16"] == 6
    assert s["mean_run"] == 15 / 6
    # sorted: {3, 5, 7} and {2}; over 16 rays {2, 3, 5, 7}
    assert s["distinct_per_8"] == (3 + 1) / 2
    assert s["distinct_per_16"] == 4
    # shares of 4 positions: [5 3 5 3 | 7 7 - 7] -> 4 + 1 runs, [2 2 2 2 |
    # 2 2 2 2] -> 2; merged, shares of 4 ranks: [3 3 5 5 | 7 7 7] -> 2 + 1,
    # and 2
    assert s["atomics"] == 7 * 10 + 8
    assert s["atomics_merged"] == 5 * 10 + 8
    # the kernel's own tile (32 rays, one warp) by default
    assert f32_ab.bin_stats(bins, K=10)["atomics"] == 6 * 10 + 8


def test_bin_stats_without_image_rays():
    bins = torch.tensor([[-1, 3], [-1, -1]], dtype=torch.int32)
    s = f32_ab.bin_stats(bins, K=4)
    assert s["atomics"] == s["atomics_merged"] == 1 and s["mean_run"] == 0
