"""The CUDA kernels against their plain PyTorch twins, on the card.

Marked ``gpu``; each test skips without a CUDA device (decided inside the
test, never at collection). Nothing here builds or imports a kernel at
collection time. Run on a machine with the card:

    python -m pytest tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from raytrace_tpu_torch.models.problem import prepare_gain
from raytrace_tpu_torch.ops import (amplify_kernel, cuda_lib, deposit_kernel,
                                    trace_kernel)
from raytrace_tpu_torch.testing import amplify_inputs, synthetic_problem

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rays(p, n, seed, device):
    rng = np.random.default_rng(seed)
    b = p.seed_beam if p.seed is not None else p.euv_beam
    return {k: torch.as_tensor(g[rng.integers(0, len(g), n)]
                               .astype(np.float32), device=device)
            for k, g in zip("xyab", (b.x, b.y, b.a, b.b))}


@pytest.mark.parametrize("method", [1, 2])
@pytest.mark.parametrize("kwargs", [dict(refraction_free=True), dict(),
                                    dict(non_uniform_gain=0.8),
                                    dict(full_plane=True)])
def test_trace_kernel_vs_twin(cuda, method, kwargs):
    p = synthetic_problem(seeded=method == 2, **kwargs)
    rays = _rays(p, 4096, 0, cuda)
    gain = prepare_gain(p.gain, cuda)
    args = (rays, p.N, p.euv_beam.dz, gain, method, 0.5, method == 1)
    before = trace_kernel.launch_count
    got = trace_kernel.trace_batch(*args)
    torch.cuda.synchronize()
    assert trace_kernel.launch_count == before + 1
    want = trace_kernel.trace_batch_plain(*args)
    assert torch.equal(got.ivl, want.ivl)
    assert torch.equal(got.escaped, want.escaped)
    rel = (got.gvl - want.gvl).abs() / want.gvl.abs().clamp_min(1e-6)
    assert rel.max().item() < 1e-5
    # the launch's last thread zeroed the refill's counters again
    stream = torch.cuda.current_stream().cuda_stream
    assert not trace_kernel._counter(cuda, stream).any()


@pytest.mark.parametrize("method", [1, 2])
def test_trace_kernel_one_segment(cuda, method):
    """N = 1 launches the kernel too (no segment to walk): the exit rays
    bitwise equal to the twin's, no micro-steps."""
    p = synthetic_problem(N=1, seeded=method == 2)
    rays = _rays(p, 1000, 4, cuda)
    gain = prepare_gain(p.gain, cuda)
    args = (rays, p.N, p.euv_beam.dz, gain, method, 0.5, method == 1)
    before = trace_kernel.launch_count
    got, steps = trace_kernel.trace_batch(*args, counts=True)
    torch.cuda.synchronize()
    assert trace_kernel.launch_count == before + 1
    want, _ = trace_kernel.trace_batch_plain(*args, counts=True)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert not steps.any()


def test_empty_batches_run_no_plain_code(cuda, monkeypatch):
    """B1, B2 and B3 on a batch of no rays: empty results on the card (B2
    leaves its accumulators as they were), no launch counted, and no plain
    twin called."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain twin ran on CUDA tensors")

    for mod, name in ((amplify_kernel, "amplify_gain_plain"),
                      (amplify_kernel, "log_gain_plain"),
                      (amplify_kernel, "iv_flags"),
                      (trace_kernel, "trace_batch_plain"),
                      (deposit_kernel, "bin_deposit_plain"),
                      (deposit_kernel, "deposit_plain"),
                      (deposit_kernel, "bin_indices")):
        monkeypatch.setattr(mod, name, refuse)
    f, fv, esc, ivl, gvl, gv = _seeded_inputs(8, None, cuda)
    before = (amplify_kernel.launch_count, trace_kernel.launch_count,
              deposit_kernel.launch_count)
    Iv, flags = amplify_kernel.amplify_gain(f[:0], fv, esc[:0], ivl[:0],
                                            gvl[:0], gv)
    assert Iv.shape == (0, 82) and Iv.dtype == torch.float64
    assert flags.shape == (0,) and flags.dtype == torch.uint8
    assert Iv.device.type == flags.device.type == "cuda"
    p = synthetic_problem()
    rays = {k: v[:0] for k, v in _rays(p, 1, 0, cuda).items()}
    res, steps = trace_kernel.trace_batch(
        rays, p.N, p.euv_beam.dz, prepare_gain(p.gain, cuda), 1, counts=True)
    assert res.gvl.shape == (0, p.N - 1, 3) and steps.shape == (0,)
    assert res.exit_x.device.type == "cuda"
    Iv, coords, ok, beam, image, i_ang = _deposit_args(
        dict(nx=9, ny=6, na=7, nb=5, nv=6), 1, 0, cuda)
    image.fill_(1.0)
    deposit_kernel.bin_deposit(Iv, coords, ok, beam, 1, 1.0, image, i_ang)
    assert torch.equal(image, torch.ones_like(image))
    assert (amplify_kernel.launch_count, trace_kernel.launch_count,
            deposit_kernel.launch_count) == before


def _deposit_args(shape, method, B, device, seed=1):
    from raytrace_tpu_torch.models.problem import prepare_beam
    from raytrace_tpu_torch.testing import deposit_inputs

    p = synthetic_problem(**shape)
    Iv, coords, ok = deposit_inputs(p.euv_beam, B, seed)
    beam = prepare_beam(p.euv_beam, device)
    K = Iv.shape[1]
    f64 = dict(dtype=torch.float64, device=device)
    return (torch.as_tensor(Iv, device=device),
            tuple(torch.as_tensor(c, device=device) for c in coords),
            torch.as_tensor(ok, device=device), beam,
            torch.zeros((beam.x.shape[0] * beam.y.shape[0], K), **f64),
            torch.zeros((beam.a.shape[0] * beam.b.shape[0], 1), **f64))


@pytest.mark.parametrize("method", [1, 2])
@pytest.mark.parametrize("shape", [
    dict(nx=60, ny=25, na=19, nb=14, nv=52),
    dict(nx=118, ny=25, na=50, nb=50, nv=82, seeded=True),
    dict(nx=9, ny=6, na=7, nb=5, nv=7, full_plane=True),
], ids=["ase-widths", "seeded-widths", "odd-K-full-plane"])
def test_deposit_kernel_vs_twin(cuda, method, shape):
    """B2 on the card: one launch, the bins bitwise equal to the twin's
    get_index, image and I_ang within 1e-12 of the twin's, no NaN from the
    rays that are not ok."""
    from raytrace_tpu_torch.ops.binning import bin_indices

    Iv, coords, ok, beam, image, i_ang = _deposit_args(shape, method,
                                                       100_000, cuda)
    before = deposit_kernel.launch_count
    deposit_kernel.bin_deposit(Iv, coords, ok, beam, method, 0.37, image,
                               i_ang)
    torch.cuda.synchronize()
    assert deposit_kernel.launch_count == before + 1
    want = (torch.zeros_like(image), torch.zeros_like(i_ang))
    deposit_kernel.bin_deposit_plain(Iv, coords, ok, beam, method, 0.37,
                                     *want)
    bins = deposit_kernel._launch(
        cuda_lib.load_library(), Iv, coords, ok, beam, method, 0.37,
        torch.zeros_like(image), torch.zeros_like(i_ang),
        torch.cuda.current_stream().cuda_stream, bins=True)
    assert torch.equal(bins, bin_indices(coords, ok, beam, method))
    for got, w in zip((image, i_ang), want):
        assert not got.isnan().any()
        assert ((got - w).abs().max() / w.abs().max()).item() < 1e-12


def test_create_image_fixture_on_card(cuda):
    import os

    from raytrace_tpu_torch import check_ans, create_image, load_input

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "golden_ase.dat")
    p, image0, i_ang0 = load_input(path)
    image, i_ang = create_image(p, "cuda", device=cuda)
    assert check_ans(image0, i_ang0, image, i_ang)


@pytest.mark.parametrize("kwargs", [dict(refraction_free=True), dict()])
@pytest.mark.parametrize("method", [1, 2])
def test_trace_counts_vs_twin(cuda, method, kwargs):
    """B1's counts variant: identical to the twin's counts on
    refraction-free rays, the same median on refracting ones; the other
    outputs as the normal launch."""
    p = synthetic_problem(seeded=method == 2, **kwargs)
    rays = _rays(p, 4096, 2, cuda)
    gain = prepare_gain(p.gain, cuda)
    args = (rays, p.N, p.euv_beam.dz, gain, method, 0.5, method == 1)
    got, steps = trace_kernel.trace_batch(*args, counts=True)
    plain = trace_kernel.trace_batch(*args)
    want, want_steps = trace_kernel.trace_batch_plain(*args, counts=True)
    torch.cuda.synchronize()
    assert torch.equal(got.ivl, plain.ivl) and torch.equal(got.gvl, plain.gvl)
    if kwargs.get("refraction_free"):
        assert torch.equal(steps, want_steps)
    else:
        assert steps.float().median() == want_steps.float().median()
    assert steps.min().item() >= 1


def _seeded_inputs(B, spread, device, K=82, seed=6):
    ivl, gvl, gv = (torch.as_tensor(a, device=device)
                    for a in amplify_inputs(B=B, K=K, spread=spread))
    rng = np.random.default_rng(seed)
    f = torch.as_tensor(rng.random(B), device=device)
    fv = torch.as_tensor(rng.uniform(0.1, 2.0, K), device=device)
    esc = torch.as_tensor(rng.random(B) < 0.125, device=device)
    return f, fv, esc, ivl, gvl, gv


@pytest.mark.parametrize("spread,K", [(None, 82), (40, 82), (None, 7)])
def test_amplify_kernel_vs_twin(cuda, spread, K):
    """B3 at the seeded shipped widths (and an odd K): the log-gain
    bitwise, the spectrum within 1e-13 (CUDA's exp against PyTorch's), the
    flags identical."""
    args = _seeded_inputs(65536, spread, cuda, K)
    before = amplify_kernel.launch_count
    got, flags = amplify_kernel.amplify_gain(*args)
    torch.cuda.synchronize()
    assert amplify_kernel.launch_count == before + 1
    _, _, gl = amplify_kernel._launch(
        cuda_lib.load_library(), *args,
        torch.cuda.current_stream().cuda_stream, log_gain=True)
    assert torch.equal(gl, amplify_kernel.log_gain_plain(*args[3:]))
    want, want_flags = amplify_kernel.amplify_gain_plain(*args)
    ok = want != 0
    assert torch.equal(got == 0, ~ok)
    assert ((got - want)[ok].abs() / want[ok].abs()).max().item() < 1e-13
    assert torch.equal(flags, want_flags)


def test_amplify_kernel_flags(cuda):
    """Both flag bits on the card: a negative and a NaN fv entry."""
    f, fv, esc, ivl, gvl, gv = _seeded_inputs(65537, None, cuda)
    fv[5], fv[9] = -0.5, float("nan")
    got, flags = amplify_kernel.amplify_gain(f, fv, esc, ivl, gvl, gv)
    want, want_flags = amplify_kernel.amplify_gain_plain(f, fv, esc, ivl,
                                                         gvl, gv)
    assert torch.equal(flags, want_flags)
    assert torch.equal((flags & amplify_kernel.FLAG_NAN) != 0, ~esc)
    assert torch.equal(got.isnan(), want.isnan())


def test_find_index_kernel_vs_searchsorted(cuda):
    """B1's interval search against the twin's clamped searchsorted on a
    uniform grid and three warped ones, grid lines, their neighbours, NaN
    and the infinities included."""
    from raytrace_tpu_torch.ops.interp import find_index

    rng = np.random.default_rng(3)
    for X in (np.linspace(-3e-3, 9e-3, 106),
              np.sort(rng.uniform(-1.0, 1.0, 26)) ** 3,
              -3e-3 + 1.2e-2 * np.linspace(0.0, 1.0, 106) ** 1.8,
              np.geomspace(1e-6, 1.0, 106)):
        y = np.concatenate([X, np.nextafter(X, -np.inf),
                            np.nextafter(X, np.inf),
                            rng.uniform(X[0] - 1e-3, X[-1] + 1e-3, 100000),
                            [np.nan, np.inf, -np.inf]])
        Xt, yt = (torch.as_tensor(a, device=cuda) for a in (X, y))
        got = trace_kernel.find_index_launch(
            cuda_lib.load_library(), Xt, yt,
            torch.cuda.current_stream().cuda_stream)
        assert torch.equal(got.long(), find_index(Xt, yt))


def test_gather_probe_kernel_vs_twin(cuda):
    from raytrace_tpu_torch.tools import gather_probe

    tab, idx = (t.to(cuda) for t in gather_probe.probe_inputs())
    got = gather_probe.gather_probe(tab, idx, 64)
    assert torch.equal(got, gather_probe.gather_probe_plain(tab, idx, 64))


@pytest.mark.parametrize("reorder", [False, True])
def test_stream_on_card_matches_sync(cuda, reorder):
    """The stream's side streams and pinned buffers: every yield within
    1e-12 of the synchronous call on the same unit."""
    from raytrace_tpu_torch import create_image, create_image_stream

    units = [synthetic_problem(seeded=i % 2 == 1, rng=i) for i in range(4)]
    want = [create_image(synthetic_problem(seeded=i % 2 == 1, rng=i),
                         "cuda", device=cuda) for i in range(4)]
    got = list(create_image_stream(units, "cuda", device=cuda, depth=2,
                                   reorder=reorder))
    for (gi, ga), (wi, wa) in zip(got, want):
        assert np.linalg.norm(gi - wi) <= 1e-12 * np.linalg.norm(wi)
        assert np.linalg.norm(ga - wa) <= 1e-12 * np.linalg.norm(wa)
