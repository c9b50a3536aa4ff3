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


@pytest.mark.parametrize("spread,K", [(None, 82), (40, 82), (None, 7)])
def test_amplify_f32_kernel_vs_twin(cuda, spread, K):
    """B3's f32 instantiation on the card: the pair, the spectrum and the
    flags bitwise equal to the twin's on the card; counted under both
    ``launch_count`` and ``F32``."""
    args = _seeded_inputs(65536, spread, cuda, K)
    before = (amplify_kernel.launch_count, amplify_kernel.F32.launch_count)
    got, flags = amplify_kernel.amplify_gain(*args, dtype=torch.float32)
    torch.cuda.synchronize()
    assert (amplify_kernel.launch_count, amplify_kernel.F32.launch_count) \
        == (before[0] + 1, before[1] + 1)
    _, _, pair = amplify_kernel._launch(
        cuda_lib.load_library(), *args,
        torch.cuda.current_stream().cuda_stream, log_gain=True,
        dtype=torch.float32)
    hi, lo = amplify_kernel.log_gain2_plain(*args[3:])
    assert torch.equal(pair[0], hi) and torch.equal(pair[1], lo)
    want, want_flags = amplify_kernel.amplify_gain_plain(
        *args, dtype=torch.float32)
    assert torch.equal(got, want) and torch.equal(flags, want_flags)


@pytest.mark.parametrize("method", [1, 2])
def test_deposit_f32_kernel_vs_twin(cuda, method):
    """B2's f32 instantiation on the card: image and I_ang within 1e-12 of
    the twin's, counted under ``F32``."""
    from raytrace_tpu_torch.models.problem import prepare_beam
    from raytrace_tpu_torch.testing import deposit_inputs

    p = synthetic_problem(nx=118, ny=25, na=50, nb=50, nv=82, seeded=True)
    Iv, coords, ok = deposit_inputs(p.euv_beam, 65536, seed=2)
    beam = prepare_beam(p.euv_beam, cuda)
    args = (torch.as_tensor(Iv, device=cuda).to(torch.float32),
            tuple(torch.as_tensor(c, device=cuda) for c in coords),
            torch.as_tensor(ok, device=cuda), beam, method, 0.37)
    C, A = p.euv_beam.nx * p.euv_beam.ny, p.euv_beam.na * p.euv_beam.nb
    f64 = dict(dtype=torch.float64, device=cuda)
    got = (torch.zeros((C, 82), **f64), torch.zeros((A, 1), **f64))
    want = (torch.zeros((C, 82), **f64), torch.zeros((A, 1), **f64))
    before = deposit_kernel.F32.launch_count
    deposit_kernel.bin_deposit(*args, *got)
    deposit_kernel.bin_deposit_plain(*args, *want)
    torch.cuda.synchronize()
    assert deposit_kernel.F32.launch_count == before + 1
    for g, w in zip(got, want):
        assert not g.isnan().any()
        assert ((g - w).abs().max() / w.abs().max()).item() < 1e-12


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("K,B", [(82, 4099), (52, 1000), (7, 300),
                                 (400, 700)])
def test_deposit_f32_kernel_views(cuda, offset, K, B):
    """B2-f32 on a spectrum that is a view at ``offset`` floats into its
    storage (each 16-byte phase of the staged copies), with a ragged last
    tile, and at K 400, whose tile takes more than 48 KB of shared memory:
    bins bitwise, image and I_ang within 1e-12 of the twin's."""
    from raytrace_tpu_torch.models.problem import prepare_beam
    from raytrace_tpu_torch.ops.binning import bin_indices
    from raytrace_tpu_torch.testing import deposit_inputs

    p = synthetic_problem(nx=31, ny=9, na=11, nb=10, nv=K, seeded=True)
    Iv, coords, ok = deposit_inputs(p.euv_beam, B, seed=offset)
    store = torch.zeros(B * K + 4, dtype=torch.float32, device=cuda)
    view = store[offset:offset + B * K].view(B, K)
    view.copy_(torch.as_tensor(Iv, device=cuda))
    beam = prepare_beam(p.euv_beam, cuda)
    args = (view, tuple(torch.as_tensor(c, device=cuda) for c in coords),
            torch.as_tensor(ok, device=cuda), beam, 2, 0.37)
    C, A = p.euv_beam.nx * p.euv_beam.ny, p.euv_beam.na * p.euv_beam.nb
    f64 = dict(dtype=torch.float64, device=cuda)
    got = (torch.zeros((C, K), **f64), torch.zeros((A, 1), **f64))
    want = (torch.zeros((C, K), **f64), torch.zeros((A, 1), **f64))
    bins = deposit_kernel._launch(cuda_lib.load_library(), *args, *got,
                                  torch.cuda.current_stream().cuda_stream,
                                  bins=True)
    deposit_kernel.bin_deposit_plain(*args, *want)
    torch.cuda.synchronize()
    assert view.data_ptr() % 16 == 4 * offset
    assert torch.equal(bins, bin_indices(*args[1:3], beam, 2))
    for g, w in zip(got, want):
        assert not g.isnan().any()
        assert ((g - w).abs().max() / w.abs().max()).item() < 1e-12


@pytest.mark.parametrize("seeded", [False, True])
def test_create_image_f32_on_card(cuda, seeded):
    """The f32 call on the card: the kernels' f32 instantiations launched
    (seeded: B3's), within 1e-12 of the twins on the card in f32 and
    within 1e-5 of the f64 call."""
    from raytrace_tpu_torch import create_image

    def call(method):
        return create_image(synthetic_problem(seeded=seeded), method,
                            spectrum_dtype=torch.float32, device=cuda)

    before = (amplify_kernel.F32.launch_count,
              deposit_kernel.F32.launch_count)
    img, ang = call("cuda")
    assert deposit_kernel.F32.launch_count > before[1]
    assert (amplify_kernel.F32.launch_count > before[0]) == seeded
    img_t, ang_t = call("cpu")
    img64, ang64 = create_image(synthetic_problem(seeded=seeded), "cuda",
                                device=cuda)
    for a, b, tol in ((img, img_t, 1e-12), (ang, ang_t, 1e-12),
                      (img, img64, 1e-5), (ang, ang64, 1e-5)):
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= tol


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


@pytest.mark.parametrize("seeded", [False, True])
def test_sharded_on_card_matches_single(cuda, seeded):
    """Two mesh entries on one card, each on its own compute stream: the
    reduced images within 1e-12 of the single call, B1, B2 (and, seeded,
    B3) launched."""
    from raytrace_tpu_torch import create_image
    from raytrace_tpu_torch.parallel.sharding import create_image_sharded

    want = create_image(synthetic_problem(seeded=seeded), "cuda",
                        device=cuda)
    before = (trace_kernel.launch_count, deposit_kernel.launch_count,
              amplify_kernel.launch_count)
    got = create_image_sharded(synthetic_problem(seeded=seeded),
                               ("cuda:0", "cuda:0"), "cuda")
    after = (trace_kernel.launch_count, deposit_kernel.launch_count,
             amplify_kernel.launch_count)
    assert after[0] >= before[0] + 2 and after[1] >= before[1] + 2
    assert (after[2] > before[2]) == seeded
    for g, w in zip(got, want):
        assert np.linalg.norm(g - w) <= 1e-12 * np.linalg.norm(w)


@pytest.mark.parametrize("fixture", ["golden_ase.dat", "golden_seed.dat"])
def test_sharded_fixture_on_card(cuda, fixture):
    import os

    from raytrace_tpu_torch import check_ans, load_input
    from raytrace_tpu_torch.parallel.sharding import create_image_sharded

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", fixture)
    p, image0, i_ang0 = load_input(path)
    image, i_ang = create_image_sharded(p, ("cuda:0", "cuda:0"), "cuda")
    assert check_ans(image0, i_ang0, image, i_ang)


@pytest.mark.parametrize("reorder", [False, True])
def test_sharded_stream_on_card(cuda, reorder):
    """The sharded stream on two entries of the card: every yield within
    1e-12 of the synchronous sharded call on the same unit."""
    from raytrace_tpu_torch import create_image_stream
    from raytrace_tpu_torch.parallel.sharding import create_image_sharded

    mesh = ("cuda:0", "cuda:0")
    want = [create_image_sharded(synthetic_problem(seeded=i % 2 == 1, rng=i),
                                 mesh, "cuda") for i in range(4)]
    got = list(create_image_stream(
        [synthetic_problem(seeded=i % 2 == 1, rng=i) for i in range(4)],
        "cuda", mesh=mesh, depth=2, reorder=reorder))
    for (gi, ga), (wi, wa) in zip(got, want):
        assert np.linalg.norm(gi - wi) <= 1e-12 * np.linalg.norm(wi)
        assert np.linalg.norm(ga - wa) <= 1e-12 * np.linalg.norm(wa)


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the multi-card path")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@pytest.mark.parametrize("seeded", [False, True])
def test_single_call_on_cuda1_with_cuda0_current(two_cards, seeded):
    """A call on cuda:1 with cuda:0 current launches on cuda:1 (its
    per-device counts) and leaves cuda:0 current. B1's per-ray outputs are
    bitwise equal to cuda:0's on the same rays; the image is within 1e-12
    of cuda:0's call (B2's f64 atomics add in an order that changes from
    call to call, on one card as across cards)."""
    from raytrace_tpu_torch import create_image
    from raytrace_tpu_torch.testing import source_rays

    torch.cuda.set_device(0)
    p = synthetic_problem(seeded=seeded)
    method = 2 if seeded else 1
    res = {}
    for dev in two_cards[:2]:
        rays = source_rays(p, 4096, dev)
        res[dev.index] = trace_kernel.trace_batch(
            rays, p.N, p.euv_beam.dz, prepare_gain(p.gain, dev), method,
            use_emis=not seeded)
    for f in res[0]._fields:
        assert torch.equal(getattr(res[0], f).cpu(), getattr(res[1], f).cpu())
    want = create_image(synthetic_problem(seeded=seeded), "cuda",
                        device="cuda:0")
    before = {w: dict(w.device_launches)
              for w in (trace_kernel, deposit_kernel, amplify_kernel)}
    got = create_image(synthetic_problem(seeded=seeded), "cuda",
                       device="cuda:1")
    assert torch.cuda.current_device() == 0
    for w in (trace_kernel, deposit_kernel) + (
            (amplify_kernel,) if seeded else ()):
        assert (w.device_launches.get(two_cards[1], 0)
                > before[w].get(two_cards[1], 0))
        assert (w.device_launches.get(two_cards[0], 0)
                == before[w].get(two_cards[0], 0))
    for g, w in zip(got, want):
        assert np.linalg.norm(g - w) <= 1e-12 * np.linalg.norm(w)


@pytest.mark.parametrize("seeded", [False, True])
def test_sharded_on_every_card_matches_single(two_cards, seeded):
    """create_image_sharded on make_mesh(), one entry a card: within 1e-12
    of the single call, and B1, B2 (and, seeded, B3) launched on every
    card."""
    from raytrace_tpu_torch import create_image
    from raytrace_tpu_torch.parallel.mesh import make_mesh
    from raytrace_tpu_torch.parallel.sharding import create_image_sharded

    want = create_image(synthetic_problem(seeded=seeded), "cuda",
                        device="cuda:0")
    kernels = (trace_kernel, deposit_kernel) + (
        (amplify_kernel,) if seeded else ())
    before = {w: dict(w.device_launches) for w in kernels}
    got = create_image_sharded(synthetic_problem(seeded=seeded), make_mesh(),
                               "cuda")
    for w in kernels:
        for dev in two_cards:
            assert w.device_launches.get(dev, 0) > before[w].get(dev, 0)
    for g, w in zip(got, want):
        assert np.linalg.norm(g - w) <= 1e-12 * np.linalg.norm(w)


def _eager(p, device):
    """The call run from Python on the card: the reference a graph replay
    is held against."""
    from raytrace_tpu_torch.models import ray_tracer

    prep = ray_tracer.prepare_pipeline(p, "cuda", device=device, eager=True)
    return ray_tracer._finalize_call(p, prep, prep.pipeline(*prep.operands),
                                     "unused.dat")


def _close(got, want):
    for g, w in zip(got, want):
        assert np.linalg.norm(g - w) <= 1e-12 * np.linalg.norm(w)


@pytest.mark.parametrize("seeded", [False, True])
def test_graph_replay_matches_eager(cuda, seeded):
    """create_image replays one captured graph over units of one shape with
    different tables: each within 1e-12 of its eager call, each replay
    adding the captured launches to the wrappers' counts."""
    import functools

    from raytrace_tpu_torch import create_image
    from raytrace_tpu_torch.models import ray_tracer
    from raytrace_tpu_torch.testing import perturbed_problems

    source = functools.partial(synthetic_problem, seeded=seeded)
    units = perturbed_problems(source, 3, salt=7)
    prep = ray_tracer.prepare_pipeline(units[0], "cuda", device=cuda)
    assert isinstance(prep.pipeline, ray_tracer._GraphPipeline)
    for u, w in zip(units, [_eager(u, cuda) for u in
                            perturbed_problems(source, 3, salt=7)]):
        before = trace_kernel.launch_count
        _close(create_image(u, "cuda", device=cuda), w)
        assert (trace_kernel.launch_count - before
                >= prep.cfg["launches"]["trace"] > 0)
    graphs = ray_tracer.prepare_pipeline(units[0], "cuda",
                                         device=cuda).pipeline.graphs
    assert len(graphs) == 1 and graphs[0].nodes["kernel"] > 0
    assert not graphs[0].in_flight


def test_two_stream_slots_replayed_back_to_back(cuda):
    """Two calls of one shape in flight at once replay two graphs, each
    with its own staging buffer, outputs and B1 counters; both agree with
    their eager calls."""
    import functools

    from raytrace_tpu_torch.models import ray_tracer
    from raytrace_tpu_torch.testing import perturbed_problems

    source = functools.partial(synthetic_problem, seeded=True)
    want = [_eager(u, cuda) for u in perturbed_problems(source, 2, salt=9)]
    units = perturbed_problems(source, 2, salt=9)
    preps = [ray_tracer.prepare_pipeline(u, "cuda", device=cuda)
             for u in units]
    outs = [prep.pipeline(*prep.operands) for prep in preps]
    assert outs[0].graph is not outs[1].graph
    assert outs[0].graph.ctr.data_ptr() != outs[1].graph.ctr.data_ptr()
    for u, prep, o, w in zip(units, preps, outs, want):
        _close(ray_tracer._finalize_call(u, prep, o, "unused.dat"), w)
    for o in outs:
        assert not o.graph.in_flight and not o.graph.ctr.any()


@pytest.mark.parametrize("seeded", [False, True])
def test_graph_on_a_card_not_current(two_cards, seeded):
    """A call on cuda:1 with cuda:0 current captures and replays its graph
    on cuda:1, within 1e-12 of the eager call there, cuda:0 left
    current."""
    from raytrace_tpu_torch import create_image

    torch.cuda.set_device(0)
    want = _eager(synthetic_problem(seeded=seeded), "cuda:1")
    for _ in range(2):
        _close(create_image(synthetic_problem(seeded=seeded), "cuda",
                            device="cuda:1"), want)
        assert torch.cuda.current_device() == 0


def test_graph_cache_reserves_its_pools(cuda):
    """After a fixture's call the card reserves its graph's pool and
    little else (the bench's ``graph_memory_check`` margin); a second
    config's capture raises the reservation by its own pool, plus at most
    one 2 MiB segment of the allocator's small pool (its B1 counters)."""
    import os

    from raytrace_tpu_torch import create_image, load_input
    from raytrace_tpu_torch.models import ray_tracer
    from raytrace_tpu_torch.tools import bench

    fixtures = os.path.join(os.path.dirname(__file__), "fixtures")
    ray_tracer.clear_pipeline_cache()
    torch.cuda.synchronize(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    reserved = []
    for name in ("golden_seed.dat", "golden_ase.dat"):
        p = load_input(os.path.join(fixtures, name))[0]
        create_image(p, "cuda", device=cuda)
        graphs = ray_tracer.prepare_pipeline(p, "cuda",
                                             device=cuda).pipeline.graphs
        assert len(graphs) == 1 and graphs[0].pool_bytes > 0
        reserved.append(torch.cuda.memory_reserved(cuda))
        over = reserved[-1] - ray_tracer.graph_pool_bytes(cuda)
        assert 0 <= over <= max(
            bench.GRAPH_MEMORY_FLOOR,
            bench.GRAPH_MEMORY_SHARE * torch.cuda.max_memory_allocated(cuda))
    assert reserved[1] - reserved[0] <= graphs[0].pool_bytes + 2 * 2 ** 20
    ray_tracer.clear_pipeline_cache()
