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


@pytest.mark.parametrize("K,C", [(52, 1500), (1, 266)])
def test_deposit_kernel_vs_twin(cuda, K, C):
    rng = np.random.default_rng(1)
    B = 100_000
    contrib = torch.as_tensor(rng.standard_normal((B, K)), device=cuda)
    bins = torch.as_tensor(rng.integers(0, C + 1, B).astype(np.int32),
                           device=cuda)
    got = deposit_kernel.deposit(
        torch.zeros((C, K), dtype=torch.float64, device=cuda), contrib, bins)
    want = deposit_kernel.deposit_plain(
        torch.zeros((C, K), dtype=torch.float64, device=cuda), contrib, bins)
    assert ((got - want).abs().max() / want.abs().max()).item() < 1e-12


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


@pytest.mark.parametrize("spread", [None, 40])
def test_amplify_kernel_vs_twin(cuda, spread):
    """B3 at the seeded shipped widths: the log-gain bitwise, the spectrum
    within 1e-13 (CUDA's exp against PyTorch's)."""
    ivl, gvl, gv = (torch.as_tensor(a, device=cuda)
                    for a in amplify_inputs(B=65536, spread=spread))
    rng = np.random.default_rng(6)
    Iv0 = torch.as_tensor(rng.random((65536, gv.shape[2])), device=cuda)
    before = amplify_kernel.launch_count
    got = amplify_kernel.amplify_gain(Iv0, ivl, gvl, gv)
    torch.cuda.synchronize()
    assert amplify_kernel.launch_count == before + 1
    _, gl = amplify_kernel._launch(cuda_lib.load_library(), Iv0, ivl, gvl,
                                   gv, torch.cuda.current_stream().cuda_stream,
                                   log_gain=True)
    assert torch.equal(gl, amplify_kernel.log_gain_plain(ivl, gvl, gv))
    want = amplify_kernel.amplify_gain_plain(Iv0, ivl, gvl, gv)
    assert ((got - want).abs() / want.abs()).max().item() < 1e-13


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
