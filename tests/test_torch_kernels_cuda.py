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
from raytrace_tpu_torch.ops import deposit_kernel, trace_kernel
from raytrace_tpu_torch.testing import synthetic_problem

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
