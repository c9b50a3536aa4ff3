"""The port at the geometry of the medium-scale bench rows, on the CPU: the
shipped shapes resampled as the reference's ``-scale=`` does (seeded
``-scale=4``, 30,663,360 rays; ASE ``-scale=16``, 6,384,000 rays), of which
every 997th ray from ray 5 is traced, so the scaled grids, seed tables and
deposits run at that scale on a few thousand rays. The plain twins against
the JAX package, the sharded call against the single call
(``tests/test_multichip.py``'s seed_medium check), and a ragged last chunk
against one chunk."""

import numpy as np
import pytest
import torch

import raytrace_tpu
from raytrace_tpu.io.loader import scale_problem as jax_scale_problem
from raytrace_tpu.testing import synthetic_problem as jax_synthetic

from raytrace_tpu_torch import create_image
from raytrace_tpu_torch.convert import problem_from_jax
from raytrace_tpu_torch.models.ray_tracer import generate_ray_indices
from raytrace_tpu_torch.parallel.sharding import create_image_sharded
from raytrace_tpu_torch.testing import ASE_SHAPE, SEED_SHAPE, ray_count
from raytrace_tpu_torch.utils.stats import check_ans

torch.set_num_threads(2)

N_START, N_PARALLEL = 5, 997

#: bench row -> (shape, -scale=, rays of the scaled problem, a chunk size
#: that leaves the stride's rays as many chunks as the card's 2^20-ray
#: chunks, the last one short)
CASES = {"seed_scale4": (SEED_SHAPE, 4.0, 30663360, 1050),
         "scale16": (ASE_SHAPE, 16.0, 6384000, 1000)}


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _jax_problem(name):
    shape, scale = CASES[name][:2]
    p = jax_synthetic(**shape)
    jax_scale_problem(p, scale)
    p.N_start, p.N_parallel = N_START, N_PARALLEL
    return p


@pytest.fixture(scope="module")
def single():
    """The port's single-chunk result of each case, computed once."""
    out = {}
    for name in CASES:
        p = problem_from_jax(_jax_problem(name))
        out[name] = create_image(p, "cpu",
                                 chunk_size=len(generate_ray_indices(p)))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_scaled_geometry_against_jax(single, name):
    pj = _jax_problem(name)
    p = problem_from_jax(pj)
    assert ray_count(p) == CASES[name][2]
    image_j, i_ang_j = raytrace_tpu.create_image(pj, "lax")
    image, i_ang = single[name]
    assert _rel(image, image_j) < 1e-5 and _rel(i_ang, i_ang_j) < 1e-5


def test_seed_scaled_sharded_matches_single(single):
    p = problem_from_jax(_jax_problem("seed_scale4"))
    image, i_ang = create_image_sharded(p, ("cpu",) * 2, "cpu")
    image1, i_ang1 = single["seed_scale4"]
    assert check_ans(image1, i_ang1, image, i_ang)
    assert _rel(image, image1) < 1e-4 and _rel(i_ang, i_ang1) < 1e-4


@pytest.mark.parametrize("name", list(CASES))
def test_ragged_last_chunk(single, name):
    p = problem_from_jax(_jax_problem(name))
    chunk = CASES[name][3]
    n = len(generate_ray_indices(p))
    assert 0 < n % chunk < chunk // 2    # a short last chunk
    image, i_ang = create_image(p, "cpu", chunk_size=chunk)
    image1, i_ang1 = single[name]
    assert _rel(image, image1) < 1e-12 and _rel(i_ang, i_ang1) < 1e-12
