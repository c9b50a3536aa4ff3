"""The port's gain-only amplify (the plain twin of CUDA kernel B3) against
the JAX package.

* Its f64 log-gain against the Pallas kernel ``pallas_amplify.
  log_gain_fused`` in interpret mode, whose (hi, lo) f32 pair tracks the f64
  sum to ~1 ulp of the largest term: within 2e-7, the bound of
  tests/test_pallas_amplify.py.
* Its spectrum against ``raytrace_tpu.ops.spectrum.amplify`` in float64
  (the same sum in the same order, then ``Iv0 * exp``): 1e-14 relative.
* The wrapper takes the twin on CPU tensors and launches nothing; with no
  segments it returns ``Iv0``.
"""

import numpy as np
import pytest
import torch

import raytrace_tpu  # noqa: F401  (JAX package: x64 + CPU config)
import jax.numpy as jnp
from raytrace_tpu.ops import pallas_amplify as pa
from raytrace_tpu.ops import spectrum as jax_spectrum
from raytrace_tpu.ops.stepper import TraceResult as JaxTraceResult

from raytrace_tpu_torch.ops import amplify_kernel, spectrum
from raytrace_tpu_torch.ops.stepper import TraceResult
from raytrace_tpu_torch.testing import amplify_inputs

torch.set_num_threads(2)


@pytest.mark.parametrize("spread", [None, 40])
def test_log_gain_vs_pallas_interpret(spread):
    ivl, gvl, gv = amplify_inputs(spread=spread)
    nsub = ivl.shape[2]
    hi, lo = pa.log_gain_fused(jnp.asarray(ivl), jnp.asarray(gvl),
                               pa.pack_gv(jnp.asarray(gv)), nsub,
                               interpret=True)
    want = np.asarray(hi).astype(np.float64) + np.asarray(lo)
    got = amplify_kernel.log_gain_plain(
        *(torch.from_numpy(a) for a in (ivl, gvl, gv))).numpy()
    assert np.abs(got - want).max() < 2e-7


@pytest.mark.parametrize("nseg", [1, 2])
def test_amplify_vs_jax_f64(nseg):
    ivl, gvl, gv = amplify_inputs(B=512, nseg=nseg, seed=3)
    K = gv.shape[2]
    Iv0 = np.random.default_rng(5).random((ivl.shape[0], K))
    res = JaxTraceResult(gvl=jnp.asarray(gvl), evl=jnp.zeros(gvl.shape),
                         ivl=jnp.asarray(ivl), exit_x=None, exit_y=None,
                         exit_a=None, exit_b=None, escaped=None, perp=None)
    want = np.asarray(jax_spectrum.amplify(
        res, jnp.asarray(Iv0), jnp.asarray(gv), nseg + 1, False,
        dtype=jnp.float64))
    got = amplify_kernel.amplify_gain_plain(
        *(torch.from_numpy(a) for a in (Iv0, ivl, gvl, gv))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)


def test_no_segments_returns_iv0():
    Iv0 = torch.from_numpy(np.random.default_rng(1).random((64, 7)))
    ivl = torch.zeros((64, 0, 3), dtype=torch.int32)
    gvl = torch.zeros((64, 0, 3), dtype=torch.float32)
    gv = torch.zeros((0, 10, 7), dtype=torch.float32)
    assert torch.equal(amplify_kernel.amplify_gain(Iv0, ivl, gvl, gv), Iv0)


def test_spectrum_gain_only_goes_through_the_wrapper():
    """spectrum.amplify's gain-only branch is the wrapper; on CPU tensors
    the wrapper is the twin and launches nothing."""
    ivl, gvl, gv = (torch.from_numpy(a) for a in amplify_inputs(B=256, seed=7))
    Iv0 = torch.from_numpy(np.random.default_rng(2).random((256, 82)))
    res = TraceResult(gvl=gvl, evl=torch.zeros_like(gvl), ivl=ivl,
                      exit_x=None, exit_y=None, exit_a=None, exit_b=None,
                      escaped=None, perp=None)
    before = amplify_kernel.launch_count
    got = spectrum.amplify(res, Iv0, gv, gv.shape[0] + 1, use_emis=False)
    assert amplify_kernel.launch_count == before
    assert torch.equal(got, amplify_kernel.amplify_gain_plain(Iv0, ivl, gvl,
                                                              gv))


def test_wrapper_checks_its_inputs():
    ivl, gvl, gv = (torch.from_numpy(a) for a in amplify_inputs(B=256, seed=8))
    Iv0 = torch.zeros((256, 82), dtype=torch.float64)
    with pytest.raises(ValueError):
        amplify_kernel.amplify_gain(Iv0.float(), ivl, gvl, gv)
    with pytest.raises(ValueError):
        amplify_kernel.amplify_gain(Iv0, ivl.long(), gvl, gv)
    with pytest.raises(ValueError):
        amplify_kernel.amplify_gain(Iv0, ivl, gvl, gv[:, :, :40])
