"""``tools/kernel_digest``'s comparison on the CPU (writing the outputs
needs the card): bitwise for every output but B2's sums under atomics,
which are held to 1e-14 relative."""

import numpy as np
import pytest

from raytrace_tpu_torch.tools import kernel_digest


def _files():
    rng = np.random.default_rng(0)
    a = {"seed_chunk.trace.gvl": rng.random(64).astype(np.float32),
         "seed_chunk.deposit.image": rng.random((8, 4)),
         "seed_chunk.deposit_f32.i_ang": rng.random((8, 1)),
         "seed_chunk.amplify_f32.hi": rng.random(64).astype(np.float32),
         "seed_chunk.deposit.bins": rng.integers(-1, 8, (64, 2),
                                                 dtype=np.int32)}
    return a, {k: v.copy() for k, v in a.items()}


def test_identical_outputs_agree(capsys):
    a, b = _files()
    assert kernel_digest.compare(a, b) == 0
    assert "DIFFERS" not in capsys.readouterr().out


@pytest.mark.parametrize("key,delta,bad", [
    ("seed_chunk.deposit.image", 1e-16, 0),
    ("seed_chunk.deposit.image", 1e-12, 1),
    ("seed_chunk.deposit_f32.i_ang", 1e-16, 0),
    ("seed_chunk.deposit_f32.i_ang", 1e-12, 1),
    ("seed_chunk.amplify_f32.hi", 1e-6, 1),
    ("seed_chunk.trace.gvl", 1e-7, 1)])
def test_differences(key, delta, bad):
    """B2's and B2-f32's sums may move at rounding; a trace output and
    B3-f32's pair may not move."""
    a, b = _files()
    b[key] = (b[key] * (1 + delta)).astype(b[key].dtype)
    assert kernel_digest.compare(a, b) == bad


def test_missing_output_and_usage():
    a, b = _files()
    del b["seed_chunk.deposit.bins"]
    assert kernel_digest.compare(a, b) == 1
    assert kernel_digest.main([]) == 2
