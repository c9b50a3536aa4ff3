"""The port's CLI: the serving-mode rows (``-stream=N``, ``-reorder``) on
the plain twins, and the JAX CLI's refusal of ``-reorder`` alone."""

import os

import pytest
import torch

from raytrace_tpu_torch.utils import cli

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "golden_seed.dat")


def test_reorder_requires_stream():
    with pytest.raises(SystemExit, match="-reorder requires -stream=N"):
        cli.Options(["-reorder", FIXTURE])
    opts = cli.Options(["-stream=3", "-reorder", FIXTURE])
    assert opts.stream == 3 and opts.reorder and opts.files == [FIXTURE]


@pytest.mark.parametrize("reorder", [False, True])
def test_stream_rows(capsys, reorder):
    """One timed call (golden check included) and a 2-unit stream, two
    rounds: the per-call and steady rows are printed, no error counted."""
    argv = ["-methods=cpu", "-iterations=1", "-stream=2", FIXTURE]
    if reorder:
        argv.insert(0, "-reorder")
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    tag = "cpu+stream+reorder" if reorder else "cpu+stream"
    rows = [line.split()[0] for line in out.splitlines() if line.strip()]
    assert tag in rows and f"{tag}.steady" in rows
    assert "All tests passed" in out
