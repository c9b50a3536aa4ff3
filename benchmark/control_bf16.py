"""Readings that the limits of ``correct`` are set from, for a cell whose
configuration already runs the program's lower precision, the f32
spectrum (``ase-f32``), in one process on the card:

    python -m benchmark.control_bf16 --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] --seconds 2

``benchmark.control``'s control is the f32 spectrum, which here is the
program itself. This control is the program with each call's image and
I_ang rounded to bfloat16 before the check: the step below f32 that keeps
f32's exponent range, so a half-precision spectrum would read at least
that far off. For each of ``--seeds`` it runs the cell's window (short, at
the cell's own load and sizes) and its check as the configuration states
them, the lower readings; for each of ``--control-seeds`` the same with the
rounding, the upper readings. One JSON line per run; the benchmark's own
runs never run the control.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np


def bf16(x) -> np.ndarray:
    """``x`` rounded to the nearest bfloat16 (ties to even), as f64."""
    import torch

    return (torch.as_tensor(np.asarray(x)).to(torch.bfloat16)
            .to(torch.float64).numpy())


@contextlib.contextmanager
def rounded_outputs():
    """Every call of a window is checked with its image and I_ang rounded
    to bfloat16 (``harness.Run.done`` wrapped while the block runs)."""
    from benchmark import harness

    done = harness.Run.done

    def rounded(run, idx, factors, t0, t1, out):
        if out is not None:
            out = (bf16(out[0]), bf16(out[1]))
        done(run, idx, factors, t0, t1, out)

    harness.Run.done = rounded
    try:
        yield
    finally:
        harness.Run.done = done


def readings(cell: dict, seed: int, seconds: float, control: bool,
             device: str = "cuda") -> dict:
    """One short run of ``cell`` (its outputs rounded to bfloat16 where
    ``control``): the numbers its check compares."""
    from benchmark import control as f64_control

    with rounded_outputs() if control else contextlib.nullcontext():
        out = f64_control.readings(cell, seed, seconds, False, device)
    return {**out, "side": "control" if control else "program"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.control_bf16")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print("benchmark.control_bf16: not enough CUDA devices",
              file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for control, group in ((False, seeds), (True, controls)):
        for seed in group:
            print(json.dumps(readings(cell, seed, args.seconds, control)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
