"""Readings that the limits of ``correct`` are set from, for one cell, in
one process on the card:

    python -m benchmark.control --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] --seconds 2

For each of ``--seeds`` it runs the cell's window (short, at the cell's
own load and sizes) and its check, and prints the numbers compared: the
lower readings, those of sound runs. For each of ``--control-seeds`` it
does the same with the control in the program's place: the program's own
lower-precision path, its f32 spectrum (``spectrum_dtype=float32``, the
step below the configuration's f64), whose numbers are the upper readings.
One JSON line per run; the benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys


def readings(cell: dict, seed: int, seconds: float, control: bool,
             device: str = "cuda") -> dict:
    """One short run of ``cell`` (with the control in the program's place
    where ``control``): the numbers its check compares."""
    from benchmark import harness

    cell = copy.deepcopy(cell)
    if control:
        cell["config_spec"]["spectrum_dtype"] = "float32"
    out = harness.run_cell(cell, seed, seconds, False, device)
    return {"workload": cell["name"], "seed": seed,
            "side": "control" if control else "program",
            "attempted": out["attempted"], "failed": out["failed"],
            "correct": out["correct"],
            **{k: c["value"] for k, c in out["checks"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.control")
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
        print("benchmark.control: not enough CUDA devices", file=sys.stderr)
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
