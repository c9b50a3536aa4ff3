"""Run one cell of the benchmark once, as a fresh process:

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

It builds the cell's inputs from the seed, warms up the cell's own shapes,
measures for ``--seconds`` and prints, as its last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks`` (each number compared with the reference, beside its limit,
also the last lines of standard error). Without CUDA, or with fewer cards
than the cell asks for, it exits with 2 and prints no result; likewise
when a module of JAX or of the JAX package is loaded once the window has
closed.
"""

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    t_main = time.perf_counter()
    import torch

    from benchmark import harness

    t_torch = time.perf_counter()
    cell = harness.load_cell(args.workload)
    chips = int(cell["chips"])
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    t_cuda = time.perf_counter()
    if visible < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"{visible} visible", file=sys.stderr)
        return 2
    started = harness.process_start()
    if not 0.0 <= _STARTED - started < 30.0:
        started = _STARTED  # a start time from another clock
    print(f"start-up: {t_main - started:.4f} s to main, {t_torch - t_main:.4f}"
          f" s importing torch and the harness, {t_cuda - t_torch:.4f} s "
          f"counting the cards", file=sys.stderr, flush=True)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", started)
    leaked = harness.forbidden_modules()
    if leaked:
        print(f"benchmark: modules that no run may load are loaded: "
              f"{leaked}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
