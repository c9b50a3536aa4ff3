"""Rank-gated output: the reference's ``pout`` (SURVEY.md U4,
src/utilities/RayUtilities.{h,cpp}).

In the reference, rank 0 prints the benchmark's output; here the rank is
the process's rank in the port's process group
(:mod:`raytrace_tpu_torch.parallel.distributed`; 0 without one).
"""

from __future__ import annotations

import sys

from raytrace_tpu_torch.parallel.distributed import rank

__all__ = ["pout"]


class _RankZeroStdout:
    """Writes to stdout on rank 0 only (the reference's rank-0-only
    benchmark output, CreateImage.cpp:86)."""

    def write(self, text: str) -> None:
        if rank() == 0:
            sys.stdout.write(text)
            sys.stdout.flush()

    def flush(self) -> None:
        sys.stdout.flush()


pout = _RankZeroStdout()
