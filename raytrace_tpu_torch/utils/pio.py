"""Parallel print streams: ``pout``/``perr``/``plog`` and ``printp`` (the
reference's SURVEY.md U4, src/utilities/RayUtilities.{h,cpp}).

In the reference, rank 0 prints the benchmark's output and every rank can
log; here the rank is the process's rank in the port's process group
(:mod:`raytrace_tpu_torch.parallel.distributed`; 0 without one). ``pout``
and ``perr`` tee to the log file that :func:`set_log_file` sets, on every
rank; ``plog`` writes to it alone.
"""

from __future__ import annotations

import sys
from typing import IO, Optional

from raytrace_tpu_torch.parallel import distributed

__all__ = ["pout", "perr", "plog", "printp", "set_log_file", "rank", "stringf"]

_log_file: Optional[IO] = None


def rank() -> int:
    """The process's rank (MPI_rank's analogue; 0 without a group), looked
    up at each call."""
    return distributed.rank()


def _log(text: str) -> None:
    if _log_file is not None:
        _log_file.write(text)
        _log_file.flush()


class _Stream:
    """Rank-gated output stream (``pout`` prints only on rank 0, like the
    reference's rank-0-only benchmark output, CreateImage.cpp:86)."""

    def __init__(self, target: str, rank0_only: bool, log_too: bool):
        self._target = target
        self._rank0_only = rank0_only
        self._log_too = log_too

    def write(self, text: str) -> None:
        if not self._rank0_only or rank() == 0:
            stream = getattr(sys, self._target)
            stream.write(text)
            stream.flush()
        if self._log_too:
            _log(text)

    def flush(self) -> None:
        getattr(sys, self._target).flush()


pout = _Stream("stdout", rank0_only=True, log_too=True)
perr = _Stream("stderr", rank0_only=False, log_too=True)


class _Log:
    """Writes to the log file alone (nothing without one)."""

    def write(self, text: str) -> None:
        _log(text)

    def flush(self) -> None:
        if _log_file is not None:
            _log_file.flush()


plog = _Log()


def set_log_file(f: Optional[IO]) -> None:
    """The file ``pout``, ``perr`` and ``plog`` write to (None: none)."""
    global _log_file
    _log_file = f


def stringf(fmt: str, *args) -> str:
    """sprintf returning a string (Utilities::stringf); ``fmt`` is
    formatted with ``%`` only when there are arguments."""
    return fmt % args if args else fmt


def printp(fmt: str, *args) -> int:
    """printf-style print to ``pout`` (Utilities::printp); the length of
    the text written."""
    text = stringf(fmt, *args)
    pout.write(text)
    return len(text)
