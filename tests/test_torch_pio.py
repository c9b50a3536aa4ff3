"""The port's print streams (``raytrace_tpu_torch/utils/pio.py``) against
``raytrace_tpu.utils.pio``: the same calls on the same seeded strings and
numbers give the same stdout, stderr, return values and log-file contents,
compared exactly, on rank 0 and with both modules' ``rank`` patched to 1."""

import io

import numpy as np
import pytest

import raytrace_tpu  # noqa: F401
from raytrace_tpu.utils import pio as jax_pio

from raytrace_tpu_torch.parallel import distributed
from raytrace_tpu_torch.utils import pio as port_pio

MODULES = (jax_pio, port_pio)


@pytest.fixture(autouse=True)
def no_log_file():
    for m in MODULES:
        m.set_log_file(None)
    yield
    for m in MODULES:
        m.set_log_file(None)


def seeded_calls(seed, n=6):
    """``n`` (format, args) pairs of words and numbers made from ``seed``."""
    rng = np.random.default_rng(seed)
    words = ["ray", "image", "I_ang", "gain", "seed", "ASE", "100%"]
    calls = []
    for _ in range(n):
        w = words[int(rng.integers(len(words)))].replace("%", "%%")
        i = int(rng.integers(-10 ** 6, 10 ** 6))
        x = float(rng.normal() * 10.0 ** rng.integers(-8, 8))
        calls.append((f"{w} %d %.6e %s|%-8s|\n", (i, x, repr(x), w)))
    calls.append(("no arguments, 100%\n", ()))
    return calls


def run(module, what, calls):
    """Each call through ``module``'s ``what``; the values returned."""
    out = []
    for fmt, args in calls:
        if what == "pout":
            out.append(module.pout.write(module.stringf(fmt, *args)))
        elif what == "perr":
            out.append(module.perr.write(module.stringf(fmt, *args)))
        elif what == "plog":
            out.append(module.plog.write(module.stringf(fmt, *args)))
        elif what == "printp":
            out.append(module.printp(fmt, *args))
        else:
            out.append(module.stringf(fmt, *args))
    for s in (module.pout, module.perr, module.plog):
        s.flush()
    return out


WHATS = ("pout", "perr", "plog", "printp", "stringf")


def test_all_lists_equal():
    assert port_pio.__all__ == jax_pio.__all__


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("what", WHATS)
def test_output_equal(capsys, what, seed):
    """stdout, stderr and the values returned, with no log file."""
    calls = seeded_calls(seed)
    got = {}
    for m in MODULES:
        ret = run(m, what, calls)
        got[m] = (ret, capsys.readouterr())
    (r_jax, o_jax), (r_port, o_port) = got[jax_pio], got[port_pio]
    assert r_port == r_jax
    assert (o_port.out, o_port.err) == (o_jax.out, o_jax.err)
    if what in ("pout", "printp"):
        assert o_port.out and not o_port.err
    if what == "perr":
        assert o_port.err and not o_port.out


@pytest.mark.parametrize("what", WHATS)
def test_log_file_equal(capsys, what):
    """The log file: ``pout``, ``perr`` and ``printp`` tee to it, ``plog``
    writes to it alone; after ``set_log_file(None)`` nothing is logged."""
    calls = seeded_calls(7)
    logs = {}
    for m in MODULES:
        log = io.StringIO()
        m.set_log_file(log)
        run(m, what, calls[:3])
        m.set_log_file(None)
        run(m, what, calls[3:])
        logs[m] = log.getvalue()
    capsys.readouterr()
    assert logs[port_pio] == logs[jax_pio]
    if what == "stringf":
        assert logs[port_pio] == ""
    else:
        assert logs[port_pio] == "".join(f % a for f, a in calls[:3])


def test_log_file_on_disk(tmp_path, capsys):
    """A file on disk gets the same bytes from both modules, flushed after
    each write."""
    texts = {}
    for m in MODULES:
        path = tmp_path / f"{m.__name__}.log"
        with open(path, "w") as f:
            m.set_log_file(f)
            m.printp("%d rays\n", 399000)
            m.perr.write("error line\n")
            m.plog.write("log only\n")
            texts[m] = path.read_text()  # before the close: flushed
            m.set_log_file(None)
    capsys.readouterr()
    assert texts[port_pio] == texts[jax_pio] == (
        "399000 rays\nerror line\nlog only\n")


def test_rank_gating(monkeypatch, capsys):
    """On rank 1: ``pout`` and ``printp`` print nothing, ``perr`` prints,
    and every stream still writes to the log."""
    got = {}
    for m in MODULES:
        monkeypatch.setattr(m, "rank", lambda: 1)
        log = io.StringIO()
        m.set_log_file(log)
        n = m.printp("rank %d of %d\n", 1, 2)
        m.pout.write("pout line\n")
        m.perr.write("perr line\n")
        m.plog.write("plog line\n")
        m.set_log_file(None)
        got[m] = (n, capsys.readouterr(), log.getvalue())
    (n_j, o_j, log_j), (n_p, o_p, log_p) = got[jax_pio], got[port_pio]
    assert n_p == n_j == len("rank 1 of 2\n")
    assert o_p.out == o_j.out == ""
    assert o_p.err == o_j.err == "perr line\n"
    assert log_p == log_j == ("rank 1 of 2\npout line\nperr line\n"
                              "plog line\n")


def test_rank_follows_process_group(monkeypatch):
    """``rank()`` is the process group's rank, looked up at each call."""
    assert port_pio.rank() == jax_pio.rank() == 0
    monkeypatch.setattr(distributed, "rank", lambda: 3)
    assert port_pio.rank() == 3


@pytest.mark.parametrize("fmt,args", [("100%", ()), ("%d%%", (100,)),
                                      ("%s", ("%d",)), ("", ())])
def test_percent_only_with_arguments(capsys, fmt, args):
    """``%`` formats only when there are arguments."""
    got = []
    for m in MODULES:
        n = m.printp(fmt, *args)
        got.append((n, m.stringf(fmt, *args), capsys.readouterr().out))
    assert got[0] == got[1]
    assert got[1][1] == (fmt % args if args else fmt)
