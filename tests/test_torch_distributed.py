"""The port's process group on the CPU: real 2-process gloo groups.

* ``raytrace_tpu_torch/tools/run_distributed.py`` on two ranks: gather_all,
  sum_scalar and host_sum_arrays across processes, the stride partition of
  the rays summed over the ranks, and a sharded call on a local mesh of 2
  per rank (4 shards over 2 processes) against the full image;
* the CLI's ``-nprocs=2`` launcher on the ASE fixture, and a rank that
  fails making the launcher fail;
* ``raytrace_tpu_torch/tools/production_loop.py`` with 1 rank against 2
  ranks: the reduced E_sum per step; without a card it raises unless asked
  for the CPU.

Each subprocess runs with a time limit and on the CPU.
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "raytrace_tpu_torch", "tools")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "golden_ase.dat")
TIMEOUT = 300


def _env():
    env = dict(os.environ, RAYTRACE_FORCE_CPU="1", OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    for name in ("RAYTRACE_COORD", "RAYTRACE_NPROCS", "RAYTRACE_PROC_ID",
                 "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(name, None)
    return env


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _ranks(tool, nproc):
    """Run ``tool`` as ``nproc`` ranks of one group; their outputs."""
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(TOOLS, tool), str(pid), str(nproc),
         port], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=_env(),
        cwd=ROOT, text=True) for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return procs, outs


def test_two_rank_harness():
    """Every CHECK of the rank worker passes on both ranks."""
    procs, outs = _ranks("run_distributed.py", 2)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {pid} failed:\n{out}"
        assert f"RESULT[{pid}] ALL_PASS" in out, out
        assert "FAIL" not in out, out
        assert len(re.findall(rf"CHECK\[{pid}\] \S+: pass", out)) == 10, out


def _gate_errors(out):
    return sum(out.count(msg) for msg in (
        "Standard deviation of run times is larger than 10%",
        "Maximum run time is more than 15% greater than the average"))


def test_cli_nprocs_two_ranks():
    """-nprocs=2 spawns a gloo group of two ranks: both pass the golden
    check, rank 0 prints each rank's timing and the verdict. The exit code
    is the cross-rank error sum; the reference's timing-stability gates
    (std <= 10% and max <= 1.15 x mean over the pooled samples) are the
    only errors allowed, and are counted exactly, because two ranks sharing
    the test machine's cores may time apart."""
    r = subprocess.run(
        [sys.executable, "-m", "raytrace_tpu_torch.utils.cli",
         "-methods=cpu", "-iterations=1", "-nprocs=2", FIXTURE],
        capture_output=True, text=True, timeout=TIMEOUT, cwd=ROOT,
        env=_env())
    out = r.stdout
    assert "Answers do not match" not in out, out + r.stderr
    assert len(re.findall(r"cpu rank [01] s/call: \[", out)) == 2, out
    assert out.count("Running tests for") == 1, out  # rank 0 prints
    assert r.returncode == _gate_errors(out), out + r.stderr
    if r.returncode == 0:
        assert "All tests passed" in out, out
    else:
        assert f"Some tests failed ({r.returncode} errors)" in out, out


def test_cli_nprocs_rank_failure_fails_the_launch():
    """A rank that fails (here: on a missing input file) makes the
    launcher exit non-zero."""
    r = subprocess.run(
        [sys.executable, "-m", "raytrace_tpu_torch.utils.cli",
         "-methods=cpu", "-iterations=1", "-nprocs=2",
         os.path.join(ROOT, "tests", "fixtures", "no_such_file.dat")],
        capture_output=True, text=True, timeout=TIMEOUT, cwd=ROOT,
        env=_env())
    assert r.returncode != 0
    assert "All tests passed" not in r.stdout


def _esums(text):
    return [float(m) for m in re.findall(r"E_sum=([0-9.e+-]+)", text)]


def test_production_loop_two_ranks_match_one():
    """Each rank computes its ray stride, IntensityStep.sum_reduce spans
    the group, and the reduced E_sum per step equals the single process's
    (the stride partition covers the same rays)."""
    r1 = subprocess.run(
        [sys.executable, os.path.join(TOOLS, "production_loop.py")],
        capture_output=True, text=True, timeout=TIMEOUT, env=_env(),
        cwd=ROOT)
    assert r1.returncode == 0, r1.stdout + r1.stderr
    ref = _esums(r1.stdout)
    assert len(ref) == 2 and all(v > 0 for v in ref)
    procs, outs = _ranks("production_loop.py", 2)
    assert all(p.returncode == 0 for p in procs), outs[0] + outs[1]
    got = _esums(outs[0])  # rank 0 prints (pio gates rank > 0)
    assert _esums(outs[1]) == [] and "ranks=2" in outs[0]
    assert "rank devices: cpu cpu" in outs[0], outs[0]
    assert len(got) == 2
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=0)


def test_production_loop_without_a_card_raises_unless_asked():
    """A rank runs on the CPU only when RAYTRACE_FORCE_CPU=1 asks for it:
    with no card visible and the variable unset, the loop fails."""
    env = _env()
    del env["RAYTRACE_FORCE_CPU"]
    r = subprocess.run(
        [sys.executable, os.path.join(TOOLS, "production_loop.py")],
        capture_output=True, text=True, timeout=TIMEOUT, env=env, cwd=ROOT)
    assert r.returncode != 0, r.stdout
    assert "no CUDA device is visible" in r.stderr, r.stderr
    assert _esums(r.stdout) == []
