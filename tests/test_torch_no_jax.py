"""The port stands alone: it imports torch and never jax or raytrace_tpu,
and chip_smoke.py refuses to run without a CUDA device or without the
package beside it."""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import raytrace_tpu_torch
for m in pkgutil.walk_packages(raytrace_tpu_torch.__path__,
                               "raytrace_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "raytrace_tpu"
             or n.startswith("raytrace_tpu."))
print("LOADED", len([n for n in sys.modules
                     if n.startswith("raytrace_tpu_torch")]))
print("BAD", bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_imports_no_jax():
    r = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                       text=True, cwd=ROOT, env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
    assert int(r.stdout.split("LOADED")[1].split()[0]) > 15


def test_chip_smoke_fails_without_cuda():
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, cwd=ROOT, env=_env(), timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, cwd=tmp_path, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
