"""The port's surface held to ``raytrace_tpu``'s.

The JAX package's sources are read as text with ``ast``; nothing of it is
imported here. Every public function and class of each of its modules
(and every name of its ``__all__``) must have a counterpart in the port:
the same name in the same module, a name of its own (:data:`RENAMED`), or
an entry of :data:`NOT_PORTED`, whose reason is a bullet of ROADMAP.md's
"Not ported on purpose" list. The entry points take the JAX package's
positional parameters in its order, and every method name of
``raytrace_tpu`` resolves in the port. Runs on the CPU in seconds:

    python -m pytest tests/test_torch_surface.py -q
"""

import ast
import importlib
import inspect
import pathlib
import re

import numpy as np
import pytest
import torch

from raytrace_tpu_torch import create_image, create_image_stream
from raytrace_tpu_torch.models import ray_tracer
from raytrace_tpu_torch.parallel import sharding
from raytrace_tpu_torch.testing import synthetic_problem
from raytrace_tpu_torch.utils import cli
from raytrace_tpu_torch.utils.errors import RayTraceError

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_ROOT = ROOT / "raytrace_tpu"
FIXTURE = str(ROOT / "tests" / "fixtures" / "golden_ase.dat")

SMALL = dict(nx=4, ny=3, na=3, nb=2, nv=4)


def _tree(module: str) -> ast.Module:
    """The parsed source of ``raytrace_tpu``'s module ``module``."""
    parts = module.split(".")[1:]
    path = JAX_ROOT.joinpath(*parts)
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    return ast.parse(path.read_text())


def _public(tree: ast.Module) -> set:
    """The module's public top-level functions and classes, and its
    ``__all__``."""
    names = {n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)) and not n.name.startswith("_")}
    for n in tree.body:
        if isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in n.targets):
            names |= set(ast.literal_eval(n.value))
    return names


def _modules() -> list:
    mods = []
    for path in sorted(JAX_ROOT.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


#: the JAX package's public names, by module
SURFACE = {m: _public(_tree(m)) for m in _modules()}

#: counterparts under a name of their own: a JAX name -> the port's
RENAMED = {
    "raytrace_tpu.models.ray_tracer.BACKENDS":
        "raytrace_tpu_torch.models.ray_tracer.METHODS",
    "raytrace_tpu.models.ray_tracer.CommonPrep":
        "raytrace_tpu_torch.models.ray_tracer.PreparedCall",
    "raytrace_tpu.models.ray_tracer.prepare_common":
        "raytrace_tpu_torch.models.ray_tracer.prepare_pipeline",
    "raytrace_tpu.models.ray_tracer.chunk_core":
        "raytrace_tpu_torch.models.ray_tracer._dispatch_steps",
    "raytrace_tpu.models.ray_tracer.chunk_trace":
        "raytrace_tpu_torch.models.ray_tracer._dispatch_steps",
    "raytrace_tpu.models.ray_tracer.chunk_post":
        "raytrace_tpu_torch.models.ray_tracer._dispatch_steps",
    "raytrace_tpu.models.ray_tracer.reorder_chunk_core":
        "raytrace_tpu_torch.models.ray_tracer._dispatch_steps",
    "raytrace_tpu.models.ray_tracer.make_bundle_pack":
        "raytrace_tpu_torch.models.problem.pack_arrays",
    "raytrace_tpu.models.ray_tracer.unpack_bundle":
        "raytrace_tpu_torch.models.problem.unpack_arrays",
    "raytrace_tpu.models.ray_tracer.make_pallas_trace_fn":
        "raytrace_tpu_torch.ops.trace_kernel.trace_batch",
    "raytrace_tpu.models.ray_tracer.resolve_bin_deposit":
        "raytrace_tpu_torch.models.ray_tracer.check_deposit",
    "raytrace_tpu.ops.deposit_kernel.deposit_tiles":
        "raytrace_tpu_torch.ops.deposit_kernel.bin_deposit",
    "raytrace_tpu.ops.pallas_amplify.log_gain_fused":
        "raytrace_tpu_torch.ops.amplify_kernel.amplify_gain",
    "raytrace_tpu.ops.pallas_kernel.trace_tiles":
        "raytrace_tpu_torch.ops.trace_kernel.trace_batch",
    "raytrace_tpu.ops.pallas_kernel.PackedGain":
        "raytrace_tpu_torch.models.problem.DeviceGain",
    "raytrace_tpu.ops.pallas_kernel.pack_gain_tables":
        "raytrace_tpu_torch.models.problem.prepare_gain",
    "raytrace_tpu.ops.stepper.trace_batch":
        "raytrace_tpu_torch.ops.stepper.trace_batch_plain",
    "raytrace_tpu.parallel.distributed.process_mesh":
        "raytrace_tpu_torch.parallel.collectives.rank_sum_on_card",
    "raytrace_tpu.parallel.sharding.make_sharded_pipeline":
        "raytrace_tpu_torch.parallel.sharding.MeshRunner",
}

#: not ported on purpose: the opening words of the bullet of ROADMAP.md's
#: "Not ported on purpose" list that gives the reason -> the JAX names
NOT_PORTED = {
    "`ops/fast_stepper.py` (the `lax` backend)": (
        "raytrace_tpu.ops.fast_stepper.FastTables",
        "raytrace_tpu.ops.fast_stepper.fits_fast",
        "raytrace_tpu.ops.fast_stepper.is_uniform",
        "raytrace_tpu.ops.fast_stepper.pack_fast_tables",
        "raytrace_tpu.ops.fast_stepper.trace_batch_fast"),
    "The TPU kernels' tiles, table layouts and envelope": (
        "raytrace_tpu.ops.pallas_kernel.TILE",
        "raytrace_tpu.ops.pallas_kernel.TILE_LANES",
        "raytrace_tpu.ops.pallas_kernel.TILE_ROWS",
        "raytrace_tpu.ops.pallas_kernel.fits_pallas",
        "raytrace_tpu.ops.pallas_kernel.meta_key_of",
        "raytrace_tpu.ops.deposit_kernel.DEPOSIT_TILE",
        "raytrace_tpu.ops.deposit_kernel.split_bf16x3",
        "raytrace_tpu.ops.pallas_amplify.PackedGv",
        "raytrace_tpu.ops.pallas_amplify.pack_gv"),
    "`testing.probe_tpu` stays out": (
        "raytrace_tpu.testing.probe_tpu",),
    "The backward-seeded `calc_seed_batch` / `calc_seed_factor` path": (
        "raytrace_tpu.ops.seed.calc_seed_batch",
        "raytrace_tpu.ops.seed.calc_seed_factor",
        "raytrace_tpu.models.problem.prepare_seed"),
    "The dense deposit (`binning.bin_images_dense`)": (
        "raytrace_tpu.ops.binning.bin_images_dense",),
    "The upload-overlap split pipelines": (
        "raytrace_tpu.parallel.sharding.make_sharded_split_pipeline",),
    "`mesh.ray_sharding` and `mesh.replicated`": (
        "raytrace_tpu.parallel.mesh.ray_sharding",
        "raytrace_tpu.parallel.mesh.replicated"),
}

_NOT_PORTED_NAMES = {n for names in NOT_PORTED.values() for n in names}


def _port_has(target: str) -> bool:
    module, name = target.rsplit(".", 1)
    return hasattr(importlib.import_module(module), name)


@pytest.mark.parametrize("module", sorted(SURFACE))
def test_public_names_have_counterparts(module):
    """Each public name of the JAX module has its counterpart in the port,
    or stands in :data:`NOT_PORTED`."""
    missing = []
    for name in sorted(SURFACE[module]):
        full = f"{module}.{name}"
        if full in _NOT_PORTED_NAMES:
            continue
        target = RENAMED.get(full, "raytrace_tpu_torch" + full[
            len("raytrace_tpu"):])
        if not _port_has(target):
            missing.append(f"{full} -> {target}")
    assert not missing, f"no counterpart in the port: {missing}"


def _roadmap_not_ported() -> str:
    text = (ROOT / "ROADMAP.md").read_text()
    start = text.index("**Not ported on purpose.**")
    end = text.index("### Queue B", start)
    return " ".join(text[start:end].split())


def test_not_ported_table_is_current():
    """Every entry of the tables names a public JAX name, no name is both
    renamed and not ported, and each reason is a bullet of ROADMAP.md's
    "Not ported on purpose" list."""
    public = {f"{m}.{n}" for m, names in SURFACE.items() for n in names}
    assert not (set(RENAMED) | _NOT_PORTED_NAMES) - public
    assert not set(RENAMED) & _NOT_PORTED_NAMES
    section = _roadmap_not_ported()
    absent = [r for r in NOT_PORTED if f"* {r}" not in section]
    assert not absent, f"reasons not in ROADMAP.md's list: {absent}"


#: ``raytrace_tpu``'s entry points: their module and the port's function
ENTRY_POINTS = {
    "create_image": ("raytrace_tpu.models.ray_tracer",
                     ray_tracer.create_image),
    "create_image_stream": ("raytrace_tpu.models.ray_tracer",
                            ray_tracer.create_image_stream),
    "prepare_pipeline": ("raytrace_tpu.models.ray_tracer",
                         ray_tracer.prepare_pipeline),
    "create_image_sharded": ("raytrace_tpu.parallel.sharding",
                             sharding.create_image_sharded),
    "prepare_sharded": ("raytrace_tpu.parallel.sharding",
                        sharding.prepare_sharded),
    "resolve_method": ("raytrace_tpu.models.ray_tracer",
                       ray_tracer.resolve_method),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_positional_order(name):
    """The JAX function's positional parameters are the first of the
    port's, in its order."""
    module, fn = ENTRY_POINTS[name]
    node, = [n for n in _tree(module).body
             if isinstance(n, ast.FunctionDef) and n.name == name]
    want = [a.arg for a in node.args.posonlyargs + node.args.args]
    got = [p.name for p in inspect.signature(fn).parameters.values()
           if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    assert got[:len(want)] == want


def _jax_method_names() -> list:
    """The keys of ``raytrace_tpu``'s ``_METHOD_ALIASES`` and
    ``BACKENDS`` (``BACKENDS["name"] = ...``), read from its source."""
    names = set()
    for n in _tree("raytrace_tpu.models.ray_tracer").body:
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name) and t.id == "_METHOD_ALIASES":
                    names |= {ast.literal_eval(k) for k in n.value.keys}
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "BACKENDS"):
                    names.add(ast.literal_eval(t.slice))
    return sorted(names)


JAX_METHODS = _jax_method_names()
#: the reference's CPU-class names: they run on the CPU, card or no card
CPU_CLASS = ("cpu", "threads", "openmp", "kokkos-serial", "kokkos-openmp",
             "kokkos-thread")


def test_jax_method_names_are_read():
    assert {"lax", "lax-exact", "pallas", "cuda", "cpu", "openacc"} <= set(
        JAX_METHODS)
    assert set(CPU_CLASS) == ray_tracer._CPU_NAMES


@pytest.mark.parametrize("name", JAX_METHODS)
def test_jax_method_names(name):
    """Every method name of ``raytrace_tpu`` resolves: on a host without a
    card each runs the twins on the CPU and ``resolve_method`` names it;
    the kernels' names raise on an explicit CPU device; a call runs."""
    p = synthetic_problem(**SMALL)
    assert isinstance(ray_tracer.resolve_method(p, name), str)
    if torch.cuda.is_available():
        pytest.skip("the rule without a card; the card's is "
                    "test_route_on_a_card_host")
    assert ray_tracer.resolve_method(p, name) == "cpu"
    assert ray_tracer._route(name) == ("cpu", torch.device("cpu"))
    if ray_tracer._METHOD_ALIASES.get(name, name) == "cuda":
        with pytest.raises(RayTraceError, match="needs a CUDA device"):
            ray_tracer.resolve_method(p, name, device="cpu")
    else:
        assert ray_tracer.resolve_method(p, name, device="cpu") == "cpu"
    img, _ = create_image(p, name)
    assert np.isfinite(img).all()


@pytest.mark.parametrize("name", JAX_METHODS)
def test_route_on_a_card_host(monkeypatch, name):
    """With a card visible, the CPU-class names stay on the CPU and every
    other name runs on the card: the kernels' names the kernels, ``lax``,
    ``lax-exact`` and ``openacc`` the twins. Nothing is launched: only the
    routing is asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    p = synthetic_problem(**SMALL)
    kernels = ray_tracer._METHOD_ALIASES.get(name, name) == "cuda"
    method = "cuda" if kernels else "cpu"
    device = "cpu" if name in CPU_CLASS else "cuda"
    assert ray_tracer._route(name) == (method, torch.device(device))
    assert ray_tracer.resolve_method(p, name) == method
    # an explicit device still wins
    assert ray_tracer._route(name, "cuda:1")[1] == torch.device("cuda:1")
    if not kernels:
        assert ray_tracer._route(name, "cpu") == ("cpu", torch.device("cpu"))


def test_route_auto():
    """``auto`` follows an explicit device; without one it is the card's
    kernels, the CPU's twins without a card."""
    assert ray_tracer._route("auto", "cpu") == ("cpu", torch.device("cpu"))
    assert ray_tracer._route("auto", "cuda") == ("cuda",
                                                 torch.device("cuda"))
    if not torch.cuda.is_available():
        assert ray_tracer._route("auto") == ("cpu", torch.device("cpu"))


@pytest.mark.parametrize("name", ["lax", "lax-exact", "openacc", "threads",
                                  "pallas"])
def test_sharded_names_resolve_as_a_call(name):
    """A mesh's entries name their devices: a name resolves on them as a
    call with that device does; the kernels' names raise on a CPU mesh."""
    p = synthetic_problem(**SMALL)
    mesh = ("cpu", "cpu")
    if ray_tracer._METHOD_ALIASES[name] == "cuda":
        with pytest.raises(RayTraceError, match="needs a CUDA device"):
            sharding.prepare_sharded(p, mesh, name)
        return
    prep = sharding.prepare_sharded(p, mesh, name)
    assert prep.method == "cpu"
    assert all(e["device"] == torch.device("cpu")
               for e in prep.cfg["entries"])
    img, ang = sharding.create_image_sharded(p, mesh, name)
    img1, ang1 = create_image(p, name)
    assert np.linalg.norm(img - img1) <= 1e-12 * np.linalg.norm(img1)
    assert np.linalg.norm(ang - ang1) <= 1e-12 * np.linalg.norm(ang1)


def test_lax_stream_runs_from_python():
    """``lax`` through ``create_image_stream`` at depth 2: the calls are
    the twins' chunk loops (no graph), each yield the synchronous call's."""
    units = [synthetic_problem(seeded=s, **SMALL) for s in (False, True,
                                                            False)]
    want = [create_image(p, "lax") for p in units]
    got = list(create_image_stream(units, "lax", depth=2))
    assert len(got) == 3
    for (img, ang), (wi, wa) in zip(got, want):
        assert np.array_equal(img, wi) and np.array_equal(ang, wa)
    pipe = ray_tracer.prepare_pipeline(units[0], "lax").pipeline
    assert isinstance(pipe, ray_tracer._EagerPipeline)


def test_cli_labels_rows_with_resolve_method(capsys):
    """The CLI names each row by what runs, as ``raytrace_tpu``'s does:
    ``lax`` runs the twins (``lax->cpu``; on the CPU here)."""
    assert cli.main(["-methods=lax,cpu", "-iterations=1", FIXTURE]) == 0
    out = capsys.readouterr().out
    assert "Running lax->cpu on cpu" in out
    rows = [line.split()[0] for line in out.splitlines()
            if re.match(r"\s+\S+\s+[0-9.]+\s+[0-9.]+", line)]
    assert rows == ["lax->cpu", "cpu"]
    assert "All tests passed" in out
