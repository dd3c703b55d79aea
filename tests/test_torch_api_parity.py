"""The port's public surface against the JAX package's, read with ``ast``:
neither package is imported.

For every module of ``libpointmatcher_tpu/``, each public top-level name
(a function, class or assignment; in a package's ``__init__.py`` also what
it imports), each ``__all__`` entry and each public method of a class must
exist in the port's counterpart module (for a method: on the class of the
same name there, or on one of its bases in the port), or stand in
``EXCLUDED`` with the ROADMAP Queue 3 item that records why it is not
ported. A second test holds the ``PMTPU_*`` switches the JAX package reads
to the port's, or to ``SWITCHES_EXCLUDED`` and its Queue 3 items.
"""

from __future__ import annotations

import ast
import functools
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX = REPO / "libpointmatcher_tpu"
PORT = REPO / "libpointmatcher_tpu_torch"

#: JAX modules whose counterparts carry other names: the Pallas kernel
#: modules, ported as the CUDA wrappers beside the port's host tables
#: (``ops/morton.py`` holds the Morton orders, ``ops/sweep.py`` the
#: survivor route's constants), and the Jacobi eigensolver (Queue 3 #40)
COUNTERPARTS = {
    "ops/knn_pallas.py": ("ops/knn_cuda.py",),
    "ops/knn_skip.py": ("ops/skip_cuda.py", "ops/skip.py", "ops/sweep.py",
                        "ops/morton.py"),
    "ops/knn_sweep2.py": ("ops/sweep_cuda.py", "ops/sweep.py"),
    "utils/smalleig.py": (),
}

#: names deliberately not ported: "module::name" or "module::Class.method"
#: → the ROADMAP Queue 3 item that records it
EXCLUDED = {
    # the JAX package's tracing machinery (#44): the port runs eagerly
    "cloud.py::PointCloud.tree_flatten": "#44",
    "cloud.py::PointCloud.tree_unflatten": "#44",
    "cloud.py::PointCloud.compact_traced": "#44",
    "filters/base.py::apply_filter_chain_traced": "#44",
    "filters/base.py::DataPointsFilter.filter_traced": "#44",
    "filters/base.py::DataPointsFilter.prepare_host": "#44",
    "filters/base.py::DataPointsFilter.survivor_bound": "#44",
    "filters/normals.py::SamplingSurfaceNormalDataPointsFilter.filter_traced": "#44",
    "filters/normals.py::SamplingSurfaceNormalDataPointsFilter.prepare_host": "#44",
    "filters/normals.py::SamplingSurfaceNormalDataPointsFilter.survivor_bound": "#44",
    "icp.py::ICP.make_loop_runner": "#44",
    "ops/dispatch.py::use_pallas": "#44",
    # the Pallas wrappers, ported under their kernels' names (#45)
    "ops/knn_pallas.py::knn1_pallas": "#45",
    "ops/knn_pallas.py::knn1_pallas_mxu": "#45",
    "ops/knn_pallas.py::knnk_pallas": "#45",
    # the fused Jacobi eigensolver: the port solves with torch.linalg.eigh
    "utils/smalleig.py::eigh_jacobi": "#40",
    "utils/smalleig.py::eigh_sorted": "#40",
    "utils/smalleig.py::eigh3_sorted": "#40",
}


@functools.lru_cache(maxsize=None)
def _surface(path: Path):
    """→ (public top-level names, ``__all__`` entries, {class: (public
    methods, base names)})."""
    tree = ast.parse(path.read_text())
    package = path.name == "__init__.py"
    names, exported, classes = set(), set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            methods = {m.name for m in node.body
                       if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                       and not m.name.startswith("_")}
            bases = {b.id if isinstance(b, ast.Name) else b.attr
                     for b in node.bases if isinstance(b, (ast.Name, ast.Attribute))}
            classes[node.name] = (methods, bases)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                    if t.id == "__all__":
                        exported |= {e.value for e in node.value.elts}
        elif package and isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in names if not n.startswith("_")}, exported, classes


@functools.lru_cache(maxsize=None)
def _port_classes():
    """Every class of the port → (public methods, base names), merged
    over modules."""
    out = {}
    for path in PORT.rglob("*.py"):
        for name, (methods, bases) in _surface(path)[2].items():
            m, b = out.setdefault(name, (set(), set()))
            m |= methods
            b |= bases
    return out


def _methods(classes, name, seen=()):
    """Public methods of the port's class ``name``, its bases' included."""
    if name not in classes or name in seen:
        return set()
    methods, bases = classes[name]
    out = set(methods)
    for b in bases:
        out |= _methods(classes, b, seen + (name,))
    return out


def _jax_modules():
    return sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def _missing(rel: str):
    """The JAX module's public names that its port counterpart lacks."""
    names, exported, classes = _surface(JAX / rel)
    port_names, port_classes = set(), _port_classes()
    for other in COUNTERPARTS.get(rel, (rel,)):
        assert (PORT / other).exists(), f"no port module {other} for {rel}"
        got, got_all, _ = _surface(PORT / other)
        port_names |= got | got_all
    out = [f"{rel}::{n}" for n in sorted(names | exported) if n not in port_names]
    for cls, (methods, _) in sorted(classes.items()):
        if cls.startswith("_") or cls not in port_names:
            continue
        have = _methods(port_classes, cls)
        out += [f"{rel}::{cls}.{m}" for m in sorted(methods - have)]
    return out


@pytest.mark.parametrize("rel", _jax_modules())
def test_public_names_have_counterparts(rel):
    missing = [m for m in _missing(rel) if m not in EXCLUDED]
    assert not missing, f"the port lacks {missing}"


def test_exclusions_are_needed_and_recorded():
    """Every exclusion names a name the port really lacks and a Queue 3
    item that ROADMAP.md holds."""
    lacking = {m for rel in _jax_modules() for m in _missing(rel)}
    roadmap = (REPO / "ROADMAP.md").read_text()
    queue3 = roadmap[roadmap.index("### Queue 3"):roadmap.index("## Recent")]
    for name, item in EXCLUDED.items():
        assert name in lacking, f"{name} is ported: drop its exclusion"
        number = item.lstrip("#")
        assert re.search(rf"^{number}\. \*\*", queue3, re.M), \
            f"{name}: Queue 3 has no item {item}"


def _switches(root: Path):
    pattern = re.compile(r"PMTPU_[A-Z0-9_]+")
    return {m for p in root.rglob("*.py") for m in pattern.findall(p.read_text())}


#: the JAX package's switches that the port does not read → the ROADMAP
#: Queue 3 item that records why (each with its test in
#: tests/test_torch_switches.py)
SWITCHES_EXCLUDED = {
    "PMTPU_STACK_NUMPY": "#49",
    "PMTPU_SOLVE": "#52",
    "PMTPU_SELECT": "#53",
}


def test_every_jax_switch_is_read_by_the_port():
    """Each ``PMTPU_*`` variable of the JAX package (its ``bench.py``'s
    ``PMTPU_BENCH_*`` aside) is read by the port through ``os.environ``, or
    stands in ``SWITCHES_EXCLUDED`` with a Queue 3 item that ROADMAP.md
    holds; an excluded switch is really not read."""
    jax_switches = {s for s in _switches(JAX) if not s.startswith("PMTPU_BENCH_")}
    assert jax_switches >= {"PMTPU_KNN_IMPL", "PMTPU_SOLVE", "PMTPU_SELECT",
                            "PMTPU_STACK_NUMPY", "PMTPU_CACHE_DIR"}
    read = re.compile(r"os\.environ(?:\.get\(|\[)\s*\"(PMTPU_[A-Z0-9_]+)\"")
    port_reads = {m for p in PORT.rglob("*.py") for m in read.findall(p.read_text())}
    missing = jax_switches - port_reads - set(SWITCHES_EXCLUDED)
    assert not missing, f"the port does not read {sorted(missing)}"
    roadmap = (REPO / "ROADMAP.md").read_text()
    queue3 = roadmap[roadmap.index("### Queue 3"):roadmap.index("## Recent")]
    for name, item in SWITCHES_EXCLUDED.items():
        assert name in jax_switches and name not in port_reads, name
        assert re.search(rf"^{item.lstrip('#')}\. \*\*.*{name}", queue3, re.M), \
            f"{name}: Queue 3 has no item {item} that names it"
