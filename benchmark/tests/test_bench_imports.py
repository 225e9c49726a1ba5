"""Nothing that a run reaches imports JAX, the JAX package or the repo's
old JAX benchmarks; the plain reference imports nothing of the program.
Names are compared whole, by the part before the first dot."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "routeformer_tpu", "bench", "tools"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(root: Path):
    return [p for p in root.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_no_run_module_imports_jax_or_the_jax_package():
    sources = _sources(BENCH)
    assert len(sources) > 10
    for path in sources:
        assert not _imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "routeformer_torch" not in _imports(path), path
        assert not _imports(path) & FORBIDDEN, path


def test_the_guard_compares_whole_names():
    assert "routeformer_torch" not in FORBIDDEN  # the port's name begins with the JAX package's
    assert "benchmark" not in FORBIDDEN
