"""What the benchmark imports and reads: no module under ``portbench/``
imports the JAX stack or the JAX package (top-level names compared whole:
the port's name begins with the JAX package's); the reference side imports
nothing of the port either; nothing reads the JAX package's benchmarks."""

import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "hyphy_tpu"}
REFERENCE_SIDE = [HERE / "reference.py", HERE / "synth.py", *sorted((HERE / "references").glob("*.py"))]


def _modules(path):
    """Every module an import statement of ``path`` names, in full."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
            names.update(f"{node.module}.{alias.name}" for alias in node.names)
    return names


def _imports(path):
    return {name.split(".")[0] for name in _modules(path)}


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not _imports(path) & BANNED


@pytest.mark.parametrize("path", REFERENCE_SIDE, ids=lambda p: str(p.relative_to(HERE)))
def test_reference_side_imports_no_program(path):
    assert "hyphy_tpu_torch" not in _imports(path)
    assert not {m for m in _modules(path)
                if m.startswith(("portbench.program", "portbench.stages"))}


def test_nothing_reads_the_jax_benchmarks():
    for path in SOURCES:
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "bench.py" not in text, path


def test_banned_modules_compares_whole_names(monkeypatch):
    import sys
    import types

    from portbench import harness

    monkeypatch.setitem(sys.modules, "hyphy_tpu_torch_like", types.ModuleType("x"))
    assert harness.banned_modules() == sorted(BANNED & {m.split(".")[0] for m in sys.modules})
    monkeypatch.setitem(sys.modules, "hyphy_tpu", types.ModuleType("hyphy_tpu"))
    assert "hyphy_tpu" in harness.banned_modules()
