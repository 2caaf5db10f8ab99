"""Nothing under portbench/ imports jax, jaxlib, flax or the JAX package
`repro`, and the reference imports nothing of the program.  Names are
compared by their whole top-level part (before the first dot), so
`repro_torch` is not `repro`."""

import ast
from pathlib import Path

from portbench import harness

HERE = Path(__file__).resolve().parent.parent
JAX = {"jax", "jaxlib", "flax", "repro"}


def top(name: str) -> str:
    return name.split(".")[0]


def imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {top(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(top(node.module))
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(top(node.args[0].value))
    return names


def test_top_level_names_are_compared_whole():
    assert top("repro_torch.models.lm") == "repro_torch"
    assert top("repro_torch.models.lm") not in JAX
    assert top("repro.models.lm") in JAX
    assert harness.FORBIDDEN == tuple(sorted(JAX, key=list(
        harness.FORBIDDEN).index))


def test_nothing_under_portbench_imports_jax_or_repro():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f): imported(f) & JAX for f in files if imported(f) & JAX}
    assert not bad


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((HERE / "reference").rglob("*.py"))
    assert files
    bad = {str(f): imported(f) for f in files
           if "repro_torch" in imported(f)}
    assert not bad


def test_the_walk_sees_imports():
    assert "repro_torch" in imported(HERE / "program.py") | imported(
        HERE / "kinds" / "train.py")
    assert "torch" in imported(HERE / "reference" / "model.py")


def test_a_run_checks_the_loaded_modules(monkeypatch):
    import sys
    import types
    assert "repro_torch" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.models", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["repro"]
