"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program.

Every import statement counts, those inside functions too, and the walk
follows the program's modules that the benchmark reaches.  Names are
compared by their top-level part as a whole word: ``repro_torch`` is the
program, ``repro`` the JAX package.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from conftest import ROOT

JAX = {"jax", "jaxlib", "flax", "repro"}
BENCH = ROOT / "bench"
SRC = ROOT / "src"


def _imports(path: Path, package: str) -> set[str]:
    """Absolute names of the modules `path` imports (``package`` resolves
    its relative imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = package.split(".")[: len(package.split(".")) - node.level + 1]
                base = ".".join(parts + ([base] if base else []))
            names.add(base)
            names.update(f"{base}.{a.name}" for a in node.names)
    return names


def _module_file(name: str) -> Path | None:
    for root in (ROOT, SRC):
        base = root.joinpath(*name.split("."))
        for cand in (base.with_suffix(".py"), base / "__init__.py"):
            if cand.is_file():
                return cand
    return None


def _package_of(path: Path) -> str:
    root = SRC if SRC in path.parents else ROOT
    rel = path.relative_to(root).with_suffix("")
    parts = list(rel.parts)
    return ".".join(parts[:-1] if parts[-1] != "__init__" else parts[:-1])


def _reached() -> dict[Path, set[str]]:
    """Every file of the benchmark and of the program modules it reaches,
    with the names each imports."""
    todo = sorted(BENCH.rglob("*.py"))
    seen: dict[Path, set[str]] = {}
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        names = _imports(path, _package_of(path))
        seen[path] = names
        for name in names:
            if name.split(".")[0] in ("bench", "repro_torch"):
                f = _module_file(name)
                if f is not None and f not in seen:
                    todo.append(f)
    return seen


def test_the_walk_reaches_the_program():
    files = _reached()
    assert SRC / "repro_torch" / "serving" / "engine.py" in files
    assert SRC / "repro_torch" / "kernels" / "ops.py" in files


def test_nothing_reached_imports_jax_or_the_jax_package():
    bad = {str(p.relative_to(ROOT)): sorted(n for n in names if n.split(".")[0] in JAX)
           for p, names in _reached().items()}
    assert {k: v for k, v in bad.items() if v} == {}


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path, _package_of(path))}
        assert not tops & (JAX | {"repro_torch"}), path
        assert "bench" not in tops or all(
            n.startswith("bench.reference") for n in _imports(path, _package_of(path))
            if n.split(".")[0] == "bench"), path


def test_a_run_loads_no_jax(small_root):
    """A whole run of a small cell on the CPU, in a fresh process."""
    code = (
        "import sys, time, torch; "
        f"sys.path[:0] = [{str(ROOT)!r}, {str(SRC)!r}]; "
        "from bench.cells import load_cell; from bench.harness import run_cell; "
        f"cell = load_cell({str(small_root)!r}, 'uhd_dynamic-mnist-d8192.classify'); "
        "out = run_cell(cell, 7, 0.3, False, torch.device('cpu'), time.monotonic()); "
        "assert out['correct'], out['checks']; "
        "print(sorted({m.split('.')[0] for m in sys.modules}))"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    loaded = set(ast.literal_eval(res.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and not loaded & JAX
