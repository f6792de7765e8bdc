"""Nothing the benchmark imports is JAX or the JAX package, compared by
whole top-level names, and the reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "mapper_tpu"}


def imports(path: Path) -> set[str]:
    """Top-level names of the modules a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = [p for p in PORTBENCH.rglob("*.py") if "tests" not in p.relative_to(PORTBENCH).parts]
    assert files
    for path in files:
        assert not imports(path) & FORBIDDEN, path


def test_top_level_names_are_compared_whole():
    assert "mapper_tpu_torch" not in FORBIDDEN and "mapper_tpu" in FORBIDDEN


def _portbench_modules(path: Path) -> set[Path]:
    """`path` and every portbench module it imports, transitively."""
    seen, todo = set(), [path]
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("portbench"):
                parts = node.module.split(".")[1:]
                base = PORTBENCH.joinpath(*parts)
                for alias in node.names:
                    for cand in (base / f"{alias.name}.py", base.with_suffix(".py"), base / "__init__.py"):
                        if cand.exists():
                            todo.append(cand)
    return seen


def test_reference_imports_nothing_of_the_program():
    for path in (PORTBENCH / "reference").glob("*.py"):
        for module in _portbench_modules(path):
            assert "mapper_tpu_torch" not in imports(module), module
            assert not imports(module) & FORBIDDEN, module


def test_reference_loads_no_program_module():
    code = ("import sys; import portbench.reference.judge, portbench.control; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'mapper_tpu_torch', 'mapper_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=PORTBENCH.parent, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"
