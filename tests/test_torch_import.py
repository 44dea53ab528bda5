"""repro_torch stands alone: importing it loads neither JAX nor any module of
the JAX package, and no source file of the port or ``chip_smoke.py`` imports
them."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
PORT_MODULES = sorted(
    "repro_torch" + "".join(f".{p}" for p in path.relative_to(PORT)
                            .with_suffix("").parts if p != "__init__")
    for path in PORT.rglob("*.py"))
FORBIDDEN = ("jax", "repro")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("first", ["repro_torch", "repro_torch.kernels.ops",
                                   "repro_torch.delivery.client",
                                   "repro_torch.core.store"])
def test_import_loads_no_jax_and_no_repro(first):
    """Import ``first`` alone (each import order must resolve), then every
    submodule, in a fresh interpreter."""
    code = (f"import importlib, sys\n"
            f"importlib.import_module({first!r})\n"
            f"for m in {PORT_MODULES!r}:\n"
            f"    importlib.import_module(m)\n"
            f"print('\\n'.join(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    loaded = out.split()
    assert "repro_torch.delivery.client" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_no_source_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = [f"{path.relative_to(REPO)}:{line}: {module}"
           for path in files for line, module in _imports(path)
           if _forbidden(module)]
    assert bad == []
