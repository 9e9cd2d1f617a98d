"""The PyTorch port stands alone: every module of ``repro_torch`` imports
with JAX unavailable, and no file of the port (nor ``chip_smoke.py``)
imports ``jax`` or anything of the JAX package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _module_names():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_port_module_imports_without_jax():
    mods = list(_module_names())
    assert len(mods) > 30, mods
    code = ("import sys\nsys.modules['jax'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "assert not any(k == 'repro' or k.startswith('repro.') "
            "for k in sys.modules), 'the JAX package was imported'\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_file_imports_no_jax_and_no_reference(path):
    bad = sorted({r for r in _imported_roots(path)
                  if r in ("jax", "jaxlib", "repro")})
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"
