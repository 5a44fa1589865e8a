"""The port imports nothing of JAX and nothing of the reference package
``repro``: checked by importing every ``repro_torch`` module and
``chip_smoke.py`` in a fresh interpreter, and by an AST scan of their
sources, of the chip probes under ``probes/`` and of the examples' port
siblings (``examples/*_torch.py``)."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
SOURCES = (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
           + sorted((REPO / "probes").glob("*.py"))
           + sorted((REPO / "examples").glob("*_torch.py")))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _module_names():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = f"""
import importlib, importlib.util, json, sys
for name in {list(_module_names())!r}:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location(
    "chip_smoke", {str(REPO / "chip_smoke.py")!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted(sys.modules)))
"""
    proc = subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ,
                               "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "repro_torch.serve.server" in loaded
    assert not [m for m in loaded if _forbidden(m)]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_source_imports_no_jax_and_no_reference(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"
