"""The port stands alone: no module of ``repro_torch``, of
``benchmarks/port`` or ``examples/port`` and no line of
``chip_smoke.py`` (or of the card-only tests) imports ``jax`` or the
``repro`` package (not even its jax-free modules), importing the port
leaves neither in ``sys.modules``, and the entry points refuse to fall
back to the CPU."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py"] + \
    sorted((REPO / "benchmarks" / "port").glob("*.py")) + \
    sorted((REPO / "examples" / "port").glob("*.py"))
MODULES = sorted(
    ".".join(p.relative_to(REPO / "src").with_suffix("").parts)
    .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def _forbidden(name: str | None) -> bool:
    top = (name or "").split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_importing_every_module_loads_neither_jax_nor_repro():
    assert len(MODULES) > 20
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.core import make_index
    from repro_torch.device import resolve_device
    from repro_torch.serving import SpatialServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((4, 2), np.int32)
    for call in (lambda: make_index("spac-h", pts),
                 lambda: SpatialServer.build("spac-h", pts),
                 lambda: make_index("spac-h", pts, device="cuda")):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert len(make_index("spac-h", pts, device="cpu")) == 4
