# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The PyTorch port imports neither JAX nor anything of the JAX package.

Two checks: importing every module of ``torchmetrics_tpu_torch`` in a fresh
interpreter leaves no ``jax*`` and no ``torchmetrics_tpu``/``torchmetrics_tpu.*``
module loaded (a subprocess, because this test process has JAX loaded by
``tests/conftest.py``), and an AST scan of every source file of the port and
of ``chip_smoke.py`` finds no such import.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "torchmetrics_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _is_forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top.startswith("jax") or top == "jaxlib" or top == "torchmetrics_tpu"


@pytest.mark.parametrize("name", ["jax", "jaxlib", "jax.numpy", "torchmetrics_tpu", "torchmetrics_tpu.metric"])
def test_forbidden_names_are_recognised(name):
    assert _is_forbidden(name)


@pytest.mark.parametrize("name", ["torchmetrics_tpu_torch", "torchmetrics_tpu_torch.metric", "torch", "numpy"])
def test_port_names_are_not_forbidden(name):
    # the port's own name starts with the string "torchmetrics_tpu"
    assert not _is_forbidden(name)


def test_importing_the_port_loads_no_jax_module():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300, check=True
    )
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "torchmetrics_tpu_torch" in loaded
    bad = [m for m in loaded if _is_forbidden(m)]
    assert not bad, f"importing the port loaded {bad}"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module",
            "__import__",
        ):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_source_imports_no_jax(path):
    bad = [name for name in _imports(path) if _is_forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_chip_smoke_and_the_port_import_no_matplotlib_at_top_level():
    """The card's machine has no matplotlib: ``chip_smoke.py`` never imports
    it, and the port imports it only inside a plot call."""
    assert not [n for n in _imports(ROOT / "chip_smoke.py") if n.split(".")[0] == "matplotlib"]
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        top = [a.name for node in tree.body if isinstance(node, ast.Import) for a in node.names]
        top += [node.module for node in tree.body if isinstance(node, ast.ImportFrom) and node.module]
        assert not [n for n in top if n.split(".")[0] == "matplotlib"], path
