# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The PyTorch port imports neither JAX nor anything of the JAX package.

Two checks: importing every module of ``torchmetrics_tpu_torch`` in a fresh
interpreter leaves no ``jax*`` and no ``torchmetrics_tpu``/``torchmetrics_tpu.*``
module loaded (a subprocess, because this test process has JAX loaded by
``tests/conftest.py``), and an AST scan of every source file of the port and
of ``chip_smoke.py`` finds no such import. A third scan finds no path into
the JAX package in those files (a ``"torchmetrics_tpu" / ...`` join, a
``torchmetrics_tpu/native`` string): the port reads none of its files.
"""
import ast
import json
import os
import re
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
    sorted(PORT.rglob("*.py"))
    + [ROOT / name for name in ("chip_smoke.py", "chip_turns.py", "chip_variants.py", "chip_k5_variants.py", "chip_k6_variants.py")],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_source_imports_no_jax(path):
    bad = [name for name in _imports(path) if _is_forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


#: a path component ``torchmetrics_tpu`` followed by more path: a file or folder of the JAX package
_JAX_PATH = re.compile(r"(^|[/\\])torchmetrics_tpu[/\\]")
#: a ``file:line`` label naming the JAX function a kernel replaces (chip_smoke.py's kernels line): not read
_FILE_LINE = re.compile(r"torchmetrics_tpu/[\w/.]+\.py:\d+")
_PATH_CALLS = {"join", "joinpath", "Path", "PurePath", "open", "read_text", "read_bytes"}


def _jax_path_reaches(source: str):
    """Places in ``source`` that name a path into the JAX package: a string
    holding one (docstrings and ``file:line`` labels aside), a ``/`` join
    or a path call with a ``"torchmetrics_tpu"`` part."""
    tree = ast.parse(source)
    docs = {
        id(node.body[0].value)
        for node in ast.walk(tree)
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
        and node.body and isinstance(node.body[0], ast.Expr) and isinstance(node.body[0].value, ast.Constant)
    }

    def jax_part(node):
        return isinstance(node, ast.Constant) and isinstance(node.value, str) and (
            node.value.strip("/\\") == "torchmetrics_tpu" or node.value.startswith(("torchmetrics_tpu/", "torchmetrics_tpu\\"))
        )

    hits = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
            for word in re.split(r"[\s'\"`,;()]+", node.value):
                if _JAX_PATH.search(word) and not _FILE_LINE.fullmatch(word):
                    hits.append((node.lineno, word))
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div) and (jax_part(node.left) or jax_part(node.right)):
            hits.append((node.lineno, "/ 'torchmetrics_tpu'"))
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in _PATH_CALLS:
            if any(jax_part(arg) for arg in node.args):
                hits.append((node.lineno, "a path call with 'torchmetrics_tpu'"))
    return hits


@pytest.mark.parametrize("snippet,bad", [
    ('p = Path(__file__).parent.parent / "torchmetrics_tpu" / "native" / "rle_codec.cpp"', True),
    ('p = os.path.join(root, "torchmetrics_tpu", "native", "rle_codec.cpp")', True),
    ('src = "torchmetrics_tpu/native/rle_codec.cpp"', True),
    ('src = ROOT.joinpath("torchmetrics_tpu/native")', True),
    ('row = {"replaces": "torchmetrics_tpu/functional/detection/map.py:92"}', False),
    ('def f():\n    """Counterpart of ``torchmetrics_tpu/functional/detection/map.py``."""', False),
    ('p = os.path.join(root, "torchmetrics_tpu_torch", "native")', False),
    ('cache = "~/.torchmetrics_tpu/DNSMOS"', False),
    ('w = os.path.join(os.path.dirname(__file__), "..", "..", "torchmetrics_tpu", "image", "weights")', True),
    ('w = ROOT / "torchmetrics_tpu/image/weights/lpips_heads_alex.npz"', True),
    ('w = os.path.join(os.path.dirname(__file__), "weights")', False),
], ids=["pathlib", "os-join", "string", "joinpath", "label", "docstring", "port-path", "home-cache", "jax-weights-join",
        "jax-weights-string", "port-weights"])
def test_jax_path_check_fires_on_reaches_only(snippet, bad):
    assert bool(_jax_path_reaches(snippet)) == bad


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py"))
    + [ROOT / name for name in ("chip_smoke.py", "chip_turns.py", "chip_variants.py", "chip_k5_variants.py", "chip_k6_variants.py")],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_source_names_no_path_into_the_jax_package(path):
    """The port reads no file of the JAX package, not even by path (its RLE
    codec is its own copy of the C++ source)."""
    hits = _jax_path_reaches(path.read_text())
    assert not hits, f"{path.relative_to(ROOT)} names paths into the JAX package: {hits}"


def test_chip_smoke_and_the_port_import_no_matplotlib_at_top_level():
    """The card's machine has no matplotlib: ``chip_smoke.py`` never imports
    it, and the port imports it only inside a plot call."""
    assert not [n for n in _imports(ROOT / "chip_smoke.py") if n.split(".")[0] == "matplotlib"]
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        top = [a.name for node in tree.body if isinstance(node, ast.Import) for a in node.names]
        top += [node.module for node in tree.body if isinstance(node, ast.ImportFrom) and node.module]
        assert not [n for n in top if n.split(".")[0] == "matplotlib"], path


# ------------------------------------------------- robustness: exports, store format

#: StateGuard's names (ROADMAP A11), among JAX's robustness exports since the port has the guard
STATEGUARD_NAMES = {
    "ArgSpec",
    "DomainContract",
    "GUARD_POLICIES",
    "GUARD_STATES",
    "GuardVerdict",
    "check_batch",
    "enable_guard",
    "guard_counters",
    "guard_ineligibility",
    "guarded_policy",
    "state_finiteness",
}


def test_robustness_exports_equal_jax_but_stateguard():
    """The name is kept from when StateGuard was the gap: the exports are now equal."""
    import torchmetrics_tpu.robustness as JR
    import torchmetrics_tpu_torch.robustness as TR

    assert STATEGUARD_NAMES <= set(TR.__all__)
    assert sorted(TR.__all__) == sorted(JR.__all__)
    for name in TR.__all__:
        assert hasattr(TR, name), name
    assert TR.validate_state_tree is not None  # importable, as in JAX, though not in __all__


@pytest.mark.parametrize("package", ["segmentation", "functional.segmentation", "functional.pairwise", "nominal",
                                     "functional.nominal", "retrieval", "functional.retrieval", "serve.chaos",
                                     "clustering", "functional.clustering", "audio", "functional.audio",
                                     "utilities.imports", "detection", "functional.detection", "native",
                                     "ops.coco_match", "image", "functional.image", "image.backbones.inception",
                                     "image.lpip", "image.perceptual_path_length", "ops.window_moments",
                                     "multimodal", "functional.multimodal", "multimodal.weights", "_examples",
                                     "_examples_generated"])
def test_the_new_domains_and_the_chaos_harness_are_scanned(package):
    """The domains of A14 ported so far and the chaos harness are among the
    modules the two checks above import and scan."""
    assert f"torchmetrics_tpu_torch.{package}" in _port_modules()


def test_chaos_harness_imports_only_the_standard_library():
    """``serve/chaos.py`` runs as a file path with neither torch nor either
    package importable (its tests poison them): the standard library alone."""
    import sys as _sys

    names = {name.split(".")[0] for name in _imports(PORT / "serve" / "chaos.py")}
    assert names <= set(_sys.stdlib_module_names) | {"__future__"}, names - set(_sys.stdlib_module_names)


def test_store_format_copy_imports_only_the_standard_library():
    path = PORT / "robustness" / "store_format.py"
    names = {name.split(".")[0] for name in _imports(path)}
    assert names <= {"__future__", "json", "os", "tempfile", "zlib", "typing"}, names


def _public(module):
    return sorted(n for n in vars(module) if not n.startswith("_"))


def test_store_format_copy_behaves_as_jax_on_one_store(tmp_path):
    """The same saves give the same snapshot and manifest bytes through
    either package's ``CheckpointStore``; on one damaged store both
    ``verify_store`` reports are equal, and so are ``prune_entries``'s."""
    import numpy as np

    import torchmetrics_tpu.robustness.store_format as jfmt
    import torchmetrics_tpu_torch.robustness.store_format as tfmt
    from torchmetrics_tpu.robustness import CheckpointStore as JStore
    from torchmetrics_tpu_torch.robustness import CheckpointStore as TStore

    assert _public(tfmt) == _public(jfmt)
    for name in ("MANIFEST_NAME", "SNAPSHOT_PREFIX", "SNAPSHOT_SUFFIX", "STORE_FORMAT_VERSION", "_MANIFEST_KEYS", "_ENTRY_KEYS"):
        assert getattr(tfmt, name) == getattr(jfmt, name), name
    assert tfmt.snapshot_filename(42) == jfmt.snapshot_filename(42)
    assert tfmt.payload_crc(b"abc") == jfmt.payload_crc(b"abc")
    assert tfmt.empty_manifest("f") == jfmt.empty_manifest("f")

    dirs = {}
    for tag, store_cls in (("jax", JStore), ("port", TStore)):
        store = store_cls(str(tmp_path / tag), keep_last=3, fingerprint="0123456789abcdef")
        for step in (2, 4, 6, 8):
            store.save({"cursor": step, "blob": np.arange(step, dtype=np.int32)}, step=step)
        dirs[tag] = Path(store.directory)
    assert sorted(os.listdir(dirs["jax"])) == sorted(os.listdir(dirs["port"]))
    for name in os.listdir(dirs["jax"]):
        assert (dirs["jax"] / name).read_bytes() == (dirs["port"] / name).read_bytes(), name

    # damage one store three ways, then both modules report alike
    damaged = dirs["port"]
    (damaged / tfmt.snapshot_filename(8)).write_bytes(b"rot")
    (damaged / tfmt.snapshot_filename(6)).unlink()
    (damaged / (tfmt.snapshot_filename(10) + ".tmp-torn")).write_bytes(b"x")
    report = tfmt.verify_store(str(damaged))
    assert report == jfmt.verify_store(str(damaged))
    assert not report["ok"] and len(report["problems"]) == 2 and report["torn_temp_files"]
    manifest = tfmt.read_manifest(str(damaged))
    assert manifest == jfmt.read_manifest(str(damaged))
    (damaged / "manifest.json").write_text("{")
    bad_t, bad_j = tfmt.verify_store(str(damaged)), jfmt.verify_store(str(damaged))
    assert bad_t == bad_j and not bad_t["manifest_ok"]

    import shutil

    kept = {}
    for tag, mod in (("jax", jfmt), ("port", tfmt)):
        directory = str(tmp_path / f"prune_{tag}")
        shutil.copytree(dirs["jax"], directory)
        kept[tag] = mod.prune_entries(directory, mod.read_manifest(directory), 1)
        assert sorted(os.listdir(directory)) == [tfmt.MANIFEST_NAME, tfmt.snapshot_filename(8)]
    assert kept["jax"] == kept["port"]


@pytest.mark.parametrize("rel", ["sketch", "drift", "ops/cm_track.py"])
def test_sketch_drift_and_k3_import_no_jax(rel):
    """The sketch and drift subpackages and K3's wrapper name no JAX module
    and nothing of ``torchmetrics_tpu`` (the AST scan, file by file)."""
    path = PORT / rel
    files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
    assert files
    for f in files:
        bad = [name for name in _imports(f) if _is_forbidden(name)]
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


#: names of the JAX package's ``__all__`` whose wait is documented (none left)
_WAITING: dict = {}


@pytest.mark.parametrize("sub", ["sketch", "drift", "utilities", "parallel", "obs", "clustering", "functional.clustering",
                                 "audio", "functional.audio", "detection", "functional.detection", "image",
                                 "functional.image", "multimodal", "functional.multimodal"])
def test_subpackage_exports_equal_jax(sub):
    import importlib

    jmod = importlib.import_module(f"torchmetrics_tpu.{sub}")
    tmod = importlib.import_module(f"torchmetrics_tpu_torch.{sub}")
    assert sorted(tmod.__all__) == sorted(set(jmod.__all__) - _WAITING.get(sub, set()))
    for name in tmod.__all__:
        assert hasattr(tmod, name), name


def test_imports_copy_is_the_standard_library_and_jax_s_flags():
    """``utilities/imports.py``: the port's own copy (stdlib only), each of
    its flags probing the module JAX's flag of the same name probes."""
    import sys as _sys

    import torchmetrics_tpu.utilities.imports as JI
    import torchmetrics_tpu_torch.utilities.imports as TI

    names = {name.split(".")[0] for name in _imports(PORT / "utilities" / "imports.py")}
    assert names <= set(_sys.stdlib_module_names) | {"__future__"}, names
    flags = sorted(n for n in vars(TI) if n.endswith("_AVAILABLE"))
    assert flags and all(getattr(TI, n).module == getattr(JI, n).module for n in flags)


@pytest.mark.parametrize(
    "path",
    sorted(p for p in (PORT / "obs").glob("*.py") if p.name != "device.py"),
    ids=lambda p: p.name,
)
def test_obs_host_modules_import_neither_torch_nor_jax(path):
    """The obs host modules stay loadable by path, as JAX's are by
    ``tools/metricscope.py``: only the standard library, at any level (the
    package-relative imports stay inside ``obs/``). ``device.py`` builds
    torch programs and is not imported by ``obs/__init__.py``."""
    names = {name.split(".")[0] for name in _imports(path)}
    assert not names & {"torch", "jax", "jaxlib", "numpy", "torchmetrics_tpu", "torchmetrics_tpu_torch"}, names
    if path.name == "__init__.py":
        tree = ast.parse(path.read_text())
        imported = {a.name for node in ast.walk(tree) if isinstance(node, ast.ImportFrom) for a in node.names}
        assert "device" not in imported


def test_obs_package_loads_by_path_without_torch():
    """The port's obs package loaded by path, as metricscope loads JAX's, in a
    fresh interpreter: no torch, no jax module gets imported."""
    code = (
        "import importlib.util, json, sys\n"
        f"pkg = {str(PORT / 'obs')!r}\n"
        "spec = importlib.util.spec_from_file_location('port_obs', pkg + '/__init__.py', submodule_search_locations=[pkg])\n"
        "mod = importlib.util.module_from_spec(spec); sys.modules['port_obs'] = mod; spec.loader.exec_module(mod)\n"
        "print(json.dumps([sorted(mod.__all__), sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax'))]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120, check=True)
    names, heavy = json.loads(out.stdout.strip().splitlines()[-1])
    assert heavy == [] and "read_jsonl" in names
