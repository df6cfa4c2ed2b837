# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's dataflow rules (ML009-ML012) and the capture fixtures
(counterpart of ``tests/unittests/lint/test_dataflow_rules.py``).

The corpus (``tests/torch_lint_corpus/``) is linted with its own directory
as the lint root, so the ``serve/`` and ``obs/`` path gates apply. The
capture fixtures (``ml002_*``, ``ml011_*``) also run here on the CPU: under
``torch.func.vmap`` (the sliced plan's per-row transform, where a host read
raises as it does inside a capture) each flagged fixture raises and each
clean twin does not, and ``make_jit_update`` folds each clean twin as its
eager updates do. ``torch.bincount`` runs under ``vmap`` and an upload is no
host read there, so those two hold their verdict on the card only
(``chip_smoke.py``'s ``lint`` phase).
"""
import glob
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from torchmetrics_tpu_torch.lint import EXPLANATIONS, RULES, lint_paths
from torchmetrics_tpu_torch.lint.dataflow import is_stdlib_surface

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO_ROOT, "tests", "torch_lint_corpus")
CLI = os.path.join(REPO_ROOT, "torchmetrics_tpu_torch", "lint", "__main__.py")


@pytest.fixture(scope="module")
def corpus_violations():
    return lint_paths([CORPUS], root=CORPUS)


def _hits(violations, rel, rule=None):
    return [v for v in violations if v.path == rel and (rule is None or v.rule == rule)]


def test_restore_alias_fixture_names_both_installs(corpus_violations):
    hits = _hits(corpus_violations, "ml009_restore_alias.py")
    assert {v.scope for v in hits} == {"restore", "restore_attr"}
    assert any("_install_state_tree" in v.message for v in hits) and any("setattr" in v.message for v in hits)


def test_donate_fixture_names_the_donating_step(corpus_violations):
    (hit,) = _hits(corpus_violations, "ml009_donate_alias.py")
    assert "donate=True" in hit.message and "`step`" in hit.message


def test_ml011_anchors_in_the_callee_and_names_the_entry(corpus_violations):
    (hit,) = _hits(corpus_violations, "ml011_callee_item.py")
    assert hit.scope == "_normalize"
    assert "`Fixture.update`" in hit.message


def test_ml012_flags_both_blocking_ops(corpus_violations):
    hits = _hits(corpus_violations, "serve/ml012_sleep_under_lock.py")
    reasons = " | ".join(v.message for v in hits)
    assert len(hits) == 2 and "time.sleep" in reasons and "open" in reasons


def test_ml010_renders_the_import_chain(corpus_violations):
    (hit,) = _hits(corpus_violations, "ml010_reaches_jax.py")
    assert "ml010_jax_backend" in hit.message and "jax" in hit.message and hit.scope == "import-closure"
    (surface,) = _hits(corpus_violations, "obs/ml010_numpy_surface.py")
    assert "numpy" in surface.message and "stdlib-only" in surface.message


@pytest.mark.parametrize("rel", ["torchmetrics_tpu_torch/serve/chaos.py", "torchmetrics_tpu_torch/serve/wire.py",
                                 "torchmetrics_tpu_torch/robustness/store_format.py",
                                 "torchmetrics_tpu_torch/_reduction_names.py", "torchmetrics_tpu_torch/obs/trace.py",
                                 "torchmetrics_tpu_torch/obs/live.py", "torchmetrics_tpu_torch/lint/rules.py",
                                 "torchmetrics_tpu_torch/lint/__main__.py"])
def test_stdlib_surfaces_are_the_runtime_pinned_ones(rel):
    """The surfaces ``tests/test_torch_import_boundary.py`` pins at run time."""
    assert is_stdlib_surface(rel)


@pytest.mark.parametrize("rel", ["torchmetrics_tpu_torch/obs/device.py", "torchmetrics_tpu_torch/serve/daemon.py",
                                 "torchmetrics_tpu_torch/metric.py", "chip_smoke.py"])
def test_torch_modules_are_not_stdlib_surfaces(rel):
    assert not is_stdlib_surface(rel)


def test_ml010_follows_parent_package_inits(tmp_path):
    """An absolute import runs every parent ``__init__``: a stdlib-only
    surface that imports its own package by name reaches torch through it,
    while a relative import inside the package (a by-path load) does not."""
    pkg = tmp_path / "pkg"
    (pkg / "obs").mkdir(parents=True)
    (pkg / "__init__.py").write_text("import torch\n")
    (pkg / "obs" / "__init__.py").write_text("")
    (pkg / "obs" / "helpers.py").write_text("import json\n")
    (pkg / "obs" / "absolute.py").write_text("from pkg.obs import helpers\n")
    (pkg / "obs" / "relative.py").write_text("from . import helpers\n")
    (pkg / "obs" / "lazy.py").write_text("def f():\n    import numpy\n    return numpy\n")
    hits = {v.path: v.message for v in lint_paths([str(pkg)], root=str(tmp_path)) if v.rule == "ML010"}
    assert set(hits) == {"pkg/obs/absolute.py"}
    assert "pkg/__init__.py" in hits["pkg/obs/absolute.py"] and "torch" in hits["pkg/obs/absolute.py"]


_SEEDS = '''
import torch


def _read(v):
    return v.sum().item()


def _mapped(row):
    return row * _read(row)


def mapped(x):
    return torch.func.vmap(_mapped)(x)


def _recorded(v):
    return bool(v.any())


def _in_graph(v):
    return v.tolist()


class Plan:
    def _step(self, v):
        return int(v.max())

    def capture(self, x, graph):
        self._record(lambda: self._step(x))
        with torch.cuda.graph(graph):
            _in_graph(x)
        return self._record(_recorded)
'''


def test_ml011_seeds_from_vmap_record_and_graph_blocks(tmp_path):
    """Besides a fusable metric's update, the captured entries are what
    ``vmap`` maps, what ``_record`` records and what runs in a
    ``torch.cuda.graph`` block."""
    (tmp_path / "seeds.py").write_text(_SEEDS)
    hits = {v.scope for v in lint_paths([str(tmp_path)], root=str(tmp_path)) if v.rule == "ML011"}
    assert hits == {"_read", "_recorded", "_in_graph", "Plan._step"}


def test_explain_covers_every_rule():
    assert set(EXPLANATIONS) == set(RULES)
    out = subprocess.run([sys.executable, CLI, "explain", "ML009"], capture_output=True, text=True, cwd=REPO_ROOT, timeout=120)
    assert out.returncode == 0 and "torch.from_numpy" in out.stdout


def test_diff_mode_reports_only_changed_files():
    """``--diff`` lints only the changed set but keeps the graphs package-wide."""
    out = subprocess.run([sys.executable, CLI, "--diff", "HEAD", "--format", "json"],
                         capture_output=True, text=True, cwd=REPO_ROOT, timeout=300)
    if "no lintable files changed" in out.stdout:
        assert out.returncode == 0
        return
    assert out.returncode in (0, 1), out.stderr
    payload = json.loads(out.stdout)
    changed = subprocess.run(["git", "diff", "--name-only", "HEAD", "--"], capture_output=True, text=True,
                             cwd=REPO_ROOT).stdout.split()
    for violation in payload["new"]:
        assert violation["path"] in changed


def test_diff_mode_refuses_to_write_the_default_baseline():
    out = subprocess.run([sys.executable, CLI, "--diff", "HEAD", "--write-baseline"],
                         capture_output=True, text=True, cwd=REPO_ROOT, timeout=300)
    assert out.returncode == 2 or "no lintable files changed" in out.stdout


# ------------------------------------------------------- capture fixtures


def _fixtures():
    out = []
    for path in sorted(glob.glob(os.path.join(CORPUS, "ml0*.py"))):
        name = os.path.basename(path)[:-3]
        if name.startswith(("ml002_", "ml011_")):
            out.append(name)
    return out


def _load(name):
    spec = importlib.util.spec_from_file_location(f"torch_lint_fixture_{name}", os.path.join(CORPUS, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


#: the flagged fixtures whose fault is no host read under vmap: bincount
#: batches there, and an upload is only a copy; the card holds them
_CARD_ONLY = ("ml002_bincount", "ml002_upload")


def test_every_flagged_fixture_has_a_capturing_twin():
    names = _fixtures()
    flagged = [n for n in names if not _load(n).CAPTURES]
    assert len(flagged) == 7
    for name in flagged:
        twin = name.replace("_callee_item", "") + "_clean"
        assert twin in names and _load(twin).CAPTURES, name


@pytest.mark.parametrize("name", _fixtures())
def test_vmap_agrees_with_the_static_verdict(name, corpus_violations):
    """A flagged fixture raises under ``torch.func.vmap`` where its read
    needs a value; its clean twin runs, as the sliced plan's per-row update
    would run it."""
    module = _load(name)
    flagged = bool(_hits(corpus_violations, name + ".py"))
    assert flagged == (not module.CAPTURES)
    metric = module.Fixture(device="cpu")
    key = next(iter(metric._defaults))
    rows = torch.stack([batch[0] for batch in module.batches("cpu")])

    def per_row(row):
        metric.reset()
        metric.update(row)
        return getattr(metric, key)

    if module.CAPTURES or name in _CARD_ONLY:
        torch.func.vmap(per_row)(rows)
    else:
        with pytest.raises(RuntimeError, match="vmap"):
            torch.func.vmap(per_row)(rows)


@pytest.mark.parametrize("name", [n for n in _fixtures() if n.endswith("_clean")])
def test_clean_twin_step_equals_its_eager_fold(name):
    """The step the card captures, run eagerly on the CPU, folds the batches
    bit for bit as the metric's own updates do."""
    from torchmetrics_tpu_torch.parallel import make_jit_update

    module = _load(name)
    step, state = make_jit_update(module.Fixture(device="cpu"))
    eager = module.Fixture(device="cpu")
    for batch in module.batches("cpu"):
        state = step(state, *batch)
        eager.update(*batch)
    for key in eager._defaults:
        assert torch.equal(state[key], getattr(eager, key)), key
    assert int(state["_update_count"]) == 3
