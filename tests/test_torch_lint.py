# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's metriclint (``torchmetrics_tpu_torch/lint``, counterpart of
``tests/unittests/test_metriclint.py``).

The port and ``chip_smoke.py`` stay clean against the committed ratchet
baseline, which holds only ML006 and ML013; every rule of the table fires on
the fixture corpus (``tests/torch_lint_corpus/``), each fixture exactly its
own rule and each clean twin none; ML007 and ML008 agree with the runtime
predicates they mirror, and ML013 gives every class both packages export
the JAX linter's verdict. The package and its CLI run on the standard
library alone.
"""
import doctest
import importlib
import inspect
import json
import os
import re
import subprocess
import sys
import time

import pytest

from torchmetrics_tpu_torch.lint import RULES, diff_against_baseline, lint_paths, load_baseline, summarize
from torchmetrics_tpu_torch.lint import rules as port_rules

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO_ROOT, "torchmetrics_tpu_torch")
SMOKE = os.path.join(REPO_ROOT, "chip_smoke.py")
CORPUS = os.path.join(REPO_ROOT, "tests", "torch_lint_corpus")
BASELINE = os.path.join(PORT, "lint", "baseline.json")
CLI = os.path.join(PORT, "lint", "__main__.py")


@pytest.fixture(scope="module")
def package_run():
    """One package-wide run, shared by the slow tests: (violations, seconds)."""
    start = time.monotonic()
    violations = lint_paths([PORT, SMOKE], root=REPO_ROOT)
    return violations, time.monotonic() - start


@pytest.fixture(scope="module")
def corpus_violations():
    return lint_paths([CORPUS], root=CORPUS)


def test_port_is_clean_against_committed_baseline(package_run):
    violations, _ = package_run
    new, _stale = diff_against_baseline(violations, load_baseline(BASELINE))
    assert not new, "new metriclint violations (fix or suppress with a reason):\n" + "\n".join(v.render() for v in new)


def test_baseline_holds_only_ratcheted_rules_and_no_stale_entry(package_run):
    violations, _ = package_run
    baseline = load_baseline(BASELINE)
    assert {key.split("::")[1] for key in baseline} == {"ML006", "ML013"}
    _new, stale = diff_against_baseline(violations, baseline)
    assert not stale, f"stale baseline entries, run the CLI with --write-baseline: {stale}"
    assert not any(v.rule not in ("ML006", "ML013") for v in violations)


def test_package_wide_run_stays_under_runtime_budget(package_run):
    """The package-wide run (import and call graphs, every rule, over the
    port and chip_smoke.py) stays cheap: ~3x the current cost, to catch an
    accidentally quadratic analysis, not CI jitter."""
    _, seconds = package_run
    assert seconds < 30.0, f"package-wide metriclint took {seconds:.1f}s (budget 30s)"


def test_every_suppression_in_the_port_carries_a_reason():
    pattern = re.compile(r"#\s*metriclint:\s*disable(-file)?=([A-Z0-9_,\s]+?)(\s*--\s*(.*))?$")
    seen = 0
    for dirpath, _dirs, files in os.walk(PORT):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            for lineno, line in enumerate(open(path, encoding="utf-8"), 1):
                if "metriclint:" not in line or "#" not in line:
                    continue
                match = pattern.search(line.rstrip())
                if match is None:
                    continue
                seen += 1
                reason = (match.group(4) or "").strip()
                assert len(reason) >= 10, f"{os.path.relpath(path, REPO_ROOT)}:{lineno} suppresses without a reason"
    assert seen >= 1


# ------------------------------------------------------------------ corpus


def _corpus_files():
    out = []
    for dirpath, _dirs, files in os.walk(CORPUS):
        for name in sorted(files):
            if name.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, name), CORPUS).replace(os.sep, "/"))
    return sorted(out)


def _expected(rel):
    """``ml0xx_*.py`` fires exactly MLxxx; a ``*_clean*.py`` twin fires nothing."""
    base = rel.split("/")[-1]
    if "clean" in base:
        return set()
    return {"ML" + base[2:5]}


@pytest.mark.parametrize("rel", _corpus_files())
def test_fixture_fires_exactly_its_rule(corpus_violations, rel):
    assert {v.rule for v in corpus_violations if v.path == rel} == _expected(rel)


def test_every_rule_fires_on_the_corpus(corpus_violations):
    """ML013, ML014 and ML015 included: a silently broken rule cannot pass."""
    fired = {v.rule for v in corpus_violations}
    assert fired == set(RULES), f"rules that did not fire: {set(RULES) - fired}"
    assert {"ML014", "ML015"} <= set(RULES) and len(RULES) == 15


def test_every_rule_has_a_clean_twin():
    files = _corpus_files()
    for rule in RULES:
        number = rule[2:]
        assert any(f.split("/")[-1].startswith(f"ml{number}") and "clean" in f for f in files), rule


def test_ml002_names_each_capture_breaker(corpus_violations):
    text = {v.path: v.message for v in corpus_violations if v.rule == "ML002"}
    assert ".item()" in text["ml002_item.py"]
    assert "bool()" in text["ml002_bool.py"]
    assert "boolean-mask" in text["ml002_mask_index.py"]
    assert "_bincount" in text["ml002_bincount.py"]
    assert "nonzero" in text["ml002_nonzero.py"]
    assert "uploads host memory" in text["ml002_upload.py"]


def test_ml014_and_ml015_messages(corpus_violations):
    (ml014,) = [v for v in corpus_violations if v.rule == "ML014"]
    assert ml014.scope == "sum_but" and "`dims`" in ml014.message and "csi.py" in ml014.message
    ml015 = [v for v in corpus_violations if v.rule == "ML015"]
    assert {v.scope for v in ml015} == {"scale_product", "side_product"}


_SNIPPET = '''
import torch

from torchmetrics_tpu_torch import Metric
from torchmetrics_tpu_torch.utilities.checks import _is_concrete

Tensor = torch.Tensor


def _host_ok(x):
    return _is_concrete(x) and x.numel() > 0


class Snippet(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x: Tensor, y: Tensor) -> None:
        if x.shape != y.shape or x.dtype == torch.bool or x is None:
            raise ValueError("static checks read no value")
        if _is_concrete(x) and bool((x < 0).any()):
            raise ValueError("a host check where values can be read")
        if not _is_concrete(y):
            self.total = self.total + y.sum()
            return
        self.total = self.total + float(y.sum())

    def compute(self):
        return float(self.total)


def _plain(x: Tensor) -> Tensor:
    if x.device.type == "cpu":
        return x[x > 0]
    return x


def _kernel_update(x: Tensor, n: int) -> Tensor:
    if _host_ok(x) and int(x.max()) >= n:
        raise ValueError("label out of range")
    return _plain(x) + x.sum(dim=-1, keepdim=True) + x.sum(dim=(0, 1))
'''


def test_host_regions_are_not_captured(tmp_path):
    """What runs only where ``_is_concrete`` holds (or on a CPU tensor), a
    compute() body and static reads (shapes, dtypes, ``is None``) are quiet."""
    path = tmp_path / "snippet.py"
    path.write_text(_SNIPPET)
    assert lint_paths([str(path)], root=str(tmp_path)) == []


def test_suppression_comment_silences_rule(tmp_path):
    flagged = open(os.path.join(CORPUS, "ml002_item.py")).read()
    suppressed = flagged.replace(
        "        scale = x.abs().max().item()",
        "        # metriclint: disable=ML002 -- the scale is read once per eager update\n"
        "        scale = x.abs().max().item()",
    )
    assert suppressed != flagged
    (tmp_path / "a.py").write_text(flagged)
    (tmp_path / "b.py").write_text(suppressed)
    assert {v.path for v in lint_paths([str(tmp_path)], root=str(tmp_path))} == {"a.py"}


def test_baseline_ratchet_semantics(corpus_violations):
    baseline = summarize(corpus_violations)
    new, stale = diff_against_baseline(corpus_violations, baseline)
    assert new == [] and stale == {}
    key = next(iter(baseline))
    baseline[key] -= 1
    new, _ = diff_against_baseline(corpus_violations, baseline)
    assert len(new) == 1
    baseline["gone.py::ML002::f"] = 2
    _, stale = diff_against_baseline(corpus_violations, baseline)
    assert stale == {"gone.py::ML002::f": 2}


# --------------------------------------------------- agreement with runtime


def _port_index():
    index = port_rules.ClassIndex()
    for dirpath, _dirs, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                import ast

                index.add_file(os.path.relpath(path, REPO_ROOT), ast.parse(open(path, encoding="utf-8").read()))
    index.finalize()
    return index


_SUBS = ("classification", "clustering", "nominal", "detection", "segmentation", "image",
         "audio", "text", "retrieval", "regression", "wrappers", "aggregation", "multimodal", "")


def _exported_classes(package):
    base = importlib.import_module(f"{package}.metric").Metric
    out = {}
    for sub in _SUBS:
        module = importlib.import_module(f"{package}.{sub}" if sub else package)
        for name in getattr(module, "__all__", []):
            obj = getattr(module, name, None)
            if inspect.isclass(obj) and issubclass(obj, base):
                out.setdefault(name, obj)
    return out


def _built_from_example(cls):
    """The first metric the statements of ``cls``'s docstring example build
    (on the CPU, as every example builds; a task wrapper builds its task's
    class), or None. Statements the example skips are skipped."""
    from torchmetrics_tpu_torch.metric import Metric

    namespace = {}
    for example in doctest.DocTestParser().get_examples(cls.__doc__ or ""):
        if example.options.get(doctest.SKIP):
            continue
        try:
            exec(compile(example.source, "<example>", "exec"), namespace)  # noqa: S102 - the port's own examples
        except Exception:
            return None
        found = [v for v in namespace.values() if isinstance(v, Metric) and type(v).__module__.startswith("torchmetrics_tpu_torch.")]
        if found:
            return found[0]
    return _BUILT_DIRECTLY.get(cls.__name__, lambda: None)()


#: the classes whose example skips its constructor (a pretrained tower or a
#: host scorer): built here on the CPU with the seeded defaults
_BUILT_DIRECTLY = {
    "FrechetInceptionDistance": lambda: _port("image").FrechetInceptionDistance(feature=64, device="cpu"),
    "KernelInceptionDistance": lambda: _port("image").KernelInceptionDistance(feature=64, subset_size=2, device="cpu"),
    "InceptionScore": lambda: _port("image").InceptionScore(device="cpu"),
    "MemorizationInformedFrechetInceptionDistance": lambda: _port("image").MemorizationInformedFrechetInceptionDistance(feature=64, device="cpu"),
    "LearnedPerceptualImagePatchSimilarity": lambda: _port("image").LearnedPerceptualImagePatchSimilarity(net_type="squeeze", device="cpu"),
    "SpeechReverberationModulationEnergyRatio": lambda: _port("audio").SpeechReverberationModulationEnergyRatio(fs=8000, device="cpu"),
    "ShortTimeObjectiveIntelligibility": lambda: _port("audio").ShortTimeObjectiveIntelligibility(fs=8000, device="cpu"),
}


def _port(sub):
    return importlib.import_module(f"torchmetrics_tpu_torch.{sub}")


def test_ml007_agrees_with_fusion_ineligibility_on_every_exported_class():
    """Every exported class, built on the CPU by its own example: the static
    mirror and ``parallel/fused.py``'s ``fusion_ineligibility`` both refuse
    it or both accept it."""
    from torchmetrics_tpu_torch.parallel import fusion_ineligibility

    index = _port_index()
    checked, disagree = 0, []
    for name, cls in sorted(_exported_classes("torchmetrics_tpu_torch").items()):
        metric = _built_from_example(cls)
        if metric is None:
            continue
        checked += 1
        runtime = fusion_ineligibility(metric)
        static = index.fusion_ineligible(type(metric).__name__)
        if (runtime is None) != (static is None):
            disagree.append((name, runtime, static))
    assert checked >= 210, checked
    assert not disagree, disagree


def test_ml007_flags_what_the_runtime_refuses(tmp_path):
    from torchmetrics_tpu_torch.parallel import fusion_ineligibility

    source = open(os.path.join(CORPUS, "ml007_collection.py")).read()
    clean = open(os.path.join(CORPUS, "ml007_clean.py")).read()
    namespace, clean_ns = {}, {}
    exec(compile(source, "ml007_collection.py", "exec"), namespace)  # noqa: S102 - test fixture
    exec(compile(clean, "ml007_clean.py", "exec"), clean_ns)  # noqa: S102 - test fixture
    assert fusion_ineligibility(namespace["KwOnly"](device="cpu")) is not None
    assert fusion_ineligibility(clean_ns["Positional"](device="cpu")) is None


_ML008_SNIPPET = '''
import torch
from torchmetrics_tpu_torch.parallel import SlicedPlan


def good(metric, cohorts, scores):
    plan_a = SlicedPlan(metric, num_cells=1024)
    plan_b = SlicedPlan(metric, num_cells=cohorts * 2)
    plan_c = metric.sliced(num_cells=512, example_keys=torch.tensor([1, 2]))
    plan_d = SlicedPlan(metric, num_cells=torch.cuda.device_count() * 128)
    plan_e = metric.sliced(num_cells=64, example_keys=torch.bucketize(scores, torch.linspace(0.0, 1.0, 16)))
    plan_f = SlicedPlan(metric, num_cells=int(cohorts / 2))
    plan_g = metric.sliced(num_cells=64, example_keys=torch.tensor([1.5, 2.5], dtype=torch.int32))
    return plan_a, plan_b, plan_c, plan_d, plan_e, plan_f, plan_g


def bad(metric, cohorts, scores):
    plan_a = SlicedPlan(metric, num_cells=1024.0)
    plan_b = SlicedPlan(metric, num_cells=cohorts / 2)
    plan_c = SlicedPlan(metric, num_cells=int(torch.unique(cohorts).numel()))
    plan_d = metric.sliced(num_cells=64, example_keys=torch.tensor([1.5]))
    plan_e = metric.sliced(num_cells=64, example_keys=scores.to(torch.float32))
    plan_f = metric.sliced(num_cells=64, example_keys=scores.float())
    return plan_a, plan_b, plan_c, plan_d, plan_e, plan_f
'''


def test_ml008_flags_only_contract_violations(tmp_path):
    path = tmp_path / "ml008_snippet.py"
    path.write_text(_ML008_SNIPPET)
    violations = [v for v in lint_paths([str(path)], root=str(tmp_path)) if v.rule == "ML008"]
    text = _ML008_SNIPPET.splitlines()
    bad_start = next(i for i, line in enumerate(text) if line.startswith("def bad")) + 1
    assert all(v.line > bad_start for v in violations), violations
    assert len([v for v in violations if v.scope == "SlicedPlan.num_cells"]) == 3
    assert len([v for v in violations if v.scope == "SlicedPlan.example_keys"]) == 3


def test_ml008_agrees_with_the_slice_predicates():
    """What ML008 flags, ``slice_table_size_reason``/``slice_key_reason``
    refuse, and what it passes they accept."""
    import torch

    from torchmetrics_tpu_torch.parallel import slice_key_reason, slice_table_size_reason

    cohorts = 9
    assert slice_table_size_reason(1024) is None and slice_table_size_reason(cohorts * 2) is None
    assert slice_table_size_reason(int(cohorts / 2)) is None and slice_table_size_reason(cohorts // 2) is None
    assert slice_table_size_reason(1024.0) is not None and slice_table_size_reason(cohorts / 2) is not None
    assert slice_table_size_reason(0) is not None and slice_table_size_reason(True) is not None
    assert slice_table_size_reason(torch.tensor(8)) is not None
    for dtype in (torch.int32, torch.int64, torch.bool, torch.tensor([1, 2]).dtype,
                  torch.tensor([1.5, 2.5], dtype=torch.int32).dtype, torch.bucketize(torch.rand(4), torch.linspace(0.0, 1.0, 16)).dtype):
        assert slice_key_reason(dtype) is None, dtype
    for dtype in (torch.tensor([1.5]).dtype, torch.float32, torch.float16, torch.bfloat16, torch.float64):
        assert slice_key_reason(dtype) is not None, dtype


def test_ml003_reads_the_port_reduction_names():
    from torchmetrics_tpu_torch._reduction_names import VALID_REDUCTION_NAMES

    assert port_rules._VALID_REDUCTIONS == tuple(VALID_REDUCTION_NAMES)


def _ml013_verdicts(rules_module, package_dir, names):
    """Each linter's own class index and ML013 check, class by class."""
    import ast

    index = rules_module.ClassIndex()
    for dirpath, _dirs, files in os.walk(package_dir):
        for fname in files:
            if fname.endswith(".py"):
                path = os.path.join(dirpath, fname)
                index.add_file(os.path.relpath(path, REPO_ROOT), ast.parse(open(path, encoding="utf-8").read()))
    index.finalize()
    out = {}
    for name in names:
        infos = index._by_name.get(name, [])
        out[name] = any(any(True for _ in rules_module.check_ml013(info, index)) for info in infos)
    return out


def test_ml013_verdicts_equal_jax_class_for_class():
    from torchmetrics_tpu.lint import rules as jax_rules

    names = sorted(set(_exported_classes("torchmetrics_tpu_torch")) & set(_exported_classes("torchmetrics_tpu")))
    assert len(names) >= 200
    port = _ml013_verdicts(port_rules, PORT, names)
    jax_ = _ml013_verdicts(jax_rules, os.path.join(REPO_ROOT, "torchmetrics_tpu"), names)
    differ = sorted(n for n in names if port[n] != jax_[n])
    assert not differ, differ
    assert sum(port.values()) >= 50  # the rule is not vacuous


# --------------------------------------------------------------------- CLI


def _cli(*args, module=False):
    cmd = [sys.executable, "-m", "torchmetrics_tpu_torch.lint", *args] if module else [sys.executable, CLI, *args]
    return subprocess.run(cmd, capture_output=True, text=True, cwd=REPO_ROOT, timeout=300)


def test_cli_exit_codes():
    flagged = os.path.join(CORPUS, "ml002_item.py")
    out = _cli(flagged)
    assert out.returncode == 1 and "ML002" in out.stdout, out.stdout + out.stderr
    payload = json.loads(_cli("--format", "json", flagged).stdout)
    assert payload["total"] == 1 and payload["new"][0]["rule"] == "ML002"
    assert _cli("--no-baseline", os.path.join(CORPUS, "ml002_item_clean.py")).returncode == 0
    assert _cli("--bogus-flag").returncode == 2


def test_cli_runs_as_a_module_and_explains_every_rule():
    out = _cli("explain", "ML014", module=True)
    assert out.returncode == 0 and "dim=()" in out.stdout, out.stderr
    for rule in RULES:
        assert rule in _cli("explain", rule).stdout
    assert _cli("explain", "ML999").returncode == 2


def test_partial_scope_refuses_to_write_the_default_baseline():
    out = _cli("--write-baseline", os.path.join(CORPUS, "ml002_item.py"))
    assert out.returncode == 2 and "refusing" in out.stderr


def test_lint_package_and_cli_import_no_torch_numpy_or_jax():
    """A fresh interpreter with torch, numpy and jax poisoned: the CLI run by
    path lints a fixture and the package loads by path."""
    code = (
        "import runpy, sys\n"
        "for name in ('torch', 'numpy', 'jax', 'jaxlib', 'torchmetrics_tpu', 'torchmetrics_tpu_torch'):\n"
        "    sys.modules[name] = None\n"
        f"sys.argv = ['metriclint', '--format', 'json', {os.path.join(CORPUS, 'ml015_prod.py')!r}]\n"
        "try:\n"
        f"    runpy.run_path({CLI!r}, run_name='__main__')\n"
        "except SystemExit as stop:\n"
        "    print('EXIT', stop.code)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO_ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("EXIT 1"), out.stdout + out.stderr
    assert '"rule": "ML015"' in out.stdout
