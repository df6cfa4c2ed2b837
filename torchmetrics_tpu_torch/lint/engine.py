# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""metriclint engine: file walking, suppression comments, baseline ratchet
(counterpart of ``torchmetrics_tpu/lint/engine.py``).

Baseline format (``torchmetrics_tpu_torch/lint/baseline.json``): a JSON object mapping
``"<path>::<rule>::<scope>"`` fingerprints to violation counts. The ratchet
compares counts per fingerprint — line numbers are deliberately NOT part of
the key so unrelated edits above a pre-existing violation do not break CI —
and fails only when a fingerprint's count EXCEEDS its baselined value. A
fingerprint that shrinks to zero just becomes stale; regenerate with
``python -m torchmetrics_tpu_torch.lint --write-baseline`` to ratchet it down.
"""
from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import dataflow
from .graph import CallGraph, ImportGraph, ModuleSet
from .rules import ClassIndex, Violation, check_file

_SUPPRESS_RE = re.compile(r"#\s*metriclint:\s*disable=([A-Z0-9_,\s]+?)(?:\s*--|$)")
_SUPPRESS_FILE_RE = re.compile(r"#\s*metriclint:\s*disable-file=([A-Z0-9_,\s]+?)(?:\s*--|$)")


def _iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for path in paths:
        if os.path.isfile(path) and path.endswith(".py"):
            yield path
        elif os.path.isdir(path):
            for dirpath, dirnames, filenames in os.walk(path):
                dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
                for fname in sorted(filenames):
                    if fname.endswith(".py"):
                        yield os.path.join(dirpath, fname)


def _parse_suppressions(source: str, tree: ast.Module) -> Tuple[Dict[int, set], set]:
    """(line -> {rules disabled on/for that line}, file-wide disabled rules).

    A suppression on a ``def``/``class`` line covers the whole body — the
    idiom for functions that are host-path by design (eager validation
    helpers, documented host branches)."""
    raw: Dict[int, set] = {}
    own_line: Dict[int, bool] = {}
    file_wide: set = set()
    # real COMMENT tokens only — suppression syntax quoted inside a
    # string/docstring (documentation, test fixtures) must stay inert
    try:
        comments = [
            (tok.start[0], tok.start[1], tok.string)
            for tok in tokenize.generate_tokens(io.StringIO(source).readline)
            if tok.type == tokenize.COMMENT
        ]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        comments = []
    for lineno, col, comment in comments:
        match = _SUPPRESS_FILE_RE.search(comment)
        if match:
            file_wide |= {r.strip() for r in match.group(1).split(",") if r.strip()}
            continue
        match = _SUPPRESS_RE.search(comment)
        if match:
            raw.setdefault(lineno, set()).update(
                r.strip() for r in match.group(1).split(",") if r.strip()
            )
            own_line[lineno] = col == 0 or not source.splitlines()[lineno - 1][:col].strip()
    per_line: Dict[int, set] = {}
    for lineno, rules in raw.items():
        per_line.setdefault(lineno, set()).update(rules)
        if own_line[lineno]:
            # only a comment on its OWN line extends to the statement below —
            # a trailing comment must not silence the neighbouring line
            per_line.setdefault(lineno + 1, set()).update(rules)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.lineno in raw and node.end_lineno is not None:
                for lineno in range(node.lineno, node.end_lineno + 1):
                    per_line.setdefault(lineno, set()).update(raw[node.lineno])
    return per_line, file_wide


def lint_paths(
    paths: Sequence[str],
    root: Optional[str] = None,
    graph_paths: Optional[Sequence[str]] = None,
) -> List[Violation]:
    """Run every rule over ``paths`` (files or directories), honouring
    suppression comments. Paths in the result are relative to ``root``.

    ``graph_paths`` widens the ANALYSIS scope without widening the REPORT
    scope: the class index, import graph and call graph are built over
    ``paths`` plus ``graph_paths``, but violations are only reported for
    files in ``paths`` — the ``--diff`` contract (lint the changed files,
    keep the cross-file rules sound)."""
    root = os.path.abspath(root or os.getcwd())
    # dedup by absolute path: overlapping inputs (dir + file inside it) must
    # not register a file's classes twice, or violations double-count
    files = list(dict.fromkeys(_iter_py_files([os.path.abspath(p) for p in paths])))
    graph_files = list(
        dict.fromkeys(_iter_py_files([os.path.abspath(p) for p in graph_paths or []]))
    )
    sources: Dict[str, str] = {}
    trees: Dict[str, ast.Module] = {}
    report_rels: List[str] = []
    index = ClassIndex()
    for fname in dict.fromkeys(files + graph_files):
        try:
            with open(fname, "r", encoding="utf-8") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=fname)
        except (OSError, SyntaxError):
            continue  # unreadable/unparsable files are pytest's problem, not ours
        rel = os.path.relpath(fname, root).replace(os.sep, "/")
        sources[rel] = source
        trees[rel] = tree
        index.add_file(rel, tree)
        if fname in set(files):
            report_rels.append(rel)
    index.finalize()

    # cross-file structures, built ONCE over the full analysis scope; the
    # module set lazily parses files outside it (a script importing a
    # package module resolves even when only the CLI is being linted)
    modules = ModuleSet(root, trees)
    importgraph = ImportGraph(modules)
    callgraph = CallGraph(modules, trees)

    report_set = set(report_rels)
    violations: List[Violation] = []
    for rel in report_rels:
        tree = trees[rel]
        violations.extend(check_file(rel, tree, index))
        violations.extend(dataflow.check_ml010(rel, tree, importgraph))
        violations.extend(dataflow.check_ml012(rel, tree))
    # graph-global rules: computed over everything, reported for the report set
    violations.extend(v for v in dataflow.check_ml009(callgraph) if v.path in report_set)
    violations.extend(v for v in dataflow.check_ml011(callgraph, index) if v.path in report_set)

    kept: List[Violation] = []
    suppressions: Dict[str, Tuple[Dict[int, set], set]] = {}
    for violation in violations:
        if violation.path not in suppressions:
            suppressions[violation.path] = _parse_suppressions(
                sources[violation.path], trees[violation.path]
            )
        per_line, file_wide = suppressions[violation.path]
        if violation.rule in file_wide:
            continue
        if violation.rule in per_line.get(violation.line, set()):
            continue
        kept.append(violation)
    kept.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return kept


# ------------------------------------------------------------------ baseline


def fingerprint(violation: Violation) -> str:
    return f"{violation.path}::{violation.rule}::{violation.scope}"


def summarize(violations: Iterable[Violation]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for violation in violations:
        key = fingerprint(violation)
        counts[key] = counts.get(key, 0) + 1
    return counts


def load_baseline(path: str) -> Dict[str, int]:
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    counts = data.get("violations", data) if isinstance(data, dict) else data
    return {str(k): int(v) for k, v in counts.items()}


def write_baseline(path: str, violations: Iterable[Violation]) -> Dict[str, int]:
    counts = summarize(violations)
    payload = {
        "_comment": "metriclint ratchet baseline — counts per path::rule::scope;"
        " regenerate with `python -m torchmetrics_tpu_torch.lint --write-baseline`."
        " New violations (counts above these) fail CI; shrinking it is welcome.",
        "violations": {k: counts[k] for k in sorted(counts)},
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=False)
        fh.write("\n")
    return counts


def diff_against_baseline(
    violations: Sequence[Violation], baseline: Dict[str, int]
) -> Tuple[List[Violation], Dict[str, int]]:
    """(new violations above baseline, stale fingerprints below baseline).

    Within one fingerprint the first ``baseline[fp]`` occurrences (in
    file/line order) are considered pre-existing; the rest are new.
    """
    remaining = dict(baseline)
    new: List[Violation] = []
    for violation in violations:
        key = fingerprint(violation)
        if remaining.get(key, 0) > 0:
            remaining[key] -= 1
        else:
            new.append(violation)
    stale = {k: v for k, v in remaining.items() if v > 0}
    return new, stale
