# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""metriclint CLI of the port — static capture/state-contract checks
(counterpart of ``tools/metriclint.py``).

Usage::

    python -m torchmetrics_tpu_torch.lint                       # ratchet vs baseline
    python torchmetrics_tpu_torch/lint/__main__.py              # the same, torch-free
    python -m torchmetrics_tpu_torch.lint --format json FILE    # machine output
    python -m torchmetrics_tpu_torch.lint --no-baseline         # full report
    python -m torchmetrics_tpu_torch.lint --write-baseline      # regenerate ratchet
    python -m torchmetrics_tpu_torch.lint --diff main           # changed files only
    python -m torchmetrics_tpu_torch.lint explain ML014         # rule rationale + fix

The default scope is ``torchmetrics_tpu_torch/`` plus ``chip_smoke.py``; the
baseline is ``torchmetrics_tpu_torch/lint/baseline.json``. With ``--diff
<git-ref>`` only files changed since the ref are REPORTED on, but the import
and call graphs are still built over the full default scope.

Exit status: 0 when no violations above the baseline, 1 otherwise (with
``--no-baseline``: 1 when any violation at all), 2 on usage errors.

Run as a file path, this script loads its sibling modules by path and
imports only the standard library (``-m`` imports the port's package, and
so torch, first).
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

_LINT_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(os.path.dirname(_LINT_DIR))
_DEFAULT_BASELINE = os.path.join(_LINT_DIR, "baseline.json")
_DEFAULT_SCOPE = ("torchmetrics_tpu_torch", "chip_smoke.py")


def _load_lint():
    """The lint package: imported normally under ``-m``, else by file path."""
    if __package__:
        return importlib.import_module(__package__)
    spec = importlib.util.spec_from_file_location(
        "torchmetrics_tpu_torch_metriclint", os.path.join(_LINT_DIR, "__init__.py"),
        submodule_search_locations=[_LINT_DIR],
    )
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # the package's relative imports need it
    spec.loader.exec_module(module)
    return module


def _explain(lint, rule: str) -> int:
    rule = rule.upper()
    if rule not in lint.RULES:
        known = ", ".join(sorted(lint.RULES))
        print(f"metriclint: unknown rule {rule!r} (known: {known})", file=sys.stderr)
        return 2
    print(f"{rule}: {lint.RULES[rule]}")
    print()
    print(textwrap.dedent(lint.EXPLANATIONS[rule]).strip())
    return 0


def _changed_files(ref: str):
    """Paths changed since ``ref`` (committed + worktree), repo-relative."""
    out = subprocess.run(
        ["git", "diff", "--name-only", ref, "--"],
        cwd=_REPO_ROOT, capture_output=True, text=True,
    )
    if out.returncode != 0:
        raise RuntimeError(out.stderr.strip() or f"git diff {ref} failed")
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "explain":
        lint = _load_lint()
        if len(argv) != 2:
            print("usage: metriclint explain ML0xx", file=sys.stderr)
            return 2
        return _explain(lint, argv[1])

    parser = argparse.ArgumentParser(prog="metriclint", description=__doc__.splitlines()[0])
    parser.add_argument("paths", nargs="*", default=None,
                        help="files/dirs to lint (default: torchmetrics_tpu_torch/ and chip_smoke.py)")
    parser.add_argument("--format", choices=("text", "json"), default="text")
    parser.add_argument("--baseline", default=_DEFAULT_BASELINE,
                        help="ratchet baseline JSON (default: torchmetrics_tpu_torch/lint/baseline.json)")
    parser.add_argument("--no-baseline", action="store_true", help="ignore the baseline; report and fail on every violation")
    parser.add_argument("--write-baseline", action="store_true", help="regenerate the baseline from the current violations and exit 0")
    parser.add_argument("--diff", metavar="GIT_REF", default=None,
                        help="report only on files changed since GIT_REF; the import/call"
                             " graphs are still built over the full default scope")
    args = parser.parse_args(argv)

    lint = _load_lint()
    default_paths = [os.path.join(_REPO_ROOT, d) for d in _DEFAULT_SCOPE]
    explicit_partial_scope = bool(args.diff) or (args.paths and sorted(
        os.path.normpath(os.path.abspath(p)) for p in args.paths
    ) != sorted(default_paths))
    if args.write_baseline and explicit_partial_scope and os.path.abspath(args.baseline) == _DEFAULT_BASELINE:
        # a partial-scope run must not clobber the package-wide ratchet
        print(
            "metriclint: refusing to overwrite the package-wide baseline from a partial"
            " scope — rerun without paths/--diff, or pass --baseline <file> for a scoped one",
            file=sys.stderr,
        )
        return 2


    if args.diff is not None:
        if args.paths:
            print("metriclint: --diff and explicit paths are mutually exclusive", file=sys.stderr)
            return 2
        try:
            changed = _changed_files(args.diff)
        except RuntimeError as err:
            print(f"metriclint: {err}", file=sys.stderr)
            return 2
        paths = [
            os.path.join(_REPO_ROOT, rel) for rel in changed
            if rel.endswith(".py") and (rel.startswith(_DEFAULT_SCOPE[0] + "/") or rel == _DEFAULT_SCOPE[1])
            and os.path.exists(os.path.join(_REPO_ROOT, rel))
        ]
        if not paths:
            print(f"metriclint: no lintable files changed since {args.diff}")
            return 0
        violations = lint.lint_paths(paths, root=_REPO_ROOT, graph_paths=default_paths)
    else:
        paths = args.paths or default_paths
        violations = lint.lint_paths(paths, root=_REPO_ROOT)

    if args.write_baseline:
        counts = lint.engine.write_baseline(args.baseline, violations)
        print(f"metriclint: wrote {sum(counts.values())} baselined violation(s) across "
              f"{len(counts)} fingerprint(s) to {os.path.relpath(args.baseline, _REPO_ROOT)}")
        return 0

    baseline = {}
    if not args.no_baseline and os.path.exists(args.baseline):
        baseline = lint.load_baseline(args.baseline)
    new, stale = lint.diff_against_baseline(violations, baseline)
    if explicit_partial_scope:
        # unreported files' baseline entries are not actually stale
        stale = {}

    if args.format == "json":
        print(json.dumps({
            "total": len(violations),
            "baselined": len(violations) - len(new),
            "new": [vars(v) for v in new],
            "stale_baseline": stale,
        }, indent=2))
    else:
        for violation in new:
            print(violation.render())
        baselined = len(violations) - len(new)
        summary = f"metriclint: {len(new)} new violation(s), {baselined} baselined"
        if stale:
            summary += (f"; {sum(stale.values())} stale baseline entr(y/ies) — "
                        "run --write-baseline to ratchet down")
        print(summary)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
