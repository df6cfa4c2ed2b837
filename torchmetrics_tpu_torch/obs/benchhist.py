# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Bench-history tracking: persist bench records, diff trajectories, gate CI.

``bench.py`` prints ONE JSON line per run (headline + extras legs), and five
of those runs already sit in the repo root as loose ``BENCH_r0*.json`` files
with no tooling over them — including the r01 → r02 trap, where an
accelerator run was eyeballed against a CPU run as if they were comparable.
This module gives the trajectory a home and a gate:

- :func:`append` — normalize one bench record (a raw ``bench.py`` JSON
  object OR a run wrapper whose ``tail`` buries the JSON line in log
  noise) into a monotonically-numbered entry inside a history directory,
  carrying the run's **provenance fingerprint**;
- :func:`collect_fingerprint` — python/torch versions, OS/arch, accelerator
  device kind, CPU model, git revision. ``bench.py`` embeds it in every
  record; entries without one (pre-fingerprint records like r01–r05) are
  treated as *incomparable*, not silently comparable;
- :func:`diff_rows` / :func:`format_bench_table` — a per-leg trajectory
  table across runs (headline + every extras leg) with a last-vs-previous
  delta, leg add/remove/error drift surfaced, and a regression list for the
  ``metricscope bench diff --fail-on-regress <pct>`` CI gate. Legs are
  throughput by ``bench.py`` convention — **higher is better** — so a
  regression is the newest value falling more than the threshold below the
  previous run's.
- :func:`fingerprint_comparable` — the refusal rule: two runs diff only
  when OS/arch, device kind and CPU model all match (or the caller passes
  ``--allow-cross-platform`` and owns the apples-to-oranges risk).

Standalone (stdlib only; :func:`collect_fingerprint` reads torch through
``sys.modules`` and NEVER imports it, so a CLI loading this module by path
stays torch-free). The history format is the JAX package's: either
package's entries diff in the other.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from typing import Any, Dict, List, Optional, Tuple

from .export import render_table

#: layout version of one history entry file
BENCH_HISTORY_VERSION = 1

#: fingerprint fields that must agree for two runs to be comparable; version
#: fields (python/torch/jax/git) drift legitimately between runs and only annotate
COMPARE_KEYS = ("platform", "device_kind", "cpu_model")

_ENTRY_RE = re.compile(r"^run_(\d{4})\.json$")


# -------------------------------------------------------------- fingerprint


def _read_cpu_model() -> Optional[str]:
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.lower().startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    try:
        import platform as _platform

        return _platform.processor() or None
    except Exception:  # pragma: no cover - platform-dependent
        return None


def _git_rev() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        )
        return out.stdout.strip() or None if out.returncode == 0 else None
    except Exception:
        return None


def collect_fingerprint() -> Dict[str, Any]:
    """Provenance of THIS process's environment. torch fields come from
    ``sys.modules`` only — a producer has torch resident, the CLI never does
    and gets nulls, which :func:`fingerprint_comparable` treats as
    incomparable rather than guessing. The ``jax`` key stays (``None``) so
    records of both packages share one schema."""
    import platform as _platform

    fp: Dict[str, Any] = {
        "python": _platform.python_version(),
        "platform": f"{_platform.system()}-{_platform.machine()}",
        "cpu_model": _read_cpu_model(),
        "jax": None,
        "torch": None,
        "device_kind": None,
        "device_count": None,
        "git_rev": _git_rev(),
    }
    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            fp["torch"] = torch.__version__
            if torch.cuda.is_available():
                fp["device_count"] = torch.cuda.device_count()
                fp["device_kind"] = f"gpu:{torch.cuda.get_device_name(0)}"
            else:
                fp["device_count"] = 1
                fp["device_kind"] = "cpu:cpu"
        except Exception:  # pragma: no cover - backend-dependent
            pass
    return fp


def fingerprint_comparable(a: Optional[Dict[str, Any]], b: Optional[Dict[str, Any]]) -> Tuple[bool, Optional[str]]:
    """``(comparable, reason)`` — the ``bench diff`` refusal rule."""
    if not a or not b:
        missing = "both runs" if not a and not b else ("the older run" if not a else "the newer run")
        return False, (
            f"{missing} carr{'y' if missing == 'both runs' else 'ies'} no provenance fingerprint"
            " (pre-fingerprint record?) — cannot prove same-platform; pass --allow-cross-platform to diff anyway"
        )
    for key in COMPARE_KEYS:
        if a.get(key) != b.get(key):
            return False, (
                f"{key} differs: {a.get(key)!r} vs {b.get(key)!r} — an apples-to-oranges diff"
                " (the r01 accelerator vs r02 CPU trap); pass --allow-cross-platform to diff anyway"
            )
    return True, None


# ------------------------------------------------------------------ records


def parse_bench_record(text: str) -> Dict[str, Any]:
    """Extract the bench JSON object from ``text``: the whole document if it
    IS one, the ``tail`` field of a run wrapper, or the last line of raw
    log output that parses as a bench record — the three shapes the repo's
    own trajectory files actually come in."""
    try:
        obj = json.loads(text)
    except ValueError:
        obj = None
    if isinstance(obj, dict):
        if "metric" in obj and "value" in obj:
            return obj
        if isinstance(obj.get("tail"), str):
            text = obj["tail"]
        else:
            raise ValueError("JSON document has neither a bench record ('metric'/'value') nor a 'tail' field")
    for line in reversed(text.splitlines()):
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            candidate = json.loads(line)
        except ValueError:
            continue
        if isinstance(candidate, dict) and "metric" in candidate and "value" in candidate:
            return candidate
    raise ValueError("no bench JSON line found (expected an object with 'metric' and 'value')")


def legs(record: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Flatten one bench record into named legs: the headline metric plus
    every extras leg. Each leg is ``{"value", "unit", "status"}`` — skipped
    and errored legs keep a row (status ``"skipped"``/``"error"``) so drift
    is visible in the trajectory instead of silently narrowing it."""
    out: Dict[str, Dict[str, Any]] = {}
    if "metric" in record:
        out[str(record["metric"])] = {
            "value": record.get("value"),
            "unit": record.get("unit"),
            "status": "ok" if isinstance(record.get("value"), (int, float)) else "error",
        }
    for name, leg in (record.get("extras") or {}).items():
        if not isinstance(leg, dict):
            continue
        if "value" in leg:
            out[str(name)] = {"value": leg["value"], "unit": leg.get("unit"), "status": "ok"}
        elif "skipped" in leg:
            out[str(name)] = {"value": None, "unit": None, "status": "skipped"}
        else:
            out[str(name)] = {"value": None, "unit": None, "status": "error"}
    return out


# ------------------------------------------------------------------ history


def entries(history_dir: str) -> List[Dict[str, Any]]:
    """Every history entry in ``history_dir``, sorted by sequence number.
    Unreadable/foreign files raise — a bench gate must not silently diff a
    truncated history."""
    try:
        names = sorted(os.listdir(history_dir))
    except OSError as err:
        raise FileNotFoundError(f"cannot read bench history directory {history_dir}: {err}") from err
    out: List[Dict[str, Any]] = []
    for name in names:
        if not _ENTRY_RE.match(name):
            continue
        path = os.path.join(history_dir, name)
        with open(path) as fh:
            entry = json.load(fh)
        version = entry.get("bench_history_version")
        if not isinstance(version, int) or version < 1 or version > BENCH_HISTORY_VERSION:
            raise ValueError(f"{path} has bench_history_version {version!r}; this build reads <= {BENCH_HISTORY_VERSION}")
        entry["_path"] = path
        out.append(entry)
    out.sort(key=lambda e: e.get("seq", 0))
    return out


def append(history_dir: str, source_path: str, label: Optional[str] = None) -> Dict[str, Any]:
    """Normalize the bench record in ``source_path`` into the next history
    entry (``run_<seq>.json``, atomic write) and return the entry dict (its
    path under ``"_path"``). The fingerprint is the one the RUN embedded —
    appending never invents one (the CLI's environment says nothing about
    where the numbers came from)."""
    with open(source_path) as fh:
        record = parse_bench_record(fh.read())
    os.makedirs(history_dir, exist_ok=True)
    existing = entries(history_dir)
    seq = (existing[-1]["seq"] + 1) if existing else 1
    entry = {
        "bench_history_version": BENCH_HISTORY_VERSION,
        "seq": seq,
        "label": label,
        "source": os.path.basename(source_path),
        "fingerprint": record.get("fingerprint"),
        "legs": legs(record),
        "record": record,
    }
    # publish with link (atomic AND exclusive, unlike replace): two CI jobs
    # appending into a shared history concurrently both land, neither
    # silently overwrites the other — on collision take the next seq
    tmp = os.path.join(history_dir, f".append.tmp-{os.getpid()}")
    try:
        while True:
            entry["seq"] = seq
            path = os.path.join(history_dir, f"run_{seq:04d}.json")
            with open(tmp, "w") as fh:
                json.dump(entry, fh, indent=1)
            try:
                os.link(tmp, path)
            except FileExistsError:
                seq += 1
                continue
            break
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    entry["_path"] = path
    return entry


def _entry_label(entry: Dict[str, Any]) -> str:
    label = entry.get("label")
    return label if label else f"r{entry.get('seq', 0):03d}"


def diff_rows(history: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per-leg trajectory rows across ``history`` (chronological order).

    Each row: ``leg``, ``unit``, ``values`` (one slot per run; None where the
    leg is absent/skipped/errored), ``prev``/``last`` (the two newest numeric
    slots the gate compares), ``delta_pct`` (last vs prev; **negative =
    slower**, legs are throughput), and ``status``: ``common`` (diffable),
    ``added``/``removed`` (leg drift between the two newest runs),
    ``error``/``skipped`` (the newest run errored or skipped the leg — an
    ok→error transition GATES under ``--fail-on-regress``: a leg that went
    from working to crashing is the worst regression, not a removal),
    ``unit-drift`` (same leg, different unit — never gated, always shouted).
    """
    all_legs: List[str] = []
    for entry in history:
        for name in entry.get("legs", {}):
            if name not in all_legs:
                all_legs.append(name)
    rows = []
    for name in all_legs:
        slots = [entry.get("legs", {}).get(name) for entry in history]
        values = [
            (s["value"] if s and s.get("status") == "ok" and isinstance(s.get("value"), (int, float)) else None)
            for s in slots
        ]
        units = [s.get("unit") for s in slots if s and s.get("unit")]
        prev_v = values[-2] if len(values) >= 2 else None
        last_v = values[-1] if values else None
        prev_s, last_s = (slots[-2] if len(slots) >= 2 else None), (slots[-1] if slots else None)
        if prev_v is not None and last_v is not None:
            if prev_s.get("unit") != last_s.get("unit"):
                status, delta = "unit-drift", None
            else:
                status = "common"
                delta = None if prev_v == 0 else (last_v - prev_v) / prev_v * 100.0
        elif last_v is not None:
            status, delta = "added", None
        elif prev_v is not None:
            # numeric before, not numeric now: say WHY — an errored/skipped
            # newest leg must not masquerade as a clean removal
            last_status = (last_s or {}).get("status")
            status = last_status if last_status in ("error", "skipped") else "removed"
            delta = None
        else:
            status, delta = (last_s or prev_s or {}).get("status", "absent"), None
        rows.append(
            {
                "leg": name,
                "unit": next(iter(units), None),
                "values": values,
                "prev": prev_v,
                "last": last_v,
                "delta_pct": delta,
                "status": status,
            }
        )
    return rows


#: at most this many run columns render; older runs still feed prev/last
_MAX_RUN_COLUMNS = 8


def format_bench_table(
    history: List[Dict[str, Any]],
    fail_on_regress_pct: Optional[float] = None,
    allow_cross_platform: bool = False,
) -> Tuple[str, List[Dict[str, Any]], Optional[str]]:
    """Render the trajectory + the fingerprint provenance block. Returns
    ``(text, regressions, refusal)``: ``refusal`` is the non-None reason when
    the two newest runs are not provably same-platform (and the caller did
    not allow cross-platform) — the CLI then refuses instead of diffing;
    ``regressions`` are the common legs whose last-vs-prev delta fell below
    ``-fail_on_regress_pct``."""
    if not history:
        return "(empty bench history — add runs with: metricscope bench append <dir> <bench.json>)", [], None
    lines: List[str] = []
    refusal: Optional[str] = None
    if len(history) >= 2:
        comparable, reason = fingerprint_comparable(
            history[-2].get("fingerprint"), history[-1].get("fingerprint")
        )
        if not comparable:
            if allow_cross_platform:
                lines.append(f"WARNING: cross-platform diff forced: {reason}")
                lines.append("")
            else:
                refusal = reason

    shown = history[-_MAX_RUN_COLUMNS:]
    rows = diff_rows(history)
    header = ("leg", "unit") + tuple(_entry_label(e) for e in shown) + ("Δ%", "status")
    regressions: List[Dict[str, Any]] = []
    table: List[Tuple[str, ...]] = [header]
    n_hidden = len(history) - len(shown)
    for row in rows:
        regressed = (
            fail_on_regress_pct is not None
            and refusal is None
            and (
                (
                    row["status"] == "common"
                    and row["delta_pct"] is not None
                    and row["delta_pct"] < -fail_on_regress_pct
                )
                # ok -> error is a regression of any magnitude: the leg went
                # from producing a number to crashing
                or (row["status"] == "error" and row["prev"] is not None)
            )
        )
        if regressed:
            regressions.append(row)
        cells = [row["leg"], row["unit"] or "-"]
        for value in row["values"][n_hidden:]:
            cells.append("-" if value is None else f"{value:g}")
        if refusal is not None:
            cells.append("?")  # deltas are withheld on a refused comparison
        else:
            cells.append("-" if row["delta_pct"] is None else f"{row['delta_pct']:+.1f}")
        cells.append(row["status"] + (" REGRESSED" if regressed else ""))
        table.append(tuple(cells))
    lines.extend(render_table(table))
    if n_hidden:
        lines.append(f"(showing the last {len(shown)} of {len(history)} runs; deltas compare the newest two)")

    lines.append("")
    lines.append("provenance:")
    fp_table: List[Tuple[str, ...]] = [("run", "platform", "device", "cpu", "torch", "git")]
    for entry in shown:
        fp = entry.get("fingerprint") or {}
        fp_table.append(
            (
                _entry_label(entry),
                str(fp.get("platform") or "-"),
                str(fp.get("device_kind") or "-"),
                (str(fp.get("cpu_model"))[:32] if fp.get("cpu_model") else "-"),
                str(fp.get("torch") or fp.get("jax") or "-"),
                str(fp.get("git_rev") or "-"),
            )
        )
    lines.extend("  " + line for line in render_table(fp_table))

    lines.append("")
    if refusal is not None:
        lines.append(f"REFUSED: {refusal}")
    elif fail_on_regress_pct is not None:
        if regressions:
            worst = ", ".join(
                r["leg"] + (" (errored)" if r["delta_pct"] is None else f" ({r['delta_pct']:+.1f}%)")
                for r in regressions[:5]
            )
            lines.append(
                f"FAIL: {len(regressions)} leg(s) regressed beyond {fail_on_regress_pct:.1f}%: {worst}"
            )
        else:
            lines.append(f"OK: no leg regressed beyond {fail_on_regress_pct:.1f}%")
    return "\n".join(lines), regressions, refusal
