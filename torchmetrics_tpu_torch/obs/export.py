# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Trace export and summarization.

Two on-disk formats:

- **JSON-lines** (:func:`write_jsonl` / :func:`read_jsonl`): one recorded
  event per line plus one trailing ``{"type": "counters", ...}`` line with
  the counter/gauge snapshot and a ``{"type": "meta", ...}`` line with drop
  accounting — a trace file is self-contained.
- **Chrome trace** (:func:`to_chrome_trace` / :func:`write_chrome_trace`):
  the Catapult JSON Object Format — load the file in ``chrome://tracing`` or
  https://ui.perfetto.dev. Spans become complete (``"ph": "X"``) events,
  instants become ``"ph": "i"``, counters ride in ``otherData``.

:func:`summarize` aggregates a recorded trace into the per-metric/per-phase
table ``tools/metricscope.py summary`` prints. This module is standalone (it
imports neither torch nor jax) so the CLI can load it without paying the package import.
"""
from __future__ import annotations

import json
import os
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import counters as _counters
from . import trace as _trace

# one warning per process when an export first observes ring-buffer drops: a
# truncated trace must announce itself even if nobody reads the meta line
_drop_warned = False


def write_jsonl(path: str, events: Optional[List[Dict[str, Any]]] = None,
                counter_snapshot: Optional[Dict[str, Any]] = None,
                dropped: Optional[int] = None, rank: Optional[int] = None) -> None:
    """Write a self-contained JSON-lines trace file.

    Defaults to the live ring buffer and the live counter registry; pass
    ``events``/``counter_snapshot`` explicitly to export a saved recording —
    the meta line's drop count then comes from ``dropped`` (a saved recording
    must carry its own accounting; the live buffer's count only applies to
    the live buffer's events).

    The meta line anchors the file for cross-process merging: ``epoch_ns``
    (wall clock) and ``mono_ns`` (the span clock at the same instant) let
    :func:`~torchmetrics_tpu_torch.obs.merge.merge_traces` place this file's
    monotonic timestamps on a shared wall-clock timeline; pass ``rank`` so
    the merged view labels this process's lane (without it, the merge falls
    back to the file's position in its argument list — the recorded ``pid``
    is informational only).

    A live-buffer export also publishes the ``obs.trace.ring_high_water``
    gauge and, the FIRST time drops are observed, emits one warning naming
    how many spans were lost — a truncated profile must not read as complete.
    """
    global _drop_warned
    live = events is None
    if dropped is None:
        dropped = _trace.dropped_events() if live else 0
    events = _trace.get_trace() if live else events
    if live:
        _counters.set_gauge("obs.trace.ring_high_water", _trace.high_water())
        if dropped and not _drop_warned:
            _drop_warned = True
            warnings.warn(
                f"trace ring buffer dropped {dropped} span(s) before this export — the trace is"
                " partial; raise TM_TPU_TRACE_BUFFER (or trace.configure) to keep the full profile",
                RuntimeWarning,
                stacklevel=2,
            )
    snap = _counters.snapshot() if counter_snapshot is None else counter_snapshot
    meta = {
        "type": "meta",
        "dropped": dropped,
        "epoch_ns": time.time_ns(),
        "mono_ns": time.perf_counter_ns(),
        "pid": os.getpid(),
    }
    if rank is not None:
        meta["rank"] = rank
    with open(path, "w") as fh:
        for event in events:
            fh.write(json.dumps(event, separators=(",", ":")) + "\n")
        fh.write(json.dumps({"type": "counters", **snap}, separators=(",", ":")) + "\n")
        fh.write(json.dumps(meta, separators=(",", ":")) + "\n")


def read_jsonl(path: str) -> Tuple[List[Dict[str, Any]], Dict[str, Any], Dict[str, Any], Dict[str, Any]]:
    """Parse a :func:`write_jsonl` file -> (events, counters, gauges, meta)."""
    events: List[Dict[str, Any]] = []
    counters: Dict[str, Any] = {}
    gauges: Dict[str, Any] = {}
    meta: Dict[str, Any] = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            record = json.loads(line)
            kind = record.get("type")
            if kind in ("span", "instant"):
                events.append(record)
            elif kind == "counters":
                counters = record.get("counters", {})
                gauges = record.get("gauges", {})
            elif kind == "meta":
                meta = {k: v for k, v in record.items() if k != "type"}
    return events, counters, gauges, meta


def to_chrome_trace(events: Optional[List[Dict[str, Any]]] = None,
                    counter_snapshot: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The recording as a ``chrome://tracing`` JSON object."""
    events = _trace.get_trace() if events is None else events
    snap = _counters.snapshot() if counter_snapshot is None else counter_snapshot
    pid = os.getpid()
    trace_events = []
    for event in events:
        out = {
            "name": event["name"],
            "cat": "tm_tpu",
            "ph": "X" if event.get("type") == "span" else "i",
            # Catapult timestamps are microseconds; the buffer records ns
            "ts": event["ts"] / 1000.0,
            "pid": pid,
            "tid": event.get("tid", 0),
        }
        if out["ph"] == "X":
            out["dur"] = event.get("dur", 0) / 1000.0
        else:
            out["s"] = "t"  # instant scoped to its thread
        if event.get("args"):
            out["args"] = event["args"]
        trace_events.append(out)
    return {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {"counters": snap.get("counters", {}), "gauges": snap.get("gauges", {})},
    }


def write_chrome_trace(path: str, events: Optional[List[Dict[str, Any]]] = None,
                       counter_snapshot: Optional[Dict[str, Any]] = None) -> None:
    with open(path, "w") as fh:
        json.dump(to_chrome_trace(events, counter_snapshot), fh, indent=1)


# ----------------------------------------------------------------- summary


def render_table(rows: Sequence[Tuple[str, ...]]) -> List[str]:
    """Column-aligned text lines for a header + data rows, with a dash rule
    under the header — THE table renderer every obs/CLI view shares
    (``summary``, ``diff``, ``xla``, ``watch``)."""
    widths = [max(len(row[i]) for row in rows) for i in range(len(rows[0]))]
    lines = []
    for i, row in enumerate(rows):
        lines.append("  ".join(cell.ljust(widths[j]) for j, cell in enumerate(row)).rstrip())
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return lines


def _percentile(sorted_ns: Sequence[int], q: float) -> float:
    """Nearest-rank percentile over a pre-sorted duration list (ns)."""
    idx = min(len(sorted_ns) - 1, max(0, int(round(q * (len(sorted_ns) - 1)))))
    return float(sorted_ns[idx])


def fmt_num(value: Optional[float], pattern: str = "{:.3f}") -> str:
    """None-safe cell formatter for the CLI tables: ``-`` when absent."""
    return "-" if value is None else pattern.format(value)


def _direct_child_ns(events: List[Dict[str, Any]]) -> Dict[int, int]:
    """Summed duration of each span's DIRECT children, keyed by ``id(event)``.

    Containment is per-thread and interval-based (a child starts at or after
    its parent and ends no later), resolved with one sorted sweep per thread
    — the stack invariant mirrors how spans actually nest at record time.
    Only same-thread nesting counts: a bounded sync's daemon worker records
    under its own tid, so the parent ``metric.sync`` span keeps that wall
    time as self (it IS the parent's wall time — the host thread is blocked).
    """
    by_tid: Dict[Any, List[Dict[str, Any]]] = {}
    for event in events:
        if event.get("type") == "span":
            by_tid.setdefault(event.get("tid", 0), []).append(event)
    child_ns: Dict[int, int] = {}
    for spans in by_tid.values():
        # parents sort before equal-start children via the longer duration
        spans.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack: List[Tuple[Dict[str, Any], int]] = []  # (event, end_ts)
        for event in spans:
            end = event["ts"] + event.get("dur", 0)
            while stack and event["ts"] >= stack[-1][1]:
                stack.pop()
            if stack:
                parent = stack[-1][0]
                child_ns[id(parent)] = child_ns.get(id(parent), 0) + event.get("dur", 0)
            stack.append((event, end))
    return child_ns


def aggregate(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Aggregate span events into per-(metric, span-name) rows.

    The grouping key is the span's ``metric`` arg (instrumented spans tag the
    metric class; untagged spans group under ``"-"``). Rows carry count,
    total/mean duration, **exclusive self-time** (direct-child span time
    subtracted, so a ``collection.group_update`` wrapping member updates and
    a ``forward`` wrapping update+compute stop double-counting in totals)
    plus the p50/p95/max distribution in ms (a mean hides the recompile/
    straggler tail the distribution exists to show), sorted by total time
    descending.
    """
    child_ns_by_event = _direct_child_ns(events)
    stats: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for event in events:
        if event.get("type") != "span":
            continue
        args = event.get("args") or {}
        key = (str(args.get("metric", "-")), event["name"])
        row = stats.get(key)
        if row is None:
            row = stats[key] = {"metric": key[0], "span": key[1], "durs_ns": [], "self_ns": 0}
        dur = event.get("dur", 0)
        row["durs_ns"].append(dur)
        row["self_ns"] += max(0, dur - child_ns_by_event.get(id(event), 0))
    rows = []
    for row in stats.values():
        durs = sorted(row["durs_ns"])
        total_ns = sum(durs)
        rows.append(
            {
                "metric": row["metric"],
                "span": row["span"],
                "count": len(durs),
                "total_ms": total_ns / 1e6,
                "self_ms": row["self_ns"] / 1e6,
                "mean_ms": total_ns / len(durs) / 1e6,
                "p50_ms": _percentile(durs, 0.50) / 1e6,
                "p95_ms": _percentile(durs, 0.95) / 1e6,
                "max_ms": durs[-1] / 1e6,
            }
        )
    rows.sort(key=lambda r: (-r["total_ms"], r["metric"], r["span"]))
    return rows


def diff_aggregates(
    rows_a: List[Dict[str, Any]], rows_b: List[Dict[str, Any]]
) -> List[Dict[str, Any]]:
    """Span-level regression diff between two :func:`aggregate` outputs.

    Joins on ``(metric, span)``. Each joined row carries both sides' count/
    p50/p95 plus signed percentage deltas (``b`` relative to ``a`` — positive
    means ``b`` is slower); rows present on one side only get ``status``
    ``"added"``/``"removed"`` with null deltas, so a diff surfaces a span
    that disappeared (instrumentation drift) as loudly as one that slowed.
    Sorted by worst regression first.
    """
    by_key_a = {(r["metric"], r["span"]): r for r in rows_a}
    by_key_b = {(r["metric"], r["span"]): r for r in rows_b}

    def _delta_pct(a: float, b: float) -> Optional[float]:
        if a <= 0:
            return None  # zero-duration base: a ratio would be meaningless
        return (b - a) / a * 100.0

    rows = []
    for key in sorted(set(by_key_a) | set(by_key_b)):
        a, b = by_key_a.get(key), by_key_b.get(key)
        row: Dict[str, Any] = {"metric": key[0], "span": key[1]}
        if a is None or b is None:
            row.update(
                status="added" if a is None else "removed",
                count_a=a["count"] if a else None, count_b=b["count"] if b else None,
                p50_a_ms=a["p50_ms"] if a else None, p50_b_ms=b["p50_ms"] if b else None,
                p95_a_ms=a["p95_ms"] if a else None, p95_b_ms=b["p95_ms"] if b else None,
                p50_delta_pct=None, p95_delta_pct=None,
            )
        else:
            row.update(
                status="common",
                count_a=a["count"], count_b=b["count"],
                p50_a_ms=a["p50_ms"], p50_b_ms=b["p50_ms"],
                p95_a_ms=a["p95_ms"], p95_b_ms=b["p95_ms"],
                p50_delta_pct=_delta_pct(a["p50_ms"], b["p50_ms"]),
                p95_delta_pct=_delta_pct(a["p95_ms"], b["p95_ms"]),
            )
        rows.append(row)
    rows.sort(
        key=lambda r: -max(r["p50_delta_pct"] or float("-inf"), r["p95_delta_pct"] or float("-inf"))
        if r["status"] == "common" else float("inf")
    )
    return rows


def format_diff_table(rows: List[Dict[str, Any]], fail_on_regress_pct: Optional[float] = None) -> Tuple[str, List[Dict[str, Any]]]:
    """Render a :func:`diff_aggregates` result; returns ``(text, regressions)``
    where ``regressions`` are the common rows whose p50 OR p95 delta exceeds
    ``fail_on_regress_pct`` (empty when no threshold given) — the CI gate
    ``metricscope diff --fail-on-regress`` exits non-zero on."""
    header = ("metric", "span", "count", "p50_a_ms", "p50_b_ms", "p50_Δ%", "p95_a_ms", "p95_b_ms", "p95_Δ%", "status")

    def _fmt(v: Optional[float], pattern: str = "{:.3f}") -> str:
        return "-" if v is None else pattern.format(v)

    regressions = []
    table = [header]
    for r in rows:
        regressed = (
            fail_on_regress_pct is not None
            and r["status"] == "common"
            and max(r["p50_delta_pct"] or float("-inf"), r["p95_delta_pct"] or float("-inf")) > fail_on_regress_pct
        )
        if regressed:
            regressions.append(r)
        count = f"{r['count_a'] if r['count_a'] is not None else '-'}/{r['count_b'] if r['count_b'] is not None else '-'}"
        table.append((
            r["metric"], r["span"], count,
            _fmt(r["p50_a_ms"]), _fmt(r["p50_b_ms"]), _fmt(r["p50_delta_pct"], "{:+.1f}"),
            _fmt(r["p95_a_ms"]), _fmt(r["p95_b_ms"]), _fmt(r["p95_delta_pct"], "{:+.1f}"),
            r["status"] + (" REGRESSED" if regressed else ""),
        ))
    lines = render_table(table)
    if fail_on_regress_pct is not None:
        lines.append("")
        if regressions:
            worst = ", ".join(
                f"{r['metric']}/{r['span']} "
                f"(+{max(r['p50_delta_pct'] or float('-inf'), r['p95_delta_pct'] or float('-inf')):.1f}%)"
                for r in regressions[:5]
            )
            lines.append(f"FAIL: {len(regressions)} span(s) regressed beyond {fail_on_regress_pct:.1f}%: {worst}")
        else:
            lines.append(f"OK: no span regressed beyond {fail_on_regress_pct:.1f}%")
    return "\n".join(lines), regressions


def summarize(events: List[Dict[str, Any]], counters: Optional[Dict[str, Any]] = None,
              gauges: Optional[Dict[str, Any]] = None, dropped: int = 0) -> str:
    """Render the per-metric/per-phase summary table plus counters as text.

    A nonzero ``dropped`` (the ring buffer discarded that many oldest events)
    is surfaced up front AND restated in the footer — a truncated profile
    must not read as complete.
    """
    rows = aggregate(events)
    header = ("metric", "span", "count", "total_ms", "self_ms", "mean_ms", "p50_ms", "p95_ms", "max_ms")
    table = [header] + [
        (r["metric"], r["span"], str(r["count"]), f"{r['total_ms']:.3f}", f"{r['self_ms']:.3f}",
         f"{r['mean_ms']:.3f}", f"{r['p50_ms']:.3f}", f"{r['p95_ms']:.3f}", f"{r['max_ms']:.3f}")
        for r in rows
    ]
    lines = []
    if dropped:
        lines.append(f"WARNING: {dropped} event(s) dropped by the bounded ring buffer — totals are partial"
                     " (raise TM_TPU_TRACE_BUFFER)")
        lines.append("")
    lines.extend(render_table(table))
    if not rows:
        lines.append("(no spans recorded)")

    instants = [e for e in events if e.get("type") == "instant"]
    if instants:
        lines.append("")
        lines.append("events:")
        for event in instants:
            args = event.get("args") or {}
            detail = " ".join(f"{k}={v}" for k, v in args.items())
            lines.append(f"  {event['name']}" + (f"  {detail}" if detail else ""))

    counters = counters or {}
    gauges = gauges or {}
    if counters or gauges:
        lines.append("")
        lines.append("counters:")
        for name in sorted(counters):
            lines.append(f"  {name} = {counters[name]}")
        for name in sorted(gauges):
            lines.append(f"  {name} = {gauges[name]} (gauge)")
    if dropped:
        lines.append("")
        lines.append(f"ring buffer dropped = {dropped} event(s) — totals above are partial")
    return "\n".join(lines)
