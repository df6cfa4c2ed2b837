# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Multi-rank trace merge: N per-rank JSONL traces -> one Chrome/Perfetto timeline.

The span recorder stamps events with ``time.perf_counter_ns()`` — a
monotonic clock whose origin is arbitrary PER PROCESS, so two ranks' raw
timestamps are incomparable. :func:`~torchmetrics_tpu_torch.obs.export.write_jsonl`
therefore anchors every trace file with an export epoch in its meta line:
``epoch_ns`` (wall clock) and ``mono_ns`` (the monotonic clock at the same
instant). ``aligned_wall_ns = ts + (epoch_ns - mono_ns)`` maps any event in
that file onto the shared wall clock — accurate to the hosts' wall-clock
agreement (NTP-level on one machine's process group, exactly what the
two-process sync scenarios are).

:func:`merge_traces` aligns every file this way, rebases to the earliest
event, and emits ONE Chrome trace with ``pid = rank`` (from the file's meta
line when the exporter recorded one, else the file's position), so the
multi-process runs render as one readable timeline in ``chrome://tracing`` /
https://ui.perfetto.dev, one process lane per rank. Files exported by an
older build (no epoch anchor) are kept but rebased to their own first event
and flagged ``unaligned`` in ``otherData``.

Standalone (imports neither torch nor jax): ``tools/metricscope.py merge`` loads this via
the obs package without paying the library import.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

from .export import read_jsonl


def merge_traces(paths: Sequence[str], ranks: Optional[Sequence[int]] = None) -> Dict[str, Any]:
    """Merge per-rank JSONL trace files into one Chrome trace object.

    ``ranks`` overrides the pid assigned to each file; default is the file's
    own ``meta["rank"]`` when present, else its position in ``paths``.
    """
    if not paths:
        raise ValueError("merge_traces needs at least one trace file")
    loaded = []
    for pos, path in enumerate(paths):
        events, counters, gauges, meta = read_jsonl(path)
        rank = ranks[pos] if ranks is not None else meta.get("rank", pos)
        offset = None  # monotonic -> wall-clock offset, ns
        if "epoch_ns" in meta and "mono_ns" in meta:
            offset = meta["epoch_ns"] - meta["mono_ns"]
        loaded.append({"path": path, "rank": rank, "events": events, "counters": counters,
                       "gauges": gauges, "meta": meta, "offset": offset})

    # rebase the merged timeline to the earliest ALIGNED start — scanned over
    # ALL events: the ring buffer is completion-ordered, so the earliest-
    # starting (outermost) span is typically recorded LAST, not first
    aligned_starts = [
        e["ts"] + f["offset"] for f in loaded if f["offset"] is not None for e in f["events"]
    ]
    t0 = min(aligned_starts) if aligned_starts else 0

    trace_events: List[Dict[str, Any]] = []
    unaligned: List[str] = []
    per_rank: Dict[str, Any] = {}
    for f in loaded:
        rank = f["rank"]
        trace_events.append(
            {"name": "process_name", "ph": "M", "pid": rank, "tid": 0,
             "args": {"name": f"rank {rank} ({f['path']})"}}
        )
        if f["offset"] is not None:
            base = f["offset"] - t0  # ns added to every event's monotonic ts
        else:
            unaligned.append(f["path"])
            # no epoch anchor: rebase this lane to its own earliest start
            base = -min(e["ts"] for e in f["events"]) if f["events"] else 0
        for event in f["events"]:
            out = {
                "name": event["name"],
                "cat": "tm_tpu",
                "ph": "X" if event.get("type") == "span" else "i",
                "ts": (event["ts"] + base) / 1000.0,  # ns -> us
                "pid": rank,
                "tid": event.get("tid", 0),
            }
            if out["ph"] == "X":
                out["dur"] = event.get("dur", 0) / 1000.0
            else:
                out["s"] = "t"
            if event.get("args"):
                out["args"] = event["args"]
            trace_events.append(out)
        per_rank[str(rank)] = {
            "path": f["path"],
            "events": len(f["events"]),
            "dropped": f["meta"].get("dropped", 0),
            "counters": f["counters"],
            "gauges": f["gauges"],
        }

    other: Dict[str, Any] = {"ranks": per_rank}
    if unaligned:
        other["unaligned"] = unaligned  # no epoch anchor: lanes not clock-comparable
    return {"traceEvents": trace_events, "displayTimeUnit": "ms", "otherData": other}


def write_merged_chrome_trace(
    out_path: str, paths: Sequence[str], ranks: Optional[Sequence[int]] = None
) -> Dict[str, Any]:
    """:func:`merge_traces` + write; returns the merged object for callers."""
    merged = merge_traces(paths, ranks=ranks)
    with open(out_path, "w") as fh:
        json.dump(merged, fh, indent=1)
    return merged
