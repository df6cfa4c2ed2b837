# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Step-build observability: the warm-up, the CUDA graph capture and the
first replay of a captured step, timed (counterpart of
``torchmetrics_tpu/obs/xla.py``; the name is kept so ``compile_rows``,
``records`` and ``format_compile_table`` keep their home).

JAX's ``jit`` hides trace, lowering, XLA compilation and the first execution
inside the first call, and the JAX module splits them. The port builds a
step differently: a fused plan, a sliced plan or a ``make_jit_update`` step
runs its step once eagerly on a side stream (the warm-up: it builds the hand
kernels with ``nvcc`` on a cold process and fills their launch caches), then
captures it into a CUDA graph, then replays the graph. With tracing enabled
those three stages get the JAX module's spans and record schema:

- ``<prefix>.lower``: the eager warm-up, host wall time;
- ``<prefix>.compile``: the graph capture, host wall time (``torch.cuda.graph``
  synchronises the device on entry), its span tagged with ``lower_ms`` and
  ``compile_ms``;
- ``<prefix>.first_step``: the first replay, host wall time of the launch
  (the replay runs asynchronously: the span times the launch, not the device).

Every record is keyed by the owner's build fingerprint. The card offers no
counterpart of XLA's ``cost_analysis``/``memory_analysis``: ``flops``,
``bytes_accessed``, ``temp_bytes``, ``argument_bytes``, ``output_bytes`` and
``code_bytes`` stay ``None``, which ``compile_rows`` and ``metricscope xla``
read as "the backend would not say". With tracing disabled the capture path
is the plain one: no span, no record, no extra work.

This module imports neither torch nor jax (the obs package stays loadable by
path); the captures it times are handed in as callables.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import counters as _counters
from . import trace as _trace
from .export import fmt_num as _fmt, render_table

_lock = threading.Lock()
_records: List[Dict[str, Any]] = []

#: the record fields the card cannot fill (JAX's cost and memory analysis)
_NO_ANALYSIS: Dict[str, Optional[float]] = {
    "flops": None, "bytes_accessed": None, "temp_bytes": None,
    "argument_bytes": None, "output_bytes": None, "code_bytes": None,
}


def records() -> List[Dict[str, Any]]:
    """Point-in-time copy of every capture record taken this process."""
    with _lock:
        return [dict(r) for r in _records]


def clear_records() -> None:
    with _lock:
        _records.clear()


# ------------------------------------------------------------------- capture


def timed_capture(
    warm: Callable[[], Any],
    capture: Callable[[], Any],
    *,
    key: str,
    metric: str,
    kind: str,
    span_prefix: str,
) -> Tuple[Any, Optional[Dict[str, Any]]]:
    """Run a step's warm-up, then its capture, timing each stage.

    Returns ``(what capture returned, the record)``. With tracing disabled
    the two callables just run, and the record is ``None``. With tracing on
    the ``<span_prefix>.lower`` and ``<span_prefix>.compile`` spans are
    recorded (the compile span carries both times in its args, so the record
    rides any JSONL or Chrome export) and the record joins the in-process
    registry. A failing stage raises, as the untimed path does.
    """
    if not _trace.ENABLED:
        warm()
        return capture(), None
    with _trace.span(f"{span_prefix}.lower", xla_key=key, metric=metric, kind=kind):
        t0 = time.perf_counter_ns()
        warm()
        lower_ns = time.perf_counter_ns() - t0
    compile_span = _trace.span(f"{span_prefix}.compile", xla_key=key, metric=metric, kind=kind)
    with compile_span:
        t0 = time.perf_counter_ns()
        out = capture()
        compile_ns = time.perf_counter_ns() - t0
        compile_span.args.update(lower_ms=lower_ns / 1e6, compile_ms=compile_ns / 1e6)
    record = {"key": key, "metric": metric, "kind": kind, "lower_ms": lower_ns / 1e6, "compile_ms": compile_ns / 1e6, **_NO_ANALYSIS}
    with _lock:
        _records.append(record)
    _counters.inc("xla.compile")
    _counters.set_gauge("xla.compile.last_ms", record["compile_ms"])
    return out, record


def first_step(key: str, metric: str, span_prefix: str) -> Any:
    """The ``<span_prefix>.first_step`` span around a step's first replay
    (call under ``if trace.ENABLED:``)."""
    return _trace.span(f"{span_prefix}.first_step", xla_key=key, metric=metric)


# -------------------------------------------------------------- CLI rendering


def compile_rows(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Extract compile records from exported span events, one row per capture,
    ranked by estimated device cost (flops, then bytes accessed, then compile
    time — the best signal the backend offered), most expensive first. Rows
    join in the matching ``*.first_step`` execution time by capture key."""
    first_step_ms: Dict[str, float] = {}
    for event in events:
        args = event.get("args") or {}
        if event.get("type") == "span" and "xla_key" in args and event["name"].endswith(".first_step"):
            first_step_ms[args["xla_key"]] = event.get("dur", 0) / 1e6
    rows = []
    for event in events:
        args = event.get("args") or {}
        if event.get("type") != "span" or "xla_key" not in args or not event["name"].endswith(".compile"):
            continue
        rows.append(
            {
                "key": args["xla_key"],
                "metric": args.get("metric", "-"),
                "kind": args.get("kind", "-"),
                "lower_ms": args.get("lower_ms"),
                "compile_ms": args.get("compile_ms", event.get("dur", 0) / 1e6),
                "flops": args.get("flops"),
                "bytes_accessed": args.get("bytes_accessed"),
                "temp_bytes": args.get("temp_bytes"),
                "first_step_ms": first_step_ms.get(args["xla_key"]),
            }
        )
    rows.sort(
        key=lambda r: (
            -(r["flops"] if r["flops"] is not None else -1.0),
            -(r["bytes_accessed"] if r["bytes_accessed"] is not None else -1.0),
            -(r["compile_ms"] or 0.0),
        )
    )
    return rows


def format_compile_table(rows: List[Dict[str, Any]]) -> str:
    """Render :func:`compile_rows` as the ``metricscope xla`` table."""
    if not rows:
        return "(no xla compile records in this trace — record with TM_TPU_TRACE=1 and a cold compiled step)"
    header = ("rank", "metric", "kind", "key", "compile_ms", "lower_ms", "first_step_ms", "mflops", "mbytes")
    table = [header]
    for i, row in enumerate(rows):
        table.append(
            (
                str(i + 1),
                row["metric"],
                row["kind"],
                row["key"][:16],
                _fmt(row["compile_ms"]),
                _fmt(row["lower_ms"]),
                _fmt(row["first_step_ms"]),
                _fmt(None if row["flops"] is None else row["flops"] / 1e6),
                _fmt(None if row["bytes_accessed"] is None else row["bytes_accessed"] / 1e6),
            )
        )
    lines = render_table(table)
    lines.append("")
    lines.append("ranked by estimated device cost: flops, then bytes accessed, then compile time")
    return "\n".join(lines)
