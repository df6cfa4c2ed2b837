# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""``torchmetrics_tpu_torch.obs`` — opt-in, near-zero-overhead-when-disabled
observability: nestable spans into a bounded ring buffer
(:mod:`~torchmetrics_tpu_torch.obs.trace`), named monotonic counters and gauges
(:mod:`~torchmetrics_tpu_torch.obs.counters`), JSON-lines / Chrome-trace export,
per-metric summaries and span-level trace diffs
(:mod:`~torchmetrics_tpu_torch.obs.export`), and the live plane — a background
status/OpenMetrics publisher with health derivation
(:mod:`~torchmetrics_tpu_torch.obs.live`, :mod:`~torchmetrics_tpu_torch.obs.openmetrics`).

Quick start::

    from torchmetrics_tpu_torch import obs

    with obs.tracing():
        metric.update(preds, target)
        metric.compute()
    obs.write_jsonl("/tmp/metrics.trace.jsonl")
    # then: python tools/metricscope.py summary /tmp/metrics.trace.jsonl

Or set ``TM_TPU_TRACE=1`` in the environment to trace the whole process.
The modules of this package import neither torch nor jax, so tooling can
load them by path without paying the library import. They write the JAX
package's formats under its span, counter and gauge names: a trace of
either package reads in the other's ``read_jsonl``, in
``tools/metricscope.py`` and in :func:`merge_traces`.
"""
from . import attribution as attribution
from . import benchhist as benchhist
from . import counters as _counters_mod
from . import live as live
from . import openmetrics as openmetrics
from . import trace as _trace_mod
from . import xla as _xla_mod
from .attribution import build_ledger, load_ledger, read_costs, write_costs
from .counters import clear as counter_clear
from .counters import get as counter_get
from .counters import inc as counter_inc
from .counters import set_gauge, snapshot
from .export import (
    aggregate,
    diff_aggregates,
    format_diff_table,
    read_jsonl,
    summarize,
    to_chrome_trace,
    write_chrome_trace,
    write_jsonl,
)
from .live import publishing
from .merge import merge_traces, write_merged_chrome_trace
from .trace import (
    configure,
    disable,
    dropped_events,
    enable,
    get_trace,
    high_water,
    instant,
    is_enabled,
    span,
    tracing,
)
from .xla import compile_rows, format_compile_table
from .xla import records as xla_records

# NOTE: torchmetrics_tpu_torch.obs.device (the in-graph telemetry plane) is NOT
# imported here — it builds torch programs and therefore imports torch, while
# this package's modules stay importable standalone. Reach it explicitly:
# ``from torchmetrics_tpu_torch.obs import device``.

def clear() -> None:
    """Reset the whole recorder: span ring buffer, counters/gauges, the
    xla compile-record registry AND the cost-attribution registry — the
    manual ``enable()``/``disable()`` flow's analogue of what ``tracing()``
    clears on entry. Use ``trace.clear()``/``counter_clear()`` for one side."""
    _trace_mod.clear()
    _counters_mod.clear()
    _xla_mod.clear_records()
    attribution.clear()


__all__ = [
    "aggregate",
    "attribution",
    "benchhist",
    "build_ledger",
    "clear",
    "compile_rows",
    "configure",
    "counter_clear",
    "counter_get",
    "counter_inc",
    "diff_aggregates",
    "disable",
    "dropped_events",
    "enable",
    "format_compile_table",
    "format_diff_table",
    "get_trace",
    "high_water",
    "instant",
    "is_enabled",
    "live",
    "load_ledger",
    "merge_traces",
    "openmetrics",
    "publishing",
    "read_costs",
    "read_jsonl",
    "set_gauge",
    "snapshot",
    "span",
    "summarize",
    "to_chrome_trace",
    "tracing",
    "write_chrome_trace",
    "write_costs",
    "write_jsonl",
    "write_merged_chrome_trace",
    "xla_records",
]
