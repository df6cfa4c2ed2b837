# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Cost attribution: one ledger joining every telemetry plane per metric.

PRs 3/6/7 each answer one question — where did host time go (spans), what
does the compiled step cost the device (XLA records), is the run alive
(live plane). Answering the question that gates kernel work — *which metric
is the expensive one, and is it host time, device flops, compile time,
state memory, or sync bytes?* — previously required joining trace files,
``obs.xla_records()`` and bench JSON by hand. This module does the join:

- :func:`build_ledger` — a PURE, torch-free function that folds span
  aggregates (update/compute/sync with p50/p95 and exclusive self-time),
  XLA compile records (flops, bytes accessed, compile/lower wall time,
  keyed by build fingerprint), ``StateSpec``-shaped state-memory bytes,
  sync payload bytes and checkpoint snapshot bytes into one
  self-describing ledger dict, one row per metric class;
- :func:`write_costs` — emits the ledger as a ``costs.json`` artifact from
  the live recorders. Producers call :func:`metric_boundary` at the
  sanctioned host-sync boundaries (``compute()``/``sync()``/runner
  snapshots) — the same places device telemetry drains — to publish the
  ``metric.<Class>.state_bytes`` gauge and fold per-state byte detail into
  an in-process registry; with ``TM_TPU_COSTS=<path>`` set the ledger is
  (re)written at every top-level ``compute()`` / ``MetricCollection``
  compute / ``StreamingEvaluator`` end, newest-wins;
- ``tools/metricscope.py top`` — ranks the ledger by a chosen cost column
  (host self-time, device flops, bytes, state bytes, ...) with a
  ``--explain <Metric>`` drill-down: the concrete input for picking hand
  kernel targets (ROADMAP §B). In the port the "XLA records" are the
  capture records of :mod:`~torchmetrics_tpu_torch.obs.xla`: their compile
  and first-step times fill the ledger, and the device flops and bytes
  columns stay empty (the card has no cost analysis to read).

**Disabled-path contract.** Every producer site is behind the usual
``trace.ENABLED``/``live.ENABLED`` flag check; with both off nothing here
runs, nothing allocates, and no file is ever written — the same discipline
as every other obs plane (tier-1 pins it).

**Join key.** Rows key on the metric CLASS name — the tag every span and
XLA record already carries. Collection member names ride along as
``instances`` (noted at collection compute), and per-state byte detail is
captured only by the in-process registry: a ledger rebuilt offline from a
trace file carries the per-class totals (the gauges ride the trace's
counter line) but not the per-state split.

Standalone (stdlib only, imports neither torch nor jax) like the rest of the obs package.
"""
from __future__ import annotations

import json
import os
import threading
import time
import weakref
from contextlib import contextmanager
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

from . import counters as _counters
from . import trace as _trace
from .export import aggregate, fmt_num as _fmt, read_jsonl, render_table
from .xla import compile_rows

#: layout version of the costs.json artifact (schema-pinned in tier-1)
COSTS_VERSION = 1

#: rankable ledger columns -> how ``metricscope top`` describes them. The
#: ledger embeds this table so a costs.json is self-describing.
TOP_COLUMNS: Dict[str, str] = {
    "host_self_ms": "host wall time inside this metric's spans, child spans excluded (exclusive self-time)",
    "host_total_ms": "host wall time inside this metric's spans, children included",
    "updates": "update events observed (span count of metric.update)",
    "device_flops": "XLA cost-analysis flops summed over this metric's compiled-step builds",
    "device_bytes": "XLA cost-analysis bytes accessed summed over this metric's compiled-step builds",
    "compile_ms": "XLA compile wall time summed over this metric's compiled-step builds",
    "state_bytes": (
        "bytes held by the metric's registered states at the last snapshot boundary"
        " (a compute-group-shared array counts in each sharing class; the run-level"
        " state_bytes_total dedups)"
    ),
    "sync_bytes": "bytes this rank contributed to the last cross-process state gather",
}

# emission path for the automatic costs.json artifact; like TM_TPU_TRACE the
# env var is read once at import, configure_costs() overrides at runtime
_COSTS_PATH: Optional[str] = os.environ.get("TM_TPU_COSTS") or None

_lock = threading.Lock()
#: class name -> {"instances": set, "by_instance": {id: per-instance slot}}.
#: Rows join on the CLASS (the span/XLA tag), but state/sync bytes and update
#: counts accumulate per live INSTANCE underneath — two ConfusionMatrix
#: members must SUM, not overwrite each other. Each slot holds a weakref to
#: its metric; dead slots are pruned lazily at the next touch of the row
#: (NOT via a ``weakref.finalize`` callback: a GC-triggered callback taking
#: the non-reentrant lock on a thread already holding it would deadlock), so
#: short-lived metrics never ghost-inflate the class totals.
_registry: Dict[str, Dict[str, Any]] = {}


def _new_row() -> Dict[str, Any]:
    return {"instances": set(), "by_instance": {}}


def _prune_row(row: Dict[str, Any]) -> None:
    """Drop slots whose metric has been garbage-collected (caller holds the
    lock)."""
    by_instance = row["by_instance"]
    dead = [key for key, slot in by_instance.items() if slot["ref"]() is None]
    for key in dead:
        del by_instance[key]


def _instance_slot(metric: Any) -> Dict[str, Any]:
    """The per-instance accumulation slot for ``metric`` (caller holds the
    lock). Created on first use; dead siblings are pruned on the way."""
    cls = type(metric).__name__
    row = _registry.get(cls)
    if row is None:
        row = _registry[cls] = _new_row()
    _prune_row(row)
    key = id(metric)
    slot = row["by_instance"].get(key)
    if slot is None:
        slot = row["by_instance"][key] = {
            "ref": weakref.ref(metric), "state_bytes": {}, "leaf_bytes": {},
            "sync_bytes": None, "updates": 0,
        }
    return slot


def _add_leaf_entries(table: Dict[Any, Tuple[Any, int]], slot: Dict[Any, Any], name: str, leaves: Any) -> None:
    """Add one state's leaves to a leaf-byte table, keyed so that SHARED
    leaves dedup across slots: array leaves key by object identity
    (compute-group members referencing the same tp/fp arrays collapse to one
    entry in the global sum), scalar/non-weakref-able leaves by a
    slot-unique key (never shared). Each array entry carries a weakref to
    its leaf — an ``id()`` is only meaningful while the object lives, so the
    global sum validates liveness before trusting a key (a freed array's id
    can be REUSED by a new allocation; without the check two unrelated
    arrays would merge as "shared")."""
    for i, leaf in enumerate(leaves):
        nbytes = getattr(leaf, "nbytes", None)
        if nbytes is not None:
            try:
                ref = weakref.ref(leaf)
            except TypeError:  # not weakref-able: slot-unique, no dedup
                table[(id(slot), name, i)] = (None, int(nbytes))
            else:
                table[id(leaf)] = (ref, int(nbytes))
        else:
            scalar_bytes = _leaf_nbytes(leaf)
            if scalar_bytes:
                table[(id(slot), name, i)] = (None, scalar_bytes)


def _leaf_byte_table(metric: Any, slot: Dict[Any, Any]) -> Dict[Any, Tuple[Any, int]]:
    """The leaf-byte table over a metric's registered states (see
    :func:`_add_leaf_entries` for the dedup keying)."""
    table: Dict[Any, Tuple[Any, int]] = {}
    for name in metric._defaults:
        _add_leaf_entries(table, slot, name, _state_leaves(getattr(metric, name)))
    return table


def _global_state_bytes_locked() -> int:
    """Deduplicated whole-process state footprint (caller holds the lock):
    the union of every live slot's leaf table, shared arrays counted once.
    Entries whose leaf has been freed since that slot's last boundary are
    skipped — their id may already belong to someone else."""
    seen: Dict[Any, int] = {}
    for row in _registry.values():
        for slot in row["by_instance"].values():
            for key, (ref, nbytes) in slot["leaf_bytes"].items():
                if ref is not None and ref() is None:
                    continue
                seen[key] = nbytes
    return sum(seen.values())


def configure_costs(path: Optional[str]) -> None:
    """Set (or, with ``None``, clear) the automatic ``costs.json`` emission
    path — the runtime analogue of ``TM_TPU_COSTS``."""
    global _COSTS_PATH
    _COSTS_PATH = path


def costs_path() -> Optional[str]:
    return _COSTS_PATH


def clear() -> None:
    """Reset the in-process attribution registry (instances + state bytes)."""
    with _lock:
        _registry.clear()


def registry_rows() -> Dict[str, Dict[str, Any]]:
    """Point-in-time per-class view of the registry (tests/diagnostics and
    the ledger): instance names, update counts summed across live instances,
    the per-state byte split summed across live instances, and the summed
    sync payload (``None`` until any instance gathers)."""
    with _lock:
        out: Dict[str, Dict[str, Any]] = {}
        for cls, row in _registry.items():
            _prune_row(row)
            slots = list(row["by_instance"].values())
            state_bytes: Dict[str, int] = {}
            for slot in slots:
                for name, nbytes in slot["state_bytes"].items():
                    state_bytes[name] = state_bytes.get(name, 0) + nbytes
            syncs = [slot["sync_bytes"] for slot in slots if slot["sync_bytes"] is not None]
            out[cls] = {
                "instances": sorted(row["instances"]),
                "updates": sum(slot["updates"] for slot in slots),
                "state_bytes": state_bytes,
                "sync_bytes": sum(syncs) if syncs else None,
            }
        return out


# -------------------------------------------------------------- state bytes


def _leaf_nbytes(leaf: Any) -> int:
    """Bytes held by one state leaf. jnp/np arrays expose ``nbytes`` as
    metadata (no device transfer); plain Python scalars count as 8."""
    nbytes = getattr(leaf, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    if isinstance(leaf, (bool, int, float, complex)):
        return 8
    return 0


def _state_leaves(value: Any) -> List[Any]:
    if isinstance(value, list):
        return list(value)
    if isinstance(value, tuple) and hasattr(value, "_fields"):  # sketch pytree
        return list(value)
    return [value]


def _state_nbytes(value: Any) -> int:
    return sum(_leaf_nbytes(v) for v in _state_leaves(value))


def state_byte_sizes(metric: Any) -> Dict[str, int]:
    """Per-state byte footprint of a metric's LIVE states, shaped by the
    ``StateSpec`` kinds: arrays count ``nbytes``, list ("cat") states the sum
    over their chunks — so a growing cat state is reported at its real size,
    not its empty default — and merge (sketch) states the sum over their
    fixed-shape leaves. Duck-typed over the ``add_state`` registry; no torch.
    """
    return {name: _state_nbytes(getattr(metric, name)) for name in metric._defaults}


def note_instance(cls_name: str, member_name: str) -> None:
    """Record that collection member ``member_name`` is an instance of
    ``cls_name`` — ledger rows carry the names next to the class join key."""
    with _lock:
        row = _registry.get(cls_name)
        if row is None:
            row = _registry[cls_name] = _new_row()
        row["instances"].add(member_name)


def note_instances(cls_name: str, member_names: Iterable[str]) -> None:
    """Batch :func:`note_instance` — the fused evaluation plane files its
    compile/flops records under the COLLECTION class (the tag its one
    compiled step carries), and this pins the member names onto that row so
    ``metricscope top`` still says which metrics the fused cost covers."""
    with _lock:
        row = _registry.get(cls_name)
        if row is None:
            row = _registry[cls_name] = _new_row()
        row["instances"].update(member_names)


def note_state_bytes(
    obj: Any,
    sizes: Dict[str, int],
    updates: int = 0,
    leaves: Optional[Dict[str, List[Any]]] = None,
) -> None:
    """Producer hook for NON-Metric state holders (the sliced plane's slice
    tables): fold ``obj``'s per-state byte split + update count into the
    registry under ``type(obj).__name__`` — the ledger then carries a
    ``state_bytes`` row per plan, exactly like a metric's — and publish the
    ``metric.<Class>.state_bytes`` gauge as the sum across live instances.
    ``leaves`` (``{state name: [array leaf, ...]}``) enrolls the holder's
    buffers in the leaf-identity table so the deduplicated
    ``metric.state_bytes_total`` gauge (what ``metricscope watch`` prefers)
    includes the carry — without it a plan's footprint would silently drop
    out of the process total. Callers guard with the trace/live flags (the
    disabled path never reaches here)."""
    cls = type(obj).__name__
    with _lock:
        slot = _instance_slot(obj)
        slot["state_bytes"] = {name: int(nbytes) for name, nbytes in sizes.items()}
        slot["updates"] = int(updates)
        if leaves is not None:
            table: Dict[Any, Tuple[Any, int]] = {}
            for name, leaf_list in leaves.items():
                _add_leaf_entries(table, slot, name, leaf_list)
            slot["leaf_bytes"] = table
        total = sum(
            sum(s["state_bytes"].values()) for s in _registry[cls]["by_instance"].values()
        )
        total_dedup = _global_state_bytes_locked()
    _counters.set_gauge(f"metric.{cls}.state_bytes", total)
    if leaves is not None:
        _counters.set_gauge("metric.state_bytes_total", total_dedup)


def metric_boundary(metric: Any) -> None:
    """Producer hook at a host-sync boundary (``compute()``/``sync()``/runner
    snapshot): fold this instance's per-state byte split + update count into
    the registry and publish the ``metric.<Class>.state_bytes`` gauge as the
    SUM across the class's live instances. Callers guard with the trace/live
    flags, so the disabled path never reaches this function; costs.json
    emission is the caller's separate :func:`maybe_emit` (after its spans
    close, so the ledger includes them)."""
    cls = type(metric).__name__
    sizes = state_byte_sizes(metric)
    with _lock:
        slot = _instance_slot(metric)
        slot["state_bytes"] = sizes
        slot["leaf_bytes"] = _leaf_byte_table(metric, slot)
        slot["updates"] = int(getattr(metric, "_update_count", 0))
        total = sum(
            sum(s["state_bytes"].values()) for s in _registry[cls]["by_instance"].values()
        )
        total_dedup = _global_state_bytes_locked()
    _counters.set_gauge(f"metric.{cls}.state_bytes", total)
    # compute-group members share state arrays by reference; the class rows
    # above count a shared array in each sharing class (each class's own
    # footprint), this gauge is the process truth with shared leaves counted
    # once — what `metricscope watch` shows
    _counters.set_gauge("metric.state_bytes_total", total_dedup)


def publish_sync_bytes(metric: Any, state_tree: Dict[str, Any]) -> None:
    """Producer hook inside ``Metric._sync_dist``: the payload this rank is
    about to contribute to the cross-process gather. The per-class gauge sums
    the class's live instances' last payloads. Array ``nbytes`` is metadata
    — no device sync happens here."""
    cls = type(metric).__name__
    payload = sum(_state_nbytes(v) for v in state_tree.values())
    with _lock:
        slot = _instance_slot(metric)
        slot["sync_bytes"] = payload
        total = sum(
            s["sync_bytes"]
            for s in _registry[cls]["by_instance"].values()
            if s["sync_bytes"] is not None
        )
    _counters.set_gauge(f"metric.{cls}.sync_bytes", total)


# while > 0, maybe_emit() is a no-op: MetricCollection.compute defers its
# members' per-compute emissions and writes the ledger ONCE at the end
_defer_depth = 0


@contextmanager
def defer_emission() -> Iterator[None]:
    """Context manager suppressing automatic costs.json emission inside it —
    a collection compute folds N member boundaries into one write."""
    global _defer_depth
    _defer_depth += 1
    try:
        yield
    finally:
        _defer_depth -= 1


def maybe_emit(rank: Optional[int] = None) -> None:
    """Write ``costs.json`` to the configured path, if tracing is on and a
    path is configured; swallow I/O errors (attribution must never take down
    the evaluation it observes) but count them."""
    if not _trace.ENABLED or _COSTS_PATH is None or _defer_depth:
        return
    try:
        write_costs(_COSTS_PATH, rank=rank)
    except OSError:
        _counters.inc("obs.costs.emit_errors")


# ------------------------------------------------------------------- ledger


def _gauge_metric_classes(gauges: Dict[str, Any], suffix: str) -> Dict[str, float]:
    """``metric.<Class>.<suffix>`` gauges -> ``{Class: value}``."""
    out: Dict[str, float] = {}
    tail = "." + suffix
    for name, value in gauges.items():
        if name.startswith("metric.") and name.endswith(tail):
            cls = name[len("metric.") : -len(tail)]
            if cls:
                out[cls] = value
    return out


def build_ledger(
    events: List[Dict[str, Any]],
    counters: Optional[Dict[str, Any]] = None,
    gauges: Optional[Dict[str, Any]] = None,
    *,
    xla_records: Optional[List[Dict[str, Any]]] = None,
    registry: Optional[Dict[str, Dict[str, Any]]] = None,
    dropped: int = 0,
    rank: Optional[int] = None,
) -> Dict[str, Any]:
    """Join every cost plane into one ledger dict (the costs.json payload).

    Pure and torch-free: callable offline over a trace file's
    ``(events, counters, gauges)`` — XLA records are then recovered from the
    exported ``*.compile`` spans — or live via :func:`write_costs`, which
    passes the in-process XLA registry (immune to span-ring drops) and the
    attribution registry (adds instance names + the per-state byte split).
    One row per metric class, sorted by host total time descending; spans
    recorded without a metric tag aggregate under the ``"-"`` row so a
    partial join is visible rather than silently dropped.
    """
    counters = counters or {}
    gauges = gauges or {}
    host_by_cls: Dict[str, Dict[str, Dict[str, Any]]] = {}
    for row in aggregate(events):
        host_by_cls.setdefault(row["metric"], {})[row["span"]] = {
            "count": row["count"],
            "total_ms": row["total_ms"],
            "self_ms": row["self_ms"],
            "p50_ms": row["p50_ms"],
            "p95_ms": row["p95_ms"],
        }
    if xla_records is None:
        xla_records = compile_rows(events)
    xla_by_cls: Dict[str, List[Dict[str, Any]]] = {}
    for record in xla_records:
        xla_by_cls.setdefault(record.get("metric", "-"), []).append(record)
    state_by_cls = _gauge_metric_classes(gauges, "state_bytes")
    sync_by_cls = _gauge_metric_classes(gauges, "sync_bytes")
    registry = registry or {}

    classes = set(host_by_cls) | set(xla_by_cls) | set(state_by_cls) | set(sync_by_cls) | set(registry)
    rows: List[Dict[str, Any]] = []
    for cls in classes:
        host = host_by_cls.get(cls, {})
        reg = registry.get(cls)
        device = None
        builds = xla_by_cls.get(cls)
        if builds:
            def _sum(field: str) -> Optional[float]:
                vals = [b[field] for b in builds if b.get(field) is not None]
                return float(sum(vals)) if vals else None

            device = {
                "builds": len(builds),
                "flops": _sum("flops"),
                "bytes_accessed": _sum("bytes_accessed"),
                "compile_ms": _sum("compile_ms"),
                "lower_ms": _sum("lower_ms"),
                "keys": [b["key"] for b in builds],
            }
        updates = host.get("metric.update", {}).get("count", 0)
        if reg:
            updates = max(updates, reg.get("updates", 0))
        state_bytes = state_by_cls.get(cls)
        if state_bytes is None and reg and reg.get("state_bytes"):
            state_bytes = sum(reg["state_bytes"].values())
        rows.append(
            {
                "metric": cls,
                "instances": sorted(reg["instances"]) if reg and reg.get("instances") else None,
                "updates": int(updates),
                "host": host,
                "host_total_ms": sum(s["total_ms"] for s in host.values()),
                "host_self_ms": sum(s["self_ms"] for s in host.values()),
                "device": device,
                "state_bytes": None if state_bytes is None else int(state_bytes),
                "state_bytes_by_state": dict(reg["state_bytes"]) if reg and reg.get("state_bytes") else None,
                "sync_bytes": None if cls not in sync_by_cls else int(sync_by_cls[cls]),
            }
        )
    rows.sort(key=lambda r: (-r["host_total_ms"], r["metric"]))
    ledger: Dict[str, Any] = {
        "type": "costs",
        "costs_version": COSTS_VERSION,
        "epoch_ns": time.time_ns(),
        "mono_ns": time.perf_counter_ns(),
        "pid": os.getpid(),
        "dropped": dropped,
        "columns": dict(TOP_COLUMNS),
        "metrics": rows,
        "run": {
            "counters": counters,
            "gauges": gauges,
            # process-wide state footprint with compute-group-shared arrays
            # counted ONCE (per-metric rows count each class's own view)
            "state_bytes_total": gauges.get("metric.state_bytes_total"),
            # whole-payload durability cost next to the per-metric planes:
            # what one durable snapshot of this run weighs on disk
            "checkpoint_bytes_last": gauges.get(
                "runner.snapshot.bytes_last", gauges.get("robustness.store.snapshot_bytes")
            ),
        },
    }
    if rank is not None:
        ledger["rank"] = rank
    return ledger


def write_costs(path: str, rank: Optional[int] = None) -> Dict[str, Any]:
    """Build the ledger from the LIVE recorders (span ring, counter registry,
    in-process XLA records, attribution registry) and write it to ``path``
    atomically (temp + replace — a concurrent reader never sees a torn
    artifact). Returns the ledger."""
    from . import xla as _xla

    snap = _counters.snapshot()
    ledger = build_ledger(
        _trace.get_trace(),
        snap["counters"],
        snap["gauges"],
        xla_records=_xla.records() or None,
        registry=registry_rows(),
        dropped=_trace.dropped_events(),
        rank=rank,
    )
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(ledger, fh, separators=(",", ":"))
    os.replace(tmp, path)
    return ledger


def _validate_costs(ledger: Any, source: str) -> Dict[str, Any]:
    """Refuse foreign/future costs layouts with a readable error instead of
    a downstream KeyError."""
    if not isinstance(ledger, dict) or ledger.get("type") != "costs":
        raise ValueError(f"{source} is not a costs.json artifact (missing type='costs')")
    version = ledger.get("costs_version")
    if not isinstance(version, int) or version < 1 or version > COSTS_VERSION:
        raise ValueError(
            f"{source} has costs_version {version!r}; this build reads <= {COSTS_VERSION}"
        )
    return ledger


def read_costs(path: str) -> Dict[str, Any]:
    """Parse and validate a ``costs.json`` artifact."""
    with open(path) as fh:
        return _validate_costs(json.load(fh), path)


def load_ledger(path: str) -> Dict[str, Any]:
    """Load a ledger from EITHER artifact: a ``costs.json`` (returned as-is)
    or a JSON-lines trace file (the ledger is rebuilt from its events +
    embedded counter snapshot) — ``metricscope top`` accepts both. The sniff
    reads only the FIRST line: a live-emitted costs.json is one compact line
    (``type: costs``), a trace line is a span/meta/counters record — no
    double read/parse of a multi-MB trace. Anything else (e.g. a hand
    pretty-printed costs document) falls through to :func:`read_costs`, so a
    foreign or future-version costs file raises its readable error instead
    of silently reading as an empty trace."""
    first = ""
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                first = line
                break
    try:
        head = json.loads(first) if first else None
    except ValueError:
        head = None
    if isinstance(head, dict) and head.get("type") == "costs":
        return _validate_costs(head, path)
    if isinstance(head, dict) and head.get("type") in ("span", "instant", "counters", "meta"):
        events, counters, gauges, meta = read_jsonl(path)
        return build_ledger(
            events, counters, gauges, dropped=meta.get("dropped", 0), rank=meta.get("rank")
        )
    return read_costs(path)


# ------------------------------------------------------------ CLI rendering


def _column_value(row: Dict[str, Any], column: str) -> Optional[float]:
    if column == "device_flops":
        return (row.get("device") or {}).get("flops")
    if column == "device_bytes":
        return (row.get("device") or {}).get("bytes_accessed")
    if column == "compile_ms":
        return (row.get("device") or {}).get("compile_ms")
    return row.get(column)


def top_rows(ledger: Dict[str, Any], by: str = "host_self_ms") -> List[Dict[str, Any]]:
    """Ledger rows ranked by ``by`` (see :data:`TOP_COLUMNS`), descending;
    rows without that cost sort last but stay visible — a metric with no
    device record is information, not noise."""
    if by not in TOP_COLUMNS:
        raise ValueError(f"unknown cost column {by!r}; choose from {sorted(TOP_COLUMNS)}")
    return sorted(
        ledger.get("metrics", []),
        key=lambda r: (
            -(v if (v := _column_value(r, by)) is not None else float("-inf")),
            r["metric"],
        ),
    )


def _fmt_int(value: Optional[float]) -> str:
    return "-" if value is None else str(int(value))


def format_top_table(ledger: Dict[str, Any], by: str = "host_self_ms", limit: Optional[int] = None) -> str:
    """Render the ``metricscope top`` ranking: one row per metric class, the
    sort column marked with ``*``."""
    rows = top_rows(ledger, by=by)
    if limit is not None:
        rows = rows[:limit]
    if not rows:
        return "(no cost rows — record with TM_TPU_TRACE=1 and run compute())"
    # the sort column's marker compares against the table's column spellings
    # (flops/bytes render in mega-units, so their headers differ from the key)
    marker = {"device_flops": "device_mflops", "device_bytes": "device_mbytes"}.get(by, by)
    header = tuple(("*" + h if h == marker else h) for h in (
        "rank", "metric", "updates", "host_self_ms", "host_total_ms",
        "device_mflops", "device_mbytes", "compile_ms", "state_bytes", "sync_bytes",
    ))
    table: List[Tuple[str, ...]] = [header]
    for i, row in enumerate(rows):
        device = row.get("device") or {}
        table.append(
            (
                str(i + 1),
                row["metric"] + (f" [{','.join(row['instances'])}]" if row.get("instances") else ""),
                str(row.get("updates", 0)),
                _fmt(row.get("host_self_ms")),
                _fmt(row.get("host_total_ms")),
                _fmt(None if device.get("flops") is None else device["flops"] / 1e6),
                _fmt(None if device.get("bytes_accessed") is None else device["bytes_accessed"] / 1e6),
                _fmt(device.get("compile_ms")),
                _fmt_int(row.get("state_bytes")),
                _fmt_int(row.get("sync_bytes")),
            )
        )
    lines = render_table(table)
    lines.append("")
    lines.append(f"ranked by {by}: {TOP_COLUMNS[by]}")
    if ledger.get("dropped"):
        lines.append(
            f"WARNING: {ledger['dropped']} span(s) were dropped by the ring buffer — host columns are partial"
        )
    checkpoint = (ledger.get("run") or {}).get("checkpoint_bytes_last")
    if checkpoint is not None:
        lines.append(f"last durable snapshot: {int(checkpoint)} bytes on disk")
    return "\n".join(lines)


def format_explain(ledger: Dict[str, Any], metric: str) -> str:
    """The ``metricscope top --explain <Metric>`` drill-down: every joined
    plane for one metric class — per-span host table (incl. self-time), per-
    build device table, the per-state byte split, sync payload bytes."""
    row = next((r for r in ledger.get("metrics", []) if r["metric"] == metric), None)
    if row is None:
        known = ", ".join(sorted(r["metric"] for r in ledger.get("metrics", []))) or "(none)"
        raise ValueError(f"no cost row for metric {metric!r}; ledger has: {known}")
    lines: List[str] = [f"{metric}" + (f"  instances: {', '.join(row['instances'])}" if row.get("instances") else "")]
    lines.append(f"updates: {row.get('updates', 0)}")
    lines.append("")
    host = row.get("host") or {}
    if host:
        table: List[Tuple[str, ...]] = [("span", "count", "total_ms", "self_ms", "p50_ms", "p95_ms")]
        for span_name in sorted(host, key=lambda s: -host[s]["total_ms"]):
            s = host[span_name]
            table.append(
                (span_name, str(s["count"]), _fmt(s["total_ms"]), _fmt(s["self_ms"]),
                 _fmt(s["p50_ms"]), _fmt(s["p95_ms"]))
            )
        lines.extend(render_table(table))
        lines.append(
            f"host: {row['host_self_ms']:.3f} ms self / {row['host_total_ms']:.3f} ms total"
        )
    else:
        lines.append("host: no spans recorded for this class")
    lines.append("")
    device = row.get("device")
    if device:
        lines.append(
            f"device: {device['builds']} compiled build(s)"
            f"  keys: {', '.join(k[:16] for k in device.get('keys', []))}"
        )
        table = [("compile_ms", "lower_ms", "mflops", "mbytes")]
        table.append(
            (_fmt(device.get("compile_ms")), _fmt(device.get("lower_ms")),
             _fmt(None if device.get("flops") is None else device["flops"] / 1e6),
             _fmt(None if device.get("bytes_accessed") is None else device["bytes_accessed"] / 1e6))
        )
        lines.extend(render_table(table))
    else:
        lines.append("device: no XLA compile records (metric never ran through a cold compiled step under tracing)")
    lines.append("")
    split = row.get("state_bytes_by_state")
    if split:
        table = [("state", "bytes")]
        for name in sorted(split, key=lambda n: -split[n]):
            table.append((name, str(int(split[name]))))
        table.append(("TOTAL", str(int(sum(split.values())))))
        lines.extend(render_table(table))
    elif row.get("state_bytes") is not None:
        lines.append(f"state_bytes: {int(row['state_bytes'])} (per-state split only in live-emitted costs.json)")
    else:
        lines.append("state_bytes: unknown (no snapshot boundary recorded)")
    if row.get("sync_bytes") is not None:
        lines.append(f"sync_bytes: {int(row['sync_bytes'])} contributed to the last state gather")
    return "\n".join(lines)
