# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Windowed aggregation: tumbling/sliding windows as a ring of mergeable
state snapshots (counterpart of ``torchmetrics_tpu/parallel/windowing.py``).

A serving eval plane answers "AUROC over the last 15 minutes", not "AUROC
since boot". The ``Running`` wrapper keeps one state copy per update event
and caps the window at a handful of updates; :class:`WindowRing` keeps a
**ring of closed windows** instead:

- the wrapped metric (or ``MetricCollection``) accumulates the OPEN window
  exactly as it always does — no change to the hot path;
- on a rotation trigger (every N batches and/or every T seconds, driven by
  :class:`~torchmetrics_tpu_torch.robustness.runner.StreamingEvaluator` or
  called directly) the open window CLOSES: its state trees snapshot into
  the ring and the metric resets. The ring holds the last ``slots`` closed
  windows; older windows fall off the ring;
- a query is a **fold**: the newest ``k`` ring entries pairwise-merge under
  each state's declared ``dist_reduce_fx`` (``tree_merge``: elementwise
  sums/maxes, cat list concatenation, sketch ``merge``), optionally with the
  open window, and the merged state computes on a scratch copy. A tumbling
  window is ``query(last=1)``; a sliding window of ``W = k × rotation
  period`` is ``query(last=k)``.

A snapshot keeps references: the port's updates replace state tensors and
never write into them, so a closed window cannot change after the rotation.

**Parity contract** (``tests/test_torch_windowing.py``, JAX's): a query
over ``k`` windows equals recomputing the metric from scratch over exactly
those windows' batches — bitwise for exact-merge state kinds (integer
elementwise, cat, add-style sketches) — and a tumbling ring with
``every_n=1`` matches ``Running(metric, window=N)`` on the overlap.

**Durability**: :meth:`WindowRing.payload` / :meth:`WindowRing.restore`
round-trip the ring as plain numpy dicts in the JAX package's layout
(``WINDOW_PAYLOAD_VERSION``), so a ring saved by either package restores in
the other; ``StreamingEvaluator`` embeds them in its snapshots.

With tracing or the live plane on, every rotation counts
``window.<Class>.rotations`` and publishes the ``window.<Class>.*`` gauges,
under the JAX package's names.
"""
from __future__ import annotations

import time
from copy import deepcopy
from typing import Any, Dict, List, Optional

from torchmetrics_tpu_torch.obs import counters as _obs_counters
from torchmetrics_tpu_torch.obs import live as _obs_live
from torchmetrics_tpu_torch.obs import trace as _obs_trace
from torchmetrics_tpu_torch.utilities.exceptions import StateRestoreError

__all__ = ["WindowRing"]

#: payload layout version of :meth:`WindowRing.payload`
WINDOW_PAYLOAD_VERSION = 1


class WindowRing:
    """Ring of closed, mergeable windows over a metric or collection.

    ::

        auroc = MulticlassAUROC(num_classes=10, thresholds=64, validate_args=False)
        ring = WindowRing(auroc, slots=15, every_s=60.0)     # 15 one-minute windows
        StreamingEvaluator(auroc, store=store, window_ring=ring).run(stream)
        ring.query(last=15)          # AUROC over the last 15 minutes
        ring.query(last=1)           # the newest closed minute (tumbling)

    Args:
        target: the ``Metric`` or ``MetricCollection`` accumulating the open
            window — the SAME object the evaluator drives.
        slots: closed windows the ring retains; older windows expire.
        every_n: close the open window after this many observed batches.
        every_s: close the open window when it has been open this long
            (checked per observed batch; OR-combined with ``every_n``).
            Both ``None`` = rotation only via explicit :meth:`rotate` calls.
    """

    def __init__(
        self,
        target: Any,
        *,
        slots: int,
        every_n: Optional[int] = None,
        every_s: Optional[float] = None,
    ) -> None:
        from torchmetrics_tpu_torch.collections import MetricCollection
        from torchmetrics_tpu_torch.metric import Metric

        if not isinstance(target, (Metric, MetricCollection)):
            raise ValueError(f"WindowRing wraps a Metric or MetricCollection, got {type(target).__name__}")
        if not (isinstance(slots, int) and not isinstance(slots, bool) and slots >= 1):
            raise ValueError(f"slots must be a positive int, got {slots!r}")
        if every_n is not None and every_n < 1:
            raise ValueError(f"every_n must be >= 1, got {every_n}")
        if every_s is not None and every_s <= 0:
            raise ValueError(f"every_s must be > 0, got {every_s}")
        self.target = target
        self.slots = slots
        self.every_n = every_n
        self.every_s = every_s
        self._is_collection = isinstance(target, MetricCollection)
        self._template = deepcopy(target)
        #: closed windows, oldest → newest; each entry is
        #: {"cursor", "batches", "members": {key: state tree incl _update_count}}
        self._ring: List[Dict[str, Any]] = []
        self._open_batches = 0
        self._opened_t = time.monotonic()
        self._rotations = 0
        # payload() encoding of the closed ring, invalidated on rotation —
        # closed windows do not change between rotations, so a per-batch
        # stall-capture payload must not re-encode the whole ring every batch
        self._encoded_ring: Optional[List[Dict[str, Any]]] = None

    # ------------------------------------------------------------------ state
    def _members(self, target: Optional[Any] = None) -> Dict[str, Any]:
        target = self.target if target is None else target
        if self._is_collection:
            return dict(target.items(keep_base=True, copy_state=True))
        return {type(target).__name__: target}

    @staticmethod
    def _snapshot_tree(metric: Any) -> Dict[str, Any]:
        tree = metric._copy_state_dict()
        tree["_update_count"] = metric._update_count
        return tree

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def open_batches(self) -> int:
        """Batches observed in the (not yet closed) open window."""
        return self._open_batches

    @property
    def open_age_s(self) -> float:
        """Seconds the current open window has been accumulating."""
        return time.monotonic() - self._opened_t

    # --------------------------------------------------------------- rotation
    def due(self) -> bool:
        """Whether a trigger asks the open window to close now."""
        if self.every_n is not None and self._open_batches >= self.every_n:
            return True
        if self.every_s is not None and self.open_age_s >= self.every_s:
            return True
        return False

    def observe(self, cursor: int) -> bool:
        """Per-batch hook (``StreamingEvaluator`` calls it after each
        applied batch): count the batch into the open window and rotate when
        a trigger fires. Returns whether a rotation happened."""
        self._open_batches += 1
        if self.due():
            self.rotate(cursor)
            return True
        return False

    def rotate(self, cursor: int = -1) -> None:
        """Close the open window: snapshot every member's state tree into the
        ring (the oldest entry expires past ``slots``) and reset the target.
        A window that saw no batches still closes — an empty window is real
        serving information ("no traffic this minute")."""
        entry = {
            "cursor": int(cursor),
            "batches": self._open_batches,
            "members": {key: self._snapshot_tree(m) for key, m in self._members().items()},
        }
        self._ring.append(entry)
        if len(self._ring) > self.slots:
            del self._ring[0]
        self.target.reset()
        self._open_batches = 0
        self._opened_t = time.monotonic()
        self._rotations += 1
        self._encoded_ring = None  # the closed set changed: re-encode lazily
        if _obs_trace.ENABLED or _obs_live.ENABLED:
            cls = type(self.target).__name__
            _obs_counters.inc(f"window.{cls}.rotations")
            _obs_counters.set_gauge(f"window.{cls}.slots_live", len(self._ring))
            _obs_counters.set_gauge(f"window.{cls}.closed_batches", entry["batches"])
            _obs_counters.set_gauge(f"window.{cls}.age_s", 0.0)

    # ------------------------------------------------------------------ query
    def _merge_trees(self, metric: Any, a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
        """Pairwise window merge under the declared reductions — the window
        close IS a ``metric_merge`` fold, so every state kind the sync/shard
        planes can reduce is windowable."""
        from torchmetrics_tpu_torch.parallel.sharded import tree_merge

        count_a, count_b = int(a["_update_count"]), int(b["_update_count"])
        # TRUE update counts as merge weights: an EMPTY closed window (count
        # 0) must not dilute "mean" states with default-valued state. Only
        # the all-empty fold (0+0 would divide by zero) falls back to equal
        # weights, where every operand is the default anyway.
        weight_a, weight_b = (count_a, count_b) if count_a + count_b else (1, 1)
        merged = tree_merge(
            metric._reductions,
            {k: a[k] for k in metric._defaults},
            {k: b[k] for k in metric._defaults},
            weight_a=weight_a,
            weight_b=weight_b,
        )
        merged["_update_count"] = count_a + count_b
        return merged

    def query(self, last: Optional[int] = None, include_open: bool = False) -> Any:
        """Compute over the newest ``last`` closed windows (default: every
        live ring entry), oldest-first fold; ``include_open=True`` also
        merges the open window's live state. The target itself is untouched
        — the fold installs into a scratch copy."""
        entries = self._ring if last is None else self._ring[max(0, len(self._ring) - last) :]
        member_trees: List[Dict[str, Dict[str, Any]]] = [e["members"] for e in entries]
        if include_open:
            member_trees = member_trees + [{key: self._snapshot_tree(m) for key, m in self._members().items()}]
        if not member_trees:
            raise ValueError("no closed windows to query (and include_open=False)")
        scratch = deepcopy(self._template)
        scratch_members = self._members(scratch)
        for key, member in scratch_members.items():
            folded = member_trees[0][key]
            for tree in member_trees[1:]:
                folded = self._merge_trees(member, folded, tree[key])
            member.load_state_tree(dict(folded))
            member._computed = None
        if self._is_collection:
            scratch._state_is_copy = False
        return scratch.compute()

    # -------------------------------------------------------------- live plane
    def probe(self) -> Dict[str, float]:
        """Live-publisher probe: the open window's age and the ring
        occupancy, as a host dict."""
        cls = type(self.target).__name__
        return {
            f"window.{cls}.age_s": self.open_age_s,
            f"window.{cls}.slots_live": float(len(self._ring)),
            f"window.{cls}.open_batches": float(self._open_batches),
        }

    # ------------------------------------------------------------- durability
    @staticmethod
    def _encode_value(value: Any) -> Any:
        """One state leaf as plain host data — the checkpoint layer's wire
        format (list -> list of ndarrays, sketch -> the field-keyed
        ``{"__sketch__", "leaves"}`` dict ``load_state_tree`` decodes)."""
        from torchmetrics_tpu_torch.robustness.checkpoint import _serialize_state

        return _serialize_state(value)

    def payload(self) -> Dict[str, Any]:
        """The ring (closed windows + open-window counters) as one plain
        numpy dict — ``StreamingEvaluator`` embeds it in its snapshots.
        Closed windows do not change between rotations, so their encoding is
        cached: the per-batch stall-capture path pays the device→host copies
        once per ROTATION, not once per batch."""
        if self._encoded_ring is None:
            self._encoded_ring = [
                {
                    "cursor": e["cursor"],
                    "batches": e["batches"],
                    "members": {
                        key: {name: self._encode_value(v) for name, v in tree.items() if name != "_update_count"}
                        | {"_update_count": int(tree["_update_count"])}
                        for key, tree in e["members"].items()
                    },
                }
                for e in self._ring
            ]
        return {
            "window_payload_version": WINDOW_PAYLOAD_VERSION,
            "slots": self.slots,
            "open_batches": self._open_batches,
            "rotations": self._rotations,
            "ring": list(self._encoded_ring),
        }

    def restore(self, payload: Dict[str, Any]) -> None:
        """Validate-ALL-then-apply restore of :meth:`payload` (either
        package's): every entry's every member tree is decoded and validated
        against the member's state registry (on a scratch copy) before the
        live ring is touched. Callers coordinating with OTHER restores (the
        runner restores the metric checkpoint too) validate first and apply
        later via :meth:`validated_parts`/:meth:`apply_parts`."""
        self.apply_parts(self.validated_parts(payload))

    def validated_parts(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Decode + validate a :meth:`payload` WITHOUT touching the live
        ring; raises :class:`StateRestoreError` on any mismatch. The result
        feeds :meth:`apply_parts`."""
        version = payload.get("window_payload_version")
        if not isinstance(version, int) or version < 1 or version > WINDOW_PAYLOAD_VERSION:
            raise StateRestoreError(
                f"window ring payload version {version!r} is not supported"
                f" (this build reads <= {WINDOW_PAYLOAD_VERSION})"
            )
        if payload.get("slots") != self.slots:
            raise StateRestoreError(
                f"window ring payload was written for slots={payload.get('slots')!r},"
                f" this ring has slots={self.slots}"
            )
        entries = payload.get("ring", [])
        if len(entries) > self.slots:
            raise StateRestoreError(
                f"window ring payload holds {len(entries)} closed windows but the ring"
                f" retains at most slots={self.slots} — corrupt/foreign payload"
            )
        scratch_members = self._members(deepcopy(self._template))
        want_keys = set(scratch_members)
        fresh_ring: List[Dict[str, Any]] = []
        try:
            for i, entry in enumerate(entries):
                members = entry["members"]
                if set(members) != want_keys:
                    raise StateRestoreError(
                        f"window ring entry {i} members {sorted(members)} do not match the"
                        f" target's {sorted(want_keys)}"
                    )
                decoded_members: Dict[str, Dict[str, Any]] = {}
                for key, tree in members.items():
                    # registry validation AND decode in one step: the scratch
                    # member's load_state_tree validates shape/dtype/kind and
                    # decodes the sketch payloads; the decoded tree is read
                    # back from the scratch (its next load replaces, never
                    # writes into, these tensors)
                    scratch_members[key].load_state_tree(dict(tree))
                    decoded_members[key] = self._snapshot_tree(scratch_members[key])
                fresh_ring.append(
                    {"cursor": int(entry["cursor"]), "batches": int(entry["batches"]), "members": decoded_members}
                )
        except (KeyError, TypeError, ValueError) as err:
            if isinstance(err, StateRestoreError):
                raise
            raise StateRestoreError(f"window ring payload is malformed: {err}") from err
        return {
            "ring": fresh_ring,
            "open_batches": int(payload.get("open_batches", 0)),
            "rotations": int(payload.get("rotations", len(fresh_ring))),
        }

    def apply_parts(self, parts: Dict[str, Any]) -> None:
        """Install :meth:`validated_parts` output into the live ring."""
        self._ring = parts["ring"]
        self._open_batches = parts["open_batches"]
        self._rotations = parts["rotations"]
        self._opened_t = time.monotonic()
        self._encoded_ring = None
