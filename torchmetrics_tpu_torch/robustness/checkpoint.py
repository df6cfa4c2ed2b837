# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Self-validating checkpoint helpers (counterpart of
``torchmetrics_tpu/robustness/checkpoint.py``).

``Metric.save_checkpoint()`` captures the metric — and, via the deep metric
walk, every wrapper child — as one plain dict of host numpy arrays plus the
schema fingerprint, format version and update count. The dict holds only
numpy arrays, lists of them and Python scalars, exactly what the JAX
package writes, so it pickles without torch or jax and a checkpoint written
by either package loads in the other (same paths, same fingerprints, same
keys). ``Metric.load_checkpoint()`` re-validates everything before touching
any state: a truncated payload, a corrupted leaf, or a schema mismatch
(different ``num_classes``, renamed state, changed reduction) raises
:class:`~torchmetrics_tpu_torch.utilities.exceptions.StateRestoreError` while
the live metric keeps its previous state — never a half-restored metric.

Saved arrays are copies, never views of live state (a payload may outlive
the step that took it). Loaded states are tensors of their own on the
metric's device, never views of the payload's numpy buffers. The format
does not carry the mesh-replicated flag of a sharded fold: a loaded state
is rank-local (``StreamingEvaluator`` re-marks a restored mesh drive).

A mergeable sketch state is written as the JAX package writes it, a
``{"__sketch__": class_name, "leaves": {field: ndarray}}`` dict, and such an
entry from either package restores leaf by leaf (``robustness/spec.py``).
"""
from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.obs import counters as _obs_counters
from torchmetrics_tpu_torch.obs import trace as _obs_trace
from torchmetrics_tpu_torch.robustness.spec import SKETCH_PAYLOAD_KEY, spec_fingerprint, validate_state_tree
from torchmetrics_tpu_torch.sketch.registry import is_sketch_state
from torchmetrics_tpu_torch.utilities.exceptions import StateRestoreError

#: host-counter value types a checkpoint may carry. Counters holding runtime
#: objects (e.g. a generator model) are execution context, not restorable
#: state — they are skipped on save so the checkpoint stays a plain
#: serializable dict, and left untouched on load.
_PLAIN_COUNTER_TYPES = (bool, int, float, str, bytes, type(None), np.ndarray, np.generic)

#: bump when the checkpoint layout changes; loaders refuse newer versions
CHECKPOINT_FORMAT_VERSION = 1

_ENTRY_KEYS = ("fingerprint", "update_count", "state")
_TOP_KEYS = ("format_version", "class", "fingerprint", "metrics")


def _walk(metric: Any) -> List[Tuple[str, Any]]:
    from torchmetrics_tpu_torch.parallel.sharded import _walk_metrics

    return _walk_metrics(metric)


def checkpoint_fingerprint(metric: Any) -> str:
    """Digest over the spec fingerprints of the metric and every wrapper child."""
    canon = sorted((path, spec_fingerprint(m)) for path, m in _walk(metric))
    return hashlib.sha256(json.dumps(canon, separators=(",", ":")).encode()).hexdigest()[:16]


def _host_copy(value: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array of its own: a CPU tensor's ``.numpy()``
    shares the live state's memory, so it is copied; a device tensor's
    ``.cpu()`` is already a new buffer."""
    value = value.detach()
    if value.device.type == "cpu":
        return value.numpy().copy()
    return value.cpu().numpy()


def _serialize_state(value: Any) -> Any:
    """One state as plain host data: list states -> list of ndarrays, sketch
    states -> a marked ``{"__sketch__": class, "leaves": {...}}`` dict,
    arrays -> ndarray."""
    if isinstance(value, list):
        return [_host_copy(x) for x in value]
    if is_sketch_state(value):
        return {
            SKETCH_PAYLOAD_KEY: type(value).__name__,
            "leaves": {field: _host_copy(leaf) for field, leaf in zip(type(value)._fields, value)},
        }
    return _host_copy(value)


def save_checkpoint(metric: Any) -> Dict[str, Any]:
    """Snapshot ``metric`` (deep: wrapper children included) as a plain dict."""
    if _obs_trace.ENABLED:
        with _obs_trace.span("checkpoint.save", metric=type(metric).__name__):
            _obs_counters.inc("checkpoint.save")
            return _save_checkpoint(metric)
    return _save_checkpoint(metric)


def _save_checkpoint(metric: Any) -> Dict[str, Any]:
    metrics: Dict[str, Any] = {}
    for path, m in _walk(metric):
        tree = m.state_tree(include_count=True)
        count = int(tree.pop("_update_count"))
        state = {name: _serialize_state(v) for name, v in tree.items()}
        metrics[path] = {
            "fingerprint": spec_fingerprint(m),
            "update_count": count,
            "state": state,
            "host_counters": {
                attr: getattr(m, attr)
                for attr in getattr(m, "_host_counters", ())
                if isinstance(getattr(m, attr), _PLAIN_COUNTER_TYPES)
            },
        }
    return {
        "format_version": CHECKPOINT_FORMAT_VERSION,
        "class": type(metric).__name__,
        "fingerprint": checkpoint_fingerprint(metric),
        "metrics": metrics,
    }


def load_checkpoint(metric: Any, checkpoint: Dict[str, Any], strict: bool = True) -> None:
    """Validate ``checkpoint`` end-to-end, then install it into ``metric``.

    Validation runs over EVERY entry before any state is applied, so a bad
    checkpoint leaves the metric untouched. Phase 1 also stages each state
    as a tensor of its own on the metric's device (an allocation failure
    therefore strikes before anything is installed); phase 2 only installs.
    """
    if _obs_trace.ENABLED:
        with _obs_trace.span("checkpoint.load", metric=type(metric).__name__, strict=strict):
            _obs_counters.inc("checkpoint.load")
            return _load_checkpoint(metric, checkpoint, strict=strict)
    return _load_checkpoint(metric, checkpoint, strict=strict)


def _load_checkpoint(metric: Any, checkpoint: Dict[str, Any], strict: bool = True) -> None:
    if not isinstance(checkpoint, dict):
        raise StateRestoreError(
            f"checkpoint for {type(metric).__name__} must be a dict, got {type(checkpoint).__name__} —"
            " truncated or corrupted payload?"
        )
    missing_top = [k for k in _TOP_KEYS if k not in checkpoint]
    if missing_top:
        raise StateRestoreError(
            f"checkpoint for {type(metric).__name__} is missing key(s) {missing_top} — truncated or corrupted payload?"
        )
    version = checkpoint["format_version"]
    if not isinstance(version, int) or version < 1 or version > CHECKPOINT_FORMAT_VERSION:
        raise StateRestoreError(
            f"checkpoint format_version {version!r} is not supported (this build reads <= {CHECKPOINT_FORMAT_VERSION})"
        )
    entries = checkpoint["metrics"]
    if not isinstance(entries, dict):
        raise StateRestoreError("checkpoint 'metrics' section must be a dict — truncated or corrupted payload?")

    walk = _walk(metric)
    live_paths = [path for path, _ in walk]
    if strict:
        extra = sorted(set(entries) - set(live_paths))
        absent = sorted(set(live_paths) - set(entries))
        if extra or absent:
            raise StateRestoreError(
                f"checkpoint structure does not match {type(metric).__name__}:"
                + (f" unexpected entries {extra}" if extra else "")
                + (f" missing entries {absent}" if absent else "")
            )

    # phase 1: validate every entry without mutating anything
    staged: List[Tuple[Any, Dict[str, Any], int, Dict[str, Any]]] = []
    for path, m in walk:
        entry = entries.get(path)
        if entry is None:
            continue  # non-strict: leave this child as-is
        where = f"{type(m).__name__} at {path!r}" if path else type(m).__name__
        if not isinstance(entry, dict) or any(k not in entry for k in _ENTRY_KEYS):
            raise StateRestoreError(f"checkpoint entry for {where} is malformed — truncated or corrupted payload?")
        if not isinstance(entry["state"], dict):
            raise StateRestoreError(f"checkpoint entry for {where}: 'state' must be a dict, got"
                                    f" {type(entry['state']).__name__}")
        validated = validate_state_tree(m, entry["state"], strict=strict)
        if entry["fingerprint"] != spec_fingerprint(m):
            # leaves are individually compatible but the registry still
            # disagrees (renamed reduction, extra state in non-strict, ...)
            raise StateRestoreError(
                f"checkpoint spec fingerprint mismatch for {where}: metric declares {spec_fingerprint(m)},"
                f" checkpoint was written with {entry['fingerprint']}"
            )
        counters = dict(entry.get("host_counters", {}))
        # counters restore via setattr: accept ONLY declared _host_counters
        # with plain values, or a corrupted payload could clobber arbitrary
        # metric attributes (e.g. ``_defaults``) despite passing state checks
        declared = set(getattr(m, "_host_counters", ()))
        bad = sorted(k for k in counters if k not in declared or not isinstance(counters[k], _PLAIN_COUNTER_TYPES))
        if bad:
            if strict:
                raise StateRestoreError(
                    f"checkpoint entry for {where} carries host counter(s) {bad} the metric does not declare"
                    " (or non-plain values) — corrupted payload?"
                )
            counters = {k: v for k, v in counters.items() if k not in bad}
        staged.append((m, validated, int(entry["update_count"]), counters))

    # phase 2: apply — every entry already validated and staged on the
    # device (so this cannot half-fail); the trusted installer skips
    # re-validating what phase 1 did
    for m, validated, count, counters in staged:
        tree = dict(validated)
        tree["_update_count"] = count
        m._install_state_tree(tree)
        m._computed = None
        m._mesh_replicated = False  # the bytes say nothing else: a rank-local state
        for attr, val in counters.items():
            setattr(m, attr, val)
