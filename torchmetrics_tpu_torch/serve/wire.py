# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""``metricserve`` wire schema (a copy of ``torchmetrics_tpu/serve/wire.py``).

The port keeps its own copy rather than importing the JAX package's: the two
are byte-for-byte the same wire, so a JAX client drives a port daemon and one
fleet folds leaves of both packages. Only this docstring differs.

Every message the daemon speaks — HTTP control-plane bodies AND the
newline-JSON local-socket ingest frames — is one JSON object carrying the
schema version under ``"v"``. This module is the single source of truth for
that envelope; it deliberately imports NOTHING outside the stdlib so the
``metricserve ctl`` client mode can load it by file path (the metricscope
idiom) on a supervisor host that cannot import jax or torch.

Envelope
--------
Request frames (socket) / request bodies (HTTP POST)::

    {"v": 1, "op": "ingest", "stream": "m1-val", "seq": 7, "batch": [...]}

Response frames / bodies::

    {"v": 1, "ok": true, ...fields}
    {"v": 1, "ok": false, "error": {"code": "backpressure", "message": "...",
                                    "retry_after_s": 0.05, ...detail}}

Error codes are machine-switchable (:data:`ERROR_CODES`): ``backpressure``
(queue full — retry after ``retry_after_s``), ``bad_seq`` (gap: the body
carries ``expected`` so the client can rewind its replay), ``not_found``,
``exists``, ``draining`` (daemon is shutting down, nothing new is admitted),
``failed`` (the stream's worker died or its circuit breaker is open — the
body carries the cause), ``bad_payload`` (the batch decodes but its
part count / dtype / trailing shape disagree with the stream's
first-accepted batch — the body carries ``expected`` and ``got``),
``bad_request``, ``unsupported_version`` and ``fingerprint_mismatch`` (a
state export was requested pinned to a registry fingerprint the stream does
not carry — HTTP 409; the federation plane quarantines the leaf instead of
folding a foreign schema).

Batches on the wire are JSON lists of (nested) number lists — one entry per
positional update argument; the server decodes them to arrays. A sliced
stream's batch leads with its integer cohort-key column(s) (the
``plan.update(keys, *batch)`` calling convention). JSON numbers round-trip
binary64 exactly, so results read back from a drain compare bitwise against
an in-process run.

State payloads (the ``/v1/state`` export verb) carry arrays through
:func:`encode_state` — a ``{"__nd__": dtype, "shape": [...], "data": ...}``
marker per array — because a bare ``tolist()`` erases the dtype and the
strict restore ladder on the aggregator side rightly refuses a float64 tree
for a float32 metric. Encoding is duck-typed (``dtype``/``shape``/
``tolist``) so this module stays stdlib-only; decoding needs numpy and lives
in :mod:`torchmetrics_tpu_torch.serve.federation`.
"""
from __future__ import annotations

import json
from typing import Any, Dict

__all__ = [
    "WIRE_VERSION",
    "ERROR_CODES",
    "ND_KEY",
    "WireError",
    "ok",
    "error",
    "encode_frame",
    "decode_frame",
    "check_version",
    "to_jsonable",
    "encode_state",
]

#: bump when a frame/body field changes meaning; the daemon rejects other
#: versions with ``unsupported_version`` instead of guessing
WIRE_VERSION = 1

ERROR_CODES = (
    "backpressure",
    "bad_seq",
    "not_found",
    "exists",
    "draining",
    "failed",
    "bad_payload",
    "bad_request",
    "unsupported_version",
    "fingerprint_mismatch",
)

#: marker key for a dtype-preserving array in a state payload
ND_KEY = "__nd__"


class WireError(ValueError):
    """A frame/body that violates the wire schema."""


def ok(**fields: Any) -> Dict[str, Any]:
    """A success envelope: ``{"v": 1, "ok": True, **fields}``."""
    return {"v": WIRE_VERSION, "ok": True, **fields}


def error(code: str, message: str, **detail: Any) -> Dict[str, Any]:
    """An error envelope with a machine-switchable ``code``."""
    if code not in ERROR_CODES:
        raise WireError(f"unknown error code {code!r} (add it to ERROR_CODES first)")
    return {"v": WIRE_VERSION, "ok": False, "error": {"code": code, "message": message, **detail}}


def encode_frame(obj: Dict[str, Any]) -> bytes:
    """One newline-terminated compact-JSON frame (the socket unit)."""
    return json.dumps(obj, separators=(",", ":")).encode() + b"\n"


def decode_frame(line: bytes) -> Dict[str, Any]:
    """Parse one frame; raises :class:`WireError` on non-JSON / non-object."""
    try:
        obj = json.loads(line)
    except ValueError as err:
        raise WireError(f"frame is not JSON: {err}") from None
    if not isinstance(obj, dict):
        raise WireError(f"frame must be a JSON object, got {type(obj).__name__}")
    return obj


def check_version(obj: Dict[str, Any]) -> None:
    """Reject a frame/body whose ``"v"`` is missing or not ours."""
    version = obj.get("v")
    if version != WIRE_VERSION:
        raise WireError(
            f"unsupported wire version {version!r} (this daemon speaks v{WIRE_VERSION})"
        )


def to_jsonable(value: Any) -> Any:
    """Results/checkpoint values → plain JSON types, duck-typed so this
    module never imports numpy/torch: array-likes go through ``tolist()``,
    0-d scalars through ``item()``, dict keys become strings (a
    ``SlicedPlan.results()`` tuple key renders as ``"(3, 1)"``)."""
    if isinstance(value, dict):
        return {str(k) if not isinstance(k, str) else k: to_jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [to_jsonable(v) for v in value]
    if hasattr(value, "tolist"):
        return value.tolist()
    if hasattr(value, "item") and not isinstance(value, (int, float, bool, str)):
        try:
            return value.item()
        except Exception:
            return repr(value)
    if isinstance(value, (int, float, bool, str)) or value is None:
        return value
    return repr(value)


def encode_state(value: Any) -> Any:
    """A checkpoint/state tree → JSON with dtype-preserving array markers.

    Arrays (anything with ``dtype``/``shape``/``tolist`` — numpy arrays and
    the port's host bfloat16 leaves alike, duck-typed so this module never
    imports either) become
    ``{"__nd__": "<dtype>", "shape": [...], "data": <nested lists>}``;
    0-d arrays and numpy scalars ride the same marker with ``"shape": []``.
    Everything else passes through :func:`to_jsonable` semantics. The
    decoder (``federation.decode_state``) rebuilds exact-dtype ndarrays, so
    the strict ``load_state_tree`` ladder accepts the round-trip.
    """
    if isinstance(value, dict):
        return {str(k) if not isinstance(k, str) else k: encode_state(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [encode_state(v) for v in value]
    if hasattr(value, "dtype") and hasattr(value, "shape") and hasattr(value, "tolist"):
        return {
            ND_KEY: str(value.dtype),
            "shape": [int(d) for d in value.shape],
            "data": value.tolist(),
        }
    if isinstance(value, bytes):
        return {"__bytes__": value.decode("latin-1")}
    if isinstance(value, (int, float, bool, str)) or value is None:
        return value
    if hasattr(value, "item"):
        try:
            return value.item()
        except Exception:
            return repr(value)
    return repr(value)
